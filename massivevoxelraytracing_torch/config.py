"""Engine configuration (the port's copy of the JAX package's config.py).

The reference scatters its knobs over three tiers: compile-time #defines
(ENABLE_GPU_DAG, ENABLE_EMBEDED_MASK, SMALL_STACK, USE_PMJ,
EXTRA_IMPLICIT_SAMPLING, block sizes), argv (--frame-range), and live ImGui
state (gridRes, sixSeparating, lens, view modes). Here they collapse into
one dataclass with the same fields, defaults and JSON as the JAX package's
EngineConfig, so a file written by either package loads in the other.
`ray_packet` maps onto `PathTracer.packet` (lanes per pt_sample call).
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class EngineConfig:
    # voxelization
    six_separating: bool = True
    cap: int = 4                         # candidate-grid size per triangle
    chunk_tris: int = 65536              # triangles per voxelize dispatch

    # tree build (the reference's DAG switch; the HakoTree ignores it)
    dag: bool = True

    # path tracer
    use_pmj: bool = True
    extra_implicit_sampling: bool = True
    max_bounces: int = 8
    n_batch_spp: int = 16
    emission_scale: float = 7.5
    hdri_scale: float = 1.75

    # execution shape: (pixel x spp) lanes per pt_sample call
    ray_packet: int = 65536

    # camera
    fovy_deg: float = 40.0
    lens_r: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "EngineConfig":
        return EngineConfig(**json.loads(s))


DEFAULT = EngineConfig()
