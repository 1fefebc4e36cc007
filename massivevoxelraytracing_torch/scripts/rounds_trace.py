"""The rounds route's 1080p lattice frame under torch.profiler, in a
process of its own: late in a long process the profiler drops device
events of short sessions (scripts/profile_window.py), so chip_smoke.py
runs this as a child process to trace the route.

    python -m massivevoxelraytracing_torch.scripts.rounds_trace [--res 1024]

The bench lattice (utils/meshgen.sphere_lattice(6, 4) through
models/scene.build_scene) at --res and the bench camera
(common.script_camera) at 1920x1080. Three calls, each warmed once, held
bit for bit against hako_mega on the same rays, and profiled with
common.profile_counted (a trace holding every round kernel launch the
wrappers counted): the frame through render_frame(traversal="rounds")
(one hako_rounds launch), and the frame's rays traced alone through
hako_rounds and through the two-launch driver (drive with hako_probe and
hako_dda_merge, a host nonzero a round). Each prints its wall ms (host
clock, synced), the round kernels' and the other device ops' ms (device
times), the device's idle share and the tries the trace took, or "not
measured" where no try gave a whole trace; the last line is the records
as JSON. Needs a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import raycast, scene
from ..ops import hako_kernels as hk
from ..ops import hako_mega
from ..utils import meshgen
from . import common

WIDTH, HEIGHT = 1920, 1080


def _record(name: str, fn, card: str) -> dict:
    """fn profiled by common.profile_counted, or "not_measured" with the
    reason where no try gave a whole trace."""
    try:
        r = common.profile_counted(fn, hk.LAUNCHES)
    except AssertionError as e:
        print(f"[rounds trace] {name}: not measured: {e} [{card}]", flush=True)
        return dict(not_measured=str(e))
    kernels = sum(ms for ms, _calls in r["named"].values())
    rec = dict(wall_ms=r["wall_ms"], round_kernels_ms=kernels,
               other_device_ms=r["busy_ms"] - kernels, idle_share=r["idle_share"],
               device_events=r["kernels"], tries=r["tries"], pad_s=r["pad_s"],
               launches={k: v[1] for k, v in r["named"].items() if v[1]})
    print(f"[rounds trace] {name}: wall {rec['wall_ms']:.3f} ms = round kernels "
          f"{kernels:.3f} ms + other device ops {rec['other_device_ms']:.3f} ms (device "
          f"times) + device idle, idle share {rec['idle_share']:.3f}; {rec['device_events']} "
          f"device events, round kernels {rec['launches']}; a whole trace after "
          f"{rec['tries']} tries [{card}]", flush=True)
    return rec


def run(res: int = 1024, device="cuda") -> dict:
    dev = common.resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("rounds_trace traces the card: it needs a card")
    card = common.card(dev)
    tri, cols = meshgen.sphere_lattice(6, 4)
    tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / res,
                             grid_res=res, accel="hako", chunk_tris=262144, device=dev)
    cam = common.script_camera(np.zeros(3, np.float32), 1.0)
    ro, rd = common.camera_rays(cam, WIDTH, HEIGHT, dev)
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T)
    img, depth = raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=dev)

    def frame():
        return raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=dev, traversal="rounds")

    def rounds():
        return hk.intersect_rays_hako(*args, T=T)

    def two_launch():
        return hk.drive((hk.hako_probe, hk.hako_dda_merge), *args, T=T, shadow=False,
                        max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
                        max_rounds=hk.default_max_rounds(snodes, T, hk.PROBES,
                                                         hk.DDA_ITERS))[:3]

    out = {}
    for key, name, fn in (
            ("frame", "frame through hako_rounds", frame),
            ("rays_hako_rounds", "the frame's rays through hako_rounds", rounds),
            ("rays_two_launch", "the frame's rays through the two-launch driver", two_launch)):
        got = fn()
        want = (img, depth) if fn is frame else mega
        if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
            raise AssertionError(f"{name}: differs from hako_mega's")
        out[key] = _record(name, fn, card)
    print(json.dumps({"rounds_trace": out}), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=1024, help="the lattice's grid resolution")
    a = ap.parse_args(argv)
    return run(a.res, a.device)


if __name__ == "__main__":
    main()
