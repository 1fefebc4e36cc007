"""The 2048^3 path's scripts at a small size on the CPU, against the JAX
package: scripts/rebuild_timing.py's builds (the sphere lattice jittered
by 1e-4 a build) each equal the JAX package's scene.build_scene of the
same mesh (triangles, dumped and unique voxels, the HakoTree through
assert_matches_jax, the voxel colours), in the plain layout and in the fat
one (USE_SNODES_ABOVE lowered in both packages); scripts/scale_demo.py's
frame equals raycast.render_frame driven directly and its PNG decodes to
that frame; and every script of the slice raises without a card unless it
is given --device cpu.

The JAX build runs op by op (jax.disable_jit): its jitted voxelizer
contracts multiply-adds into FMAs and flips cell-boundary ties
(test_torch_voxelize), here one dumped voxel of the jittered lattice. Its
triangle split runs its numpy version: its native build contracts
multiply-adds on hosts with FMA and bisects other edges at ties
(test_torch_host): on a host with FMA, 7,429 triangles against the
port's 7,435 for the second build. The port's split is built without contraction and equals the numpy
version's triangles."""

import numpy as np
import jax
import pytest
import torch

from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.utils import native as jnative
from massivevoxelraytracing_torch.models import raycast
from massivevoxelraytracing_torch.ops import camera, hako
from massivevoxelraytracing_torch.scripts import (
    microbench, pt_phase_attrib, pt_step_timing, rebuild_timing, scale_demo)
from massivevoxelraytracing_torch.utils import png

from test_torch_hako_build import assert_matches_jax

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RES = 64
NSP, SUBDIV = 2, 1


@pytest.fixture(scope="module")
def numpy_split():
    """The JAX package's split through its numpy version."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "split_to_cap", lambda *a, **k: None)
    try:
        yield
    finally:
        mp.undo()


def jax_build(i: int, res: int):
    tri, cols = scale_demo.sphere_lattice(NSP, SUBDIV, 0.44)
    tri = tri + np.float32(rebuild_timing.JITTER) * np.float32(i)
    with jax.disable_jit():
        return jscene.build_scene(tri, cols, origin=np.zeros(3, np.float32),
                                  dps=1.0 / res, grid_res=res, accel="hako",
                                  chunk_tris=scale_demo.CHUNK)


def assert_build_equals_jax(rec, jt):
    pt = rec["tree"]
    for key in ("n_triangles", "n_dumped", "n_unique"):
        assert rec[key] == jt.build_stats[key], key
    assert pt.n_voxels == jt.n_voxels == rec["n_unique"]
    assert_matches_jax(jt, pt)
    np.testing.assert_array_equal(pt.color.numpy().view(np.uint32),
                                  np.asarray(jt.color)[: pt.n_voxels])


@pytest.fixture(scope="module")
def rebuilt(numpy_split):
    return rebuild_timing.run(res=RES, nsp=NSP, subdiv=SUBDIV, n=2, device="cpu",
                              keep_trees=True)


@pytest.mark.parametrize("i", [0, 1])
def test_rebuild_equals_jax(rebuilt, numpy_split, i):
    rec = rebuilt["builds"][i]
    assert (rec["build"], rec["tag"]) == (i, "cold" if i == 0 else "warm")
    assert rec["peak_bytes"] is None  # no device memory on the CPU
    assert rec["tree"].snodes is None
    assert_build_equals_jax(rec, jax_build(i, RES))


def test_rebuilds_see_new_values(rebuilt):
    """The jitter moves the mesh: the second build is not the first's."""
    a, b = (r["tree"] for r in rebuilt["builds"])
    assert rebuilt["mesh_triangles"] == 8 * 80  # 2^3 icospheres at subdivision 1
    assert (a.n_voxels, int(a.bricks.sum())) != (b.n_voxels, int(b.bricks.sum()))


def test_rebuild_fat_layout_equals_jax(numpy_split, monkeypatch):
    monkeypatch.setattr(jhako, "USE_SNODES_ABOVE", RES // 2)
    monkeypatch.setattr(hako, "USE_SNODES_ABOVE", RES // 2)
    rec = rebuild_timing.run(res=RES, nsp=NSP, subdiv=SUBDIV, n=1, device="cpu",
                             keep_trees=True)["builds"][0]
    assert rec["tree"].snodes is not None and rec["tree"].n_snodes > 0
    assert_build_equals_jax(rec, jax_build(0, RES))


def test_scale_demo_frame_and_png(tmp_path):
    out = str(tmp_path / "scale_demo.png")
    rec = scale_demo.run(res=RES, nsp=NSP, subdiv=2, width=64, height=48, out=out,
                         device="cpu")
    cam = camera.Camera.look_at(eye=np.full(3, 0.5) + np.array([0.9, 0.4, 1.4]) * 0.9,
                                target=np.full(3, 0.5), fovy_deg=45.0)
    img, depth = raycast.render_frame(rec["tree"], cam, 64, 48, show_color=True,
                                      device="cpu")
    assert torch.equal(rec["img"], img) and torch.equal(rec["depth"], depth)
    np.testing.assert_array_equal(png.read(out), img.numpy())
    hit = float((depth < 1e37).float().mean())
    assert rec["hit_fraction"] == hit and 0.2 < hit < 0.9
    assert rec["n_voxels"] == rec["tree"].n_voxels == rec["build_stats"]["n_unique"]
    assert rec["launches_a_frame"] == 0  # CPU tensors: the plain version
    assert "frame_ms" not in rec and "kernel_ms" not in rec  # no device time


@pytest.mark.parametrize("script", [microbench, pt_phase_attrib, pt_step_timing,
                                    rebuild_timing, scale_demo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_needs_a_card_or_the_cpu_flag(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
