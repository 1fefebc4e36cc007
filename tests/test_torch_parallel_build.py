"""The port's sharded scene build (parallel/build.py) on the CPU, on
tests/test_parallel_build.py's scene: icosphere(2) at 32^3, 128-triangle
chunks, emission on a fifth of the triangles (duplicate means on both
channels).

  * Against itself and against models.scene.build_scene: every field of
    the tree bit for bit, at 2 and 8 shards, for the octree, the brick
    tree and the HakoTree. The port voxelizes per triangle with every op
    rounded, so the shard count and the build path change no bit.
  * Against the JAX package's build_scene_sharded over its 8 virtual CPU
    devices (jitted): voxel and node counts within that test's own bounds
    (n // 66 voxels, n // 50 nodes), and the voxel set equal up to the
    1.5% tie band that XLA's multiply-add contraction moves
    (test_torch_voxelize: the port equals the reference op by op).
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.parallel import build as jbuild
from massivevoxelraytracing_torch.entry import trees_equal
from massivevoxelraytracing_torch.models import scene
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.parallel import build as pbuild
from massivevoxelraytracing_torch.parallel import mesh as mesh_lib
from massivevoxelraytracing_torch.utils import meshgen

from test_torch_hako_build import jax_tree_dict

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

GRID = 32


def scene_inputs():
    tri = meshgen.icosphere(2, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, GRID)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    emi = np.zeros_like(col)
    emi[: len(emi) // 5] = 0.5
    return tri, col, emi, dict(origin=origin, dps=dps, grid_res=GRID,
                               chunk_tris=128)


@pytest.fixture(scope="module")
def inputs():
    return scene_inputs()


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("accel", ["octree", "brick", "hako"])
def test_sharded_build_equals_build_scene(inputs, accel, n_devices):
    tri, col, emi, kw = inputs
    single = scene.build_scene(tri, col, emi, accel=accel, device="cpu", **kw)
    sharded = pbuild.build_scene_sharded(tri, col, emi, accel=accel,
                                         n_devices=n_devices, device="cpu", **kw)
    assert trees_equal(single, sharded)
    assert sharded.build_stats["n_devices"] == n_devices
    for key in ("n_triangles", "n_dumped", "n_unique", "n_nodes", "accel_bytes"):
        assert sharded.build_stats[key] == single.build_stats[key], key
    assert sharded.has_emission


def test_partition_invariance_on_an_explicit_mesh(inputs):
    """The same tree from a mesh given by the caller and from n_devices,
    at 3 shards (chunks that do not divide evenly before padding)."""
    tri, col, emi, kw = inputs
    mesh = mesh_lib.make_build_mesh(3, device="cpu")
    assert mesh.axis_names == ("dp",) and mesh.size == 3
    a = pbuild.build_scene_sharded(tri, col, emi, mesh=mesh, accel="hako", **kw)
    b = pbuild.build_scene_sharded(tri, col, emi, n_devices=8, device="cpu",
                                   accel="hako", **kw)
    assert trees_equal(a, b) and a.build_stats["n_devices"] == 3


def test_buffer_retry_keeps_the_tree(inputs, monkeypatch):
    """The count pass sizes each shard's dump buffers exactly (the valid
    candidates of its triangles), so the JAX package's retry loop (a buffer
    too small for the worst shard, doubled and the pass rerun) has nothing
    left to retry: every entry of every buffer is written once before the
    group unique reads it, the sizes add up to n_dumped, and the tree is
    the one build_scene gives."""
    tri, col, emi, kw = inputs
    want = scene.build_scene(tri, col, emi, device="cpu", accel="hako", **kw)
    sizes = []
    real_buffers = pbuild.scene_mod._dump_buffers
    real_sums = pbuild.vox_ops.sort_and_unique_sums

    def buffers(n, device):
        bufs = real_buffers(n, device)
        for b in bufs:
            b.fill_(-7)  # no Morton code is negative
        sizes.append(n)
        return bufs

    def sums(code, color, emission, *a, **k):
        assert bool((code >= 0).all()), "a dump buffer entry was never written"
        return real_sums(code, color, emission, *a, **k)

    monkeypatch.setattr(pbuild.scene_mod, "_dump_buffers", buffers)
    monkeypatch.setattr(pbuild.vox_ops, "sort_and_unique_sums", sums)
    got = pbuild.build_scene_sharded(tri, col, emi, n_devices=2, device="cpu",
                                     accel="hako", **kw)
    assert len(sizes) == 2 and min(sizes) > 0
    assert sum(sizes) == got.build_stats["n_dumped"] == want.build_stats["n_dumped"]
    assert trees_equal(want, got)


def test_cuda_mesh_raises_without_a_card(inputs, monkeypatch):
    tri, col, emi, kw = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        pbuild.build_scene_sharded(tri, col, emi, n_devices=2, **kw)


@pytest.mark.parametrize("accel", ["octree", "brick", "hako"])
def test_close_to_jax_sharded_build(inputs, accel):
    tri, col, emi, kw = inputs
    jt = jbuild.build_scene_sharded(tri, col, emi, n_devices=8, accel=accel, **kw)
    pt = pbuild.build_scene_sharded(tri, col, emi, n_devices=8, device="cpu",
                                    accel=accel, **kw)
    assert jt.build_stats["n_devices"] == pt.build_stats["n_devices"] == 8
    nj, np_ = jt.build_stats["n_unique"], pt.build_stats["n_unique"]
    assert abs(nj - np_) <= max(2, nj // 66), (nj, np_)
    assert abs(jt.n_nodes - pt.n_nodes) <= max(2, jt.n_nodes // 50)
    if accel == "hako":
        want = hako.voxels_from_tree(hako.from_numpy(jax_tree_dict(jt),
                                                     device="cpu"))
        got = hako.voxels_from_tree(pt)
        assert len(np.setxor1d(want, got)) <= max(2, nj // 66)
