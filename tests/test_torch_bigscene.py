"""The port's scene-memory sharding (parallel/bigscene.py) on the CPU, on
tests/test_bigscene.py's scene (icosphere(3) at 64^3, 1,536 rays from
one eye to seeded targets).

  * Shards against the JAX package's shard_hako_tree of the same JAX tree
    (`hako.from_numpy` on both sides): rows, levels, supernodes, root
    masks, attributes and voxel bases equal, at 2 and 4 shards.
  * The sharded traversal against the port's whole-tree traversal, with
    the JAX test's bars: hit sets equal, t within rtol 1e-6, nmajor and
    the global voxel index equal, more than one shard winning hits; shadow
    rays (any hit) at 3 shards; shaded pixels above 0.999 agreement.
    (Measured: every output bit-equal; the whole tree is traced by the
    megakernel's plain version, the shards by the round driver's.)
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.parallel import bigscene as jbigscene
from massivevoxelraytracing_tpu.utils import meshgen
from massivevoxelraytracing_torch.models import raycast, scene
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.ops.hako_kernels import intersect_hako
from massivevoxelraytracing_torch.parallel import bigscene

from test_torch_hako_build import assert_trees_equal, jax_tree_dict

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

MISS = 1e37
GRID = 64


def scene_inputs():
    tri = meshgen.icosphere(3, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, GRID)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    return tri, col, dict(origin=origin, dps=dps, grid_res=GRID, accel="hako")


def rays(origin, dps, n=1536):
    extent = float(dps) * GRID
    center = np.asarray(origin) + extent / 2
    rng = np.random.default_rng(11)
    ro = np.tile((center + np.array([0.8, 0.5, 1.5]) * extent).astype(np.float32),
                 (n, 1))
    target = np.asarray(origin) + extent * rng.uniform(0.1, 0.9, (n, 3))
    return ro, (target - ro).astype(np.float32)


@pytest.fixture(scope="module")
def port_scene():
    tri, col, kw = scene_inputs()
    tree = scene.build_scene(tri, col, device="cpu", **kw)
    return tree, *rays(kw["origin"], kw["dps"])


@pytest.fixture(scope="module")
def jax_tree():
    tri, col, kw = scene_inputs()
    return jscene.build_scene(tri, col, **kw)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shards_equal_jax_shards(jax_tree, n_shards):
    jt = jax_tree
    want = jbigscene.shard_hako_tree(jt, n_shards)
    got = bigscene.shard_hako_tree(hako.from_numpy(jax_tree_dict(jt), device="cpu"),
                                   n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert_trees_equal(g, hako.from_numpy(jax_tree_dict(w), device="cpu"))
        assert g.voxel_base == w.voxel_base
    assert sum(s.n_bricks for s in got) == jt.n_bricks
    assert sum(s.n_voxels for s in got) == jt.n_voxels


def test_shard_rows_and_bases(port_scene):
    """Shards reuse the rows as they are apart from the rebased voxel base;
    each shard's base is its first brick's; devices are honoured."""
    tree, _ro, _rd = port_scene
    shards = bigscene.shard_hako_tree(tree, 3, devices=["cpu"])
    rows = torch.cat([s.bricks for s in shards])
    base = torch.cat([s.bricks[:, bigscene.BASE_COL] + s.voxel_base
                      for s in shards])
    keep = [c for c in range(rows.shape[1]) if c != bigscene.BASE_COL]
    assert torch.equal(rows[:, keep], tree.bricks[:, keep])
    assert torch.equal(base, tree.bricks[:, bigscene.BASE_COL])
    assert [int(s.bricks[0, bigscene.BASE_COL]) for s in shards] == [0, 0, 0]
    assert all(s.device == torch.device("cpu") for s in shards)
    with pytest.raises(ValueError):
        bigscene.shard_hako_tree(tree, tree.n_bricks + 1)
    assert dataclasses.is_dataclass(shards[0])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_scene_matches_full_tree(port_scene, n_shards):
    tree, ro, rd = port_scene
    t1, nm1, vi1 = intersect_hako(tree, ro, rd)
    shards = bigscene.shard_hako_tree(tree, n_shards)
    assert sum(s.n_bricks for s in shards) == tree.n_bricks
    assert sum(s.n_voxels for s in shards) == tree.n_voxels
    t2, nm2, vi2, win = bigscene.intersect_sharded(shards, ro, rd)
    hit1, hit2 = t1 < MISS, t2 < MISS
    assert torch.equal(hit1, hit2), "hit sets differ"
    np.testing.assert_allclose(t2[hit2].numpy(), t1[hit1].numpy(), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(vi1[hit1], vi2[hit2])
    assert torch.equal(nm1[hit1], nm2[hit2])
    assert len(torch.unique(win[hit2])) > 1, "rays all won by one shard?"
    assert torch.equal(vi2[~hit2], torch.zeros_like(vi2[~hit2]))


def test_sharded_scene_shadow_anyhit(port_scene):
    tree, ro, rd = port_scene
    t1 = intersect_hako(tree, ro, rd, shadow=True)[0]
    t2 = bigscene.intersect_sharded(bigscene.shard_hako_tree(tree, 3), ro, rd,
                                    shadow=True)[0]
    assert torch.equal(t1 < MISS, t2 < MISS)


def test_sharded_scene_render_matches(port_scene):
    tree, ro, rd = port_scene
    ro, rd = ro[:1024], rd[:1024]
    img1, t1 = raycast.render_rays(tree, ro, rd, show_color=True)
    img2, t2 = bigscene.render_rays_sharded(bigscene.shard_hako_tree(tree, 4),
                                            ro, rd, show_color=True)
    assert (img1 == img2).all(dim=-1).float().mean() > 0.999
    assert torch.equal(t1 < MISS, t2 < MISS)


def test_sharded_traversal_against_jax(port_scene, jax_tree):
    """The port's sharded traversal of the JAX tree's shards against the
    JAX package's intersect_sharded (its round driver in interpret mode),
    on 256 of the rays: hit sets, nmajor, global voxel index and winning
    shard equal, t
    within 8 ulps of max(|t|, 1) (XLA contracts the cell plane into an FMA,
    test_torch_hako_mega)."""
    jt = jax_tree
    _tree, ro, rd = port_scene
    ro, rd = ro[:256], rd[:256]
    jshards = jbigscene.shard_hako_tree(jt, 2, devices=jax.devices()[:2])
    tj, nmj, vij, winj = jbigscene.intersect_sharded(jshards, ro, rd)
    pshards = bigscene.shard_hako_tree(
        hako.from_numpy(jax_tree_dict(jt), device="cpu"), 2)
    tp, nmp, vip, winp = (x.numpy() for x in bigscene.intersect_sharded(
        pshards, ro, rd))
    hit = tj < MISS
    np.testing.assert_array_equal(tp < MISS, hit)
    np.testing.assert_array_equal(nmp[hit], nmj[hit])
    np.testing.assert_array_equal(vip.view(np.uint32)[hit], vij[hit])
    np.testing.assert_array_equal(winp[hit], winj[hit])
    scale = np.spacing(np.maximum(np.abs(tj[hit]), 1.0).astype(np.float32))
    assert np.all(np.abs(tp[hit].astype(np.float64) - tj[hit]) <= 8 * scale)
    assert hit.any() and (~hit).any()
