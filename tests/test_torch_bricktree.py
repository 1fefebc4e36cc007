"""BrickTree64 of the PyTorch port (ops/bricktree.py) against the JAX
package's: the build equal (meta rows, node and level counts, the root,
the grid padded to a power of 4 and the `upper` that moves with it); the
walk equal to the JAX walk op by op (jax.disable_jit) bit for bit, and to
the jitted walk on discrete outputs with t within 16 ulps of max(|t|, 1)
(9 measured: XLA:CPU contracts the cell-plane chains into FMAs); the walk's
vidx is the voxel rank; the brick walk and the octree walk agree up to
classified ties (the port's utils/tiecheck.py), as the JAX package's own
test holds them; `from_numpy` of a JAX tree equals the port's build."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from massivevoxelraytracing_tpu.ops import bricktree as jbricktree
from massivevoxelraytracing_torch.models import accel, cpu_oracle, scene
from massivevoxelraytracing_torch.ops import bricktree, hako, morton, traverse2
from massivevoxelraytracing_torch.ops.camera import Camera
from massivevoxelraytracing_torch.utils import meshgen
from massivevoxelraytracing_torch.utils.tiecheck import (
    classify_structures,
    classify_vs_each_other,
)
from test_torch_octree import padded_pairs, port_octree, random_voxels
from test_torch_traverse import as_np, assert_discrete_equal, assert_matches_jitted, rays

torch.set_num_threads(1)



def jax_brick(m_u64, grid_res, dps):
    return jbricktree.build_bricktree(*padded_pairs(m_u64), len(m_u64), grid_res,
                                      lower=np.zeros(3, np.float32), dps=dps)


def port_brick(m_u64, grid_res, dps):
    return bricktree.build_bricktree(torch.from_numpy(m_u64.astype(np.int64)),
                                     grid_res, lower=np.zeros(3, np.float32),
                                     dps=dps)


def both(grid_res, n_vox, seed=0):
    rng = np.random.default_rng(seed)
    m = random_voxels(grid_res, n_vox, rng)
    dps = 1.0 / grid_res
    return m, jax_brick(m, grid_res, dps), port_brick(m, grid_res, dps), rng


@pytest.mark.parametrize("grid_res,n_vox", [(4, 10), (8, 100), (16, 300),
                                            (32, 2000), (128, 8000), (256, 20000)])
def test_build_equals_jax(grid_res, n_vox):
    m, jt, pt, _ = both(grid_res, n_vox, seed=grid_res)
    assert (pt.n_nodes, pt.root, pt.n_levels, pt.grid_res, pt.n_voxels) == (
        jt.n_nodes, jt.root, jt.n_levels, jt.grid_res, jt.n_voxels)
    assert pt.grid_res == bricktree.pad_res_pow4(grid_res) >= grid_res
    np.testing.assert_array_equal(np.asarray(jt.meta)[: pt.n_nodes],
                                  pt.meta.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jt.upper), pt.upper.numpy())
    assert pt.memory_bytes() == 16 * pt.n_nodes


@pytest.mark.parametrize("grid_res,n_vox", [(128, 12000)])
def test_walk_equals_jitted_jax(grid_res, n_vox):
    m, jt, pt, rng = both(grid_res, n_vox, seed=5)
    ro, rd = rays(m, grid_res, 1024, rng)
    got = [x.numpy() for x in bricktree.intersect_bricktree(pt, ro, rd)]
    assert (got[0] < 1e37).sum() > 300
    assert_matches_jitted(jbricktree.intersect_bricktree, jt, ro, rd, got)


def test_walk_equals_jax_op_by_op():
    m, jt, pt, rng = both(16, 300, seed=6)
    ro, rd = rays(m, 16, 24, rng)
    with jax.disable_jit():
        want = as_np(jbricktree.intersect_bricktree(jt, ro, rd))
    assert_discrete_equal(want, [x.numpy() for x in
                                 bricktree.intersect_bricktree(pt, ro, rd)])


@pytest.mark.parametrize("grid_res", [8, 16, 64])
def test_brick_equals_octree_up_to_ties(grid_res):
    dps = 1.0 / grid_res
    rng = np.random.default_rng(99)
    m = random_voxels(grid_res, grid_res * grid_res, rng)
    oct_tree = port_octree(m, grid_res, dps=dps)
    brick = port_brick(m, grid_res, dps)
    # from outside the box at voxel centres: the two walks round their
    # cell planes differently, so t agrees to rtol 1e-5 where t is not tiny
    n = 1024
    u = rng.normal(size=(n, 3))
    ro = (0.5 + 2.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    x, y, z = morton.np_decode(m[rng.integers(0, len(m), n)].astype(np.int64))
    rd = ((np.stack([x, y, z], -1) + 0.5) * dps - ro).astype(np.float32)
    t1, m1, v1 = (x.numpy() for x in traverse2.intersect_octree2(oct_tree, ro, rd))
    t2, m2, v2 = (x.numpy() for x in bricktree.intersect_bricktree(brick, ro, rd))
    assert (t1 < 1e37).sum() > 300
    n_tie = classify_vs_each_other(t1, m1, v1, t2, m2, v2, rtol=1e-5)
    assert n_tie <= n // 100, f"{n_tie}/{n} ties is implausibly many"


def test_vidx_is_the_voxel_rank():
    grid_res = 16
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 300, np.random.default_rng(7)).astype(np.int64)
    brick = port_brick(m, grid_res, dps)
    hits = 0
    for k in range(0, len(m), 7):
        x, y, z = morton.np_decode(m[k:k + 1])
        ctr = (np.array([x[0], y[0], z[0]], np.float32) + 0.5) * dps
        ro = np.array([[ctr[0], ctr[1], -3.0]], np.float32)
        rd = np.array([[0.0, 0.0, 1.0]], np.float32)
        t, _, vi = bricktree.intersect_bricktree(brick, ro, rd)
        to, _, vo = cpu_oracle.intersect_brute_force(m, (0, 0, 0), dps, ro[0], rd[0])
        assert np.isfinite(to) and float(t[0]) < 1e37
        assert int(vi[0]) == vo and np.isclose(float(t[0]), to, rtol=1e-5)
        hits += 1
    assert hits > 40


def test_single_level():
    # res 4: the root is a leaf brick
    m = np.unique(morton.np_encode(np.array([0, 1, 3]), np.array([0, 2, 3]),
                                   np.array([1, 1, 2])))
    brick = port_brick(m, 4, 0.25)
    assert brick.n_levels == 1 and brick.n_nodes == 1
    ro = np.array([[0.1, 0.1, -2.0], [0.3, 0.6, -2.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    t, _, vi = (x.numpy() for x in bricktree.intersect_bricktree(brick, ro, rd))
    for i in range(2):
        to, _, vo = cpu_oracle.intersect_brute_force(m, (0, 0, 0), 0.25, ro[i], rd[i])
        assert (t[i] < 1e37) == np.isfinite(to)
        if np.isfinite(to):
            assert vi[i] == vo


def test_from_numpy_equals_port_build():
    m, jt, pt, rng = both(64, 3000, seed=8)
    d = {f.name: (np.asarray(getattr(jt, f.name))
                  if hasattr(getattr(jt, f.name), "shape") else getattr(jt, f.name))
         for f in dataclasses.fields(jt)}
    got = bricktree.from_numpy(d, device="cpu")
    for name in ("meta", "lower", "upper"):
        assert torch.equal(getattr(got, name), getattr(pt, name)), name
    assert (got.n_nodes, got.root, got.n_levels, got.grid_res) == (
        pt.n_nodes, pt.root, pt.n_levels, pt.grid_res)
    ro, rd = rays(m, 64, 256, rng)
    for a, b in zip(bricktree.intersect_bricktree(got, ro, rd),
                    bricktree.intersect_bricktree(pt, ro, rd)):
        assert torch.equal(a, b)


def test_structures_frame_agrees_with_hako_up_to_classified_cases():
    """A camera frame of the sphere lattice through the HakoTree, the brick
    tree and the octree: every disagreement is a tie, a graze or plane
    drift (utils/tiecheck.classify_structures), chip_smoke.py's phase 7
    check at a small size."""
    grid_res = 128
    tri, cols = meshgen.sphere_lattice(3, 3)
    trees = {a: scene.build_scene(tri, cols, origin=np.zeros(3, np.float32),
                                  dps=1.0 / grid_res, grid_res=grid_res,
                                  device="cpu", accel=a)
             for a in ("hako", "brick", "octree")}
    c = np.full(3, 0.5, np.float32)
    cam = Camera.look_at(eye=c + np.array([0.9, 0.4, 1.4]) * 0.9, target=c,
                         fovy_deg=40.0)
    x, y = np.meshgrid(np.arange(160), np.arange(96))
    ro = np.broadcast_to(cam.o, (x.size, 3)).astype(np.float32)
    u = (2.0 * (x.ravel() + 0.5) / 160 - 1.0) * cam.tan_half_fovy * 160 / 96
    v = (1.0 - 2.0 * (y.ravel() + 0.5) / 96) * cam.tan_half_fovy
    rd = (u[:, None] * cam.right + v[:, None] * cam.up + cam.front).astype(np.float32)
    out = {}
    for name, tree in trees.items():
        kind, depth, meta, root = accel.accel_args(tree)
        out[name] = [t.numpy() for t in accel.intersect_with(
            kind, depth, meta, root, tree.lower, tree.upper,
            torch.from_numpy(ro), torch.from_numpy(rd))]
    assert (out["hako"][0] < 1e37).mean() > 0.2
    codes = hako.voxels_from_tree(trees["hako"]).astype(np.int64)
    for name in ("brick", "octree"):
        kinds = classify_structures(*out["hako"], *out[name], codes, (0, 0, 0),
                                    1.0 / grid_res, 1.0, ro, rd)
        assert sum(kinds.values()) <= len(ro) // 100, (name, kinds)

