"""The octree walks of the PyTorch port (ops/traverse.py v1, the
reference's advance-one-axis state machine; ops/traverse2.py v2, one
iteration a node visit), against the JAX package's intersect_octree /
intersect_octree2 on the same tree and rays:

  * evaluated op by op (jax.disable_jit: no fusion, no FMA) the reference
    gives the port's bits exactly: t, nmajor and the voxel rank;
  * against the jitted reference, whose XLA:CPU program contracts the
    walk's t1 - dt * scale chains into FMAs (level after level), t is
    within 16 ulps of max(|t|, 1) (10 measured) and the hit mask, nmajor
    and the voxel rank are equal, except on rays where the contraction
    flips an exact float tie (at most 1%, about 1 in 1,000 rays seen):
    each such ray is traced again by the reference op by op and must then
    equal the port bit for bit;
  * v1 and v2 agree up to classified ties (the port's utils/tiecheck.py,
    a copy of tests/tiecheck.py), as the JAX package's own v1 / v2 test
    holds them;
  * the walk of a JAX-built tree taken through octree.from_numpy equals the
    walk of the port's own build; `max_iters` cuts every lane at the same
    iteration as the reference;
  * hits agree with the brute-force slab oracle up to ties and grazes."""

import numpy as np
import jax
import pytest
import torch

from massivevoxelraytracing_tpu.ops import traverse as jtraverse
from massivevoxelraytracing_tpu.ops import traverse2 as jtraverse2
from massivevoxelraytracing_torch.models import cpu_oracle
from massivevoxelraytracing_torch.ops import morton, octree, traverse, traverse2
from massivevoxelraytracing_torch.utils.tiecheck import (
    classify_vs_each_other,
    classify_vs_oracle,
)
from test_torch_octree import jax_octree, jax_octree_dict, port_octree, random_voxels

torch.set_num_threads(1)

T_ULPS = 16


def rays(m_u64, grid_res, n, rng):
    """Random rays around the unit box, half aimed at voxel centres, and a
    few axis-parallel ones."""
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    x, y, z = morton.np_decode(m_u64[rng.integers(0, len(m_u64), n // 2)].astype(np.int64))
    target = (np.stack([x, y, z], -1) + 0.5) / grid_res
    rd[: n // 2] = (target - ro[: n // 2]).astype(np.float32)
    rd[:8, 1:] = 0.0
    rd[8:16, ::2] = 0.0
    return ro, rd


def as_np(out):
    return [np.asarray(x) for x in out]


def ulps(a, b):
    h = a < 1e37
    if not h.any():
        return 0.0
    return float((np.abs(a[h] - b[h]) / np.spacing(np.maximum(np.abs(a[h]), 1))).max())


def assert_discrete_equal(want, got, t_ulps=None):
    """want: the JAX outputs (t f32, nmajor i32, vidx u32); got: the port's."""
    tw, nw, vw = want
    tg, ng, vg = got
    np.testing.assert_array_equal(tw < 1e37, tg < 1e37)
    np.testing.assert_array_equal(nw, ng)
    np.testing.assert_array_equal(vw.view(np.int32), vg)
    if t_ulps is None:
        np.testing.assert_array_equal(tw.view(np.int32), tg.view(np.int32))
    else:
        assert ulps(tw, tg) <= t_ulps


def assert_matches_jitted(jfn, jtree, ro, rd, got, **kw):
    """The port's outputs `got` against the jitted reference: t within
    T_ULPS everywhere both hit; a ray whose discrete outputs differ must be
    an FMA-flipped tie: the reference traced op by op gives the port's
    bits there. Returns the number of such rays."""
    want = as_np(jfn(jtree, ro, rd, **kw))
    tw, nw, vw = want
    tg, ng, vg = got
    off = ((tw < 1e37) != (tg < 1e37)) | (nw != ng) | (vw.view(np.int32) != vg)
    idx = np.nonzero(off)[0]
    assert len(idx) <= len(ro) // 100, f"{len(idx)} rays differ"
    keep = ~off
    assert_discrete_equal([x[keep] for x in want], [x[keep] for x in got], T_ULPS)
    if len(idx):
        with jax.disable_jit():
            exact = as_np(jfn(jtree, ro[idx], rd[idx], **kw))
        assert_discrete_equal(exact, [x[idx] for x in got])
    return len(idx)


def both(grid_res, n_vox, dag=True, seed=0):
    """Voxels, the JAX octree, the port's octree and a seeded generator."""
    rng = np.random.default_rng(seed)
    m = random_voxels(grid_res, n_vox, rng)
    dps = 1.0 / grid_res
    return (m, jax_octree(m, grid_res, dag, dps=dps),
            port_octree(m, grid_res, dag, dps=dps), rng)


WALKS = {
    "v1": (jtraverse.intersect_octree, traverse.intersect_octree),
    "v2": (jtraverse2.intersect_octree2, traverse2.intersect_octree2),
}


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("walk", ["v1", "v2"])
@pytest.mark.parametrize("grid_res,n_vox,dag", [(16, 300, True), (64, 3000, False),
                                                 (256, 20000, True)])
def test_walk_equals_jitted_jax(walk, grid_res, n_vox, dag, shadow):
    m, jt, pt, rng = both(grid_res, n_vox, dag, seed=grid_res)
    ro, rd = rays(m, grid_res, 1024, rng)
    jfn, pfn = WALKS[walk]
    got = [x.numpy() for x in pfn(pt, ro, rd, shadow=shadow)]
    assert (got[0] < 1e37).sum() > 300
    assert_matches_jitted(jfn, jt, ro, rd, got, shadow=shadow)


@pytest.mark.parametrize("walk", ["v1", "v2"])
def test_walk_equals_jax_op_by_op(walk):
    m, jt, pt, rng = both(32, 600, seed=1)
    ro, rd = rays(m, 32, 96, rng)
    jfn, pfn = WALKS[walk]
    with jax.disable_jit():
        want = as_np(jfn(jt, ro, rd))
    assert_discrete_equal(want, [x.numpy() for x in pfn(pt, ro, rd)])


@pytest.mark.parametrize("grid_res", [8, 32, 64])
def test_v2_equals_v1_up_to_ties(grid_res):
    rng = np.random.default_rng(77)
    m = random_voxels(grid_res, grid_res * grid_res, rng)
    tree = port_octree(m, grid_res, dps=1.0 / grid_res)
    n = 1024
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    t1, m1, v1 = (x.numpy() for x in traverse.intersect_octree(tree, ro, rd))
    t2, m2, v2 = (x.numpy() for x in traverse2.intersect_octree2(tree, ro, rd))
    n_tie = classify_vs_each_other(t1, m1, v1, t2, m2, v2, rtol=1e-6)
    assert n_tie <= n // 100, f"{n_tie}/{n} ties is implausibly many"


def test_walk_of_a_jax_tree_equals_walk_of_the_port_build():
    m, jt, pt, rng = both(64, 3000, seed=2)
    got = octree.from_numpy(jax_octree_dict(jt), device="cpu")
    ro, rd = rays(m, 64, 512, rng)
    for fn in (traverse.intersect_octree, traverse2.intersect_octree2):
        for a, b in zip(fn(got, ro, rd), fn(pt, ro, rd)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("max_iters", [1, 3, 9])
def test_max_iters_cuts_like_jax(max_iters):
    m, jt, pt, rng = both(64, 3000, seed=3)
    ro, rd = rays(m, 64, 256, rng)
    got = [x.numpy() for x in traverse2.intersect_octree2(pt, ro, rd,
                                                          max_iters=max_iters)]
    assert_matches_jitted(jtraverse2.intersect_octree2, jt, ro, rd, got,
                          max_iters=max_iters)
    full = traverse2.intersect_octree2(pt, ro, rd)[0].numpy()
    assert (got[0] < 1e37).sum() < (full < 1e37).sum()


def test_walks_agree_with_brute_force():
    grid_res = 16
    dps = 1.0 / grid_res
    rng = np.random.default_rng(4)
    m = random_voxels(grid_res, 400, rng)
    tree = port_octree(m, grid_res, dps=dps)
    # from a sphere around the grid at interior points (tests/test_traverse.py)
    n = 96
    u = rng.normal(size=(n, 3))
    ro = (0.5 + 2.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    rd = (rng.uniform(0.1, 0.9, (n, 3)) - ro).astype(np.float32)
    m64 = m.astype(np.int64)
    for fn in (traverse.intersect_octree, traverse2.intersect_octree2):
        t, nmaj, vidx = (x.numpy() for x in fn(tree, ro, rd))
        for i in range(len(ro)):
            to, no, vo = cpu_oracle.intersect_brute_force(m64, (0, 0, 0), dps,
                                                          ro[i], rd[i])
            if (t[i] < 1e37) == np.isfinite(to) and (
                    t[i] >= 1e37 or (vidx[i] == vo and np.isclose(t[i], to, rtol=2e-5))):
                continue
            classify_vs_oracle(i, m64, (0, 0, 0), dps, ro[i], rd[i], t[i], vidx[i], to, vo)
