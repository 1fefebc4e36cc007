"""The port's megakernel plain version (ops/hako_mega.py) against the JAX
package's hako_mega.intersect_hako_mega, run in interpret mode on CPU as
its own tests run it, on plain-layout trees (64^3: T = 1, 256^3: T = 2);
against the brute-force AABB oracle; shadow any-hit; probe / DDA caps;
the walk against the 64-cell scan; and the wrapper's CPU dispatch.

Tolerance on t. XLA:CPU contracts the reference's cell plane
`t1 - dc * (4 - k)` (hako_kernels._plane) into a fused multiply-add, even
behind its optimization barrier: `test_walk64_contraction_site` shows the
jitted reference walk differing from itself evaluated op by op, and the
port equal to the op-by-op evaluation bit for bit. The port rounds the
product, as the TPU kernel and the CUDA kernel do. So t differs from the
interpret-mode reference by a few ulps (measured at most 3 ulps of
max(|t|, 1)); the bound is 8. Hit mask, nmajor and vrank stay exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.models import cpu_oracle
from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_tpu.ops import hako_mega as jmega
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_torch.ops import hako_kernels as tk
from massivevoxelraytracing_torch.ops import hako_mega

from test_torch_hako_build import jax_tree, port_tree, random_voxels

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

T_FMA_ULPS = 8


def mixed_rays(m_u64, grid_res, n, rng):
    """Half random rays, half aimed at voxel centers."""
    dps = 1.0 / grid_res
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    x, y, z = jmorton.np_decode(m_u64[rng.integers(0, len(m_u64), n // 2)])
    target = (np.stack([x, y, z], -1) + 0.5) * dps
    rd[: n // 2] = (
        target - ro[: n // 2] + rng.normal(size=(n // 2, 3)) * 2e-4
    ).astype(np.float32)
    return ro, rd


def plain(tree, ro, rd, **kw):
    """The plain version on CPU tensors -> numpy (t, nmaj, vrank), and
    checks that every lane resolved."""
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    t, nm, vr, unresolved = hako_mega.intersect_rays_hako_mega_plain(
        bricks, snodes, tabs, root, tree.lower, tree.upper,
        torch.from_numpy(ro), torch.from_numpy(rd), T=T, **kw)
    assert int(unresolved) == 0
    return t.numpy(), nm.numpy(), vr.numpy().view(np.uint32)


def assert_t_close(t_port, t_ref):
    """|dt| within T_FMA_ULPS ulps of max(|t|, 1) (module docstring)."""
    scale = np.spacing(np.maximum(np.abs(t_ref), 1.0).astype(np.float32))
    err = np.abs(t_port.astype(np.float64) - t_ref.astype(np.float64))
    assert np.all(err <= T_FMA_ULPS * scale), float((err / scale).max())


def assert_matches_reference(port, ref):
    (tp, nmp, vrp), (tj, nmj, vrj) = port, ref
    hit = tj < 1e37
    np.testing.assert_array_equal(tp < 1e37, hit)
    np.testing.assert_array_equal(nmp, nmj)
    np.testing.assert_array_equal(vrp, vrj)
    assert_t_close(tp[hit], tj[hit])
    assert hit.any() and (~hit).any()


_CASES = {}


def make_case(grid_res):
    """(voxels, JAX tree, port tree, rays, JAX reference result); the
    interpret-mode reference runs once per tree in this module."""
    if grid_res not in _CASES:
        rng = np.random.default_rng(grid_res + 1)
        m = random_voxels(grid_res, grid_res * 24, rng)
        ro, rd = mixed_rays(m, grid_res, 1024, rng)
        jt = jax_tree(m, grid_res)
        ref = tuple(np.asarray(x) for x in jmega.intersect_hako_mega(jt, ro, rd))
        _CASES[grid_res] = (m, jt, port_tree(m, grid_res), ro, rd, ref)
    return _CASES[grid_res]


@pytest.fixture(params=[64, 256])
def case(request):
    return make_case(request.param)


def test_plain_matches_jax(case):
    _m, _jt, pt, ro, rd, ref = case
    assert_matches_reference(plain(pt, ro, rd), ref)


def test_plain_shadow_matches_jax():
    """Any-hit: the same hit mask as the reference's shadow rays, rank 0
    (one interpret-mode shadow reference, 64^3, keeps the file fast)."""
    _m, jt, pt, ro, rd, _ref = make_case(64)
    tj, nmj, vrj = (np.asarray(x) for x in
                    jmega.intersect_hako_mega(jt, ro, rd, shadow=True))
    tp, nmp, vrp = plain(pt, ro, rd, shadow=True)
    np.testing.assert_array_equal(tp < 1e37, tj < 1e37)
    np.testing.assert_array_equal(nmp, nmj)
    np.testing.assert_array_equal(vrp, 0)


def test_caps_do_not_change_results(case):
    """One probe / one DDA step per round exercises every resume path:
    more rounds, the same traversal, bit for bit."""
    _m, _jt, pt, ro, rd, _ref = case
    base = plain(pt, ro, rd)
    capped = plain(pt, ro, rd, max_probes=1, max_dda=1)
    for a, b in zip(base, capped):
        np.testing.assert_array_equal(a, b)


def test_plain_matches_brute_force():
    """The axis-parallel and origin-inside rays of the reference's
    test_mega_matches_brute_force, against the slab-test oracle."""
    from tiecheck import assert_face_tie

    rng = np.random.default_rng(3)
    grid_res = 64
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 2048, rng)
    pt = port_tree(m, grid_res)
    n = 256
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro[:8] = np.array([0.503, 0.497, -2.0], np.float32)
    rd[:2] = np.array([0.0, 0.0, 1.0], np.float32)
    rd[2:4] = np.array([0.0, 1.0, 0.0], np.float32)[None]
    ro[4:8] = np.array([0.503, 0.497, 0.501], np.float32)

    t, nm, vi = plain(pt, ro, rd)
    oracle = [cpu_oracle.intersect_brute_force(m, (0, 0, 0), dps, ro[i], rd[i])
              for i in range(n)]
    to = np.array([o[0] for o in oracle], np.float32)
    nmo = np.array([o[1] for o in oracle])
    vio = np.array([o[2] for o in oracle])
    hit = t < 1e37
    np.testing.assert_array_equal(hit, np.isfinite(to))
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(t[hit], to[hit], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(vi[hit], vio[hit])
    # the face axis may differ only at exact edge/corner ties
    for i in np.nonzero(hit & (nm != nmo))[0]:
        assert_face_tie(i, m[int(vi[i])], np.zeros(3, np.float32), dps,
                        ro[i], rd[i])


def walk_inputs(n=20000, seed=2):
    rng = np.random.default_rng(seed)
    t1 = rng.uniform(0.5, 3.0, (3, n)).astype(np.float32)
    dc = rng.uniform(0.01, 0.3, (3, n)).astype(np.float32)
    tq = rng.uniform(-0.5, 3.0, n).astype(np.float32)
    ml = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    mh = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vm6 = rng.integers(0, 64, n).astype(np.int32)
    return ml, mh, vm6, t1, dc, tq


def port_walk(fn, ml, mh, vm6, t1, dc, tq):
    out = fn(torch.from_numpy(ml.view(np.int32)).long(),
             torch.from_numpy(mh.view(np.int32)).long(),
             torch.from_numpy(vm6).long(), torch.from_numpy(t1),
             torch.from_numpy(dc), torch.from_numpy(tq))
    return [x.numpy() for x in out]


def test_walk64_equals_scan64():
    args = walk_inputs()
    walk = port_walk(tk._walk64_impl, *args)
    scan = port_walk(tk._scan64_impl, *args)
    for a, b in zip(walk, scan):
        np.testing.assert_array_equal(a, b)
    assert (walk[2] < 64).any() and (walk[2] == 64).any()


def test_walk64_contraction_site():
    """The port's walk equals the reference's walk evaluated op by op
    (no fusion, so no FMA) bit for bit; the jitted reference picks the
    same cells but contracts the planes (the t tolerance above)."""
    ml, mh, vm6, t1, dc, tq = walk_inputs(n=2000)
    port = port_walk(tk._walk64_impl, ml, mh, vm6, t1, dc, tq)
    jargs = (jnp.asarray(ml), jnp.asarray(mh), jnp.asarray(vm6),
             *[jnp.asarray(t1[a]) for a in range(3)],
             *[jnp.asarray(dc[a]) for a in range(3)], jnp.asarray(tq))
    with jax.disable_jit():
        op_by_op = [np.asarray(x) for x in jk._walk64_impl(*jargs)]
    for a, b in zip(port, op_by_op):
        np.testing.assert_array_equal(a, b)
    jitted = [np.asarray(x) for x in
              jax.jit(lambda *a: jk._walk64_impl(*a, stable=True))(*jargs)]
    np.testing.assert_array_equal(jitted[2], port[2])
    assert not np.array_equal(jitted[0], port[0])  # the contracted planes


def test_ray_preamble_matches_jax():
    rng = np.random.default_rng(9)
    n = 4096
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:16, 0] = 0.0
    rd[16:32, 1] = -0.0
    lo = np.array([0.0, -0.25, 0.5], np.float32)
    up = lo + np.float32(1.5)
    ref = jax.jit(lambda lo, up, ro, rd: jk._ray_preamble(
        [lo[0], lo[1], lo[2]], [up[0], up[1], up[2]],
        [ro[:, 0], ro[:, 1], ro[:, 2]], [rd[:, 0], rd[:, 1], rd[:, 2]],
        True))(lo, up, ro, rd)
    got = tk._ray_preamble(*(torch.from_numpy(a) for a in (lo, up, ro, rd)))
    for k in range(3):
        np.testing.assert_array_equal(
            got[k].numpy(), np.stack([np.asarray(x) for x in ref[k]]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_wrapper_runs_plain_version_on_cpu():
    """CPU tensors go to the plain version: no kernel launch counted, no
    lane left unresolved."""
    _m, _jt, pt, ro, rd, _ref = make_case(64)
    hako_mega.reset_counters()
    t, nm, vr = hako_mega.intersect_hako_mega(pt, ro, rd)
    assert hako_mega.LAUNCHES == 0
    assert hako_mega.unresolved_lanes() == 0
    want = plain(pt, ro, rd)
    np.testing.assert_array_equal(t.numpy(), want[0])
    np.testing.assert_array_equal(nm.numpy(), want[1])
    np.testing.assert_array_equal(vr.numpy().view(np.uint32), want[2])


def test_wrapper_refuses_other_devices():
    rays = torch.empty((4, 3), device="meta")
    rows = torch.empty((1, 164), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hako_mega.intersect_rays_hako_mega(
            rows, None, (), (1, 0), torch.zeros(3), torch.ones(3), rays,
            rays, T=1)
    # the refused call leaves no counter behind on that device
    assert hako_mega.unresolved_lanes() == 0


def test_default_max_rounds():
    assert hako_mega.default_max_rounds(1024) == 3 * 64 + 64
    assert hako_mega.default_max_rounds(64) == 3 * 4 + 64
    assert hako_mega.default_max_rounds(256, 1, 1) == (3 * 16 + 64) * 4 * 24
