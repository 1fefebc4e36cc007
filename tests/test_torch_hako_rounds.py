"""The port's legacy round driver (ops/hako_kernels.intersect_rays_hako:
kernels A, B and the merge under a host loop over rounds) in its plain
version, against the JAX package's intersect_hako run in interpret mode on
CPU as its own tests run it, on plain-layout trees (64^3: T = 1, 256^3:
T = 2; shadow rays against the reference in test_torch_hako_rounds_fat);
against the port's plain megakernel bit for bit (the two routes
share every per-lane function); capped resumes; the wrapper's CPU dispatch
and the accel switch `traversal="rounds"`.

Tolerance on t: test_torch_hako_mega's 8 ulps of max(|t|, 1) (XLA:CPU
contracts the reference's cell planes into FMAs; the port rounds the
product). Hit mask, nmajor and vrank are exact.
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_torch.models import accel, raycast
from massivevoxelraytracing_torch.ops import camera, hako_kernels as hk
from massivevoxelraytracing_torch.ops import hako_mega

from test_torch_hako_build import jax_tree, port_tree, random_voxels
from test_torch_hako_mega import assert_matches_reference, mixed_rays, plain

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def rounds_plain(tree, ro, rd, **kw):
    """The round driver's plain version on CPU tensors -> numpy (t, nmaj,
    vrank as u32), rounds; checks that every lane resolved."""
    (bricks, snodes, tabs, root), T = hk.hako_args(tree)
    t, nm, vr, unresolved, rounds = hk.intersect_rays_hako_plain(
        bricks, snodes, tabs, root, tree.lower, tree.upper,
        torch.from_numpy(ro), torch.from_numpy(rd), T=T, **kw)
    assert int(unresolved) == 0
    return (t.numpy(), nm.numpy(), vr.numpy().view(np.uint32)), rounds


_CASES = {}


def make_case(grid_res):
    """(port tree, rays, JAX legacy-driver reference); the interpret-mode
    reference runs once per tree in this module."""
    if grid_res not in _CASES:
        rng = np.random.default_rng(grid_res + 2)
        m = random_voxels(grid_res, grid_res * 24, rng)
        ro, rd = mixed_rays(m, grid_res, 512, rng)
        jt = jax_tree(m, grid_res)
        ref = tuple(np.asarray(x) for x in jk.intersect_hako(jt, ro, rd))
        _CASES[grid_res] = (jt, port_tree(m, grid_res), ro, rd, ref)
    return _CASES[grid_res]


@pytest.fixture(params=[64, 256])
def case(request):
    return make_case(request.param)


def test_rounds_plain_matches_jax(case):
    _jt, pt, ro, rd, ref = case
    got, rounds = rounds_plain(pt, ro, rd)
    assert rounds > 1
    assert_matches_reference(got, ref)


@pytest.mark.parametrize("shadow", [False, True])
def test_rounds_equal_megakernel_bit_for_bit(case, shadow):
    _jt, pt, ro, rd, _ref = case
    got, _ = rounds_plain(pt, ro, rd, shadow=shadow)
    for a, b in zip(got, plain(pt, ro, rd, shadow=shadow)):
        np.testing.assert_array_equal(a, b)


def clustered_case():
    """tests/test_hako.py's snode capped-resume scene: 30 clusters of
    voxels in a 2048^3 grid, rays aimed at voxels."""
    rng = np.random.default_rng(338)
    grid_res = 2048
    base = rng.integers(0, grid_res // 8, size=(30, 3)).astype(np.uint32) * 8
    off = rng.integers(0, 24, size=(50, 30, 3)).astype(np.uint32)
    c = (base[None, :, :] + off).reshape(-1, 3) % grid_res
    m = np.unique(jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]))
    n = 96
    ro = rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    x, y, z = jmorton.np_decode(m[rng.integers(0, len(m), n)])
    rd = ((np.stack([x, y, z], -1) + 0.5) / grid_res - ro).astype(np.float32)
    return port_tree(m, grid_res), ro, rd


@pytest.mark.parametrize("which", ["64", "clustered2048"])
def test_capped_resume_changes_nothing(which):
    """One probe per kernel-A call and one sub-brick visit per kernel-B
    call exercise every resume path: more rounds, the same traversal bit
    for bit (tests/test_hako.py:338's case, and 64^3)."""
    if which == "64":
        _jt, pt, ro, rd, _ref = make_case(64)
    else:
        pt, ro, rd = clustered_case()
    base, r_base = rounds_plain(pt, ro, rd)
    capped, r_capped = rounds_plain(pt, ro, rd, max_probes=1, max_dda=1)
    assert r_capped > r_base
    assert (base[0] < 1e37).any()
    for a, b, c in zip(base, capped, plain(pt, ro, rd)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_too_few_rounds_leave_lanes_unresolved():
    _jt, pt, ro, rd, _ref = make_case(64)
    (bricks, snodes, tabs, root), T = hk.hako_args(pt)
    out = hk.intersect_rays_hako_plain(
        bricks, snodes, tabs, root, pt.lower, pt.upper, torch.from_numpy(ro),
        torch.from_numpy(rd), T=T, max_rounds=1)
    assert out[4] == 1 and 0 < int(out[3]) <= len(ro)


def test_wrapper_runs_plain_version_on_cpu():
    """CPU tensors go to the plain versions: no kernel launch counted, the
    rounds counted, no lane left unresolved."""
    _jt, pt, ro, rd, _ref = make_case(64)
    hk.reset_counters()
    t, nm, vr = hk.intersect_hako(pt, ro, rd)
    assert hk.LAUNCHES == {"hako_rounds": 0, "hako_probe": 0, "hako_dda_merge": 0,
                           "hako_dda": 0, "hako_merge": 0, "hako_dda_cached": 0}
    assert hk.rounds_run() > 1 and hk.unresolved_lanes() == 0
    want, _ = rounds_plain(pt, ro, rd)
    np.testing.assert_array_equal(t.numpy(), want[0])
    np.testing.assert_array_equal(nm.numpy(), want[1])
    np.testing.assert_array_equal(vr.numpy().view(np.uint32), want[2])


def test_wrappers_refuse_other_devices():
    n = 4
    rays = torch.empty((n, 3), device="meta")
    idx = torch.empty(n, dtype=torch.int32, device="meta")
    f = torch.empty(n, device="meta")
    b = torch.empty(n, dtype=torch.bool, device="meta")
    bt1 = torch.empty((3, n), device="meta")
    rows = torch.empty((1, 164), dtype=torch.int32, device="meta")
    bounds = torch.empty(6, device="meta")
    with pytest.raises(ValueError):
        hk.hako_probe(None, (), 1, (1, 0), bounds, rays, rays, idx, f,
                      max_probes=4)
    with pytest.raises(ValueError):
        hk.hako_dda(rows, bounds, rays, rays, idx, b, idx, bt1, f,
                    dt_factor=0.25, leaf=True, shadow=False, max_iters=4)
    state = (b, f, f, idx, idx)
    with pytest.raises(ValueError):
        hk.hako_merge(state, idx, b, bt1, f, b, b, f, idx, idx, b, f)
    with pytest.raises(ValueError):
        hk.intersect_rays_hako(rows, None, (), (1, 0), torch.zeros(3),
                               torch.ones(3), rays, rays, T=1)
    # the refused calls leave no counter behind on that device
    assert hk.unresolved_lanes() == 0


def test_merge_plain_writes_only_served_active_lanes():
    """The merge: served active lanes take the round's results (t, nmaj,
    vrank on a hit; resolved on a hit or exhaustion; the next resume
    key), resolved and unserved lanes keep theirs."""
    r = 6
    state = (torch.tensor([False, False, True, False, False, False]),
             torch.zeros(r), torch.full((r,), hk.MAX_FLOAT),
             torch.full((r,), -1, dtype=torch.int32),
             torch.zeros(r, dtype=torch.int32))
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)  # lanes 4, 5 unserved
    emit = torch.tensor([True, True, True, False])
    bt1 = torch.tensor([[5.0, 6.0, 7.0, 8.0], [4.0, 9.0, 9.0, 9.0],
                        [9.0, 9.0, 9.0, 9.0]])
    tqn = torch.tensor([1.0, 2.0, 3.0, 4.0])
    exh = torch.tensor([False, False, False, True])
    hit = torch.tensor([True, False, True, False])
    t_hit = torch.tensor([0.5, 0.6, 0.7, 0.8])
    nmaj = torch.tensor([2, 1, 1, 0], dtype=torch.int32)
    vr = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    more = torch.tensor([False, True, False, False])
    tqr = torch.tensor([0.1, 0.2, 0.3, 0.4])
    hk.hako_merge(state, idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr, more, tqr)
    resolved, tq, t, nm, vrank = state
    assert resolved.tolist() == [True, False, True, True, False, False]
    assert tq.tolist() == pytest.approx([4.0, 0.2, 0.0, 4.0, 0.0, 0.0])
    miss = np.float32(hk.MAX_FLOAT)
    np.testing.assert_array_equal(
        t.numpy(), np.array([0.5, miss, miss, miss, miss, miss], np.float32))
    assert nm.tolist() == [2, -1, -1, -1, -1, -1]
    assert vrank.tolist() == [11, 0, 0, 0, 0, 0]


def test_accel_traversal_switch():
    _jt, pt, _ro, _rd, _ref = make_case(64)
    assert accel.accel_args(pt)[0] == "hako_mega"
    assert accel.accel_args(pt, "rounds")[0] == "hako"
    with pytest.raises(ValueError):
        accel.accel_args(pt, "legacy")


def test_render_frame_rounds_equals_mega():
    """The primary frame through traversal="rounds" equals the megakernel
    route's, image and depth bit for bit."""
    _jt, pt, _ro, _rd, _ref = make_case(256)
    cam = camera.Camera.look_at(eye=(0.5, 0.8, 2.2), target=(0.5, 0.5, 0.5),
                                fovy_deg=40.0)
    img_m, depth_m = raycast.render_frame(pt, cam, 40, 24, device="cpu")
    hako_mega.reset_counters()
    img_r, depth_r = raycast.render_frame(pt, cam, 40, 24, device="cpu",
                                          traversal="rounds")
    assert bool((depth_r < 1e37).any())
    np.testing.assert_array_equal(img_r.numpy(), img_m.numpy())
    np.testing.assert_array_equal(depth_r.numpy(), depth_m.numpy())

