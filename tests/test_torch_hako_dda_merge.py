"""The round's row stage in one launch (ops/hako_kernels.hako_dda_merge:
kernel B on the supernode and brick rows and the merge) in its plain
version on the CPU: against the unfused stage (hako_dda, the supernode
hand-off, hako_dda, hako_merge) bit for bit on the inputs of every round,
primary and shadow rays, with capped DDA iterations so that resumed lanes
and supernode misses arise; the round driver with the fused stage against
the JAX package's intersect_hako in interpret mode, on a plain 64^3 tree
and a fat 512^3 one (USE_SNODES_ABOVE 128 in both packages, T = 1); the
wrapper's CPU dispatch and its refusal of other devices.

Tolerance on t against the reference: test_torch_hako_mega's 8 ulps of
max(|t|, 1) (XLA:CPU contracts the reference's cell planes into FMAs; the
port rounds the product). Hit mask, nmajor and vrank are exact.
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.ops import hako_kernels as hk

from test_torch_hako_build import jax_tree, port_tree, random_voxels
from test_torch_hako_mega import assert_matches_reference, mixed_rays

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N_RAYS = 128
_CASES = {}


def make_case(fat: bool):
    """(port tree, rays, JAX reference) of a plain 64^3 or a fat 512^3
    tree; the interpret-mode reference runs once per tree in this module."""
    if fat not in _CASES:
        grid_res, n_vox = (512, 8000) if fat else (64, 64 * 24)
        mp = pytest.MonkeyPatch()
        if fat:
            mp.setattr(jhako, "USE_SNODES_ABOVE", 128)
            mp.setattr(hako, "USE_SNODES_ABOVE", 128)
        try:
            rng = np.random.default_rng(grid_res + 5)
            m = random_voxels(grid_res, n_vox, rng)
            ro, rd = mixed_rays(m, grid_res, N_RAYS, rng)
            jt = jax_tree(m, grid_res)
            pt = port_tree(m, grid_res)
        finally:
            mp.undo()
        assert (pt.snodes is not None) == fat
        ref = tuple(np.asarray(x) for x in jk.intersect_hako(jt, ro, rd))
        _CASES[fat] = (pt, ro, rd, ref)
    return _CASES[fat]


def drive_args(tree, ro, rd):
    (bricks, snodes, tabs, root), T = hk.hako_args(tree)
    return (bricks, snodes, tabs, root, tree.lower, tree.upper,
            torch.from_numpy(ro), torch.from_numpy(rd)), T


class Compared:
    """A row stage that runs the fused wrapper on a copy of the round's
    state and the unfused stage on the state itself, every round, and
    holds the two states equal; counts the lanes that resumed (more) in
    each kernel B stage and the supernode misses."""

    def __init__(self):
        self.rounds = 0
        self.more = {False: 0, True: 0}
        self.snode_misses = 0

    def dda(self, *a, **k):
        out = hk.hako_dda(*a, **k)
        self.more[k["leaf"]] += int(out[6].sum())
        if not k["leaf"]:
            self.snode_misses += int((a[5] & ~out[0]).sum())
        return out

    def stage(self, state, *a, **k):
        fused = tuple(x.clone() for x in state)
        hk.hako_dda_merge(fused, *a, **k)
        hk.unfused_stage(self.dda, hk.hako_merge)(state, *a, **k)
        for i, (f, u) in enumerate(zip(fused, state)):
            assert torch.equal(f, u), f"state {i} differs in round {self.rounds}"
        self.rounds += 1


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("fat", [False, True])
def test_fused_plain_equals_unfused_stage_every_round(fat, shadow):
    pt, ro, rd, _ref = make_case(fat)
    args, T = drive_args(pt, ro, rd)
    cmp = Compared()
    hk.reset_counters()
    out = hk.drive((hk.hako_probe, cmp.stage), *args, T=T, shadow=shadow,
                   max_probes=hk.PROBES, max_dda=2,
                   max_rounds=hk.default_max_rounds(args[1], T, hk.PROBES, 2))
    assert int(out[3]) == 0 and out[4] == cmp.rounds > 1
    assert cmp.more[True] > 0  # capped brick rows resumed
    if fat:
        assert cmp.more[False] > 0 and cmp.snode_misses > 0
    assert set(hk.LAUNCHES.values()) == {0}  # the plain versions, no kernel
    want = hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow)
    for a, b in zip(out[:3], want[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fat", [False, True])
def test_fused_route_matches_jax(fat):
    """intersect_hako runs (hako_probe, hako_dda_merge) a round: on the CPU
    their plain versions, equal to the reference."""
    pt, ro, rd, ref = make_case(fat)
    hk.reset_counters()
    t, nm, vr = hk.intersect_hako(pt, ro, rd)
    assert hk.rounds_run() > 1 and hk.unresolved_lanes() == 0
    assert_matches_reference((t.numpy(), nm.numpy(), vr.numpy().view(np.uint32)), ref)


def test_wrapper_plain_on_cpu_and_refuses_other_devices():
    pt, ro, rd, _ref = make_case(True)
    args, T = drive_args(pt, ro, rd)
    bricks, snodes, tabs, root, lower, upper, ro_t, rd_t = args
    levels, level_off = hk.level_pack(tabs)
    bounds = torch.cat([lower, upper])
    n = ro_t.shape[0]
    idx = torch.arange(n, dtype=torch.int32)

    def fresh():
        return (torch.zeros(n, dtype=torch.bool), torch.zeros(n),
                torch.full((n,), hk.MAX_FLOAT), torch.full((n,), -1, dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32))

    a_out = hk.hako_probe(levels, level_off, T, root, bounds, ro_t, rd_t, idx,
                          torch.zeros(n), max_probes=hk.PROBES)
    kw = dict(T=T, shadow=False, max_iters=hk.DDA_ITERS)
    hk.reset_counters()
    got, want = fresh(), fresh()
    hk.hako_dda_merge(got, bricks, snodes, bounds, ro_t, rd_t, idx, *a_out, **kw)
    hk.hako_dda_merge_plain(want, bricks, snodes, bounds, ro_t, rd_t, idx, *a_out, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[0].any())
    assert set(hk.LAUNCHES.values()) == {0}

    def meta(x):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    m_state = tuple(meta(x) for x in fresh())
    with pytest.raises(ValueError, match="no hako_dda_merge kernel"):
        hk.hako_dda_merge(m_state, meta(bricks), meta(snodes), meta(bounds),
                          meta(ro_t), meta(rd_t), meta(idx), *(meta(x) for x in a_out),
                          **kw)
    assert set(hk.LAUNCHES.values()) == {0} and hk.unresolved_lanes() == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("extra", [-1, 1])
def test_wrapper_refuses_a_state_of_another_length(device, extra):
    """A state one lane shorter or longer than the rays is refused before
    the wrapper picks its path: on the CPU (the plain path) and on a device
    with no kernel alike, as the card's kernel path is (test_torch_cuda)."""
    n = 4
    kw = dict(dtype=torch.float32, device=device)
    rays = torch.zeros((n, 3), **kw)
    idx = torch.zeros(n, dtype=torch.int32, device=device)
    f = torch.zeros(n, **kw)
    b = torch.zeros(n, dtype=torch.bool, device=device)
    rows = torch.zeros((1, 164), dtype=torch.int32, device=device)
    r = n + extra
    state = (torch.zeros(r, dtype=torch.bool, device=device), torch.zeros(r, **kw),
             torch.zeros(r, **kw), torch.zeros(r, dtype=torch.int32, device=device),
             torch.zeros(r, dtype=torch.int32, device=device))
    hk.reset_counters()
    with pytest.raises(ValueError, match=f"state: {r} lanes for {n} rays"):
        hk.hako_dda_merge(state, rows, None, torch.zeros(6, **kw), rays, rays, idx, b, idx,
                          torch.zeros((3, n), **kw), f, f, b, T=1, shadow=False,
                          max_iters=4)
    assert set(hk.LAUNCHES.values()) == {0}
