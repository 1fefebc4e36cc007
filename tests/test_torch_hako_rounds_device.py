"""The round loop as the card runs it (csrc/hako_rounds.cu,
hako_rounds_kernel: one cooperative launch, one list of lanes a round,
kernel A and the row stage per lane, the lanes still unresolved appended
to the next list in whatever order the warps' atomics give), written as
tensor ops (`rounds_device_plain`: each round's survivors in an order
drawn from a seeded torch.Generator), held on the CPU

  * against the JAX package's intersect_hako run in interpret mode, as
    its own tests run it: 64^3 (T = 1) and 256^3 (T = 2) plain trees here,
    the 512^3 fat tree in test_torch_hako_rounds_device_fat.py (each
    interpret-mode reference costs ~12 s); primary and shadow rays; t
    within test_torch_hako_mega's 8 ulps of max(|t|, 1) (XLA:CPU contracts
    the reference's cell planes into FMAs; the port rounds the product),
    hit mask and vrank exact, nmajor exact but where a ray enters its
    voxel through an edge or a corner (at most 1% of the rays, each
    checked from the per-axis slab times by tiecheck.assert_face_tie),
    whose face the reference's FMA-contracted planes can decide the other
    way;
  * against the port's plain driver (intersect_rays_hako_plain, the
    kernel's plain version) bit for bit, with the same rounds and
    unresolved lanes, at the default caps, with one probe and one
    sub-brick visit a round, and cut at 3 rounds; two list orders give
    the same bits;

and the CPU side of the wrappers: intersect_rays_hako's accumulators
(rounds_run, unresolved_lanes) on the CPU, hako_rounds' refusal of CPU
tensors, and its C entry's parameters against their ctypes binding.
"""

import os
import re

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.utils import cuda_build

from test_torch_hako_build import jax_tree, port_tree, random_voxels
from tiecheck import assert_face_tie
from test_torch_hako_mega import assert_matches_reference, assert_t_close, mixed_rays

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N_RAYS = 512


def rounds_device_plain(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *,
                        T: int, shadow: bool = False, max_probes: int = hk.PROBES,
                        max_dda: int = hk.DDA_ITERS, max_rounds: int | None = None,
                        seed: int = 0):
    """hako_rounds_kernel's schedule: round 0 serves lanes 0..n-1; each
    later round serves the list the round before appended its unresolved
    lanes to, permuted. Returns (t, nmaj, vrank, unresolved int32 [1],
    rounds) as intersect_rays_hako_plain does, and the lists' lengths."""
    if max_rounds is None:
        max_rounds = hk.default_max_rounds(snodes, T, max_probes, max_dda)
    gen = torch.Generator().manual_seed(seed)
    n = ro.shape[0]
    levels, level_off = hk.level_pack(tabs)
    bounds = torch.cat([lower, upper]).to(torch.float32)
    state = (torch.zeros(n, dtype=torch.bool), torch.zeros(n),
             torch.full((n,), hk.MAX_FLOAT), torch.full((n,), -1, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32))
    lanes = torch.arange(n, dtype=torch.int32)
    rounds, lengths = 0, []
    while rounds < max_rounds and lanes.numel():
        lengths.append(int(lanes.numel()))
        a_out = hk.hako_probe_plain(levels, level_off, T, root_mask, bounds, ro, rd, lanes,
                                    state[1], max_probes=max_probes)
        hk.hako_dda_merge_plain(state, bricks, snodes, bounds, ro, rd, lanes, *a_out,
                                T=T, shadow=shadow, max_iters=max_dda)
        left = lanes[~state[0][lanes.long()]]
        lanes = left[torch.randperm(left.numel(), generator=gen)]
        rounds += 1
    unresolved = torch.tensor([lanes.numel()], dtype=torch.int32)
    return (state[2], state[3], state[4], unresolved, rounds), lengths


_CASES = {}
TREE_SHAPES = {"64": (64, 1536, None), "256": (256, 6144, None), "fat512": (512, 8000, 128)}


def make_case(name):
    """(port tree args, T, the voxels' Morton codes, the rays as numpy,
    the JAX references primary and shadow); built once per tree and
    module."""
    if name not in _CASES:
        grid_res, n_vox, snodes_above = TREE_SHAPES[name]
        mp = pytest.MonkeyPatch()
        if snodes_above is not None:
            mp.setattr(jhako, "USE_SNODES_ABOVE", snodes_above)
            mp.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
        try:
            rng = np.random.default_rng(grid_res + 20)
            m = random_voxels(grid_res, n_vox, rng)
            ro, rd = mixed_rays(m, grid_res, N_RAYS, rng)
            jt = jax_tree(m, grid_res)
            pt = port_tree(m, grid_res)
        finally:
            mp.undo()
        assert (pt.snodes is not None) == (snodes_above is not None)
        refs = {shadow: tuple(np.asarray(x) for x in jk.intersect_hako(jt, ro, rd,
                                                                       shadow=shadow))
                for shadow in (False, True)}
        (bricks, snodes, tabs, root), T = hk.hako_args(pt)
        args = (bricks, snodes, tabs, root, pt.lower, pt.upper, torch.from_numpy(ro),
                torch.from_numpy(rd))
        _CASES[name] = (args, T, m, (ro, rd), refs)
    return _CASES[name]


def as_numpy(out):
    return out[0].numpy(), out[1].numpy(), out[2].numpy().view(np.uint32)


def assert_matches_jax(got, ref, case, primary):
    """got (numpy t, nmaj, vrank) against the interpret-mode reference
    `ref`: hit mask and vrank exact, t within test_torch_hako_mega's bar;
    nmajor exact but where the ray enters its voxel through an edge or a
    corner (tiecheck.assert_face_tie on the per-axis slab times; at most
    1% of the rays), whose face the reference's FMA-contracted planes can
    decide the other way. `primary`: the port's primary outputs of the
    same rays, whose vrank names a shadow ray's voxel."""
    tp, nmp, vrp = got
    tj, nmj, vrj = ref
    hit = tj < 1e37
    np.testing.assert_array_equal(tp < 1e37, hit)
    np.testing.assert_array_equal(vrp, vrj)
    assert_t_close(tp[hit], tj[hit])
    assert hit.any() and (~hit).any()
    flips = np.nonzero(nmp != nmj)[0]
    assert len(flips) <= len(tp) // 100, f"{len(flips)} face axes differ"
    m, grid_res, ro, rd = case
    for i in flips:
        assert tp[i] == primary[0][i]
        assert_face_tie(i, m[int(primary[2][i])], np.zeros(3, np.float32),
                        1.0 / grid_res, ro[i], rd[i])


def check_against_jax(tree, shadow):
    args, T, voxels, (ro, rd), refs = make_case(tree)
    out, lengths = rounds_device_plain(*args, T=T, shadow=shadow)
    assert int(out[3]) == 0 and out[4] > 1 and lengths[0] == N_RAYS
    primary = as_numpy(hk.intersect_rays_hako_plain(*args, T=T))
    assert_matches_jax(as_numpy(out), refs[shadow],
                       (voxels, TREE_SHAPES[tree][0], ro, rd), primary)
    if shadow:
        np.testing.assert_array_equal(out[2].numpy(), 0)


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("tree", ["64", "256"])
def test_device_schedule_matches_jax(tree, shadow):
    check_against_jax(tree, shadow)


CAPS = {"default": (hk.PROBES, hk.DDA_ITERS, None), "capped": (1, 1, None),
        "cut": (1, 2, 3)}


def check_against_plain_driver(tree, shadow, caps):
    """Bit for bit the plain driver's t, nmajor and vrank, with its rounds
    and unresolved lanes, whatever order the lists take."""
    args, T = make_case(tree)[:2]
    max_probes, max_dda, max_rounds = CAPS[caps]
    kw = dict(T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
              max_rounds=max_rounds)
    want = hk.intersect_rays_hako_plain(*args, **kw)
    runs = [rounds_device_plain(*args, seed=seed, **kw) for seed in (0, 1)]
    for got, lengths in runs:
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert got[4] == want[4] and int(got[3]) == int(want[3])
        assert len(lengths) == got[4] and lengths == sorted(lengths, reverse=True)
    if caps == "cut":
        assert want[4] == 3 and int(want[3]) > 0
    else:
        assert int(want[3]) == 0 and want[4] > (2 if caps == "default" else 4)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("tree", ["64", "256"])
def test_device_schedule_equals_plain_driver(tree, shadow, caps):
    check_against_plain_driver(tree, shadow, caps)


def test_rounds_accumulator_on_cpu():
    """intersect_rays_hako on CPU tensors runs the plain driver and adds
    its rounds and unresolved lanes to the CPU's accumulator, which
    reset_counters zeroes; no kernel launch is counted."""
    args, T = make_case("64")[:2]
    want = [hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow) for shadow in (False, True)]
    cut = hk.intersect_rays_hako_plain(*args, T=T, max_rounds=2)
    hk.reset_counters()
    assert hk.rounds_run() == 0 and hk.unresolved_lanes() == 0
    for shadow, w in zip((False, True), want):
        got = hk.intersect_rays_hako(*args, T=T, shadow=shadow)
        for a, b in zip(got, w[:3]):
            assert torch.equal(a, b)
    assert hk.rounds_run() == want[0][4] + want[1][4] > 2
    assert hk.unresolved_lanes() == 0
    hk.intersect_rays_hako(*args, T=T, max_rounds=2)
    assert hk.rounds_run() == want[0][4] + want[1][4] + 2
    assert hk.unresolved_lanes() == int(cut[3]) > 0
    acc = hk._ACC[torch.device("cpu")]
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (2,)
    assert set(hk.LAUNCHES.values()) == {0}
    hk.reset_counters()
    assert hk.rounds_run() == 0 and hk.unresolved_lanes() == 0


def test_hako_rounds_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only (on the CPU
    intersect_rays_hako runs the plain driver): it raises before any
    counter moves."""
    args, T = make_case("64")[:2]
    hk.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        hk.hako_rounds(*args, T=T)
    meta = tuple(torch.empty(x.shape, dtype=x.dtype, device="meta") for x in args[6:])
    with pytest.raises(ValueError, match="no hako_rounds kernel"):
        hk.hako_rounds(*args[:6], *meta, T=T)
    assert set(hk.LAUNCHES.values()) == {0} and hk.rounds_run() == 0


def c_params(name: str) -> list:
    """The parameter declarations of a C entry point of hako_rounds.cu."""
    with open(os.path.join(cuda_build.CSRC, "hako_rounds.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\) \{", src, re.S)
    return [p.strip() for p in m.group(1).split(",")]


class _Spec:
    pass


class _Recorder:
    """Stands in for the library: records the argtypes _bind sets."""

    def __init__(self):
        self.specs = {}

    def __getattr__(self, name):
        return self.specs.setdefault(name, _Spec())


def bound_argtypes() -> dict:
    """{C entry point: the ctypes argtypes cuda_build._bind gives it}."""
    rec = _Recorder()
    cuda_build._bind(rec)
    return {name: spec.argtypes for name, spec in rec.specs.items()
            if hasattr(spec, "argtypes")}


@pytest.mark.parametrize("entry", ["hako_rounds_launch", "hako_rounds_grid"])
def test_entry_points_match_their_bindings(entry):
    """Each parameter of the C entry has its ctypes type: a pointer
    (void*), an int or a float, in order."""
    bound = bound_argtypes()[entry]
    params = c_params(entry)
    assert len(bound) == len(params)
    for decl, ct in zip(params, bound):
        if "*" in decl:
            assert ct is cuda_build.ctypes.c_void_p, decl
        elif decl.startswith("float"):
            assert ct is cuda_build.ctypes.c_float, decl
        elif decl.startswith("unsigned"):
            assert ct is cuda_build.ctypes.c_uint, decl
        else:
            assert decl.startswith("int") and ct is cuda_build.ctypes.c_int, decl


def test_rounds_counts_and_bound():
    """scripts/common.rounds_counts: each round's lanes are the device
    schedule's list lengths, the lanes it leaves the next round's, its
    row walks and rows counted; rounds_bound sums the rounds' bytes."""
    from massivevoxelraytracing_torch.scripts import common

    args, T = make_case("256")[:2]
    (out, lengths) = rounds_device_plain(*args, T=T)
    rc = common.rounds_counts(*args, T=T)
    assert [r[0] for r in rc["rounds"]] == lengths
    assert [r[1] for r in rc["rounds"]] == lengths[1:] + [0] and rc["unresolved"] == 0
    assert all(r[3] <= r[2] <= 2 * r[0] for r in rc["rounds"]) and rc["rounds"][0][3] > 0
    assert rc["table_words"] == sum(int(t.numel()) for t in args[2]) > 0
    n_bytes, by = common.rounds_bound(rc)
    rays = sum(lengths)
    assert by == "bytes" and n_bytes * common.HBM_BYTES_PER_S / 1e3 > rays * 24 + N_RAYS * 12


def test_profile_window_needs_a_card():
    """scripts/profile_window measures the card's trace and refuses the CPU."""
    from massivevoxelraytracing_torch.scripts import profile_window

    with pytest.raises(RuntimeError, match="needs a card"):
        profile_window.run([0.0], device="cpu")


def test_rounds_trace_needs_a_card():
    """scripts/rounds_trace traces the card and refuses the CPU."""
    from massivevoxelraytracing_torch.scripts import rounds_trace

    with pytest.raises(RuntimeError, match="needs a card"):
        rounds_trace.run(32, device="cpu")


def test_profile_counted_retakes_until_the_trace_holds_every_launch(monkeypatch):
    """common.profile_counted: a trace that misses a counted launch is taken
    again with the next pad; one that never holds it raises."""
    from massivevoxelraytracing_torch.scripts import common

    counts = {"hako_rounds": 0, "hako_probe": 0}
    held = iter([0, 0, 1])

    def fake(fn, pad_s=0.0, names=()):
        fn()
        seen = next(held, 0)
        return dict(named={k: (0.1, seen if k == "hako_rounds" else 0) for k in names})

    def call():
        counts["hako_rounds"] += 1

    monkeypatch.setattr(common, "profile_call", fake)
    r = common.profile_counted(call, counts)
    assert r["tries"] == 3 and r["pad_s"] == common.PROFILE_PADS_S[2]
    assert counts["hako_rounds"] == 3
    with pytest.raises(AssertionError, match="missed launches"):
        common.profile_counted(call, counts, tries=2)
