"""scripts/r3_phase_split.py on the CPU (plain versions): the block-local
distinct-row counts that hako_dda_cached reports (block_rows_plain)
against the reference's row dedup (its dedup :152) re-stated at 128-lane
blocks; kernel B's outputs in child-id order, scattered back, against
those in the round's order; on a fat 512^3 tree the script's staged
round, its one round on the device (unfused and fused stage, on a preset
state) and the host-wall phases of drive(max_rounds=1) against the round
driver's first round; and the entry point at --device cpu and its
refusal without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako, morton
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.ops import hako_mega
from massivevoxelraytracing_torch.scripts import r3_phase_split as r3

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

BLOCK = hk.CACHE_BLOCK


def reference_dedup(emit, child, cap, U):
    """r3_phase_split.py's dedup (:152) at `cap` blocks of BLOCK lanes: the
    per-block boundary counts (the sentinel id of non-emitting lanes is a
    group of its own) and rank_ok."""
    rb = BLOCK
    ids = jnp.where(emit != 0, child, jnp.int32(0x7FFFFFFF)).reshape(cap, rb)
    pos = jnp.broadcast_to(jnp.arange(rb, dtype=jnp.int32)[None, :], (cap, rb))
    ids_s, pos_s = jax.lax.sort((ids, pos), dimension=1, num_keys=1, is_stable=True)
    bnd = jnp.concatenate([jnp.ones((cap, 1), jnp.int32),
                           (ids_s[:, 1:] != ids_s[:, :-1]).astype(jnp.int32)], axis=1)
    rank_s = jnp.cumsum(bnd, axis=1) - 1
    _, rank_l = jax.lax.sort((pos_s, rank_s), dimension=1, num_keys=1, is_stable=False)
    rank_ok = (rank_l < U).astype(jnp.int32)
    return np.asarray(bnd.sum(1)), np.asarray(rank_ok).reshape(-1)


@pytest.mark.parametrize("U", [4, 64])
def test_block_rows_equal_the_reference_dedup(U):
    rng = np.random.default_rng(U)
    cap = 24
    n = cap * BLOCK
    child = rng.integers(0, 40, n).astype(np.int32)  # many repeats a block
    child[: 5 * BLOCK] = rng.integers(0, 10**6, 5 * BLOCK)  # and distinct rows
    emit = rng.random(n) < 0.7
    emit[BLOCK:2 * BLOCK] = True   # a block without the sentinel group
    emit[2 * BLOCK:3 * BLOCK] = False  # and one without go-lanes
    bnd_sum, rank_ok = reference_dedup(jnp.asarray(emit.astype(np.int32)),
                                       jnp.asarray(child), cap, U)
    got = hk.block_rows_plain(torch.from_numpy(emit), torch.from_numpy(child), U).numpy()
    go = emit.reshape(cap, BLOCK)
    np.testing.assert_array_equal(got[:, 0], go.sum(1))
    np.testing.assert_array_equal(got[:, 1] + (~go).any(1), bnd_sum)
    np.testing.assert_array_equal(got[:, 2], (rank_ok.reshape(cap, BLOCK) & go).sum(1))
    # blocks of more than U distinct rows overflow; of 40 at most, not at U = 64
    assert (got[:, 2] < got[:, 0]).any()
    assert (got[5:, 2] == got[5:, 0]).all() == (U == 64)
    # a ragged tail block counts its lanes alone
    tail = hk.block_rows_plain(torch.from_numpy(emit[:n - 50]),
                               torch.from_numpy(child[:n - 50]), U).numpy()
    np.testing.assert_array_equal(tail[:-1], got[:-1])
    assert tail[-1, 0] == go[-1, :-50].sum()


def fat_tree(device="cpu"):
    """A random fat tree at 512^3 (supernode rows above 128^3)."""
    rng = np.random.default_rng(512)
    c = torch.from_numpy(rng.integers(0, 512, size=(120000, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    old = hako.USE_SNODES_ABOVE
    hako.USE_SNODES_ABOVE = 128
    try:
        return hako.build_hako(codes, 512, device=device, dps=1.0 / 512)
    finally:
        hako.USE_SNODES_ABOVE = old


class FirstRound:
    """The plain round kernels, recording the first round's outputs."""

    def __init__(self):
        self.out = {}

    def probe(self, *a, **k):
        got = hk.hako_probe_plain(*a, **k)
        self.out.setdefault("kernel A", got)
        return got

    def dda(self, *a, **k):
        got = hk.hako_dda_plain(*a, **k)
        self.out.setdefault("B rows, round order" if k["leaf"] else "supernode rows", got)
        return got

    def merge(self, state, *a):
        hk.hako_merge_plain(state, *a)
        self.out.setdefault("merge", tuple(x.clone() for x in state))


@pytest.fixture(scope="module")
def fat_run():
    tree = fat_tree()
    assert tree.snodes is not None
    cam = r3.script_camera(tree)
    return tree, cam, r3.run(tree, cam, 64, 64, label="fat 512^3")


def test_fat_staged_round_equals_the_drivers_first_round(fat_run):
    tree, cam, got = fat_run
    assert got["fat"] and got["uniq"] == r3.uniq_for(512) > 0 and got["lanes"] == 2048
    assert got["phases"].keys() >= {"kernel A", "supernode rows", "B rows, round order",
                                    "B rows, sorted by row", r3.DEVICE_ROUND_UNFUSED,
                                    r3.DEVICE_ROUND_FUSED, r3.HOST_WALL_UNFUSED,
                                    r3.HOST_WALL_FUSED}
    # on the CPU the wrappers run the plain versions and launch nothing
    assert set(got["launches"].values()) == {0}
    n = got["lanes"]
    ro, rd = (torch.from_numpy(x) for x in r3.phase_timing.frame_rays(cam, 64, 64))
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    rec = FirstRound()
    want = hk.drive((rec.probe, hk.unfused_stage(rec.dda, rec.merge)), *args, T=T,
                    shadow=False, max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
                    max_rounds=hk.default_max_rounds(snodes, T, hk.PROBES, hk.DDA_ITERS))
    for name in ("kernel A", "supernode rows", "B rows, round order"):
        for a, b in zip(got["outputs"][name], rec.out[name]):
            assert torch.equal(a, b[..., :n]), name  # every lane is in round 1
    merged = got["outputs"]["bookkeeping (round_lanes + merge)"]
    for a, b in zip(merged, rec.out["merge"]):
        assert torch.equal(a[:n], b[:n])
    # one round of the driver on the phases' lanes leaves that state (the
    # host-wall phases' outputs: t, nmaj, vrank, unresolved)
    one = got["outputs"][r3.HOST_WALL_UNFUSED]
    for a, b in zip(one[:3], merged[2:]):
        assert torch.equal(a, b[:n])
    assert int(one[3]) == int((~merged[0][:n]).sum()) > 0
    # ... and so does the round with the fused row stage
    for a, b in zip(got["outputs"][r3.HOST_WALL_FUSED], one):
        assert torch.equal(a, b)
    # the full frame
    for a, b in zip(got["outputs"]["frame"], want[:3]):
        assert torch.equal(a, b)
    assert got["frame"]["rounds"] == want[4] > 1
    assert bool((want[0] < 1e37).any())


@pytest.mark.parametrize("name", [r3.DEVICE_ROUND_UNFUSED, r3.DEVICE_ROUND_FUSED])
def test_device_round_equals_the_drivers_first_round(fat_run, name):
    """The round timed on the device (kernel A and the row stage on a copy
    of drive's fresh state of the phases' lanes) leaves the whole state of
    the plain driver's first round on those lanes; on the CPU it is not
    timed, launches nothing and carries its bytes bound nowhere."""
    tree, cam, got = fat_run
    n = got["lanes"]
    ro, rd = (torch.from_numpy(x)[:n] for x in r3.phase_timing.frame_rays(cam, 64, 64))
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    rec = FirstRound()
    hk.drive((rec.probe, hk.unfused_stage(rec.dda, rec.merge)), bricks, snodes, tabs, root,
             tree.lower, tree.upper, ro, rd, T=T, shadow=False, max_probes=hk.PROBES,
             max_dda=hk.DDA_ITERS, max_rounds=1)
    state = got["outputs"][name]
    assert len(state) == 5 and state[0].shape[0] == n
    for a, b in zip(state, rec.out["merge"]):
        assert torch.equal(a, b)
    assert bool(state[0].any()) and not bool(state[0].all())
    phase = got["phases"][name]
    assert set(phase) == {"launches"} and set(phase["launches"].values()) == {0}


def test_sorted_kernel_b_scatters_back(fat_run):
    _tree, _cam, got = fat_run
    out = got["outputs"]
    emit, child = out["supernode rows"][0], out["supernode rows"][3]
    order = r3.sort_by_row(emit, child)
    assert bool(emit.any()) and not torch.equal(order, torch.arange(order.shape[0]))
    back = r3.scatter_back(order, out["B rows, sorted by row"])
    for a, b in zip(back, out["B rows, round order"]):
        assert torch.equal(a, b)
    # sorting packs a row's lanes into one block (or two, at a boundary):
    # the blocks' distinct rows sum to at most the round order's
    rows = got["rows"]
    assert rows["sorted by row"]["go_lanes"] == rows["round order"]["go_lanes"] > 0
    srt, rnd = rows["sorted by row"], rows["round order"]
    assert (rows["distinct_rows_round"] <= srt["distinct_rows"]
            <= min(rnd["distinct_rows"], rows["distinct_rows_round"] + srt["blocks"]))
    cached = out[f"B cached U={got['uniq']}, round order"]
    for a, b in zip(cached[0], out["B rows, round order"]):
        assert torch.equal(a, b)


def test_main_runs_on_the_cpu(monkeypatch):
    """The entry point at --device cpu on a small tree in place of the
    lattice (whose build at 32^3 takes minutes on one core)."""
    tree = fat_tree()
    monkeypatch.setattr(r3.treecache, "lattice_tree", lambda res, device: tree)
    got = r3.main(["--device", "cpu", "--res", "512", "--width", "32", "--height", "32"])
    assert got["uniq"] == r3.uniq_for(512) and got["label"] == "lattice 512^3"
    assert got["frame"]["rays"] == 8192 and "ms" not in got["frame"]


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r3.main(["--res", "32"])


@pytest.mark.parametrize("res", [32, 64, 256, 512, 1024, 2048, 8192, 16384])
def test_uniq_is_the_references(res):
    assert r3.uniq_for(res) == jk.knobs_for_res(res).get("uniq", 0)
