"""The gather probes' plain versions (ops/probes.py: take_along_plain,
smem_alloc_plain, ohg_plain) against the JAX package's Pallas bodies of
scripts/dyngather_probe2.py and scripts/gather_probe3.py, re-stated here
(dyngather_probe2.py runs its probes when imported, and both scripts set
up a TPU runtime) and run under pl.pallas_call(..., interpret=True) on the
reference's own draws; integers exactly. Then both ported scripts at
--device cpu, and their refusal without a card. The kernels run on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 5d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import common
from massivevoxelraytracing_torch.scripts import dyngather_probe2 as dg
from massivevoxelraytracing_torch.scripts import gather_ab
from massivevoxelraytracing_torch.scripts import gather_probe3 as g3

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

S = 16


def interpret(kernel, args, out_shape, dtype=jnp.int32, scratch=()):
    """The reference's pallas_call (every operand in VMEM), interpreted."""
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=list(scratch),
        interpret=True,
    )(*[jnp.asarray(a) for a in args]))


# dyngather_probe2.py's four bodies (:41, :52, :59, :70)
def k_taa1(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:] % 128, axis=1)


def k_taa1w(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:] % 256, axis=1)[:, :128]


def k_taa0(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:] % S, axis=0)


def k_taa0t(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:] % 128, axis=0)[:S]


BODIES = {"k_taa1": k_taa1, "k_taa1w": k_taa1w, "k_taa0": k_taa0, "k_taa0t": k_taa0t}


def test_the_script_runs_the_references_bodies():
    assert [b[1] for b in dg.BODIES] == list(BODIES)
    for name, body, axis, mod, ts, xs in dg.BODIES:
        assert dg.forms(axis) == (("shared", "shfl", "global") if axis == 1
                                  else ("shared", "global"))


@pytest.mark.parametrize("body", list(BODIES))
def test_take_along_bodies_match_jax(body):
    """Each body on the reference's draws (argument i from
    default_rng(i)); the port's batch of 3 tiles starts with them."""
    _name, _body, axis, mod, ts, xs = next(b for b in dg.BODIES if b[1] == body)
    t, idx = (a[0] for a in dg.draws((ts, xs)))
    ref = [np.random.default_rng(i).integers(0, hi, sh) for i, (sh, hi) in enumerate((ts, xs))]
    for a, b in zip((t, idx), ref):
        np.testing.assert_array_equal(a, b)
    want = interpret(BODIES[body], [t, idx], (S, 128))
    np.testing.assert_array_equal(want, np.take_along_axis(t, idx % mod, axis=axis)[:S, :128])
    tt, it = torch.from_numpy(t[None]), torch.from_numpy(idx[None])
    for form in dg.forms(axis):
        got = probes.take_along_probe(tt, it, axis=axis, mod=mod, form=form, c_out=128)
        assert got.dtype == torch.int32 and tuple(got.shape) == (1, S, 128)
        np.testing.assert_array_equal(got.numpy()[0], want)
    batch = [torch.from_numpy(a) for a in dg.draws((ts, xs), 3)]
    assert torch.equal(batch[0][:1], tt) and torch.equal(batch[1][:1], it)
    got = probes.take_along_plain(*batch, axis=axis, mod=mod, c_out=128)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), interpret(BODIES[body], [batch[0][b].numpy(), batch[1][b].numpy()],
                                      (S, 128)))


def a0_kernel(tbl_ref, idx_ref, out_ref):
    """gather_probe3.py :70 probe_a0small's kernel."""
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], idx_ref[:], axis=0)


@pytest.mark.parametrize("n_rows", g3.A0_ROWS)
def test_a0small_matches_jax(n_rows):
    tbl = np.random.default_rng(0).integers(0, 99, (n_rows, 128)).astype(np.int32)
    idx = np.random.default_rng(1).integers(0, n_rows, (16, 128)).astype(np.int32)
    want = interpret(a0_kernel, [tbl, idx], (16, 128))
    got = probes.take_along_plain(torch.from_numpy(tbl[None]), torch.from_numpy(idx[None]),
                                  axis=0, mod=0)
    np.testing.assert_array_equal(got.numpy()[0], want)


def jax_ohg(n_rows, k, r_rows=16):
    """gather_probe3.py :147 probe_ohg's kernel (one-hot rows times the f32
    table on the MXU, then the lane select), interpreted on its draws."""
    n = n_rows * 128

    def kernel(tbl_ref, idx_ref, out_ref):
        tbl = tbl_ref[:].astype(jnp.float32)

        def body(i, idx):
            row = (idx >> 7).reshape(-1)
            lane = idx & 127
            oh = (jax.lax.broadcasted_iota(jnp.int32, (r_rows * 128, n_rows), 1)
                  == row[:, None]).astype(jnp.float32)
            rows = jnp.dot(oh, tbl, preferred_element_type=jnp.float32)
            v = jnp.take_along_axis(rows.reshape(r_rows * 128, 128),
                                    (lane.reshape(-1))[:, None], axis=1).reshape(r_rows, 128)
            return (idx + v.astype(jnp.int32)) & (n - 1)

        out_ref[:] = jax.lax.fori_loop(0, k, body, idx_ref[:])

    tbln, idxn = g3.ohg_inputs(n_rows, r_rows)
    return tbln, idxn, interpret(kernel, [tbln, idxn], (r_rows, 128))


OHG = {(128, 32): None, (1024, 4): None}


def ohg_reference(n_rows, k):
    if OHG[(n_rows, k)] is None:
        OHG[(n_rows, k)] = jax_ohg(n_rows, k)
    return OHG[(n_rows, k)]


@pytest.mark.parametrize("mode", ["gather", "mma"])
@pytest.mark.parametrize("n_rows,k", list(OHG))
def test_ohg_matches_jax(n_rows, k, mode):
    """ohg (128 rows, the reference's 32 hops) and ohg1k (1024 rows, a
    few hops): the plain chase and the plain byte-plane one-hot product
    equal the reference's MXU gather and its numpy chase."""
    tbln, idxn, want = ohg_reference(n_rows, k)
    np.testing.assert_array_equal(want, g3.numpy_chase(tbln, idxn, k))
    got = probes.ohg_plain(torch.from_numpy(tbln), torch.from_numpy(idxn), k, mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ohg_planes_cover_the_table():
    """The 1024-row table's values reach 2^17 - 1: the third byte plane is
    in use, and the wrapper's modes all run the plain chase on the CPU."""
    tbln, idxn = g3.ohg_inputs(1024)
    assert tbln.max() >= 1 << 16 and tbln.max() < 1 << 17
    table, idx = torch.from_numpy(tbln), torch.from_numpy(idxn)
    want = probes.ohg_plain(table, idx, 8, "gather")
    for mode in probes.OHG_MODES:
        assert torch.equal(probes.ohg_probe(table, idx, k=8, mode=mode), want)
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.ohg_probe(table, idx, k=4, mode="global")
    assert torch.equal(probes.ohg_probe(table, idx, k=1, mode="mma"),
                       probes.ohg_plain(table, idx, 1, "gather"))


@pytest.mark.parametrize("mb", [0, 16])
def test_vmem_body_with_the_last_row_written_matches_plain(mb):
    """gather_probe3.py :101 probe_vmem's kernel, with the one write the
    port adds: the reference writes 2x into scratch row 0 only and returns
    row 0 + row n - 1, so its output reads a row it never wrote (undefined:
    NaN when interpreted, whatever the allocation held on the TPU). With
    row n - 1 written as well the output is 4x for every n, as the port's
    smem_alloc_probe returns; mb 0 is a one-row scratch."""
    n = max(mb * 1024 * 1024 // 4 // 128, 1)

    def kernel(x_ref, out_ref, scratch):
        scratch[0, :] = x_ref[0, :] * 2.0
        scratch[n - 1, :] = x_ref[0, :] * 2.0
        out_ref[:] = scratch[0, :][None, :] + scratch[n - 1, :][None, :]

    x = np.random.default_rng(0).uniform(0.5, 2.0, (1, 128)).astype(np.float32)
    want = interpret(kernel, [x], (1, 128), jnp.float32,
                     [pltpu.VMEM((n, 128), jnp.float32)])
    got = probes.smem_alloc_probe(torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, 4 * x)


def test_wrappers_refuse_what_no_kernel_takes():
    t = torch.zeros(1, 16, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="shfl take-along on axis 0"):
        probes.take_along_probe(t, t, axis=0, mod=16, form="shfl")
    with pytest.raises(ValueError, match="power of two"):
        probes.take_along_probe(t, t, axis=1, mod=100, form="shared")
    with pytest.raises(ValueError, match="no take-along form"):
        probes.take_along_probe(t, t, axis=1, mod=128, form="wgmma")
    # a modulus past the gathered axis would reach past the tile
    with pytest.raises(ValueError, match=r"no larger than the gathered axis \(128\)"):
        probes.take_along_probe(t, t, axis=1, mod=256, form="global")
    with pytest.raises(ValueError, match=r"no larger than the gathered axis \(16\)"):
        probes.take_along_probe(t, t, axis=0, mod=32, form="shared")
    with pytest.raises(ValueError, match="32 or more"):
        probes.ohg_probe(torch.zeros(16, 128, dtype=torch.int32), t[0], k=8, mode="mma")
    with pytest.raises(ValueError, match="a row or more"):
        probes.smem_alloc_probe(torch.zeros(1, 128), 0)


def test_take_along_bytes_counts_the_sectors_the_indices_reach():
    """The bound's bytes: 32-byte sectors of the tile (8 int32) that this
    run's indices reach, plus the indices read and the output written."""
    t = torch.zeros(2, 16, 128, dtype=torch.int32)
    idx = torch.zeros(2, 16, 256, dtype=torch.int32)
    # every index 0 along rows: one sector a row, 32 in all; the indices'
    # unread columns (128-255) count for nothing
    assert common.take_along_bytes(t, idx, axis=1, mod=128, c_out=128) == (
        32 * 32 + 2 * 4 * 2 * 16 * 128)
    # along columns, row 0 only: the 16 sectors of row 0 in each tile
    assert common.take_along_bytes(t, idx[:, :, :128], axis=0, mod=16, c_out=128) == (
        32 * 16 * 2 + 2 * 4 * 2 * 16 * 128)
    # the modulus folds 128 + j onto j: every sector of the 16 rows
    j = torch.arange(128, dtype=torch.int32)
    wide = (j + 128).expand(2, 16, 128).contiguous()
    assert common.take_along_bytes(t, wide, axis=1, mod=128, c_out=128) == (
        4 * t.numel() + 2 * 4 * 2 * 16 * 128)
    # k_taa0t's 16 indices a column reach about 63% of its 128-row table
    _, x = dg.draws(dg.BODIES[3][4:], 1)
    got = common.take_along_bytes(torch.zeros(1, 128, 128, dtype=torch.int32),
                                  torch.from_numpy(x), axis=0, mod=128, c_out=128)
    assert 0.55 * 65536 < got - 2 * 4 * 16 * 128 < 0.70 * 65536


def test_smem_refusal_is_an_answer_only_on_the_card():
    """On the CPU (or within a block's shared memory) a ValueError is a
    fault and propagates; a call that returns is passed through."""
    def refuse():
        raise ValueError("over")

    with pytest.raises(ValueError, match="over"):
        common.smem_refusal(refuse, 1 << 30, torch.device("cpu"))
    assert common.smem_refusal(lambda: 3, 1 << 30, torch.device("cpu")) == (3, None)


def test_dyngather_script_runs_on_the_cpu():
    got = dg.main(["--device", "cpu"])
    assert got["batches"] == [1]
    assert [(r["body"], r["form"]) for r in got["cases"]] == [
        (b[1], f) for b in dg.BODIES for f in dg.forms(b[2])]
    assert all(r["launches"] == 0 and not r["refused"] for r in got["cases"])


def test_gather_probe3_script_runs_on_the_cpu():
    """The reference's default list: the chase loops, a0small (nothing
    refused on the CPU) and the allocation sizes, no capacity answer."""
    got = g3.main(["--device", "cpu"])
    assert list(got) == list(g3.DEFAULT)
    assert [r["n_rows"] for r in got["a0small"]["cases"]] == [n for n in g3.A0_ROWS
                                                             for _ in range(2)]
    assert [s["rows"] for s in got["vmem"]["sizes"]] == [kb * 2 for kb in g3.VMEM_KB]
    assert got["vmem"]["optin_bytes"] is None and got["vmem"]["launches"] == 0
    assert got["chase"]["lanes"] == 1 << 21 and got["chase_rows"]["k"] == 16


@pytest.mark.parametrize("script", [dg, g3])
def test_scripts_refuse_without_a_card(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])


# ---------------------------------------------------------------------------
# the redesigned kernels' helpers: the mma mode's B fragments and the shared
# axis-0 take-along's reached sectors, slices and marks
# ---------------------------------------------------------------------------

def fragment_bytes(frag):
    """int32 [..., 2] registers -> uint8 [..., 2, 4] (byte j of each)."""
    u = frag.numpy().astype(np.int64) & 0xFFFFFFFF
    return np.stack([(u >> (8 * j)) & 255 for j in range(4)], -1)


@pytest.mark.parametrize("n_rows,cluster", [(32, 1), (64, 2), (128, 1), (256, 4)])
def test_ohg_fragments_are_the_mma_b_layout(n_rows, cluster):
    """ohg_fragments, read back by mma.sync m16n8k32's B layout (thread
    (g, t): register 0's byte j is row 4t + j, register 1's row 16 + 4t +
    j, both at column g of the 32 x 8 tile), give every table row's three
    byte planes, block r holding the chunks r x chunks.. ."""
    tbl = np.random.default_rng(n_rows).integers(0, 1 << 24, (n_rows, 128)).astype(np.int32)
    frag = fragment_bytes(probes.ohg_fragments(torch.from_numpy(tbl), cluster))
    chunks = n_rows // 32 // cluster
    assert frag.shape == (cluster, chunks, 16, 3, 32, 2, 4)
    got = np.zeros((3, n_rows, 128), np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for r in range(cluster):
        for kc in range(chunks):
            base = 32 * (r * chunks + kc)
            for nt in range(16):
                for j in range(4):
                    for half in range(2):
                        got[:, base + 16 * half + 4 * t + j, 8 * nt + g] = (
                            frag[r, kc, nt, :, :, half, j])
    want = np.stack([(tbl.astype(np.int64) >> (8 * p)) & 255 for p in range(3)])
    np.testing.assert_array_equal(got, want)


def one_hot_regs(d):
    """The one-hot byte of an A register: byte d (0-3) set to 1."""
    return np.where((d >= 0) & (d < 4), 1 << (8 * np.clip(d, 0, 3)), 0)


def mma_model(n_rows, cluster, table, idx, k):
    """The mma mode's hops as the kernel computes them, lane by lane of
    each cluster's 16 x cluster: each block's partial from its B fragments
    (ohg_fragments) and the rows' one-hot A registers, multiplied as
    mma.sync m16n8k32 defines its fragments, then the cluster's slots
    summed at each lane's column."""
    frag = fragment_bytes(probes.ohg_fragments(torch.from_numpy(table), cluster))
    chunks = n_rows // 32 // cluster
    lanes = 16 * cluster
    n = idx.size
    x = np.zeros(-(-n // lanes) * lanes, np.int64)
    x[:n] = idx
    g = np.arange(8)
    for _ in range(k):
        step = np.zeros_like(x)
        for first in range(0, x.size, lanes):
            for grp in range(cluster):
                lo = first + 16 * grp
                rows, cols = x[lo:lo + 16] >> 7, x[lo:lo + 16] & 127
                for r in range(cluster):
                    part = np.zeros((16, 128), np.int64)
                    for kc in range(chunks):
                        c = r * chunks + kc
                        a = np.zeros((16, 32), np.int64)
                        for t in range(4):
                            for half, rsel in ((0, rows[g]), (1, rows[g + 8])):
                                for khalf in range(2):
                                    reg = one_hot_regs(rsel - 32 * c - 4 * t - 16 * khalf)
                                    for j in range(4):
                                        a[g + 8 * half, 16 * khalf + 4 * t + j] = (reg >> (8 * j)) & 255
                        for nt in range(16):
                            b = np.zeros((3, 32, 8), np.int64)
                            for lane in range(32):
                                for half in range(2):
                                    b[:, 16 * half + 4 * (lane % 4) + np.arange(4), lane // 4] = (
                                        frag[r, kc, nt, :, lane, half, :])
                            d = np.einsum("mk,pkn->pmn", a, b)
                            part[:, 8 * nt:8 * nt + 8] += d[0] + (d[1] << 8) + (d[2] << 16)
                    step[lo:lo + 16] += part[np.arange(16), cols]
        x = (x + step) & (n_rows * 128 - 1)
    return x[:n].astype(np.int32)


@pytest.mark.parametrize("n_rows,cluster,n", [(32, 1, 17), (64, 2, 15), (128, 4, 70)])
def test_ohg_mma_model_matches_the_plain_chase(n_rows, cluster, n):
    """The mma mode's arithmetic as the kernel lays it out (B fragments,
    one-hot A registers, partials of a cluster's blocks summed) equals the
    plain one-hot chase, for lane counts that leave a group and a cluster
    partial."""
    tbl = np.random.default_rng(n).integers(0, n_rows * 128, (n_rows, 128)).astype(np.int32)
    idx = np.random.default_rng(n + 1).integers(0, n_rows * 128, n).astype(np.int32)
    want = probes.ohg_plain(torch.from_numpy(tbl), torch.from_numpy(idx), 3, "mma").numpy()
    np.testing.assert_array_equal(mma_model(n_rows, cluster, tbl, idx, 3), want)
    np.testing.assert_array_equal(want, g3.numpy_chase(tbl, idx, 3))


def test_ohg_cluster_and_shared_memory():
    """The mma mode's default cluster keeps a block's share of the byte
    planes at 192 KB or less (1024 rows: 2 blocks); every default fits an
    H100's 232,448 bytes of opt-in shared memory up to 4096 rows."""
    assert [probes.ohg_cluster(n) for n in (32, 128, 512, 1024, 2048, 4096)] == [
        1, 1, 1, 2, 4, 8]
    for n in (32, 128, 512, 1024, 2048, 4096):
        cl = probes.ohg_cluster(n)
        assert probes.ohg_smem_bytes(n, cl) <= 232448
        assert probes.ohg_smem_bytes(n, cl) == n * 384 // cl + 2 * cl * 16 * cl * 4
    assert probes.ohg_smem_bytes(1024, 1) > 232448  # one block cannot hold the 1024 rows


@pytest.mark.parametrize("body", ["k_taa0", "k_taa0t"])
def test_taa0_sectors_are_the_bounds_sectors(body):
    """The sectors the shared axis-0 take-along stages where it marks are
    those the bytes bound counts (common.take_along_bytes): each 32-byte
    sector of a row that an index of its columns reaches."""
    _name, _body, axis, mod, ts, xs = next(b for b in dg.BODIES if b[1] == body)
    t, idx = (torch.from_numpy(a) for a in dg.draws((ts, xs), 3))
    idx = idx + mod * torch.arange(3, dtype=torch.int32)[:, None, None]
    sec = probes.taa0_sectors(t, idx, mod=mod)
    B, R, C = t.shape
    assert sec.shape == (B, R, C // 8)
    assert 32 * int(sec.sum()) + 8 * B * 16 * C == common.take_along_bytes(
        t, idx, axis=0, mod=mod, c_out=C)
    # by hand: row m of sector q is reached iff some idx[b, :, 8q..8q+7] % mod == m
    x = (idx.numpy() % mod).reshape(B, 16, C // 8, 8)
    for b in range(B):
        for q in range(C // 8):
            np.testing.assert_array_equal(
                np.flatnonzero(sec[b, :, q].numpy()), np.unique(x[b, :, q]))


def test_taa0_sectors_skip_indices_outside_the_tile():
    """With mod 0 an index outside the tile reads through L1 and marks no
    sector; a partial last sector (12 columns) counts as one."""
    t = torch.zeros(1, 4, 12, dtype=torch.int32)
    idx = torch.tensor([[[0, 1, 2, 3, 7, -1, 3, 3, 2, 9, 0, 0]]], dtype=torch.int32)
    sec = probes.taa0_sectors(t, idx, mod=0)
    assert sec.shape == (1, 4, 2)
    np.testing.assert_array_equal(sec[0].numpy(), [[1, 1], [1, 0], [1, 1], [1, 0]])


def test_taa0_slice_on_the_reference_shapes():
    """The slice a block of the shared axis-0 take-along takes: 32 columns
    on a batch that fills the card (k_taa0t's and k_taa0's 1,056 tiles),
    halved while the blocks are fewer than the SMs: one a0small tile over
    16 blocks of 8 columns, 17 tiles over 8 blocks of 16 each, 33 over 4
    of 32; a tile narrower than the slice in one block, rounded up to a
    sector."""
    sms = 132
    assert [probes.taa0_slice(128, b, sms) for b in (1, 3, 17, 33, 1056)] == [
        8, 8, 16, 32, 32]
    assert probes.taa0_slice(12, 1056, sms) == 16 and probes.taa0_slice(72, 1, sms) == 8
    assert probes.taa0_slice(72, 1056, sms) == 32 and probes.taa0_slice(4, 1, sms) == 8


def test_taa0_whole_tiles_on_the_reference_shapes():
    """The shared axis-0 take-along stages whole tiles where 16 indices a
    column reach every sector and the batch fills the card (k_taa0's
    1,056 16-row tiles) or a tile is one 16-byte load of each of a
    block's 256 threads (a0small's 8-row tile, 4 KB); it slices k_taa0t's
    128-row tiles (~63% of the sectors reached), a modulus under the
    rows, a0small's 32- and 128-row tile and small batches of larger
    tiles."""
    sms = 132
    assert probes.taa0_whole(16, 128, 16, 16, 1056, sms)
    assert not probes.taa0_whole(128, 128, 16, 128, 1056, sms)
    assert not probes.taa0_whole(128, 128, 16, 16, 1056, sms)
    assert not probes.taa0_whole(16, 128, 16, 16, 131, sms)
    assert [probes.taa0_whole(r, 128, 16, 0, 1, sms) for r in (8, 32, 128)] == [
        True, False, False]
    assert [probes.taa0_whole(r, 128, 16, 0, sms, sms) for r in (8, 32, 128)] == [
        True, True, False]
    assert probes.taa0_whole(16, 12, 16, 0, 3, sms)  # 768 B: one load a thread
    assert not probes.taa0_whole(8, 128, 2, 0, 1, sms)  # 2 indices reach too few


def test_ohg_mma_refuses_tables_over_its_clusters_shared_memory():
    """The mma mode holds a table's byte planes in its cluster's shared
    memory, 8 blocks at most: on an H100 (232,448 bytes a block) 4,096
    rows fit, 8,192 rows (401,408 bytes a block) are refused, naming the
    bytes."""
    limit = 232448
    assert probes.ohg_mma_check(4096, limit) == 8
    with pytest.raises(ValueError, match="8192-row table over 8 blocks are 401408 bytes"):
        probes.ohg_mma_check(8192, limit)
    with pytest.raises(ValueError, match="over the 100000 bytes"):
        probes.ohg_mma_check(1024, 100000)
    # on the CPU the wrapper runs the plain version at any size
    table = torch.zeros(8192, 128, dtype=torch.int32)
    assert torch.equal(probes.ohg_probe(table, torch.ones(4, dtype=torch.int32), k=1,
                                        mode="mma"), torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("n_rows", [128, 1024])
def test_ohg_library_yardstick_equals_the_plain_chase(n_rows):
    """gather_probe3.ohg_library, the reference's formulation as PyTorch
    calls (a float32 one-hot times the float32 table), is exact."""
    tbln, idxn = g3.ohg_inputs(n_rows, 2)
    table, idx = torch.from_numpy(tbln), torch.from_numpy(idxn)
    assert torch.equal(g3.ohg_library(table, idx, 4), probes.ohg_plain(table, idx, 4))


def test_gather_ab_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        gather_ab.run()


def test_gather_ab_drops_the_new_arguments_for_the_earlier_entries():
    """The earlier source's entry points, as built, take the arguments the
    current wrappers pass less the slice (take-along) or the cluster
    (one-hot gather); the source kept is the parent commit's."""
    import inspect
    import re

    with open(gather_ab.EARLIER) as f:
        old = f.read()
    with open(gather_ab.EARLIER.replace("earlier/hako_probes_5ace4b1.cu",
                                        "hako_probes.cu")) as f:
        new = f.read()

    def params(text, name):
        head = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in head.split(",")]

    assert params(new, "take_along_probe_launch") == (
        params(old, "take_along_probe_launch")[:12] + ["slice", "stream"])
    assert params(new, "ohg_probe_launch") == (
        params(old, "ohg_probe_launch")[:8] + ["cluster", "stream"])
    assert "a[:12], a[13]" in inspect.getsource(gather_ab.build_earlier)
    assert "a[:8], a[9]" in inspect.getsource(gather_ab.build_earlier)
    assert set(gather_ab.ENTRIES) == set(re.findall(r'extern "C" [\w ]+?\*? ?(\w+)\(', old))


def test_every_bound_entry_point_takes_the_arguments_of_its_source():
    """utils/cuda_build._bind declares for each C entry point as many
    arguments as its definition in csrc/ takes (a launcher that gains or
    loses an argument without its binding fails here, not on the card)."""
    import glob
    import os
    import re
    import types

    from massivevoxelraytracing_torch.utils import cuda_build

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    cuda_build._bind(lib)
    src = ""
    for path in sorted(glob.glob(os.path.join(cuda_build.CSRC, "*.c*"))):
        with open(path) as f:
            src += f.read()
    bound = {name: fn.argtypes for name, fn in vars(lib).items() if hasattr(fn, "argtypes")}
    assert {"take_along_probe_launch", "ohg_probe_launch", "ohg_mma_max_clusters"} <= set(bound)
    for name, argtypes in bound.items():
        m = re.search(rf'extern "C" [^;{{]*?\b{name}\(([^)]*)\)\s*{{', src)
        assert m, name
        params = [a for a in m.group(1).split(",") if a.strip() not in ("", "void")]
        assert len(argtypes) == len(params), name
