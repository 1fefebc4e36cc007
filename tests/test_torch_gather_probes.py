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
