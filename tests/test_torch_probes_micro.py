"""The plain versions of the issue-cost probes (ops/probes.py:
construct_probe, node_gather_probe, table_select_probe, calib_probe and
the scan64 walk probe) against the JAX package's functions on the same
inputs: [16, 128] lanes from a seeded numpy generator, K = 8 repeats. The
JAX bodies are those of scripts/construct_micro.py and
scripts/hako_kernel_micro.py, re-stated here (the scripts set up a TPU
runtime when imported). All exact: integer outputs, or f32 evaluated op
by op under jax.disable_jit(). The kernels run on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.ops import probes

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (16, 128)
K = 8


def inputs(rng):
    """construct_micro.py's af, bf (f32), ai (i32), au and a second u32."""
    return dict(
        f=[rng.uniform(0.5, 2.0, SHAPE).astype(np.float32) for _ in range(2)],
        i=[rng.integers(0, 1 << 30, SHAPE).astype(np.int32)],
        u=[rng.integers(0, 1 << 32, SHAPE, dtype=np.uint64).astype(np.uint32)
           for _ in range(2)])


def jax_construct(kind, args):
    """construct_micro.py's kernel bodies, K repeats."""
    if kind in ("minmax", "cmpsel"):
        x, y = args
        for _ in range(K):
            if kind == "minmax":
                x = jnp.minimum(jnp.maximum(x, y), y + x)
            else:
                x = jnp.where(x < y, x + y, y)
        return x
    x = args[0]
    if kind == "i2f":
        acc = jnp.zeros(SHAPE, jnp.float32)
        for _ in range(K):
            acc = acc + (x & 255).astype(jnp.float32)
            x = x ^ acc.astype(jnp.int32)
        return acc
    for _ in range(K):
        if kind == "int":
            x = ((x + 7) & 0x7FFFFFF) ^ (x >> 3)
        elif kind == "vshift":
            sh = (x & 31).astype(jnp.uint32)
            x = x + ((args[1] >> sh) & jnp.uint32(1)).astype(jnp.int32)
        elif kind == "barrel":
            sh = x & 31
            v = args[1]
            for b in (1, 2, 4, 8, 16):
                v = jnp.where((sh & b) != 0, v >> b, v)
            x = x + (v & jnp.uint32(1)).astype(jnp.int32)
        elif kind == "bitat":
            x = x + jk._bit_at(args[1], args[2], x & 63).astype(jnp.int32)
        else:
            x = x + jk._pc64_below(args[1], args[2], x & 63)
    return x


@pytest.mark.parametrize("kind", list(probes.CONSTRUCTS))
def test_construct_plain_matches_jax(kind):
    rng = np.random.default_rng(list(probes.CONSTRUCTS).index(kind))
    pool = inputs(rng)
    taken = {"f": 0, "i": 0, "u": 0}
    args = []
    for c in probes.CONSTRUCTS[kind]:
        args.append(pool[c][taken[c]])
        taken[c] += 1
    with jax.disable_jit():
        want = np.asarray(jax_construct(kind, [jnp.asarray(a) for a in args]))
    got = probes.construct_probe(
        kind, [torch.from_numpy(a.reshape(-1).view(np.int32 if a.dtype == np.uint32
                                                   else a.dtype)) for a in args], k=K)
    assert got.dtype == (torch.float32 if kind in probes.FLOAT_CONSTRUCTS else torch.int32)
    np.testing.assert_array_equal(got.numpy().reshape(SHAPE), want)


def jax_gather_chain(gather, idx0):
    """hako_kernel_micro.py's k_gflat / k_gsplit chain, K repeats, with the
    masks folded as node_gather_plain folds them."""
    acc = jnp.zeros(SHAPE, jnp.int32)
    fold = jnp.zeros(SHAPE, jnp.uint32)
    for _ in range(K):
        a, b, c = gather(idx0 + acc)
        acc = (acc + c) & 31
        fold = fold ^ a ^ b
    return np.asarray(acc), np.asarray(fold).view(np.int32)


@pytest.mark.parametrize("rows", [None, 1, 8, 32])
def test_node_gather_plain_matches_jax_gathers(rows):
    """rows None: the flat [128, 16] table of _gather_node_flat; else the
    split [rows, 11 * 128] table of _gather_node."""
    rng = np.random.default_rng(10 if rows is None else rows)
    if rows is None:
        tab = rng.uniform(0, 255, (128, 16)).astype(np.float32)
        n = 128
        gather = jax.jit(lambda i: jk._gather_node_flat(jnp.asarray(tab), 128, i))
    else:
        tab = rng.uniform(0, 255, (rows, probes.N_TAB_SEG * 128)).astype(np.float32)
        n = rows * 128
        gather = jax.jit(lambda i: jk._gather_node(jnp.asarray(tab), rows, i))
    idx0 = rng.integers(0, n - 31, SHAPE).astype(np.int32)
    want = jax_gather_chain(gather, jnp.asarray(idx0))
    table = probes.node_table_from_segments(tab, "cpu")
    assert table.dtype == torch.int32 and tuple(table.shape) == (n, 3)
    for space in probes.SPACES:
        got = probes.node_gather_probe(table, torch.from_numpy(idx0.reshape(-1)), k=K,
                                       space=space)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().reshape(SHAPE), w)


def test_node_table_refuses_other_shapes():
    with pytest.raises(ValueError):
        probes.node_table_from_segments(np.zeros((4, 12), np.float32), "cpu")
    with pytest.raises(ValueError):  # not a power of two
        probes.node_gather_probe(torch.zeros((96, 3), dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32), k=K, space="global")
    with pytest.raises(ValueError):  # k not a multiple of the kernels' unroll
        probes.construct_probe("int", [torch.zeros(4, dtype=torch.int32)], k=6)


def test_table_select_plain_matches_fold_select():
    """hako_kernel_micro.py's k_fold: _fold_select over 64 x 3 u32 words."""
    rng = np.random.default_rng(11)
    tab3 = rng.integers(0, 1 << 32, (1, 192), dtype=np.uint64).astype(np.uint32)
    idx0 = rng.integers(0, 56, SHAPE).astype(np.int32)
    items = [[jnp.uint32(tab3[0, 3 * i + j]) for i in range(64)] for j in range(3)]
    acc = jnp.zeros(SHAPE, jnp.int32)
    for _ in range(K):
        sel = (jnp.asarray(idx0) + acc) & 63
        a, b, c = (jk._fold_select(it, sel, 6) for it in items)
        acc = (acc + (a ^ b ^ c).astype(jnp.int32)) & 31
    tab = torch.from_numpy(tab3.reshape(64, 3).view(np.int32))
    for form in probes.FORMS:
        got = probes.table_select_probe(tab, torch.from_numpy(idx0.reshape(-1)), k=K,
                                        form=form)
        np.testing.assert_array_equal(got.numpy().reshape(SHAPE), np.asarray(acc))


@pytest.mark.parametrize("kind", probes.CALIBS)
def test_calib_plain_matches_jax_op_by_op(kind):
    """calibrate()'s k_chain / k_par8, each multiply and add rounded."""
    rng = np.random.default_rng(12)
    a0 = rng.uniform(0.5, 2.0, SHAPE).astype(np.float32)
    b0 = rng.uniform(0.5, 2.0, SHAPE).astype(np.float32)
    with jax.disable_jit():
        if kind == "chain":
            a, b = jnp.asarray(a0), jnp.asarray(b0)
            for _ in range(1024):
                a = a * 1.0000001 + b
            want = np.asarray(a)
        else:
            b = jnp.asarray(a0)
            acc = [jnp.asarray(a0) + float(i) for i in range(8)]
            for _ in range(128):
                acc = [x * 1.0000001 + b for x in acc]
            r = acc[0]
            for x in acc[1:]:
                r = r + x
            want = np.asarray(r)
    assert np.float32(1.0000001) == np.float32(1 + 2.0 ** -23)
    got = probes.calib_probe(kind, torch.from_numpy(a0.reshape(-1)),
                             torch.from_numpy(b0.reshape(-1)))
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy().reshape(SHAPE), want)


def test_scan_walk_probe_matches_jax_scan_and_the_walk():
    """The scan64 walk probe's cell sums equal the reference's _scan64_impl
    (op by op) and the walk64 probe's on planes of real rays."""
    rng = np.random.default_rng(13)
    n, iters = 512, 3
    ro = torch.from_numpy(rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    _t0, t1, dt, _vm6, _ok = hk._ray_preamble(torch.zeros(3), torch.ones(3), ro, rd)
    dc = dt * 0.25
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    args = (torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32)),
            t1.contiguous(), dc.contiguous())
    got = probes.walk_probe(*args, iters=iters, impl="scan")
    want = np.zeros(n, np.int64)
    t1n, dcn = t1.numpy(), dc.numpy()
    with jax.disable_jit():
        for _ in range(iters):
            cell = jk._scan64_impl(jnp.asarray(lo), jnp.asarray(hi), jnp.zeros(n, jnp.int32),
                                   *[jnp.asarray(t1n[a]) for a in range(3)],
                                   *[jnp.asarray(dcn[a]) for a in range(3)],
                                   jnp.zeros(n, jnp.float32))[2]
            want += np.asarray(cell)
            lo = lo * np.uint32(1664525) + np.uint32(1013904223)
            hi = hi * np.uint32(22695477) + np.uint32(1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  probes.walk_probe(*args, iters=iters).numpy())
    assert (want < 64 * iters).any() and (want > 0).any()


@pytest.mark.parametrize("script", ["construct_micro", "hako_kernel_micro"])
def test_scripts_run_the_plain_versions_and_refuse_without_a_card(script, monkeypatch):
    import importlib

    mod = importlib.import_module(f"massivevoxelraytracing_torch.scripts.{script}")
    recs = mod.main(["--device", "cpu"])
    names = {r["name"] for r in recs}
    assert {"calib chain", "calib par8"} <= names
    if script == "construct_micro":
        assert {f"construct {c}" for c in probes.CONSTRUCTS} <= names
    else:
        assert {"walk64", "scan64", "fetch 2 brick words"} <= names
        assert {f"gather {s} n={n}" for s in probes.SPACES for n in (128, 1024, 4096)} <= names
        assert {f"select 64x3 {f}" for f in probes.FORMS} <= names
    assert all(r["max_abs_err"] == 0.0 and "ms" not in r for r in recs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_scripts_share_one_calibration():
    """Run on one meter, the two scripts calibrate once and measure each
    case once."""
    from massivevoxelraytracing_torch.scripts import common, construct_micro
    from massivevoxelraytracing_torch.scripts import hako_kernel_micro

    meter = common.Meter(torch.device("cpu"))
    hako_kernel_micro.main(["--device", "cpu"], meter=meter)
    recs = construct_micro.main(["--device", "cpu"], meter=meter)
    cases = [(r["name"], r["shape"]) for r in recs]
    assert len(cases) == len(set(cases))
    assert [r["name"] for r in recs if r["name"].startswith("calib")] == [
        f"calib {c}" for c in probes.CALIBS]
    assert all(r["checked_k"] == [r["k"]] for r in recs)


# the shared forms' wavefront model (scripts/common.smem_wavefronts) and
# the staged layouts' address functions


def test_smem_wavefronts_broadcast_and_one_bank():
    """A word every lane asks for is one wavefront; 32 distinct words of
    one bank are 32; 32 words in 32 banks are 1; a lane that loads nothing
    costs nothing; a 16-byte load of 32 consecutive records is 4 phases."""
    from massivevoxelraytracing_torch.scripts import common

    lane = np.arange(32)
    assert common.smem_wavefronts(np.full(32, 7)) == 1
    assert common.smem_wavefronts(lane * 32 + 5) == 32
    assert common.smem_wavefronts(lane) == 1
    assert common.smem_wavefronts(np.where(lane < 2, lane * 32, -1)) == 2
    assert common.smem_wavefronts(lane * 4, 16) == 4
    assert common.smem_wavefronts(np.zeros(32, int), 16) == 4  # a broadcast a phase
    assert common.smem_wavefronts(lane * 32, 16) == 32  # 8 records of one bank a phase
    assert list(common.smem_wavefronts(np.stack([lane, lane * 32]))) == [1, 32]


@pytest.mark.parametrize("n, want", [(64, 6.0), (128, 8.4), (1024, 10.3), (4096, 10.5)])
def test_smem_wavefronts_of_the_packed_table(n, want):
    """Uniformly random entries of the packed table (stride 3 words), 4,000
    warps: the wavefronts a warp-repeat of its 3 loads, as the uniform
    model counts them (6.0 / 8.4 / 10.3 / 10.5 at 64 / 128 / 1,024 / 4,096
    entries)."""
    from massivevoxelraytracing_torch.scripts import common

    e = np.random.default_rng(n).integers(0, n, (1, 4000 * 32))
    assert common.staged_wavefronts(e, 3, 1) == pytest.approx(want, abs=0.1)


@pytest.mark.parametrize("rec, copies, per_load", [(3, 32, 1), (4, 8, 4)])
def test_replicated_layouts_are_conflict_free(rec, copies, per_load):
    """32 word copies take 1 wavefront a 4-byte load and 8 record copies 4
    a 16-byte load, whatever the entries: random, all one entry, all in one
    bank of the packed table, a stride of 8 records, each warp's lanes
    sorted or reversed."""
    from massivevoxelraytracing_torch.scripts import common

    rng = np.random.default_rng(24)
    lane = np.arange(32)
    for e in (rng.integers(0, 4096, (200, 32)), np.zeros((1, 32), int),
              (lane * 32)[None], (lane * 8)[None], np.sort(rng.integers(0, 64, (50, 32))),
              (31 - lane)[None]):
        for a, width in common.staged_loads(e, rec, copies):
            assert width == (16 if rec == 4 else 4)
            assert (common.smem_wavefronts(a, width) == per_load).all()


@pytest.mark.parametrize("select", [False, True])
def test_fetch_entries_follow_the_plain_recurrence(select):
    """The entries a case reads at repeat r are (idx0 + acc_r) & (n - 1),
    acc_r the plain version's output after r repeats; a lane past the
    last whole warp starts at entry 0."""
    from massivevoxelraytracing_torch.scripts import common

    rng = np.random.default_rng(5)
    n = 64 if select else 128
    tab = torch.from_numpy(rng.integers(0, 1 << 32, (n, 3), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32))
    idx0 = torch.from_numpy(rng.integers(0, n - 31, 45).astype(np.int32))
    e = common.fetch_entries(tab, idx0, 9, select=select)
    assert e.shape == (9, 64) and (e[0, 45:] == 0).all()
    for r in (0, 1, 8):
        acc = (probes.table_select_plain(tab, idx0, r) if select else
               probes.node_gather_plain(tab, idx0, r)[0]) if r else torch.zeros(45, dtype=torch.int32)
        assert np.array_equal(e[r, :45], ((idx0 + acc) & (n - 1)).numpy())


def test_staged_layouts_by_table_size():
    """The launchers' layouts (mirrored for the wavefront model): the
    select's 32 word copies; the node fetch's 32 word copies where they fit
    48 KB, 4 record copies up to 1,024 nodes, the packed table beyond."""
    assert probes.SELECT_LAYOUT == (3, 32)
    assert [probes.gather_layout(1 << j) for j in range(13)] == (
        [(3, 32)] * 8 + [(4, 4)] * 3 + [(3, 1)] * 2)
