"""Gather probes on the card, after the JAX package's scripts/gather_probe3.py:

    python -m massivevoxelraytracing_torch.scripts.gather_probe3 [names]
    python -m massivevoxelraytracing_torch.scripts.gather_probe3 --device cpu

  chase      - a dependent chase through torch.index_select (the
               reference's XLA jnp.take loop): 16 hops of 2^21 lanes over a permutation of
               2^20, G dependent gathers/s; no kernel of the port, the
               library yardstick of a dependent gather
  chase_rows - the same through whole rows of an int32 [2^18, 8] table
               (the 16^3-brick fetch shape), the next index in column 0
  a0small    - take_along_axis on axis 0 over [n_rows, 128] tables of 8,
               32, 128 and 1024 rows by a [16, 128] index, one shot
               (ops/probes.take_along_probe from shared memory and through
               L1; a table over a block's shared memory is refused, as the
               reference's FAIL)
  vmem       - the largest dynamic shared memory one block launches with
               (ops/probes.smem_alloc_probe) at 16-227 KB up to the card's
               opt-in limit, then one 512-byte row more
  ohg        - the dependent chase idx = (idx + flat[idx]) & (n - 1) over a
               [128, 128] table, 32 hops of 2,048 lanes: each hop a load
               from shared memory, through L1, or a one-hot product on the
               tensor cores (ops/probes.ohg_probe); beside the tensor
               cores the reference's formulation as PyTorch calls, its
               library yardstick (ohg_library: a float32 one-hot times
               the float32 table by torch.matmul, TF32 off, a hop),
               timed as one CUDA graph of the 32 hops (ohg_library_graph)
               and, host-bound, launched a call at a time
  ohg1k      - the same over [1024, 128]

Default: chase chase_rows a0small vmem (the reference's). Every kernel is
held bit for bit against its plain version before it is timed; the one-hot
gather also against the numpy chase, as the reference validates it. The
one-hot gather is timed with scripts/common.Meter at k and 2k hops (each
checked first). --device cpu runs the plain versions (and the chase loops)
at the reference's shapes and prints no time; without a card and without
that flag the script raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import common

A0_ROWS = (8, 32, 128, 1024)
A0_INDEX_ROWS = 16
VMEM_KB = (16, 32, 48, 64, 100, 128, 200, 227)
OHG_LANE_ROWS = 16   # the reference's [16, 128] lanes
OHG_HOPS = 32


class Context:
    def __init__(self, device, card: str):
        self.device = device
        self.card = card
        self.meter = None

    def get_meter(self):
        if self.meter is None:
            self.meter = common.Meter(self.device)
        return self.meter


def _chase_time(ctx, fn, lanes: int, k: int, what: str) -> dict:
    """Run the chase loop fn; on the card, time it (a train of 10)."""
    rec = dict(name=what, lanes=lanes, k=k, launches=0)
    if ctx.device.type != "cuda":
        fn()
        print(f"{what}: done [{ctx.card}]", flush=True)
        return rec
    ms = common.timed(fn, reps=10)[1]
    rec.update(ms=ms, g_per_s=lanes * k / (ms * 1e-3) / 1e9)
    print(f"{what}: {ms:8.3f} ms  {rec['g_per_s']:6.2f} G dependent gathers/s "
          f"[{ctx.card}]", flush=True)
    return rec


def probe_chase(ctx, n: int = 1 << 20, r: int = 1 << 21, k: int = 16) -> dict:
    rng = np.random.default_rng(0)
    tbl = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(ctx.device)
    idx0 = torch.from_numpy(rng.integers(0, n, (r,)).astype(np.int32)).to(ctx.device)

    def chase():
        idx = idx0
        for _ in range(k):
            idx = tbl.index_select(0, idx)
        return idx

    return _chase_time(ctx, chase, r, k, f"chase flat n={n} r={r} k={k}")


def probe_chase_rows(ctx, n: int = 1 << 18, r: int = 1 << 21, k: int = 16,
                     cols: int = 8) -> dict:
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, n, (n, cols)).astype(np.uint32)
    tbl[:, 0] = rng.permutation(n).astype(np.uint32)
    tbl = torch.from_numpy(tbl.view(np.int32)).to(ctx.device)
    idx0 = torch.from_numpy(rng.integers(0, n, (r,)).astype(np.int32)).to(ctx.device)

    def chase():
        idx = idx0
        for _ in range(k):
            idx = tbl.index_select(0, idx)[:, 0]
        return idx

    return _chase_time(ctx, chase, r, k, f"chase rows{cols} n={n} r={r} k={k}")


def probe_a0small(ctx) -> dict:
    cases = []
    for n_rows in A0_ROWS:
        tbl = np.random.default_rng(0).integers(0, 99, (n_rows, 128)).astype(np.int32)
        idx = np.random.default_rng(1).integers(0, n_rows, (A0_INDEX_ROWS, 128))
        t = torch.from_numpy(tbl[None]).to(ctx.device)
        x = torch.from_numpy(idx.astype(np.int32)[None]).to(ctx.device)
        ref = np.take_along_axis(tbl, idx, axis=0)
        if not np.array_equal(probes.take_along_plain(t, x, axis=0, mod=0).cpu().numpy()[0],
                              ref):
            raise AssertionError(f"a0small n_rows={n_rows}: the plain version differs "
                                 "from numpy")
        for form in ("shared", "global"):
            rec = common.gather_case(f"a0 one-shot n_rows={n_rows:>5}", t, x, axis=0, mod=0,
                                     form=form, c_out=128, card=ctx.card, refusable=True)
            rec["n_rows"] = n_rows
            cases.append(rec)
    return dict(cases=cases)


def probe_vmem(ctx) -> dict:
    """The sizes up to the card's opt-in limit, then its largest row count
    and one row more. On the CPU the plain version at each size."""
    dev = ctx.device
    row = probes.SMEM_ROW_FLOATS * 4
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 2.0, (1, probes.SMEM_ROW_FLOATS))
                         .astype(np.float32)).to(dev)
    want = probes.smem_alloc_plain(x, 1)
    cuda = dev.type == "cuda"
    limit = probes.smem_optin_bytes(dev) if cuda else None
    rows = [kb * 1024 // row for kb in VMEM_KB if not cuda or kb * 1024 <= limit]
    if cuda and limit // row not in rows:
        rows.append(limit // row)
    sizes = []
    before = common.gather_case_launches()
    for n in rows:
        got = probes.smem_alloc_probe(x, n)
        if not torch.equal(got, want):
            raise AssertionError(f"vmem {n} rows: the kernel differs from its plain version")
        sizes.append(dict(rows=n, bytes=n * row, launched=True))
        print(f"smem alloc {n * row / 1024:7.1f} KB ({n} rows): ok, == 4x [{ctx.card}]",
              flush=True)
    rec = dict(sizes=sizes, optin_bytes=limit)
    if cuda:
        over = limit // row + 1
        try:
            probes.smem_alloc_probe(x, over)
            sizes.append(dict(rows=over, bytes=over * row, launched=True))
        except RuntimeError as e:
            sizes.append(dict(rows=over, bytes=over * row, launched=False, error=str(e)))
            print(f"smem alloc {over * row / 1024:7.1f} KB ({over} rows): refused: {e} "
                  f"[{ctx.card}]", flush=True)
        launched = [s for s in sizes if s["launched"]]
        refused = [s for s in sizes if not s["launched"]]
        top = max(launched, key=lambda s: s["bytes"])
        ms = common.event_ms_each(lambda _: probes.smem_alloc_probe(x, top["rows"]),
                                  lambda: None)
        plain_ms = common.timed(lambda: probes.smem_alloc_plain(x, top["rows"]), reps=1,
                                warm=False)[1]
        b_ms, b_by = common.bound(2 * row, 0)
        rec.update(optin_rows=limit // row, largest_launched_bytes=top["bytes"],
                   largest_launched_rows=top["rows"],
                   first_refused_bytes=refused[0]["bytes"] if refused else None,
                   refused_rows=refused[0]["rows"] if refused else None,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"smem alloc: the largest that launched {top['bytes']} B ({top['rows']} rows; "
              f"opt-in limit {limit} B), the first refused "
              f"{rec['first_refused_bytes']} B; {ms * 1e3:.3f} us a launch at the largest "
              f"[{ctx.card}]", flush=True)
    rec["launches"] = common.gather_case_launches() - before
    return rec


def ohg_inputs(n_rows: int, r_rows: int = OHG_LANE_ROWS):
    """The reference's draws: (table int32 [n_rows, 128], lanes int32
    [r_rows, 128]) from one default_rng(0), values below n = 128 n_rows."""
    n = n_rows * 128
    rng = np.random.default_rng(0)
    tbln = rng.integers(0, n, (n_rows, 128)).astype(np.int32)
    idxn = rng.integers(0, n, (r_rows, 128)).astype(np.int32)
    return tbln, idxn


def numpy_chase(tbln, idxn, k: int):
    flat = tbln.reshape(-1)
    exp = idxn.copy()
    for _ in range(k):
        exp = (exp + flat[exp]) & (flat.shape[0] - 1)
    return exp


def ohg_ops(lanes: int, n_rows: int, k: int) -> float:
    """The one-hot product's int8 operations: 2 x lanes x n_rows x 128 x 3
    planes a hop."""
    return 2.0 * lanes * n_rows * probes.OHG_COLS * probes.OHG_PLANES * k


def ohg_library(table, idx, k: int):
    """k hops of the reference's MXU formulation as PyTorch calls: the
    float32 one-hot rows of the lanes' indices times the float32 table
    (torch.matmul, exact with TF32 off: one product by 1.0 an output),
    the lane's column (torch.gather), add and mask. Equals ohg_plain."""
    if table.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the one-hot yardstick needs float32 matmuls: TF32 is on")
    n_rows = table.shape[0]
    tab = table.to(torch.float32)
    rows = torch.arange(n_rows, device=table.device)
    x = idx.reshape(-1).long()
    for _ in range(k):
        one_hot = ((x >> 7)[:, None] == rows[None, :]).to(torch.float32)
        v = torch.matmul(one_hot, tab).gather(1, (x & 127)[:, None])[:, 0]
        x = (x + v.long()) & (n_rows * probes.OHG_COLS - 1)
    return x.to(torch.int32).reshape(idx.shape)


def ohg_library_graph(table, idx, k: int):
    """ohg_library's k hops captured once in one CUDA graph: a function of
    no arguments that replays them and returns the graph's output, so that
    timing it reads the library calls' device work without the host's
    launch of each (ohg_library itself is host-bound: several launches a
    hop). Needs a card."""
    dev = table.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ohg_library(table, idx, k)  # cuBLAS's handle and workspace, before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ohg_library(table, idx, k)

    def replay():
        graph.replay()
        return out
    return replay


def probe_ohg(ctx, n_rows: int = 128, r_rows: int = OHG_LANE_ROWS, k: int = OHG_HOPS) -> dict:
    dev = ctx.device
    tbln, idxn = ohg_inputs(n_rows, r_rows)
    table = torch.from_numpy(tbln).to(dev)
    idx = torch.from_numpy(idxn).to(dev)
    lanes = idx.numel()
    exp = numpy_chase(tbln, idxn, k)
    for plain_mode in ("gather", "mma"):
        if not np.array_equal(probes.ohg_plain(table, idx, k, plain_mode).cpu().numpy(), exp):
            raise AssertionError(f"ohg n_rows={n_rows}: the plain {plain_mode} chase differs "
                                 "from numpy")
    meter = ctx.get_meter()
    cases = []
    for mode in probes.OHG_MODES:
        name = f"ohg n={n_rows * 128:>7} {mode}"
        before = common.gather_case_launches()
        plain_mode = "mma" if mode == "mma" else "gather"
        shape = dict(shape="reference", lanes=lanes, threads=probes.OHG_THREADS, k=k)
        need = table.numel() * 4 if mode == "shared" else 0
        cl = probes.ohg_cluster(n_rows)
        kernel, targs = (("ohg_mma_kernel", (cl, cl)) if mode == "mma" else
                         ("ohg_probe_kernel", (probes.OHG_MODES.index(mode),)))
        if mode == "mma":
            shape["threads"] = 32 * probes.OHG_TILES
        # the case is measured at once, so its closures may read the loop's names
        rec, refused = common.smem_refusal(lambda: meter.case(
            name, kernel, targs, shape,
            lambda kk: probes.ohg_probe(table, idx, k=kk, mode=mode),
            lambda kk: probes.ohg_plain(table, idx, kk, plain_mode),
            n_bytes=4 * (table.numel() + 2 * lanes),
            repeats=1 if mode == "mma" else probes.UNROLL), need, dev)
        if refused is not None:
            print(f"{name}: refused: {refused} [{ctx.card}]", flush=True)
            cases.append(dict(name=name, mode=mode, n_rows=n_rows, refused=True,
                              smem_bytes=need, optin_bytes=probes.smem_optin_bytes(dev),
                              launches=common.gather_case_launches() - before))
            continue
        rec.update(mode=mode, n_rows=n_rows, refused=False)
        if mode == "mma":
            rec["cluster"] = cl
            if not torch.equal(ohg_library(table, idx, k), probes.ohg_plain(table, idx, k)):
                raise AssertionError(f"{name}: the torch.matmul yardstick differs from the "
                                     "plain chase")
        if dev.type == "cuda":
            lib = ""
            if mode == "mma":
                ops = ohg_ops(lanes, n_rows, k)
                graphed = ohg_library_graph(table, idx, k)
                if not torch.equal(graphed(), probes.ohg_plain(table, idx, k)):
                    raise AssertionError(f"{name}: the graphed torch.matmul yardstick differs "
                                         "from the plain chase")
                rec.update(bound_ms=ops / common.INT8_OPS_PER_S * 1e3, bound_by="operations",
                           library_ms=common.best_ms([graphed], reps=3)[0],
                           library_host_bound_ms=common.best_ms(
                               [lambda: ohg_library(table, idx, k)], reps=3)[0])
                lib = (f"; torch.matmul yardstick {rec['library_ms']:.4f} ms in one CUDA graph, "
                       f"{rec['library_host_bound_ms']:.4f} ms launched a call at a time "
                       "(host-bound)")
            rec["plain_ms"] = common.timed(lambda: probes.ohg_plain(
                table, idx, k, plain_mode), reps=1, warm=False)[1]
            rec["us_per_hop"] = (rec["ms_2k"] - rec["ms"]) * 1e3 / k
            print(f"{name}: {rec['ms'] * 1e3:9.2f} us at {k} hops, {rec['us_per_hop']:.4f} "
                  f"us a hop (2k - k), {lanes * k / (rec['ms'] * 1e-3) / 1e9:6.3f} G "
                  f"gathers/s; bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}), "
                  f"share {rec['bound_ms'] / rec['ms']:.1%}; plain {rec['plain_ms']:.3f} ms"
                  f"{lib} [{ctx.card}]", flush=True)
        rec["launches"] = common.gather_case_launches() - before
        cases.append(rec)
    return dict(n_rows=n_rows, lanes=lanes, k=k, cases=cases)


ALL = {
    "chase": probe_chase,
    "chase_rows": probe_chase_rows,
    "a0small": probe_a0small,
    "vmem": probe_vmem,
    "ohg": lambda ctx: probe_ohg(ctx, 128),
    "ohg1k": lambda ctx: probe_ohg(ctx, 1024),
}
DEFAULT = ("chase", "chase_rows", "a0small", "vmem")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("names", nargs="*",
                    help=f"probes to run, of {' '.join(ALL)} (default: {' '.join(DEFAULT)})")
    args = ap.parse_args(argv)
    unknown = [nm for nm in args.names if nm not in ALL]
    if unknown:
        ap.error(f"no probe {unknown}")
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    ctx = Context(dev, card)
    if dev.type == "cuda":
        common.warm_up(dev)
    return {nm: ALL[nm](ctx) for nm in (args.names or DEFAULT)}


if __name__ == "__main__":
    main()
