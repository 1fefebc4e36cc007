"""The pieces inside the round kernels, each alone on the card (the JAX
package's scripts/hako_kernel_micro.py): walk64 and the 64-cell scan64
sweep (walk_probe), a node fetch from a node table in global, shared and
constant memory (node_gather_probe; n = 128, 1024, 4096 nodes: the JAX
package's flat table and its split tables of 1, 8 and 32 rows, carried
across by node_table_from_segments), the 64-entry select that the
reference's fold_select over SMEM does, from constant memory, shared
memory or registers with warp shuffles (table_select_probe), and the
brick-row word fetch (fetch_probe); and `calibrate`: the rate at which an
SM issues each class of instruction the repeat loops issue, alone and in
pairs (common.pipe_rates over pipe_probe: the rates every case's pipe
floor is read at), then dependent multiply-adds against eight independent
chains (calib_probe), which give the latency of one dependent
instruction.

    python -m massivevoxelraytracing_torch.scripts.hako_kernel_micro
    python -m massivevoxelraytracing_torch.scripts.hako_kernel_micro --device cpu

Every case is held bit for bit against its plain version (ops/probes.py)
at each launch shape and each repeat count it is timed at, then timed
with CUDA events; a line a case and
shape as scripts/construct_micro.py prints. The shared forms' cases add a
line of shared-memory floors beside the issue floor: the case's own
wavefronts a warp-repeat in the launch's layout and in the packed table,
their floor, the 3-wavefront floor and, for the node fetch at the
script's shape, the staged tables at the card's L2 read rate. The walks read the planes of
random rays through the unit box (the JAX script's k_walk reads random
planes); the node fetches start at random nodes spread over the table
(the JAX script's start at nodes below 56). --device cpu runs the plain
versions at 256 lanes and prints no time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hako_kernels as hk
from ..ops import probes
from . import common

K = 64                      # in-kernel repeats (the JAX script's)
TABLES = ((128, None), (1024, 8), (4096, 32))  # nodes, split rows (None: flat)
FETCH_ROWS = 4096           # the word fetch's rows (2.7 MB, L2-resident)
# the walks' repeats at one warp an SM and at full occupancy: a repeat
# takes 0.57 us at one warp an SM and the card runs 125 G repeats/s
# (NVIDIA H100 80GB HBM3, 700 W), so these time well, and their plain
# versions (hundreds of eager ops a repeat) check them quickly
WALK_LATENCY_REPEATS, WALK_RATE_REPEATS = 128, 64
# the calibration's at one warp an SM: its dependent instruction's ns is
# every latency floor's unit, and its plain version is two ops a repeat
CALIB_LATENCY_REPEATS = 4096


def _f32(rng, lanes, device):
    return torch.from_numpy(rng.uniform(0.5, 2.0, lanes).astype(np.float32)).to(device)


def _u32(rng, size, device):
    return torch.from_numpy(rng.integers(0, 1 << 32, size, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)


def calibrate(meter, seed: int = 0) -> list:
    """The SM's pipes first (common.pipe_rates: meter.pipe, the rates and
    pipes every case's pipe floor is read at); then k_chain and k_par8 at
    every launch shape; sets meter.dep_ns, the ns of one dependent
    instruction, from the chain at one warp an SM, and marks the meter
    calibrated."""
    rng = np.random.default_rng(seed)
    cuda = meter.device.type == "cuda"
    pipe = common.pipe_rates(meter.device, meter.funcs if cuda else None,
                             meter.sms if cuda else 0, meter.clock if cuda else 0.0,
                             meter.card, seed)
    if cuda:
        meter.pipe = pipe
    out = []
    for kind in probes.CALIBS:
        base = probes.CALIB_REPEATS[kind]
        for shape in common.shapes(meter.device, base,
                                   latency_k=CALIB_LATENCY_REPEATS):
            a = _f32(rng, shape["lanes"], meter.device)
            b = _f32(rng, shape["lanes"], meter.device)
            rec = meter.case(
                f"calib {kind}", "calib_probe_kernel", (probes.CALIBS.index(kind),),
                shape,
                lambda kk, a=a, b=b, t=shape["threads"]: probes.calib_probe(
                    kind, a, b, k=kk, threads=t),
                lambda kk, a=a, b=b: probes.calib_plain(kind, a, b, kk),
                n_bytes=12 * shape["lanes"], repeats=probes.UNROLL)
            if kind == "chain" and shape["shape"] == "one warp an SM" and "ms" in rec:
                meter.dep_ns = rec["ns_per_repeat"] / rec["chain_per_repeat"]
                print(f"calib: {meter.dep_ns:.4f} ns per dependent instruction "
                      f"({meter.dep_ns * meter.clock * 1e-9:.2f} cycles at the "
                      f"maximum SM clock) [{meter.card}]", flush=True)
            out.append(rec)
    meter.calibrated = True
    return out


def ray_planes(lanes, device, rng):
    """(t1, dc) f32 [3, lanes]: exit planes and quarter spans of random
    rays through the unit box."""
    ro = torch.from_numpy(rng.uniform(-1.0, 2.0, (lanes, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(lanes, 3)).astype(np.float32))
    _t0, t1, dt, _vm6, _ok = hk._ray_preamble(torch.zeros(3), torch.ones(3), ro, rd)
    return t1.contiguous().to(device), (dt * 0.25).contiguous().to(device)


def segment_table(n: int, rows, rng) -> np.ndarray:
    """A JAX-style node table of n nodes: the flat f32 [128, 16] or the
    split f32 [rows, 11 * 128] of random byte segments."""
    if rows is None:
        return rng.uniform(0, 255, (n, 16)).astype(np.float32)
    return rng.uniform(0, 255, (rows, probes.N_TAB_SEG * 128)).astype(np.float32)


def smem_floors(meter, rec: dict, table, idx0, shape: dict, layout: tuple, *,
                select: bool, l2: float = 0.0, n: int = 64) -> None:
    """A shared-form case's shared-memory floors, printed and added to its
    record beside the issue floor (not to its bound): its own wavefronts a
    warp-repeat in the launch's layout and in the packed table, their
    floor and the 3-wavefront floor (common.case_wavefronts,
    wavefront_ms); for the node fetch at the script's shape also its
    staged tables (each block's read of the 12 n bytes) over the card's
    L2 read rate `l2`."""
    lanes, k = shape["lanes"], shape["k"]
    waves, packed = common.case_wavefronts(table, idx0, k, select=select,
                                           layouts=(layout, (3, 1)))
    rec.update(layout=list(layout), wavefronts=waves, packed_wavefronts=packed,
               wavefront_floor_ms=common.wavefront_ms(lanes, k, waves, meter.sms, meter.clock),
               floor3_ms=common.wavefront_ms(lanes, k, 3, meter.sms, meter.clock))
    rec["wavefront_share"] = rec["wavefront_floor_ms"] / rec["ms"]
    staged = ""
    if not select and shape["shape"] == "script":
        rec["staged_l2_ms"] = -(-lanes // shape["threads"]) * 12 * n / l2 * 1e3
        staged = (f", the staged tables at the L2 read rate ({l2 / 1e12:.2f} TB/s) "
                  f"{rec['staged_l2_ms']:.4f} ms")
    print(f"{rec['name']:26s} {shape['shape']:14s} shared memory, layout {tuple(layout)}: "
          f"{waves:.2f} wavefronts a warp-repeat (packed table {packed:.2f}), their floor "
          f"{rec['wavefront_floor_ms']:.4f} ms ({rec['wavefront_share']:.1%} of the launch), "
          f"3 wavefronts {rec['floor3_ms']:.4f} ms{staged} [{meter.card}]", flush=True)


def run(meter, k: int = K, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    dev = meter.device
    for impl in probes.WALK_IMPLS:
        for shape in common.shapes(dev, k, latency_k=WALK_LATENCY_REPEATS,
                                   rate_k=WALK_RATE_REPEATS):
            n = shape["lanes"]
            t1, dc = ray_planes(n, dev, rng)
            lo, hi = _u32(rng, n, dev), _u32(rng, n, dev)
            meter.case(
                f"{impl}64", "walk_probe_kernel", (impl == "scan",), shape,
                lambda kk, a=(lo, hi, t1, dc), t=shape["threads"]: probes.walk_probe(
                    *a, iters=kk, impl=impl, threads=t),
                lambda kk, a=(lo, hi, t1, dc): probes.walk_probe_plain(
                    *a, iters=kk, impl=impl),
                n_bytes=36 * n, repeats=1)
    l2 = (max(common.l2_read_rates(dev, np.random.default_rng(seed)).values())
          if dev.type == "cuda" else 0.0)
    for n_nodes, rows in TABLES:
        table = probes.node_table_from_segments(segment_table(n_nodes, rows, rng), dev)
        layout = probes.gather_layout(n_nodes)
        for space in probes.SPACES:
            kernel = (("node_gather_shared_kernel", layout) if space == "shared" else
                      ("node_gather_probe_kernel", (probes.SPACES.index(space),)))
            for shape in common.shapes(dev, k):
                idx0 = torch.from_numpy(rng.integers(0, n_nodes - 31, shape["lanes"])
                                        .astype(np.int32)).to(dev)
                rec = meter.case(
                    f"gather {space} n={n_nodes}", *kernel, shape,
                    lambda kk, i=idx0, t=shape["threads"]: probes.node_gather_probe(
                        table, i, k=kk, space=space, threads=t),
                    lambda kk, i=idx0: probes.node_gather_plain(table, i, kk),
                    n_bytes=12 * (n_nodes + shape["lanes"]), repeats=probes.UNROLL)
                if space == "shared" and "ms" in rec:
                    smem_floors(meter, rec, table, idx0, shape, layout, select=False, l2=l2,
                                n=n_nodes)
    tab = _u32(rng, (64, 3), dev)
    for form in probes.FORMS:
        kernel = (("table_select_shared_kernel", probes.SELECT_LAYOUT) if form == "shared" else
                  ("table_select_probe_kernel", (probes.FORMS.index(form),)))
        for shape in common.shapes(dev, k):
            idx0 = torch.from_numpy(rng.integers(0, 56, shape["lanes"])
                                    .astype(np.int32)).to(dev)
            rec = meter.case(
                f"select 64x3 {form}", *kernel, shape,
                lambda kk, i=idx0, t=shape["threads"]: probes.table_select_probe(
                    tab, i, k=kk, form=form, threads=t),
                lambda kk, i=idx0: probes.table_select_plain(tab, i, kk),
                n_bytes=768 + 8 * shape["lanes"], repeats=probes.UNROLL)
            if form == "shared" and "ms" in rec:
                smem_floors(meter, rec, tab, idx0, shape, probes.SELECT_LAYOUT, select=True)
    rows = _u32(rng, (FETCH_ROWS, probes.ROW_WORDS), dev)
    for shape in common.shapes(dev, k):
        row_of = torch.from_numpy(rng.integers(0, FETCH_ROWS, shape["lanes"])
                                  .astype(np.int32)).to(dev)
        meter.case(
            "fetch 2 brick words", "fetch_probe_kernel", (), shape,
            lambda kk, r=row_of, t=shape["threads"]: probes.fetch_probe(
                rows, r, iters=kk, threads=t),
            lambda kk, r=row_of: probes.fetch_probe_plain(rows, r, iters=kk),
            n_bytes=rows.numel() * 4 + 8 * shape["lanes"], repeats=1)
    return meter.records


def main(argv=None, meter=None) -> list:
    """The calibration and every case; with `meter`, that meter's device
    and calibration (calibrated once, whichever script runs first)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    meter = meter or common.Meter(common.resolve_device(args.device))
    print(meter.card, flush=True)
    if not meter.calibrated:
        calibrate(meter)
    return run(meter)


if __name__ == "__main__":
    main()
