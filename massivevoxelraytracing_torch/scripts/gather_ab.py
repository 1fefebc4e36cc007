"""The tensor-core one-hot gather (ohg_probe, mma mode) and the shared
axis-0 take-along gather (take_along_probe<0, SHARED>) against an earlier
design of each, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.gather_ab \
        [--old csrc/earlier/hako_probes_5ace4b1.cu]

The earlier design defaults to commit 5ace4b1's csrc/hako_probes.cu, kept
verbatim under `csrc/earlier/` (`git show 5ace4b1:massivevoxelraytracing_
torch/csrc/hako_probes.cu` gives the same file), built with the library's
nvcc flags into a library of its own (utils/cuda_build.build_renamed: its
C entry points suffixed `_old`, the current csrc/ searched for
hako_device.cuh) and called through the same wrappers (ops/probes.
ohg_probe, take_along_probe) with cuda_build.load answering the earlier
entry points; those take no cluster or slice argument, which is dropped.

Cases, each held bit for bit against its plain version through both
designs first, then timed in the turns old, new, new, old (CUDA events; a
turn the least of 3 trains of REPS calls, so that a host stall in one
train does not set it):
  * ohg mma: gather_probe3's 128- and 1024-row tables, 32 hops of 2,048
    lanes; beside them in the same turns the reference's formulation as
    PyTorch calls (gather_probe3.ohg_library, torch.matmul a hop), as one
    CUDA graph of the 32 hops (the library yardstick) and launched a call
    at a time (host-bound), and the int8 bound;
  * take-along, axis 0, shared: dyngather_probe2's k_taa0t and k_taa0 on
    its batch of 8 tiles an SM, every launch reading from HBM (copies
    taken in turn, common.cold_copies), and gather_probe3's a0small
    tables of 8, 32 and 128 rows, one tile after the L2 is flushed (the
    median of REPS launches a turn); beside them torch.gather in the same
    turns and the bytes bound (the sectors the indices reach:
    probes.taa0_sectors). Where the wrapper takes whole tiles
    (probes.taa0_whole: k_taa0's batch and a0small's 8-row tile, whose
    indices reach every sector)
    the current kernel is the earlier one, and the sliced kernel, called
    through its entry point with the slice taa0_slice picks and a new
    output a call as the wrapper's, is timed beside it: the measured
    reason for the choice. Elsewhere the earlier kernel is the whole-tile
    one.
Prints each kernel's ptxas registers and spills. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os

import numpy as np
import torch

from ..ops import hako_kernels as hk
from ..ops import probes
from ..utils import cuda_build
from . import common, dyngather_probe2, gather_probe3
from .walk_ab import ptxas_lines

REPS = 10
TURNS = ("old", "new", "new", "old")
EARLIER = os.path.join(cuda_build.CSRC, "earlier", "hako_probes_5ace4b1.cu")
ENTRIES = ("row_chase_launch", "walk_probe_launch", "fetch_probe_launch",
           "construct_probe_launch", "node_gather_probe_launch", "table_select_probe_launch",
           "calib_probe_launch", "shell_copy_probe_launch", "preamble_probe_launch",
           "probe_stage_probe_launch", "smem_optin_bytes", "cuda_error_string",
           "take_along_probe_launch", "smem_alloc_probe_launch", "ohg_probe_launch")
KERNELS = {"ohg": ("ohg_mma_kernel", "ohg_probe_kernel"),
           "taa0": ("take_along_a0_kernel", "take_along_probe_kernel")}


def build_earlier(src: str = EARLIER):
    """(the earlier library's two entry points as the current wrappers
    call them, its ptxas report), built once a process."""
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "gather_ab")
    lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, ENTRIES,
                                                        includes=(cuda_build.CSRC,))
    print(f"[gather_ab] built the earlier design from "
          f"{os.path.relpath(src, cuda_build.CSRC)} in {seconds:.1f} s", flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    taa, ohg = lib.take_along_probe_launch_old, lib.ohg_probe_launch_old
    taa.argtypes = [i, i, p, p, p, i, i, i, i, i, i, i, p]
    ohg.argtypes = [i, p, i, p, i, i, p, i, p]
    taa.restype = ohg.restype = ctypes.c_int

    def take_along(*a):  # the current signature less the slice
        return taa(*a[:12], a[13])

    def one_hot(*a):  # less the cluster
        return ohg(*a[:8], a[9])

    return dict(take_along_probe_launch=take_along, ohg_probe_launch=one_hot), log


@contextlib.contextmanager
def earlier_entries(entries: dict):
    """The wrappers launch the earlier entry points while inside."""
    lib = cuda_build.load()
    real_load = cuda_build.load

    class Swapped:
        def __getattr__(self, attr):
            return entries.get(attr) or getattr(lib, attr)

    cuda_build.load = Swapped
    try:
        yield
    finally:
        cuda_build.load = real_load


@contextlib.contextmanager
def counts_kept():
    """The probes' and the round kernels' launch counts restored on
    leaving: the comparisons are not the main path's launches."""
    saved = dict(probes.LAUNCHES), dict(hk.LAUNCHES)
    try:
        yield
    finally:
        probes.LAUNCHES.update(saved[0])
        hk.LAUNCHES.update(saved[1])


def in_turns(fns: dict, timer, what: str, want) -> dict:
    """{label: [ms a turn]}: each fn (of no arguments) == want first, then
    timed by timer(fn) in TURNS (the "old" and "new" turns; every other
    label is timed beside each turn)."""
    for label, fn in fns.items():
        got = fn()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {label} differs from the plain version")
    ms = {label: [] for label in fns}
    for turn in TURNS:
        ms[turn].append(timer(fns[turn]))
        for label in fns:
            if label not in ("old", "new"):
                ms[label].append(timer(fns[label]))
    return ms


def report(what: str, ms: dict, bound: tuple, card: str) -> dict:
    old, new = ms["old"], ms["new"]
    faster = ("current" if max(new) < min(old) else
              "earlier" if max(old) < min(new) else "neither")
    extra = "; ".join(f"{k} {' / '.join(f'{v:.4f}' for v in vs)}" for k, vs in ms.items()
                      if k not in ("old", "new"))
    print(f"[gather_ab] {what}: turns earlier {old[0]:.4f}, current {new[0]:.4f}, current "
          f"{new[1]:.4f}, earlier {old[1]:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
          f"share earlier {bound[0] / min(old):.1%}, current {bound[0] / min(new):.1%}; "
          f"faster in every turn: {faster}" + (f"; {extra} ms" if extra else "")
          + f" [{card}]", flush=True)
    return dict(old_ms=old, ms=new, bound_ms=bound[0], bound_by=bound[1],
                share=bound[0] / min(new), old_share=bound[0] / min(old), faster=faster,
                **{f"{k}_ms": v for k, v in ms.items() if k not in ("old", "new")})


def ohg_ab(entries: dict, n_rows: int, card: str) -> dict:
    """ohg mma on gather_probe3's table of n_rows, 32 hops of 2,048 lanes."""
    dev = torch.device("cuda", torch.cuda.current_device())
    tbln, idxn = gather_probe3.ohg_inputs(n_rows)
    table, idx = torch.from_numpy(tbln).to(dev), torch.from_numpy(idxn).to(dev)
    k = gather_probe3.OHG_HOPS
    want = probes.ohg_plain(table, idx, k, "mma")

    def old():
        with earlier_entries(entries):
            return probes.ohg_probe(table, idx, k=k, mode="mma")

    fns = {"old": old, "new": lambda: probes.ohg_probe(table, idx, k=k, mode="mma"),
           "torch.matmul": gather_probe3.ohg_library_graph(table, idx, k),
           "torch.matmul host-bound": lambda: gather_probe3.ohg_library(table, idx, k)}
    ms = in_turns(fns, lambda fn: common.best_ms([fn], reps=REPS)[0],
                  f"ohg mma {n_rows} rows", want)
    ops = gather_probe3.ohg_ops(idx.numel(), n_rows, k)
    cl = probes.ohg_cluster(n_rows)
    held = probes.ohg_max_clusters(n_rows, cl, dev)
    rec = report(f"ohg_probe mma, {n_rows} rows x 128, {k} hops of {idx.numel()} lanes, "
                 f"cluster {cl} ({-(-idx.numel() // (16 * cl))} clusters; the card holds "
                 f"{held} at once; torch.matmul in one CUDA graph, host-bound launched a "
                 "call at a time)", ms,
                 (ops / common.INT8_OPS_PER_S * 1e3, "operations"), card)
    rec.update(cluster=cl, clusters_held=held)
    return rec


def sliced_call(t, idx, mod: int, slice_cols: int):
    """A function of (t, idx, _) that runs the sliced shared axis-0 kernel
    (take_along_a0_kernel) through its entry point with `slice_cols`
    columns a block, into a new output a call as the wrapper does, on
    tiles the wrapper takes whole."""
    dev = t.device
    B, R, C = t.shape
    r, Ci = idx.shape[1:]

    def call(tt, xx, _rr):
        out = torch.empty(B, r, C, dtype=torch.int32, device=dev)
        rc = cuda_build.load().take_along_probe_launch(
            0, probes.TAA_FORMS.index("shared"), tt.data_ptr(), xx.data_ptr(), out.data_ptr(),
            B, R, C, r, Ci, C, int(mod), slice_cols, probes._stream(dev))
        if rc:
            raise RuntimeError(f"take_along_a0_kernel launch failed: CUDA error {rc}")
        return out
    return call


def taa_ab(entries: dict, name: str, t, idx, mod: int, card: str) -> dict:
    """take_along_probe axis 0, shared, on the tiles t by idx: a batch from
    cold copies taken in turn, one tile after an L2 flush."""
    dev = t.device
    B, R, C = t.shape
    want = probes.take_along_plain(t, idx, axis=0, mod=mod)
    red = torch.remainder(idx.long(), mod) if mod else idx.long()
    gathered = torch.empty_like(want)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    whole = probes.taa0_whole(R, C, idx.shape[1], mod, B, sms)
    sl = probes.taa0_slice(C, B, sms)

    def new(tt, xx, rr):
        return probes.take_along_probe(tt, xx, axis=0, mod=mod, form="shared")

    def old(tt, xx, rr):
        with earlier_entries(entries):
            return probes.take_along_probe(tt, xx, axis=0, mod=mod, form="shared")

    def library(tt, xx, rr):
        return torch.gather(tt, 1, rr, out=gathered)

    calls = {"old": old, "new": new, "torch.gather": library}
    if whole:
        calls["sliced"] = sliced_call(t, idx, mod, sl)
    if B == 1:
        flush = common.l2_flush(dev)
        fns = {k: (lambda f=f: f(t, idx, red)) for k, f in calls.items()}

        def timer(fn):
            return common.event_ms_median(lambda _: fn(), flush, REPS)
    else:
        copies = common.cold_copies((t, idx, red), dev)
        fns = {k: common.in_turn(f, copies) for k, f in calls.items()}

        def timer(fn):
            return common.best_ms([fn], reps=REPS)[0]
    ms = in_turns(fns, timer, name, want)
    n_bytes = common.take_along_bytes(t, idx, axis=0, mod=mod, c_out=t.shape[2])
    reached = int(probes.taa0_sectors(t, idx, mod=mod).sum()) * common.SECTOR_BYTES
    design = (f"whole tiles, the earlier kernel (sliced: slices of {sl} staging {reached} B)"
              if whole else
              f"slices of {sl} columns staging the sectors the indices reach ({reached} B)")
    rec = report(f"take_along_probe axis 0 shared, {name}, B={B}, {design}, of the tiles' "
                 f"{t.numel() * 4} B", ms, common.bound(n_bytes, 0), card)
    rec.update(batch=B, bytes=n_bytes, staged_bytes=t.numel() * 4 if whole else reached,
               slice=0 if whole else sl, whole=whole)
    return rec


def ptxas_report(log: str, which: str, card: str) -> dict:
    """Registers and spills of the kernels of `which`, printed."""
    out = {}
    for kernel in KERNELS["ohg"] + KERNELS["taa0"]:
        lines = ptxas_lines(log, kernel)
        out[kernel] = lines
        for ln in lines:
            print(f"[gather_ab] ptxas {which} {kernel}: {' '.join(ln.split())} [{card}]",
                  flush=True)
    return out


def run(old: str = EARLIER, card: str = "") -> dict:
    """Every case in turns, after building the earlier library."""
    if not torch.cuda.is_available():
        raise RuntimeError("gather_ab times CUDA kernels: it needs a card")
    dev = torch.device("cuda", 0)
    cuda_build.load()
    entries, log = build_earlier(old)
    out = dict(ptxas=dict(current=ptxas_report(cuda_build.last_build_log or "", "current",
                                               card),
                          earlier=ptxas_report(log, "earlier", card)))
    common.warm_up(dev)
    with counts_kept():
        for n_rows in (128, 1024):
            out[f"ohg {n_rows}"] = ohg_ab(entries, n_rows, card)
        batch = dyngather_probe2.TILES_AN_SM * torch.cuda.get_device_properties(
            dev).multi_processor_count
        for _name, body, axis, mod, ts, xs in dyngather_probe2.BODIES:
            if axis != 0:
                continue
            t, idx = (torch.from_numpy(a).to(dev) for a in dyngather_probe2.draws((ts, xs),
                                                                                  batch))
            out[body] = taa_ab(entries, body, t, idx, mod, card)
        for n_rows in gather_probe3.A0_ROWS[:-1]:
            tbl = np.random.default_rng(0).integers(0, 99, (n_rows, 128)).astype(np.int32)
            x = np.random.default_rng(1).integers(0, n_rows, (gather_probe3.A0_INDEX_ROWS, 128))
            t = torch.from_numpy(tbl[None]).to(dev)
            idx = torch.from_numpy(x.astype(np.int32)[None]).to(dev)
            out[f"a0small {n_rows}"] = taa_ab(entries, f"a0small n_rows={n_rows}", t, idx,
                                              0, card)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", default=EARLIER,
                    help="an earlier hako_probes.cu (default: commit 5ace4b1's)")
    args = ap.parse_args(argv)
    return run(args.old, card=common.card(torch.device("cuda")))


if __name__ == "__main__":
    main()
