"""Kernel B's block-local row cache (hako_dda_cached) and the row-word
fetch probe (fetch_probe), each staging brick rows in shared memory,
against an earlier design of each, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.row_stage_ab [--res 1024]
    python -m massivevoxelraytracing_torch.scripts.row_stage_ab --device cpu --res 32 --width 64 --height 64

The earlier designs default to commit a33e950's csrc/hako_rounds.cu and
csrc/hako_probes.cu, kept verbatim under `csrc/earlier/` (`git show
a33e950:massivevoxelraytracing_torch/csrc/hako_rounds.cu` gives the same
file), each built at the start of the case that uses it with the
library's nvcc flags into a library of its own (utils/cuda_build.
build_renamed: its C entry points suffixed `_old`, the current csrc/
searched for hako_device.cuh) and called through the same wrappers
(ops/hako_kernels.hako_dda_cached, ops/probes.fetch_probe), cuda_build.
load answering the earlier entry point. A design not kept is such a
source, passed as --old-rounds / --old-probes.

Cases, each held bit for bit against its plain version through both
designs first, then timed in the turns old, new, new, old (CUDA events; a
turn the least of 3 trains of REPS calls, so that a host stall in one
train does not set it):
  * dda: hako_dda_cached at U (the reference's UNIQ for the resolution,
    64 at 1024^3) on the brick rows of r3_phase_split's round (the
    lattice's top rung: kernel A, the supernode rows and the hand-off),
    in the round's order and sorted by row, with hako_dda on the same
    lanes in the same turns; the bytes bound, common.dda_bound (each
    distinct row once);
  * fetch: fetch_probe at hako_kernel_micro's three launch shapes
    (common.shapes: one warp an SM, full occupancy, the JAX script's
    131,072 lanes) on its 4,096-row table (2.7 MB, L2-resident) at k
    repeats, and at 2k where the Meter times 2k (the ns of a dependent
    repeat); beside each, Meter.case's bound from each design's SASS (the
    issue floor of its repeat loop, the bytes floor) and, for the staged
    design, what bounds it: the staged bytes (512 a lane) over the card's
    L2 read rate, the most that l2_read_probe (a grid that fills the card
    streaming 16-byte ld.global.cg reads over an L2-resident buffer of 8,
    16 or 32 MiB, 256 MiB a launch) reaches in the same run, its sums ==
    their plain version first.
Prints each kernel's ptxas registers and spills and the dynamic shared
memory a block launches with, as each design's launcher computes it (its
library's *_smem_bytes query; one is appended to an earlier source that
has the formula but no query, and an earlier source with neither launches
the kernel with none). --device cpu runs the plain versions (the wrappers
on CPU tensors) at the plain versions' small size and prints no time;
without a card and without that flag it raises. The launches it makes
are not counted (probes.LAUNCHES and hako_kernels.LAUNCHES are restored).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import time

import numpy as np
import torch

from ..ops import hako_kernels as hk
from ..ops import probes
from ..utils import cuda_build, sass, treecache
from . import common, hako_kernel_micro, r3_phase_split
from .gather_ab import counts_kept, earlier_entries
from .walk_ab import ptxas_lines

REPS = 10
TURNS = ("old", "new", "new", "old")
EARLIER = {"rounds": os.path.join(cuda_build.CSRC, "earlier", "hako_rounds_a33e950.cu"),
           "probes": os.path.join(cuda_build.CSRC, "earlier", "hako_probes_a33e950.cu")}
# the entry point each case swaps, and its kernel
ENTRY = {"rounds": "hako_dda_cached_launch", "probes": "fetch_probe_launch"}
KERNEL = {"rounds": "hako_dda_cached_kernel", "probes": "fetch_probe_kernel"}
# the query of the dynamic shared memory a block launches with, and the
# source's function that it answers from
SMEM = {"rounds": ("hako_dda_cached_smem_bytes", "cached_smem_bytes"),
        "probes": ("fetch_probe_smem_bytes", "fetch_smem_bytes")}
STAGED_WORDS = 128  # words 0-127 of a row: what the staged fetch copies a lane
L2_PROBE_MIB = (8, 16, 32)  # the L2-resident buffers of the L2 read probe
L2_PROBE_READ_MIB = 256     # what one launch of it reads, in passes over a buffer
L2_PROBE_BLOCKS_PER_SM = 8  # of 256 threads: a full SM


def entry_points(text: str) -> list:
    """The C entry points a source defines."""
    return re.findall(r'extern "C" [\w ]+?\*? ?(\w+)\(', text)


def smem_shim(which: str, text: str) -> str:
    """The SMEM[which] query to append to a source that has the formula but
    no query, else ""."""
    query, formula = SMEM[which]
    if query + "(" in text or not re.search(rf"\b{formula}\(", text):
        return ""
    return f'\nextern "C" size_t {query}(int v) {{ return {formula}(v); }}\n'


def build_earlier(which: str, src: str):
    """(the earlier library's ENTRY[which], its ptxas report, its SASS
    functions, its SMEM[which] query or None), built now, synchronously."""
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "row_stage_ab", which)
    with open(src) as f:
        text = f.read()
    extra = smem_shim(which, text)
    names = entry_points(text + extra)
    lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, names,
                                                        includes=(cuda_build.CSRC,),
                                                        extra=extra)
    print(f"[row_stage_ab] built the earlier {which} design from "
          f"{os.path.relpath(src, cuda_build.CSRC)} in {seconds:.1f} s", flush=True)
    fn = getattr(lib, ENTRY[which] + "_old")
    fn.argtypes = getattr(cuda_build.load(), ENTRY[which]).argtypes
    fn.restype = ctypes.c_int
    query = None
    if SMEM[which][0] in names:
        query = getattr(lib, SMEM[which][0] + "_old")
        query.argtypes, query.restype = [ctypes.c_int], ctypes.c_size_t
    return fn, log, sass.functions(sass.dump(lib._name)), query


def launch_smem(which: str, arg: int, earlier) -> dict:
    """The dynamic shared memory a block launches with: the current
    library's and the earlier one's (None where its source has no formula:
    it launches with none)."""
    return dict(new=int(getattr(cuda_build.load(), SMEM[which][0])(arg)),
                old=None if earlier is None else int(earlier(arg)))


def smem_text(smem: dict) -> str:
    old = "none" if smem["old"] is None else f"{smem['old']} B"
    return f"dynamic shared memory a block: current {smem['new']} B, earlier {old}"


def _flat(x) -> list:
    return [y for z in x for y in _flat(z)] if isinstance(x, (tuple, list)) else [x]


def in_turns(fns: dict, what: str, want, cuda: bool) -> dict:
    """{label: [ms a turn]}: each fn (of no arguments) bit-equal to want
    first (its outputs flattened), then, on the card, timed in TURNS (the
    "old" and "new" turns; every other label beside each turn)."""
    for label, fn in fns.items():
        got = _flat(fn())
        if len(got) != len(_flat(want)) or not all(
                torch.equal(g, w) for g, w in zip(got, _flat(want))):
            raise AssertionError(f"{what}: {label} differs from the plain version")
    if not cuda:
        return {}
    ms = {label: [] for label in fns}
    for turn in TURNS:
        ms[turn].append(common.best_ms([fns[turn]], reps=REPS)[0])
        for label in fns:
            if label not in ("old", "new"):
                ms[label].append(common.best_ms([fns[label]], reps=REPS)[0])
    return ms


def faster(ms: dict) -> str:
    old, new = ms["old"], ms["new"]
    return ("current" if max(new) < min(old) else
            "earlier" if max(old) < min(new) else "neither")


def ptxas_report(log: str, which: str, design: str, card: str) -> list:
    lines = ptxas_lines(log, KERNEL[which])
    for ln in lines:
        print(f"[row_stage_ab] ptxas {design} {KERNEL[which]}: {' '.join(ln.split())} "
              f"[{card}]", flush=True)
    return lines


def dda_ab(tree, cam, width: int, height: int, *, old: str = EARLIER["rounds"],
           card: str = "") -> dict:
    """hako_dda_cached at U on r3_phase_split's round, in the round's
    order and sorted by row, beside hako_dda."""
    cuda = tree.device.type == "cuda"
    out = {}
    if cuda:
        fn, log, _funcs, old_smem = build_earlier("rounds", old)
        out["ptxas"] = dict(current=ptxas_report(cuda_build.last_build_log or "", "rounds",
                                                 "current", card),
                            earlier=ptxas_report(log, "rounds", "earlier", card))
        common.warm_up(tree.device)
    stage = r3_phase_split.round_setup(tree, cam, width, height)
    kw, u, lanes = stage["leaf"], stage["uniq"], stage["brick_lanes"]
    head = (stage["bricks"], *stage["rays"])
    out.update(uniq=u, lanes=stage["lanes"], fat=stage["fat"])
    if cuda:
        out["smem"] = launch_smem("rounds", u, old_smem)
    order = r3_phase_split.sort_by_row(lanes[1], lanes[2])
    for name, args in (("round order", head + lanes),
                       ("sorted by row", head + r3_phase_split.gather_lanes(order, *lanes))):
        go, child = args[5], args[6]
        want = (hk.hako_dda_plain(*args, **kw), hk.block_rows_plain(go, child, u))

        def new(a=args):
            return hk.hako_dda_cached(*a, cache=u, **kw)

        fns = {"new": new, "hako_dda": lambda a=args: (hk.hako_dda(*a, **kw), want[1])}
        if cuda:
            def earlier(a=args):
                with earlier_entries({ENTRY["rounds"]: fn}):
                    return hk.hako_dda_cached(*a, cache=u, **kw)
            fns["old"] = earlier
        ms = in_turns(fns, f"hako_dda_cached U={u}, {name}", want, cuda)
        go_n, rows = common.dda_counts(go, child)
        stats = want[1].long()
        rec = dict(go_lanes=go_n, distinct_rows=rows,
                   block_distinct_rows=int(stats[:, 1].sum()),
                   cached_lanes=int(stats[:, 2].sum()))
        if cuda:
            b_ms, b_by = common.dda_bound(stage["lanes"], go_n, rows)
            rec.update(old_ms=ms["old"], ms=ms["new"], hako_dda_ms=ms["hako_dda"],
                       bound_ms=b_ms, bound_by=b_by, share=b_ms / min(ms["new"]),
                       old_share=b_ms / min(ms["old"]), faster=faster(ms))
            print(f"[row_stage_ab] hako_dda_cached U={u}, {name} ({stage['lanes']} lanes, "
                  f"{go_n} go, {rows} distinct rows; {rec['cached_lanes']} lanes read the "
                  f"cache): turns earlier {ms['old'][0]:.4f}, current {ms['new'][0]:.4f}, "
                  f"current {ms['new'][1]:.4f}, earlier {ms['old'][1]:.4f} ms; hako_dda "
                  f"{' / '.join(f'{v:.4f}' for v in ms['hako_dda'])} ms in the same turns; "
                  f"bound {b_ms:.4f} ms ({b_by}); share earlier {rec['old_share']:.1%}, "
                  f"current {rec['share']:.1%}; faster in every turn: {rec['faster']}; "
                  f"{smem_text(out['smem'])} [{card}]", flush=True)
        else:
            print(f"[row_stage_ab] hako_dda_cached U={u}, {name}: {stage['lanes']} lanes == "
                  f"plain [{card}]", flush=True)
        out[name] = rec
    return out


def l2_read_rates(device, rng) -> dict:
    """{MiB: bytes/s} that l2_read_probe reads an L2-resident buffer of each
    size at (a grid of L2_PROBE_BLOCKS_PER_SM blocks of 256 an SM, the
    buffer read L2_PROBE_READ_MIB / MiB times a launch, warm: the least of
    3 trains), its sums == their plain version first."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count * (
        L2_PROBE_BLOCKS_PER_SM)
    rates = {}
    for mib in L2_PROBE_MIB:
        buf = hako_kernel_micro._u32(rng, ((mib << 20) // 4,), device)
        passes = L2_PROBE_READ_MIB // mib

        def read(b=buf, p=passes):
            return probes.l2_read_probe(b, passes=p, blocks=blocks)

        if not torch.equal(read(), probes.l2_read_plain(buf, passes=passes,
                                                         lanes=blocks * 256)):
            raise AssertionError(f"l2_read_probe {mib} MiB differs from the plain version")
        rates[mib] = passes * (mib << 20) / (common.best_ms([read], reps=REPS)[0] * 1e-3)
    return rates


def issue_floor_ms(funcs: dict, lanes: int, k: int, sms: int, clock: float) -> tuple:
    """(SASS instructions of fetch_probe_kernel's repeat loop a repeat,
    the issue floor of lanes x k repeats), as Meter.case counts them."""
    c = sass.loop_counts(funcs, KERNEL["probes"], repeats=1)
    return c["per_repeat"], lanes / 32 * k * c["per_repeat"] / (
        sms * common.SCHEDULERS * clock) * 1e3


def fetch_ab(device, *, old: str = EARLIER["probes"], k: int = hako_kernel_micro.K,
             seed: int = 1, card: str = "") -> dict:
    """fetch_probe at the Meter's launch shapes on hako_kernel_micro's
    table."""
    cuda = device.type == "cuda"
    out = {}
    if cuda:
        fn, log, old_funcs, old_smem = build_earlier("probes", old)
        out["ptxas"] = dict(current=ptxas_report(cuda_build.last_build_log or "", "probes",
                                                 "current", card),
                            earlier=ptxas_report(log, "probes", "earlier", card))
        funcs = sass.functions(sass.dump(cuda_build.LIB_PATH))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        clock = common.sm_clock_hz()
        common.warm_up(device)
        out["l2_rates"] = l2_read_rates(device, np.random.default_rng(seed))
        out["l2_bytes_per_s"] = max(out["l2_rates"].values())
    rng = np.random.default_rng(seed)
    rows = hako_kernel_micro._u32(rng, (hako_kernel_micro.FETCH_ROWS, probes.ROW_WORDS),
                                  device)
    for shape in common.shapes(device, k):
        n, t, kk = shape["lanes"], shape["threads"], shape["k"]
        row_of = torch.from_numpy(rng.integers(0, hako_kernel_micro.FETCH_ROWS, n)
                                  .astype(np.int32)).to(device)
        ks = (kk, 2 * kk) if cuda and shape["shape"] != "script" else (kk,)
        rec = dict(lanes=n, threads=t, k=kk)
        for reps in ks:
            want = probes.fetch_probe_plain(rows, row_of, iters=reps)
            fns = {"new": lambda r=reps: probes.fetch_probe(rows, row_of, iters=r, threads=t)}
            if cuda:
                def earlier(r=reps):
                    with earlier_entries({ENTRY["probes"]: fn}):
                        return probes.fetch_probe(rows, row_of, iters=r, threads=t)
                fns["old"] = earlier
            ms = in_turns(fns, f"fetch_probe {shape['shape']} k={reps}", want, cuda)
            if cuda:
                rec[f"old_ms_{reps}"], rec[f"ms_{reps}"] = ms["old"], ms["new"]
        if not cuda:
            print(f"[row_stage_ab] fetch_probe {shape['shape']} {n} lanes x {kk}: == plain "
                  f"[{card}]", flush=True)
            out[shape["shape"]] = rec
            continue
        new_sass, new_issue = issue_floor_ms(funcs, n, kk, sms, clock)
        old_sass, old_issue = issue_floor_ms(old_funcs, n, kk, sms, clock)
        bytes_ms = (rows.numel() * 4 + 8 * n) / common.HBM_BYTES_PER_S * 1e3
        l2_ms = n * STAGED_WORDS * 4 / out["l2_bytes_per_s"] * 1e3
        ms = {"old": rec[f"old_ms_{kk}"], "new": rec[f"ms_{kk}"]}
        rec.update(smem=launch_smem("probes", t, old_smem), old_ms=ms["old"], ms=ms["new"],
                   faster=faster(ms),
                   sass_per_repeat=new_sass, old_sass_per_repeat=old_sass,
                   issue_floor_ms=new_issue, old_issue_floor_ms=old_issue,
                   bytes_floor_ms=bytes_ms, bound_ms=max(new_issue, bytes_ms),
                   old_bound_ms=max(old_issue, bytes_ms),
                   bound_by="operations" if new_issue >= bytes_ms else "bytes",
                   staged_l2_ms=l2_ms)
        rec["share"] = rec["bound_ms"] / min(ms["new"])
        rec["old_share"] = rec["old_bound_ms"] / min(ms["old"])
        rec["staged_l2_share"] = l2_ms / min(ms["new"])
        slope = ""
        if len(ks) == 2:
            rec["ns_per_repeat"] = [(b - a) * 1e6 / kk for a, b in
                                    zip(rec[f"ms_{kk}"], rec[f"ms_{2 * kk}"])]
            rec["old_ns_per_repeat"] = [(b - a) * 1e6 / kk for a, b in
                                        zip(rec[f"old_ms_{kk}"], rec[f"old_ms_{2 * kk}"])]
            slope = (f"; ns a repeat (2k - k) earlier "
                     f"{' / '.join(f'{v:.3f}' for v in rec['old_ns_per_repeat'])}, current "
                     f"{' / '.join(f'{v:.3f}' for v in rec['ns_per_repeat'])}")
        print(f"[row_stage_ab] fetch_probe {shape['shape']} ({n} lanes x {kk}, {t} threads): "
              f"turns earlier {ms['old'][0]:.4f}, current {ms['new'][0]:.4f}, current "
              f"{ms['new'][1]:.4f}, earlier {ms['old'][1]:.4f} ms{slope}; Meter bound "
              f"earlier {rec['old_bound_ms']:.4f} ms (SASS {old_sass:.2f} a repeat), current "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, SASS {new_sass:.2f} a repeat; "
              f"bytes floor {bytes_ms:.4f}); share earlier {rec['old_share']:.1%}, current "
              f"{rec['share']:.1%}; the staging's bound, {n * STAGED_WORDS * 4} B over the "
              f"card's L2 read rate ({out['l2_bytes_per_s'] / 1e12:.2f} TB/s, l2_read_probe "
              f"{' / '.join(f'{v / 1e12:.2f}' for v in out['l2_rates'].values())} at "
              f"{' / '.join(str(m) for m in out['l2_rates'])} MiB): {l2_ms:.4f} ms, "
              f"{rec['staged_l2_share']:.1%}; faster in every turn: {rec['faster']}; "
              f"{smem_text(rec['smem'])} [{card}]", flush=True)
        out[shape["shape"]] = rec
    return out


def run(tree, cam, width: int, height: int, *, cases=("dda", "fetch"),
        old_rounds: str = EARLIER["rounds"], old_probes: str = EARLIER["probes"],
        card: str = "") -> dict:
    """The cases on the tree's device, their launches not counted."""
    out = {}
    with counts_kept():
        if "dda" in cases:
            out["dda"] = dda_ab(tree, cam, width, height, old=old_rounds, card=card)
        if "fetch" in cases:
            out["fetch"] = fetch_ab(tree.device, old=old_probes, card=card)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=1024, help="the lattice's grid resolution")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--old-rounds", default=EARLIER["rounds"],
                    help="an earlier hako_rounds.cu (default: commit a33e950's)")
    ap.add_argument("--old-probes", default=EARLIER["probes"],
                    help="an earlier hako_probes.cu (default: commit a33e950's)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    t0 = time.time()
    tree = treecache.lattice_tree(args.res, device=dev)
    print(f"[row_stage_ab] lattice {args.res}^3 loaded in {time.time() - t0:.1f} s",
          flush=True)
    return run(tree, r3_phase_split.script_camera(tree), args.width, args.height,
               old_rounds=args.old_rounds, old_probes=args.old_probes, card=card)


if __name__ == "__main__":
    main()
