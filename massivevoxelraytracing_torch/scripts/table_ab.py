"""The shared-memory forms of the node fetch and the 64-entry select
(ops/probes.node_gather_probe(space="shared"), table_select_probe(form=
"shared")) against an earlier design of each, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.table_ab
    python -m massivevoxelraytracing_torch.scripts.table_ab --device cpu

The earlier design defaults to commit 6fa41fa's csrc/hako_probes.cu, kept
verbatim under `csrc/earlier/` (`git show
6fa41fa:massivevoxelraytracing_torch/csrc/hako_probes.cu` gives the same
file), built at the start with the library's nvcc flags into a library of
its own (utils/cuda_build.build_renamed: its C entry points suffixed
`_old`, the current csrc/ searched for hako_device.cuh) and called
through the same wrappers, cuda_build.load answering the earlier entry
points. A design not kept is such a source, passed as --old-probes.

Cases: hako_kernel_micro's three launch shapes (common.shapes: one warp an
SM, full occupancy, the JAX script's 131,072 lanes) x (the select from 64
x 3 words; the node fetch at n = 128, 1024 and 4096 nodes on
hako_kernel_micro's tables), each held bit for bit against its plain
version through both designs at k and, where the Meter times 2k, at 2k,
then timed in the turns old, new, new, old (CUDA events; a turn the least
of 3 trains of REPS calls). Beside each: each design's issue floor
(Meter.case's, from its repeat loop's SASS), the case's own shared-memory
wavefronts a warp-repeat under each design's layout and their floor, the
3-wavefront floor (common.case_wavefronts, wavefront_ms), and for the node fetch at the
script's shape the table's staged bytes (each block's read of it) over
the card's L2 read rate
(l2_read_probe, common.l2_read_rates). Prints each design's ptxas
registers and spills and the dynamic shared memory a block launches with
(an earlier source without the query: its launcher's 12 n bytes for the
node fetch, and the select's static 768 B). --device cpu runs the plain
versions (the wrappers on CPU tensors) at the plain versions' small size
and prints no time; without a card and without that flag it raises. The
launches it makes are not counted.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import numpy as np
import torch

from ..ops import probes
from ..utils import cuda_build, sass
from . import common, hako_kernel_micro
from .gather_ab import counts_kept, earlier_entries
from .row_stage_ab import entry_points, faster, in_turns
from .walk_ab import ptxas_lines

REPS = 10
EARLIER = os.path.join(cuda_build.CSRC, "earlier", "hako_probes_6fa41fa.cu")
ENTRY = {"table_select_probe": "table_select_probe_launch",
         "node_gather_probe": "node_gather_probe_launch"}
QUERIES = {"node_gather_probe_plan": ([ctypes.c_int, ctypes.c_void_p], None),
           "node_gather_probe_smem_bytes": ([ctypes.c_int], ctypes.c_size_t),
           "table_select_probe_smem_bytes": ([], ctypes.c_size_t)}
SELECT_STATIC_BYTES = 768  # 6fa41fa's select: the 64 x 3 words, static shared memory


class Design:
    """One build of the probes: its entry points of the two shared forms,
    its shared-form queries (None for a source without them), its SASS
    functions and its ptxas report."""

    def __init__(self, lib, funcs: dict, log: str, suffix: str = ""):
        self.entries = {k: getattr(lib, v + suffix) for k, v in ENTRY.items()}
        self.queries = {}
        for name, (args, res) in QUERIES.items():
            fn = getattr(lib, name + suffix, None)
            if fn is not None:
                fn.argtypes, fn.restype = args, res
            self.queries[name] = fn
        self.funcs, self.log = funcs, log

    def layout(self, which: str, n: int) -> tuple:
        """(rec, copies) of its shared form on n entries."""
        if which == "table_select_probe":
            if self.queries["table_select_probe_smem_bytes"] is None:
                return (3, 1)
            return next(self.instantiations("table_select_shared_kernel"))[1][:2]
        plan = self.queries["node_gather_probe_plan"]
        if plan is None:
            return (3, 1)
        out = (ctypes.c_int * 2)()
        plan(n, out)
        return tuple(out)

    def instantiations(self, kernel: str):
        """(mangled name, its integer template arguments) of each
        instantiation of `kernel`."""
        for f in self.funcs:
            m = re.search(rf"{kernel}I((?:L[ib]\d+E)+)E", f)
            if m:
                yield f, tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m.group(1)))

    def kernel(self, which: str, n: int) -> str:
        """The mangled name of the kernel its shared form launches on n
        entries."""
        if which == "table_select_probe":
            if self.queries["table_select_probe_smem_bytes"] is None:
                return sass.kernel_name(self.funcs, "table_select_probe_kernel", 1)
            return next(self.instantiations("table_select_shared_kernel"))[0]
        if self.queries["node_gather_probe_plan"] is None:
            return sass.kernel_name(self.funcs, "node_gather_probe_kernel", 1)
        return sass.kernel_name(self.funcs, "node_gather_shared_kernel", *self.layout(which, n))

    def smem_bytes(self, which: str, n: int) -> str:
        if which == "table_select_probe":
            q = self.queries["table_select_probe_smem_bytes"]
            return f"{SELECT_STATIC_BYTES} B static" if q is None else f"{int(q())} B"
        q = self.queries["node_gather_probe_smem_bytes"]
        return f"{12 * n} B" if q is None else f"{int(q(n))} B"

    def issue_ms(self, which: str, n: int, shape: dict, sms: int, clock: float) -> tuple:
        """(SASS instructions a repeat of its loop, the issue floor of the
        shape's lanes x k repeats), as Meter.case counts them."""
        body = sass.loop_body(self.funcs[self.kernel(which, n)])
        per = len(body) / probes.UNROLL
        return per, shape["lanes"] / 32 * shape["k"] * per / (
            sms * common.SCHEDULERS * clock) * 1e3


def build_earlier(src: str) -> Design:
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "table_ab")
    with open(src) as f:
        names = entry_points(f.read())
    lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, names,
                                                        includes=(cuda_build.CSRC,))
    print(f"[table_ab] built the earlier design from "
          f"{os.path.relpath(src, cuda_build.CSRC)} in {seconds:.1f} s", flush=True)
    current = cuda_build.load()
    for name in ENTRY.values():
        fn = getattr(lib, name + "_old")
        fn.argtypes, fn.restype = getattr(current, name).argtypes, ctypes.c_int
    return Design(lib, sass.functions(sass.dump(lib._name)), log, "_old")


def report_ptxas(designs: dict, card: str) -> dict:
    """Each design's ptxas lines for the kernels its shared forms launch."""
    out = {}
    for label, d in designs.items():
        out[label] = {}
        kernels = {d.kernel("table_select_probe", 64)} | {
            d.kernel("node_gather_probe", n) for n, _rows in hako_kernel_micro.TABLES}
        for mangled in sorted(kernels):
            lines = ptxas_lines(d.log, mangled)
            out[label][sass.source_key(mangled)] = lines
            for ln in lines:
                print(f"[table_ab] ptxas {label}: {' '.join(ln.split())} [{card}]", flush=True)
    return out


def compare_sass(designs: dict, card: str) -> dict:
    """The probes' kernels of both designs by their digests (utils/sass):
    the ones with the same machine code, the ones that differ, and those
    that only one design has."""
    def by_kernel(d):
        return {k.split(":", 1)[1]: v for k, v in sass.digests(d.funcs).items()
                if k.startswith("hako_probes")}

    old, new = by_kernel(designs["earlier"]), by_kernel(designs["current"])
    out = dict(same=sorted(k for k in old if new.get(k) == old[k]),
               differ=sorted(k for k in old if k in new and new[k] != old[k]),
               earlier_only=sorted(old.keys() - new.keys()),
               current_only=sorted(new.keys() - old.keys()))
    print(f"[table_ab] SASS of the probes: {len(out['same'])} kernels the same in both "
          f"designs; different: {out['differ']}; the earlier design's only: "
          f"{out['earlier_only']}; the current one's only: {out['current_only']} [{card}]",
          flush=True)
    return out


def cases(device, rng, lanes: int):
    """(kernel, n entries, table, start indices) of each case, as
    hako_kernel_micro makes them."""
    tab = hako_kernel_micro._u32(rng, (64, 3), device)
    idx0 = torch.from_numpy(rng.integers(0, 56, lanes).astype(np.int32)).to(device)
    yield "table_select_probe", 64, tab, idx0
    for n, rows in hako_kernel_micro.TABLES:
        table = probes.node_table_from_segments(
            hako_kernel_micro.segment_table(n, rows, rng), device)
        idx0 = torch.from_numpy(rng.integers(0, n - 31, lanes).astype(np.int32)).to(device)
        yield "node_gather_probe", n, table, idx0


def call(which: str, table, idx0, kk: int, threads: int):
    if which == "table_select_probe":
        return probes.table_select_probe(table, idx0, k=kk, form="shared", threads=threads)
    return probes.node_gather_probe(table, idx0, k=kk, space="shared", threads=threads)


def plain(which: str, table, idx0, kk: int):
    if which == "table_select_probe":
        return probes.table_select_plain(table, idx0, kk)
    return probes.node_gather_plain(table, idx0, kk)


def run(device, *, old: str = EARLIER, k: int = hako_kernel_micro.K, seed: int = 1,
        card: str = "") -> dict:
    """The cases on `device`, their launches not counted: {kernel: {case:
    record}}, a case "<shape>" for the select and "n=<n> <shape>" for the
    node fetch."""
    cuda = device.type == "cuda"
    out = {which: {} for which in ENTRY}
    with counts_kept():
        if cuda:
            designs = dict(current=Design(cuda_build.load(),
                                          sass.functions(sass.dump(cuda_build.LIB_PATH)),
                                          cuda_build.last_build_log or ""),
                           earlier=build_earlier(old))
            out["ptxas"] = report_ptxas(designs, card)
            out["sass"] = compare_sass(designs, card)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            clock = common.sm_clock_hz()
            common.warm_up(device)
            out["l2_rates"] = common.l2_read_rates(device, np.random.default_rng(seed))
            l2 = out["l2_bytes_per_s"] = max(out["l2_rates"].values())
        rng = np.random.default_rng(seed)
        for shape in common.shapes(device, k):
            lanes, t, kk = shape["lanes"], shape["threads"], shape["k"]
            ks = (kk, 2 * kk) if cuda and shape["shape"] != "script" else (kk,)
            for which, n, table, idx0 in cases(device, rng, lanes):
                name = shape["shape"] if which == "table_select_probe" else (
                    f"n={n} {shape['shape']}")
                rec = dict(lanes=lanes, threads=t, k=kk)
                for reps in ks:
                    fns = {"new": lambda r=reps: call(which, table, idx0, r, t)}
                    if cuda:
                        def earlier(r=reps):
                            with earlier_entries({ENTRY[which]: designs["earlier"].entries[which]}):
                                return call(which, table, idx0, r, t)
                        fns["old"] = earlier
                    ms = in_turns(fns, f"{which} {name} k={reps}", plain(which, table, idx0, reps),
                                  cuda)
                    if cuda:
                        rec[f"old_ms_{reps}"], rec[f"ms_{reps}"] = ms["old"], ms["new"]
                if not cuda:
                    print(f"[table_ab] {which} {name} {lanes} lanes x {kk}: == plain [{card}]",
                          flush=True)
                    out[which][name] = rec
                    continue
                out[which][name] = measure(rec, which, n, table, idx0, shape, ks, designs,
                                           sms, clock, l2, card)
    return out


def case_bytes(which: str, n: int, lanes: int) -> int:
    """The bytes floor's bytes, as hako_kernel_micro counts them."""
    return 768 + 8 * lanes if which == "table_select_probe" else 12 * (n + lanes)


def measure(rec: dict, which: str, n: int, table, idx0, shape: dict, ks: tuple,
            designs: dict, sms: int, clock: float, l2: float, card: str) -> dict:
    """The case's record: its turns, and for each design the Meter's bound
    (its issue floor, the bytes floor) and the shared-memory floors."""
    lanes, kk = shape["lanes"], shape["k"]
    ms = {"old": rec[f"old_ms_{kk}"], "new": rec[f"ms_{kk}"]}
    rec.update(old_ms=ms["old"], ms=ms["new"], faster=faster(ms),
               bytes_floor_ms=case_bytes(which, n, lanes) / common.HBM_BYTES_PER_S * 1e3,
               floor3_ms=common.wavefront_ms(lanes, kk, 3, sms, clock))
    select = which == "table_select_probe"
    layouts = {key: designs[label].layout(which, n)
               for label, key in (("current", ""), ("earlier", "old_"))}
    waves = common.case_wavefronts(table, idx0, kk, select=select, layouts=layouts.values())
    for (label, key), w in zip((("current", ""), ("earlier", "old_")), waves):
        d = designs[label]
        per, issue = d.issue_ms(which, n, shape, sms, clock)
        rec.update({f"{key}layout": list(layouts[key]), f"{key}sass_per_repeat": per,
                    f"{key}issue_floor_ms": issue,
                    f"{key}bound_ms": max(issue, rec["bytes_floor_ms"]),
                    f"{key}wavefronts": w,
                    f"{key}wavefront_floor_ms": common.wavefront_ms(lanes, kk, w, sms, clock),
                    f"{key}smem": d.smem_bytes(which, n)})
        rec[f"{key}share"] = rec[f"{key}bound_ms"] / min(ms[key.rstrip("_") or "new"])
        rec[f"{key}wavefront_share"] = (rec[f"{key}wavefront_floor_ms"]
                                        / min(ms[key.rstrip("_") or "new"]))
        if not select and shape["shape"] == "script":
            blocks = -(-lanes // shape["threads"])
            rec[f"{key}staged_l2_ms"] = blocks * 12 * n / l2 * 1e3
    slope = ""
    if len(ks) == 2:
        for key in ("", "old_"):
            rec[f"{key}ns_per_repeat"] = [(b - a) * 1e6 / kk for a, b in
                                          zip(rec[f"{key}ms_{kk}"], rec[f"{key}ms_{2 * kk}"])]
        slope = (f"; ns a repeat (2k - k) earlier "
                 f"{' / '.join(f'{v:.2f}' for v in rec['old_ns_per_repeat'])}, current "
                 f"{' / '.join(f'{v:.2f}' for v in rec['ns_per_repeat'])}")
    staged = ""
    if "staged_l2_ms" in rec:
        staged = (f"; the staged tables at the L2 read rate ({l2 / 1e12:.2f} TB/s): earlier "
                  f"{rec['old_staged_l2_ms']:.4f} ms, current {rec['staged_l2_ms']:.4f} ms")
    name = shape["shape"] if select else f"n={n} {shape['shape']}"
    print(f"[table_ab] {which} {name} ({lanes} lanes x {kk}, {shape['threads']} threads): "
          f"turns earlier {ms['old'][0]:.4f}, current {ms['new'][0]:.4f}, current "
          f"{ms['new'][1]:.4f}, earlier {ms['old'][1]:.4f} ms{slope}; Meter bound earlier "
          f"{rec['old_bound_ms']:.4f} ms (SASS {rec['old_sass_per_repeat']:.2f} a repeat), "
          f"current {rec['bound_ms']:.4f} ms (SASS {rec['sass_per_repeat']:.2f}; bytes floor "
          f"{rec['bytes_floor_ms']:.4f}), share earlier {rec['old_share']:.1%}, current "
          f"{rec['share']:.1%}; shared-memory wavefronts a warp-repeat earlier "
          f"{rec['old_wavefronts']:.2f} {tuple(rec['old_layout'])}, current "
          f"{rec['wavefronts']:.2f} {tuple(rec['layout'])}, their floors "
          f"{rec['old_wavefront_floor_ms']:.4f} / {rec['wavefront_floor_ms']:.4f} ms (shares "
          f"{rec['old_wavefront_share']:.1%} / {rec['wavefront_share']:.1%}), 3 wavefronts "
          f"{rec['floor3_ms']:.4f} ms{staged}; faster in every turn: {rec['faster']}; shared "
          f"memory a block earlier {rec['old_smem']}, current {rec['smem']} [{card}]",
          flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--old-probes", default=EARLIER,
                    help="an earlier hako_probes.cu (default: commit 6fa41fa's)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(dev, old=args.old_probes, card=card)


if __name__ == "__main__":
    main()
