"""The Hopper forms of the walk probe (walk64 and the 64-cell sweep,
ops/probes.walk_probe) and of the construct probe (the eight constructs,
bit_at and pc64_below in their Hopper forms; ops/probes.construct_probe)
against an earlier design of each, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.issue_ab
    python -m massivevoxelraytracing_torch.scripts.issue_ab --device cpu

The earlier design defaults to commit aca9a3e's csrc/hako_probes.cu, kept
verbatim under `csrc/earlier/` (`git show
aca9a3e:massivevoxelraytracing_torch/csrc/hako_probes.cu` gives the same
file), built at the start with the library's nvcc flags into a library of
its own (utils/cuda_build.build_renamed: its C entry points suffixed
`_old`, the current csrc/ searched for hako_device.cuh) and called through
the same wrappers, cuda_build.load answering the earlier entry points. A
design not kept is such a source, passed as --old-probes.

Cases: the Meter's three launch shapes (common.shapes: one warp an SM, full
occupancy, the JAX script's 131,072 lanes) x (walk64, scan64, the eight
constructs), on hako_kernel_micro's and construct_micro's inputs and
repeats, each held bit for bit against its plain version through both
designs at k and, where the Meter times 2k, at 2k, then timed in the turns
old, new, new, old (CUDA events; a turn the least of 3 trains of REPS
calls). Beside each: each design's SASS a repeat (its repeat loop's, from
cuobjdump), its issue floor and its pipe floor (utils/sass.pipe_floor at the
rates common.pipe_rates measures in the same run, or those passed in). For
the walk the counting variant (probes.walk_count) gives, for both walks on
the case's lanes, the slots its warps ran and the slots its lanes needed,
and the SIMT efficiency (lane-slots over 32 x warp-slots). Prints each
design's ptxas registers and spills for the kernels the cases launch, and
which probe kernels have the same machine code in both designs, and
hako_mega's traversal loop against the issue floor and the pipe floor.
--device cpu runs the plain versions (the wrappers on CPU tensors) at the
plain versions' small size and prints no time; without a card and without
that flag it raises. The launches it makes are not counted.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import probes
from ..utils import cuda_build, sass
from . import common, construct_micro, hako_kernel_micro
from .gather_ab import counts_kept, earlier_entries
from .row_stage_ab import entry_points, faster, in_turns
from .table_ab import compare_sass
from .walk_ab import ptxas_lines

EARLIER = os.path.join(cuda_build.CSRC, "earlier", "hako_probes_aca9a3e.cu")
ENTRY = {"walk_probe": "walk_probe_launch", "construct_probe": "construct_probe_launch"}
KERNEL = {"walk_probe": "walk_probe_kernel", "construct_probe": "construct_probe_kernel"}
# the earlier library's entry points that callers swap in: the walk and
# construct probes here, the probe body by stage in scripts/stage_ab.py
SWAPPED = (*ENTRY.values(), "probe_stage_probe_launch")


def build_earlier(src: str):
    """(the earlier library's SWAPPED entry points, its SASS functions, its
    ptxas report), built now."""
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "issue_ab")
    with open(src) as f:
        names = entry_points(f.read())
    lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, names,
                                                        includes=(cuda_build.CSRC,))
    print(f"[issue_ab] built the earlier design from "
          f"{os.path.relpath(src, cuda_build.CSRC)} in {seconds:.1f} s", flush=True)
    current = cuda_build.load()
    entries = {}
    for name in SWAPPED:
        fn = getattr(lib, name + "_old")
        fn.argtypes, fn.restype = getattr(current, name).argtypes, ctypes.c_int
        entries[name] = fn
    return entries, sass.functions(sass.dump(lib._name)), log


def cases(device, rng, shape: dict):
    """(name, kernel, template arguments, k, call, plain) of each case at
    one launch shape, on the inputs the Meter's scripts make."""
    lanes, t = shape["lanes"], shape["threads"]
    walk_k = hako_kernel_micro.K if device.type != "cuda" else {
        "one warp an SM": hako_kernel_micro.WALK_LATENCY_REPEATS,
        "full occupancy": hako_kernel_micro.WALK_RATE_REPEATS}.get(shape["shape"],
                                                                  hako_kernel_micro.K)
    for impl in probes.WALK_IMPLS:
        t1, dc = hako_kernel_micro.ray_planes(lanes, device, rng)
        lo, hi = hako_kernel_micro._u32(rng, lanes, device), hako_kernel_micro._u32(rng, lanes,
                                                                                     device)
        yield (f"{impl}64", "walk_probe", (impl == "scan",), walk_k,
               lambda kk, a=(lo, hi, t1, dc), i=impl: probes.walk_probe(
                   *a, iters=kk, impl=i, threads=t),
               lambda kk, a=(lo, hi, t1, dc), i=impl: probes.walk_probe_plain(
                   *a, iters=kk, impl=i), (lo, hi, t1, dc))
    construct_k = shape["k"] if device.type != "cuda" else {
        "one warp an SM": max(construct_micro.K, common.LATENCY_REPEATS),
        "full occupancy": max(construct_micro.K, common.RATE_REPEATS)}.get(
            shape["shape"], construct_micro.K)
    for kind in probes.CONSTRUCTS:
        xs = construct_micro.inputs(kind, lanes, device, rng)
        yield (f"construct {kind}", "construct_probe", (list(probes.CONSTRUCTS).index(kind),),
               construct_k,
               lambda kk, xs=xs, kd=kind: probes.construct_probe(kd, xs, k=kk, threads=t),
               lambda kk, xs=xs, kd=kind: probes.construct_plain(kd, xs, kk), None)


def floors(funcs, kernel: str, targs: tuple, shape: dict, k: int, sms: int, clock: float,
           pipe: dict) -> dict:
    """A design's SASS a repeat and its issue and pipe floors on the case."""
    body = sass.loop_body(funcs[sass.kernel_name(funcs, kernel, *targs)])
    repeats = 1 if kernel == "walk_probe_kernel" else probes.UNROLL
    pf = sass.pipe_floor(body, pipe["rates"], pipe["pipes"], repeats)
    warps = shape["lanes"] / 32 * k
    return dict(sass_per_repeat=len(body) / repeats,
                issue_floor_ms=warps * len(body) / repeats / (sms * common.SCHEDULERS * clock)
                * 1e3,
                pipe_floor_ms=warps * pf["clocks"] / (sms * clock) * 1e3,
                busiest_pipe=pf["pipe"], pipe_clocks_per_repeat=pf["clocks"],
                by_pipe=pf["by_pipe"])


def walk_slots(args, k: int, shape: dict, card: str) -> dict:
    """The counting variant of both walks on the case's lanes: each lane's
    slots == the plain count, the lanes' slots == the passes' active lanes;
    the warps' slots, the lanes' slots and the SIMT efficiency."""
    lo, hi, t1, dc = args
    out = {}
    for label, hopper in (("earlier", False), ("current", True)):
        got = probes.walk_count(lo, hi, t1, dc, iters=k, hopper=hopper,
                                threads=shape["threads"])
        want = probes.walk_count_plain(lo, hi, t1, dc, iters=k, hopper=hopper)
        if not torch.equal(got["slots"], want["slots"]) or (
                got["lane_slots"] != int(got["slots"].sum())) or not torch.equal(
                got["out"], want["out"]):
            raise AssertionError(f"walk_count ({label}) differs from its plain count")
        out[label] = dict(warp_slots=got["passes"], lane_slots=got["lane_slots"],
                          simt=got["lane_slots"] / (32 * got["passes"]) if got["passes"] else 0.0)
    print(f"[issue_ab] walk64 {shape['shape']} slots: warps ran {out['earlier']['warp_slots']} "
          f"(earlier) / {out['current']['warp_slots']} (current) where the lanes needed "
          f"{out['earlier']['lane_slots']} / {out['current']['lane_slots']}; SIMT efficiency "
          f"{out['earlier']['simt']:.1%} / {out['current']['simt']:.1%} [{card}]", flush=True)
    return out


def run(device, *, old: str = EARLIER, seed: int = 1, card: str = "",
        pipe: dict | None = None, funcs: dict | None = None, earlier=None) -> dict:
    """The cases on `device`, their launches not counted: {kernel: {"<case>
    <shape>": record}}, with "ptxas", "sass", "pipe", "mega" and
    "walk_slots". pipe / funcs / earlier: the pipe rates, the current
    library's SASS functions and build_earlier(old)'s answer where the
    caller has them already."""
    cuda = device.type == "cuda"
    t_start = time.perf_counter()
    out = {which: {} for which in ENTRY}
    out["walk_slots"] = {}
    with counts_kept():
        if cuda:
            entries, old_funcs, old_log = earlier or build_earlier(old)
            new_funcs = funcs or sass.functions(sass.dump(cuda_build.LIB_PATH))
            out["ptxas"] = {}
            for label, log in (("current", cuda_build.last_build_log or ""),
                               ("earlier", old_log)):
                out["ptxas"][label] = {}
                for kernel in KERNEL.values():
                    lines = ptxas_lines(log, kernel)
                    out["ptxas"][label][kernel] = lines
                    for ln in lines:
                        print(f"[issue_ab] ptxas {label} {kernel}: {' '.join(ln.split())} "
                              f"[{card}]", flush=True)
            out["sass"] = sass_kept(old_funcs, new_funcs, card)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            clock = common.sm_clock_hz()
            common.warm_up(device)
            pipe = pipe or common.pipe_rates(device, new_funcs, sms, clock, card, seed)
            out["pipe"] = pipe
            out["mega"] = mega_loops(new_funcs, pipe, card)
            print(f"[issue_ab] set-up (the earlier build, both listings, the floors): "
                  f"{time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
        rng = np.random.default_rng(seed)
        for shape in common.shapes(device, construct_micro.K):
            t_shape, t_plain, t_slots = time.perf_counter(), 0.0, 0.0
            for name, which, targs, k, call, plain, args in cases(device, rng, shape):
                ks = (k, 2 * k) if cuda and shape["shape"] != "script" else (k,)
                rec = dict(lanes=shape["lanes"], threads=shape["threads"], k=k)
                for kk in ks:
                    fns = {"new": lambda kk=kk: call(kk)}
                    if cuda:
                        def earlier(kk=kk, w=which):
                            with earlier_entries({ENTRY[w]: entries[ENTRY[w]]}):
                                return call(kk)
                        fns["old"] = earlier
                    t0 = time.perf_counter()
                    want = plain(kk)
                    t_plain += time.perf_counter() - t0
                    ms = in_turns(fns, f"{name} {shape['shape']} k={kk}", want, cuda)
                    if cuda:
                        rec[f"old_ms_{kk}"], rec[f"ms_{kk}"] = ms["old"], ms["new"]
                key = f"{name} {shape['shape']}"
                if not cuda:
                    print(f"[issue_ab] {key} {shape['lanes']} lanes x {k}: == plain [{card}]",
                          flush=True)
                    out[which][key] = rec
                    continue
                rec.update(old_ms=rec[f"old_ms_{k}"], ms=rec[f"ms_{k}"],
                           faster=faster({"old": rec[f"old_ms_{k}"], "new": rec[f"ms_{k}"]}))
                for label, key_prefix, funcs in (("current", "", new_funcs),
                                                 ("earlier", "old_", old_funcs)):
                    for f_key, v in floors(funcs, KERNEL[which], targs, shape, k, sms, clock,
                                           pipe).items():
                        rec[key_prefix + f_key] = v
                if len(ks) == 2:
                    for p in ("", "old_"):
                        rec[p + "slope_ms"] = [b - a for a, b in
                                               zip(rec[f"{p}ms_{k}"], rec[f"{p}ms_{2 * k}"])]
                report(key, rec, card)
                out[which][key] = rec
                if name == "walk64":
                    t0 = time.perf_counter()
                    out["walk_slots"][shape["shape"]] = walk_slots(args, k, shape, card)
                    t_slots += time.perf_counter() - t0
            print(f"[issue_ab] {shape['shape']}: {time.perf_counter() - t_shape:.1f} s, of it "
                  f"the plain versions {t_plain:.1f} s, the walks' slots {t_slots:.1f} s "
                  f"[{card}]", flush=True)
    return out


def mega_loops(funcs: dict, pipe: dict, card: str) -> dict:
    """hako_mega's traversal loop against both floors: for each of its
    instantiations, the outermost loop's instructions a pass over the SM's 4
    a clock (the issue floor's clocks) and on its busiest pipe at the
    measured rates (sass.pipe_floor), from the current library's SASS."""
    out = {}
    for name, instrs in funcs.items():
        if "hako_mega_kernel" not in name:
            continue
        pf = sass.pipe_floor(sass.loop_body(instrs), pipe["rates"], pipe["pipes"])
        key = sass.source_key(name)
        out[key] = dict(issue_clocks=pf["issue_clocks"], pipe_clocks=pf["clocks"],
                        pipe=pf["pipe"], by_pipe=pf["by_pipe"],
                        unclassified=pf["unclassified"])
        print(f"[issue_ab] hako_mega loop {key}: {4 * pf['issue_clocks']:.0f} SASS a pass, "
              f"issue {pf['issue_clocks']:.2f} SM-clocks a warp-pass, busiest pipe "
              f"{pf['pipe']} {pf['clocks']:.2f} "
              f"({', '.join(f'{k} {v:.2f}' for k, v in sorted(pf['by_pipe'].items()))}; "
              f"{pf['unclassified']:.0f} outside the measured classes) [{card}]", flush=True)
    return out


def sass_kept(old_funcs: dict, new_funcs: dict, card: str) -> dict:
    """table_ab.compare_sass on the two listings."""
    return compare_sass(dict(earlier=SimpleNamespace(funcs=old_funcs),
                             current=SimpleNamespace(funcs=new_funcs)), card)


def report(key: str, rec: dict, card: str) -> None:
    slope = ""
    if "slope_ms" in rec:
        slope = (f"; slope (2k - k) earlier {' / '.join(f'{v:.4f}' for v in rec['old_slope_ms'])}"
                 f", current {' / '.join(f'{v:.4f}' for v in rec['slope_ms'])} ms")
    print(f"[issue_ab] {key} ({rec['lanes']} lanes x {rec['k']}, {rec['threads']} threads): "
          f"turns earlier {rec['old_ms'][0]:.4f}, current {rec['ms'][0]:.4f}, current "
          f"{rec['ms'][1]:.4f}, earlier {rec['old_ms'][1]:.4f} ms{slope}; SASS a repeat "
          f"earlier {rec['old_sass_per_repeat']:.2f}, current {rec['sass_per_repeat']:.2f}; "
          f"issue floor earlier {rec['old_issue_floor_ms']:.4f}, current "
          f"{rec['issue_floor_ms']:.4f} ms; pipe floor earlier {rec['old_pipe_floor_ms']:.4f} "
          f"({rec['old_busiest_pipe']}), current {rec['pipe_floor_ms']:.4f} ms "
          f"({rec['busiest_pipe']}); faster in every turn: {rec['faster']} [{card}]",
          flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--old-probes", default=EARLIER,
                    help="an earlier hako_probes.cu (default: commit aca9a3e's)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(dev, old=args.old_probes, card=card)


if __name__ == "__main__":
    main()
