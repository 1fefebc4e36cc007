"""The probe body by stage (ops/probes.probe_stage_probe: kernel A's body
cut into stages, the reference's hako_shell_micro.py :200 and :287)
against an earlier design, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.stage_ab
    python -m massivevoxelraytracing_torch.scripts.stage_ab --device cpu

The earlier design is commit aca9a3e's csrc/hako_probes.cu, kept verbatim
under `csrc/earlier/` (its stage kernel and launcher are those of every
commit up to bd00d0e, and it includes the current hako_device.cuh, which
they left unchanged), built by scripts/issue_ab.build_earlier into a
library of its own and called through the same wrapper, cuda_build.load
answering the earlier entry point.

Two sets of 524,288 lanes:
  * script: hako_shell_micro's lanes and 256^3 tree (T = 2, one level of
    64 nodes; stages 0-3 at t_q = 0, stage 4 at t_q = array 6), where a
    lane's root walk runs only if its origin lies in the box (3.7% of
    lanes, in ~80% of warps) and the second walk never does;
  * hits: the card tests' rays (origins around the unit box, directions of
    every sign, t_q of either sign) under dense masks (a root mask and two
    level tables of 40 and 300 nodes, T = 3), where the walks find cells
    and their slots are the cost.
Every stage of each set is held bit for bit against its plain version
through both designs, then timed in the turns old, new, new, old
(row_stage_ab.in_turns; every timed launch reads its inputs from HBM,
common.cold_copies). Beside each: each design's grid, ptxas registers and
blocks an SM (the current design's as its launcher sizes its wave,
probes.stage_blocks; the earlier's by its registers), an empty launch of its grid, its SASS a warp-lane (the lane
body once, each walk loop as often as the warps run its slots,
probes.stage_slots), its pipe floor at pipe_probe's rates
(common.lane_floor; the rates measured in the same run, or passed in), the
bytes bound (each input read and each output written once, the level
tables once), and the share of the larger of the two. --floors-only
prints all of that but the turns (what a prediction is made from, before
any timing). --device cpu runs the plain versions on 2,048 lanes of each
set and prints no time; without a card and without that flag it raises.
The launches it makes are not counted.
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from ..ops import hako_kernels as hk
from ..ops import probes
from ..utils import cuda_build, sass
from . import common, hako_shell_micro, issue_ab
from .gather_ab import counts_kept, earlier_entries
from .row_stage_ab import faster, in_turns

ENTRY = "probe_stage_probe_launch"
KERNEL = "probe_stage_kernel"
LANES = hako_shell_micro.LANES
CPU_LANES = hako_shell_micro.BLOCK
THREADS = 128      # the stage kernel's block (kLaneThreads)
F32 = 4
HIT_T = 3
HIT_LEVELS = ((40, 250, 420), (300, 0, 1 << 20))  # nodes, base range: an smem and a taa level


def hit_inputs(device, lanes: int, seed: int = 13):
    """(rays: 7 f32 [lanes], bounds, root masks, level tables): the card
    tests' rays (origins U(-0.5, 1.5), directions N(0, 1), t_q U(-0.2,
    0.6)) in the unit box under dense masks, each mask word the or of
    three random words; level 0 has 40 nodes (the smem form), level 1 300
    (the taa form), bases from HIT_LEVELS, so ranks and child indices run
    past both."""
    rng = np.random.default_rng(seed)

    def words(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    def dense(n):
        return words(n) | words(n) | words(n)

    tabs = [torch.as_tensor(np.stack([dense(n), dense(n), rng.integers(lo, hi, n)
                                      .astype(np.uint32)], 1).view(np.int32), device=device)
            for n, lo, hi in HIT_LEVELS]
    root = tuple(int(dense(1)[0]) for _ in range(2))
    rays = ([torch.as_tensor(rng.uniform(-0.5, 1.5, lanes).astype(np.float32), device=device)
             for _ in range(3)]
            + [torch.as_tensor(rng.normal(size=lanes).astype(np.float32), device=device)
               for _ in range(3)]
            + [torch.as_tensor(rng.uniform(-0.2, 0.6, lanes).astype(np.float32),
                               device=device)])
    bounds = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32, device=device)
    return rays, bounds, root, tabs


def input_sets(device, lanes: int) -> dict:
    """{set: (the rays of each stage, bounds, root masks, tables, T)}."""
    eight, tree = hako_shell_micro.script_inputs(device, lanes)
    (_bricks, _snodes, tabs, root), T = hk.hako_args(tree)
    bounds = torch.cat([tree.lower, tree.upper]).to(torch.float32)
    tq0 = torch.zeros(lanes, dtype=torch.float32, device=device)
    script = [eight[:6] + [tq0]] * 4 + [eight[:6] + [eight[6]]]
    rays, hb, hroot, htabs = hit_inputs(device, lanes)
    return {"script": (script, bounds, (root[0] & 0xFFFF, root[1] & 0xFFFF), tabs, T),
            "hits": ([rays] * 5, hb, hroot, htabs, HIT_T)}


def stage_bytes(stage: int, lanes: int, tabs) -> int:
    """What the stage must move: its 7 input floats a lane read once, its
    outputs (3 words a lane for stages 0-3, 8 for stage 4) written once,
    and the level tables once where it fetches."""
    words = 7 + (8 if stage == 4 else 3)
    return words * F32 * lanes + (sum(t.numel() for t in tabs) * F32 if stage >= 2 else 0)


def ptxas_registers(log: str) -> dict:
    """{stage: registers} of each probe_stage_kernel instantiation in a
    ptxas report."""
    out, stage = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(rf"{KERNEL}ILi(\d)E", ln)
            stage = int(m.group(1)) if m else None
        elif stage is not None and "registers" in ln:
            out[stage] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def blocks_per_sm(registers: int, threads: int = THREADS) -> int:
    """The blocks an SM holds of the earlier design (one lane a thread, no
    shared memory) by its registers (65,536 a Hopper SM, given to
    each warp in units of 256, at most 2,048 threads and 32 blocks)."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // per_warp // (threads // 32), 2048 // threads, 32)


def run(device, *, card: str = "", pipe: dict | None = None, funcs: dict | None = None,
        earlier=None, floors_only: bool = False) -> dict:
    """Both sets' stages on `device`, their launches not counted: {"<set>
    stage <s>": record}, with "designs" (each design's registers and blocks
    an SM by stage) and "pipe". pipe / funcs / earlier: the pipe rates, the
    current library's SASS functions and issue_ab.build_earlier's answer
    where the caller has them already. floors_only: no turns."""
    cuda = device.type == "cuda"
    lanes = LANES if cuda else CPU_LANES
    t_start = time.perf_counter()
    out = {}
    with counts_kept():
        if cuda:
            entries, old_funcs, old_log = earlier or issue_ab.build_earlier(issue_ab.EARLIER)
            old_fn = entries[ENTRY]
            funcs = funcs or sass.functions(sass.dump(cuda_build.LIB_PATH))
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            clock = common.sm_clock_hz()
            common.warm_up(device)
            pipe = pipe or common.pipe_rates(device, funcs, sms, clock, card)
            regs = {"current": ptxas_registers(cuda_build.last_build_log or ""),
                    "earlier": ptxas_registers(old_log)}
            designs = {
                "current": {s: dict(registers=r,
                                    blocks_per_sm=probes.stage_blocks(s, 1 << 30, device) // sms)
                            for s, r in regs["current"].items()},
                "earlier": {s: dict(registers=r, blocks_per_sm=blocks_per_sm(r))
                            for s, r in regs["earlier"].items()}}
            out.update(designs=designs, pipe=pipe)
            print(f"[stage_ab] registers (blocks an SM): "
                  + "; ".join(f"{label} " + ", ".join(
                      f"stage {s} {d.get('registers')} ({d.get('blocks_per_sm')})"
                      for s, d in sorted(designs[label].items())) for label in designs)
                  + f"; set-up {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
        for set_name, (stage_rays, bounds, root, tabs, T) in input_sets(device, lanes).items():
            for stage, rays in enumerate(stage_rays):
                key = f"{set_name} stage {stage}"

                def call(*r, s=stage, b=bounds, m=root, t=tabs, T=T):
                    return probes.probe_stage_probe(s, list(r), b, m, t, T=T)

                want = probes.probe_stage_plain(stage, rays, bounds, root, tabs, T=T)
                sets = common.cold_copies(tuple(rays), device) if cuda else [tuple(rays)]
                fns = {"new": common.in_turn(call, sets)}
                if cuda:
                    def earlier_call(*r, c=call):
                        with earlier_entries({ENTRY: old_fn}):
                            return c(*r)
                    fns["old"] = common.in_turn(earlier_call, sets)
                ms = in_turns(fns, f"probe_stage_probe {key}", want, cuda and not floors_only)
                rec = dict(lanes=lanes, T=T)
                if not cuda:
                    print(f"[stage_ab] {key} ({lanes} lanes): both designs == plain [{card}]",
                          flush=True)
                    out[key] = rec
                    continue
                rec["bytes_ms"] = stage_bytes(stage, lanes, tabs) / common.HBM_BYTES_PER_S * 1e3
                if not floors_only:
                    rec.update(old_ms=ms["old"], ms=ms["new"], faster=faster(ms))
                for label, hopper, fs, grid_stride in (("current", True, funcs, True),
                                                       ("earlier", False, old_funcs, False)):
                    slots = probes.stage_slots(stage, rays, bounds, root, tabs, T=T,
                                               hopper=hopper)
                    times, entries = common.stage_loop_times(stage, slots, T, -(-lanes // 32))
                    fl = common.lane_floor(fs, KERNEL, (stage,), grid_stride=grid_stride,
                                           times=times, entries=entries, lanes=lanes,
                                           pipe=pipe, sms=sms, clock=clock)
                    blocks = (probes.stage_blocks(stage, lanes, device) if label == "current"
                              else -(-lanes // THREADS))
                    fl.update(slots=slots, grid_blocks=blocks, empty_launch_ms=common.best_ms(
                        [lambda b=blocks: probes.empty_launch(b, THREADS, device)])[0])
                    bound = max(rec["bytes_ms"], fl["pipe_floor_ms"] or 0.0)
                    fl.update(bound_ms=bound, bound_by="bytes" if bound == rec["bytes_ms"]
                              else "operations")
                    if not floors_only:
                        fl["share"] = bound / min(ms["new" if label == "current" else "old"])
                    rec[label] = fl
                report(key, rec, card)
                out[key] = rec
    if cuda:
        print(f"[stage_ab] {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    return out


def floor_text(fl: dict) -> str:
    if fl["pipe_floor_ms"] is None:
        return (f"pipe floor not measured ({fl['loops']} loops in the lane body, "
                f"{fl['straight']} SASS outside them)")
    return (f"{fl['instructions']:.1f} SASS a warp-lane, pipe floor {fl['pipe_floor_ms']:.4f} "
            f"ms ({fl['busiest_pipe']}), issue {fl['issue_floor_ms']:.4f} ms")


def report(key: str, rec: dict, card: str) -> None:
    def design(label):
        d = rec[label]
        share = f", share {d['share']:.1%}" if "share" in d else ""
        slots = " / ".join(f"{s['warp_slots']}" for s in d["slots"])
        return (f"{label} {floor_text(d)}, warps' slots a walk {slots}, grid "
                f"{d['grid_blocks']} (empty launch {d['empty_launch_ms']:.4f} ms), bound "
                f"{d['bound_ms']:.4f} ms ({d['bound_by']}){share}")

    turns = ""
    if "ms" in rec:
        turns = (f"turns earlier {rec['old_ms'][0]:.4f}, current {rec['ms'][0]:.4f}, current "
                 f"{rec['ms'][1]:.4f}, earlier {rec['old_ms'][1]:.4f} ms; ")
    print(f"[stage_ab] {key} ({rec['lanes']} lanes, T={rec['T']}): {turns}bytes bound "
          f"{rec['bytes_ms']:.4f} ms; {design('current')}; {design('earlier')}"
          + (f"; faster in every turn: {rec['faster']}" if "faster" in rec else "")
          + f" [{card}]", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--floors-only", action="store_true",
                    help="the floors, grids and registers of both designs, no timing")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(dev, card=card, floors_only=args.floors_only)


if __name__ == "__main__":
    main()
