"""PT step phase attribution, after the JAX package's
scripts/pt_phase_attrib.py: the 16-spp step timed while max_bounces, NEE
(sky on / off) and the inter-bounce compaction vary; the differences
attribute the step's seconds to primary rays, each bounce's closest-hit
rays, NEE's any-hit rays and the compaction:

    python -m massivevoxelraytracing_torch.scripts.pt_phase_attrib
    python -m massivevoxelraytracing_torch.scripts.pt_phase_attrib --device cpu --res 32 --width 32 --height 32 --steps 1 --cells b0 b2 b2_nosky b2_nocompact

The scene is the bench lattice's HakoTree at --res (utils/treecache.
lattice_tree) under the reference scripts' camera (fovy 40). A cell is
named b<bounces>, with _nosky (no sky: no HDRI, so NEE finds no light and
a miss adds nothing) or _nocompact (compaction off); the reference's seven
are b0, b1, b2, b4, b8, b8_nosky and b8_nocompact. Each cell runs a fresh
PathTracer(max_bounces=...) with its compaction set, on one PMJ table
built once on the host (its cost printed): one warm step, then --steps
timed steps on the host clock, synced (pt_step_timing.measure): s/step,
the accumulator's mean and hako_mega's launches a step. On the card one
more step of the profiled cells (b0, b8, b8_nocompact) runs under torch.profiler for
the device's busy and idle share, its device kernels and the time in
hako_mega and in the sample chain's kernels, the trace held to the step's
counted launches (scripts/common.profile_counted: taken again until it
holds every hako_mega and sample-chain launch the wrappers counted, else
"not measured").
Then the differences: primary (b0), each added bounce (b1 - b0, b2 -
b1, (b4 - b2) / 2, (b8 - b4) / 4), NEE (b8 - b8_nosky) and compaction
(b8_nocompact - b8), for the cells run.

Two results hold by design and are checked: compaction is a stable
permutation of the lanes, so a _nocompact cell's accumulator equals its
compacted cell's bit for bit; and on a tree without emission a _nosky
cell's mean is exactly 0. The reference's U knob and MEGA_TUNED_PT table
choose TPU forms and are not ported. Its log of these cells
(docs/logs/r5_pt_sweep.log) ran on a tree cache without voxel colours, so
its bounces reflected black albedo: its means do not carry over. Without
a card and without --device cpu the script raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import pathtracer
from ..ops import sampling
from ..utils import treecache
from . import common, pt_step_timing

CELLS = ("b0", "b1", "b2", "b4", "b8", "b8_nosky", "b8_nocompact")
PROFILED = ("b0", "b8", "b8_nocompact")  # b8_nocompact: the compaction on the device


def parse_cell(name: str) -> tuple:
    """(max_bounces, sky, compact) of a cell's name: compact None is the
    tracer's own choice (on from COMPACT_MIN_LANES lanes)."""
    head, _, tail = name.partition("_")
    if not head.startswith("b") or not head[1:].isdigit() or tail not in (
            "", "nosky", "nocompact"):
        raise ValueError(f"a cell is b<bounces>[_nosky|_nocompact], not {name!r}")
    return int(head[1:]), tail != "nosky", (False if tail == "nocompact" else None)


def attribution(s: dict) -> dict:
    """The step's seconds split by the cells' differences (those whose
    cells ran): (cell, cell subtracted, divisor) a part."""
    parts = (("primary (b0)", "b0", None, 1), ("bounce 1 (b1 - b0)", "b1", "b0", 1),
             ("bounce 2 (b2 - b1)", "b2", "b1", 1),
             ("bounces 3-4, each ((b4 - b2) / 2)", "b4", "b2", 2),
             ("bounces 5-8, each ((b8 - b4) / 4)", "b8", "b4", 4),
             ("NEE (b8 - b8_nosky)", "b8", "b8_nosky", 1),
             ("compaction (b8_nocompact - b8)", "b8_nocompact", "b8", 1))
    return {what: (s[a] - (s[b] if b else 0.0)) / div for what, a, b, div in parts
            if a in s and (b is None or b in s)}


def run(res: int = 1024, width: int = 960, height: int = 540, steps: int = 2,
        tree=None, cells=None, device="cuda", card: str = "") -> dict:
    """The cells on the lattice at res^3 (or on `tree`). Returns each
    cell's numbers and accumulator, and the attribution."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if tree is None:
        tree = treecache.lattice_tree(res, device=dev)
    res = tree.grid_res
    cam = common.script_camera(tree.lower.cpu().numpy(), float(tree.dps) * res)
    t0 = time.perf_counter()
    pmj_table = torch.from_numpy(sampling.make_pmj_table())
    print(f"[pt-attrib] PMJ table {tuple(pmj_table.shape)} built on the host in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, shared by every cell", flush=True)

    records = {}
    for name in cells or CELLS:
        bounces, sky, compact = parse_cell(name)
        pt = pathtracer.PathTracer(width=width, height=height, max_bounces=bounces,
                                   device=dev)
        pt.compact = compact
        pt.pmj_table = pmj_table
        pt.setup()
        if sky:
            pt.load_hdri(common.sky_img())
        pt.update_scene(tree)
        rec = dict(bounces=bounces, sky=sky, compact=compact,
                   **pt_step_timing.measure(pt, cam, steps), accum=pt.accum.clone())
        if not np.isfinite(rec["mean"]):
            raise AssertionError(f"{name}: the accumulator's mean is {rec['mean']}")
        if cuda and name in PROFILED:
            rec["profile"] = common.profile_or_none(
                lambda: pt.step(cam), common.step_counts(),
                f"[pt-attrib res={res} {width}x{height}] {name} profiled step", card)
            # the steps the profiles ran: every try, where none held the counts
            rec["profiled_steps"] = (rec["profile"]["tries"] if rec["profile"]
                                     else len(common.PROFILE_PADS_S))
        records[name] = rec
        what = (f"{rec['s_per_step']:.3f} s/step (first {rec['first_s']:.1f} s)" if cuda
                else "plain versions")
        p = rec.get("profile")
        prof = (f", profiled step: busy {p['busy_ms']:.1f} of {p['wall_ms']:.1f} ms, idle "
                f"share {p['idle_share']:.3f}, {p['kernels']} device kernels, hako_mega "
                f"{p['mega_ms']:.1f} ms, the sample chain's kernels "
                f"{sum(v[0] for v in p['chain'].values()):.1f} ms (every counted launch "
                f"traced, try {p['tries']})" if p else
                ", profiled step: not measured" if "profile" in rec else "")
        print(f"[pt-attrib res={res} {width}x{height}] {name}: {what} "
              f"mean={rec['mean']:.6f}, {rec['launches_a_step']:g} hako_mega launches "
              f"a step{prof} [{card}]", flush=True)
        del pt

    for name, rec in records.items():
        if not rec["sky"] and not tree.has_emission and rec["mean"] != 0.0:
            raise AssertionError(f"{name}: no sky and no emission, yet mean {rec['mean']}")
        if rec["compact"] is False:
            twin = f"b{rec['bounces']}"
            if twin in records and not torch.equal(rec["accum"], records[twin]["accum"]):
                raise AssertionError(f"{name}: the accumulator differs from {twin}'s")
    shares = attribution({k: r["s_per_step"] for k, r in records.items()}) if cuda else {}
    for what, s in shares.items():
        print(f"[pt-attrib]   {what:36s} {s:8.3f} s/step [{card}]", flush=True)
    return dict(res=res, width=width, height=height, steps=steps, cells=records,
                attribution=shares)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=1024, help="grid resolution")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--steps", type=int, default=2, help="timed steps a cell")
    ap.add_argument("--cells", nargs="+", default=list(CELLS),
                    help="b<bounces>[_nosky|_nocompact] ...")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(args.res, args.width, args.height, args.steps, cells=args.cells,
               device=dev, card=card)


if __name__ == "__main__":
    main()
