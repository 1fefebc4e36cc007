"""Kernel A's fixed cost on the card, after the JAX package's
scripts/hako_shell_micro.py: its I/O shell, the ray preamble, the real
kernel A at 1 and 2 probes, and its probe body unrolled and by stage.

    python -m massivevoxelraytracing_torch.scripts.hako_shell_micro --staged
    python -m massivevoxelraytracing_torch.scripts.hako_shell_micro --device cpu --staged

Inputs, drawn as the reference draws them from default_rng(0): eight f32
arrays of U(0.5, 2) over GRID x 2,048 lanes (GRID = 256 blocks: a full
round's 524,288 lanes), then 60,000 voxel coordinates in 256^3, whose
unique Morton codes build the tree (lower 0, dps 1/256: T = 2, one level
table of 64 nodes). Arrays 0-2 are the origins, 3-5 the directions, all
positive: a ray finds cells only where its origin lies inside the unit
box on every axis, (1/3)^3 = 3.7% of lanes, though the line of ~59% of
them meets the box behind the origin (the preamble's enter_ok); so the
cases mostly measure I/O and the preamble (both shares are printed).

Cases, each held bit for bit against its plain version, then timed with
CUDA events (the least of 3 trains of 10 launches queued behind a spin
kernel, beside the library call where there is one; ms and us a
2,048-lane block, as the reference reports). The preamble's and the
stages' bound is the larger of their bytes and their pipe floor
(common.lane_floor: the kernel's SASS a warp-lane, each walk loop counted
as often as the warps run its slots, probes.stage_slots, at pipe_probe's
rates, common.pipe_rates, measured here unless the caller passes them). Every timed launch reads its
inputs from HBM, as a round's kernel A does: each train takes copies of
the case's inputs in turn, enough that 4 L2s of other copies pass between
two reads of one (scripts/common.cold_copies), for the kernels and for
torch.add alike:
  * the shell, o = i + 1: 8 separate arrays in and 8 out (the
    reference's :64), and the same data as one [GRID, 8, 2048] array
    each way (:78), with the time of torch.add on the same arrays into
    a new output a call, as the kernel's wrapper writes; then the kernel
    and torch.add into one fixed set of outputs, whose dirty lines the
    L2 keeps from one call to the next (so fewer bytes reach HBM);
  * the shell + the ray preamble on the unit box (:102);
  * the real kernel A (hako_probe) at P = 1 and 2 on every lane, tq = 0
    (:134);
  * the probe body unrolled over the T levels (:200; tq = array 6, as the
    reference passes it);
  * with --staged, the body by stage (:287; tq = 0): preamble + walk,
    + coords / planes / rank, + node fetch, + second walk.
The reference's body and stages read the low 16 bits of each root mask
word (its scal_i[0, 0] and [0, 2]); they get the same masks here. Its
stage 2 clips the rank to [0, 55] before the fetch, a literal of the
script: the tree's level has 64 nodes. Kernel A gets the tree's full root
masks, as the reference's real kernel does.

--device cpu runs the plain versions on the first 2,048 lanes (one
block) and prints no time; without a card and without that flag the
script raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hako, morton, probes
from ..ops import hako_kernels as hk
from . import common

GRID = 256         # blocks of the reference's grid
BLOCK = 2048       # lanes a block (16 x 128)
LANES = GRID * BLOCK
N_VOXELS = 60000
TREE_RES = 256
F32 = 4            # bytes
FIXED_OUT = "into fixed outputs"
FIXED_OUT_ADD = "torch.add into them"


def script_inputs(device, lanes: int = LANES):
    """(eight f32 [lanes] arrays, the tree) from default_rng(0) in the
    reference's draw order (all GRID x 2,048 lanes are drawn; the first
    `lanes` are kept)."""
    rng = np.random.default_rng(0)
    eight = [rng.uniform(0.5, 2.0, (LANES,)).astype(np.float32) for _ in range(8)]
    c = torch.from_numpy(rng.integers(0, TREE_RES, size=(N_VOXELS, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    tree = hako.build_hako(codes, TREE_RES, device=device,
                           lower=np.zeros(3, np.float32), dps=1.0 / TREE_RES)
    return [torch.from_numpy(x[:lanes]).to(device) for x in eight], tree


def _equal(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")


def run(device, *, staged: bool = False, card: str = "", pipe: dict | None = None,
        funcs: dict | None = None) -> dict:
    """The cases on `device` (all lanes on the card, one block on the
    CPU). Returns the case records, the tree's shape and the shares of
    lanes whose line meets the box and whose walk finds a cell. pipe /
    funcs: the pipe rates and the library's SASS functions where the
    caller has them already."""
    cuda = device.type == "cuda"
    lanes = LANES if cuda else BLOCK
    if cuda:
        from ..utils import cuda_build, sass

        cuda_build.load()
        funcs = funcs or sass.functions(sass.dump(cuda_build.LIB_PATH))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        clock = common.sm_clock_hz()
        pipe = pipe or common.pipe_rates(device, funcs, sms, clock, card)

    def floor(kernel, targs=(), runs=((), ()), grid_stride=False):
        """The kernel's pipe floor on the case's lanes (on the card); runs:
        common.stage_loop_times' (loop times, guard entries)."""
        return common.lane_floor(funcs, kernel, targs, grid_stride=grid_stride,
                                 times=runs[0], entries=runs[1], lanes=lanes, pipe=pipe,
                                 sms=sms, clock=clock)
    eight, tree = script_inputs(device, lanes)
    (_bricks, _snodes, tabs, root), T = hk.hako_args(tree)
    forms = probes.level_forms(tabs)
    blocks = lanes / BLOCK
    tab_bytes = sum(t.numel() for t in tabs) * F32
    pre_ops = 30 * lanes  # the ray preamble's float ops, a lower bound
    print(f"[shell micro] tree: T={T} level nodes {[t.shape[0] for t in tabs]} "
          f"forms {forms}; {lanes} lanes [{card}]", flush=True)
    records = []

    def case(name, site, kernel, fn, plain, inputs, n_bytes, n_ops, library=None,
             variants=None, pipe_floor=None):
        """fn(*inputs) against plain(*inputs), then (on the card) both,
        library(*inputs) and each of `variants` ({label: function}, each
        held against plain first) timed in turns on cold copies of the
        inputs; the bound the larger of n_bytes, n_ops and pipe_floor()
        (common.lane_floor's record) where given."""
        before = dict(probes.LAUNCHES), dict(hk.LAUNCHES)
        got = fn(*inputs)
        want = plain(*inputs)
        _equal(name, got, want)
        variants = variants or {}
        for label, v in variants.items():
            _equal(f"{name}, {label}", v(*inputs), want)
        rec = dict(name=name, site=site, kernel=kernel, lanes=lanes)
        if cuda:
            fns = [fn] + ([library] if library else []) + list(variants.values())
            ms = common.best_ms([common.in_turn(f, common.cold_copies(inputs, device))
                                 for f in fns])
            rec["ms"], rec["library_ms"] = ms[0], (ms[1] if library else None)
            rec["variants_ms"] = dict(zip(variants, ms[1 + bool(library):]))
            rec["plain_ms"] = common.timed(lambda: plain(*inputs), reps=1, warm=False)[1]
            rec["us_per_block"] = rec["ms"] * 1e3 / blocks
            rec["bound_ms"], rec["bound_by"] = common.bound(n_bytes, n_ops)
            rec["bytes_ms"] = n_bytes / common.HBM_BYTES_PER_S * 1e3
            if pipe_floor is not None:
                fl = pipe_floor()
                rec.update(pipe_floor_ms=fl["pipe_floor_ms"], busiest_pipe=fl["busiest_pipe"],
                           sass_a_warp_lane=fl["instructions"], lane_loops=fl["loops"])
                if (fl["pipe_floor_ms"] or 0.0) > rec["bound_ms"]:
                    rec["bound_ms"], rec["bound_by"] = fl["pipe_floor_ms"], "operations"
        rec["launches"] = (sum(probes.LAUNCHES[k] - before[0][k] for k in probes.LAUNCHES)
                           + sum(hk.LAUNCHES[k] - before[1][k] for k in hk.LAUNCHES))
        records.append(rec)
        if cuda:
            lib = (f", torch.add {rec['library_ms']:.4f} ms" if library else "")
            if "pipe_floor_ms" in rec:
                lib += (f"; bytes {rec['bytes_ms']:.4f} ms, pipe floor "
                        + ("not measured" if rec["pipe_floor_ms"] is None else
                           f"{rec['pipe_floor_ms']:.4f} ms ({rec['busiest_pipe']}, "
                           f"{rec['sass_a_warp_lane']:.1f} SASS a warp-lane)"))
            lib += "".join(f", {label} {v:.4f} ms" for label, v in rec["variants_ms"].items())
            print(f"[shell micro] {name:36s}: {rec['ms']:8.4f} ms ({rec['us_per_block']:6.3f} "
                  f"us/block) == plain ({rec['plain_ms']:.2f} ms); bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}){lib}; inputs from HBM "
                  f"[{card}]", flush=True)
        else:
            print(f"[shell micro] {name:36s}: == plain version [{card}]", flush=True)
        return got

    # (a) 8 separate arrays in and 8 out, (b) one consolidated block
    outs8 = [torch.empty_like(x) for x in eight]
    one = torch.stack([x.reshape(-1, BLOCK) for x in eight], 1).contiguous()
    out1 = torch.empty_like(one)
    # torch.add beside the kernel on a new output a call, as the wrapper
    # writes; then both into one fixed set of outputs (whose dirty lines the
    # L2 keeps from one call to the next)
    for label, site, ins, outs in (("8 separate in + 8 out", ":64", eight, outs8),
                                   ("1 consolidated in + 1 out", ":78", (one,), (out1,))):
        case(f"shell: {label}", site, "shell_copy_probe", probes.shell_copy_probe,
             probes.shell_copy_plain, ins, 16 * F32 * lanes, 0,
             lambda *xs: tuple(torch.add(x, 1.0) for x in xs),
             variants={FIXED_OUT: lambda *xs, o=outs: probes.shell_copy_probe(*xs, out=o),
                       FIXED_OUT_ADD: lambda *xs, o=outs: tuple(
                           torch.add(x, 1.0, out=y) for x, y in zip(xs, o))})
    # (c) + the ray preamble on the unit box
    unit = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32, device=device)
    pre = case("shell + ray preamble", ":102", "preamble_probe",
               lambda *r: probes.preamble_probe(list(r), unit),
               lambda *r: probes.preamble_plain(list(r), unit), eight[:6],
               14 * F32 * lanes, pre_ops,
               pipe_floor=lambda: floor("preamble_probe_kernel"))
    # (d) the real kernel A
    bounds = torch.cat([tree.lower, tree.upper]).to(torch.float32)
    ro = torch.stack(eight[:3], 1).contiguous()
    rd = torch.stack(eight[3:6], 1).contiguous()
    idx = torch.arange(lanes, dtype=torch.int32, device=device)
    tq0 = torch.zeros(lanes, dtype=torch.float32, device=device)
    levels, level_off = hk.level_pack(list(tabs))
    head = (levels, level_off, T, root, bounds)
    for p in (1, 2):
        got = case(f"real kernel A (P={p})", ":134", "hako_probe",
                   lambda *a, p=p: hk.hako_probe(*head, *a, max_probes=p),
                   lambda *a, p=p: hk.hako_probe_plain(*head, *a, max_probes=p),
                   (ro, rd, idx, tq0), 58 * lanes + tab_bytes, pre_ops)
    # the line of most rays meets the box, but behind their origin
    meets, ahead = float(pre[7].mean()), 1.0 - float(got[5].float().mean())
    print(f"[shell micro]   lanes whose line meets the box (enter_ok): {meets:.4f}; "
          f"whose root walk finds a cell ahead (kernel A, not exhausted): {ahead:.4f}",
          flush=True)
    # (e) the body unrolled; the reference's 16-bit root mask words
    root16 = (root[0] & 0xFFFF, root[1] & 0xFFFF)

    def stage_fns(stage):
        return (lambda *r: probes.probe_stage_probe(stage, list(r), bounds, root16, tabs,
                                                    T=T),
                lambda *r: probes.probe_stage_plain(stage, list(r), bounds, root16, tabs,
                                                    T=T))

    def stage_floor(stage, rays):
        """The stage's pipe floor, its walks' slots as the warps run them."""
        slots = probes.stage_slots(stage, rays, bounds, root16, tabs, T=T)
        return floor("probe_stage_kernel", (stage,),
                     common.stage_loop_times(stage, slots, T, -(-lanes // 32)),
                     grid_stride=True)

    body = eight[:6] + [eight[6]]
    case("unrolled probe body (no loop)", ":200", "probe_stage_probe", *stage_fns(4),
         body, 15 * F32 * lanes + tab_bytes, pre_ops,
         pipe_floor=lambda: stage_floor(4, body))
    if staged:
        zero_tq = eight[:6] + [tq0]
        for stage in range(4):
            case(f"stage {stage}: {probes.PROBE_STAGES[stage]}", ":287",
                 "probe_stage_probe", *stage_fns(stage), zero_tq,
                 10 * F32 * lanes + (tab_bytes if stage >= 2 else 0), pre_ops,
                 pipe_floor=lambda s=stage: stage_floor(s, zero_tq))
    return dict(lanes=lanes, T=T, level_nodes=[t.shape[0] for t in tabs], forms=forms,
                meets_box_share=meets, ahead_share=ahead, cases=records)


def main(argv=None, *, pipe: dict | None = None, funcs: dict | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--staged", action="store_true",
                    help="also time the probe body by stage (the reference's STAGED run)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(dev, staged=args.staged, card=card, pipe=pipe, funcs=funcs)


if __name__ == "__main__":
    main()
