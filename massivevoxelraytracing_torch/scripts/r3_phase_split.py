"""The round's phases at the top rung's width, after the JAX package's
scripts/r3_phase_split.py, and its question on the card: does
deduplicating a round's brick rows (a block-local row cache) pay for
kernel B?

    python -m massivevoxelraytracing_torch.scripts.r3_phase_split --res 1024
    python -m massivevoxelraytracing_torch.scripts.r3_phase_split --device cpu --res 32 --width 64 --height 64

The bench lattice (utils/treecache.lattice_tree) at --res under the
script's camera, 1920x1088 rays in tile order padded to the renderer's
packet (scripts/hako_phase_timing.frame_rays; the reference pads to its
largest packet, the same at this size). The phases run on the first
eighth of the frame's lanes, the reference's top rung (cap = nb //
CAP_DIV blocks of 2,048, CAP_DIV = 8), each checked against its plain
version, then timed with CUDA events (a kernel: the least of 3 trains of
10 launches queued behind a spin kernel; a phase with a host sync or a
state to restore: the mean of 10 single runs):
  1. kernel A (hako_probe) at max_probes 4 (the reference's :130);
  2. on a fat tree, the supernode row stage (hako_dda, leaf=False), then
     supernode_handoff;
  3. kernel B on the brick rows: hako_dda against hako_dda_cached, whose
     128-lane blocks stage up to U distinct rows in shared memory (U the
     reference's tuned UNIQ for the resolution: 64 at 1024^3), each in
     the round's lane order and with the lanes sorted by child id (:212);
  4. that sort, with its gathers and the scatter of the outputs back,
     timed alone (the counterpart of dedup_sorts, :188);
  5. the distinct rows of each 128-lane block in both orders, and the
     go-lanes that read the cache and those that overflowed U (the
     kernel's own counts, equal to block_rows_plain's);
  6. the bookkeeping: round_lanes (the round's one host sync) and
     hako_merge (:249);
  7. the row stage in one launch (hako_dda_merge: the supernode rows, the
     handoff, the brick rows and the merge) on kernel A's outputs, against
     the stages 2, 3 and the merge it replaces;
  8. one round on the device, as the reference times its jitted round body
     on a fixed state (:274): the inputs drive builds (the level tables,
     the bounds, the fresh state of the phases' lanes and its round_lanes)
     made once, then kernel A and the row stage on a copy of that state,
     timed with CUDA events (the mean of 10 single runs queued behind a
     spin kernel long enough for the round's wrapper calls and eager
     ops), with the unfused stage (kernel B and the merge apart, as the
     reference's round) and with the fused one (the route's), each beside
     the sum of its kernels' bytes bounds;
  9. the host's wall of that round: drive(..., max_rounds=1) on the
     phases' lanes, whose level pack, state allocation, nonzero sync and
     two wrapper calls hold the queued launches to the host's pace;
 10. the full frame through intersect_rays_hako: its rounds and ms, equal
     to the plain driver's.

On a fat tree the reference's isolated kernel B feeds kernel A's
supernode ids into the brick tables (tab_a, tab_m = bricks at :147, leaf
B at :212): a DDA of unrelated rows. Here phase 3 runs on the round's
real stages (supernode rows, the handoff, brick rows), as
scripts/hako_phase_timing.py does. The port's driver has no cap ladder
(the reference's :302-322): every round serves every unresolved lane, so
the frame's rounds are printed without a split by rung. --device cpu
runs the plain versions (the cached kernel's: hako_dda_plain and
block_rows_plain) and prints no time.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import hako_kernels as hk
from ..ops import hako_mega
from ..utils import treecache
from . import common
from . import hako_phase_timing as phase_timing

RB = phase_timing.RB  # rays a block of the reference's round kernels
CAP_DIV = 8           # the reference's top rung: an eighth of the blocks
# the reference's tuned row-dedup budget (its UNIQ knob, TUNED_BY_RES)
UNIQ_BY_RES = {256: 32, 1024: 64, 2048: 64}
INT32_MAX = 2**31 - 1
# the round's phases: on the device (a preset state) and the host's wall
DEVICE_ROUND_UNFUSED = "one round on the device, unfused stage"
DEVICE_ROUND_FUSED = "one round on the device, fused stage"
HOST_WALL_UNFUSED = "host wall: drive(max_rounds=1), unfused"
HOST_WALL_FUSED = "host wall: drive(max_rounds=1), fused"


def uniq_for(grid_res: int) -> int:
    """The reference's UNIQ at grid_res (knobs_for_res): the entry nearest
    in log space, if within 4x of it; else its default, 0 (no cache)."""
    key = min(UNIQ_BY_RES,
              key=lambda k: abs(math.log(k) - math.log(max(grid_res, 1))))
    return UNIQ_BY_RES[key] if max(key, grid_res) / max(min(key, grid_res), 1) <= 4 else 0


def script_camera(tree):
    """The reference script's camera for a tree: from (0.9, 0.4, 1.4) x 0.9
    extents off the box's center, 40 degrees."""
    lo = tree.lower.cpu().numpy()
    hi = tree.upper.cpu().numpy()
    center = (lo + hi) / 2
    extent = float((hi - lo).max())
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
        target=center, fovy_deg=40.0)


def _equal(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")


def bound_sum(bounds) -> tuple:
    """The sum of kernels' bounds (ms, bound_by): 'bytes' where every part
    is bound by its bytes."""
    return (sum(b[0] for b in bounds),
            "bytes" if all(b[1] == "bytes" for b in bounds) else "operations")


def sort_by_row(emit, child):
    """The lanes in child-id order, the go-lanes first (a stable sort)."""
    return torch.sort(torch.where(emit, child, INT32_MAX), stable=True)[1]


def gather_lanes(order, idx, emit, child, bt1, tqe):
    return idx[order], emit[order], child[order], bt1[:, order], tqe[order]


def scatter_back(order, outs):
    """Kernel B's outputs in sorted order -> the round's lane order."""
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[order] = x
        back.append(y)
    return tuple(back)


def block_summary(stats) -> dict:
    """A kernel's per-block counts (go-lanes, distinct rows, go-lanes that
    read the cache) summed and spread over the blocks with go-lanes."""
    s = stats.long()
    live = s[s[:, 0] > 0]
    go, cached = int(s[:, 0].sum()), int(s[:, 2].sum())
    d = live[:, 1].double() if live.shape[0] else torch.zeros(1, dtype=torch.float64)
    return dict(blocks=int(s.shape[0]), blocks_with_go=int(live.shape[0]), go_lanes=go,
                distinct_rows=int(s[:, 1].sum()), mean_distinct=float(d.mean()),
                max_distinct=int(d.max()), cached_lanes=cached, overflow_lanes=go - cached)


def round_setup(tree, cam, width: int, height: int, *, max_probes: int = hk.PROBES,
                max_dda: int = hk.DDA_ITERS, step=None) -> dict:
    """The round that run times, up to kernel B's inputs on the brick rows:
    the frame's rays under cam, the top rung's lanes, kernel A's outputs
    and, on a fat tree, the supernode rows and their hand-off, through the
    wrappers (the kernels on the card, the plain versions on the CPU).
    step(name, kernel, plain, bound) gives kernel A's and the supernode
    rows' outputs (run checks and times them there; by default the kernel
    alone). Kernel B's arguments are (bricks, *rays, *brick_lanes), its
    keywords "leaf"."""
    step = step or (lambda name, kernel, plain, bound: kernel())
    dev = tree.device
    ro_np, rd_np = phase_timing.frame_rays(cam, width, height)
    ro = torch.from_numpy(ro_np).to(dev)
    rd = torch.from_numpy(rd_np).to(dev)
    n_rays = ro.shape[0]
    cap = max(n_rays // RB // CAP_DIV, 1)
    n = min(cap * RB, n_rays)
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    fat = snodes is not None
    levels, level_off = hk.level_pack(tabs)
    bounds = torch.cat([tree.lower, tree.upper]).to(device=dev, dtype=torch.float32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    rays = (bounds, ro, rd)
    state0 = phase_timing._fresh_state(n_rays, dev)
    a = (levels, level_off, T, root, *rays, idx, state0[1])
    a_bound = common.probe_bound(n, 0 if levels is None else levels.numel())
    a_out = step("kernel A", lambda: hk.hako_probe(*a, max_probes=max_probes),
                 lambda: hk.hako_probe_plain(*a, max_probes=max_probes), a_bound)
    emit, child, bt1, tqe, tqn, exh = a_out
    dda_kw = dict(shadow=False, max_iters=max_dda)
    unfused_bounds = [a_bound]
    if fat:
        sa = (snodes, *rays, idx, emit, child, bt1, tqe)
        unfused_bounds.append(common.dda_bound(n, *common.dda_counts(emit, child)))
        sn = step("supernode rows",
                  lambda: hk.hako_dda(*sa, dt_factor=0.25 ** T, leaf=False, **dda_kw),
                  lambda: hk.hako_dda_plain(*sa, dt_factor=0.25 ** T, leaf=False, **dda_kw),
                  unfused_bounds[-1])
        emit, child, bt1, tqe, tqn = hk.supernode_handoff(emit, bt1, tqn, sn)
    return dict(T=T, fat=fat, bricks=bricks, snodes=snodes, tabs=tabs, root=root,
                levels=levels, level_off=level_off, rays=rays, n_rays=n_rays, cap=cap,
                lanes=n, state0=state0, a_out=a_out, a_bound=a_bound,
                unfused_bounds=unfused_bounds, brick_lanes=(idx, emit, child, bt1, tqe),
                tqn=tqn, exh=exh, uniq=uniq_for(tree.grid_res),
                leaf=dict(dt_factor=0.25 ** (T + 2 if fat else T), leaf=True, **dda_kw))


def run(tree, cam, width: int, height: int, *, max_probes: int = hk.PROBES,
        max_dda: int = hk.DDA_ITERS, label: str = "", card: str = "") -> dict:
    """The phases and the full frame of one tree and camera. Returns their
    times (None on the CPU), launches and row counts, and each phase's
    outputs (under "outputs")."""
    dev = tree.device
    cuda = dev.type == "cuda"
    phases, outputs = {}, {}
    launches0 = dict(hk.LAUNCHES)

    def phase(name, kernel, plain, setup=None, equal=_equal, bound=None, calls=1):
        """kernel(x) / plain(x) of x = setup() (untimed), or of nothing;
        records the phase's kernel launches (its check and its timing) and
        a kernel's bound on its inputs (scripts/common). `calls`: the
        wrapper calls (and eager ops) one kernel(x) queues."""
        prep = setup or (lambda: None)
        k_fn, p_fn = ((kernel, plain) if setup else
                      (lambda _: kernel(), lambda _: plain()))
        before = dict(hk.LAUNCHES)
        got = k_fn(prep())
        equal(name, got, p_fn(prep()))
        outputs[name] = got
        rec = phases[name] = {}
        if cuda:
            rec["ms"] = (common.event_ms_each(k_fn, prep, calls=calls) if setup else
                         common.best_ms([kernel])[0])
            rec["plain_ms"] = common.event_ms_each(p_fn, prep, reps=1)
            if bound:
                rec["bound_ms"], rec["bound_by"] = bound
        rec["launches"] = {k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES}
        return got

    r = round_setup(tree, cam, width, height, max_probes=max_probes, max_dda=max_dda,
                    step=lambda name, kernel, plain, bound: phase(name, kernel, plain,
                                                                   bound=bound))
    T, fat, bricks, snodes, tabs, root = (r[k] for k in ("T", "fat", "bricks", "snodes",
                                                         "tabs", "root"))
    levels, level_off, rays, state0 = r["levels"], r["level_off"], r["rays"], r["state0"]
    bounds, ro, rd = rays
    n_rays, cap, n, uniq, leaf = r["n_rays"], r["cap"], r["lanes"], r["uniq"], r["leaf"]
    a_bound, unfused_bounds, tqn, exh = r["a_bound"], r["unfused_bounds"], r["tqn"], r["exh"]
    lanes = r["brick_lanes"]
    idx, emit, child, bt1, _tqe = lanes

    def cached_equal(name, got, want):
        _equal(name, got[0], want[0])
        _equal(name + " (block rows)", (got[1],), (want[1],))

    def kernel_b(order_name, lanes):
        b = (bricks, *rays, *lanes)
        go, ch = lanes[1], lanes[2]
        b_bound = common.dda_bound(n, *common.dda_counts(go, ch))
        out = phase(f"B rows, {order_name}", lambda: hk.hako_dda(*b, **leaf),
                    lambda: hk.hako_dda_plain(*b, **leaf), bound=b_bound)
        cached = phase(f"B cached U={uniq}, {order_name}",
                       lambda: hk.hako_dda_cached(*b, cache=uniq, **leaf),
                       lambda: (hk.hako_dda_plain(*b, **leaf),
                                hk.block_rows_plain(go, ch, uniq)),
                       equal=cached_equal, bound=b_bound)
        return out, cached[1], b_bound

    out_r, stats_r, b_bound = kernel_b("round order", lanes)
    unfused_bounds.append(b_bound)
    order = sort_by_row(emit, child)
    out_s, stats_s, _ = kernel_b("sorted by row", gather_lanes(order, *lanes))
    _equal("B sorted, scattered back", scatter_back(order, out_s), out_r)

    def reorder(_):
        o = sort_by_row(emit, child)
        gather_lanes(o, *lanes)
        return scatter_back(o, out_s)

    sort_rec = {"launches": {k: 0 for k in hk.LAUNCHES}}
    if cuda:
        sort_rec["ms"] = common.best_ms([lambda: reorder(None)])[0]
    phases["sort, gathers, scatter back"] = sort_rec
    rows = {"round order": block_summary(stats_r), "sorted by row": block_summary(stats_s),
            "distinct_rows_round": int(torch.unique(child[emit]).numel())}

    hit, t_hit, nmaj, vr, _p3, _tqp, more, tqr = out_r
    m = (idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr, more, tqr)
    unfused_bounds.append(common.merge_bound(*common.merge_counts(state0, idx, emit, hit,
                                                                  more)))

    def book(merge):
        def call(state):
            hk.round_lanes(state)
            merge(state, *m)
            return state
        return call

    phase("bookkeeping (round_lanes + merge)", book(hk.hako_merge),
          book(hk.hako_merge_plain), setup=lambda: tuple(x.clone() for x in state0))

    a_out = r["a_out"]

    def staged(stage):
        def call(state):
            stage(state, bricks, snodes, *rays, idx, *a_out, T=T, shadow=False,
                  max_iters=max_dda)
            return state
        return call

    walks = ([(a_out[0], a_out[1])] if fat else []) + [(emit, child)]
    stage_bound = common.dda_merge_bound(*common.dda_merge_counts(
        state0, idx, a_out[0], walks, hit))
    phase("row stage fused (hako_dda_merge)", staged(hk.hako_dda_merge),
          staged(hk.hako_dda_merge_plain), setup=lambda: tuple(x.clone() for x in state0),
          bound=stage_bound)

    # one round on the device: drive's inputs on the phases' lanes, made once
    ro_n, rd_n = ro[:n], rd[:n]
    round_state = phase_timing._fresh_state(n, dev)
    round_idx = hk.round_lanes(round_state)

    def device_round(probe, stage):
        def call(state):
            a_out = probe(levels, level_off, T, root, bounds, ro_n, rd_n, round_idx,
                          state[1], max_probes=max_probes)
            stage(state, bricks, snodes, bounds, ro_n, rd_n, round_idx, *a_out, T=T,
                  shadow=False, max_iters=max_dda)
            return state
        return call

    plain_round = device_round(hk.hako_probe_plain,
                               hk.unfused_stage(hk.hako_dda_plain, hk.hako_merge_plain))
    # the unfused stage queues kernel B twice, the hand-off's eager ops and
    # the merge behind kernel A; the fused one a launch behind it
    for name, stage, calls, parts in (
            (DEVICE_ROUND_UNFUSED, hk.unfused_stage(hk.hako_dda, hk.hako_merge), 8,
             unfused_bounds),
            (DEVICE_ROUND_FUSED, hk.hako_dda_merge, 4, [a_bound, stage_bound])):
        phase(name, device_round(hk.hako_probe, stage), plain_round,
              setup=lambda: tuple(x.clone() for x in round_state),
              bound=bound_sum(parts), calls=calls)

    kw = dict(T=T, shadow=False, max_probes=max_probes, max_dda=max_dda)
    head = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro_n, rd_n)
    plains = (hk.hako_probe_plain, hk.unfused_stage(hk.hako_dda_plain, hk.hako_merge_plain))
    for name, kernels in (
            (HOST_WALL_UNFUSED, (hk.hako_probe, hk.unfused_stage(hk.hako_dda, hk.hako_merge))),
            (HOST_WALL_FUSED, (hk.hako_probe, hk.hako_dda_merge))):
        phase(name, lambda k=kernels: hk.drive(k, *head, max_rounds=1, **kw)[:4],
              lambda: hk.drive(plains, *head, max_rounds=1, **kw)[:4])

    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    fkw = dict(T=T, max_probes=max_probes, max_dda=max_dda)
    before, rounds0 = dict(hk.LAUNCHES), hk.rounds_run()
    got = hk.intersect_rays_hako(*args, **fkw)
    rounds = hk.rounds_run() - rounds0
    want = hk.intersect_rays_hako_plain(*args, **fkw)
    _equal("full frame", got, want[:3])
    if int(want[3].item()):
        raise AssertionError("full frame: lanes unresolved")
    outputs["frame"] = got
    frame = dict(rays=n_rays, rounds=rounds)
    if cuda:
        frame["ms"] = common.event_ms_each(lambda _: hk.intersect_rays_hako(*args, **fkw),
                                           lambda: None, reps=3)
        frame["mrays"] = n_rays / frame["ms"] / 1e3
    frame["launches"] = {k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES}

    total = {k: hk.LAUNCHES[k] - launches0[k] for k in hk.LAUNCHES}
    summed = None
    if cuda:
        parts = ["kernel A", "B rows, round order", "bookkeeping (round_lanes + merge)"]
        summed = sum(phases[p]["ms"] for p in parts + (["supernode rows"] if fat else []))
    _report(label, card, cuda, T, fat, n_rays, cap, n, uniq, max_probes, max_dda, phases,
            rows, summed, frame, total)
    return dict(label=label, T=T, fat=fat, rays=n_rays, cap=cap, lanes=n, uniq=uniq,
                max_probes=max_probes, max_dda=max_dda, phases=phases, rows=rows,
                sum_of_phases_ms=summed, frame=frame, launches=total, outputs=outputs)


def _report(label, card, cuda, T, fat, n_rays, cap, n, uniq, max_probes, max_dda,
            phases, rows, summed, frame, total):
    print(f"[r3 split] {label} T={T} fat={fat}: {n_rays} rays, top rung {cap} blocks "
          f"({n} lanes), P={max_probes}, D={max_dda}, U={uniq} [{card}]", flush=True)
    for name, rec in phases.items():
        if cuda:
            plain = f" == plain ({rec['plain_ms']:.2f} ms)" if "plain_ms" in rec else ""
            if "bound_ms" in rec:
                plain += f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            print(f"[r3 split]   {name:40s} {rec['ms']:9.4f} ms{plain}, launches "
                  f"{ {k: v for k, v in rec['launches'].items() if v} } [{card}]",
                  flush=True)
        else:
            print(f"[r3 split]   {name:40s} == plain", flush=True)
    for order in ("round order", "sorted by row"):
        r = rows[order]
        print(f"[r3 split]   rows a 128-lane block, {order}: {r['mean_distinct']:.2f} "
              f"distinct (max {r['max_distinct']}) over {r['blocks_with_go']} blocks with "
              f"go-lanes; {r['go_lanes']} go-lanes, {r['cached_lanes']} read the cache, "
              f"{r['overflow_lanes']} past U={uniq}; {rows['distinct_rows_round']} "
              "distinct rows in the round", flush=True)
    if cuda:
        stage = phases["row stage fused (hako_dda_merge)"]["ms"]
        parts = (["supernode rows"] if fat else []) + ["B rows, round order"]
        unfused = sum(phases[p]["ms"] for p in parts)
        print(f"[r3 split]   row stage fused {stage:.4f} ms against kernel B's stages "
              f"{unfused:.4f} ms + the merge (in the bookkeeping) [{card}]", flush=True)
        dev_u, dev_f = phases[DEVICE_ROUND_UNFUSED], phases[DEVICE_ROUND_FUSED]
        print(f"[r3 split]   one round on the device (CUDA events on a preset state): "
              f"{dev_u['ms']:.4f} ms unfused (bounds' sum {dev_u['bound_ms']:.4f}), "
              f"{dev_f['ms']:.4f} ms fused (bounds' sum {dev_f['bound_ms']:.4f}), against "
              f"the sum of its phases {summed:.4f} ms; the host's wall of drive(max_rounds"
              f"=1) (level pack, allocation, the nonzero sync, the wrapper calls) "
              f"{phases[HOST_WALL_UNFUSED]['ms']:.4f} ms unfused, "
              f"{phases[HOST_WALL_FUSED]['ms']:.4f} fused [{card}]", flush=True)
        print(f"[r3 split]   full frame {frame['ms']:.3f} ms = {frame['mrays']:.1f} Mrays/s, "
              f"{frame['rounds']} rounds (no cap ladder: every round serves every "
              f"unresolved lane), == plain [{card}]", flush=True)
    else:
        print(f"[r3 split]   full frame: {frame['rounds']} rounds (no cap ladder), == plain",
              flush=True)
    print(f"[r3 split]   launches in all: {total}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=1024, help="grid resolution")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    t0 = time.time()
    tree = treecache.lattice_tree(args.res, device=dev)
    print(f"[r3 split] lattice {args.res}^3: {tree.n_voxels} voxels, {tree.n_bricks} "
          f"bricks, fat={tree.snodes is not None}, loaded in {time.time() - t0:.1f} s",
          flush=True)
    return run(tree, script_camera(tree), args.width, args.height,
               label=f"lattice {args.res}^3", card=card)


if __name__ == "__main__":
    main()
