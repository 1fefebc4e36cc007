"""The round route's phases timed apart, and the full frame's rounds, at
the JAX package's scripts/hako_phase_timing.py scene: bumpy_sphere(5,
radius 0.9) at --res (default 256) under the script's camera, 1920x1088
rays in the port's tile order, padded as the renderer pads a packet.

    python -m massivevoxelraytracing_torch.scripts.hako_phase_timing --res 1024
    python -m massivevoxelraytracing_torch.scripts.hako_phase_timing --device cpu --res 32 --width 64 --height 64

Phases, each on the first cap = nb // 4 blocks of 2048 rays (nb: the
frame's blocks), each kernel's outputs held bit for bit against its plain
version, then timed with CUDA events beside its bound on these inputs
(scripts/common.probe_bound, dda_bound, merge_bound):
  * hako_probe (the reference's kernel A) from the root;
  * hako_dda over the supernode rows, on a fat tree (T stages above the
    bricks, grid above hako.USE_SNODES_ABOVE);
  * hako_dda over the brick rows (kernel B, leaf, not shadow);
  * hako_merge into a fresh round state;
  * hako_dda_merge, the route's row stage (the supernode rows, the
    handoff, the brick rows and the merge in one launch), into a fresh
    round state;
  * the driver's per-round host work without kernels
    (hako_kernels.round_lanes, the nonzero sync; supernode_handoff, the
    wheres of a fat round), host clock;
  * one round's wall on the host clock, from a synced start to a synced
    end (round_lanes, kernel A and the row stage on a fresh round state),
    with the unfused stage (kernel B and the merge apart, the hand-off
    between) and with the fused one.
Then the full frame through intersect_rays_hako (on the card the round
loop in one launch of hako_rounds), through the two-launch driver (drive
with hako_probe and the fused stage) and through the driver with the
unfused stage: their wall times, rounds and launches (counted as
differences, so a caller's counts run on), each result against
intersect_rays_hako_plain, and the wall of one run of each under
torch.profiler split into the round kernels' device time, the other
device ops' (the driver's nonzero, wheres, stacks) and the rest, where
the device waits on the host: from a trace that holds every round kernel
launch (common.profile_counted), else "not measured" (late in a long
process the profiler drops device events: scripts/profile_window.py).

The reference's XLA brick-row gather (its :121) has no counterpart:
hako_dda reads the rows itself, so that time is inside hako_dda's. Its
SCANI / GATHI knobs choose TPU forms and are not ported. --device cpu
runs the plain versions and prints no time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import raycast, scene
from ..ops import hako_kernels as hk
from ..ops import hako_mega
from ..utils import meshgen
from . import common

RB = 2048  # rays a block of the reference's round kernels (16 x 128)
MAX_RAY_PACKET = 1 << 21


def packet_for(n: int) -> int:
    """The renderer's packet for a frame of n rays (a power of two, 8,192
    to 2,097,152)."""
    return min(MAX_RAY_PACKET, max(1 << max(n - 1, 0).bit_length(), 8192))


def bumpy_scene(grid_res: int, device):
    """The reference script's tree and camera."""
    tri = meshgen.bumpy_sphere(5, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    tree = scene.build_scene(tri, origin=origin, dps=dps, grid_res=grid_res,
                             accel="hako", device=device)
    return tree, common.script_camera(origin, float(dps) * grid_res)


def frame_rays(cam, width: int, height: int):
    """(ro, rd) f32 [R, 3] numpy: the frame's rays in tile order, padded to
    the packet with rays parked at 1e9 (the reference script's formula)."""
    n = width * height
    packet = packet_for(n)
    idx = np.full(-(-n // packet) * packet, -1, np.int64)
    idx[:n] = raycast.tile_order(width, height)
    live = idx >= 0
    safe = np.maximum(idx, 0)
    px = (safe % width).astype(np.float32)
    py = (safe // width).astype(np.float32)
    th = cam.tan_half_fovy
    u = (-th + 2.0 * th * (px + 0.5) / width) * (width / height)
    v = th - 2.0 * th * (py + 0.5) / height
    rd = (u[:, None] * np.asarray(cam.right) + v[:, None] * np.asarray(cam.up)
          + np.asarray(cam.front)).astype(np.float32)
    ro = np.where(live[:, None], np.asarray(cam.o)[None, :], 1e9).astype(np.float32)
    return ro, rd


def _fresh_state(n: int, device):
    return (torch.zeros(n, dtype=torch.bool, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.full((n,), hk.MAX_FLOAT, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device))


def _equal(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")


def _launched_since(before: dict) -> dict:
    """The round kernels' launches since the snapshot `before` of
    hako_kernels.LAUNCHES."""
    return {k: hk.LAUNCHES[k] - before[k] for k in hk.LAUNCHES}


def _profiled(fn) -> dict:
    """fn() under torch.profiler (CUPTI device times), from a trace that
    holds each round kernel launch the wrappers counted
    (common.profile_counted): split_wall_ms, kernels_ms (the round
    kernels'), other_device_ms, host_ms (the rest, where the device waits)
    and device_events; or not_measured (the reason) where no try gave a
    whole trace (late in a long process: scripts/profile_window.py)."""
    try:
        r = common.profile_counted(fn, hk.LAUNCHES)
    except AssertionError as e:
        return dict(not_measured=str(e))
    kernels = sum(ms for ms, _calls in r["named"].values())
    return dict(split_wall_ms=r["wall_ms"], kernels_ms=kernels,
                other_device_ms=r["busy_ms"] - kernels,
                host_ms=r["wall_ms"] - r["busy_ms"], device_events=r["kernels"])


def run(tree, cam, width: int, height: int, *, max_probes: int = hk.PROBES,
        max_dda: int = hk.DDA_ITERS, label: str = "", card: str = "") -> dict:
    """The phases and the full frame of one tree and camera. Returns their
    times (None on the CPU), the round count and launches, and each
    phase's outputs (under "outputs")."""
    dev = tree.device
    cuda = dev.type == "cuda"
    ro_np, rd_np = frame_rays(cam, width, height)
    ro = torch.from_numpy(ro_np).to(dev)
    rd = torch.from_numpy(rd_np).to(dev)
    n_rays = ro.shape[0]
    cap = max(n_rays // RB // 4, 1)
    n = min(cap * RB, n_rays)
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    fat = snodes is not None
    levels, level_off = hk.level_pack(tabs)
    bounds = torch.cat([tree.lower, tree.upper]).to(device=dev, dtype=torch.float32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    rays = (bounds, ro, rd)
    phases, outputs = {}, {}

    launches0 = dict(hk.LAUNCHES)

    def phase(name, kernel, plain, bound, setup=None):
        """kernel(x) / plain(x) of x = setup() (untimed), or of nothing;
        records the phase's kernel launches (its check and its timing) and
        its bound(), a function of its outputs."""
        prep = setup or (lambda: None)
        k_fn, p_fn = ((kernel, plain) if setup else
                      (lambda _: kernel(), lambda _: plain()))
        before = dict(hk.LAUNCHES)
        got = k_fn(prep())
        _equal(name, got, p_fn(prep()))
        outputs[name] = got
        rec = phases[name] = {}
        if cuda:
            rec["ms"] = common.event_ms_each(k_fn, prep)
            rec["plain_ms"] = common.event_ms_each(p_fn, prep, reps=1)
            rec["bound_ms"], rec["bound_by"] = bound(got)
        rec["launches"] = _launched_since(before)
        return got

    state0 = _fresh_state(n_rays, dev)
    a = (levels, level_off, T, root, *rays, idx, state0[1])
    emit, child, bt1, tqe, tqn, exh = phase(
        "hako_probe", lambda: hk.hako_probe(*a, max_probes=max_probes),
        lambda: hk.hako_probe_plain(*a, max_probes=max_probes),
        lambda _: common.probe_bound(n, 0 if levels is None else levels.numel()))
    dda_kw = dict(shadow=False, max_iters=max_dda)
    if fat:
        s = (snodes, *rays, idx, emit, child, bt1, tqe)
        sn = phase("hako_dda supernodes",
                   lambda: hk.hako_dda(*s, dt_factor=0.25 ** T, leaf=False, **dda_kw),
                   lambda: hk.hako_dda_plain(*s, dt_factor=0.25 ** T, leaf=False,
                                             **dda_kw),
                   lambda _, e=emit, c=child: common.dda_bound(n, *common.dda_counts(e, c)))
        emit, child, bt1, tqe, tqn = hk.supernode_handoff(emit, bt1, tqn, sn)
    leaf_f = 0.25 ** (T + 2 if fat else T)
    b = (bricks, *rays, idx, emit, child, bt1, tqe)
    hit, t_hit, nmaj, vr, _p3, _tqp, more, tqr = phase(
        "hako_dda leaf", lambda: hk.hako_dda(*b, dt_factor=leaf_f, leaf=True, **dda_kw),
        lambda: hk.hako_dda_plain(*b, dt_factor=leaf_f, leaf=True, **dda_kw),
        lambda _: common.dda_bound(n, *common.dda_counts(emit, child)))
    m = (idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr, more, tqr)

    def merged(fn):
        def call(state):
            fn(state, *m)
            return state
        return call

    phase("hako_merge", merged(hk.hako_merge), merged(hk.hako_merge_plain),
          lambda _: common.merge_bound(*common.merge_counts(state0, idx, emit, hit, more)),
          setup=lambda: tuple(x.clone() for x in state0))
    a_out = outputs["hako_probe"]

    def staged(stage):
        def call(state):
            stage(state, bricks, snodes, *rays, idx, *a_out, T=T, shadow=False,
                  max_iters=max_dda)
            return state
        return call

    walks = ([(a_out[0], a_out[1])] if fat else []) + [(emit, child)]
    phase("hako_dda_merge", staged(hk.hako_dda_merge), staged(hk.hako_dda_merge_plain),
          lambda _: common.dda_merge_bound(*common.dda_merge_counts(
              state0, idx, a_out[0], walks, hit)),
          setup=lambda: tuple(x.clone() for x in state0))

    stages = {"unfused": hk.unfused_stage(hk.hako_dda, hk.hako_merge),
              "fused": hk.hako_dda_merge}
    host, round_wall = None, {}
    if cuda:
        reps = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            hk.round_lanes(state0)
            if fat:
                hk.supernode_handoff(a_out[0], a_out[2], a_out[4], sn)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / reps * 1e3
        one = _fresh_state(n_rays, dev)
        one[0][n:] = True  # the quarter's lanes alone
        for name, stage in stages.items():
            total = 0.0
            for _ in range(reps):
                st = tuple(x.clone() for x in one)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lanes = hk.round_lanes(st)
                stage(st, bricks, snodes, *rays, lanes,
                      *hk.hako_probe(levels, level_off, T, root, *rays, lanes, st[1],
                                     max_probes=max_probes),
                      T=T, shadow=False, max_iters=max_dda)
                torch.cuda.synchronize()
                total += time.perf_counter() - t0
            round_wall[name] = total / reps * 1e3

    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    kw = dict(T=T, max_probes=max_probes, max_dda=max_dda)
    dkw = dict(T=T, shadow=False, max_probes=max_probes, max_dda=max_dda,
               max_rounds=hk.default_max_rounds(snodes, T, max_probes, max_dda))
    before, rounds0, unresolved0 = dict(hk.LAUNCHES), hk.rounds_run(), hk.unresolved_lanes()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = hk.intersect_rays_hako(*args, **kw)
    if cuda:
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rounds, launches = hk.rounds_run() - rounds0, _launched_since(before)
    unresolved = hk.unresolved_lanes() - unresolved0
    want = hk.intersect_rays_hako_plain(*args, **kw)
    _equal("full frame", got, want[:3])
    if unresolved or int(want[3].item()) or rounds != want[4]:
        raise AssertionError(f"full frame: {unresolved} lanes unresolved, {rounds} rounds "
                             f"against the plain driver's {want[4]}")
    outputs["frame"] = got
    frame = dict(rays=n_rays, rounds=rounds, launches=launches)
    drivers = {"two_launch": (hk.hako_probe, stages["fused"]),
               "unfused": (hk.hako_probe, stages["unfused"])}
    for name, kernels in drivers.items():
        before = dict(hk.LAUNCHES)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        old = hk.drive(kernels, *args, **dkw)
        if cuda:
            torch.cuda.synchronize()
        frame[name] = dict(launches=_launched_since(before),
                           wall_ms=(time.perf_counter() - t0) * 1e3)
        _equal(f"full frame, {name} driver", old[:3], want[:3])
        if int(old[3].item()) or old[4] != rounds:
            raise AssertionError(f"full frame, {name} driver: lanes unresolved or other "
                                 f"rounds")
    if cuda:
        frame.update(wall_ms=wall, mrays=n_rays / wall / 1e3,
                     **_profiled(lambda: hk.intersect_rays_hako(*args, **kw)))
        for name, kernels in drivers.items():
            frame[name].update(_profiled(lambda k=kernels: hk.drive(k, *args, **dkw)))

    total = _launched_since(launches0)
    print(f"[phase timing] {label} T={T} fat={fat}: {n_rays} rays, {cap} blocks "
          f"({n} rays) a phase, P={max_probes}, D={max_dda} [{card}]", flush=True)
    for name, rec in phases.items():
        if cuda:
            print(f"[phase timing]   {name:20s} {rec['ms']:9.4f} ms == plain "
                  f"({rec['plain_ms']:.2f} ms), bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}), launches {rec['launches']} [{card}]", flush=True)
        else:
            print(f"[phase timing]   {name:20s} == plain, launches {rec['launches']}",
                  flush=True)
    if cuda:
        print(f"[phase timing]   host round work    {host:9.4f} ms (nonzero sync"
              f"{' + supernode wheres' if fat else ''}; host clock) [{card}]", flush=True)
        print(f"[phase timing]   one round's wall (host clock, synced): unfused "
              f"{round_wall['unfused']:.4f} ms, fused {round_wall['fused']:.4f} ms [{card}]",
              flush=True)
        for name, rec in (("hako_rounds", frame), ("two-launch", frame["two_launch"]),
                          ("unfused-stage", frame["unfused"])):
            split = (f"profiled run: not measured ({rec['not_measured']})"
                     if "not_measured" in rec else
                     f"profiled run ({rec['device_events']} device events recorded) "
                     f"{rec['split_wall_ms']:.3f} ms = round kernels {rec['kernels_ms']:.3f} "
                     f"ms + other device ops {rec['other_device_ms']:.3f} ms (device times) "
                     f"+ device idle (the host loop) {rec['host_ms']:.3f} ms")
            print(f"[phase timing]   full frame, {name} driver: {rec['wall_ms']:.3f} ms, "
                  f"{rounds} rounds, launches {rec['launches']}, == plain; {split} [{card}]",
                  flush=True)
    else:
        print(f"[phase timing]   full frame: {rounds} rounds, launches {launches} (two-launch "
              f"{frame['two_launch']['launches']}, unfused {frame['unfused']['launches']}), "
              f"== plain", flush=True)
    print(f"[phase timing]   launches in all (phases, frame{', profiled frame' if cuda else ''}"
          f"): {total}", flush=True)
    return dict(label=label, T=T, fat=fat, rays=n_rays, cap=cap, lanes=n,
                max_probes=max_probes, max_dda=max_dda, phases=phases,
                host_round_ms=host, round_wall_ms=round_wall, frame=frame, launches=total,
                outputs=outputs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=256, help="grid resolution")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--max-probes", type=int, default=hk.PROBES,
                    help="root descents a round (the driver's max_probes)")
    ap.add_argument("--max-dda", type=int, default=hk.DDA_ITERS,
                    help="sub-brick visits a stage and round (the driver's max_dda)")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    tree, cam = bumpy_scene(args.res, dev)
    return run(tree, cam, args.width, args.height, max_probes=args.max_probes,
               max_dda=args.max_dda, label=f"bumpy_sphere {args.res}^3", card=card)


if __name__ == "__main__":
    main()
