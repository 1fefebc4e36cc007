#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. build the CUDA kernels from massivevoxelraytracing_torch/csrc (one
     nvcc per source, all at once) and the host library (g++);
  2. hold the hako_mega kernel against its plain PyTorch version on the
     card: random-voxel trees at 64^3 and 256^3 (plain top levels) and a
     512^3 tree with supernodes (T = 1, the 1024^3 layout), primary and
     shadow rays; hit mask, nmajor and vrank must be equal, t within
     rtol 3e-7 (bit-exact is expected; the ulp difference is printed);
  2b. the round driver (kernels hako_probe, hako_dda, hako_merge) on the
     same trees: against its plain version and against the megakernel,
     bit for bit;
  3. the main path's primary frame: build_scene of the bench lattice at
     1024^3 and 1920x1080 frames with the bench camera through the
     megakernel, then kernel vs plain version on 16,384 rays sampled
     across that frame;
  3b. the same frame through the round driver: image and depth equal the
     megakernel's; frame time, rounds and launches;
  4. the path tracer: PMJ table build; a warm 16-spp step and 2 timed
     steps at 1024^3 / 1080p through the megakernel (PT Mrays/s counted
     as bench.py does, mean radiance within 1% of the JAX package's
     bench run), a profiled step (device idle share, top device ops),
     one step through the round driver from the same state (accumulator
     bit-equal), and on one packet's full bounce-1 BSDF and NEE batches
     (the inputs the step gives the kernels): each of hako_probe /
     hako_dda / hako_merge against its plain version, round by round, and
     hako_mega against its plain version. Every kernel's time, plain time
     and bound are taken on that BSDF batch.

Prints the card's name and power limit beside every timing, one JSON line
of kernel results, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 7
GRID = 1024
WIDTH, HEIGHT = 1920, 1080
TIMED_FRAMES = 5
SAMPLE_RAYS = 16384
JAX_N_VOXELS = 13_645_209  # the JAX package's build of this scene
TIE_BAND = 0.015           # voxelizer float-tie band (test_parallel_build)
HIT_BAND = (0.62, 0.64)
# mean of accum[:, :3] after 3 16-spp steps, the JAX package's bench run
# of the same scene, camera and sky (BENCH_r05.json); the estimator and
# its samples are the same, so the port's must agree within 1%
JAX_PT_MEAN = 37.1021
PT_MEAN_RTOL = 0.01
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
ROW_BYTES = 164 * 4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 3, warm: bool = True):
    """(result, ms per call) with CUDA events, after one warm call."""
    import torch

    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def timed_each(fn, setup, reps: int = 10) -> float:
    """ms per call of fn(setup()) with CUDA events around each call only
    (setup, e.g. copying a state that fn updates in place, untimed)."""
    import torch

    fn(setup())
    total = 0.0
    for _ in range(reps):
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(args)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def compare(kern, plain, what: str) -> dict:
    """Kernel vs plain outputs: discrete exact, t within rtol 3e-7."""
    tk, nk, vk = (x.cpu().numpy() for x in kern)
    tp, np_, vp = (x.cpu().numpy() for x in plain[:3])
    hk, hp = tk < 1e37, tp < 1e37
    if not np.array_equal(hk, hp):
        raise AssertionError(f"{what}: {int((hk != hp).sum())} hit-mask mismatches")
    if not np.array_equal(nk, np_):
        raise AssertionError(f"{what}: {int((nk != np_).sum())} nmajor mismatches")
    if not np.array_equal(vk, vp):
        raise AssertionError(f"{what}: {int((vk != vp).sum())} vrank mismatches")
    if not np.all(np.isfinite(tk)):
        raise AssertionError(f"{what}: non-finite t")
    err = np.abs(tk[hk] - tp[hk]) if hk.any() else np.zeros(1, np.float32)
    ulp = np.abs(tk[hk].view(np.int32).astype(np.int64)
                 - tp[hk].view(np.int32).astype(np.int64)) if hk.any() else err
    np.testing.assert_allclose(tk[hk], tp[hk], rtol=3e-7, atol=0, err_msg=what)
    return dict(max_abs_err=float(err.max()), max_ulp=int(ulp.max()),
                hits=int(hk.sum()), n=int(hk.size))


def assert_bits_equal(a, b, what: str) -> None:
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: output {i} differs")


def random_tree(grid_res: int, n: int, rng, device, snodes_above=None):
    from massivevoxelraytracing_torch.ops import hako, morton

    c = torch_from(rng.integers(0, grid_res, size=(n, 3)), device)
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    old = hako.USE_SNODES_ABOVE
    if snodes_above is not None:
        hako.USE_SNODES_ABOVE = snodes_above
    try:
        tree = hako.build_hako(codes, grid_res, device=device,
                               dps=1.0 / grid_res)
    finally:
        hako.USE_SNODES_ABOVE = old
    return tree, codes


def torch_from(a, device):
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def mixed_rays(codes, grid_res: int, n: int, rng):
    """Half random rays, half aimed at voxel centers (numpy seed)."""
    from massivevoxelraytracing_torch.ops import morton

    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    pick = codes.cpu()[rng.integers(0, codes.shape[0], n // 2)]
    xyz = np.stack([c.numpy() for c in morton.decode(pick)], -1)
    target = (xyz + 0.5) / grid_res
    rd[: n // 2] = (target - ro[: n // 2]
                    + rng.normal(size=(n // 2, 3)) * 2e-4).astype(np.float32)
    return ro, rd


def tree_args(tree, ro, rd, device):
    from massivevoxelraytracing_torch.ops import hako_mega

    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    ro_t = torch_from(ro, device).float().contiguous()
    rd_t = torch_from(rd, device).float().contiguous()
    return (bricks, snodes, tabs, root, tree.lower, tree.upper, ro_t, rd_t), T


def kernel_vs_plain(tree, ro, rd, shadow: bool, what: str, device):
    """Launch the megakernel through its wrapper and the plain version
    directly, on the same device tensors. Returns (stats, kernel ms,
    plain ms)."""
    from massivevoxelraytracing_torch.ops import hako_mega

    args, T = tree_args(tree, ro, rd, device)
    kern, k_ms = timed(lambda: hako_mega.intersect_rays_hako_mega(
        *args, T=T, shadow=shadow))
    plain, p_ms = timed(lambda: hako_mega.intersect_rays_hako_mega_plain(
        *args, T=T, shadow=shadow), reps=1, warm=False)
    if int(plain[3].item()) != 0:
        raise AssertionError(f"{what}: plain version left lanes unresolved")
    return compare(kern, plain, what), k_ms, p_ms


def rounds_vs_plain(tree, ro, rd, shadow: bool, what: str, device) -> int:
    """The round driver through its kernels, against its plain version and
    against the megakernel, bit for bit. Returns the rounds it took."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega

    args, T = tree_args(tree, ro, rd, device)
    hk.reset_counters()
    got = hk.intersect_rays_hako(*args, T=T, shadow=shadow)
    want = hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow)
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    torch_sync()
    assert_bits_equal(got, want[:3], f"{what}: rounds vs plain")
    assert_bits_equal(got, mega, f"{what}: rounds vs megakernel")
    if hk.unresolved_lanes() or int(want[3].item()):
        raise AssertionError(f"{what}: rounds left lanes unresolved")
    if min(hk.LAUNCHES.values()) < 1:
        raise AssertionError(f"{what}: a round kernel was not launched")
    return hk.ROUNDS


def torch_sync():
    import torch

    torch.cuda.synchronize()


def phase_kernel_cases(device, smi: str, rng) -> float:
    """Phases 2 and 2b. Returns the largest |t_kernel - t_plain|."""
    worst = 0.0
    for grid_res, n_vox in ((64, 1536), (256, 6144), (512, 8000)):
        fat_above = 128 if grid_res == 512 else None
        tree, codes = random_tree(grid_res, n_vox, rng, device, fat_above)
        layout = f"fat T={tree.T}" if tree.snodes is not None else f"plain T={tree.T}"
        ro, rd = mixed_rays(codes, grid_res, 4096, rng)
        for shadow in (False, True):
            what = f"{grid_res}^3 {layout} {'shadow' if shadow else 'primary'}"
            st, k_ms, p_ms = kernel_vs_plain(tree, ro, rd, shadow, what, device)
            worst = max(worst, st["max_abs_err"])
            print(f"[phase2] {what}: equal on {st['n']} rays ({st['hits']} hits), "
                  f"max |dt| {st['max_abs_err']:.3g}, max ulp {st['max_ulp']}; "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms [{smi}]",
                  flush=True)
            rounds = rounds_vs_plain(tree, ro, rd, shadow, what, device)
            print(f"[phase2b] {what}: round driver == plain version == "
                  f"megakernel bit for bit, {rounds} rounds", flush=True)
    return worst


def bench_camera():
    """bench.py's camera for the lattice (origin 0, extent 1)."""
    from massivevoxelraytracing_torch.ops.camera import Camera

    extent = 1.0
    center = np.zeros(3, np.float32) + extent / 2
    return Camera.look_at(
        eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
        target=center, fovy_deg=40.0,
    )


def phase_main_path(device, smi: str, rng):
    """Phase 3: build the lattice, render frames, then hold the kernel
    against the plain version on rays sampled across the frame."""
    import torch

    from massivevoxelraytracing_torch.models import accel, raycast, scene
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.utils import meshgen

    grid_res, width, height, frames = GRID, WIDTH, HEIGHT, TIMED_FRAMES
    tri, cols = meshgen.sphere_lattice(6, 4)
    cam = bench_camera()

    t0 = time.time()
    tree = scene.build_scene(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel="hako", chunk_tris=262144, device=device,
    )
    build_s = time.time() - t0
    img, depth = raycast.render_frame(tree, cam, width, height, device=device)
    _, frame_ms = timed(lambda: raycast.render_frame(
        tree, cam, width, height, device=device), reps=frames)
    hako_mega.reset_counters()
    img, depth = raycast.render_frame(tree, cam, width, height, device=device)
    torch.cuda.synchronize(device)
    launches = hako_mega.LAUNCHES
    unresolved = hako_mega.unresolved_lanes()

    st = tree.build_stats
    n_vox = tree.n_voxels
    d_vox = n_vox - JAX_N_VOXELS
    hit = depth < 1e37
    hit_frac = float(hit.float().mean())
    mrays = width * height / (frame_ms * 1e-3) / 1e6
    print(f"[phase3] lattice {grid_res}^3: {st['n_triangles']} triangles -> "
          f"{st['n_dumped']} dumped -> {n_vox} voxels (JAX build "
          f"{JAX_N_VOXELS}, diff {d_vox:+d} = {d_vox / JAX_N_VOXELS:+.4%}), "
          f"{tree.n_nodes} nodes (JAX build 90128), T={tree.T}, "
          f"fat={tree.snodes is not None}", flush=True)
    print(f"[phase3] build {build_s:.3f} s: split {st['t_split_s']*1e3:.1f} ms, "
          f"count {st['t_count_s']*1e3:.1f} ms, unique {st['t_unique_s']*1e3:.1f} ms, "
          f"accel {st['t_accel_s']*1e3:.1f} ms (first build in this process) [{smi}]",
          flush=True)
    print(f"[phase3] frame {width}x{height}: {frame_ms:.3f} ms = {mrays:.2f} Mrays/s "
          f"(mean of {frames}), hit fraction {hit_frac:.4f}, kernel launches "
          f"{launches}, unresolved lanes {unresolved} [{smi}]", flush=True)

    if tuple(img.shape) != (height, width, 3) or tuple(depth.shape) != (height, width):
        raise AssertionError(f"frame shapes {tuple(img.shape)} {tuple(depth.shape)}")
    if not bool(torch.isfinite(depth[hit]).all()) or bool((depth[hit] <= 0).any()):
        raise AssertionError("hit depths must be finite and positive")
    if launches < 1:
        raise AssertionError("the main path launched no hako_mega kernel")
    if unresolved != 0:
        raise AssertionError(f"{unresolved} lanes unresolved at max_rounds")
    if abs(d_vox) > TIE_BAND * JAX_N_VOXELS:
        raise AssertionError(f"n_voxels {n_vox} outside the tie band")
    if not HIT_BAND[0] <= hit_frac <= HIT_BAND[1]:
        raise AssertionError(f"hit fraction {hit_frac} outside {HIT_BAND}")

    # kernel vs plain on rays sampled across the frame
    ro, rd = raycast._gen_rays_tiled(
        *(torch_from(np.asarray(v, np.float32), device)
          for v in (cam.o, cam.right, cam.up, cam.front)),
        torch_from(np.float32(cam.tan_half_fovy), device),
        width=width, height=height,
    )
    kind, T, meta, root = accel.accel_args(tree)
    _, frame_kernel_ms = timed(lambda: accel.intersect_with(
        kind, T, meta, root, tree.lower, tree.upper, ro, rd), reps=frames)
    idx = np.sort(rng.choice(ro.shape[0], size=SAMPLE_RAYS, replace=False))
    sample = (ro[idx].cpu().numpy(), rd[idx].cpu().numpy())
    st2, k_ms, p_ms = kernel_vs_plain(
        tree, *sample, False, f"{grid_res}^3 lattice frame sample", device)
    print(f"[phase3] kernel vs plain on {st2['n']} frame rays ({st2['hits']} hits): "
          f"equal, max |dt| {st2['max_abs_err']:.3g}, max ulp {st2['max_ulp']}; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; kernel alone on the full "
          f"frame {frame_kernel_ms:.3f} ms [{smi}]", flush=True)
    result = dict(launches=launches, max_abs_err=st2["max_abs_err"],
                  frame_kernel_ms=frame_kernel_ms, frame_ms=frame_ms)
    return tree, cam, img, depth, result


def phase_rounds_frame(tree, cam, img_mega, depth_mega, device, smi: str):
    """Phase 3b: the same 1080p frame through the round driver."""
    import torch

    from massivevoxelraytracing_torch.models import raycast
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    def frame():
        return raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=device,
                                    traversal="rounds")

    frame()
    hk.reset_counters()
    t0 = time.time()
    img, depth = frame()
    torch.cuda.synchronize(device)
    wall_ms = (time.time() - t0) * 1e3
    rounds, launches = hk.ROUNDS, dict(hk.LAUNCHES)
    unresolved = hk.unresolved_lanes()
    _, frame_ms = timed(frame, reps=2, warm=False)
    if not torch.equal(img, img_mega) or not torch.equal(depth, depth_mega):
        raise AssertionError("rounds frame differs from the megakernel frame")
    if unresolved != 0:
        raise AssertionError(f"rounds frame: {unresolved} lanes unresolved")
    if min(launches.values()) < 1:
        raise AssertionError(f"rounds frame launched no kernel of {launches}")
    print(f"[phase3b] rounds frame {WIDTH}x{HEIGHT}: image and depth == megakernel "
          f"bit for bit; {frame_ms:.3f} ms (mean of 2, CUDA events; one counted "
          f"run {wall_ms:.1f} ms host clock), {rounds} rounds, launches {launches}, "
          f"unresolved lanes {unresolved} [{smi}]", flush=True)
    return dict(frame_ms=frame_ms, rounds=rounds, launches=launches)


class Checked:
    """The round driver's three kernels, each launched through its wrapper
    and run as its plain version on the same inputs every round, compared
    (discrete outputs exact, floats bit-equal; max |float diff| kept), and
    continued with the kernel's outputs. Records the first round's inputs
    of each kernel (for timing) and the rows B reads."""

    def __init__(self):
        self.err = {"hako_probe": 0.0, "hako_dda": 0.0, "hako_merge": 0.0}
        self.first = {}
        self.rows = {}

    def _diff(self, name, got, want):
        import torch

        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype.is_floating_point and g.numel():
                self.err[name] = max(self.err[name], float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: output {i} differs from the plain version")

    def probe(self, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        self.first.setdefault("hako_probe", (a, k))
        got = hk.hako_probe(*a, **k)
        self._diff("hako_probe", got, hk.hako_probe_plain(*a, **k))
        return got

    def dda(self, rows, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        self.first.setdefault(("hako_dda", k["leaf"]), ((rows, *a), k))
        got = hk.hako_dda(rows, *a, **k)
        self._diff("hako_dda", got, hk.hako_dda_plain(rows, *a, **k))
        go, child = a[4], a[5]
        self.rows.setdefault(k["leaf"], []).append(child[go].long())
        return got

    def merge(self, state, *a):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        if "hako_merge" not in self.first:
            self.first["hako_merge"] = (tuple(x.clone() for x in state), a)
        want = tuple(x.clone() for x in state)
        hk.hako_merge(state, *a)
        hk.hako_merge_plain(want, *a)
        self._diff("hako_merge", state, want)

    def distinct_rows(self) -> int:
        import torch

        return sum(int(torch.unique(torch.cat(v)).numel())
                   for v in self.rows.values() if v)

    def row_visits(self) -> int:
        return sum(int(x.numel()) for v in self.rows.values() for x in v)


def checked_rounds(tree, ro, rd, shadow: bool, what: str) -> Checked:
    """Run the round loop with Checked kernels and hold its result against
    the megakernel's."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega

    chk = Checked()
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    out = hk.drive((chk.probe, chk.dda, chk.merge), *args, T=T, shadow=shadow,
                   max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
                   max_rounds=hk.default_max_rounds(snodes, T, hk.PROBES,
                                                    hk.DDA_ITERS))
    if int(out[3].item()) != 0:
        raise AssertionError(f"{what}: lanes unresolved")
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    assert_bits_equal(out[:3], mega, f"{what}: checked rounds vs megakernel")
    chk.rounds = out[4]
    return chk


def time_round_kernels(chk: Checked, smi: str, what: str) -> dict:
    """Each kernel on its first-round inputs: ms (CUDA events), plain ms,
    and its bound from these inputs. Bytes: what the kernel reads and
    writes on these inputs, each once, counted by the lanes that take each
    branch (a lane's idx, rays and row are read only where the kernel
    reads them), each distinct row once; operations: a lower bound, the
    ray preamble's ~30 float ops per lane and ~100 per row walked."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    out = {}
    a, k = chk.first["hako_probe"]
    n = int(a[7].shape[0])  # idx
    ms = timed_each(lambda _: hk.hako_probe(*a, **k), lambda: None)
    _, p_ms = timed(lambda: hk.hako_probe_plain(*a, **k), reps=1, warm=False)
    # every lane: in idx 4, ro/rd 24, tq 4; out emit 1, child 4, bt1 12,
    # tqe/tqn 8, exh 1; the level tables once
    lv = 0 if a[0] is None else a[0].numel() * 4
    out["hako_probe"] = dict(ms=ms, plain_ms=p_ms, n=n,
                             bound=bound(n * (32 + 26) + lv, 30 * n))
    a, k = chk.first[("hako_dda", True)]
    n = int(a[4].shape[0])
    go, child = a[5], a[6]
    rows = int(torch.unique(child[go]).numel())
    ms = timed_each(lambda _: hk.hako_dda(*a, **k), lambda: None)
    _, p_ms = timed(lambda: hk.hako_dda_plain(*a, **k), reps=1, warm=False)
    n_go = int(go.sum())
    # every lane: in go 1, tqe 4; out hit 1, t/nmaj/vr/p3/tqp/tqr 24, more 1;
    # go lanes: in idx 4, ro/rd 24, child 4, bt1 12, and their rows
    out["hako_dda"] = dict(ms=ms, plain_ms=p_ms, n=n, rows=rows, n_go=n_go,
                           bound=bound(n * (5 + 26) + n_go * 44
                                       + rows * ROW_BYTES, 130 * n_go))
    state0, a = chk.first["hako_merge"]
    idx, emit, _bt1, _tqn, _exh, hit, _t, _nm, _vr, more, _tqr = a
    n = int(idx.shape[0])
    act = ~state0[0][idx.long()]
    n_act = int(act.sum())
    n_more = int((act & emit & more).sum())
    n_plane = int((act & emit & ~more).sum())
    n_hit = int((act & hit).sum())
    ms = timed_each(lambda s: hk.hako_merge(s, *a),
                    lambda: tuple(x.clone() for x in state0))
    _, p_ms = timed(lambda: hk.hako_merge_plain(
        tuple(x.clone() for x in state0), *a), reps=1, warm=False)
    # every lane: in idx 4, resolved 1; active lanes: in tqn 4, emit/hit/exh
    # 3, out resolved 1, tq 4; emitting lanes: in more 1, then tqr 4 (more)
    # or bt1 12; hit lanes: in t/nmaj/vr 12, out t/nmaj/vrank 12
    out["hako_merge"] = dict(ms=ms, plain_ms=p_ms, n=n, n_hit=n_hit,
                             bound=bound(n * 5 + n_act * 12 + n_more * 5
                                         + n_plane * 13 + n_hit * 24, 3 * n_act))
    for name, v in out.items():
        extra = "".join(f", {v[key]} {label}" for key, label in (
            ("n_go", "go lanes"), ("rows", "distinct rows"), ("n_hit", "hit lanes"))
            if key in v)
        print(f"[phase4] {name} on the first round of {what} ({v['n']} lanes{extra}): "
              f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.2f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}) [{smi}]", flush=True)
    return out


def bench_sky():
    """bench.py's procedural sky (64 x 128)."""
    h, w = 64, 128
    ang = np.linspace(0, np.pi, h)[:, None]
    return np.stack([
        np.broadcast_to(0.6 + 0.4 * np.cos(ang), (h, w)),
        np.broadcast_to(0.7 + 0.3 * np.cos(ang), (h, w)),
        np.broadcast_to(0.9 + 0.1 * np.cos(ang), (h, w)),
    ], -1).astype(np.float32)


def profile_step(pt, cam) -> tuple:
    """One step under torch.profiler: (device busy ms, wall ms, top device
    kernels as (name, ms, calls), hako_mega kernel ms, device kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pt.step(cam)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    busy_us = 0.0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            ms, calls = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + us / 1e3, calls + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    mega_ms = sum(ms for name, (ms, _) in kernels.items() if "hako_mega" in name)
    n_kernels = sum(calls for _ms, calls in kernels.values())
    return busy_us / 1e3, wall_ms, [
        (name[:70], ms, calls) for name, (ms, calls) in top], mega_ms, n_kernels


def phase_pt(tree, cam, device, smi: str) -> dict:
    """Phase 4: the path tracer at 1024^3 / 1080p."""
    import torch

    from massivevoxelraytracing_torch.models import accel, pathtracer
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega, sampling

    t0 = time.time()
    table = sampling.make_pmj_table()
    pmj_s = time.time() - t0
    print(f"[phase4] PMJ table {table.shape} built on the host in {pmj_s * 1e3:.1f} ms",
          flush=True)

    pt = pathtracer.PathTracer(width=WIDTH, height=HEIGHT, device=device)
    pt.pmj_table = torch.from_numpy(table)
    pt.setup()
    pt.load_hdri(bench_sky())
    pt.update_scene(tree)

    # warm step; record the first packet's traversal batches on the way
    calls = []
    real = accel.intersect_with

    def recording(kind, depth, meta, root, lower, upper, ro, rd, *, shadow=False):
        if len(calls) < 1 + 2 * pathtracer.MAX_BOUNCES:
            calls.append((ro, rd, shadow))
        return real(kind, depth, meta, root, lower, upper, ro, rd, shadow=shadow)

    accel.intersect_with = recording
    try:
        t0 = time.time()
        pt.step(cam)
        torch.cuda.synchronize()
        first_s = time.time() - t0
    finally:
        accel.intersect_with = real

    state_spp = pt.spp_done
    state_accum = pt.accum.clone()
    torch.cuda.reset_peak_memory_stats(device)
    hako_mega.reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    pt.step(cam)
    after_one = pt.accum.clone()
    pt.step(cam)
    stop.record()
    torch.cuda.synchronize()
    step_s = start.elapsed_time(stop) / 2 / 1e3
    mega_launches = hako_mega.LAUNCHES // 2
    peak_gb = torch.cuda.max_memory_allocated(device) / 2**30
    n_spp = pt.n_batch_spp
    rays = WIDTH * HEIGHT * n_spp * (1 + 2 * pathtracer.MAX_BOUNCES)
    mrays = rays / step_s / 1e6
    mean = float(pt.accum[:, :3].mean())
    unresolved = hako_mega.unresolved_lanes()
    print(f"[phase4] PT mega {WIDTH}x{HEIGHT} {n_spp} spp: {step_s:.3f} s/step "
          f"(mean of 2, CUDA events; warm step {first_s:.1f} s) = {mrays:.2f} "
          f"PT Mrays/s ({rays} rays/step), {mega_launches} hako_mega launches "
          f"per step, peak memory {peak_gb:.2f} GiB, accum mean {mean:.4f} "
          f"after 3 steps (JAX bench {JAX_PT_MEAN}), unresolved {unresolved} "
          f"[{smi}]", flush=True)
    if not np.isfinite(mean) or abs(mean / JAX_PT_MEAN - 1.0) > PT_MEAN_RTOL:
        raise AssertionError(f"PT mean radiance {mean} outside {PT_MEAN_RTOL:.0%} "
                             f"of {JAX_PT_MEAN}")
    if not bool(torch.isfinite(pt.accum).all()):
        raise AssertionError("non-finite radiance")
    if mega_launches < 1 or unresolved:
        raise AssertionError("PT mega step: no launch or unresolved lanes")

    busy_ms, wall_ms, top, mega_ms, n_kernels = profile_step(pt, cam)
    print(f"[phase4] profiled mega step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms in {n_kernels} device kernels, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, hako_mega kernels {mega_ms:.1f} ms; "
          f"top device kernels: [{smi}]", flush=True)
    for name, ms, count in top:
        print(f"[phase4]   {ms:9.2f} ms  {count:6d} calls  {name}", flush=True)

    # one step through the round driver from the state after the warm step
    rpt = pathtracer.PathTracer(width=WIDTH, height=HEIGHT, device=device,
                                traversal="rounds")
    rpt.pmj_table = pt.pmj_table
    rpt.env = pt.env
    rpt.update_scene(tree)
    rpt.accum = state_accum
    rpt.spp_done = state_spp
    hk.reset_counters()
    t0 = time.time()
    rpt.step(cam)
    torch.cuda.synchronize()
    rounds_s = time.time() - t0
    launches = dict(hk.LAUNCHES)
    rounds = hk.ROUNDS
    if not torch.equal(rpt.accum, after_one):
        d = (rpt.accum - after_one).abs()
        raise AssertionError(f"rounds PT step differs from the megakernel's: "
                             f"{int((d > 0).sum())} values, max {float(d.max())}")
    if hk.unresolved_lanes() or min(launches.values()) < 1:
        raise AssertionError(f"rounds PT step: unresolved lanes or no launch {launches}")
    n = WIDTH * HEIGHT
    pix_packet = max(min(pt.packet // (n_spp * 2), 1 << (n - 1).bit_length()), 1024)
    calls_per_step = (pt._pixel_perm(pix_packet)[2] // pix_packet
                      * (1 + 2 * pathtracer.MAX_BOUNCES))
    print(f"[phase4] PT rounds step: accumulator == megakernel step bit for bit; "
          f"{rounds_s:.2f} s (host clock), {rounds} rounds over {calls_per_step} "
          f"traversal calls, launches {launches} [{smi}]", flush=True)

    # every kernel vs its plain version on the first packet's full bounce-1
    # BSDF and NEE batches, the inputs the step gives them; the BSDF batch
    # is also the one each kernel is timed on
    (ro_b, rd_b, sb), (ro_s, rd_s, ss) = calls[3], calls[4]
    if sb or not ss:
        raise AssertionError("recorded batches are not BSDF then NEE")
    err = {"hako_mega": 0.0, "hako_probe": 0.0, "hako_dda": 0.0, "hako_merge": 0.0}
    for ro, rd, shadow, name in ((ro_b, rd_b, False, "BSDF"), (ro_s, rd_s, True, "NEE")):
        what = f"bounce-1 {name} batch"
        chk = checked_rounds(tree, ro, rd, shadow, what)
        st, k_ms, p_ms = kernel_vs_plain(tree, ro, rd, shadow, what, device)
        for k, v in chk.err.items():
            err[k] = max(err[k], v)
        err["hako_mega"] = max(err["hako_mega"], st["max_abs_err"])
        print(f"[phase4] {what} ({st['n']} lanes, {st['hits']} hits): "
              f"hako_probe / hako_dda / hako_merge == plain versions round by round "
              f"over {chk.rounds} rounds, max |diff| {chk.err}; hako_mega == plain "
              f"version, max |dt| {st['max_abs_err']:.3g}, max ulp {st['max_ulp']}; "
              f"hako_mega {k_ms:.3f} ms, plain {p_ms:.1f} ms [{smi}]", flush=True)
        if not shadow:
            timing = time_round_kernels(chk, smi, f"one packet's {what}")
            timing["hako_mega"] = dict(ms=k_ms, plain_ms=p_ms,
                                       bound=mega_bound(tree, chk, st["n"]))
    return dict(step_s=step_s, mrays=mrays, mean=mean, peak_gb=peak_gb,
                mega_launches=mega_launches, rounds_launches=launches,
                rounds=rounds, rounds_s=rounds_s, timing=timing, err=err,
                busy_ms=busy_ms, wall_ms=wall_ms, mega_ms=mega_ms)


def mega_bound(tree, chk: Checked, n: int) -> tuple:
    """hako_mega's bound on n rays: rays in (24 B), results out (12 B),
    every distinct row the traversal reads (from the checked round driver
    run `chk` on the same rays; both routes walk the same rows), the level
    tables."""
    lv = sum(t.numel() * 4 for t in tree.levels)
    return bound(n * 36 + chk.distinct_rows() * ROW_BYTES + lv,
                 30 * n + 100 * chk.row_visits())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from massivevoxelraytracing_torch.utils import cuda_build, host_build

    device = torch.device("cuda", 0)
    smi = card()
    rng = np.random.default_rng(SEED)

    t0 = time.time()
    cuda_build.load()
    regs = [ln.strip() for ln in cuda_build.last_build_log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    host_build.load()
    print(f"[phase1] built {os.path.relpath(cuda_build.LIB_PATH)} and "
          f"{os.path.relpath(host_build.LIB_PATH)} in {time.time() - t0:.1f} s "
          f"(nvcc {cuda_build.last_build_seconds}, g++ "
          f"{host_build.last_build_seconds}) [{smi}]", flush=True)
    for ln in regs:
        print(f"[phase1] ptxas: {ln}")

    worst = phase_kernel_cases(device, smi, rng)
    tree, cam, img, depth, main_path = phase_main_path(device, smi, rng)
    rframe = phase_rounds_frame(tree, cam, img, depth, device, smi)
    pt = phase_pt(tree, cam, device, smi)

    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "jaxlib", "massivevoxelraytracing_tpu")]
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    src = "massivevoxelraytracing_torch/csrc/"
    ref = "massivevoxelraytracing_tpu/ops/"
    table = [("hako_mega", "hako_mega.cu", "hako_mega.py:471",
              pt["mega_launches"], main_path["launches"])]
    for name, replaces in (("hako_probe", "hako_kernels.py:1218,1681"),
                           ("hako_dda", "hako_kernels.py:1252,1700"),
                           ("hako_merge", "hako_kernels.py:1735")):
        table.append((name, "hako_rounds.cu", replaces,
                      pt["rounds_launches"][name], rframe["launches"][name]))
    # ms, plain_ms, bound and the PT part of max_abs_err come from the same
    # inputs (the bounce-1 batches); max_abs_err also covers phases 2-3
    earlier_err = {"hako_mega": max(worst, main_path["max_abs_err"])}
    kernels = []
    for name, source, replaces, launches, frame_launches in table:
        tm = pt["timing"][name]
        kernels.append(dict(
            name=name, route="cuda", source=src + source, replaces=ref + replaces,
            launches=launches,
            max_abs_err=max(earlier_err.get(name, 0.0), pt["err"][name]),
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1], library_ms=None,
            frame_launches=frame_launches,
        ))
    kernels[0]["frame_kernel_ms"] = main_path["frame_kernel_ms"]
    print(json.dumps({"kernels": kernels, "pt": {
        "s_per_step": pt["step_s"], "mrays": pt["mrays"], "mean": pt["mean"],
        "peak_gib": pt["peak_gb"], "rounds_step_s": pt["rounds_s"],
        "rounds_per_step": pt["rounds"], "device_busy_ms": pt["busy_ms"],
        "device_mega_ms": pt["mega_ms"], "profiled_wall_ms": pt["wall_ms"]}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
