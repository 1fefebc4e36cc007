#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. build the CUDA kernels from massivevoxelraytracing_torch/csrc;
  2. hold the hako_mega kernel against its plain PyTorch version on the
     card: random-voxel trees at 64^3 and 256^3 (plain top levels) and a
     512^3 tree with supernodes (T = 1, the 1024^3 layout), primary and
     shadow rays; hit mask, nmajor and vrank must be equal, t within
     rtol 3e-7 (bit-exact is expected; the ulp difference is printed);
  3. the main path: build_scene of the bench lattice at 1024^3 and
     1920x1080 frames with the bench camera, then kernel vs plain version
     on 16,384 rays sampled across that frame.

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


def kernel_vs_plain(tree, ro, rd, shadow: bool, what: str, device):
    """Launch the kernel through its wrapper and the plain version
    directly, on the same device tensors. Returns (stats, kernel ms,
    plain ms)."""
    from massivevoxelraytracing_torch.ops import hako_mega

    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    ro_t = torch_from(ro, device).float().contiguous()
    rd_t = torch_from(rd, device).float().contiguous()
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro_t, rd_t)
    kern, k_ms = timed(lambda: hako_mega.intersect_rays_hako_mega(
        *args, T=T, shadow=shadow))
    plain, p_ms = timed(lambda: hako_mega.intersect_rays_hako_mega_plain(
        *args, T=T, shadow=shadow), reps=1, warm=False)
    if int(plain[3].item()) != 0:
        raise AssertionError(f"{what}: plain version left lanes unresolved")
    return compare(kern, plain, what), k_ms, p_ms


def phase_kernel_cases(device, smi: str, rng) -> float:
    """Phase 2. Returns the largest |t_kernel - t_plain|."""
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


def phase_main_path(device, smi: str, rng) -> dict:
    """Phase 3: build the lattice, render frames, then hold the kernel
    against the plain version on rays sampled across the frame."""
    import torch

    from massivevoxelraytracing_torch.models import accel, raycast, scene
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_tpu.utils import meshgen

    grid_res, width, height, frames = GRID, WIDTH, HEIGHT, TIMED_FRAMES
    tri, cols = meshgen.sphere_lattice(6, 4)
    cam = bench_camera()

    hako_mega.reset_counters()
    t0 = time.time()
    tree = scene.build_scene(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel="hako", chunk_tris=262144, device=device,
    )
    build_s = time.time() - t0
    img, depth = raycast.render_frame(tree, cam, width, height, device=device)
    _, frame_ms = timed(lambda: raycast.render_frame(
        tree, cam, width, height, device=device), reps=frames)
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
    st2, k_ms, p_ms = kernel_vs_plain(
        tree, ro[idx].cpu().numpy(), rd[idx].cpu().numpy(), False,
        f"{grid_res}^3 lattice frame sample", device)
    print(f"[phase3] kernel vs plain on {st2['n']} frame rays ({st2['hits']} hits): "
          f"equal, max |dt| {st2['max_abs_err']:.3g}, max ulp {st2['max_ulp']}; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; kernel alone on the full "
          f"frame {frame_kernel_ms:.3f} ms [{smi}]", flush=True)
    return dict(launches=launches, max_abs_err=st2["max_abs_err"], ms=k_ms,
                plain_ms=p_ms, frame_kernel_ms=frame_kernel_ms,
                frame_ms=frame_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from massivevoxelraytracing_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    smi = card()
    rng = np.random.default_rng(SEED)

    t0 = time.time()
    cuda_build.load()
    regs = [ln.strip() for ln in cuda_build.last_build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[phase1] built {os.path.relpath(cuda_build.LIB_PATH)} in "
          f"{time.time() - t0:.1f} s (nvcc {cuda_build.last_build_seconds}) [{smi}]",
          flush=True)
    for ln in regs:
        print(f"[phase1] ptxas: {ln}")

    worst = phase_kernel_cases(device, smi, rng)
    main_path = phase_main_path(device, smi, rng)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "hako_mega",
        "route": "cuda",
        "source": "massivevoxelraytracing_torch/csrc/hako_mega.cu",
        "replaces": "massivevoxelraytracing_tpu/ops/hako_mega.py:471",
        "launches": main_path["launches"],
        "max_abs_err": max(worst, main_path["max_abs_err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "frame_kernel_ms": main_path["frame_kernel_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
