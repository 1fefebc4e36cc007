"""Reference-maximum scale demonstration (the port's counterpart of the
JAX package's scripts/scale_shell.py): a 16384^3 grid of terrain voxels --
the reference's headline scale (renderer_introduction.pdf p.8: 16384^3,
654M voxels, 24 GB card) -- built through the streamed builder
(ops/hako_stream.py) from the Morton-cube terrain generator
(utils/shellgen.py), checked against the generator's own count, rendered
once through render_frame and written as a PNG.

Usage:
  python -m massivevoxelraytracing_torch.apps.scale_shell --res 16384 \
      --out out/scale_shell.png
  python -m massivevoxelraytracing_torch.apps.scale_shell --res 256 \
      --width 320 --height 192 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models import raycast
from ..ops import camera as camera_ops
from ..ops import hako_stream
from ..utils import png, runtime, shellgen


def shell_camera(res: int):
    center = np.array([0.5, 0.5, 0.52]) * res
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.55, 0.35, 0.28]) * res,
        target=center - np.array([0.0, 0.0, 0.04]) * res,
        up=(0.0, 0.0, 1.0),  # terrain height runs along z
        fovy_deg=50.0,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=16384, help="grid resolution")
    ap.add_argument("--cube", type=int, default=None,
                    help="generator cube (default min(1024, res / 4))")
    ap.add_argument("--a1", type=float, default=0.07, help="octave 1 amplitude")
    ap.add_argument("--f1", type=float, default=8.0, help="octave 1 frequency")
    ap.add_argument("--a2", type=float, default=0.015, help="octave 2 amplitude")
    ap.add_argument("--f2", type=float, default=27.0, help="octave 2 frequency")
    ap.add_argument("--target", type=float, default=None,
                    help="scale a1 once so the analytic count lands near it")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--color", action="store_true", help="terrain colors")
    ap.add_argument("--park", choices=["host", "device"], default=None,
                    help="where finished brick rows wait (default: device on "
                    "the card, host on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "tensor versions)")
    ap.add_argument("--out", default="out/scale_shell.png")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    res = args.res
    cube = args.cube or min(1024, res // 4)
    park = args.park or ("device" if device.type == "cuda" else "host")

    def make(a1):
        return shellgen.Terrain(res, cube, a1=a1, f1=args.f1, a2=args.a2,
                                f2=args.f2, color=args.color, device=device)

    t0 = time.time()
    a1 = args.a1
    terrain = make(a1)
    total = terrain.total_voxels()
    if args.target:
        # the column overhead past res^2 scales about linearly with the
        # slope (= a1 at a fixed f1 while octave 2 stays put): one
        # proportional step lands within a few percent
        excess = max(total - res * res, 1)
        a1 = a1 * max(args.target - res * res, 1) / excess
        terrain = make(a1)
        total = terrain.total_voxels()
    t_est = time.time() - t0
    print(f"[shell] res={res} cube={cube} a1={a1:.4f} analytic voxels="
          f"{total / 1e6:.1f}M ({t_est:.1f}s column pass)", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    tree = hako_stream.build_hako_stream(terrain.chunks(), res, park=park)
    runtime.synchronize(device)
    build_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    print(f"[shell] voxels={tree.n_voxels / 1e6:.1f}M bricks={tree.n_bricks} "
          f"snodes={tree.n_snodes} levels={tree.n_per_level} T={tree.T} "
          f"mem={tree.memory_bytes() / 1e6:.1f}MB build={build_s:.1f}s "
          f"park={park}", flush=True)
    if tree.n_voxels != total:
        raise AssertionError(f"streamed {tree.n_voxels} voxels, the column "
                             f"pass counted {total}")

    cam = shell_camera(res)

    def frame():
        return raycast.render_frame(tree, cam, args.width, args.height,
                                    show_color=args.color, device=device)

    t0 = time.time()
    img, depth = frame()
    runtime.synchronize(device)
    t_first = time.time() - t0
    iters = 4
    t0 = time.time()
    for _ in range(iters):
        img, depth = frame()
    runtime.synchronize(device)
    dt = (time.time() - t0) / iters
    hit = float((depth < 1e37).float().mean())
    print(f"[shell] frame {args.width}x{args.height}: {dt * 1e3:.1f} ms = "
          f"{args.width * args.height / dt / 1e6:.1f} Mrays/s hit={hit:.2f} "
          f"(first {t_first:.2f}s)", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    png.write(args.out, img.cpu().numpy())
    print(f"[shell] wrote {args.out}", flush=True)
    return dict(tree=tree, cam=cam, n_voxels=tree.n_voxels, analytic=total,
                a1=a1, build_s=build_s, park=park, rows_bytes=tree.memory_bytes(),
                peak_bytes=peak, frame_ms=dt * 1e3, first_frame_s=t_first,
                hit=hit, path=args.out)


if __name__ == "__main__":
    main()
