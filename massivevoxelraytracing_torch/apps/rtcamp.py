"""Headless batch path-trace renderer, the RTCamp contest binary (the port
of the JAX package's apps/rtcamp.py; RTCamp.cpp:25-210): frames
[begin, end), each re-voxelized and rebuilt at an animated grid resolution
(dps lerped from boxWide/fromRes to boxWide/toRes, the grid rounded up to
a power of two), N path-trace steps of 16 spp each, the next frame's scene
decoded while the device renders, PNGs written by a background thread,
and a per-frame stats line with the build's phase split.

Frame-range partitioning across machines is the --frame-range flag
(apps/launch_frames.py runs one process per range).

Usage:
  python -m massivevoxelraytracing_torch.apps.rtcamp --frame-range 0 8 \
      --frames 24 --width 480 --height 300 --steps 2 --out out/anim
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
import time

import numpy as np
import torch

from ..models import scene
from ..models.pathtracer import PathTracer
from ..ops import camera as camera_ops
from ..parallel.build import build_scene_sharded
from ..utils import hdr, meshgen, png, runtime
from .common import add_device_args
from .scenes import animated_scene


def next_power_of_two(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class PngWriter:
    """Background PNG writer (RTCamp.cpp:173-193's thread pool) with a
    bounded queue. A failed write is kept: the thread drops the rest of
    the queue, so `put` never blocks on it, and the caller's next `put`
    or `close` raises it."""

    def __init__(self, maxsize: int = 4):
        self._q: "queue.Queue[tuple[str, np.ndarray] | None]" = queue.Queue(maxsize)
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is None:
                try:
                    png.write(*item)
                except BaseException as e:  # kept for the caller
                    self._error = e

    def _raise(self):
        if self._error is not None:
            raise RuntimeError("the PNG writer failed") from self._error

    def put(self, path: str, img: np.ndarray) -> None:
        self._raise()
        self._q.put((path, img))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._raise()


def main(argv=None) -> list:
    """Renders the frames; returns one record a frame (frame, grid_res,
    origin, dps, cam, update_s, render_s, build_stats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frame-range", nargs=2, type=int, default=None,
                    metavar=("BEGIN", "END"))
    ap.add_argument("--frames", type=int, default=24, help="total frames")
    ap.add_argument("--scene", default="torus")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--steps", type=int, default=2,
                    help="PT steps per frame (16 spp each; reference uses 8)")
    ap.add_argument("--from-res", type=int, default=128)
    ap.add_argument("--to-res", type=int, default=256)
    ap.add_argument("--lens-r", type=float, default=0.0)
    ap.add_argument("--hdri", default="procedural",
                    help="'procedural', 'none', or a .hdr path")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler Chrome trace directory (the frames)")
    ap.add_argument("--build-devices", type=int, default=0,
                    help="shard the per-frame scene build over N mesh "
                    "entries of --device (parallel/build.py; 0 or 1: the "
                    "single-device build)")
    ap.add_argument("--out", default="out/anim")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    begin, end = args.frame_range or (0, args.frames)
    os.makedirs(args.out, exist_ok=True)
    writer = PngWriter(maxsize=4)

    pt = PathTracer(width=args.width, height=args.height, device=device)
    pt.setup()
    if args.hdri == "procedural":
        env = hdr.procedural_sky(512, 256)
        pt.load_hdri(env, env)
    elif args.hdri != "none":
        env = hdr.read_hdr(args.hdri)
        pt.load_hdri(env, env)

    # decode the first frame (loadSceneFrame(beginFrame))
    tri, col, emi = animated_scene(args.scene, begin, args.frames)

    records = []
    sw_total = time.time()
    with runtime.profile(args.profile):
        for frame in range(begin, end):
            # animated resolution sweep (RTCamp.cpp:140-142)
            lo, hi = meshgen.mesh_bounds(tri)
            box_wide = float((hi - lo).max()) * 1.02
            mix = frame / max(args.frames, 1)
            dps = (box_wide / args.from_res) * (1 - mix) + (box_wide / args.to_res) * mix
            grid_res = next_power_of_two(int(np.ceil(box_wide / dps)))
            origin = (lo + hi) * 0.5 - grid_res * dps * 0.5

            t0 = time.time()
            build_kw = dict(origin=origin, dps=dps, grid_res=grid_res,
                            accel=args.accel, device=device)
            if args.build_devices > 1:
                tree = build_scene_sharded(
                    tri, col, emi, n_devices=args.build_devices, **build_kw)
            else:
                tree = scene.build_scene(tri, col, emi, **build_kw)
            # (both end with a device sync)
            t_update = time.time() - t0

            center = origin + grid_res * dps * 0.5
            cam = camera_ops.Camera.look_at(
                eye=center + np.array([0.9, 0.5, 1.6]) * box_wide,
                target=center,
                fovy_deg=40.0,
                lens_r=args.lens_r,
            )

            t0 = time.time()
            pt.update_scene(tree)
            pt.clear_frame_buffer()
            for _ in range(args.steps):
                pt.step(cam)

            # decode the NEXT frame while the device renders (RTCamp.cpp:161)
            if frame + 1 < end:
                tri, col, emi = animated_scene(args.scene, frame + 1, args.frames)

            img = pt.resolve()
            t_render = time.time() - t0

            writer.put(os.path.join(args.out, f"{frame:03d}.png"), img)
            # the reference's per-frame stats line (RTCamp.cpp:144-152) plus
            # the build's phase split
            st = tree.build_stats
            print(
                f"[frame {frame}] res( {grid_res} ) total( {time.time()-sw_total:.1f} s ) "
                f"/ update {t_update:.3f} / render {t_render:.3f}"
                f" [split {st['t_split_s']:.2f} count {st['t_count_s']:.2f}"
                f" unique {st['t_unique_s']:.2f} accel {st['t_accel_s']:.2f}"
                f" vox {st['n_unique']/1e6:.1f}M]",
                flush=True,
            )
            records.append(dict(frame=frame, grid_res=grid_res, origin=origin,
                                dps=dps, cam=cam, update_s=t_update,
                                render_s=t_render, build_stats=st))

    writer.close()
    print(f"[rtcamp] {end - begin} frames -> {args.out}")
    return records


if __name__ == "__main__":
    main()
