"""Progressive path-trace viewer, headless (the port of the JAX package's
apps/voxpt.py, the voxPTGPU dev app of voxPTGPU.cpp:11-277): accumulate
16 spp per step on a static frame, save `render_first.png` at exactly
16 spp (the reference's regression artifact) and periodic snapshots, and
print the stats the ImGui panel would show (voxel count, tree bytes,
per-step ms). `--checkpoint` writes the accumulation state after every
step; `--resume` continues from one, bit for bit as if never stopped.

Usage:
  python -m massivevoxelraytracing_torch.apps.voxpt --scene torus --res 256 \
      --width 640 --height 360 --steps 8 --out out/pt
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import EngineConfig
from ..models import scene
from ..models.pathtracer import RAY_PACKET, PathTracer
from ..ops import camera as camera_ops
from ..parallel.build import build_scene_sharded
from ..utils import hdr, meshgen, png, runtime
from .common import add_device_args
from .scenes import load_scene


def main(argv=None) -> PathTracer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="torus")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--steps", type=int, default=8, help="16 spp each")
    ap.add_argument("--six-separating", type=int, default=1)
    ap.add_argument("--dag", type=int, default=1,
                    help="octree DAG dedup (--accel octree)")
    ap.add_argument("--lens-r", type=float, default=0.0)
    ap.add_argument("--hdri", default="procedural",
                    help="'procedural', 'none', or a .hdr path")
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    ap.add_argument("--checkpoint", default=None, help="write checkpoint here")
    ap.add_argument("--ray-packet", type=int, default=RAY_PACKET,
                    help="(pixel x spp) lanes per path-tracer call (default: "
                    "the PathTracer's 2^21; EngineConfig.ray_packet is 65536, "
                    "the same accumulator at many more calls a step)")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler Chrome trace directory (the steps)")
    ap.add_argument("--build-devices", type=int, default=0,
                    help="shard the scene build over N mesh entries of "
                    "--device (parallel/build.py; 0 or 1: the single-device "
                    "build)")
    ap.add_argument("--out", default="out/pt")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg = EngineConfig(
        six_separating=bool(args.six_separating),
        dag=bool(args.dag),
        lens_r=args.lens_r,
        ray_packet=args.ray_packet,
    )

    tri, col, emi = load_scene(args.scene)
    origin, dps = meshgen.fit_grid(tri, args.res)

    sw = runtime.Stopwatch()
    build_kw = dict(
        origin=origin, dps=dps, grid_res=args.res,
        six_separating=cfg.six_separating, dag=cfg.dag, cap=cfg.cap,
        chunk_tris=cfg.chunk_tris, accel=args.accel, device=device,
    )
    if args.build_devices > 1:
        tree = build_scene_sharded(tri, col, emi, n_devices=args.build_devices,
                                   **build_kw)
    else:
        tree = scene.build_scene(tri, col, emi, **build_kw)
    t_build = sw.lap("build", tree)
    print(
        f"[voxpt] res({args.res}) voxels({tree.n_voxels}) nodes({tree.n_nodes}) "
        f"octree({tree.memory_bytes()/1e6:.2f} MB) emissive({tree.has_emission}) "
        f"build {t_build*1e3:.1f} ms"
    )

    pt = PathTracer(
        width=args.width, height=args.height,
        emission_scale=cfg.emission_scale, packet=cfg.ray_packet,
        max_bounces=cfg.max_bounces, n_batch_spp=cfg.n_batch_spp,
        use_pmj=cfg.use_pmj, device=device,
    )
    pt.setup()
    if args.hdri == "procedural":
        env = hdr.procedural_sky(512, 256)
        pt.load_hdri(env, env, scale=cfg.hdri_scale)
    elif args.hdri != "none":
        env = hdr.read_hdr(args.hdri)
        pt.load_hdri(env, env, scale=cfg.hdri_scale)
    pt.update_scene(tree)

    extent = float(dps) * args.res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.55, 1.6]) * extent,
        target=center,
        fovy_deg=cfg.fovy_deg,
        lens_r=cfg.lens_r,
    )

    start_step = 0
    if args.resume:
        pt.load_checkpoint(args.resume)
        start_step = pt.steps
        print(f"[voxpt] resumed at {pt.spp_done} spp")

    with runtime.profile(args.profile):
        for step in range(start_step, args.steps):
            t0 = time.time()
            pt.step(cam)
            runtime.synchronize(pt.accum)
            dt = time.time() - t0
            spp = pt.spp_done
            print(f"[voxpt] step {step}: +{cfg.n_batch_spp} spp -> {spp} spp "
                  f"({dt*1e3:.1f} ms)")
            if spp == 16:
                png.write(os.path.join(args.out, "render_first.png"), pt.resolve())
            if args.snapshot_every and (step + 1) % args.snapshot_every == 0:
                png.write(os.path.join(args.out, f"snapshot_{spp:04d}spp.png"),
                          pt.resolve())
            if args.checkpoint:
                pt.save_checkpoint(args.checkpoint)

    png.write(os.path.join(args.out, "render_final.png"), pt.resolve())
    print(f"[voxpt] {pt.spp_done} spp -> {args.out}/render_final.png")
    return pt


if __name__ == "__main__":
    main()
