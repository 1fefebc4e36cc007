"""Headless ray-cast lab (the port of the JAX package's apps/voxrt.py, the
voxRT / voxRTGPU apps of voxRT.cpp:59-428): voxelize a scene, build the
acceleration structure (`--accel`: the HakoTree by default, the brick
tree, or the SVO/DAG with `--dag`), render primary rays through it with
normal or voxel-color shading, and write `voxrt.png`. `--wire` burns a
depth-tested voxel wireframe into `voxrt_wire.png`; `--oracle` A/B's the
frame's depth against the brute-force slab intersector over the oracle's
own voxels (models/cpu_oracle.py) and fails when more than 2% of the
pixels disagree.

Usage:
  python -m massivevoxelraytracing_torch.apps.voxrt --scene torus --res 256 \
      --width 640 --height 360 --mode color --out out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import cpu_oracle, raycast, scene
from ..ops import camera as camera_ops
from ..utils import meshgen, png, runtime
from .common import add_device_args
from .scenes import load_scene


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="torus",
                    help="torus|sphere|bumpy|soup or a path to .obj/.ply")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--mode", choices=["normal", "color"], default="normal")
    ap.add_argument("--six-separating", type=int, default=1)
    ap.add_argument("--dag", type=int, default=1,
                    help="octree DAG dedup (--accel octree)")
    ap.add_argument("--wire", action="store_true",
                    help="burn a depth-tested voxel wireframe overlay into "
                    "voxrt_wire.png (drawVoxelsWire equivalent)")
    ap.add_argument("--wire-max", type=int, default=4096,
                    help="max voxels drawn by --wire")
    ap.add_argument("--oracle-pixels", type=int, default=2048,
                    help="pixels A/B'd by --oracle (full frame if smaller)")
    ap.add_argument("--oracle", action="store_true",
                    help="A/B against the brute-force intersector")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler Chrome trace directory (the render)")
    ap.add_argument("--out", default="out")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    os.makedirs(args.out, exist_ok=True)
    tri, colors, emissions = load_scene(args.scene)
    origin, dps = meshgen.fit_grid(tri, args.res)

    sw = runtime.Stopwatch()
    tree = scene.build_scene(
        tri, colors, emissions, origin=origin, dps=dps, grid_res=args.res,
        six_separating=bool(args.six_separating), dag=bool(args.dag),
        accel=args.accel, device=device,
    )
    t_build = sw.lap("build", tree)

    lo = np.asarray(origin)
    extent = float(dps) * args.res
    center = lo + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.55, 1.6]) * extent,
        target=center,
        fovy_deg=40.0,
    )
    with runtime.profile(args.profile):
        img_t, depth_t = raycast.render_frame(
            tree, cam, args.width, args.height,
            show_color=(args.mode == "color"), device=device)
        t_render = sw.lap("render", depth_t)
    img = img_t.cpu().numpy()
    depth = depth_t.cpu().numpy()

    out_path = os.path.join(args.out, "voxrt.png")
    png.write(out_path, img)
    print(
        f"[voxrt] res({args.res}) voxels({tree.n_voxels}) nodes({tree.n_nodes}) "
        f"octree({tree.memory_bytes()/1e6:.1f} MB) / "
        f"build {t_build*1e3:.1f} ms / render {t_render*1e3:.1f} ms -> {out_path}"
    )
    stats = dict(build_s=t_build, render_s=t_render, n_voxels=tree.n_voxels,
                 n_nodes=tree.n_nodes, accel_bytes=tree.memory_bytes(),
                 path=out_path, depth=depth)

    m64 = None
    if args.wire or args.oracle:
        # the oracle's own voxels, voxelized on the host
        m64, _, _ = cpu_oracle.voxelize_mesh(
            tri, origin, dps, args.res, True, colors, emissions,
            attributes=False)
    if args.wire:
        from ..utils import wireframe

        wimg = img.copy()
        wireframe.draw_voxels_wire(
            wimg, depth, cam, m64, lo, dps, max_voxels=args.wire_max)
        wire_path = os.path.join(args.out, "voxrt_wire.png")
        png.write(wire_path, wimg)
        print(f"[voxrt] wire overlay -> {wire_path}")

    if args.oracle:
        # A/B pixels against the brute-force slab test: the FULL frame when
        # small enough, otherwise a random sample
        n_pix = args.width * args.height
        if n_pix <= args.oracle_pixels:
            sel = np.arange(n_pix)
        else:
            rng = np.random.default_rng(0)
            sel = rng.choice(n_pix, args.oracle_pixels, replace=False)
        n_check = len(sel)
        sel_t = torch.as_tensor(sel, device=device)
        ro, rd = camera_ops.shoot(cam, sel_t % args.width, sel_t // args.width,
                                  0.5, 0.5, args.width, args.height)
        to, _ = cpu_oracle.brute_force_rays(m64, lo, dps, ro, rd)
        to = to.cpu().numpy()
        dn = depth.reshape(-1)[sel]
        dev_hit = dn < 1e37
        near = np.isclose(dn, to, rtol=3e-5, atol=1e-6)
        bad = int((dev_hit != np.isfinite(to)).sum()
                  + (dev_hit & np.isfinite(to) & ~near).sum())
        print(f"[voxrt] oracle A/B: {n_check - bad}/{n_check} pixels agree")
        stats.update(oracle_checked=n_check, oracle_agree=n_check - bad)
        if bad > n_check // 50:
            raise SystemExit("oracle mismatch beyond tolerance")
    return stats


if __name__ == "__main__":
    main()
