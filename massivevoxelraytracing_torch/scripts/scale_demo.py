"""Reference-scale demonstration on the card, after the JAX package's
scripts/scale_demo.py: build and render the sphere lattice at 2048^3 (the
reference's dragon: 55M voxels at 2048^3, ~2 ms a 1080p frame of primary
rays; the lattice's surface reaches ~54.4M voxels there):

    python -m massivevoxelraytracing_torch.scripts.scale_demo
    python -m massivevoxelraytracing_torch.scripts.scale_demo --device cpu --res 64 --nsp 2 --subdiv 2 --width 64 --height 48

The mesh is utils/meshgen.sphere_lattice(nsp, subdiv, radius), a
multi-million-triangle input for the split to the voxelizer's cap and the
chunked voxelize. The script builds it through models/scene.build_scene
(accel "hako") and prints its voxels, dumped voxels, bricks, level sizes,
bytes, the build's seconds with its build_stats split and, on the card,
the peak device memory of the build. Then it renders 1920x1088 frames
with voxel colours (models/raycast.render_frame, fovy 45), times 4 after
a warm one (host clock, synced), and prints ms, Mrays/s, hit fraction and
hako_mega's launches a frame. On the card it adds hako_mega's own ms on
the frame's rays (CUDA events) and its bound on them
(scripts/common.frame_bound: the rows the traversal reads). It writes the
last frame as a PNG (utils/png). Without a card and without --device cpu
the script raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models import accel, raycast, scene
from ..ops import hako_mega
from ..utils import meshgen, png
from . import common

CHUNK = 262144
ITERS = 4


def sphere_lattice(nsp: int, subdiv: int, radius_frac: float):
    """utils/meshgen.sphere_lattice (kept under the reference script's name
    for rebuild_timing)."""
    return meshgen.sphere_lattice(nsp, subdiv, radius_frac)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(res: int = 2048, nsp: int = 6, subdiv: int = 4, radius: float = 0.44,
        chunk: int = CHUNK, width: int = 1920, height: int = 1088,
        out: str = "out/scale_demo.png", device="cuda", card: str = "") -> dict:
    """Build, render and time the lattice at res^3. Returns the numbers,
    the tree, the camera and the last frame's image and depth."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    tri, cols = sphere_lattice(nsp, subdiv, radius)
    mesh_s = time.perf_counter() - t0
    print(f"[scale] mesh: {len(tri)} triangles ({mesh_s:.1f} s)", flush=True)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / res,
                             grid_res=res, accel="hako", chunk_tris=chunk, device=dev)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    st = tree.build_stats
    print(f"[scale] res={res} voxels={tree.n_voxels} (dumped {st['n_dumped']}, "
          f"triangles after the split {st['n_triangles']}) bricks={tree.n_bricks} "
          f"supernodes={tree.n_snodes} T={tree.T} levels={tree.n_per_level} "
          f"mem={tree.memory_bytes()} B build={build_s:.3f} s (split "
          f"{st['t_split_s']:.3f}, count {st['t_count_s']:.3f}, unique "
          f"{st['t_unique_s']:.3f}, accel {st['t_accel_s']:.3f})"
          + (f", peak device memory {peak / 2**30:.2f} GiB" if cuda else "")
          + f" [{card}]", flush=True)

    cam = common.script_camera(np.zeros(3, np.float32), 1.0, fovy_deg=45.0)

    def frame():
        return raycast.render_frame(tree, cam, width, height, show_color=True, device=dev)

    t0 = time.perf_counter()
    img, depth = frame()
    _sync(dev)
    first_s = time.perf_counter() - t0
    launches0 = hako_mega.LAUNCHES
    t0 = time.perf_counter()
    for _ in range(ITERS):
        img, depth = frame()
    _sync(dev)
    frame_ms = (time.perf_counter() - t0) / ITERS * 1e3
    launches = (hako_mega.LAUNCHES - launches0) / ITERS
    hit = float((depth < 1e37).float().mean())
    mrays = width * height / (frame_ms * 1e-3) / 1e6
    rec = dict(res=res, nsp=nsp, subdiv=subdiv, mesh_triangles=int(len(tri)),
               n_voxels=tree.n_voxels, n_bricks=tree.n_bricks, n_snodes=tree.n_snodes,
               T=tree.T, n_per_level=list(tree.n_per_level),
               memory_bytes=tree.memory_bytes(), build_s=build_s,
               build_stats=dict(st), peak_build_bytes=peak, width=width, height=height,
               first_frame_s=first_s, hit_fraction=hit, launches_a_frame=launches)
    if cuda:
        rec.update(frame_ms=frame_ms, mrays=mrays)
        ro, rd = common.camera_rays(cam, width, height, dev)
        kind, T, meta, root = accel.accel_args(tree)
        _, rec["kernel_ms"] = common.timed(lambda: accel.intersect_with(
            kind, T, meta, root, tree.lower, tree.upper, ro, rd), reps=ITERS)
        rec["bound"] = common.frame_bound(tree, ro, rd)
        print(f"[scale] frame {width}x{height}: {frame_ms:.3f} ms = {mrays:.2f} Mrays/s "
              f"(mean of {ITERS}), hit fraction {hit:.4f}, {launches:g} hako_mega launches "
              f"a frame (first frame {first_s:.2f} s); hako_mega alone on the frame's "
              f"rays {rec['kernel_ms']:.3f} ms, bound {rec['bound']['bound_ms']:.4f} ms "
              f"({rec['bound']['bound_by']}: {rec['bound']['distinct_rows']} distinct rows, "
              f"{rec['bound']['row_visits']} row visits) [{card}]", flush=True)
    else:
        print(f"[scale] frame {width}x{height}: hit fraction {hit:.4f}, {launches:g} "
              f"hako_mega launches a frame [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    png.write(out, img.cpu().numpy())
    print(f"[scale] wrote {out}", flush=True)
    rec.update(out=out, tree=tree, cam=cam, img=img, depth=depth)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=2048, help="grid resolution")
    ap.add_argument("--nsp", type=int, default=6, help="spheres per axis")
    ap.add_argument("--subdiv", type=int, default=4,
                    help="icosphere subdivision per sphere (4: 5,120 triangles each)")
    ap.add_argument("--radius", type=float, default=0.44,
                    help="sphere radius as a fraction of the lattice spacing")
    ap.add_argument("--chunk", type=int, default=CHUNK, help="triangles per chunk")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--out", default="out/scale_demo.png")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(args.res, args.nsp, args.subdiv, args.radius, args.chunk, args.width,
               args.height, args.out, dev, card=card)


if __name__ == "__main__":
    main()
