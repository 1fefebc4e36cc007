"""Warm per-frame rebuild timing at the reference's scale, after the JAX
package's scripts/rebuild_timing.py (a 2048^3 rebuild of a >= 5M-triangle
mesh in single-digit seconds; the reference rebuilt its octree every frame
at ~135 ms for 41M voxels):

    python -m massivevoxelraytracing_torch.scripts.rebuild_timing
    python -m massivevoxelraytracing_torch.scripts.rebuild_timing --device cpu --res 64 --nsp 2 --subdiv 1 --n 2

Builds the sphere lattice (nsp^3 icospheres at subdiv: 7^3 x 20,480 = 7.0M
triangles by default) n times in one process through
models/scene.build_scene (accel "hako"), each on the mesh + 1e-4 * i: the
same shapes, new values, as an animated frame gives them. Build 0 is
"cold" (the first in the process: kernel libraries loaded, the caching
allocator empty), builds 1..n-1 "warm", the rebuild a frame pays. Each
prints its seconds and build_stats' split (split: the host C++ worklist;
count: pass 1 and its readback; unique: emit, sort / unique and readback;
accel: the tree and its readbacks), triangles after the split, dumped and
unique voxels, the tree's bytes and, on the card, the build's peak device
memory (the peak is reset before each build). Every region ends in a
synchronize on the card (build_scene's own). Without a card and without
--device cpu the script raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import scene
from . import common
from .scale_demo import CHUNK, sphere_lattice

JITTER = 1e-4


def run(res: int = 2048, nsp: int = 7, subdiv: int = 5, n: int = 3,
        chunk: int = CHUNK, device="cuda", card: str = "", keep_trees: bool = False) -> dict:
    """n builds of the jittered lattice. Returns the mesh's size and one
    record a build (with its tree where keep_trees)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    tri, cols = sphere_lattice(nsp, subdiv, 0.44)
    print(f"[rebuild] mesh: {len(tri)} triangles ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    builds = []
    for i in range(n):
        # same shapes, different values: an animated frame, not a cache hit
        jitter = np.float32(JITTER) * np.float32(i)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tree = scene.build_scene(tri + jitter, cols, origin=np.zeros(3, np.float32),
                                 dps=1.0 / res, grid_res=res, accel="hako",
                                 chunk_tris=chunk, device=dev)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        st = tree.build_stats
        tag = "cold" if i == 0 else "warm"
        rec = dict(build=i, tag=tag, s=dt, split_s=st["t_split_s"], count_s=st["t_count_s"],
                   unique_s=st["t_unique_s"], accel_s=st["t_accel_s"],
                   n_triangles=st["n_triangles"], n_dumped=st["n_dumped"],
                   n_unique=st["n_unique"], accel_bytes=st["accel_bytes"],
                   n_voxels=tree.n_voxels, peak_bytes=peak)
        print(f"[rebuild] build {i} ({tag}): {dt:.3f} s  split={rec['split_s']:.3f} "
              f"count={rec['count_s']:.3f} unique={rec['unique_s']:.3f} "
              f"accel={rec['accel_s']:.3f}  tris={rec['n_triangles']} "
              f"dumped={rec['n_dumped']} unique={rec['n_unique']} "
              f"bytes={rec['accel_bytes']}"
              + (f" peak={peak / 2**30:.2f} GiB" if cuda else "") + f" [{card}]", flush=True)
        if keep_trees:
            rec["tree"] = tree
        builds.append(rec)
        del tree
    return dict(res=res, nsp=nsp, subdiv=subdiv, mesh_triangles=int(len(tri)),
                builds=builds)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--res", type=int, default=2048, help="grid resolution")
    ap.add_argument("--nsp", type=int, default=7, help="spheres per axis")
    ap.add_argument("--subdiv", type=int, default=5,
                    help="icosphere subdivision (5: 20,480 triangles a sphere)")
    ap.add_argument("--n", type=int, default=3, help="builds")
    ap.add_argument("--chunk", type=int, default=CHUNK, help="triangles per chunk")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(args.res, args.nsp, args.subdiv, args.n, args.chunk, dev, card=card)


if __name__ == "__main__":
    main()
