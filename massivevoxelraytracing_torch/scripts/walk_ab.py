"""A walk kernel (the brick walk, or with --kernel octree_walk the octree /
DAG walk) against earlier designs of the same kernel, on the same rays, in
turns on one card:

    git show a1f93ac:massivevoxelraytracing_torch/csrc/walks.cu > build/walk_ab/a1f93ac.cu
    python -m massivevoxelraytracing_torch.scripts.walk_ab --old build/walk_ab/a1f93ac.cu [--old ...]
    git show 0a88370:massivevoxelraytracing_torch/csrc/walks.cu > build/walk_ab/0a88370.cu
    python -m massivevoxelraytracing_torch.scripts.walk_ab --kernel octree_walk \
        --old build/walk_ab/0a88370.cu

Each earlier source is built with the library's nvcc flags into a library
of its own (utils/cuda_build.build_renamed: its C entry points suffixed
`_old`) and loaded beside the current one; a design is named by its
file's stem. Cases, on the bench lattice at 1024^3 (models/scene.
build_scene) built as a brick tree, or as an octree with the DAG on and
then off: the 1920x1080 frame's rays from the bench camera, and the
bounce-1 BSDF and NEE (shadow) batches of one 16-spp PT step through the
brick tree at 640x360 (the calls chip_smoke.py's phase 7 records). On
each case the current kernel, through its wrapper, is held bit for bit
against the plain walk, and every design's t, nmajor and vidx against
the plain walk's; then each earlier design is timed with the current one
by CUDA events (common.timed, REPS calls a turn, the same host work
around each launch) in the turns old, new, new, old, beside
common.walk_bound and what a visit tests (common.walk_rows / visit_note:
for the brick walk the set bits a selection over the whole mask tests
and the crossed and occupied cells the current one tests at most; for
the octree walk the occupied octants, the crossed and occupied ones, and
the current design's loop trips against the plain walk's iterations).
Prints each design's registers, stack and spills from ptxas. Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

import numpy as np
import torch

from ..models import accel, pathtracer, scene
from ..ops import traverse
from ..ops.traverse import F32
from ..utils import cuda_build, meshgen
from . import common

REPS = 5
TURNS = ("old", "new", "new", "old")
GRID = 1024
FRAME = (1920, 1080)
PT_FRAME = (640, 360)


def ptxas_lines(log: str, kernel: str = "brick_walk_kernel") -> list:
    """The ptxas report's lines for one kernel: its properties, stack,
    spills and registers."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        if inside and ("Function properties" in ln or "stack frame" in ln
                       or "registers" in ln):
            out.append(ln.strip())
    return out


def build_old(src: str, out_dir: str, kernel: str = "brick_walk"):
    """The earlier walks.cu as a library of its own; returns (its
    <kernel>_launch, its ptxas lines for <kernel>_kernel)."""
    lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, ("brick_walk_launch",
                                                                       "octree_walk_launch"))
    print(f"[walk_ab] built the earlier design from {src} in {seconds:.1f} s", flush=True)
    fn = getattr(lib, f"{kernel}_launch_old")
    fn.argtypes = getattr(cuda_build.load(), f"{kernel}_launch").argtypes
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(log, f"{kernel}_kernel")


def launcher(fn, tree, ro, rd, shadow: bool = False):
    """A call of one design's brick_walk_launch or octree_walk_launch
    (by the tree's kind) on these rays, with the host work
    traverse.launch_walk does around it (new outputs a call)."""
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    kind, depth, meta, root = accel.accel_args(tree)
    lead = () if kind == "brick" else (int(bool(shadow)),)

    def call():
        head, out, _keep = traverse.walk_launch_args(
            meta, root, tree.lower, tree.upper, ro, rd, depth=depth, max_iters=100_000)
        rc = fn(*lead, *head, stream)
        if rc != 0:
            raise RuntimeError(f"{kind} walk launch: CUDA error {rc}")
        return out
    return call


def same_bits(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32) if g.dtype == F32 else g,
                           w.view(torch.int32) if w.dtype == F32 else w)
               for g, w in zip(got, want, strict=True))


TREES = {"brick_walk": (("brick", dict(accel="brick")),),
         "octree_walk": (("octree DAG", dict(accel="octree")),
                         ("octree no DAG", dict(accel="octree", dag=False)))}


def lattice_cases(device, kernel: str = "brick_walk"):
    """({name: the lattice as the kernel's structure}, [(case, ro, rd,
    shadow)]): the frame's rays and the brick PT step's bounce-1 BSDF and
    NEE batches."""
    tri, cols = meshgen.sphere_lattice(6, 4)

    def build(**kw):
        return scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / GRID,
                                 grid_res=GRID, chunk_tris=262144, device=device, **kw)

    tree = build(accel="brick")
    cam = common.script_camera(np.zeros(3, np.float32), 1.0)
    ro, rd = common.camera_rays(cam, *FRAME, device)
    cases = [("frame 1080p", ro, rd, False)]
    calls, real = [], accel.intersect_with

    def recording(*a, **k):
        if len(calls) < 5:
            calls.append((a[6], a[7], k.get("shadow", False)))
        return real(*a, **k)

    pt = pathtracer.PathTracer(width=PT_FRAME[0], height=PT_FRAME[1], device=device)
    pt.setup()
    pt.load_hdri(common.sky_img())
    pt.update_scene(tree)
    accel.intersect_with = recording
    try:
        pt.step(cam)
    finally:
        accel.intersect_with = real
    (ro_b, rd_b, sb), (ro_s, rd_s, ss) = calls[3], calls[4]
    if sb or not ss:
        raise AssertionError("the recorded bounce-1 batches are not BSDF then NEE")
    cases += [("PT bounce-1 BSDF", ro_b, rd_b, False), ("PT bounce-1 NEE", ro_s, rd_s, True)]
    trees = {name: tree if kw["accel"] == "brick" else build(**kw) for name, kw in TREES[kernel]}
    return trees, cases


def run_case(name, tree, ro, rd, shadow, olds: dict, card: str = "") -> dict:
    """Every design on one batch of rays: outputs equal, then timed in
    turns; returns the times, bound and what a visit tests."""
    kind, depth, meta, root = accel.accel_args(tree)
    args = (kind, depth, meta, root, tree.lower, tree.upper, ro, rd)
    want = accel.intersect_with(*args, shadow=shadow, stages="plain")
    if not same_bits(accel.intersect_with(*args, shadow=shadow), want):
        raise AssertionError(f"{name}: the current kernel differs from the plain walk")
    lib = cuda_build.load()
    current = lib.brick_walk_launch if kind == "brick" else lib.octree_walk_launch
    fns = {"new": launcher(current, tree, ro, rd, shadow),
           **{k: launcher(fn, tree, ro, rd, shadow) for k, fn in olds.items()}}
    for k, fn in fns.items():
        if not same_bits(fn(), want):
            raise AssertionError(f"{name}: the {k} design differs from the plain walk")
    ms = {k: [] for k in fns}
    for other in olds:
        for turn in TURNS:
            k = "new" if turn == "new" else other
            ms[k].append(common.timed(fns[k], REPS)[1])
    rows = common.walk_rows(kind, depth, meta, root, tree.lower, tree.upper, ro, rd,
                            shadow=shadow)
    b_ms, b_by = common.walk_bound(kind, ro.shape[0], rows["rows"], rows["visits"],
                                   shadow=shadow)
    for i, other in enumerate(olds):
        old_ms, new_ms = ms[other], ms["new"][2 * i:2 * i + 2]
        faster = ("current" if max(new_ms) < min(old_ms) else
                  other if max(old_ms) < min(new_ms) else "neither")
        print(f"[walk_ab] {name} ({ro.shape[0]} rays, shadow {shadow}, == plain walk): turns "
              f"{other} {old_ms[0]:.4f}, current {new_ms[0]:.4f}, current {new_ms[1]:.4f}, "
              f"{other} {old_ms[1]:.4f} ms; bound {b_ms:.4f} ms ({b_by}); share {other} "
              f"{b_ms / min(old_ms):.2%}, current {b_ms / min(new_ms):.2%}; faster: {faster} "
              f"[{card}]", flush=True)
    print(f"[walk_ab] {name}: {rows['entered']} rays enter, {rows['visits']} visits, "
          f"{rows['rows']} distinct rows; {common.visit_note(rows)}", flush=True)
    return dict(rays=int(ro.shape[0]), shadow=shadow, ms=ms, bound_ms=b_ms, bound_by=b_by,
                **rows)


def run(old_srcs: list, device="cuda", card: str = "", kernel: str = "brick_walk") -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("walk_ab times CUDA kernels: it needs a card")
    if kernel not in TREES:
        raise ValueError(f"kernel must be one of {sorted(TREES)}, not {kernel!r}")
    cuda_build.load()
    regs = {"current": ptxas_lines(cuda_build.last_build_log, f"{kernel}_kernel")}
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "walk_ab")
    olds = {}
    for src in old_srcs:
        name = os.path.splitext(os.path.basename(src))[0]
        olds[name], regs[name] = build_old(src, out_dir, kernel)
    for name, lines in regs.items():
        for ln in lines or ["(built before this process: see chip_smoke.py phase 1)"]:
            ln = re.sub(r"\s+", " ", ln)
            print(f"[walk_ab] ptxas {name}: {ln}", flush=True)
    trees, cases = lattice_cases(dev, kernel)
    common.warm_up(dev)
    out = {"ptxas": regs}
    for tree_name, tree in trees.items():
        for name, ro, rd, shadow in cases:
            key = name if kernel == "brick_walk" else f"{tree_name} {name}"
            out[key] = run_case(key, tree, ro, rd, shadow, olds, card)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, action="append",
                    help="an earlier walks.cu (repeat for several, each timed in turns "
                         "with the current one)")
    ap.add_argument("--kernel", choices=sorted(TREES), default="brick_walk",
                    help="the walk kernel to time (default brick_walk)")
    args = ap.parse_args(argv)
    return run(args.old, card=common.card(torch.device("cuda")), kernel=args.kernel)


if __name__ == "__main__":
    main()
