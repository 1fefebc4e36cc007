"""The scene build's count and emit kernels against earlier designs of
the same kernels, on the same inputs, in turns on one card:

    git show <commit>:massivevoxelraytracing_torch/csrc/vox_build.cu > build/vox_ab/old.cu
    python -m massivevoxelraytracing_torch.scripts.vox_ab --old build/vox_ab/old.cu [--old ...]

Each earlier source is built with the library's nvcc flags into a
library of its own (its C entry points suffixed `_old`) and loaded beside
the current one; a design is named by its file's stem. Cases: the bench
lattice at 1024^3 (one group) and the 2048^3 lattice of
scripts/rebuild_timing (models/scene.dump_groups' groups), both split to
cap 4 by the host split as build_scene splits them. On each case every
design's count of all triangles and emit of each group are held bit for
bit against the current one's (the emit into buffers prefilled with a
sentinel, every entry written), then each earlier design is timed with
the current one by CUDA events (common.timed, REPS calls a turn) in the
turns old, new, new, old, beside common.vox_bound on the call's data and
the cells tested: the bbox cells (common.vox_cells, an earlier design's
cell loop) and the slab-clipped cells of the current enumeration
(common.vox_tested_cells). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import time

import numpy as np
import torch

from ..models import scene
from ..ops import voxelize as vox
from ..ops.octree import bucket
from ..utils import cuda_build, meshgen, meshprep
from . import common
from .scale_demo import CHUNK, sphere_lattice

REPS = 5
ENTRY_POINTS = ("vox_count_launch", "vox_emit_launch", "vox_unique_reduce_launch")
TURNS = ("old", "new", "new", "old")


def build_old(src: str, out_dir: str):
    """The earlier source as a library of its own, its entry points
    suffixed `_old`; returns (count, emit) launch functions."""
    os.makedirs(out_dir, exist_ok=True)
    with open(src) as f:
        text = f.read()
    for name in ENTRY_POINTS:
        text = text.replace(name + "(", name + "_old(")
    stem = os.path.splitext(os.path.basename(src))[0]
    renamed = os.path.join(out_dir, f"{stem}_renamed.cu")
    with open(renamed, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, f"lib{stem}_renamed.so")
    compile_cmds, link = cuda_build.nvcc_commands(cuda_build.nvcc_path(), lib_path, [renamed])
    t0 = time.perf_counter()
    for cmd in (*compile_cmds, link):
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cmd[-1]}:\n{done.stderr[-4000:]}")
    print(f"[vox_ab] built the earlier design from {src} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    lib = ctypes.CDLL(lib_path)
    cur = cuda_build.load()
    lib.vox_count_launch_old.argtypes = cur.vox_count_launch.argtypes
    lib.vox_emit_launch_old.argtypes = cur.vox_emit_launch.argtypes
    return lib.vox_count_launch_old, lib.vox_emit_launch_old


def _ptr(x) -> int:
    return x.data_ptr()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def cases():
    """(name, split arrays, origin, dps, grid_res) of the two lattices."""
    origin = np.zeros(3, np.float32)
    for name, grid, mesh in (("lattice1024", 1024, lambda: meshgen.sphere_lattice(6, 4)),
                             ("lattice2048", 2048, lambda: sphere_lattice(7, 5, 0.44))):
        tri, cols = mesh()
        arrays = meshprep.split_to_cap(tri, cols, np.zeros_like(tri), origin, 1.0 / grid,
                                       grid, 4)
        yield name, [np.ascontiguousarray(a) for a in arrays], origin, 1.0 / grid, grid


def run_case(name, arrays, origin, dps, grid, olds, device, card: str = "") -> dict:
    """The current design and each earlier one (olds: {name: (count,
    emit)}) on one case; returns the times, bounds and cells."""
    t, c, e = (torch.from_numpy(a).to(device) for a in arrays)
    origin_t = torch.from_numpy(origin).to(device)
    dps_t = torch.tensor(dps, dtype=torch.float32, device=device)
    kw = dict(grid_res=grid, six_separating=True, cap=4)
    T = t.shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream

    def count_old(fn):
        def call():
            out = torch.empty(T, dtype=torch.int32, device=device)
            _check(fn(1, _ptr(t), T, _ptr(origin_t), _ptr(dps_t), grid, 4, _ptr(out), stream),
                   "old count")
            return out
        return call

    def count_new():
        return vox.count(t, origin_t, dps_t, **kw)

    counts = count_new()
    count_fns = {"new": count_new, **{k: count_old(v[0]) for k, v in olds.items()}}
    for k, fn in count_fns.items():
        if not torch.equal(counts, fn()):
            raise AssertionError(f"{name}: the {k} design's counts differ from the current's")
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    chunk = min(CHUNK, bucket(T, floor=1024))
    offsets = scene.chunk_offsets(end, chunk)
    start = end - counts
    groups = scene.dump_groups(offsets)

    def timed_turns(fns):
        """{design: [ms of each of its turns]}: each earlier design in turns
        with the current one (old, new, new, old)."""
        ms = {k: [] for k in fns}
        for other in fns:
            if other == "new":
                continue
            for turn in TURNS:
                k = "new" if turn == "new" else other
                ms[k].append(common.timed(fns[k], REPS)[1])
        return ms

    n_cells = common.vox_cells(t, origin_t, dps_t, grid, 4)
    tested = common.vox_tested_cells(t, origin_t, dps_t, grid, 4)
    if tested["valid"] != int(end[-1]):
        raise AssertionError(f"{name}: the enumeration's valid cells {tested['valid']} are "
                             f"not the count's {int(end[-1])}")
    rec = dict(triangles=T, dumped=int(end[-1]), groups=len(groups), cells=n_cells, **{
        f"tested_{k}": v for k, v in tested.items()})
    rec["vox_count"] = dict(ms=timed_turns(count_fns),
                            bound=common.vox_bound("vox_count", n_tri=T, n_cells=n_cells))
    emit_ms = None
    emit_bound, emit_by = 0.0, set()
    for ka, kb in groups:
        a, b = ka * chunk, min(kb * chunk, T)
        off0 = int(offsets[ka])
        n = int(offsets[kb]) - off0
        tg, cg, eg, sg = t[a:b], c[a:b], e[a:b], start[a:b] - off0

        def bufs():
            return (torch.full((n,), -1, dtype=torch.int64, device=device),
                    torch.full((n,), 7, dtype=torch.int32, device=device),
                    torch.full((n,), 7, dtype=torch.int32, device=device))

        def emit_old(fn, out):
            def call():
                _check(fn(1, _ptr(tg), _ptr(cg), _ptr(eg), _ptr(sg), b - a, _ptr(origin_t),
                          _ptr(dps_t), grid, 4, n, *(_ptr(x) for x in out), stream),
                       "old emit")
                return out
            return call

        def emit_new(out=bufs()):
            return vox.emit(tg, cg, eg, sg, origin_t, dps_t, out, **kw)

        emit_fns = {"new": emit_new, **{k: emit_old(v[1], bufs()) for k, v in olds.items()}}
        got = {k: fn() for k, fn in emit_fns.items()}
        for k in olds:
            for x, y in zip(got[k], got["new"]):
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: the {k} design's dump buffers differ")
        if bool((got["new"][0] < 0).any()):
            raise AssertionError(f"{name}: a dump buffer entry was left unwritten")
        ms = timed_turns(emit_fns)
        emit_ms = ms if emit_ms is None else {
            k: [x + y for x, y in zip(emit_ms[k], ms[k])] for k in ms}
        cells_g = common.vox_cells(tg, origin_t, dps_t, grid, 4)
        bnd = common.vox_bound("vox_emit", n_tri=b - a, n_cells=cells_g, n_dumped=n)
        emit_bound += bnd[0]
        emit_by.add(bnd[1])
        del got, emit_fns
    rec["vox_emit"] = dict(ms=emit_ms, bound=(emit_bound, "/".join(sorted(emit_by))),
                           launches=len(groups))
    for k in ("vox_count", "vox_emit"):
        r = rec[k]
        bnd = r["bound"][0]
        r["share"] = {d: bnd / min(ms) for d, ms in r["ms"].items()}
        for i, other in enumerate(olds):
            old_ms, new_ms = r["ms"][other], r["ms"]["new"][2 * i:2 * i + 2]
            faster = ("current" if max(new_ms) < min(old_ms) else
                      other if max(old_ms) < min(new_ms) else "neither")
            print(f"[vox_ab] {name} {k} ({r.get('launches', 1)} launch(es) a build): turns "
                  f"{other} {old_ms[0]:.4f}, current {new_ms[0]:.4f}, current {new_ms[1]:.4f}, "
                  f"{other} {old_ms[1]:.4f} ms; bound {bnd:.4f} ms ({r['bound'][1]}); share "
                  f"{other} {r['share'][other]:.1%}, current {bnd / min(new_ms):.1%}; faster: "
                  f"{faster} [{card}]", flush=True)
    print(f"[vox_ab] {name}: {T} triangles, {rec['dumped']} dumped, {len(groups)} group(s); "
          f"bbox cells {n_cells} (the earlier design's cell loop), units "
          f"{tested['units']}, slab-clipped cells tested {tested['cells']} [{card}]",
          flush=True)
    return rec


def run(old_srcs: list, device="cuda", card: str = "") -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("vox_ab times CUDA kernels: it needs a card")
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "vox_ab")
    olds = {os.path.splitext(os.path.basename(src))[0]: build_old(src, out_dir)
            for src in old_srcs}
    out = {}
    for name, arrays, origin, dps, grid in cases():
        out[name] = run_case(name, arrays, origin, dps, grid, olds, dev, card)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, action="append",
                    help="an earlier vox_build.cu (repeat for several, each timed in turns "
                         "with the current one)")
    args = ap.parse_args(argv)
    return run(args.old, card=common.card(torch.device("cuda")))


if __name__ == "__main__":
    main()
