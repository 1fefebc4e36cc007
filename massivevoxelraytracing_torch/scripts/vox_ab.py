"""The scene build's kernels against earlier designs of the same kernels,
on the same inputs, in turns on one card:

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
(common.vox_tested_cells). Then the unique stage after the sort, on the
lattice group (means) and on the 2048^3 groups (sums) and their merge:
an earlier design's stage is its kernel after the bookkeeping that was
built for it with torch ops (the boundary flags, n_unique read back, the
segment ids: `segments_stage`), or, for an earlier source of this
design, its run heads' count, the cumsum, the readback and its reduce;
each design's outputs held bit for bit against the current stage's,
then the stage and its reduce kernel alone timed in the same turns,
beside the stage bound (common.vox_bound("vox_unique_reduce")). Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import types

import numpy as np
import torch

from ..models import scene
from ..ops import voxelize as vox
from ..ops.octree import bucket
from ..utils import cuda_build, meshgen, meshprep
from . import common
from .scale_demo import CHUNK, sphere_lattice

REPS = 5
ENTRY_POINTS = ("vox_count_launch", "vox_emit_launch", "vox_unique_reduce_launch",
                "vox_run_heads_launch", "vox_unique_tile")
TURNS = ("old", "new", "new", "old")


def build_old(src: str, out_dir: str):
    """The earlier source as a library of its own, its entry points
    suffixed `_old`; returns its launch functions (count, emit, reduce;
    heads and tile when it has this design's run heads' count, else
    None)."""
    lib, text, seconds, _log = cuda_build.build_renamed(src, out_dir, ENTRY_POINTS)
    print(f"[vox_ab] built the earlier design from {src} in {seconds:.1f} s", flush=True)
    cur = cuda_build.load()
    lib.vox_count_launch_old.argtypes = cur.vox_count_launch.argtypes
    lib.vox_emit_launch_old.argtypes = cur.vox_emit_launch.argtypes
    heads = tile = None
    if "vox_run_heads_launch" in text:
        heads, tile = lib.vox_run_heads_launch_old, lib.vox_unique_tile_old
        heads.argtypes = cur.vox_run_heads_launch.argtypes
        tile.argtypes = cur.vox_unique_tile.argtypes
        lib.vox_unique_reduce_launch_old.argtypes = cur.vox_unique_reduce_launch.argtypes
    else:  # a run a thread: (mode, s_key, perm, boundary, seg, n, in, code, out, stream)
        p = ctypes.c_void_p
        lib.vox_unique_reduce_launch_old.argtypes = [ctypes.c_int, p, p, p, p,
                                                     ctypes.c_longlong, p, p, p, p]
    for fn in (lib.vox_count_launch_old, lib.vox_emit_launch_old,
               lib.vox_unique_reduce_launch_old, heads, tile):
        if fn is not None:
            fn.restype = ctypes.c_int
    return types.SimpleNamespace(count=lib.vox_count_launch_old, emit=lib.vox_emit_launch_old,
                                 reduce=lib.vox_unique_reduce_launch_old, heads=heads, tile=tile)


def _ptr(x) -> int:
    return x.data_ptr()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def timed_turns(fns: dict) -> dict:
    """{design: [ms of each of its turns]}: each earlier design in turns
    with the current one ("new"): old, new, new, old."""
    ms = {k: [] for k in fns}
    for other in fns:
        if other == "new":
            continue
        for turn in TURNS:
            k = "new" if turn == "new" else other
            ms[k].append(common.timed(fns[k], REPS)[1])
    return ms


def _outputs(n_unique: int, mode: str, device):
    """The reduce's outputs as the wrapper allocates them: (code, the
    kernel's seven output slots, the result tuple)."""
    code = torch.empty(n_unique, dtype=torch.int64, device=device)
    if mode == "sums":
        outs = list(torch.empty((7, n_unique), dtype=torch.int64, device=device))
        return code, outs, (code, tuple(outs[:6]), outs[6])
    outs = [torch.empty(n_unique, dtype=torch.int32, device=device) for _ in range(2)]
    return code, outs, (code, outs[0], outs[1])


def _ptrs(xs):
    return (ctypes.c_void_p * 7)(*[x.data_ptr() for x in xs])


def segments_stage(fn, s_key, perm, attrs, mode: str, stream):
    """The unique stage of the design that walked a run a thread, after the
    sort: its torch bookkeeping (the boundary flags, n_unique read back, the segment ids)
    and the kernel `fn` (an earlier vox_unique_reduce_launch). Returns
    (the stage, its kernel alone on bookkeeping made once): each call
    returns (outputs, n_unique)."""
    def segments():
        s_valid = s_key != vox.INVALID_KEY
        ne = torch.ones_like(s_valid)
        ne[1:] = s_key[1:] != s_key[:-1]
        boundary = s_valid & ne
        n_unique = int(boundary.sum())
        seg = torch.cumsum(boundary, 0) - 1
        return boundary, torch.where(s_valid, seg, n_unique), n_unique

    def reduce(boundary, seg, n_unique):
        code, outs, result = _outputs(n_unique, mode, s_key.device)
        in_ptrs, out_ptrs = _ptrs(attrs), _ptrs(outs)
        _check(fn(vox.MODES.index(mode), _ptr(s_key), _ptr(perm), _ptr(boundary), _ptr(seg),
                  len(s_key), ctypes.addressof(in_ptrs), _ptr(code), ctypes.addressof(out_ptrs),
                  stream), "old reduce")
        return result, n_unique

    made = segments()
    return (lambda: reduce(*segments())), (lambda: reduce(*made))


def tiles_stage(ns, s_key, perm, attrs, mode: str, stream):
    """An earlier source of the current design (ns: build_old's functions
    with heads): its run heads' count, the cumsum, the readback, its
    reduce; returns (the stage, its reduce alone on heads counted once)."""
    m = vox.MODES.index(mode)
    N = len(s_key)

    def ends():
        heads = torch.empty(-(-N // ns.tile()), dtype=torch.int64, device=s_key.device)
        _check(ns.heads(_ptr(s_key), N, _ptr(heads), stream), "old run heads")
        e = torch.cumsum(heads, 0)
        return e, int(e[-1])

    def reduce(e, n_unique):
        code, outs, result = _outputs(n_unique, mode, s_key.device)
        in_ptrs, out_ptrs = _ptrs(attrs), _ptrs(outs)
        _check(ns.reduce(m, _ptr(s_key), _ptr(perm), _ptr(e), N, ctypes.addressof(in_ptrs),
                         _ptr(code), ctypes.addressof(out_ptrs), stream), "old reduce")
        return result, n_unique

    made = ends()
    return (lambda: reduce(*ends())), (lambda: reduce(*made))


def unique_ab(what: str, s_key, perm, attrs, mode: str, olds: dict, stream) -> dict:
    """The unique stage and its reduce kernel alone of every design on one
    sorted stream: each design's outputs == the current stage's bit for
    bit, then both timed in turns; returns {"stage" / "kernel": {design:
    [ms a turn]}, "n_unique"}."""
    want, n_unique = vox.unique_reduce(s_key, perm, attrs, mode=mode)
    ends = torch.cumsum(vox.run_heads(s_key), 0)
    stages = {"new": lambda: vox.unique_reduce(s_key, perm, attrs, mode=mode)}
    kernels = {"new": lambda: (vox.reduce_tiles(s_key, perm, attrs, ends, n_unique, mode=mode),
                               n_unique)}
    for k, ns in olds.items():
        make = tiles_stage if ns.heads is not None else segments_stage
        stages[k], kernels[k] = make(ns if ns.heads is not None else ns.reduce, s_key, perm,
                                     attrs, mode, stream)
    want_flat = common.flat_tensors(want)
    for k in stages:
        for fns, part in ((stages, "stage"), (kernels, "kernel")):
            got, n = fns[k]()
            if n != n_unique:
                raise AssertionError(f"{what}: the {k} design's {part} found {n} unique, "
                                     f"not {n_unique}")
            for x, y in zip(common.flat_tensors(got), want_flat, strict=True):
                if not torch.equal(x, y):
                    raise AssertionError(f"{what}: the {k} design's {part} outputs differ")
    del want, want_flat
    return dict(stage=timed_turns(stages), kernel=timed_turns(kernels), n_unique=n_unique)


def _add_turns(acc, ms):
    return ms if acc is None else {k: [x + y for x, y in zip(acc[k], ms[k])] for k in ms}


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
    count_fns = {"new": count_new, **{k: count_old(v.count) for k, v in olds.items()}}
    for k, fn in count_fns.items():
        if not torch.equal(counts, fn()):
            raise AssertionError(f"{name}: the {k} design's counts differ from the current's")
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    chunk = min(CHUNK, bucket(T, floor=1024))
    offsets = scene.chunk_offsets(end, chunk)
    start = end - counts
    groups = scene.dump_groups(offsets)

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
    uniq = {m: dict(stage=None, kernel=None, bound=0.0, calls=0) for m in ("means", "sums")}
    sums_parts = []
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

        emit_fns = {"new": emit_new, **{k: emit_old(v.emit, bufs()) for k, v in olds.items()}}
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
        # the unique stage on this group's dump: the means of the one group,
        # or a group's sums (kept for the merge)
        code, color, emission = got["new"]
        del got, emit_fns
        s_key, perm = torch.sort(code, stable=True)
        mode = "means" if len(groups) == 1 else "sums"
        u = unique_ab(f"{name} group {ka}-{kb}", s_key, perm, (color, emission), mode, olds,
                      stream)
        for part in ("stage", "kernel"):
            uniq[mode][part] = _add_turns(uniq[mode][part], u[part])
        uniq[mode]["bound"] += common.vox_bound("vox_unique_reduce", n_sorted=n,
                                                n_unique=u["n_unique"], mode=mode)[0]
        uniq[mode]["calls"] += 1
        if mode == "sums":
            sums_parts.append(vox.unique_reduce(s_key, perm, (color, emission), mode=mode)[0])
        del code, color, emission, s_key, perm
    rec["vox_emit"] = dict(ms=emit_ms, bound=(emit_bound, "/".join(sorted(emit_by))),
                           launches=len(groups))
    if sums_parts:  # the merge of the groups' sums
        s_key, perm = torch.sort(torch.cat([p[0] for p in sums_parts]), stable=True)
        attrs = (*[torch.cat([p[1][i] for p in sums_parts]) for i in range(6)],
                 torch.cat([p[2] for p in sums_parts]))
        del sums_parts
        u = unique_ab(f"{name} merge", s_key, perm, attrs, "merge", olds, stream)
        uniq["merge"] = dict(stage=u["stage"], kernel=u["kernel"], calls=1,
                             bound=common.vox_bound("vox_unique_reduce", n_sorted=len(s_key),
                                                    n_unique=u["n_unique"], mode="merge")[0])
        rec["unique"] = u["n_unique"]
        del s_key, perm, attrs
    rec["vox_unique"] = {m: r for m, r in uniq.items() if r["calls"]}
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
    for mode, r in rec["vox_unique"].items():
        for part in ("stage", "kernel"):
            ms = r[part]
            r[f"{part}_share"] = {d: r["bound"] / min(x) for d, x in ms.items()}
            for i, other in enumerate(olds):
                old_ms, new_ms = ms[other], ms["new"][2 * i:2 * i + 2]
                faster = ("current" if max(new_ms) < min(old_ms) else
                          other if max(old_ms) < min(new_ms) else "neither")
                what = ("the stage after the sort" if part == "stage" else
                        "the reduce kernel alone")
                print(f"[vox_ab] {name} unique {mode} ({r['calls']} call(s) a build), {what}: "
                      f"turns {other} {old_ms[0]:.4f}, current {new_ms[0]:.4f}, current "
                      f"{new_ms[1]:.4f}, {other} {old_ms[1]:.4f} ms; stage bound "
                      f"{r['bound']:.4f} ms (bytes); share {other} "
                      f"{r[f'{part}_share'][other]:.1%}, current "
                      f"{r['bound'] / min(new_ms):.1%}; faster: {faster} [{card}]", flush=True)
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
