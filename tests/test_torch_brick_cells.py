"""The brick walk's crossed-cell mask on the CPU.

brick_walk_kernel (csrc/walks.cu) selects a node's child among the cells
of `crossed_cells(...) & occupancy` only, so that mask must hold every cell
the selection accepts (en < ex and ex > 0), or a result changes; the
design builds it from pairwise plane comparisons and says it is that set
exactly. Its construction as tensor code, bricktree.crossed_cells_plain,
is held here against the plain body's own en / ex (bricktree.
_cell_entry_exit, the lines _brick_body runs):

  * on the planes of every active lane at every step of the plain walk,
    on rays that mirror, have ±0 and axis-parallel directions, start
    inside the box or on the cell-plane lattice (along the axes, the face
    diagonals and (1, 1, 1)), are parked or hold NaN / inf, over a sparse
    tree, a solid cube and a full grid;
  * on plane sets made by hand: exact ties within and across axes, ±0,
    ±inf, NaN in one plane and in one axis, unsorted planes, every mirror;
  * on planes made from t1 / dt / scale with dt = 0, scale 4^-15 and
    non-finite t1 / dt.

Then the kernel source itself, compiled for the host with g++ (a stub
cuda_runtime.h, the launch run as a loop over blocks and threads), is
held bit for bit against the plain walk on such trees and rays, with
max_iters cuts and stacks shallower than the walk. And the A/B script's
ptxas parsing and its refusal without a card, and walk_rows' counts.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import bricktree, morton, traverse
from massivevoxelraytracing_torch.utils import cuda_build

torch.set_num_threads(1)

GRID = 64
QUARTERS = torch.arange(5, dtype=torch.float32)
CELLS = torch.tensor(bricktree._POS_CELL)
ONE = torch.ones(64, dtype=torch.int64)


def accepted(tbx, tby, tbz, vmask):
    """The body's accepted cells (en < ex & ex > 0) as a mask over the
    node's own bits (walk cell c is bit c ^ vmask)."""
    en, ex = bricktree._cell_entry_exit(tbx, tby, tbz)
    acc = (en < ex) & (ex > 0.0)
    return torch.where(acc, ONE[None, :] << (CELLS[None, :] ^ vmask[:, None]), 0).sum(1)


def assert_mask(tbx, tby, tbz, vmask, what):
    got = bricktree.crossed_cells_plain(tbx, tby, tbz, vmask)
    want = accepted(tbx, tby, tbz, vmask)
    missing = want & ~got
    assert not bool(missing.any()), f"{what}: the mask misses accepted cells"
    assert torch.equal(got, want), f"{what}: the mask holds cells the body refuses"
    return int((want != 0).sum())


def grid_codes(lo, size):
    g = torch.arange(size)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    return morton.encode(x.reshape(-1) + lo[0], y.reshape(-1) + lo[1],
                         z.reshape(-1) + lo[2]).unique()


def trees():
    rng = np.random.default_rng(21)
    c = torch.as_tensor(rng.integers(0, GRID, size=(2500, 3)))
    return {"sparse": morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique(),
            "solid": grid_codes((20, 24, 16), 16),
            "full": grid_codes((0, 0, 0), GRID)}


DIRS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 1, 0], [0, -1, 1], [-1, 0, -1],
                 [1, 1, 1], [-1, 1, -1], [-1, -1, -1]], np.float32)


def rays(codes, n, seed):
    """Rays aimed at voxels, then: ±0 and axis-parallel directions, from
    inside the box, from the cell-plane lattice along the axes, the face
    diagonals and (1, 1, 1), from inside a voxel and on its face, parked
    at 1e9, NaN and inf."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(codes[rng.integers(0, codes.shape[0], n)]))
    vox = np.stack([x, y, z], -1).astype(np.float32)
    rd = ((vox + 0.5) / GRID - ro).astype(np.float32)
    m = n // 8
    rd[:m, 0] = 0.0
    rd[m:2 * m, 1] = -0.0
    rd[2 * m:3 * m, :2] = -0.0
    ro[3 * m:4 * m] = rng.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    ro[4 * m:5 * m] = (rng.integers(0, GRID + 1, (m, 3)) / GRID).astype(np.float32)
    rd[4 * m:6 * m] = DIRS[rng.integers(0, len(DIRS), 2 * m)]
    ro[5 * m:5 * m + m // 2] = ((vox[5 * m:5 * m + m // 2] + 0.25) / GRID).astype(np.float32)
    face = vox[5 * m + m // 2:6 * m] + 0.5
    face[:, 0] -= 0.5
    ro[5 * m + m // 2:6 * m] = (face / GRID).astype(np.float32)
    k = 6 * m
    ro[k:k + 8] = 1e9
    rd[k + 8] = np.nan
    ro[k + 9, 1] = np.nan
    ro[k + 10] = np.inf
    rd[k + 11] = 0.0
    rd[k + 12, 2] = np.inf
    return torch.from_numpy(ro), torch.from_numpy(rd)


@pytest.mark.parametrize("name", ["sparse", "solid", "full"])
def test_mask_equals_accepted_cells_at_every_walk_step(name):
    codes = trees()[name]
    tree = bricktree.build_bricktree(codes, GRID, lower=np.zeros(3, np.float32),
                                     dps=1.0 / GRID)
    ro, rd = rays(codes, 768, 5)
    seen = [0, 0]

    def on_step(st):
        a = st["active"]
        planes = bricktree._cell_planes(*(st[k][a] for k in (
            "t1x", "t1y", "t1z", "dtx", "dty", "dtz", "scale")), QUARTERS)[:3]
        seen[0] += int(a.sum())
        seen[1] += assert_mask(*planes, st["vmask"][a], f"{name} walk step")

    t, _nmaj, _vidx = bricktree.intersect_rays_brick_plain(
        tree.meta, tree.root, tree.lower, tree.upper, ro, rd, n_levels=tree.n_levels,
        on_step=on_step)
    assert seen[0] > 1000 and seen[1] > 0.9 * seen[0]
    assert int((t < 1e37).sum()) > 200


def hand_planes(rng, n, values, sort: bool):
    p = torch.from_numpy(rng.choice(np.asarray(values, np.float32), size=(n, 3, 5)))
    return torch.sort(p, dim=2).values if sort else p


SPECIAL = [-np.inf, -3.0, -1.0, -0.0, 0.0, 1.0, 2.0, 3.0, np.inf]


@pytest.mark.parametrize("case", ["ties sorted", "ties unsorted", "signed zeros and inf",
                                  "nan plane", "nan axis"])
def test_mask_equals_accepted_cells_on_hand_made_planes(case):
    rng = np.random.default_rng(len(case))
    n = 4096
    if case == "ties sorted":
        p = hand_planes(rng, n, [-2, -1, 0, 1, 2, 3, 4], True)
    elif case == "ties unsorted":
        p = hand_planes(rng, n, [-1, 0, 1, 2, 3], False)
    elif case == "signed zeros and inf":
        p = hand_planes(rng, n, SPECIAL, bool(rng.integers(2)))
        p[: n // 2] = torch.sort(p[: n // 2], dim=2).values
    else:
        p = hand_planes(rng, n, [-1, 0, 1, 2, 3], True)
        lane = torch.arange(n)
        axis = torch.from_numpy(rng.integers(0, 3, n))
        if case == "nan plane":
            p[lane, axis, torch.from_numpy(rng.integers(0, 5, n))] = float("nan")
        else:
            p[lane, axis] = float("nan")
    vmask = torch.from_numpy(rng.integers(0, 8, n))
    vm64 = sum(((vmask >> a) & 1) * bricktree._MIRROR64[a] for a in range(3))
    hits = assert_mask(p[:, 0], p[:, 1], p[:, 2], vm64, case)
    if not case.startswith("nan axis"):
        assert hits > n // 20, case


@pytest.mark.parametrize("scale", [1.0, 4.0 ** -7, 4.0 ** -15])
def test_mask_equals_accepted_cells_from_t1_dt_scale(scale):
    """Planes made as the walk makes them: dt = 0 on an axis, the deepest
    scale of a 16-level tree, t1 or dt non-finite on some lanes."""
    rng = np.random.default_rng(int(-np.log2(scale)))
    n = 4096
    dt = rng.uniform(0.5, 4.0, (n, 3)).astype(np.float32)
    t1 = ((rng.uniform(-1.0, 1.0, (n, 3)) + dt) * scale).astype(np.float32)
    dt[rng.random((n, 3)) < 0.2] = 0.0
    t1[:64, 0] = np.inf
    t1[64:128, 1] = -np.inf
    dt[128:192, 2] = np.inf
    t1[192:256, 0] = np.nan
    t1[256:512] = np.float32(scale) * rng.integers(-2, 3, (256, 3)).astype(np.float32) / 4
    dt[256:512] = 1.0
    t1, dt = torch.from_numpy(t1), torch.from_numpy(dt)
    sc = torch.full((n,), scale, dtype=torch.float32)
    planes = bricktree._cell_planes(t1[:, 0], t1[:, 1], t1[:, 2], dt[:, 0], dt[:, 1],
                                    dt[:, 2], sc, QUARTERS)[:3]
    vmask = torch.from_numpy(rng.integers(0, 8, n))
    vm64 = sum(((vmask >> a) & 1) * bricktree._MIRROR64[a] for a in range(3))
    assert assert_mask(*planes, vm64, f"scale {scale}") > n // 4


# ---------------------------------------------------------------------------
# the kernel source on the host
# ---------------------------------------------------------------------------

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct int4 { int x, y, z, w; };
struct Dim { unsigned x, y, z; };
static Dim blockIdx, threadIdx, gridDim, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline int __ffsll(long long v) { return __builtin_ffsll(v); }
inline int __popcll(unsigned long long v) { return __builtin_popcountll(v); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <typename K, typename A> void host_launch(K k, long long g, int b, const A& a) {
  gridDim = {unsigned(g), 1, 1};
  blockDim = {unsigned(b), 1, 1};
  for (long long i = 0; i < g; ++i)
    for (int j = 0; j < b; ++j) {
      blockIdx = {unsigned(i), 0, 0};
      threadIdx = {unsigned(j), 0, 0};
      k(a);
    }
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """csrc/walks.cu compiled for the host: each launch a loop over its
    blocks and threads (the walks use no shared memory or barriers); the
    NaN-propagating max / min take their off-device branch."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host library; it is needed here too"
    d = tmp_path_factory.mktemp("walks_host")
    with open(os.path.join(cuda_build.CSRC, "walks.cu")) as f:
        src = f.read()
    src, n = re.subn(r"kernel<<<([^,]+),\s*kThreads,\s*0,\s*static_cast<cudaStream_t>"
                     r"\(stream\)>>>\(a\);", r"host_launch(kernel, \1, kThreads, a);", src)
    assert n == 1 and "<<<" not in src
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "walks.cpp").write_text(src)
    lib_path = str(d / "libwalks_host.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(d), "-o", lib_path, str(d / "walks.cpp")], check=True)
    lib = ctypes.CDLL(lib_path)
    p, q, u, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                     ctypes.c_float)
    lib.brick_walk_launch.argtypes = [p, q, p, p, p, q, u, i, q, f, f, f, p, p, p, p]
    lib.brick_walk_launch.restype = ctypes.c_int
    return lib


def host_brick_walk(lib, tree, ro, rd, n_levels, max_iters):
    head, out, _keep = traverse.walk_launch_args(tree.meta, tree.root, tree.lower, tree.upper,
                                                 ro, rd, depth=n_levels, max_iters=max_iters)
    assert lib.brick_walk_launch(*head, None) == 0
    return out


def assert_bits(got, want, what):
    for g, w, name in zip(got, want, ("t", "nmajor", "vidx")):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}: {name} differs"


@pytest.mark.parametrize("name", ["sparse", "solid", "full"])
def test_kernel_source_on_host_equals_plain_walk(host_walks, name):
    codes = trees()[name]
    tree = bricktree.build_bricktree(codes, GRID, lower=np.zeros(3, np.float32),
                                     dps=1.0 / GRID)
    ro, rd = rays(codes, 1024, 9)
    for n_levels, max_iters in ((tree.n_levels, 1), (tree.n_levels, 7), (tree.n_levels, 100),
                                (tree.n_levels, 100_000), (1, 100_000), (2, 100_000)):
        want = bricktree.intersect_rays_brick_plain(
            tree.meta, tree.root, tree.lower, tree.upper, ro, rd, n_levels=n_levels,
            max_iters=max_iters)
        got = host_brick_walk(host_walks, tree, ro, rd, n_levels, max_iters)
        assert_bits(got, want, f"{name} levels {n_levels} max_iters {max_iters}")
        if n_levels == tree.n_levels and max_iters == 100_000:
            assert int((want[0] < 1e37).sum()) > 300


# ---------------------------------------------------------------------------
# the measurement helpers
# ---------------------------------------------------------------------------

def test_walk_rows_counts_bits_and_crossed_cells():
    from massivevoxelraytracing_torch.scripts import common

    codes = trees()["solid"]
    tree = bricktree.build_bricktree(codes, GRID, lower=np.zeros(3, np.float32),
                                     dps=1.0 / GRID)
    ro, rd = rays(codes, 256, 3)
    got = common.walk_rows("brick", tree.n_levels, tree.meta, tree.root, tree.lower,
                           tree.upper, ro, rd)
    assert set(got) == {"entered", "rows", "visits", "bits", "cells"}
    assert 0 < got["cells"] <= 10 * got["visits"] and got["cells"] < got["bits"]
    assert 0 < got["rows"] <= tree.n_nodes and got["entered"] <= ro.shape[0]


def test_walk_ab_reads_ptxas_and_needs_a_card():
    from massivevoxelraytracing_torch.scripts import walk_ab

    log = ("ptxas info    : Compiling entry function '_Z17brick_walk_kernel8WalkArgs' for "
           "'sm_90a'\nptxas info    : Function properties for _Z17brick_walk_kernel8WalkArgs\n"
           "    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_Z18octree_walk_kernel' for 'sm_90a'\n"
           "ptxas info    : Used 38 registers\n")
    lines = walk_ab.ptxas_lines(log)
    assert len(lines) == 3 and "40 registers" in lines[2] and "spill" in lines[1]
    with pytest.raises(RuntimeError, match="needs a card"):
        walk_ab.run([], device="cpu")
