"""csrc/hako_rounds.cu compiled for the host with g++ and run on the CPU:
the round loop's cooperative kernel (hako_rounds_kernel) and the
two-launch driver's kernels (hako_probe_kernel, hako_dda_merge_kernel),
through their wrappers, held bit for bit against the plain driver.

tests/cuda_host_stub.py stands in for the CUDA runtime and cooperative
groups: a cooperative launch runs every CUDA thread of its grid at once
as a std::thread, so the lists, counts and barriers of the persistent
loop run with real concurrency; a <<<grid, block>>> launch runs its
threads one after another (those kernels have no collectives); the
occupancy query answers the blocks an SM and the "SMs" set per case.
jmax / jmin's PTX (max.NaN / min.NaN) becomes NaN-propagating compares.
The wrappers are pointed at the host library (_device_of says "cuda",
the stream is null), so their checks, allocations, counts and error
path run as on the card. Cases: 64^3 and 256^3 plain trees and a 512^3
fat tree, primary and shadow, default caps, one probe and one sub-brick
visit a round, a cut at 3 rounds and at 0; grids from one block to more
blocks than the lanes need; a grid larger than the co-resident one,
refused, raising; the device accumulators.
"""

import contextlib
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.utils import cuda_build

import cuda_host_stub
from test_torch_hako_build import port_tree, random_voxels
from test_torch_hako_mega import mixed_rays
from test_torch_hako_rounds_device import bound_argtypes

torch.set_num_threads(1)

HOST_MINMAX = """
__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a || b != b) return NAN;
  if (a == b) return std::signbit(a) ? b : a;
  return a > b ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a || b != b) return NAN;
  if (a == b) return std::signbit(a) ? a : b;
  return a < b ? a : b;
}
"""


def without_row_cache(src: str) -> str:
    """The source less kernel B's row cache (hako_dda_cached_kernel, its
    launch and entry point), which no case here runs: its bulk copies,
    mbarriers and shared-memory reads are PTX, which the host cannot
    build."""
    a = src.index("// Kernel B through a block-local row cache")
    b = src.index("struct MergeParams {")
    c = src.index("// hako_dda_launch's arguments, the row cache's size in rows")
    d = src.index('extern "C" int hako_merge_launch(')
    assert a < b < c < d
    return src[:a] + src[b:c] + src[d:]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("rounds_host")
    with open(os.path.join(cuda_build.CSRC, "hako_device.cuh")) as f:
        dev = f.read()
    a = dev.index("__device__ __forceinline__ float jmax(")
    b = dev.index("__device__ __forceinline__ float min3(")
    with open(os.path.join(cuda_build.CSRC, "hako_rounds.cu")) as f:
        src = f.read()
    src, _ = cuda_host_stub.rewrite_launches(src)
    src, n = re.subn(r"return cudaLaunchCooperativeKernel\(\s*reinterpret_cast<const void\*>"
                     r"\((\w+<[\w, ]*>)\),\s*dim3\((\w+)\),\s*dim3\((\w+)\), args, 0, s\);",
                     r"(void)args; return emu_coop_launch(dim3(\2), dim3(\3), [&] { \1(p); });",
                     src)
    assert n == 1 and "<<<" not in src
    src = without_row_cache(src)
    lib = cuda_host_stub.build(d, "rounds_host", src, headers={
        "hako_device.cuh": dev[:a] + HOST_MINMAX + dev[b:]})
    argtypes = bound_argtypes()
    for name in ("hako_probe_launch", "hako_dda_merge_launch", "hako_rounds_launch",
                 "hako_rounds_grid"):
        fn = getattr(lib, name)
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
    lib.emu_set_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.emu_coop_count.restype = ctypes.c_longlong
    lib.cuda_error_string = lambda rc: b"host emulation"
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers launch the host library's kernels on CPU tensors."""
    monkeypatch.setattr(cuda_build, "load", lambda: host_lib)
    monkeypatch.setattr(hk, "_device_of", lambda ro, name: "cuda")
    monkeypatch.setattr(hk, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(hk, "_ACC", {})
    monkeypatch.setattr(hk, "_GRIDS", {})  # each case sets its own grid
    hk.reset_counters()
    yield host_lib
    hk.reset_counters()


_CASES = {}


def case(name):
    """(driver args, T) of a random tree and 768 mixed rays."""
    if name not in _CASES:
        grid_res, n_vox, snodes_above = {"64": (64, 1536, None), "256": (256, 6144, None),
                                         "fat512": (512, 8000, 128)}[name]
        mp = pytest.MonkeyPatch()
        if snodes_above is not None:
            mp.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
        try:
            rng = np.random.default_rng(grid_res + 40)
            m = random_voxels(grid_res, n_vox, rng)
            ro, rd = mixed_rays(m, grid_res, 768, rng)
            pt = port_tree(m, grid_res)
        finally:
            mp.undo()
        assert (pt.snodes is not None) == (snodes_above is not None)
        (bricks, snodes, tabs, root), T = hk.hako_args(pt)
        _CASES[name] = ((bricks, snodes, tabs, root, pt.lower, pt.upper,
                         torch.from_numpy(ro), torch.from_numpy(rd)), T)
    return _CASES[name]


CAPS = {"default": (hk.PROBES, hk.DDA_ITERS, None), "capped": (1, 1, None),
        "cut3": (1, 2, 3), "cut0": (hk.PROBES, hk.DDA_ITERS, 0)}
GRIDS = {"3x1": (3, 1), "4x2": (4, 2), "1x1": (1, 1)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("tree", ["64", "256", "fat512"])
def test_rounds_kernel_on_host_equals_plain_driver(on_host, tree, shadow, caps, grid):
    args, T = case(tree)
    max_probes, max_dda, max_rounds = CAPS[caps]
    if max_rounds is None:
        max_rounds = hk.default_max_rounds(args[1], T, max_probes, max_dda)
    kw = dict(T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
              max_rounds=max_rounds)
    on_host.emu_set_grid(*GRIDS[grid])
    launched = on_host.emu_coop_count()
    got = hk.hako_rounds(*args, **kw)
    assert on_host.emu_coop_count() == launched + 1 and hk.LAUNCHES["hako_rounds"] == 1
    want = hk.intersect_rays_hako_plain(*args, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3].tolist() == [want[4], int(want[3])]
    if caps == "cut0":
        assert want[4] == 0 and int(want[3]) == 768
    elif caps != "cut3":
        assert int(want[3]) == 0 and want[4] > 2


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("tree", ["64", "256", "fat512"])
def test_two_launch_kernels_on_host_equal_plain_driver(on_host, tree, shadow):
    """kernel A's and the row stage's bodies, as device functions shared
    with hako_rounds, through the two-launch driver."""
    args, T = case(tree)
    kw = dict(T=T, shadow=shadow, max_probes=hk.PROBES, max_dda=2,
              max_rounds=hk.default_max_rounds(args[1], T, hk.PROBES, 2))
    got = hk.drive((hk.hako_probe, hk.hako_dda_merge), *args, **kw)
    want = hk.intersect_rays_hako_plain(*args, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[4] == want[4] and int(got[3]) == int(want[3]) == 0
    assert hk.LAUNCHES["hako_probe"] == hk.LAUNCHES["hako_dda_merge"] == got[4]


def test_refused_grid_raises_and_accumulators_add(on_host):
    args, T = case("64")
    on_host.emu_set_grid(2, 1)
    assert hk.rounds_grid("cpu", False, False) == (1, 2)
    with pytest.raises(RuntimeError, match="hako_rounds kernel launch failed"):
        hk.hako_rounds(*args, T=T, _blocks=3)
    assert set(hk.LAUNCHES.values()) == {0}
    got = hk.hako_rounds(*args, T=T, _blocks=2)
    primary = hk.intersect_rays_hako(*args, T=T)
    shadow = hk.intersect_rays_hako(*args, T=T, shadow=True)
    want = [hk.intersect_rays_hako_plain(*args, T=T, shadow=s) for s in (False, True)]
    for a, b, c in zip(got[:3], primary, want[0][:3]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(shadow[0], want[1][0])
    assert hk.LAUNCHES["hako_rounds"] == 3
    assert hk.rounds_run() == want[0][4] + want[1][4] and hk.unresolved_lanes() == 0
