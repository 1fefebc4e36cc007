"""The probe body by stage (csrc/hako_probes.cu: probe_stage_kernel, its
Hopper walk and launcher) compiled for the host with g++ and run on the
CPU through its wrapper, held bit for bit against the plain version.

tests/cuda_host_stub.py stands in for the CUDA runtime: a <<<grid,
block>>> launch runs its threads one after another, and the occupancy
query answers the blocks an SM and the "SMs" set per case, so the
launcher's one wave and the kernel's grid-stride loop run as on the card
(each thread takes 1 to many lanes). jmax / jmin's PTX (max.NaN /
min.NaN) becomes NaN-propagating compares, the evict-first load a plain
load, and __byte_perm, __funnelshift_l and __clz their definitions;
pc64_below_hopper's 64-bit shift asm is the same shift on the host. Cases:
every stage on the shell micro's lanes and the card tests' dense masks,
at 1 to 3 waves of 1 x 1 to 4 x 2 blocks, and on rays of every mirror
mask with +-0, inf and NaN direction components."""

import contextlib
import ctypes
import os

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import stage_ab
from massivevoxelraytracing_torch.utils import cuda_build

import cuda_host_stub
from test_torch_hako_rounds_host import HOST_MINMAX
from test_torch_cuda import edge_rays, equal_or_both_nan

torch.set_num_threads(1)

HOST_INTRINSICS = r"""
template <class T> inline T __ldcs(const T* p) { return *p; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= ((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFFu) << (8 * i);
  return r;
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned long long v = (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<unsigned>((v << (shift & 31)) >> 32);
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
"""


def stage_source(src: str) -> str:
    """The Hopper walk's and the stage kernel's part of hako_probes.cu, with
    their launcher; pc64_below_hopper's asm as the same 64-bit shift."""
    def cut(a, b):
        return src[src.index(a):src.index(b)]

    pc64 = cut("__device__ __forceinline__ uint32_t pc64_below_hopper(",
               "// The walk probe: walk64's Hopper form")
    host_pc64 = """__device__ __forceinline__ uint32_t pc64_below_hopper(uint32_t lo, uint32_t hi, int cell) {
  const uint64_t v = ((static_cast<uint64_t>(hi) << 32) | lo);
  const uint64_t w = cell == 0 ? 0 : v << (64 - cell);
  return __popc(static_cast<uint32_t>(w)) + __popc(static_cast<uint32_t>(w >> 32));
}
"""
    assert "shl.b64" in pc64
    launch = src.index('extern "C" int probe_stage_probe_launch(')
    blocks_end = src.index("// The shared memory a block can opt in to")
    return ("#include <cuda_runtime.h>\n#include <cstdint>\n#include \"hako_device.cuh\"\n"
            "namespace {\n"
            "constexpr int kLaneThreads = 128;\nconstexpr int kMaxStageLevels = 8;\n"
            + cut("__device__ __forceinline__ uint32_t axis_offsets(",
                  "// hako::walk64 as it is, with WarpPass counting")
            + host_pc64
            + cut("// The reference's node-table forms", "// -----------------------------"
                  "----------------------------------------------\n// 2D gathers")
            + cut("inline int lane_blocks(int n)", "bool launch_shape_ok(")
            + "}  // namespace\n"
            + src[launch:blocks_end])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage_host")
    with open(os.path.join(cuda_build.CSRC, "hako_device.cuh")) as f:
        dev = f.read()
    a = dev.index("__device__ __forceinline__ float jmax(")
    b = dev.index("__device__ __forceinline__ float min3(")
    with open(os.path.join(cuda_build.CSRC, "hako_probes.cu")) as f:
        src, n = cuda_host_stub.rewrite_launches(stage_source(f.read()))
    assert n == 1
    lib = cuda_host_stub.build(d, "stage_host", src, extra=HOST_INTRINSICS, headers={
        "hako_device.cuh": dev[:a] + HOST_MINMAX + dev[b:]})

    class Bound:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    bound = Bound()
    cuda_build._bind(bound)
    for name in ("probe_stage_probe_launch", "probe_stage_probe_blocks"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(bound, name).argtypes
        fn.restype = ctypes.c_int
    lib.emu_set_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.emu_set_device.argtypes = [ctypes.c_int]
    lib.cuda_error_string = lambda rc: b"host emulation"
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrapper launches the host library's kernel on CPU tensors."""
    monkeypatch.setattr(cuda_build, "load", lambda: host_lib)
    monkeypatch.setattr(probes, "_device_of", lambda x, name: "cuda")
    monkeypatch.setattr(probes, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    probes.reset_counters()
    yield host_lib
    probes.reset_counters()


def equal_to_plain(stage, rays, bounds, root, tabs, T):
    got = probes.probe_stage_probe(stage, rays, bounds, root, tabs, T=T)
    want = probes.probe_stage_plain(stage, rays, bounds, root, tabs, T=T)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert equal_or_both_nan(g, w)
    return got


GRIDS = {"3x1": (3, 1), "1x1": (1, 1), "4x2": (4, 2)}


def emulate(lib, grid):
    """The emulated card of `grid`, a device of its own (its index in
    GRIDS): the launcher asks a device's wave once a stage."""
    lib.emu_set_device(list(GRIDS).index(grid))
    lib.emu_set_grid(*GRIDS[grid])


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("stage", range(5))
def test_stage_kernel_on_host_equals_plain(on_host, stage, grid):
    """Both input sets of scripts/stage_ab.py, 1,000 lanes each (the last
    warp partial): 8 to 1 waves of the emulated card's blocks."""
    emulate(on_host, grid)
    sms, per_sm = GRIDS[grid]
    assert on_host.probe_stage_probe_blocks(stage, 1000) == min(sms * per_sm, 8)
    assert on_host.probe_stage_probe_blocks(stage, 100) == 1
    assert on_host.probe_stage_probe_blocks(7, 1000) == 0
    for stage_rays, bounds, root, tabs, T in stage_ab.input_sets(torch.device("cpu"),
                                                                 1000).values():
        got = equal_to_plain(stage, stage_rays[stage], bounds, root, tabs, T)
        if stage == 4 and T == stage_ab.HIT_T:
            assert (got[1] < 64).any() and (got[1] == 64).any()
    assert probes.LAUNCHES["probe_stage_probe"] == 2


@pytest.mark.parametrize("stage", range(5))
def test_stage_kernel_on_host_mirrors_and_edges(on_host, stage):
    """Every mirror mask, +-0 / inf / NaN direction components, t_q of
    either sign, lanes that are not a multiple of the wave's."""
    emulate(on_host, "3x1")
    rng = np.random.default_rng(60 + stage)
    _rays, bounds, root, tabs = stage_ab.hit_inputs(torch.device("cpu"), 1, seed=60 + stage)
    for n in (1, 33, 2000):
        equal_to_plain(stage, edge_rays(rng, n, torch.device("cpu")), bounds, root, tabs,
                       stage_ab.HIT_T)


def test_stage_wave_is_asked_once_a_device_and_stage(on_host):
    """The launcher keeps a device's wave by stage: a later answer of the
    occupancy query on that device does not move it, a stage not yet
    launched there takes the new one, and a device past the kept ones
    asks at every launch."""
    on_host.emu_set_device(len(GRIDS))
    on_host.emu_set_grid(1, 1)
    assert on_host.probe_stage_probe_blocks(0, 1000) == 1
    on_host.emu_set_grid(4, 2)
    assert on_host.probe_stage_probe_blocks(0, 1000) == 1
    assert on_host.probe_stage_probe_blocks(1, 1000) == 8
    on_host.emu_set_device(64)
    for grid, blocks in (("1x1", 1), ("4x2", 8)):
        on_host.emu_set_grid(*GRIDS[grid])
        assert on_host.probe_stage_probe_blocks(0, 1000) == blocks


def test_stage_wrapper_refuses_a_stage_or_levels_it_lacks(on_host):
    """A stage past 4, or a T past the level tables given, raises in the
    wrapper before any launch."""
    rays, bounds, root, tabs = stage_ab.hit_inputs(torch.device("cpu"), 64)
    with pytest.raises(ValueError, match="no probe stage"):
        probes.probe_stage_probe(5, rays, bounds, root, tabs, T=3)
    with pytest.raises(ValueError, match="level tables"):
        probes.probe_stage_probe(4, rays, bounds, root, tabs, T=4)
    assert probes.LAUNCHES["probe_stage_probe"] == 0
