"""A host stand-in for the CUDA runtime, so that a kernel source of the
port compiles with g++ and runs on the CPU in tests.

RUNTIME is the `cuda_runtime.h` the source includes: the CUDA keywords
defined away, dim3 / int4 / uint4, the warp intrinsics and atomics the
kernels use, and two launches. A `<<<grid, block, smem, stream>>>`
launch (rewritten by rewrite_launches) runs its threads one after
another, for kernels without collectives; a cooperative launch
(emu_coop_launch) runs every thread of its grid at once as a std::thread,
grid.sync() a std::barrier over the grid and __ballot_sync / __shfl_sync
a std::barrier over the warp, so lists, counters and barriers run with
real concurrency. The occupancy query answers g_emu_per_sm blocks on
each of g_emu_sms "SMs" (emu_set_grid), cudaGetDevice the index
emu_set_device gives (0 until then), and a cooperative grid larger than
that is refused. COOPERATIVE_GROUPS is `cooperative_groups.h`.
build() writes the headers and the source and compiles them.
"""

import ctypes
import re
import shutil
import subprocess

RUNTIME = r"""#pragma once
#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorCooperativeLaunchTooLarge = 720 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef void* cudaStream_t;

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  std::array<long long, 32> vals{};
};
struct EmuGrid {
  std::unique_ptr<std::barrier<>> grid_bar;
  std::vector<EmuWarp> warps;
};
inline EmuGrid* g_emu = nullptr;
inline int g_emu_sms = 3;          // "SMs" of the emulated card
inline int g_emu_per_sm = 1;       // blocks an SM by "occupancy"
inline int g_emu_device = 0;       // the current device's index
inline long long g_emu_coop_launches = 0;

inline EmuWarp& emu_warp() {
  return g_emu->warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  EmuWarp& w = emu_warp();
  const int l = threadIdx.x & 31;
  w.vals[l] = pred ? 1 : 0;
  w.bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) if (w.vals[i]) r |= 1u << i;
  w.bar->arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) {
  EmuWarp& w = emu_warp();
  w.vals[threadIdx.x & 31] = v;
  w.bar->arrive_and_wait();
  const int r = static_cast<int>(w.vals[src]);
  w.bar->arrive_and_wait();
  return r;
}
inline unsigned __activemask() { return 0xffffffffu; }
inline void __syncthreads() {}
inline int __syncthreads_count(int p) { return p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
inline float __ldcg(const float* p) {
  int i = __atomic_load_n(reinterpret_cast<const int*>(p), __ATOMIC_RELAXED);
  return __int_as_float(i);
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = g_emu_device; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = g_emu_sms; return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = g_emu_per_sm; return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }

// <<<g, b, smem, s>>> launches of kernels without collectives
template <class F>
inline void emu_seq_launch(dim3 g, dim3 b, F&& fn) {
  blockDim = b;
  gridDim = g;
  for (unsigned blk = 0; blk < g.x; ++blk)
    for (unsigned t = 0; t < b.x; ++t) {
      blockIdx = dim3(blk);
      threadIdx = dim3(t);
      fn();
    }
}

// a cooperative launch: every thread at once
template <class F>
inline cudaError_t emu_coop_launch(dim3 g, dim3 b, F&& fn) {
  if (static_cast<int>(g.x) > g_emu_sms * g_emu_per_sm) return cudaErrorCooperativeLaunchTooLarge;
  ++g_emu_coop_launches;
  EmuGrid E;
  const unsigned n = g.x * b.x;
  E.grid_bar = std::make_unique<std::barrier<>>(n);
  E.warps.resize(n / 32);
  for (auto& w : E.warps) w.bar = std::make_unique<std::barrier<>>(32);
  g_emu = &E;
  blockDim = b;
  gridDim = g;
  std::vector<std::thread> ts;
  for (unsigned blk = 0; blk < g.x; ++blk)
    for (unsigned t = 0; t < b.x; ++t)
      ts.emplace_back([&fn, blk, t] {
        blockIdx = dim3(blk);
        threadIdx = dim3(t);
        fn();
      });
  for (auto& th : ts) th.join();
  g_emu = nullptr;
  return cudaSuccess;
}

extern "C" long long emu_coop_count() { return g_emu_coop_launches; }
extern "C" void emu_set_grid(int sms, int per_sm) { g_emu_sms = sms; g_emu_per_sm = per_sm; }
extern "C" void emu_set_device(int d) { g_emu_device = d; }
"""

COOPERATIVE_GROUPS = r"""#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() const { g_emu->grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
"""


def _split_top(s: str) -> list:
    """s split at the commas outside parentheses and brackets."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return [x.strip() for x in out + [cur]]


def _seq_launch(m) -> str:
    cfg = _split_top(m.group(2))
    return (f"emu_seq_launch(dim3({cfg[0]}), dim3({cfg[1]}), "
            f"[&] {{ {m.group(1)}({m.group(3)}); }});")


def rewrite_launches(src: str) -> tuple:
    """(src with each `kernel<<<grid, block, ...>>>(args);` made an
    emu_seq_launch, the launches rewritten)."""
    return re.subn(r"(\w+(?:<[\w, ]*>)?)<<<(.*?)>>>\((.*?)\);", _seq_launch, src,
                   flags=re.S)


def build(d, name: str, src: str, extra: str = "", headers: dict | None = None):
    """Compile `src` (launches already rewritten) in the directory `d` with
    RUNTIME (and `extra` after it) as cuda_runtime.h, COOPERATIVE_GROUPS
    and `headers` ({file name: text}) beside it, into lib<name>.so; returns
    the loaded library."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the port's host library; it is needed here too"
    (d / "cuda_runtime.h").write_text(RUNTIME + extra)
    (d / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for file, text in (headers or {}).items():
        (d / file).write_text(text)
    (d / f"{name}.cpp").write_text(src)
    lib_path = str(d / f"lib{name}.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-I", str(d), "-o", lib_path, str(d / f"{name}.cpp")],
                   check=True)
    return ctypes.CDLL(lib_path)
