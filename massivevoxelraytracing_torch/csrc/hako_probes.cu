// Hopper microbenchmarks of two questions the megakernel's design asks,
// ports of the reference's Pallas probes in scripts/:
//
// * row chase (gather_probe3.py "chase" / "chase_rows", dma_gather_probe3.py:
//   each gather's index comes from the row the gather before it read):
//   chains of dependent 656-byte brick-row reads, the next row taken from
//   word 0 (4 B a thread), from the xor of words 0-3 (one 16-byte load a
//   thread) or from the xor of all 164 words (a warp reads the row as 41
//   16-byte vectors and xor-reduces it). CHAINS independent chains a
//   thread (a warp, for the whole-row read) are interleaved, so their loads
//   are in flight together. Launched with one warp an SM it gives the time
//   of one dependent hop; at full occupancy, the rate of independent rows.
// * walk vs fetch (hako_kernel_micro.py): walk64 alone on masks held in
//   registers (the masks step through an LCG, so nothing is hoisted), and
//   the row-word fetch alone (words 2s, 2s+1 of the lane's row, s taken from
//   the words read before), each looped in the kernel.
//
// What bounds them is what they measure: load latency (the chase, the
// fetch) and issue rate (the walk). Plain PyTorch versions that compute the
// same outputs are in ops/probes.py.

#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int MODE, int CHAINS>
__global__ void row_chase_kernel(const uint32_t* rows, const int* start,
                                 int* end, int n_chains, int hops) {
  using hako::kRowWords;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int owner = MODE == 2 ? t >> 5 : t;  // a thread, or a warp
  int idx[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int k = owner * CHAINS + c;
    idx[c] = k < n_chains ? start[k] : 0;
  }
  for (int h = 0; h < hops; ++h) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const uint32_t* row = rows + static_cast<size_t>(idx[c]) * kRowWords;
      if (MODE == 0) {
        idx[c] = static_cast<int>(__ldg(row));
      } else if (MODE == 1) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
        idx[c] = static_cast<int>(v.x ^ v.y ^ v.z ^ v.w);
      } else {
        const int lane = threadIdx.x & 31;
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
        const uint4 a = __ldg(r4 + lane);
        uint32_t x = a.x ^ a.y ^ a.z ^ a.w;
        if (lane < kRowWords / 4 - 32) {
          const uint4 b = __ldg(r4 + 32 + lane);
          x ^= b.x ^ b.y ^ b.z ^ b.w;
        }
        idx[c] = static_cast<int>(__reduce_xor_sync(kFull, x));
      }
    }
  }
  if (MODE == 2 && (threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int k = owner * CHAINS + c;
    if (k < n_chains) end[k] = idx[c];
  }
}

template <int MODE>
int launch_chase(const uint32_t* rows, const int* start, int* end,
                 int n_chains, int hops, int chains, int blocks, int threads,
                 cudaStream_t s) {
  switch (chains) {
    case 1:
      row_chase_kernel<MODE, 1><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    case 2:
      row_chase_kernel<MODE, 2><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    case 4:
      row_chase_kernel<MODE, 4><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void walk_probe_kernel(const uint32_t* lo0, const uint32_t* hi0,
                                  const float* t1, const float* dc, int n,
                                  int iters, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t lo = lo0[i], hi = hi0[i];
  const float t1v[3] = {t1[i], t1[n + i], t1[2 * n + i]};
  const float dcv[3] = {dc[i], dc[n + i], dc[2 * n + i]};
  int acc = 0;
  for (int k = 0; k < iters; ++k) {
    acc += hako::walk64(lo, hi, 0, t1v, dcv, 0.0f).c;
    lo = lo * 1664525u + 1013904223u;
    hi = hi * 22695477u + 1u;
  }
  out[i] = acc;
}

__global__ void fetch_probe_kernel(const uint32_t* rows, const int* row_of,
                                   int n, int iters, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2* row = reinterpret_cast<const uint2*>(
      rows + static_cast<size_t>(row_of[i]) * hako::kRowWords);
  uint32_t s = i & 63, acc = 0;
  for (int k = 0; k < iters; ++k) {
    const uint2 w = __ldg(row + s);
    acc ^= w.x ^ w.y;
    s = (w.x ^ w.y ^ static_cast<uint32_t>(k)) & 63u;
  }
  out[i] = static_cast<int>(acc);
}

}  // namespace

// C entries for ctypes; device pointers. Each returns cudaGetLastError()
// after its launch (or an invalid-value code for a shape it does not take).
extern "C" int row_chase_launch(const void* rows, const void* start, void* end,
                                int n_chains, int hops, int mode, int chains,
                                int blocks, int threads, void* stream) {
  if (n_chains <= 0 || hops < 0 || blocks <= 0 || threads <= 0 || threads % 32)
    return cudaErrorInvalidValue;
  const auto* r = static_cast<const uint32_t*>(rows);
  const auto* st = static_cast<const int*>(start);
  auto* e = static_cast<int*>(end);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_chase<0>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    case 1: return launch_chase<1>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    case 2: return launch_chase<2>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int walk_probe_launch(const void* lo, const void* hi, const void* t1,
                                 const void* dc, int n, int iters, void* out,
                                 void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  walk_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const float*>(t1), static_cast<const float*>(dc), n, iters,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fetch_probe_launch(const void* rows, const void* row_of, int n,
                                  int iters, void* out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  fetch_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int*>(row_of), n,
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
