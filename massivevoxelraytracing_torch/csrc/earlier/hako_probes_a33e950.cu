// Hopper microbenchmarks of the questions the megakernel's design asks,
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
// * walk / scan vs fetch (hako_kernel_micro.py k_walk, scan64, k_words):
//   walk64 (or the 64-cell scan64 sweep) alone on masks held in registers
//   (the masks step through an LCG, so nothing is hoisted), and the
//   row-word fetch alone (words 2s, 2s+1 of the lane's row, s taken from
//   the words read before), each looped in the kernel.
// * construct_probe<C> (construct_micro.py run): K dependent repeats of one
//   vector construct a lane, each written the way Hopper computes it
//   (fminf / fmaxf, a select, integer ops, a variable shift, the literal
//   5-step barrel shift, int <-> float converts, bit_at and pc64_below of
//   hako_device.cuh with __popc).
// * node_gather_probe<SPACE> (hako_kernel_micro.py k_gflat / k_gsplit): a
//   chain of dependent node fetches (mask_lo, mask_hi, base) from a table
//   in global memory (__ldg), in shared memory (copied in by each block)
//   or in constant memory (uploaded on the launch stream).
// * table_select_probe<FORM> (hako_kernel_micro.py k_fold, fold_select
//   over 64 x 3 words in SMEM): the 64-entry select from constant memory,
//   from shared memory, or from registers across the warp (each word of
//   the 64 entries as 2 registers a lane) with __shfl_sync.
// * calib_probe<KIND> (hako_kernel_micro.py calibrate): K dependent
//   a * 1.0000001f + b (a separate multiply and add under -fmad=false;
//   the reference's K = 1024) against 8 independent chains of K (128).
// * shell_copy_probe<AOS> (hako_shell_micro.py :64 and :78): kernel A's
//   I/O without its work, o = i + 1 over 8 float arrays of a lane each
//   (8 separate streams in and 8 out, kernel A's own layout) or over one
//   consolidated [G, 8, L] array. The TPU question was the per-grid-step
//   cost of 16 pipelined VMEM blocks; here it is what 16 streams cost
//   against one array of the same bytes. Bound: bytes, each input read
//   and each output written once (33.5 MB, 0.0100 ms at 3.35 TB/s, on
//   the script's 524,288 lanes). Both layouts run one streaming design:
//   every thread has 8 independent 16-byte loads in flight before its
//   first store (one float4 of each of the 8 arrays, or 8 float4s of the
//   one array, each load instruction coalesced over the warp), with an
//   evict-first hint on the inputs, read once, in one wave of 128-thread
//   blocks at most (a grid-stride loop past it), so neither layout pays
//   a last partial wave of short blocks.
// * preamble_probe (hako_shell_micro.py :102): the shell plus
//   hako::ray_preamble on the unit box, 6 arrays in (the ray's SoA
//   origin and direction, read straight into the preamble's value
//   overload: no [n, 3] interleave) and its 8 outputs (t0 + t1 an axis,
//   dt an axis, vm6 and enter_ok as floats).
// * probe_stage_probe<STAGE> (hako_shell_micro.py :200 k_body and :287
//   staged): kernel A's probe body cut into stages, from the device
//   functions the traversal runs (ray_preamble, walk64, coords, plane,
//   pc64_below) and the level-table fetch. STAGE 0: preamble + the root
//   walk; 1: + the cell's coords, exit planes and rank; 2: + the node
//   fetch at the rank (clipped to [0, clip], the reference's literal);
//   3: + the walk of the fetched node. STAGE 4: the body unrolled over
//   the T levels, no probe loop. Where a walk finds no cell (c = 64) the
//   reference still ranks c ^ vm6 (64-127) with its shifts clipped, and
//   fetches child indices past a level: pc64_below_clipped gives its rank
//   and level_node the node its table form gives (a clipped index or
//   zeros past the level's nodes).
// * take_along_probe<AXIS, FORM> (dyngather_probe2.py :19, its k_taa1 /
//   k_taa1w / k_taa0 / k_taa0t, and gather_probe3.py :70 probe_a0small):
//   take_along_axis within a tile, out[i, j] = t[i, idx[i, j] % mod] (axis
//   1) or t[idx[i, j] % mod, j] (axis 0), on a batch of independent tiles,
//   a block a tile. The TPU question was which 2D dynamic gathers Mosaic
//   lowers along lanes and sublanes; here it is what a block's gather
//   within its tile costs three ways: FORM SHARED stages the tile in shared
//   memory with coalesced 16-byte loads, then gathers from it (a tile over
//   the block's opt-in shared memory is refused by the wrapper); along
//   columns (axis 0) a block takes a slice of a tile's columns and
//   stages only the 32-byte sectors of it that its indices reach
//   (take_along_a0_kernel), but where its indices reach every sector of
//   a card-filling batch or of a 4 KB tile, a tile a block; FORM SHFL (axis 1) holds a row in a warp, C /
//   32 registers a lane, and gathers with one __shfl_sync a register and a
//   select (a shuffle reaches 32 lanes only); FORM GLOBAL gathers through
//   L1 (__ldg). Bound: bytes (the
//   sectors the indices reach, the indices and the output once); one tile
//   is launch-bound, which is why the batch exists.
// * smem_alloc_probe (gather_probe3.py :101 probe_vmem, the largest single
//   VMEM scratch): n rows of 128 floats of dynamic shared memory, after
//   cudaFuncSetAttribute raises the block's limit to them; 2x goes into
//   row 0 and into row n - 1, and the output is row 0 + row n - 1 = 4x for
//   every n. The reference never writes its last row, so its output is
//   undefined (NaN when interpreted); writing it defines the output and
//   proves the far end of the allocation is addressable. No bound: a
//   capacity probe, answered by the largest n that launches.
// * ohg_probe<MODE> (gather_probe3.py :147 probe_ohg): the dependent chase
//   idx = (idx + flat[idx]) & (n - 1) over an int32 [n_rows, 128] table,
//   k hops a lane. MODE SHARED stages the table in shared memory, MODE
//   GLOBAL loads through L1 / L2: both are bound by the latency of k
//   dependent loads. MODE MMA is the reference's MXU gather on the tensor
//   cores (ohg_mma_kernel): each hop the full one-hot product of every
//   lane's row with the table's three byte planes (values < 2^24) by
//   mma.sync m16n8k32 u8 x u8 -> s32, over every 32-row chunk and 8-column
//   tile, as the reference computes it. The planes are split once a call
//   while a block stages them in shared memory in the B fragments' order;
//   a cluster of blocks splits the table's rows where it exceeds what one
//   block holds, and a lane's column is combined across the cluster
//   through distributed shared memory. Bound: operations (2 x lanes x
//   n_rows x 128 x 3 int8 operations a hop).
//
// What bounds them is what they measure: load latency (the chase, the
// fetch, the gathers) and issue rate or dependent-op latency (the walk, the
// constructs, the selects, the calibration). The shell and the preamble
// are bound by their bytes (16 and 14 floats a lane, each read or written
// once); so are the stages where most rays miss the box (a missing ray's
// walk ends at its first test), else by the walks' issue. The repeat
// loops keep every repeat data-dependent; the outer loop is `#pragma
// unroll 1` around a fixed inner unroll of kUnroll, so the outer loop
// body's SASS instructions over kUnroll are the cost of one repeat.
// Plain PyTorch versions that compute the same outputs are in
// ops/probes.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace cg = cooperative_groups;

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

// The 64-cell in-order sweep with walk64's contract (the reference's
// _scan64_impl): every cell's entry / exit from the 5 planes an axis, the
// occupied cell of least entry (the lowest cell index on equal entries).
__device__ __forceinline__ hako::Walk scan64(uint32_t lo, uint32_t hi, int vm6,
                                             const float t1[3], const float dc[3],
                                             float t_q) {
  using hako::jmax;
  using hako::jmin;
  const float tq0 = jmax(t_q, 0.0f);
  float tb[3][5];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 5; ++k) tb[a][k] = hako::plane(t1[a], dc[a], k);
  }
  hako::Walk best{hako::kMaxFloat, hako::kMaxFloat, 64};
#pragma unroll
  for (int c = 0; c < 64; ++c) {
    int cx, cy, cz;
    hako::coords(c, cx, cy, cz);
    const float en = jmax(tb[0][cx], jmax(tb[1][cy], tb[2][cz]));
    const float ex = jmin(tb[0][cx + 1], jmin(tb[1][cy + 1], tb[2][cz + 1]));
    if (hako::bit_at(lo, hi, vm6 ^ c) && en < ex && ex > tq0 && en < best.en) {
      best = hako::Walk{en, ex, c};
    }
  }
  return best;
}

template <bool SCAN>
__global__ void walk_probe_kernel(const uint32_t* lo0, const uint32_t* hi0,
                                  const float* t1, const float* dc, int n,
                                  int iters, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t lo = lo0[i], hi = hi0[i];
  const float t1v[3] = {t1[i], t1[n + i], t1[2 * n + i]};
  const float dcv[3] = {dc[i], dc[n + i], dc[2 * n + i]};
  int acc = 0;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    acc += SCAN ? scan64(lo, hi, 0, t1v, dcv, 0.0f).c
                : hako::walk64(lo, hi, 0, t1v, dcv, 0.0f).c;
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
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const uint2 w = __ldg(row + s);
    acc ^= w.x ^ w.y;
    s = (w.x ^ w.y ^ static_cast<uint32_t>(k)) & 63u;
  }
  out[i] = static_cast<int>(acc);
}

constexpr int kUnroll = 8;  // repeats in one pass of a probe's outer loop

enum Construct { kMinMax, kCmpSel, kInt, kVShift, kBarrel, kI2F, kBitAt, kPc64 };

// One lane: K = outer * kUnroll dependent repeats of construct C.
// fa / fb f32, ia i32, ua / ub u32 inputs; fout (f32 constructs) or iout.
template <int C>
__global__ void construct_probe_kernel(const float* fa, const float* fb,
                                       const int* ia, const uint32_t* ua,
                                       const uint32_t* ub, int n, int outer,
                                       float* fout, int* iout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (C == kMinMax || C == kCmpSel) {
    float x = fa[i];
    const float y = fb[i];
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (C == kMinMax) {
          x = fminf(fmaxf(x, y), y + x);
        } else {
          x = x < y ? x + y : y;
        }
      }
    }
    fout[i] = x;
  } else if constexpr (C == kI2F) {
    int x = ia[i];
    float acc = 0.0f;
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc = acc + static_cast<float>(x & 255);
        x = x ^ static_cast<int>(acc);
      }
    }
    fout[i] = acc;
  } else {
    // integer chains in u32 (wrap-around adds); >> 3 of kInt is arithmetic
    uint32_t x = static_cast<uint32_t>(ia[i]);
    const uint32_t m0 = C == kInt ? 0u : ua[i];
    const uint32_t m1 = (C == kBitAt || C == kPc64) ? ub[i] : 0u;
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (C == kInt) {
          x = ((x + 7u) & 0x7FFFFFFu) ^
              static_cast<uint32_t>(static_cast<int>(x) >> 3);
        } else if constexpr (C == kVShift) {
          x += (m0 >> (x & 31u)) & 1u;
        } else if constexpr (C == kBarrel) {
          const uint32_t sh = x & 31u;
          uint32_t v = m0;
          v = (sh & 1u) ? v >> 1 : v;
          v = (sh & 2u) ? v >> 2 : v;
          v = (sh & 4u) ? v >> 4 : v;
          v = (sh & 8u) ? v >> 8 : v;
          v = (sh & 16u) ? v >> 16 : v;
          x += v & 1u;
        } else if constexpr (C == kBitAt) {
          x += hako::bit_at(m0, m1, static_cast<int>(x & 63u)) ? 1u : 0u;
        } else {
          x += hako::pc64_below(m0, m1, static_cast<int>(x & 63u));
        }
      }
    }
    iout[i] = static_cast<int>(x);
  }
}

template <int C>
int launch_construct(const float* fa, const float* fb, const int* ia,
                     const uint32_t* ua, const uint32_t* ub, int n, int outer,
                     void* out, int threads, cudaStream_t s) {
  construct_probe_kernel<C><<<(n + threads - 1) / threads, threads, 0, s>>>(
      fa, fb, ia, ua, ub, n, outer, static_cast<float*>(out),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

enum Space { kGlobal, kShared, kConstant };
constexpr int kMaxNodes = 4096;  // 4096 x 12 B = 48 KB of constant memory
__constant__ uint32_t c_nodes[3 * kMaxNodes];
__constant__ uint32_t c_select[3 * 64];

// One lane: K dependent node fetches, idx = (idx0 + acc) & (n_nodes - 1),
// acc = (acc + base) & 31, fold ^= mask_lo ^ mask_hi. Every thread of a
// block runs the loop (the shared table is copied in by all of them).
template <int SPACE>
__global__ void node_gather_probe_kernel(const uint32_t* table, int n_nodes,
                                         const int* idx0, int n, int outer,
                                         int* acc_out, int* fold_out) {
  extern __shared__ uint32_t s_nodes[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (SPACE == kShared) {
    for (int j = threadIdx.x; j < 3 * n_nodes; j += blockDim.x) s_nodes[j] = table[j];
    __syncthreads();
  }
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  const uint32_t wrap = static_cast<uint32_t>(n_nodes - 1);
  uint32_t acc = 0, fold = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t w = 3u * ((start + acc) & wrap);
      uint32_t lo, hi, base;
      if constexpr (SPACE == kGlobal) {
        lo = __ldg(table + w);
        hi = __ldg(table + w + 1);
        base = __ldg(table + w + 2);
      } else if constexpr (SPACE == kShared) {
        lo = s_nodes[w];
        hi = s_nodes[w + 1];
        base = s_nodes[w + 2];
      } else {
        lo = c_nodes[w];
        hi = c_nodes[w + 1];
        base = c_nodes[w + 2];
      }
      acc = (acc + base) & 31u;
      fold ^= lo ^ hi;
    }
  }
  if (live) {
    acc_out[i] = static_cast<int>(acc);
    fold_out[i] = static_cast<int>(fold);
  }
}

enum Form { kSelConstant, kSelShared, kSelShuffle };

// One lane: K dependent selects from 64 entries of 3 words,
// sel = (idx0 + acc) & 63, acc = (acc + (w0 ^ w1 ^ w2)) & 31. Every
// thread runs the loop (the shuffle form needs the whole warp).
template <int FORM>
__global__ void table_select_probe_kernel(const uint32_t* tab, const int* idx0,
                                          int n, int outer, int* out) {
  __shared__ uint32_t s_tab[3 * 64];
  constexpr unsigned kFull = 0xffffffffu;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  uint32_t reg[3][2];
  if constexpr (FORM == kSelShared) {
    for (int j = threadIdx.x; j < 3 * 64; j += blockDim.x) s_tab[j] = tab[j];
    __syncthreads();
  } else if constexpr (FORM == kSelShuffle) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      reg[j][0] = __ldg(tab + 3 * lane + j);
      reg[j][1] = __ldg(tab + 3 * (lane + 32) + j);
    }
  }
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  uint32_t acc = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t sel = (start + acc) & 63u;
      uint32_t w[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if constexpr (FORM == kSelConstant) {
          w[j] = c_select[3 * sel + j];
        } else if constexpr (FORM == kSelShared) {
          w[j] = s_tab[3 * sel + j];
        } else {
          const uint32_t a = __shfl_sync(kFull, reg[j][0], sel & 31u);
          const uint32_t b = __shfl_sync(kFull, reg[j][1], sel & 31u);
          w[j] = (sel & 32u) ? b : a;
        }
      }
      acc = (acc + (w[0] ^ w[1] ^ w[2])) & 31u;
    }
  }
  if (live) out[i] = static_cast<int>(acc);
}

enum Calib { kChain, kPar8 };

// kChain: K dependent x = x * 1.0000001f + b (the reference: K = 1024);
// kPar8: 8 independent chains of K (the reference: 128) from x_j = a + j
// with b = a, then summed in order.
template <int KIND>
__global__ void calib_probe_kernel(const float* a, const float* b, int n,
                                   int outer, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c = 1.0000001f;
  if constexpr (KIND == kChain) {
    float x = a[i];
    const float y = b[i];
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = x * c + y;
    }
    out[i] = x;
  } else {
    const float y = a[i];
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = a[i] + static_cast<float>(j);
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = x[j] * c + y;
      }
    }
    float r = x[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) r = r + x[j];
    out[i] = r;
  }
}

constexpr int kShellArrays = 8;
constexpr int kShellThreads = 128;  // the shell's block
constexpr int kShellLoads = 8;      // float4 loads a thread has in flight before it stores
constexpr int kLaneThreads = 128;  // the round kernels' block
constexpr int kMaxStageLevels = 8;  // must match utils/cuda_build.py MAX_LEVELS

struct ShellParams {
  const float* in[kShellArrays];
  float* out[kShellArrays];
  int n;  // floats an array
};

__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
}

// o = i + 1 over the first ARRAYS arrays of n floats, streamed: a
// grid-stride loop over tiles of kShellThreads x U float4s of each array
// (U = kShellLoads / ARRAYS), every thread issuing its kShellLoads
// independent 16-byte loads before its first store. The loads are
// evict-first (ld.global.cs: each input is read once); the stores are
// plain, so a caller that writes the same outputs again finds their
// lines still in L2 (on an H100 SXM, evict-first stores were no faster
// into new outputs and up to 7% slower into the same ones). A partial
// last tile checks each float4, and block 0's first threads take the
// n % 4 floats past the last whole float4.
template <int ARRAYS>
__global__ void __launch_bounds__(kShellThreads) shell_copy_kernel(const ShellParams p) {
  constexpr int U = kShellLoads / ARRAYS;
  constexpr int kTile = kShellThreads * U;  // float4s of each array a block-step
  const int n4 = p.n / 4;
  for (int base = blockIdx.x * kTile; base < n4; base += gridDim.x * kTile) {
    const bool whole = base + kTile <= n4;
    float4 v[ARRAYS][U];
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) {
      const float4* in = reinterpret_cast<const float4*>(p.in[a]) + base + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (whole || base + u * kShellThreads + static_cast<int>(threadIdx.x) < n4)
          v[a][u] = __ldcs(in + u * kShellThreads);
      }
    }
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) {
      float4* out = reinterpret_cast<float4*>(p.out[a]) + base + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (whole || base + u * kShellThreads + static_cast<int>(threadIdx.x) < n4)
          out[u * kShellThreads] = plus_one(v[a][u]);
      }
    }
  }
  const int k = 4 * n4 + static_cast<int>(threadIdx.x);
  if (blockIdx.x == 0 && k < p.n) {
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) p.out[a][k] = p.in[a][k] + 1.0f;
  }
}

struct PreambleParams {
  const float* ray[6];  // ox, oy, oz, dx, dy, dz [n]
  const float* bounds;  // lower[3], upper[3]
  int n;
  float* out[8];
};

__global__ void __launch_bounds__(kLaneThreads) preamble_probe_kernel(const PreambleParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float o[3] = {p.ray[0][i], p.ray[1][i], p.ray[2][i]};
  const float d[3] = {p.ray[3][i], p.ray[4][i], p.ray[5][i]};
  const hako::Ray r = hako::ray_preamble(p.bounds, o, d);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p.out[a][i] = r.t0[a] + r.t1[a];
    p.out[3 + a][i] = r.dt[a];
  }
  p.out[6][i] = static_cast<float>(r.vm6);
  p.out[7][i] = r.enter_ok ? 1.0f : 0.0f;
}

// The reference's node-table forms (hako_kernels._gather_node_any), which
// decide what a child index past a level fetches.
enum NodeForm { kFormSmem, kFormTaa, kFormSplit };

struct StageParams {
  const float* ray[7];  // ox, oy, oz, dx, dy, dz, tq [n]
  const float* bounds;
  uint32_t root_lo, root_hi;
  const uint32_t* levels;  // root-down (mask_lo, mask_hi, base) triples
  int level_off[kMaxStageLevels], level_n[kMaxStageLevels];
  int level_form[kMaxStageLevels], level_rows[kMaxStageLevels];
  int T, clip, n;
  int* out_i[3];    // child, cell, rank (stages 0-3: child)
  float* out_f[5];  // en, ex, exit planes x y z (stages 0-3: en, ex)
};

// The node the reference's gather gives for `child` at root-down level d:
// the smem form clips the index to [0, 63], the taa form its row to
// [0, rows - 1]; every form reads zeros past the level's nodes.
__device__ __forceinline__ void level_node(const StageParams& p, int d, int child,
                                           uint32_t& lo, uint32_t& hi, uint32_t& base) {
  int i = child;
  if (p.level_form[d] == kFormSmem) {
    i = min(max(child, 0), 63);
  } else if (p.level_form[d] == kFormTaa) {
    i = min(max(child >> 7, 0), p.level_rows[d] - 1) * 128 + (child & 127);
  }
  if (i < 0 || i >= p.level_n[d]) {
    lo = hi = base = 0u;
    return;
  }
  const uint32_t* node = p.levels + 3 * (p.level_off[d] + i);
  lo = node[0];
  hi = node[1];
  base = node[2];
}

template <int STAGE>
__global__ void __launch_bounds__(kLaneThreads) probe_stage_kernel(const StageParams p) {
  using namespace hako;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float o[3] = {p.ray[0][i], p.ray[1][i], p.ray[2][i]};
  const float d[3] = {p.ray[3][i], p.ray[4][i], p.ray[5][i]};
  const Ray r = ray_preamble(p.bounds, o, d);
  const float tq = p.ray[6][i];
  float cur[3] = {r.t1[0], r.t1[1], r.t1[2]};
  float dc[3] = {r.dt[0] * 0.25f, r.dt[1] * 0.25f, r.dt[2] * 0.25f};
  if constexpr (STAGE == 4) {
    uint32_t mlo = p.root_lo, mhi = p.root_hi, base = 0u;
    Walk w{kMaxFloat, kMaxFloat, 64};
    float nt1[3] = {0.0f, 0.0f, 0.0f};
    int rank = 0, child = 0;
    for (int depth = 0; depth < p.T; ++depth) {
      w = walk64(mlo, mhi, r.vm6, cur, dc, tq);
      int cx, cy, cz;
      coords(w.c, cx, cy, cz);
      nt1[0] = plane(cur[0], dc[0], min(cx + 1, 4));
      nt1[1] = plane(cur[1], dc[1], min(cy + 1, 4));
      nt1[2] = plane(cur[2], dc[2], min(cz + 1, 4));
      rank = static_cast<int>(pc64_below_clipped(mlo, mhi, w.c ^ r.vm6));
      child = static_cast<int>(base) + rank;
      if (depth < p.T - 1) {
        level_node(p, depth, child, mlo, mhi, base);
        for (int a = 0; a < 3; ++a) {
          cur[a] = nt1[a];
          dc[a] = dc[a] * 0.25f;
        }
      }
    }
    p.out_i[0][i] = child;
    p.out_i[1][i] = w.c;
    p.out_i[2][i] = rank;
    p.out_f[0][i] = w.en;
    p.out_f[1][i] = w.ex;
    p.out_f[2][i] = nt1[0];
    p.out_f[3][i] = nt1[1];
    p.out_f[4][i] = nt1[2];
  } else {
    const Walk w = walk64(p.root_lo, p.root_hi, r.vm6, cur, dc, tq);
    int child = w.c;
    if constexpr (STAGE >= 1) {
      int cx, cy, cz;
      coords(w.c, cx, cy, cz);
      const float nt1[3] = {plane(cur[0], dc[0], min(cx + 1, 4)),
                            plane(cur[1], dc[1], min(cy + 1, 4)),
                            plane(cur[2], dc[2], min(cz + 1, 4))};
      const int rank =
          static_cast<int>(pc64_below_clipped(p.root_lo, p.root_hi, w.c ^ r.vm6));
      child = rank;
      if constexpr (STAGE >= 2) {
        uint32_t ml2, mh2, b2;
        level_node(p, 0, min(max(child, 0), p.clip), ml2, mh2, b2);
        child = static_cast<int>(b2) + rank;
        if constexpr (STAGE >= 3) {
          const float dc2[3] = {dc[0] * 0.25f, dc[1] * 0.25f, dc[2] * 0.25f};
          child = child + walk64(ml2, mh2, r.vm6, nt1, dc2, tq).c;
        }
      }
    }
    p.out_i[0][i] = child;
    p.out_f[0][i] = w.en;
    p.out_f[1][i] = w.ex;
  }
}

// ---------------------------------------------------------------------------
// 2D gathers within a tile, shared-memory capacity, the one-hot gather
// ---------------------------------------------------------------------------

constexpr int kTaaThreads = 256;  // a block a tile (16 x 128 outputs: 8 a thread)
enum TaaForm { kTaaShared, kTaaShfl, kTaaGlobal };

struct TaaParams {
  const int* t;    // [B, R, C]
  const int* idx;  // [B, r, Ci]
  int* out;        // [B, r, c_out]
  int R, C, r, Ci, c_out;
  int mask;        // the reference's modulus - 1 (a power of two), or -1: none
};

// One tile: out[i, j] = src[i, idx[i, j] & mask] (AXIS 1) or
// src[idx[i, j] & mask, j] (AXIS 0), four outputs a thread a pass (one
// 16-byte index load, one 16-byte store); src in shared memory, or the
// tile in global memory read through L1.
template <int AXIS, bool LDG>
__device__ __forceinline__ void gather_tile(const TaaParams& p, const int* src, int b) {
  const int quads = p.c_out / 4;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out;
  for (int v = threadIdx.x; v < p.r * quads; v += blockDim.x) {
    const int i = v / quads;
    const int j = (v - i * quads) * 4;
    const int4 x = __ldg(reinterpret_cast<const int4*>(idx + i * p.Ci + j));
    int o[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = o[q] & p.mask;
      const int at = AXIS == 1 ? i * p.C + m : m * p.C + j + q;
      o[q] = LDG ? __ldg(src + at) : src[at];
    }
    *reinterpret_cast<int4*>(out + i * p.c_out + j) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

// One tile along axis 1, a warp a row: lane l holds t[i, l + 32 q] for
// q < Q (Q = C / 32), and takes column c as the shuffle of register c / 32
// from lane c % 32 (every register is shuffled; a select keeps the one).
template <int Q>
__device__ __forceinline__ void shfl_rows(const TaaParams& p, int b) {
  const int lane = threadIdx.x & 31;
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out;
  for (int i = threadIdx.x >> 5; i < p.r; i += blockDim.x >> 5) {
    int reg[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) reg[q] = __ldg(tile + i * p.C + 32 * q + lane);
    for (int j = lane; j < p.c_out; j += 32) {  // c_out % 32 == 0: warp-uniform
      const int c = __ldg(idx + i * p.Ci + j) & p.mask;
      int v = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = __shfl_sync(kFull, reg[q], c & 31);
        v = (c >> 5) == q ? s : v;
      }
      out[i * p.c_out + j] = v;
    }
  }
}

template <int AXIS, int FORM>
__global__ void __launch_bounds__(kTaaThreads) take_along_probe_kernel(const TaaParams p) {
  extern __shared__ int4 s_taa_tile[];
  const int b = blockIdx.x;
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  if constexpr (FORM == kTaaShared) {
    const int4* t4 = reinterpret_cast<const int4*>(tile);
    for (int v = threadIdx.x; v < p.R * p.C / 4; v += blockDim.x) s_taa_tile[v] = __ldg(t4 + v);
    __syncthreads();
    gather_tile<AXIS, false>(p, reinterpret_cast<const int*>(s_taa_tile), b);
  } else if constexpr (FORM == kTaaGlobal) {
    gather_tile<AXIS, true>(p, tile, b);
  } else {
    static_assert(AXIS == 1, "the shuffle form gathers along a row");
    if (p.C == 128) {
      shfl_rows<4>(p, b);
    } else {
      shfl_rows<8>(p, b);
    }
  }
}

// Axis 0 from shared memory (the SHARED form along columns), a block a
// slice of `slice` columns of one tile (a multiple of 8: a 32-byte sector
// of a row lies in one slice; the tile's last slice may be narrower, a
// multiple of 4). Output column j reads column j of the tile alone, so a
// block stages only the sectors of its slice that its indices reach: (1)
// it loads its indices, kTaaQuads 16-byte loads a thread in flight (the
// first of them kept in registers for step 3), and marks in shared memory
// each (row, sector) they reach (any writer of the 1 wins); (2) after a
// barrier it stages the marked sectors, kTaaStage 16-byte loads a thread
// in flight before their stores; (3) after a barrier it gathers from the
// slice. An index outside the tile (mod 0 takes idx as it is) is not
// marked and reads the tile through L1, as the GLOBAL form does. Bound:
// bytes (the reached sectors, the indices and the output once); the
// slices of one tile spread its loads over several SMs, and several
// small blocks an SM overlap one block's staging with another's gather.
// The wrapper picks the slice (ops/probes.taa0_slice), takes whole tiles
// instead (take_along_probe_kernel<0, SHARED>) where the indices reach
// nearly every sector of a batch that fills the card or of a tile a
// block stages in one load a thread (ops/probes.taa0_whole: k_taa0's
// batch, a0small's 8-row tile), and keeps the whole-tile
// refusal (a tile over a block's opt-in shared memory), as the
// reference's FAIL.
constexpr int kTaa0Threads = 128;  // 256 took 1.6x k_taa0's time (PERF.md §6)
constexpr int kTaaSector = 8;    // int32 columns of a 32-byte sector
constexpr int kTaaQuads = 2;     // 16-byte index loads a thread has in flight
constexpr int kTaaStage = 4;     // 16-byte staging loads a thread has in flight

// Registers: at most 40 a thread (12 blocks of 128 an SM).
__global__ void __launch_bounds__(kTaa0Threads, 12)
    take_along_a0_kernel(const TaaParams p, int slice, int slices) {
  extern __shared__ int4 s_taa_slice[];
  int* s_cols = reinterpret_cast<int*>(s_taa_slice);  // [R][slice]
  const int b = blockIdx.x / slices;
  const int j0 = (blockIdx.x - b * slices) * slice;
  const int w = min(slice, p.C - j0);                  // columns of this slice
  const int nsec = (w + kTaaSector - 1) / kTaaSector;
  const int quads = w / 4;
  const int n_quads = p.r * quads;
  const int step = blockDim.x * kTaaQuads;
  unsigned char* s_mark = reinterpret_cast<unsigned char*>(s_cols + p.R * slice);  // [R][nsec]
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci + j0;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out + j0;
  const unsigned rows = static_cast<unsigned>(p.R);
  auto load = [&](int base, int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int i = v / quads;
        x[u] = __ldg(reinterpret_cast<const int4*>(idx + i * p.Ci + 4 * (v - i * quads)));
      }
    }
  };
  auto mark = [&](int base, const int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int q = v - v / quads * quads;
        const int m[4] = {x[u].x & p.mask, x[u].y & p.mask, x[u].z & p.mask, x[u].w & p.mask};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (static_cast<unsigned>(m[e]) < rows)
            s_mark[m[e] * nsec + (4 * q + e) / kTaaSector] = 1;
        }
      }
    }
  };
  auto gather = [&](int base, const int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int i = v / quads;
        const int q = v - i * quads;
        int o[4] = {x[u].x & p.mask, x[u].y & p.mask, x[u].z & p.mask, x[u].w & p.mask};
        if (p.mask >= 0) {  // a modulus (at most R): every index lies in the tile
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = s_cols[o[e] * slice + 4 * q + e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = static_cast<unsigned>(o[e]) < rows
                       ? s_cols[o[e] * slice + 4 * q + e]
                       : __ldg(tile + static_cast<long long>(o[e]) * p.C + j0 + 4 * q + e);
          }
        }
        *reinterpret_cast<int4*>(out + i * p.c_out + 4 * q) = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
  };
  int4 first[kTaaQuads];
  load(0, first);
  for (int v = threadIdx.x; v < p.R * nsec; v += blockDim.x) s_mark[v] = 0;
  __syncthreads();
  mark(0, first);
  for (int base = step; base < n_quads; base += step) {
    int4 x[kTaaQuads];
    load(base, x);
    mark(base, x);
  }
  __syncthreads();
  const int halves = p.R * nsec * 2;  // 16-byte halves of the slice's sectors
  for (int base = 0; base < halves; base += blockDim.x * kTaaStage) {
    int4 v[kTaaStage];
    int at[kTaaStage];
#pragma unroll
    for (int u = 0; u < kTaaStage; ++u) {
      const int h = base + u * blockDim.x + threadIdx.x;
      at[u] = -1;
      if (h < halves) {
        const int sec = h >> 1;
        const int row = sec / nsec;
        const int jj = (sec - row * nsec) * kTaaSector + 4 * (h & 1);
        if (jj < w && s_mark[sec]) {
          at[u] = row * slice + jj;
          v[u] = __ldg(reinterpret_cast<const int4*>(tile + static_cast<size_t>(row) * p.C +
                                                     j0 + jj));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTaaStage; ++u) {
      if (at[u] >= 0) *reinterpret_cast<int4*>(s_cols + at[u]) = v[u];
    }
  }
  __syncthreads();
  gather(0, first);
  for (int base = step; base < n_quads; base += step) {
    int4 x[kTaaQuads];
    load(base, x);
    gather(base, x);
  }
}

// Raise a kernel's dynamic shared memory limit where `bytes` needs it; on a
// refusal, clear the error so that the next launch's check is not blamed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <int AXIS, int FORM>
int launch_taa(const TaaParams& p, int B, cudaStream_t s) {
  const size_t smem = FORM == kTaaShared ? static_cast<size_t>(p.R) * p.C * sizeof(int) : 0;
  const cudaError_t e = allow_smem(take_along_probe_kernel<AXIS, FORM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  take_along_probe_kernel<AXIS, FORM><<<B, kTaaThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// slice: 0 for whole tiles, a block a tile (ops/probes.taa0_whole), else
// a positive multiple of the sector (ops/probes.taa0_slice).
int launch_taa0_shared(const TaaParams& p, int B, int slice, cudaStream_t s) {
  if (slice == 0) return launch_taa<0, kTaaShared>(p, B, s);
  if (slice < 0 || slice % kTaaSector) return cudaErrorInvalidValue;
  const int slices = (p.C + slice - 1) / slice;
  if (static_cast<long long>(B) * slices > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t marks = (static_cast<size_t>(p.R) * (slice / kTaaSector) + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(p.R) * slice * sizeof(int) + marks;
  const cudaError_t e = allow_smem(take_along_a0_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  take_along_a0_kernel<<<B * slices, kTaa0Threads, smem, s>>>(p, slice, slices);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSmemRowFloats = 128;  // the reference's scratch row

__global__ void smem_alloc_probe_kernel(const float* x, float* out, int n_rows) {
  extern __shared__ float s_alloc_rows[];  // n_rows x 128
  const int j = threadIdx.x;
  const size_t last = static_cast<size_t>(n_rows - 1) * kSmemRowFloats + j;
  const float v = x[j] * 2.0f;
  s_alloc_rows[j] = v;
  s_alloc_rows[last] = v;
  __syncthreads();
  out[j] = s_alloc_rows[j] + s_alloc_rows[last];
}

enum OhgMode { kOhgShared, kOhgGlobal, kOhgMma };
constexpr int kOhgCols = 128;   // the table's row
constexpr int kOhgGroup = 16;   // lanes an mma's A fragment holds (its M)
constexpr int kOhgPlanes = 3;   // byte planes of a table value (< 2^24)
constexpr int kOhgChunk = 32;   // table rows an mma takes (its K)
constexpr int kOhgTiles = kOhgCols / 8;          // 8-column n-tiles of a row: a warp each
constexpr int kOhgMmaThreads = 32 * kOhgTiles;   // 512
constexpr int kOhgChunkFrags = kOhgTiles * kOhgPlanes * 32;  // B fragments (uint2) of a chunk
constexpr int kOhgBatch = 4;    // 16-lane groups whose accumulators a warp holds at once

// Byte p of four words, packed from the low byte up: a B register of
// byte plane p.
__device__ __forceinline__ uint32_t byte_plane(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3, int p) {
  const uint32_t sel = static_cast<uint32_t>(p) | (static_cast<uint32_t>(p + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// The one-hot byte of an A register: byte d (0-3) set to 1, or none.
__device__ __forceinline__ uint32_t one_hot(int d) {
  return static_cast<unsigned>(d) < 4u ? 1u << (8 * d) : 0u;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// SHARED / GLOBAL: k hops of idx = (idx + flat[idx]) & (n_rows * 128 - 1),
// a thread a lane, kUnroll hops a pass of the outer loop.
template <int MODE>
__global__ void ohg_probe_kernel(const int* table, int n_rows, const int* idx0, int n,
                                 int k, int* out) {
  const uint32_t wrap = static_cast<uint32_t>(n_rows) * kOhgCols - 1u;
  extern __shared__ int4 s_ohg_table[];
  const int* s_tab = reinterpret_cast<const int*>(s_ohg_table);
  if constexpr (MODE == kOhgShared) {
    const int4* t4 = reinterpret_cast<const int4*>(table);
    for (int v = threadIdx.x; v < n_rows * kOhgCols / 4; v += blockDim.x)
      s_ohg_table[v] = __ldg(t4 + v);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x = i < n ? static_cast<uint32_t>(idx0[i]) : 0u;
#pragma unroll 1
  for (int o = 0; o < k / kUnroll; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = MODE == kOhgShared ? s_tab[x] : __ldg(table + x);
      x = (x + static_cast<uint32_t>(w)) & wrap;
    }
  }
  if (i < n) out[i] = static_cast<int>(x);
}

// What a warp of the MMA mode's block needs of its place: its block's B
// fragments and first chunk, its n-tile (its warp), its lane (g, t) and
// its block's rank in the cluster.
struct OhgWarp {
  const uint2* frag;
  int chunks, c0, nt, lane, g, t, rank;
};

// One hop of a cluster's G 16-lane groups: this block's partial of the
// one-hot product at each lane's column, into slot `rank` of the lane in
// `part` ([CL][16 G]) of every block of the cluster. Each
// row's one-hot A registers (row g and g + 8 of a group; bytes at
// columns 4t..4t+3 and 16+4t..16+4t+3 of its 32-row chunk) are built
// once, with the block's chunk that holds the row: every other chunk's
// registers are 0, and its mma runs all the same.
template <int CL, int G>
__device__ __forceinline__ void ohg_partials(const OhgWarp& w, const uint32_t (&xa)[G],
                                             const uint32_t (&xb)[G], int* part) {
  constexpr int kLanes = kOhgGroup * G;
  constexpr int kB = G < kOhgBatch ? G : kOhgBatch;
  auto put = [&](int at, int v) {
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int r = 0; r < CL; ++r) cluster.map_shared_rank(part, r)[w.rank * kLanes + at] = v;
    } else {
      part[at] = v;
    }
  };
#pragma unroll
  for (int gb = 0; gb < G; gb += kB) {
    int acc[kB][kOhgPlanes][4] = {};
    uint32_t a[kB][4];
    int ka[kB], kb[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int ra = static_cast<int>(xa[gb + u] >> 7), rb = static_cast<int>(xb[gb + u] >> 7);
      ka[u] = (ra >> 5) - w.c0;
      kb[u] = (rb >> 5) - w.c0;
      const int oa = (ra & (kOhgChunk - 1)) - 4 * w.t, ob = (rb & (kOhgChunk - 1)) - 4 * w.t;
      a[u][0] = one_hot(oa);
      a[u][1] = one_hot(ob);
      a[u][2] = one_hot(oa - 16);
      a[u][3] = one_hot(ob - 16);
    }
#pragma unroll 2
    for (int kc = 0; kc < w.chunks; ++kc) {
      const uint2* bp = w.frag + (kc * kOhgTiles + w.nt) * kOhgPlanes * 32 + w.lane;
      const uint2 b[kOhgPlanes] = {bp[0], bp[32], bp[64]};
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const uint32_t a0 = kc == ka[u] ? a[u][0] : 0u, a2 = kc == ka[u] ? a[u][2] : 0u;
        const uint32_t a1 = kc == kb[u] ? a[u][1] : 0u, a3 = kc == kb[u] ? a[u][3] : 0u;
#pragma unroll
        for (int p = 0; p < kOhgPlanes; ++p) mma_u8(acc[u][p], a0, a1, a2, a3, b[p].x, b[p].y);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      int v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = acc[u][0][r] + (acc[u][1][r] << 8) + (acc[u][2][r] << 16);
      const int ca = static_cast<int>(xa[gb + u] & 127u), cb = static_cast<int>(xb[gb + u] & 127u);
      const int at = kOhgGroup * (gb + u) + w.g;
      if ((ca >> 3) == w.nt && ((ca & 7) >> 1) == w.t) put(at, (ca & 1) ? v[1] : v[0]);
      if ((cb >> 3) == w.nt && ((cb & 7) >> 1) == w.t) put(at + 8, (cb & 1) ? v[3] : v[2]);
    }
  }
}

// Every group's step: idx += the sum of the cluster's slots, masked.
template <int CL, int G>
__device__ __forceinline__ void ohg_step(uint32_t (&xa)[G], uint32_t (&xb)[G], const int* part,
                                         int g, uint32_t wrap) {
  constexpr int kLanes = kOhgGroup * G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    uint32_t sa = 0u, sb = 0u;
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      sa += static_cast<uint32_t>(part[r * kLanes + kOhgGroup * gi + g]);
      sb += static_cast<uint32_t>(part[r * kLanes + kOhgGroup * gi + g + 8]);
    }
    xa[gi] = (xa[gi] + sa) & wrap;
    xb[gi] = (xb[gi] + sb) & wrap;
  }
}

// MMA: the reference's MXU gather on the tensor cores, k dependent hops
// of the full one-hot product a hop. A cluster of CL blocks chases 16 G
// lanes; block `rank` holds table rows [rank, rank + 1) x n_rows / CL as
// their three byte planes (values < 2^24), split from the words once a
// call while they are staged, stored in the order mma.sync m16n8k32 u8
// reads its B fragments: s_frag[(kc * 16 + nt) * 3 + p][lane] = (b0, b1),
// the bytes of rows 32 kc + 4t..4t+3 and 32 kc + 16 + 4t..16 + 4t+3 at
// column 8 nt + g (g = lane / 4, t = lane % 4). Warp nt of each block
// computes n-tile nt (8 columns) for every lane: each hop it builds the
// one-hot A fragments of the lanes' rows and runs one mma a chunk, plane
// and group over EVERY chunk the block holds, zero one-hot or not, and
// every n-tile of the row: the probe measures the full product, as the
// reference computes it (a gather would skip the zero chunks and the
// other tiles). Its int8 operations are 2 x lanes x n_rows x 128 x 3 a
// hop. The block's partial p0 + (p1 << 8) + (p2 << 16) at each lane's
// column (exact: at most one non-zero term a sum) goes to every block of
// the cluster through distributed shared memory, one slot a block and
// lane, double-buffered by the hop's parity; after the cluster barrier (a
// block barrier for CL = 1) every thread sums the slots of its lanes and
// steps their indices. No B fragment is loaded from global memory or split
// in the hop loop. Bound:
// operations, int8 on the tensor cores; the design spreads 2,048 lanes
// over 128 blocks of 16 warps (128 / CL clusters, as many as the card
// holds at once for CL <= 2) and keeps the table in shared memory, split
// across the cluster where it exceeds one SM's. wgmma's m64 tile would
// give a block 64 lanes, half the blocks: measured so (A in registers, B
// from shared memory), it was 17% slower at 128 rows and 4% faster at
// 1024 (PERF.md §6).
template <int CL, int G>
__global__ void __launch_bounds__(kOhgMmaThreads, 1)
    ohg_mma_kernel(const int* table, int n_rows, const int* idx0, int n, int k, int* out) {
  constexpr int kLanes = kOhgGroup * G;  // a cluster's lanes: each of its blocks holds all
  extern __shared__ uint2 s_ohg_frag[];
  OhgWarp w;
  w.frag = s_ohg_frag;
  w.chunks = n_rows / kOhgChunk / CL;  // 32-row chunks this block holds
  int* s_part = reinterpret_cast<int*>(s_ohg_frag + w.chunks * kOhgChunkFrags);  // [2][CL][kLanes]
  w.lane = threadIdx.x & 31;
  w.nt = threadIdx.x >> 5;
  w.g = w.lane >> 2;
  w.t = w.lane & 3;
  w.rank = 0;
  if constexpr (CL > 1) w.rank = static_cast<int>(cg::this_cluster().block_rank());
  w.c0 = w.rank * w.chunks;
  const int first = blockIdx.x / CL * kLanes;
  const uint32_t wrap = static_cast<uint32_t>(n_rows) * kOhgCols - 1u;
  for (int v = threadIdx.x; v < w.chunks * kOhgTiles * 32; v += blockDim.x) {
    const int fl = v & 31, ft = (v >> 5) % kOhgTiles, kc = v / (32 * kOhgTiles);
    const int* col = table +
                     static_cast<size_t>((w.c0 + kc) * kOhgChunk + 4 * (fl & 3)) * kOhgCols +
                     8 * ft + (fl >> 2);
    uint32_t word[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      word[j] = static_cast<uint32_t>(__ldg(col + j * kOhgCols));
      word[4 + j] = static_cast<uint32_t>(__ldg(col + (16 + j) * kOhgCols));
    }
    uint2* dst = s_ohg_frag + (kc * kOhgTiles + ft) * kOhgPlanes * 32 + fl;
#pragma unroll
    for (int p = 0; p < kOhgPlanes; ++p) {
      dst[p * 32] = make_uint2(byte_plane(word[0], word[1], word[2], word[3], p),
                               byte_plane(word[4], word[5], word[6], word[7], p));
    }
  }
  uint32_t xa[G], xb[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int la = first + kOhgGroup * gi + w.g;
    xa[gi] = la < n ? static_cast<uint32_t>(idx0[la]) : 0u;
    xb[gi] = la + 8 < n ? static_cast<uint32_t>(idx0[la + 8]) : 0u;
  }
  if constexpr (CL > 1) {
    cg::this_cluster().sync();  // the fragments staged, every block of the cluster running
  } else {
    __syncthreads();
  }
#pragma unroll 1
  for (int h = 0; h < k; ++h) {
    int* part = s_part + (h & 1) * CL * kLanes;
    ohg_partials<CL, G>(w, xa, xb, part);
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    ohg_step<CL, G>(xa, xb, part, w.g, wrap);
  }
  if (w.rank == 0 && w.nt == 0 && w.t == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int la = first + kOhgGroup * gi + w.g;
      if (la < n) out[la] = static_cast<int>(xa[gi]);
      if (la + 8 < n) out[la + 8] = static_cast<int>(xb[gi]);
    }
  }
}

// One cluster of CL blocks a 16 CL lanes (G = CL groups); the launch
// carries the cluster shape (cudaLaunchKernelEx).
template <int CL>
cudaLaunchConfig_t ohg_mma_config(int n_rows, int n, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kOhgGroup * CL - 1) / (kOhgGroup * CL) * CL);
  cfg.blockDim = dim3(kOhgMmaThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_rows / kOhgChunk / CL) * kOhgChunkFrags *
                             sizeof(uint2) + 2 * CL * kOhgGroup * CL * sizeof(int);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CL>
int launch_ohg_mma(const int* tab, int n_rows, const int* start, int n, int k, int* o,
                   cudaStream_t s) {
  if (n_rows / kOhgChunk < CL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = ohg_mma_config<CL>(n_rows, n, s, &attr);
  if (CL == 1) cfg.numAttrs = 0;
  void (*kernel)(const int*, int, const int*, int, int, int*) = ohg_mma_kernel<CL, CL>;
  cudaError_t e = allow_smem(kernel, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, kernel, tab, n_rows, start, n, k, o);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The clusters of CL blocks the card holds at once (cudaOccupancyMaxActiveClusters),
// or minus the CUDA error.
template <int CL>
int ohg_mma_clusters(int n_rows) {
  if (n_rows / kOhgChunk < CL) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ohg_mma_config<CL>(n_rows, kOhgGroup * CL, nullptr, &attr);
  void (*kernel)(const int*, int, const int*, int, int, int*) = ohg_mma_kernel<CL, CL>;
  cudaError_t e = allow_smem(kernel, cfg.dynamicSmemBytes);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return clusters;
}

inline int lane_blocks(int n) { return (n + kLaneThreads - 1) / kLaneThreads; }

bool launch_shape_ok(int n, int k, int threads) {
  return n > 0 && k > 0 && k % kUnroll == 0 && threads > 0 && threads <= 1024 &&
         threads % 32 == 0;
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
                                 const void* dc, int n, int iters, int scan,
                                 int threads, void* out, void* stream) {
  if (n <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const auto* l = static_cast<const uint32_t*>(lo);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* a = static_cast<const float*>(t1);
  const auto* d = static_cast<const float*>(dc);
  auto* o = static_cast<int*>(out);
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scan) {
    walk_probe_kernel<true><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, o);
  } else {
    walk_probe_kernel<false><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fetch_probe_launch(const void* rows, const void* row_of, int n,
                                  int iters, int threads, void* out, void* stream) {
  if (n <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  fetch_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int*>(row_of), n,
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int construct_probe_launch(int kind, const void* fa, const void* fb,
                                      const void* ia, const void* ua,
                                      const void* ub, int n, int k, void* out,
                                      int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(fa);
  const auto* b = static_cast<const float*>(fb);
  const auto* x = static_cast<const int*>(ia);
  const auto* m0 = static_cast<const uint32_t*>(ua);
  const auto* m1 = static_cast<const uint32_t*>(ub);
  const int outer = k / kUnroll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMinMax: return launch_construct<kMinMax>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kCmpSel: return launch_construct<kCmpSel>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kInt: return launch_construct<kInt>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kVShift: return launch_construct<kVShift>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kBarrel: return launch_construct<kBarrel>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kI2F: return launch_construct<kI2F>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kBitAt: return launch_construct<kBitAt>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kPc64: return launch_construct<kPc64>(a, b, x, m0, m1, n, outer, out, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

// table: int32 [n_nodes, 3] on the device, n_nodes a power of two <= 4096.
extern "C" int node_gather_probe_launch(int space, const void* table,
                                        int n_nodes, const void* idx0, int n,
                                        int k, void* acc, void* fold,
                                        int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads) || n_nodes <= 0 || n_nodes > kMaxNodes ||
      (n_nodes & (n_nodes - 1)))
    return cudaErrorInvalidValue;
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* start = static_cast<const int*>(idx0);
  auto* a = static_cast<int*>(acc);
  auto* f = static_cast<int*>(fold);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  const size_t bytes = static_cast<size_t>(n_nodes) * 3 * sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (space) {
    case kGlobal:
      node_gather_probe_kernel<kGlobal><<<blocks, threads, 0, s>>>(
          tab, n_nodes, start, n, outer, a, f);
      break;
    case kShared: {
      if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            node_gather_probe_kernel<kShared>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      node_gather_probe_kernel<kShared><<<blocks, threads, bytes, s>>>(
          tab, n_nodes, start, n, outer, a, f);
      break;
    }
    case kConstant: {
      const cudaError_t e = cudaMemcpyToSymbolAsync(
          c_nodes, tab, bytes, 0, cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      node_gather_probe_kernel<kConstant><<<blocks, threads, 0, s>>>(
          tab, n_nodes, start, n, outer, a, f);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [64, 3] on the device.
extern "C" int table_select_probe_launch(int form, const void* tab,
                                         const void* idx0, int n, int k,
                                         void* out, int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* start = static_cast<const int*>(idx0);
  auto* o = static_cast<int*>(out);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kSelConstant: {
      const cudaError_t e = cudaMemcpyToSymbolAsync(
          c_select, t, sizeof(c_select), 0, cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      table_select_probe_kernel<kSelConstant><<<blocks, threads, 0, s>>>(t, start, n, outer, o);
      break;
    }
    case kSelShared:
      table_select_probe_kernel<kSelShared><<<blocks, threads, 0, s>>>(t, start, n, outer, o);
      break;
    case kSelShuffle:
      table_select_probe_kernel<kSelShuffle><<<blocks, threads, 0, s>>>(t, start, n, outer, o);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int calib_probe_launch(int kind, const void* a, const void* b, int n,
                                  int k, void* out, int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(a);
  const auto* y = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kChain: calib_probe_kernel<kChain><<<blocks, threads, 0, s>>>(x, y, n, outer, o); break;
    case kPar8: calib_probe_kernel<kPar8><<<blocks, threads, 0, s>>>(x, y, n, outer, o); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// in / out: host arrays of 8 device pointers (AOS: the first of each);
// n floats an array. One wave of blocks at most (the SMs x the blocks an
// SM holds), fewer where the tiles are fewer.
extern "C" int shell_copy_probe_launch(int aos, const void* const* in,
                                       void* const* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  ShellParams p{};
  for (int a = 0; a < (aos ? 1 : kShellArrays); ++a) {
    p.in[a] = static_cast<const float*>(in[a]);
    p.out[a] = static_cast<float*>(out[a]);
  }
  p.n = n;
  void (*kernel)(ShellParams) = aos ? &shell_copy_kernel<1> : &shell_copy_kernel<kShellArrays>;
  const int tile = kShellThreads * (aos ? kShellLoads : kShellLoads / kShellArrays);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kShellThreads, 0);
  const int tiles = (n / 4 + tile - 1) / tile;
  const int wave = sms * per_sm > 0 ? sms * per_sm : 1;
  const int blocks = tiles < 1 ? 1 : (tiles < wave ? tiles : wave);
  kernel<<<blocks, kShellThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ray: host array of 6 device pointers, out of 8; bounds a device [6].
extern "C" int preamble_probe_launch(const void* const* ray, const void* bounds,
                                     int n, void* const* out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  PreambleParams p{};
  for (int a = 0; a < 6; ++a) p.ray[a] = static_cast<const float*>(ray[a]);
  for (int a = 0; a < 8; ++a) p.out[a] = static_cast<float*>(out[a]);
  p.bounds = static_cast<const float*>(bounds);
  p.n = n;
  preamble_probe_kernel<<<lane_blocks(n), kLaneThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ray: host array of 7 device pointers (origin, direction, tq); out_i of
// 3 and out_f of 5 (stages 0-3 write the first 1 and 2); levels a device
// table, the per-level arrays host arrays of n_levels ints.
extern "C" int probe_stage_probe_launch(
    int stage, const void* const* ray, const void* bounds, unsigned root_lo,
    unsigned root_hi, const void* levels, const int* level_off,
    const int* level_n, const int* level_form, const int* level_rows,
    int n_levels, int T, int clip, int n, void* const* out_i,
    void* const* out_f, void* stream) {
  if (n <= 0 || n_levels < 0 || n_levels > kMaxStageLevels ||
      (stage == 4 ? T - 1 > n_levels || T < 1 : stage >= 2 && n_levels < 1))
    return cudaErrorInvalidValue;
  StageParams p{};
  for (int a = 0; a < 7; ++a) p.ray[a] = static_cast<const float*>(ray[a]);
  p.bounds = static_cast<const float*>(bounds);
  p.root_lo = root_lo;
  p.root_hi = root_hi;
  p.levels = static_cast<const uint32_t*>(levels);
  for (int d = 0; d < n_levels; ++d) {
    p.level_off[d] = level_off[d];
    p.level_n[d] = level_n[d];
    p.level_form[d] = level_form[d];
    p.level_rows[d] = level_rows[d];
  }
  p.T = T;
  p.clip = clip;
  p.n = n;
  for (int a = 0; a < 3; ++a) p.out_i[a] = static_cast<int*>(out_i[a]);
  for (int a = 0; a < 5; ++a) p.out_f[a] = static_cast<float*>(out_f[a]);
  const int b = lane_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: probe_stage_kernel<0><<<b, kLaneThreads, 0, s>>>(p); break;
    case 1: probe_stage_kernel<1><<<b, kLaneThreads, 0, s>>>(p); break;
    case 2: probe_stage_kernel<2><<<b, kLaneThreads, 0, s>>>(p); break;
    case 3: probe_stage_kernel<3><<<b, kLaneThreads, 0, s>>>(p); break;
    case 4: probe_stage_kernel<4><<<b, kLaneThreads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block can opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// or -1 if the device does not answer.
extern "C" int smem_optin_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return v;
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// t int32 [B, R, C], idx int32 [B, r, Ci], out int32 [B, r, c_out], all
// 16-byte aligned; mod 0 (none) or a power of two. Axis 1: r <= R, c_out
// <= Ci; axis 0: c_out == C <= Ci. SHFL: axis 1, C 128 or 256, c_out % 32
// == 0, mod <= C. SHARED: R x C x 4 bytes of shared memory along rows; along
// columns the same with `slice` 0 (whole tiles), else a slice of R x `slice`
// (a multiple of 8), only the sectors the indices reach.
extern "C" int take_along_probe_launch(int axis, int form, const void* t, const void* idx,
                                       void* out, int B, int R, int C, int r, int Ci,
                                       int c_out, int mod, int slice, void* stream) {
  const bool shapes = B > 0 && R > 0 && C > 0 && r > 0 && c_out > 0 && C % 4 == 0 &&
                      Ci % 4 == 0 && c_out % 4 == 0 && mod >= 0 && (mod & (mod - 1)) == 0 &&
                      (axis == 1 ? r <= R && c_out <= Ci : axis == 0 && c_out == C && C <= Ci);
  const bool shfl_ok = axis == 1 && (C == 128 || C == 256) && c_out % 32 == 0 && mod <= C;
  if (!shapes || form < kTaaShared || form > kTaaGlobal || (form == kTaaShfl && !shfl_ok))
    return cudaErrorInvalidValue;
  const TaaParams p{static_cast<const int*>(t), static_cast<const int*>(idx),
                    static_cast<int*>(out), R, C, r, Ci, c_out, mod ? mod - 1 : -1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    switch (form) {
      case kTaaShared: return launch_taa<1, kTaaShared>(p, B, s);
      case kTaaShfl: return launch_taa<1, kTaaShfl>(p, B, s);
      default: return launch_taa<1, kTaaGlobal>(p, B, s);
    }
  }
  return form == kTaaShared ? launch_taa0_shared(p, B, slice, s)
                            : launch_taa<0, kTaaGlobal>(p, B, s);
}

// x, out: f32 [128]. Returns the CUDA error of a refused allocation (of
// the attribute or of the launch), cleared.
extern "C" int smem_alloc_probe_launch(const void* x, void* out, int n_rows, void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(n_rows) * kSmemRowFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(smem_alloc_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess) {
    smem_alloc_probe_kernel<<<1, kSmemRowFloats, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_rows);
    e = cudaGetLastError();
  } else {
    cudaGetLastError();
  }
  return static_cast<int>(e);
}

// table int32 [n_rows, 128] (n_rows a power of two, at least 32 for MMA),
// idx0 / out int32 [n]; k a multiple of kUnroll (any k >= 1 for MMA).
// SHARED / GLOBAL: `threads` lanes a block. MMA: clusters of `cluster`
// blocks (1, 2, 4 or 8, at most n_rows / 32), 16 x cluster lanes each.
extern "C" int ohg_probe_launch(int mode, const void* table, int n_rows, const void* idx0,
                                int n, int k, void* out, int threads, int cluster,
                                void* stream) {
  if (n <= 0 || k <= 0 || threads <= 0 || threads > 1024 || threads % 32 || n_rows <= 0 ||
      (n_rows & (n_rows - 1)) || (mode == kOhgMma ? n_rows < kOhgChunk : k % kUnroll != 0))
    return cudaErrorInvalidValue;
  const auto* tab = static_cast<const int*>(table);
  const auto* start = static_cast<const int*>(idx0);
  auto* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kOhgShared: {
      const size_t bytes = static_cast<size_t>(n_rows) * kOhgCols * sizeof(int);
      const cudaError_t e = allow_smem(ohg_probe_kernel<kOhgShared>, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      ohg_probe_kernel<kOhgShared><<<(n + threads - 1) / threads, threads, bytes, s>>>(
          tab, n_rows, start, n, k, o);
      break;
    }
    case kOhgGlobal:
      ohg_probe_kernel<kOhgGlobal><<<(n + threads - 1) / threads, threads, 0, s>>>(
          tab, n_rows, start, n, k, o);
      break;
    case kOhgMma:
      switch (cluster) {
        case 1: return launch_ohg_mma<1>(tab, n_rows, start, n, k, o, s);
        case 2: return launch_ohg_mma<2>(tab, n_rows, start, n, k, o, s);
        case 4: return launch_ohg_mma<4>(tab, n_rows, start, n, k, o, s);
        case 8: return launch_ohg_mma<8>(tab, n_rows, start, n, k, o, s);
        default: return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The clusters of the MMA mode (`cluster` blocks each, on a table of
// n_rows) that the card runs at once; minus the CUDA error where it
// refuses the shape.
extern "C" int ohg_mma_max_clusters(int n_rows, int cluster) {
  switch (cluster) {
    case 1: return ohg_mma_clusters<1>(n_rows);
    case 2: return ohg_mma_clusters<2>(n_rows);
    case 4: return ohg_mma_clusters<4>(n_rows);
    case 8: return ohg_mma_clusters<8>(n_rows);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
