// The legacy HakoTree round driver's kernels on Hopper: kernel A
// (hako_probe), the round's row stage (hako_dda_merge: kernel B on the
// supernode and brick rows and the merge, in one launch), and the
// unfused kernel B (hako_dda, leaf and supernode rows, primary and
// shadow) and merge (hako_merge) that the phase-timing scripts launch
// alone. The host loop around them is
// ops/hako_kernels.py::intersect_rays_hako: each round takes the lanes
// still unresolved (an index list), runs A and then the row stage, until
// no lane is left.
//
// Replaces the Pallas kernels of massivevoxelraytracing_tpu/ops/
// hako_kernels.py: kernel A (_make_kernel_a, launched at :1218 and in its
// fused form at :1681), kernel B (_make_kernel_b :975, launched at :1252
// and fused :1700) and the merge (_make_merge_kernel :1096, launched at
// :1735). On the TPU a grid step owned a block of rays in lockstep; the
// round driver picked whole ray blocks, gathered each lane's 164-word row
// from HBM in XLA, transposed it to word-major in VMEM, and wrote the
// state back with XLA scatters; it split B and the merge into separate
// launches because its grid mapped state blocks through scalar prefetch.
// Here every kernel runs one thread per active lane, reached through the
// round's index list: B reads its own row straight from global memory by
// child id (no gather buffer, no transpose), and the merge writes the
// lane's state in place.
//
// What bounds them on an H100: each launch is a short pass over the active
// lanes (tens of bytes of state per lane in and out, plus the rows B
// touches), so at the shapes of the main path they are bound by memory
// traffic and by the DDA's issue rate (the walk64 lattice walks, as in the
// megakernel), and, late in a traversal when few lanes are left, by launch
// and host-sync latency (one "any lane active?" read per round). The
// unfused route moved every per-lane intermediate through HBM between
// launches: B's 8 outputs a stage (26 B a lane), the supernode hand-off's
// eager tensor ops, the merge's 12 input streams (~41 B a lane).
// hako_dda_merge keeps them in registers: it reads kernel A's outputs once,
// runs the supernode row, the hand-off, the brick row and the merge per
// lane (the megakernel's chain after its probe, hako_mega.cu), and writes
// only the lane's state. A round is two launches (A, then the row stage)
// with no eager op between them. A row cache for B (hako_dda_cached
// below) was measured beside hako_dda (scripts/r3_phase_split.py) and is
// not on the route.
//
// Exactness: the kernels share every __device__ function with the
// megakernel (hako_device.cuh), and the row stage evaluates the unfused
// kernels' and the merge's expressions in the same order, so the fused
// and unfused routes and the megakernel give identical bits.

#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace {

constexpr int kMaxLevels = 8;  // must match utils/cuda_build.py MAX_LEVELS
constexpr int kThreads = 128;

struct ProbeParams {
  const uint32_t* levels;  // root-down (mask_lo, mask_hi, base) triples
  int level_off[kMaxLevels];
  int T;
  uint32_t root_lo, root_hi;
  const float* bounds;  // lower[3], upper[3]
  const float* ro;      // [R, 3]
  const float* rd;      // [R, 3]
  const int* idx;       // [n] active lanes
  const float* tq;      // [R] resume keys
  int n, max_probes;
  bool* emit;
  int* child;
  float* bt1;  // [3, n]
  float* tqe;
  float* tqn;
  bool* exh;
};

// Kernel A: the lane's preamble, then up to max_probes root descents.
__global__ void __launch_bounds__(kThreads) hako_probe_kernel(const ProbeParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const int lane = p.idx[j];
  const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, lane);
  const float tq0 = p.tq[lane];
  Probe r{false, !ray.enter_ok, 0, {0.0f, 0.0f, 0.0f}, tq0, tq0, 0, 0, 0};
  if (ray.enter_ok) {
    r = probe_from_root(p.levels, p.level_off, p.T, p.root_lo, p.root_hi,
                        ray.t1, ray.dt, ray.vm6, tq0, p.max_probes);
  }
  p.emit[j] = r.emit;
  p.child[j] = r.emit ? r.child : 0;
  p.bt1[j] = r.bt1[0];
  p.bt1[p.n + j] = r.bt1[1];
  p.bt1[2 * p.n + j] = r.bt1[2];
  p.tqe[j] = r.tqe;
  p.tqn[j] = r.tqn;
  p.exh[j] = r.exh;
}

struct DdaParams {
  const uint32_t* rows;  // [N, 164] brick or supernode rows
  const float* bounds;
  const float* ro;
  const float* rd;
  const int* idx;
  int n;
  const bool* go;
  const int* child;
  const float* bt1;  // [3, n]
  const float* tqe;
  float dt_factor;
  int max_iters;
  bool* hit;  // hit (leaf) / emit (supernode)
  float* t;   // t (leaf) / exit plane x
  int* nmaj;  // face axis (leaf) / exit plane y, bit-cast
  int* vr;    // voxel rank (leaf) / child brick
  float* p3;  // exit plane z
  float* tqp; // resume key passed to the brick stage
  bool* more; // stopped at max_iters
  float* tqr; // resume key
};

// Kernel B: the row DDA of each go-lane's own row (rows[child]).
template <bool LEAF, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_dda_kernel(const DdaParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  Dda d{false, false, kMaxFloat, -1, 0u, 0.0f, 0.0f, p.tqe[j], 0, 0, 0, 0};
  if (p.go[j]) {
    const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, p.idx[j]);
    const float bt1[3] = {p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]};
    d = dda_rows<LEAF, SHADOW>(
        p.rows + static_cast<size_t>(p.child[j]) * kRowWords, ray.dt,
        p.dt_factor, ray.vm6, bt1, p.tqe[j], p.max_iters);
  }
  p.hit[j] = d.hit;
  p.t[j] = d.t_hit;
  p.nmaj[j] = d.nmaj;
  p.vr[j] = static_cast<int>(d.vr);
  p.p3[j] = d.p3;
  p.tqp[j] = d.tqp;
  p.more[j] = d.more;
  p.tqr[j] = d.tqr;
}

// Kernel B through a block-local row cache (the reference's uniq-regather
// path, _make_kernel_b(dedup_u=U), measured by scripts/r3_phase_split.py
// :212): each 128-lane block finds the distinct rows among its go-lanes,
// stages the first `cache` of them (by row id) in shared memory with one
// coalesced copy, and each lane runs dda_rows on its staged row, or on its
// row in global memory when it did not fit. dda_rows reads either through
// the same generic pointer, so the results are hako_dda_kernel's bit for
// bit whatever `cache` is (the reference defers the lanes that do not fit
// instead; deferral is a round rung, which the port leaves out).
//
// Finding the distinct rows: a bitonic sort of the block's 128 (row id,
// lane) keys in shared memory (28 compare-exchange steps), then the
// boundaries of the sorted ids counted with a ballot and a prefix over the
// 4 warps: the counterpart of the reference's per-block sort, boundary
// cumsum and unique take (r3_phase_split.py dedup :152). The sort was
// chosen over __match_any_sync because a warp's match finds duplicates only
// within its 32 lanes, and merging the 4 warps' leaders needs the same
// block-wide step again; the sort also gives each row its rank, the slot
// it is staged at, in one pass. Cost: ~30 barriers and ~200 instructions a
// lane before the first row word, against one row copy a distinct row
// instead of one row read a lane. stats [blocks, 3]: the block's go-lanes,
// its distinct rows, the go-lanes that read the cache.
constexpr int kRowVec = hako::kRowWords / 4;  // 16-byte vectors a row

size_t cached_smem_bytes(int cache) {
  return static_cast<size_t>(cache) * hako::kRowWords * 4 + kThreads * 8 +
         kThreads * 4 + static_cast<size_t>(cache > 0 ? cache : 1) * 4 + 16;
}

template <bool LEAF, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_dda_cached_kernel(
    const DdaParams p, int cache, int* stats) {
  using namespace hako;
  extern __shared__ uint4 s_mem[];
  uint4* s_rows = s_mem;  // [cache][41]
  auto* s_key = reinterpret_cast<unsigned long long*>(s_rows + cache * kRowVec);
  int* s_slot = reinterpret_cast<int*>(s_key + kThreads);  // by lane
  int* s_id = s_slot + kThreads;                           // by slot
  int* s_warp = s_id + (cache > 0 ? cache : 1);            // 4 warp counts
  const int t = threadIdx.x;
  const int j = blockIdx.x * kThreads + t;
  const bool live = j < p.n;
  const bool go = live && p.go[j];
  const uint32_t none = 0xFFFFFFFFu;
  const uint32_t id = go ? static_cast<uint32_t>(p.child[j]) : none;
  s_key[t] = (static_cast<unsigned long long>(id) << 32) | static_cast<unsigned>(t);
  __syncthreads();
  for (int k = 2; k <= kThreads; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      const int q = t ^ h;
      if (q > t) {
        const unsigned long long a = s_key[t], b = s_key[q];
        if ((a > b) == ((t & k) == 0)) {
          s_key[t] = b;
          s_key[q] = a;
        }
      }
      __syncthreads();
    }
  }
  // sorted position t: a row's first key is a boundary; its rank counts
  // the boundaries up to it
  const unsigned long long key = s_key[t];
  const uint32_t kid = static_cast<uint32_t>(key >> 32);
  const bool real = kid != none;
  const bool bnd = real && (t == 0 || static_cast<uint32_t>(s_key[t - 1] >> 32) != kid);
  const unsigned ball = __ballot_sync(0xffffffffu, bnd);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) s_warp[warp] = __popc(ball);
  __syncthreads();
  int rank = __popc(ball & ((2u << lane) - 1u)) - 1;
  int distinct = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) rank += s_warp[w];
    distinct += s_warp[w];
  }
  if (bnd && rank < cache) s_id[rank] = static_cast<int>(kid);
  s_slot[key & (kThreads - 1)] = real && rank < cache ? rank : -1;
  __syncthreads();
  const int staged = min(distinct, cache);
  const uint4* rows4 = reinterpret_cast<const uint4*>(p.rows);
  for (int v = t; v < staged * kRowVec; v += kThreads) {
    const int r = v / kRowVec;
    s_rows[v] = __ldg(rows4 + static_cast<size_t>(s_id[r]) * kRowVec + (v - r * kRowVec));
  }
  const int slot = s_slot[t];
  const int n_go = __syncthreads_count(go);
  const int n_cached = __syncthreads_count(go && slot >= 0);
  if (t == 0) {
    stats[3 * blockIdx.x] = n_go;
    stats[3 * blockIdx.x + 1] = distinct;
    stats[3 * blockIdx.x + 2] = n_cached;
  }
  if (!live) return;
  Dda d{false, false, kMaxFloat, -1, 0u, 0.0f, 0.0f, p.tqe[j], 0, 0, 0, 0};
  if (go) {
    const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, p.idx[j]);
    const float bt1[3] = {p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]};
    const uint32_t* row = slot >= 0
        ? reinterpret_cast<const uint32_t*>(s_rows + slot * kRowVec)
        : p.rows + static_cast<size_t>(p.child[j]) * kRowWords;
    d = dda_rows<LEAF, SHADOW>(row, ray.dt, p.dt_factor, ray.vm6, bt1, p.tqe[j],
                               p.max_iters);
  }
  p.hit[j] = d.hit;
  p.t[j] = d.t_hit;
  p.nmaj[j] = d.nmaj;
  p.vr[j] = static_cast<int>(d.vr);
  p.p3[j] = d.p3;
  p.tqp[j] = d.tqp;
  p.more[j] = d.more;
  p.tqr[j] = d.tqr;
}

template <bool LEAF, bool SHADOW>
int launch_cached(const DdaParams& p, int cache, int* stats, cudaStream_t s) {
  const size_t bytes = cached_smem_bytes(cache);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hako_dda_cached_kernel<LEAF, SHADOW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) {
      cudaGetLastError();  // leave no error for the next launch's check
      return static_cast<int>(e);
    }
  }
  hako_dda_cached_kernel<LEAF, SHADOW><<<(p.n + kThreads - 1) / kThreads, kThreads,
                                         bytes, s>>>(p, cache, stats);
  return static_cast<int>(cudaGetLastError());
}

struct MergeParams {
  const int* idx;
  int n;
  const bool* emit;
  const float* bt1;  // [3, n]
  const float* tqn;
  const bool* exh;
  const bool* hit;
  const float* t_hit;
  const int* nmaj;
  const int* vr;
  const bool* more;
  const float* tqr;
  bool* resolved;  // [R] state, updated in place
  float* tq;
  float* t_out;
  int* nm_out;
  int* vi_out;
};

// The round's where-merges (the reference's _make_merge_kernel without
// the two-brick stage), written into the lane's state.
__global__ void __launch_bounds__(kThreads) hako_merge_kernel(const MergeParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const int lane = p.idx[j];
  if (p.resolved[lane]) return;  // act: only unresolved lanes merge
  float tqn = p.tqn[j];
  if (p.emit[j]) {
    tqn = p.more[j] ? p.tqr[j]
                    : min3(p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]);
  }
  const bool newhit = p.hit[j];
  p.resolved[lane] = newhit || p.exh[j];
  p.tq[lane] = tqn;
  if (newhit) {
    p.t_out[lane] = p.t_hit[j];
    p.nm_out[lane] = p.nmaj[j];
    p.vi_out[lane] = p.vr[j];
  }
}

struct DdaMergeParams {
  const uint32_t* bricks;  // [N, 164] brick rows
  const uint32_t* snodes;  // [M, 164] supernode rows (FAT only)
  const float* bounds;
  const float* ro;
  const float* rd;
  const int* idx;
  int n;
  // kernel A's outputs for the round's lanes
  const bool* emit;
  const int* child;
  const float* bt1;  // [3, n]
  const float* tqe;
  const float* tqn;
  const bool* exh;
  float dt_snode, dt_brick;  // 0.25^T and 0.25^(T+2 if fat else T)
  int max_iters;
  bool* resolved;  // [R] state, updated in place
  float* tq;
  float* t_out;
  int* nm_out;
  int* vi_out;
};

// The round's row stage: on a fat tree the supernode row DDA and the
// hand-off (supernode_handoff), then the brick row DDA, then the merge
// (hako_merge_kernel), per lane and in registers; the same expressions in
// the same order as hako_dda_kernel<false, SHADOW> -> supernode_handoff ->
// hako_dda_kernel<true, SHADOW> -> hako_merge_kernel, and as the
// megakernel's round after its probe.
template <bool FAT, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_dda_merge_kernel(const DdaMergeParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const int lane = p.idx[j];
  if (p.resolved[lane]) return;  // act: only unresolved lanes merge
  float tqn = p.tqn[j];
  bool newhit = false;
  float t_hit = 0.0f;
  int nmaj = 0;
  uint32_t vr = 0u;
  bool emit = p.emit[j];
  if (emit) {
    const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, lane);
    float bt1[3] = {p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]};
    float tqe = p.tqe[j];
    uint32_t child = static_cast<uint32_t>(p.child[j]);
    if (FAT) {
      // stage 1: the supernode row walk emits the next brick + planes
      const Dda s = dda_rows<false, SHADOW>(
          p.snodes + static_cast<size_t>(child) * kRowWords, ray.dt,
          p.dt_snode, ray.vm6, bt1, tqe, p.max_iters);
      if (!s.hit) tqn = s.more ? s.tqr : min3(bt1[0], bt1[1], bt1[2]);
      emit = s.hit;
      bt1[0] = s.t_hit;
      bt1[1] = __int_as_float(s.nmaj);
      bt1[2] = s.p3;
      tqe = s.tqp;
      child = s.vr;
    }
    if (emit) {
      const Dda b = dda_rows<true, SHADOW>(
          p.bricks + static_cast<size_t>(child) * kRowWords, ray.dt,
          p.dt_brick, ray.vm6, bt1, tqe, p.max_iters);
      tqn = b.more ? b.tqr : min3(bt1[0], bt1[1], bt1[2]);
      newhit = b.hit;
      t_hit = b.t_hit;
      nmaj = b.nmaj;
      vr = b.vr;
    }
  }
  p.resolved[lane] = newhit || p.exh[j];
  p.tq[lane] = tqn;
  if (newhit) {
    p.t_out[lane] = t_hit;
    p.nm_out[lane] = nmaj;
    p.vi_out[lane] = static_cast<int>(vr);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C entries for ctypes. Pointers are device pointers except level_off (host,
// T - 1 ints). Each returns cudaGetLastError() after its launch; the caller
// raises if it is not 0.
extern "C" int hako_probe_launch(
    const void* levels, const int* level_off, int T, unsigned root_lo,
    unsigned root_hi, const void* bounds, const void* ro, const void* rd,
    const void* idx, const void* tq, int n, void* emit, void* child,
    void* bt1, void* tqe, void* tqn, void* exh, int max_probes,
    void* stream) {
  if (T < 1 || T - 1 > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  ProbeParams p{};
  p.levels = static_cast<const uint32_t*>(levels);
  for (int l = 0; l < T - 1; ++l) p.level_off[l] = level_off[l];
  p.T = T;
  p.root_lo = root_lo;
  p.root_hi = root_hi;
  p.bounds = static_cast<const float*>(bounds);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.idx = static_cast<const int*>(idx);
  p.tq = static_cast<const float*>(tq);
  p.n = n;
  p.max_probes = max_probes;
  p.emit = static_cast<bool*>(emit);
  p.child = static_cast<int*>(child);
  p.bt1 = static_cast<float*>(bt1);
  p.tqe = static_cast<float*>(tqe);
  p.tqn = static_cast<float*>(tqn);
  p.exh = static_cast<bool*>(exh);
  hako_probe_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

namespace {

DdaParams dda_params(const void* rows, const void* bounds, const void* ro,
                     const void* rd, const void* idx, int n, const void* go,
                     const void* child, const void* bt1, const void* tqe,
                     void* hit, void* t, void* nmaj, void* vr, void* p3,
                     void* tqp, void* more, void* tqr, float dt_factor,
                     int max_iters) {
  DdaParams p{};
  p.rows = static_cast<const uint32_t*>(rows);
  p.bounds = static_cast<const float*>(bounds);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.idx = static_cast<const int*>(idx);
  p.n = n;
  p.go = static_cast<const bool*>(go);
  p.child = static_cast<const int*>(child);
  p.bt1 = static_cast<const float*>(bt1);
  p.tqe = static_cast<const float*>(tqe);
  p.dt_factor = dt_factor;
  p.max_iters = max_iters;
  p.hit = static_cast<bool*>(hit);
  p.t = static_cast<float*>(t);
  p.nmaj = static_cast<int*>(nmaj);
  p.vr = static_cast<int*>(vr);
  p.p3 = static_cast<float*>(p3);
  p.tqp = static_cast<float*>(tqp);
  p.more = static_cast<bool*>(more);
  p.tqr = static_cast<float*>(tqr);
  return p;
}

}  // namespace

extern "C" int hako_dda_launch(
    const void* rows, const void* bounds, const void* ro, const void* rd,
    const void* idx, int n, const void* go, const void* child,
    const void* bt1, const void* tqe, void* hit, void* t, void* nmaj,
    void* vr, void* p3, void* tqp, void* more, void* tqr, float dt_factor,
    int leaf, int shadow, int max_iters, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const DdaParams p = dda_params(rows, bounds, ro, rd, idx, n, go, child, bt1,
                                 tqe, hit, t, nmaj, vr, p3, tqp, more, tqr,
                                 dt_factor, max_iters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = blocks_for(n);
  if (leaf && shadow) hako_dda_kernel<true, true><<<b, kThreads, 0, s>>>(p);
  else if (leaf) hako_dda_kernel<true, false><<<b, kThreads, 0, s>>>(p);
  else if (shadow) hako_dda_kernel<false, true><<<b, kThreads, 0, s>>>(p);
  else hako_dda_kernel<false, false><<<b, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// hako_dda_launch's arguments, the row cache's size in rows and its stats
// (device int32 [blocks of 128 lanes, 3]). A cache whose shared memory
// the card refuses returns that error without a launch.
extern "C" int hako_dda_cached_launch(
    const void* rows, const void* bounds, const void* ro, const void* rd,
    const void* idx, int n, const void* go, const void* child,
    const void* bt1, const void* tqe, void* hit, void* t, void* nmaj,
    void* vr, void* p3, void* tqp, void* more, void* tqr, float dt_factor,
    int leaf, int shadow, int max_iters, int cache, void* stats,
    void* stream) {
  if (n <= 0 || cache < 0) return cudaErrorInvalidValue;
  const DdaParams p = dda_params(rows, bounds, ro, rd, idx, n, go, child, bt1,
                                 tqe, hit, t, nmaj, vr, p3, tqp, more, tqr,
                                 dt_factor, max_iters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(stats);
  if (leaf && shadow) return launch_cached<true, true>(p, cache, st, s);
  if (leaf) return launch_cached<true, false>(p, cache, st, s);
  if (shadow) return launch_cached<false, true>(p, cache, st, s);
  return launch_cached<false, false>(p, cache, st, s);
}

extern "C" int hako_merge_launch(
    const void* idx, int n, const void* emit, const void* bt1,
    const void* tqn, const void* exh, const void* hit, const void* t_hit,
    const void* nmaj, const void* vr, const void* more, const void* tqr,
    void* resolved, void* tq, void* t_out, void* nm_out, void* vi_out,
    void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  MergeParams p{};
  p.idx = static_cast<const int*>(idx);
  p.n = n;
  p.emit = static_cast<const bool*>(emit);
  p.bt1 = static_cast<const float*>(bt1);
  p.tqn = static_cast<const float*>(tqn);
  p.exh = static_cast<const bool*>(exh);
  p.hit = static_cast<const bool*>(hit);
  p.t_hit = static_cast<const float*>(t_hit);
  p.nmaj = static_cast<const int*>(nmaj);
  p.vr = static_cast<const int*>(vr);
  p.more = static_cast<const bool*>(more);
  p.tqr = static_cast<const float*>(tqr);
  p.resolved = static_cast<bool*>(resolved);
  p.tq = static_cast<float*>(tq);
  p.t_out = static_cast<float*>(t_out);
  p.nm_out = static_cast<int*>(nm_out);
  p.vi_out = static_cast<int*>(vi_out);
  hako_merge_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The row stage: snodes is null for a plain tree (the brick stage alone).
extern "C" int hako_dda_merge_launch(
    const void* bricks, const void* snodes, const void* bounds,
    const void* ro, const void* rd, const void* idx, int n, const void* emit,
    const void* child, const void* bt1, const void* tqe, const void* tqn,
    const void* exh, float dt_snode, float dt_brick, int shadow,
    int max_iters, void* resolved, void* tq, void* t_out, void* nm_out,
    void* vi_out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  DdaMergeParams p{};
  p.bricks = static_cast<const uint32_t*>(bricks);
  p.snodes = static_cast<const uint32_t*>(snodes);
  p.bounds = static_cast<const float*>(bounds);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.idx = static_cast<const int*>(idx);
  p.n = n;
  p.emit = static_cast<const bool*>(emit);
  p.child = static_cast<const int*>(child);
  p.bt1 = static_cast<const float*>(bt1);
  p.tqe = static_cast<const float*>(tqe);
  p.tqn = static_cast<const float*>(tqn);
  p.exh = static_cast<const bool*>(exh);
  p.dt_snode = dt_snode;
  p.dt_brick = dt_brick;
  p.max_iters = max_iters;
  p.resolved = static_cast<bool*>(resolved);
  p.tq = static_cast<float*>(tq);
  p.t_out = static_cast<float*>(t_out);
  p.nm_out = static_cast<int*>(nm_out);
  p.vi_out = static_cast<int*>(vi_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = blocks_for(n);
  const bool fat = snodes != nullptr;
  if (fat && shadow) hako_dda_merge_kernel<true, true><<<b, kThreads, 0, s>>>(p);
  else if (fat) hako_dda_merge_kernel<true, false><<<b, kThreads, 0, s>>>(p);
  else if (shadow) hako_dda_merge_kernel<false, true><<<b, kThreads, 0, s>>>(p);
  else hako_dda_merge_kernel<false, false><<<b, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
