// The legacy HakoTree round driver on Hopper: the round loop in one
// persistent cooperative launch (hako_rounds), and the kernels of the
// two-launch driver it replaced, which stay for the scripts and the
// round-by-round checks: kernel A (hako_probe), the round's row stage
// (hako_dda_merge: kernel B on the supernode and brick rows and the merge,
// in one launch), and the unfused kernel B (hako_dda, leaf and supernode
// rows, primary and shadow) and merge (hako_merge) that the phase-timing
// scripts launch alone. ops/hako_kernels.py::intersect_rays_hako launches
// hako_rounds; ops/hako_kernels.py::drive is the host loop of the
// two-launch driver (each round the lanes still unresolved as an index
// list from a host nonzero, then A, then the row stage).
//
// Replaces the Pallas kernels of massivevoxelraytracing_tpu/ops/
// hako_kernels.py: kernel A (_make_kernel_a, launched at :1218 and in its
// fused form at :1681), kernel B (_make_kernel_b :975, launched at :1252
// and fused :1700) and the merge (_make_merge_kernel :1096, launched at
// :1735), and the XLA while_loop of block-compacted rounds around them
// (:1985, :2010; the lanes compacted with jnp.nonzero inside the jit,
// :1407, :1805). On the TPU a grid step owned a block of rays in
// lockstep; the round driver picked whole ray blocks, gathered each
// lane's 164-word row from HBM in XLA, transposed it to word-major in
// VMEM, and wrote the state back with XLA scatters; it split B and the
// merge into separate launches because its grid mapped state blocks
// through scalar prefetch. Here every kernel runs one thread per active
// lane: B reads its own row straight from global memory by child id (no
// gather buffer, no transpose), and the merge writes the lane's state in
// place.
//
// What bounds them on an H100: a round is a short pass over the active
// lanes (tens of bytes of state per lane in and out, plus the rows B
// touches), bound by the DDA's issue rate under divergence (the walk64
// lattice walks, as in the megakernel) and by memory traffic. The
// two-launch driver added, every round, a host nonzero sync, two wrapper
// calls and kernel A's outputs through HBM (26 B a lane), so its device
// sat idle ~90% of a frame while the host loop ran. hako_rounds keeps the
// lane lists and the round loop on the device: one launch a call, no host
// sync, kernel A's outputs in registers, a grid barrier between rounds.
// hako_dda_merge kept B's outputs and the merge's inputs in registers the
// same way (the unfused route moved B's 8 outputs a stage, the supernode
// hand-off's eager tensor ops and the merge's 12 input streams through
// HBM). A row cache for B (hako_dda_cached below) was measured beside
// hako_dda (scripts/r3_phase_split.py) and is not on the route.
//
// Exactness: the kernels share every __device__ function with the
// megakernel (hako_device.cuh); kernel A's body (probe_lane) and the row
// stage's (row_stage) are the same functions in both drivers, in the
// same order, so the fused, two-launch and unfused drivers and the
// megakernel give identical bits.

#include <cooperative_groups.h>
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

// Kernel A's body for one lane: up to max_probes root descents from the
// resume key tq0 (a ray that misses the root box is exhausted at once).
__device__ __forceinline__ hako::Probe probe_lane(
    const hako::Ray& ray, const uint32_t* levels, const int* level_off, int T,
    uint32_t root_lo, uint32_t root_hi, float tq0, int max_probes) {
  using namespace hako;
  Probe r{false, !ray.enter_ok, 0, {0.0f, 0.0f, 0.0f}, tq0, tq0, 0, 0, 0};
  if (ray.enter_ok) {
    r = probe_from_root(levels, level_off, T, root_lo, root_hi, ray.t1, ray.dt,
                        ray.vm6, tq0, max_probes);
  }
  return r;
}

// Kernel A: the lane's preamble, then up to max_probes root descents.
__global__ void __launch_bounds__(kThreads) hako_probe_kernel(const ProbeParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const int lane = p.idx[j];
  const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, lane);
  const Probe r = probe_lane(ray, p.levels, p.level_off, p.T, p.root_lo,
                             p.root_hi, p.tq[lane], p.max_probes);
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
// stages the first `cache` of them (by row id) in shared memory, and each
// lane runs dda_rows on its staged row, or on its row in global memory
// when it did not fit. The row's words are the same either way, so the
// results are hako_dda_kernel's bit for bit whatever `cache` is (the
// reference defers the lanes that do not fit instead; deferral is a round
// rung, which the port leaves out). stats [blocks, 3]: the block's
// go-lanes, its distinct rows, the go-lanes that read the cache.
//
// What bounds it: one row read a distinct row instead of one a go-lane
// (common.dda_bound), then the DDA's issue. The design keeps the
// dedup short and lets no lane wait for a copy it does not read:
// * distinct rows: __match_any_sync gives each row a leader in its warp;
//   the leaders list their ids in shared memory (by lane, with the
//   warp's ballot of leaders), and behind one barrier each leader finds
//   the earliest warp that lists its row (that entry stands for the row
//   in the block). A second barrier counts the block's
//   distinct rows. Where they all fit, a row's slot is its entry's place
//   among the standing entries; where they do not, its rank among them
//   (the `cache` smallest ids are staged, as the reference's sort ranks
//   them), counted over the block's standing ids. Two barriers in all,
//   where a bitonic sort of the block's 128 keys took 28.
// * the copy: the standing entry's leader stages its row with one bulk
//   copy (cp.async.bulk, 656 B = 41 x 16, the table 16-byte aligned).
//   The block's copies complete on one mbarrier, which each warp arrives
//   on once its leaders have issued theirs; a lane whose row is staged
//   waits for it after its ray preamble, and every other lane walks its
//   row in global memory at once. (An mbarrier a warp was within 2% of
//   it, an mbarrier a row 11% slower on the lattice round: a block
//   initialised U of them, PERF.md section 6.)
// * the reads: a staged row is read with ld.shared (dda_rows over
//   SmemRow), not through a generic pointer.
// Shared memory: `cache` rows (656 B each; 43 KB at U = 64, 5 blocks an
// SM), set by `cache` as before, and the mbarrier.
constexpr int kRowVec = hako::kRowWords / 4;  // 16-byte vectors a row
constexpr uint32_t kRowBytes = hako::kRowWords * 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;
// the block's small counts after its ids (by lane): a warp's ballots of
// its leaders and of those whose row no earlier warp lists, its
// go-lanes; the lanes that read the cache and the warps done with them
enum { kLeads = 0, kStanding = kWarps, kGoes = 2 * kWarps, kCachedLanes = 3 * kWarps,
       kWarpsDone, kSmall };

size_t cached_smem_bytes(int cache) {
  return static_cast<size_t>(cache) * kRowBytes + 8 + (kThreads + kSmall) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A row staged in shared memory at a shared-window address: row[k] is one
// ld.shared (LDS).
struct SmemRow {
  uint32_t addr;
  __device__ __forceinline__ uint32_t operator[](int k) const {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr + 4u * static_cast<uint32_t>(k)));
    return v;
  }
};

// bytes bytes from global src to shared dst, completing on mbarrier bar,
// which is told to expect them (its phase also waits for its arrivals)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Until mbarrier bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

template <bool LEAF, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_dda_cached_kernel(
    const DdaParams p, int cache, int* stats) {
  using namespace hako;
  extern __shared__ uint4 s_mem[];
  uint4* s_rows = s_mem;  // [cache][41]
  auto* s_bar = reinterpret_cast<unsigned long long*>(s_rows + cache * kRowVec);
  uint32_t* s_ids = reinterpret_cast<uint32_t*>(s_bar + 1);  // [warp][lane] leaders' ids
  int* s_small = reinterpret_cast<int*>(s_ids + kThreads);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int j = blockIdx.x * kThreads + t;
  const bool live = j < p.n;
  const bool go = live && p.go[j];
  const uint32_t id = go ? static_cast<uint32_t>(p.child[j]) : kNoRow;
  const uint32_t bar = smem_addr(s_bar);  // the block's copies, and a warp's arrival each
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(kWarps) : "memory");
  }
  // the warp's distinct rows: the lowest lane of a row leads it
  const int leader = __ffs(__match_any_sync(kFull, id)) - 1;
  const bool lead = go && lane == leader;
  const unsigned leads = __ballot_sync(kFull, lead);
  if (lead) s_ids[warp * 32 + lane] = id;
  const unsigned goes = __ballot_sync(kFull, go);
  if (lane == 0) {
    s_small[kLeads + warp] = static_cast<int>(leads);
    s_small[kGoes + warp] = __popc(goes);
  }
  if (t == 0) s_small[kCachedLanes] = s_small[kWarpsDone] = 0;
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  // the entry that stands for the row: its earliest warp's
  int fw = warp, fi = lane;
  if (lead) {
    for (int w = 0; w < warp && fw == warp; ++w) {
      for (unsigned m = static_cast<unsigned>(s_small[kLeads + w]); m; m &= m - 1u) {
        const int k = __ffs(m) - 1;
        if (s_ids[w * 32 + k] == id) {
          fw = w;
          fi = k;
          break;
        }
      }
    }
  }
  const bool standing = lead && fw == warp;
  const unsigned stands = __ballot_sync(kFull, standing);
  if (lane == 0) s_small[kStanding + warp] = static_cast<int>(stands);
  const int distinct = __syncthreads_count(standing);
  int slot = -1;
  if (lead) {
    if (distinct <= cache) {  // every row staged, at its standing entry's place
      slot = __popc(static_cast<unsigned>(s_small[kStanding + fw]) & ((1u << fi) - 1u));
      for (int w = 0; w < fw; ++w) slot += __popc(static_cast<unsigned>(s_small[kStanding + w]));
    } else if (cache > 0) {  // the cache smallest rows: this row's rank
      int rank = 0;
      for (int w = 0; w < kWarps; ++w) {
        for (unsigned m = static_cast<unsigned>(s_small[kStanding + w]); m; m &= m - 1u) {
          rank += s_ids[w * 32 + __ffs(m) - 1] < id;
        }
      }
      slot = rank < cache ? rank : -1;
    }
    if (standing && slot >= 0) {
      bulk_load(smem_addr(s_rows + slot * kRowVec),
                p.rows + static_cast<size_t>(id) * kRowWords, kRowBytes, bar);
    }
  }
  __syncwarp();  // the warp's copies expected before its arrival completes the phase
  if (lane == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
  slot = __shfl_sync(kFull, slot, leader);
  // the stats: the last warp to add its cached lanes writes them
  const unsigned cached = __ballot_sync(kFull, go && slot >= 0);
  if (lane == 0) {
    atomicAdd(&s_small[kCachedLanes], __popc(cached));
    __threadfence_block();
    if (atomicAdd(&s_small[kWarpsDone], 1) == kWarps - 1) {
      __threadfence_block();
      int n_go = 0;
      for (int w = 0; w < kWarps; ++w) n_go += s_small[kGoes + w];
      stats[3 * blockIdx.x] = n_go;
      stats[3 * blockIdx.x + 1] = distinct;
      stats[3 * blockIdx.x + 2] = atomicAdd(&s_small[kCachedLanes], 0);
    }
  }
  if (!live) return;
  Dda d{false, false, kMaxFloat, -1, 0u, 0.0f, 0.0f, p.tqe[j], 0, 0, 0, 0};
  if (go) {
    const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, p.idx[j]);
    const float bt1[3] = {p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]};
    if (slot >= 0) {
      mbar_wait(bar, 0);
      d = dda_rows<LEAF, SHADOW>(SmemRow{smem_addr(s_rows + slot * kRowVec)}, ray.dt,
                                 p.dt_factor, ray.vm6, bt1, p.tqe[j], p.max_iters);
    } else {
      d = dda_rows<LEAF, SHADOW>(p.rows + static_cast<size_t>(id) * kRowWords, ray.dt,
                                 p.dt_factor, ray.vm6, bt1, p.tqe[j], p.max_iters);
    }
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

struct Hit {
  bool hit;
  float t;
  int nmaj;
  uint32_t vr;
};

// The row stage's body for a lane that kernel A emitted a row for (child,
// its exit planes bt1, resume key tqe): on a fat tree the supernode row
// DDA and the hand-off (supernode_handoff), then the brick row DDA. Sets
// the lane's next resume key tqn (kernel A's on entry) and returns the
// brick stage's hit; the same expressions in the same order as
// hako_dda_kernel<false, SHADOW> -> supernode_handoff ->
// hako_dda_kernel<true, SHADOW> -> hako_merge_kernel, and as the
// megakernel's round after its probe.
template <bool FAT, bool SHADOW>
__device__ __forceinline__ Hit row_stage(const uint32_t* bricks,
                                         const uint32_t* snodes,
                                         const float dt[3], int vm6,
                                         float dt_snode, float dt_brick,
                                         int max_iters, uint32_t child,
                                         float bt1[3], float tqe, float& tqn) {
  using namespace hako;
  Hit h{false, 0.0f, 0, 0u};
  bool emit = true;
  if (FAT) {
    // stage 1: the supernode row walk emits the next brick + planes
    const Dda s = dda_rows<false, SHADOW>(
        snodes + static_cast<size_t>(child) * kRowWords, dt, dt_snode, vm6,
        bt1, tqe, max_iters);
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
        bricks + static_cast<size_t>(child) * kRowWords, dt, dt_brick, vm6,
        bt1, tqe, max_iters);
    tqn = b.more ? b.tqr : min3(bt1[0], bt1[1], bt1[2]);
    h = Hit{b.hit, b.t_hit, b.nmaj, b.vr};
  }
  return h;
}

// The round's row stage on kernel A's outputs (row_stage), then the merge
// into the lane's state.
template <bool FAT, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_dda_merge_kernel(const DdaMergeParams p) {
  using namespace hako;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const int lane = p.idx[j];
  if (p.resolved[lane]) return;  // act: only unresolved lanes merge
  float tqn = p.tqn[j];
  Hit h{false, 0.0f, 0, 0u};
  if (p.emit[j]) {
    const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, lane);
    float bt1[3] = {p.bt1[j], p.bt1[p.n + j], p.bt1[2 * p.n + j]};
    h = row_stage<FAT, SHADOW>(p.bricks, p.snodes, ray.dt, ray.vm6, p.dt_snode,
                               p.dt_brick, p.max_iters,
                               static_cast<uint32_t>(p.child[j]), bt1, p.tqe[j], tqn);
  }
  p.resolved[lane] = h.hit || p.exh[j];
  p.tq[lane] = tqn;
  if (h.hit) {
    p.t_out[lane] = h.t;
    p.nm_out[lane] = h.nmaj;
    p.vi_out[lane] = static_cast<int>(h.vr);
  }
}

struct RoundsParams {
  const uint32_t* bricks;  // [N, 164] brick rows
  const uint32_t* snodes;  // [M, 164] supernode rows (FAT only)
  const uint32_t* levels;  // root-down (mask_lo, mask_hi, base) triples
  int level_off[kMaxLevels];
  int T;
  uint32_t root_lo, root_hi;
  const float* lower;  // [3]
  const float* upper;  // [3]
  const float* ro;     // [n, 3]
  const float* rd;     // [n, 3]
  int n, max_probes, max_iters, max_rounds;
  float dt_snode, dt_brick;  // 0.25^T and 0.25^(T+2 if fat else T)
  int* lists;   // [2, n] lane lists: round r appends to list r & 1
  int* counts;  // [3] list lengths: round r appends to counts[r % 3]
  float* tq;    // [n] resume keys (read from round 1 on)
  float* t_out;
  int* nm_out;
  int* vi_out;
  int* info;  // [2]: rounds run, lanes left unresolved
  int* acc;   // [2] accumulators info is added to, or null
};

// One round of one lane: kernel A's body, then the row stage's on A's
// outputs in registers, then the merge. A lane that hits or exhausts the
// tree writes its result (t, nmaj, vrank; a miss is MAX_FLOAT, -1, 0)
// once and returns false; one that goes on keeps its resume key for the
// next round and returns true. The state (resolved, tq, t, nmaj, vrank)
// of the two-launch driver starts as (false, 0, MAX_FLOAT, -1, 0), so
// round 0 takes tq = 0 without a read, and a lane is unresolved exactly
// while it is in a list: the row stage's resolved check always passes.
template <bool FAT, bool SHADOW>
__device__ __forceinline__ bool serve_lane(const RoundsParams& p,
                                           const float bounds[6], int lane,
                                           bool first) {
  using namespace hako;
  const Ray ray = ray_preamble(bounds, p.ro, p.rd, lane);
  // written by another block in an earlier round: read through L2
  const float tq0 = first ? 0.0f : __ldcg(p.tq + lane);
  const Probe a = probe_lane(ray, p.levels, p.level_off, p.T, p.root_lo,
                             p.root_hi, tq0, p.max_probes);
  float tqn = a.tqn;
  Hit h{false, 0.0f, 0, 0u};
  if (a.emit) {
    float bt1[3] = {a.bt1[0], a.bt1[1], a.bt1[2]};
    h = row_stage<FAT, SHADOW>(p.bricks, p.snodes, ray.dt, ray.vm6, p.dt_snode,
                               p.dt_brick, p.max_iters,
                               static_cast<uint32_t>(a.child), bt1, a.tqe, tqn);
  }
  if (h.hit || a.exh) {
    p.t_out[lane] = h.hit ? h.t : kMaxFloat;
    p.nm_out[lane] = h.hit ? h.nmaj : -1;
    p.vi_out[lane] = h.hit ? static_cast<int>(h.vr) : 0;
    return false;
  }
  p.tq[lane] = tqn;
  return true;
}

// The whole round loop in one cooperative launch, on a grid that is
// co-resident (the wrapper sizes it from the occupancy): replaces the
// reference's XLA while_loop of rounds (ops/hako_kernels.py:1985, :2010)
// and the port's host loop of two launches a round
// (ops/hako_kernels.py::drive). Round 0 serves lanes 0..n-1; each later
// round serves the list the round before appended its unresolved lanes
// to. The grid strides over the round's lanes a warp at a time; a warp
// appends its lanes that go on with one atomicAdd (__ballot_sync,
// __popc). A warp-aggregated atomic claim of the next chunk of lanes
// would balance a round's lanes dynamically, at an atomic on every
// chunk's path; the stride needs no counter and spreads each warp's
// chunks across the list. Between rounds the grid synchronises, so the
// next round sees every append, resume key and count. The loop ends when a round leaves
// no lane or at max_rounds; lanes still listed then are misses.
// The order of a list changes from run to run, but a lane's round
// depends on nothing but its own state, so every output and the round
// count (the most rounds any lane needs) are the same bits.
template <bool FAT, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_rounds_kernel(const RoundsParams p) {
  using namespace hako;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const float bounds[6] = {p.lower[0], p.lower[1], p.lower[2],
                           p.upper[0], p.upper[1], p.upper[2]};
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  const int warp_first = blockIdx.x * kThreads + (threadIdx.x - wl);
  const int stride = gridDim.x * kThreads;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  if (leader) p.counts[0] = 0;
  grid.sync();
  int count = p.n;
  int r = 0;
  for (; r < p.max_rounds && count > 0; ++r) {
    const int* in = p.lists + ((r + 1) & 1) * p.n;  // round r - 1's list
    int* out = p.lists + (r & 1) * p.n;
    int* out_count = p.counts + r % 3;
    // round r + 1 appends to counts[(r + 1) % 3], which every thread last
    // read right after round r - 2's barrier
    if (leader) p.counts[(r + 1) % 3] = 0;
    for (int base = warp_first; base < count; base += stride) {
      const int j = base + wl;
      int lane = 0;
      bool left = false;
      if (j < count) {
        lane = r == 0 ? j : __ldcg(in + j);
        left = serve_lane<FAT, SHADOW>(p, bounds, lane, r == 0);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, left);
      if (ball != 0u) {
        int slot = 0;
        if (wl == 0) slot = atomicAdd(out_count, __popc(ball));
        slot = __shfl_sync(0xffffffffu, slot, 0);
        if (left) out[slot + __popc(ball & below)] = lane;
      }
    }
    grid.sync();
    count = __ldcg(out_count);
  }
  // lanes left at max_rounds keep the state's initial miss
  const int* left_list = p.lists + ((r + 1) & 1) * p.n;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < count; j += stride) {
    const int lane = r == 0 ? j : __ldcg(left_list + j);
    p.t_out[lane] = kMaxFloat;
    p.nm_out[lane] = -1;
    p.vi_out[lane] = 0;
  }
  if (leader) {
    p.info[0] = r;
    p.info[1] = count;
    if (p.acc != nullptr) {
      atomicAdd(p.acc, r);
      atomicAdd(p.acc + 1, count);
    }
  }
}

template <bool FAT, bool SHADOW>
int rounds_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hako_rounds_kernel<FAT, SHADOW>, kThreads, 0);
  return e == cudaSuccess ? per_sm : -static_cast<int>(e);
}

int blocks_per_sm(bool fat, bool shadow) {
  if (fat && shadow) return rounds_blocks_per_sm<true, true>();
  if (fat) return rounds_blocks_per_sm<true, false>();
  if (shadow) return rounds_blocks_per_sm<false, true>();
  return rounds_blocks_per_sm<false, false>();
}

template <bool FAT, bool SHADOW>
cudaError_t launch_rounds(RoundsParams& p, int blocks, cudaStream_t s) {
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hako_rounds_kernel<FAT, SHADOW>), dim3(blocks),
      dim3(kThreads), args, 0, s);
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
// The dynamic shared memory a block of hako_dda_cached_kernel launches with.
extern "C" size_t hako_dda_cached_smem_bytes(int cache) { return cached_smem_bytes(cache); }

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

// The co-resident grid of hako_rounds_kernel<fat, shadow>: out[0] its
// blocks an SM by the occupancy calculator, out[1] the device's SMs.
// Returns a CUDA error code, 0 on success.
extern "C" int hako_rounds_grid(int fat, int shadow, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm = blocks_per_sm(fat != 0, shadow != 0);
  if (per_sm < 0) return -per_sm;
  out[0] = per_sm;
  return 0;
}

// The round loop in one cooperative launch of `blocks` blocks (the caller
// sizes the grid from hako_rounds_grid; the card refuses one it cannot
// hold co-resident). lists: int32 [2, n], counts: int32 [3], tq: f32 [n]
// scratch; t_out / nm_out / vi_out the results; info int32 [2] (rounds
// run, lanes unresolved); acc int32 [2] or null. Returns the launch's
// error, 0 on success.
extern "C" int hako_rounds_launch(
    const void* bricks, const void* snodes, const void* levels,
    const int* level_off, int T, unsigned root_lo, unsigned root_hi,
    const void* lower, const void* upper, const void* ro, const void* rd,
    int n, void* lists, void* counts, void* tq, void* t_out, void* nm_out,
    void* vi_out, void* info, void* acc, int shadow, int max_probes,
    int max_dda, int max_rounds, float dt_snode, float dt_brick, int blocks,
    void* stream) {
  if (T < 1 || T - 1 > kMaxLevels || n <= 0 || blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaErrorCooperativeLaunchTooLarge;  // no block fits an SM
  const bool fat = snodes != nullptr;
  RoundsParams p{};
  p.bricks = static_cast<const uint32_t*>(bricks);
  p.snodes = static_cast<const uint32_t*>(snodes);
  p.levels = static_cast<const uint32_t*>(levels);
  for (int l = 0; l < T - 1; ++l) p.level_off[l] = level_off[l];
  p.T = T;
  p.root_lo = root_lo;
  p.root_hi = root_hi;
  p.lower = static_cast<const float*>(lower);
  p.upper = static_cast<const float*>(upper);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.n = n;
  p.max_probes = max_probes;
  p.max_iters = max_dda;
  p.max_rounds = max_rounds;
  p.dt_snode = dt_snode;
  p.dt_brick = dt_brick;
  p.lists = static_cast<int*>(lists);
  p.counts = static_cast<int*>(counts);
  p.tq = static_cast<float*>(tq);
  p.t_out = static_cast<float*>(t_out);
  p.nm_out = static_cast<int*>(nm_out);
  p.vi_out = static_cast<int*>(vi_out);
  p.info = static_cast<int*>(info);
  p.acc = static_cast<int*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (fat && shadow) e = launch_rounds<true, true>(p, blocks, s);
  else if (fat) e = launch_rounds<true, false>(p, blocks, s);
  else if (shadow) e = launch_rounds<false, true>(p, blocks, s);
  else e = launch_rounds<false, false>(p, blocks, s);
  const cudaError_t last = cudaGetLastError();  // leave no error behind
  return static_cast<int>(e != cudaSuccess ? e : last);
}
