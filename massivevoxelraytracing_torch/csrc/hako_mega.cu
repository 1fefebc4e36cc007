// HakoMega on Hopper: the whole HakoTree traversal, one thread per ray
// running to completion.
//
// Replaces the Pallas megakernel of massivevoxelraytracing_tpu/ops/
// hako_mega.py (_make_megakernel, launched by _intersect_mega). On the TPU
// a grid step owned a block of 1024-2048 rays in lockstep and fetched each
// round's distinct brick rows by DMA into VMEM, regathering them per lane
// with one-hot matmuls. Here each thread runs its own round loop
//   root probe (probe_from_root, up to max_probes descents)
//   -> supernode-row DDA (fat trees) -> brick-row DDA -> merge
// until it hits, exhausts the tree, or reaches max_rounds. Rows (656 B)
// are read straight from global memory through L1/L2; level tables are
// plain indexed loads. No dedup, no DMA, no U budget: results do not
// depend on them (the reference's tests).
//
// What bounds it on an H100 (chip_smoke.py: the counting variant below and
// the probes of hako_probes.cu): issuing the walk64 lattice walks under
// divergence, not memory. A 1080p frame ray takes 2.4 rounds and 13 walks;
// its dependent row loads would take ~0.04 ms for the frame at the
// measured L2 hop time and full occupancy, its bytes 0.027 ms, against
// ~1.1 ms in the kernel; the probe and DDA loops run at a SIMT efficiency
// of 0.47 on the frame and 0.32 on the path tracer's bounce batches, whose
// time is the life of their slowest warps. The design answers with fewer
// instructions per walk: the NaN-propagating min / max are one instruction
// each (hako_device.cuh), which took ~30% off the frame and the batches.
// Persistent warps with ray refill, vector row loads, shared-memory
// supernode rows, a register diet, step scheduling and warp-owned ray
// pools were measured against this design, lost on the frame or the
// bounce batches, and were taken out again (PERF.md).
//
// Exactness: see hako_device.cuh (-fmad=false, IEEE division).

#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace {

constexpr int kMaxLevels = 8;  // must match utils/cuda_build.py MAX_LEVELS
constexpr int kThreads = 128;
constexpr int kWarpStats = 7;  // see hako_mega_launch

struct Params {
  const uint32_t* bricks;
  const uint32_t* snodes;  // nullptr for a plain tree
  const uint32_t* levels;  // root-down (mask_lo, mask_hi, base) triples
  int level_off[kMaxLevels];
  uint32_t root_lo, root_hi;
  const float* bounds;  // lower[3], upper[3]
  const float* ro;      // [n, 3]
  const float* rd;      // [n, 3]
  float* t_out;
  int* nmaj_out;
  int* vrank_out;
  int* unresolved;
  int* counts;                     // COUNT: [8, n]
  unsigned long long* warp_stats;  // COUNT: [warps, kWarpStats]
  int n, T, max_probes, max_dda, max_rounds;
  float dt_snode, dt_brick;  // 0.25^T and 0.25^(T+2 if fat else T)
};

struct Counts {
  int rounds, descents, snode_iters, brick_iters, walks, row_words, row_loads,
      level_words;
};

template <bool FAT, bool SHADOW, bool COUNT>
__global__ void __launch_bounds__(kThreads) hako_mega_kernel(const Params p) {
  using namespace hako;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const long long t0 = COUNT ? clock64() : 0;
  long long t_end = 0;  // COUNT: when this lane's ray resolved
  Counts c{};
  WarpPass outer{0, 0}, inner{0, 0};
  WarpPass* const in = COUNT ? &inner : nullptr;

  const Ray ray = ray_preamble(p.bounds, p.ro, p.rd, i);
  const float* t1 = ray.t1;
  const float* dt = ray.dt;
  const int vm6 = ray.vm6;

  bool resolved = !ray.enter_ok;  // no-enter rays are misses
  if (COUNT && resolved) t_end = clock64();
  float t_q = 0.0f;
  float t_out = kMaxFloat;
  int nm_out = -1;
  uint32_t vi_out = 0;
  for (int rnd = 0; rnd < p.max_rounds && !resolved; ++rnd) {
    count_pass(COUNT ? &outer : nullptr);
    const Probe pr = probe_from_root(p.levels, p.level_off, p.T, p.root_lo,
                                     p.root_hi, t1, dt, vm6, t_q,
                                     p.max_probes, in);
    float tqn = pr.tqn;
    bool emit = pr.emit;
    uint32_t child = static_cast<uint32_t>(pr.child);
    float bt1[3] = {pr.bt1[0], pr.bt1[1], pr.bt1[2]};
    float tqe = pr.tqe;
    if (COUNT) {
      ++c.rounds;
      c.descents += pr.descents;
      c.walks += pr.walks;
      c.level_words += pr.words;
    }
    if (FAT && emit) {
      // stage 1: the supernode row walk emits the next brick + planes
      const Dda s = dda_rows<false, SHADOW>(
          p.snodes + static_cast<size_t>(child) * kRowWords, dt, p.dt_snode,
          vm6, bt1, tqe, p.max_dda, in);
      if (COUNT) {
        c.snode_iters += s.iters;
        c.walks += s.walks;
        c.row_words += s.words;
        c.row_loads += s.loads;
      }
      if (!s.hit) tqn = s.more ? s.tqr : min3(bt1[0], bt1[1], bt1[2]);
      emit = s.hit;
      bt1[0] = s.t_hit;
      bt1[1] = __int_as_float(s.nmaj);
      bt1[2] = s.p3;
      tqe = s.tqp;
      child = s.vr;
    }
    bool newhit = false;
    if (emit) {
      const Dda b = dda_rows<true, SHADOW>(
          p.bricks + static_cast<size_t>(child) * kRowWords, dt, p.dt_brick,
          vm6, bt1, tqe, p.max_dda, in);
      if (COUNT) {
        c.brick_iters += b.iters;
        c.walks += b.walks;
        c.row_words += b.words;
        c.row_loads += b.loads;
      }
      tqn = b.more ? b.tqr : min3(bt1[0], bt1[1], bt1[2]);
      if (b.hit) {
        newhit = true;
        t_out = b.t_hit;
        nm_out = b.nmaj;
        vi_out = b.vr;
      }
    }
    resolved = newhit || pr.exh;
    t_q = tqn;
    // read in the pass that resolves the ray, before the lane waits for
    // the rest of its warp at the end of the loop
    if (COUNT && resolved) t_end = clock64();
  }
  if (!resolved) atomicAdd(p.unresolved, 1);
  p.t_out[i] = t_out;
  p.nmaj_out[i] = nm_out;
  p.vrank_out[i] = static_cast<int>(vi_out);
  if (COUNT) {
    const long long t1c = clock64();
    if (!resolved) t_end = t1c;
    const int v[8] = {c.rounds,    c.descents, c.snode_iters, c.brick_iters,
                      c.walks,     c.row_words, c.row_loads,  c.level_words};
    for (int k = 0; k < 8; ++k) p.counts[k * p.n + i] = v[k];
    // each lane adds its share of its warp's counters (the lowest active
    // lane of each pass counted that pass)
    unsigned long long* ws =
        p.warp_stats + static_cast<size_t>(i >> 5) * kWarpStats;
    atomicAdd(ws + 0, outer.popc);
    atomicAdd(ws + 1, outer.passes);
    atomicMin(ws + 2, static_cast<unsigned long long>(t0));
    atomicMax(ws + 3, static_cast<unsigned long long>(t1c));
    atomicAdd(ws + 4, static_cast<unsigned long long>(t_end - t0));
    atomicAdd(ws + 5, inner.popc);
    atomicAdd(ws + 6, inner.passes);
  }
}

template <bool COUNT>
void launch(const Params& p, bool fat, bool shadow, cudaStream_t s) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  if (fat && shadow) hako_mega_kernel<true, true, COUNT><<<blocks, kThreads, 0, s>>>(p);
  else if (fat) hako_mega_kernel<true, false, COUNT><<<blocks, kThreads, 0, s>>>(p);
  else if (shadow) hako_mega_kernel<false, true, COUNT><<<blocks, kThreads, 0, s>>>(p);
  else hako_mega_kernel<false, false, COUNT><<<blocks, kThreads, 0, s>>>(p);
}

}  // namespace

// C entry for ctypes. Pointers are device pointers except level_off (host,
// T - 1 ints). counts / warp_stats: null for the main variant; else the
// counting variant runs and fills counts [8, n] int32 (per ray: rounds,
// descents, supernode and brick DDA iterations, walk64 calls, row words
// read, row reads, level-table words) and warp_stats [ceil(n / 32), 7]
// uint64 (per warp: the round loop's active-lane sum and passes, first and
// last clock64, the sum of its lanes' lives (each from its first clock to
// the pass that resolved its ray), the probe and DDA loops' active-lane
// sum and passes), which the caller fills with
// (0, 0, ~0, 0, 0, 0, 0) rows. Returns cudaGetLastError() after the
// launch; the caller raises if it is not 0.
extern "C" int hako_mega_launch(
    const void* bricks, const void* snodes, const void* levels,
    const int* level_off, int T, unsigned root_lo, unsigned root_hi,
    const void* bounds, const void* ro, const void* rd, int n, void* t_out,
    void* nmaj_out, void* vrank_out, void* unresolved, int shadow,
    int max_probes, int max_dda, int max_rounds, float dt_snode,
    float dt_brick, void* counts, void* warp_stats, void* stream) {
  if (T < 1 || T - 1 > kMaxLevels || n <= 0) return cudaErrorInvalidValue;
  Params p{};
  p.bricks = static_cast<const uint32_t*>(bricks);
  p.snodes = static_cast<const uint32_t*>(snodes);
  p.levels = static_cast<const uint32_t*>(levels);
  for (int l = 0; l < T - 1; ++l) p.level_off[l] = level_off[l];
  p.root_lo = root_lo;
  p.root_hi = root_hi;
  p.bounds = static_cast<const float*>(bounds);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.t_out = static_cast<float*>(t_out);
  p.nmaj_out = static_cast<int*>(nmaj_out);
  p.vrank_out = static_cast<int*>(vrank_out);
  p.unresolved = static_cast<int*>(unresolved);
  p.counts = static_cast<int*>(counts);
  p.warp_stats = static_cast<unsigned long long*>(warp_stats);
  p.n = n;
  p.T = T;
  p.max_probes = max_probes;
  p.max_dda = max_dda;
  p.max_rounds = max_rounds;
  p.dt_snode = dt_snode;
  p.dt_brick = dt_brick;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fat = snodes != nullptr;
  if (counts != nullptr) launch<true>(p, fat, shadow != 0, s);
  else launch<false>(p, fat, shadow != 0, s);
  return static_cast<int>(cudaGetLastError());
}
