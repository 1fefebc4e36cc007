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
// until it hits, exhausts the tree, or reaches max_rounds, with its own
// trip counts: there is no lockstep, so stragglers cost only their own
// thread. Rows (656 B) are read straight from global memory through
// L1/L2; level tables are plain indexed loads. No dedup, no DMA, no U
// budget: results do not depend on them (the reference's tests).
//
// What bounds it on an H100: chains of dependent global loads (node word
// -> row words -> next row) and warp divergence between rays that need
// different numbers of rounds and DDA steps, not bandwidth: a 1080p frame
// touches a few MB of rows, which the 50 MB L2 holds. The design answers
// with one independent thread per ray and 128-thread blocks, so the SMs
// keep many rays' loads in flight while others compute. A shared-memory
// row cache per block, warp-coherent ray tiles and persistent blocks are
// left for later measurement-driven work.
//
// Exactness: see hako_device.cuh (-fmad=false, IEEE division).

#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace {

constexpr int kMaxLevels = 8;  // must match utils/cuda_build.py MAX_LEVELS
constexpr int kThreads = 128;

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
  int n, T, max_probes, max_dda, max_rounds;
  float dt_snode, dt_brick;  // 0.25^T and 0.25^(T+2 if fat else T)
};

template <bool FAT, bool SHADOW>
__global__ void __launch_bounds__(kThreads) hako_mega_kernel(const Params p) {
  using namespace hako;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  // mirrored parametrization (the reference's _ray_preamble)
  float t0[3], t1[3], dt[3];
  int vm6 = 0;
  const int pat[3] = {0b001001, 0b010010, 0b100100};
  for (int a = 0; a < 3; ++a) {
    const float lo = p.bounds[a];
    const float up = p.bounds[3 + a];
    const float ro = p.ro[3 * i + a];
    const float inv = 1.0f / p.rd[3 * i + a];
    const bool neg = inv < 0.0f;
    const float rom = neg ? (lo + up) - ro : ro;
    const float bound =
        (0.25f * kMaxFloat) / jmax(jmax(fabsf(lo - rom), fabsf(up - rom)), 1.0f);
    const float inva = jmin(fabsf(inv), bound);
    t0[a] = (lo - rom) * inva;
    t1[a] = (up - rom) * inva;
    dt[a] = t1[a] - t0[a];
    if (neg) vm6 |= pat[a];
  }
  const bool enter_ok = min3(t1[0], t1[1], t1[2]) >= max3(t0[0], t0[1], t0[2]);

  bool resolved = !enter_ok;  // no-enter rays are misses
  float t_q = 0.0f;
  float t_out = kMaxFloat;
  int nm_out = -1;
  uint32_t vi_out = 0;
  for (int rnd = 0; rnd < p.max_rounds && !resolved; ++rnd) {
    const Probe pr = probe_from_root(p.levels, p.level_off, p.T, p.root_lo,
                                     p.root_hi, t1, dt, vm6, t_q,
                                     p.max_probes);
    float tqn = pr.tqn;
    bool emit = pr.emit;
    uint32_t child = static_cast<uint32_t>(pr.child);
    float bt1[3] = {pr.bt1[0], pr.bt1[1], pr.bt1[2]};
    float tqe = pr.tqe;
    if (FAT && emit) {
      // stage 1: the supernode row walk emits the next brick + planes
      const Dda s = dda_rows<false, SHADOW>(
          p.snodes + static_cast<size_t>(child) * kRowWords, dt, p.dt_snode,
          vm6, bt1, tqe, p.max_dda);
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
          vm6, bt1, tqe, p.max_dda);
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
  }
  if (!resolved) atomicAdd(p.unresolved, 1);
  p.t_out[i] = t_out;
  p.nmaj_out[i] = nm_out;
  p.vrank_out[i] = static_cast<int>(vi_out);
}

template <bool FAT, bool SHADOW>
void launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  hako_mega_kernel<FAT, SHADOW><<<blocks, kThreads, 0, stream>>>(p);
}

}  // namespace

// C entry for ctypes. Pointers are device pointers except level_off (host,
// T - 1 ints). Returns cudaGetLastError() after the launch; the caller
// raises if it is not 0.
extern "C" int hako_mega_launch(
    const void* bricks, const void* snodes, const void* levels,
    const int* level_off, int T, unsigned root_lo, unsigned root_hi,
    const void* bounds, const void* ro, const void* rd, int n, void* t_out,
    void* nmaj_out, void* vrank_out, void* unresolved, int shadow,
    int max_probes, int max_dda, int max_rounds, float dt_snode,
    float dt_brick, void* stream) {
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
  p.n = n;
  p.T = T;
  p.max_probes = max_probes;
  p.max_dda = max_dda;
  p.max_rounds = max_rounds;
  p.dt_snode = dt_snode;
  p.dt_brick = dt_brick;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fat = snodes != nullptr;
  if (fat && shadow) launch<true, true>(p, s);
  else if (fat) launch<true, false>(p, s);
  else if (shadow) launch<false, true>(p, s);
  else launch<false, false>(p, s);
  return static_cast<int>(cudaGetLastError());
}
