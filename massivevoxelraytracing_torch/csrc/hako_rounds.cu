// The legacy HakoTree round driver's kernels on Hopper: kernel A
// (hako_probe), kernel B (hako_dda, leaf and supernode rows, primary and
// shadow) and the merge (hako_merge). The host loop around them is
// ops/hako_kernels.py::intersect_rays_hako: each round takes the lanes
// still unresolved (an index list), runs A, B on the supernode rows of a
// fat tree, B on the brick rows, and merges, until no lane is left.
//
// Replaces the Pallas kernels of massivevoxelraytracing_tpu/ops/
// hako_kernels.py: kernel A (_make_kernel_a, launched at :1218 and in its
// fused form at :1681), kernel B (_make_kernel_b, :1252 and fused :1700)
// and the merge (_make_merge_kernel, :1735). On the TPU a grid step owned
// a block of rays in lockstep; the round driver picked whole ray blocks,
// gathered each lane's 164-word row from HBM in XLA, transposed it to
// word-major in VMEM, and wrote the state back with XLA scatters. Here
// every kernel runs one thread per active lane, reached through the
// round's index list: B reads its own row straight from global memory by
// child id (no gather buffer, no transpose), and the merge writes the
// lane's state in place.
//
// What bounds them on an H100: each launch is a short pass over the active
// lanes (tens of bytes of state per lane in and out, plus the rows B
// touches), so at the shapes of the main path they are bound by memory
// traffic and, late in a traversal when few lanes are left, by launch and
// host-sync latency (one "any lane active?" read per round). The design
// keeps state per lane in flat arrays indexed by the round's list, so the
// reads are dense in the list's order; rows go through L1/L2 as in the
// megakernel. Fusing a round into one launch, persistent lanes and a row
// cache are later work.
//
// Exactness: the kernels share every __device__ function with the
// megakernel (hako_device.cuh), so both routes give identical bits.

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
  Probe r{false, !ray.enter_ok, 0, {0.0f, 0.0f, 0.0f}, tq0, tq0};
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
  Dda d{false, false, kMaxFloat, -1, 0u, 0.0f, 0.0f, p.tqe[j]};
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

extern "C" int hako_dda_launch(
    const void* rows, const void* bounds, const void* ro, const void* rd,
    const void* idx, int n, const void* go, const void* child,
    const void* bt1, const void* tqe, void* hit, void* t, void* nmaj,
    void* vr, void* p3, void* tqp, void* more, void* tqr, float dt_factor,
    int leaf, int shadow, int max_iters, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = blocks_for(n);
  if (leaf && shadow) hako_dda_kernel<true, true><<<b, kThreads, 0, s>>>(p);
  else if (leaf) hako_dda_kernel<true, false><<<b, kThreads, 0, s>>>(p);
  else if (shadow) hako_dda_kernel<false, true><<<b, kThreads, 0, s>>>(p);
  else hako_dda_kernel<false, false><<<b, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
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
