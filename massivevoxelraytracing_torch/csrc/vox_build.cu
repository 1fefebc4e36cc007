// The scene build's device work on Hopper, one kernel a stage of
// ops/voxelize.py.
//
// Replaces XLA-fused work of the reference (no pallas_call): on the TPU
// each of voxelize_dense, count_voxels, sort_and_unique_sums,
// merge_unique_sums and _chunk_emit is one jitted program a chunk shape;
// run as eager tensor code the voxelizer is a few hundred launches over
// [chunk, cap^3] tensors a chunk a pass, and the unique 7 scatter passes
// with their gathers and unpacks.
//
//   vox_count_kernel<SIX>           replaces massivevoxelraytracing_tpu/
//       ops/voxelize.py:266-349 (voxelize_dense's valid mask, count_voxels)
//       and models/scene.py:160-161 (the count pass). Bound: bytes (40 B
//       a triangle) over the operations of its walk (~190 a triangle, ~22
//       a unit, ~26 a tested cell; on the bbox, ~40 a cell, operations
//       bound: scripts/common.vox_bound). One thread a triangle, its context
//       (triangle_contexts :79-177) in registers. Its candidates
//       (coverage_mask :180-237) are walked as units in candidate order, a
//       unit a column (X, Y) of the voxel bbox and a run of up to kZCells Z
//       cells: the major-axis edge tests and the z slab once a unit, then
//       only the cells inside the slab (on the bench lattice 37.3M of the
//       151.7M bbox cells); int counters.
//   vox_emit_kernel<SIX>            replaces ops/voxelize.py:266-343
//       (voxelize_dense) and models/scene.py:36-49 (_chunk_emit). A warp
//       takes 32 triangles, one a lane, and its lanes walk their units in
//       step as the count does; the units with valid cells go to the
//       warp's queue in shared memory (their cells' bit mask and first
//       position), and whenever 32 cells wait each lane emits one: the
//       int64 Morton code, and the colour and emission at the closest point
//       of the cell corner (closest_barycentric :240-263, pack_rgb8 :45), at
//       offsets[t] + its rank (increasing candidate index). The closest-point
//       arithmetic so runs on full warps whatever the triangles' sizes.
//       Bound: bytes (16 B a dumped voxel) and the closest-point arithmetic;
//       no candidate tensor exists.
//   vox_unique_reduce_kernel<MODE>  replaces ops/voxelize.py:351-506
//       (sort_and_unique_sums, merge_unique_sums, sort_and_unique: the
//       segment sums). The stable sort, the neighbour compare and the
//       boundaries' cumsum stay torch ops. A thread on a run's first
//       entry walks the run through perm and sums the six 8-bit channels
//       and the count in int64 (or the groups' sums); exact integer sums
//       need no atomics and equal the scatter_add_ sums in any order.
//       Bound: bytes (perm, key and
//       the attribute words a sorted entry; the gathers through perm are
//       random, so each touches a 32 B sector).
//
// Exactness: every value equals the plain stage's bit for bit. Built with
// -fmad=false (no contraction) and IEEE division; float expressions keep
// the plain code's order, left to right; min / max / clamp propagate NaN
// as torch's do; a float-to-int cast saturates with NaN to 0, as torch's
// on the card does; int32 arithmetic wraps as torch's does (zmax - 1).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kZCells = 32;  // Z cells of a unit, a bit each
constexpr int kMeans = 0, kSums = 1, kMerge = 2;  // voxelize.MODES

__device__ __forceinline__ long long lane0() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long lane_step() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// torch.maximum / torch.minimum / clamp: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// float -> int32 as torch casts on the card: truncate, saturate, NaN -> 0
__device__ __forceinline__ int f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}

// int32 a - 1 with the wrap of torch's int32 arithmetic
__device__ __forceinline__ int minus1(int a) {
  return static_cast<int>(static_cast<unsigned>(a) - 1u);
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// morton._part1by2
__device__ __forceinline__ long long part1by2(int v) {
  long long x = static_cast<long long>(v) & 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFll;
  x = (x | (x << 16)) & 0x1F0000FF0000FFll;
  x = (x | (x << 8)) & 0x100F00F00F00F00Fll;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ll;
  x = (x | (x << 2)) & 0x1249249249249249ll;
  return x;
}

// pack_rgb8's quantizer: clamp(v * 255 + 0.5, 0, 255), NaN -> 0, truncate
__device__ __forceinline__ uint32_t quant8(float v) {
  float x = v * 255.0f + 0.5f;
  if (x != x) return 0u;
  return static_cast<uint32_t>(fminf(fmaxf(x, 0.0f), 255.0f));
}

__device__ __forceinline__ int pack_rgb8(float r, float g, float b) {
  return static_cast<int>(quant8(r) | (quant8(g) << 8) | (quant8(b) << 16) | 0xFF000000u);
}

// x[m] for a runtime m in {0, 1, 2}, without indexing a local array by it
// (which would put the array in local memory)
__device__ __forceinline__ float pick(const float* x, int m) {
  return m == 0 ? x[0] : (m == 1 ? x[1] : x[2]);
}

__device__ __forceinline__ int pick(const int* x, int m) {
  return m == 0 ? x[0] : (m == 1 ? x[1] : x[2]);
}

// The per-triangle context (voxelize.triangle_contexts): the major axis
// m, the clamped voxel bbox in projected (u, v, w) = (m, m + 1, m + 2)
// order, the z slab's constants, and the edge functions of the axes m
// (tested at the cell's (xc, yc)), m + 1 (at (yc, zc)) and m + 2 (at (zc,
// xc)): the cell corner r has r[m] = xc, r[m + 1] = yc, r[m + 2] = zc.
struct Ctx {
  int major;
  int lo[3], up[3];          // u, v, w
  float o[3];                // origin in u, v, w
  float kx, ky, c_lo, c_hi;  // c_min, c_max; with SIX c_six in c_hi
  float ex[3][3], ey[3][3], ed[3][3];  // [m, m + 1, m + 2][edge]
  bool empty;
};

template <bool SIX>
__device__ __forceinline__ void make_ctx(const float* v0, const float* v1, const float* v2,
                                         const float* origin, float dps, int grid_res,
                                         Ctx& c) {
  float e01[3], e12[3], n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e01[k] = v1[k] - v0[k];
    e12[k] = v2[k] - v1[k];
  }
  cross(e01, e12, n);
  float ax = fabsf(n[0]), ay = fabsf(n[1]), az = fabsf(n[2]);
  const int m = ax < ay ? (ay < az ? 0 : 2) : (ax < az ? 0 : 1);
  c.major = m;

  int lower[3], upper[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float bb_lo = nan_min(nan_min(v0[k], v1[k]), v2[k]);
    float bb_hi = nan_max(nan_max(v0[k], v1[k]), v2[k]);
    lower[k] = f2i(floorf((bb_lo - origin[k]) / dps));
    upper[k] = f2i(floorf((bb_hi - origin[k]) / dps));
    lower[k] = lower[k] < 0 ? 0 : lower[k];
    upper[k] = upper[k] > grid_res - 1 ? grid_res - 1 : upper[k];
  }

  // every axis's edge functions, then the three in (m, m + 1, m + 2) order
  float ex[3][3], ey[3][3], ed[3][3];
  const float* vs[3] = {v0, v1, v2};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const int a = axis, b = (axis + 1) % 3;
    const float s = 0.0f < n[(axis + 2) % 3] ? 1.0f : -1.0f;
#pragma unroll
    for (int edge = 0; edge < 3; ++edge) {
      float au = vs[edge][a], av = vs[edge][b];
      float bu = vs[(edge + 1) % 3][a], bv = vs[(edge + 1) % 3][b];
      float nex = -(bv - av) * s;
      float ney = (bu - au) * s;
      float d;
      if (!SIX) {
        d = nan_max(nex * dps, 0.0f) + nan_max(ney * dps, 0.0f) - (nex * au + ney * av);
      } else {
        d = nex * (dps * 0.5f - au) + ney * (dps * 0.5f - av) +
            0.5f * dps * nan_max(fabsf(nex), fabsf(ney));
      }
      ex[axis][edge] = nex;
      ey[axis][edge] = ney;
      ed[axis][edge] = d;
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = (m + j) % 3;  // runtime: picked, never an index
#pragma unroll
    for (int edge = 0; edge < 3; ++edge) {
      c.ex[j][edge] = k == 0 ? ex[0][edge] : (k == 1 ? ex[1][edge] : ex[2][edge]);
      c.ey[j][edge] = k == 0 ? ey[0][edge] : (k == 1 ? ey[1][edge] : ey[2][edge]);
      c.ed[j][edge] = k == 0 ? ed[0][edge] : (k == 1 ? ed[1][edge] : ed[2][edge]);
    }
    c.o[j] = pick(origin, k);
    c.lo[j] = pick(lower, k);
    c.up[j] = pick(upper, k);
  }

  const int mv = (m + 1) % 3, mw = (m + 2) % 3;
  float kx = -pick(n, m) / pick(n, mw);
  float ky = -pick(n, mv) / pick(n, mw);
  float K = -kx * pick(v0, m) - ky * pick(v0, mv) + pick(v0, mw);
  c.kx = kx;
  c.ky = ky;
  if (SIX) {
    c.c_hi = K + 0.5f * dps * (kx + ky);
    c.c_lo = 0.0f;
  } else {
    c.c_hi = K + dps * (nan_max(kx, 0.0f) + nan_max(ky, 0.0f));
    c.c_lo = K + dps * (nan_min(kx, 0.0f) + nan_min(ky, 0.0f));
  }
  bool degenerate = n[0] == 0.0f && n[1] == 0.0f && n[2] == 0.0f;
  c.empty = degenerate || upper[0] < lower[0] || upper[1] < lower[1] || upper[2] < lower[2];
}

__device__ __forceinline__ bool edges_pass(const float* ex, const float* ey, const float* ed,
                                           float pu, float pv) {
  return ex[0] * pu + ey[0] * pv + ed[0] >= 0.0f && ex[1] * pu + ey[1] * pv + ed[1] >= 0.0f &&
         ex[2] * pu + ey[2] * pv + ed[2] >= 0.0f;
}

// The valid cells of unit (X, Y, zbase) of triangle c (its column and a
// run of kZCells Z cells) as the bits Z - zbase. The major-axis edge tests
// and the z slab run once (yRangeInclusive, zRangeInclusive), then only the
// cells of the slab's range [max(zmin, lo_w), min(zmax, up_w)] within the
// cap (zend) and this run are tested: intersect(p), the other two axes'
// edge tests, skipped when the bbox is flat along the remainder axis.
template <bool SIX>
__device__ __forceinline__ unsigned unit_mask(const Ctx& c, int X, int Y, int zbase, int zend,
                                              bool flat, float dps) {
  const float xc = c.o[0] + static_cast<float>(X) * dps;
  const float yc = c.o[1] + static_cast<float>(Y) * dps;
  if (!edges_pass(c.ex[0], c.ey[0], c.ed[0], xc, yc)) return 0u;
  const float var = c.kx * xc + c.ky * yc;
  int zmin, zmax;
  if (SIX) {
    float indexf = (var + c.c_hi - c.o[2]) / dps;
    float zf = floorf(indexf);
    zmax = f2i(zf);
    zmin = indexf == zf ? minus1(zmax) : zmax;
  } else {
    zmin = f2i(floorf((var + c.c_lo - c.o[2]) / dps));
    zmax = f2i(floorf((var + c.c_hi - c.o[2]) / dps));
  }
  // zbase >= lo_w and zend <= up_w: no int arithmetic on zmin / zmax
  const int zlo = zmin > zbase ? zmin : zbase;
  int zhi = zmax < zend ? zmax : zend;
  zhi = zhi < zbase + (kZCells - 1) ? zhi : zbase + (kZCells - 1);
  unsigned mask = 0u;
  for (int Z = zlo; Z <= zhi; ++Z) {
    const float zc = c.o[2] + static_cast<float>(Z) * dps;
    if (flat || (edges_pass(c.ex[1], c.ey[1], c.ed[1], yc, zc) &&
                 edges_pass(c.ex[2], c.ey[2], c.ed[2], zc, xc))) {
      mask |= 1u << (Z - zbase);
    }
  }
  return mask;
}

// A triangle's units in candidate order: columns (ox, oy) < (ext_u,
// ext_v), each a run of Z chunks zb < nz (one unless cap > kZCells)
struct Units {
  int lo_u, lo_v, lo_w, ext_u, ext_v, nz, zend;
  bool flat;
  int ox, oy, zb;

  __device__ __forceinline__ void init(const Ctx& c, int cap) {
    ox = oy = zb = 0;
    lo_u = lo_v = lo_w = ext_u = ext_v = zend = 0;
    nz = 1;
    flat = false;
    if (c.empty) return;
    int ext[3];  // lo <= up < grid_res: no overflow
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = c.up[k] - c.lo[k] + 1;
      ext[k] = e < cap ? e : cap;
    }
    lo_u = c.lo[0];
    lo_v = c.lo[1];
    lo_w = c.lo[2];
    ext_u = ext[0];
    ext_v = ext[1];
    nz = (ext[2] + kZCells - 1) / kZCells;
    zend = c.lo[2] + ext[2] - 1;
    flat = c.lo[2] == c.up[2];
  }
  __device__ __forceinline__ bool more() const { return ox < ext_u; }
  __device__ __forceinline__ void next() {
    if (++zb == nz) {
      zb = 0;
      if (++oy == ext_v) {
        oy = 0;
        ++ox;
      }
    }
  }
};

// The position of the k-th (from 0) set bit of m (which has more than k)
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

__device__ __forceinline__ void load3x3(const float* p, long long t, float* v0, float* v1,
                                        float* v2) {
  const float* q = p + 9 * t;
  for (int k = 0; k < 3; ++k) {
    v0[k] = q[k];
    v1[k] = q[3 + k];
    v2[k] = q[6 + k];
  }
}

struct CountArgs {
  const float* tri;
  const float* origin;
  const float* dps;
  long long n;
  int grid_res, cap;
  int* count;
};

template <bool SIX>
__global__ void __launch_bounds__(kThreads, 4) vox_count_kernel(CountArgs a) {
  const float dps = *a.dps;
  const float origin[3] = {a.origin[0], a.origin[1], a.origin[2]};
  for (long long t = lane0(); t < a.n; t += lane_step()) {
    float v0[3], v1[3], v2[3];
    load3x3(a.tri, t, v0, v1, v2);
    Ctx c;
    make_ctx<SIX>(v0, v1, v2, origin, dps, a.grid_res, c);
    Units u;
    u.init(c, a.cap);
    int n = 0;
    for (; u.more(); u.next()) {
      n += __popc(unit_mask<SIX>(c, u.lo_u + u.ox, u.lo_v + u.oy, u.lo_w + u.zb * kZCells,
                                 u.zend, u.flat, dps));
    }
    a.count[t] = n;
  }
}

struct EmitArgs {
  const float *tri, *col, *emi;
  const long long* offsets;
  const float* origin;
  const float* dps;
  long long n, n_out;
  int grid_res, cap;
  long long* code;
  int *color, *emission;
};

// closest_barycentric's branch ladder, then bc / (bc0 + bc1 + bc2)
__device__ __forceinline__ void closest_bc(const float* v0, const float* v1, const float* v2,
                                           const float* ng, const float* e0, const float* e1,
                                           const float* e2, const float* p, float* bc) {
  float d0[3], d1[3], d2[3], nd0[3], nd1[3], nd2[3], x[3];
  for (int k = 0; k < 3; ++k) {
    d0[k] = v0[k] - p[k];
    d1[k] = v1[k] - p[k];
    d2[k] = v2[k] - p[k];
    nd0[k] = -d0[k];
    nd1[k] = -d1[k];
    nd2[k] = -d2[k];
  }
  cross(d2, d0, x);
  float U = dot(x, ng);
  cross(d0, d1, x);
  float V = dot(x, ng);
  cross(d1, d2, x);
  float W = dot(x, ng);
  bool u_neg = U < 0.0f;
  bool v_neg = !u_neg && V < 0.0f;
  bool w_neg = !u_neg && !v_neg && W < 0.0f;
  float V2 = u_neg ? dot(nd0, e0) : (v_neg ? V : (w_neg ? dot(d1, e2) : V));
  float W2 = u_neg ? dot(d2, e0) : (v_neg ? dot(nd1, e1) : W);
  float U2 = v_neg ? dot(d0, e1) : (w_neg ? dot(nd2, e2) : U);
  float b0 = nan_max(U2, 0.0f), b1 = nan_max(V2, 0.0f), b2 = nan_max(W2, 0.0f);
  float tot = b0 + b1 + b2;
  bc[0] = b0 / tot;
  bc[1] = b1 / tot;
  bc[2] = b2 / tot;
}

// the reference's rotation: bc.x * a1 + bc.y * a2 + bc.z * a0, packed
__device__ __forceinline__ int shade(const float* bc, const float* a0, const float* a1,
                                     const float* a2) {
  float ch[3];
  for (int k = 0; k < 3; ++k) ch[k] = bc[0] * a1[k] + bc[1] * a2[k] + bc[2] * a0[k];
  return pack_rgb8(ch[0], ch[1], ch[2]);
}

constexpr int kQueue = 64;  // a warp's queue: < 32 pending units + 32 new ones

// A warp's units with valid cells, in the order the lanes find them (a
// ring), and its lanes' triangles, for the voxel expansion: cell s of the
// warp's stream lies in the unit whose first cell (vstart) is the last at
// or before s.
struct WarpQueue {
  float tri[27][32];  // v0, v1, v2, colours, emissions of each lane's triangle
  int major[32];
  unsigned mask[kQueue];
  int X[kQueue], Y[kQueue], zbase[kQueue], lane[kQueue];
  long long vstart[kQueue], pos[kQueue];
};

// The unit of queue entries [head, tail) that holds stream cell s
__device__ __forceinline__ int find_unit(const WarpQueue& q, int head, int tail, long long s) {
  int lo = head, hi = tail - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (q.vstart[mid % kQueue] <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Stream cells done + lane, lane < cnt: one a lane, its code, colour and
// emission at its unit's position + its rank among the unit's cells.
__device__ __forceinline__ void emit_cells(const WarpQueue& q, const EmitArgs& a,
                                           const float* origin, float dps, int head, int tail,
                                           long long done, int cnt) {
  const int lane = threadIdx.x & 31;
  if (lane >= cnt) return;
  const long long s = done + lane;
  const int j = find_unit(q, head, tail, s) % kQueue;
  const int k = static_cast<int>(s - q.vstart[j]);
  const long long pos = q.pos[j] + k;
  if (pos < 0 || pos >= a.n_out) return;
  const int owner = q.lane[j];
  const int m = q.major[owner];
  const int X = q.X[j], Y = q.Y[j], Z = q.zbase[j] + nth_bit(q.mask[j], k);
  const float xc = pick(origin, m) + static_cast<float>(X) * dps;
  const float yc = pick(origin, (m + 1) % 3) + static_cast<float>(Y) * dps;
  const float zc = pick(origin, (m + 2) % 3) + static_cast<float>(Z) * dps;
  // unproject: grid coordinates and the cell corner in axis order
  const int i0 = m == 0 ? X : (m == 1 ? Z : Y);
  const int i1 = m == 0 ? Y : (m == 1 ? X : Z);
  const int i2 = m == 0 ? Z : (m == 1 ? Y : X);
  const float p[3] = {m == 0 ? xc : (m == 1 ? zc : yc), m == 0 ? yc : (m == 1 ? xc : zc),
                      m == 0 ? zc : (m == 1 ? yc : xc)};
  a.code[pos] = part1by2(i0) | (part1by2(i1) << 1) | (part1by2(i2) << 2);
  float v0[3], v1[3], v2[3];
  for (int i = 0; i < 3; ++i) {
    v0[i] = q.tri[i][owner];
    v1[i] = q.tri[3 + i][owner];
    v2[i] = q.tri[6 + i][owner];
  }
  float e0[3], e1[3], e2[3], ng[3], bc[3];
  for (int i = 0; i < 3; ++i) {
    e0[i] = v2[i] - v0[i];
    e1[i] = v0[i] - v1[i];
    e2[i] = v1[i] - v2[i];
  }
  cross(e2, e0, ng);
  closest_bc(v0, v1, v2, ng, e0, e1, e2, p, bc);
  float f[9];
  for (int i = 0; i < 9; ++i) f[i] = q.tri[9 + i][owner];
  a.color[pos] = shade(bc, f, f + 3, f + 6);
  for (int i = 0; i < 9; ++i) f[i] = q.tri[18 + i][owner];
  a.emission[pos] = shade(bc, f, f + 3, f + 6);
}

// A warp takes 32 triangles, one a lane: each lane walks its own units
// (its context in registers), a unit a step; the units with valid cells go
// to the warp's queue, and whenever 32 cells wait, each lane emits one.
template <bool SIX>
__global__ void __launch_bounds__(kThreads, 3) vox_emit_kernel(EmitArgs a) {
  __shared__ WarpQueue queues[kWarps];
  WarpQueue& q = queues[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float dps = *a.dps;
  const float origin[3] = {a.origin[0], a.origin[1], a.origin[2]};
  for (long long base = lane0() - lane; base < a.n; base += lane_step()) {
    const long long t = base + lane;
    Ctx c;
    c.empty = true;
    long long pos = 0;
    if (t < a.n) {
      float v0[3], v1[3], v2[3];
      load3x3(a.tri, t, v0, v1, v2);
      make_ctx<SIX>(v0, v1, v2, origin, dps, a.grid_res, c);
      for (int k = 0; k < 3; ++k) {
        q.tri[k][lane] = v0[k];
        q.tri[3 + k][lane] = v1[k];
        q.tri[6 + k][lane] = v2[k];
      }
      for (int k = 0; k < 9; ++k) {
        q.tri[9 + k][lane] = a.col[9 * t + k];
        q.tri[18 + k][lane] = a.emi[9 * t + k];
      }
      q.major[lane] = c.major;
      pos = a.offsets[t];
    }
    Units u;
    u.init(c, a.cap);
    long long queued = 0, done = 0;  // the warp's stream cells queued, emitted
    int head = 0, tail = 0;          // queue entries: the first pending, the next free
    while (__any_sync(0xFFFFFFFFu, u.more())) {
      unsigned m = 0u;
      int X = u.lo_u + u.ox, Y = u.lo_v + u.oy, zbase = u.lo_w + u.zb * kZCells;
      if (u.more()) {
        m = unit_mask<SIX>(c, X, Y, zbase, u.zend, u.flat, dps);
        u.next();
      }
      const int n = __popc(m);
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += y;
      }
      const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
      const unsigned has = __ballot_sync(0xFFFFFFFFu, n > 0);
      __syncwarp();  // the last windows' reads before these writes
      if (n > 0) {
        const int e = (tail + __popc(has & below)) % kQueue;
        q.mask[e] = m;
        q.X[e] = X;
        q.Y[e] = Y;
        q.zbase[e] = zbase;
        q.lane[e] = lane;
        q.vstart[e] = queued + incl - n;
        q.pos[e] = pos;
      }
      pos += n;
      tail += __popc(has);
      queued += total;
      __syncwarp();
      for (; queued - done >= 32; done += 32) {
        emit_cells(q, a, origin, dps, head, tail, done, 32);
        head = queued - done > 32 ? find_unit(q, head, tail, done + 32) : tail;
      }
      if (head >= kQueue) {  // keep the counters small: entries are taken mod kQueue
        head -= kQueue;
        tail -= kQueue;
      }
    }
    emit_cells(q, a, origin, dps, head, tail, done, static_cast<int>(queued - done));
    __syncwarp();  // before the next triangles overwrite the queue
  }
}

struct ReduceArgs {
  const long long *s_key, *perm, *seg;
  const bool* boundary;
  long long n;
  const void* in[7];  // means / sums: color, emission (int32); merge: 6 sums, count (int64)
  long long* code;
  void* out[7];  // means / merge: color, emission (int32); sums: 6 sums, count (int64)
};

__device__ __forceinline__ int pack_means(const long long* s, long long cnt) {
  return static_cast<int>(static_cast<uint32_t>(s[0] / cnt) |
                          (static_cast<uint32_t>(s[1] / cnt) << 8) |
                          (static_cast<uint32_t>(s[2] / cnt) << 16) | 0xFF000000u);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) vox_unique_reduce_kernel(ReduceArgs a) {
  for (long long i = lane0(); i < a.n; i += lane_step()) {
    if (!a.boundary[i]) continue;
    const long long key = a.s_key[i];
    long long s[6] = {0, 0, 0, 0, 0, 0};
    long long cnt = 0;
    for (long long j = i; j < a.n && a.s_key[j] == key; ++j) {
      long long p = a.perm[j];
      if (MODE == kMerge) {
        for (int k = 0; k < 6; ++k) s[k] += static_cast<const long long*>(a.in[k])[p];
        cnt += static_cast<const long long*>(a.in[6])[p];
      } else {
        for (int w = 0; w < 2; ++w) {
          uint32_t packed = static_cast<uint32_t>(static_cast<const int*>(a.in[w])[p]);
          s[3 * w] += packed & 0xFF;
          s[3 * w + 1] += (packed >> 8) & 0xFF;
          s[3 * w + 2] += (packed >> 16) & 0xFF;
        }
        ++cnt;
      }
    }
    long long u = a.seg[i];
    a.code[u] = key;
    if (MODE == kSums) {
      for (int k = 0; k < 6; ++k) static_cast<long long*>(a.out[k])[u] = s[k];
      static_cast<long long*>(a.out[6])[u] = cnt;
    } else {
      cnt = cnt > 1 ? cnt : 1;
      static_cast<int*>(a.out[0])[u] = pack_means(s, cnt);
      static_cast<int*>(a.out[1])[u] = pack_means(s + 3, cnt);
    }
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, long long n, void* stream) {
  if (n <= 0) return 0;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vox_count_launch(int six, const void* tri, long long n, const void* origin,
                                const void* dps, int grid_res, int cap, void* count,
                                void* stream) {
  CountArgs a{static_cast<const float*>(tri), static_cast<const float*>(origin),
              static_cast<const float*>(dps), n, grid_res, cap, static_cast<int*>(count)};
  return six ? launch(vox_count_kernel<true>, a, n, stream)
             : launch(vox_count_kernel<false>, a, n, stream);
}

// Writes nothing at or past n_out (the buffers' length).
extern "C" int vox_emit_launch(int six, const void* tri, const void* col, const void* emi,
                               const void* offsets, long long n, const void* origin,
                               const void* dps, int grid_res, int cap, long long n_out,
                               void* code, void* color, void* emission, void* stream) {
  EmitArgs a{static_cast<const float*>(tri), static_cast<const float*>(col),
             static_cast<const float*>(emi), static_cast<const long long*>(offsets),
             static_cast<const float*>(origin), static_cast<const float*>(dps), n, n_out,
             grid_res, cap, static_cast<long long*>(code), static_cast<int*>(color),
             static_cast<int*>(emission)};
  return six ? launch(vox_emit_kernel<true>, a, n, stream)
             : launch(vox_emit_kernel<false>, a, n, stream);
}

// mode: 0 means, 1 sums, 2 merge (voxelize.MODES); in / out: 7 device
// pointers each (those a mode does not use are ignored); the outputs hold
// seg's largest value on a boundary entry, plus one.
extern "C" int vox_unique_reduce_launch(int mode, const void* s_key, const void* perm,
                                        const void* boundary, const void* seg, long long n,
                                        const void* const* in, void* code,
                                        void* const* out, void* stream) {
  ReduceArgs a{};
  a.s_key = static_cast<const long long*>(s_key);
  a.perm = static_cast<const long long*>(perm);
  a.seg = static_cast<const long long*>(seg);
  a.boundary = static_cast<const bool*>(boundary);
  a.n = n;
  int n_in = mode == kMerge ? 7 : 2, n_out = mode == kSums ? 7 : 2;
  for (int k = 0; k < n_in; ++k) a.in[k] = in[k];
  for (int k = 0; k < n_out; ++k) a.out[k] = out[k];
  a.code = static_cast<long long*>(code);
  switch (mode) {
    case kMeans: return launch(vox_unique_reduce_kernel<kMeans>, a, n, stream);
    case kSums: return launch(vox_unique_reduce_kernel<kSums>, a, n, stream);
    default: return launch(vox_unique_reduce_kernel<kMerge>, a, n, stream);
  }
}
