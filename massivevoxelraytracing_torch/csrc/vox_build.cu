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
//   vox_run_heads_kernel            replaces ops/voxelize.py:366-374, 416-424,
//       475-483 (the boundary flags, their cumsum and n_unique of the three
//       functions below). A block a tile of kUniqueTile sorted entries
//       counts its run heads (a valid key that differs from the key before
//       it), the keys read once and coalesced; torch.cumsum over the tiles'
//       counts gives each tile's first unique index and n_unique. Bound:
//       bytes (8 B a sorted entry, 8 B a tile).
//   vox_unique_reduce_kernel<MODE>  replaces ops/voxelize.py:352-506
//       (sort_and_unique_sums, merge_unique_sums, sort_and_unique: the
//       segment sums). The stable sort stays torch.sort. A block takes the
//       same tile: its keys and perm are loaded coalesced into shared
//       memory, then each thread takes kUniqueItems consecutive entries,
//       finds their heads and gathers their attribute words through perm
//       (every gather of the tile in flight at once); a segmented scan
//       keyed by the heads (warp shuffles, then the warps' totals) gives
//       each thread the sum of the run it starts in. A run belongs to the
//       tile that holds its head: the thread holding its last entry stages
//       it in shared memory at the head's rank in the tile, and the block
//       writes the staged uniques coalesced at the tile's first unique
//       index (a thread's runs lie kUniqueItems entries apart, so writing
//       them in place scatters the stores); a tile's last run that goes on
//       past the tile is summed by the whole block a chunk of kThreads
//       entries at a time, to the run's end, and written by one thread.
//       Sums are exact integers in any order (no atomics), equal to the
//       scatter_add_ sums: the means / sums mode adds the 8-bit channels
//       three to a 64-bit word in 21-bit fields (a tile's sums stay below
//       2^21), the merge int64 sums. Bound: bytes (the key, perm and
//       attribute words of a sorted entry, each word counted at its 4 B or
//       8 B though the gathers through perm are random; the code and
//       outputs of a unique voxel: scripts/common.vox_bound).
//
// Exactness: every value equals the plain stage's bit for bit. Built with
// -fmad=false (no contraction) and IEEE division; float expressions keep
// the plain code's order, left to right; min / max / clamp propagate NaN
// as torch's do; a float-to-int cast saturates with NaN to 0, as torch's
// on the card does; int32 arithmetic wraps as torch's does (zmax - 1).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

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

constexpr long long kInvalidKey = LLONG_MAX;  // voxelize.INVALID_KEY
constexpr unsigned kFull = 0xFFFFFFFFu;

// Sorted entries a thread of the unique stage's kernels, and a tile
// (voxelize.UNIQUE_TILE)
constexpr int kUniqueItems = 4;
constexpr int kUniqueTile = kThreads * kUniqueItems;

// Shared-memory slot of tile entry j: one pad word every kUniqueItems
// entries, so the consecutive entries of each of 16 threads fall in
// distinct banks
__device__ __forceinline__ int pad(int j) { return j + j / kUniqueItems; }

struct ReduceArgs {
  const long long *s_key, *perm;
  const long long* ends;  // the run heads of tiles 0..b, inclusive
  long long n;
  const void* in[7];  // means / sums: color, emission (int32); merge: 6 sums, count (int64)
  long long* code;
  void* out[7];  // means / merge: color, emission (int32); sums: 6 sums, count (int64)
};

// An entry's attribute words: means / sums, the packed colour and emission
struct Colors {
  uint32_t c, e;
};

// Their running sums: the 8-bit channels three to a word in 21-bit fields
// (at most kUniqueTile * 255 < 2^21 a field, so no field carries into the
// next), and the count
struct Packed {
  unsigned long long c, e;
  unsigned n;
};

// The merge's entry and sums: six int64 sums and the count
struct Wide {
  long long s[6];
  long long n;
};

constexpr unsigned long long kField = (1ull << 21) - 1;

__device__ __forceinline__ unsigned long long fields(uint32_t p) {
  return (p & 0xFFull) | ((p >> 8 & 0xFFull) << 21) | ((p >> 16 & 0xFFull) << 42);
}

__device__ __forceinline__ void zero(Packed& x) {
  x.c = x.e = 0ull;
  x.n = 0u;
}

__device__ __forceinline__ void zero(Wide& x) {
#pragma unroll
  for (int k = 0; k < 6; ++k) x.s[k] = 0;
  x.n = 0;
}

__device__ __forceinline__ void add(Packed& x, const Packed& y) {
  x.c += y.c;
  x.e += y.e;
  x.n += y.n;
}

__device__ __forceinline__ void add(Wide& x, const Wide& y) {
#pragma unroll
  for (int k = 0; k < 6; ++k) x.s[k] += y.s[k];
  x.n += y.n;
}

__device__ __forceinline__ Packed sum_of(const Colors& r) {
  return Packed{fields(r.c), fields(r.e), 1u};
}

__device__ __forceinline__ Wide sum_of(const Wide& r) { return r; }

__device__ __forceinline__ void gather(const ReduceArgs& a, long long p, Colors& r) {
  r.c = static_cast<uint32_t>(__ldg(static_cast<const int*>(a.in[0]) + p));
  r.e = static_cast<uint32_t>(__ldg(static_cast<const int*>(a.in[1]) + p));
}

__device__ __forceinline__ void gather(const ReduceArgs& a, long long p, Wide& r) {
#pragma unroll
  for (int k = 0; k < 6; ++k) r.s[k] = __ldg(static_cast<const long long*>(a.in[k]) + p);
  r.n = __ldg(static_cast<const long long*>(a.in[6]) + p);
}

__device__ __forceinline__ Packed shfl_up(const Packed& x, int d) {
  return Packed{__shfl_up_sync(kFull, x.c, d), __shfl_up_sync(kFull, x.e, d),
                __shfl_up_sync(kFull, x.n, d)};
}

__device__ __forceinline__ Wide shfl_up(const Wide& x, int d) {
  Wide y;
#pragma unroll
  for (int k = 0; k < 6; ++k) y.s[k] = __shfl_up_sync(kFull, x.s[k], d);
  y.n = __shfl_up_sync(kFull, x.n, d);
  return y;
}

__device__ __forceinline__ Packed shfl_xor(const Packed& x, int d) {
  return Packed{__shfl_xor_sync(kFull, x.c, d), __shfl_xor_sync(kFull, x.e, d),
                __shfl_xor_sync(kFull, x.n, d)};
}

__device__ __forceinline__ Wide shfl_xor(const Wide& x, int d) {
  Wide y;
#pragma unroll
  for (int k = 0; k < 6; ++k) y.s[k] = __shfl_xor_sync(kFull, x.s[k], d);
  y.n = __shfl_xor_sync(kFull, x.n, d);
  return y;
}

// The sums as int64: six channel (or group) sums and the count, added to s
__device__ __forceinline__ void widen(const Packed& x, long long* s) {
  s[0] += static_cast<long long>(x.c & kField);
  s[1] += static_cast<long long>(x.c >> 21 & kField);
  s[2] += static_cast<long long>(x.c >> 42);
  s[3] += static_cast<long long>(x.e & kField);
  s[4] += static_cast<long long>(x.e >> 21 & kField);
  s[5] += static_cast<long long>(x.e >> 42);
  s[6] += x.n;
}

__device__ __forceinline__ void widen(const Wide& x, long long* s) {
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] += x.s[k];
  s[6] += x.n;
}

// The segmented scan's operator: (heads, sum) of an earlier span, then of a
// later one; the later one's sum restarts at its first head
template <typename Acc>
__device__ __forceinline__ void combine(int h0, const Acc& x0, int& h, Acc& x) {
  if (h == 0) add(x, x0);
  h += h0;
}

__device__ __forceinline__ int pack_means(const long long* s, long long cnt) {
  return static_cast<int>(static_cast<uint32_t>(s[0] / cnt) |
                          (static_cast<uint32_t>(s[1] / cnt) << 8) |
                          (static_cast<uint32_t>(s[2] / cnt) << 16) | 0xFF000000u);
}

// Unique voxel u: its code, and its packed means (sum / max(count, 1)) or
// its six sums and count; s = six sums and the count
template <int MODE>
__device__ __forceinline__ void write_sums(const ReduceArgs& a, long long u, long long key,
                                           const long long* s) {
  a.code[u] = key;
  if (MODE == kSums) {
#pragma unroll
    for (int k = 0; k < 7; ++k) static_cast<long long*>(a.out[k])[u] = s[k];
  } else {
    const long long cnt = s[6] > 1 ? s[6] : 1;
    static_cast<int*>(a.out[0])[u] = pack_means(s, cnt);
    static_cast<int*>(a.out[1])[u] = pack_means(s + 3, cnt);
  }
}

// A tile's outputs staged in shared memory (over its keys and perm, once
// those are read), a unique voxel at its rank r in the tile: its code, then
// its packed means (means, merge) or its packed sums (sums)
template <int MODE>
struct Stage {
  static constexpr int kWords =
      MODE == kSums ? 3 * kUniqueTile + kUniqueTile / 2 : 2 * kUniqueTile;
  long long* w;

  __device__ __forceinline__ int* color() const {
    return reinterpret_cast<int*>(w + kUniqueTile);
  }
  __device__ __forceinline__ unsigned long long* c() const {
    return reinterpret_cast<unsigned long long*>(w + kUniqueTile);
  }
  __device__ __forceinline__ unsigned* n() const {
    return reinterpret_cast<unsigned*>(w + 3 * kUniqueTile);
  }

  template <typename Acc>
  __device__ __forceinline__ void put(int r, long long key, const Acc& x) const {
    w[r] = key;
    if constexpr (MODE == kSums) {
      c()[r] = x.c;
      c()[kUniqueTile + r] = x.e;
      n()[r] = x.n;
    } else {
      long long s[7] = {0, 0, 0, 0, 0, 0, 0};
      widen(x, s);
      const long long cnt = s[6] > 1 ? s[6] : 1;
      color()[r] = pack_means(s, cnt);
      color()[kUniqueTile + r] = pack_means(s + 3, cnt);
    }
  }

  // staged unique r to unique u of the outputs
  __device__ __forceinline__ void write(const ReduceArgs& a, int r, long long u) const {
    a.code[u] = w[r];
    if constexpr (MODE == kSums) {
      long long s[7] = {0, 0, 0, 0, 0, 0, 0};
      widen(Packed{c()[r], c()[kUniqueTile + r], n()[r]}, s);
#pragma unroll
      for (int k = 0; k < 7; ++k) static_cast<long long*>(a.out[k])[u] = s[k];
    } else {
      static_cast<int*>(a.out[0])[u] = color()[r];
      static_cast<int*>(a.out[1])[u] = color()[kUniqueTile + r];
    }
  }
};

// The run heads of each tile of kUniqueTile sorted entries
__global__ void __launch_bounds__(kThreads) vox_run_heads_kernel(const long long* s_key,
                                                                 long long n,
                                                                 long long* heads) {
  __shared__ int warp_heads[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kUniqueTile;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kUniqueItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const long long key = s_key[i];
      const long long prev = i > 0 ? s_key[i - 1] : kInvalidKey;
      c += key != kInvalidKey && key != prev;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
  if ((threadIdx.x & 31) == 0) warp_heads[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_heads[w];
    heads[blockIdx.x] = total;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) vox_unique_reduce_kernel(ReduceArgs a) {
  using Entry = typename std::conditional<MODE == kMerge, Wide, Colors>::type;
  using Acc = typename std::conditional<MODE == kMerge, Wide, Packed>::type;
  constexpr int I = kUniqueItems;
  constexpr int T = kUniqueTile;
  constexpr int kIn = 2 * (T + T / I);
  __shared__ long long words[kIn > Stage<MODE>::kWords ? kIn : Stage<MODE>::kWords];
  long long* keys = words;
  long long* perms = words + (T + T / I);
  const Stage<MODE> stage{words};
  __shared__ int warp_heads[kWarps];
  __shared__ Acc warp_sum[kWarps];
  __shared__ long long tail_key, tail_u;
  __shared__ Acc tail_sum;
  __shared__ int tail_open;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  // the tile's keys and perm, coalesced (past n: an invalid key)
#pragma unroll
  for (int k = 0; k < I; ++k) {
    const int j = k * kThreads + t;
    const long long i = base + j;
    keys[pad(j)] = i < a.n ? a.s_key[i] : kInvalidKey;
    perms[pad(j)] = i < a.n ? a.perm[i] : 0;
  }
  if (t == 0) tail_open = 0;
  __syncthreads();

  // this thread's I consecutive entries: keys, heads (a valid key that
  // differs from the one before it), attribute words
  long long key[I];
  Entry v[I];
  unsigned heads = 0u;
  long long prev = t > 0 ? keys[pad(t * I - 1)] : (base > 0 ? a.s_key[base - 1] : kInvalidKey);
#pragma unroll
  for (int m = 0; m < I; ++m) {
    const int j = t * I + m;
    key[m] = keys[pad(j)];
    if (key[m] != kInvalidKey) {
      gather(a, perms[pad(j)], v[m]);
      if (key[m] != prev) heads |= 1u << m;
    }
    prev = key[m];
  }
  const long long next = t < kThreads - 1 ? keys[pad(t * I + I)]
                                          : (base + T < a.n ? a.s_key[base + T] : kInvalidKey);

  // (heads, the sum since the last head) of this thread's entries, then
  // the block's exclusive segmented scan of them
  int h = __popc(heads);
  Acc x;
  zero(x);
#pragma unroll
  for (int m = 0; m < I; ++m) {
    if (heads >> m & 1u) zero(x);
    if (key[m] != kInvalidKey) add(x, sum_of(v[m]));
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int h0 = __shfl_up_sync(kFull, h, d);
    const Acc x0 = shfl_up(x, d);
    if (lane >= d) combine(h0, x0, h, x);
  }
  if (lane == 31) {
    warp_heads[warp] = h;
    warp_sum[warp] = x;
  }
  int h_lane = __shfl_up_sync(kFull, h, 1);
  Acc x_lane = shfl_up(x, 1);
  if (lane == 0) {
    h_lane = 0;
    zero(x_lane);
  }
  __syncthreads();
  int h_ex = 0;
  Acc carry;
  zero(carry);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      int hw = warp_heads[w];
      Acc xw = warp_sum[w];
      combine(h_ex, carry, hw, xw);
      h_ex = hw;
      carry = xw;
    }
  }
  combine(h_ex, carry, h_lane, x_lane);
  h_ex = h_lane;
  carry = x_lane;

  // each run this thread ends and the tile owns (its head in the tile),
  // staged at the head's rank r in the tile (the keys and perm are read:
  // the barrier above)
  const long long first = blockIdx.x > 0 ? a.ends[blockIdx.x - 1] : 0;
  bool owned = h_ex > 0;
  int r = h_ex - 1;
#pragma unroll
  for (int m = 0; m < I; ++m) {
    if (heads >> m & 1u) {
      owned = true;
      zero(carry);
      ++r;
    }
    if (key[m] == kInvalidKey) continue;
    add(carry, sum_of(v[m]));
    const long long after = m + 1 < I ? key[m + 1] : next;
    if (owned && after != key[m]) {
      stage.put(r, key[m], carry);
    } else if (owned && m == I - 1 && t == kThreads - 1) {  // goes on past the tile
      tail_open = 1;
      tail_key = key[m];
      tail_u = first + r;
      tail_sum = carry;
    }
  }
  __syncthreads();
  // the staged uniques, coalesced: all of the tile's but a run past it
  const int n_staged = static_cast<int>(a.ends[blockIdx.x] - first) - tail_open;
  for (int q = t; q < n_staged; q += kThreads) stage.write(a, q, first + q);
  if (!tail_open) return;

  // the tile's last run, past the tile: a chunk of kThreads entries a pass
  // (the run's entries are a prefix of each chunk) until a chunk ends it
  const long long run_key = tail_key;
  long long s[7] = {0, 0, 0, 0, 0, 0, 0};
  for (long long c0 = base + T;; c0 += kThreads) {
    const long long i = c0 + t;
    const bool in_run = i < a.n && a.s_key[i] == run_key;
    Acc y;
    zero(y);
    if (in_run) {
      Entry e;
      gather(a, a.perm[i], e);
      y = sum_of(e);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) add(y, shfl_xor(y, d));
    if (lane == 0) warp_sum[warp] = y;
    const int taken = __syncthreads_count(in_run);
    if (t == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) widen(warp_sum[w], s);
    }
    if (taken < kThreads) break;
    __syncthreads();  // thread 0 has read the warps' sums
  }
  if (t == 0) {
    widen(tail_sum, s);
    write_sums<MODE>(a, tail_u, run_key, s);
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

// Sorted entries a tile (voxelize.UNIQUE_TILE)
extern "C" int vox_unique_tile() { return kUniqueTile; }

// heads: int64 [ceil(n / kUniqueTile)], each tile's run heads
extern "C" int vox_run_heads_launch(const void* s_key, long long n, void* heads, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kUniqueTile - 1) / kUniqueTile);
  vox_run_heads_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(s_key), n, static_cast<long long*>(heads));
  return static_cast<int>(cudaGetLastError());
}

// ends: the inclusive cumsum of vox_run_heads_launch's heads; in / out: 7
// device pointers each (those a mode does not use are ignored), the outputs
// of ends' last value entries
extern "C" int vox_unique_reduce_launch(int mode, const void* s_key, const void* perm,
                                        const void* ends, long long n,
                                        const void* const* in, void* code,
                                        void* const* out, void* stream) {
  if (n <= 0) return 0;
  ReduceArgs a{};
  a.s_key = static_cast<const long long*>(s_key);
  a.perm = static_cast<const long long*>(perm);
  a.ends = static_cast<const long long*>(ends);
  a.n = n;
  int n_in = mode == kMerge ? 7 : 2, n_out = mode == kSums ? 7 : 2;
  for (int k = 0; k < n_in; ++k) a.in[k] = in[k];
  for (int k = 0; k < n_out; ++k) a.out[k] = out[k];
  a.code = static_cast<long long*>(code);
  const unsigned grid = static_cast<unsigned>((n + kUniqueTile - 1) / kUniqueTile);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMeans: vox_unique_reduce_kernel<kMeans><<<grid, kThreads, 0, st>>>(a); break;
    case kSums: vox_unique_reduce_kernel<kSums><<<grid, kThreads, 0, st>>>(a); break;
    default: vox_unique_reduce_kernel<kMerge><<<grid, kThreads, 0, st>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
