// The brick-tree and octree / DAG walks on Hopper: one thread a ray,
// walking to completion, one kernel a structure of models/accel.py.
//
// Replaces XLA-fused work of the reference (no pallas_call): on the TPU
// each walk is one lax.while_loop over every lane inside one jitted
// program. Run as eager tensor code (traverse.run_walk) an iteration is
// ~60 tensor ops over the live lanes, with a host sync and a compaction
// every 4 iterations: 0.5-0.7 s a 1080p frame.
//
//   brick_walk_kernel          replaces massivevoxelraytracing_tpu/ops/
//       bricktree.py:240-437 (its while_loop body and the walk's set-up),
//       the port's ops/bricktree.py _brick_body + traverse.walk_state +
//       traverse.run_walk. A node's 16-byte meta row [mask_lo, mask_hi,
//       base, 0] is one vector load. A ray crosses at most 10 of a node's
//       64 cells, so a visit first builds the mask of the cells it can
//       accept (crossed_cells: the 15 cell planes once, then pairwise
//       plane comparisons, exact) and ANDs it with the node's occupancy;
//       the selection then runs over those bits only (a bit b is the
//       walk's cell c = b ^ mirror), keeping its own test, the
//       lexicographic minimum (entry, c) over the Morton cell index c and
//       the strict rule (a valid entry of MAX_FLOAT is never taken). A
//       visit that returns to a node (a pop, or a leaf cell behind the
//       origin) takes the candidates its earlier visit left, carried on
//       the stack or in registers, instead of rebuilding the mask. Each
//       iteration is still one visit with one decision, as in the plain
//       walk, so max_iters cuts the same lanes. `shadow` changes nothing in
//       this walk (the rank comes from popcounts), so one body serves both.
//   octree_walk_kernel<SHADOW> replaces ops/traverse2.py:54-273 (the v2
//       walk over children ++ psum), the port's ops/traverse2.py _v2_body.
//       It reads only the two words of the node's 64-byte row it uses
//       (children[c], psum[c]). A ray crosses at most 4 of a node's 8
//       octants, in an order its planes give: a visit's candidates are
//       the occupied ones in that order (crossed_octants: the interval the
//       ray spends in the node cut at the midplanes inside it, exact), so
//       taking the body's (en, c) minimum is taking the first. Before it
//       descends the walk builds the child's list from the child word it
//       read (the occupancy rides in bits 24-31); an empty one is a child
//       the plain walk would enter only to pop, and the walk takes the
//       parent's next candidate instead. A return visit (a pop, or a leaf
//       behind the origin) takes what its earlier visit left, carried on
//       the stack or in registers. A loop trip thus ends in a real descend,
//       a hit, a leaf behind the origin, a rejected child or the walk's
//       end, and counts the plain iterations it stands for, so max_iters
//       cuts the same lanes (traverse2.fold_counts counts both). The psum
//       prefix is accumulated only on a real descend, and not for shadow
//       rays. DAG on or off is the same walk.
//
// The per-lane stack is a per-thread array of depth D <= 16 (local
// memory, L1-cached): a push at sp >= D writes nothing and a pop there
// reads 0, as traverse.stack_push / stack_read do. A v2 entry is 6 words
// (t1 and the node in one vector, the candidates left with the depth, the
// prefix sum; 5 for shadow rays): scale is 2^-depth.
//
// What bounds them on an H100: neither bytes nor operations, but the
// divergence of a walk whose length depends on the ray. The least time
// counted from the code (scripts/common.walk_bound) is the bytes the rays,
// the outputs and the rows they reach must move; a ray's iterations are a
// dependent chain of row loads and ~60-400 instructions, so the design
// keeps each lane on its own ray to the end (no host syncs, no
// compaction) and each iteration's state in registers.
//
// Exactness: every output equals the plain walk's bit for bit. Built with
// -fmad=false (no contraction) and IEEE division. Where a port of these
// walks drifts most easily, this one follows the plain code exactly:
//   - the preamble (traverse.walk_state): inv = 1 / rd is a true division
//     (±inf for ±0; -0.0 sets the mirror bit), bound = f32(0.25 MAX_FLOAT)
//     / max(max(|lo - ro_m|, |up - ro_m|), 1), inv_a = min(|inv|, bound);
//     0.25 MAX_FLOAT, MAX_FLOAT and the resume key's NEG_INF come in as
//     the float32 values the plain walk uses;
//   - the cell planes: the brick walk's t1 - dt * (scale - (scale * 0.25)
//     * k), the v2 walk's t1 - dt * (0.5 * scale) and t1 - dt * scale, in
//     that order, with no FMA (recomputed where used: the same operations
//     on the same values give the same bits); scale is a power of 4 (of 2)
//     fixed by the depth, so a stack entry keeps the depth alone;
//   - max / min propagate NaN as torch.maximum / torch.minimum do
//     (fmaxf / fminf would drop it), and so does the clamp;
//   - the stack bounds above;
//   - unsigned 32-bit arithmetic: the rank base + popcount_below and the
//     psum sums wrap at 32 bits, and the outputs are their int32 bit
//     patterns;
//   - max_iters: a lane still walking after max_iters iterations keeps
//     its miss (t = MAX_FLOAT, nmajor = -1, vidx = 0), as run_walk counts
//     them (the v2 walk counts the plain iterations its trips stand for);
//     a ray that never enters (enter_ok false, parked padding) is a miss
//     and takes no iteration.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxBlocks = 1ll << 20;
constexpr int kMaxDepth = 16;  // the wrappers refuse a deeper stack
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float tmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
#else
  return a != a ? a : (b != b ? b : (a > b ? a : b));
#endif
}

__device__ __forceinline__ float tmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
#else
  return a != a ? a : (b != b ? b : (a < b ? a : b));
#endif
}

// torch.clamp(x, min=1.0): NaN stays NaN
__device__ __forceinline__ float clamp_min1(float x) {
  return x != x ? x : (x < 1.0f ? 1.0f : x);
}

struct Consts {
  float quarter_max;  // f32(0.25 * MAX_FLOAT)
  float max_float;    // f32(MAX_FLOAT): the miss t and the selection's "none"
  float neg_inf;      // f32(NEG_INF): the resume key after a descend
};

struct WalkArgs {
  const void* meta;     // brick: int32 [N, 4]; octree: int32 [N, 16]
  long long last;       // N - 1
  const float* bounds;  // lower [3], upper [3]
  const float* ro;
  const float* rd;
  long long n;
  uint32_t root;        // brick: the root's index; octree: index | mask << 24
  int depth;            // brick: its levels; octree: the stack depth
  long long max_iters;
  Consts k;
  float* t;
  int* nmaj;
  int* vidx;
};

// traverse.walk_state for one ray: dt, t1, the mirror mask, enter_ok.
struct Ray {
  float dt[3], t1[3];
  uint32_t vm;
  bool enter;
};

__device__ __forceinline__ Ray preamble(const WalkArgs& a, long long i,
                                        const uint32_t mirror[3]) {
  Ray r;
  float t0[3];
  r.vm = 0;
  for (int ax = 0; ax < 3; ++ax) {
    const float ro = a.ro[3 * i + ax], rd = a.rd[3 * i + ax];
    const float lo = a.bounds[ax], up = a.bounds[3 + ax];
    const float inv = 1.0f / rd;
    const bool neg = inv < 0.0f;
    const float ro_m = neg ? (lo + up) - ro : ro;
    const float bound =
        a.k.quarter_max / clamp_min1(tmax(fabsf(lo - ro_m), fabsf(up - ro_m)));
    const float inv_a = tmin(fabsf(inv), bound);
    t0[ax] = (lo - ro_m) * inv_a;
    r.t1[ax] = (up - ro_m) * inv_a;
    r.dt[ax] = r.t1[ax] - t0[ax];
    if (neg) r.vm |= mirror[ax];
  }
  r.enter = tmin(r.t1[0], tmin(r.t1[1], r.t1[2])) >= tmax(t0[0], tmax(t0[1], t0[2]));
  return r;
}

__device__ __forceinline__ void cell_coords(int c, int& cx, int& cy, int& cz) {
  cx = (c & 1) | (((c >> 3) & 1) << 1);
  cy = ((c >> 1) & 1) | (((c >> 4) & 1) << 1);
  cz = ((c >> 2) & 1) | (((c >> 5) & 1) << 1);
}

// the brick walk's cell plane k in [0, 4]: t1 - dt * (scale - qs * k)
__device__ __forceinline__ float plane4(float t1, float dt, float scale, float qs, int k) {
  return t1 - dt * (scale - qs * static_cast<float>(k));
}

// the node's own cell (x, y, z) in [0, 4)^3 as its bit b (the Morton cell
// index, bricktree._POS_CELL)
__host__ __device__ constexpr int cell_bit(int x, int y, int z) {
  return (x & 1) | ((y & 1) << 1) | ((z & 1) << 2) | ((x >> 1) << 3) | ((y >> 1) << 4) |
         ((z >> 1) << 5);
}

// The crossed-cell mask's words. A 64-bit cell mask is two words, lo
// (cells with z < 2) and hi (z >= 2). kXY: the cells (i, j, any z) in one
// word (the same in both); kXZ / kYZ: the cells (i, any y, k) / (any x,
// j, k) in word k >> 1.
__host__ __device__ constexpr uint32_t kXY(int i, int j) {
  return (1u << cell_bit(i, j, 0)) | (1u << cell_bit(i, j, 1));
}
__host__ __device__ constexpr uint32_t kXZ(int i, int k) {
  uint32_t w = 0;
  for (int y = 0; y < 4; ++y) w |= 1u << (cell_bit(i, y, k) & 31);
  return w;
}
__host__ __device__ constexpr uint32_t kYZ(int j, int k) {
  uint32_t w = 0;
  for (int x = 0; x < 4; ++x) w |= 1u << (cell_bit(x, j, k) & 31);
  return w;
}

// One axis of a visit in the node's own cell order: cell r is entered at
// en[r] and left at ex[r], the planes of walk coordinate r, or 3 - r where
// the axis is mirrored (the 5 planes computed once, as plane4 does); ex[r]
// is NaN where the cell's own interval is empty or behind the origin.
__device__ __forceinline__ void axis_cells(float t1, float dt, const float step[5], bool mir,
                                           float en[4], float ex[4]) {
  float p[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) p[k] = t1 - dt * step[k];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    en[r] = mir ? p[3 - r] : p[r];
    const float x = mir ? p[4 - r] : p[r + 1];
    ex[r] = (en[r] < x) & (x > 0.0f) ? x : __int_as_float(0x7fc00000);
  }
}

// The cells of this visit the selection can accept, as a mask over the
// node's own bits: cell (x, y, z) passes iff en < ex and ex > 0, that is
// iff each of its axes' intervals is non-empty and in front (axis_cells)
// and each pair of them overlaps (en_a < ex_b and en_b < ex_a). That is
// the nine comparisons en_a < ex_b that max(en) < min(ex) means, and a NaN
// plane fails one of them as it makes en or ex NaN; a comparison does not
// round. So the mask is the set the selection accepts before its resume
// key, exactly (bricktree.crossed_cells_plain is this construction as
// tensor code). 96 comparisons, each pair's predicated into its word.
__device__ __forceinline__ uint64_t crossed_cells(float t1x, float t1y, float t1z, float dtx,
                                                  float dty, float dtz, float scale,
                                                  float qs, uint32_t vm) {
  float step[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) step[k] = scale - qs * static_cast<float>(k);
  float ex_[4], ey_[4], ez_[4], xx[4], xy[4], xz[4];
  axis_cells(t1x, dtx, step, vm & 1u, ex_, xx);
  axis_cells(t1y, dty, step, vm & 2u, ey_, xy);
  axis_cells(t1z, dtz, step, vm & 4u, ez_, xz);
  uint32_t w_xy = 0, w_xz[2] = {0, 0}, w_yz[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((ex_[i] < xy[j]) & (ey_[j] < xx[i])) w_xy |= kXY(i, j);
      if ((ex_[i] < xz[j]) & (ez_[j] < xx[i])) w_xz[j >> 1] |= kXZ(i, j);
      if ((ey_[i] < xz[j]) & (ez_[j] < xy[i])) w_yz[j >> 1] |= kYZ(i, j);
    }
  }
  return static_cast<uint64_t>(w_xy & w_xz[0] & w_yz[0]) |
         (static_cast<uint64_t>(w_xy & w_xz[1] & w_yz[1]) << 32);
}

__global__ void __launch_bounds__(kThreads) brick_walk_kernel(WalkArgs a) {
  const uint32_t mirror[3] = {0b001001u, 0b010010u, 0b100100u};  // bricktree._MIRROR64
  const int4* meta = static_cast<const int4*>(a.meta);
  const int D = a.depth;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Ray r = preamble(a, i, mirror);
    float t_out = a.k.max_float;
    int nmajor = -1;
    uint32_t vidx = 0;
    bool active = r.enter;
    uint32_t node = a.root;
    int depth = a.depth - 1;
    float t1x = r.t1[0], t1y = r.t1[1], t1z = r.t1[2];
    const float dtx = r.dt[0], dty = r.dt[1], dtz = r.dt[2];
    float scale = 1.0f, rk_t = a.k.neg_inf;
    int rk_c = -1, sp = 0;
    // the candidates of the coming visit when it stands where an earlier
    // one stood (a pop, or a leaf cell behind the origin): that visit's
    // valid cells less the one it took, which are exactly the cells after
    // its (best_t, best_c) among its crossed and occupied ones
    bool have = false;
    uint64_t carried = 0;
    // a stack entry: node, t1, the resume key, depth (scale = 4^-(levels -
    // 1 - depth)) and the carried candidates
    uint32_t s_node[kMaxDepth], s_key[kMaxDepth];
    float s_t1x[kMaxDepth], s_t1y[kMaxDepth], s_t1z[kMaxDepth], s_rkt[kMaxDepth];
    uint64_t s_cand[kMaxDepth];
    for (long long it = 0; it < a.max_iters && active; ++it) {
      const long long row_i = static_cast<long long>(node) < a.last
                                  ? static_cast<long long>(node) : a.last;
      const int4 row = meta[row_i];
      const uint64_t mask = static_cast<uint64_t>(static_cast<uint32_t>(row.x)) |
                            (static_cast<uint64_t>(static_cast<uint32_t>(row.y)) << 32);
      const uint32_t base = static_cast<uint32_t>(row.z);
      const float qs = scale * 0.25f;
      const uint64_t cand =
          have ? carried : crossed_cells(t1x, t1y, t1z, dtx, dty, dtz, scale, qs, r.vm) & mask;
      have = false;

      // the selection over the candidates: (en, c) lexicographic min
      float best_t = a.k.max_float;
      int best_c = 64, n_valid = 0;
      uint64_t valid = 0;
      for (uint64_t m = cand; m != 0; m &= m - 1) {
        const int b = __ffsll(static_cast<long long>(m)) - 1;
        const int c = b ^ static_cast<int>(r.vm);
        int cx, cy, cz;
        cell_coords(c, cx, cy, cz);
        const float en = tmax(plane4(t1x, dtx, scale, qs, cx),
                              tmax(plane4(t1y, dty, scale, qs, cy),
                                   plane4(t1z, dtz, scale, qs, cz)));
        const float ex = tmin(plane4(t1x, dtx, scale, qs, cx + 1),
                              tmin(plane4(t1y, dty, scale, qs, cy + 1),
                                   plane4(t1z, dtz, scale, qs, cz + 1)));
        const bool after = en > rk_t || (en == rk_t && c > rk_c);
        if (en < ex && ex > 0.0f && after) {
          ++n_valid;
          valid |= 1ull << b;
          if (en < best_t) {
            best_t = en;
            best_c = en < a.k.max_float ? c : 64;
          } else if (en == best_t && en < a.k.max_float && c < best_c) {
            best_c = c;
          }
        }
      }

      if (best_c < 64) {
        const int rb = (best_c ^ static_cast<int>(r.vm)) & 63;
        const uint32_t target =
            base + static_cast<uint32_t>(__popcll(mask & ((1ull << rb) - 1ull)));
        const uint64_t rest = valid & ~(1ull << rb);
        int cx, cy, cz;
        cell_coords(best_c, cx, cy, cz);
        if (depth == 0) {
          if (best_t > 0.0f) {  // a leaf hit: the in-order first wins
            t_out = best_t;
            const float en_xa = plane4(t1x, dtx, scale, qs, cx);
            const float en_ya = plane4(t1y, dty, scale, qs, cy);
            nmajor = best_t == en_xa ? 1 : (best_t == en_ya ? 2 : 0);
            vidx = target;
            active = false;
          } else {  // behind the origin: stay, resume past it
            rk_t = best_t;
            rk_c = best_c;
            carried = rest;
            have = true;
          }
        } else {  // descend, pushing this node if another cell is valid
          if (n_valid > 1) {
            if (sp < D) {
              s_node[sp] = node;
              s_key[sp] = static_cast<uint32_t>(best_c) | (static_cast<uint32_t>(depth) << 8);
              s_t1x[sp] = t1x;
              s_t1y[sp] = t1y;
              s_t1z[sp] = t1z;
              s_rkt[sp] = best_t;
              s_cand[sp] = rest;
            }
            ++sp;
          }
          const float nx = plane4(t1x, dtx, scale, qs, cx + 1);
          const float ny = plane4(t1y, dty, scale, qs, cy + 1);
          const float nz = plane4(t1z, dtz, scale, qs, cz + 1);
          node = target;
          depth -= 1;
          t1x = nx;
          t1y = ny;
          t1z = nz;
          scale = qs;
          rk_t = a.k.neg_inf;
          rk_c = -1;
        }
      } else if (sp == 0) {  // nothing left: a miss
        active = false;
      } else {  // pop; past the stack's depth every field reads 0
        --sp;
        const bool in = sp < D;
        const uint32_t key = in ? s_key[sp] : 0u;
        node = in ? s_node[sp] : 0u;
        depth = static_cast<int>(key >> 8);
        t1x = in ? s_t1x[sp] : 0.0f;
        t1y = in ? s_t1y[sp] : 0.0f;
        t1z = in ? s_t1z[sp] : 0.0f;
        scale = in ? __int_as_float((127 - 2 * (a.depth - 1 - depth)) << 23) : 0.0f;
        rk_t = in ? s_rkt[sp] : 0.0f;
        rk_c = static_cast<int>(key & 0xFFu);
        carried = in ? s_cand[sp] : 0ull;
        have = in;
      }
    }
    if (active) {  // cut by max_iters: a miss
      t_out = a.k.max_float;
      nmajor = -1;
      vidx = 0;
    }
    a.t[i] = t_out;
    a.nmaj[i] = nmajor;
    a.vidx[i] = static_cast<int>(vidx);
  }
}

// The octants of a v2 visit the body can accept (en < ex and ex > 0), as
// a list in the ray's order. The body's planes on each axis are t0 = t1 -
// dt * scale <= tm = t1 - dt * (0.5 * scale) <= t1 (dt >= 0; every plane of
// a ray that enters is finite, below 0.75 MAX_FLOAT in magnitude), so the
// ray is in the node on [lo, hi] = [max t0, min t1], and at a time t in
// between in the octant whose half on axis a is 1 iff t > tm_a. The
// midplanes inside (lo, hi), sorted, cut that interval into at most four
// pieces; an octant passes the body's test iff it is a piece's octant and
// the piece is non-empty with its right end > 0, and its en and ex are
// then the piece's ends exactly (max / min return an operand, a comparison
// does not round). So the accepted octants are those pieces' octants, in
// the order of their entries (no two share one), the order the body's
// (en, c) minimum takes them; and a first visit's resume key (NEG_INF, -1)
// takes every one (traverse2.crossed_octants_plain is this set, built from
// pairwise plane comparisons as tensor code). Returns the occupied ones:
// bits 3k..3k+2 the k-th piece's octant (the node's own bit: the walk's
// octant ^ vm) and bit kListed + k set iff it is a candidate; 0 if none is.
constexpr int kListed = 12;

__device__ __forceinline__ void sort2(float& fa, uint32_t& ba, float& fb, uint32_t& bb) {
  if (fb < fa) {
    const float f = fa;
    fa = fb;
    fb = f;
    const uint32_t b = ba;
    ba = bb;
    bb = b;
  }
}

__device__ __forceinline__ uint32_t crossed_octants(float t1x, float t1y, float t1z, float dtx,
                                                    float dty, float dtz, float scale,
                                                    uint32_t vm, uint32_t occ) {
  const float hs = 0.5f * scale;
  const float tmx = t1x - dtx * hs, tmy = t1y - dty * hs, tmz = t1z - dtz * hs;
  const float tx0 = t1x - dtx * scale, ty0 = t1y - dty * scale, tz0 = t1z - dtz * scale;
  const float lo = tmax(tx0, tmax(ty0, tz0)), hi = tmin(t1x, tmin(t1y, t1z));
  // the first piece's octant (walk order), and each axis's cut: its
  // midplane where inside (lo, hi), else hi (no cut)
  const uint32_t first = (tmx <= lo ? 1u : 0u) | (tmy <= lo ? 2u : 0u) | (tmz <= lo ? 4u : 0u);
  float fx = tmx > lo && tmx < hi ? tmx : hi;
  float fy = tmy > lo && tmy < hi ? tmy : hi;
  float fz = tmz > lo && tmz < hi ? tmz : hi;
  uint32_t bx = 1u, by = 2u, bz = 4u;
  sort2(fx, bx, fy, by);
  sort2(fy, by, fz, bz);
  sort2(fx, bx, fy, by);
  const uint32_t o0 = first ^ vm, o1 = o0 ^ bx, o2 = o1 ^ by, o3 = o2 ^ bz;
  const uint32_t listed = (((lo < fx) & (fx > 0.0f)) & (occ >> o0)) |
                          ((((fx < fy) & (fy > 0.0f)) & (occ >> o1)) << 1) |
                          ((((fy < fz) & (fz > 0.0f)) & (occ >> o2)) << 2) |
                          ((((fz < hi) & (hi > 0.0f)) & (occ >> o3)) << 3);
  return (listed & 0xFu) == 0 ? 0u
                              : (o0 | o1 << 3 | o2 << 6 | o3 << 9 | (listed & 0xFu) << kListed);
}

// the index of the lowest set bit of a non-zero word
__device__ __forceinline__ int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(m)) - 1;
#else
  return __builtin_ctz(m);
#endif
}

__device__ __forceinline__ int float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int b;
  std::memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// The v2 walk. Each visit's candidates are its accepted occupied octants
// in the ray's order (crossed_octants): built once, when the walk looks
// into a child before it descends, and carried; a return visit (a pop, or
// a leaf behind the origin) takes what its earlier visit left. A loop trip
// takes the first candidate, the body's (en, c) minimum, and ends in a
// descend into a child with candidates, a hit, a leaf behind the origin,
// or a child with none: there the plain walk descends, finds nothing and
// pops, and this walk takes the parent's next candidate on its next trip
// without descending. `it` counts the plain walk's iterations exactly (a
// rejected child is its descend and the child's empty visit), so
// max_iters cuts the same lanes; a rejected child's push and pop cancel
// only inside the stack, and past it the plain sequence is taken one
// iteration at a time.
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads) octree_walk_kernel(WalkArgs a) {
  const uint32_t mirror[3] = {1u, 2u, 4u};
  const uint32_t* meta = static_cast<const uint32_t*>(a.meta);
  const int D = a.depth;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Ray r = preamble(a, i, mirror);
    float t_out = a.k.max_float;
    int nmajor = -1;
    uint32_t vidx = 0;
    uint32_t node = a.root, skipped = 0;
    float t1x = r.t1[0], t1y = r.t1[1], t1z = r.t1[2];
    const float dtx = r.dt[0], dty = r.dt[1], dtz = r.dt[2];
    float scale = 1.0f;  // 2^-depth
    int depth = 0, sp = 0;
    // the candidates of the visit at plain iteration it; a ray that does
    // not enter has none and an empty stack: a miss, no iteration
    uint32_t cand =
        r.enter ? crossed_octants(t1x, t1y, t1z, dtx, dty, dtz, scale, r.vm, node >> 24) : 0u;
    // a stack entry: t1 and node in one vector, the candidates left with
    // the depth, and the prefix sum
    int4 s_node[kMaxDepth];
    uint32_t s_cand[kMaxDepth], s_skip[kMaxDepth];
    long long it = 0;
    for (;;) {
      if (cand == 0) {  // a visit that finds nothing: the walk ends, or a pop
        if (sp == 0 || it >= a.max_iters) break;
        --sp;
        ++it;
        if (sp >= D) continue;  // past the stack every field reads 0: no octant
        const int4 e = s_node[sp];
        t1x = __int_as_float(e.x);
        t1y = __int_as_float(e.y);
        t1z = __int_as_float(e.z);
        node = static_cast<uint32_t>(e.w);
        cand = s_cand[sp] & 0xFFFFu;
        depth = static_cast<int>(s_cand[sp] >> 16);
        scale = __int_as_float((127 - depth) << 23);
        if (!SHADOW) skipped = s_skip[sp];
      }
      if (it >= a.max_iters) break;  // cut: a miss

      // the candidate to take: the first listed, the (en, c) minimum
      const int k = lowest_bit(cand >> kListed);
      const int rb = static_cast<int>(cand >> (3 * k)) & 7;
      const int best_c = rb ^ static_cast<int>(r.vm);
      uint32_t rest = cand & ~(1u << (kListed + k));
      if ((rest >> kListed) == 0) rest = 0;
      const long long idx = static_cast<long long>(node & 0xFFFFFFu);
      const long long row = (idx < a.last ? idx : a.last) * 16;
      const uint32_t child = meta[row + rb];
      const bool bx = best_c & 1, by = best_c & 2, bz = best_c & 4;
      const float hs = 0.5f * scale;
      const float tmx = t1x - dtx * hs, tmy = t1y - dty * hs, tmz = t1z - dtz * hs;
      if (child == kInvalid) {
        const float en_xa = bx ? tmx : t1x - dtx * scale;
        const float en_ya = by ? tmy : t1y - dty * scale;
        const float best_t = tmax(en_xa, tmax(en_ya, bz ? tmz : t1z - dtz * scale));
        if (best_t > 0.0f) {  // a leaf hit: the in-order first wins
          t_out = best_t;
          nmajor = best_t == en_xa ? 1 : (best_t == en_ya ? 2 : 0);
          vidx = SHADOW ? skipped : skipped + meta[row + 8 + rb];
          break;
        }
        cand = rest;  // behind the origin: stay, take the next
        ++it;
        continue;
      }
      // look into the child as its own visit would
      const float cx = bx ? t1x : tmx, cy = by ? t1y : tmy, cz = bz ? t1z : tmz;
      const uint32_t child_cand =
          crossed_octants(cx, cy, cz, dtx, dty, dtz, hs, r.vm, child >> 24);
      if (child_cand == 0) {  // the plain walk descends, finds nothing, pops
        if (rest != 0 && sp < D) {  // its push and pop cancel: the parent's next
          cand = rest;
          it += 2;
          continue;
        }
        if (rest != 0) ++sp;  // a push past the stack: the pop reads zeros
        cand = 0;             // at the child's empty visit
        ++it;
        continue;
      }
      if (rest != 0) {  // descend, pushing this node if another octant is valid
        if (sp < D) {
          s_node[sp] = int4{float_bits(t1x), float_bits(t1y), float_bits(t1z),
                            static_cast<int>(node)};
          s_cand[sp] = rest | (static_cast<uint32_t>(depth) << 16);
          if (!SHADOW) s_skip[sp] = skipped;
        }
        ++sp;
      }
      if (!SHADOW) skipped += meta[row + 8 + rb];
      node = child;
      t1x = cx;
      t1y = cy;
      t1z = cz;
      scale = hs;
      ++depth;
      cand = child_cand;
      ++it;
    }
    a.t[i] = t_out;
    a.nmaj[i] = nmajor;
    a.vidx[i] = static_cast<int>(vidx);
  }
}

int launch(void (*kernel)(WalkArgs), const WalkArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  long long b = (a.n + kThreads - 1) / kThreads;
  kernel<<<static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

WalkArgs walk_args(const void* meta, long long n_nodes, const void* bounds, const void* ro,
                   const void* rd, long long n, unsigned root, int depth,
                   long long max_iters, float quarter_max, float max_float,
                   float neg_inf, void* t, void* nmaj, void* vidx) {
  return WalkArgs{meta, n_nodes - 1, static_cast<const float*>(bounds),
                  static_cast<const float*>(ro), static_cast<const float*>(rd), n,
                  static_cast<uint32_t>(root), depth, max_iters,
                  Consts{quarter_max, max_float, neg_inf}, static_cast<float*>(t),
                  static_cast<int*>(nmaj), static_cast<int*>(vidx)};
}

}  // namespace

// meta: int32 [n_nodes, 4] (16-byte aligned); bounds: f32 lower ++ upper;
// ro, rd: f32 [n, 3]; n_levels <= 16; outputs t f32, nmaj / vidx int32 [n].
extern "C" int brick_walk_launch(const void* meta, long long n_nodes, const void* bounds,
                                 const void* ro, const void* rd, long long n, unsigned root,
                                 int n_levels, long long max_iters, float quarter_max,
                                 float max_float, float neg_inf, void* t, void* nmaj,
                                 void* vidx, void* stream) {
  if (n_levels < 1 || n_levels > kMaxDepth || n_nodes < 1) return cudaErrorInvalidValue;
  return launch(brick_walk_kernel,
                walk_args(meta, n_nodes, bounds, ro, rd, n, root, n_levels, max_iters,
                          quarter_max, max_float, neg_inf, t, nmaj, vidx),
                stream);
}

// meta: int32 [n_nodes, 16] (children ++ psum); root: index | mask << 24;
// stack_depth <= 16; the rest as brick_walk_launch.
extern "C" int octree_walk_launch(int shadow, const void* meta, long long n_nodes,
                                  const void* bounds, const void* ro, const void* rd,
                                  long long n, unsigned root, int stack_depth,
                                  long long max_iters, float quarter_max, float max_float,
                                  float neg_inf, void* t, void* nmaj, void* vidx,
                                  void* stream) {
  if (stack_depth < 1 || stack_depth > kMaxDepth || n_nodes < 1) return cudaErrorInvalidValue;
  const WalkArgs a = walk_args(meta, n_nodes, bounds, ro, rd, n, root, stack_depth,
                               max_iters, quarter_max, max_float, neg_inf, t, nmaj, vidx);
  return shadow ? launch(octree_walk_kernel<true>, a, stream)
                : launch(octree_walk_kernel<false>, a, stream);
}
