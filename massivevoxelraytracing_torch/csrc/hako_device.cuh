// Per-thread device functions of the HakoTree traversal.
//
// Line-for-line ports of the reference's shared Pallas device functions
// (massivevoxelraytracing_tpu/ops/hako_kernels.py: _plane, _coords,
// _cell_of, _bit_at, _pc64_below, _walk64_impl, _probe_from_root,
// _dda_rows) for one ray per thread. The plain PyTorch versions of the same
// functions are massivevoxelraytracing_torch/ops/hako_kernels.py.
//
// Exactness: every cell plane is t1 - dc * (4 - k) (plane()), and exact
// float equality between planes decides the face axis, walk ties and
// resume keys. Build with -fmad=false and IEEE division (no fast math):
// a contracted FMA would drift those comparisons by an ulp. min/max
// propagate NaN like jnp.minimum/maximum and torch.minimum/maximum.
//
// Counters: Probe and Dda also return how many descents, sub-brick visits,
// walk64 calls, row / table words and row loads a call took. Callers that
// do not read them (every kernel but the megakernel's counting variant) let
// the compiler drop them.
#pragma once

#include <cfloat>
#include <cstdint>

namespace hako {

constexpr int kRowWords = 164;
constexpr float kMaxFloat = FLT_MAX;

// NaN-propagating max / min in one instruction each (sm_80+): equal to
// fmaxf / fminf unless an operand is NaN, and then NaN.
__device__ __forceinline__ float jmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float jmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min3(float a, float b, float c) {
  return jmin(a, jmin(b, c));
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  return jmax(a, jmax(b, c));
}

// Cell-boundary plane tb[k] = t1 - dc * (4 - k), k in [0, 4].
__device__ __forceinline__ float plane(float t1, float dc, int k) {
  return t1 - dc * static_cast<float>(4 - k);
}

__device__ __forceinline__ void coords(int c, int& cx, int& cy, int& cz) {
  cx = (c & 1) | (((c >> 3) & 1) << 1);
  cy = ((c >> 1) & 1) | (((c >> 4) & 1) << 1);
  cz = ((c >> 2) & 1) | (((c >> 5) & 1) << 1);
}

__device__ __forceinline__ int cell_of(int cx, int cy, int cz) {
  return (cx & 1) | ((cy & 1) << 1) | ((cz & 1) << 2) | ((cx >> 1) << 3) |
         ((cy >> 1) << 4) | ((cz >> 1) << 5);
}

// cell in [0, 64)
__device__ __forceinline__ bool bit_at(uint32_t lo, uint32_t hi, int cell) {
  const uint32_t w = cell < 32 ? (lo >> cell) : (hi >> (cell - 32));
  return (w & 1u) != 0u;
}

// Rank of a child: popcount of the mask bits below cell, cell in [0, 64).
__device__ __forceinline__ uint32_t pc64_below(uint32_t lo, uint32_t hi,
                                               int cell) {
  if (cell >= 32) {
    return __popc(lo) + __popc(hi & ((1u << (cell - 32)) - 1u));
  }
  return __popc(lo & ((1u << cell) - 1u));
}

// pc64_below for any cell in [0, 128), as the reference's _pc64_below
// clips its shifts: a cell of 64 or more (a walk that found nothing,
// mirrored) counts every bit of lo and the bits of hi below bit 31, which
// is cell 63's count. The traversal never asks for such a cell; the
// probes of the walk's stages do, and give the reference's value.
__device__ __forceinline__ uint32_t pc64_below_clipped(uint32_t lo,
                                                       uint32_t hi, int cell) {
  return pc64_below(lo, hi, cell < 63 ? cell : 63);
}

// A warp's passes through a loop and the active lanes summed over them
// (their ratio over 32 is the loop's SIMT efficiency): the lowest active
// lane of each pass counts it. Callers pass nullptr to count nothing.
struct WarpPass {
  unsigned long long popc, passes;
};

__device__ __forceinline__ void count_pass(WarpPass* wp) {
  if (wp == nullptr) return;
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(m) - 1)) {
    wp->popc += __popc(m);
    ++wp->passes;
  }
}

struct Ray {
  float t0[3], t1[3], dt[3];
  int vm6;
  bool enter_ok;
};

// Mirrored parametrization of one ray (the reference's _ray_preamble):
// per-axis entry / exit planes of the root box and their span, the XOR
// mirror mask vm6, and whether the ray enters the box at all. bounds:
// lower[3], upper[3]; o / d: the ray's origin and direction.
__device__ __forceinline__ Ray ray_preamble(const float* bounds,
                                            const float o3[3],
                                            const float d3[3]) {
  Ray r;
  r.vm6 = 0;
  const int pat[3] = {0b001001, 0b010010, 0b100100};
  for (int a = 0; a < 3; ++a) {
    const float lo = bounds[a];
    const float up = bounds[3 + a];
    const float o = o3[a];
    const float inv = 1.0f / d3[a];
    const bool neg = inv < 0.0f;
    const float rom = neg ? (lo + up) - o : o;
    const float bound =
        (0.25f * kMaxFloat) / jmax(jmax(fabsf(lo - rom), fabsf(up - rom)), 1.0f);
    const float inva = jmin(fabsf(inv), bound);
    r.t0[a] = (lo - rom) * inva;
    r.t1[a] = (up - rom) * inva;
    r.dt[a] = r.t1[a] - r.t0[a];
    if (neg) r.vm6 |= pat[a];
  }
  r.enter_ok = min3(r.t1[0], r.t1[1], r.t1[2]) >= max3(r.t0[0], r.t0[1], r.t0[2]);
  return r;
}

// Ray i of ro / rd [n, 3].
__device__ __forceinline__ Ray ray_preamble(const float* bounds,
                                            const float* ro, const float* rd,
                                            int i) {
  const float o[3] = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  const float d[3] = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  return ray_preamble(bounds, o, d);
}

struct Walk {
  float en, ex;
  int c;  // 64 = none
};

// First occupied cell (in order) of a 4^3 node along the mirrored ray whose
// exit lies strictly past max(t_q, 0): a 10-slot monotone lattice walk
// (a ray crosses at most 10 cells of a 4^3 node; x wins ties, then y).
__device__ __forceinline__ Walk walk64(uint32_t lo, uint32_t hi, int vm6,
                                       const float t1[3], const float dc[3],
                                       float t_q) {
  const Walk none{kMaxFloat, kMaxFloat, 64};
  const float tq0 = jmax(t_q, 0.0f);
  const float node_en = max3(plane(t1[0], dc[0], 0), plane(t1[1], dc[1], 0),
                             plane(t1[2], dc[2], 0));
  const float node_ex = min3(t1[0], t1[1], t1[2]);
  const float t_start = jmax(node_en, tq0);
  if (!(t_start < node_ex)) return none;
  int cx = (plane(t1[0], dc[0], 1) <= t_start) +
           (plane(t1[0], dc[0], 2) <= t_start) +
           (plane(t1[0], dc[0], 3) <= t_start);
  int cy = (plane(t1[1], dc[1], 1) <= t_start) +
           (plane(t1[1], dc[1], 2) <= t_start) +
           (plane(t1[1], dc[1], 3) <= t_start);
  int cz = (plane(t1[2], dc[2], 1) <= t_start) +
           (plane(t1[2], dc[2], 2) <= t_start) +
           (plane(t1[2], dc[2], 3) <= t_start);
  // true entry of the start cell (can precede a resume key)
  float en = max3(plane(t1[0], dc[0], cx), plane(t1[1], dc[1], cy),
                  plane(t1[2], dc[2], cz));
  float nx = plane(t1[0], dc[0], min(cx + 1, 4));
  float ny = plane(t1[1], dc[1], min(cy + 1, 4));
  float nz = plane(t1[2], dc[2], min(cz + 1, 4));
  for (int slot = 0; slot < 10; ++slot) {
    const float ex = min3(nx, ny, nz);
    const int cell = cell_of(cx, cy, cz);
    if (bit_at(lo, hi, cell ^ vm6) && en < ex && ex > tq0) {
      return Walk{en, ex, cell};
    }
    if (slot == 9) break;
    // step the axis whose plane is crossed first (ties: x, then y)
    en = ex;
    if (nx <= ny && nx <= nz) {
      if (++cx >= 4) break;
      nx = plane(t1[0], dc[0], min(cx + 1, 4));
    } else if (ny <= nz) {
      if (++cy >= 4) break;
      ny = plane(t1[1], dc[1], min(cy + 1, 4));
    } else {
      if (++cz >= 4) break;
      nz = plane(t1[2], dc[2], min(cz + 1, 4));
    }
  }
  return none;
}

struct Probe {
  bool emit, exh;
  int child;
  float bt1[3];
  float tqe, tqn;
  int descents, walks, words;  // root descents, walk64 calls, table words
};

// Up to max_probes restart descents from the root through the top tree,
// emitting the ray's next fat row (child id, its exit planes bt1, the
// resume key tqe) or exhaustion. levels: root-down tables of
// (mask_lo, mask_hi, base) words, level d starting at node level_off[d].
__device__ __forceinline__ Probe probe_from_root(
    const uint32_t* levels, const int* level_off, int T, uint32_t root_lo,
    uint32_t root_hi, const float t1[3], const float dt[3], int vm6,
    float t_q, int max_probes, WarpPass* wp = nullptr) {
  Probe r{false, false, 0, {0.0f, 0.0f, 0.0f}, t_q, t_q, 0, 0, 0};
  for (int p = 0; p < max_probes; ++p) {
    ++r.descents;
    uint32_t mlo = root_lo, mhi = root_hi, base = 0;
    float cur[3] = {t1[0], t1[1], t1[2]};
    float dc[3] = {dt[0] * 0.25f, dt[1] * 0.25f, dt[2] * 0.25f};
    float tq_new = t_q;
    for (int depth = 0; depth < T; ++depth) {
      count_pass(wp);
      const Walk w = walk64(mlo, mhi, vm6, cur, dc, t_q);
      ++r.walks;
      if (w.c >= 64) {  // dead subtree: resume past this node's exit
        tq_new = min3(cur[0], cur[1], cur[2]);
        if (depth == 0) r.exh = true;
        break;
      }
      int cx, cy, cz;
      coords(w.c, cx, cy, cz);
      const float nt1[3] = {plane(cur[0], dc[0], min(cx + 1, 4)),
                            plane(cur[1], dc[1], min(cy + 1, 4)),
                            plane(cur[2], dc[2], min(cz + 1, 4))};
      const uint32_t child = base + pc64_below(mlo, mhi, w.c ^ vm6);
      if (depth == T - 1) {
        r.emit = true;
        r.child = static_cast<int>(child);
        r.bt1[0] = nt1[0];
        r.bt1[1] = nt1[1];
        r.bt1[2] = nt1[2];
        r.tqe = t_q;
        tq_new = min3(nt1[0], nt1[1], nt1[2]);
      } else {
        const uint32_t* node = levels + 3 * (level_off[depth] + child);
        mlo = node[0];
        mhi = node[1];
        base = node[2];
        r.words += 3;
        for (int a = 0; a < 3; ++a) {
          cur[a] = nt1[a];
          dc[a] = dc[a] * 0.25f;
        }
      }
    }
    t_q = tq_new;
    if (r.emit || r.exh) break;
  }
  r.tqn = t_q;
  return r;
}

struct Dda {
  bool hit, more;
  float t_hit;
  int nmaj;
  uint32_t vr;
  float p3, tqp, tqr;
  int iters, walks, words, loads;  // sub-brick visits, walk64 calls, row
                                   // words read, row load instructions
};

// Hierarchical DDA inside one 16^3 row: the coarse 4^3 sub-bricks (words
// 128-129), then the fine 4^3 cells (words 2s, 2s+1). A leaf row reports
// the first voxel strictly ahead of the origin (t, face axis, rank =
// base + sub-brick prefix + popcount); a supernode row (LEAF = false)
// emits the first child brick past the resume key with its exit planes
// (the y plane bit-cast into nmaj). Stops after max_iters sub-bricks with
// a resume key. Row: how the row's words are read, row[k] (a pointer into
// global memory by default; hako_dda_cached passes a shared-memory row).
template <bool LEAF, bool SHADOW, class Row = const uint32_t*>
__device__ __forceinline__ Dda dda_rows(Row row,
                                        const float dt[3], float dt_factor,
                                        int vm6, const float bt1[3],
                                        float tqe0, int max_iters,
                                        WarpPass* wp = nullptr) {
  float dcs[3], dcv[3];
  for (int a = 0; a < 3; ++a) {
    const float dtb = dt[a] * dt_factor;
    dcs[a] = dtb * 0.25f;    // coarse (4^3-of-cells) dt
    dcv[a] = dtb * 0.0625f;  // fine cell dt
  }
  const uint32_t coarse_lo = row[128];
  const uint32_t coarse_hi = row[129];
  const uint32_t base = row[130];

  Dda r{false, false, kMaxFloat, -1, 0u, 0.0f, 0.0f, tqe0, 0, 0, 3, 1};
  float sub_tq = tqe0;
  bool active = true;
  for (int i = 0; i < max_iters && active; ++i) {
    count_pass(wp);
    ++r.iters;
    ++r.walks;
    const Walk ws = walk64(coarse_lo, coarse_hi, vm6, bt1, dcs, sub_tq);
    if (ws.c >= 64) {
      active = false;
      break;
    }
    const int s_real = ws.c ^ vm6;
    const uint32_t w_lo = row[2 * s_real];
    const uint32_t w_hi = row[2 * s_real + 1];
    r.words += 2;
    r.loads += 1;
    int sx, sy, sz;
    coords(ws.c, sx, sy, sz);
    const float st1[3] = {plane(bt1[0], dcs[0], min(sx + 1, 4)),
                          plane(bt1[1], dcs[1], min(sy + 1, 4)),
                          plane(bt1[2], dcs[2], min(sz + 1, 4))};
    const Walk wv = walk64(w_lo, w_hi, vm6, st1, dcv, sub_tq);
    ++r.walks;
    const bool found_v = wv.c < 64;
    // leaf: a voxel behind the origin is skipped (entry strictly ahead);
    // supernode: any child row past the resume key is next
    const bool is_hit = LEAF ? (found_v && wv.en > 0.0f) : found_v;
    if (is_hit) {
      int vx, vy, vz;
      coords(wv.c, vx, vy, vz);
      r.hit = true;
      if (!(LEAF && SHADOW)) {
        const uint32_t pk = row[132 + (s_real >> 1)];
        r.words += 1;
        r.loads += 1;
        const uint32_t pref = (s_real & 1) ? (pk >> 16) : (pk & 0xFFFFu);
        r.vr = base + pref + pc64_below(w_lo, w_hi, wv.c ^ vm6);
      }
      if (LEAF) {
        const float en_xa = plane(st1[0], dcv[0], vx);
        const float en_ya = plane(st1[1], dcv[1], vy);
        r.nmaj = wv.en == en_xa ? 1 : (wv.en == en_ya ? 2 : 0);
        r.t_hit = wv.en;
      } else {
        // child-row cell EXIT planes become the next stage's bt1
        r.t_hit = plane(st1[0], dcv[0], min(vx + 1, 4));
        r.nmaj = __float_as_int(plane(st1[1], dcv[1], min(vy + 1, 4)));
        r.p3 = plane(st1[2], dcv[2], min(vz + 1, 4));
        r.tqp = sub_tq;
      }
      active = false;
      break;
    }
    // origin-inside voxel: resume past it; empty sub-brick: past its exit
    sub_tq = found_v ? wv.ex : jmax(sub_tq, ws.ex);
  }
  r.more = active;
  r.tqr = sub_tq;
  return r;
}

}  // namespace hako
