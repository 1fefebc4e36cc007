// The path tracer's per-lane sample chain on Hopper: one thread per lane,
// one kernel per stage of ops/pt_chain.py.
//
// Replaces the XLA-fused sample chain of the reference's jitted pt_sample
// (massivevoxelraytracing_tpu/models/pathtracer.py:58-350): the Owen-
// scrambled PMJ02 draws (ops/sampling.py pmj_sample2d over ops/hashing.py
// and ops/bits.py), the PCG32 stream (ops/rng.py), the HDRI alias-table
// importance sample and nearest lookup (ops/hdri.py), the cosine
// directions (sampling.sample_lambertian) and the bounce loop's
// throughput / radiance updates. That chain has no pallas_call: on the TPU
// XLA fused it into a few fusions a bounce; run as eager tensor code it
// is ~1,700 device kernels a bounce, each a pass over the lanes.
//
//   pt_lane_init_kernel       lanes, PMJ stream / PCG32 state, thin lens
//   pt_primary_shade_kernel   miss mask, primary HDRI, raw emission
//   pt_bounce_sample_kernel   albedo, normal, hit point, NEE sample
//                             (alias or prefix tables), cosine directions
//   pt_bounce_shade_kernel    NEE contribution, throughput, pickups,
//                             hit-state advance, next compaction key
//   pt_compact_gather_kernel  every per-lane tensor by the permutation
//
// What bounds it on an H100: bytes. A lane reads and writes ~100-250 B a
// stage (its state in [R] / [R, 3] arrays, plus random gathers of the
// PMJ, alias, colour and emission tables) against a few hundred
// instructions, the double-precision sin / cos / atan2 among them. The
// design keeps each stage one pass over the lanes: every per-lane value a
// stage makes lives in registers until the stage writes its outputs, and
// the launches a bounce fall from ~1,700 to five.
//
// Exactness: every value equals the plain stage's bit for bit. Built with
// -fmad=false (no contraction) and IEEE division and square root; u32
// hashing in uint32_t; the transcendentals in double, rounded to float
// (sampling._f64); constants are the float32 roundings torch makes of the
// Python scalars (hex literals below), and float expressions keep the
// plain stages' order, left to right.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr uint32_t kLength = 4096;    // sampling.LENGTH
constexpr uint32_t kNSequence = 128;  // sampling.N_SEQUENCE
constexpr uint64_t kPcgMult = 6364136223846793005ull;

// float32 roundings of the Python constants of the plain stages
constexpr float kPi = 0x1.921fb6p+1f;       // f32(math.pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;    // f32(2 * math.pi)
constexpr float kTableK = 0x1.99999ap-1f;   // f32(0.8), hdri.select_table
constexpr float kMissT = 0x1.e17b84p+122f;  // f32(1e37)
constexpr float kMinPdf = 0x1.79ca1p-67f;   // f32(1e-20)
constexpr float kPark = 1e9f;               // exact in float32
constexpr float kInv255 = 0x1.010102p-8f;   // f32(1 / 255)
constexpr float kInvMax = 0x1p-32f;         // f32(1 / 0xFFFFFFFF)
constexpr long long kMask32 = 0xFFFFFFFFll;

// the HDRI of the bounce sample: none, the alias tables, the prefix tables
constexpr int kNoHdri = 0, kAlias = 1, kSats = 2;

// ---------------------------------------------------------------------------
// hashing and scrambling (ops/hashing.py, ops/bits.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t murmur_combine(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 = rotl32(h1 ^ k1, 13);
  return h1 * 5u + 0xE6546B64u;
}

// hash_combine(a, b) and hash_combine(a, b, c)
__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  return fmix32(murmur_combine(a, b) ^ 4u);
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return fmix32(murmur_combine(murmur_combine(a, b), c) ^ 8u);
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  return x ^ (x * 0x8D22F6E6u);
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

__device__ __forceinline__ float uniformf(uint32_t x) {
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float scramble_f32(float x, uint32_t seed) {
  uint32_t bits = __float_as_uint(x + 1.0f);
  uint32_t s = 0x3F800000u | (nested_uniform_scramble(bits & 0x7FFFFFu, seed) & 0x7FFFFFu);
  return __uint_as_float(s) - 1.0f;
}

__device__ __forceinline__ uint32_t pcg32_next(uint64_t& state, uint64_t inc) {
  uint64_t old = state;
  state = old * kPcgMult + inc;
  uint32_t xs = static_cast<uint32_t>(((old >> 18) ^ old) >> 27);
  uint32_t rot = static_cast<uint32_t>(old >> 59);
  return (xs >> rot) | (xs << ((0u - rot) & 31u));
}

// clamp(x, min=lo) and clamp(x, lo, hi) as torch takes them: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ long long clampi(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__device__ __forceinline__ float f64cos(float x) { return static_cast<float>(cos(static_cast<double>(x))); }
__device__ __forceinline__ float f64sin(float x) { return static_cast<float>(sin(static_cast<double>(x))); }
__device__ __forceinline__ float f64atan2(float y, float x) {
  return static_cast<float>(atan2(static_cast<double>(y), static_cast<double>(x)));
}

// rgb8_to_f32 of table[clip(i)]
__device__ __forceinline__ void rgb8(const int* table, long long n, long long i, float out[3]) {
  uint32_t p = static_cast<uint32_t>(table[clampi(i, n - 1)]);
  out[0] = static_cast<float>(p & 0xFFu) * kInv255;
  out[1] = static_cast<float>((p >> 8) & 0xFFu) * kInv255;
  out[2] = static_cast<float>((p >> 16) & 0xFFu) * kInv255;
}

__device__ __forceinline__ void load3(const float* a, long long i, float v[3]) {
  v[0] = a[3 * i];
  v[1] = a[3 * i + 1];
  v[2] = a[3 * i + 2];
}

__device__ __forceinline__ void store3(float* a, long long i, const float v[3]) {
  a[3 * i] = v[0];
  a[3 * i + 1] = v[1];
  a[3 * i + 2] = v[2];
}

// A lane's sample stream: the PMJ02 table (PMJ) or its PCG32 state.
struct Rng {
  const float* table;  // f32 [n_points, 2]
  long long n_points;
  uint32_t stream, spp;
  uint64_t state, inc;

  template <bool PMJ>
  __device__ __forceinline__ void draw(uint32_t d, float& x, float& y) {
    if (PMJ) {  // sampling.pmj_sample2d
      uint32_t si = nested_uniform_scramble(spp, hash3(stream, d, 31082745u)) & (kLength - 1);
      uint32_t dim = nested_uniform_scramble(d, hash2(stream, 54761983u)) & (kNSequence - 1);
      long long lin = clampi(static_cast<long long>(dim) * kLength + si, n_points - 1);
      x = scramble_f32(table[2 * lin], hash3(stream, dim, 83927105u));
      y = scramble_f32(table[2 * lin + 1], hash3(stream, dim, 12654890u));
    } else {
      uint32_t a = pcg32_next(state, inc);
      uint32_t b = pcg32_next(state, inc);
      x = uniformf(a);
      y = uniformf(b);
    }
  }
};

// sampling.sample_lambertian (with its orthonormal_basis)
__device__ __forceinline__ void sample_lambertian(float a, float b, const float ng[3], float out[3]) {
  float r = sqrtf(a);
  float theta = b * kTwoPi;
  float x = r * f64cos(theta);
  float y = r * f64sin(theta);
  float z = sqrtf(clamp_min(1.0f - a, 0.0f));
  float z0 = ng[0], z1 = ng[1], z2 = ng[2];
  float sign = z2 >= 0.0f ? 1.0f : -1.0f;
  float aa = -1.0f / (sign + z2);
  float bb = z0 * z1 * aa;
  float xa[3] = {1.0f + sign * z0 * z0 * aa, sign * bb, -sign * z0};
  float ya[3] = {bb, sign + z1 * z1 * aa, -z1};
  for (int k = 0; k < 3; ++k) out[k] = xa[k] * x + ya[k] * y + ng[k] * z;
}

struct Env {
  const float* prob;       // f32 [7, nt] (alias)
  const long long* alias;  // int64 [7, nt] (alias)
  const float* pdf;        // f32 [7, nt] (alias)
  const long long* sats;   // int64 [7, h, w] u32 prefix tables (sats)
  const float* pixels;     // f32 [h, w, 3]
  int w, h;
  int steps_w, steps_h;    // hdri.search_steps(w), (h)
  float scale, d_theta, d_phi;
};

// hdri._upper_bound: the smallest i in [0, n] with f(i) > b, in a fixed
// number of bisection steps (a lane stops moving once i == j)
template <typename F>
__device__ __forceinline__ long long upper_bound(F f, long long n, int steps, float b) {
  long long i = 0, j = n;
  for (int s = 0; s < steps; ++s) {
    if (i < j) {
      long long m = (i + j) / 2;
      if (f(m) <= b) {
        i = m + 1;
      } else {
        j = m;
      }
    }
  }
  return i;
}

// importance_sample's sats backend: X by a binary search over the last
// prefix row, Y within column X; p_sel the texel's 2x2 corner difference.
// u32 prefix values in int64, differences masked to 32 bits.
__device__ __forceinline__ void sats_texel(const Env& e, long long table, float u0, float u1,
                                           long long& X, long long& Y, float& p_sel) {
  const long long w = e.w, h = e.h, last = 7 * w * h - 1;
  const long long* sat = e.sats;
  auto gather = [&](long long y, long long x) { return sat[clampi(table * (w * h) + y * w + x, last)]; };
  auto ps_h = [&](long long x) -> long long { return x <= 0 ? 0 : gather(h - 1, x - 1); };
  X = upper_bound([&](long long m) { return static_cast<float>(ps_h(m)) * kInvMax; }, w,
                  e.steps_w, u0) - 1;
  X = clampi(X, w - 1);
  const long long vol = (ps_h(X + 1) - ps_h(X)) & kMask32;
  const float vol_f = clamp_min(static_cast<float>(vol), 1.0f);
  auto ps_v = [&](long long y) -> long long {
    if (y <= 0) return 0;
    long long s0 = X <= 0 ? 0 : gather(y - 1, X - 1);
    return (gather(y - 1, X) - s0) & kMask32;
  };
  Y = upper_bound([&](long long m) { return static_cast<float>(ps_v(m)) / vol_f; }, h,
                  e.steps_h, u1) - 1;
  Y = clampi(Y, h - 1);
  const long long a = (X <= 0 || Y <= 0) ? 0 : gather(Y - 1, X - 1);
  const long long b = Y <= 0 ? 0 : gather(Y - 1, X);
  const long long c = X <= 0 ? 0 : gather(Y, X - 1);
  const long long d = gather(Y, X);
  p_sel = static_cast<float>(((d - b) + (a - c)) & kMask32) * kInvMax;
}

// hdri.importance_sample(axis_aligned=True) through the alias tables
// (HDRI kAlias) or the prefix tables (kSats)
template <int HDRI>
__device__ __forceinline__ void importance_sample(const Env& e, const float n[3], float u0, float u1,
                                                  float u2, float u3, float dir[3], float le[3],
                                                  float& sr_pdf) {
  // select_table: the reversed chain, the first true condition wins
  long long table = 0;
  if (n[2] < -kTableK) table = 6;
  if (kTableK < n[2]) table = 5;
  if (n[1] < -kTableK) table = 4;
  if (kTableK < n[1]) table = 3;
  if (n[0] < -kTableK) table = 2;
  if (kTableK < n[0]) table = 1;
  long long nt = static_cast<long long>(e.w) * e.h;
  long long X, Y;
  float p_sel;
  if (HDRI == kSats) {
    sats_texel(e, table, u0, u1, X, Y, p_sel);
  } else {
    long long last = 7 * nt - 1;
    long long j = clampi(static_cast<long long>(u0 * static_cast<float>(nt)), nt - 1);
    long long lin = clampi(table * nt + j, last);
    float pa = e.prob[lin];
    long long ja = e.alias[lin];
    long long texel = u1 < pa ? j : ja;
    p_sel = e.pdf[clampi(table * nt + texel, last)];
    X = texel % e.w;
    Y = texel / e.w;
  }
  // _finish_sample
  float theta = static_cast<float>(Y) * e.d_theta;
  float dh = 2.0f * f64sin(e.d_theta * 0.5f) * f64sin(e.d_theta * 0.5f + theta);
  float sr = dh * e.d_phi;
  float s_y = f64cos(theta) * (1.0f - u2) + f64cos(theta + e.d_theta) * u2;
  float phi = e.d_phi * (static_cast<float>(X) + u3) + kPi;
  float s_x = f64cos(phi);
  float s_z = f64sin(phi);
  float sin_theta = sqrtf(clamp_min(1.0f - s_y * s_y, 0.0f));
  dir[0] = s_x * sin_theta;
  dir[1] = s_y;
  dir[2] = s_z * sin_theta;
  sr_pdf = clamp_min(p_sel, kMinPdf) / sr;
  long long px = clampi(Y * e.w + X, nt - 1);
  for (int k = 0; k < 3; ++k) le[k] = e.pixels[3 * px + k] * e.scale;
}

__device__ __forceinline__ long long lane0() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long lane_step() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct Cam {
  const float *o, *right, *up, *front;                        // f32 [3]
  const float *tan_half_fovy, *lens_r, *focus, *inv_w, *inv_h, *aspect;  // f32 scalars
};

struct InitArgs {
  Cam cam;
  const float* table;
  long long n_points;
  const long long* perm;  // nullptr: no pixel permutation
  long long n_perm;
  uint32_t pix_start, spp_base;
  long long width, pix_packet, n_spp, n;
  int spp_major;
  long long *stream, *spp, *pcg_state, *pcg_inc;
  float *ro, *rd;
};

template <bool PMJ>
__global__ void __launch_bounds__(kThreads) pt_lane_init_kernel(InitArgs a) {
  const Cam c = a.cam;
  const float tan = *c.tan_half_fovy, lens_r = *c.lens_r, focus = *c.focus;
  const float inv_w = *c.inv_w, inv_h = *c.inv_h, aspect = *c.aspect;
  for (long long r = lane0(); r < a.n; r += lane_step()) {
    long long pix_off = a.spp_major ? r / a.n_spp : r % a.pix_packet;
    long long spp_off = a.spp_major ? r % a.n_spp : r / a.pix_packet;
    long long pix_idx = static_cast<uint32_t>(a.pix_start + static_cast<uint32_t>(pix_off));
    if (a.perm != nullptr) pix_idx = a.perm[clampi(pix_idx, a.n_perm - 1)];
    long long px = pix_idx % a.width;
    long long py = pix_idx / a.width;  // rows past the frame render harmlessly
    Rng g{a.table, a.n_points, hash2(0u, static_cast<uint32_t>(pix_idx)),
          a.spp_base + static_cast<uint32_t>(spp_off), 0, 0};
    if (!PMJ) {  // rng.pcg32_init(hash_combine(stream, spp), stream)
      g.inc = (static_cast<uint64_t>(g.stream) << 1) | 1u;
      g.state = (g.inc + hash2(g.stream, g.spp)) * kPcgMult + g.inc;
    }
    float cu0, cu1, lu0, lu1;
    g.draw<PMJ>(0, cu0, cu1);
    g.draw<PMJ>(1, lu0, lu1);
    float xf = (static_cast<float>(px) + cu0) * inv_w;
    float yf = (static_cast<float>(py) + cu1) * inv_h;
    float fx = focus * (-tan + 2.0f * tan * xf) * aspect;
    float fy = focus * (tan - 2.0f * tan * yf);
    float lx = -lens_r + 2.0f * lens_r * lu0;
    float ly = -lens_r + 2.0f * lens_r * lu1;
    float ro[3], rd[3];
    for (int k = 0; k < 3; ++k) {
      rd[k] = (fx - lx) * c.right[k] + (fy - ly) * c.up[k] + focus * c.front[k];
      ro[k] = c.o[k] + lx * c.right[k] + ly * c.up[k];
    }
    store3(a.ro, r, ro);
    store3(a.rd, r, rd);
    a.stream[r] = g.stream;
    a.spp[r] = g.spp;
    if (!PMJ) {
      a.pcg_state[r] = static_cast<long long>(g.state);
      a.pcg_inc[r] = static_cast<long long>(g.inc);
    }
  }
}

struct PrimaryArgs {
  const float* t;
  const int* vidx;
  const float* rd;
  const int* emission;
  long long n_emission;
  const float* img;  // f32 [hp, wp, 3]
  int w, h;
  float scale;
  long long n;
  float *T, *L;
  bool* miss;
};

template <bool HDRI>
__global__ void __launch_bounds__(kThreads) pt_primary_shade_kernel(PrimaryArgs a) {
  for (long long r = lane0(); r < a.n; r += lane_step()) {
    bool miss = a.t[r] >= kMissT;
    float L[3] = {0.0f, 0.0f, 0.0f};
    if (miss && HDRI) {  // hdri.sample_nearest(primary=True)
      float n[3];
      load3(a.rd, r, n);
      float phi = f64atan2(n[2], n[0]) + kPi;
      float theta = f64atan2(sqrtf(n[0] * n[0] + n[2] * n[2]), n[1]);
      float u = phi / kTwoPi, v = theta / kPi;
      long long x = static_cast<long long>(clamp2(u * static_cast<float>(a.w), 0.0f,
                                                  static_cast<float>(a.w) - 1.0f));
      long long y = static_cast<long long>(clamp2(v * static_cast<float>(a.h), 0.0f,
                                                  static_cast<float>(a.h) - 1.0f));
      for (int k = 0; k < 3; ++k) L[k] = a.img[3 * (y * a.w + x) + k] * a.scale;
    }
    if (!miss) rgb8(a.emission, a.n_emission, a.vidx[r], L);  // raw, unscaled
    const float one[3] = {1.0f, 1.0f, 1.0f};
    store3(a.T, r, one);
    store3(a.L, r, L);
    a.miss[r] = miss;
  }
}

struct SampleArgs {
  const int* color;
  long long n_color;
  const int *vidx, *nmaj;
  const float *ro, *rd, *t;
  const bool* miss;
  const long long *stream, *spp, *pcg_state, *pcg_inc;
  const float* table;
  long long n_points;
  uint32_t dim;
  Env env;
  long long n;
  float *refl, *hit_n, *hit_p, *rd_out, *dir_e, *dir_s, *emissive, *pdf;
  long long* pcg_state_out;
};

template <int HDRI, bool EXTRA, bool PMJ>
__global__ void __launch_bounds__(kThreads) pt_bounce_sample_kernel(SampleArgs a) {
  for (long long r = lane0(); r < a.n; r += lane_step()) {
    bool miss = a.miss[r];
    float refl[3], rd[3], ro[3] = {0.0f, 0.0f, 0.0f}, hn[3], hp[3];
    rgb8(a.color, a.n_color, a.vidx[r], refl);
    load3(a.rd, r, rd);
    if (!miss) load3(a.ro, r, ro);  // a dead lane's hit point is parked
    // traverse.hit_normal
    int nm = a.nmaj[r];
    hn[0] = nm == 1 ? (0.0f < rd[0] ? -1.0f : 1.0f) : 0.0f;
    hn[1] = nm == 2 ? (0.0f < rd[1] ? -1.0f : 1.0f) : 0.0f;
    hn[2] = nm == 0 ? (0.0f < rd[2] ? -1.0f : 1.0f) : 0.0f;
    float t = miss ? 0.0f : a.t[r];
    for (int k = 0; k < 3; ++k) hp[k] = miss ? kPark : ro[k] + rd[k] * t;

    Rng g{a.table, a.n_points, static_cast<uint32_t>(a.stream[r]),
          static_cast<uint32_t>(a.spp[r]), 0, 0};
    if (!PMJ) {
      g.state = static_cast<uint64_t>(a.pcg_state[r]);
      g.inc = static_cast<uint64_t>(a.pcg_inc[r]);
    }
    uint32_t d = a.dim;
    if (HDRI != kNoHdri) {
      float u0, u1, u2, u3, dir[3], le[3], pdf;
      g.draw<PMJ>(d, u0, u1);
      g.draw<PMJ>(d + 1, u2, u3);
      d += 2;
      importance_sample<HDRI>(a.env, hn, u0, u1, u2, u3, dir, le, pdf);
      store3(a.dir_s, r, dir);
      store3(a.emissive, r, le);
      a.pdf[r] = pdf;
    }
    if (EXTRA) {
      float e0, e1, dir[3];
      g.draw<PMJ>(d, e0, e1);
      d += 1;
      sample_lambertian(e0, e1, hn, dir);
      store3(a.dir_e, r, dir);
    }
    float b0, b1, dir_b[3];
    g.draw<PMJ>(d, b0, b1);
    sample_lambertian(b0, b1, hn, dir_b);
    store3(a.refl, r, refl);
    store3(a.hit_n, r, hn);
    store3(a.hit_p, r, hp);
    store3(a.rd_out, r, miss ? rd : dir_b);
    if (!PMJ) a.pcg_state_out[r] = static_cast<long long>(g.state);
  }
}

struct ShadeArgs {
  const int* emission;
  long long n_emission;
  const float* escale;  // f32 scalar on the device
  const float *T, *L, *refl, *hit_n, *dir_s, *emissive, *pdf;
  const bool* miss;
  const int *nmaj, *vidx;
  const float* rd;
  const float *t_s, *t_e;
  const int* v_e;
  const float* t_b;
  const int *nm_b, *vi_b;
  float inv_extra, w_depth0;
  long long n;
  float *T_out, *L_out;
  int *nmaj_out, *vidx_out;
  bool* miss_out;
  long long* key;  // nullptr: no key
};

// A lane reads only what its outcome needs: refl and the BSDF t when it
// is alive, the NEE sample when its shadow ray was clear, the hit state
// of the BSDF ray or its old one, the direction for a live lane's key.
template <bool HDRI, bool EXTRA>
__global__ void __launch_bounds__(kThreads) pt_bounce_shade_kernel(ShadeArgs a) {
  const float escale = *a.escale;
  for (long long r = lane0(); r < a.n; r += lane_step()) {
    bool alive = !a.miss[r];
    float T[3], L[3], refl[3];
    load3(a.T, r, T);
    load3(a.L, r, L);
    if (alive) load3(a.refl, r, refl);
    if (HDRI && alive && a.t_s[r] >= kMissT) {  // NEE to the environment, any-hit
      float hn[3], ds[3], em[3];
      load3(a.hit_n, r, hn);
      load3(a.dir_s, r, ds);
      load3(a.emissive, r, em);
      float cosw = clamp_min(hn[0] * ds[0] + hn[1] * ds[1] + hn[2] * ds[2], 0.0f);
      float q = cosw / a.pdf[r];
      for (int k = 0; k < 3; ++k) L[k] = L[k] + T[k] * (refl[k] / kPi) * q * em[k];
    }
    if (alive)
      for (int k = 0; k < 3; ++k) T[k] = T[k] * refl[k];
    if (EXTRA && alive && a.t_e[r] < kMissT) {  // the implicit emission ray
      float le[3];
      rgb8(a.emission, a.n_emission, a.v_e[r], le);
      for (int k = 0; k < 3; ++k) L[k] = L[k] + T[k] * (le[k] * escale) / a.inv_extra;
    }
    bool new_hit = alive && a.t_b[r] < kMissT;  // the BSDF ray
    int vidx, nmaj;
    if (new_hit) {
      float le[3];
      vidx = a.vi_b[r];
      nmaj = a.nm_b[r];
      rgb8(a.emission, a.n_emission, vidx, le);
      for (int k = 0; k < 3; ++k) L[k] = L[k] + T[k] * (le[k] * escale) * a.w_depth0;
    } else {
      vidx = a.vidx[r];
      nmaj = a.nmaj[r];
    }
    store3(a.T_out, r, T);
    store3(a.L_out, r, L);
    a.nmaj_out[r] = nmaj;
    a.vidx_out[r] = vidx;
    a.miss_out[r] = !new_hit;
    if (a.key != nullptr) {
      long long oct = 8;
      if (new_hit) {
        const float* d = a.rd + 3 * r;
        oct = (d[0] < 0.0f) + 2 * (d[1] < 0.0f) + 4 * (d[2] < 0.0f);
      }
      a.key[r] = (oct << 32) | static_cast<long long>(static_cast<uint32_t>(vidx));
    }
  }
}

struct GatherArgs {
  const long long* perm;
  long long n;
  const int* vidx;
  const long long *stream, *spp, *orig;
  const int* nmaj;
  const float *t, *ro, *rd, *T, *L;
  int* vidx_o;
  long long *stream_o, *spp_o, *orig_o;
  int* nmaj_o;
  float *t_o, *ro_o, *rd_o, *T_o, *L_o;
  bool* miss_o;
};

__global__ void __launch_bounds__(kThreads) pt_compact_gather_kernel(GatherArgs a) {
  for (long long r = lane0(); r < a.n; r += lane_step()) {
    long long p = a.perm[r];
    float v[3];
    a.vidx_o[r] = a.vidx[p];
    a.stream_o[r] = a.stream[p];
    a.spp_o[r] = a.spp[p];
    a.orig_o[r] = a.orig[p];
    a.nmaj_o[r] = a.nmaj[p];
    float t = a.t[p];
    a.t_o[r] = t;
    a.miss_o[r] = t >= kMissT;
    load3(a.ro, p, v);
    store3(a.ro_o, r, v);
    load3(a.rd, p, v);
    store3(a.rd_o, r, v);
    load3(a.T, p, v);
    store3(a.T_o, r, v);
    load3(a.L, p, v);
    store3(a.L_o, r, v);
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

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out(void* p) {
  return static_cast<T*>(p);
}

template <int HDRI>
int launch_sample(const SampleArgs& a, int extra, int pmj, long long n, void* stream) {
  // every (EXTRA, PMJ) case: the sample dims and their order differ
  switch ((extra ? 2 : 0) | (pmj ? 1 : 0)) {
    case 0: return launch(pt_bounce_sample_kernel<HDRI, false, false>, a, n, stream);
    case 1: return launch(pt_bounce_sample_kernel<HDRI, false, true>, a, n, stream);
    case 2: return launch(pt_bounce_sample_kernel<HDRI, true, false>, a, n, stream);
    default: return launch(pt_bounce_sample_kernel<HDRI, true, true>, a, n, stream);
  }
}

}  // namespace

// cam: 10 device pointers (o, right, up, front, tan_half_fovy, lens_r,
// focus, inv_w, inv_h, aspect); perm nullptr for none; pcg_* nullptr for
// PMJ.
extern "C" int pt_lane_init_launch(int pmj, const void* table, long long n_points,
                                   const void* perm, long long n_perm, unsigned pix_start,
                                   unsigned spp_base, long long width, long long pix_packet,
                                   long long n_spp, int spp_major, const void* const* cam,
                                   long long n, void* stream_out, void* spp_out,
                                   void* pcg_state, void* pcg_inc, void* ro, void* rd,
                                   void* stream) {
  InitArgs a{};
  a.cam = Cam{in<float>(cam[0]), in<float>(cam[1]), in<float>(cam[2]), in<float>(cam[3]),
              in<float>(cam[4]), in<float>(cam[5]), in<float>(cam[6]), in<float>(cam[7]),
              in<float>(cam[8]), in<float>(cam[9])};
  a.table = in<float>(table);
  a.n_points = n_points;
  a.perm = in<long long>(perm);
  a.n_perm = n_perm;
  a.pix_start = pix_start;
  a.spp_base = spp_base;
  a.width = width;
  a.pix_packet = pix_packet;
  a.n_spp = n_spp;
  a.n = n;
  a.spp_major = spp_major;
  a.stream = out<long long>(stream_out);
  a.spp = out<long long>(spp_out);
  a.pcg_state = out<long long>(pcg_state);
  a.pcg_inc = out<long long>(pcg_inc);
  a.ro = out<float>(ro);
  a.rd = out<float>(rd);
  return pmj ? launch(pt_lane_init_kernel<true>, a, n, stream)
             : launch(pt_lane_init_kernel<false>, a, n, stream);
}

extern "C" int pt_primary_shade_launch(int hdri, const void* t, const void* vidx, const void* rd,
                                       const void* emission, long long n_emission,
                                       const void* img, int w, int h, float scale, long long n,
                                       void* T, void* L, void* miss, void* stream) {
  PrimaryArgs a{in<float>(t), in<int>(vidx), in<float>(rd), in<int>(emission), n_emission,
                in<float>(img), w, h, scale, n, out<float>(T), out<float>(L), out<bool>(miss)};
  return hdri ? launch(pt_primary_shade_kernel<true>, a, n, stream)
              : launch(pt_primary_shade_kernel<false>, a, n, stream);
}

// hdri: 0 none, 1 the alias tables, 2 the prefix tables (sats); the
// tables of another backend nullptr; dir_e nullptr without extra; pcg_*
// nullptr with pmj.
extern "C" int pt_bounce_sample_launch(
    int hdri, int extra, int pmj, const void* color, long long n_color, const void* vidx,
    const void* nmaj, const void* ro, const void* rd, const void* t, const void* miss,
    const void* stream_in, const void* spp, const void* pcg_state, const void* pcg_inc,
    const void* table, long long n_points, unsigned dim, const void* alias_prob,
    const void* alias_idx, const void* alias_pdf, const void* sats, const void* pixels, int w,
    int h, int steps_w, int steps_h, float scale, float d_theta, float d_phi, long long n,
    void* refl, void* hit_n,
    void* hit_p, void* rd_out, void* dir_e, void* dir_s, void* emissive, void* pdf,
    void* pcg_state_out, void* stream) {
  SampleArgs a{};
  a.color = in<int>(color);
  a.n_color = n_color;
  a.vidx = in<int>(vidx);
  a.nmaj = in<int>(nmaj);
  a.ro = in<float>(ro);
  a.rd = in<float>(rd);
  a.t = in<float>(t);
  a.miss = in<bool>(miss);
  a.stream = in<long long>(stream_in);
  a.spp = in<long long>(spp);
  a.pcg_state = in<long long>(pcg_state);
  a.pcg_inc = in<long long>(pcg_inc);
  a.table = in<float>(table);
  a.n_points = n_points;
  a.dim = dim;
  a.env = Env{in<float>(alias_prob), in<long long>(alias_idx), in<float>(alias_pdf),
              in<long long>(sats), in<float>(pixels), w, h, steps_w, steps_h, scale, d_theta,
              d_phi};
  a.n = n;
  a.refl = out<float>(refl);
  a.hit_n = out<float>(hit_n);
  a.hit_p = out<float>(hit_p);
  a.rd_out = out<float>(rd_out);
  a.dir_e = out<float>(dir_e);
  a.dir_s = out<float>(dir_s);
  a.emissive = out<float>(emissive);
  a.pdf = out<float>(pdf);
  a.pcg_state_out = out<long long>(pcg_state_out);
  switch (hdri) {
    case kNoHdri: return launch_sample<kNoHdri>(a, extra, pmj, n, stream);
    case kAlias: return launch_sample<kAlias>(a, extra, pmj, n, stream);
    default: return launch_sample<kSats>(a, extra, pmj, n, stream);
  }
}

// hit_n / dir_s / emissive / pdf / t_s nullptr without hdri; t_e / v_e
// nullptr without extra; key nullptr for none.
extern "C" int pt_bounce_shade_launch(
    int hdri, int extra, const void* emission, long long n_emission, const void* escale,
    const void* T, const void* L, const void* refl, const void* hit_n, const void* dir_s,
    const void* emissive, const void* pdf, const void* miss, const void* nmaj,
    const void* vidx, const void* rd, const void* t_s, const void* t_e, const void* v_e,
    const void* t_b, const void* nm_b, const void* vi_b, float inv_extra, float w_depth0,
    long long n, void* T_out, void* L_out, void* nmaj_out, void* vidx_out, void* miss_out,
    void* key, void* stream) {
  ShadeArgs a{};
  a.emission = in<int>(emission);
  a.n_emission = n_emission;
  a.escale = in<float>(escale);
  a.T = in<float>(T);
  a.L = in<float>(L);
  a.refl = in<float>(refl);
  a.hit_n = in<float>(hit_n);
  a.dir_s = in<float>(dir_s);
  a.emissive = in<float>(emissive);
  a.pdf = in<float>(pdf);
  a.miss = in<bool>(miss);
  a.nmaj = in<int>(nmaj);
  a.vidx = in<int>(vidx);
  a.rd = in<float>(rd);
  a.t_s = in<float>(t_s);
  a.t_e = in<float>(t_e);
  a.v_e = in<int>(v_e);
  a.t_b = in<float>(t_b);
  a.nm_b = in<int>(nm_b);
  a.vi_b = in<int>(vi_b);
  a.inv_extra = inv_extra;
  a.w_depth0 = w_depth0;
  a.n = n;
  a.T_out = out<float>(T_out);
  a.L_out = out<float>(L_out);
  a.nmaj_out = out<int>(nmaj_out);
  a.vidx_out = out<int>(vidx_out);
  a.miss_out = out<bool>(miss_out);
  a.key = out<long long>(key);
  switch ((hdri ? 2 : 0) | (extra ? 1 : 0)) {
    case 0: return launch(pt_bounce_shade_kernel<false, false>, a, n, stream);
    case 1: return launch(pt_bounce_shade_kernel<false, true>, a, n, stream);
    case 2: return launch(pt_bounce_shade_kernel<true, false>, a, n, stream);
    default: return launch(pt_bounce_shade_kernel<true, true>, a, n, stream);
  }
}

extern "C" int pt_compact_gather_launch(
    const void* perm, long long n, const void* vidx, const void* stream_in, const void* spp,
    const void* orig, const void* nmaj, const void* t, const void* ro, const void* rd,
    const void* T, const void* L, void* vidx_o, void* stream_o, void* spp_o, void* orig_o,
    void* nmaj_o, void* t_o, void* ro_o, void* rd_o, void* T_o, void* L_o, void* miss_o,
    void* stream) {
  GatherArgs a{in<long long>(perm), n, in<int>(vidx), in<long long>(stream_in),
               in<long long>(spp), in<long long>(orig), in<int>(nmaj), in<float>(t),
               in<float>(ro), in<float>(rd), in<float>(T), in<float>(L), out<int>(vidx_o),
               out<long long>(stream_o), out<long long>(spp_o), out<long long>(orig_o),
               out<int>(nmaj_o), out<float>(t_o), out<float>(ro_o), out<float>(rd_o),
               out<float>(T_o), out<float>(L_o), out<bool>(miss_o)};
  return launch(pt_compact_gather_kernel, a, n, stream);
}
