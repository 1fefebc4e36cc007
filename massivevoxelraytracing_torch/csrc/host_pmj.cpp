// PMJ(0,2) sample table on the host (the port's copy of mvrt_pmj02_table in
// the JAX package's csrc/native.cpp): PCG32 driving the pmj02 stochastic
// generator, 128 sequences x 4096 2-D points by default. Built into the same
// host library as host_split.cpp (utils/host_build.py). The plain version is
// sampling.np_pmj02_samples.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PCG32 {
  uint64_t state, inc;
  void setup(uint64_t seed, uint64_t stream) {
    state = 0;
    inc = stream * 2 + 1;
    next();
    state += seed;
    next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xs = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xs >> rot) | (xs << ((-rot) & 31));
  }
  float uniformf() {
    uint32_t bits = (next() >> 9) | 0x3f800000u;
    float v;
    memcpy(&v, &bits, 4);
    return v - 1.0f;
  }
};

// pmj02 xor strata tables
const uint32_t kXors[2][32] = {
    {0x0, 0x0, 0x2, 0x6, 0x6, 0xe, 0x36, 0x4e, 0x16, 0x2e, 0x276, 0x6ce,
     0x716, 0xc2e, 0x3076, 0x40ce, 0x116, 0x22e, 0x20676, 0x60ece, 0x61716,
     0xe2c2e, 0x367076, 0x4ec0ce, 0x170116, 0x2c022e, 0x2700676, 0x6c00ece,
     0x7001716, 0xc002c2e, 0x30007076, 0x4000c0ce},
    {0x0, 0x1, 0x3, 0x3, 0x7, 0x1b, 0x27, 0xb, 0x17, 0x13b, 0x367, 0x38b,
     0x617, 0x183b, 0x2067, 0x8b, 0x117, 0x1033b, 0x30767, 0x30b8b, 0x71617,
     0x1b383b, 0x276067, 0xb808b, 0x160117, 0x138033b, 0x3600767, 0x3800b8b,
     0x6001617, 0x1800383b, 0x20006067, 0x808b}};

}  // namespace

extern "C" {

// out: f32 [n_sequence * length * 2]
void hako_pmj02_table(int32_t n_sequence, int32_t length, uint64_t seed,
                      uint64_t stream, float* out) {
  PCG32 rng;
  rng.setup(seed, stream);
  std::vector<double> s((size_t)length * 2);
  for (int i = 0; i < n_sequence; i++) {
    s[0] = rng.uniformf();
    s[1] = rng.uniformf();
    int log_n = 0;
    while ((1 << log_n) < length) {
      int prev_len = 1 << log_n;
      int n_strata = prev_len * 2;
      double i_strata = 1.0 / n_strata;
      for (int k = 0; k < prev_len && prev_len + k < length; k++) {
        int px = k ^ kXors[0][log_n];
        int xs = ((int)(s[(size_t)px * 2] * n_strata)) ^ 1;
        int py = k ^ kXors[1][log_n];
        int ys = ((int)(s[(size_t)py * 2 + 1] * n_strata)) ^ 1;
        s[(size_t)(prev_len + k) * 2] = (rng.uniformf() + xs) * i_strata;
        s[(size_t)(prev_len + k) * 2 + 1] = (rng.uniformf() + ys) * i_strata;
      }
      log_n++;
    }
    float* dst = out + (size_t)i * length * 2;
    for (int k = 0; k < length * 2; k++) dst[k] = (float)s[k];
  }
}

}  // extern "C"
