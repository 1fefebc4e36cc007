// Host Morton codec and MurmurHash3 (the port's copy of the Morton +
// Murmur oracle block of the JAX package's csrc/native.cpp, after the
// reference's unittest.cpp benchmark and oracle roles). Built into the same
// host library as host_split.cpp (utils/host_build.py). The plain versions
// are ops/morton.np_encode / np_decode (magic bits on the host),
// ops/morton.encode_naive (the bit loop) and
// ops/hashing.np_murmur3_x86_32.
//
// A code holds coordinate bit i of x, y, z at bits 3i, 3i+1, 3i+2 (21 bits
// a coordinate, 63 in all), the layout of ops/morton.encode.

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t split_by_3(uint32_t a) {
  uint64_t x = a & 0x1FFFFF;
  x = (x | x << 32) & 0x1f00000000ffffull;
  x = (x | x << 16) & 0x1f0000ff0000ffull;
  x = (x | x << 8) & 0x100f00f00f00f00full;
  x = (x | x << 4) & 0x10c30c30c30c30c3ull;
  x = (x | x << 2) & 0x1249249249249249ull;
  return x;
}

inline uint32_t third_bits(uint64_t m) {
  uint64_t x = m & 0x1249249249249249ull;
  x = (x ^ (x >> 2)) & 0x10c30c30c30c30c3ull;
  x = (x ^ (x >> 4)) & 0x100f00f00f00f00full;
  x = (x ^ (x >> 8)) & 0x1f0000ff0000ffull;
  x = (x ^ (x >> 16)) & 0x1f00000000ffffull;
  x = (x ^ (x >> 32)) & 0x1fffffull;
  return (uint32_t)x;
}

}  // namespace

extern "C" {

void hako_morton_encode(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                        int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = split_by_3(x[i]) | (split_by_3(y[i]) << 1) | (split_by_3(z[i]) << 2);
}

void hako_morton_decode(const uint64_t* m, int64_t n, uint32_t* x, uint32_t* y,
                        uint32_t* z) {
  for (int64_t i = 0; i < n; i++) {
    x[i] = third_bits(m[i]);
    y[i] = third_bits(m[i] >> 1);
    z[i] = third_bits(m[i] >> 2);
  }
}

uint32_t hako_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  int64_t nblocks = len / 4;
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    memcpy(&k1, data + i * 4, 4);
    k1 *= c1;
    k1 = (k1 << 15) | (k1 >> 17);
    k1 *= c2;
    h1 ^= k1;
    h1 = (h1 << 13) | (h1 >> 19);
    h1 = h1 * 5 + 0xe6546b64;
  }
  uint32_t k1 = 0;
  const uint8_t* tail = data + nblocks * 4;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = (k1 << 15) | (k1 >> 17);
      k1 *= c2;
      h1 ^= k1;
  }
  h1 ^= (uint32_t)len;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6b;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35;
  h1 ^= h1 >> 16;
  return h1;
}

}  // extern "C"
