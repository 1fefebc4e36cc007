// Host split of triangles to the voxelizer's cap (the port's copy of
// mvrt_split_to_cap in the JAX package's csrc/native.cpp).
//
// The dense voxelizer evaluates a static cap^3 candidate grid per triangle,
// so a triangle whose voxel bbox exceeds the cap is bisected at its longest
// edge until every part fits. Worklist form: one input triangle at a time,
// its parts in depth-first order (first half first).
//
// Build (utils/host_build.py): g++ -O3 -std=c++17 -fPIC -ffp-contract=off
// -shared, without -march=native. The longest edge is chosen by comparing
// sqrtf(dx*dx + dy*dy + dz*dz); a contracted multiply-add would round those
// sums differently on hosts with FMA and choose other edges at ties, so the
// triangle count would depend on the host.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tri9 {
  float v[9], c[9], e[9];
};

// Max per-axis voxel-index extent (inclusive count) of the clipped bbox.
int64_t bbox_ext(const float* v, const float* origin, float dps,
                 int64_t grid_res) {
  float lo[3], hi[3];
  for (int a = 0; a < 3; a++) {
    lo[a] = v[a] < v[3 + a] ? v[a] : v[3 + a];
    if (v[6 + a] < lo[a]) lo[a] = v[6 + a];
    hi[a] = v[a] > v[3 + a] ? v[a] : v[3 + a];
    if (v[6 + a] > hi[a]) hi[a] = v[6 + a];
  }
  int64_t ext = 0;
  for (int a = 0; a < 3; a++) {
    int64_t l = (int64_t)floorf((lo[a] - origin[a]) / dps);
    int64_t u = (int64_t)floorf((hi[a] - origin[a]) / dps);
    if (l < 0) l = 0;
    if (u > grid_res - 1) u = grid_res - 1;
    int64_t x = u - l + 1;
    if (x < 0) x = 0;
    if (x > ext) ext = x;
  }
  return ext;
}

}  // namespace

extern "C" {

// v/c/e: f32 [n, 9]. out_*: may be nullptr with out_cap == 0 to query the
// count. Returns the total output triangle count; buffers are written up
// to out_cap triangles.
int64_t hako_split_to_cap(const float* v, const float* c, const float* e,
                          int64_t n, const float* origin, float dps,
                          int64_t grid_res, int64_t cap, float* out_v,
                          float* out_c, float* out_e, int64_t out_cap) {
  std::vector<Tri9> stack;
  stack.reserve(128);
  int64_t n_out = 0;
  for (int64_t i = 0; i < n; i++) {
    Tri9 t;
    memcpy(t.v, v + i * 9, 36);
    memcpy(t.c, c + i * 9, 36);
    memcpy(t.e, e + i * 9, 36);
    stack.push_back(t);
    while (!stack.empty()) {
      Tri9 cur = stack.back();
      stack.pop_back();
      if (bbox_ext(cur.v, origin, dps, grid_res) <= cap) {
        if (n_out < out_cap) {
          memcpy(out_v + n_out * 9, cur.v, 36);
          memcpy(out_c + n_out * 9, cur.c, 36);
          memcpy(out_e + n_out * 9, cur.e, 36);
        }
        n_out++;
        continue;
      }
      // longest edge (the first maximum wins)
      float el[3];
      for (int k = 0; k < 3; k++) {
        int a = k, b = (k + 1) % 3;
        float dx = cur.v[b * 3] - cur.v[a * 3];
        float dy = cur.v[b * 3 + 1] - cur.v[a * 3 + 1];
        float dz = cur.v[b * 3 + 2] - cur.v[a * 3 + 2];
        el[k] = sqrtf(dx * dx + dy * dy + dz * dz);
      }
      int w = 0;
      if (el[1] > el[w]) w = 1;
      if (el[2] > el[w]) w = 2;
      int a = w, b = (w + 1) % 3, o = (w + 2) % 3;
      Tri9 t1, t2;
      for (int j = 0; j < 3; j++) {
        float vm = (cur.v[a * 3 + j] + cur.v[b * 3 + j]) * 0.5f;
        float cm = (cur.c[a * 3 + j] + cur.c[b * 3 + j]) * 0.5f;
        float em = (cur.e[a * 3 + j] + cur.e[b * 3 + j]) * 0.5f;
        t1.v[j] = cur.v[a * 3 + j];
        t1.v[3 + j] = vm;
        t1.v[6 + j] = cur.v[o * 3 + j];
        t2.v[j] = vm;
        t2.v[3 + j] = cur.v[b * 3 + j];
        t2.v[6 + j] = cur.v[o * 3 + j];
        t1.c[j] = cur.c[a * 3 + j];
        t1.c[3 + j] = cm;
        t1.c[6 + j] = cur.c[o * 3 + j];
        t2.c[j] = cm;
        t2.c[3 + j] = cur.c[b * 3 + j];
        t2.c[6 + j] = cur.c[o * 3 + j];
        t1.e[j] = cur.e[a * 3 + j];
        t1.e[3 + j] = em;
        t1.e[6 + j] = cur.e[o * 3 + j];
        t2.e[j] = em;
        t2.e[3 + j] = cur.e[b * 3 + j];
        t2.e[6 + j] = cur.e[o * 3 + j];
      }
      stack.push_back(t2);
      stack.push_back(t1);
    }
  }
  return n_out;
}

}  // extern "C"
