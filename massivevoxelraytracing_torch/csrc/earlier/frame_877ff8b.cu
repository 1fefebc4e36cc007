// The primary frame around the traversal on Hopper: ray generation and
// shading, one thread a lane or a pixel, one kernel a stage of
// models/raycast.py.
//
// Replaces XLA-fused work of the reference (no pallas_call): on the TPU
// render_frame's ray generation and its shade + un-tile are inside one
// jitted program with the traversal (massivevoxelraytracing_tpu/models/
// raycast.py:142-217). Run as eager tensor code they are ~25 device
// kernels each around the traversal kernel, plus four small copies of the
// camera to the card a frame.
//
//   frame_raygen_kernel              replaces models/raycast.py:159-185
//       (_gen_rays_band). One thread a lane of the padded tile-major band
//       (lane = ((ty * ntx + tx) * 128 + ky) * 128 + kx). The camera comes
//       in by value, as the float32 values the plain stage uses, so no
//       copy to the card precedes the launch. Writes ro and rd, f32
//       [n_pad, 3]; a lane past the frame's edge gets ro = 1e9 (parked,
//       outside the root box, a miss at once).
//   frame_shade_kernel<COLOR, UNTILE> replaces models/raycast.py:30-41
//       (_shade_flat, hit_normal) and :188-216 (_shade_untile_band). One
//       thread an output pixel: it reads its lane's t and nmajor and rd
//       (normals) or vidx and the colour table (COLOR), and writes the u8
//       RGB pixel and the depth in row-major order (UNTILE), or in lane
//       order (render_rays' flat order).
//
// What bounds them on an H100: bytes. Ray generation writes 24 B a lane
// and reads nothing; the shade reads 24 B a lane (t, nmajor, rd) and
// writes 7 B a pixel. Both are a few dozen instructions a thread, so the
// design is one pass with every intermediate in registers.
//
// Exactness: every value equals the plain stage's bit for bit. Built with
// -fmad=false (no contraction) and IEEE division; the float expressions
// keep the plain stage's order: u = (-th + (2 th)(px + 0.5) / w) * aspect
// with a true division, v = th - (2 th)(py + 0.5) / h, rd = (u right +
// v up) + front; the colour channel is multiplied by f32(1 / 255) (not
// divided by 255), the pixel is clamp(rgb * 255 + 0.5, 0, 255) truncated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr long long kTile = 128;              // raycast.TILE
constexpr float kMissT = 0x1.e17b84p+122f;    // f32(1e37): t < 1e37 is a hit
constexpr float kInv255 = 0x1.010102p-8f;     // f32(1 / 255), voxelize.rgb8_to_f32
constexpr float kPark = 1e9f;                 // exact in float32

// The camera as the plain stage's float32 values: origin, right, up,
// front, tan(fovy / 2), f32(width), f32(height), f32(width / height).
struct Camera {
  float o[3], right[3], up[3], front[3];
  float th, w, h, aspect;
};

struct RaygenArgs {
  Camera cam;
  long long py0, width, height, ntx, n_pad;
  float* ro;
  float* rd;
};

__device__ __forceinline__ long long lane0() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

__global__ void __launch_bounds__(kThreads) frame_raygen_kernel(RaygenArgs a) {
  const Camera& c = a.cam;
  const float two_th = 2.0f * c.th;
  for (long long lane = lane0(); lane < a.n_pad; lane += stride()) {
    const long long ti = lane / (kTile * kTile), k = lane % (kTile * kTile);
    const long long px = (ti % a.ntx) * kTile + k % kTile;
    const long long py = (ti / a.ntx) * kTile + k / kTile + a.py0;
    const bool live = px < a.width && py < a.height;
    const float pxf = static_cast<float>(px), pyf = static_cast<float>(py);
    const float u = (-c.th + two_th * (pxf + 0.5f) / c.w) * c.aspect;
    const float v = c.th - two_th * (pyf + 0.5f) / c.h;
    for (int ax = 0; ax < 3; ++ax) {
      a.rd[3 * lane + ax] = (u * c.right[ax] + v * c.up[ax]) + c.front[ax];
      a.ro[3 * lane + ax] = live ? c.o[ax] : kPark;
    }
  }
}

struct ShadeArgs {
  const float* t;
  const int* nmaj;
  const int* vidx;
  const float* rd;
  const int* color;
  long long n_color;
  long long n_out, width, ntx;  // output pixels; UNTILE: the row width, tiles a row
  uint8_t* img;
  float* depth;
};

// torch.clamp(x, 0, 255): NaN stays NaN
__device__ __forceinline__ float clamp255(float x) {
  if (x != x) return x;
  return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
}

template <bool COLOR, bool UNTILE>
__global__ void __launch_bounds__(kThreads) frame_shade_kernel(ShadeArgs a) {
  for (long long i = lane0(); i < a.n_out; i += stride()) {
    long long lane = i;
    if (UNTILE) {
      const long long y = i / a.width, x = i % a.width;
      lane = (((y / kTile) * a.ntx + x / kTile) * kTile + y % kTile) * kTile + x % kTile;
    }
    const float t = a.t[lane];
    const bool hit = t < kMissT;
    float col[3];
    if (COLOR) {
      long long idx = static_cast<long long>(a.vidx[lane]);
      idx = idx < 0 ? 0 : (idx > a.n_color - 1 ? a.n_color - 1 : idx);
      const uint32_t p = static_cast<uint32_t>(a.color[idx]);
      for (int ch = 0; ch < 3; ++ch)
        col[ch] = static_cast<float>((p >> (8 * ch)) & 0xFFu) * kInv255;
    } else {
      // hit_normal: -sign(rd) on the major axis (1: x, 2: y, 0: z), then
      // (n + 1) * 0.5
      const int nm = a.nmaj[lane];
      for (int ax = 0; ax < 3; ++ax) {
        const float s = 0.0f < a.rd[3 * lane + ax] ? -1.0f : 1.0f;
        const float n = nm == (ax + 1) % 3 ? s : 0.0f;
        col[ax] = (n + 1.0f) * 0.5f;
      }
    }
    for (int ch = 0; ch < 3; ++ch) {
      const float x = clamp255((hit ? col[ch] : 0.0f) * 255.0f + 0.5f);
      a.img[3 * i + ch] = static_cast<uint8_t>(x);
    }
    a.depth[i] = t;
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

// cam: 16 host floats (Camera's order); ro, rd: f32 [n_pad, 3] with n_pad
// = ntx * 128 * band_tile_rows * 128, ntx = ceil(width / 128).
extern "C" int frame_raygen_launch(const float* cam, long long py0, long long width,
                                   long long height, long long band_tile_rows, void* ro,
                                   void* rd, void* stream) {
  RaygenArgs a{};
  float* dst = &a.cam.o[0];
  for (int k = 0; k < 16; ++k) dst[k] = cam[k];
  a.py0 = py0;
  a.width = width;
  a.height = height;
  a.ntx = (width + kTile - 1) / kTile;
  a.n_pad = a.ntx * kTile * band_tile_rows * kTile;
  a.ro = static_cast<float*>(ro);
  a.rd = static_cast<float*>(rd);
  return launch(frame_raygen_kernel, a, a.n_pad, stream);
}

// color: show the voxel colours (int32 [n_color] packed RGB8, vidx read)
// or the face normals (rd read); untile: n_out = rows_out * width pixels
// in row-major order from the tile-major lanes (width <= ntx * 128), else
// n_out lanes in their own order.
extern "C" int frame_shade_launch(int color, int untile, const void* t, const void* nmaj,
                                  const void* vidx, const void* rd, const void* color_table,
                                  long long n_color, long long n_out, long long width,
                                  void* img, void* depth, void* stream) {
  ShadeArgs a{static_cast<const float*>(t), static_cast<const int*>(nmaj),
              static_cast<const int*>(vidx), static_cast<const float*>(rd),
              static_cast<const int*>(color_table), n_color, n_out, width,
              (width + kTile - 1) / kTile, static_cast<uint8_t*>(img),
              static_cast<float*>(depth)};
  if (color)
    return untile ? launch(frame_shade_kernel<true, true>, a, n_out, stream)
                  : launch(frame_shade_kernel<true, false>, a, n_out, stream);
  return untile ? launch(frame_shade_kernel<false, true>, a, n_out, stream)
                : launch(frame_shade_kernel<false, false>, a, n_out, stream);
}
