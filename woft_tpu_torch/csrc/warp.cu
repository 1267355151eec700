// Kernel A: bilinear perspective warp with zero padding
// (cv2.warpPerspective INTER_LINEAR, BORDER_CONSTANT = 0), NHWC float32.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/warp.py:block_warp
// (pallas_call at :221), which warps each (8, 128) output block from one
// shared source patch through one-hot matmuls and is exact only inside a
// pose envelope, with a planning pass and lax.cond tiers around it.
//
// Bound on the H100: device-memory bytes. Per output pixel the warp reads
// about one source pixel and writes one; a 1280x720x3 frame moves 11 MB
// each way (6.6 us at 3.35 TB/s) and does ~55 flops a pixel, far below the
// card's float32 rate. Both frames fit the 50 MB L2 cache, so back-to-back
// launches can run under that bound; what the kernel then pays for is
// instructions executed and cache lines touched per load.
//
// Design: a block owns a 32 x 8 tile of output pixels, one thread a pixel,
// a warp a 32-pixel row of the tile. The source footprint of a block is a
// compact quadrilateral for any pose: a source row serves the lower corners
// of one output row and the upper corners of the next from L1 (256 x 1
// strips fetched it twice).
// Each thread back-projects its own pixel centre with the float32 inverse
// homography (9 floats read from device memory, so the host never syncs)
// and the |z| < 1e-12 clamp, so the kernel is exact for EVERY pose and has
// no envelope, plan or fallback. All offsets are 32-bit (the entry refuses
// 2^31 elements or more): four corner pointers, each one multiply-add on
// the source's base, and the C channels of a corner at constant offsets, so
// the two horizontally adjacent corners are one run of 2*C floats. A corner
// outside the source weighs 0 and reads pixel 0 of its row, or row 0,
// instead (the plain version's clamped gather), so all 4*C loads are
// unconditional and started before the first use. The warp stores its row
// of 32*C consecutive floats straight from registers, C stores of stride C:
// staging the row in shared memory for 16-byte stores was slower on the
// card and is not done. A pixel whose four
// corners all lie outside is written as zeros without a load. C is a
// template parameter for 1, 3 and 4; other channel counts take the same
// body with run-time loops. Built with --fmad=false and the same products
// and sums in the same order as the plain PyTorch version
// (ops/warp.py:_back_project and grid_sample), so the two agree bit for
// bit.
//
// The source batch is 1 or n: with 1 (source stride 0), the n homographies
// warp one source into n outputs in one launch, as the multi-target
// tracker crops its n search windows from one frame.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), 1280x720x3 (chip_smoke.py):
// 0.0078 ms near identity, 0.0123 ms at 30 degrees and 1.5x scale (a warp's
// 32 pixels then cross ~11 source rows), 0.0064 ms partly off-image; the
// one-thread-per-pixel strip kernel it replaces took 0.0150, 0.0154 and
// 0.0106 ms. Warps of 16 x 2 pixels take 0.0087 and 0.0114 ms (slower near
// identity, the tracker's steady case), 8 x 4 lose at both, 32 x 1 tiles
// take 0.020 ms; with the loads compiled out the kernel takes 0.0071 ms
// (tools/torch_kernel_ablate.py).
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

template <int CT>
__global__ void __launch_bounds__(kThreads)
    warp_bilinear_kernel(const float* __restrict__ src, int src_n, int h,
                         int w, int c_arg, const float* __restrict__ hinv,
                         float* __restrict__ out, int out_h, int out_w) {
  const int c = CT > 0 ? CT : c_arg;
  const int n = blockIdx.z;
  const int px = blockIdx.x * kTileW + (threadIdx.x & (kTileW - 1));
  const int py = blockIdx.y * kTileH + threadIdx.x / kTileW;
  if (px >= out_w || py >= out_h) return;

  const float xd = (float)px;
  const float yd = (float)py;
  const float* m = hinv + 9 * n;
  const float sx = m[0] * xd + m[1] * yd + m[2];
  const float sy = m[3] * xd + m[4] * yd + m[5];
  float z = m[6] * xd + m[7] * yd + m[8];
  if (fabsf(z) < 1e-12f) z = z < 0.f ? -1e-12f : 1e-12f;
  const float x = sx / z;
  const float y = sy / z;
  float* o = out + ((n * out_h + py) * out_w + px) * c;
  // x <= -2 or x >= w + 1 (likewise y): every corner lies outside, the
  // sample is exactly 0. The test also keeps the int conversion in range.
  if (!(x > -2.f && x < (float)w + 1.f && y > -2.f && y < (float)h + 1.f)) {
    for (int ch = 0; ch < c; ++ch) o[ch] = 0.f;
    return;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool vx0 = (unsigned)x0 < (unsigned)w;
  const bool vx1 = (unsigned)(x0 + 1) < (unsigned)w;
  const bool vy0 = (unsigned)y0 < (unsigned)h;
  const bool vy1 = (unsigned)(y0 + 1) < (unsigned)h;
  // a corner outside the source weighs 0 and reads pixel 0 of its row or
  // row 0 instead, as the plain version's clamped gather does
  const float w00 = vy0 && vx0 ? (1.f - fx) * (1.f - fy) : 0.f;
  const float w10 = vy0 && vx1 ? fx * (1.f - fy) : 0.f;
  const float w01 = vy1 && vx0 ? (1.f - fx) * fy : 0.f;
  const float w11 = vy1 && vx1 ? fx * fy : 0.f;
  const int cx0 = (vx0 ? x0 : 0) * c;
  const int cx1 = (vx1 ? x0 + 1 : 0) * c;
  const int ns = src_n == 1 ? 0 : n;
  const int cy0 = (ns * h + (vy0 ? y0 : 0)) * w * c;
  const int cy1 = (ns * h + (vy1 ? y0 + 1 : 0)) * w * c;
  const float* p00 = src + (cy0 + cx0);
  const float* p10 = src + (cy0 + cx1);
  const float* p01 = src + (cy1 + cx0);
  const float* p11 = src + (cy1 + cx1);
  if constexpr (CT > 0) {
    float v00[CT], v10[CT], v01[CT], v11[CT];
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) {
      v00[ch] = __ldg(p00 + ch);
      v10[ch] = __ldg(p10 + ch);
      v01[ch] = __ldg(p01 + ch);
      v11[ch] = __ldg(p11 + ch);
    }
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) {
      float acc = v00[ch] * w00;
      acc = acc + v10[ch] * w10;
      acc = acc + v01[ch] * w01;
      acc = acc + v11[ch] * w11;
      o[ch] = acc;
    }
  } else {
    for (int ch = 0; ch < c; ++ch) {
      float acc = __ldg(p00 + ch) * w00;
      acc = acc + __ldg(p10 + ch) * w10;
      acc = acc + __ldg(p01 + ch) * w01;
      acc = acc + __ldg(p11 + ch) * w11;
      o[ch] = acc;
    }
  }
}

template <int CT>
void launch(const float* src, int src_n, int n, int h, int w, int c,
            const float* hinv, float* out, int out_h, int out_w,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((out_w + kTileW - 1) / kTileW),
                  (unsigned)((out_h + kTileH - 1) / kTileH), (unsigned)n);
  warp_bilinear_kernel<CT><<<grid, kThreads, 0, stream>>>(
      src, src_n, h, w, c, hinv, out, out_h, out_w);
}

}  // namespace

// src (src_n, h, w, c) with src_n 1 or n, and out (n, out_h, out_w, c)
// float32 NHWC, each under 2^31 elements, hinv (n, 3, 3) float32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int woft_warp_bilinear(const float* src, int src_n, int n, int h,
                                  int w, int c, const float* hinv,
                                  float* out, int out_h, int out_w,
                                  void* stream) {
  const long long lim = 0x7fffffffLL;
  if (c < 1 || n < 1 || n > 65535 || (src_n != 1 && src_n != n) ||
      (long long)src_n * h * w * c > lim ||
      (long long)n * out_h * out_w * c > lim) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 1: launch<1>(src, src_n, n, h, w, c, hinv, out, out_h, out_w, s); break;
    case 3: launch<3>(src, src_n, n, h, w, c, hinv, out, out_h, out_w, s); break;
    case 4: launch<4>(src, src_n, n, h, w, c, hinv, out, out_h, out_w, s); break;
    default: launch<0>(src, src_n, n, h, w, c, hinv, out, out_h, out_w, s);
  }
  return (int)cudaGetLastError();
}
