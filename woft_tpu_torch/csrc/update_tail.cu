// Kernel H: the motion encoder's chain of 3x3 convolutions, fused.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/update_tail.py:
// motion_encoder_pallas (pallas_call at :228):
//   cor2 = relu(bf16(conv3(cor1, wc2) + bc2))             256 -> 192
//   flo2 = relu(bf16(conv3(flo1, wf2) + bf2))             128 -> 64
//   out  = relu(bf16(conv3(cat(cor2, flo2), wcv) + bcv))  256 -> 126
//   result = cat(out, bf16(flow))                         128 channels, bf16
// conv3 is the 3x3 convolution with zero padding, bf16 operands, float32
// accumulation, float32 bias. The second convolution's zero padding applies
// to the first stage's ACTIVATIONS: outside the image cor2 and flo2 are
// zero, not relu(bias). There a grid step owns a band of rows, copies it
// with a 2-row halo by DMA from zero-padded inputs, keeps all taps in fast
// memory and pads the 126-channel result to 128 lanes. None of that is
// carried over. (The same file's second form, flow_head_pallas, is kernel
// I in flow_head.cu.)
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 9 * (256 * 192
// + 128 * 64 + 256 * 126) = 23.2 GFLOP, 0.024 ms at 989 TFLOP/s, against
// 16 MB (0.005 ms): operations-bound.
//
// Design: a CUDA block owns a 6 x 6 tile of output pixels. The first stage
// is computed on the 8 x 8 region around it (64 rows, the tile of conv_pass)
// from a 10 x 10 input tile read with bounds checks (zeros outside the
// image, no padded copy); one device function, stage1(), serves both
// first-stage convolutions: product, float32 bias, one rounding to bf16,
// relu, zero outside the image, into a shared-memory tile. The second stage
// is one more conv_pass over that tile (its rows 36..63 are dropped) and
// writes the 126 channels and bf16(flow) into lanes 126-127 itself. 44 % of
// the first stage's rows are halo recomputed by a neighbouring block: the
// price of a tile small enough for the two input tiles and the stage-1 tile
// to share an SM's shared memory. The plain version (models/update.py) sums
// the products in another order, so a rounding to bf16 may fall the other
// way on a small share of entries.
#include "conv_mma.cuh"

namespace {

using namespace woft;

constexpr int kOutT = 6;               // output tile: 6 x 6 pixels
constexpr int kReg = kOutT + 2;        // stage-1 region: 8 x 8 = kTileM
constexpr int kInT = kOutT + 4;        // input tile: 10 x 10
constexpr int kLdS = 256 + kPad;       // row of the stage-1 tile (256 channels)
constexpr int kTileM = kReg * kReg;    // the stage-1 region is one pass
template <int N>                       // 64 rows x N channels, 2 x 4 warps
using Pass = Tile<2, N / 32, 2, 4>;
static_assert(Pass<64>::M == kTileM, "the stage-1 region is one pass");

// relu(bf16(conv3(tile) + bias)) on the stage-1 region, zero outside the
// (H, W) image, into channels [c0, c0 + N) of the stage-1 tile S1.
// Region pixel (ry, rx) is image pixel (y0 - 1 + ry, x0 - 1 + rx) and reads
// input-tile positions (ry + ky) * 10 + rx + kx.
template <int N>
__device__ __forceinline__ void stage1(const __nv_bfloat16* tile, int ld,
                                       int K, const __nv_bfloat16* W,
                                       const float* bias, __nv_bfloat16* Bs,
                                       __nv_bfloat16* S1, int c0, int y0,
                                       int x0, int H, int Wd) {
  using T = Pass<N>;
  int a_pos[T::MI];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
    const int row = T::ldmatrix_row(mi);
    a_pos[mi] = (row / kReg) * kInT + row % kReg;
  }
  float acc[T::MI][T::NI][4];
  conv_pass<T>(acc, tile, ld, a_pos, 3, kInT, 9, K, W, Bs);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = T::acc_row(mi, 2 * half);
      const int y = y0 - 1 + row / kReg, x = x0 - 1 + row % kReg;
      const bool inside = y >= 0 && y < H && x >= 0 && x < Wd;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = T::acc_col(ni);
        float v[2] = {0.f, 0.f};
        if (inside) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = fmaxf(
                round_bf16(acc[mi][ni][2 * half + e] + bias[col + e]), 0.f);
          }
        }
        store_bf16x2(S1 + row * kLdS + c0 + col, v[0], v[1]);
      }
    }
  }
}

// Input tile of C bf16 channels: position (iy, ix) is image pixel
// (y0 - 2 + iy, x0 - 2 + ix).
template <int C>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile,
                                               const __nv_bfloat16* src,
                                               int y0, int x0, int H, int Wd) {
  constexpr int kLd = C + kPad;
  for (int idx = threadIdx.x; idx < kInT * kInT * (C / 8); idx += kThreads) {
    const int p = idx / (C / 8), c = (idx % (C / 8)) * 8;
    const int y = y0 - 2 + p / kInT, x = x0 - 2 + p % kInT;
    const bool inside = y >= 0 && y < H && x >= 0 && x < Wd;
    *reinterpret_cast<uint4*>(tile + p * kLd + c) = load_bf16x8(
        inside ? src + ((size_t)y * Wd + x) * C + c : src, inside);
  }
}

// ------------------------------------------------------------ kernel H ----

constexpr int kCor = 256, kFlo = 128, kCor2 = 192, kFlo2 = 64, kMotion = 128;
constexpr int kLdCor = kCor + kPad, kLdFlo = kFlo + kPad;
constexpr int kSmemElemsH = kInT * kInT * (kLdCor + kLdFlo) +
                            kTileM * kLdS + kStages * kCor2 * kLdB;

struct MotionArgs {
  const __nv_bfloat16* cor1;
  const __nv_bfloat16* flo1;
  const float* flow;
  const __nv_bfloat16* wc2;   // [9][192][256]
  const __nv_bfloat16* wf2;   // [9][64][128]
  const __nv_bfloat16* wcv;   // [9][128][256], output rows 126, 127 zero
  const float* bc2;
  const float* bf2;
  const float* bcv;           // 128, entries 126, 127 unused
  __nv_bfloat16* out;
  int H, W;
};

__global__ void __launch_bounds__(kThreads)
motion_encoder_tail_kernel(const MotionArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* cor = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* flo = cor + kInT * kInT * kLdCor;
  __nv_bfloat16* S1 = flo + kInT * kInT * kLdFlo;
  __nv_bfloat16* Bs = S1 + kTileM * kLdS;

  const int y0 = blockIdx.y * kOutT, x0 = blockIdx.x * kOutT;
  load_tile_bf16<kCor>(cor, a.cor1, y0, x0, a.H, a.W);
  load_tile_bf16<kFlo>(flo, a.flo1, y0, x0, a.H, a.W);

  stage1<kCor2>(cor, kLdCor, kCor, a.wc2, a.bc2, Bs, S1, 0, y0, x0, a.H, a.W);
  stage1<kFlo2>(flo, kLdFlo, kFlo, a.wf2, a.bf2, Bs, S1, kCor2, y0, x0, a.H,
                a.W);

  // second stage: output pixel (oy, ox) of the tile is region position
  // (oy + 1, ox + 1) and reads region positions (oy + ky) * 8 + ox + kx
  using T = Pass<kMotion>;
  int a_pos[T::MI];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
    const int row = T::ldmatrix_row(mi);
    a_pos[mi] = row < kOutT * kOutT ? (row / kOutT) * kReg + row % kOutT : 0;
  }
  float acc[T::MI][T::NI][4];
  conv_pass<T>(acc, S1, kLdS, a_pos, 3, kReg, 9, kCor2 + kFlo2, a.wcv, Bs);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = T::acc_row(mi, 2 * half);
      const int y = y0 + row / kOutT, x = x0 + row % kOutT;
      if (row >= kOutT * kOutT || y >= a.H || x >= a.W) continue;
      const size_t pix = (size_t)y * a.W + x;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = T::acc_col(ni);
        float v[2];
        if (col < kMotion - 2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = fmaxf(
                round_bf16(acc[mi][ni][2 * half + e] + a.bcv[col + e]), 0.f);
          }
        } else {                 // lanes 126, 127: the flow itself
          v[0] = a.flow[pix * 2];
          v[1] = a.flow[pix * 2 + 1];
        }
        store_bf16x2(a.out + pix * kMotion + col, v[0], v[1]);
      }
    }
  }
}

}  // namespace

// Kernel H. cor1 (H, W, 256), flo1 (H, W, 128) bf16 and flow (H, W, 2)
// float32, channels minor; wc2 [9][192][256], wf2 [9][64][128], wcv
// [9][128][256] (output rows 126 and 127 zero) bf16, input channels minor;
// bc2 (192), bf2 (64), bcv (128) float32; out (H, W, 128) bf16. All
// contiguous and 16-byte aligned. Returns cudaGetLastError().
extern "C" int woft_motion_encoder_tail(
    const void* cor1, const void* flo1, const void* flow, const void* wc2,
    const void* bc2, const void* wf2, const void* bf2, const void* wcv,
    const void* bcv, void* out, int H, int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const MotionArgs a = {static_cast<const __nv_bfloat16*>(cor1),
                        static_cast<const __nv_bfloat16*>(flo1),
                        static_cast<const float*>(flow),
                        static_cast<const __nv_bfloat16*>(wc2),
                        static_cast<const __nv_bfloat16*>(wf2),
                        static_cast<const __nv_bfloat16*>(wcv),
                        static_cast<const float*>(bc2),
                        static_cast<const float*>(bf2),
                        static_cast<const float*>(bcv),
                        static_cast<__nv_bfloat16*>(out), H, W};
  constexpr int smem = kSmemElemsH * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      motion_encoder_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kOutT - 1) / kOutT),
                  (unsigned)((H + kOutT - 1) / kOutT));
  motion_encoder_tail_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
