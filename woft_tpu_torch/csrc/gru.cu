// Kernel G: one direction of the SepConvGRU's gated update, fused.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/gru.py:fused_gru_update
// (pallas_call at :187, reached through sep_conv_gru_pallas). There one launch
// per direction holds all taps in fast memory and tiles the axis the
// convolution does not run along, with zero guard columns padded onto the
// inputs by the caller. The two launches differ only in which dimension is
// tiled; here one kernel serves both, given the pixel strides of "along the
// convolution" and "across it".
//
// Function, per pixel p of a (H, W) map, channels minor, along one axis:
//   zr  = bf16(conv5(cat(bf16(h), x), wzr) + bzr) + pre_zr       (bf16 add)
//   z|r = bf16(sigmoid(float(zr)))                                128 | 128
//   rh  = bf16(r * h)                         zero outside the image
//   q   = bf16(tanh(float(bf16(conv5(cat(rh, x), wq) + bq) + pre_q)))
//   out = float(bf16(1 - z)) * h + float(bf16(z * q))             float32
// with conv5 the 5-tap convolution along the axis with zero padding, bf16
// operands, float32 accumulation and float32 bias. h and out are float32,
// x, pre_zr, pre_q and the taps bf16. These are the rounding points of the
// TPU kernel (gru.py:104-126) and of models/update.py:gru_update_plain.
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 5 * 256 * 384
// = 14.2 GFLOP, 0.014 ms at 989 TFLOP/s, against 30 MB of operands (0.009
// ms at 3.35 TB/s): operations-bound.
//
// Design: a CUDA block owns 2 lines x 36 positions of output. r is needed 2
// positions beyond the output on each side, so the block computes z|r on 40
// positions a line (80 rows a pass) from a 44-position tile of cat(bf16(h),
// x) read with bounds checks (zeros outside the image: the convolution's
// padding, no padded copies). The gate epilogue writes z to shared memory
// and overwrites the tile's h half with r * h, zero where the position lies
// outside the image, so the second convolution reads cat(rh, x) from the
// same tile; its 80 rows include 4 a line whose result is dropped. 11 % of
// the z|r products and 10 % of the q products are recomputed halo. The tile
// is sized for the 132 SMs, two blocks each: 225 blocks along W and 240
// along H at 720p run in one round, where 64-row tiles (270 and 320 blocks)
// left a second, nearly empty round. Each of the eight warps owns all 80
// rows and an eighth of the output channels. The taps stream from L2 (see
// conv_mma.cuh). sigmoid and tanh use expf and tanhf, not the fast
// intrinsics: the gates are rounded to bf16 and must round as the plain
// version's do. The plain version sums the products in another order, so a
// rounding to bf16 may fall the other way on a small share of entries.
#include "conv_mma.cuh"

namespace {

using namespace woft;

constexpr int kC = 128;               // hidden channels = motion channels
using GateTile = Tile<5, 4, 1, 8>;    // z|r: 80 rows x 256 channels
using CandTile = Tile<5, 2, 1, 8>;    // q:   80 rows x 128 channels
constexpr int kRows = GateTile::M;    // rows of a pass
constexpr int kLines = 2;             // lines of a block
constexpr int kMid = kRows / kLines;  // positions a line with z|r: 40
constexpr int kOut = kMid - 4;        // positions a line with output: 36
constexpr int kIn = kMid + 4;         // positions a line in the input tile: 44
constexpr int kLdA = 2 * kC + kPad;   // row of the input tile
constexpr int kLdZ = kC + kPad;       // row of the z tile
constexpr int kSmemElems =
    kLines * kIn * kLdA + kStages * 2 * kC * kLdB + kRows * kLdZ;
static_assert(GateTile::N == 2 * kC && CandTile::N == kC &&
              CandTile::M == kRows, "tile shapes");

struct GruArgs {
  const float* h;
  const __nv_bfloat16* x;
  const __nv_bfloat16* pre_zr;
  const __nv_bfloat16* pre_q;
  const __nv_bfloat16* wzr;   // [5][256][256]: tap, z|r channel, cat(h, x)
  const __nv_bfloat16* wq;    // [5][128][256]
  const float* bzr;
  const float* bq;
  float* out;
  int n_lines, len;           // lines, and positions along the convolution
  int line_stride, pos_stride;  // in pixels
};

__global__ void __launch_bounds__(kThreads, 2)
gru_update_kernel(const GruArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kLines * kIn * kLdA;
  __nv_bfloat16* Zs = Bs + kStages * 2 * kC * kLdB;

  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kOut;       // first output position
  const int line0 = blockIdx.y * kLines;

  auto pixel = [&](int line, int s) {
    return (size_t)line * a.line_stride + (size_t)s * a.pos_stride;
  };

  // the tile: position i of line l is image position s0 - 4 + i
  for (int idx = t; idx < kLines * kIn * (kC / 4); idx += kThreads) {
    const int p = idx / (kC / 4), c = (idx % (kC / 4)) * 4;
    const int l = p / kIn, s = s0 - 4 + p % kIn;
    const bool inside = line0 + l < a.n_lines && s >= 0 && s < a.len;
    *reinterpret_cast<uint2*>(As + p * kLdA + c) = load_f32x4_as_bf16(
        inside ? a.h + pixel(line0 + l, s) * kC + c : a.h, inside);
  }
  for (int idx = t; idx < kLines * kIn * (kC / 8); idx += kThreads) {
    const int p = idx / (kC / 8), c = (idx % (kC / 8)) * 8;
    const int l = p / kIn, s = s0 - 4 + p % kIn;
    const bool inside = line0 + l < a.n_lines && s >= 0 && s < a.len;
    *reinterpret_cast<uint4*>(As + p * kLdA + kC + c) = load_bf16x8(
        inside ? a.x + pixel(line0 + l, s) * kC + c : a.x, inside);
  }

  // row of a pass -> (line, j): z|r position j of the line is image
  // position s0 - 2 + j and tile position j + 2; tap t reads j + t
  int a_pos[GateTile::MI];
#pragma unroll
  for (int mi = 0; mi < GateTile::MI; ++mi) {
    const int row = GateTile::ldmatrix_row(mi);
    a_pos[mi] = (row / kMid) * kIn + row % kMid;
  }

  {
    float acc[GateTile::MI][GateTile::NI][4];
    conv_pass<GateTile>(acc, As, kLdA, a_pos, 5, 0, 5, 2 * kC, a.wzr, Bs);
#pragma unroll
    for (int mi = 0; mi < GateTile::MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = GateTile::acc_row(mi, 2 * half);
        const int l = row / kMid, j = row % kMid;
        const int s = s0 - 2 + j;
        const bool inside = line0 + l < a.n_lines && s >= 0 && s < a.len;
        const size_t pix = inside ? pixel(line0 + l, s) : 0;
#pragma unroll
        for (int ni = 0; ni < GateTile::NI; ++ni) {
          const int col = GateTile::acc_col(ni);
          float g[2] = {0.f, 0.f};
          if (inside) {
            const __nv_bfloat162 pre = *reinterpret_cast<const __nv_bfloat162*>(
                a.pre_zr + pix * (2 * kC) + col);
            const float pre_f[2] = {__low2float(pre), __high2float(pre)};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = round_bf16(acc[mi][ni][2 * half + e] + a.bzr[col + e]);
              v = round_bf16(v + pre_f[e]);
              g[e] = round_bf16(1.f / (1.f + expf(-v)));
            }
          }
          if (col < kC) {          // z: kept for the blend
            store_bf16x2(Zs + row * kLdZ + col, g[0], g[1]);
          } else {                 // r: r * h replaces h in the tile
            float rh[2] = {0.f, 0.f};
            if (inside) {
              const float2 hv = *reinterpret_cast<const float2*>(
                  a.h + pix * kC + col - kC);
              rh[0] = g[0] * hv.x;
              rh[1] = g[1] * hv.y;
            }
            store_bf16x2(As + (l * kIn + j + 2) * kLdA + col - kC, rh[0],
                         rh[1]);
          }
        }
      }
    }
  }

  {
    float acc[CandTile::MI][CandTile::NI][4];
    conv_pass<CandTile>(acc, As, kLdA, a_pos, 5, 0, 5, 2 * kC, a.wq, Bs);
#pragma unroll
    for (int mi = 0; mi < CandTile::MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = CandTile::acc_row(mi, 2 * half);
        const int l = row / kMid, j = row % kMid;
        const int s = s0 - 2 + j;
        if (j < 2 || j >= kMid - 2 || s >= a.len || line0 + l >= a.n_lines) {
          continue;
        }
        const size_t pix = pixel(line0 + l, s);
#pragma unroll
        for (int ni = 0; ni < CandTile::NI; ++ni) {
          const int col = CandTile::acc_col(ni);
          const __nv_bfloat162 pre = *reinterpret_cast<const __nv_bfloat162*>(
              a.pre_q + pix * kC + col);
          const __nv_bfloat162 zz =
              *reinterpret_cast<const __nv_bfloat162*>(Zs + row * kLdZ + col);
          const float2 hv =
              *reinterpret_cast<const float2*>(a.h + pix * kC + col);
          const float pre_f[2] = {__low2float(pre), __high2float(pre)};
          const float z[2] = {__low2float(zz), __high2float(zz)};
          const float hf[2] = {hv.x, hv.y};
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float q = round_bf16(acc[mi][ni][2 * half + e] + a.bq[col + e]);
            q = round_bf16(q + pre_f[e]);
            q = round_bf16(tanhf(q));
            const float keep = round_bf16(1.f - z[e]) * hf[e];
            o[e] = keep + round_bf16(z[e] * q);
          }
          *reinterpret_cast<float2*>(a.out + pix * kC + col) =
              make_float2(o[0], o[1]);
        }
      }
    }
  }
}

}  // namespace

// One gated update along an axis of a (n_lines x len)-pixel map whose pixel
// (line, s) lies at pixel index line * line_stride + s * pos_stride: for a
// channels-minor (H, W, C) map, along W: n_lines = H, len = W, strides (W,
// 1); along H: n_lines = W, len = H, strides (1, W). h, out: float32, 128
// channels; x, pre_q: bf16, 128; pre_zr: bf16, 256; wzr [5][256][256] and wq
// [5][128][256] bf16, input channels minor; bzr (256), bq (128) float32. All
// contiguous and 16-byte aligned; out must not alias h. Returns
// cudaGetLastError().
extern "C" int woft_gru_update(const void* h, const void* x,
                               const void* pre_zr, const void* pre_q,
                               const void* wzr, const void* wq,
                               const void* bzr, const void* bq, void* out,
                               int channels, int n_lines, int len,
                               int line_stride, int pos_stride, void* stream) {
  if (channels != kC || n_lines < 1 || len < 1 || line_stride < 1 ||
      pos_stride < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const GruArgs a = {static_cast<const float*>(h),
                     static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(pre_zr),
                     static_cast<const __nv_bfloat16*>(pre_q),
                     static_cast<const __nv_bfloat16*>(wzr),
                     static_cast<const __nv_bfloat16*>(wq),
                     static_cast<const float*>(bzr),
                     static_cast<const float*>(bq),
                     static_cast<float*>(out),
                     n_lines, len, line_stride, pos_stride};
  constexpr int smem = kSmemElems * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      gru_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((len + kOut - 1) / kOut),
                  (unsigned)((n_lines + kLines - 1) / kLines));
  gru_update_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
