// Kernel G, float32 form: one direction of the SepConvGRU's gated update,
// fused, on float32 FFMA.
//
// Replaces no TPU kernel. The JAX package runs its float32 ('highest')
// refinement loop through XLA's convolutions; its fused GRU
// (woft_tpu/ops/pallas/gru.py:fused_gru_update, and csrc/gru.cu here) is a
// bf16 kernel, and a float32 twin on the TPU would have needed 6-pass
// matmuls. On Hopper float32 FFMA is the card's native float32 path, so the
// canonical tracker's GRU (float32, TF32 off) gets its own kernel: it takes
// the place of two cuDNN float32 convolutions and a dozen elementwise
// launches a direction (models/raft.py:_sep_conv_gru).
//
// Function, per pixel p of a (H, W) map, channels minor, along one axis,
// all in float32:
//   z   = sigmoid(conv5(cat(h, x), wz) + bz + pre_z)
//   r   = sigmoid(conv5(cat(h, x), wr) + br + pre_r)
//   rh  = r * h                               zero outside the image
//   q   = tanh(conv5(cat(rh, x), wq) + bq + pre_q)
//   out = (1 - z) * h + z * q
// with conv5 the 5-tap convolution along the axis with zero padding,
// float32 operands, float32 products summed in float32 by FFMA (fmaf: no
// TF32, no bf16, no split-operand tensor-core products), the bias and the
// hoisted context added in float32, sigmoid as 1 / (1 + expf(-v)) with an
// IEEE division and tanh as tanhf (not the fast intrinsics), and the blend
// rounded at each of its four operations (the library is built with
// --fmad=false). models/update.py:gru_update_f32_plain is the same
// arithmetic; only the order of the 1,280 products' sum differs, as it
// does from cuDNN's.
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 5 * 256 * 384
// = 14.16 GFLOP, 0.211 ms at 67 TFLOP/s of float32 FFMA, against 46 MB of
// operands (h, x, pre_zr, pre_q, out and 1.97 MB of taps; 0.014 ms at 3.35
// TB/s): bound by FFMA throughput 15 times over, so the design is a
// register-blocked SIMT implicit GEMM that keeps the FFMA pipes fed.
//
// Design:
// - The lines of the map are laid end to end, each followed by two zero
//   positions, as in the bf16 kernel G: position p = line * (len + 2) + s.
//   One kernel serves both axes, given the pixel strides. A CTA owns 124
//   consecutive output positions and computes z|r on 128 (2 more on each
//   side: q needs r two positions away) from a tile of cat(h, x) over 132
//   positions. At 720p that is 118 CTAs along W and 119 along H, one a SM:
//   one wave on 132 SMs, 3 % of the products halo.
// - The tile is held channel-major in shared memory, [256 channels][132
//   positions] float32 (135 KB), loaded once (a transposing copy, lanes
//   over positions), zero at the zero positions. A tap only shifts the
//   position a product reads, so one row of 20 floats of a channel feeds
//   all five taps of a thread's 16 positions: 5 LDS.128 for 320 FFMA.
// - The taps, [pass z|r|q][256 channels][5 taps][128 outputs] float32
//   (1.97 MB, in L2 after the first CTAs), stream through a two-stage
//   cp.async ring of 16-channel slices (40 KB each), the next slice landing
//   while the current one is multiplied; the ring runs on across the three
//   passes, so a pass's first slice loads during the previous epilogue.
//   L2 -> SM: 1.97 MB a CTA, 232 MB a launch.
// - 256 threads; each holds 16 positions x 4 channels (lanes over the
//   channel groups, so the 8 threads of a quarter-warp read 128 contiguous
//   bytes of taps, no bank conflict, and a warp's window reads are one
//   broadcast). Per tap: 1 LDS.128 of taps for 64 FFMA (8 x 8 blocks took
//   2 and ran no faster). Three 128-channel passes (z, r, q). z waits for
//   the blend in the output buffer (L2), at the CTA's own output positions:
//   the registers stay with the products. r * h overwrites the tile's h
//   half before the q pass, so the q pass reads cat(rh, x) from the same
//   tile.
// - The epilogues are loops over batches of 4 rows, the next batch's
//   operands (pre_zr, pre_q, h, z) loading while the current one is
//   computed. Unrolled over all 64 accumulators they were most of the
//   kernel's code, run once a CTA and stalled on instruction fetch (0.40
//   against 0.37 ms); a row at a time they left each load's latency
//   exposed (0.373 against 0.359 ms).
// - Measured by clock stamps at 720p (cycles a CTA at 1,980 MHz): tile
//   16,000; each pass 205,000-212,000 (80 % of its 164,000 FFMA cycles);
//   the epilogues 17,000, 24,000 and 24,000: 0.359 ms, 39 TFLOP/s, 59 % of
//   the card's float32 peak on 118 of its 132 SMs.
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kC = 128;                 // hidden channels = motion channels
constexpr int kK = 2 * kC;              // input channels: cat(h, x)
constexpr int kTaps = 5;
constexpr int kThreads = 256;
constexpr int kTM = 16;                 // positions a thread
constexpr int kTN = 4;                  // channels a thread: one float4
constexpr int kWin = (kTM + 4) / 4;     // float4s of a channel's window
constexpr int kRows = 128;              // z|r positions of a CTA
constexpr int kGroups = kC / kTN;       // channel groups: lanes run over them
constexpr int kOut = kRows - 4;         // output positions: 124
constexpr int kTile = kRows + 4;        // tile positions: 132
constexpr int kLd = kTile;              // floats a channel row of the tile
constexpr int kKC = 16;                 // input channels a tap slice
constexpr int kSlices = kK / kKC;       // a pass: 16
constexpr int kStageFloats = kKC * kTaps * kC;   // 10,240: 40 KB
constexpr int kStages = 2;
constexpr int kPassFloats = kK * kTaps * kC;     // 163,840
constexpr size_t kSmem =
    (size_t)(kK * kLd + kStages * kStageFloats) * sizeof(float);  // 217,088
static_assert(kLd % 4 == 0, "16-byte aligned channel rows");
static_assert((kRows / kTM) * kGroups == kThreads, "one block a thread");
static_assert(kTM % 4 == 0, "whole float4s");
static_assert(kStageFloats % (4 * kThreads) == 0, "whole 16-byte copies");

struct GruF32Params {
  const float* h;           // (positions' pixels, 128)
  const float* x;           // (pixels, 128)
  const float* pre_zr;      // (pixels, 256)
  const float* pre_q;       // (pixels, 128)
  const float* w;           // [3][256][5][128]
  const float* b;           // [3][128]: bz | br | bq
  float* out;               // (pixels, 128)
  int n_lines, len;         // lines, and positions along the convolution
  int line_stride, pos_stride;  // in pixels
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.f / (1.f + expf(-v));
}

// slice `it` of the three passes' taps into ring stage it % kStages
__device__ __forceinline__ void load_slice(float* ring, const float* w,
                                           int it, int tid) {
  const int pass = it / kSlices, s = it % kSlices;
  const float* src = w + (size_t)pass * kPassFloats +
                     (size_t)s * kStageFloats;
  float* dst = ring + (it % kStages) * kStageFloats;
#pragma unroll
  for (int i = 0; i < kStageFloats / (4 * kThreads); ++i) {
    const int f = 4 * (tid + i * kThreads);
    cp_async_16_zfill(dst + f, src + f, true);
  }
  cp_async_commit();
}

// the kTM + 4 floats tile[c][m .. m + kTM + 3] of a channel row
__device__ __forceinline__ void load_window(float4 (&a)[kWin], const float* p) {
#pragma unroll
  for (int k = 0; k < kWin; ++k) a[k] = *reinterpret_cast<const float4*>(p + 4 * k);
}

// one input channel's products: its five taps (ws: [5][128] at the
// thread's channels) against the window
__device__ __forceinline__ void channel_products(float (&acc)[kTM][kTN],
                                                 const float4 (&w4)[kWin],
                                                 const float* ws) {
  float a[4 * kWin];
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    a[4 * k] = w4[k].x;
    a[4 * k + 1] = w4[k].y;
    a[4 * k + 2] = w4[k].z;
    a[4 * k + 3] = w4[k].w;
  }
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float4 v = *reinterpret_cast<const float4*>(ws + t * kC);
    const float b[kTN] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i + t], b[j], acc[i][j]);
    }
  }
}

// One pass: acc[i][j] = sum over 256 channels and 5 taps of
// tile[c][m + i + t] * W[c][t][n_j], the ring's slices it0 .. it0 + 15.
// Every thread reaches every barrier.
__device__ __forceinline__ void ffma_pass(float (&acc)[kTM][kTN],
                                          const float* tile, float* ring,
                                          const float* w, int it0, int m,
                                          int n, int tid) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  for (int s = 0; s < kSlices; ++s) {
    const int it = it0 + s;
    cp_async_wait<0>();
    __syncthreads();   // slice it landed for all; stage (it + 1) is free
    if (it + 1 < 3 * kSlices) load_slice(ring, w, it + 1, tid);
    const float* ws = ring + (it % kStages) * kStageFloats + n;
    const float* at = tile + (s * kKC) * kLd + m;
    // two register sets of the channel's window alternate: channel c + 1's
    // loads are in flight while channel c's products run
    float4 a0[kWin], a1[kWin];
    load_window(a0, at);
#pragma unroll 1
    for (int c = 0; c < kKC; c += 2) {
      load_window(a1, at + (c + 1) * kLd);
      channel_products(acc, a0, ws + c * kTaps * kC);
      if (c + 2 < kKC) load_window(a0, at + (c + 2) * kLd);
      channel_products(acc, a1, ws + (c + 1) * kTaps * kC);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gru_update_kernel_f32(const __grid_constant__ GruF32Params P) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                   // [256][kLd]: cat(h, x), then rh
  float* ring = smem + kK * kLd;        // [kStages][16][5][128] taps

  const int tid = threadIdx.x;
  // lanes run over the channel groups, so the 8 threads of a quarter-warp
  // read 128 contiguous bytes of taps (no bank conflict) and share their
  // window (a broadcast)
  const int cg = tid % kGroups, pg = tid / kGroups;
  const int m = kTM * pg;               // z|r rows m .. m + kTM - 1
  const int n = kTN * cg;               // channels n .. n + 3

  const int period = P.len + 2;
  const int p0 = blockIdx.x * kOut;     // first output position
  // position p -> pixel; false for a zero position
  auto pixel = [&](int p, size_t& pix) {
    if (p < 0) return false;
    const int line = p / period;
    const int s = p - line * period;
    if (line >= P.n_lines || s >= P.len) return false;
    pix = (size_t)line * P.line_stride + (size_t)s * P.pos_stride;
    return true;
  };

  load_slice(ring, P.w, 0, tid);

  // the tile: column i is position p0 - 4 + i; lanes over positions, so
  // the transposing stores hit 32 banks
  constexpr int kPosQuads = kK / 4;                    // 64 a position
  constexpr int kItems = kTile * kPosQuads;            // 8,448
  constexpr int kBatch = 11;
  static_assert(kItems % (kThreads * kBatch) == 0, "whole batches");
  for (int base = tid; base < kItems; base += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads;
      const int q = idx / kTile, i = idx - q * kTile;
      size_t pix = 0;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pixel(p0 - 4 + i, pix)) {
        v[k] = q < kPosQuads / 2
                   ? ldg4(P.h + pix * kC + 4 * q)
                   : ldg4(P.x + pix * kC + 4 * (q - kPosQuads / 2));
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads;
      const int q = idx / kTile, i = idx - q * kTile;
      float* d = tile + (4 * q) * kLd + i;
      d[0] = v[k].x;
      d[kLd] = v[k].y;
      d[2 * kLd] = v[k].z;
      d[3 * kLd] = v[k].w;
    }
  }
  // (the first pass's barrier makes the tile visible)

  // The epilogues. This thread's z|r row m + i is position p0 - 2 + m + i.
  // Unrolled over the 64 accumulators, their arithmetic (expf, the IEEE
  // division, tanhf) is most of the kernel's code: straight-line code each
  // CTA runs once, waiting on instruction fetch. So each is a loop over
  // batches of kB rows that handles rows 0 .. kB - 1 of acc and then
  // shifts the rows down, the next batch's operands loading meanwhile (a
  // row at a time left each load's latency exposed: a third of an
  // epilogue).
  constexpr int kB = 4;
  static_assert(kTM % kB == 0, "whole batches");
  float acc[kTM][kTN];
  auto shift = [&]() {
#pragma unroll
    for (int i = 0; i + kB < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = acc[i + kB][j];
    }
  };
  // the thread's channels of `map` (`stride` floats a pixel) at the pixels
  // of rows i0 .. i0 + kB - 1, zeros at a zero position; plain loads, since
  // z is read back from the output buffer this kernel writes, where the
  // read-only path is not coherent
  auto fetch = [&](float (&v)[kB][kTN], bool (&in)[kB], const float* map,
                   int stride, int i0) {
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      size_t pix = 0;
      in[k] = pixel(p0 - 2 + m + i0 + k, pix);
      const float4 f =
          in[k] ? *reinterpret_cast<const float4*>(map + pix * stride + n)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      v[k][0] = f.x;
      v[k][1] = f.y;
      v[k][2] = f.z;
      v[k][3] = f.w;
    }
  };
  // output rows 2 .. 125 hold this CTA's output positions
  auto out_row = [&](int i, size_t& pix) {
    return m + i >= 2 && m + i < kRows - 2 && pixel(p0 - 2 + m + i, pix);
  };
  auto store = [&](size_t pix, const float (&o)[kTN]) {
    *reinterpret_cast<float4*>(P.out + pix * kC + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  };
  float bias[kTN];

  // ---- z: waits for the blend in the output buffer (L2), at the output
  // rows only, so the registers stay with the products ----
  ffma_pass(acc, tile, ring, P.w, 0, m, n, tid);
  {
#pragma unroll
    for (int j = 0; j < kTN; ++j) bias[j] = __ldg(P.b + n + j);
    float nxt[kB][kTN];
    bool in_nxt[kB];
    fetch(nxt, in_nxt, P.pre_zr, kK, 0);
#pragma unroll 1
    for (int i0 = 0; i0 < kTM; i0 += kB) {
      float pre[kB][kTN];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) pre[k][j] = nxt[k][j];
      }
      if (i0 + kB < kTM) fetch(nxt, in_nxt, P.pre_zr, kK, i0 + kB);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        float o[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          o[j] = sigmoid_f32(acc[k][j] + bias[j] + pre[k][j]);
        }
        size_t pix = 0;
        if (out_row(i0 + k, pix)) store(pix, o);
      }
      shift();
    }
  }

  // ---- r, then r * h into the tile's h half ----
  ffma_pass(acc, tile, ring, P.w, kSlices, m, n, tid);
  __syncthreads();                      // every warp's reads of h are done
  {
#pragma unroll
    for (int j = 0; j < kTN; ++j) bias[j] = __ldg(P.b + kC + n + j);
    float nxt[kB][kTN];
    bool in_nxt[kB];
    fetch(nxt, in_nxt, P.pre_zr + kC, kK, 0);
#pragma unroll 1
    for (int i0 = 0; i0 < kTM; i0 += kB) {
      float pre[kB][kTN];
      bool in[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        in[k] = in_nxt[k];
#pragma unroll
        for (int j = 0; j < kTN; ++j) pre[k][j] = nxt[k][j];
      }
      if (i0 + kB < kTM) fetch(nxt, in_nxt, P.pre_zr + kC, kK, i0 + kB);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          float* t = tile + (n + j) * kLd + m + i0 + k + 2;
          const float r = sigmoid_f32(acc[k][j] + bias[j] + pre[k][j]);
          *t = in[k] ? r * *t : 0.f;
        }
      }
      shift();
    }
  }
  // (the q pass's first barrier makes rh visible)

  // ---- q and the blend ----
  ffma_pass(acc, tile, ring, P.w, 2 * kSlices, m, n, tid);
  {
#pragma unroll
    for (int j = 0; j < kTN; ++j) bias[j] = __ldg(P.b + 2 * kC + n + j);
    float nxt[3][kB][kTN];              // pre_q, h, z
    bool in_nxt[kB];
    auto fetch3 = [&](int i0) {
      fetch(nxt[0], in_nxt, P.pre_q, kC, i0);
      fetch(nxt[1], in_nxt, P.h, kC, i0);
      fetch(nxt[2], in_nxt, P.out, kC, i0);
    };
    fetch3(0);
#pragma unroll 1
    for (int i0 = 0; i0 < kTM; i0 += kB) {
      float cur[3][kB][kTN];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int k = 0; k < kB; ++k) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) cur[a][k][j] = nxt[a][k][j];
        }
      }
      if (i0 + kB < kTM) fetch3(i0 + kB);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        float o[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float q = tanhf(acc[k][j] + bias[j] + cur[0][k][j]);
          o[j] = (1.f - cur[2][k][j]) * cur[1][k][j] + cur[2][k][j] * q;
        }
        size_t pix = 0;
        if (out_row(i0 + k, pix)) store(pix, o);
      }
      shift();
    }
  }
}

}  // namespace

// One gated update along an axis of a (n_lines x len)-pixel map whose pixel
// (line, s) lies at pixel index line * line_stride + s * pos_stride: for a
// channels-minor (H, W, C) map, along W: n_lines = H, len = W, strides (W,
// 1); along H: n_lines = W, len = H, strides (1, W). h, x, out: float32,
// 128 channels; pre_zr: 256; pre_q: 128; w: [3][256][5][128] float32 taps
// (z, r, q; input channel, tap, output channel); b: [3][128]. All
// contiguous and 16-byte aligned; out must not alias h. Returns
// cudaGetLastError() after the launch.
extern "C" int woft_gru_update_f32(const void* h, const void* x,
                                   const void* pre_zr, const void* pre_q,
                                   const void* w, const void* b, void* out,
                                   int channels, int n_lines, int len,
                                   int line_stride, int pos_stride,
                                   void* stream) {
  if (channels != kC || n_lines < 1 || len < 1 || line_stride < 1 ||
      pos_stride < 1 || (long long)n_lines * (len + 2) > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const GruF32Params P = {static_cast<const float*>(h),
                          static_cast<const float*>(x),
                          static_cast<const float*>(pre_zr),
                          static_cast<const float*>(pre_q),
                          static_cast<const float*>(w),
                          static_cast<const float*>(b),
                          static_cast<float*>(out),
                          n_lines, len, line_stride, pos_stride};
  cudaError_t err = cudaFuncSetAttribute(
      gru_update_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int positions = n_lines * (len + 2);
  gru_update_kernel_f32<<<(positions + kOut - 1) / kOut, kThreads, kSmem,
                          (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
