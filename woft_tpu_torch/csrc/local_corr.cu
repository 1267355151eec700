// Kernel C: construction of one level of the block-local correlation
// volume, queries minor.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/local_corr.py:
// block_local_corr -> _corr_pallas (pallas_call at :135) in its p_major
// form. There each grid step owns one (8, 16) query block, copies the
// block's window of the zero-padded target features into fast memory with
// one DMA (origin (by*sh, (bx*sw)//8*8): the x-origin is a multiple of 8
// because the DMA must be tile-aligned) and multiplies it with the block's
// 128 query features on the matrix unit.
//
// Function: out[b, py, px, q] = scale * sum_d win_b[py, px, d] * f1b[b, q, d]
// with win_b[py, px] = f2[by*sh - pad + py, (bx*sw)//8*8 - pad + px] and zero
// outside the level, b = by*nbw + bx, float32 accumulation, one rounding to
// the output type. The quantised x-origin is part of the function (it
// decides where a far-off lookup saturates), so it is kept.
//
// Bound on the H100 at 720p (120 blocks, D = 256, windows of 3,200 / 1,200 /
// 704 / 672 positions): 2 * 120 * 128 * 256 * 5,776 = 45.4 GFLOP a flow.
// In bf16 the stored volume (177 MB written, 53 us at 3.35 TB/s) outweighs
// the product at the tensor cores' 989 TFLOP/s (46 us): bytes-bound. In
// float32 (67 TFLOP/s outside the tensor cores) the product bounds it:
// 0.68 ms.
//
// Design: the product is computed here, in the kernel's own body. A CUDA
// block owns a 128-position x 128-query tile of one query block: the window
// is read straight from the UNPADDED level with bounds checks (exact zeros
// outside, no padded copy of the level), 16 bytes a thread, prefetched into
// registers while the previous K-slice is multiplied from shared memory.
//   bf16: eight warps as 4 x 2, each a 32 x 64 sub-tile of m16n8k16
//   mma.sync tensor-core tiles (bf16 products are exact in float32, the
//   accumulators are float32); the tile is staged through shared memory so
//   that the volume is written with coalesced 16-byte stores.
//   float32: 8 x 8 outputs a thread with explicit fmaf from transposed
//   shared-memory slices (no tensor cores: TF32 would round the features).
// The sum runs in another order than the plain version's einsum
// (models/corr.py:block_local_corr_plain), so the two agree to float32
// accumulation error (about 1e-5 relative) and, after rounding to bf16, to
// one bf16 ulp on a small share of entries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // window positions per tile
constexpr int kBN = 128;      // queries per block (bq)
constexpr int kThreads = 256;

struct Geometry {
  int D, hl, wl, pad, sh, sw, wh, ww, nbw;
  float scale;
};

// Source row of window position p of query block b, or nullptr when the
// position lies in the zero padding or beyond the window.
template <typename T>
__device__ __forceinline__ const T* window_row(const T* f2, const Geometry& g,
                                               int b, int p) {
  if (p >= g.wh * g.ww) return nullptr;
  const int by = b / g.nbw;
  const int bx = b - by * g.nbw;
  const int py = p / g.ww;
  const int y = by * g.sh - g.pad + py;
  const int x = (bx * g.sw) / 8 * 8 - g.pad + (p - py * g.ww);
  if (y < 0 || y >= g.hl || x < 0 || x >= g.wl) return nullptr;
  return f2 + ((size_t)y * g.wl + x) * g.D;
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kBKh = 32;               // K-slice, bf16 elements
constexpr int kLdh = kBKh + 8;         // padded row: conflict-free fragments
constexpr int kLdc = kBN + 8;          // padded row of the staged tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
local_corr_bf16_kernel(const __nv_bfloat16* __restrict__ f1b,
                       const __nv_bfloat16* __restrict__ f2,
                       __nv_bfloat16* __restrict__ out, const Geometry g) {
  // K-slices of the window (A) and the queries (B); reused for the output
  // tile after the K loop
  __shared__ __align__(16) __nv_bfloat16 smem[kBM * kLdc];
  __nv_bfloat16* As = smem;                    // [kBM][kLdh]
  __nv_bfloat16* Bs = smem + kBM * kLdh;       // [kBN][kLdh]

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kBM;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int wm = warp >> 1, wn = warp & 1;     // 4 x 2 warps
  const int grp = lane >> 2, tg = lane & 3;

  // loader: rows lr and lr + 64, 8 elements at column lc
  const int lr = t >> 2, lc = (t & 3) * 8;
  const __nv_bfloat16* a_src[2];
  const __nv_bfloat16* b_src[2];
  for (int h = 0; h < 2; ++h) {
    a_src[h] = window_row(f2, g, b, p0 + lr + 64 * h);
    b_src[h] = f1b + ((size_t)b * kBN + lr + 64 * h) * g.D;
  }
  uint4 a_reg[2], b_reg[2];
  auto fetch = [&](int k0) {
    for (int h = 0; h < 2; ++h) {
      a_reg[h] = a_src[h] != nullptr
                     ? *reinterpret_cast<const uint4*>(a_src[h] + k0 + lc)
                     : make_uint4(0u, 0u, 0u, 0u);
      b_reg[h] = *reinterpret_cast<const uint4*>(b_src[h] + k0 + lc);
    }
  };

  float acc[2][8][4];
  for (int mi = 0; mi < 2; ++mi)
    for (int ni = 0; ni < 8; ++ni)
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < g.D; k0 += kBKh) {
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint4*>(As + (lr + 64 * h) * kLdh + lc) = a_reg[h];
      *reinterpret_cast<uint4*>(Bs + (lr + 64 * h) * kLdh + lc) = b_reg[h];
    }
    __syncthreads();
    if (k0 + kBKh < g.D) fetch(k0 + kBKh);
#pragma unroll
    for (int kk = 0; kk < kBKh; kk += 16) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* base =
            As + (wm * 32 + mi * 16 + grp) * kLdh + kk + tg * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLdh);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLdh + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const __nv_bfloat16* base =
            Bs + (wn * 64 + ni * 8 + grp) * kLdh + kk + tg * 2;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // stage the scaled, rounded tile: Cs[position][query]
  __nv_bfloat16* Cs = smem;                    // [kBM][kLdc]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int r = wm * 32 + mi * 16 + grp;
      const int c = wn * 64 + ni * 8 + tg * 2;
      *reinterpret_cast<__nv_bfloat162*>(Cs + r * kLdc + c) =
          __floats2bfloat162_rn(acc[mi][ni][0] * g.scale,
                                acc[mi][ni][1] * g.scale);
      *reinterpret_cast<__nv_bfloat162*>(Cs + (r + 8) * kLdc + c) =
          __floats2bfloat162_rn(acc[mi][ni][2] * g.scale,
                                acc[mi][ni][3] * g.scale);
    }
  }
  __syncthreads();
  const int np = g.wh * g.ww;
  __nv_bfloat16* out_b = out + (size_t)b * np * kBN;
  // 16 chunks of 8 queries a row: consecutive threads, consecutive chunks
  for (int c = t; c < kBM * (kBN / 8); c += kThreads) {
    const int r = c >> 4, col = (c & 15) * 8;
    if (p0 + r < np) {
      *reinterpret_cast<uint4*>(out_b + (size_t)(p0 + r) * kBN + col) =
          *reinterpret_cast<const uint4*>(Cs + r * kLdc + col);
    }
  }
}

// ------------------------------------------------------------- float32 ----

constexpr int kBKf = 16;               // K-slice, float32 elements
constexpr int kLdf = kBM + 4;          // padded, keeps float4 alignment

__global__ void __launch_bounds__(kThreads)
local_corr_f32_kernel(const float* __restrict__ f1b,
                      const float* __restrict__ f2, float* __restrict__ out,
                      const Geometry g) {
  __shared__ __align__(16) float As[kBKf][kLdf];   // [d][position]
  __shared__ __align__(16) float Bs[kBKf][kLdf];   // [d][query]

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kBM;
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;              // 16 x 16 threads

  // loader: row lr, 8 elements at column lc
  const int lr = t >> 1, lc = (t & 1) * 8;
  const float* a_src = window_row(f2, g, b, p0 + lr);
  const float* b_src = f1b + ((size_t)b * kBN + lr) * g.D;
  float4 a_reg[2], b_reg[2];
  auto fetch = [&](int k0) {
    for (int h = 0; h < 2; ++h) {
      a_reg[h] = a_src != nullptr
                     ? *reinterpret_cast<const float4*>(a_src + k0 + lc + 4 * h)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      b_reg[h] = *reinterpret_cast<const float4*>(b_src + k0 + lc + 4 * h);
    }
  };

  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < g.D; k0 += kBKf) {
    for (int h = 0; h < 2; ++h) {
      const int d = lc + 4 * h;
      As[d + 0][lr] = a_reg[h].x;
      As[d + 1][lr] = a_reg[h].y;
      As[d + 2][lr] = a_reg[h].z;
      As[d + 3][lr] = a_reg[h].w;
      Bs[d + 0][lr] = b_reg[h].x;
      Bs[d + 1][lr] = b_reg[h].y;
      Bs[d + 2][lr] = b_reg[h].z;
      Bs[d + 3][lr] = b_reg[h].w;
    }
    __syncthreads();
    if (k0 + kBKf < g.D) fetch(k0 + kBKf);
#pragma unroll
    for (int kk = 0; kk < kBKf; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float q[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], q[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int np = g.wh * g.ww;
  float* out_b = out + (size_t)b * np * kBN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = p0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r < np) {
      float* row = out_b + (size_t)r * kBN;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[i][0] * g.scale, acc[i][1] * g.scale,
                      acc[i][2] * g.scale, acc[i][3] * g.scale);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) =
          make_float4(acc[i][4] * g.scale, acc[i][5] * g.scale,
                      acc[i][6] * g.scale, acc[i][7] * g.scale);
    }
  }
}

}  // namespace

// f1b (nb, 128, D) blocked query features; f2 (hl, wl, D) unpadded level;
// out (nb, wh, ww, 128); all of one element type, bfloat16 when is_bf16
// else float32; contiguous and 16-byte aligned; D a multiple of 32.
// nb = nbh * nbw query blocks; window b starts at (by*sh - pad,
// (bx*sw)//8*8 - pad) of the level. Returns cudaGetLastError().
extern "C" int woft_local_corr(const void* f1b, const void* f2, void* out,
                               int nb, int bq, int D, int hl, int wl, int pad,
                               int sh, int sw, int wh, int ww, int nbw,
                               float scale, int is_bf16, void* stream) {
  if (bq != kBN || D < 32 || D % 32 != 0 || nb < 1 || nbw < 1 || wh < 1 ||
      ww < 1 || hl < 1 || wl < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g = {D, hl, wl, pad, sh, sw, wh, ww, nbw, scale};
  const dim3 grid((unsigned)((wh * ww + kBM - 1) / kBM), (unsigned)nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    local_corr_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f1b),
        static_cast<const __nv_bfloat16*>(f2),
        static_cast<__nv_bfloat16*>(out), g);
  } else {
    local_corr_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(f1b), static_cast<const float*>(f2),
        static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
