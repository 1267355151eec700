// Shared device code of the fused update-block kernels (gru.cu: kernel G;
// update_tail.cu: kernels H and I): one pass of a small convolution written
// as a sum of per-tap matrix products on the tensor cores.
//
// A pass computes, for M output rows (pixels) and N output channels,
//     acc[row][n] = sum_tap sum_k A[pos(row) + off(tap)][k] * W[tap][n][k]
// with A a tile of bf16 activations in shared memory, one row of `lda`
// elements per tile position, zero-filled outside the image by whoever
// loaded it, and W the bf16 taps in device memory, channels-in minor. A tap
// only shifts the tile position a row reads, so the 1x5, 5x1 and 3x3
// convolutions of the update block all run through this one function.
//
// The taps do not fit in an SM's shared memory (0.3 to 1.0 MB a convolution),
// so they are streamed from L2 in slices of 32 input channels through a ring
// of two shared-memory buffers filled with cp.async: the next slice arrives
// while the current one is multiplied, with one __syncthreads() a slice.
// Eight warps as WM (rows) x WN (channels), each owning MI m16 x NI n8 tiles
// of m16n8k16 mma.sync: bf16 products are exact in float32 and the
// accumulators are float32. Fragments are read with ldmatrix; every
// activation row is padded by 8 elements (16 bytes), which spreads eight
// consecutive rows over all 32 banks.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace woft {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // input channels of a weight slice
constexpr int kLdB = kBK + 8;  // padded row of the weight slice
constexpr int kStages = 2;     // weight slices in shared memory
constexpr int kPad = 8;        // elements appended to every activation row

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i of a
// thread then holds elements [lane / 4][2 * (lane % 4) .. + 1] of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from device memory straight into shared memory, asynchronously.
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The shape of a pass: WM x WN warps, each MI x NI mma tiles.
template <int MI_, int NI_, int WM_, int WN_>
struct Tile {
  static constexpr int MI = MI_, NI = NI_, WM = WM_, WN = WN_;
  static constexpr int M = WM * MI * 16;   // rows of a pass
  static constexpr int N = WN * NI * 8;    // output channels of a pass
  static_assert(WM * WN * 32 == kThreads, "eight warps");
  static_assert(NI % 2 == 0, "two n8 tiles per ldmatrix");
  static_assert((N * (kBK / 8)) % kThreads == 0, "whole loads per thread");

  static __device__ __forceinline__ int warp_m() {
    return (threadIdx.x >> 5) / WN;
  }
  static __device__ __forceinline__ int warp_n() {
    return (threadIdx.x >> 5) % WN;
  }
  // the row whose tile position this lane hands to ldmatrix for m16 tile mi
  static __device__ __forceinline__ int ldmatrix_row(int mi) {
    return warp_m() * (MI * 16) + mi * 16 + (threadIdx.x & 15);
  }
  // row and first column of accumulator element acc[mi][ni][e]
  static __device__ __forceinline__ int acc_row(int mi, int e) {
    return warp_m() * (MI * 16) + mi * 16 + ((threadIdx.x & 31) >> 2) +
           (e >> 1) * 8;
  }
  static __device__ __forceinline__ int acc_col(int ni) {
    return warp_n() * (NI * 8) + ni * 8 + (threadIdx.x & 3) * 2;
  }
};

// One pass (see the top of the file). Tap `tap` reads tile position
// a_pos + (tap / tap_w) * tap_pitch + tap % tap_w, a_pos[mi] being the
// position of row T::ldmatrix_row(mi). K, the tile's input channels, is a
// multiple of 32; W is [n_taps][T::N][K], 16-byte aligned; Bs holds kStages
// * T::N * kLdB elements. All 256 threads call it; it ends with a
// __syncthreads(), and everything written to shared memory before the call
// is visible to the products.
template <class T>
__device__ __forceinline__ void conv_pass(
    float (&acc)[T::MI][T::NI][4], const __nv_bfloat16* As, int lda,
    const int (&a_pos)[T::MI], int tap_w, int tap_pitch, int n_taps, int K,
    const __nv_bfloat16* __restrict__ W, __nv_bfloat16* Bs) {
  constexpr int MI = T::MI, NI = T::NI, N = T::N;
  constexpr int kLoads = N * (kBK / 8) / kThreads;  // 16-byte loads a thread
  const int t = threadIdx.x;
  const int lane = t & 31;

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int slices = K / kBK;
  const int n_iter = n_taps * slices;
  auto load_slice = [&](int it) {
    const int tap = it / slices;
    const int k0 = (it - tap * slices) * kBK;
    __nv_bfloat16* dst = Bs + (it % kStages) * (N * kLdB);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = t + i * kThreads;
      const int n = idx >> 2, kc = (idx & 3) * 8;
      cp_async_16(dst + n * kLdB + kc,
                  W + ((size_t)tap * N + n) * K + k0 + kc);
    }
  };

  const int a_col = (lane >> 4) * 8;
  const int b_row = T::warp_n() * (NI * 8) + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_slice(s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();     // this thread's part of slice `it`
    __syncthreads();                  // everyone's; and slice it - 1 is spent
    if (it + kStages - 1 < n_iter) load_slice(it + kStages - 1);
    cp_async_commit();
    const int tap = it / slices;
    const int k0 = (it - tap * slices) * kBK;
    const int toff = (tap / tap_w) * tap_pitch + tap % tap_w;
    const __nv_bfloat16* Bt = Bs + (it % kStages) * (N * kLdB);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, Bt + (b_row + nj * 16) * kLdB + kk + b_col);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af,
                    As + (size_t)(a_pos[mi] + toff) * lda + k0 + kk + a_col);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// 8 bf16 channels of one pixel, or zeros when `inside` is false.
__device__ __forceinline__ uint4 load_bf16x8(const __nv_bfloat16* src,
                                             bool inside) {
  return inside ? *reinterpret_cast<const uint4*>(src)
                : make_uint4(0u, 0u, 0u, 0u);
}

// 4 float32 channels of one pixel rounded to bf16, or zeros.
__device__ __forceinline__ uint2 load_f32x4_as_bf16(const float* src,
                                                    bool inside) {
  if (!inside) return make_uint2(0u, 0u);
  const float4 v = *reinterpret_cast<const float4*>(src);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  return packed;
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace woft
