// Shared code of kernels G (gru.cu), H (update_tail.cu) and I
// (flow_head.cu): one pass of a small convolution as a sum of per-tap matrix
// products on Hopper's warpgroup tensor-core instruction, with the taps
// brought in by TMA.
//
// A pass computes, for 64 rows (pixels) a consumer warpgroup and N = 64,
// 128 or 192 output channels,
//     acc[row][n] = sum_tap sum_k A[pos(row) + off(tap)][k] * W[tap][n][k]
// with A a tile of bf16 activations in shared memory (one row of `lda`
// elements a tile position, zero-filled outside the image by whoever loaded
// it) and W the bf16 taps in device memory, input channels minor. A tap only
// shifts the tile position a row reads, so the 1x5, 5x1 and 3x3
// convolutions run through the one function.
//
// - Products: wgmma.mma_async m64nNk16, bf16 operands, float32
//   accumulators in registers (N / 2 a thread: with a 64 x 256 accumulator
//   a block of three warpgroups, capped at 168 registers a thread, spills
//   and ptxas serialises the wgmma, C7512). A comes from registers: each
//   warp loads its 16 rows with ldmatrix at the tap's row offset (the
//   m16k16 fragment that ldmatrix.x4 yields for mma.sync is the one wgmma
//   takes). Taking A from shared memory through a descriptor would need the
//   128-byte swizzle's 8-row phase to survive a shift of one row, which it
//   does not; the rows keep a 16-byte pad instead, so eight consecutive
//   rows cover all 32 banks and ldmatrix is conflict-free. Two register
//   sets of A alternate, so a slice's products run while the next slice's
//   fragments load.
// - Taps (B): K-major boxes of N rows x 64 input channels (128 bytes a
//   row, 128-byte swizzle), one box a (tap, 64-channel slice), loaded by
//   TMA into a ring of stages with a full and an empty mbarrier each. One
//   thread of a producer warpgroup keeps the ring full (the warpgroup gives
//   its registers to the consumers); the consumer warps hand a stage
//   back when its products are done. No barrier of the whole block a
//   slice, and the producer runs ahead across passes and epilogues.
// - The taps do not fit in shared memory (0.6 to 1.0 MB a kernel), so each
//   CTA streams them once from L2; the kernels size their CTAs so that one
//   wave covers the map, which makes the tap traffic (CTAs x tap bytes) as
//   small as one wave allows.
// - Every wgmma of a pass is issued from uniform control flow (ptxas
//   serialises wgmma in divergent code, C7518).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace woft {

constexpr int kPad = 8;       // elements appended to every activation row
constexpr int kSliceK = 64;   // input channels of a tap slice: 128 bytes

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// m16n8k16 on the tensor cores, bf16 operands, float32 accumulators (the
// small products beside a pass: kernel I's second stage)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that never
// ends (a broken pipeline) traps after ~2^26 polls, seconds, instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(bar) : "memory");
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when `inside` is false (the source is then not read).
__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src,
                                                  bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most kPending of this thread's cp.async groups are in
// flight; a barrier after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// `count` float32 quads, rounded to bf16 pairs: quad i is read from src(i)
// (nullptr: zeros) and written to dst(i). `threads` threads, thread t, each
// with kBatch loads in flight before the first store, so the rows' latency
// is paid once a batch and not once a quad.
template <int kBatch, class Src, class Dst>
__device__ __forceinline__ void load_quads_as_bf16(int count, int threads,
                                                   int t, Src src, Dst dst) {
  for (int i0 = t; i0 < count; i0 += kBatch * threads) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * threads;
      const float* p = i < count ? src(i) : nullptr;
      v[k] = p != nullptr ? __ldg(reinterpret_cast<const float4*>(p))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * threads;
      if (i >= count) break;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[k].x, v[k].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[k].z, v[k].w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst(i)) = packed;
    }
  }
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows of 64
// bf16: 8-row groups 1,024 bytes apart (SBO); the leading offset is unused
// for swizzled K-major layouts. Every base is 1,024-byte aligned, so the
// base offset is 0; a K-step of 16 advances the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, float32) (+)= A (64 x 16, registers) * B (N x 16)^T, for N =
// 64, 128 and 192: N / 2 accumulators a thread
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef ACC8

// Keeps the compiler from moving a register across the asynchronous wgmma:
// accumulators after the last wait, A fragments until their products are
// known to be done.
template <int M>
__device__ __forceinline__ void keep_acc(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Warp specialisation: the producer is a whole warpgroup (one thread issues
// the TMA loads) that hands registers to the consumers. ptxas still
// compiles the consumers within the block's launch bound (registers are
// allocated for warps four at a time: 168 a thread for three warpgroups,
// 128 for four), but on the card this layout ran G 2.5 us and I 1 us faster
// than a lone producer warp (tools/torch_kernel_ablate.py, PERF.md).
template <int n>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(n));
}
template <int n>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(n));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The tap ring: `stages` buffers of `stage_bytes` (1,024-byte aligned) and
// a full and an empty mbarrier each. Slice `it` (counted over the whole
// kernel, producer and consumers alike) lives in stage it % stages.
struct Ring {
  uint32_t data, bars;
  int stages;
  uint32_t stage_bytes;
  __device__ uint32_t stage(int s) const { return data + s * stage_bytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }

  // one thread, before the block's first __syncthreads()
  __device__ void init(int consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Producer: slice `it` is the box at (c0, c1) of `map`, `bytes` long.
  __device__ void load(int it, const CUtensorMap* map, int c0, int c1,
                       uint32_t bytes) const {
    const int s = it % stages;
    mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
    mbar_expect_tx(full(s), bytes); tma_load_2d(stage(s), map, c0, c1, full(s));
  }
};

// One pass, called by every thread of the consumer warpgroups: N = 2 * M
// output channels (64, 128 or 192) for the warpgroup's 64 rows. Row `a_row`
// of this lane's ldmatrix (its warp's 16 rows, lane & 15) reads tile
// position a_row + (tap / tap_w) * tap_pitch + tap % tap_w for tap `tap`.
// The pass takes slices it0 .. it0 + n_taps * slices_per_tap - 1 of the
// ring, tap major (an even count), each an [N][64] box of input channels
// 64 * (slice % slices_per_tap) onwards. Accumulator acc[4 j + 2 h + e] is
// row 16 * warp + lane / 4 + 8 h of the warpgroup's 64, channel
// 8 j + 2 (lane % 4) + e.
template <int M>
__device__ __forceinline__ void wgmma_pass(float (&acc)[M],
                                           const __nv_bfloat16* As, int lda,
                                           int a_row, int tap_w, int tap_pitch,
                                           int n_taps, int slices_per_tap,
                                           const Ring& ring, int it0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_base = As + (size_t)a_row * lda + (lane >> 4) * 8;
  const int n = n_taps * slices_per_tap;
  uint32_t a[2][4][4];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = 0.f;

  auto step = [&](auto set, int i) {
    constexpr int S = decltype(set)::value;
    const int tap = i / slices_per_tap;
    const int kc = i - tap * slices_per_tap;
    const int toff = (tap / tap_w) * tap_pitch + tap % tap_w;
    const __nv_bfloat16* src = a_base + (size_t)toff * lda + kc * kSliceK;
#pragma unroll
    for (int k = 0; k < 4; ++k) ldmatrix_x4(a[S][k], src + 16 * k);
    const int it = it0 + i;
    const int s = it % ring.stages;
    mbar_wait(ring.full(s), (it / ring.stages) & 1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t b = ring.stage(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs(acc, a[S][k], sw128_desc(b + 32 * k), (i | k) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (i > 0) {
      // the previous slice's products are done: its stage goes back to the
      // producer and its A registers may be loaded again
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      keep_a(a[S ^ 1]);
      if (lane == 0) mbar_arrive(ring.empty((it - 1) % ring.stages));
    }
  };
  for (int i = 0; i < n; i += 2) {
    step(std::integral_constant<int, 0>(), i);
    step(std::integral_constant<int, 1>(), i + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  keep_a(a[1]);
  keep_acc(acc);
  if (lane == 0) mbar_arrive(ring.empty((it0 + n - 1) % ring.stages));
}

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 20000;   // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10000;       // + the CUresult of the encode

// cuTensorMapEncodeTiled through the runtime: the library links no -lcuda.
inline int tap_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        p == nullptr) {
      return kErrEntryPoint;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// Tensor maps of tap stacks, kept for the last few pointers a call site
// saw (a forward prepares its taps once, so a launch finds its maps here and
// encodes nothing). Each site has fixed shapes, so the pointer is the key.
template <int kEntries>
struct TapMaps {
  const void* ptr[kEntries] = {};
  CUtensorMap map[kEntries];
  int next = 0;

  // The map of the bf16 matrix [rows][K] at `w` (K contiguous), read in
  // boxes of box_rows x 64 with the 128-byte swizzle. Returns 0,
  // 10000 + CUresult or 20000.
  int get(const void* w, int K, int rows, int box_rows,
          const CUtensorMap** out) {
    for (int i = 0; i < kEntries; ++i) {
      if (ptr[i] == w) {
        *out = &map[i];
        return 0;
      }
    }
    EncodeTiled fn;
    int rc = tap_encoder(&fn);
    if (rc) return rc;
    const int i = next;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kSliceK, (cuuint32_t)box_rows};
    const cuuint32_t ones[2] = {1, 1};
    const CUresult r = fn(&map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          const_cast<void*>(w), dims, strides, box, ones,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      ptr[i] = nullptr;
      return kErrEncode + (int)r;
    }
    ptr[i] = w;
    next = (i + 1) % kEntries;
    *out = &map[i];
    return 0;
  }
};

}  // namespace woft
