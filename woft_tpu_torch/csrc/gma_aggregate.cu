// Kernel M: GMA's global motion aggregation with its residual, fused.
//
// GMA (Jiang et al., ICCV 2021; github.com/zacjiang/GMA core/gma.py,
// Aggregate) mixes the motion features of every cell of the 1/8 grid:
//   out  = attn @ v,  attn (N, N) = softmax_j(q_i . k_j / sqrt(128))
//   mf_g = mf + gamma * out
// with one head of 128 channels. In WOFT the flow's first image is the
// template, so attn is template state: models/gma.py builds it once a
// sequence (template_attention) and stores it in bf16, rows summing to 1.
// Each of a flow's 12 iterations then pays one (N x N) @ (N x 128) product,
// which this kernel runs, with the residual and the concatenation the GRU
// reads fused into its epilogue:
//   x[i] = cat(mf[i], bf16(mf[i] + gamma * sum_j attn[i][j] * v[j]))
// bf16 operands, float32 sums, one rounding at the end; mf + gamma * out in
// float32 with no FMA contraction (--fmad=false), as
// models/gma.py:gma_aggregate_plain computes it. The tensor cores add each
// k16 product into the float32 accumulator with truncation, so the sum of
// N terms may drift from the plain version's by up to a float32 ulp of the
// running sum a step (N / 16 steps: ~2.4e-4 of it at 1080p), which the
// bf16 rounding of mf_g hides except where mf + gamma * out cancels.
//
// Replaces no TPU kernel: woft_tpu has no GMA (its update block,
// woft_tpu/models/raft.py, is RAFT's), so nothing computes this function
// there; the port's plain version above is its CPU twin.
//
// Bound on the H100 at 1080p (N = 32,400): 2 N^2 128 = 268.7 GFLOP, 0.272
// ms at 989 TFLOP/s. Reading the stored attention (2.10 GB of bf16) takes
// 0.627 ms at 3.35 TB/s, so this form is bound by HBM; recomputing the
// scores from q and k instead (a flash form) would take twice the products
// and 1.05 G exponentials an iteration.
//
// Design (conv_wgmma.cuh's pieces: TMA, an mbarrier ring, wgmma):
// - A CTA owns 256 rows of attn and all 128 output channels: two consumer
//   warpgroups of two m64 tiles each (128 float32 accumulators a thread),
//   so one wave of ceil(N / 256) = 127 CTAs covers 1080p on 132 SMs and v
//   is read from L2 127 times (1.05 GB) instead of twice that with 128-row
//   CTAs.
// - Both operands come by TMA, K-major with the 128-byte swizzle, into a
//   ring of four 48 KB stages: a [256][64] box of attn and a [128][64] box
//   of v transposed (vt, made by one cuBLAS product beside the kernel:
//   vt = to_v . mf^T). wgmma reads both from shared memory through
//   descriptors (no ldmatrix: nothing shifts a row here, unlike the
//   convolutions). Rows and columns past N come in as zeros (TMA's
//   out-of-bounds fill), so no tile needs a bound check.
// - One producer thread keeps the ring full; the consumer warps hand a
//   stage back once the products that read it are done.
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kD = 128;                          // head width = motion width
constexpr int kWarpgroups = 2;                   // consumers
constexpr int kTiles = 2;                        // m64 tiles a warpgroup
constexpr int kRows = 64 * kTiles * kWarpgroups; // rows of a CTA: 256
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBlock = kConsumers + 128;         // + the producer warpgroup
constexpr int kRing = 4;
constexpr uint32_t kABytes = kRows * kSliceK * 2;   // [256][64] bf16: 32 KB
constexpr uint32_t kBBytes = kD * kSliceK * 2;      // [128][64] bf16: 16 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr size_t kSmem = 1024 + kRing * kStageBytes + 16 * kRing;

struct AggParams {
  CUtensorMap attn;           // [N][N] bf16, boxes of 256 rows x 64
  CUtensorMap vt;             // [128][N] bf16, boxes of 128 rows x 64
  const __nv_bfloat16* mf;    // [N][128]
  const float* gamma;         // [1]
  __nv_bfloat16* out;         // [N][256]: mf | mf_g
  int n;
};

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, float32) += A (64 x 16) * B (128 x 16)^T, both operands in
// shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "n"(1));
}

#undef ACC8

__global__ void __launch_bounds__(kBlock, 1)
gma_aggregate_kernel(const __grid_constant__ AggParams P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Ring ring{base, base + kRing * kStageBytes, kRing, kStageBytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();

  const int row0 = blockIdx.x * kRows;
  const int nk = (P.n + kSliceK - 1) / kSliceK;   // slices of 64 columns

  if (warp >= kConsumers / 32) {
    // ---- producer: attn's rows and vt, 64 columns a stage ----
    regs_down<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kRing;
        mbar_wait(ring.empty(s), ((it / kRing) & 1) ^ 1);
        mbar_expect_tx(ring.full(s), kStageBytes);
        tma_load_2d(ring.stage(s), &P.attn, it * kSliceK, row0, ring.full(s));
        tma_load_2d(ring.stage(s) + kABytes, &P.vt, it * kSliceK, 0,
                    ring.full(s));
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<232>();
  const int wg = tid >> 7;
  float acc[kTiles][64];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int s = it % kRing;
    mbar_wait(ring.full(s), (it / kRing) & 1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t a = ring.stage(s) + wg * (kTiles * 64 * 128);
    const uint32_t b = ring.stage(s) + kABytes;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        wgmma_ss(acc[t], sw128_desc(a + t * 64 * 128 + 32 * k),
                 sw128_desc(b + 32 * k));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (it > 0) {
      // the previous stage's products are done: it goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (lane == 0) mbar_arrive(ring.empty((it - 1) % kRing));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int t = 0; t < kTiles; ++t) keep_acc(acc[t]);

  // ---- epilogue: x[r] = cat(mf[r], bf16(mf[r] + gamma * acc)) ----
  // accumulator acc[t][4 j + 2 h + e]: row 16 (warp % 4) + lane / 4 + 8 h of
  // tile t, channel 8 j + 2 (lane % 4) + e
  const float g = __ldg(P.gamma);
  const int cq = 2 * (lane & 3);
  const int wrow = row0 + wg * (kTiles * 64) + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wrow + t * 64 + 8 * hh;
      if (r >= P.n) continue;
      const __nv_bfloat16* m = P.mf + (size_t)r * kD + cq;
      __nv_bfloat16* o = P.out + (size_t)r * (2 * kD) + cq;
      uint32_t mv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mv[j] = __ldg(reinterpret_cast<const unsigned int*>(m + 8 * j));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&mv[j]));
        const int ai = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(o + 8 * j) = mv[j];
        store_bf16x2(o + kD + 8 * j, f.x + g * acc[t][ai],
                     f.y + g * acc[t][ai + 1]);
      }
    }
  }
}

// The map of a bf16 matrix [outer][inner] whose rows lie `ld` elements
// apart, read in boxes of box_rows x 64 with the 128-byte swizzle; elements
// past `inner` or `outer` read as zeros.
int encode(CUtensorMap* map, const void* ptr, int inner, int outer, int ld,
           int box_rows) {
  EncodeTiled fn;
  const int rc = tap_encoder(&fn);
  if (rc) return rc;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kSliceK, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

}  // namespace

// x = cat(mf, bf16(mf + gamma * attn @ v)) for N cells: attn [N][lda]
// (the first N columns read), vt [128][ldv] (v transposed, the first N
// columns read), both bf16 with lda, ldv >= N multiples of 8 and 16-byte
// aligned rows; mf [N][128] bf16; gamma: one float32 on the device; out
// [N][256] bf16. The tensor maps are encoded at every call (a few
// microseconds on the host; a CUDA graph keeps the ones of its capture).
// Returns cudaGetLastError(), or 10000 + the CUresult of a failed encode,
// or 20000 when the driver has no cuTensorMapEncodeTiled.
extern "C" int woft_gma_aggregate(const void* attn, int lda, const void* vt,
                                  int ldv, const void* mf, const void* gamma,
                                  void* out, int n, void* stream) {
  if (n < 1 || lda < n || ldv < n || lda % 8 || ldv % 8) {
    return (int)cudaErrorInvalidValue;
  }
  AggParams P;
  int rc = encode(&P.attn, attn, n, n, lda, kRows);
  if (rc) return rc;
  if ((rc = encode(&P.vt, vt, n, kD, ldv, kD))) return rc;
  P.mf = static_cast<const __nv_bfloat16*>(mf);
  P.gamma = static_cast<const float*>(gamma);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.n = n;
  cudaError_t err = cudaFuncSetAttribute(
      gma_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  gma_aggregate_kernel<<<(n + kRows - 1) / kRows, kBlock, kSmem,
                         (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
