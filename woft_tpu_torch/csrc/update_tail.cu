// Kernel H: the motion encoder's chain of 3x3 convolutions, in two launches.
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
// I in flow_head.cu.) These are models/update.py's
// motion_encoder_stage1_plain and motion_encoder_stage2_plain.
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 9 * (256 * 192
// + 128 * 64 + 256 * 126) = 23.2 GFLOP, 0.024 ms at 989 TFLOP/s, against
// 16 MB (0.005 ms): operations-bound.
//
// Design (both stages are conv_wgmma.cuh's pass: wgmma products, TMA-fed
// taps through an mbarrier ring, a producer warpgroup):
// - Two launches through L2, no stage-1 row computed twice. Stage 1 writes
//   cat(cor2, flo2) as one (H, W, 256) bf16 map (7.4 MB at 720p, which
//   stays in the 50 MB L2), stage 2 convolves it. One launch would hold a
//   stage-1 tile beside its input tiles: for 8 x 16 outputs the 10 x 18
//   stage-1 region (95 KB) and the 12 x 20 cor1 (127 KB) and flo1 (65 KB)
//   tiles exceed the 227 KB of a CTA before any tap ring, and 52 of the
//   region's 180 rows would be halo that a neighbour computes too.
// - A CTA owns 8 x 16 output pixels in either stage, 128 rows: a 64-row
//   m-tile (4 image rows of 16) for each of two consumer warpgroups, read
//   from a 10 x 18 input tile that the consumers copy with cp.async and
//   bounds checks (zeros outside the image, no padded copy). At 720p the
//   grid is 10 x 12 = 120 CTAs: one wave on 132 SMs.
// - Stage 1 copies its flo1 tile (49 KB) first and runs the flo pass (N =
//   64, 9 taps x 2 slices of wf2) while its cor1 tile (95 KB) arrives, then
//   the cor pass (N = 192, 9 x 4 slices of wc2: 96 accumulators a thread).
//   Its boxes take up to 24 KB, so the ring has three stages. Epilogue:
//   float32 bias, one rounding to bf16, relu, stored for the pixels inside
//   the image only. Stage 2's tile copy reads zeros outside the image: that
//   is the second convolution's zero padding of the activations, and
//   relu(bias) never reaches it.
// - Stage 2: one N = 128 pass over 9 x 4 slices of wcv (its output rows 126
//   and 127 are zero padding) through a ring of four 16 KB stages; the
//   epilogue writes the 126 channels and bf16(flow) into lanes 126-127.
// - Each epilogue stages its rows in the input tile's space, free once
//   every warp's products are done, and copies them out 16 bytes a thread,
//   whole pixels: all 120 CTAs store at once, and stores straight from the
//   accumulators (16 bytes of a 32-byte sector each) took 8.5 us of the
//   first version's 0.053 ms, 4.3 us staged (tools/torch_kernel_ablate.py,
//   PERF.md).
// - Stage 2 is a programmatic dependent launch: its CTAs start on the SMs
//   that stage 1 leaves, set up their ring and fetch taps, and wait for
//   stage 1's map only before their tile copy (0.5-0.8 us of the kernel).
// - Tap traffic from L2, CTAs x tap bytes: 120 x 1,032,192 = 124 MB in
//   stage 1, 120 x 589,824 = 71 MB in stage 2. Leaving the tap loads out
//   saves under 1 us: the products, tile copies, epilogues and launches
//   bound it.
// The plain versions sum the products in another order, so a rounding to
// bf16 may fall the other way on a small share of entries.
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kCor = 256, kFlo = 128, kCor2 = 192, kFlo2 = 64;
constexpr int kMid = kCor2 + kFlo2;          // stage 1's map: 256 channels
constexpr int kMotion = 128;                 // the result's channels
constexpr int kOH = 8, kOW = 16;             // output tile of a CTA
constexpr int kIH = kOH + 2, kIW = kOW + 2;  // input tile: 10 x 18
constexpr int kTilePos = kIH * kIW;
constexpr int kWarpgroups = 2;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBlock = kConsumers + 128;     // + the producer warpgroup
static_assert(kOH * kOW == 64 * kWarpgroups, "a 64-row m-tile a warpgroup");
static_assert(kOW == 16, "a warp's 16 ldmatrix rows are one image row");
constexpr int kLdCor = kCor + kPad;          // rows of the tiles
constexpr int kLdFlo = kFlo + kPad;
constexpr int kLdMid = kMid + kPad;
constexpr int kFloSlices = 9 * (kFlo / kSliceK);   // 18
constexpr int kCorSlices = 9 * (kCor / kSliceK);   // 36
constexpr int kMidSlices = 9 * (kMid / kSliceK);   // 36

// stage 1: a ring of three [192][64] stages
constexpr int kRing1 = 3;
constexpr uint32_t kStage1Bytes = kCor2 * 128;
constexpr int kCorBytes = kTilePos * kLdCor * 2;
constexpr int kFloBytes = kTilePos * kLdFlo * 2;
constexpr size_t kSmem1 = 1024 + kRing1 * kStage1Bytes + kCorBytes +
                          kFloBytes + kMid * 4 + 16 * kRing1;
// stage 2: a ring of four [128][64] stages
constexpr int kRing2 = 4;
constexpr uint32_t kStage2Bytes = kMotion * 128;
constexpr int kMidBytes = kTilePos * kLdMid * 2;
constexpr size_t kSmem2 = 1024 + kRing2 * kStage2Bytes + kMidBytes +
                          kMotion * 4 + 16 * kRing2;

struct Stage1Params {
  CUtensorMap wc2;            // [9 * 192][256]: (tap, cor2 channel), cor1
  CUtensorMap wf2;            // [9 * 64][128]: (tap, flo2 channel), flo1
  const __nv_bfloat16* cor1;  // (H, W, 256)
  const __nv_bfloat16* flo1;  // (H, W, 128)
  const float* bc2;
  const float* bf2;
  __nv_bfloat16* mid;         // (H, W, 256): cat(cor2, flo2)
  int H, W;
};

struct Stage2Params {
  CUtensorMap wcv;            // [9 * 128][256]: (tap, out channel), mid
  const __nv_bfloat16* mid;
  const float* flow;          // (H, W, 2)
  const float* bcv;           // 128, entries 126 and 127 unused
  __nv_bfloat16* out;         // (H, W, 128)
  int H, W;
};

// The consumers' copy of a C-channel bf16 map into a [10 * 18][C + kPad]
// tile: position (iy, ix) is image pixel (y0 - 1 + iy, x0 - 1 + ix), zeros
// outside the image. One cp.async group; the caller commits it.
template <int C>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int y0,
                                          int x0, int H, int W, int tid) {
  for (int idx = tid; idx < kTilePos * (C / 8); idx += kConsumers) {
    const int p = idx / (C / 8), c = (idx % (C / 8)) * 8;
    const int y = y0 - 1 + p / kIW, x = x0 - 1 + p % kIW;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    cp_async_16_zfill(tile + p * (C + kPad) + c,
                      inside ? src + ((size_t)y * W + x) * C + c : src,
                      inside);
  }
}

// An epilogue's staging of relu(bf16(acc + bias)): this thread's two rows
// of its warpgroup's 64 x N accumulator (N = 2 * M, rows `row` and `row` +
// 8 of the CTA's 128) into a [128][N + kPad] bf16 tile in shared memory,
// eight channel pairs at a time: the bias loads first, then the
// arithmetic, then the stores.
template <int M>
__device__ __forceinline__ void stage_rows(const float (&acc)[M],
                                           const float* bias,
                                           __nv_bfloat16* st, int row,
                                           int cq) {
  constexpr int kLd = 2 * M + kPad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int j0 = 0; j0 < M / 4; j0 += 8) {
      float2 b[8], v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float2*>(bias + 8 * (j0 + j) + cq);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ai = 4 * (j0 + j) + 2 * hh;
        v[j] = make_float2(fmaxf(round_bf16(acc[ai] + b[j].x), 0.f),
                           fmaxf(round_bf16(acc[ai + 1] + b[j].y), 0.f));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store_bf16x2(st + (row + 8 * hh) * kLd + 8 * (j0 + j) + cq, v[j].x,
                     v[j].y);
      }
    }
  }
}

// The staged [128][N + kPad] tile to channels [c0, c0 + N) of a C-channel
// bf16 map, CTA row r being image pixel (y0 + r / 16, x0 + r % 16), for the
// pixels inside the image only: 16 bytes a thread, N * 2 contiguous bytes a
// pixel (whole 32-byte sectors; stores straight from the accumulators wrote
// 16 bytes of a sector at a time).
template <int N, int C>
__device__ __forceinline__ void copy_out(const __nv_bfloat16* st,
                                         __nv_bfloat16* dst, int c0, int y0,
                                         int x0, int H, int W, int tid) {
  constexpr int kChunks = N / 8;
  for (int idx = tid; idx < kOH * kOW * kChunks; idx += kConsumers) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int y = y0 + r / kOW, x = x0 + r % kOW;
    if (y < H && x < W) {
      *reinterpret_cast<uint4*>(dst + ((size_t)y * W + x) * C + c0 + c) =
          *reinterpret_cast<const uint4*>(st + r * (N + kPad) + c);
    }
  }
}

// --------------------------------------------------------------- stage 1 ----

__global__ void __launch_bounds__(kBlock, 1)
motion_stage1_kernel(const __grid_constant__ Stage1Params P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw) + kRing1 * kStage1Bytes;
  __nv_bfloat16* cor = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* flo = reinterpret_cast<__nv_bfloat16*>(sm + kCorBytes);
  float* bias = reinterpret_cast<float*>(sm + kCorBytes + kFloBytes);
  const Ring ring{base, smem_addr(bias + kMid), kRing1, kStage1Bytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();
  // stage 2 may take the SMs this grid leaves (see the C entry)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (warp >= kConsumers / 32) {
    // ---- producer: the flo taps, then the cor taps ----
    regs_down<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < kFloSlices; ++it) {
        const int tap = it / (kFlo / kSliceK), kc = it % (kFlo / kSliceK);
        ring.load(it, &P.wf2, kc * kSliceK, tap * kFlo2, kFlo2 * 128);
      }
      for (int i = 0; i < kCorSlices; ++i) {
        const int tap = i / (kCor / kSliceK), kc = i % (kCor / kSliceK);
        ring.load(kFloSlices + i, &P.wc2, kc * kSliceK, tap * kCor2,
                  kCor2 * 128);
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<232>();
  const int y0 = blockIdx.y * kOH, x0 = blockIdx.x * kOW;
  load_tile<kFlo>(flo, P.flo1, y0, x0, P.H, P.W, tid);
  cp_async_commit();
  load_tile<kCor>(cor, P.cor1, y0, x0, P.H, P.W, tid);
  cp_async_commit();
  for (int i = tid; i < kMid; i += kConsumers) {
    bias[i] = i < kCor2 ? P.bc2[i] : P.bf2[i - kCor2];
  }
  cp_async_wait<1>();                       // this thread's flo1 copies
  named_sync(1, kConsumers);                // everyone's, and the biases

  // warp w's 16 rows are output row y0 + w, columns x0 .. x0 + 15; tap
  // (ky, kx) of its row r reads tile position (w + ky) * 18 + r + kx
  const int a_row = warp * kIW + (lane & 15);
  const int row = 16 * warp + (lane >> 2);  // accumulator rows: row, row + 8
  const int cq = 2 * (lane & 3);
  {
    float acc[kFlo2 / 2];
    wgmma_pass(acc, flo, kLdFlo, a_row, 3, kIW, 9, kFlo / kSliceK, ring, 0);
    named_sync(1, kConsumers);              // every warp is done with flo1
    stage_rows(acc, bias + kCor2, flo, row, cq);
    named_sync(1, kConsumers);
    copy_out<kFlo2, kMid>(flo, P.mid, kCor2, y0, x0, P.H, P.W, tid);
  }
  cp_async_wait<0>();                       // this thread's cor1 copies
  named_sync(1, kConsumers);
  {
    float acc[kCor2 / 2];
    wgmma_pass(acc, cor, kLdCor, a_row, 3, kIW, 9, kCor / kSliceK, ring,
               kFloSlices);
    named_sync(1, kConsumers);              // every warp is done with cor1
    stage_rows(acc, bias, cor, row, cq);
    named_sync(1, kConsumers);
    copy_out<kCor2, kMid>(cor, P.mid, 0, y0, x0, P.H, P.W, tid);
  }
}

// --------------------------------------------------------------- stage 2 ----

__global__ void __launch_bounds__(kBlock, 1)
motion_stage2_kernel(const __grid_constant__ Stage2Params P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw) + kRing2 * kStage2Bytes;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(sm);
  float* bias = reinterpret_cast<float*>(sm + kMidBytes);
  const Ring ring{base, smem_addr(bias + kMotion), kRing2, kStage2Bytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: the taps of the 126 (+ 2 zero) output channels ----
    regs_down<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < kMidSlices; ++it) {
        const int tap = it / (kMid / kSliceK), kc = it % (kMid / kSliceK);
        ring.load(it, &P.wcv, kc * kSliceK, tap * kMotion, kStage2Bytes);
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<232>();
  const int y0 = blockIdx.y * kOH, x0 = blockIdx.x * kOW;
  for (int i = tid; i < kMotion; i += kConsumers) bias[i] = P.bcv[i];
  // stage 1 has finished and its map is visible (the producer above
  // streams taps meanwhile, which stage 1 does not write)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  load_tile<kMid>(tile, P.mid, y0, x0, P.H, P.W, tid);
  cp_async_commit();
  cp_async_wait<0>();
  named_sync(1, kConsumers);

  const int a_row = warp * kIW + (lane & 15);
  const int row = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[kMotion / 2];
  wgmma_pass(acc, tile, kLdMid, a_row, 3, kIW, 9, kMid / kSliceK, ring, 0);
  named_sync(1, kConsumers);                // every warp is done with mid
  stage_rows(acc, bias, tile, row, cq);
  if (cq == kMotion - 2 - 8 * 15) {
    // this thread staged lanes 126, 127 of its rows: the flow itself there
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row + 8 * hh;
      const int y = y0 + r / kOW, x = x0 + r % kOW;
      if (y < P.H && x < P.W) {
        const float2 fl = *reinterpret_cast<const float2*>(
            P.flow + ((size_t)y * P.W + x) * 2);
        store_bf16x2(tile + r * (kMotion + kPad) + kMotion - 2, fl.x, fl.y);
      }
    }
  }
  named_sync(1, kConsumers);
  copy_out<kMotion, kMotion>(tile, P.out, 0, y0, x0, P.H, P.W, tid);
}

TapMaps<8> g_wc2_maps, g_wf2_maps, g_wcv_maps;

}  // namespace

// Kernel H. cor1 (H, W, 256), flo1 (H, W, 128) bf16 and flow (H, W, 2)
// float32, channels minor; wc2 [9][192][256], wf2 [9][64][128], wcv
// [9][128][256] (output rows 126 and 127 zero) bf16, input channels minor;
// bc2 (192), bf2 (64), bcv (128) float32; mid (H, W, 256) bf16 scratch,
// which holds cat(cor2, flo2) afterwards; out (H, W, 128) bf16. All
// contiguous and 16-byte aligned. Two launches on `stream`, stage 1 then
// stage 2. The taps' tensor maps are encoded at the first call with a
// pointer and kept for the last eight. Returns the launches' cudaError_t,
// or 10000 + the CUresult of a failed encode, or 20000 when
// cuTensorMapEncodeTiled is not found.
extern "C" int woft_motion_encoder_tail(
    const void* cor1, const void* flo1, const void* flow, const void* wc2,
    const void* bc2, const void* wf2, const void* bf2, const void* wcv,
    const void* bcv, void* mid, void* out, int H, int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const CUtensorMap *mc, *mf, *mv;
  int rc = g_wc2_maps.get(wc2, kCor, 9 * kCor2, kCor2, &mc);
  if (rc) return rc;
  if ((rc = g_wf2_maps.get(wf2, kFlo, 9 * kFlo2, kFlo2, &mf))) return rc;
  if ((rc = g_wcv_maps.get(wcv, kMid, 9 * kMotion, kMotion, &mv))) return rc;
  const Stage1Params P1 = {*mc, *mf,
                           static_cast<const __nv_bfloat16*>(cor1),
                           static_cast<const __nv_bfloat16*>(flo1),
                           static_cast<const float*>(bc2),
                           static_cast<const float*>(bf2),
                           static_cast<__nv_bfloat16*>(mid), H, W};
  const Stage2Params P2 = {*mv, static_cast<const __nv_bfloat16*>(mid),
                           static_cast<const float*>(flow),
                           static_cast<const float*>(bcv),
                           static_cast<__nv_bfloat16*>(out), H, W};
  cudaError_t err = cudaFuncSetAttribute(
      motion_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(motion_stage2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kOW - 1) / kOW),
                  (unsigned)((H + kOH - 1) / kOH));
  const cudaStream_t s = (cudaStream_t)stream;
  motion_stage1_kernel<<<grid, kBlock, kSmem1, s>>>(P1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // Programmatic dependent launch: stage 2's CTAs start on the SMs stage 1
  // leaves, set up their ring and load taps, and wait (griddepcontrol.wait)
  // only before they read the map.
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = kSmem2;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, motion_stage2_kernel, P2);
}
