// Kernel I: the flow head, conv2(relu(conv1(net))), fused.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/update_tail.py:
// flow_head_pallas (pallas_call at :310). There a grid step owns a band of
// rows, copies it with a 2-row halo by DMA from a zero-padded input, keeps
// all taps in fast memory and pads the 2-channel result to 128 lanes. None of
// that is carried over.
//
// Function, per pixel of a (H, W) map, channels minor:
//   hid   = relu(bf16(conv3(bf16(net), w1) + b1))    128 -> 256
//   delta = conv3(hid, w2) + b2                      256 -> 2, float32
// conv3 is the 3x3 convolution with zero padding, bf16 operands, float32
// accumulation, float32 bias. The second convolution's zero padding applies
// to hid: outside the image hid is zero, not relu(b1). The delta is never
// rounded. These are models/update.py:flow_head_plain's rounding points.
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 9 * (128 * 256
// + 256 * 2) = 8.6 GFLOP, 0.009 ms at 989 TFLOP/s, against 8.7 MB (0.003
// ms): operations-bound.
//
// Design (stage 1 is conv_wgmma.cuh's pass: wgmma products, TMA-fed taps):
// - A CTA owns a 10 x 14 tile of output pixels. Stage 1 runs on the 12 x 16
//   region around it, 192 rows: one 64-row m-tile (4 region rows) for each
//   of three consumer warpgroups, from a 14 x 18 tile of bf16(net) read
//   with bounds checks (zeros outside the image, no padded copy), eleven
//   16-byte loads a thread in flight. 27 % of the stage-1 rows are halo
//   (44 % with the 6 x 6 tiles before), and at 720p the grid is 12 x 9 =
//   108 CTAs: one wave on 132 SMs (405 blocks on 264 slots before).
// - Stage 1's 256 output channels run as two passes of 128, each over 9
//   taps x 2 slices [128][64] of w1, 16 KB a slice through a ring of four
//   stages: 589,824 bytes of taps a CTA, 64 MB of L2 -> SM traffic a launch
//   (239 MB before). Epilogue: float32 bias, one rounding, relu, zero
//   outside the image, into a [192][128] bf16 tile of the pass's channels.
// - Stage 2 (256 -> 2) is split by tap: after each pass, the tile times w2
//   (its 9 x 2 rows as the 18 columns of an n24 product, K = the pass's 128
//   channels) gives every region row's contribution to each tap's output,
//   mma.sync m16n8k16, a 16-row m-tile a warp, into float32 partials in
//   shared memory (the second pass adds to the first's). Then each output
//   pixel sums its nine taps' partials from the neighbouring region rows,
//   + b2, never rounded. Each hidden activation is read once, not once a
//   tap. The plain version sums in another order, so the delta agrees to
//   float32 accumulation error plus the few hidden activations whose
//   rounding to bf16 fell the other way.
//
// What bounds it (tools/torch_kernel_ablate.py --kernels I, PERF.md): the
// stage-1 products, 113 MFLOP a CTA, 15 us at one SM's share of the bf16
// peak, and no CTA of the 108 can share them; leaving them out saves 10 us
// of 0.027 ms, the tile loads 3 us, the tap loads and stage 2 under 1 us.
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kNet = 128, kHid = 256;
constexpr int kOH = 10, kOW = 14;            // output tile
constexpr int kRH = kOH + 2, kRW = kOW + 2;  // stage-1 region: 12 x 16
constexpr int kIH = kOH + 4, kIW = kOW + 4;  // input tile: 14 x 18
constexpr int kWarpgroups = 3;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBlock = kConsumers + 128;     // + the producer warpgroup
constexpr int kRegion = kRH * kRW;           // 192 rows
static_assert(kRegion == 64 * kWarpgroups, "a 64-row m-tile a warpgroup");
static_assert(kRW == 16, "a warp's 16 ldmatrix rows are one region row");
constexpr int kLdIn = kNet + kPad;           // row of the input tile
constexpr int kLdS = 128 + kPad;             // row of the stage-1 tile
constexpr int kTaps2 = 18;                   // w2's rows: (tap, channel)
constexpr int kLdW = kHid + kPad;            // row of w2 in shared memory
constexpr int kRing = 4;
constexpr uint32_t kStageBytes = 128 * 128;  // [128][64] bf16
constexpr int kSlicesPerTap = kNet / kSliceK;         // 2
constexpr int kSlicesHalf = 9 * kSlicesPerTap;        // a pass: 18
constexpr int kInBytes = kIH * kIW * kLdIn * 2;
constexpr int kS1Bytes = kRegion * kLdS * 2;
constexpr int kW2Bytes = 24 * kLdW * 2;      // n24: rows 18-23 zero
constexpr int kPartBytes = kRegion * kTaps2 * 4;
constexpr size_t kSmem = 1024 + kRing * kStageBytes + kInBytes + kS1Bytes +
                         kW2Bytes + kPartBytes + 16 * kRing;
constexpr int kOutPixels = kOH * kOW;        // 140

struct FlowHeadParams {
  CUtensorMap w1;             // [9 * 256][128]: (tap, hidden channel), net
  const float* net;
  const __nv_bfloat16* w2;    // [9][2][256]
  const float* b1;
  const float* b2;
  float* out;                 // (H, W, 2)
  int H, W;
};

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

__global__ void __launch_bounds__(kBlock, 1)
flow_head_kernel(const __grid_constant__ FlowHeadParams P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw) + kRing * kStageBytes;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* S1 = reinterpret_cast<__nv_bfloat16*>(sm + kInBytes);
  __nv_bfloat16* W2 = reinterpret_cast<__nv_bfloat16*>(sm + kInBytes +
                                                       kS1Bytes);
  float* part = reinterpret_cast<float*>(sm + kInBytes + kS1Bytes + kW2Bytes);
  const Ring ring{base, smem_addr(sm + kInBytes + kS1Bytes + kW2Bytes +
                                  kPartBytes),
                  kRing, kStageBytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: w1's hidden channels 0-127, then 128-255 ----
    regs_down<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < 2 * kSlicesHalf; ++it) {
        const int half = it / kSlicesHalf, i = it % kSlicesHalf;
        const int tap = i / kSlicesPerTap, kc = i % kSlicesPerTap;
        ring.load(it, &P.w1, kc * kSliceK, tap * kHid + half * 128,
                  kStageBytes);
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<152>();
  const int y0 = blockIdx.y * kOH, x0 = blockIdx.x * kOW;
  // input tile position (iy, ix) is image pixel (y0 - 2 + iy, x0 - 2 + ix)
  load_quads_as_bf16<11>(
      kIH * kIW * (kNet / 4), kConsumers, tid,
      [&](int idx) -> const float* {
        const int q = idx / (kNet / 4);
        const int y = y0 - 2 + q / kIW, x = x0 - 2 + q % kIW;
        return y >= 0 && y < P.H && x >= 0 && x < P.W
                   ? P.net + ((size_t)y * P.W + x) * kNet + (idx % (kNet / 4)) * 4
                   : nullptr;
      },
      [&](int idx) {
        return tile + (idx / (kNet / 4)) * kLdIn + (idx % (kNet / 4)) * 4;
      });
  for (int idx = tid; idx < 24 * (kHid / 8); idx += kConsumers) {
    const int n = idx / (kHid / 8), k = (idx % (kHid / 8)) * 8;
    *reinterpret_cast<uint4*>(W2 + n * kLdW + k) =
        n < kTaps2 ? *reinterpret_cast<const uint4*>(P.w2 + n * kHid + k)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  named_sync(1, kConsumers);

  // stage 1: region row r = (ry, rx) is image pixel (y0 - 1 + ry, x0 - 1 +
  // rx) and reads input-tile positions (ry + ky) * 18 + rx + kx
  const int row0 = (tid >> 7) * 64 + (warp & 3) * 16;
  const int a_row = (row0 / kRW) * kIW + (lane & 15);
  const int cq = 2 * (lane & 3);
  // stage 2: warp w's m-tile is region rows 16 w .. 16 w + 15
  const int m0 = 16 * warp;
  const __nv_bfloat16* a2 = S1 + (m0 + (lane & 15)) * kLdS + (lane >> 4) * 8;
  const __nv_bfloat16* bw =
      W2 + ((lane & 7) + (lane >> 4) * 8) * kLdW + ((lane >> 3) & 1) * 8;
  for (int half = 0; half < 2; ++half) {
    float acc[64];                          // 64 rows x 128 channels
    wgmma_pass(acc, tile, kLdIn, a_row, 3, kIW, 9, kSlicesPerTap, ring,
               half * kSlicesHalf);
    if (half) named_sync(1, kConsumers);    // the first half's tile is read
    // all loads, then the arithmetic, then the stores (a store the compiler
    // cannot tell from the bias would hold back the next pair's load)
    float2 b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      b[j] = __ldg(reinterpret_cast<const float2*>(P.b1 + half * 128 + 8 * j +
                                                   cq));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + (lane >> 2) + 8 * hh;
      const int y = y0 - 1 + r / kRW, x = x0 - 1 + r % kRW;
      const bool inside = y >= 0 && y < P.H && x >= 0 && x < P.W;
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ai = 4 * j + 2 * hh;
        v[j] = inside ? make_float2(fmaxf(round_bf16(acc[ai] + b[j].x), 0.f),
                                    fmaxf(round_bf16(acc[ai + 1] + b[j].y), 0.f))
                      : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        store_bf16x2(S1 + r * kLdS + 8 * j + cq, v[j].x, v[j].y);
      }
    }
    named_sync(1, kConsumers);              // the tile is complete

    // each region row's contribution to each (tap, channel) output
    float c[3][4] = {};
#pragma unroll
    for (int kk = 0; kk < 128; kk += 16) {
      uint32_t af[4], b01[4], bb[2];
      ldmatrix_x4(af, a2 + kk);
      ldmatrix_x4(b01, bw + half * 128 + kk);
      ldmatrix_x2(bb, bw + 16 * kLdW + half * 128 + kk);
      const uint32_t bn0[2] = {b01[0], b01[1]}, bn1[2] = {b01[2], b01[3]};
      mma_bf16(c[0], af, bn0);
      mma_bf16(c[1], af, bn1);
      mma_bf16(c[2], af, bb);
    }
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      const int col = 8 * nt + cq;
      if (col >= kTaps2) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2* dst = reinterpret_cast<float2*>(
            part + (m0 + (lane >> 2) + 8 * hh) * kTaps2 + col);
        float2 v = make_float2(c[nt][2 * hh], c[nt][2 * hh + 1]);
        if (half) {
          const float2 prev = *dst;
          v.x += prev.x;
          v.y += prev.y;
        }
        *dst = v;
      }
    }
  }
  named_sync(1, kConsumers);                // the partials are complete

  // output pixel o = (oy, ox), channel ch: its nine taps' partials
  for (int idx = tid; idx < 2 * kOutPixels; idx += kConsumers) {
    const int o = idx >> 1, ch = idx & 1;
    const int oy = o / kOW, ox = o % kOW;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= P.H || x >= P.W) continue;
    float sum = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = (oy + tap / 3) * kRW + ox + tap % 3;
      sum += part[r * kTaps2 + 2 * tap + ch];
    }
    P.out[((size_t)y * P.W + x) * 2 + ch] = sum + P.b2[ch];
  }
}

TapMaps<8> g_w1_maps;

}  // namespace

// Kernel I. net (H, W, 128) float32, channels minor; w1 [9][256][128], w2
// [9][2][256] bf16, input channels minor; b1 (256), b2 (2) float32; out (H,
// W, 2) float32. All contiguous and 16-byte aligned. w1's tensor map is
// encoded at the first call with a pointer and kept for the last eight.
// Returns cudaGetLastError(), or 10000 + the CUresult of a failed encode,
// or 20000 when the driver has no cuTensorMapEncodeTiled.
extern "C" int woft_flow_head(const void* net, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              int H, int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const CUtensorMap* m1;
  const int rc = g_w1_maps.get(w1, kNet, 9 * kHid, 128, &m1);
  if (rc) return rc;
  const FlowHeadParams P = {*m1,
                            static_cast<const float*>(net),
                            static_cast<const __nv_bfloat16*>(w2),
                            static_cast<const float*>(b1),
                            static_cast<const float*>(b2),
                            static_cast<float*>(out), H, W};
  cudaError_t err = cudaFuncSetAttribute(
      flow_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kOW - 1) / kOW),
                  (unsigned)((H + kOH - 1) / kOH));
  flow_head_kernel<<<grid, kBlock, kSmem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
