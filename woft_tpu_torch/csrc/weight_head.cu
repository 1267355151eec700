// Kernel J: the weight head in bf16 mode, one launch for M rows.
//
// Replaces no TPU kernel: woft_tpu runs its weight head through XLA
// (woft_tpu/models/raft.py, the weight head's conv stack), and so did the
// port, through cuDNN: in bf16 mode layers.conv2d widens the bf16-rounded
// operands back to float32, so cuDNN ran float32 products, mostly through
// its FFT path, over float32 activations in device memory (52.8 ms of a
// 1080p frame at 32,400 rows on an H100).
//
// Function, per row m (a cell of the flow's grid; models/raft.py:
// weight_head_apply at the structure ((128, 3), (128, 3), (128, 3)), Kp =
// 9, L = 4):
//   x0[c][y][x] = corr[m][y * 36 + x * 4 + c] (c < 4), mean[m] (c = 4)
//     the reference's reshape of the lookup's 324 channels as (Kp, Kp, L)
//     although they are laid out level-major
//   x1 = relu(conv3(bf16(x0), w1) + b1)        5 -> 128, 9 x 9
//   x2 = relu(conv3(bf16(x1), w2) + b2)        128 -> 128
//   x3 = relu(conv3(bf16(x2), w3) + b3)        128 -> 128
//   out[m] = mean_yx(<bf16(x3), bf16(w4)> + b4)
// conv3 is the 3x3 convolution with zero padding; bf16 operands, float32
// sums, float32 biases: the rounding points of the unfused path
// (models/weight_head.py:weight_head_plain), whose products are exact in
// float32, so the two differ only in the order of the sums.
//
// Bound on the H100 at 32,400 rows (the 1080p grid): 48.73 MFLOP a row,
// 1,578.9 GFLOP, 1.60 ms at 989 TFLOP/s; the rows read 42 MB (bf16
// lookups), 0.013 ms: operations-bound.
//
// Design (conv_wgmma.cuh's wgmma products and tap ring, the taps by TMA):
// - A persistent CTA (one a SM) walks over pairs of rows. A pair's 2 x 81
//   positions are 162 of the 192 wgmma rows of three consumer warpgroups;
//   wgmma row i reads its position through pos(i), so only the 81 valid
//   positions of a row's zero-padded 11 x 11 tile are computed, not 121,
//   and rows 162-191 read a fixed position and are dropped.
// - Activations stay in shared memory as bf16, two ping-pong tiles of 2 x
//   121 positions x 136 channels (a 16-byte pad a position, so ldmatrix is
//   conflict-free), zero on the tile borders: conv1 writes tile A, conv2
//   reads A and writes B, conv3 reads B and goes straight into the 1x1 and
//   the row's mean in registers. Nothing between the layers touches device
//   memory.
// - Conv1 (K = 45) is one product: an im2col of the pair, [192][64] bf16
//   (45 columns tap-major, (ky * 3 + kx) * 5 + c, and zeros), times one
//   [128][64] box of taps, 4 wgmma k-steps.
// - Taps: one bf16 matrix [19 * 128][128], 19 blocks of 128 output rows:
//   block 0 conv1's im2col columns, blocks 1-9 conv2's taps, 10-18
//   conv3's, input channels minor. 37 boxes of [128][64] (16 KB) a pair,
//   through a ring of four stages that the producer keeps full across
//   pairs; the two 128-channel convolutions' 590 KB of taps stream from L2
//   once a pair: 9.6 GB of L2 reads at 32,400 rows, 1.7 ms at ~5.5 TB/s,
//   of the order of the 1.9 ms that the pairs' 192-row products take at
//   the bf16 peak. Below half the peak the ring hides it.
// - The pair's inputs (2 x 325 values) are staged in shared memory as
//   float32, then the im2col is built from them; the epilogues add the
//   float32 bias, round once to bf16 and take the ReLU (relu(bf16(v)) ==
//   bf16(relu(v))); conv3's epilogue forms each position's 1x1 dot from
//   bf16(relu) and the bf16-rounded w4 in float32, sums a quad's four
//   partials by shuffles, and one warp a row sums its 81 positions.
// - Registers: the consumers hold two 64 x 128 float32 accumulators (the
//   sum and the tensor cores' partial, wgmma_run) and one set of A; the
//   producer warpgroup gives its registers away (setmaxnreg), so each
//   consumer thread has 160.
//
// Measured on an H100 (PERF.md): 3.84 ms at 32,400 rows, 411 TFLOP/s,
// 42 % of the bf16 peak and 49 % of what the 162-of-192-row tiles allow;
// 0.58 ms at 4,500 rows. Without the float32 promotion of the sums it ran
// in 3.14 ms, further from float64 than cuDNN (wgmma_run).
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kKp = 9, kLevels = 4, kCin = kLevels + 1;
constexpr int kCells = kKp * kKp;                 // 81 positions a row
constexpr int kCorr = kCells * kLevels;           // 324 lookups a row
constexpr int kRaw = kCorr + 1;                   // + the mean response
constexpr int kTile = kKp + 2;                    // zero-padded 11 x 11
constexpr int kTilePos = kTile * kTile;           // 121
constexpr int kC = 128;                           // hidden channels
constexpr int kK1 = 9 * kCin;                     // conv1's 45 columns
constexpr int kRows = 2;                          // head rows a CTA pass
constexpr int kWarpgroups = 3;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBlock = kConsumers + 128;          // + the producer warpgroup
constexpr int kMRows = 64 * kWarpgroups;          // 192 wgmma rows
constexpr int kValid = kRows * kCells;            // 162 of them used
static_assert(kValid <= kMRows, "a pair's positions fit the wgmma rows");
constexpr int kLd = kC + kPad;                    // activation row: 136
constexpr int kLdI = kSliceK + kPad;              // im2col row: 72
constexpr int kRing = 4;
constexpr uint32_t kStageBytes = 128 * 128;       // [128][64] bf16
constexpr int kSlicesPerTap = kC / kSliceK;       // 2
constexpr int kSlicesConv = 9 * kSlicesPerTap;    // 18 a 128-channel conv
constexpr int kSlicesPair = 1 + 2 * kSlicesConv;  // 37 a pair
constexpr int kTapRows = 19 * kC;                 // rows of the tap matrix
constexpr int kActBytes = kRows * kTilePos * kLd * 2;     // 65,824
constexpr int kI2cBytes = kMRows * kLdI * 2;              // 27,648
constexpr int kRawBytes = (kRows * kRaw * 4 + 15) / 16 * 16;
constexpr int kDotBytes = kMRows * 4;
constexpr int kConsts = 4 * kC + 1;               // b1 | b2 | b3 | w4 | b4
constexpr int kConstBytes = (kConsts * 4 + 15) / 16 * 16;
constexpr size_t kSmem = 1024 + kRing * kStageBytes + 2 * kActBytes +
                         kI2cBytes + kRawBytes + kDotBytes + kConstBytes +
                         16 * kRing;
static_assert(kSmem <= 232448, "fits the H100's 227 KB a block");

struct HeadParams {
  CUtensorMap taps;           // [19 * 128][128] bf16
  const void* corr;           // (M, 324) float32 or bf16
  const float* mean;          // (M,)
  const float* consts;        // (513,)
  float* out;                 // (M,)
  int M;
};

__device__ __forceinline__ float load_in(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_in(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// tile position (padded) of valid wgmma row i < kValid
__device__ __forceinline__ int tile_pos(int i) {
  const int r = i / kCells, p = i - r * kCells;
  const int y = p / kKp, x = p - y * kKp;
  return r * kTilePos + (y + 1) * kTile + x + 1;
}

// n slices of products over the ring, it0 onwards: acc = sum_i A_i * box_i^T,
// A_i read by this lane's ldmatrix at a_lane + off(i) elements.
//
// The tensor cores add each k-step's products into the float32 accumulator
// with truncation, not rounding to nearest: summed over a 3x3 convolution's
// 72 k-steps that drifts towards zero and moved the logits 5x further from
// a float64 evaluation than cuDNN's float32 sums (median over 32,400 rows).
// So the products go into a second accumulator `t` that is added into acc
// in float32, rounded to nearest, every kPromote slices (three taps): then
// the median gap is 1/8 of cuDNN's, for a fifth more time (PERF.md).
//
// One register set of A: a slice's fragments load after the previous
// slice's products are done, and the other two warpgroups' products fill
// the tensor cores meanwhile.
constexpr int kPromote = 6;

template <class Off>
__device__ __forceinline__ void wgmma_run(float (&acc)[64],
                                          const __nv_bfloat16* a_lane, int n,
                                          Off off, const Ring& ring, int it0) {
  const int lane = threadIdx.x & 31;
  float t[64];
  for (int i = 0; i < n; ++i) {
    uint32_t a[4][4];
    const __nv_bfloat16* src = a_lane + off(i);
#pragma unroll
    for (int k = 0; k < 4; ++k) ldmatrix_x4(a[k], src + 16 * k);
    const int it = it0 + i, s = it % ring.stages;
    mbar_wait(ring.full(s), (it / ring.stages) & 1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t b = ring.stage(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_rs(t, a[k], sw128_desc(b + 32 * k), (i % kPromote | k) != 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    keep_a(a);
    keep_acc(t);
    if (lane == 0) mbar_arrive(ring.empty(s));
    if ((i + 1) % kPromote == 0 || i == n - 1) {
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = i >= kPromote ? acc[j] + t[j] : t[j];
    }
  }
}

// Epilogue of conv1 and conv2: bf16(relu(acc + bias)) into the tile `dst`
// at the positions of the valid rows.
__device__ __forceinline__ void store_act(const float (&acc)[64],
                                          const float* bias,
                                          __nv_bfloat16* dst, int row0,
                                          int lane) {
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + (lane >> 2) + 8 * hh;
    if (i >= kValid) continue;
    __nv_bfloat16* d = dst + tile_pos(i) * kLd + cq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + cq);
      const int ai = 4 * j + 2 * hh;
      store_bf16x2(d + 8 * j, fmaxf(round_bf16(acc[ai] + b.x), 0.f),
                   fmaxf(round_bf16(acc[ai + 1] + b.y), 0.f));
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kBlock, 1)
weight_head_kernel(const __grid_constant__ HeadParams P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw_addr) + kRing * kStageBytes;
  __nv_bfloat16* tileA = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* tileB = reinterpret_cast<__nv_bfloat16*>(sm + kActBytes);
  __nv_bfloat16* i2c = reinterpret_cast<__nv_bfloat16*>(sm + 2 * kActBytes);
  float* raw = reinterpret_cast<float*>(sm + 2 * kActBytes + kI2cBytes);
  float* dots = reinterpret_cast<float*>(sm + 2 * kActBytes + kI2cBytes +
                                         kRawBytes);
  float* consts = dots + kMRows;
  const Ring ring{base, smem_addr(sm + 2 * kActBytes + kI2cBytes + kRawBytes +
                                  kDotBytes + kConstBytes),
                  kRing, kStageBytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pairs = (P.M + kRows - 1) / kRows;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: per pair, conv1's box, then conv2's and conv3's taps
    regs_down<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0;
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        ring.load(it++, &P.taps, 0, 0, kStageBytes);
        for (int i = 0; i < 2 * kSlicesConv; ++i) {
          const int conv = i / kSlicesConv, j = i % kSlicesConv;
          const int tap = j / kSlicesPerTap, kc = j % kSlicesPerTap;
          ring.load(it++, &P.taps, kc * kSliceK,
                    (1 + conv * 9 + tap) * kC, kStageBytes);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<160>();   // (65,536 - 128 * 24) / 384, in steps of 8: acc and t
  // the tiles' borders stay zero: the epilogues write valid positions only
  for (int i = tid; i < 2 * kActBytes / 16; i += kConsumers) {
    reinterpret_cast<uint4*>(tileA)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < kConsts; i += kConsumers) consts[i] = __ldg(P.consts + i);
  const int row0 = (tid >> 7) * 64 + (warp & 3) * 16;   // the warp's 16 rows
  const int i_lane = row0 + (lane & 15);                // this lane's row
  // ldmatrix row of the 3x3 convolutions: the position's top-left
  // neighbour (rows past the pair's read a fixed one), and slice i = (tap,
  // 64-channel half) reads tap (ky, kx) at ky * 11 + kx positions further
  const int a_lane = (i_lane < kValid ? tile_pos(i_lane) - kTile - 1 : 0) *
                         kLd + (lane >> 4) * 8;
  const auto tap_off = [](int i) {
    const int tap = i / kSlicesPerTap;
    return ((tap / 3) * kTile + tap % 3) * kLd + (i % kSlicesPerTap) * kSliceK;
  };
  const __nv_bfloat16* a_i2c = i2c + i_lane * kLdI + (lane >> 4) * 8;
  const T* corr = static_cast<const T*>(P.corr);

  int it0 = 0;
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int m0 = pair * kRows;
    const int n_here = min(kRows, P.M - m0);
    for (int idx = tid; idx < kRows * kRaw; idx += kConsumers) {
      const int r = idx / kRaw, f = idx - r * kRaw;
      const size_t m = (size_t)m0 + r;
      raw[idx] = r >= n_here ? 0.f
                 : f < kCorr ? load_in(corr + m * kCorr + f)
                             : __ldg(P.mean + m);
    }
    named_sync(1, kConsumers);
    // im2col: row i, column (ky * 3 + kx) * 5 + c
    for (int idx = tid; idx < kMRows * (kSliceK / 2); idx += kConsumers) {
      const int i = idx / (kSliceK / 2), k0 = (idx % (kSliceK / 2)) * 2;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + e;
        v[e] = 0.f;
        if (i < kValid && k < kK1) {
          const int r = i / kCells, p = i - r * kCells;
          const int y = p / kKp, x = p - y * kKp;
          const int t = k / kCin, c = k - t * kCin;
          const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
          if (yy >= 0 && yy < kKp && xx >= 0 && xx < kKp) {
            v[e] = raw[r * kRaw + (c < kLevels ? yy * (kKp * kLevels) +
                                                     xx * kLevels + c
                                               : kCorr)];
          }
        }
      }
      store_bf16x2(i2c + i * kLdI + k0, v[0], v[1]);
    }
    named_sync(1, kConsumers);

    float acc[64];
    wgmma_run(acc, a_i2c, 1, [](int) { return 0; }, ring, it0);
    store_act(acc, consts, tileA, row0, lane);
    named_sync(1, kConsumers);

    wgmma_run(acc, tileA + a_lane, kSlicesConv, tap_off, ring, it0 + 1);
    store_act(acc, consts + kC, tileB, row0, lane);
    named_sync(1, kConsumers);

    wgmma_run(acc, tileB + a_lane, kSlicesConv, tap_off, ring,
              it0 + 1 + kSlicesConv);
    // conv3's epilogue: each position's 1x1 dot over its 128 channels
    const int cq = 2 * (lane & 3);
    const float* b3 = consts + 2 * kC;
    const float* w4 = consts + 3 * kC;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(b3 + 8 * j + cq);
        const float2 w = *reinterpret_cast<const float2*>(w4 + 8 * j + cq);
        const int ai = 4 * j + 2 * hh;
        s += fmaxf(round_bf16(acc[ai] + b.x), 0.f) * w.x;
        s += fmaxf(round_bf16(acc[ai + 1] + b.y), 0.f) * w.y;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) dots[row0 + (lane >> 2) + 8 * hh] = s;
    }
    named_sync(1, kConsumers);
    // one warp a row: the mean over its 81 positions
    if (warp < n_here) {
      const float b4 = consts[4 * kC];
      float s = 0.f;
      for (int p = lane; p < kCells; p += 32) s += dots[warp * kCells + p] + b4;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) P.out[m0 + warp] = s / (float)kCells;
    }
    it0 += kSlicesPair;
  }
}

TapMaps<8> g_tap_maps;
int g_sms = 0;

template <class T>
int launch(const HeadParams& P, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      weight_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (P.M + kRows - 1) / kRows;
  const int grid = pairs < g_sms ? pairs : g_sms;
  weight_head_kernel<T><<<grid, kBlock, kSmem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel J. corr (M, 324) float32 (corr_bf16 = 0) or bf16 (1), the rows'
// lookups in the dense lookup's channel order; mean (M,) float32; taps
// [19 * 128][128] bf16 (models/weight_head.py:head_params); consts (513,)
// float32: b1 | b2 | b3 | w4 rounded to bf16 | b4; out (M,) float32 logits.
// All contiguous, taps 16-byte aligned. The taps' tensor map is encoded at
// the first call with a pointer and kept for the last eight. Returns
// cudaGetLastError(), or 10000 + the CUresult of a failed encode, or 20000
// when the driver has no cuTensorMapEncodeTiled.
extern "C" int woft_weight_head(const void* corr, int corr_bf16,
                                const void* mean, const void* taps,
                                const void* consts, void* out, int M,
                                void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return (int)err;
  }
  const CUtensorMap* map;
  const int rc = g_tap_maps.get(taps, kC, kTapRows, kC, &map);
  if (rc) return rc;
  const HeadParams P = {*map, corr, static_cast<const float*>(mean),
                        static_cast<const float*>(consts),
                        static_cast<float*>(out), M};
  return corr_bf16 ? launch<__nv_bfloat16>(P, stream) : launch<float>(P, stream);
}
