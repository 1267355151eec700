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
// x is RAFT's 128 motion channels or GMA's 256 (cat(mf, mf_g), models/gma.py);
// the kernel is instantiated for each width, which changes only the tile's
// row (cat(h, x): 256 or 384 channels, 225 KB of shared memory in all at
// 384) and the tap slices a pass streams (20 or 30).
//
// Bound on the H100 at 720p (90 x 160 pixels): 2 * 14,400 * 5 * 256 * 384
// = 14.2 GFLOP, 0.014 ms at 989 TFLOP/s, against 30 MB of operands (0.009
// ms at 3.35 TB/s): operations-bound.
//
// Design (the pass is conv_wgmma.cuh's: wgmma products, TMA-fed taps):
// - The lines of the map are laid end to end, each followed by two zero
//   positions: position p = line * (len + 2) + s. Two zeros between lines
//   are all the padding a 5-tap convolution needs, and r * h is zero there
//   too, so the two stacked convolutions see every line's zero padding
//   without a tile per line. A CTA owns 124 consecutive positions of
//   output. It computes z|r on 128 positions (2 more on each side: q needs
//   r two positions away), one 64-row m-tile for each of its two consumer
//   warpgroups, from a 132-position tile of cat(bf16(h), x) read with
//   bounds checks. At 720p that is 118 CTAs along W and 119 along H: one
//   wave on 132 SMs, 3 % of the products halo. A position is one pixel's
//   contiguous 128 channels, so both axes load their tile alike, a pixel a
//   row: x by cp.async, h (float32, rounded to bf16 on the way in, so not a
//   TMA copy) with nine 16-byte loads a thread in flight.
// - Three passes of 128 channels (z, r, q), 20 tap slices [128][64] each,
//   stream through a ring of four 16 KB stages; the producer loads the next
//   pass's taps while the consumers run an epilogue. L2 -> SM traffic:
//   983,040 bytes a CTA, 116 MB a launch along W and 117 MB along H (it was
//   221 and 236 MB with 2 x 36-position blocks).
// - z waits in a shared-memory tile for the blend (in registers it pushed
//   the block past its 168 registers a thread). After the r pass, r * h
//   overwrites the tile's h half (zero outside the image) once every warp
//   has read its fragments; the q pass then reads cat(rh, x) from the same
//   tile. The epilogues read their operands (pre_zr, pre_q, h) eight
//   channel pairs at a time, all loads in flight before the first use; the
//   biases sit in shared memory.
// - sigmoid and tanh use expf, IEEE division and tanhf, not the fast
//   intrinsics: the gates are rounded to bf16 and must round as the plain
//   version's do. Evaluated per gate they took a third of the kernel (49,152
//   a CTA on its 8 consumer warps, the tensor cores idle meanwhile); their
//   bf16 inputs take few values, so they are read from exact tables (see
//   sigmoid_direct below). The plain version sums the products in another
//   order, so a rounding to bf16 may fall the other way on a small share of
//   entries.
//
// What bounds it (tools/torch_kernel_ablate.py --kernels G, PERF.md): no
// single part. Of 0.043 ms the three epilogues take ~15 us, with the tensor
// cores idle, the products ~12 us, and the launch, the tile loads and the
// 60 ring hand-overs ~14 us; the products hide the tap loads (leaving the
// loads out saves nothing). Tried and dropped: one 64 x 256 z|r pass (168
// registers a thread spill and ptxas serialises the wgmma, C7512), the
// epilogues as row loops over a staging tile (slower), the z gates computed
// between the r pass's wgmma issues (they lengthened the pass by as much as
// they took).
#include "conv_wgmma.cuh"

namespace {

using namespace woft;

constexpr int kC = 128;                    // hidden channels
constexpr int kWarpgroups = 2;             // consumers: 64 rows each
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kBlock = kConsumers + 128;   // + the producer warpgroup
constexpr int kRows = 64 * kWarpgroups;    // z|r positions of a CTA: 128
constexpr int kOut = kRows - 4;            // output positions: 124
constexpr int kTile = kRows + 4;           // tile positions: 132
constexpr int kRing = 4;
constexpr uint32_t kStageBytes = kC * 128;       // [128][64] bf16
constexpr int kLdZ = kC + kPad;            // row of the z tile
constexpr int kZBytes = kRows * kLdZ * 2;
constexpr int kBiasBytes = 3 * kC * 4;           // bzr | bq

// What the motion input's width kX (128: RAFT; 256: GMA's cat(mf, mf_g))
// changes: the tile's row, cat(h, x), and the slices of a tap.
template <int kX>
struct Shape {
  static constexpr int kIn = kC + kX;                  // 256 or 384
  static constexpr int kLdA = kIn + kPad;              // row of the tile
  static constexpr int kSlicesPerTap = kIn / kSliceK;  // 4 or 6
  static constexpr int kSlices = 5 * kSlicesPerTap;    // a pass: 20 or 30
  static constexpr int kTileBytes = kTile * kLdA * 2;
};

struct GruParams {
  CUtensorMap wzr;            // [5 * 256][128 + kX]: (tap, z|r channel), cat(h, x)
  CUtensorMap wq;             // [5 * 128][128 + kX]
  const float* h;
  const __nv_bfloat16* x;
  const __nv_bfloat16* pre_zr;
  const __nv_bfloat16* pre_q;
  const float* bzr;
  const float* bq;
  float* out;
  int n_lines, len;           // lines, and positions along the convolution
  int line_stride, pos_stride;  // in pixels
};

// the epilogues' reads of device memory, read-only for the kernel's life
__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld_f32x2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Two values rounded to bf16 and back, with one packed conversion.
__device__ __forceinline__ float2 round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The gates' transcendentals, exactly as the plain version rounds them:
// bf16(sigmoid(v)) = bf16(1 / (1 + expf(-v))) and bf16(tanhf(v)) for a
// bf16 input v. Evaluated gate by gate they were a third of the kernel's time
// (a CTA has 49,152 of them on 8 warps while the tensor cores wait), and
// their input takes only 2^16 values, so they are read from tables that a
// kernel fills once a device with these same functions, by sign, exponent
// and mantissa, for |v| in [2^-16, 2^7) (sigmoid) and [2^-16, 2^5) (tanh).
// Outside that the rounded values are known: below, sigmoid rounds to 0.5
// (1 + expf(-v) is within 2^-15 of 2) and tanh to v (tanh(v) = v(1 - v^2 /
// 3 ...)); above, expf(-v) underflows to 0 or overflows to inf, so sigmoid
// is 1 or 0, and tanhf is +-1; NaN stays NaN. A table entry is the function's
// value, so the tables change no result, and the lookup has no branch.
__device__ __forceinline__ float sigmoid_direct(float v) {
  return round_bf16(1.f / (1.f + expf(-v)));
}
__device__ __forceinline__ float tanh_direct(float v) {
  return round_bf16(tanhf(v));
}

constexpr int kSigLo = 127 - 16, kSigHi = 127 + 7;    // biased exponents
constexpr int kTanhLo = 127 - 16, kTanhHi = 127 + 5;
constexpr int kSigN = 2 * (kSigHi - kSigLo) * 128;
constexpr int kTanhN = 2 * (kTanhHi - kTanhLo) * 128;
constexpr int kTables = kSigN + kTanhN;               // 11,264 entries
static_assert(kTables % 8 == 0, "whole 16-byte copies");
constexpr int kTableBytes = kTables * 2;
template <int kX>
constexpr size_t smem_bytes() {
  return 1024 + kRing * kStageBytes + Shape<kX>::kTileBytes + kZBytes +
         kBiasBytes + kTableBytes + 16 * kRing;
}
static_assert(smem_bytes<256>() <= 227 * 1024, "one CTA an SM");

__device__ __align__(16) __nv_bfloat16 g_tables[kTables];  // sigmoid | tanh

// entry i of a table over biased exponents [lo, hi): its bf16 input
__device__ __forceinline__ float table_input(int i, int lo, int hi) {
  const int per_sign = (hi - lo) * 128;
  const uint32_t sign = i / per_sign, rest = i % per_sign;
  const uint32_t bits = (sign << 15) | ((lo + rest / 128) << 7) | (rest % 128);
  return __uint_as_float(bits << 16);
}

__global__ void fill_tables_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kSigN) {
    g_tables[i] = __float2bfloat16_rn(
        sigmoid_direct(table_input(i, kSigLo, kSigHi)));
  } else if (i < kTables) {
    g_tables[i] = __float2bfloat16_rn(
        tanh_direct(table_input(i - kSigN, kTanhLo, kTanhHi)));
  }
}

// The table entry of a bf16 value v (its exponent clamped into [lo, hi));
// *e gets v's biased exponent.
template <int lo, int hi>
__device__ __forceinline__ float lookup(const __nv_bfloat16* tab, float v,
                                        int* e) {
  const uint32_t b = __float_as_uint(v) >> 16;
  *e = (b >> 7) & 0xFF;
  const int ec = min(max(*e, lo), hi - 1);
  return __bfloat162float(
      tab[(((b >> 15) * (hi - lo) + ec - lo) << 7) | (b & 0x7F)]);
}

__device__ __forceinline__ float sigmoid_of(const __nv_bfloat16* tab,
                                            float v) {
  int e;
  const float t = lookup<kSigLo, kSigHi>(tab, v, &e);
  const float r = e < kSigLo ? 0.5f : e >= kSigHi ? (v > 0.f ? 1.f : 0.f) : t;
  return v != v ? v : r;
}

__device__ __forceinline__ float tanh_of(const __nv_bfloat16* tab, float v) {
  int e;
  const float t = lookup<kTanhLo, kTanhHi>(tab + kSigN, v, &e);
  return e < kTanhLo || v != v ? v
         : e >= kTanhHi        ? (v > 0.f ? 1.f : -1.f)
                               : t;
}

// two gates: bf16(sigmoid(bf16(bf16(acc + bias) + pre)))
__device__ __forceinline__ float2 sigmoid2(const __nv_bfloat16* tab,
                                           float2 acc, float2 bias,
                                           float2 pre) {
  const float2 t = round2(acc.x + bias.x, acc.y + bias.y);
  const float2 v = round2(t.x + pre.x, t.y + pre.y);
  return make_float2(sigmoid_of(tab, v.x), sigmoid_of(tab, v.y));
}

// two outputs: q = bf16(tanh(bf16(bf16(acc + bias) + pre))), then
// bf16(1 - z) * h + bf16(z * q)
__device__ __forceinline__ float2 blend2(const __nv_bfloat16* tab, float2 acc,
                                         float2 bias, float2 pre, float2 z,
                                         float2 h) {
  const float2 t = round2(acc.x + bias.x, acc.y + bias.y);
  const float2 v = round2(t.x + pre.x, t.y + pre.y);
  const float2 q = make_float2(tanh_of(tab, v.x), tanh_of(tab, v.y));
  const float2 keep = round2(1.f - z.x, 1.f - z.y);
  const float2 zq = round2(z.x * q.x, z.y * q.y);
  return make_float2(keep.x * h.x + zq.x, keep.y * h.y + zq.y);
}

template <int kX>
__global__ void __launch_bounds__(kBlock, 1)
gru_update_kernel(const __grid_constant__ GruParams P) {
  using S = Shape<kX>;
  constexpr int kLdA = S::kLdA, kSlicesPerTap = S::kSlicesPerTap;
  constexpr int kSlices = S::kSlices;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw) + kRing * kStageBytes;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(sm);
  sm += S::kTileBytes;
  __nv_bfloat16* Zs = reinterpret_cast<__nv_bfloat16*>(sm);
  sm += kZBytes;
  float* bias = reinterpret_cast<float*>(sm);   // bzr | bq
  sm += kBiasBytes;
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(sm);
  sm += kTableBytes;
  const Ring ring{base, smem_addr(sm), kRing, kStageBytes};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: the z taps, the r taps, the q taps ----
    regs_down<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int it = 0; it < 3 * kSlices; ++it) {
        const int pass = it / kSlices, i = it % kSlices;
        const int tap = i / kSlicesPerTap, kc = i % kSlicesPerTap;
        if (pass < 2) {
          ring.load(it, &P.wzr, kc * kSliceK, tap * 2 * kC + pass * kC,
                    kStageBytes);
        } else {
          ring.load(it, &P.wq, kc * kSliceK, tap * kC, kStageBytes);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  regs_up<232>();
  const int period = P.len + 2;
  const int p0 = blockIdx.x * kOut;   // first output position
  // position p -> pixel; false for a zero position
  auto pixel = [&](int p, size_t& pix) {
    if (p < 0) return false;
    const int line = p / period;
    const int s = p - line * period;
    if (line >= P.n_lines || s >= P.len) return false;
    pix = (size_t)line * P.line_stride + (size_t)s * P.pos_stride;
    return true;
  };

  // the tile: row i is position p0 - 4 + i
  for (int idx = tid; idx < kTile * (kX / 8); idx += kConsumers) {
    const int i = idx / (kX / 8), c = (idx % (kX / 8)) * 8;
    size_t pix = 0;
    const bool inside = pixel(p0 - 4 + i, pix);
    cp_async_16_zfill(As + i * kLdA + kC + c, P.x + pix * kX + c, inside);
  }
  for (int i = tid; i < kTables / 8; i += kConsumers) {
    cp_async_16_zfill(tab + 8 * i, g_tables + 8 * i, true);
  }
  cp_async_commit();
  load_quads_as_bf16<9>(
      kTile * (kC / 4), kConsumers, tid,
      [&](int idx) -> const float* {
        size_t pix = 0;
        return pixel(p0 - 4 + idx / (kC / 4), pix)
                   ? P.h + pix * kC + (idx % (kC / 4)) * 4 : nullptr;
      },
      [&](int idx) { return As + (idx / (kC / 4)) * kLdA + (idx % (kC / 4)) * 4; });
  for (int i = tid; i < 3 * kC; i += kConsumers) {
    bias[i] = i < 2 * kC ? P.bzr[i] : P.bq[i - 2 * kC];
  }
  cp_async_wait<0>();
  named_sync(1, kConsumers);

  // z|r row j is position p0 - 2 + j and reads tile rows j .. j + 4
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;
  const int a_row = row0 + (lane & 15);
  const int r0 = row0 + (lane >> 2);        // accumulator rows r0, r0 + 8
  const int cq = 2 * (lane & 3);
  size_t pix[2];
  bool inside[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pix[hh] = 0;
    inside[hh] = pixel(p0 - 2 + r0 + 8 * hh, pix[hh]);
  }
  float acc[64];                            // 64 rows x 128 channels

  // The epilogues work in chunks of eight channel pairs: every load first,
  // then the arithmetic, then every store (a store through a pointer the
  // compiler cannot tell from the tables' would hold back the next pair's
  // loads, and the gates would run one after another).

  // z, kept in shared memory for the blend
  wgmma_pass(acc, As, kLdA, a_row, 5, 0, 5, kSlicesPerTap, ring, 0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const __nv_bfloat16* pre_z = P.pre_zr + pix[hh] * (2 * kC) + cq;
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {
      float2 pre[8], b[8], g[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pre[j] = ld_bf16x2(pre_z + 8 * (j0 + j));
        b[j] = *reinterpret_cast<const float2*>(bias + 8 * (j0 + j) + cq);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ai = 4 * (j0 + j) + 2 * hh;
        g[j] = sigmoid2(tab, make_float2(acc[ai], acc[ai + 1]), b[j], pre[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store_bf16x2(Zs + (r0 + 8 * hh) * kLdZ + 8 * (j0 + j) + cq, g[j].x,
                     g[j].y);
      }
    }
  }

  // r, then r * h into the tile's h half
  wgmma_pass(acc, As, kLdA, a_row, 5, 0, 5, kSlicesPerTap, ring, kSlices);
  named_sync(1, kConsumers);                // every warp's reads of h are done
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const __nv_bfloat16* pre_r = P.pre_zr + pix[hh] * (2 * kC) + kC + cq;
    const float* hp = P.h + pix[hh] * kC + cq;
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {
      float2 pre[8], hv[8], b[8], rh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pre[j] = ld_bf16x2(pre_r + 8 * (j0 + j));
        hv[j] = ld_f32x2(hp + 8 * (j0 + j));
        b[j] = *reinterpret_cast<const float2*>(bias + kC + 8 * (j0 + j) + cq);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ai = 4 * (j0 + j) + 2 * hh;
        const float2 r = sigmoid2(tab, make_float2(acc[ai], acc[ai + 1]), b[j],
                                  pre[j]);
        rh[j] = inside[hh] ? make_float2(r.x * hv[j].x, r.y * hv[j].y)
                           : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store_bf16x2(As + (r0 + 8 * hh + 2) * kLdA + 8 * (j0 + j) + cq,
                     rh[j].x, rh[j].y);
      }
    }
  }
  named_sync(1, kConsumers);                // the tile holds cat(rh, x)

  // q and the blend
  wgmma_pass(acc, As, kLdA, a_row, 5, 0, 5, kSlicesPerTap, ring, 2 * kSlices);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r < 2 || r >= kRows - 2 || !inside[hh]) continue;
    const __nv_bfloat16* pre_q = P.pre_q + pix[hh] * kC + cq;
    const float* hp = P.h + pix[hh] * kC + cq;
    float* out = P.out + pix[hh] * kC + cq;
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {
      float2 pre[8], hv[8], b[8], z[8], o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * (j0 + j) + cq;
        pre[j] = ld_bf16x2(pre_q + 8 * (j0 + j));
        hv[j] = ld_f32x2(hp + 8 * (j0 + j));
        b[j] = *reinterpret_cast<const float2*>(bias + 2 * kC + col);
        z[j] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Zs + r * kLdZ + col));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ai = 4 * (j0 + j) + 2 * hh;
        o[j] = blend2(tab, make_float2(acc[ai], acc[ai + 1]), b[j], pre[j],
                      z[j], hv[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * (j0 + j)) = o[j];
      }
    }
  }
}

// a site's maps by the motion width (0: 128, 1: 256), since a freed tap
// stack's address may come back holding the other width's taps
TapMaps<8> g_zr_maps[2], g_q_maps[2];
constexpr int kMaxDevices = 64;
bool g_tables_ready[kMaxDevices];

template <int kX>
int launch(const GruParams& P, void* stream) {
  constexpr size_t smem = smem_bytes<kX>();
  cudaError_t err = cudaFuncSetAttribute(
      gru_update_kernel<kX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int positions = P.n_lines * (P.len + 2);
  gru_update_kernel<kX><<<(positions + kOut - 1) / kOut, kBlock, smem,
                          (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace
// One gated update along an axis of a (n_lines x len)-pixel map whose pixel
// (line, s) lies at pixel index line * line_stride + s * pos_stride: for a
// channels-minor (H, W, C) map, along W: n_lines = H, len = W, strides (W,
// 1); along H: n_lines = W, len = H, strides (1, W). h, out: float32, 128
// channels; x: bf16, `channels` = 128 (RAFT's motion features) or 256
// (GMA's cat(mf, mf_g)); pre_q: bf16, 128; pre_zr: bf16, 256; wzr
// [5][256][128 + channels] and wq [5][128][128 + channels] bf16, input
// channels minor; bzr (256), bq (128) float32. All
// contiguous and 16-byte aligned; out must not alias h. The taps' tensor
// maps are encoded at the first call with a pointer and kept for the last
// eight; the first call on a device also fills the gate tables (one small
// kernel, waited for on `stream`). Returns cudaGetLastError(), or 10000 + the CUresult of a failed
// encode, or 20000 when the driver has no cuTensorMapEncodeTiled.
extern "C" int woft_gru_update(const void* h, const void* x,
                               const void* pre_zr, const void* pre_q,
                               const void* wzr, const void* wq,
                               const void* bzr, const void* bq, void* out,
                               int channels, int n_lines, int len,
                               int line_stride, int pos_stride, void* stream) {
  if ((channels != 128 && channels != 256) || n_lines < 1 || len < 1 ||
      line_stride < 1 || pos_stride < 1 ||
      (long long)n_lines * (len + 2) > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const int wide = channels == 256, in = kC + channels;
  const CUtensorMap *mzr, *mq;
  int rc = g_zr_maps[wide].get(wzr, in, 5 * 2 * kC, kC, &mzr);
  if (rc) return rc;
  if ((rc = g_q_maps[wide].get(wq, in, 5 * kC, kC, &mq))) return rc;
  const GruParams P = {*mzr, *mq,
                       static_cast<const float*>(h),
                       static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(pre_zr),
                       static_cast<const __nv_bfloat16*>(pre_q),
                       static_cast<const float*>(bzr),
                       static_cast<const float*>(bq),
                       static_cast<float*>(out),
                       n_lines, len, line_stride, pos_stride};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_tables_ready[device]) {
    // once a device: the gate tables, ready before any launch reads them
    fill_tables_kernel<<<(kTables + 255) / 256, 256, 0,
                         (cudaStream_t)stream>>>();
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = cudaStreamSynchronize((cudaStream_t)stream)) != cudaSuccess) {
      return (int)err;
    }
    g_tables_ready[device] = true;
  }
  return wide ? launch<256>(P, stream) : launch<128>(P, stream);
}
