// Kernel C: construction of every level of the block-local correlation
// volume in one launch, queries minor.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/local_corr.py:
// block_local_corr -> _corr_pallas (pallas_call at :135) in its p_major
// form. There each grid step owns one (8, 16) query block, copies the
// block's window of the zero-padded target features into fast memory with
// one DMA (origin (by*sh, (bx*sw)//8*8): the x-origin is a multiple of 8
// because the DMA must be tile-aligned) and multiplies it with the block's
// 128 query features on the matrix unit, one launch a level.
//
// Function: out_l[b, py, px, q] = scale * sum_d win_b[py, px, d] * f1b[b, q, d]
// with win_b[py, px] = f2_l[by*sh - pad + py, (bx*sw)//8*8 - pad + px] and
// zero outside the level, b = by*nbw + bx, float32 accumulation, one
// rounding to the output type. A launch may compute a band of the grid:
// blocks b0 .. b0 + nb - 1 (the spatially sharded forward gives each rank
// its own band), query block and volume at the band's local index
// b - b0, the window at the grid's block b; b0 = 0 is the whole grid.
// The quantised x-origin is part of the function (it decides where a
// far-off lookup saturates), so it is kept.
//
// Bound on the H100 at 720p (120 blocks, D = 256, four levels, windows of
// 3,200 / 1,200 / 704 / 672 positions): 2 * 120 * 128 * 256 * 5,776 = 45.4
// GFLOP a flow. In bf16 each input read once and the volume written once
// are 7.9 MB of queries + 9.8 MB of levels + 177.4 MB of volume: 58 us at
// 3.35 TB/s, against 46 us for the product at the tensor cores' 989
// TFLOP/s: bytes-bound, but only just. mma.sync, fed from shared memory
// through registers, reaches about a sixth of that rate here (166 TFLOP/s
// with the previous design), so the product hid nothing; only wgmma, which
// reads both operands from shared memory asynchronously, runs the product
// under the write stream. In float32 (67 TFLOP/s outside the tensor cores)
// the product bounds it: 0.68 ms.
//
// bf16 design: one launch a flow, one CTA a query block (120 CTAs on 132
// SMs at 720p). A block's product is 378 MFLOP, 50 us at one SM's share of
// the wgmma peak, and it writes 1.48 MB, 53 us of the whole card's write
// rate when the 120 blocks write together: one CTA a block keeps the
// 128 x 256 query tile (64 KB) resident and reads it once, where the
// previous design read it once per 128 window positions (722 MB of L2
// traffic a flow, now 372 MB: the windows once a block plus 7.9 MB of
// queries). Dealing tiles to a persistent grid of 132 would fill the last
// 12 SMs but reload query tiles and race for them; not done.
//   - Tiles are whole window rows, at most 128 positions (ops/kernels.py:
//     local_corr_table; at 720p 2 x 64, 3 x 40, 4 x 32, 4 x 32 positions,
//     47 tiles a block). A tile's rows are one TMA box (64 channels, ww
//     columns, rows) of the UNPADDED (hl, wl, D) level at (by*sh - pad +
//     t*rows, (bx*sw)//8*8 - pad): TMA fills the box outside the level
//     with zeros, which is exactly the function's padding.
//   - One producer warp keeps a ring of six 16 KB K-slices (128 positions
//     x 64 channels, 128-byte swizzle) full, one mbarrier pair a slice.
//   - Two consumer warpgroups each multiply one 64-position half of a tile
//     with wgmma.mma_async m64n128k16 (bf16 in, float32 accumulators),
//     both operands read from shared memory through descriptors.
//   - Epilogue: scale, round once to bf16, stage in a 128-byte-swizzled
//     32 KB buffer (two, alternating), and write the tile's m x 256-byte
//     output span with two TMA stores, which run under the next tile's
//     product; TMA clips the rows beyond the window.
// Shared memory: 64 KB queries + 96 KB ring + 64 KB staging = 224 KB.
//
// What bounds it (tools/torch_kernel_ablate.py, PERF.md): with K = 256 a
// tile's products take about 1.1 us at the SM's wgmma rate, and its
// epilogue (staging, two barriers, the store hand-off) and the pipeline's
// drain and refill about as long again, after the products, not under
// them; leaving out the window loads, the products or the stores each
// saves under 10 %. Designs that tried to run the epilogue under the next
// tile's products were no faster: warpgroups taking whole tiles in turn,
// each with its own ring (they fell into step: both multiplied, then both
// staged), two accumulator sets taken in turn (ptxas serialised the
// wgmmas, C7518, in every arrangement tried), and stores straight from
// the accumulators instead of staging (16 bytes of 8 rows a warp store:
// twice as slow).
// Tensor maps are encoded on the host once per level set and pointer set
// (ops/kernels.py caches the parameter block), with cuTensorMapEncodeTiled
// taken through cudaGetDriverEntryPoint: the library links no -lcuda.
//
// float32 design (no config sets it): 256 threads a 128-position x
// 128-query tile, explicit fmaf from transposed shared-memory slices (TF32
// would round the features), the window read straight from the unpadded
// level with bounds checks; all levels in one launch through the same
// level table.
//
// The sum runs in another order than the plain version's einsum
// (models/corr.py:block_local_corr_plain), so the two agree to float32
// accumulation error (about 1e-5 relative) and, after rounding to bf16, to
// one bf16 ulp on a small share of entries.
#include <string.h>

#include "conv_wgmma.cuh"   // mbarrier, TMA and descriptor helpers

namespace {

using namespace woft;

constexpr int kMaxLevels = 8;
constexpr int kBQ = 128;               // queries a block

struct LevelGeom {
  const void* f2;   // (hl, wl, D) level
  void* out;        // (nb, wh, ww, 128) volume
  int hl, wl, pad, sh, sw, wh, ww;
  int rows;         // bf16: window rows a tile
  int tiles;        // bf16: tiles of the level
  int tile0;        // float32: first blockIdx.x of the level
};

struct Geom {
  LevelGeom lv[kMaxLevels];
  const void* f1b;  // (nb, 128, D): the band's query blocks
  int L, nb, nbw, D, f32_tiles, is_bf16;
  int b0;           // the band's first block in the nbh x nbw grid
  float scale;
};

struct Maps {
  CUtensorMap q;                  // f1b as (D, nb*128), box (64, 128)
  CUtensorMap win[kMaxLevels];    // level as (D, wl, hl), box (64, ww, rows)
  CUtensorMap out[kMaxLevels];    // volume as (128, wh*ww, nb), box (64, m, 1)
};

struct Params {
  Maps maps;
  Geom g;
};

// ---------------------------------------------------------------- bf16 ----

constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kThreadsBf16 = kConsumerThreads + 32;   // + the producer warp
constexpr int kStages = 6;             // ring of K-slices
constexpr int kSlice = 128 * 128;      // 128 rows of 64 bf16 channels
constexpr int kStage = 2 * kSlice;     // staged output tile: 128 x 128 bf16

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 tile, float32) (+)= A (64 x 16) * B (16 x 128)^T, both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
local_corr_bf16_kernel(const __grid_constant__ Params P) {
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment: the 128-byte swizzle repeats every 8 rows
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Geom& G = P.g;
  const int KC = G.D / 64;                       // K-slices a tile
  const uint32_t q_s = base;                     // KC x 16 KB
  const uint32_t ring = q_s + KC * kSlice;       // kStages x 16 KB
  const uint32_t stage = ring + kStages * kSlice;  // 2 x 32 KB
  const uint32_t bars = stage + 2 * kStage;
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {
    // ---- producer: the query tile once, then every window K-slice ----
    if (lane == 0) {
      mbar_expect_tx(q_bar, KC * kSlice);
      for (int kc = 0; kc < KC; ++kc)
        tma_load_2d(q_s + kc * kSlice, &P.maps.q, kc * 64, b * kBQ, q_bar);
      const int by = (G.b0 + b) / G.nbw, bx = G.b0 + b - by * G.nbw;
      int it = 0;
      for (int l = 0; l < G.L; ++l) {
        const LevelGeom& lv = G.lv[l];
        const int y0 = by * lv.sh - lv.pad;
        const int x0 = (bx * lv.sw) / 8 * 8 - lv.pad;
        const uint32_t bytes = 128u * lv.rows * lv.ww;
        for (int t = 0; t < lv.tiles; ++t) {
          for (int kc = 0; kc < KC; ++kc, ++it) {
            const int s = it % kStages;
            mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full(s), bytes); tma_load_3d(ring + s * kSlice, &P.maps.win[l], kc * 64, x0, y0 + t * lv.rows, full(s));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies rows wg*64 .. wg*64+63 ----
  const int wg = tid >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(q_bar, 0);
  // this thread's accumulator rows r0 and r0 + 8 of the tile
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const uint32_t col_bytes = (uint32_t)(lane & 3) * 4;
  int it = 0, tile_no = 0;
  for (int l = 0; l < G.L; ++l) {
    const LevelGeom& lv = G.lv[l];
    const int m = lv.rows * lv.ww;
    for (int t = 0; t < lv.tiles; ++t, ++tile_no) {
      int prev = 0;
      for (int kc = 0; kc < KC; ++kc, ++it) {
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        const uint32_t a = ring + s * kSlice + wg * (64 * 128);
        const uint32_t bq = q_s + kc * kSlice;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16(acc, sw128_desc(a + 32 * k), sw128_desc(bq + 32 * k), (kc | k) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kc > 0) {
          // the previous slice's products are done: hand it back
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = s;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      keep_acc(acc);
      if (lane == 0) mbar_arrive(empty(prev));

      // epilogue: stage buffer tile_no % 2 was last read by the TMA store
      // issued two tiles ago
      const uint32_t sb = stage + (tile_no & 1) * kStage;
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      named_sync(1, kConsumerThreads);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // queries 8j .. 8j+7: half j/8 of the row, 16-byte chunk j%8,
        // swizzled by the row's index mod 8
        const uint32_t half = sb + (j >> 3) * kSlice;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] * G.scale, acc[4 * j + 2 * i + 1] * G.scale);
          const uint32_t dst = half + r * 128 + (((j & 7) ^ (r & 7)) << 4) + col_bytes;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(dst),
                       "r"(*reinterpret_cast<const uint32_t*>(&v)) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, kConsumerThreads);
      if (tid == 0) {
        for (int h = 0; h < 2; ++h)
          tma_store_3d(&P.maps.out[l], sb + h * kSlice, h * 64, t * m, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

size_t bf16_smem_bytes(int D) {
  return 1024 + (size_t)(D / 64) * kSlice + (size_t)kStages * kSlice +
         2 * (size_t)kStage + 8 * (1 + 2 * kStages);
}

// ------------------------------------------------------------- float32 ----

constexpr int kBM = 128;               // window positions a tile
constexpr int kThreadsF32 = 256;
constexpr int kBKf = 16;               // K-slice, float32 elements
constexpr int kLdf = kBM + 4;          // padded, keeps float4 alignment

// Source row of window position p of query block b, or nullptr when the
// position lies in the zero padding or beyond the window.
__device__ __forceinline__ const float* window_row(const LevelGeom& lv, int D,
                                                   int nbw, int b, int p) {
  if (p >= lv.wh * lv.ww) return nullptr;
  const int by = b / nbw;
  const int bx = b - by * nbw;
  const int py = p / lv.ww;
  const int y = by * lv.sh - lv.pad + py;
  const int x = (bx * lv.sw) / 8 * 8 - lv.pad + (p - py * lv.ww);
  if (y < 0 || y >= lv.hl || x < 0 || x >= lv.wl) return nullptr;
  return static_cast<const float*>(lv.f2) + ((size_t)y * lv.wl + x) * D;
}

__global__ void __launch_bounds__(kThreadsF32)
local_corr_f32_kernel(const Geom G) {
  __shared__ __align__(16) float As[kBKf][kLdf];   // [d][position]
  __shared__ __align__(16) float Bs[kBKf][kLdf];   // [d][query]

  int l = 0;
  while (l + 1 < G.L && (int)blockIdx.x >= G.lv[l + 1].tile0) ++l;
  const LevelGeom& lv = G.lv[l];
  const int b = blockIdx.y;
  const int p0 = (blockIdx.x - lv.tile0) * kBM;
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;              // 16 x 16 threads

  // loader: row lr, 8 elements at column lc
  const int lr = t >> 1, lc = (t & 1) * 8;
  const float* a_src = window_row(lv, G.D, G.nbw, G.b0 + b, p0 + lr);
  const float* b_src =
      static_cast<const float*>(G.f1b) + ((size_t)b * kBQ + lr) * G.D;
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
  for (int k0 = 0; k0 < G.D; k0 += kBKf) {
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
    if (k0 + kBKf < G.D) fetch(k0 + kBKf);
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

  const int np = lv.wh * lv.ww;
  float* out_b = static_cast<float*>(lv.out) + (size_t)b * np * kBQ;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = p0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r < np) {
      float* row = out_b + (size_t)r * kBQ;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[i][0] * G.scale, acc[i][1] * G.scale,
                      acc[i][2] * G.scale, acc[i][3] * G.scale);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) =
          make_float4(acc[i][4] * G.scale, acc[i][5] * G.scale,
                      acc[i][6] * G.scale, acc[i][7] * G.scale);
    }
  }
}

// ---------------------------------------------------------------- host ----

// A bf16 tensor map with 128-byte swizzle: dims and box innermost first,
// strides in bytes of dims 1 .. rank-1.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

}  // namespace

extern "C" int woft_local_corr_params_size() { return (int)sizeof(Params); }

// Fills the parameter block of one launch (tensor maps included) into
// params (woft_local_corr_params_size() bytes). The launch computes blocks
// b0 .. b0 + nb - 1 of the grid of nbw block columns. f1b (nb, 128, D)
// those blocks' query features; f2s[l] (hl, wl, D) unpadded levels;
// outs[l] (nb, wh, ww, 128) volumes; all of one element type, bfloat16
// when is_bf16 else float32, contiguous and 16-byte aligned. geo: L rows of hl, wl, pad, sh,
// sw, wh, ww, rows, tiles (rows and tiles: the bf16 tiling, whole window
// rows of at most 128 positions, ops/kernels.py:local_corr_table). bf16
// needs D a multiple of 64 up to 256, float32 a multiple of 32. Returns 0,
// cudaErrorInvalidValue, 10000 + the CUresult of a failed encode, or 20000
// when the driver has no cuTensorMapEncodeTiled.
extern "C" int woft_local_corr_plan(const void* f1b, const void* const* f2s,
                                    void* const* outs, const int* geo, int L,
                                    int nb, int nbw, int b0, int D,
                                    float scale, int is_bf16, void* params) {
  if (L < 1 || L > kMaxLevels || nb < 1 || nbw < 1 || b0 < 0 || D < 32 ||
      D % 32 ||
      (is_bf16 && (D % 64 || D > 256))) {
    return (int)cudaErrorInvalidValue;
  }
  Params P;
  memset(&P, 0, sizeof P);
  Geom& G = P.g;
  G.f1b = f1b;
  G.L = L;
  G.nb = nb;
  G.nbw = nbw;
  G.b0 = b0;
  G.D = D;
  G.is_bf16 = is_bf16;
  G.scale = scale;
  int f32_tiles = 0;
  for (int l = 0; l < L; ++l) {
    const int* r = geo + 9 * l;
    LevelGeom& lv = G.lv[l];
    lv = LevelGeom{f2s[l], outs[l], r[0], r[1], r[2], r[3], r[4], r[5], r[6],
                   r[7], r[8], f32_tiles};
    if (lv.hl < 1 || lv.wl < 1 || lv.wh < 1 || lv.ww < 1 || lv.ww > 128 ||
        lv.rows < 1 || lv.rows * lv.ww > 128 || lv.tiles * lv.rows < lv.wh) {
      return (int)cudaErrorInvalidValue;
    }
    f32_tiles += (lv.wh * lv.ww + kBM - 1) / kBM;
  }
  G.f32_tiles = f32_tiles;
  if (is_bf16) {
    EncodeTiled fn;
    int rc = tap_encoder(&fn);
    if (rc) return rc;
    const cuuint64_t qd[2] = {(cuuint64_t)D, (cuuint64_t)nb * kBQ};
    const cuuint64_t qs[1] = {(cuuint64_t)D * 2};
    const cuuint32_t qb[2] = {64, kBQ};
    if ((rc = encode(fn, &P.maps.q, f1b, 2, qd, qs, qb))) return rc;
    for (int l = 0; l < L; ++l) {
      const LevelGeom& lv = G.lv[l];
      const cuuint64_t wd[3] = {(cuuint64_t)D, (cuuint64_t)lv.wl,
                                (cuuint64_t)lv.hl};
      const cuuint64_t ws[2] = {(cuuint64_t)D * 2, (cuuint64_t)lv.wl * D * 2};
      const cuuint32_t wb[3] = {64, (cuuint32_t)lv.ww, (cuuint32_t)lv.rows};
      if ((rc = encode(fn, &P.maps.win[l], lv.f2, 3, wd, ws, wb))) return rc;
      const cuuint64_t np = (cuuint64_t)lv.wh * lv.ww;
      const cuuint64_t od[3] = {kBQ, np, (cuuint64_t)nb};
      const cuuint64_t os[2] = {kBQ * 2, np * kBQ * 2};
      const cuuint32_t ob[3] = {64, (cuuint32_t)(lv.rows * lv.ww), 1};
      if ((rc = encode(fn, &P.maps.out[l], lv.out, 3, od, os, ob))) return rc;
    }
  }
  memcpy(params, &P, sizeof P);
  return 0;
}

// Launches kernel C with a parameter block from woft_local_corr_plan.
// Returns cudaGetLastError().
extern "C" int woft_local_corr_launch(const void* params, void* stream) {
  Params P;
  memcpy(&P, params, sizeof P);
  cudaStream_t s = (cudaStream_t)stream;
  if (P.g.is_bf16) {
    const size_t smem = bf16_smem_bytes(P.g.D);
    cudaError_t rc = cudaFuncSetAttribute(
        local_corr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    local_corr_bf16_kernel<<<P.g.nb, kThreadsBf16, smem, s>>>(P);
  } else {
    local_corr_f32_kernel<<<dim3((unsigned)P.g.f32_tiles, (unsigned)P.g.nb),
                            kThreadsF32, 0, s>>>(P.g);
  }
  return (int)cudaGetLastError();
}
