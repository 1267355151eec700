// Kernels D, E, F: bilinear (2r+1)^2 window lookups in the block-local
// correlation volume, queries minor.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/local_lookup.py in its three
// forms:
//   D  block_local_lookup_fine_multi (pallas_call at :288): all levels in one
//      launch, each block reading an (fr, fc) fine sub-window at a per-block
//      anchor;
//   E  block_local_lookup (:421): one level, the whole stored window, one
//      launch a level; here all levels of a lookup in one launch;
//   F  block_local_lookup_fine (:204): D for one level.
// The TPU kernels keep a block's 128 queries in the vector lanes and avoid
// gathers: each query's slab start is expanded into a two-hot weight row and
// the kernel sums over every possible start (n_s + n_t multiply-adds per
// output row, of which two per axis are non-zero), with double-buffered
// DMAs of the sub-windows; the starts, anchors and the exactness flags are
// computed around the kernel by XLA (woft_tpu/models/corr.py:553-627). Here
// a thread reads its own four taps, and D and E take the (H1, W1, 2)
// level-0 coordinates and the layout's level table and compute each
// query's start, fraction, its block's anchor and the guard flag
// themselves, so a guarded lookup is two launches (D, then E under the
// flags) where the coordinate arithmetic took about twenty small ones.
// D and F also keep their explicit-operand entries (anchors, relative
// starts and fractions: the TPU kernel's own arguments); only the prologue
// that finds each query's start differs.
//
// Function: out[b, c0 + l*k*k + j*k + i, q] =
//     (v[y, x] (1-fy) + v[y+1, x] fy) (1-fx)
//   + (v[y, x+1] (1-fy) + v[y+1, x+1] fy) fx,
// y = ys + j, x = xs + i, v = vol_l[b, :, :, q], float32 arithmetic in this
// order (y blend, then x blend; the reference's order), rounded once to the
// output type. The coordinates enter as in models/corr.py:
// _local_level_coords: w = ((c / 2^l) + pad) - origin, clamped to
// [r, size - r - 1.001], start trunc(w) - r, fraction w - trunc(w); the
// block's anchor is its least start (columns rounded down to 8), clamped
// to [0, size - fine], and a start beyond anchor + rel_max saturates there
// and sets the block's flag for that level (_fine_anchor_starts). Built
// with --fmad=false, so every step rounds like the plain PyTorch version.
// The coordinate-driven entries may look up a band of the block grid:
// blocks b0 .. b0 + nb - 1, each block's queries and window origin those
// of the grid's block b, its volume, output rows and flags at the band's
// local index b - b0 (the spatially sharded forward gives each rank its
// own band); b0 = 0 is the whole grid.
//
// Bound on the H100 at 720p (120 blocks of 128 queries, 4 levels, bf16):
// each query and level needs one 10 x 10 patch (15,360 * 4 * 200 B = 12.3
// MB), the coordinates are 0.1 MB and the output 120 * 324 * 128 * 2 B =
// 10 MB: about 6.7 us at 3.35 TB/s. Device memory moves 32-byte sectors,
// and at one (y, x) the 16 queries of a query row are one bf16 sector, so
// the reads a kernel cannot avoid are the union of each query row's
// patches in sectors (chip_smoke.py computes it: 19.7 MB at its smooth
// 720p field, 0.0089 ms with the output and the coordinates). The blend
// is 6 flops per output plus 3 per column, far below the float32 rate.
//
// D's design: grid (block, level), 8 warps a CTA, one warp per query row
// of 16 queries (3,840 warps at 720p, 480 CTAs).
//   - Prologue: the CTA reduces its block's least and greatest coordinate
//     per axis (128 coordinates from L2, warp shuffles, one barrier). The
//     start is a monotone function of the coordinate, so the block's least
//     and greatest starts, hence its anchor and its flag, follow from 4
//     values, not from 128 starts. The block's CTA writes the flag: bad
//     (nb, L) is written in full, no zeroing.
//   - Each warp then works alone: its 16 queries' clamped starts (both
//     half-warps), their bounding box by warp reductions, and the box
//     copied into the warp's own shared-memory region with 16-byte
//     cp.async, 32 bytes (bf16) a position: every sector of the box is read
//     from device memory once, where the previous design (one CTA per
//     window row, one thread a query) read each value twice and touched up
//     to 32 sectors with one load.
//   - Blend: half-warp h writes output rows 5h .. 5h + 4 (h = 1: 5 .. 8)
//     of its query, walking window rows 5h .. 5h + 5
//     and keeping the previous row's 10 values in registers (110 reads for
//     81 outputs instead of 180), and stores out[.., j*k + i, q]: 16 queries
//     write one 32-byte piece. The staged row stride is padded so the two
//     half-warps fall on other banks.
//   - A warp stages at most 320 positions (10 KB in bf16, 80 KB a CTA, 2
//     CTAs an SM): a smooth field's level-0 box is about 11 x 26. A larger
//     box (a violating block, or explicit operands not bound to a fine
//     window) is read from device memory directly, with the same
//     arithmetic. The whole fine window of all 128 queries (240 KB) would
//     not fit one CTA.
// What bounds it (tools/torch_kernel_ablate.py, PERF.md): not the bytes.
// An empty launch of the grid takes a fifth of its time, the prologue
// another fifth, the blend's dependent shared-memory reads and arithmetic
// a third; the copies and the stores add the rest. 8 warps a CTA ran
// slightly faster than 4 or 2; 8-query groups with 4 lanes a query, or a
// larger box, made it slower.
//
// E under the exactness guard writes only the blocks whose flag is set: at
// 720p the 10 blocks of the last block row (their padding queries violate
// the fine window on every lookup). Grid (nb, levels, z): all k rows of a
// (query block, level) at once, in as few CTAs of up to 1,024 threads as
// hold them (two at bq = 128: rows 0-4 and 5-8); an unflagged block's CTAs
// read its L flag bytes and return. (Looping a thread over two rows, 480
// CTAs, took 8.3 us a lookup against 6.3: the flagged blocks' dependent
// loads, not the launch, set the time.) Its loads go straight to device
// memory: one thread a query, walking its k + 1 columns once.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kRowQ = 16;                 // queries of one staged query row
// D: warps a CTA, one query row each
constexpr int kWarps = 8;
// D: (y, x) positions a warp stages, 10 KB in bf16: a smooth field's
// level-0 box is about 11 x 26; a larger box (a violating block) is read
// from device memory directly
constexpr int kStagePositions = 320;
// level table of the coordinate-driven entries (ops/kernels.py builds it
// from models/corr.py:_lookup_constants): header H1, W1, nbw, bh, bw, r;
// per level wh, ww, sh, sw, fr, fc, rel_max (y, x), anchor_max (y, x) as
// ints and div, pad, hi (y, x) as floats
constexpr int kHeader = 6;
constexpr int kLevelInts = 10;
constexpr int kLevelFloats = 4;

struct Level {
  const void* vol;    // (nb, wh, ww, bq)
  const int* ys;      // explicit entries: (nb, bq) row starts
  const int* xs;      // (nb, bq) column starts
  const float* fy;    // (nb, bq)
  const float* fx;    // (nb, bq)
  int wh, ww;
  // coordinate-driven entries: the level's layout
  int sh, sw, fr, fc, rel_max_y, rel_max_x, anchor_max_y, anchor_max_x;
  float div, pad, hi_y, hi_x;
};

struct Params {
  Level lv[kMaxLevels];
  int num_levels;
  const float* coords;          // (H1, W1, 2) (x, y), or null: explicit
  int H1, W1, nbw, bh, bw, r;
  int b0;                       // coordinates: the band's first block
  const int* anchors;           // explicit D: (nb, num_levels, 2) [r0, c0]
  const unsigned char* flag;    // explicit E: (nb,) or null
  const unsigned char* bad;     // E from coordinates: (nb, num_levels) or null
  unsigned char* bad_out;       // D from coordinates: (nb, num_levels)
  int bq, k;
  int out_channels;             // channels of a block's output
  int channel0;                 // first channel written
  int stage_positions;          // D: staged (y, x) positions a CTA holds
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Row stride, in positions, of a staged box nc positions wide: the two
// half-warps, which start 5 rows apart, land 16 banks apart (a position of
// 16 queries spans 8 banks in bf16, 16 in float32).
template <typename VT>
__host__ __device__ __forceinline__ int stage_stride(int nc) {
  return sizeof(VT) == 2 ? nc + ((6 - (nc & 3)) & 3) : (nc | 1);
}

// Level-0 coordinate (x, y) of query q of block (by, bx). Padding queries
// (beyond H1 or W1) sit at (0, 0), as the blocked layout's zero pad puts
// them.
__device__ __forceinline__ float2 query_coord(const Params& P, int by, int bx,
                                              int q) {
  const int qy = q / P.bw;
  const int py = by * P.bh + qy;
  const int px = bx * P.bw + (q - qy * P.bw);
  if (py < P.H1 && px < P.W1) {
    return reinterpret_cast<const float2*>(P.coords)[(size_t)py * P.W1 + px];
  }
  return make_float2(0.f, 0.f);
}

// One axis of a level: w = ((c / div) + pad) - origin clamped to [r, hi],
// the plain version's float32 operations in its order; returns the slab
// start trunc(w) - r, and the fraction w - trunc(w) in f. Every step is
// monotone in c, so the least (greatest) start of a set of coordinates is
// the start of the least (greatest) coordinate.
__device__ __forceinline__ int axis_start(float c, float div, float pad,
                                          float origin, float hi, int r,
                                          float& f) {
  float w = __fsub_rn(__fadd_rn(__fdiv_rn(c, div), pad), origin);
  w = fminf(fmaxf(w, (float)r), hi);
  const float t = truncf(w);
  f = __fsub_rn(w, t);
  return (int)t - r;
}

// Query q of the band's block b at level l, from the level-0 coordinates:
// its slab start (sy, sx) in the stored window and its fractions.
__device__ __forceinline__ void coord_start(const Params& P, int b, int l,
                                            int q, int& sy, int& sx,
                                            float& fy, float& fx) {
  const Level& lv = P.lv[l];
  const int by = (P.b0 + b) / P.nbw;
  const int bx = P.b0 + b - by * P.nbw;
  const float2 c = query_coord(P, by, bx, q);
  sy = axis_start(c.y, lv.div, lv.pad, (float)(by * lv.sh), lv.hi_y, P.r, fy);
  sx = axis_start(c.x, lv.div, lv.pad, (float)((bx * lv.sw) / 8 * 8),
                  lv.hi_x, P.r, fx);
}

// One output row: k outputs from rows row0 and row0 + row_step, columns
// col_step apart, written out_step apart.
template <typename VT, typename OT>
__device__ __forceinline__ void blend_row(const VT* row0, size_t row_step,
                                          size_t col_step, float fy, float fx,
                                          int k, OT* o, size_t out_step) {
  const VT* row1 = row0 + row_step;
  const float gy = 1.0f - fy;
  const float gx = 1.0f - fx;
  float prev = load(row0) * gy + load(row1) * fy;
  for (int i = 0; i < k; ++i) {
    const size_t c = (size_t)(i + 1) * col_step;
    const float next = load(row0 + c) * gy + load(row1 + c) * fy;
    store(o + (size_t)i * out_step, prev * gx + next * fx);
    prev = next;
  }
}

// Rows j0 .. j1 - 1 of one query's window: walks window rows j0 .. j1,
// keeping the previous row's k + 1 values in registers (11 reads a row
// pair become k + 1 a row), and writes out[.., j*k + i, q] out_step apart.
// Same arithmetic as blend_row.
template <typename VT, typename OT, int K>
__device__ __forceinline__ void blend_rows(const VT* v, int row_step,
                                           int col_step, float fy, float fx,
                                           int j0, int j1, OT* o,
                                           size_t out_step) {
  const float gy = 1.0f - fy;
  const float gx = 1.0f - fx;
  float top[K + 1];
#pragma unroll
  for (int i = 0; i <= K; ++i) top[i] = load(v + j0 * row_step + i * col_step);
  for (int j = j0; j < j1; ++j) {
    const VT* next_row = v + (j + 1) * row_step;
    float prev = 0.f;
#pragma unroll
    for (int i = 0; i <= K; ++i) {
      const float bot = load(next_row + i * col_step);
      const float col = top[i] * gy + bot * fy;
      top[i] = bot;
      if (i > 0) {
        store(o + ((size_t)j * K + i - 1) * out_step, prev * gx + col * fx);
      }
      prev = col;
    }
  }
}

// D and F: grid (nb, levels, query rows / kWarps), kWarps warps a CTA; warp
// w owns query row z * kWarps + w (16 queries) and its own staging region,
// so after the block's coordinate range everything is warp-local. Lane
// (q, h) = (lane % 16, lane / 16) writes window rows 5h .. 5h + 4 of query
// q (k = 9; other k: rows h, h + 2, ...).
template <typename VT, typename OT, bool kCoords>
__global__ void __launch_bounds__(kWarps * 32)
    local_lookup_fine_kernel(const __grid_constant__ Params P,
                             OT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ float s_part[kWarps][4];   // a warp's coordinate range
  const int b = blockIdx.x, l = blockIdx.y;
  const Level& lv = P.lv[l];
  const int k = P.k, bq = P.bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  VT* stage = reinterpret_cast<VT*>(stage_raw) +
              (size_t)warp * P.stage_positions * kRowQ;
  const int by = (P.b0 + b) / P.nbw;     // b0 = 0 from explicit operands
  const int bx = P.b0 + b - by * P.nbw;
  const float oy = (float)(by * lv.sh);
  const float ox = (float)((bx * lv.sw) / 8 * 8);

  // the block's anchor; from coordinates also its flag
  int r0, c0;
  if (kCoords) {
    // its least and greatest starts are those of its least and greatest
    // coordinates (axis_start)
    const float kInf = __int_as_float(0x7f800000);
    float mnx = kInf, mny = kInf, mxx = -kInf, mxy = -kInf;
    for (int q = tid; q < bq; q += kWarps * 32) {
      const float2 c = query_coord(P, by, bx, q);
      mnx = fminf(mnx, c.x);
      mny = fminf(mny, c.y);
      mxx = fmaxf(mxx, c.x);
      mxy = fmaxf(mxy, c.y);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, o));
      mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, o));
      mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, o));
      mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, o));
    }
    if (lane == 0) {
      s_part[warp][0] = mnx;
      s_part[warp][1] = mny;
      s_part[warp][2] = mxx;
      s_part[warp][3] = mxy;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      mnx = fminf(mnx, s_part[w][0]);
      mny = fminf(mny, s_part[w][1]);
      mxx = fmaxf(mxx, s_part[w][2]);
      mxy = fmaxf(mxy, s_part[w][3]);
    }
    float f;
    const int lo_y = axis_start(mny, lv.div, lv.pad, oy, lv.hi_y, P.r, f);
    const int lo_x = axis_start(mnx, lv.div, lv.pad, ox, lv.hi_x, P.r, f);
    r0 = min(max(lo_y, 0), lv.anchor_max_y);
    c0 = min(max(lo_x & -8, 0), lv.anchor_max_x);
    if (tid == 0 && blockIdx.z == 0) {
      const int hi_y = axis_start(mxy, lv.div, lv.pad, oy, lv.hi_y, P.r, f);
      const int hi_x = axis_start(mxx, lv.div, lv.pad, ox, lv.hi_x, P.r, f);
      P.bad_out[b * P.num_levels + l] =
          (hi_y - r0 > lv.rel_max_y) || (hi_x - c0 > lv.rel_max_x);
    }
  } else {
    r0 = P.anchors[(b * P.num_levels + l) * 2];
    c0 = P.anchors[(b * P.num_levels + l) * 2 + 1];
  }

  const int ql = lane & (kRowQ - 1);
  for (int row = blockIdx.z * kWarps + warp; row < bq / kRowQ;
       row += kWarps * gridDim.z) {
    // this lane's query: its clamped start, then the row's bounding box
    // (both half-warps hold the row's 16 queries)
    const int q0 = row * kRowQ;
    int ys, xs;
    float fy, fx;
    if (kCoords) {
      const float2 c = query_coord(P, by, bx, q0 + ql);
      ys = axis_start(c.y, lv.div, lv.pad, oy, lv.hi_y, P.r, fy);
      xs = axis_start(c.x, lv.div, lv.pad, ox, lv.hi_x, P.r, fx);
      ys = r0 + min(max(ys - r0, 0), lv.rel_max_y);
      xs = c0 + min(max(xs - c0, 0), lv.rel_max_x);
    } else {
      const size_t bi = (size_t)b * bq + q0 + ql;
      ys = lv.ys[bi] + r0;
      xs = lv.xs[bi] + c0;
      fy = lv.fy[bi];
      fx = lv.fx[bi];
    }
    ys = min(max(ys, 0), lv.wh - k - 1);
    xs = min(max(xs, 0), lv.ww - k - 1);
    const int r_lo = __reduce_min_sync(0xffffffffu, ys);
    const int c_lo = __reduce_min_sync(0xffffffffu, xs);
    const int nr = __reduce_max_sync(0xffffffffu, ys) + k + 1 - r_lo;
    const int nc = __reduce_max_sync(0xffffffffu, xs) + k + 1 - c_lo;
    const int stride = stage_stride<VT>(nc);
    const bool staged = nr * stride <= P.stage_positions;
    const VT* vol = static_cast<const VT*>(lv.vol) +
                    (size_t)b * lv.wh * lv.ww * bq + q0;
    if (staged) {
      constexpr int kPerChunk = 16 / (int)sizeof(VT);   // values in 16 B
      constexpr int kChunks = kRowQ / kPerChunk;        // pieces a position
      const int n = nc * kChunks;                       // pieces a row
      const VT* src = vol + ((size_t)r_lo * lv.ww + c_lo) * bq;
      VT* dst = stage;
      for (int rr = 0; rr < nr; ++rr) {
        for (int t = lane; t < n; t += 32) {
          const int cc = t / kChunks, ch = t % kChunks;   // powers of two
          cp_async16(dst + cc * kRowQ + ch * kPerChunk,
                     src + (size_t)cc * bq + ch * kPerChunk);
        }
        src += (size_t)lv.ww * bq;
        dst += stride * kRowQ;
      }
      cp_async_wait_all();
      __syncwarp();
    }
    OT* o = out + ((size_t)b * P.out_channels + P.channel0 +
                   (size_t)l * k * k) * bq + q0 + ql;
    if (staged && k == 9) {
      // half-warp h walks window rows 5h .. 5h + 4 (h = 1: rows 5 .. 8)
      const int j0 = lane < kRowQ ? 0 : 5;
      blend_rows<VT, OT, 9>(
          stage + ((ys - r_lo) * stride + (xs - c_lo)) * kRowQ + ql,
          stride * kRowQ, kRowQ, fy, fx, j0, lane < kRowQ ? 5 : 9, o, bq);
    } else {
      for (int j = lane / kRowQ; j < k; j += 2) {
        if (staged) {
          blend_row<VT, OT>(
              stage + ((ys - r_lo + j) * stride + (xs - c_lo)) * kRowQ + ql,
              (size_t)stride * kRowQ, kRowQ, fy, fx, k,
              o + (size_t)j * k * bq, bq);
        } else {
          blend_row<VT, OT>(vol + ((size_t)(ys + j) * lv.ww + xs) * bq + ql,
                            (size_t)lv.ww * bq, bq, fy, fx, k,
                            o + (size_t)j * k * bq, bq);
        }
      }
    }
    __syncwarp();      // the next row reuses the staging region
  }
}

// E: grid (nb, levels, z), block (threads, rows): the z blocks of a (query
// block, level) share its k rows, one row a thread row, in as few blocks
// as 1,024 threads allow; an unflagged query block's blocks read its flags
// and return.
template <typename VT, typename OT>
__global__ void local_lookup_exact_kernel(const __grid_constant__ Params P,
                                          OT* __restrict__ out) {
  const int b = blockIdx.x, l = blockIdx.y;
  if (P.flag != nullptr && P.flag[b] == 0) return;
  if (P.bad != nullptr) {
    bool any = false;
    for (int m = 0; m < P.num_levels; ++m) {
      any = any || P.bad[b * P.num_levels + m] != 0;
    }
    if (!any) return;
  }
  const int k = P.k, bq = P.bq;
  const Level& lv = P.lv[l];
  const int j0 = blockIdx.z * blockDim.y + threadIdx.y;
  const int jstep = gridDim.z * blockDim.y;
  const VT* vol = static_cast<const VT*>(lv.vol) +
                  (size_t)b * lv.wh * lv.ww * bq;
  for (int q = threadIdx.x; q < bq; q += blockDim.x) {
    int ys, xs;
    float fy, fx;
    if (P.coords != nullptr) {
      coord_start(P, b, l, q, ys, xs, fy, fx);
    } else {
      const size_t bi = (size_t)b * bq + q;
      ys = lv.ys[bi];
      xs = lv.xs[bi];
      fy = lv.fy[bi];
      fx = lv.fx[bi];
    }
    ys = min(max(ys, 0), lv.wh - k - 1);
    xs = min(max(xs, 0), lv.ww - k - 1);
    for (int j = j0; j < k; j += jstep) {
      OT* o = out + ((size_t)b * P.out_channels + P.channel0 +
                     (size_t)l * k * k + (size_t)j * k) * bq + q;
      blend_row<VT, OT>(vol + ((size_t)(ys + j) * lv.ww + xs) * bq + q,
                        (size_t)lv.ww * bq, bq, fy, fx, k, o, bq);
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed first.
template <typename K>
int allow_smem(K kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename VT, typename OT>
int launch_typed(const Params& P, int nb, bool exact, void* out,
                 cudaStream_t s) {
  OT* o = static_cast<OT*>(out);
  if (exact) {
    // every row at once, in as few blocks as 1,024 threads allow
    const int tx = P.bq < 1024 ? ((P.bq + 31) / 32) * 32 : 1024;
    const int z = (P.k + 1024 / tx - 1) / (1024 / tx);
    const int ty = (P.k + z - 1) / z;
    local_lookup_exact_kernel<VT, OT>
        <<<dim3((unsigned)nb, (unsigned)P.num_levels, (unsigned)z),
           dim3(tx, ty), 0, s>>>(P, o);
    return (int)cudaGetLastError();
  }
  const int smem = kWarps * P.stage_positions * kRowQ * (int)sizeof(VT);
  const int rows = P.bq / kRowQ;
  const dim3 grid((unsigned)nb, (unsigned)P.num_levels,
                  (unsigned)((rows + kWarps - 1) / kWarps));
  if (P.coords != nullptr) {
    auto kern = local_lookup_fine_kernel<VT, OT, true>;
    const int rc = allow_smem(kern, smem);
    if (rc != 0) return rc;
    kern<<<grid, kWarps * 32, smem, s>>>(P, o);
  } else {
    auto kern = local_lookup_fine_kernel<VT, OT, false>;
    const int rc = allow_smem(kern, smem);
    if (rc != 0) return rc;
    kern<<<grid, kWarps * 32, smem, s>>>(P, o);
  }
  return (int)cudaGetLastError();
}

int launch(Params& P, int nb, bool exact, bool vol_bf16, bool out_bf16,
           void* out, void* stream) {
  if (P.num_levels < 1 || P.num_levels > kMaxLevels || nb < 1 || P.bq < 1 ||
      P.k < 1 || P.channel0 < 0 ||
      P.channel0 + P.num_levels * P.k * P.k > P.out_channels) {
    return (int)cudaErrorInvalidValue;
  }
  if (!exact && P.bq % kRowQ != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < P.num_levels; ++l) {
    if (P.lv[l].wh < P.k + 1 || P.lv[l].ww < P.k + 1) {
      return (int)cudaErrorInvalidValue;
    }
  }
  // staged positions a CTA holds: kStagePositions, or less when the level
  // table bounds every box by a smaller fine window
  if (!exact) {
    int need = kStagePositions;
    if (P.coords != nullptr) {
      need = 0;
      for (int l = 0; l < P.num_levels; ++l) {
        const int fc = P.lv[l].fc;
        const int w = P.lv[l].fr * (vol_bf16 ? stage_stride<__nv_bfloat16>(fc)
                                             : stage_stride<float>(fc));
        need = need > w ? need : w;
      }
    }
    P.stage_positions = need < kStagePositions ? need : kStagePositions;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16 && out_bf16) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(P, nb, exact, out, s);
  } else if (vol_bf16) {
    return launch_typed<__nv_bfloat16, float>(P, nb, exact, out, s);
  } else if (out_bf16) {
    return launch_typed<float, __nv_bfloat16>(P, nb, exact, out, s);
  }
  return launch_typed<float, float>(P, nb, exact, out, s);
}

// The level table of volumes whose per-level (2, nb, bq) starts and
// fractions lie at [l] of (L, 2, nb, bq) arrays: [l][0] rows, [l][1]
// columns.
void fill_levels(Params& P, const void* const* vols, const int* whs,
                 const int* wws, int num_levels, const int* starts,
                 const float* frac, int nb, int bq) {
  const size_t n = (size_t)nb * bq;
  for (int l = 0; l < num_levels; ++l) {
    Level& lv = P.lv[l];
    lv.vol = vols[l];
    lv.ys = starts + (2 * l) * n;
    lv.xs = starts + (2 * l + 1) * n;
    lv.fy = frac + (2 * l) * n;
    lv.fx = frac + (2 * l + 1) * n;
    lv.wh = whs[l];
    lv.ww = wws[l];
  }
  P.num_levels = num_levels;
}

// The level table of the coordinate-driven entries (layout at kHeader).
int fill_coord_levels(Params& P, const float* coords, const void* const* vols,
                      int num_levels, const int* geo, const float* fgeo,
                      int b0, int nb) {
  if (num_levels < 1 || num_levels > kMaxLevels || b0 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  P.coords = coords;
  P.b0 = b0;
  P.H1 = geo[0];
  P.W1 = geo[1];
  P.nbw = geo[2];
  P.bh = geo[3];
  P.bw = geo[4];
  P.r = geo[5];
  if (P.H1 < 1 || P.W1 < 1 || P.nbw < 1 || P.bh < 1 || P.bw < 1 ||
      b0 + nb > (P.H1 + P.bh - 1) / P.bh * P.nbw) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < num_levels; ++l) {
    const int* g = geo + kHeader + l * kLevelInts;
    const float* f = fgeo + l * kLevelFloats;
    Level& lv = P.lv[l];
    lv.vol = vols[l];
    lv.wh = g[0];
    lv.ww = g[1];
    lv.sh = g[2];
    lv.sw = g[3];
    lv.fr = g[4];
    lv.fc = g[5];
    lv.rel_max_y = g[6];
    lv.rel_max_x = g[7];
    lv.anchor_max_y = g[8];
    lv.anchor_max_x = g[9];
    lv.div = f[0];
    lv.pad = f[1];
    lv.hi_y = f[2];
    lv.hi_x = f[3];
  }
  P.num_levels = num_levels;
  return 0;
}

}  // namespace

// Kernel D from coordinates over blocks b0 .. b0 + nb - 1 of the grid.
// coords (H1, W1, 2) float32 level-0 (x, y), natural raster order; vols:
// host array of num_levels device pointers to the band's (nb, wh, ww, bq)
// volumes; geo, fgeo: host level table (kHeader + 10 per
// level ints, 4 per level floats, see above). out (nb, num_levels*k*k, bq);
// bad (nb, num_levels) uint8: 1 where a start of the block left its fine
// window at that level. *_bf16: element type bfloat16 instead of float32.
// Device arrays contiguous, volumes 16-byte aligned, bq a multiple of 16.
// Returns cudaGetLastError().
extern "C" int woft_local_lookup_coords(const float* coords,
                                        const void* const* vols,
                                        int num_levels, const int* geo,
                                        const float* fgeo, int b0, int nb,
                                        int bq, int k, int vol_bf16,
                                        void* out, int out_bf16,
                                        unsigned char* bad, void* stream) {
  Params P = {};
  const int rc =
      fill_coord_levels(P, coords, vols, num_levels, geo, fgeo, b0, nb);
  if (rc != 0) return rc;
  P.bad_out = bad;
  P.bq = bq;
  P.k = k;
  P.out_channels = num_levels * k * k;
  P.channel0 = 0;
  return launch(P, nb, false, vol_bf16 != 0, out_bf16 != 0, out, stream);
}

// Kernel E from coordinates, every level in one launch: coords, vols, geo,
// fgeo, b0 as for kernel D; bad (nb, num_levels) uint8 or NULL: a block
// none of whose flags is set is left untouched. out (nb,
// num_levels*k*k, bq).
extern "C" int woft_local_lookup_exact_coords(
    const float* coords, const void* const* vols, int num_levels,
    const int* geo, const float* fgeo, const unsigned char* bad, int b0,
    int nb, int bq, int k, int vol_bf16, void* out, int out_bf16,
    void* stream) {
  Params P = {};
  const int rc =
      fill_coord_levels(P, coords, vols, num_levels, geo, fgeo, b0, nb);
  if (rc != 0) return rc;
  P.bad = bad;
  P.bq = bq;
  P.k = k;
  P.out_channels = num_levels * k * k;
  P.channel0 = 0;
  return launch(P, nb, true, vol_bf16 != 0, out_bf16 != 0, out, stream);
}

// Kernel D from explicit operands. vols, whs, wws: host arrays of
// num_levels device pointers to (nb, wh, ww, bq) volumes and their window
// sizes. anchors (nb, num_levels, 2) int32 [r0, c0]; rel (num_levels, 2,
// nb, bq) int32 starts relative to the anchors, [l][0] rows and [l][1]
// columns; frac (num_levels, 2, nb, bq) float32. out (nb, num_levels*k*k,
// bq). Volumes 16-byte aligned, bq a multiple of 16.
extern "C" int woft_local_lookup_fine_multi(
    const void* const* vols, const int* whs, const int* wws, int num_levels,
    const int* anchors, const int* rel, const float* frac, int nb, int bq,
    int k, int vol_bf16, void* out, int out_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  Params P = {};
  fill_levels(P, vols, whs, wws, num_levels, rel, frac, nb, bq);
  P.anchors = anchors;
  P.bq = bq;
  P.k = k;
  P.out_channels = num_levels * k * k;
  P.channel0 = 0;
  return launch(P, nb, false, vol_bf16 != 0, out_bf16 != 0, out, stream);
}

// Kernel F: kernel D for one level. anchors (nb, 2); rel, frac (2, nb, bq);
// out (nb, k*k, bq).
extern "C" int woft_local_lookup_fine(const void* vol, int wh, int ww,
                                      const int* anchors, const int* rel,
                                      const float* frac, int nb, int bq,
                                      int k, int vol_bf16, void* out,
                                      int out_bf16, void* stream) {
  return woft_local_lookup_fine_multi(&vol, &wh, &ww, 1, anchors, rel, frac,
                                      nb, bq, k, vol_bf16, out, out_bf16,
                                      stream);
}

// Kernel E from explicit starts, every level in one launch. vols, whs, wws
// as for kernel D; starts (num_levels, 2, nb, bq) int32 absolute slab
// starts (rows, columns); frac (num_levels, 2, nb, bq) float32; flag (nb,)
// uint8 or NULL: a block whose flag is 0 is left untouched. Writes
// channels channel0 + l*k*k .. channel0 + (l+1)*k*k of out (nb,
// out_channels, bq) for level l.
extern "C" int woft_local_lookup_exact(const void* const* vols,
                                       const int* whs, const int* wws,
                                       int num_levels, const int* starts,
                                       const float* frac,
                                       const unsigned char* flag, int nb,
                                       int bq, int k, int vol_bf16, void* out,
                                       int out_channels, int channel0,
                                       int out_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  Params P = {};
  fill_levels(P, vols, whs, wws, num_levels, starts, frac, nb, bq);
  P.flag = flag;
  P.bq = bq;
  P.k = k;
  P.out_channels = out_channels;
  P.channel0 = channel0;
  return launch(P, nb, true, vol_bf16 != 0, out_bf16 != 0, out, stream);
}
