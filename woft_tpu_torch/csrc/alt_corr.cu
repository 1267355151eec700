// Kernel K: RAFT's volume-free ("alternate") correlation lookup, every
// level in one launch, dense over the query grid or indexed over M cells.
//
// Replaces no TPU kernel: woft_tpu computes its alternate lookup
// (woft_tpu/models/corr.py:corr_lookup_alternate) with XLA gathers and a
// batched product, chunk by chunk, as the port's plain version
// (woft_tpu_torch/models/corr.py:corr_lookup_alternate_plain) does. RAFT's
// own form is princeton-vl/RAFT core/corr.py:AlternateCorrBlock with the
// alt_cuda_corr extension. It exists for frames whose all-pairs pyramid
// does not fit the card: at 3840x2160 (a 270 x 480 grid, Q = 129,600) the
// float32 pyramid would take 89.2 GB.
//
// What it computes, for query q (features f1[q], level-0 coordinates (x,
// y)) and level l (fmap2 average-pooled l times, (B, Hl, Wl, D)): at c =
// (x, y) / 2^l, (x0, y0) = floor(c), the (2r+2)^2 integer taps (x0 - r +
// b, y0 - r + a), a, b in 0..2r+1, each <f1[q], level[batch(q), tap]> (0
// outside the level) times 1/sqrt(D); then output channel l*(2r+1)^2 +
// i*(2r+1) + j (i offsets x, j offsets y: RAFT's transposed window) blends
// taps (j, i), (j, i+1), (j+1, i), (j+1, i+1) with the fraction (fx, fy),
// in the plain version's order and with its weights. The products are
// float32 FFMA (the configuration keeps TF32 off), summed in channel order
// per tap: the plain version's batched product sums in another order, so
// the two agree to ~1e-6 of the largest value, not bit for bit.
//
// Bound on the H100: float32 operations. One dense lookup at 4K is Q x 4
// levels x 100 taps x 256 channels x 2 = 26.5 GFLOP: 0.396 ms at 67
// TFLOP/s; its bytes (f1 and the four levels read once, the output written
// once) are ~478 MB, 0.143 ms at 3.35 TB/s.
//
// Design: a CTA of 128 threads takes one level (blockIdx.y) of a tile of
// queries, 8 x 16 cells of the grid (dense) or 128 consecutive rows of the
// index (indexed); a thread is one query and keeps its tap sums in
// registers, in two passes over the channels (window rows 0..r+1, then
// r+1..2r+1: at most 60 sums a thread; row r+1 is summed twice, 10 % more
// work). The CTA first takes the bounding box of its queries' window
// origins (a block min). Where the box's region of the level fits shared
// memory (at most kMaxPositions positions; 13 x 25 = 325 a pass for a tile
// under a smooth flow at level 0) and the tile lies in one batch element,
// the region is staged 8 channels at a time by cp.async, double buffered
// and zero-filled outside the level, as two planes of 4 channels (16 B a
// position, so the 8 threads of a quarter-warp, 8 neighbouring cells, read
// 128 contiguous bytes: no bank conflict under a smooth flow); each thread
// reads its taps' 8 channels from it and does 8 FFMA a tap with its
// query's 8 channels in registers. Otherwise (a tile whose windows
// scatter, or rows of several batch elements) each thread reads its taps
// from global memory (L1/L2) in the same order. The outputs are blended in
// registers, staged in shared memory and written as contiguous rows.
// Each tap's value is used once per query, so the loop moves one float
// from shared memory per FFMA: the SM's 128 bytes a clock of shared-memory
// bandwidth feed 32 of its 128 FFMA a clock, which caps K at about 25 %
// of the float32 bound. Tried and not kept, because slower: two queries a
// thread, 2^l rows apart, sharing the taps of their windows (1.7 times
// fewer shared-memory bytes a product): 80 sums and the taps in flight
// spilled even at 255 registers (4.40 ms a 4K lookup against 2.85).
#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 8;                // a dense tile: cells of the grid
constexpr int kTileX = 16;
constexpr int kThreads = kTileY * kTileX;  // one query a thread
constexpr int kChunk = 8;                  // channels a stage
constexpr int kMaxLevels = 8;
// positions of a staged region: two buffers of two 16-byte planes
constexpr int kMaxPositions = 640;
constexpr int kStageFloat4s = 2 * 2 * kMaxPositions;

struct Params {
  const float* level[kMaxLevels];  // (B, Hl, Wl, D) float32
  int h[kMaxLevels];
  int w[kMaxLevels];
  const float* f1;          // (B * H1 * W1, D) float32
  const float* coords;      // (B * H1 * W1, 2) float32, level-0 (x, y)
  const long long* cells;   // (n,) int64 or null (dense)
  float* out;               // (n, L * (2r+1)^2) float32
  int n;                    // queries looked up
  int per_batch;            // H1 * W1: cells of one batch element
  int h1, w1;               // the grid (dense tiles)
  int tiles_y, tiles_x;     // dense tiles of one batch element
  int d;                    // channels, a multiple of kChunk
  int levels;
  float scale;              // 1 / sqrt(D)
};

// One level's work of a CTA: the region of the level its queries' windows
// span (staged in shared memory when it fits) and this thread's query.
struct Tile {
  const float* lvl;     // the level
  int hl, wl;
  int rx0, ry0;         // the region's origin: the least window origin
  int cols, span;       // its width; its height less a window's
  int rb;               // its batch element (staged tiles only)
  bool staged;
  const float* f1;      // the query's features
  int ox, oy, batch;    // the query's window origin and batch element
  bool valid;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot8(float acc, const float4& fa,
                                      const float4& fb, const float4& u,
                                      const float4& v) {
  acc = __fmaf_rn(fa.x, u.x, acc);
  acc = __fmaf_rn(fa.y, u.y, acc);
  acc = __fmaf_rn(fa.z, u.z, acc);
  acc = __fmaf_rn(fa.w, u.w, acc);
  acc = __fmaf_rn(fb.x, v.x, acc);
  acc = __fmaf_rn(fb.y, v.y, acc);
  acc = __fmaf_rn(fb.z, v.z, acc);
  acc = __fmaf_rn(fb.w, v.w, acc);
  return acc;
}

// block-wide min of four ints (a thread's values; every thread gets them)
__device__ __forceinline__ void block_min4(int v[4], int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = __reduce_min_sync(0xffffffffu, v[k]);
    if (lane == 0) red[warp * 4 + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int m = red[k];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = min(m, red[w * 4 + k]);
    v[k] = m;
  }
  __syncthreads();
}

// acc[(a - A0) * kT + b]: the tap sums of window rows A0 .. A0 + NA - 1
// (every column b) over all channels. Every thread of the CTA calls it; a
// staged tile ends with a barrier.
template <int R, int A0, int NA>
__device__ __forceinline__ void tap_rows(const Params& p, const Tile& tl,
                                         float4* buf, float* acc) {
  constexpr int kT = 2 * R + 2;
#pragma unroll
  for (int k = 0; k < NA * kT; ++k) acc[k] = 0.0f;
  const int t = threadIdx.x;
  const int chunks = p.d / kChunk;
  if (tl.staged) {
    // the region's rows A0 .. A0 + span + NA - 1, zeros outside the level
    const int positions = tl.cols * (tl.span + NA);
    const float* base =
        tl.lvl + static_cast<long long>(tl.rb) * tl.hl * tl.wl * p.d;
    // pos / cols by a float reciprocal: exact for pos < 2^22 (the
    // quotient's error stays under half of 1 / cols)
    const float inv_cols = 1.0f / static_cast<float>(tl.cols);
    auto stage = [&](int s, int c0) {
      float4* dst = buf + s * 2 * kMaxPositions;
      for (int i = t; i < 2 * positions; i += kThreads) {
        const int pos = i >> 1, half = i & 1;
        const int ry = __float2int_rz((static_cast<float>(pos) + 0.5f) *
                                      inv_cols);
        const int gy = tl.ry0 + A0 + ry, gx = tl.rx0 + (pos - ry * tl.cols);
        const bool in = gy >= 0 && gy < tl.hl && gx >= 0 && gx < tl.wl;
        const float* src =
            in ? base + (static_cast<long long>(gy) * tl.wl + gx) * p.d +
                     c0 + half * 4
               : p.f1;
        cp_async16(dst + half * kMaxPositions + pos, src, in ? 16 : 0);
      }
      cp_async_commit();
    };
    const int at = (tl.oy - tl.ry0) * tl.cols + (tl.ox - tl.rx0);
    stage(0, 0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage((c + 1) & 1, (c + 1) * kChunk);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (tl.valid) {
        const float4 fa = __ldg(reinterpret_cast<const float4*>(
            tl.f1 + c * kChunk));
        const float4 fb = __ldg(reinterpret_cast<const float4*>(
            tl.f1 + c * kChunk + 4));
        const float4* A = buf + (c & 1) * 2 * kMaxPositions + at;
        const float4* B = A + kMaxPositions;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
#pragma unroll
          for (int b = 0; b < kT; ++b) {
            acc[a * kT + b] = dot8(acc[a * kT + b], fa, fb,
                                   A[a * tl.cols + b], B[a * tl.cols + b]);
          }
        }
      }
      __syncthreads();
    }
  } else if (tl.valid) {
    const float* base =
        tl.lvl + static_cast<long long>(tl.batch) * tl.hl * tl.wl * p.d;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < chunks; ++c) {
      const float4 fa = __ldg(reinterpret_cast<const float4*>(
          tl.f1 + c * kChunk));
      const float4 fb = __ldg(reinterpret_cast<const float4*>(
          tl.f1 + c * kChunk + 4));
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int gy = tl.oy + A0 + a;
        const bool row_in = gy >= 0 && gy < tl.hl;
#pragma unroll
        for (int b = 0; b < kT; ++b) {
          const int gx = tl.ox + b;
          const bool in = row_in && gx >= 0 && gx < tl.wl;
          const float4* src = reinterpret_cast<const float4*>(
              base + (static_cast<long long>(in ? gy : 0) * tl.wl +
                      (in ? gx : 0)) * p.d + c * kChunk);
          const float4 u = in ? __ldg(src) : zero;
          const float4 v = in ? __ldg(src + 1) : zero;
          acc[a * kT + b] = dot8(acc[a * kT + b], fa, fb, u, v);
        }
      }
    }
  }
}

// out[i][j - J0] for output rows J0 .. J0 + NJ - 1 from acc's window rows
// J0 .. J0 + NJ (acc row 0 is window row J0), into ``dst`` (pitch floats a
// thread, [i][NJ] each).
template <int R, int J0, int NJ>
__device__ __forceinline__ void blend_rows(const float* acc, float fx,
                                           float fy, float scale, float* dst) {
  constexpr int kT = 2 * R + 2;
  constexpr int kK = 2 * R + 1;
  const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
  const float w10 = fy * (1.0f - fx), w11 = fy * fx;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float v00 = acc[j * kT + i] * scale;
      const float v01 = acc[j * kT + i + 1] * scale;
      const float v10 = acc[(j + 1) * kT + i] * scale;
      const float v11 = acc[(j + 1) * kT + i + 1] * scale;
      dst[i * NJ + j] = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 3)
    alt_corr_kernel(const __grid_constant__ Params p) {
  constexpr int kT = 2 * R + 2;   // taps a window side
  constexpr int kK = 2 * R + 1;   // outputs a window side
  // two passes over the channels, window rows 0 .. R+1 for output rows
  // 0 .. R, then rows R+1 .. 2R+1 for output rows R+1 .. 2R: at most
  // (R + 2) (2R + 2) sums a thread, held in registers
  constexpr int kRows0 = R + 2, kRows1 = R + 1;
  constexpr int kPitch0 = kK * (R + 1), kPitch1 = kK * R + 1;
  static_assert(kThreads * kPitch1 <= 4 * kStageFloat4s,
                "the second pass's outputs reuse the stage buffers");
  extern __shared__ float4 smem[];
  float4* buf = smem;                          // [buffer][plane][position]
  float* out0 = reinterpret_cast<float*>(smem + kStageFloat4s);
  float* out1 = reinterpret_cast<float*>(smem);
  __shared__ int red[kThreads / 32 * 4];
  __shared__ int qidx[kThreads];

  const int t = threadIdx.x;
  const int l = blockIdx.y;
  Tile tl;
  tl.lvl = p.level[l];
  tl.hl = p.h[l];
  tl.wl = p.w[l];

  // this thread's query: its row in f1 / coords and its output row
  int q = 0, qo = -1;
  if (p.cells == nullptr) {
    const int tiles = p.tiles_y * p.tiles_x;
    const int b = blockIdx.x / tiles;
    const int rem = blockIdx.x - b * tiles;
    const int ty = rem / p.tiles_x;
    const int y = ty * kTileY + t / kTileX;
    const int x = (rem - ty * p.tiles_x) * kTileX + t % kTileX;
    if (y < p.h1 && x < p.w1) {
      q = b * p.per_batch + y * p.w1 + x;
      qo = q;
    }
  } else {
    const int m = blockIdx.x * kThreads + t;
    if (m < p.n) {
      q = static_cast<int>(p.cells[m]);
      qo = m;
    }
  }
  tl.valid = qo >= 0;
  qidx[t] = qo;
  tl.batch = q / p.per_batch;
  tl.f1 = p.f1 + static_cast<long long>(q) * p.d;

  // window origin at this level, clamped where the window lies wholly
  // outside (every tap zero either way), and the shared fraction
  const float inv = 1.0f / static_cast<float>(1 << l);   // exact: 2^-l
  const float cx = __ldg(p.coords + 2 * static_cast<long long>(q)) * inv;
  const float cy = __ldg(p.coords + 2 * static_cast<long long>(q) + 1) * inv;
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  tl.ox = static_cast<int>(fminf(fmaxf(x0f - R, -static_cast<float>(kT)),
                                 static_cast<float>(tl.wl)));
  tl.oy = static_cast<int>(fminf(fmaxf(y0f - R, -static_cast<float>(kT)),
                                 static_cast<float>(tl.hl)));

  // the tile's region: the box of its origins (maxima as minima of the
  // negated values; a thread with no query leaves each one alone), and
  // whether it lies in one batch element and fits the stage buffers
  constexpr int kNone = 0x7fffffff;
  int box[4] = {tl.valid ? tl.ox : kNone, tl.valid ? tl.oy : kNone,
                tl.valid ? -tl.ox : kNone, tl.valid ? -tl.oy : kNone};
  int bs[4] = {tl.valid ? tl.batch : kNone, tl.valid ? -tl.batch : kNone,
               kNone, kNone};
  block_min4(box, red);
  block_min4(bs, red);
  tl.rx0 = box[0];
  tl.ry0 = box[1];
  tl.cols = -box[2] - box[0] + kT;
  tl.span = -box[3] - box[1];
  tl.rb = bs[0];
  tl.staged = bs[0] == -bs[1] &&
              static_cast<long long>(tl.cols) * (tl.span + kRows0) <=
                  kMaxPositions;

  float acc[kRows0 * kT];
  tap_rows<R, 0, kRows0>(p, tl, buf, acc);
  if (tl.valid) {
    blend_rows<R, 0, R + 1>(acc, fx, fy, p.scale, out0 + t * kPitch0);
  }
  // (a staged pass ends with a barrier; an unstaged one reads no buffer)
  tap_rows<R, R + 1, kRows1>(p, tl, buf, acc);
  if (tl.valid) {
    blend_rows<R, R + 1, R>(acc, fx, fy, p.scale, out1 + t * kPitch1);
  }
  __syncthreads();
  // every query's (2r+1)^2 outputs as one contiguous row segment
  const int row = p.levels * kK * kK;
  for (int e = t; e < kThreads * kK * kK; e += kThreads) {
    const int tq = e / (kK * kK);
    const int o = qidx[tq];
    if (o >= 0) {
      const int c = e - tq * kK * kK, i = c / kK, j = c - i * kK;
      p.out[static_cast<long long>(o) * row + l * kK * kK + c] =
          j <= R ? out0[tq * kPitch0 + i * (R + 1) + j]
                 : out1[tq * kPitch1 + i * R + (j - R - 1)];
    }
  }
}

template <int R>
int launch(const Params& p, cudaStream_t s) {
  constexpr int kK = 2 * R + 1;
  const int bytes = kStageFloat4s * 16 + kThreads * kK * (R + 1) * 4;
  // (a device's attribute: set on the current one at every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      alt_corr_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.cells == nullptr
                         ? p.tiles_y * p.tiles_x * (p.n / p.per_batch)
                         : (p.n + kThreads - 1) / kThreads;
  alt_corr_kernel<R><<<dim3(blocks, p.levels), kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel K. level_ptrs, hs, ws: host arrays of num_levels (B, hl, wl, d)
// float32 levels (fmap2 pooled l times; hl or wl may be 0); f1 (B * h1 *
// w1, d) and coords (B * h1 * w1, 2) float32; cells: null (dense: n = B *
// h1 * w1 queries, output row q) or (n,) int64 cells in [0, B * h1 * w1)
// (output row m reads cell cells[m]); out (n, num_levels * (2r+1)^2)
// float32, every element written. d a multiple of 8, radius 3 or 4.
// Returns cudaGetLastError().
extern "C" int woft_alt_corr(const void* const* level_ptrs, const int* hs,
                             const int* ws, int num_levels, const float* f1,
                             const float* coords, const long long* cells,
                             long long n, int batch, int h1, int w1, int d,
                             int radius, float* out, void* stream) {
  const long long cells_all = static_cast<long long>(batch) * h1 * w1;
  if (num_levels < 1 || num_levels > kMaxLevels || n < 1 ||
      n > 0x7fffffffLL || d < kChunk || d % kChunk != 0 ||
      (radius != 3 && radius != 4) || cells_all < 1 ||
      cells_all > 0x7fffffffLL || (cells == nullptr && n != cells_all)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  for (int l = 0; l < num_levels; ++l) {
    p.level[l] = static_cast<const float*>(level_ptrs[l]);
    p.h[l] = hs[l];
    p.w[l] = ws[l];
  }
  p.f1 = f1;
  p.coords = coords;
  p.cells = cells;
  p.out = out;
  p.n = static_cast<int>(n);
  p.per_batch = h1 * w1;
  p.h1 = h1;
  p.w1 = w1;
  p.tiles_y = (h1 + kTileY - 1) / kTileY;
  p.tiles_x = (w1 + kTileX - 1) / kTileX;
  p.d = d;
  p.levels = num_levels;
  p.scale = 1.0f / sqrtf(static_cast<float>(d));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return radius == 3 ? launch<3>(p, s) : launch<4>(p, s);
}
