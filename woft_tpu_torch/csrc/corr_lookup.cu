// Kernel B: bilinear (2r+1)^2 window lookup in the 4-level correlation
// pyramid, zero padding outside each level.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/corr_lookup.py:
// fused_corr_lookup (pallas_call at :177) with pad_pyramid (:42). The TPU
// kernel needs a pre-padded, tile-aligned copy of the pyramid, loads an
// 8-aligned 24-row band per query and level, selects the window with
// one-hot matmuls, and emits (j, i) order that the caller transposes.
//
// Bound on the H100: device-memory bytes. At 720p (Q = 90 * 160 queries)
// each query and level needs one (2r+2)^2 = 10 x 10 float32 window of its
// pyramid row (at most 14,400 * 4 * 400 B = 23 MB; less where windows
// overhang a level) and the output is 14,400 * 324 * 4 B = 18.7 MB: 10.7 us
// at 3.35 TB/s for the smoke test's coordinates. That bound counts exact
// bytes. The pyramid (1.1 GB) is far beyond the L2 cache, so every window
// comes from device memory, which moves whole 32-byte sectors: a 40-byte
// row segment at an arbitrary 4-byte offset spans two sectors (three, one
// time in eight), about 670 B a full window, 16-17 us with the output; no
// kernel gets under that. The blend is ~10 flops per output, far below the
// float32 rate.
//
// Design: one warp per (query, level) window; a block is (32 lanes, L
// levels, 8 / L queries), so a warp reads its level and query from
// threadIdx without a division. The level is uniform across the warp: the
// level table is a __grid_constant__ parameter read with a warp-uniform
// index (no copy on the stack), and the scaled coordinate, its floor and
// fraction, the four corner weights, the range test and the row's base
// pointer are computed once a window, not once an output. A window row
// takes the next power of two of lanes (16 at r = 4, so a load instruction
// covers two rows and five of them the window): lanes run along x, a row
// segment's sectors are fetched once, every load is started before the first
// use, and a load's address is one 32-bit multiply-add on the row's base.
// 64 resident warps an SM keep ~1,300 sectors in flight, which is what a
// latency-bound gather needs. The (2r+2)^2 values go to shared memory with
// zeros where the window overhangs the UNPADDED level (pad_pyramid has no
// counterpart), and each lane then blends its outputs from shared memory.
// The warp writes its (2r+1)^2 outputs as consecutive floats: channel
// l*(2r+1)^2 + i*(2r+1) + j (i offsets x, j offsets y: RAFT's transposed
// window) is only a shared-memory index, so no transpose follows, and the
// four warps of a query fill its L*(2r+1)^2 contiguous floats. A window
// that lies wholly outside its level is written as zeros without a load;
// the same test keeps the int conversion in range. An optional int64 row
// vector maps query m to pyramid row rows[m]: the sparse weight head reads
// its 4,500 cells in place (18,000 warps, two rounds of the card) instead
// of copying their rows out of the pyramid; duplicates are allowed. r is a
// template parameter, 0 to 8 (constant divisors, unrolled loads and blends).
// Each output is v00*(wx0*wy0) + v10*(wx1*wy0) + v01*(wx0*wy1) +
// v11*(wx1*wy1), summed in that order and built with --fmad=false, so it
// rounds like the plain PyTorch version (models/corr.py:corr_lookup_plain)
// bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at the 720p shapes
// (chip_smoke.py): 0.026 ms dense (the one-thread-per-output kernel it
// replaces: 0.21 ms) and 0.007 ms for the 4,500 indexed queries (0.067 ms).
// The scattered reads bound it: with the loads compiled out it takes 0.013
// ms, with the stores compiled out 0.021 ms (tools/torch_kernel_ablate.py).
// Tried and not kept, because no faster: resident blocks that loop over
// queries and fetch the next coordinate early.
//
// bf16 levels (the reference's 'bf16' and 'default' modes store the
// pyramid so, woft_tpu/models/raft.py:651-657): a second instantiation
// reads 2-byte values and widens each to float32 as it is loaded (exact: a
// bf16 value is the top half of its float32), as the TPU kernel widens its
// strip (corr_lookup.py:109); the fractions, the blend and the float32
// output are the float32 form's, so it matches the plain version on the
// same bf16 levels bit for bit. At 720p its reads halve (about 11.5 MB of
// windows) and the 18.7 MB output stays: the byte bound falls by about a
// quarter, not by half.
//
// Kernel B' (woft_corr_lookup_backward, _bf16): the backward of B for
// rows = query, which the training forward's 13 lookups a flow take
// (models/corr.py:_CorrLookup). The JAX package differentiates its XLA
// lookup there; it has no backward kernel. Given g = dL/d(out) (Q,
// L*(2r+1)^2) float32 it writes d_levels[l] (Q, hl, wl) in the level's
// dtype and d_coords (Q, 2) float32, the VJP of the plain lookup
// (models/corr.py:corr_lookup_backward_plain): a tap outside the level
// gives neither value nor gradient, the floor's gradient is zero, each
// level's coordinate gradient is scaled by 2^-l.
//
// Bound on the H100: device-memory bytes. Query q reads row q of each
// level only, so its gradient is zero outside a (2r+2)^2 patch of row q,
// but every row is written whole: at batch 4 of 288x384 (Q = 6,912, the
// 36x48 grid and its three pooled levels, 2,292 floats a query) that is
// 63.4 MB of float32 rows (31.7 MB of bf16), plus g (9.0 MB) and the
// patches of the levels read for the coordinate gradient: ~0.022 ms at
// 3.35 TB/s. The arithmetic is ~30 flops a tap.
//
// Design: one warp per (query, level), the block and the tests of B (32,
// L, 8 / L). The warp stages its (2r+2)^2 window of the level (zeros
// outside it) and its (2r+1)^2 slice of g in shared memory, computes the
// patch's gradient there (each cell gathers the up-to-four taps whose
// corners land on it, w00, w10, w01, w11 terms in that order) and its
// share of the coordinate gradient (a warp sum), then writes its whole row
// of d_levels in one coalesced pass, zeros outside the patch: no atomics,
// no memset, the same result every run. The L warps of a query put their
// coordinate sums in shared memory, and the level-0 warp adds them in
// level order. Sums are float32 and rounded once to bf16 for bf16 levels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // (query, level) windows a block
constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;

struct Levels {
  const void* ptr[kMaxLevels];      // float or bf16 (unsigned short) data
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float load_widened(const float* p) {
  return __ldg(p);
}

// bf16 -> float32, exact: the 16 bits are the float's top half
__device__ __forceinline__ float load_widened(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

template <int R, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    corr_lookup_kernel(const __grid_constant__ Levels lv,
                       const float* __restrict__ coords,
                       const long long* __restrict__ rows, int q,
                       float* __restrict__ out) {
  constexpr int kK = 2 * R + 1;        // outputs a window row
  constexpr int kSide = kK + 1;        // window rows and columns
  constexpr int kPitch = kSide + 1;    // floats between rows in the tile
  // lanes that share a window row: the power of two that holds it
  constexpr int kLpr = kSide <= 4 ? 4 : kSide <= 8 ? 8 : kSide <= 16 ? 16 : 32;
  constexpr int kRowsPerLoad = 32 / kLpr;
  constexpr int kLoads = (kSide + kRowsPerLoad - 1) / kRowsPerLoad;
  __shared__ float tiles[kWarps][kSide * kPitch];
  // blockDim = (32, levels, queries a block): a warp is one (query, level)
  const int lane = threadIdx.x;
  const int l = threadIdx.y;
  const int qi = blockIdx.x * blockDim.z + threadIdx.z;
  if (qi >= q) return;
  const int hl = lv.h[l];
  const int wl = lv.w[l];

  const float inv_scale = __int_as_float((127 - l) << 23);   // 2^-l, exact
  const float x = coords[2 * qi] * inv_scale;
  const float y = coords[2 * qi + 1] * inv_scale;
  float* o = out + (size_t)(qi * blockDim.y + l) * (kK * kK);
  // x <= -(r + 2) or x >= wl + r + 1 (likewise y): the whole window lies
  // outside the level and every output is exactly 0. The test also keeps
  // the int conversion in range.
  if (!(x > -(float)(R + 2) && x < (float)(wl + R + 1) &&
        y > -(float)(R + 2) && y < (float)(hl + R + 1))) {
    for (int c = lane; c < kK * kK; c += 32) o[c] = 0.f;
    return;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int gx0 = (int)x0f - R;
  const int gy0 = (int)y0f - R;
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w10 = fx * (1.f - fy);
  const float w01 = (1.f - fx) * fy;
  const float w11 = fx * fy;
  const long long row = rows != nullptr ? rows[qi] : qi;
  const T* base =
      static_cast<const T*>(lv.ptr[l]) + row * (long long)(hl * wl);
  // keeps the 64-bit row offset out of every load's address arithmetic
  asm volatile("" : "+l"(base));

  // stage the window: lanes along x, zeros outside the level
  float* s = tiles[threadIdx.z * blockDim.y + l];
  const int rx = lane % kLpr;
  const int ry = lane / kLpr;
  const int gx = gx0 + rx;
  const bool in_x = rx < kSide && (unsigned)gx < (unsigned)wl;
  float v[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int gy = gy0 + ry + n * kRowsPerLoad;
    const bool valid = in_x && (unsigned)gy < (unsigned)hl;
    v[n] = valid ? load_widened(base + (gy * wl + gx)) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int wy = ry + n * kRowsPerLoad;
    if (rx < kSide && wy < kSide) s[wy * kPitch + rx] = v[n];
  }
  __syncwarp();

#pragma unroll
  for (int n = 0; n < (kK * kK + 31) / 32; ++n) {
    const int c = lane + 32 * n;
    if (c < kK * kK) {
      const int i = c / kK;
      const int j = c - i * kK;
      const float* p = s + j * kPitch + i;
      float acc = p[0] * w00;
      acc = acc + p[1] * w10;
      acc = acc + p[kPitch] * w01;
      acc = acc + p[kPitch + 1] * w11;
      o[c] = acc;
    }
  }
}

template <int R, typename T>
void launch(const Levels& lv, int num_levels, const float* coords,
            const long long* rows, int q, float* out, cudaStream_t stream) {
  const int per_block = kWarps / num_levels;   // queries a block, >= 1
  const dim3 block(32, num_levels, per_block);
  corr_lookup_kernel<R, T>
      <<<(q + per_block - 1) / per_block, block, 0, stream>>>(
          lv, coords, rows, q, out);
}

template <typename T>
int lookup(const void* const* level_ptrs, const int* hs, const int* ws,
           int num_levels, const float* coords, const long long* rows,
           long long q, int radius, float* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || q < 1 || q * num_levels > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)q;
  switch (radius) {
    case 0: launch<0, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 1: launch<1, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 2: launch<2, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 3: launch<3, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 4: launch<4, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 5: launch<5, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 6: launch<6, T>(lv, num_levels, coords, rows, n, out, s); break;
    case 7: launch<7, T>(lv, num_levels, coords, rows, n, out, s); break;
    default: launch<8, T>(lv, num_levels, coords, rows, n, out, s);
  }
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void store_grad(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_grad(unsigned short* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

struct GradLevels {
  void* ptr[kMaxLevels];            // float or bf16 (unsigned short) rows
};

template <int R, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    corr_lookup_backward_kernel(const __grid_constant__ Levels lv,
                                const __grid_constant__ GradLevels dlv,
                                const float* __restrict__ coords,
                                const float* __restrict__ g, int q,
                                float* __restrict__ d_coords) {
  constexpr int kK = 2 * R + 1;
  constexpr int kKK = kK * kK;
  constexpr int kSide = kK + 1;
  constexpr int kPitch = kSide + 1;
  constexpr int kLpr = kSide <= 4 ? 4 : kSide <= 8 ? 8 : kSide <= 16 ? 16 : 32;
  constexpr int kRowsPerLoad = 32 / kLpr;
  constexpr int kLoads = (kSide + kRowsPerLoad - 1) / kRowsPerLoad;
  __shared__ float vals[kWarps][kSide * kPitch];   // the level's window
  __shared__ float grads[kWarps][kSide * kPitch];  // the patch's gradient
  __shared__ float gs[kWarps][kKK];                // this level's g
  __shared__ float2 dxy[kWarps];                   // coordinate sums
  const int lane = threadIdx.x;
  const int l = threadIdx.y;
  const int warp = threadIdx.z * blockDim.y + l;
  const int qi = blockIdx.x * blockDim.z + threadIdx.z;
  const bool active = qi < q;      // no return: the block syncs below
  const int hl = lv.h[l];
  const int wl = lv.w[l];
  const float inv_scale = __int_as_float((127 - l) << 23);   // 2^-l, exact
  const float x = active ? coords[2 * qi] * inv_scale : 0.f;
  const float y = active ? coords[2 * qi + 1] * inv_scale : 0.f;
  // as in B: the whole window outside the level gives zero everywhere
  const bool inside = active && x > -(float)(R + 2) &&
                      x < (float)(wl + R + 1) && y > -(float)(R + 2) &&
                      y < (float)(hl + R + 1);
  float* s = vals[warp];
  float* d = grads[warp];
  float* gw = gs[warp];
  float dx = 0.f, dy = 0.f;
  int gx0 = 0, gy0 = 0;
  if (inside) {
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    gx0 = (int)x0f - R;
    gy0 = (int)y0f - R;
    const float w00 = (1.f - fx) * (1.f - fy);
    const float w10 = fx * (1.f - fy);
    const float w01 = (1.f - fx) * fy;
    const float w11 = fx * fy;
    const T* base =
        static_cast<const T*>(lv.ptr[l]) + (long long)qi * (hl * wl);
    const int rx = lane % kLpr;
    const int ry = lane / kLpr;
    const int gx = gx0 + rx;
    const bool in_x = rx < kSide && (unsigned)gx < (unsigned)wl;
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int wy = ry + n * kRowsPerLoad;
      const int gy = gy0 + wy;
      const bool valid = in_x && (unsigned)gy < (unsigned)hl;
      const float v = valid ? load_widened(base + (gy * wl + gx)) : 0.f;
      if (rx < kSide && wy < kSide) s[wy * kPitch + rx] = v;
    }
    const float* grow = g + (size_t)qi * (blockDim.y * kKK) + l * kKK;
    for (int c = lane; c < kKK; c += 32) gw[c] = grow[c];
    __syncwarp();
    // the coordinate gradient: channel c = i*kK + j samples window cell
    // (row j, column i); d/dfx of the blend and d/dfy
    for (int c = lane; c < kKK; c += 32) {
      const int i = c / kK;
      const int j = c - i * kK;
      const float* p = s + j * kPitch + i;
      const float gc = gw[c];
      dx = dx + gc * ((p[1] - p[0]) * (1.f - fy) +
                      (p[kPitch + 1] - p[kPitch]) * fy);
      dy = dy + gc * ((p[kPitch] - p[0]) * (1.f - fx) +
                      (p[kPitch + 1] - p[1]) * fx);
    }
    // the patch's gradient: cell (wy, wx) is corner (dy, dx) of the tap at
    // (j, i) = (wy - dy, wx - dx)
    for (int e = lane; e < kSide * kSide; e += 32) {
      const int wy = e / kSide;
      const int wx = e - wy * kSide;
      float acc = 0.f;
      if (wy < kK && wx < kK) acc = acc + gw[wx * kK + wy] * w00;
      if (wy < kK && wx > 0) acc = acc + gw[(wx - 1) * kK + wy] * w10;
      if (wy > 0 && wx < kK) acc = acc + gw[wx * kK + wy - 1] * w01;
      if (wy > 0 && wx > 0) acc = acc + gw[(wx - 1) * kK + wy - 1] * w11;
      d[wy * kPitch + wx] = acc;
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dx += __shfl_xor_sync(0xffffffffu, dx, off);
    dy += __shfl_xor_sync(0xffffffffu, dy, off);
  }
  if (lane == 0) dxy[warp] = make_float2(dx * inv_scale, dy * inv_scale);

  // the whole row, zeros outside the patch, walked in raster order
  if (active) {
    T* out = static_cast<T*>(dlv.ptr[l]) + (long long)qi * (hl * wl);
    const int n = hl * wl;
    int gy = lane / wl;
    int gx = lane - gy * wl;
    const int step_y = 32 / wl;
    const int step_x = 32 - step_y * wl;
    for (int e = lane; e < n; e += 32) {
      const int wy = gy - gy0;
      const int wx = gx - gx0;
      const float v = inside && (unsigned)wy < (unsigned)kSide &&
                              (unsigned)wx < (unsigned)kSide
                          ? d[wy * kPitch + wx]
                          : 0.f;
      store_grad(out + e, v);
      gx += step_x;
      gy += step_y;
      if (gx >= wl) {
        gx -= wl;
        ++gy;
      }
    }
  }
  __syncthreads();
  if (active && l == 0 && lane == 0) {
    float sx = 0.f, sy = 0.f;
    for (int m = 0; m < (int)blockDim.y; ++m) {
      const float2 v = dxy[threadIdx.z * blockDim.y + m];
      sx = sx + v.x;
      sy = sy + v.y;
    }
    d_coords[2 * qi] = sx;
    d_coords[2 * qi + 1] = sy;
  }
}

template <int R, typename T>
void launch_backward(const Levels& lv, const GradLevels& dlv, int num_levels,
                     const float* coords, const float* g, int q,
                     float* d_coords, cudaStream_t stream) {
  const int per_block = kWarps / num_levels;
  const dim3 block(32, num_levels, per_block);
  corr_lookup_backward_kernel<R, T>
      <<<(q + per_block - 1) / per_block, block, 0, stream>>>(
          lv, dlv, coords, g, q, d_coords);
}

template <typename T>
int lookup_backward(const void* const* level_ptrs, void* const* grad_ptrs,
                    const int* hs, const int* ws, int num_levels,
                    const float* coords, const float* g, long long q,
                    int radius, float* d_coords, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || q < 1 || q * num_levels > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  GradLevels dlv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    dlv.ptr[l] = grad_ptrs[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)q;
  switch (radius) {
#define WOFT_BWD(r) \
  launch_backward<r, T>(lv, dlv, num_levels, coords, g, n, d_coords, s)
    case 0: WOFT_BWD(0); break;
    case 1: WOFT_BWD(1); break;
    case 2: WOFT_BWD(2); break;
    case 3: WOFT_BWD(3); break;
    case 4: WOFT_BWD(4); break;
    case 5: WOFT_BWD(5); break;
    case 6: WOFT_BWD(6); break;
    case 7: WOFT_BWD(7); break;
    default: WOFT_BWD(8);
#undef WOFT_BWD
  }
  return (int)cudaGetLastError();
}

}  // namespace

// level_ptrs, hs, ws: host arrays of num_levels device pointers to (R, hl,
// wl) float32 levels and their sizes. coords (q, 2) float32 level-0 (x, y);
// rows (q,) int64 pyramid rows or NULL for row = query; out (q,
// num_levels * (2r+1)^2) float32, 0 <= r <= 8. Device arrays contiguous.
// Returns cudaGetLastError().
extern "C" int woft_corr_lookup(const void* const* level_ptrs, const int* hs,
                                const int* ws, int num_levels,
                                const float* coords, const long long* rows,
                                long long q, int radius, float* out,
                                void* stream) {
  return lookup<float>(level_ptrs, hs, ws, num_levels, coords, rows, q,
                       radius, out, stream);
}

// The same with bf16 levels: the output stays float32.
extern "C" int woft_corr_lookup_bf16(const void* const* level_ptrs,
                                     const int* hs, const int* ws,
                                     int num_levels, const float* coords,
                                     const long long* rows, long long q,
                                     int radius, float* out, void* stream) {
  return lookup<unsigned short>(level_ptrs, hs, ws, num_levels, coords, rows,
                                q, radius, out, stream);
}

// Kernel B': level_ptrs, hs, ws as above with R = q (row = query);
// grad_ptrs: host array of num_levels device pointers to the (q, hl, wl)
// gradient rows, float32, every element written; g (q, num_levels *
// (2r+1)^2) float32; d_coords (q, 2) float32. Returns cudaGetLastError().
extern "C" int woft_corr_lookup_backward(const void* const* level_ptrs,
                                         void* const* grad_ptrs,
                                         const int* hs, const int* ws,
                                         int num_levels, const float* coords,
                                         const float* g, long long q,
                                         int radius, float* d_coords,
                                         void* stream) {
  return lookup_backward<float>(level_ptrs, grad_ptrs, hs, ws, num_levels,
                                coords, g, q, radius, d_coords, stream);
}

// The same with bf16 levels and bf16 gradient rows (float32 sums, rounded
// once to nearest even).
extern "C" int woft_corr_lookup_backward_bf16(
    const void* const* level_ptrs, void* const* grad_ptrs, const int* hs,
    const int* ws, int num_levels, const float* coords, const float* g,
    long long q, int radius, float* d_coords, void* stream) {
  return lookup_backward<unsigned short>(level_ptrs, grad_ptrs, hs, ws,
                                         num_levels, coords, g, q, radius,
                                         d_coords, stream);
}
