// Kernels D, E, F: bilinear (2r+1)^2 window lookups in the block-local
// correlation volume, queries minor.
//
// Replaces the TPU kernel woft_tpu/ops/pallas/local_lookup.py in its three
// forms:
//   D  block_local_lookup_fine_multi (pallas_call at :288): all levels in one
//      launch, each block reading an (fr, fc) fine sub-window at a per-block
//      anchor;
//   E  block_local_lookup (:421): one level, the whole stored window;
//   F  block_local_lookup_fine (:204): D for one level.
// The TPU kernels keep a block's 128 queries in the vector lanes and avoid
// gathers: each query's slab start is expanded into a two-hot weight row and
// the kernel sums over every possible start (n_s + n_t multiply-adds per
// output row, of which two per axis are non-zero), with double-buffered
// DMAs of the sub-windows. Here a thread reads its own four taps, so the
// kernels take each query's integer slab start and fraction per axis
// instead of the expanded arrays, and D, E and F share one device function:
// they differ only in where the start comes from (anchor + relative start
// clamped to the fine window, or an absolute start in the stored window).
//
// Function: out[b, c0 + l*k*k + j*k + i, q] =
//     (v[y, x] (1-fy) + v[y+1, x] fy) (1-fx)
//   + (v[y, x+1] (1-fy) + v[y+1, x+1] fy) fx,
// y = ys + j, x = xs + i, v = vol_l[b, :, :, q], float32 arithmetic in this
// order (y blend, then x blend; the reference's order), rounded once to the
// output type. Built with --fmad=false so it rounds like the plain PyTorch
// version (models/corr.py:_slab_blend_plain).
//
// Bound on the H100: device-memory bytes. At 720p (120 blocks of 128
// queries, 4 levels) a lookup needs per query and level one 10 x 10 patch
// of bf16 values (15,360 * 4 * 200 B = 12.3 MB), the starts and fractions
// (2.0 MB) and writes 120 * 324 * 128 outputs (10 MB in bf16): about 7 us at
// 3.35 TB/s. The blend is 6 flops per output plus 3 per column, far below
// the float32 rate.
//
// Design: one CUDA block per (query block b, level l, window row j), one
// thread per query. The thread walks its k + 1 columns once, blending the
// two rows of each column (k + 1 column values for k outputs), and writes
// out[.., j*k + i, q] for consecutive q from consecutive threads: stores
// are coalesced. Loads are 2- or 4-byte reads at (y, x, q); neighbouring
// queries of a smooth flow field read neighbouring x at neighbouring q, so a
// 32-byte sector fetched for one thread is used by its neighbours a few
// columns later, from L1. The fine sub-window is not staged in shared
// memory: level 0's is 24 x 40 x 128 x 2 B = 245,760 B, more than a block
// may hold. A block whose flag is zero returns before it reads anything
// (E under the exactness guard). Starts are clamped to [0, size - k - 1]
// as a memory guard; valid inputs already satisfy it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;

struct Level {
  const void* vol;    // (nb, wh, ww, bq)
  const int* ys;      // (nb, bq) row starts
  const int* xs;      // (nb, bq) column starts
  const float* fy;    // (nb, bq)
  const float* fx;    // (nb, bq)
  int wh;
  int ww;
};

struct Params {
  Level lv[kMaxLevels];
  int num_levels;
  const int* anchors;           // (nb, num_levels, 2) [r0, c0] or null
  const unsigned char* flag;    // (nb,) or null
  int bq;
  int k;
  int out_channels;             // channels of a block's output
  int channel0;                 // first channel written
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename VT, typename OT>
__global__ void local_lookup_kernel(const Params P, OT* __restrict__ out) {
  const int b = blockIdx.x;
  if (P.flag != nullptr && P.flag[b] == 0) return;
  const int k = P.k;
  const int l = blockIdx.y / k;
  const int j = blockIdx.y - l * k;
  const Level lv = P.lv[l];
  const int bq = P.bq;
  int r0 = 0, c0 = 0;
  if (P.anchors != nullptr) {
    r0 = P.anchors[(b * P.num_levels + l) * 2];
    c0 = P.anchors[(b * P.num_levels + l) * 2 + 1];
  }
  const VT* vol = static_cast<const VT*>(lv.vol) +
                  (size_t)b * lv.wh * lv.ww * bq;
  OT* out_b = out + ((size_t)b * P.out_channels + P.channel0 +
                     (size_t)l * k * k + (size_t)j * k) * bq;
  for (int q = threadIdx.x; q < bq; q += blockDim.x) {
    const size_t bi = (size_t)b * bq + q;
    const int ys = min(max(lv.ys[bi] + r0, 0), lv.wh - k - 1);
    const int xs = min(max(lv.xs[bi] + c0, 0), lv.ww - k - 1);
    const float fy = lv.fy[bi];
    const float fx = lv.fx[bi];
    const float gy = 1.0f - fy;
    const float gx = 1.0f - fx;
    const VT* row0 = vol + ((size_t)(ys + j) * lv.ww + xs) * bq + q;
    const VT* row1 = row0 + (size_t)lv.ww * bq;
    float prev = load(row0) * gy + load(row1) * fy;
    for (int i = 0; i < k; ++i) {
      const size_t o = (size_t)(i + 1) * bq;
      const float next = load(row0 + o) * gy + load(row1 + o) * fy;
      store(out_b + (size_t)i * bq + q, prev * gx + next * fx);
      prev = next;
    }
  }
}

int launch(const Params& P, int nb, bool vol_bf16, bool out_bf16, void* out,
           void* stream) {
  if (P.num_levels < 1 || P.num_levels > kMaxLevels || nb < 1 || P.bq < 1 ||
      P.k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < P.num_levels; ++l) {
    if (P.lv[l].wh < P.k + 1 || P.lv[l].ww < P.k + 1) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((unsigned)nb, (unsigned)(P.num_levels * P.k));
  const int threads = P.bq < 1024 ? ((P.bq + 31) / 32) * 32 : 1024;
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16 && out_bf16) {
    local_lookup_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<grid, threads, 0, s>>>(P, static_cast<__nv_bfloat16*>(out));
  } else if (vol_bf16) {
    local_lookup_kernel<__nv_bfloat16, float>
        <<<grid, threads, 0, s>>>(P, static_cast<float*>(out));
  } else if (out_bf16) {
    local_lookup_kernel<float, __nv_bfloat16>
        <<<grid, threads, 0, s>>>(P, static_cast<__nv_bfloat16*>(out));
  } else {
    local_lookup_kernel<float, float>
        <<<grid, threads, 0, s>>>(P, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel D. vols, whs, wws: host arrays of num_levels device pointers to
// (nb, wh, ww, bq) volumes and their window sizes. anchors (nb, num_levels,
// 2) int32 [r0, c0]; rel (num_levels, 2, nb, bq) int32 starts relative to
// the anchors, [l][0] rows and [l][1] columns; frac (num_levels, 2, nb, bq)
// float32. out (nb, num_levels*k*k, bq). *_bf16: element type bfloat16
// instead of float32. Device arrays contiguous. Returns cudaGetLastError().
extern "C" int woft_local_lookup_fine_multi(
    const void* const* vols, const int* whs, const int* wws, int num_levels,
    const int* anchors, const int* rel, const float* frac, int nb, int bq,
    int k, int vol_bf16, void* out, int out_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  Params P = {};
  const size_t n = (size_t)nb * bq;
  for (int l = 0; l < num_levels; ++l) {
    P.lv[l] = Level{vols[l],
                    rel + (2 * l) * n,
                    rel + (2 * l + 1) * n,
                    frac + (2 * l) * n,
                    frac + (2 * l + 1) * n,
                    whs[l],
                    wws[l]};
  }
  P.num_levels = num_levels;
  P.anchors = anchors;
  P.flag = nullptr;
  P.bq = bq;
  P.k = k;
  P.out_channels = num_levels * k * k;
  P.channel0 = 0;
  return launch(P, nb, vol_bf16 != 0, out_bf16 != 0, out, stream);
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

// Kernel E. vol (nb, wh, ww, bq); starts (2, nb, bq) int32 absolute slab
// starts (rows, columns); frac (2, nb, bq) float32; flag (nb,) uint8 or
// NULL: a block whose flag is 0 is left untouched. Writes channels
// channel0 .. channel0 + k*k of out (nb, out_channels, bq).
extern "C" int woft_local_lookup_exact(const void* vol, int wh, int ww,
                                       const int* starts, const float* frac,
                                       const unsigned char* flag, int nb,
                                       int bq, int k, int vol_bf16, void* out,
                                       int out_channels, int channel0,
                                       int out_bf16, void* stream) {
  if (channel0 < 0 || channel0 + k * k > out_channels) {
    return (int)cudaErrorInvalidValue;
  }
  Params P = {};
  const size_t n = (size_t)nb * bq;
  P.lv[0] = Level{vol, starts, starts + n, frac, frac + n, wh, ww};
  P.num_levels = 1;
  P.anchors = nullptr;
  P.flag = flag;
  P.bq = bq;
  P.k = k;
  P.out_channels = out_channels;
  P.channel0 = channel0;
  return launch(P, nb, vol_bf16 != 0, out_bf16 != 0, out, stream);
}
