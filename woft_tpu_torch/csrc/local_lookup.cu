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
// E under the exactness guard writes only the blocks whose flag is set,
// so its bound is the work of those blocks alone: at 720p the 10 blocks of
// the last block row (their padding queries violate the fine window on
// every lookup), 4 levels, each query's 200-byte patch, 16 bytes of starts
// and fractions and 162 bytes of bf16 output: 1.9 MB, 0.6 us, plus the 120
// flag bytes. Nearly all of E's time is its launch.
//
// Design: one thread per query, walking its k + 1 columns once, blending
// the two rows of each column (k + 1 column values for k outputs), and
// writing out[.., j*k + i, q] for consecutive q from consecutive threads:
// stores are coalesced. Loads are 2- or 4-byte reads at (y, x, q);
// neighbouring queries of a smooth flow field read neighbouring x at
// neighbouring q, so a 32-byte sector fetched for one thread is used by its
// neighbours a few columns later, from L1. The fine sub-window is not
// staged in shared memory: level 0's is 24 x 40 x 128 x 2 B = 245,760 B,
// more than a block may hold. Starts are clamped to [0, size - k - 1] as a
// memory guard; valid inputs already satisfy it.
//   D, F: one CUDA block per (query block b, level l, window row j).
//   E: one launch for all levels; all k rows of a (query block, level) at
//   once, in as few CUDA blocks of up to 1,024 threads as hold them (two
//   at bq = 128: rows 0-4 and 5-8). A block whose flag is zero reads that
//   flag and returns: at 720p 960 blocks a lookup, 880 of them return at
//   once, where the previous design launched 4 x 1,080 blocks in four
//   launches. (Looping a thread over two rows, 480 blocks, took 8.3 us a
//   lookup against 2.6 us unflagged: the flagged blocks' dependent loads,
//   not the launch, set the time.)
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

// Rows j0, j0 + jstep, ... (< k) of level l of block b: one thread a
// query, walking its k + 1 columns once.
template <typename VT, typename OT>
__device__ __forceinline__ void lookup_rows(const Params& P, OT* out, int b,
                                            int l, int j0, int jstep) {
  const int k = P.k;
  const Level& lv = P.lv[l];
  const int bq = P.bq;
  int r0 = 0, c0 = 0;
  if (P.anchors != nullptr) {
    r0 = P.anchors[(b * P.num_levels + l) * 2];
    c0 = P.anchors[(b * P.num_levels + l) * 2 + 1];
  }
  const VT* vol = static_cast<const VT*>(lv.vol) +
                  (size_t)b * lv.wh * lv.ww * bq;
  for (int j = j0; j < k; j += jstep) {
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
}

// D and F: grid (nb, levels, k), one block a window row.
template <typename VT, typename OT>
__global__ void local_lookup_fine_kernel(const __grid_constant__ Params P,
                                         OT* __restrict__ out) {
  lookup_rows<VT, OT>(P, out, blockIdx.x, blockIdx.y, blockIdx.z, P.k);
}

// E: grid (nb, levels, z), block (threads, rows): the z blocks of a (query
// block, level) share its k rows, one row a thread row, in as few blocks
// as 1,024 threads allow; an unflagged query block's blocks read one flag
// and return.
template <typename VT, typename OT>
__global__ void local_lookup_exact_kernel(const __grid_constant__ Params P,
                                          OT* __restrict__ out) {
  const int b = blockIdx.x;
  if (P.flag != nullptr && P.flag[b] == 0) return;
  lookup_rows<VT, OT>(P, out, b, blockIdx.y,
                      blockIdx.z * blockDim.y + threadIdx.y,
                      gridDim.z * blockDim.y);
}

template <typename VT, typename OT>
void launch_typed(const Params& P, int nb, bool exact, void* out,
                  cudaStream_t s) {
  const int tx = P.bq < 1024 ? ((P.bq + 31) / 32) * 32 : 1024;
  OT* o = static_cast<OT*>(out);
  if (exact) {
    // every row at once, in as few blocks as 1,024 threads allow
    const int z = (P.k + 1024 / tx - 1) / (1024 / tx);
    const int ty = (P.k + z - 1) / z;
    local_lookup_exact_kernel<VT, OT>
        <<<dim3((unsigned)nb, (unsigned)P.num_levels, (unsigned)z),
           dim3(tx, ty), 0, s>>>(P, o);
  } else {
    local_lookup_fine_kernel<VT, OT>
        <<<dim3((unsigned)nb, (unsigned)P.num_levels, (unsigned)P.k), tx, 0,
           s>>>(P, o);
  }
}

int launch(const Params& P, int nb, bool exact, bool vol_bf16, bool out_bf16,
           void* out, void* stream) {
  if (P.num_levels < 1 || P.num_levels > kMaxLevels || nb < 1 || P.bq < 1 ||
      P.k < 1 || P.channel0 < 0 ||
      P.channel0 + P.num_levels * P.k * P.k > P.out_channels) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < P.num_levels; ++l) {
    if (P.lv[l].wh < P.k + 1 || P.lv[l].ww < P.k + 1) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (vol_bf16 && out_bf16) {
    launch_typed<__nv_bfloat16, __nv_bfloat16>(P, nb, exact, out, s);
  } else if (vol_bf16) {
    launch_typed<__nv_bfloat16, float>(P, nb, exact, out, s);
  } else if (out_bf16) {
    launch_typed<float, __nv_bfloat16>(P, nb, exact, out, s);
  } else {
    launch_typed<float, float>(P, nb, exact, out, s);
  }
  return (int)cudaGetLastError();
}

// The level table of volumes whose per-level (2, nb, bq) starts and
// fractions lie at [l] of (L, 2, nb, bq) arrays: [l][0] rows, [l][1]
// columns.
void fill_levels(Params& P, const void* const* vols, const int* whs,
                 const int* wws, int num_levels, const int* starts,
                 const float* frac, int nb, int bq) {
  const size_t n = (size_t)nb * bq;
  for (int l = 0; l < num_levels; ++l) {
    P.lv[l] = Level{vols[l],
                    starts + (2 * l) * n,
                    starts + (2 * l + 1) * n,
                    frac + (2 * l) * n,
                    frac + (2 * l + 1) * n,
                    whs[l],
                    wws[l]};
  }
  P.num_levels = num_levels;
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
  fill_levels(P, vols, whs, wws, num_levels, rel, frac, nb, bq);
  P.anchors = anchors;
  P.flag = nullptr;
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

// Kernel E, every level in one launch. vols, whs, wws as for kernel D;
// starts (num_levels, 2, nb, bq) int32 absolute slab starts (rows,
// columns); frac (num_levels, 2, nb, bq) float32; flag (nb,) uint8 or NULL:
// a block whose flag is 0 is left untouched. Writes channels channel0 +
// l*k*k .. channel0 + (l+1)*k*k of out (nb, out_channels, bq) for level l.
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
  P.anchors = nullptr;
  P.flag = flag;
  P.bq = bq;
  P.k = k;
  P.out_channels = out_channels;
  P.channel0 = channel0;
  return launch(P, nb, true, vol_bf16 != 0, out_bf16 != 0, out, stream);
}
