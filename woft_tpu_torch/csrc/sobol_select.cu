// Kernel N: the tracker's Sobol-n selection of tentative correspondences
// from a (rows, P) bool validity mask, one row a target: for each row,
// n slot indices and their validity (ops/sampling.py:masked_sobol_gather).
//
// Replaces no TPU kernel: woft_tpu selects through XLA
// (woft_tpu/ops/sampling.py:masked_sobol_gather: a cumsum of the widened
// mask, a sort of the rounded targets, a searchsorted). On the card the
// same chain ran as PyTorch calls, and its int64 cumsum over rows of 2 M
// slots took tensor_kernel_scan_innermost_dim: one block a row, each
// walking its row in series, 8 blocks on 132 SMs for 8 targets at 1080p
// (3.8 ms a frame).
//
// What it computes, per row with n_valid valid slots, for target j < n:
//   n_valid > n:  k_j = rint(float32(n_valid) * s_j)      (half to even)
//                 valid_j = k_j < n_valid and (j == 0 or k_j != k_{j-1})
//   otherwise:    k_j = j, valid_j = j < n_valid
//   idx_j = the first slot whose running count of valid slots reaches
//           k_j + 1, or P - 1 where none does (k_j >= n_valid).
// s is the first n points of the 1-D Sobol sequence SORTED ascending (the
// wrapper's table). x -> rint(float32(n_valid * x)) is non-decreasing in
// x, so the targets of the sorted table come out sorted, with the same
// values and the same duplicates as sorting the rounded targets: no sort.
// A slot counts as valid where its byte is nonzero, as bool's conversion
// reads it. Every index and flag equals the plain version's, invalid
// targets included: integer logic and one IEEE product and rounding.
//
// Bound on the H100: device-memory bytes. A call must read the mask once
// (rows * P bytes: 16.6 MB for 8 targets at 1080p, 5 us at 3.35 TB/s) and
// write rows * n * 9 bytes of output; there is nothing to compute.
//
// Design, two launches a call, no atomics, no allocation and no host
// sync (safe in a CUDA graph, deterministic):
// - count: grid (tiles, rows), 256 threads; a block reads its tile of
//   `tile` bytes (a multiple of 4,096: 16-byte loads, four in flight a
//   thread) and writes the tile's count of valid slots, one int a (row,
//   tile). Every mask byte is read once.
// - select: grid (ceil(n / 8), rows), 8 warps a block, one target a warp.
//   Each block scans its row's tile counts (at most kMaxTiles, in shared
//   memory) into exclusive prefixes and n_valid: a few thousand integers,
//   cheaper to redo in every block than a third launch. A warp computes
//   its k_j, finds the tile holding valid slot k_j by binary search over
//   the prefixes, then walks that tile 2,048 bytes a step (each lane 64
//   bytes, four 16-byte loads in flight, mostly from L2: the count pass
//   has just read them) with a warp scan of the lanes' counts; the lane
//   that holds the slot finds its byte in registers.
// - Rows whose start is not 16-byte aligned (P not a multiple of 16, or an
//   offset view) load byte by byte (vec = 0); bytes past P count as 0.
// - The kernels' names hold "gather", as the scan they replace was filed
//   "gather / index" by the benchmark's trace reader.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                 // bytes a load
constexpr int kLoads = 4;                // loads in flight a thread
constexpr int kChunk = kThreads * kVec;  // bytes a block reads a load
constexpr int kLaneBytes = kLoads * kVec;
constexpr int kWarpStep = 32 * kLaneBytes;  // bytes a warp walks a step
constexpr int kMaxTiles = 8192;          // a row's prefixes: 32 KB shared
constexpr unsigned kFull = 0xffffffffu;

// valid (nonzero) bytes of a 32-bit word
__device__ __forceinline__ int bytes_set(unsigned w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;
}

__device__ __forceinline__ int bytes_set(const uint4& q) {
  return bytes_set(q.x) + bytes_set(q.y) + bytes_set(q.z) + bytes_set(q.w);
}

// the 16 bytes of row v at offset o, bytes at or past P read as 0
__device__ __forceinline__ uint4 load16(const unsigned char* v, long long o,
                                        long long P, bool vec) {
  if (vec && o + kVec <= P) {
    return __ldg(reinterpret_cast<const uint4*>(v + o));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < kVec && o + b < P; ++b) {
    if (v[o + b]) w[b >> 2] |= 1u << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kThreads)
    sobol_gather_count_kernel(const unsigned char* __restrict__ valid, int P,
                              int tile, int tiles, int vec,
                              int* __restrict__ counts) {
  const int row = blockIdx.y;
  const unsigned char* v = valid + static_cast<long long>(row) * P;
  const long long lo = static_cast<long long>(blockIdx.x) * tile;
  const long long hi = lo + tile;
  int c = 0;
  for (long long o = lo + threadIdx.x * kVec; o < hi; o += kLoads * kChunk) {
    uint4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long ou = o + u * kChunk;
      q[u] = ou < hi ? load16(v, ou, P, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) c += bytes_set(q[u]);
  }
  c = __reduce_add_sync(kFull, c);
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = __reduce_add_sync(kFull, lane < kWarps ? warp_sum[lane] : 0);
    if (lane == 0) counts[static_cast<long long>(row) * tiles + blockIdx.x] = c;
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive prefixes of the row's tile counts into prefix[0, tiles);
// returns the row's n_valid (every thread)
__device__ int scan_counts(const int* __restrict__ c, int tiles,
                           int* prefix) {
  __shared__ int warp_off[kWarps];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (tiles + kThreads - 1) / kThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int b = min(a + per, tiles);
  int s = 0;
  for (int i = a; i < b; ++i) {
    const int x = c[i];
    prefix[i] = x;
    s += x;
  }
  const int incl = warp_inclusive_scan(s, lane);
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_off[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    if (lane < kWarps) warp_off[lane] = wi - w;
    if (lane == kWarps - 1) total = wi;
  }
  __syncthreads();
  int run = warp_off[warp] + incl - s;
  for (int i = a; i < b; ++i) {
    const int x = prefix[i];
    prefix[i] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

// The position (0-3) of the r-th valid byte of w, r < bytes_set(w)
__device__ __forceinline__ int nth_byte(unsigned w, int r) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if ((w >> (8 * b)) & 0xffu) {
      if (r == 0) return b;
      --r;
    }
  }
  return 3;
}

// The slot of valid slot k (0-based; k < n_valid) of row v, every lane
__device__ long long find_slot(const unsigned char* v, const int* prefix,
                               int tiles, int tile, long long P, bool vec,
                               int k, int lane) {
  int lo = 0, hi = tiles - 1;  // the last tile whose prefix is <= k
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= k) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int rank = k - prefix[lo];
  const long long start = static_cast<long long>(lo) * tile;
  // the walk ends inside the tile; the bound only keeps a fault from
  // turning into an endless loop
  for (long long o = start; o < start + tile; o += kWarpStep) {
    uint4 q[kLoads];
    int cl = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      q[u] = load16(v, o + lane * kLaneBytes + u * kVec, P, vec);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) cl += bytes_set(q[u]);
    const int incl = warp_inclusive_scan(cl, lane);
    const int step = __shfl_sync(kFull, incl, 31);
    if (rank >= step) {
      rank -= step;
      continue;
    }
    const int owner = __ffs(__ballot_sync(kFull, incl > rank)) - 1;
    long long slot = 0;
    if (lane == owner) {
      int r = rank - (incl - cl);
      bool done = false;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const unsigned w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cw = bytes_set(w[e]);
          if (!done && r < cw) {
            slot = o + lane * kLaneBytes + u * kVec + 4 * e +
                   nth_byte(w[e], r);
            done = true;
          }
          if (!done) r -= cw;
        }
      }
    }
    return __shfl_sync(kFull, slot, owner);
  }
  return P - 1;
}

__global__ void __launch_bounds__(kThreads)
    sobol_gather_select_kernel(const unsigned char* __restrict__ valid,
                               const int* __restrict__ counts,
                               const float* __restrict__ sobol, int P,
                               int tile, int tiles, int n, int vec,
                               long long* __restrict__ idx,
                               unsigned char* __restrict__ sel) {
  extern __shared__ int prefix[];
  const int row = blockIdx.y;
  const int n_valid =
      scan_counts(counts + static_cast<long long>(row) * tiles, tiles, prefix);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // warp-uniform
  long long k;
  bool ok;
  if (n_valid > n) {
    const float nv = __int2float_rn(n_valid);
    k = static_cast<long long>(rintf(__fmul_rn(nv, sobol[j])));
    ok = k < n_valid &&
         (j == 0 ||
          static_cast<long long>(rintf(__fmul_rn(nv, sobol[j - 1]))) != k);
  } else {
    k = j;
    ok = j < n_valid;
  }
  const unsigned char* v = valid + static_cast<long long>(row) * P;
  const long long slot =
      k < n_valid ? find_slot(v, prefix, tiles, tile, P, vec != 0,
                              static_cast<int>(k), lane)
                  : P - 1;
  if (lane == 0) {
    const long long o = static_cast<long long>(row) * n + j;
    idx[o] = slot;
    sel[o] = ok;
  }
}

}  // namespace

// valid (rows, P) bool (bytes), rows 16-byte aligned when vec; sobol (n,)
// float32, the first n Sobol points sorted ascending; tile a multiple of
// kChunk with tiles = ceil(P / tile) <= kMaxTiles; counts (rows, tiles)
// int32 scratch; idx (rows, n) int64 and sel (rows, n) bool outputs. Two
// launches on stream; returns the first cudaGetLastError() that is not
// cudaSuccess.
extern "C" int woft_sobol_select(const void* valid, const void* sobol,
                                 int rows, int P, int n, int tile, int tiles,
                                 int vec, void* counts, void* idx, void* sel,
                                 void* stream) {
  if (rows < 1 || rows > 65535 || P < 1 || n < 1 || tile < kChunk ||
      tile % kChunk || tiles < 1 || tiles > kMaxTiles ||
      static_cast<long long>(tiles) * tile < P ||
      static_cast<long long>(tiles - 1) * tile >= P ||
      (vec && (P % kVec ||
               reinterpret_cast<unsigned long long>(valid) % kVec))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  int* c = static_cast<int*>(counts);
  sobol_gather_count_kernel<<<dim3(tiles, rows), kThreads, 0, s>>>(
      v, P, tile, tiles, vec, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sobol_gather_select_kernel<<<dim3((n + kWarps - 1) / kWarps, rows),
                               kThreads, tiles * sizeof(int), s>>>(
      v, c, static_cast<const float*>(sobol), P, tile, tiles, n, vec,
      static_cast<long long*>(idx), static_cast<unsigned char*>(sel));
  return static_cast<int>(cudaGetLastError());
}
