// Kernel L: the feature encoder's instance norm (affine-free, biased
// variance, eps) of an NCHW map, fused with the convolution's bias before
// it, the ReLU after it and, at a residual block's end, relu(x + y).
//
// Replaces no TPU kernel: woft_tpu runs its instance_norm
// (woft_tpu/models/layers.py:instance_norm) through XLA, which fuses the
// reduction and the elementwise tail itself. On the card PyTorch runs each
// nn.InstanceNorm2d as batch_norm on a (1, N*C, H, W) view: one block a
// plane for the statistics (64 to 128 blocks on 132 SMs, each reducing a
// whole plane), a second kernel to apply them, then one more pass over
// memory each for the ReLU, the residual add and its ReLU; before it, a
// pass of its own adds the convolution's bias to cuDNN's output.
//
// What it computes, per (n, c) plane of x (float32 or bf16): x = T(x +
// b[c]) where a bias is given (PyTorch's bias add after cuDNN's product,
// T the input's type), mean and the biased variance of that in float32,
// y = T((x - mean) * (1 / sqrt(var + eps))) (the module path's rounding),
// then
//   mode 0: out = relu(y)
//   mode 1: out = T(relu(r + relu(y)))            r: the block's input
//   mode 2: out = T(relu(s + relu(y)))            s = T((sc - mean_sc) *
//           (1 / sqrt(var_sc + eps))): the shortcut's norm, applied on the
//           fly from its convolution's output sc (its bias added likewise)
//           and its own statistics
// with the sum in float32 and rounded once, as PyTorch adds two bf16
// tensors. The square root and the division are IEEE (no fast math), as
// PyTorch's 1 / sqrt(var + eps); only the order of the statistics' sums
// differs from the plain version (ops/kernels.py:instance_norm_act_plain).
//
// Bound on the H100: device-memory bytes, at a few operations a byte. A
// call has to read each input once and write its output once: 2 map sizes
// (mode 0) or 3 (modes 1, 2); it reads x twice (statistics, then apply),
// so it moves 3 map sizes, 4 with a residual and 5 with a shortcut, less
// what the second read finds in the 50 MB L2. The module path moved 10
// map sizes for a norm with its bias and ReLU, and 6 more at a block's end.
//
// Design, two launches a call:
// - statistics: the grid is planes x splits (x 2 tensors in mode 2), 256
//   threads a block; ops/kernels.py:instance_norm_plan picks the splits
//   from (N*C, H*W) so that every shape fills the card with about two
//   waves of eight blocks an SM (a whole plane a block left 64-128 blocks
//   on 132 SMs). A block reads one contiguous chunk of a plane with 16-byte
//   loads, two a thread an iteration; a thread takes the exact mean and M2
//   of the 8 (float32) or 16 (bf16) values it holds in registers, two
//   passes over registers, and merges them into its running (count, mean,
//   M2) by Chan's formula; the block merges its threads' by the same
//   formula (warp shuffles, then one warp) and writes one partial. No
//   single-pass sum of squares anywhere.
// - apply: the same grid over planes x splits. Each block first merges its
//   plane's partials (one a thread, the same tree; every block repeats
//   this tiny merge, so no third launch and no atomics), then streams its
//   chunk: normalise, ReLU, (residual or normalised shortcut, add, ReLU),
//   16-byte loads and stores. The blocks run the map backwards, so the
//   first to start read what the statistics pass read last, which is
//   still in L2.
// - A plane whose H*W is not a multiple of the 16-byte vector, or an
//   unaligned operand, takes the same kernels with scalar loads (VEC = 1).
// - The symbols keep clear of the words the benchmark's trace reader
//   files under other layers: they are "normalisation" there.
// Not done: keeping a plane on chip between the two passes (a cluster's
// shared memory holds a 720p float32 or 1080p bf16 plane, not a 4K one).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;  // 16-byte loads a thread an iteration

struct Stat {
  float n, mean, m2;
};

// Chan's pairwise merge of (count, mean, M2) summaries; an empty side
// leaves the other as it is
__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  a.mean = a.mean + d * f;
  a.m2 = a.m2 + b.m2 + d * d * a.n * f;
  a.n = n;
}

__device__ __forceinline__ Stat shfl_down(const Stat& s, int o) {
  return Stat{__shfl_down_sync(0xffffffffu, s.n, o),
              __shfl_down_sync(0xffffffffu, s.mean, o),
              __shfl_down_sync(0xffffffffu, s.m2, o)};
}

// The block's merged summary, in thread 0
__device__ Stat block_merge(Stat s, Stat* red) {
  for (int o = 16; o > 0; o >>= 1) merge(s, shfl_down(s, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red[lane] : Stat{0.f, 0.f, 0.f};
    for (int o = kWarps / 2; o > 0; o >>= 1) merge(s, shfl_down(s, o));
  }
  return s;
}

// float32 and bf16 (as unsigned short) elements: loads widen to float32,
// stores round to nearest even
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements a 16-byte load
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Elem<unsigned short> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __uint_as_float(static_cast<unsigned>(*p) << 16);
  }
  static __device__ __forceinline__ unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(unsigned short* p, float v) {
    *p = bits(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __uint_as_float(static_cast<unsigned>(bits(v)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = static_cast<unsigned>(bits(v[2 * k])) |
             (static_cast<unsigned>(bits(v[2 * k + 1])) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// N elements from p: one 16-byte load (N = kVec) or one scalar (N = 1)
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* v) {
  if constexpr (N == 1) {
    v[0] = Elem<T>::load(p);
  } else {
    Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), v);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  if constexpr (N == 1) {
    Elem<T>::store(p, v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = Elem<T>::pack(v);
  }
}

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;  // NaN passes, as torch's relu
}

// A call's operands: x (planes, hw) to normalise; r the residual (mode 1)
// or the shortcut convolution's output (mode 2), x's shape, else null; bx,
// br per-channel biases added (rounded to T) to x and to the shortcut
// before anything else, or null; part the (1 or 2, planes, splits)
// partials; out x's shape
template <typename T>
struct Maps {
  const T* x;
  const T* r;
  const T* bx;
  const T* br;
  float4* part;
  T* out;
  int planes, channels, hw, splits, chunk;
  float eps;
};

template <typename T>
__device__ __forceinline__ float bias_of(const T* b, int plane, int channels) {
  return b == nullptr ? 0.f : Elem<T>::load(b + plane % channels);
}

// One partial (count, mean, M2, 0) a block: chunk blockIdx.x % splits of
// plane blockIdx.x / splits of x (blockIdx.y 0) or of the shortcut's map
// (blockIdx.y 1), each value with its channel's bias added and rounded
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    instance_norm_stats_kernel(const Maps<T> m) {
  __shared__ Stat red[kWarps];
  const int plane = blockIdx.x / m.splits;
  const int begin = (blockIdx.x - plane * m.splits) * m.chunk;
  const int end = min(m.hw, begin + m.chunk);
  const T* x = (blockIdx.y ? m.r : m.x) + static_cast<size_t>(plane) * m.hw;
  const float b = bias_of(blockIdx.y ? m.br : m.bx, plane, m.channels);
  Stat s{0.f, 0.f, 0.f};
  for (int i = begin + threadIdx.x * N; i < end;
       i += kThreads * N * kUnroll) {
    float v[kUnroll][N];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads * N;
      ok[u] = j < end;  // chunks and planes hold whole vectors
      if (ok[u]) load_n<T, N>(x + j, v[u]);
    }
    float cnt = 0.f, sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      cnt += static_cast<float>(N);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        v[u][k] = Elem<T>::round(v[u][k] + b);
        sum += v[u][k];
      }
    }
    const float mean = sum / cnt;  // cnt >= N: the first load is in range
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = v[u][k] - mean;
        m2 += d * d;
      }
    }
    merge(s, Stat{cnt, mean, m2});
  }
  s = block_merge(s, red);
  if (threadIdx.x == 0) {
    m.part[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] =
        make_float4(s.n, s.mean, s.m2, 0.f);
  }
}

// (mean, 1 / sqrt(var + eps)) of a plane from its splits partials, in
// every thread of the block
__device__ float2 plane_coefs(const float4* __restrict__ part, int splits,
                              float eps, Stat* red, float2* out) {
  Stat s{0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < splits; k += kThreads) {
    const float4 p = part[k];
    merge(s, Stat{p.x, p.y, p.z});
  }
  s = block_merge(s, red);
  if (threadIdx.x == 0) {
    *out = make_float2(s.mean, 1.f / sqrtf(s.m2 / s.n + eps));
  }
  __syncthreads();
  return *out;
}

enum Mode { kRelu = 0, kResidual = 1, kShortcut = 2 };

template <typename T, int N, int MODE>
__global__ void __launch_bounds__(kThreads)
    instance_norm_apply_kernel(const Maps<T> m) {
  __shared__ Stat red[2][kWarps];
  __shared__ float2 coef[2];
  // backwards: the first blocks take the chunks read last by the statistics
  const int b = gridDim.x - 1 - blockIdx.x;
  const int plane = b / m.splits;
  const int begin = (b - plane * m.splits) * m.chunk;
  const int end = min(m.hw, begin + m.chunk);
  const float2 cx =
      plane_coefs(m.part + static_cast<size_t>(plane) * m.splits, m.splits,
                  m.eps, red[0], &coef[0]);
  const float bx = bias_of(m.bx, plane, m.channels);
  float2 cs = make_float2(0.f, 0.f);
  float bs = 0.f;
  if constexpr (MODE == kShortcut) {
    cs = plane_coefs(
        m.part + (static_cast<size_t>(m.planes) + plane) * m.splits,
        m.splits, m.eps, red[1], &coef[1]);
    bs = bias_of(m.br, plane, m.channels);
  }
  const size_t base = static_cast<size_t>(plane) * m.hw;
  const T* x = m.x + base;
  const T* r = MODE == kRelu ? nullptr : m.r + base;
  T* out = m.out + base;
  for (int i = begin + threadIdx.x * N; i < end;
       i += kThreads * N * kUnroll) {
    float v[kUnroll][N], w[kUnroll][N];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads * N;
      ok[u] = j < end;
      if (ok[u]) {
        load_n<T, N>(x + j, v[u]);
        if constexpr (MODE != kRelu) load_n<T, N>(r + j, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float o[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xv = Elem<T>::round(v[u][k] + bx);
        const float y = relu(Elem<T>::round((xv - cx.x) * cx.y));
        if constexpr (MODE == kRelu) {
          o[k] = y;
        } else if constexpr (MODE == kResidual) {
          o[k] = relu(w[u][k] + y);
        } else {
          const float sv = Elem<T>::round(w[u][k] + bs);
          o[k] = relu(Elem<T>::round((sv - cs.x) * cs.y) + y);
        }
      }
      store_n<T, N>(out + i + u * kThreads * N, o);
    }
  }
}

// The stem's form: x channels-last, (N, hw positions, channels), as a
// convolution leaves the NHWC image it took; mode 0 only; out NCHW.
constexpr int kPosUnroll = 4;    // positions a thread an iteration
constexpr int kMaxStemChannels = 128;
constexpr int kTile = 64;        // positions an apply block

// One partial a channel a block: positions [blockIdx.x * chunk, ...) of
// image blockIdx.y. A thread reads one 16-byte vector of channels of a
// position (the warp 512 or 256 contiguous bytes) and keeps one summary a
// channel; the block merges the summaries of each channel's threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    instance_norm_stats_nhwc_kernel(const Maps<T> m) {
  constexpr int V = Elem<T>::kVec;
  __shared__ Stat red[kThreads * V];
  const int groups = m.channels / V;  // vectors a position
  const int lanes = kThreads / groups;  // positions a step
  const int g = threadIdx.x % groups;
  const int q = threadIdx.x / groups;
  const int begin = blockIdx.x * m.chunk;
  const int end = min(m.hw, begin + m.chunk);
  const T* x = m.x + static_cast<size_t>(blockIdx.y) * m.hw * m.channels +
               g * V;
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = bias_of(m.bx, g * V + k, m.channels);
  Stat s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = Stat{0.f, 0.f, 0.f};
  for (int p = begin + q; p < end; p += lanes * kPosUnroll) {
    float v[kPosUnroll][V];
    bool ok[kPosUnroll];
    float cnt = 0.f;
#pragma unroll
    for (int u = 0; u < kPosUnroll; ++u) {
      const int pp = p + u * lanes;
      ok[u] = pp < end;
      if (ok[u]) {
        load_n<T, V>(x + static_cast<size_t>(pp) * m.channels, v[u]);
        cnt += 1.f;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPosUnroll; ++u) {
        if (!ok[u]) continue;
        v[u][k] = Elem<T>::round(v[u][k] + b[k]);
        sum += v[u][k];
      }
      const float mean = sum / cnt;
      float m2 = 0.f;
#pragma unroll
      for (int u = 0; u < kPosUnroll; ++u) {
        if (!ok[u]) continue;
        const float d = v[u][k] - mean;
        m2 += d * d;
      }
      merge(s[k], Stat{cnt, mean, m2});
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) red[threadIdx.x * V + k] = s[k];
  __syncthreads();
  // channel c = g * V + k: the threads g, g + groups, ... in order
  if (threadIdx.x < m.channels) {
    const int c = threadIdx.x;
    Stat a{0.f, 0.f, 0.f};
    for (int j = 0; j < lanes; ++j) {
      merge(a, red[((c / V) + j * groups) * V + c % V]);
    }
    m.part[(static_cast<size_t>(blockIdx.y) * m.channels + c) * m.splits +
           blockIdx.x] = make_float4(a.n, a.mean, a.m2, 0.f);
  }
}

// (mean, 1 / sqrt(var + eps)) of each plane from its splits partials: a
// warp a plane
__global__ void __launch_bounds__(kThreads)
    instance_norm_coef_kernel(const float4* __restrict__ part, int planes,
                              int splits, float eps, float2* __restrict__ coef) {
  const int plane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (plane >= planes) return;
  const int lane = threadIdx.x & 31;
  Stat s{0.f, 0.f, 0.f};
  for (int k = lane; k < splits; k += 32) {
    const float4 p = part[static_cast<size_t>(plane) * splits + k];
    merge(s, Stat{p.x, p.y, p.z});
  }
  for (int o = 16; o > 0; o >>= 1) merge(s, shfl_down(s, o));
  if (lane == 0) {
    coef[plane] = make_float2(s.mean, 1.f / sqrtf(s.m2 / s.n + eps));
  }
}

// relu(norm(x + bias)) of kTile positions of image blockIdx.y, every
// channel: read as channels-last rows, staged channel-major in shared
// memory, written NCHW (16-byte stores where a plane holds whole vectors)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    instance_norm_apply_nhwc_kernel(const Maps<T> m,
                                    const float2* __restrict__ coef) {
  constexpr int V = Elem<T>::kVec;
  __shared__ float tile[kMaxStemChannels][kTile + 1];
  __shared__ float3 cb[kMaxStemChannels];  // mean, 1 / std, bias
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, m.hw - p0);
  const int C = m.channels;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float2 k = coef[n * C + c];
    cb[c] = make_float3(k.x, k.y, bias_of(m.bx, c, C));
  }
  __syncthreads();
  const T* x = m.x + (static_cast<size_t>(n) * m.hw + p0) * C;
  for (int e = threadIdx.x * V; e < np * C; e += kThreads * V) {
    float v[V];
    load_n<T, V>(x + e, v);
    const int p = e / C;
    const int c0 = e - p * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float3 t = cb[c0 + k];
      const float xv = Elem<T>::round(v[k] + t.z);
      tile[c0 + k][p] = relu(Elem<T>::round((xv - t.x) * t.y));
    }
  }
  __syncthreads();
  T* out = m.out + static_cast<size_t>(n) * C * m.hw + p0;
  if (m.hw % V == 0) {  // every plane starts on a 16-byte boundary
    const int per_row = kTile / V;
    for (int i = threadIdx.x; i < C * per_row; i += kThreads) {
      const int c = i / per_row;
      const int j = (i - c * per_row) * V;
      if (j >= np) continue;  // np is a multiple of V here
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = tile[c][j + k];
      store_n<T, V>(out + static_cast<size_t>(c) * m.hw + j, o);
    }
  } else {
    for (int i = threadIdx.x; i < C * kTile; i += kThreads) {
      const int c = i / kTile;
      const int j = i - c * kTile;
      if (j < np) Elem<T>::store(out + static_cast<size_t>(c) * m.hw + j,
                                 tile[c][j]);
    }
  }
}

template <typename T>
int launch_nhwc(const Maps<T>& m, int images, float2* coef, cudaStream_t s) {
  instance_norm_stats_nhwc_kernel<T>
      <<<dim3(m.splits, images), kThreads, 0, s>>>(m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  instance_norm_coef_kernel<<<(m.planes + kWarps - 1) / kWarps, kThreads, 0,
                              s>>>(m.part, m.planes, m.splits, m.eps, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  instance_norm_apply_nhwc_kernel<T>
      <<<dim3((m.hw + kTile - 1) / kTile, images), kThreads, 0, s>>>(m, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch(const Maps<T>& m, int mode, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(m.planes) * m.splits;
  instance_norm_stats_kernel<T, N>
      <<<dim3(blocks, mode == kShortcut ? 2 : 1), kThreads, 0, s>>>(m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (mode) {
    case kRelu:
      instance_norm_apply_kernel<T, N, kRelu><<<blocks, kThreads, 0, s>>>(m);
      break;
    case kResidual:
      instance_norm_apply_kernel<T, N, kResidual>
          <<<blocks, kThreads, 0, s>>>(m);
      break;
    default:
      instance_norm_apply_kernel<T, N, kShortcut>
          <<<blocks, kThreads, 0, s>>>(m);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* r, const void* bx, const void* br,
                 int mode, int planes, int channels, int hw, int splits,
                 int chunk, int vec, float eps, void* part, void* out,
                 cudaStream_t s) {
  const Maps<T> m{static_cast<const T*>(x), static_cast<const T*>(r),
                  static_cast<const T*>(bx), static_cast<const T*>(br),
                  static_cast<float4*>(part), static_cast<T*>(out),
                  planes, channels, hw, splits, chunk, eps};
  return vec == 1 ? launch<T, 1>(m, mode, s)
                  : launch<T, Elem<T>::kVec>(m, mode, s);
}

}  // namespace

// x, out: (planes, hw) float32 (bf16 = 0) or bf16 (bf16 = 1), contiguous,
// planes = N * channels; r: null (mode 0), the residual (mode 1) or the
// shortcut convolution's output (mode 2), x's shape and type; bx, br: null
// or (channels,) biases of x's type added to x and (mode 2) to r as the
// convolutions that made them would; part: (2 if mode 2 else 1, planes,
// splits) float4 scratch. vec: 1, or the elements of a 16-byte load (4
// float32, 8 bf16) where hw is a multiple of it and x, r, out are 16-byte
// aligned; chunk a multiple of vec, splits * chunk >= hw. Two launches on
// stream; returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int woft_instance_norm(const void* x, const void* r,
                                  const void* bx, const void* br, int mode,
                                  int bf16, int planes, int channels, int hw,
                                  int splits, int chunk, int vec, float eps,
                                  void* part, void* out, void* stream) {
  const long long blocks = static_cast<long long>(planes) * splits;
  if (vec != 1 && vec != (bf16 ? 8 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes < 1 || channels < 1 || planes % channels || hw < 1 ||
      splits < 1 || chunk < 1 || chunk % vec || mode < 0 || mode > 2 ||
      (mode != kRelu && r == nullptr) || (mode != kShortcut && br) ||
      blocks > 0x7fffffffLL || static_cast<long long>(splits) * chunk < hw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_typed<unsigned short>(x, r, bx, br, mode, planes,
                                             channels, hw, splits, chunk, vec,
                                             eps, part, out, s)
              : launch_typed<float>(x, r, bx, br, mode, planes, channels, hw,
                                    splits, chunk, vec, eps, part, out, s);
}

// The stem's form: x (images, hw, channels) channels-last, float32 or bf16,
// channels a multiple of the 16-byte vector (4 float32, 8 bf16) whose
// vectors a position divide 256, at most 128; x 16-byte aligned; bx null or
// (channels,); part (images * channels, splits) float4 scratch, coef
// (images * channels) float2 scratch; out (images, channels, hw)
// contiguous. relu(norm(x + bx)), three launches (statistics, the
// planes' coefficients, apply) on stream.
extern "C" int woft_instance_norm_nhwc(const void* x, const void* bx,
                                       int bf16, int images, int channels,
                                       int hw, int splits, int chunk,
                                       float eps, void* part, void* coef,
                                       void* out, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (images < 1 || images > 65535 || channels < vec ||
      channels % vec || kThreads % (channels / vec) ||
      channels > kMaxStemChannels || hw < 1 || splits < 1 || chunk < 1 ||
      splits > 65535 || static_cast<long long>(splits) * chunk < hw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* k = static_cast<float2*>(coef);
  if (bf16) {
    using T = unsigned short;
    const Maps<T> m{static_cast<const T*>(x), nullptr,
                    static_cast<const T*>(bx), nullptr,
                    static_cast<float4*>(part), static_cast<T*>(out),
                    images * channels, channels, hw, splits, chunk, eps};
    return launch_nhwc<T>(m, images, k, s);
  }
  const Maps<float> m{static_cast<const float*>(x), nullptr,
                      static_cast<const float*>(bx), nullptr,
                      static_cast<float4*>(part), static_cast<float*>(out),
                      images * channels, channels, hw, splits, chunk, eps};
  return launch_nhwc<float>(m, images, k, s);
}
