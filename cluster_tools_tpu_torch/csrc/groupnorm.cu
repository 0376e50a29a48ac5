// GroupNorm followed by the tanh GELU, forward and backward, for the U-Net's
// ConvBlock (cluster_tools_tpu_torch/models/unet.py, through ops/norm.py):
//
//     z = (x - mean_g) * rstd_g * w_c + b_c,     y = gelu_tanh(z)
//
// on a contiguous (N, C, S) tensor (S = D * H * W), G groups of C / G
// channels, the moments taken per (sample, group) over C / G * S values
// (biased variance, rstd = 1 / sqrt(var + eps)).  It replaces no Pallas
// kernel: the JAX package leaves flax's nn.GroupNorm and nn.gelu
// (cluster_tools_tpu/models/unet.py:51-53) to XLA.  Before it, the port ran
// PyTorch's GroupNorm on a float32 copy of each bfloat16 convolution output:
// one thread block per (sample, group) row for the moments (16 blocks on
// 132 SMs at the U-Net's batch of 2 and 8 groups) and separate float32
// passes for the affine apply, GELU and the casts.
//
// What bounds it on an H100: bytes.  Some 20-30 float32 operations per
// value against 6 bytes moved per bfloat16 value forward (x read for the
// moments, x read and y written by the apply) and 10 backward (x and dy read
// by the reduction and again by the dx pass, dx written).  The design:
//   * every reduction is split over many blocks.  The (sample, channel)
//     rows of S values are cut into K chunks of L values (ops/norm.py
//     chunk_plan: at least 4 blocks per SM, chunks of at most 32768 values);
//     block b reduces chunk b % K of row b / K and writes its partial.  A
//     second, small launch of one warp per group (forward), or per channel
//     and per group (backward), merges the partials in a fixed order.  No
//     atomics: two calls on one input give bitwise equal outputs;
//   * the moments are Welford-stable: each thread folds its values 8 at a
//     time as (count, mean, M2) by Chan's formula, the block merges its
//     threads' moments the same way in a fixed tree, and the group's merge
//     runs in float64.  No E[x^2] - E[x]^2;
//   * x is read in its own dtype, 16 bytes a thread per load of bfloat16
//     (8 values; 2 x 16 bytes for float32), kUnroll loads in flight, and y
//     written once in the output dtype.  The backward recomputes z and
//     gelu'(z) from x and the saved (mean, rstd): no float32 activation is
//     stored anywhere;
//   * GELU as z * sigmoid(2u) with u = sqrt(2 / pi) (z + 0.044715 z^3): the
//     same function as 0.5 z (1 + tanh u), without the cancellation of
//     1 + tanh u; its derivative s + 2 z s (1 - s) u', s = sigmoid(2u),
//     with 1 - s formed as e * s where e = exp(-2u) <= 1.
// All arithmetic is float32 (the merges float64); a value's channel is
// fixed within a block, so (mean, rstd, w, b) are read once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a chunk's block
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 8;       // values per vector load (16 B of bfloat16)
constexpr int kUnroll = 4;     // vector loads a thread has in flight

constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

// ---------------------------------------------------------------------------
// loads and stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load_pack(const float* p, float v[kPack]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_pack(const __nv_bfloat16* p,
                                          float v[kPack]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address in the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_pack(float* p, const float v[kPack]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_pack(__nv_bfloat16* p,
                                           const float v[kPack]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// GELU (tanh approximation) and its derivative
// ---------------------------------------------------------------------------

__device__ __forceinline__ float gelu_u(float z) {
  return kBeta * fmaf(kKappa * z, z * z, z);
}

// exp and the division by the hardware's approximations (a few float32
// ulps; once e overflows, z / (1 + e) reads 0, its limit): the backward's
// reduction has some 40 float32 operations per value to spend at the
// card's bandwidth, and the IEEE forms alone take half of them.
__device__ __forceinline__ float gelu_tanh(float z) {
  return __fdividef(z, 1.f + __expf(-2.f * gelu_u(z)));
}

__device__ __forceinline__ float gelu_tanh_grad(float z) {
  const float u = gelu_u(z);
  const float e = __expf(-2.f * u);
  const float s = __fdividef(1.f, 1.f + e);       // (1 + tanh u) / 2
  const float t = u >= 0.f ? e * s : 1.f - s;     // 1 - s
  const float du = kBeta * fmaf(3.f * kKappa * z, z, 1.f);
  return fmaf(2.f * z * s, t * du, s);
}

// ---------------------------------------------------------------------------
// fixed-order reductions
// ---------------------------------------------------------------------------

struct Moments {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2); exact when either is empty.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float fb = b.n / n;
  const float d = b.mean - a.mean;
  Moments r;
  r.n = n;
  r.mean = fmaf(d, fb, a.mean);
  r.m2 = a.m2 + b.m2 + d * d * (a.n * fb);
  return r;
}

__device__ __forceinline__ Moments pack_moments(const float v[kPack]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPack; ++i) s += v[i];
  const float m = s * (1.f / kPack);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPack; ++i) {
    const float d = v[i] - m;
    q = fmaf(d, d, q);
  }
  return Moments{static_cast<float>(kPack), m, q};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o;
    o.n = __shfl_down_sync(0xffffffffu, m.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, m.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, m.m2, off);
    m = merge(m, o);
  }
  return m;  // lane 0 holds the warp's moments
}

// The block's moments, in thread 0.
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments warps[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  m = warp_merge(m);
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warps[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
  }
  return m;
}

// The block's sums, in thread 0.
__device__ __forceinline__ float2 block_sum(float2 v) {
  __shared__ float2 warps[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warps[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, off);
      v.y += __shfl_down_sync(0xffffffffu, v.y, off);
    }
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One chunk of one (sample, channel) row: values [s0, s1) of the row at
// ``base``, as this thread reads them, in order.  Calls ``f(p, 8, v)`` on
// each full pack p (values 8p .. 8p + 7, vector loads, when VEC) and
// ``f(-1 - i, 1, &v)`` on each value i read alone (the chunk's tail, or
// every value when not VEC).
template <typename T, bool VEC, typename F>
__device__ __forceinline__ void walk_chunk(const T* base, long long s0,
                                           long long s1, F&& f) {
  long long tail = s0;
  if (VEC) {
    const long long p1 = s1 / kPack;
    for (long long p = s0 / kPack + threadIdx.x; p < p1;
         p += kThreads * kUnroll) {
      float v[kUnroll][kPack];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kThreads < p1)
          load_pack(base + (p + u * kThreads) * kPack, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kThreads < p1) f(p + u * kThreads, kPack, v[u]);
    }
    tail = p1 * kPack;
  }
  for (long long i = tail + threadIdx.x; i < s1; i += kThreads) {
    float v = to_float(base[i]);
    f(-1 - i, 1, &v);
  }
}

// The (row, chunk) of block b and the chunk's values [s0, s1).
struct Chunk {
  long long row, s0, s1;
};

__device__ __forceinline__ Chunk chunk_of_block(long long S, long long L,
                                                int K) {
  Chunk ch;
  ch.row = blockIdx.x / K;
  ch.s0 = (blockIdx.x % K) * L;
  ch.s1 = min(ch.s0 + L, S);
  return ch;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Pass 1: the moments (mean, M2) of one chunk of one (sample, channel) row.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
groupnorm_stats_kernel(const T* __restrict__ x, float2* __restrict__ part,
                       long long S, long long L, int K) {
  const Chunk ch = chunk_of_block(S, L, K);
  Moments acc{0.f, 0.f, 0.f};
  walk_chunk<T, VEC>(x + ch.row * S, ch.s0, ch.s1,
                     [&](long long, int n, const float* v) {
                       acc = merge(acc, n == kPack
                                            ? pack_moments(v)
                                            : Moments{1.f, v[0], 0.f});
                     });
  acc = block_merge(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(acc.mean, acc.m2);
}

// Pass 2: one warp per (sample, group) merges the partials of the group's
// C / G channels, channel by channel and chunk by chunk (lane j takes
// partials j, j + 32, ...), in float64; writes the group's mean and rstd.
__global__ void groupnorm_moments_kernel(const float2* __restrict__ part,
                                         float* __restrict__ mean,
                                         float* __restrict__ rstd,
                                         long long S, long long L, int K,
                                         int cpg, float eps) {
  const long long ng = blockIdx.x;
  const int lane = threadIdx.x;
  const float2* pg = part + ng * cpg * K;
  double n = 0.0, mu = 0.0, m2 = 0.0;
  for (long long j = lane; j < static_cast<long long>(cpg) * K; j += 32) {
    const long long k = j % K;
    const double nb = static_cast<double>(min(L, S - k * L));
    const float2 p = pg[j];
    const double nn = n + nb, fb = nb / nn, d = p.x - mu;
    mu += d * fb;
    m2 += p.y + d * d * n * fb;
    n = nn;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, off);
    const double mb = __shfl_down_sync(0xffffffffu, mu, off);
    const double qb = __shfl_down_sync(0xffffffffu, m2, off);
    const double nn = n + nb;
    if (nn > 0.0) {
      const double fb = nb / nn, d = mb - mu;
      mu += d * fb;
      m2 += qb + d * d * n * fb;
      n = nn;
    }
  }
  if (lane == 0) {
    const double var = fmax(m2 / n, 0.0);
    mean[ng] = static_cast<float>(mu);
    rstd[ng] = static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
  }
}

// Pass 3: y = gelu_tanh(x * a + sh), a = rstd * w_c, sh = b_c - mean * a.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                            const float* __restrict__ w,
                            const float* __restrict__ b,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd, long long S,
                            long long L, int K, int C, int cpg) {
  const Chunk ch = chunk_of_block(S, L, K);
  const long long ng = ch.row / cpg;
  const int c = static_cast<int>(ch.row % C);
  const float a = rstd[ng] * w[c];
  const float sh = fmaf(-a, mean[ng], b[c]);
  T* yr = y + ch.row * S;
  walk_chunk<T, VEC>(x + ch.row * S, ch.s0, ch.s1,
                     [&](long long p, int n, const float* v) {
                       float o[kPack];
#pragma unroll
                       for (int i = 0; i < kPack; ++i)
                         if (i < n) o[i] = gelu_tanh(fmaf(v[i], a, sh));
                       if (n == kPack)
                         store_pack(yr + p * kPack, o);
                       else
                         yr[-1 - p] = from_float<T>(o[0]);
                     });
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dz = dy * gelu'(z) and xhat = (x - mean) * rstd of one value.
struct Grad {
  float a, sh, mu, r;
  __device__ __forceinline__ void operator()(float x, float dy, float* dz,
                                             float* xhat) const {
    *dz = dy * gelu_tanh_grad(fmaf(x, a, sh));
    *xhat = (x - mu) * r;
  }
};

__device__ __forceinline__ Grad grad_of_row(long long row, int C, int cpg,
                                            const float* w, const float* b,
                                            const float* mean,
                                            const float* rstd) {
  const long long ng = row / cpg;
  const int c = static_cast<int>(row % C);
  Grad g;
  g.mu = mean[ng];
  g.r = rstd[ng];
  g.a = g.r * w[c];
  g.sh = fmaf(-g.a, g.mu, b[c]);
  return g;
}

// Pass 1: sum dz and dz * xhat over one chunk of one (sample, channel) row.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_bwd_reduce_kernel(const T* __restrict__ dy,
                                 const T* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 float2* __restrict__ part, long long S,
                                 long long L, int K, int C, int cpg) {
  const Chunk ch = chunk_of_block(S, L, K);
  const Grad g = grad_of_row(ch.row, C, cpg, w, b, mean, rstd);
  const T* dyr = dy + ch.row * S;
  float2 acc = make_float2(0.f, 0.f);
  walk_chunk<T, VEC>(x + ch.row * S, ch.s0, ch.s1,
                     [&](long long p, int n, const float* v) {
                       float d[kPack];
                       if (n == kPack)
                         load_pack(dyr + p * kPack, d);
                       else
                         d[0] = to_float(dyr[-1 - p]);
#pragma unroll
                       for (int i = 0; i < kPack; ++i)
                         if (i < n) {
                           float dz, xh;
                           g(v[i], d[i], &dz, &xh);
                           acc.x += dz;
                           acc.y = fmaf(dz, xh, acc.y);
                         }
                     });
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// Pass 2.  Blocks 0 .. C-1: channel c's partials over the samples and
// chunks: dbias[c] = sum dz, dweight[c] = sum dz * xhat.  Blocks C ..: one
// per (sample, group), the group's sums of w_c dz and w_c dz xhat over its
// M = C / G * S values, divided by M.  Fixed order, float64.
__global__ void groupnorm_gelu_bwd_params_kernel(
    const float2* __restrict__ part, const float* __restrict__ w,
    float* __restrict__ dw, float* __restrict__ db,
    float2* __restrict__ coef, long long N, int C, int cpg, int K,
    double M) {
  const int lane = threadIdx.x;
  double s1 = 0.0, s2 = 0.0;
  const bool channel = blockIdx.x < static_cast<unsigned int>(C);
  if (channel) {
    const long long c = blockIdx.x;
    for (long long j = lane; j < N * K; j += 32) {
      const float2 p = part[((j / K) * C + c) * K + j % K];
      s1 += p.x;
      s2 += p.y;
    }
  } else {
    const long long ng = blockIdx.x - C;
    const float2* pg = part + ng * cpg * K;
    for (long long j = lane; j < static_cast<long long>(cpg) * K; j += 32) {
      const double wc = w[(ng * cpg + j / K) % C];
      const float2 p = pg[j];
      s1 += wc * p.x;
      s2 += wc * p.y;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane != 0) return;
  if (channel) {
    db[blockIdx.x] = static_cast<float>(s1);
    dw[blockIdx.x] = static_cast<float>(s2);
  } else {
    coef[blockIdx.x - C] =
        make_float2(static_cast<float>(s1 / M), static_cast<float>(s2 / M));
  }
}

// Pass 3: dx = rstd (w_c dz - mean(w dz) - xhat mean(w dz xhat)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_bwd_dx_kernel(const T* __restrict__ dy,
                             const T* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ b,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float2* __restrict__ coef,
                             T* __restrict__ dx, long long S, long long L,
                             int K, int C, int cpg) {
  const Chunk ch = chunk_of_block(S, L, K);
  const Grad g = grad_of_row(ch.row, C, cpg, w, b, mean, rstd);
  const float wc = w[ch.row % C];
  const float2 q = coef[ch.row / cpg];
  const T* dyr = dy + ch.row * S;
  T* dxr = dx + ch.row * S;
  walk_chunk<T, VEC>(x + ch.row * S, ch.s0, ch.s1,
                     [&](long long p, int n, const float* v) {
                       float d[kPack], o[kPack];
                       if (n == kPack)
                         load_pack(dyr + p * kPack, d);
                       else
                         d[0] = to_float(dyr[-1 - p]);
#pragma unroll
                       for (int i = 0; i < kPack; ++i)
                         if (i < n) {
                           float dz, xh;
                           g(v[i], d[i], &dz, &xh);
                           o[i] = g.r * (fmaf(wc, dz, -q.x) - xh * q.y);
                         }
                       if (n == kPack)
                         store_pack(dxr + p * kPack, o);
                       else
                         dxr[-1 - p] = from_float<T>(o[0]);
                     });
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int check(long long N, int C, int G, long long S, long long L, int K) {
  if (G <= 0 || C % G != 0 || K <= 0 || L <= 0 || L % kPack != 0 ||
      (K - 1) * L >= S || K * L < S || N * C * K > 0x7fffffffLL ||
      N * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T, bool VEC>
int forward(const void* xv, void* yv, const float* w, const float* b,
            float* mean, float* rstd, float2* part, long long N, int C,
            int G, long long S, long long L, int K, float eps,
            cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int cpg = C / G;
  const unsigned int blocks = static_cast<unsigned int>(N * C * K);
  groupnorm_stats_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(x, part, S, L,
                                                               K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  groupnorm_moments_kernel<<<static_cast<unsigned int>(N * G), 32, 0, st>>>(
      part, mean, rstd, S, L, K, cpg, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  groupnorm_gelu_apply_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      x, y, w, b, mean, rstd, S, L, K, C, cpg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int backward(const void* dyv, const void* xv, const float* w, const float* b,
             const float* mean, const float* rstd, void* dxv, float* dw,
             float* db, float2* part, float2* coef, long long N, int C,
             int G, long long S, long long L, int K, cudaStream_t st) {
  const T* dy = static_cast<const T*>(dyv);
  const T* x = static_cast<const T*>(xv);
  T* dx = static_cast<T*>(dxv);
  const int cpg = C / G;
  const unsigned int blocks = static_cast<unsigned int>(N * C * K);
  groupnorm_gelu_bwd_reduce_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      dy, x, w, b, mean, rstd, part, S, L, K, C, cpg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  groupnorm_gelu_bwd_params_kernel<<<static_cast<unsigned int>(C + N * G), 32,
                                     0, st>>>(
      part, w, dw, db, coef, N, C, cpg, K,
      static_cast<double>(cpg) * static_cast<double>(S));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  groupnorm_gelu_bwd_dx_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
      dy, x, w, b, mean, rstd, coef, dx, S, L, K, C, cpg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  ``dtype`` 0 = float32,
// 1 = bfloat16, for x, y, dy and dx alike; w, b, mean, rstd, dw, db are
// float32; ``part`` holds N * C * K float2 partials and ``coef`` N * G
// float2.  The (row, chunk) plan (L, K) is ops/norm.py chunk_plan's: L a
// multiple of 8, K = ceil(S / L).  Vector loads are used when S is a
// multiple of 8 and every tensor pointer is 16-byte aligned.  Each launches
// three kernels on ``stream``, allocates nothing and returns the first
// cudaError_t of its launches.

extern "C" int ctt_groupnorm_gelu_fwd(const void* x, void* y, int dtype,
                                      const float* w, const float* b,
                                      float* mean, float* rstd, void* part,
                                      long long N, int C, int G, long long S,
                                      long long L, int K, float eps,
                                      void* stream) {
  if (N <= 0 || C <= 0 || S <= 0) return 0;
  const int bad = check(N, C, G, S, L, K);
  if (bad) return bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  const bool vec = S % kPack == 0 && aligned16(x) && aligned16(y);
  if (dtype == 0)
    return vec ? forward<float, true>(x, y, w, b, mean, rstd, p, N, C, G, S,
                                      L, K, eps, st)
               : forward<float, false>(x, y, w, b, mean, rstd, p, N, C, G, S,
                                       L, K, eps, st);
  if (dtype == 1)
    return vec ? forward<__nv_bfloat16, true>(x, y, w, b, mean, rstd, p, N, C,
                                              G, S, L, K, eps, st)
               : forward<__nv_bfloat16, false>(x, y, w, b, mean, rstd, p, N,
                                               C, G, S, L, K, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ctt_groupnorm_gelu_bwd(const void* dy, const void* x,
                                      int dtype, const float* w,
                                      const float* b, const float* mean,
                                      const float* rstd, void* dx, float* dw,
                                      float* db, void* part, void* coef,
                                      long long N, int C, int G, long long S,
                                      long long L, int K, void* stream) {
  if (N <= 0 || C <= 0 || S <= 0) return 0;
  const int bad = check(N, C, G, S, L, K);
  if (bad) return bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  float2* q = static_cast<float2*>(coef);
  const bool vec =
      S % kPack == 0 && aligned16(dy) && aligned16(x) && aligned16(dx);
  if (dtype == 0)
    return vec ? backward<float, true>(dy, x, w, b, mean, rstd, dx, dw, db, p,
                                       q, N, C, G, S, L, K, st)
               : backward<float, false>(dy, x, w, b, mean, rstd, dx, dw, db,
                                        p, q, N, C, G, S, L, K, st);
  if (dtype == 1)
    return vec ? backward<__nv_bfloat16, true>(dy, x, w, b, mean, rstd, dx,
                                               dw, db, p, q, N, C, G, S, L,
                                               K, st)
               : backward<__nv_bfloat16, false>(dy, x, w, b, mean, rstd, dx,
                                                dw, db, p, q, N, C, G, S, L,
                                                K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
