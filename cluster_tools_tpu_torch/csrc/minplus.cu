// Min-plus ("tropical") product along one axis of the separable exact EDT:
//
//     out[r, i] = min_j  f[r, j] + ((i - j) * s)^2        f: float32 (m, n)
//
// Replaces the TPU kernel cluster_tools_tpu/ops/edt.py:53-105
// (_minplus_pallas_impl): there a grid of (row tiles, i tiles, j tiles)
// whose sequential j axis carried a running minimum in the revisited output
// block.  Blocks of a CUDA grid run in no order, so here the grid covers
// (row tiles, i tiles) and each block walks the whole j axis itself.
//
// What bounds it on an H100: arithmetic.  Every (r, i, j) triple is one
// fp32 add and one min, 2*m*n^2 operations per axis against 8*m*n bytes of
// traffic (f read once, out written once).  Design against that bound:
//   * one block owns BM x BI outputs; each thread keeps RM x RI running
//     minima in registers, so a value of f loaded from shared memory is
//     used RI times and a cost RM times;
//   * f is staged through shared memory one TJ-wide j tile at a time
//     (rows padded by one float against bank conflicts);
//   * costs depend only on i - j and are rebuilt from integers: a thread's
//     RI costs slide by one position per j step, so each step computes one
//     new cost instead of RI;
//   * the ragged edges (r >= m, i >= n, j >= n) are masked, not padded:
//     the j = i term already yields f[r, i], so a mask equals the TPU
//     kernel's 1e10 padding.
// Rounding: cost = (d * d) * s^2 with d = float(i - j), then f + cost, each
// op rounded separately (__fmul_rn / __fadd_rn: no FMA contraction), the
// same float32 op sequence as the plain PyTorch version in ops/edt.py.
// So results are bitwise equal to it at any spacing, and at unit spacing
// bitwise equal to the JAX package's XLA path too.

#include <cuda_runtime.h>

namespace {

constexpr int RM = 4;            // rows per thread
constexpr int RI = 4;            // consecutive i per thread
constexpr int TX = 16;           // threads along i
constexpr int TY = 16;           // threads along rows
constexpr int BM = TY * RM;      // rows per block
constexpr int BI = TX * RI;      // i per block
constexpr int TJ = 64;           // j tile staged in shared memory

__device__ __forceinline__ float sq_cost(int d, float s2) {
  const float df = static_cast<float>(d);
  return __fmul_rn(__fmul_rn(df, df), s2);
}

__global__ void __launch_bounds__(TX * TY)
minplus_rows_kernel(const float* __restrict__ f, float* __restrict__ out,
                    long long m, int n, float s2) {
  __shared__ float fs[BM][TJ + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int i0 = blockIdx.y * BI + tx * RI;

  float acc[RM][RI];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int t = 0; t < RI; ++t) acc[a][t] = __int_as_float(0x7f800000);

  for (int j0 = 0; j0 < n; j0 += TJ) {
    const int jn = min(TJ, n - j0);
    __syncthreads();
    for (int e = tid; e < BM * TJ; e += TX * TY) {
      const int rr = e / TJ;
      const int jj = e - rr * TJ;
      const long long r = row0 + rr;
      fs[rr][jj] = (r < m && jj < jn) ? f[r * n + j0 + jj] : 0.0f;
    }
    __syncthreads();

    // costs of this thread's RI outputs at j = j0, then slide per step
    float w[RI];
#pragma unroll
    for (int t = 0; t < RI; ++t) w[t] = sq_cost(i0 + t - j0, s2);

    for (int jj = 0; jj < jn; ++jj) {
      float fv[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a) fv[a] = fs[ty * RM + a][jj];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int t = 0; t < RI; ++t)
          acc[a][t] = fminf(acc[a][t], __fadd_rn(fv[a], w[t]));
#pragma unroll
      for (int t = RI - 1; t > 0; --t) w[t] = w[t - 1];
      w[0] = sq_cost(i0 - (j0 + jj + 1), s2);
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const long long r = row0 + ty * RM + a;
    if (r >= m) continue;
#pragma unroll
    for (int t = 0; t < RI; ++t)
      if (i0 + t < n) out[r * n + i0 + t] = acc[a][t];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns the cudaError_t of the launch; allocates nothing.
extern "C" int ctt_minplus_rows(const float* f, float* out, long long m,
                                int n, float s2, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long row_tiles = (m + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned int>(row_tiles), (n + BI - 1) / BI);
  const dim3 block(TX, TY);
  minplus_rows_kernel<<<grid, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(f, out, m, n, s2);
  return static_cast<int>(cudaGetLastError());
}
