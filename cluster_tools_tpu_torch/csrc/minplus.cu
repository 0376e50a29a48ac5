// Min-plus ("tropical") product along one axis of the separable exact EDT,
// computed as the exact lower envelope of parabolas:
//
//     out[i] = min_j  f[j] + ((i - j) * s)^2      for every scanline f
//
// of a float32 (or boolean mask) tensor viewed as (outer, n, inner), the
// scanline axis in the middle.  Replaces the TPU kernel
// cluster_tools_tpu/ops/edt.py:53-105 (_minplus_pallas_impl), a dense
// min-plus product: there every (row, i, j) triple was evaluated, because a
// Pallas grid marches VMEM tiles and has no cheap per-lane sequential scan.
// On Hopper a thread can walk a scanline, so the Felzenszwalb-Huttenlocher
// envelope does the same function in O(n) per scanline instead of O(n^2).
//
// What bounds it on an H100: bytes.  Each launch reads f once and writes out
// once, 8 bytes per element (5 when f is the mask), against ~20 instructions
// per element.  But the envelope is a walk in order, with data-dependent
// branches, and a (58, 576, 576) block has only 33,408 scanlines along y or
// x.  So the walk's latency is what the design fights:
//   * two walkers per scanline.  Each scanline is cut into two bands; warp
//     2g builds the envelope of band 0 and warp 2g + 1 that of band 1 of
//     the same 32 scanlines.  The envelope of the whole scanline is the
//     lower convex hull of the points (v, h_v) (h as under Exactness), and
//     the hull of two x-separated point sets is a prefix of the left hull
//     and a suffix of the right one: the band-0 walker finds the bridge
//     between them with the same exact test, and each walker then writes
//     its own band's outputs, band 1 starting from the entry in use at its
//     first position (a short walk from the bridge).  That halves the
//     serial walk and the stack per thread, and doubles the threads.
//   * scanlines stay where they lie.  For inner > 1 (the z and y axes of a
//     C-ordered volume) lane t walks the scanline at inner offset t, so at
//     each step neighbouring lanes read neighbouring addresses.  For
//     inner == 1 (x, contiguous scanlines) a warp stages 32 rows x 16
//     elements of its scanlines through shared memory: coalesced row
//     segments in, and the same transposed on the way out.
//   * both layouts stage 16 elements per thread at a time into two tiles
//     per warp taken in turns, their loads issued a chunk ahead into
//     registers, so they are in flight while the previous chunk is walked.
//     Pops re-read f at positions under the stack's top: mostly in the
//     current or the previous chunk, else loaded when that position comes
//     second from the top, one pop before it is needed.  The output walk
//     gathers f at the next 16 envelope entries at the start of each chunk,
//     while the warp is converged, so its advances read shared memory.
//     Global loads inside the data-dependent loops would stall the warp.
//   * the envelope stack holds uint16 scanline positions in shared memory
//     (2 bytes per element of a band, laid out [k][thread] so a warp at one
//     depth hits consecutive banks).  f is not kept beside them: that would
//     triple the stack and cut the warps per SM.  The walk keeps positions
//     as doubles and floats beside the integers, so a step converts only
//     its own f: conversions issue at a quarter of the float64 rate.
//   * template flags instead of extra passes: the first axis of an EDT may
//     read the boolean mask itself (True -> BIG, False -> 0; every present
//     entry is then 0 and f is never re-read), the last writes the correctly
//     rounded float32 sqrt (__fsqrt_rn).
//
// Exactness.  Parabola v is g_v(x) = f[v] + S (x - v)^2 with S = float32(s^2)
// and h_v = f[v] + S v^2.  For a < b, g_b(x) - g_a(x) = (h_b - h_a) -
// 2 S (b - a) x falls in x and crosses 0 at (h_b - h_a) / (2 S (b - a)).
// Every envelope test (pops, the bridge, the walks) compares such crossings
// cross-multiplied, in float64, with no division:
//   t is covered by p < t < q:  (h_q - h_t) (t - p) <= (h_t - h_p) (q - t)
//   b is in use at i, not a:    h_b - h_a <= 2 S (b - a) i
// At unit spacing with integer-valued f below 2^24 (squared distances) every
// operand is an integer below 2^40, so every float64 product and sum is
// exact and the envelope is the exact one.  Each output is then formed as
// the dense product forms each of its terms, cost = (d * d) * s^2 from
// integer d = i - v, then f[v] + cost, each op rounded on its own
// (__fmul_rn/__fadd_rn, -fmad=false): it is one of the dense minimum's own
// terms, and because rounding is monotone it is that minimum bitwise.  At
// other spacings the envelope picks the exact real argmin while the dense
// minimum of rounded terms may pick a near-tie a few ulp lower: the two
// agree within rtol 1e-6.  Entries equal to BIG (1e10) are absent
// parabolas; a scanline with none present outputs BIG, as the dense
// minimum does (fl(BIG + 0)).  That is exact while every present entry
// plus its largest cost stays below BIG, as squared distances do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;
constexpr int kChunk = 16;                    // elements staged per step
constexpr int kPitch = kChunk + 1;            // tile row pitch, no conflicts
constexpr int kTile = 32 * kPitch;            // floats in one warp's tile
constexpr int kMaxWarps = 8;
constexpr size_t kBlockSmem = 48 * 1024;      // per-block budget to aim at
constexpr size_t kMaxSmem = 232448;           // per-block limit on sm_90

// Each scanline is cut into two bands, [0, nb) and [nb, n); warp 2g walks
// band 0 and warp 2g + 1 band 1 of the same 32 scanlines.
__host__ __device__ __forceinline__ int band_len(int n) { return (n + 1) / 2; }

__host__ __device__ __forceinline__ size_t stack_bytes(int n, int threads) {
  return (static_cast<size_t>(band_len(n)) * threads * 2 + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int threads) {
  return stack_bytes(n, threads) +
         static_cast<size_t>(threads / 32) * 2 * kTile * sizeof(float);
}

template <typename In>
__device__ __forceinline__ float value(const In* p);

template <>
__device__ __forceinline__ float value<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float value<uint8_t>(const uint8_t* p) {
  return __ldg(p) ? kBig : 0.0f;
}

// true when t is not on the envelope of p < t < q: (h_q - h_t) (t - p) <=
// (h_t - h_p) (q - t), positions as doubles
__device__ __forceinline__ bool covered(double p, double hp, double t,
                                        double ht, double q, double hq) {
  return (hq - ht) * (t - p) <= (ht - hp) * (q - t);
}

template <typename In, bool ROWS, bool SQRT>
__global__ void __launch_bounds__(kMaxWarps * 32)
minplus_envelope_kernel(const In* __restrict__ f, float* __restrict__ out,
                        long long lines, int n, long long inner, float s2) {
  constexpr bool kMask = sizeof(In) == 1;  // present entries are all 0
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int band = (tid >> 5) & 1;
  const int nb = band_len(n);
  const int lo = band * nb;                // this thread's band [lo, hi)
  const int hi = min(n, lo + nb);
  uint16_t* stk = reinterpret_cast<uint16_t*>(smem);  // [k][tid], k < nb
  const int tid0 = tid - band * 32;        // the two walkers of a scanline
  const int tid1 = tid0 + 32;
  // the warp's two tiles, [scanline][element]; a thread owns one row of each
  float* tiles = reinterpret_cast<float*>(smem + stack_bytes(n, T)) +
                 (tid >> 5) * 2 * kTile;

  const long long line =
      static_cast<long long>(blockIdx.x) * (T / 2) + (tid >> 6) * 32 + lane;
  const long long row0 = line - lane;  // ROWS: the warp's first scanline
  const bool valid = line < lines;
  long long base, stride;
  if (ROWS) {
    base = line * n;
    stride = 1;
  } else {
    const long long a = line / inner;
    base = a * n * inner + (line - a * inner);
    stride = inner;
  }
  const double S = s2;
  auto at = [&](int j) { return value<In>(f + base + j * stride); };
  // f and h = f + S v^2 at a present position v, from global memory
  auto f_of = [&](int v) { return kMask ? 0.0f : at(v); };
  auto h_of = [&](double vd, float fv) {
    return static_cast<double>(fv) + S * (vd * vd);
  };
  // loads of elements [q0, q0 + cn) of the warp's scanlines into registers
  // (ROWS: v[i] is element q0 + lane % 16 of row 2i + lane / 16; else v[c]
  // is element q0 + c of the thread's own scanline), then their stores into
  // a tile.  Issued one chunk ahead, so the loads are in flight while a
  // chunk is walked.
  auto load = [&](float* v, int q0, int cn) {
    if (ROWS) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const long long row = row0 + 2 * i + (lane >> 4);
        v[i] = row < lines && (lane & 15) < cn
                   ? value<In>(f + row * n + q0 + (lane & 15)) : 0.0f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        v[c] = valid && c < cn ? at(q0 + c) : 0.0f;
    }
  };
  auto store = [&](float* tl, const float* v) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (ROWS)
        tl[(2 * c + (lane >> 4)) * kPitch + (lane & 15)] = v[c];
      else
        tl[lane * kPitch + c] = v[c];
  };

  // pass 1: the envelope of this band, as a stack of parabola positions.
  // t is its top, p the entry below and pp the one below that: their
  // positions (td, pd also as doubles), f (ft, fp, fpp) and h (ht, hp);
  // npt = ht - hp and dtp = td - pd.  Chunk i is staged in tile i % 2, so
  // a pop that reaches back less than one chunk finds f in shared memory;
  // f at pp is loaded when pp changes and used only at the next pop, so
  // even a load from global memory is mostly in flight meanwhile.
  int top = -1, t = 0, p = 0, pp = 0;
  float ft = 0.0f, fp = 0.0f, fpp = 0.0f;
  double td = 0.0, pd = 0.0, ht = 0.0, hp = 0.0, npt = 0.0, dtp = 0.0;
  float ahead[kChunk];
  if (lo < hi) load(ahead, lo, min(kChunk, hi - lo));
  for (int q0 = lo, i = 0; q0 < hi; q0 += kChunk, ++i) {
    const int cn = min(kChunk, hi - q0);
    const float* cur = tiles + (i & 1) * kTile + lane * kPitch;
    const float* prev = tiles + ((i + 1) & 1) * kTile + lane * kPitch;
    auto f_at = [&](int j) {
      return kMask              ? 0.0f
             : j >= q0          ? cur[j - q0]
             : j >= q0 - kChunk ? prev[j - q0 + kChunk]
                                : at(j);
    };
    store(tiles + (i & 1) * kTile, ahead);
    __syncwarp();
    if (q0 + kChunk < hi)
      load(ahead, q0 + kChunk, min(kChunk, hi - q0 - kChunk));
    if (valid) {
      double qd = static_cast<double>(q0) - 1.0;
      for (int c = 0; c < cn; ++c) {
        qd += 1.0;
        const float fq = cur[c];
        if (!(fq < kBig)) continue;
        const double hq = h_of(qd, fq);
        while (top >= 1 && (hq - ht) * dtp <= npt * (qd - td)) {
          --top;
          t = p;
          td = pd;
          ft = fp;
          ht = hp;
          if (top >= 1) {
            p = pp;
            fp = fpp;
            pd = static_cast<double>(p);
            hp = h_of(pd, fp);
            npt = ht - hp;
            dtp = td - pd;
            if (top >= 2) {
              pp = stk[(top - 2) * T + tid];
              fpp = f_at(pp);
            }
          }
        }
        stk[++top * T + tid] = static_cast<uint16_t>(q0 + c);
        pp = p;
        fpp = fp;
        p = t;
        pd = td;
        fp = ft;
        hp = ht;
        t = q0 + c;
        td = qd;
        ft = fq;
        ht = hq;
        npt = ht - hp;
        dtp = td - pd;
      }
    }
    __syncwarp();
  }

  // the bridge: the envelope of the whole scanline is the band-0 stack up
  // to entry i0 followed by the band-1 stack from entry j1 (as the lower
  // convex hull of two x-separated point sets is a prefix of the left hull
  // and a suffix of the right one).  The two walkers meet through shared
  // memory, in their own warps' tiles, which pass 1 no longer needs.
  int* meet = reinterpret_cast<int*>(tiles - band * 2 * kTile) + lane * 4;
  __syncthreads();
  meet[band] = top;
  __syncthreads();
  const int top0 = meet[0], top1 = meet[1];
  if (band == 0 && valid && top0 >= 0 && top1 >= 0) {
    int i0 = top0, j1 = 0;
    int a = stk[i0 * T + tid0], b = stk[tid1];
    double ad = a, bd = b, ha = h_of(ad, f_of(a)), hb = h_of(bd, f_of(b));
    for (bool moved = true; moved;) {
      moved = false;
      while (i0 >= 1) {
        const int c = stk[(i0 - 1) * T + tid0];
        const double cd = c, hc = h_of(cd, f_of(c));
        if (!covered(cd, hc, ad, ha, bd, hb)) break;
        --i0;
        a = c;
        ad = cd;
        ha = hc;
        moved = true;
      }
      while (j1 < top1) {
        const int c = stk[(j1 + 1) * T + tid1];
        const double cd = c, hc = h_of(cd, f_of(c));
        if (!covered(ad, ha, bd, hb, cd, hc)) break;
        ++j1;
        b = c;
        bd = cd;
        hb = hc;
        moved = true;
      }
    }
    meet[2] = i0;
    meet[3] = j1;
  } else if (band == 0) {
    meet[2] = top0;
    meet[3] = 0;
  }
  __syncthreads();
  const int i0 = meet[2], j1 = meet[3];
  __syncthreads();  // before pass 2 takes the tiles back
  // the merged envelope: entries 0..mtop, band 0's up to i0, then band 1's
  const int mtop = i0 + (top1 >= 0 ? top1 - j1 + 1 : 0);
  auto mpos = [&](int k) {
    return k <= i0 ? stk[k * T + tid0] : stk[(k - i0 - 1 + j1) * T + tid1];
  };

  // pass 2: walk the merged envelope over this band's outputs.  a = entry
  // k is the parabola in use at q, b = entry k + 1 the next (positions
  // also as doubles ad, bd and floats af, bf; f as fa, fb; h as ha, hb),
  // nab = hb - ha and dab = 2 S (b - a).  Band 1 finds its first entry by
  // a short walk from the bridge.  Outputs are staged in tile 0.  At the
  // start of each chunk, with the warp converged, f at the next 16 entries
  // is gathered into the thread's row of tile 1 (all loads in flight at
  // once), so an advance reads f from shared memory unless a chunk holds
  // more than 16 of them.
  float* mo = tiles + lane * kPitch;
  float* win = tiles + kTile + lane * kPitch;
  int wk = 0;  // win[j] holds f at entry wk + j
  auto gather = [&](int k0) {
    wk = k0;
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      v[j] = k0 + j <= mtop ? at(mpos(k0 + j)) : 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) win[j] = v[j];
  };
  auto fetch = [&](int kk, int v) {
    return kMask ? 0.0f : kk - wk < kChunk ? win[kk - wk] : at(v);
  };
  int k = 0;
  float fa = 0.0f, fb = 0.0f, af = 0.0f, bf = 0.0f;
  double ad = 0.0, bd = 0.0, ha = 0.0, hb = 0.0, nab = 0.0, dab = 0.0;
  if (valid && mtop >= 0 && lo < hi) {
    if (band == 1) {
      // entry k is in use at lo: the crossing of (k - 1, k) is <= lo and
      // that of (k, k + 1) is not
      const double lod = lo;
      k = min(i0 + 1, mtop);
      int v = mpos(k);
      double vd = v, hv = h_of(vd, f_of(v));
      while (k > 0) {
        const int u = mpos(k - 1);
        const double ud = u, hu = h_of(ud, f_of(u));
        if (hv - hu <= 2.0 * S * (vd - ud) * lod) break;
        --k;
        vd = ud;
        hv = hu;
      }
      while (k < mtop) {
        const int u = mpos(k + 1);
        const double ud = u, hu = h_of(ud, f_of(u));
        if (!(hu - hv <= 2.0 * S * (ud - vd) * lod)) break;
        ++k;
        vd = ud;
        hv = hu;
      }
    }
    if (!kMask) gather(k);
    const int a = mpos(k);
    fa = fetch(k, a);
    af = static_cast<float>(a);
    ad = static_cast<double>(a);
    ha = h_of(ad, fa);
    if (k < mtop) {
      const int b = mpos(k + 1);
      fb = fetch(k + 1, b);
      bf = static_cast<float>(b);
      bd = static_cast<double>(b);
      hb = h_of(bd, fb);
      nab = hb - ha;
      dab = 2.0 * S * (bd - ad);
    }
  }
  for (int q0 = lo; q0 < hi; q0 += kChunk) {
    const int cn = min(kChunk, hi - q0);
    if (valid) {
      if (!kMask && q0 > lo && k + 2 <= mtop) gather(k + 2);
      double qd = static_cast<double>(q0) - 1.0;
      float qf = static_cast<float>(q0) - 1.0f;
      for (int c = 0; c < cn; ++c) {
        qd += 1.0;
        qf += 1.0f;
        while (k < mtop && nab <= dab * qd) {
          ++k;
          fa = fb;
          af = bf;
          ad = bd;
          ha = hb;
          if (k < mtop) {
            const int b = mpos(k + 1);
            fb = fetch(k + 1, b);
            bf = static_cast<float>(b);
            bd = static_cast<double>(b);
            hb = h_of(bd, fb);
            nab = hb - ha;
            dab = 2.0 * S * (bd - ad);
          }
        }
        const float d = __fadd_rn(qf, -af);
        float v = __fadd_rn(fa, __fmul_rn(__fmul_rn(d, d), s2));
        if (mtop < 0) v = kBig;
        mo[c] = SQRT ? __fsqrt_rn(v) : v;
      }
    }
    __syncwarp();
    if (ROWS) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int r = 2 * i + (lane >> 4), e = lane & 15;
        const long long row = row0 + r;
        if (row < lines && e < cn)
          out[row * n + q0 + e] = tiles[r * kPitch + e];
      }
    } else if (valid) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < cn) out[base + (q0 + c) * stride] = mo[c];
    }
    __syncwarp();
  }
}

template <typename In, bool ROWS, bool SQRT>
int launch(const void* f, float* out, long long lines, int n,
           long long inner, float s2, cudaStream_t stream) {
  int threads = kMaxWarps * 32;
  while (threads > 64 && smem_bytes(n, threads) > kBlockSmem) threads /= 2;
  const size_t smem = smem_bytes(n, threads);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = minplus_envelope_kernel<In, ROWS, SQRT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = threads / 2;  // two walkers per scanline
  const long long blocks = (lines + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(
      static_cast<const In*>(f), out, lines, n, inner, s2);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_in(const void* f, float* out, long long lines, int n,
              long long inner, float s2, bool sqrt_out, cudaStream_t st) {
  if (inner == 1)
    return sqrt_out ? launch<In, true, true>(f, out, lines, n, 1, s2, st)
                    : launch<In, true, false>(f, out, lines, n, 1, s2, st);
  return sqrt_out ? launch<In, false, true>(f, out, lines, n, inner, s2, st)
                  : launch<In, false, false>(f, out, lines, n, inner, s2, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  ``f`` is a C-contiguous
// (outer, n, inner) float32 tensor, or a bool/uint8 mask when ``f_is_mask``
// (True reads as BIG, False as 0); ``out`` is float32 of the same shape,
// not aliasing ``f``; the squared distances are written, or their sqrt when
// ``sqrt_out``.  Launches on ``stream`` and returns the cudaError_t of the
// launch; allocates nothing.
extern "C" int ctt_minplus_envelope(const void* f, int f_is_mask, float* out,
                                    long long outer, int n, long long inner,
                                    float s2, int sqrt_out, void* stream) {
  if (outer <= 0 || n <= 0 || inner <= 0) return 0;
  const long long lines = outer * inner;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f_is_mask
             ? launch_in<uint8_t>(f, out, lines, n, inner, s2, sqrt_out, st)
             : launch_in<float>(f, out, lines, n, inner, s2, sqrt_out, st);
}
