// Device functions shared by the fused Negative-Binomial kernels
// (phase_kernel.cuh, velo_kernel.cuh): the NB element, the warp
// reduce-scatter, the even split of a persistent grid and the cp.async
// copies of the count rings.
//
// CUDA counterparts of `velocycle_tpu_torch/ops/special.py` (the threshold-2
// integer-count forms of `velocycle_tpu/ops/special.py`) and of the NB
// element functions `_nb_lp` / `_nb_lp_and_grads` of `ops/nb_kernels.py`,
// written in the same operation order so the kernels and their plain torch
// versions hold one arithmetic.  Compiled without --use_fast_math: expf/logf/log1pf and the
// divisions are the IEEE-accurate library versions.
#pragma once

#include <cuda_runtime.h>

namespace vct {

// The basis widths Nh the kernels are instantiated for: 3, 5 and 7 with and
// without delta_nu batches, 11 and 16 without (nb_phase.cu and nb_velo.cu,
// `pick_nh`; ops/nb_kernels.py KERNEL_WIDTHS).
constexpr int kMaxDnuWidth = 7;

// The chain batch of one launch: K parameter sets over the same counts (the
// chains of an MCMC batch, the particles of an SMC stage).  Each parameter
// operand's stride between chains in floats, 0 where the chains share it;
// the counts and Db are shared by every chain.  K = 1 is the unbatched
// launch.  The phase body reads nu, zeta, cf, disp and dnu; the velocity
// body all of them.
struct ChainStrides {
  int K;
  int loss_pieces;        // loss_part entries per chain (the plan's)
  long long nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu;
};

// Per-gene columns of the NB log-pmf and of the lgamma / digamma ratios:
// they depend on the dispersion r only, so a kernel computes them once per
// gene and stages them in shared memory instead of once per element.
struct GeneCols {
  float a;        // 1 / r
  float log_r;    // log r
  float l0, l1;   // log(a), log(a + 1)
  float i0, i1;   // 1 / a, 1 / (a + 1)
  float full_l;   // l0 + l1
  // y - a - 2 (y_shift), the rounding of y, where the sum i0 + i1 was kept:
  // the element adds i0 + i1 itself (the same bits), and the struct's size,
  // which sets the wide body's shared memory, stays
  float delta;
  float y;        // a + 2 rounded: a + 2 + delta
  float ym;       // y - 0.5
  float inv_y;    // 1 / y
  float log_y;    // log y
  float rc_y;     // lgamma Stirling correction at y
  float tail_y;   // digamma asymptotic tail at y
};

// y - a - 2, exactly: the rounding of y = fl(a + 2).  Fast2Sum with the
// larger operand first, (y - a) - 2 for a >= 2 and (y - 2) - a below, is
// exact under round-to-nearest.  It is not 0 wherever y has a larger
// exponent than a: every a < 2 and a in [2^n - 2, 2^n) for n >= 2.
__device__ __forceinline__ float y_shift(float a, float y) {
  return (y - fmaxf(a, 2.0f)) - fminf(a, 2.0f);
}

__device__ __forceinline__ GeneCols gene_cols(float r) {
  GeneCols c;
  c.a = 1.0f / r;
  c.log_r = logf(r);
  c.l0 = logf(c.a);
  c.l1 = logf(c.a + 1.0f);
  c.i0 = 1.0f / c.a;
  c.i1 = 1.0f / (c.a + 1.0f);
  c.full_l = c.l0 + c.l1;
  const float y = c.a + 2.0f;
  c.delta = y_shift(c.a, y);
  c.y = y;
  c.ym = y - 0.5f;
  c.inv_y = 1.0f / y;
  const float inv2_y = c.inv_y * c.inv_y;
  c.log_y = logf(y);
  c.rc_y = c.inv_y * ((1.0f / 12.0f) - inv2_y * ((1.0f / 360.0f) -
           inv2_y * ((1.0f / 1260.0f) - inv2_y * (1.0f / 1680.0f))));
  c.tail_y = -0.5f * c.inv_y - inv2_y * ((1.0f / 12.0f) -
             inv2_y * ((1.0f / 120.0f) - inv2_y / 252.0f));
  return c;
}

// From this a = 1/r on, a gene's dispersion gradient takes the form with no
// cancelling terms (nb_lp_grads); below it the form d lp/d a = dgr + log
// sigmoid, whose float32 error grows as a / mu but is no larger below here
// (ops/special.py EXCESS_FROM).
constexpr float kExcessFrom = 64.0f;

// Below this argument log1p_excess and log1m_excess take their series
// (through the 9th power: truncated at ~1.4e-8 relative); above it the
// direct differences lose at most ~30 float32 ulps (ops/special.py
// SERIES_BELOW).
constexpr float kSeriesBelow = 0.125f;

// t - log1p(t) for t >= 0, given l1p = log1p(t): its series t^2/2 - t^3/3
// + ... - t^9/9 below kSeriesBelow, where the difference cancels.
__device__ __forceinline__ float log1p_excess(float t, float l1p) {
  const float ser = t * t * (0.5f - t * ((1.0f / 3.0f) - t * (0.25f - t * (0.2f - t * (
                    (1.0f / 6.0f) - t * ((1.0f / 7.0f) - t * (0.125f - t / 9.0f)))))));
  return t < kSeriesBelow ? ser : t - l1p;
}

// -log1p(-s) - s = s^2/2 + s^3/3 + ... + s^9/9, for 0 <= s < kSeriesBelow.
__device__ __forceinline__ float log1m_excess(float s) {
  return s * s * (0.5f + s * ((1.0f / 3.0f) + s * (0.25f + s * (0.2f + s * (
         (1.0f / 6.0f) + s * ((1.0f / 7.0f) + s * (0.125f + s / 9.0f)))))));
}

// The Stirling branch's arguments for a count k >= 0 (used where k >= 2):
// x = k - 2 (clamped at 0), t = x / y, log1p(t) and 1 / (y + x) and its
// square, with y = a + 2 rounded (GeneCols).
struct Stirling {
  float x, t, l1p, inv, inv2;
  bool lt;  // k < 2: the ratios are exact sums of at most two terms
};

__device__ __forceinline__ Stirling stirling(float k, const GeneCols& c) {
  Stirling s;
  s.x = fmaxf(k - 2.0f, 0.0f);
  s.t = s.x * c.inv_y;
  s.l1p = log1pf(s.t);
  s.inv = 1.0f / (c.y + s.x);
  s.inv2 = s.inv * s.inv;
  s.lt = k < 2.0f;
  return s;
}

// lgamma(k + a) - lgamma(a) for an integer-valued count k >= 0.
__device__ __forceinline__ float lgamma_ratio(float k, const Stirling& s, const GeneCols& c) {
  const float rc_ka = s.inv * ((1.0f / 12.0f) - s.inv2 * ((1.0f / 360.0f) -
                      s.inv2 * ((1.0f / 1260.0f) - s.inv2 * (1.0f / 1680.0f))));
  const float stir_l = (c.ym + s.x) * s.l1p + s.x * c.log_y - s.x + rc_ka - c.rc_y;
  const float small_l = (k > 0.0f ? c.l0 : 0.0f) + (k > 1.0f ? c.l1 : 0.0f);
  return s.lt ? small_l : c.full_l + stir_l;
}

// digamma(k + a) - digamma(a).  The Stirling difference digamma(y + x) -
// digamma(y) is taken at the rounded y; its derivative in y is about 1/(y +
// x) - 1/y = d1, so at the true a + 2 = y - delta it is less delta d1.
__device__ __forceinline__ float digamma_ratio(float k, const Stirling& s, const GeneCols& c) {
  const float tail_ka = -0.5f * s.inv - s.inv2 * ((1.0f / 12.0f) -
                        s.inv2 * ((1.0f / 120.0f) - s.inv2 / 252.0f));
  const float d1 = -s.x * s.inv * c.inv_y;  // 1/ka - 1/y
  const float stir_d = s.l1p + tail_ka - c.tail_y - c.delta * d1;
  const float small_d = (k > 0.0f ? c.i0 : 0.0f) + (k > 1.0f ? c.i1 : 0.0f);
  return s.lt ? small_d : (c.i0 + c.i1) + stir_d;
}

// k - a (digamma(k + a) - digamma(a)) = sum_{j<k} j / (a + j): 0 for k < 2;
// for k >= 2 the Stirling branch's 1/(a+1) + (x - a log1p(t)) - a
// (tail(ka) - tail(y)) with ka = y + x, taken as y (t - log1p t) + (y - a)
// log1p t (y - a is exact, 2 + delta) and through 1/ka - 1/y = -x / (ka
// y): no difference of two O(k) or two O(1/a) numbers, which cancel when a
// = 1/r is large.  The Stirling difference is taken at the rounded y, as in
// digamma_ratio: + a delta d1 moves it to a + 2.
__device__ __forceinline__ float digamma_excess(const Stirling& s, const GeneCols& c) {
  const float d1 = -s.x * s.inv * c.inv_y;  // 1/ka - 1/y
  const float iy2 = c.inv_y * c.inv_y;
  const float d2 = d1 * (s.inv + c.inv_y);  // 1/ka^2 - 1/y^2
  const float td = -0.5f * d1 - d2 * ((1.0f / 12.0f) - (s.inv2 + iy2) * (1.0f / 120.0f) +
                   (s.inv2 * s.inv2 + s.inv2 * iy2 + iy2 * iy2) * (1.0f / 252.0f));
  const float stir_k = c.i1 + c.y * log1p_excess(s.t, s.l1p) + (c.y - c.a) * s.l1p - c.a * td;
  return s.lt ? 0.0f : stir_k + c.a * c.delta * d1;
}

// log Gamma(x) for x > 0: Lanczos, g = 7, n = 9.
__device__ __forceinline__ float lgamma_pos(float x) {
  const float z = x - 1.0f;
  float series = 0.99999999999980993f;
  series += 676.5203681218851f / (z + 1.0f);
  series += -1259.1392167224028f / (z + 2.0f);
  series += 771.32342877765313f / (z + 3.0f);
  series += -176.61502916214059f / (z + 4.0f);
  series += 12.507343278686905f / (z + 5.0f);
  series += -0.13857109526572012f / (z + 6.0f);
  series += 9.9843695780195716e-6f / (z + 7.0f);
  series += 1.5056327351493116e-7f / (z + 8.0f);
  const float t = z + 7.0f + 0.5f;
  return 0.9189385332046727f + (z + 0.5f) * logf(t) - t + logf(series);
}

// softplus(log_b) and log sigmoid(log_b) = log_b - softplus(log_b), sharing
// one exp and one log1p.  The log sigmoid is min(log_b, 0) - log1p(e), not
// the difference, which cancels where log_b is large: at small dispersion
// (a = 1/r large) the NB element weights it by a.
__device__ __forceinline__ void softplus_log_sigmoid(float log_b, float e, float& sp,
                                                     float& log_sig) {
  const float l1 = log1pf(e);
  sp = fmaxf(log_b, 0.0f) + l1;
  log_sig = fminf(log_b, 0.0f) - l1;
}

// NB log-pmf as the loss-only kernels evaluate it, at log_b = -log r - elog:
// lgr + a * log sigmoid(log_b) - k * softplus(log_b) (threshold-2 ratio
// lgamma), free of the cancellation of a * log_b - (a + k) * softplus(log_b).
template <bool SKIP_K>
__device__ __forceinline__ float nb_lp(float k, float log_b, const GeneCols& c) {
  const float lgr = lgamma_ratio(k, stirling(k, c), c);
  float sp, log_sig;
  softplus_log_sigmoid(log_b, expf(-fabsf(log_b)), sp, log_sig);
  float lp = lgr + c.a * log_sig - k * sp;
  if (!SKIP_K) lp -= lgamma_pos(k + 1.0f);
  return lp;
}

// (log-pmf, d lp/d elog, d lp/d r) as the fwd+grad kernels evaluate them:
// softplus, log sigmoid, sigmoid and 1 - sigmoid share one exp; d lp/d elog
// is k * sig - a * (1 - sig), not (a + k) * sig - a.  d lp/d r is, for a
// gene with a < kExcessFrom, -a^2 d lp/d a + a g_elog with d lp/d a = dgr +
// log sig at fixed log_b; from kExcessFrom on
//   d lp/d r = a ((k - a dgr) - k sig_c - a (log sig + sig_c)),
// each term O(mu^2 / a): k - a dgr from digamma_excess, and -(log sig +
// sig_c) where log_b >= 0 and sig_c < kSeriesBelow as log1m_excess(sig_c)
// (there the difference of two O(mu / a) numbers).  No term cancels at small
// dispersion.  The kernels' threads all work on one gene at a time, so the
// choice between the two is uniform across a warp.  g_r is 0 unless
// WANT_DISP, which compiles the digamma chain in.
template <bool WANT_DISP, bool SKIP_K>
__device__ __forceinline__ void nb_lp_grads(float k, float log_b, const GeneCols& c,
                                            float& lp, float& g_elog, float& g_r) {
  const float e = expf(-fabsf(log_b));
  const float d = 1.0f / (1.0f + e);
  float sp, log_sig;
  softplus_log_sigmoid(log_b, e, sp, log_sig);
  const float ed = e * d;
  const bool pos = log_b >= 0.0f;
  const float sig = pos ? d : ed;
  const float sig_c = pos ? ed : d;
  const Stirling s = stirling(k, c);
  lp = lgamma_ratio(k, s, c) + c.a * log_sig - k * sp;
  if (!SKIP_K) lp -= lgamma_pos(k + 1.0f);
  g_elog = k * sig - c.a * sig_c;
  g_r = 0.0f;
  if (WANT_DISP) {
    if (c.a < kExcessFrom) {
      const float dlp_da = digamma_ratio(k, s, c) + log_sig;
      g_r = (dlp_da * (-c.a) + g_elog) * c.a;
    } else {
      const float q = (pos && sig_c < kSeriesBelow) ? log1m_excess(sig_c) : -(log_sig + sig_c);
      g_r = ((digamma_excess(s, c) - k * sig_c) + c.a * q) * c.a;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ constexpr int log2_exact(int p) {
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

// Warp reduce-scatter of P values (P a power of two, <= 32): afterwards the
// lanes l with l % (32 / P) == 0 hold in v[0] the warp total of value
// l / (32 / P).  Each of the first log2(P) steps trades half of the values a
// lane holds with its partner; the rest is a plain butterfly on one value.
template <int P>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[P], int lane) {
  static_assert(P <= 32, "a warp reduce-scatters at most 32 values");
  constexpr int LOG_P = log2_exact(P);
#pragma unroll
  for (int step = 0; step < LOG_P; ++step) {
    const int half = P >> (step + 1);
    const int off = 16 >> step;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < P / 2; ++j) {
      if (j < half) {
        const float send = upper ? v[j] : v[j + half];
        const float keep = upper ? v[j + half] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
#pragma unroll
  for (int o = 16 >> LOG_P; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
}

// The even split of a persistent grid: U units, tile-major (unit u = tile
// u / n_chunks, gene chunk u % n_chunks); CTA p of P owns [p U / P, (p + 1)
// U / P).  The CTA that owns unit u:
__host__ __device__ inline int unit_owner(long long u, long long U, int P) {
  return static_cast<int>(((u + 1) * P - 1) / U);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled; src and dst 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace vct
