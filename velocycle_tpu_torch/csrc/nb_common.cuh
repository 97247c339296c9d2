// Device functions shared by the fused Negative-Binomial kernels
// (nb_phase.cu, nb_velo.cu).
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

// Per-gene columns of the NB log-pmf and of `lgamma_digamma_ratio`: they
// depend on the dispersion r only, so a kernel computes them once per gene
// and stages them in shared memory instead of once per element.
struct GeneCols {
  float a;        // 1 / r
  float log_r;    // log r
  float l0, l1;   // log(a), log(a + 1)
  float i0, i1;   // 1 / a, 1 / (a + 1)
  float full_l;   // l0 + l1
  float full_d;   // i0 + i1
  float y;        // a + 2
  float ym;       // y - 0.5
  float inv_y;    // 1 / y
  float log_y;    // log y
  float rc_y;     // lgamma Stirling correction at y
  float tail_y;   // digamma asymptotic tail at y
};

__device__ __forceinline__ GeneCols gene_cols(float r) {
  GeneCols c;
  c.a = 1.0f / r;
  c.log_r = logf(r);
  c.l0 = logf(c.a);
  c.l1 = logf(c.a + 1.0f);
  c.i0 = 1.0f / c.a;
  c.i1 = 1.0f / (c.a + 1.0f);
  c.full_l = c.l0 + c.l1;
  c.full_d = c.i0 + c.i1;
  const float y = c.a + 2.0f;
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

// lgamma(k + a) - lgamma(a) and, when WANT_D, digamma(k + a) - digamma(a),
// for an integer-valued count k >= 0.
template <bool WANT_D>
__device__ __forceinline__ void lgamma_digamma_ratio(float k, const GeneCols& c,
                                                     float& lgr, float& dgr) {
  const float x = fmaxf(k - 2.0f, 0.0f);
  const float ka = c.y + x;
  const float l1p = log1pf(x * c.inv_y);
  const float inv = 1.0f / ka;
  const float inv2 = inv * inv;
  const float rc_ka = inv * ((1.0f / 12.0f) - inv2 * ((1.0f / 360.0f) -
                      inv2 * ((1.0f / 1260.0f) - inv2 * (1.0f / 1680.0f))));
  const float stir_l = (c.ym + x) * l1p + x * c.log_y - x + rc_ka - c.rc_y;
  const bool lt = k < 2.0f;
  const float small_l = (k > 0.0f ? c.l0 : 0.0f) + (k > 1.0f ? c.l1 : 0.0f);
  lgr = lt ? small_l : c.full_l + stir_l;
  if (WANT_D) {
    const float tail_ka = -0.5f * inv - inv2 * ((1.0f / 12.0f) -
                          inv2 * ((1.0f / 120.0f) - inv2 / 252.0f));
    const float stir_d = l1p + tail_ka - c.tail_y;
    const float small_d = (k > 0.0f ? c.i0 : 0.0f) + (k > 1.0f ? c.i1 : 0.0f);
    dgr = lt ? small_d : c.full_d + stir_d;
  }
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

// NB log-pmf as the loss-only kernels evaluate it, at log_b = -log r - elog
// (threshold-2 ratio lgamma, softplus through logf(1 + e)).
template <bool SKIP_K>
__device__ __forceinline__ float nb_lp(float k, float log_b, const GeneCols& c) {
  float lgr, unused;
  lgamma_digamma_ratio<false>(k, c, lgr, unused);
  const float sp = fmaxf(log_b, 0.0f) + logf(1.0f + expf(-fabsf(log_b)));
  float lp = lgr + c.a * log_b - (c.a + k) * sp;
  if (!SKIP_K) lp -= lgamma_pos(k + 1.0f);
  return lp;
}

// (log-pmf, d lp/d elog, d lp/d r) as the fwd+grad kernels evaluate them:
// softplus and sigmoid share one exp; g_r is 0 unless WANT_DISP, which
// compiles the digamma chain in.
template <bool WANT_DISP, bool SKIP_K>
__device__ __forceinline__ void nb_lp_grads(float k, float log_b, const GeneCols& c,
                                            float& lp, float& g_elog, float& g_r) {
  const float e = expf(-fabsf(log_b));
  const float d = 1.0f / (1.0f + e);
  const float sp = fmaxf(log_b, 0.0f) + log1pf(e);
  const float sig = log_b >= 0.0f ? d : e * d;
  float lgr, dgr = 0.0f;
  lgamma_digamma_ratio<WANT_DISP>(k, c, lgr, dgr);
  const float a_k = c.a + k;
  lp = lgr + c.a * log_b - a_k * sp;
  if (!SKIP_K) lp -= lgamma_pos(k + 1.0f);
  const float g_sig = a_k * sig;
  g_elog = g_sig - c.a;
  g_r = 0.0f;
  if (WANT_DISP) {
    const float dlp_da = dgr + log_b - sp;
    g_r = (dlp_da * (-c.a) + (g_sig - c.a)) * c.a;
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

}  // namespace vct
