// Fused velocity-stage S+U Negative-Binomial likelihood for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_velo_fwd_kernel` and
// `_velo_fwdgrad_kernel` of `velocycle_tpu/ops/nb_kernels.py`.  Computes
//
//   sum_{g,c} NB_logpmf(S[g,c] | ElogS, r[g]) + NB_logpmf(U[g,c] | ElogU, r[g])
//   ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]
//   x     = (nu @ zeta_dphi^T) * omega + exp(log_gamma)
//   ElogU = -log_beta + log(max(x, 0) + 1e-5) + ElogS
//
// and, in the fwd+grad variant, its gradients w.r.t. nu (Ng,Nh), zeta and
// zeta_dphi (Nc,Nh), cf and omega (Nc,), log_beta, log_gamma and r (Ng,) and
// delta_nu (Nb,Ng) in ONE pass over both count matrices.  No (Ng, Nc)
// intermediate ever reaches device memory.
//
// What bounds it on the H100: as for the phase pair (nb_phase.cu), the
// per-element special-function arithmetic of two NB terms, not the int16
// S+U stream (0.84 GB at 2048 x 102400, 0.25 ms at 3.35 TB/s).  The design
// is the phase pair's, with the velocity element's doubled cell state:
//   * one CTA per tile of kCellsPerBlock cells sweeps ALL genes; each thread
//     keeps its cell's zeta, zeta_dphi, cf and omega in registers and
//     accumulates the cell-indexed gradients (dzeta, dzeta_dphi, dcf,
//     domega) there, written once at the end with no atomics.  One cell per
//     thread keeps the doubled state (24 floats at Nh = 5) from spilling and
//     puts more warps on each SM;
//   * per gene chunk, nu, every dispersion-only column of the special
//     functions (vct::GeneCols), -log_beta and gamma = exp(log_gamma) are
//     staged once per gene in shared memory;
//   * the gene-indexed gradients (dnu, ddisp, dlog_beta, the pre-gamma
//     sum of g_x, ddelta_nu) are reduced over the warp by a reduce-scatter
//     (each shuffle step halves the values a lane holds: 9 shuffles for 8
//     values instead of 40), then over the CTA's warps in shared memory,
//     into per-cell-tile partials (n_tiles, Ng, Nh+3+Nb) that the host
//     wrapper sums over tiles in a fixed order; the loss goes through
//     per-CTA double partials the same way.  No float atomics: results are
//     bit-reproducible run to run.
// The relu gate: g_x = gU * (x > 0 ? 1/xr : 0) with a strict >, as the
// Pallas kernel; dlog_gamma = (sum_c g_x) * gamma is applied by the wrapper
// after the sum over tiles.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_velo.so nb_velo.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerBlock = kThreads;   // one cell per thread
constexpr int kWarps = kThreads / 32;
constexpr int kGeneChunk = 32;
constexpr int kMaxNb = 4;

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
  for (int o = 16 >> LOG_P; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
}

struct Args {
  const void* S;
  const void* U;
  const float* nu;
  const float* zeta;
  const float* zdphi;
  const float* cf;
  const float* omega;
  const float* lbeta;
  const float* lgamma;
  const float* disp;
  const float* dnu;   // (Nb, Ng) or null
  const float* Db;    // (Nb, Nc) or null
  int Ng, Nc, Nh, Nb;
  double* loss_part;  // (n_tiles,)
  float* gene_part;   // (n_tiles, Ng, Nh + 3 + Nb)
  float* dzeta;       // (Nc, Nh)
  float* dzdphi;      // (Nc, Nh)
  float* dcf;         // (Nc,)
  float* domega;      // (Nc,)
  cudaStream_t stream;
};

template <typename TK, int NH, bool GRAD, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
__global__ void __launch_bounds__(kThreads)
velo_kernel(const TK* __restrict__ S, const TK* __restrict__ U,
            const float* __restrict__ nu, const float* __restrict__ zeta,
            const float* __restrict__ zdphi, const float* __restrict__ cf,
            const float* __restrict__ omega, const float* __restrict__ lbeta,
            const float* __restrict__ lgamma, const float* __restrict__ disp,
            const float* __restrict__ dnu, const float* __restrict__ Db,
            int Ng, int Nc, int Nb, double* __restrict__ loss_part,
            float* __restrict__ gene_part, float* __restrict__ dzeta,
            float* __restrict__ dzdphi, float* __restrict__ dcf,
            float* __restrict__ domega) {
  constexpr int NB_SLOTS = HAS_DNU ? kMaxNb : 1;
  // gene partial columns: dnu (NH), ddisp, dlog_beta, sum_c g_x, ddnu (Nb)
  constexpr int NV_MAX = NH + 3 + (HAS_DNU ? kMaxNb : 0);
  constexpr int P = pow2_at_least(NV_MAX);
  constexpr int LANES_PER_VALUE = 32 / P;
  static_assert(P <= 32, "too many gene-indexed values for one warp");
  __shared__ float s_nu[kGeneChunk][NH];
  __shared__ vct::GeneCols s_cols[kGeneChunk];
  __shared__ float s_nlb[kGeneChunk];   // -log_beta
  __shared__ float s_gam[kGeneChunk];   // exp(log_gamma)
  __shared__ float s_dnu[kGeneChunk][NB_SLOTS];
  __shared__ float s_red[GRAD ? kGeneChunk : 1][GRAD ? P : 1][kWarps];
  __shared__ double s_loss[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int nb = HAS_DNU ? Nb : 0;
  const int NV = NH + 3 + nb;

  // this thread's cell: registers for the whole gene sweep
  const int cell = tile * kCellsPerBlock + tid;
  const bool valid = cell < Nc;
  float z[NH], zd[NH], dz[NH], dzd[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    z[h] = valid ? zeta[static_cast<size_t>(cell) * NH + h] : 0.0f;
    zd[h] = valid ? zdphi[static_cast<size_t>(cell) * NH + h] : 0.0f;
    dz[h] = 0.0f;
    dzd[h] = 0.0f;
  }
  const float cfv = valid ? cf[cell] : 0.0f;
  const float om = valid ? omega[cell] : 0.0f;
  float db[NB_SLOTS];
#pragma unroll
  for (int b = 0; b < NB_SLOTS; ++b)
    db[b] = (HAS_DNU && b < nb && valid) ? Db[static_cast<size_t>(b) * Nc + cell] : 0.0f;
  float dc = 0.0f, dom = 0.0f;

  double loss = 0.0;
  for (int g0 = 0; g0 < Ng; g0 += kGeneChunk) {
    const int gn = min(kGeneChunk, Ng - g0);
    for (int i = tid; i < gn * NH; i += kThreads)
      s_nu[i / NH][i % NH] = nu[static_cast<size_t>(g0) * NH + i];
    if (tid < gn) {
      s_cols[tid] = vct::gene_cols(disp[g0 + tid]);
      s_nlb[tid] = -lbeta[g0 + tid];
      s_gam[tid] = expf(lgamma[g0 + tid]);
    }
    if (HAS_DNU) {
      for (int i = tid; i < gn * nb; i += kThreads)
        s_dnu[i % gn][i / gn] = dnu[static_cast<size_t>(i / gn) * Ng + g0 + i % gn];
    }
    __syncthreads();

    float chunk_loss = 0.0f;
    for (int gl = 0; gl < gn; ++gl) {
      const size_t idx = static_cast<size_t>(g0 + gl) * Nc + cell;
      const vct::GeneCols c = s_cols[gl];
      float nuv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) nuv[h] = s_nu[gl][h];

      const float kS = valid ? static_cast<float>(S[idx]) : 0.0f;
      const float kU = valid ? static_cast<float>(U[idx]) : 0.0f;
      // dE and x in the plain version's order, rounded product by rounded
      // sum (no FMA contraction): near x = 0 the gradient 1/xr magnifies any
      // difference in x up to 1e5 times, so both sides form x bit-identically
      float dot = 0.0f, dE = 0.0f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        dot += nuv[h] * z[h];
        dE = __fadd_rn(dE, __fmul_rn(nuv[h], zd[h]));
      }
      float elogS = dot + cfv;
      if (HAS_DNU) {
        float off = 0.0f;
#pragma unroll
        for (int b = 0; b < NB_SLOTS; ++b)
          if (b < nb) off += s_dnu[gl][b] * db[b];
        elogS += off;
      }
      const float x = __fadd_rn(__fmul_rn(dE, om), s_gam[gl]);
      const float xr = fmaxf(x, 0.0f) + 1e-5f;
      const float elogU = (s_nlb[gl] + logf(xr)) + elogS;
      const float log_bS = -c.log_r - elogS;
      const float log_bU = -c.log_r - elogU;

      if constexpr (!GRAD) {
        const float lp = vct::nb_lp<SKIP_K>(kS, log_bS, c) + vct::nb_lp<SKIP_K>(kU, log_bU, c);
        chunk_loss += valid ? lp : 0.0f;
      } else {
        float lpS, gS, grS, lpU, gU, grU;
        vct::nb_lp_grads<WANT_DISP, SKIP_K>(kS, log_bS, c, lpS, gS, grS);
        vct::nb_lp_grads<WANT_DISP, SKIP_K>(kU, log_bU, c, lpU, gU, grU);
        float lp = lpS + lpU;
        float g_r = grS + grU;
        if (!valid) {
          lp = 0.0f;
          gS = 0.0f;
          gU = 0.0f;
          g_r = 0.0f;
        }
        const float g_e = gS + gU;                          // ElogU includes ElogS
        const float g_x = gU * (x > 0.0f ? 1.0f / xr : 0.0f);  // relu + log chain
        const float g_xo = g_x * om;
        chunk_loss += lp;
        dc += g_e;
        dom += g_x * dE;

        float v[P];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          dz[h] += g_e * nuv[h];
          dzd[h] += g_xo * nuv[h];
          v[h] = g_e * z[h] + g_xo * zd[h];
        }
        v[NH] = g_r;
        v[NH + 1] = -gU;
        v[NH + 2] = g_x;
#pragma unroll
        for (int b = 0; b < P - NH - 3; ++b)
          v[NH + 3 + b] = (b < NB_SLOTS && HAS_DNU && b < nb) ? g_e * db[b] : 0.0f;
        warp_reduce_scatter<P>(v, lane);
        if (lane % LANES_PER_VALUE == 0) s_red[gl][lane / LANES_PER_VALUE][warp] = v[0];
      }
    }
    loss += static_cast<double>(chunk_loss);

    if constexpr (GRAD) {
      __syncthreads();
      for (int i = tid; i < gn * NV; i += kThreads) {
        const int gl = i / NV;
        const int vi = i % NV;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_red[gl][vi][w];
        gene_part[(static_cast<size_t>(tile) * Ng + g0 + gl) * NV + vi] = s;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged columns
  }

  if constexpr (GRAD) {
    if (valid) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        dzeta[static_cast<size_t>(cell) * NH + h] = dz[h];
        dzdphi[static_cast<size_t>(cell) * NH + h] = dzd[h];
      }
      dcf[cell] = dc;
      domega[cell] = dom;
    }
  }

  loss = vct::warp_sum(loss);
  if (lane == 0) s_loss[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_loss[w];
    loss_part[tile] = s;
  }
}

template <typename TK, int NH, bool GRAD, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
void launch(const Args& a) {
  const int tiles = (a.Nc + kCellsPerBlock - 1) / kCellsPerBlock;
  velo_kernel<TK, NH, GRAD, WANT_DISP, HAS_DNU, SKIP_K>
      <<<tiles, kThreads, 0, a.stream>>>(
          static_cast<const TK*>(a.S), static_cast<const TK*>(a.U), a.nu, a.zeta,
          a.zdphi, a.cf, a.omega, a.lbeta, a.lgamma, a.disp, a.dnu, a.Db, a.Ng,
          a.Nc, a.Nb, a.loss_part, a.gene_part, a.dzeta, a.dzdphi, a.dcf,
          a.domega);
}

template <typename TK, int NH, bool GRAD, bool WANT_DISP, bool HAS_DNU>
void pick_skip(const Args& a, bool skip_k) {
  if (skip_k) launch<TK, NH, GRAD, WANT_DISP, HAS_DNU, true>(a);
  else launch<TK, NH, GRAD, WANT_DISP, HAS_DNU, false>(a);
}

template <typename TK, int NH, bool GRAD, bool WANT_DISP>
void pick_dnu(const Args& a, bool skip_k) {
  if (a.Nb > 0) pick_skip<TK, NH, GRAD, WANT_DISP, true>(a, skip_k);
  else pick_skip<TK, NH, GRAD, WANT_DISP, false>(a, skip_k);
}

template <typename TK, int NH, bool GRAD>
void pick_disp(const Args& a, bool want_disp, bool skip_k) {
  if constexpr (GRAD) {
    if (want_disp) {
      pick_dnu<TK, NH, true, true>(a, skip_k);
      return;
    }
  }
  pick_dnu<TK, NH, GRAD, false>(a, skip_k);
}

template <typename TK, bool GRAD>
int pick_nh(const Args& a, bool want_disp, bool skip_k) {
  switch (a.Nh) {
    case 3: pick_disp<TK, 3, GRAD>(a, want_disp, skip_k); break;
    case 5: pick_disp<TK, 5, GRAD>(a, want_disp, skip_k); break;
    case 7: pick_disp<TK, 7, GRAD>(a, want_disp, skip_k); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool GRAD>
int run(const Args& a, int counts_int16, bool want_disp, bool skip_k) {
  if (a.Ng < 1 || a.Nc < 1 || a.Nb < 0 || a.Nb > kMaxNb)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  const int rc = counts_int16 ? pick_nh<int16_t, GRAD>(a, want_disp, skip_k)
                              : pick_nh<float, GRAD>(a, want_disp, skip_k);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vct_velo_cells_per_block() { return kCellsPerBlock; }

int vct_velo_max_nb() { return kMaxNb; }

// Loss only: loss_part (n_tiles,) doubles, summed by the caller.
int vct_velo_fwd(const void* S, const void* U, int counts_int16, const float* nu,
                 const float* zeta, const float* zdphi, const float* cf,
                 const float* omega, const float* lbeta, const float* lgamma,
                 const float* disp, const float* dnu, const float* Db, int Ng, int Nc,
                 int Nh, int Nb, int skip_k, double* loss_part, void* stream) {
  Args a{S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
         Ng, Nc, Nh, Nb, loss_part, nullptr, nullptr, nullptr, nullptr, nullptr,
         static_cast<cudaStream_t>(stream)};
  return run<false>(a, counts_int16, false, skip_k != 0);
}

// Loss and all gradients: loss_part (n_tiles,), gene_part (n_tiles, Ng,
// Nh+3+Nb) = [dnu, ddisp, dlog_beta, sum_c g_x, ddnu], dzeta and dzdphi
// (Nc, Nh), dcf and domega (Nc,).
int vct_velo_fwdgrad(const void* S, const void* U, int counts_int16, const float* nu,
                     const float* zeta, const float* zdphi, const float* cf,
                     const float* omega, const float* lbeta, const float* lgamma,
                     const float* disp, const float* dnu, const float* Db, int Ng,
                     int Nc, int Nh, int Nb, int skip_k, int want_disp,
                     double* loss_part, float* gene_part, float* dzeta, float* dzdphi,
                     float* dcf, float* domega, void* stream) {
  Args a{S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
         Ng, Nc, Nh, Nb, loss_part, gene_part, dzeta, dzdphi, dcf, domega,
         static_cast<cudaStream_t>(stream)};
  return run<true>(a, counts_int16, want_disp != 0, skip_k != 0);
}

}  // extern "C"
