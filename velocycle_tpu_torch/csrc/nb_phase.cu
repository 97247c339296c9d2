// Fused phase-stage Negative-Binomial likelihood for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_phase_fwd_kernel` and
// `_phase_fwdgrad_kernel` of `velocycle_tpu/ops/nb_kernels.py`.  Computes
//
//   sum_{g,c} NB_logpmf(S[g,c] | ElogS[g,c], r[g]),
//   ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]
//
// and, in the fwd+grad variant, its gradients w.r.t. nu (Ng,Nh), zeta (Nc,Nh),
// cf (Nc,), r (Ng,) and delta_nu (Nb,Ng) in ONE pass over the count matrix.
// No (Ng, Nc) intermediate ever reaches device memory.
//
// What bounds it on the H100: the per-element special-function arithmetic
// (the threshold-2 lgamma/digamma ratio, softplus/sigmoid: ~4 transcendentals
// and ~5 divisions per element in IEEE precision), not the int16 count stream
// (0.42 GB at 2048 x 102400, 0.125 ms at 3.35 TB/s).  So the design spends
// nothing on the stream and everything on keeping the element loop lean:
//   * one CTA per tile of kCellsPerBlock cells sweeps ALL genes, so the
//     cell-indexed gradients (dzeta, dcf) live in registers for the whole
//     kernel and are written once, with no atomics;
//   * per gene chunk, nu and every dispersion-only column of the special
//     functions (1/r, log r, log(a+j), 1/(a+j), Stirling terms at a+2) are
//     computed once per gene into shared memory, not once per element;
//   * the gene-indexed gradients (dnu, ddisp, ddnu) are reduced over the
//     CTA's cells (warp shuffles, then one shared-memory pass per gene chunk)
//     into a per-cell-tile partial buffer (n_tiles, Ng, Nh+1+Nb) that the
//     host wrapper sums over tiles in a fixed order; the loss goes through
//     per-CTA double partials the same way.  No float atomics: results are
//     bit-reproducible run to run.
// Known limits of this first version: one shuffle tree per gene and value,
// 2-byte count loads, Nh unrolled FMAs with no tensor cores.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_phase.so nb_phase.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"
#include "phase_layout.cuh"

namespace {

using namespace vct::phase_layout;
constexpr int kMaxNb = 4;

struct Args {
  const void* S;
  const float* nu;
  const float* zeta;
  const float* cf;
  const float* disp;
  const float* dnu;   // (Nb, Ng) or null
  const float* Db;    // (Nb, Nc) or null
  int Ng, Nc, Nh, Nb;
  double* loss_part;  // (n_tiles,)
  float* gene_part;   // (n_tiles, Ng, Nh + 1 + Nb)
  float* dzeta;       // (Nc, Nh)
  float* dcf;         // (Nc,)
  cudaStream_t stream;
};

template <typename TK, int NH, bool GRAD, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
__global__ void __launch_bounds__(kThreads)
phase_kernel(const TK* __restrict__ S, const float* __restrict__ nu,
             const float* __restrict__ zeta, const float* __restrict__ cf,
             const float* __restrict__ disp, const float* __restrict__ dnu,
             const float* __restrict__ Db, int Ng, int Nc, int Nb,
             double* __restrict__ loss_part, float* __restrict__ gene_part,
             float* __restrict__ dzeta, float* __restrict__ dcf) {
  constexpr int NB_SLOTS = HAS_DNU ? kMaxNb : 1;
  constexpr int NV_MAX = NH + 1 + (HAS_DNU ? kMaxNb : 0);
  __shared__ float s_nu[kGeneChunk][NH];
  __shared__ vct::GeneCols s_cols[kGeneChunk];
  __shared__ float s_dnu[kGeneChunk][NB_SLOTS];
  __shared__ float s_red[GRAD ? kGeneChunk : 1][GRAD ? NV_MAX : 1][kWarps];
  __shared__ double s_loss[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int nb = HAS_DNU ? Nb : 0;
  const int NV = NH + 1 + nb;

  // this thread's cells: registers for the whole gene sweep
  int cell[kCellsPerThread];
  bool valid[kCellsPerThread];
  float z[kCellsPerThread][NH];
  float cfv[kCellsPerThread];
  float db[kCellsPerThread][NB_SLOTS];
  float dz[kCellsPerThread][NH];
  float dc[kCellsPerThread];
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    cell[i] = tile * kCellsPerBlock + i * kThreads + tid;
    valid[i] = cell[i] < Nc;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      z[i][h] = valid[i] ? zeta[static_cast<size_t>(cell[i]) * NH + h] : 0.0f;
      dz[i][h] = 0.0f;
    }
    cfv[i] = valid[i] ? cf[cell[i]] : 0.0f;
    dc[i] = 0.0f;
#pragma unroll
    for (int b = 0; b < NB_SLOTS; ++b)
      db[i][b] = (HAS_DNU && b < nb && valid[i])
                     ? Db[static_cast<size_t>(b) * Nc + cell[i]] : 0.0f;
  }

  double loss = 0.0;
  for (int g0 = 0; g0 < Ng; g0 += kGeneChunk) {
    const int gn = min(kGeneChunk, Ng - g0);
    for (int i = tid; i < gn * NH; i += kThreads)
      s_nu[i / NH][i % NH] = nu[static_cast<size_t>(g0) * NH + i];
    if (tid < gn) s_cols[tid] = vct::gene_cols(disp[g0 + tid]);
    if (HAS_DNU) {
      for (int i = tid; i < gn * nb; i += kThreads)
        s_dnu[i % gn][i / gn] = dnu[static_cast<size_t>(i / gn) * Ng + g0 + i % gn];
    }
    __syncthreads();

    float chunk_loss = 0.0f;
    for (int gl = 0; gl < gn; ++gl) {
      const size_t row = static_cast<size_t>(g0 + gl) * Nc;
      const vct::GeneCols c = s_cols[gl];
      float nuv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) nuv[h] = s_nu[gl][h];
      float dnv[NB_SLOTS];
#pragma unroll
      for (int b = 0; b < NB_SLOTS; ++b) dnv[b] = (HAS_DNU && b < nb) ? s_dnu[gl][b] : 0.0f;

      float v_nu[NH];
      float v_ddnu[NB_SLOTS];
      float v_disp = 0.0f;
#pragma unroll
      for (int h = 0; h < NH; ++h) v_nu[h] = 0.0f;
#pragma unroll
      for (int b = 0; b < NB_SLOTS; ++b) v_ddnu[b] = 0.0f;

#pragma unroll
      for (int i = 0; i < kCellsPerThread; ++i) {
        const float k = valid[i] ? static_cast<float>(S[row + cell[i]]) : 0.0f;
        float dot = 0.0f;
#pragma unroll
        for (int h = 0; h < NH; ++h) dot += nuv[h] * z[i][h];
        float elog = dot + cfv[i];
        if (HAS_DNU) {
          float off = 0.0f;
#pragma unroll
          for (int b = 0; b < NB_SLOTS; ++b)
            if (b < nb) off += dnv[b] * db[i][b];
          elog += off;
        }
        const float log_b = -c.log_r - elog;
        if constexpr (!GRAD) {
          const float lp = vct::nb_lp<SKIP_K>(k, log_b, c);
          chunk_loss += valid[i] ? lp : 0.0f;
        } else {
          float lp, g_elog, g_r;
          vct::nb_lp_grads<WANT_DISP, SKIP_K>(k, log_b, c, lp, g_elog, g_r);
          if (!valid[i]) {
            lp = 0.0f;
            g_elog = 0.0f;
            g_r = 0.0f;
          }
          chunk_loss += lp;
          dc[i] += g_elog;
          v_disp += g_r;
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            dz[i][h] += g_elog * nuv[h];
            v_nu[h] += g_elog * z[i][h];
          }
#pragma unroll
          for (int b = 0; b < NB_SLOTS; ++b)
            if (HAS_DNU && b < nb) v_ddnu[b] += g_elog * db[i][b];
        }
      }

      if constexpr (GRAD) {
#pragma unroll
        for (int h = 0; h < NH; ++h) v_nu[h] = vct::warp_sum(v_nu[h]);
        if (WANT_DISP) v_disp = vct::warp_sum(v_disp);
#pragma unroll
        for (int b = 0; b < NB_SLOTS; ++b)
          if (HAS_DNU && b < nb) v_ddnu[b] = vct::warp_sum(v_ddnu[b]);
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < NH; ++h) s_red[gl][h][warp] = v_nu[h];
          s_red[gl][NH][warp] = WANT_DISP ? v_disp : 0.0f;
#pragma unroll
          for (int b = 0; b < NB_SLOTS; ++b)
            if (HAS_DNU && b < nb) s_red[gl][NH + 1 + b][warp] = v_ddnu[b];
        }
      }
    }
    loss += static_cast<double>(chunk_loss);

    if constexpr (GRAD) {
      __syncthreads();
      for (int i = tid; i < gn * NV; i += kThreads) {
        const int gl = i / NV;
        const int v = i % NV;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_red[gl][v][w];
        gene_part[(static_cast<size_t>(tile) * Ng + g0 + gl) * NV + v] = s;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged columns
  }

  if constexpr (GRAD) {
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      if (!valid[i]) continue;
#pragma unroll
      for (int h = 0; h < NH; ++h) dzeta[static_cast<size_t>(cell[i]) * NH + h] = dz[i][h];
      dcf[cell[i]] = dc[i];
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
  phase_kernel<TK, NH, GRAD, WANT_DISP, HAS_DNU, SKIP_K>
      <<<tiles, kThreads, 0, a.stream>>>(
          static_cast<const TK*>(a.S), a.nu, a.zeta, a.cf, a.disp, a.dnu, a.Db,
          a.Ng, a.Nc, a.Nb, a.loss_part, a.gene_part, a.dzeta, a.dcf);
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

int vct_phase_cells_per_block() { return kCellsPerBlock; }

int vct_phase_max_nb() { return kMaxNb; }

// Loss only: loss_part (n_tiles,) doubles, summed by the caller.
int vct_phase_fwd(const void* S, int counts_int16, const float* nu, const float* zeta,
                  const float* cf, const float* disp, const float* dnu, const float* Db,
                  int Ng, int Nc, int Nh, int Nb, int skip_k, double* loss_part,
                  void* stream) {
  Args a{S, nu, zeta, cf, disp, dnu, Db, Ng, Nc, Nh, Nb,
         loss_part, nullptr, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  return run<false>(a, counts_int16, false, skip_k != 0);
}

// Loss and all gradients: loss_part (n_tiles,), gene_part (n_tiles, Ng, Nh+1+Nb),
// dzeta (Nc, Nh), dcf (Nc,).
int vct_phase_fwdgrad(const void* S, int counts_int16, const float* nu, const float* zeta,
                      const float* cf, const float* disp, const float* dnu, const float* Db,
                      int Ng, int Nc, int Nh, int Nb, int skip_k, int want_disp,
                      double* loss_part, float* gene_part, float* dzeta, float* dcf,
                      void* stream) {
  Args a{S, nu, zeta, cf, disp, dnu, Db, Ng, Nc, Nh, Nb,
         loss_part, gene_part, dzeta, dcf, static_cast<cudaStream_t>(stream)};
  return run<true>(a, counts_int16, want_disp != 0, skip_k != 0);
}

}  // extern "C"
