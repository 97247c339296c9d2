// Roofline ladder of the phase fwd+grad kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of `tools/kernel_profile.py`: `k_stream`,
// `k_matmul`, `k_logpmf`, `k_fwdgrad`, the three settings of
// `_variant_kernel` (v_full, v_nodig, v_nocell) and `k_vpu_only`.  Each
// rung is `phase_fwdgrad` (nb_phase.cu) cut down to one more or one fewer
// piece of work, in the same launch layout (phase_layout.cuh) and on the
// same device functions (nb_common.cuh), so the differences between rungs
// say where that kernel's time goes on this card:
//
//   STREAM    sum float(S) + n_rep * sum(nu): the count stream alone, through
//             the production load path (2-byte or 4-byte scalar loads, two
//             cells per thread 256 apart).  n_rep is the TPU tool's cell-tile
//             count N_C (it adds nu once per grid cell to chain its steps).
//   MATMUL    sum S * (nu @ zeta^T): + ElogS, no cf
//   LOGPMF    sum NB_logpmf(S | nu @ zeta^T, r), lgamma(k+1) skipped, no cf
//   FWDGRAD   LOGPMF's loss (fwd+grad form) + dnu = g_elog @ zeta; no
//             digamma chain, no cf, no cell gradients
//   V_FULL    loss + dnu, ddisp, dzeta, dcf with cf: the same function as
//             phase_fwdgrad with no delta_nu, lgamma(k+1) skipped, want_disp
//   V_NODIG   V_FULL without the digamma chain; the ddisp slot holds
//             sum_c g_elog (kernel_profile.py:196-197)
//   V_NOCELL  V_FULL without the cell gradients (no dzeta, dcf)
//   VPU_ONLY  sum NB_logpmf(floor(3 |elog|) | elog, r), elog = nu @ zeta^T:
//             the arithmetic with no count matrix read at all
//
// Gene-indexed sums go to per-cell-tile partials (n_tiles, Ng, NV), NV = Nh
// for FWDGRAD and Nh + 1 for the variants, summed by the caller in a fixed
// order; the loss to per-CTA double partials.  No float atomics: repeats are
// bit-identical.  Nh = 5 only, as the TPU tool fixes it.  What bounds each
// rung is what it measures: STREAM the bytes (0.42 GB of int16 counts at
// 2048 x 102400), the others the per-element special functions.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_ladder.so nb_ladder.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"
#include "phase_layout.cuh"

namespace {

using namespace vct::phase_layout;
constexpr int NH = 5;

// the order of RUNGS in ops/ladder_kernels.py
enum : int { STREAM, MATMUL, LOGPMF, FWDGRAD, V_FULL, V_NODIG, V_NOCELL, VPU_ONLY };

struct Args {
  const void* S;
  const float* nu;
  const float* zeta;
  const float* cf;
  const float* disp;
  int Ng, Nc, n_rep;
  double* loss_part;  // (n_tiles,)
  float* gene_part;   // (n_tiles, Ng, NV) or null
  float* dzeta;       // (Nc, Nh) or null
  float* dcf;         // (Nc,) or null
  cudaStream_t stream;
};

template <typename TK, int RUNG>
__global__ void __launch_bounds__(kThreads)
ladder_kernel(const TK* __restrict__ S, const float* __restrict__ nu,
              const float* __restrict__ zeta, const float* __restrict__ cf,
              const float* __restrict__ disp, int Ng, int Nc, int n_rep,
              double* __restrict__ loss_part, float* __restrict__ gene_part,
              float* __restrict__ dzeta, float* __restrict__ dcf) {
  constexpr bool READS_S = RUNG != VPU_ONLY;
  constexpr bool ELOG = RUNG != STREAM;
  constexpr bool COLS = RUNG >= LOGPMF;
  constexpr bool GRAD = RUNG >= FWDGRAD && RUNG <= V_NOCELL;
  constexpr bool HAS_CF = RUNG >= V_FULL && RUNG <= V_NOCELL;
  constexpr bool WANT_DISP = RUNG == V_FULL || RUNG == V_NOCELL;
  constexpr bool CELL_GRADS = RUNG == V_FULL || RUNG == V_NODIG;
  constexpr int NV = RUNG == FWDGRAD ? NH : NH + 1;
  __shared__ float s_nu[kGeneChunk][NH];
  __shared__ vct::GeneCols s_cols[COLS ? kGeneChunk : 1];
  __shared__ float s_red[GRAD ? kGeneChunk : 1][GRAD ? NV : 1][kWarps];
  __shared__ double s_loss[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;

  int cell[kCellsPerThread];
  bool valid[kCellsPerThread];
  float z[kCellsPerThread][NH];
  float cfv[kCellsPerThread];
  float dz[kCellsPerThread][NH];
  float dc[kCellsPerThread];
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    cell[i] = tile * kCellsPerBlock + i * kThreads + tid;
    valid[i] = cell[i] < Nc;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      z[i][h] = (ELOG && valid[i]) ? zeta[static_cast<size_t>(cell[i]) * NH + h] : 0.0f;
      dz[i][h] = 0.0f;
    }
    cfv[i] = (HAS_CF && valid[i]) ? cf[cell[i]] : 0.0f;
    dc[i] = 0.0f;
  }

  double loss = 0.0;
  for (int g0 = 0; g0 < Ng; g0 += kGeneChunk) {
    const int gn = min(kGeneChunk, Ng - g0);
    for (int i = tid; i < gn * NH; i += kThreads) {
      const float v = nu[static_cast<size_t>(g0) * NH + i];
      s_nu[i / NH][i % NH] = v;
      if (RUNG == STREAM && tile == 0) loss += static_cast<double>(n_rep) * v;
    }
    if (COLS && tid < gn) s_cols[tid] = vct::gene_cols(disp[g0 + tid]);
    __syncthreads();

    float chunk_loss = 0.0f;
    for (int gl = 0; gl < gn; ++gl) {
      const size_t row = static_cast<size_t>(g0 + gl) * Nc;
      vct::GeneCols c{};
      if constexpr (COLS) c = s_cols[gl];
      float nuv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) nuv[h] = s_nu[gl][h];

      float v_nu[NH];
      float v_disp = 0.0f;
#pragma unroll
      for (int h = 0; h < NH; ++h) v_nu[h] = 0.0f;

#pragma unroll
      for (int i = 0; i < kCellsPerThread; ++i) {
        float k = 0.0f;
        if constexpr (READS_S) k = valid[i] ? static_cast<float>(S[row + cell[i]]) : 0.0f;
        if constexpr (RUNG == STREAM) {
          chunk_loss += k;
        } else {
          float dot = 0.0f;
#pragma unroll
          for (int h = 0; h < NH; ++h) dot += nuv[h] * z[i][h];
          const float elog = HAS_CF ? dot + cfv[i] : dot;
          if constexpr (RUNG == MATMUL) {
            chunk_loss += k * elog;
          } else {
            if constexpr (RUNG == VPU_ONLY) k = floorf(fabsf(elog) * 3.0f);
            const float log_b = -c.log_r - elog;
            if constexpr (!GRAD) {
              const float lp = vct::nb_lp<true>(k, log_b, c);
              chunk_loss += valid[i] ? lp : 0.0f;
            } else {
              float lp, g_elog, g_r;
              vct::nb_lp_grads<WANT_DISP, true>(k, log_b, c, lp, g_elog, g_r);
              if (!valid[i]) {
                lp = 0.0f;
                g_elog = 0.0f;
                g_r = 0.0f;
              }
              chunk_loss += lp;
              if (CELL_GRADS) dc[i] += g_elog;
              v_disp += RUNG == V_NODIG ? g_elog : g_r;
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                if (CELL_GRADS) dz[i][h] += g_elog * nuv[h];
                v_nu[h] += g_elog * z[i][h];
              }
            }
          }
        }
      }

      if constexpr (GRAD) {
#pragma unroll
        for (int h = 0; h < NH; ++h) v_nu[h] = vct::warp_sum(v_nu[h]);
        if (NV > NH) v_disp = vct::warp_sum(v_disp);
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < NH; ++h) s_red[gl][h][warp] = v_nu[h];
          if (NV > NH) s_red[gl][NV - 1][warp] = v_disp;
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

  if constexpr (CELL_GRADS) {
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

template <typename TK, int RUNG>
void launch(const Args& a) {
  const int tiles = (a.Nc + kCellsPerBlock - 1) / kCellsPerBlock;
  ladder_kernel<TK, RUNG><<<tiles, kThreads, 0, a.stream>>>(
      static_cast<const TK*>(a.S), a.nu, a.zeta, a.cf, a.disp, a.Ng, a.Nc, a.n_rep,
      a.loss_part, a.gene_part, a.dzeta, a.dcf);
}

template <typename TK>
int pick_rung(const Args& a, int rung) {
  switch (rung) {
    case STREAM: launch<TK, STREAM>(a); break;
    case MATMUL: launch<TK, MATMUL>(a); break;
    case LOGPMF: launch<TK, LOGPMF>(a); break;
    case FWDGRAD: launch<TK, FWDGRAD>(a); break;
    case V_FULL: launch<TK, V_FULL>(a); break;
    case V_NODIG: launch<TK, V_NODIG>(a); break;
    case V_NOCELL: launch<TK, V_NOCELL>(a); break;
    case VPU_ONLY: launch<TK, VPU_ONLY>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

int vct_ladder_cells_per_block() { return kCellsPerBlock; }

// One rung: loss_part (n_tiles,) doubles; FWDGRAD gene_part (n_tiles, Ng, Nh);
// the variants gene_part (n_tiles, Ng, Nh + 1), and V_FULL / V_NODIG dzeta
// (Nc, Nh) and dcf (Nc,).  Pointers a rung does not read or write may be null.
int vct_ladder_run(int rung, const void* S, int counts_int16, const float* nu,
                   const float* zeta, const float* cf, const float* disp, int Ng,
                   int Nc, int Nh, int n_rep, double* loss_part, float* gene_part,
                   float* dzeta, float* dcf, void* stream) {
  if (Ng < 1 || Nc < 1 || Nh != NH) return static_cast<int>(cudaErrorInvalidValue);
  Args a{S, nu, zeta, cf, disp, Ng, Nc, n_rep, loss_part, gene_part, dzeta, dcf,
         static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  const int rc = counts_int16 ? pick_rung<int16_t>(a, rung) : pick_rung<float>(a, rung);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
