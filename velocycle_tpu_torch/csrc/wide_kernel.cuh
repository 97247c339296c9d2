// The wide-basis body of the fused NB kernels for Hopper (sm_90a): both
// stages' loss-only and fwd+grad cuts at a basis width W that is a runtime
// value, up to kMaxWidth columns.  nb_wide.cu instantiates it and exports
// the C interface; ops/nb_kernels.py routes every shape past the narrow
// bodies' widest instantiation (16 columns) here, with the delta_nu batches
// folded into basis columns (`widen_inputs`).
//
// Why a second body.  The narrow bodies (phase_kernel.cuh, velo_kernel.cuh)
// keep each thread's basis rows, cell gradients and gene-sum values in
// registers sized by a template width, and reduce the gene sums with a warp
// reduce-scatter of at most 32 values: neither holds past a few dozen
// columns.  Here the tile's basis rows and cell-gradient accumulators live
// in dynamic shared memory, and each sum over a tile's cells is taken by
// one thread in cell order, for any number of values per gene.
//
// Layout.  The work is cut into units, as in the narrow bodies: one tile of
// T cells by one chunk of G genes, G * T = kThreads * kGenesPerThread (one
// element per thread and gene it carries), chain-major and tile-major over
// a persistent grid that splits the units evenly.  T is the largest of
// kMaxTile, kMaxTile / 2, ... kMinTile whose shared memory (`smem_layout`)
// fits kTileBudget, chosen at the launch from W; the smallest tile is taken
// whatever its size, up to the card's 227 KB.  Thread tid carries cell
// tid % T of the tile and genes q * kGenesPerThread .. + kGenesPerThread - 1
// of the chunk, q = tid / T: a warp holds 32 neighbouring cells of one
// gene group, so its shared-memory reads of a basis row are conflict-free
// and its genes' columns are broadcasts.  Each unit runs in three passes
// between barriers:
//   A. each thread's ElogS (and dEs) for its genes, summed over the W
//      columns in order, then the NB element: the loss, and d lp / d ElogS
//      (and the velocity stage's other per-element factors) into per-gene
//      rows of shared memory;
//   B. the gene sums over the tile's cells (dnu's W columns and the
//      per-gene scalars), one output per thread in cell order, into
//      per-tile partials (K x tiles, Ng, NV) that the caller sums over
//      tiles;
//   C. the cell gradients: each tile row of the accumulators (dzeta's W
//      rows and dcf; the velocity stage also dzeta_dphi, domega) adds the
//      unit's sum over its genes, in gene order.
// When a CTA's run leaves a tile, it writes the tile's accumulators as one
// piece (pieces, rows, K * Nc); `wide_cell_sum_kernel` adds a tile's pieces
// in CTA order.  The loss goes to per-(chain, CTA) doubles, flushed when a
// run crosses a chain boundary.  No float atomics and every sum in a fixed
// order: repeats are bit-identical.
//
// Counts are read straight from device memory, one element per thread and
// gene (a warp reads 32 neighbouring cells of one row), all of a unit's
// before pass A so that their latencies overlap the basis sums; any Nc,
// any row alignment.  dEs and x of the velocity stage are formed as in
// velo_kernel.cuh, one rounded product and one rounded sum per column in
// the plain version's order.  The NB element and the integer-count special
// functions are nb_common.cuh's, unchanged.
//
// What bounds it: shared-memory traffic and the per-element arithmetic.
// Passes A-C each cost about W fused multiply-adds per element, B and C
// with two shared-memory reads each (no register blocking yet); the count
// stream is 2 bytes (int16) per element and matrix.  Tensor cores for the
// three basis products are the redesign this body leaves open.
//
// The layout constants below are their only definition: the Python
// wrappers read them back from the library (vct_wide_layout), and on the
// CPU from this file.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"

namespace vct {
namespace wide {

constexpr int kThreads = 128;
constexpr int kGenesPerThread = 8;
constexpr int kMaxWidth = 256;
constexpr int kTileBudget = 112640;   // bytes (110 KB) of shared memory a tile is fitted to
constexpr int kMinTile = 32;
constexpr int kMaxTile = 128;
constexpr int kElems = kThreads * kGenesPerThread;   // G * T: elements of a unit
constexpr int kColFloats = static_cast<int>(sizeof(GeneCols) / sizeof(float));
static_assert(kMaxTile <= kThreads && kThreads % kMaxTile == 0, "threads cover the tile");
static_assert(kMinTile % 32 == 0, "a warp holds cells of one gene group");
static_assert(kGenesPerThread % 4 == 0, "a thread's genes are whole float4s");

// FWD: the loss alone.  FWDGRAD: the loss and every gradient.
enum Cut : int { FWD, FWDGRAD, kNumCuts };
enum Stage : int { PHASE, VELO };

// Values summed over a tile's cells per gene (the gene partials' last
// axis): phase [dnu (W), ddisp]; velocity [dnu (W), ddisp, dlog_beta,
// sum_c g_x].  Rows of a cell piece: phase [dzeta (W), dcf]; velocity
// [dzeta (W), dzeta_dphi (W), dcf, domega].
__host__ __device__ constexpr int gene_values(int stage, int W) {
  return W + (stage == PHASE ? 1 : 3);
}
__host__ __device__ constexpr int cell_rows(int stage, int W) {
  return stage == PHASE ? W + 1 : 2 * W + 2;
}
// per-element rows of a unit's factors (G x (T + 1) floats each): phase
// [g_elog, g_r]; velocity [g_e, g_x * omega, g_x * dEs, g_r, -g_U, g_x]
__host__ __device__ constexpr int factor_rows(int stage) { return stage == PHASE ? 2 : 6; }

// Offsets, in floats, of one CTA's shared memory for a tile of T cells at
// width W.  Rows over the tile's cells are T + 1 floats apart, so that
// pass B's threads, each on another row at the same cell, meet no bank
// conflict.
struct Smem {
  int G, PT;   // genes of a unit, floats between two cell rows
  int nu;      // nu^T (W, G): the unit's genes' coefficients, column by column
  int cols;    // GeneCols (G)
  int gene;    // velocity: -log_beta, exp(log_gamma) (2 x G)
  int z;       // zeta^T (W, PT); velocity then zeta_dphi^T
  int acc;     // cell-gradient accumulators (cell_rows, PT)
  int fac;     // the unit's per-element factors (factor_rows x G, PT)
  int total;
};

__host__ __device__ inline Smem smem_layout(int stage, int cut, int W, int T) {
  Smem s;
  s.G = kElems / T;
  s.PT = T + 1;
  s.nu = 0;
  s.cols = s.nu + W * s.G;
  s.gene = s.cols + kColFloats * s.G;
  s.z = s.gene + (stage == VELO ? 2 * s.G : 0);
  s.acc = s.z + (stage == VELO ? 2 : 1) * W * s.PT;
  const bool grad = cut == FWDGRAD;
  s.fac = s.acc + (grad ? cell_rows(stage, W) * s.PT : 0);
  s.total = s.fac + (grad ? factor_rows(stage) * s.G * s.PT : 0);
  return s;
}

// The tile for width W: the largest power-of-two T in [kMinTile, kMaxTile]
// whose shared memory fits kTileBudget, else kMinTile.
__host__ inline int tile_cells(int stage, int cut, int W) {
  int T = kMaxTile;
  while (T > kMinTile && smem_layout(stage, cut, W, T).total * 4 > kTileBudget) T /= 2;
  return T;
}

// The one body.  STAGE picks the phase or the velocity element; U,
// zeta_dphi, omega, log_beta and log_gamma are read by the velocity stage
// only.  `lgk_skip` drops lgamma(k + 1) (the caller adds its sum).
template <int STAGE, typename TS, typename TU, int CUT, bool WANT_DISP>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const TS* __restrict__ S, const TU* __restrict__ U, const float* __restrict__ nu,
            const float* __restrict__ zeta, const float* __restrict__ zdphi,
            const float* __restrict__ cf, const float* __restrict__ omega,
            const float* __restrict__ lbeta, const float* __restrict__ lgamma,
            const float* __restrict__ disp, int Ng, int Nc, int W, int T, int lgk_skip,
            ChainStrides cs, double* __restrict__ loss_part, float* __restrict__ gene_part,
            float* __restrict__ cell_piece) {
  constexpr bool VEL = STAGE == VELO;
  constexpr bool GRAD = CUT == FWDGRAD;
  constexpr int GPT = kGenesPerThread;
  extern __shared__ __align__(16) float sm[];
  __shared__ double s_loss[kThreads / 32];

  const Smem L = smem_layout(STAGE, CUT, W, T);
  const int G = L.G, PT = L.PT;
  float* s_nu = sm + L.nu;
  GeneCols* s_cols = reinterpret_cast<GeneCols*>(sm + L.cols);
  float* s_nlb = sm + L.gene;
  float* s_gam = s_nlb + G;
  float* s_z = sm + L.z;
  float* s_zd = s_z + W * PT;
  float* s_acc = sm + L.acc;
  float* s_fac = sm + L.fac;
  const int NV = gene_values(STAGE, W);
  const int NR = cell_rows(STAGE, W);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid % T;          // this thread's cell of the tile
  const int q = tid / T;          // ... and its gene group
  const int n_rep = kThreads / T; // threads per cell
  const int n_chunks = (Ng + G - 1) / G;
  const int tiles = (Nc + T - 1) / T;
  const long long UC = static_cast<long long>(tiles) * n_chunks;  // units of one chain
  const long long n_units = UC * cs.K;
  const long long u0 = static_cast<long long>(blockIdx.x) * n_units / gridDim.x;
  const long long u1 = static_cast<long long>(blockIdx.x + 1) * n_units / gridDim.x;
  const size_t KNc = static_cast<size_t>(cs.K) * Nc;

  int tile = -1;
  bool valid = false;
  float cfv = 0.0f, omv = 0.0f;

  // this CTA's piece of a tile's cell gradients, in CTA order, and the
  // accumulators zeroed for the next tile
  auto flush = [&](int gt) {
    const int k = static_cast<int>(blockIdx.x) -
                  unit_owner(static_cast<long long>(gt) * n_chunks, n_units, gridDim.x);
    const int ch = gt / tiles;
    const int c0 = (gt - ch * tiles) * T;
    const int tn = min(T, Nc - c0);
    float* out = cell_piece + static_cast<size_t>(k) * NR * KNc + static_cast<size_t>(ch) * Nc + c0;
    for (int j = tid; j < NR * T; j += kThreads) {
      const int r = j / T;
      const int cc = j - r * T;
      if (cc < tn) out[static_cast<size_t>(r) * KNc + cc] = s_acc[r * PT + cc];
      s_acc[r * PT + cc] = 0.0f;
    }
  };

  int chain = static_cast<int>(u0 / UC);
  double loss = 0.0;
  auto flush_loss = [&]() {
    loss = warp_sum(loss);
    if (lane == 0) s_loss[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += s_loss[w];
      const int k = static_cast<int>(blockIdx.x) - unit_owner(chain * UC, n_units, gridDim.x);
      loss_part[static_cast<size_t>(chain) * cs.loss_pieces + k] = s;
    }
    __syncthreads();
    loss = 0.0;
  };

  if (GRAD)
    for (int j = tid; j < NR * PT; j += kThreads) s_acc[j] = 0.0f;

  for (long long u = u0; u < u1; ++u) {
    if (u / UC != chain) {  // uniform over the CTA: the next chain's units
      flush_loss();
      chain = static_cast<int>(u / UC);
    }
    const int gt = static_cast<int>(u / n_chunks);
    const int t = gt - chain * tiles;
    const int c0 = t * T;
    const int g0 = static_cast<int>(u - static_cast<long long>(gt) * n_chunks) * G;
    const int gn = min(G, Ng - g0);

    // the tile's basis rows (and the previous tile's piece out) when the
    // run enters a tile; the barrier that ended the last unit freed them
    if (gt != tile) {
      if (GRAD && tile >= 0) flush(tile);
      tile = gt;
      const int tn = min(T, Nc - c0);
      const float* zeta_c = zeta + chain * cs.zeta + static_cast<size_t>(c0) * W;
      for (int j = tid; j < T * W; j += kThreads) {
        const int cc = j / W;
        const int h = j - cc * W;
        s_z[h * PT + cc] = cc < tn ? zeta_c[j] : 0.0f;
      }
      if (VEL) {
        const float* zd_c = zdphi + chain * cs.zdphi + static_cast<size_t>(c0) * W;
        for (int j = tid; j < T * W; j += kThreads) {
          const int cc = j / W;
          const int h = j - cc * W;
          s_zd[h * PT + cc] = cc < tn ? zd_c[j] : 0.0f;
        }
      }
      valid = c < tn;
      cfv = valid ? cf[chain * cs.cf + c0 + c] : 0.0f;
      omv = (VEL && valid) ? omega[chain * cs.omega + c0 + c] : 0.0f;
    }

    // the unit's genes: nu^T, the dispersion columns, -log_beta and
    // exp(log_gamma); zeros for genes past Ng
    const float* nu_c = nu + chain * cs.nu + static_cast<size_t>(g0) * W;
    for (int j = tid; j < G * W; j += kThreads) {
      const int gl = j / W;
      const int h = j - gl * W;
      s_nu[h * G + gl] = gl < gn ? nu_c[j] : 0.0f;
    }
    if (tid < gn) {
      s_cols[tid] = gene_cols(disp[chain * cs.disp + g0 + tid]);
      if (VEL) {
        s_nlb[tid] = -lbeta[chain * cs.lbeta + g0 + tid];
        s_gam[tid] = expf(lgamma[chain * cs.lgamma + g0 + tid]);
      }
    }
    // this thread's counts, in flight while the basis sums run
    const int gb = q * GPT;          // first gene of this thread's group
    float kS[GPT], kU[VEL ? GPT : 1];
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const bool ok = valid && gb + i < gn;
      const size_t at = static_cast<size_t>(g0 + gb + i) * Nc + c0 + c;
      kS[i] = ok ? static_cast<float>(S[at]) : 0.0f;
      if (VEL) kU[VEL ? i : 0] = ok ? static_cast<float>(U[at]) : 0.0f;
    }
    __syncthreads();  // the unit's genes and the tile's rows are in place

    // pass A: ElogS (and dEs) over the columns in order, then the element
    float acc[GPT], dE[VEL ? GPT : 1];
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      acc[i] = 0.0f;
      if (VEL) dE[VEL ? i : 0] = 0.0f;
    }
    const float* zc = s_z + c;
    const float* nq = s_nu + gb;
    for (int h = 0; h < W; ++h) {
      const float zv = zc[h * PT];
      float n[GPT];
#pragma unroll
      for (int i = 0; i < GPT; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(nq + h * G + i);
        n[i] = v.x;
        n[i + 1] = v.y;
        n[i + 2] = v.z;
        n[i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < GPT; ++i) acc[i] += n[i] * zv;
      if (VEL) {
        const float zdv = s_zd[h * PT + c];
#pragma unroll
        for (int i = 0; i < GPT; ++i)
          dE[VEL ? i : 0] = __fadd_rn(dE[VEL ? i : 0], __fmul_rn(n[i], zdv));
      }
    }

    float chunk_loss = 0.0f;
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int gl = gb + i;
      if (gl >= gn) break;  // uniform over a warp: one gene group
      const GeneCols cc = s_cols[gl];
      const float elogS = acc[i] + cfv;
      float* fac = s_fac + gl * PT + c;   // row r of the factors: + r * G * PT
      if constexpr (!VEL) {
        if constexpr (!GRAD) {
          float lp = nb_lp<true>(kS[i], -cc.log_r - elogS, cc);
          if (!lgk_skip) lp -= lgamma_pos(kS[i] + 1.0f);
          chunk_loss += valid ? lp : 0.0f;
        } else {
          float lp, g_elog, g_r;
          nb_lp_grads<WANT_DISP, true>(kS[i], -cc.log_r - elogS, cc, lp, g_elog, g_r);
          if (!lgk_skip) lp -= lgamma_pos(kS[i] + 1.0f);
          if (!valid) {
            lp = 0.0f;
            g_elog = 0.0f;
            g_r = 0.0f;
          }
          chunk_loss += lp;
          fac[0] = g_elog;
          fac[G * PT] = g_r;
        }
      } else {
        const float kUi = kU[VEL ? i : 0];
        const float dEi = dE[VEL ? i : 0];
        const float x = __fadd_rn(__fmul_rn(dEi, omv), s_gam[gl]);
        const float xr = fmaxf(x, 0.0f) + 1e-5f;
        const float elogU = (s_nlb[gl] + logf(xr)) + elogS;
        const float log_bS = -cc.log_r - elogS;
        const float log_bU = -cc.log_r - elogU;
        if constexpr (!GRAD) {
          float lpS = nb_lp<true>(kS[i], log_bS, cc);
          if (!lgk_skip) lpS -= lgamma_pos(kS[i] + 1.0f);
          float lpU = nb_lp<true>(kUi, log_bU, cc);
          if (!lgk_skip) lpU -= lgamma_pos(kUi + 1.0f);
          chunk_loss += valid ? lpS + lpU : 0.0f;
        } else {
          float lpS, gS, grS, lpU, gU, grU;
          nb_lp_grads<WANT_DISP, true>(kS[i], log_bS, cc, lpS, gS, grS);
          if (!lgk_skip) lpS -= lgamma_pos(kS[i] + 1.0f);
          nb_lp_grads<WANT_DISP, true>(kUi, log_bU, cc, lpU, gU, grU);
          if (!lgk_skip) lpU -= lgamma_pos(kUi + 1.0f);
          float lp = lpS + lpU;
          float g_r = grS + grU;
          if (!valid) {
            lp = 0.0f;
            gS = 0.0f;
            gU = 0.0f;
            g_r = 0.0f;
          }
          const float g_e = gS + gU;                             // ElogU includes ElogS
          const float g_x = gU * (x > 0.0f ? 1.0f / xr : 0.0f);  // relu + log chain
          chunk_loss += lp;
          fac[0] = g_e;
          fac[G * PT] = g_x * omv;
          fac[2 * G * PT] = g_x * dEi;
          fac[3 * G * PT] = g_r;
          fac[4 * G * PT] = -gU;
          fac[5 * G * PT] = g_x;
        }
      }
    }
    loss += static_cast<double>(chunk_loss);

    if constexpr (GRAD) {
      __syncthreads();  // the unit's factors are complete

      // pass B: the gene sums, one (gene, value) per thread, in cell order
      float* gp = gene_part + (static_cast<size_t>(gt) * Ng + g0) * NV;
      for (int j = tid; j < gn * NV; j += kThreads) {
        const int gl = j / NV;
        const int v = j - gl * NV;
        const float* f0 = s_fac + gl * PT;
        float s = 0.0f;
        if (v < W) {
          const float* zr = s_z + v * PT;
          if constexpr (!VEL) {
            for (int cc = 0; cc < T; ++cc) s += f0[cc] * zr[cc];
          } else {
            const float* f1 = f0 + G * PT;
            const float* zdr = s_zd + v * PT;
            for (int cc = 0; cc < T; ++cc) s += f0[cc] * zr[cc] + f1[cc] * zdr[cc];
          }
        } else {
          // phase: g_r; velocity: g_r, -g_U, g_x (factor rows 3, 4, 5)
          const float* fr = f0 + (VEL ? 3 + (v - W) : 1) * G * PT;
          for (int cc = 0; cc < T; ++cc) s += fr[cc];
        }
        gp[j] = s;
      }

      // pass C: each accumulator row adds the unit's sum over its genes
      for (int r = q; r < NR; r += n_rep) {
        // the factor row and the nu column (null: a plain sum) of row r
        int fr;
        const float* ncol = nullptr;
        if (!VEL) {
          fr = 0;
          if (r < W) ncol = s_nu + r * G;
        } else if (r < W) {
          fr = 0;
          ncol = s_nu + r * G;
        } else if (r < 2 * W) {
          fr = 1;
          ncol = s_nu + (r - W) * G;
        } else {
          fr = r == 2 * W ? 0 : 2;
        }
        const float* f = s_fac + fr * G * PT + c;
        float s = 0.0f;
        if (ncol != nullptr) {
          for (int gl = 0; gl < gn; ++gl) s += f[gl * PT] * ncol[gl];
        } else {
          for (int gl = 0; gl < gn; ++gl) s += f[gl * PT];
        }
        s_acc[r * PT + c] += s;
      }
    }
    __syncthreads();  // the unit's rows are free for the next unit
  }
  if (GRAD && tile >= 0) flush(tile);
  flush_loss();
}

// The cell gradients (K, Nc, W) per basis block and (K, Nc) per scalar row
// from the pieces (pieces, rows, K * Nc): each tile's pieces added in the
// order of the CTAs that wrote them.  Phase rows [dzeta, dcf]; velocity
// [dzeta, dzeta_dphi, dcf, domega].
template <int STAGE>
__global__ void wide_cell_sum_kernel(const float* __restrict__ cell_piece, int Ng, int Nc, int K,
                                     int W, int T, int grid, float* __restrict__ dzeta,
                                     float* __restrict__ dzdphi, float* __restrict__ dcf,
                                     float* __restrict__ domega) {
  const long long KNc = static_cast<long long>(K) * Nc;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= KNc) return;
  const int NR = cell_rows(STAGE, W);
  const int G = kElems / T;
  const int ch = static_cast<int>(v / Nc);
  const int c = static_cast<int>(v - static_cast<long long>(ch) * Nc);
  const int n_chunks = (Ng + G - 1) / G;
  const int tiles = (Nc + T - 1) / T;
  const long long n_units = static_cast<long long>(K) * tiles * n_chunks;
  const long long first = (static_cast<long long>(ch) * tiles + c / T) * n_chunks;
  const int n = unit_owner(first + n_chunks - 1, n_units, grid) -
                unit_owner(first, n_units, grid) + 1;
  for (int r = 0; r < NR; ++r) {
    float s = cell_piece[static_cast<size_t>(r) * KNc + v];
    for (int k = 1; k < n; ++k) s += cell_piece[(static_cast<size_t>(k) * NR + r) * KNc + v];
    if (r < W) dzeta[static_cast<size_t>(v) * W + r] = s;
    else if (STAGE == VELO && r < 2 * W) dzdphi[static_cast<size_t>(v) * W + r - W] = s;
    else if (r == NR - (STAGE == VELO ? 2 : 1)) dcf[v] = s;
    else domega[v] = s;
  }
}

}  // namespace wide
}  // namespace vct
