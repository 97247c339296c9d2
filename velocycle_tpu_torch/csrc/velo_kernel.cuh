// The one body of the velocity-stage NB kernels for Hopper (sm_90a):
// `velo_fwd` and `velo_fwdgrad`, two compile-time cuts (`Cut`) of the same
// template in the same launch layout, on the same device functions as the
// phase kernels (nb_common.cuh).  nb_velo.cu instantiates it and exports the
// C interface.
//
// What it computes, per element of the (Ng, Nc) count matrices S and U:
//
//   ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]
//   x     = (nu @ zeta_dphi^T) * omega + exp(log_gamma)
//   ElogU = -log_beta + log(max(x, 0) + 1e-5) + ElogS
//   NB_logpmf(S | ElogS, r) + NB_logpmf(U | ElogU, r)
//
// summed, and in the FWDGRAD cut its gradients w.r.t. nu, zeta, zeta_dphi,
// cf, omega, log_beta, log_gamma, r and delta_nu, in one pass.
//
// Layout: phase_kernel.cuh's, with two count rows per gene.  The work is cut
// into units: one tile of kCellsPerTile cells (kCellsPerThread per thread,
// each cell's zeta, zeta_dphi, cf, omega, Db column and cell gradients in
// registers) by one chunk of kGeneChunk genes.  A persistent grid of SMs x
// resident CTAs (occupancy calculator) splits the units, tile-major, into
// contiguous runs that differ by at most one unit.  A CTA whose run crosses
// a tile boundary writes that tile's cell gradients (dzeta, dzeta_dphi, dcf,
// domega) as one piece; `velo_cell_sum_kernel` adds a tile's pieces in CTA
// order.  The velocity element keeps about twice phase's cell state in
// registers, so registers, not shared memory, set the resident CTAs: of
// three layouts swept on the H100 (PERF.md, the velocity sweep), two cells
// per thread with 8-gene chunks, two stages and a 128-register cap (16
// warps per SM) beat 16-gene chunks in three stages (12 warps at 134
// registers) and one cell per thread (20 warps).
//
// Chains.  A launch may carry K parameter sets over the same S and U (the
// chains of an MCMC batch, the particles of an SMC stage: `ChainStrides`,
// nb_common.cuh), as phase_kernel.cuh does: chain-major units, K x tiles x
// chunks, split evenly over the same persistent grid; gene partials (K,
// tiles, Ng, NV) and cell pieces over K x Nc indexed by the tile counted
// over all chains; the loss in per-(chain, CTA) doubles, flushed when a
// CTA's run crosses a chain boundary.  At K = 1 every index and every sum
// is the unbatched launch's: the same bits.
//
// S and U reach the arithmetic through a ring of kStages shared-memory
// stages: while unit i is computed, units i+1 .. i+kStages-1 are in flight
// as 16-byte `cp.async` copies of the aligned window around each row
// segment (each matrix with its own count type and row width, so int16 S
// may sit beside float32 U), with the unit's nu, dispersion, log_beta,
// log_gamma and delta_nu rows as 4-byte copies in the same group.  Odd Nc,
// misaligned matrix starts and the matrix end are handled as in
// phase_kernel.cuh.
//
// dE and x are formed in the plain version's column order, rounded product
// by rounded sum (no FMA contraction): just above the relu gate the gradient
// 1/xr magnifies any difference in x up to 1e5 times, so both sides form x
// bit-identically.  The gate is strict: g_x = gU * (x > 0 ? 1/xr : 0).
//
// Fixed-order sums and no float atomics: the gene-indexed sums [dnu, ddisp,
// dlog_beta, sum_c g_x, ddelta_nu] go through a warp reduce-scatter and the
// CTA's warps into per-tile partials (n_tiles, Ng, NH + 3 + Nb) that the
// caller sums over tiles (dlog_gamma = (sum_c g_x) * exp(log_gamma) after
// that sum); the loss into per-(chain, CTA) doubles; the cell gradients
// through the pieces.  Repeats are bit-identical.
//
// The layout constants below are their only definition: the Python wrappers
// read them back from the library (vct_velo_layout), and on the CPU from
// this file.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"

namespace vct {
namespace velo {

constexpr int kThreads = 128;
constexpr int kCellsPerThread = 2;
constexpr int kCellsPerTile = 256;
constexpr int kGeneChunk = 8;
constexpr int kStages = 2;
constexpr int kMaxNb = 4;
constexpr int kMinBlocksPerSm = 4;   // caps registers at 128 per thread
constexpr int kWarps = kThreads / 32;
static_assert(kCellsPerTile == kThreads * kCellsPerThread, "whole cells per thread");
static_assert(kCellsPerTile * 2 % 16 == 0, "a tile row is whole 16-byte pieces");
static_assert(kGeneChunk <= kThreads, "one thread stages each gene's columns");

// FWD: the loss alone.  FWDGRAD: the loss and every gradient.
enum Cut : int { FWD, FWDGRAD, kNumCuts };

// Gene-partial columns besides dnu (NH) and ddelta_nu (Nb): ddisp,
// dlog_beta, sum_c g_x.
constexpr int kGeneExtra = 3;

// One ring stage: kGeneChunk rows of S, then kGeneChunk rows of U, each the
// tile's cells plus up to 15 bytes of misaligned head; then the unit's
// floats: nu (kGeneChunk x NH), dispersion, log_beta, log_gamma (kGeneChunk
// each) and delta_nu (kMaxNb x kGeneChunk).
template <typename TK>
__host__ __device__ constexpr int row_bytes() {
  return kCellsPerTile * static_cast<int>(sizeof(TK)) + 16;
}

template <int NH, bool HAS_DNU>
__host__ __device__ constexpr int param_floats() {
  return kGeneChunk * (NH + 3 + (HAS_DNU ? kMaxNb : 0));
}

template <typename TS, typename TU, int NH, bool HAS_DNU>
__host__ __device__ constexpr int stage_bytes() {
  return kGeneChunk * (row_bytes<TS>() + row_bytes<TU>()) +
         (param_floats<NH, HAS_DNU>() * 4 + 15) / 16 * 16;
}

// Start the copies of rows g0 .. g0 + gn - 1, cells c0 .. of the (Ng, Nc)
// matrix K (n elements) into `dst`, rows of row_bytes<TK>() bytes: the
// aligned window around each row segment; the piece below a misaligned
// matrix start element by element, the piece past the matrix end
// zero-filled by the copy itself.
template <typename TK>
__device__ __forceinline__ void issue_rows(unsigned char* dst, const TK* K, size_t n, int g0,
                                           int gn, int c0, int Nc, int tid) {
  constexpr int ROW = row_bytes<TK>();
  constexpr int Q = ROW / 16;
  const char* begin = reinterpret_cast<const char*>(K);
  const char* end = begin + n * sizeof(TK);
  const int seg = min(kCellsPerTile, Nc - c0) * static_cast<int>(sizeof(TK));
  for (int i = tid; i < gn * Q; i += kThreads) {
    const int r = i / Q;
    const int q = i - r * Q;
    const char* a = begin + (static_cast<size_t>(g0 + r) * Nc + c0) * sizeof(TK);
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15u);
    if (q * 16 >= lead + seg) continue;
    const char* src = a - lead + 16 * q;
    unsigned char* d = dst + r * ROW + 16 * q;
    if (src < begin) {
      for (const char* b = begin; b < src + 16 && b < end; b += sizeof(TK))
        *reinterpret_cast<TK*>(d + (b - src)) = *reinterpret_cast<const TK*>(b);
    } else {
      const long long left = end - src;
      cp_async16(d, src, left < 16 ? static_cast<int>(left) : 16);
    }
  }
}

template <typename TS, typename TU, int NH, int CUT, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
velo_kernel(const TS* __restrict__ S, const TU* __restrict__ U, const float* __restrict__ nu,
            const float* __restrict__ zeta, const float* __restrict__ zdphi,
            const float* __restrict__ cf, const float* __restrict__ omega,
            const float* __restrict__ lbeta, const float* __restrict__ lgamma,
            const float* __restrict__ disp, const float* __restrict__ dnu,
            const float* __restrict__ Db, int Ng, int Nc, int Nb, ChainStrides cs,
            double* __restrict__ loss_part, float* __restrict__ gene_part,
            float* __restrict__ cell_piece) {
  constexpr bool GRAD = CUT == FWDGRAD;
  constexpr int NB_SLOTS = HAS_DNU ? kMaxNb : 1;
  constexpr int NVC = NH + kGeneExtra + (HAS_DNU ? kMaxNb : 0);  // values reduced per gene
  constexpr int P = pow2_at_least(NVC);
  constexpr int SPAN = 32 / P;
  constexpr int ROW_S = row_bytes<TS>();
  constexpr int ROW_U = row_bytes<TU>();
  constexpr int STAGE = stage_bytes<TS, TU, NH, HAS_DNU>();
  constexpr int OFF_U = kGeneChunk * ROW_S;              // U rows in a stage
  constexpr int PRM = OFF_U + kGeneChunk * ROW_U;        // the floats in a stage
  constexpr int PRM_DISP = kGeneChunk * NH;              // ... dispersions in them
  constexpr int PRM_LB = PRM_DISP + kGeneChunk;          // ... log_beta
  constexpr int PRM_LG = PRM_LB + kGeneChunk;            // ... log_gamma
  constexpr int PRM_DNU = PRM_LG + kGeneChunk;           // ... delta_nu
  constexpr int NCG = 2 * NH + 2;  // rows of a cell piece: dzeta, dzeta_dphi, dcf, domega
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ GeneCols s_cols[kGeneChunk];
  __shared__ float s_nlb[kGeneChunk];   // -log_beta
  __shared__ float s_gam[kGeneChunk];   // exp(log_gamma)
  __shared__ float s_red[GRAD ? kGeneChunk : 1][GRAD ? NVC : 1][kWarps];
  __shared__ double s_loss[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = HAS_DNU ? Nb : 0;
  const int NV = NH + kGeneExtra + nb;
  const int n_chunks = (Ng + kGeneChunk - 1) / kGeneChunk;
  const int tiles = (Nc + kCellsPerTile - 1) / kCellsPerTile;
  const long long UC = static_cast<long long>(tiles) * n_chunks;  // units of one chain
  const long long n_units = UC * cs.K;
  const long long u0 = static_cast<long long>(blockIdx.x) * n_units / gridDim.x;
  const long long u1 = static_cast<long long>(blockIdx.x + 1) * n_units / gridDim.x;
  const size_t n_el = static_cast<size_t>(Ng) * Nc;
  const unsigned s_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(S) & 15u);
  const unsigned u_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(U) & 15u);

  // start the copies of unit u into ring stage `slot`
  auto issue = [&](long long u, int slot) {
    unsigned char* st = ring + slot * STAGE;
    const int gt = static_cast<int>(u / n_chunks);
    const int ch = gt / tiles;
    const int t = gt - ch * tiles;
    const int g0 = static_cast<int>(u - static_cast<long long>(gt) * n_chunks) * kGeneChunk;
    const int gn = min(kGeneChunk, Ng - g0);
    const int c0 = t * kCellsPerTile;
    issue_rows(st, S, n_el, g0, gn, c0, Nc, tid);
    issue_rows(st + OFF_U, U, n_el, g0, gn, c0, Nc, tid);
    float* prm = reinterpret_cast<float*>(st + PRM);
    const float* nu_c = nu + ch * cs.nu;
    for (int i = tid; i < gn * NH; i += kThreads)
      cp_async4(prm + i, nu_c + static_cast<size_t>(g0) * NH + i);
    // each gene's dispersion, log_beta and log_gamma are copied by the
    // thread that turns them into its staged columns
    if (tid < gn) {
      cp_async4(prm + PRM_DISP + tid, disp + ch * cs.disp + g0 + tid);
      cp_async4(prm + PRM_LB + tid, lbeta + ch * cs.lbeta + g0 + tid);
      cp_async4(prm + PRM_LG + tid, lgamma + ch * cs.lgamma + g0 + tid);
    }
    if (HAS_DNU) {
      const float* dnu_c = dnu + ch * cs.dnu;
      for (int i = tid; i < gn * nb; i += kThreads) {
        const int b = i / gn;
        const int g = i - b * gn;
        cp_async4(prm + PRM_DNU + b * kGeneChunk + g, dnu_c + static_cast<size_t>(b) * Ng + g0 + g);
      }
    }
  };

  // this thread's cells of the current tile (i * kThreads + tid): registers
  // for the tile's units.  `tile` counts the tiles of all chains (chain *
  // tiles + tile of the chain); cell[] is the cell within the chain
  constexpr int C = kCellsPerThread;
  const size_t KNc = static_cast<size_t>(cs.K) * Nc;
  int tile = -1;
  int cell[C];
  bool valid[C];
  float z[C][NH], zd[C][NH];
  float cfv[C], om[C];
  float db[C][NB_SLOTS];
  float dz[C][GRAD ? NH : 1], dzd[C][GRAD ? NH : 1];
  float dc[C], dom[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    cell[i] = 0;
    valid[i] = false;
    cfv[i] = om[i] = dc[i] = dom[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < NH; ++h) z[i][h] = zd[i][h] = 0.0f;
#pragma unroll
    for (int h = 0; h < (GRAD ? NH : 1); ++h) dz[i][h] = dzd[i][h] = 0.0f;
#pragma unroll
    for (int b = 0; b < NB_SLOTS; ++b) db[i][b] = 0.0f;
  }

  // this CTA's piece of a tile's cell gradients, in CTA order; the pieces
  // are (pieces, 2 NH + 2, K * Nc), the chains' cells side by side
  auto flush = [&](int gt) {
    const int k = static_cast<int>(blockIdx.x) -
                  unit_owner(static_cast<long long>(gt) * n_chunks, n_units, gridDim.x);
    const size_t c0 = static_cast<size_t>(gt / tiles) * Nc;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (!valid[i]) continue;
      float* out = cell_piece + static_cast<size_t>(k) * NCG * KNc + c0 + cell[i];
#pragma unroll
      for (int h = 0; h < (GRAD ? NH : 1); ++h) {
        out[static_cast<size_t>(h) * KNc] = dz[i][h];
        out[static_cast<size_t>(NH + h) * KNc] = dzd[i][h];
      }
      out[static_cast<size_t>(2 * NH) * KNc] = dc[i];
      out[static_cast<size_t>(2 * NH + 1) * KNc] = dom[i];
    }
  };

  // this CTA's piece of a chain's loss: loss_part is (K, loss_pieces), a
  // chain's pieces in the order of the CTAs that carry its units
  int chain = static_cast<int>(u0 / UC);
  double loss = 0.0;
  auto flush_loss = [&]() {
    loss = warp_sum(loss);
    if (lane == 0) s_loss[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_loss[w];
      const int k = static_cast<int>(blockIdx.x) - unit_owner(chain * UC, n_units, gridDim.x);
      loss_part[static_cast<size_t>(chain) * cs.loss_pieces + k] = s;
    }
    __syncthreads();
    loss = 0.0;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (u0 + s < u1) issue(u0 + s, s);
    cp_async_commit();
  }

  for (long long u = u0; u < u1; ++u) {
    if (u / UC != chain) {  // uniform over the CTA: the next chain's units
      flush_loss();
      chain = static_cast<int>(u / UC);
    }
    const int iu = static_cast<int>(u - u0);
    const int slot = iu % kStages;
    // refill the stage that unit u - 1 used (every thread left it at the
    // barrier that ended the last step), then wait for unit u
    if (u + kStages - 1 < u1) issue(u + kStages - 1, (iu + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();

    const int gt = static_cast<int>(u / n_chunks);
    const int t = gt - chain * tiles;
    const int g0 = static_cast<int>(u - static_cast<long long>(gt) * n_chunks) * kGeneChunk;
    const int gn = min(kGeneChunk, Ng - g0);
    const unsigned char* st = ring + slot * STAGE;
    const float* prm = reinterpret_cast<const float*>(st + PRM);
    if (tid < gn) {
      s_cols[tid] = gene_cols(prm[PRM_DISP + tid]);
      s_nlb[tid] = -prm[PRM_LB + tid];
      s_gam[tid] = expf(prm[PRM_LG + tid]);
    }
    __syncthreads();  // the stage and the columns are in place for every thread

    if (gt != tile) {
      if (GRAD && tile >= 0) flush(tile);
      tile = gt;
      const float* zeta_c = zeta + chain * cs.zeta;
      const float* zdphi_c = zdphi + chain * cs.zdphi;
      const float* cf_c = cf + chain * cs.cf;
      const float* om_c = omega + chain * cs.omega;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        cell[i] = t * kCellsPerTile + i * kThreads + tid;
        valid[i] = cell[i] < Nc;
        const size_t row = static_cast<size_t>(valid[i] ? cell[i] : 0) * NH;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          z[i][h] = valid[i] ? zeta_c[row + h] : 0.0f;
          zd[i][h] = valid[i] ? zdphi_c[row + h] : 0.0f;
        }
#pragma unroll
        for (int h = 0; h < (GRAD ? NH : 1); ++h) dz[i][h] = dzd[i][h] = 0.0f;
        cfv[i] = valid[i] ? cf_c[cell[i]] : 0.0f;
        om[i] = valid[i] ? om_c[cell[i]] : 0.0f;
        dc[i] = dom[i] = 0.0f;
#pragma unroll
        for (int b = 0; b < NB_SLOTS; ++b)
          db[i][b] = (HAS_DNU && b < nb && valid[i])
                         ? Db[static_cast<size_t>(b) * Nc + cell[i]] : 0.0f;
      }
    }

    // byte offsets of (g0, this tile's first cell) in S and U, for the rows'
    // heads
    const size_t cell0 = static_cast<size_t>(g0) * Nc + static_cast<size_t>(t) * kCellsPerTile;
    const size_t rowS0 = cell0 * sizeof(TS) + s_mis;
    const size_t rowU0 = cell0 * sizeof(TU) + u_mis;
    float chunk_loss = 0.0f;
    for (int gl = 0; gl < gn; ++gl) {
      const size_t gofs = static_cast<size_t>(gl) * Nc;
      const unsigned char* rs = st + gl * ROW_S + ((rowS0 + gofs * sizeof(TS)) & 15u);
      const unsigned char* ru = st + OFF_U + gl * ROW_U + ((rowU0 + gofs * sizeof(TU)) & 15u);
      float nuv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) nuv[h] = prm[gl * NH + h];
      float dnv[NB_SLOTS];
#pragma unroll
      for (int b = 0; b < NB_SLOTS; ++b)
        dnv[b] = (HAS_DNU && b < nb) ? prm[PRM_DNU + b * kGeneChunk + gl] : 0.0f;
      const GeneCols c = s_cols[gl];
      const float nlb = s_nlb[gl];
      const float gam = s_gam[gl];
      float v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = 0.0f;

#pragma unroll
      for (int i = 0; i < C; ++i) {
        float kS = 0.0f, kU = 0.0f;
        if (valid[i]) {
          const int e = i * kThreads + tid;
          kS = static_cast<float>(*reinterpret_cast<const TS*>(rs + e * sizeof(TS)));
          kU = static_cast<float>(*reinterpret_cast<const TU*>(ru + e * sizeof(TU)));
        }
        // dE and x in the plain version's order, without FMA contraction
        float dot = 0.0f, dE = 0.0f;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          dot += nuv[h] * z[i][h];
          dE = __fadd_rn(dE, __fmul_rn(nuv[h], zd[i][h]));
        }
        float elogS = dot + cfv[i];
        if (HAS_DNU) {
          float off = 0.0f;
#pragma unroll
          for (int b = 0; b < NB_SLOTS; ++b)
            if (b < nb) off += dnv[b] * db[i][b];
          elogS += off;
        }
        const float x = __fadd_rn(__fmul_rn(dE, om[i]), gam);
        const float xr = fmaxf(x, 0.0f) + 1e-5f;
        const float elogU = (nlb + logf(xr)) + elogS;
        const float log_bS = -c.log_r - elogS;
        const float log_bU = -c.log_r - elogU;

        if constexpr (!GRAD) {
          const float lp = nb_lp<SKIP_K>(kS, log_bS, c) + nb_lp<SKIP_K>(kU, log_bU, c);
          chunk_loss += valid[i] ? lp : 0.0f;
        } else {
          float lpS, gS, grS, lpU, gU, grU;
          nb_lp_grads<WANT_DISP, SKIP_K>(kS, log_bS, c, lpS, gS, grS);
          nb_lp_grads<WANT_DISP, SKIP_K>(kU, log_bU, c, lpU, gU, grU);
          float lp = lpS + lpU;
          float g_r = grS + grU;
          if (!valid[i]) {
            lp = 0.0f;
            gS = 0.0f;
            gU = 0.0f;
            g_r = 0.0f;
          }
          const float g_e = gS + gU;                             // ElogU includes ElogS
          const float g_x = gU * (x > 0.0f ? 1.0f / xr : 0.0f);  // relu + log chain
          const float g_xo = g_x * om[i];
          chunk_loss += lp;
          dc[i] += g_e;
          dom[i] += g_x * dE;
          // this thread's share of the gene-indexed sums, over its cells
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            dz[i][h] += g_e * nuv[h];
            dzd[i][h] += g_xo * nuv[h];
            v[h] += g_e * z[i][h] + g_xo * zd[i][h];
          }
          v[NH] += g_r;
          v[NH + 1] -= gU;
          v[NH + 2] += g_x;
          if constexpr (HAS_DNU) {
#pragma unroll
            for (int b = 0; b < NB_SLOTS; ++b)
              if (b < nb) v[NH + kGeneExtra + b] += g_e * db[i][b];
          }
        }
      }
      if constexpr (GRAD) {
        warp_reduce_scatter<P>(v, lane);
        if (lane % SPAN == 0 && lane / SPAN < NVC) s_red[gl][lane / SPAN][warp] = v[0];
      }
    }
    loss += static_cast<double>(chunk_loss);
    __syncthreads();  // the stage is free for refilling; s_red is complete

    if constexpr (GRAD) {
      for (int j = tid; j < gn * NV; j += kThreads) {
        const int gl = j / NV;
        const int vi = j - gl * NV;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_red[gl][vi][w];
        gene_part[(static_cast<size_t>(gt) * Ng + g0 + gl) * NV + vi] = s;
      }
    }
  }
  if (GRAD && tile >= 0) flush(tile);
  cp_async_wait<0>();
  flush_loss();
}

// dzeta and dzeta_dphi (K, Nc, NH), dcf and domega (K, Nc) from the
// pieces (pieces, 2 NH + 2, K * Nc): each tile's pieces added in the order
// of the CTAs that wrote them.
template <int NH>
__global__ void velo_cell_sum_kernel(const float* __restrict__ cell_piece, int Ng, int Nc,
                                     int K, int grid, float* __restrict__ dzeta,
                                     float* __restrict__ dzdphi, float* __restrict__ dcf,
                                     float* __restrict__ domega) {
  constexpr int NCG = 2 * NH + 2;
  const long long KNc = static_cast<long long>(K) * Nc;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= KNc) return;
  const int ch = static_cast<int>(v / Nc);
  const int c = static_cast<int>(v - static_cast<long long>(ch) * Nc);
  const int n_chunks = (Ng + kGeneChunk - 1) / kGeneChunk;
  const int tiles = (Nc + kCellsPerTile - 1) / kCellsPerTile;
  const long long n_units = static_cast<long long>(K) * tiles * n_chunks;
  const long long first = (static_cast<long long>(ch) * tiles + c / kCellsPerTile) * n_chunks;
  const int n = unit_owner(first + n_chunks - 1, n_units, grid) -
                unit_owner(first, n_units, grid) + 1;
#pragma unroll
  for (int r = 0; r < NCG; ++r) {
    float s = cell_piece[static_cast<size_t>(r) * KNc + v];
    for (int k = 1; k < n; ++k) s += cell_piece[(static_cast<size_t>(k) * NCG + r) * KNc + v];
    if (r < NH) dzeta[static_cast<size_t>(v) * NH + r] = s;
    else if (r < 2 * NH) dzdphi[static_cast<size_t>(v) * NH + r - NH] = s;
    else if (r == 2 * NH) dcf[v] = s;
    else domega[v] = s;
  }
}

}  // namespace velo
}  // namespace vct
