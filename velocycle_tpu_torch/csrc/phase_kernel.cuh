// The one body of the phase-stage NB kernels for Hopper (sm_90a):
// `phase_fwd`, `phase_fwdgrad`, and the eight rungs of the roofline ladder,
// each a compile-time cut of the same template (`Cut`), in the same launch
// layout, on the same device functions (nb_common.cuh).  nb_phase.cu
// instantiates it and exports the C interface.
//
// Layout.  The work is cut into units: one tile of kCellsPerTile cells
// (kCellsPerThread per thread, each cell's zeta, cf, Db column and cell
// gradients in registers) by one chunk of kGeneChunk genes.  A persistent
// grid of as many CTAs as the card holds at once (SM count x resident CTAs
// per SM, from the occupancy calculator) splits the units, tile-major, into
// contiguous runs that differ by at most one unit, so every SM carries the
// same work.  A CTA whose run crosses a tile boundary writes that tile's
// cell gradients as one piece; `cell_sum_kernel` adds a tile's pieces in
// CTA order.  Two cells per thread share each gene's staged columns, nu
// and warp reduction between two elements and give two independent
// element chains; on the H100 that beat one cell per thread with more
// warps resident (PERF.md, the layout sweep).
//
// Chains.  A launch may carry K parameter sets over the same counts (the
// chains of an MCMC batch: `ChainStrides`, nb_common.cuh).  The units are
// then chain-major, K x tiles x chunks, and the persistent grid splits all
// of them evenly, so a CTA's run may cross from one chain into the next.
// Gene partials and cell-gradient pieces are indexed by the tile counted
// over all chains, and the loss goes to per-(chain, CTA) doubles, flushed
// when the run crosses a chain boundary.  At K = 1 every index and every
// sum is the unbatched launch's: the same bits.
//
// Counts reach the arithmetic through a ring of kStages shared-memory
// stages: while unit i is computed, units i+1 .. i+kStages-1 are in flight
// as 16-byte `cp.async` copies (neighbouring threads on neighbouring
// addresses, completion by commit/wait groups), with the unit's nu,
// dispersion and delta_nu rows as 4-byte copies in the same group.  A row
// segment of S starts wherever g * Nc + c0 puts it, so each stage row holds
// the 16-byte-aligned window around the segment and the element loop reads
// at the segment's offset in it: no padded copy of S, any Nc.  The piece
// below a misaligned matrix start is copied element by element, and the
// piece past the matrix end is zero-filled by the copy itself.
//
// Fixed-order sums and no float atomics: gene-indexed sums go through a
// warp reduce-scatter and the CTA's warps into per-tile partials (n_tiles,
// Ng, NV) that the caller sums over tiles; the loss into per-CTA doubles;
// the cell gradients through the pieces.  Repeats are bit-identical.
//
// The layout constants below are their only definition: the Python
// wrappers read them back from the library (vct_phase_layout), and on the
// CPU from this file.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"

namespace vct {
namespace phase {

constexpr int kThreads = 128;
constexpr int kCellsPerThread = 2;
constexpr int kCellsPerTile = 256;
constexpr int kGeneChunk = 16;
constexpr int kStages = 3;
constexpr int kMaxNb = 4;
constexpr int kMinBlocksPerSm = 5;   // caps registers at 102 per thread
constexpr int kWarps = kThreads / 32;
static_assert(kCellsPerTile == kThreads * kCellsPerThread, "whole cells per thread");
static_assert(kCellsPerTile * 2 % 16 == 0, "a tile row is whole 16-byte pieces");

// What one instantiation computes.  FWD and FWDGRAD are the production
// kernels; the rest are the ladder's rungs (ops/ladder_kernels.py MODES maps
// each rung to one; v_full is FWDGRAD itself):
//   STREAM    sum float(S) + n_rep * sum(nu): the count stream alone,
//             through the ring
//   MATMUL    sum S * (nu @ zeta^T)
//   LOGPMF    sum NB_logpmf(S | nu @ zeta^T, r): FWD without cf
//   GRAD_NU   LOGPMF's loss in the fwd+grad form + dnu: no digamma chain,
//             no cf, no cell gradients, no ddisp slot
//   V_NODIG   FWDGRAD without the digamma chain; the ddisp slot holds
//             sum_c g_elog
//   V_NOCELL  FWDGRAD without the cell gradients (dzeta, dcf)
//   VPU_ONLY  sum NB_logpmf(floor(3 |elog|) | elog, r), elog = nu @ zeta^T:
//             the arithmetic with no count read
enum Cut : int { FWD, FWDGRAD, STREAM, MATMUL, LOGPMF, GRAD_NU, V_NODIG, V_NOCELL,
                 VPU_ONLY, kNumCuts };

template <int CUT>
struct Flags {
  static constexpr bool reads_s = CUT != VPU_ONLY;
  static constexpr bool elog = CUT != STREAM;
  static constexpr bool cols = CUT != STREAM && CUT != MATMUL;
  static constexpr bool grad = CUT == FWDGRAD || CUT == GRAD_NU || CUT == V_NODIG ||
                               CUT == V_NOCELL;
  static constexpr bool has_cf = CUT == FWD || CUT == FWDGRAD || CUT == V_NODIG ||
                                 CUT == V_NOCELL;
  static constexpr bool cell_grads = CUT == FWDGRAD || CUT == V_NODIG;
  // gene partial columns besides ddelta_nu: dnu, then the ddisp slot
  __host__ __device__ static constexpr int nv(int nh) {
    return grad ? (CUT == GRAD_NU ? nh : nh + 1) : 0;
  }
};

// One ring stage: kGeneChunk rows of counts, each the tile's cells plus up
// to 15 bytes of misaligned head, then the unit's nu (kGeneChunk x NH),
// dispersion (kGeneChunk) and delta_nu (kMaxNb x kGeneChunk) floats.
template <typename TK>
__host__ __device__ constexpr int row_bytes() {
  return kCellsPerTile * static_cast<int>(sizeof(TK)) + 16;
}

template <typename TK, int NH, bool HAS_DNU>
__host__ __device__ constexpr int stage_bytes() {
  return kGeneChunk * row_bytes<TK>() +
         (kGeneChunk * (NH + 1 + (HAS_DNU ? kMaxNb : 0)) * 4 + 15) / 16 * 16;
}

template <typename TK, int NH, int CUT, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
phase_kernel(const TK* __restrict__ S, const float* __restrict__ nu,
             const float* __restrict__ zeta, const float* __restrict__ cf,
             const float* __restrict__ disp, const float* __restrict__ dnu,
             const float* __restrict__ Db, int Ng, int Nc, int Nb, int n_rep,
             ChainStrides cs, double* __restrict__ loss_part,
             float* __restrict__ gene_part, float* __restrict__ cell_piece) {
  using F = Flags<CUT>;
  constexpr int NB_SLOTS = HAS_DNU ? kMaxNb : 1;
  constexpr int NVC = F::nv(NH) + (HAS_DNU ? kMaxNb : 0);  // values reduced per gene
  constexpr int P = pow2_at_least(NVC > 0 ? NVC : 1);
  constexpr int SPAN = 32 / P;
  constexpr bool DISP_SUM = WANT_DISP || CUT == V_NODIG;
  constexpr int ROW = row_bytes<TK>();
  constexpr int STAGE = stage_bytes<TK, NH, HAS_DNU>();
  constexpr int PRM = kGeneChunk * ROW;            // offset of the floats in a stage
  constexpr int PRM_DISP = kGeneChunk * NH;        // ... of the dispersions in them
  constexpr int PRM_DNU = kGeneChunk * (NH + 1);   // ... of delta_nu
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ GeneCols s_cols[F::cols ? kGeneChunk : 1];
  __shared__ float s_red[F::grad ? kGeneChunk : 1][F::grad ? NVC : 1][kWarps];
  __shared__ double s_loss[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = HAS_DNU ? Nb : 0;
  const int NV = F::nv(NH) + nb;
  const int n_chunks = (Ng + kGeneChunk - 1) / kGeneChunk;
  const int tiles = (Nc + kCellsPerTile - 1) / kCellsPerTile;
  const long long UC = static_cast<long long>(tiles) * n_chunks;  // units of one chain
  const long long U = UC * cs.K;
  const long long u0 = static_cast<long long>(blockIdx.x) * U / gridDim.x;
  const long long u1 = static_cast<long long>(blockIdx.x + 1) * U / gridDim.x;
  const char* s_begin = reinterpret_cast<const char*>(S);
  const char* s_end = s_begin + static_cast<size_t>(Ng) * Nc * sizeof(TK);
  const unsigned s_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(S) & 15u);

  // start the copies of unit u into ring stage `slot`
  auto issue = [&](long long u, int slot) {
    unsigned char* st = ring + slot * STAGE;
    const int gt = static_cast<int>(u / n_chunks);
    const int ch = gt / tiles;
    const int t = gt - ch * tiles;
    const int g0 = static_cast<int>(u - static_cast<long long>(gt) * n_chunks) * kGeneChunk;
    const int gn = min(kGeneChunk, Ng - g0);
    if constexpr (F::reads_s) {
      constexpr int Q = ROW / 16;
      const int c0 = t * kCellsPerTile;
      const int seg = min(kCellsPerTile, Nc - c0) * static_cast<int>(sizeof(TK));
      for (int i = tid; i < gn * Q; i += kThreads) {
        const int r = i / Q;
        const int q = i - r * Q;
        const char* a = s_begin + (static_cast<size_t>(g0 + r) * Nc + c0) * sizeof(TK);
        const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15u);
        if (q * 16 >= lead + seg) continue;
        const char* src = a - lead + 16 * q;
        unsigned char* dst = st + r * ROW + 16 * q;
        if (src < s_begin) {  // below a misaligned matrix start: element copies
          for (const char* b = s_begin; b < src + 16 && b < s_end; b += sizeof(TK))
            *reinterpret_cast<TK*>(dst + (b - src)) = *reinterpret_cast<const TK*>(b);
        } else {
          const long long left = s_end - src;
          cp_async16(dst, src, left < 16 ? static_cast<int>(left) : 16);
        }
      }
    }
    float* prm = reinterpret_cast<float*>(st + PRM);
    const float* nu_c = nu + ch * cs.nu;
    for (int i = tid; i < gn * NH; i += kThreads)
      cp_async4(prm + i, nu_c + static_cast<size_t>(g0) * NH + i);
    // each dispersion is copied by the thread that turns it into columns
    if (F::cols && tid < gn) cp_async4(prm + PRM_DISP + tid, disp + ch * cs.disp + g0 + tid);
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
  float z[C][NH];
  float cfv[C];
  float db[C][NB_SLOTS];
  float dz[C][NH];
  float dc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    cell[i] = 0;
    valid[i] = false;
    cfv[i] = dc[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < NH; ++h) z[i][h] = dz[i][h] = 0.0f;
#pragma unroll
    for (int b = 0; b < NB_SLOTS; ++b) db[i][b] = 0.0f;
  }

  // this CTA's piece of a tile's cell gradients, in CTA order; the pieces
  // are (pieces, NH + 1, K * Nc), the chains' cells side by side
  auto flush = [&](int gt) {
    const int k = static_cast<int>(blockIdx.x) -
                  unit_owner(static_cast<long long>(gt) * n_chunks, U, gridDim.x);
    const size_t c0 = static_cast<size_t>(gt / tiles) * Nc;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (!valid[i]) continue;
      float* out = cell_piece + static_cast<size_t>(k) * (NH + 1) * KNc + c0 + cell[i];
#pragma unroll
      for (int h = 0; h < NH; ++h) out[static_cast<size_t>(h) * KNc] = dz[i][h];
      out[static_cast<size_t>(NH) * KNc] = dc[i];
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
      const int k = static_cast<int>(blockIdx.x) - unit_owner(chain * UC, U, gridDim.x);
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
    if (F::cols && tid < gn) s_cols[tid] = gene_cols(prm[PRM_DISP + tid]);
    __syncthreads();  // the stage and the columns are in place for every thread

    if (gt != tile) {
      if (F::cell_grads && tile >= 0) flush(tile);
      tile = gt;
      const float* zeta_c = zeta + chain * cs.zeta;
      const float* cf_c = cf + chain * cs.cf;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        cell[i] = t * kCellsPerTile + i * kThreads + tid;
        valid[i] = cell[i] < Nc;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          z[i][h] = (F::elog && valid[i]) ? zeta_c[static_cast<size_t>(cell[i]) * NH + h] : 0.0f;
          dz[i][h] = 0.0f;
        }
        cfv[i] = (F::has_cf && valid[i]) ? cf_c[cell[i]] : 0.0f;
        dc[i] = 0.0f;
#pragma unroll
        for (int b = 0; b < NB_SLOTS; ++b)
          db[i][b] = (HAS_DNU && b < nb && valid[i])
                         ? Db[static_cast<size_t>(b) * Nc + cell[i]] : 0.0f;
      }
    }
    if (CUT == STREAM && t == 0) {
      for (int j = tid; j < gn * NH; j += kThreads) loss += static_cast<double>(n_rep) * prm[j];
    }

    // byte offset of (g0, this tile's first cell) in S, for the rows' heads
    const size_t row0 = (static_cast<size_t>(g0) * Nc + static_cast<size_t>(t) * kCellsPerTile) *
                        sizeof(TK) + s_mis;
    float chunk_loss = 0.0f;
    for (int gl = 0; gl < gn; ++gl) {
      const unsigned char* row =
          st + gl * ROW + ((row0 + static_cast<size_t>(gl) * Nc * sizeof(TK)) & 15u);
      float nuv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) nuv[h] = prm[gl * NH + h];
      float dnv[NB_SLOTS];
#pragma unroll
      for (int b = 0; b < NB_SLOTS; ++b)
        dnv[b] = (HAS_DNU && b < nb) ? prm[PRM_DNU + b * kGeneChunk + gl] : 0.0f;
      const GeneCols c = F::cols ? s_cols[gl] : GeneCols{};
      float v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = 0.0f;

#pragma unroll
      for (int i = 0; i < C; ++i) {
        float k = 0.0f;
        if constexpr (F::reads_s) {
          if (valid[i])
            k = static_cast<float>(
                *reinterpret_cast<const TK*>(row + (i * kThreads + tid) * sizeof(TK)));
        }
        if constexpr (CUT == STREAM) {
          chunk_loss += k;
          continue;
        }
        float dot = 0.0f;
#pragma unroll
        for (int h = 0; h < NH; ++h) dot += nuv[h] * z[i][h];
        float elog = F::has_cf ? dot + cfv[i] : dot;
        if (HAS_DNU) {
          float off = 0.0f;
#pragma unroll
          for (int b = 0; b < NB_SLOTS; ++b)
            if (b < nb) off += dnv[b] * db[i][b];
          elog += off;
        }
        if constexpr (CUT == MATMUL) {
          chunk_loss += k * elog;
        } else if constexpr (!F::grad) {
          if constexpr (CUT == VPU_ONLY) k = floorf(fabsf(elog) * 3.0f);
          const float lp = nb_lp<SKIP_K>(k, -c.log_r - elog, c);
          chunk_loss += valid[i] ? lp : 0.0f;
        } else {
          float lp, g_elog, g_r;
          nb_lp_grads<WANT_DISP, SKIP_K>(k, -c.log_r - elog, c, lp, g_elog, g_r);
          if (!valid[i]) {
            lp = 0.0f;
            g_elog = 0.0f;
            g_r = 0.0f;
          }
          chunk_loss += lp;
          // this thread's share of the gene-indexed sums, over its cells
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            if (F::cell_grads) dz[i][h] += g_elog * nuv[h];
            v[h] += g_elog * z[i][h];
          }
          if (F::cell_grads) dc[i] += g_elog;
          if constexpr (F::nv(NH) > NH) v[NH] += DISP_SUM ? (CUT == V_NODIG ? g_elog : g_r) : 0.0f;
          if constexpr (HAS_DNU) {
#pragma unroll
            for (int b = 0; b < NB_SLOTS; ++b)
              if (b < nb) v[F::nv(NH) + b] += g_elog * db[i][b];
          }
        }
      }
      if constexpr (F::grad) {
        warp_reduce_scatter<P>(v, lane);
        if (lane % SPAN == 0 && lane / SPAN < NVC) s_red[gl][lane / SPAN][warp] = v[0];
      }
    }
    loss += static_cast<double>(chunk_loss);
    __syncthreads();  // the stage is free for refilling; s_red is complete

    if constexpr (F::grad) {
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
  if (F::cell_grads && tile >= 0) flush(tile);
  cp_async_wait<0>();
  flush_loss();
}

// dzeta (K, Nc, NH) and dcf (K, Nc) from the pieces (pieces, NH + 1, K * Nc):
// each tile's pieces added in the order of the CTAs that wrote them.
template <int NH>
__global__ void cell_sum_kernel(const float* __restrict__ cell_piece, int Ng, int Nc, int K,
                                int grid, float* __restrict__ dzeta, float* __restrict__ dcf) {
  const long long KNc = static_cast<long long>(K) * Nc;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= KNc) return;
  const int ch = static_cast<int>(v / Nc);
  const int c = static_cast<int>(v - static_cast<long long>(ch) * Nc);
  const int n_chunks = (Ng + kGeneChunk - 1) / kGeneChunk;
  const int tiles = (Nc + kCellsPerTile - 1) / kCellsPerTile;
  const long long U = static_cast<long long>(K) * tiles * n_chunks;
  const long long first = (static_cast<long long>(ch) * tiles + c / kCellsPerTile) * n_chunks;
  const int n = unit_owner(first + n_chunks - 1, U, grid) - unit_owner(first, U, grid) + 1;
#pragma unroll
  for (int h = 0; h <= NH; ++h) {
    float s = cell_piece[static_cast<size_t>(h) * KNc + v];
    for (int k = 1; k < n; ++k) s += cell_piece[(static_cast<size_t>(k) * (NH + 1) + h) * KNc + v];
    if (h < NH) dzeta[static_cast<size_t>(v) * NH + h] = s;
    else dcf[v] = s;
  }
}

}  // namespace phase
}  // namespace vct
