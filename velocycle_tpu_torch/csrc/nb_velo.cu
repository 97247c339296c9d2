// Velocity-stage Negative-Binomial kernels for Hopper (sm_90a): the C
// interface over the one templated body of velo_kernel.cuh.
//
// Replaces the Pallas TPU kernels `_velo_fwd_kernel` and
// `_velo_fwdgrad_kernel` of `velocycle_tpu/ops/nb_kernels.py`, which compute
//
//   sum_{g,c} NB_logpmf(S[g,c] | ElogS, r[g]) + NB_logpmf(U[g,c] | ElogU, r[g])
//   ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]
//   x     = (nu @ zeta_dphi^T) * omega + exp(log_gamma)
//   ElogU = -log_beta + log(max(x, 0) + 1e-5) + ElogS
//
// and, in the fwd+grad form, its gradients w.r.t. nu (Ng,Nh), zeta and
// zeta_dphi (Nc,Nh), cf and omega (Nc,), log_beta, log_gamma and r (Ng,) and
// delta_nu (Nb,Ng) in ONE pass over both count matrices, with no (Ng, Nc)
// intermediate in device memory.
//
// What bounds it on the H100: the per-element special-function arithmetic
// of two NB terms and the log(xr) chain, not the S+U stream (0.84 GB at
// 2048 x 102400 int16, 0.25 ms at 3.35 TB/s), unless the count loads are
// left exposed.  velo_kernel.cuh says what the layout does about both: an
// even split over a persistent grid, and S and U staged ahead of the
// arithmetic in a cp.async ring.
//
// A launch may carry K parameter sets over the same S and U (the chains
// of an MCMC batch or the particles of an SMC stage: `ChainStrides`,
// nb_common.cuh): the layout, the instantiations and the fixed-order sums
// are those of K = 1, which is the unbatched launch bit for bit.
//
// S and U each have their own count type (int16 or float32): all four pairs
// are instantiated, so a dataset that compacts only one matrix to int16
// runs without a converted copy of the other.  Basis widths: Nh in {3, 5,
// 7} with up to kMaxNb delta_nu batches, and 11 and 16 without; the Python
// wrapper pads any other Nh with zero columns to the next width and folds
// more batches into extra columns (ops/nb_kernels.py, `kernel_width`).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_velo.so nb_velo.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"
#include "velo_kernel.cuh"

namespace {

using namespace vct::velo;
using vct::ChainStrides;
using vct::unit_owner;

struct Args {
  int cut;            // a Cut
  const void* S;      // (Ng, Nc) int16 or float32
  const void* U;      // (Ng, Nc) int16 or float32
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
  bool skip_k, want_disp;
  ChainStrides cs;    // the chain batch: K, loss pieces, parameter strides
  double* loss_part;  // (K, loss_pieces)
  float* gene_part;   // (K, n_tiles, Ng, Nh + 3 + Nb), FWDGRAD
  float* cell_piece;  // (pieces, 2 Nh + 2, K * Nc), FWDGRAD
  float* dzeta;       // (K, Nc, Nh), FWDGRAD
  float* dzdphi;      // (K, Nc, Nh), FWDGRAD
  float* dcf;         // (K, Nc), FWDGRAD
  float* domega;      // (K, Nc), FWDGRAD
  cudaStream_t stream;
};

// How one call is laid out on the card.
struct Plan {
  int grid;           // CTAs
  int pieces;         // most cell-gradient pieces of one tile (0: none)
  int blocks_per_sm;  // resident CTAs per SM (occupancy)
  int dyn_smem;       // dynamic shared memory per CTA, bytes (the ring)
  int loss_pieces;    // most CTAs that carry units of one chain
};

template <typename TS, typename TU, int NH, int CUT, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
struct Inst {
  static constexpr int kCut = CUT;
  static constexpr int kRingBytes = kStages * stage_bytes<TS, TU, NH, HAS_DNU>();

  static auto kernel() {
    return velo_kernel<TS, TU, NH, CUT, WANT_DISP, HAS_DNU, SKIP_K>;
  }

  // The ring's size as the launch limit (required above 48 KB), and as much
  // of the SM's memory for shared memory as it offers, so that the
  // occupancy the plan counts on is the one the launch gets.  Once per
  // instantiation and process.
  static int set_attributes() {
    static const int rc = [] {
      cudaError_t e = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel(), cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      return static_cast<int>(e);
    }();
    return rc;
  }

  // A persistent grid: every CTA the card holds at once, at most one per
  // unit; pieces, the most CTAs that share one tile.
  static int plan(const Args& a, Plan& p) {
    int rc = set_attributes();
    int dev = 0, sms = 0;
    if (rc == 0) rc = static_cast<int>(cudaGetDevice(&dev));
    if (rc == 0)
      rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &p.blocks_per_sm, kernel(), kThreads, kRingBytes));
    if (rc != 0) return rc;
    if (p.blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int n_chunks = (a.Ng + kGeneChunk - 1) / kGeneChunk;
    const int tiles = (a.Nc + kCellsPerTile - 1) / kCellsPerTile;
    const long long UC = static_cast<long long>(tiles) * n_chunks;
    const long long n_units = UC * a.cs.K;
    const long long slots = static_cast<long long>(sms) * p.blocks_per_sm;
    p.grid = static_cast<int>(n_units < slots ? n_units : slots);
    p.dyn_smem = kRingBytes;
    p.pieces = 0;
    p.loss_pieces = 0;
    for (int c = 0; c < a.cs.K; ++c) {
      const int n = unit_owner((c + 1) * UC - 1, n_units, p.grid) -
                    unit_owner(c * UC, n_units, p.grid) + 1;
      if (n > p.loss_pieces) p.loss_pieces = n;
    }
    if (CUT == FWDGRAD) {
      for (long long t = 0; t < static_cast<long long>(tiles) * a.cs.K; ++t) {
        const long long first = t * n_chunks;
        const int n = unit_owner(first + n_chunks - 1, n_units, p.grid) -
                      unit_owner(first, n_units, p.grid) + 1;
        if (n > p.pieces) p.pieces = n;
      }
    }
    return 0;
  }

  static int run(const Args& a, const Plan& p) {
    velo_kernel<TS, TU, NH, CUT, WANT_DISP, HAS_DNU, SKIP_K>
        <<<p.grid, kThreads, p.dyn_smem, a.stream>>>(
        static_cast<const TS*>(a.S), static_cast<const TU*>(a.U), a.nu, a.zeta, a.zdphi, a.cf,
        a.omega, a.lbeta, a.lgamma, a.disp, a.dnu, a.Db, a.Ng, a.Nc, a.Nb, a.cs, a.loss_part,
        a.gene_part, a.cell_piece);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || CUT != FWDGRAD) return rc;
    const long long KNc = static_cast<long long>(a.cs.K) * a.Nc;
    velo_cell_sum_kernel<NH><<<static_cast<int>((KNc + 255) / 256), 256, 0, a.stream>>>(
        a.cell_piece, a.Ng, a.Nc, a.cs.K, p.grid, a.dzeta, a.dzdphi, a.dcf, a.domega);
    return static_cast<int>(cudaGetLastError());
  }
};

// Calls op.template go<Inst<...>>() for the instantiation the arguments
// select: S and U each int16 or float32; Nh in {3, 5, 7} with up to kMaxNb
// batches, or 11 and 16 without; the loss-only cut, or the fwd+grad cut
// with or without the dispersion gradient; lgamma(k + 1) skipped or not.
template <typename TS, typename TU, int NH, int CUT, bool WD, bool DNU, class Op>
int pick_skip(const Args& a, const Op& op) {
  return a.skip_k ? op.template go<Inst<TS, TU, NH, CUT, WD, DNU, true>>()
                  : op.template go<Inst<TS, TU, NH, CUT, WD, DNU, false>>();
}

template <typename TS, typename TU, int NH, int CUT, bool WD, class Op>
int pick_dnu(const Args& a, const Op& op) {
  if constexpr (NH <= vct::kMaxDnuWidth) {
    if (a.Nb > 0) return pick_skip<TS, TU, NH, CUT, WD, true>(a, op);
  } else {
    if (a.Nb > 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  return pick_skip<TS, TU, NH, CUT, WD, false>(a, op);
}

template <typename TS, typename TU, int NH, class Op>
int pick_cut(const Args& a, const Op& op) {
  if (a.cut == FWD) return pick_dnu<TS, TU, NH, FWD, false>(a, op);
  if (a.want_disp) return pick_dnu<TS, TU, NH, FWDGRAD, true>(a, op);
  return pick_dnu<TS, TU, NH, FWDGRAD, false>(a, op);
}

template <typename TS, typename TU, class Op>
int pick_nh(const Args& a, const Op& op) {
  switch (a.Nh) {
    case 3: return pick_cut<TS, TU, 3>(a, op);
    case 5: return pick_cut<TS, TU, 5>(a, op);
    case 7: return pick_cut<TS, TU, 7>(a, op);
    case 11: return pick_cut<TS, TU, 11>(a, op);
    case 16: return pick_cut<TS, TU, 16>(a, op);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TS, class Op>
int pick_u(const Args& a, bool u_int16, const Op& op) {
  return u_int16 ? pick_nh<TS, int16_t>(a, op) : pick_nh<TS, float>(a, op);
}

template <class Op>
int dispatch(const Args& a, bool s_int16, bool u_int16, const Op& op) {
  if (a.cut < 0 || a.cut >= kNumCuts || a.Ng < 1 || a.Nc < 1 || a.Nb < 0 || a.Nb > kMaxNb ||
      a.cs.K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return s_int16 ? pick_u<int16_t>(a, u_int16, op) : pick_u<float>(a, u_int16, op);
}

struct PlanOp {
  const Args& a;
  Plan& p;
  template <class K> int go() const { return K::plan(a, p); }
};

struct RunOp {
  const Args& a;
  int grid, pieces;
  template <class K> int go() const {
    Plan p;
    const int rc = K::plan(a, p);
    if (rc != 0) return rc;
    // the caller's buffers were sized from vct_velo_plan
    if (p.grid != grid || p.pieces > pieces || p.loss_pieces != a.cs.loss_pieces ||
        (K::kCut == FWDGRAD && (a.gene_part == nullptr || a.cell_piece == nullptr ||
                                a.dzeta == nullptr || a.dzdphi == nullptr ||
                                a.dcf == nullptr || a.domega == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return K::run(a, p);
  }
};

}  // namespace

extern "C" {

// The layout constants: {threads per CTA, cells per tile, genes per chunk,
// ring stages, max batches}.  Returns how many it wrote.
int vct_velo_layout(int* out, int n) {
  const int v[] = {kThreads, kCellsPerTile, kGeneChunk, kStages, kMaxNb};
  int i = 0;
  for (; i < n && i < 5; ++i) out[i] = v[i];
  return i;
}

// The plan of one call of `cut` (0: velo_fwd, 1: velo_fwdgrad) over K
// chains (K = 1: unbatched): out = {grid, pieces, blocks_per_sm, dyn_smem,
// loss_pieces}.  The caller sizes loss_part (K, loss_pieces) and, for
// velo_fwdgrad, cell_piece (pieces, 2 Nh + 2, K * Nc) from it.
int vct_velo_plan(int cut, int s_int16, int u_int16, int Ng, int Nc, int Nh, int Nb, int K,
                  int skip_k, int want_disp, int* out) {
  Args a{};
  a.cut = cut;
  a.Ng = Ng;
  a.Nc = Nc;
  a.Nh = Nh;
  a.Nb = Nb;
  a.skip_k = skip_k != 0;
  a.want_disp = want_disp != 0;
  a.cs.K = K;
  Plan p{};
  const int rc = dispatch(a, s_int16 != 0, u_int16 != 0, PlanOp{a, p});
  out[0] = p.grid;
  out[1] = p.pieces;
  out[2] = p.blocks_per_sm;
  out[3] = p.dyn_smem;
  out[4] = p.loss_pieces;
  return rc;
}

// Both entry points take K parameter sets over the same S, U and Db: chain
// c reads nu + c * st_nu, zeta + c * st_zeta, zeta_dphi + c * st_zdphi, cf
// + c * st_cf, omega + c * st_omega, log_beta + c * st_lbeta, log_gamma + c
// * st_lgamma, disp + c * st_disp and dnu + c * st_dnu (strides in floats,
// 0 for an operand the chains share).  They return the CUDA error of the
// launches, or cudaErrorInvalidValue for arguments or buffers the plan
// does not match.

// Loss only, with the grid and loss pieces of its plan: loss_part (K,
// loss_pieces) doubles, zero where a chain has fewer pieces, summed by the
// caller.
int vct_velo_fwd(const void* S, int s_int16, const void* U, int u_int16, const float* nu,
                 const float* zeta, const float* zdphi, const float* cf, const float* omega,
                 const float* lbeta, const float* lgamma, const float* disp, const float* dnu,
                 const float* Db, int Ng, int Nc, int Nh, int Nb, int K, long long st_nu,
                 long long st_zeta, long long st_zdphi, long long st_cf, long long st_omega,
                 long long st_lbeta, long long st_lgamma, long long st_disp, long long st_dnu,
                 int skip_k, int grid, int loss_pieces, double* loss_part, void* stream) {
  const Args a{FWD, S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
               Ng, Nc, Nh, Nb, skip_k != 0, false,
               ChainStrides{K, loss_pieces, st_nu, st_zeta, st_zdphi, st_cf, st_omega,
                            st_lbeta, st_lgamma, st_disp, st_dnu},
               loss_part, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, s_int16 != 0, u_int16 != 0, RunOp{a, grid, 0});
}

// Loss and all gradients, with the grid, pieces and loss pieces of its
// plan: loss_part (K, loss_pieces); gene_part (K, n_tiles, Ng, Nh + 3 + Nb)
// = [dnu, ddisp, dlog_beta, sum_c g_x, ddnu]; dzeta and dzdphi (K, Nc,
// Nh), dcf and domega (K, Nc), through the cell_piece (pieces, 2 Nh + 2, K
// * Nc) scratch.
int vct_velo_fwdgrad(const void* S, int s_int16, const void* U, int u_int16, const float* nu,
                     const float* zeta, const float* zdphi, const float* cf,
                     const float* omega, const float* lbeta, const float* lgamma,
                     const float* disp, const float* dnu, const float* Db, int Ng, int Nc,
                     int Nh, int Nb, int K, long long st_nu, long long st_zeta,
                     long long st_zdphi, long long st_cf, long long st_omega,
                     long long st_lbeta, long long st_lgamma, long long st_disp,
                     long long st_dnu, int skip_k, int want_disp, int grid, int pieces,
                     int loss_pieces, double* loss_part, float* gene_part, float* cell_piece,
                     float* dzeta, float* dzdphi, float* dcf, float* domega, void* stream) {
  const Args a{FWDGRAD, S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
               Ng, Nc, Nh, Nb, skip_k != 0, want_disp != 0,
               ChainStrides{K, loss_pieces, st_nu, st_zeta, st_zdphi, st_cf, st_omega,
                            st_lbeta, st_lgamma, st_disp, st_dnu},
               loss_part, gene_part, cell_piece, dzeta, dzdphi, dcf, domega,
               static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, s_int16 != 0, u_int16 != 0, RunOp{a, grid, pieces});
}

}  // extern "C"
