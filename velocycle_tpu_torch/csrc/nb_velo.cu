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
  double* loss_part;  // (grid,)
  float* gene_part;   // (n_tiles, Ng, Nh + 3 + Nb), FWDGRAD
  float* cell_piece;  // (pieces, 2 Nh + 2, Nc), FWDGRAD
  float* dzeta;       // (Nc, Nh), FWDGRAD
  float* dzdphi;      // (Nc, Nh), FWDGRAD
  float* dcf;         // (Nc,), FWDGRAD
  float* domega;      // (Nc,), FWDGRAD
  cudaStream_t stream;
};

// How one call is laid out on the card.
struct Plan {
  int grid;           // CTAs: loss_part entries
  int pieces;         // most cell-gradient pieces of one tile (0: none)
  int blocks_per_sm;  // resident CTAs per SM (occupancy)
  int dyn_smem;       // dynamic shared memory per CTA, bytes (the ring)
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
    const long long n_units = static_cast<long long>(tiles) * n_chunks;
    const long long slots = static_cast<long long>(sms) * p.blocks_per_sm;
    p.grid = static_cast<int>(n_units < slots ? n_units : slots);
    p.dyn_smem = kRingBytes;
    p.pieces = 0;
    if (CUT == FWDGRAD) {
      for (int t = 0; t < tiles; ++t) {
        const long long first = static_cast<long long>(t) * n_chunks;
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
        a.omega, a.lbeta, a.lgamma, a.disp, a.dnu, a.Db, a.Ng, a.Nc, a.Nb, a.loss_part,
        a.gene_part, a.cell_piece);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || CUT != FWDGRAD) return rc;
    velo_cell_sum_kernel<NH><<<(a.Nc + 255) / 256, 256, 0, a.stream>>>(
        a.cell_piece, a.Ng, a.Nc, p.grid, a.dzeta, a.dzdphi, a.dcf, a.domega);
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
  if (a.cut < 0 || a.cut >= kNumCuts || a.Ng < 1 || a.Nc < 1 || a.Nb < 0 || a.Nb > kMaxNb)
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
    if (p.grid != grid || p.pieces > pieces ||
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

// The plan of one call of `cut` (0: velo_fwd, 1: velo_fwdgrad): out =
// {grid, pieces, blocks_per_sm, dyn_smem}.  The caller sizes loss_part
// (grid,) and, for velo_fwdgrad, cell_piece (pieces, 2 Nh + 2, Nc) from it.
int vct_velo_plan(int cut, int s_int16, int u_int16, int Ng, int Nc, int Nh, int Nb,
                  int skip_k, int want_disp, int* out) {
  Args a{};
  a.cut = cut;
  a.Ng = Ng;
  a.Nc = Nc;
  a.Nh = Nh;
  a.Nb = Nb;
  a.skip_k = skip_k != 0;
  a.want_disp = want_disp != 0;
  Plan p{};
  const int rc = dispatch(a, s_int16 != 0, u_int16 != 0, PlanOp{a, p});
  out[0] = p.grid;
  out[1] = p.pieces;
  out[2] = p.blocks_per_sm;
  out[3] = p.dyn_smem;
  return rc;
}

// Loss only, with the grid of its plan: loss_part (grid,) doubles, summed
// by the caller.  Returns the CUDA error of the launch, or
// cudaErrorInvalidValue for arguments the plan does not match.
int vct_velo_fwd(const void* S, int s_int16, const void* U, int u_int16, const float* nu,
                 const float* zeta, const float* zdphi, const float* cf, const float* omega,
                 const float* lbeta, const float* lgamma, const float* disp, const float* dnu,
                 const float* Db, int Ng, int Nc, int Nh, int Nb, int skip_k, int grid,
                 double* loss_part, void* stream) {
  const Args a{FWD, S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
               Ng, Nc, Nh, Nb, skip_k != 0, false, loss_part, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, s_int16 != 0, u_int16 != 0, RunOp{a, grid, 0});
}

// Loss and all gradients, with the grid and pieces of its plan: loss_part
// (grid,); gene_part (n_tiles, Ng, Nh + 3 + Nb) = [dnu, ddisp, dlog_beta,
// sum_c g_x, ddnu]; dzeta and dzdphi (Nc, Nh), dcf and domega (Nc,), through
// the cell_piece (pieces, 2 Nh + 2, Nc) scratch.
int vct_velo_fwdgrad(const void* S, int s_int16, const void* U, int u_int16, const float* nu,
                     const float* zeta, const float* zdphi, const float* cf,
                     const float* omega, const float* lbeta, const float* lgamma,
                     const float* disp, const float* dnu, const float* Db, int Ng, int Nc,
                     int Nh, int Nb, int skip_k, int want_disp, int grid, int pieces,
                     double* loss_part, float* gene_part, float* cell_piece, float* dzeta,
                     float* dzdphi, float* dcf, float* domega, void* stream) {
  const Args a{FWDGRAD, S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp, dnu, Db,
               Ng, Nc, Nh, Nb, skip_k != 0, want_disp != 0, loss_part, gene_part,
               cell_piece, dzeta, dzdphi, dcf, domega, static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, s_int16 != 0, u_int16 != 0, RunOp{a, grid, pieces});
}

}  // extern "C"
