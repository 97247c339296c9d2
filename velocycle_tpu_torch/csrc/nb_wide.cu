// Wide-basis Negative-Binomial kernels of both stages for Hopper (sm_90a):
// the C interface over the one body of wide_kernel.cuh, for basis widths the
// narrow bodies are not instantiated for (more than 16 columns, delta_nu
// batches folded in), any width.
//
// Replaces, at those widths, the Pallas TPU kernels `_phase_fwd_kernel`,
// `_phase_fwdgrad_kernel`, `_velo_fwd_kernel` and `_velo_fwdgrad_kernel` of
// `velocycle_tpu/ops/nb_kernels.py`, whose block specs take any basis width
// (the same functions as nb_phase.cu and nb_velo.cu compute).  The basis
// width W and whether lgamma(k + 1) is skipped are runtime values; the
// stage, the cut, the dispersion gradient and the count types are template
// parameters: 14 phase and 28 velocity instantiations, the per-pass timing
// cuts included.
//
// What bounds it on the H100 and what the layout does about it:
// wide_kernel.cuh.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_wide.so nb_wide.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"
#include "wide_kernel.cuh"

namespace {

using namespace vct::wide;
using vct::ChainStrides;
using vct::unit_owner;

struct Args {
  int stage, cut;     // a Stage and a Cut
  const void* S;      // (Ng, Nc) int16 or float32
  const void* U;      // (Ng, Nc) int16 or float32; velocity only
  const float *nu, *zeta, *zdphi, *cf, *omega, *lbeta, *lgamma, *disp;
  int Ng, Nc, W;
  bool skip_k, want_disp;
  ChainStrides cs;
  double* loss_part;  // (K, loss_pieces)
  float* gene_part;   // (K * tiles, Ng, gene_values), FWDGRAD
  float* cell_piece;  // (pieces, cell_rows, K * Nc), FWDGRAD
  float *dzeta, *dzdphi, *dcf, *domega;   // FWDGRAD; dzdphi, domega velocity only
  cudaStream_t stream;
};

struct Plan {
  int grid;           // CTAs
  int pieces;         // most cell-gradient pieces of one (tile, sweep) (0: none)
  int blocks_per_sm;  // resident CTAs per SM (occupancy)
  int dyn_smem;       // dynamic shared memory per CTA, bytes
  int loss_pieces;    // most CTAs that carry units of one chain
  Shape shape;        // resident columns, sweeps, chunked pass A
};

template <int STAGE, typename TS, typename TU, int CUT, bool WD>
struct Inst {
  static auto kernel() { return wide_kernel<STAGE, TS, TU, CUT, WD>; }

  static int plan(const Args& a, Plan& p) {
    constexpr int u_bytes = STAGE == VELO ? static_cast<int>(sizeof(TU)) : 0;
    p.shape = plan_shape(STAGE, CUT, a.W, sizeof(TS), u_bytes);
    const int bytes = smem_layout(STAGE, CUT, p.shape.Wz, p.shape.chunked, sizeof(TS), u_bytes).total;
    int dev = 0, sms = 0, optin = 0;
    int rc = static_cast<int>(cudaGetDevice(&dev));
    if (rc == 0)
      rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0)
      rc = static_cast<int>(
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    if (rc != 0) return rc;
    if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
    // this width's shared memory as the launch limit (required above 48
    // KB), and as much of the SM's memory for shared memory as it offers
    rc = static_cast<int>(
        cudaFuncSetAttribute(kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (rc == 0)
      rc = static_cast<int>(cudaFuncSetAttribute(
          kernel(), cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
    if (rc == 0)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &p.blocks_per_sm, kernel(), kThreads, bytes));
    if (rc != 0) return rc;
    if (p.blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int n_chunks = (a.Ng + kGeneChunk - 1) / kGeneChunk;
    const int pairs = (a.Nc + kCellsPerTile - 1) / kCellsPerTile * p.shape.sweeps;
    const long long UC = static_cast<long long>(pairs) * n_chunks;
    const long long n_units = UC * a.cs.K;
    const long long slots = static_cast<long long>(sms) * p.blocks_per_sm;
    p.grid = static_cast<int>(n_units < slots ? n_units : slots);
    p.dyn_smem = bytes;
    p.pieces = 0;
    p.loss_pieces = 0;
    for (int c = 0; c < a.cs.K; ++c) {
      const int n = unit_owner((c + 1) * UC - 1, n_units, p.grid) -
                    unit_owner(c * UC, n_units, p.grid) + 1;
      if (n > p.loss_pieces) p.loss_pieces = n;
    }
    if (CUT == FWDGRAD) {   // the timing cuts write no cell pieces
      for (long long t = 0; t < static_cast<long long>(pairs) * a.cs.K; ++t) {
        const long long first = t * n_chunks;
        const int n = unit_owner(first + n_chunks - 1, n_units, p.grid) -
                      unit_owner(first, n_units, p.grid) + 1;
        if (n > p.pieces) p.pieces = n;
      }
    }
    return 0;
  }

  static int run(const Args& a, const Plan& p) {
    wide_kernel<STAGE, TS, TU, CUT, WD><<<p.grid, kThreads, p.dyn_smem, a.stream>>>(
        static_cast<const TS*>(a.S), static_cast<const TU*>(a.U), a.nu, a.zeta, a.zdphi, a.cf,
        a.omega, a.lbeta, a.lgamma, a.disp, a.Ng, a.Nc, a.W, p.shape.Wz, p.shape.sweeps,
        p.shape.chunked ? 1 : 0, a.skip_k ? 1 : 0, a.cs, a.loss_part, a.gene_part, a.cell_piece);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || CUT != FWDGRAD) return rc;
    const long long KNc = static_cast<long long>(a.cs.K) * a.Nc;
    wide_cell_sum_kernel<STAGE><<<static_cast<int>((KNc + 255) / 256), 256, 0, a.stream>>>(
        a.cell_piece, a.Ng, a.Nc, a.cs.K, a.W, p.shape.Wz, p.shape.sweeps, p.grid, a.dzeta,
        a.dzdphi, a.dcf, a.domega);
    return static_cast<int>(cudaGetLastError());
  }
};

// Calls op.template go<Inst<...>>() for the instantiation the arguments
// select: the stage; S (and U) int16 or float32; the loss-only cut, or the
// fwd+grad cut (and its timing cuts) with or without the dispersion
// gradient.
template <int STAGE, typename TS, typename TU, class Op>
int pick_cut(const Args& a, const Op& op) {
  if (a.cut == FWD) return op.template go<Inst<STAGE, TS, TU, FWD, false>>();
  if (a.cut == PASS_A)
    return a.want_disp ? op.template go<Inst<STAGE, TS, TU, PASS_A, true>>()
                       : op.template go<Inst<STAGE, TS, TU, PASS_A, false>>();
  if (a.cut == PASS_AB)
    return a.want_disp ? op.template go<Inst<STAGE, TS, TU, PASS_AB, true>>()
                       : op.template go<Inst<STAGE, TS, TU, PASS_AB, false>>();
  if (a.want_disp) return op.template go<Inst<STAGE, TS, TU, FWDGRAD, true>>();
  return op.template go<Inst<STAGE, TS, TU, FWDGRAD, false>>();
}

template <class Op>
int dispatch(const Args& a, bool s_int16, bool u_int16, const Op& op) {
  if (a.cut < 0 || a.cut >= kNumCuts || a.Ng < 1 || a.Nc < 1 || a.W < 1 || a.cs.K < 1 ||
      (a.stage != PHASE && a.stage != VELO))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.stage == PHASE)
    return s_int16 ? pick_cut<PHASE, int16_t, int16_t>(a, op)
                   : pick_cut<PHASE, float, int16_t>(a, op);
  if (s_int16)
    return u_int16 ? pick_cut<VELO, int16_t, int16_t>(a, op)
                   : pick_cut<VELO, int16_t, float>(a, op);
  return u_int16 ? pick_cut<VELO, float, int16_t>(a, op) : pick_cut<VELO, float, float>(a, op);
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
    // the caller's buffers were sized from vct_wide_plan
    if (p.grid != grid || p.pieces > pieces || p.loss_pieces != a.cs.loss_pieces ||
        (a.cut != FWD && a.gene_part == nullptr) ||
        (a.cut == FWDGRAD &&
         (a.cell_piece == nullptr || a.dzeta == nullptr ||
          a.dcf == nullptr ||
          (a.stage == VELO && (a.dzdphi == nullptr || a.domega == nullptr)))))
      return static_cast<int>(cudaErrorInvalidValue);
    return K::run(a, p);
  }
};

}  // namespace

extern "C" {

// The layout constants: {threads per CTA, genes per unit, cells per tile,
// shared-memory budget in bytes, pass A's chunk columns of the phase and
// of the velocity stage}.  Returns how many it wrote.
int vct_wide_layout(int* out, int n) {
  const int v[] = {kThreads, kGeneChunk, kCellsPerTile, kSmemBudget, kPhaseChunkCols,
                   kVeloChunkCols};
  int i = 0;
  for (; i < n && i < 6; ++i) out[i] = v[i];
  return i;
}

// The plan of one call of `cut` (0: loss only, 1: fwd+grad, 2 and 3: its
// timing cuts) of `stage` (0: phase, 1: velocity) at width W over K chains:
// out = {grid, pieces, blocks_per_sm, dyn_smem, loss_pieces, sweep_cols,
// sweeps, chunked}.  The caller sizes loss_part (K, loss_pieces) and, for
// the gradient cuts, gene_part (K * tiles, Ng, gene_values) with tiles =
// ceil(Nc / kCellsPerTile) and, for fwd+grad, cell_piece (pieces,
// cell_rows, K * Nc) from it.
int vct_wide_plan(int stage, int cut, int s_int16, int u_int16, int Ng, int Nc, int W, int K,
                  int want_disp, int* out) {
  Args a{};
  a.stage = stage;
  a.cut = cut;
  a.Ng = Ng;
  a.Nc = Nc;
  a.W = W;
  a.want_disp = want_disp != 0;
  a.cs.K = K;
  Plan p{};
  const int rc = dispatch(a, s_int16 != 0, u_int16 != 0, PlanOp{a, p});
  out[0] = p.grid;
  out[1] = p.pieces;
  out[2] = p.blocks_per_sm;
  out[3] = p.dyn_smem;
  out[4] = p.loss_pieces;
  out[5] = p.shape.Wz;
  out[6] = p.shape.sweeps;
  out[7] = p.shape.chunked ? 1 : 0;
  return rc;
}

// One launch with the grid, pieces and loss pieces of its plan, over
// K parameter sets sharing S (and U): chain c reads nu + c * st_nu, zeta + c
// * st_zeta, zeta_dphi + c * st_zdphi, cf + c * st_cf, omega + c * st_omega,
// log_beta + c * st_lbeta, log_gamma + c * st_lgamma and disp + c * st_disp
// (strides in floats, 0 for an operand the chains share).  The phase stage
// reads no U, zeta_dphi, omega, log_beta or log_gamma and writes no
// dzeta_dphi or domega (null).  Loss only: loss_part (K, loss_pieces)
// doubles, zero where a chain has fewer pieces.  Fwd+grad: also gene_part
// (K * tiles, Ng, gene_values) = phase [dnu (W), ddisp], velocity [dnu (W),
// ddisp, dlog_beta, sum_c g_x], and dzeta (dzeta_dphi) (K, Nc, W), dcf
// (domega) (K, Nc) through the cell_piece scratch.  Returns the CUDA error
// of the launches, or cudaErrorInvalidValue for arguments or buffers the
// plan does not match.
int vct_wide_run(int stage, int cut, const void* S, int s_int16, const void* U, int u_int16,
                 const float* nu, const float* zeta, const float* zdphi, const float* cf,
                 const float* omega, const float* lbeta, const float* lgamma, const float* disp,
                 int Ng, int Nc, int W, int K, long long st_nu, long long st_zeta,
                 long long st_zdphi, long long st_cf, long long st_omega, long long st_lbeta,
                 long long st_lgamma, long long st_disp, int skip_k, int want_disp, int grid,
                 int pieces, int loss_pieces, double* loss_part,
                 float* gene_part, float* cell_piece, float* dzeta, float* dzdphi, float* dcf,
                 float* domega, void* stream) {
  const Args a{stage, cut, S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, disp,
               Ng, Nc, W, skip_k != 0, want_disp != 0,
               ChainStrides{K, loss_pieces, st_nu, st_zeta, st_zdphi, st_cf, st_omega,
                            st_lbeta, st_lgamma, st_disp, 0},
               loss_part, gene_part, cell_piece, dzeta, dzdphi, dcf, domega,
               static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, s_int16 != 0, u_int16 != 0, RunOp{a, grid, pieces});
}

}  // extern "C"
