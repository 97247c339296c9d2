// Phase-stage Negative-Binomial kernels for Hopper (sm_90a): the C interface
// over the one templated body of phase_kernel.cuh.
//
// Replaces the Pallas TPU kernels `_phase_fwd_kernel` and
// `_phase_fwdgrad_kernel` of `velocycle_tpu/ops/nb_kernels.py`, which compute
//
//   sum_{g,c} NB_logpmf(S[g,c] | ElogS[g,c], r[g]),
//   ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]
//
// and, in the fwd+grad form, its gradients w.r.t. nu (Ng,Nh), zeta (Nc,Nh),
// cf (Nc,), r (Ng,) and delta_nu (Nb,Ng) in ONE pass over the count matrix,
// with no (Ng, Nc) intermediate in device memory; and the kernels of the
// roofline ladder of `tools/kernel_profile.py` (`k_stream`, `k_matmul`,
// `k_logpmf`, `k_fwdgrad`, `_variant_kernel`, `k_vpu_only`), each the same
// body cut down at compile time (phase_kernel.cuh `Cut`).  The ladder's
// v_full is the FWDGRAD instantiation that `phase_fwdgrad` launches.
//
// What bounds it on the H100: the per-element special-function arithmetic
// (the threshold-2 lgamma/digamma ratio, softplus/sigmoid: ~4 transcendentals
// and ~5 divisions per element in IEEE precision) and, unless they are
// hidden, the latencies of the count loads; the count stream itself is 0.42
// GB at 2048 x 102400 int16, 0.125 ms at 3.35 TB/s.  phase_kernel.cuh says
// what the layout does about both: an even split over a persistent grid,
// and the counts staged ahead of the arithmetic in a cp.async ring.
// Gene-indexed sums go to per-cell-tile partials and the loss to per-CTA
// doubles (per chain and CTA in a chain-batched launch: phase_kernel.cuh
// `ChainStrides`), summed by the caller in a fixed order; the cell gradients to
// per-CTA pieces that cell_sum_kernel adds in CTA order: no float atomics,
// repeats are bit-identical.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnb_phase.so nb_phase.cu
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "nb_common.cuh"
#include "phase_kernel.cuh"

namespace {

using namespace vct::phase;
using vct::ChainStrides;
using vct::unit_owner;

struct Args {
  int mode;           // a Cut
  const void* S;      // (Ng, Nc) int16 or float32; null for VPU_ONLY
  const float* nu;
  const float* zeta;
  const float* cf;
  const float* disp;
  const float* dnu;   // (Nb, Ng) or null
  const float* Db;    // (Nb, Nc) or null
  int Ng, Nc, Nh, Nb, n_rep;
  bool skip_k, want_disp;
  ChainStrides cs;    // the chain batch: K, loss pieces, parameter strides
  double* loss_part;  // (K, loss_pieces)
  float* gene_part;   // (K, n_tiles, Ng, NV) or null
  float* cell_piece;  // (pieces, Nh + 1, K * Nc) or null
  float* dzeta;       // (K, Nc, Nh) or null
  float* dcf;         // (K, Nc) or null
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

template <typename TK, int NH, int CUT, bool WANT_DISP, bool HAS_DNU, bool SKIP_K>
struct Inst {
  static constexpr int kCut = CUT;
  static constexpr int kRingBytes = kStages * stage_bytes<TK, NH, HAS_DNU>();

  static auto kernel() {
    return phase_kernel<TK, NH, CUT, WANT_DISP, HAS_DNU, SKIP_K>;
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
    const long long U = UC * a.cs.K;
    const long long slots = static_cast<long long>(sms) * p.blocks_per_sm;
    p.grid = static_cast<int>(U < slots ? U : slots);
    p.dyn_smem = kRingBytes;
    p.pieces = 0;
    p.loss_pieces = 0;
    for (int c = 0; c < a.cs.K; ++c) {
      const int n = unit_owner((c + 1) * UC - 1, U, p.grid) - unit_owner(c * UC, U, p.grid) + 1;
      if (n > p.loss_pieces) p.loss_pieces = n;
    }
    if (Flags<CUT>::cell_grads) {
      for (long long t = 0; t < static_cast<long long>(tiles) * a.cs.K; ++t) {
        const long long first = t * n_chunks;
        const int n = unit_owner(first + n_chunks - 1, U, p.grid) -
                      unit_owner(first, U, p.grid) + 1;
        if (n > p.pieces) p.pieces = n;
      }
    }
    return 0;
  }

  static int run(const Args& a, const Plan& p) {
    phase_kernel<TK, NH, CUT, WANT_DISP, HAS_DNU, SKIP_K>
        <<<p.grid, kThreads, p.dyn_smem, a.stream>>>(
        static_cast<const TK*>(a.S), a.nu, a.zeta, a.cf, a.disp, a.dnu, a.Db, a.Ng, a.Nc,
        a.Nb, a.n_rep, a.cs, a.loss_part, a.gene_part, a.cell_piece);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || !Flags<CUT>::cell_grads) return rc;
    const long long KNc = static_cast<long long>(a.cs.K) * a.Nc;
    cell_sum_kernel<NH><<<static_cast<int>((KNc + 255) / 256), 256, 0, a.stream>>>(
        a.cell_piece, a.Ng, a.Nc, a.cs.K, p.grid, a.dzeta, a.dcf);
    return static_cast<int>(cudaGetLastError());
  }
};

// Calls op.template go<Inst<...>>() for the instantiation the arguments
// select.  The production modes take Nh in {3, 5, 7} with up to kMaxNb
// batches, or 11 and 16 without (the Python wrapper pads other widths with
// zero columns and folds more batches into extra columns), and any flags;
// the ladder's rungs Nh = 5, no batches, and the flags the TPU tool fixes
// for each.
template <typename TK, int NH, int CUT, bool WD, bool DNU, class Op>
int pick_skip(const Args& a, const Op& op) {
  return a.skip_k ? op.template go<Inst<TK, NH, CUT, WD, DNU, true>>()
                  : op.template go<Inst<TK, NH, CUT, WD, DNU, false>>();
}

template <typename TK, int NH, int CUT, bool WD, class Op>
int pick_dnu(const Args& a, const Op& op) {
  if constexpr (NH <= vct::kMaxDnuWidth) {
    if (a.Nb > 0) return pick_skip<TK, NH, CUT, WD, true>(a, op);
  } else {
    if (a.Nb > 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  return pick_skip<TK, NH, CUT, WD, false>(a, op);
}

template <typename TK, int NH, class Op>
int pick_mode(const Args& a, const Op& op) {
  if (a.mode == FWD) return pick_dnu<TK, NH, FWD, false>(a, op);
  if (a.want_disp) return pick_dnu<TK, NH, FWDGRAD, true>(a, op);
  return pick_dnu<TK, NH, FWDGRAD, false>(a, op);
}

template <typename TK, class Op>
int pick_rung(const Args& a, const Op& op) {
  switch (a.mode) {
    case STREAM: return op.template go<Inst<TK, 5, STREAM, false, false, true>>();
    case MATMUL: return op.template go<Inst<TK, 5, MATMUL, false, false, true>>();
    case LOGPMF: return op.template go<Inst<TK, 5, LOGPMF, false, false, true>>();
    case GRAD_NU: return op.template go<Inst<TK, 5, GRAD_NU, false, false, true>>();
    case V_NODIG: return op.template go<Inst<TK, 5, V_NODIG, false, false, true>>();
    case V_NOCELL: return op.template go<Inst<TK, 5, V_NOCELL, true, false, true>>();
    case VPU_ONLY: return op.template go<Inst<TK, 5, VPU_ONLY, false, false, true>>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TK, class Op>
int pick_nh(const Args& a, const Op& op) {
  if (a.mode != FWD && a.mode != FWDGRAD) {
    if (a.Nh != 5 || a.Nb != 0) return static_cast<int>(cudaErrorInvalidValue);
    return pick_rung<TK>(a, op);
  }
  switch (a.Nh) {
    case 3: return pick_mode<TK, 3>(a, op);
    case 5: return pick_mode<TK, 5>(a, op);
    case 7: return pick_mode<TK, 7>(a, op);
    case 11: return pick_mode<TK, 11>(a, op);
    case 16: return pick_mode<TK, 16>(a, op);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Op>
int dispatch(const Args& a, bool counts_int16, const Op& op) {
  if (a.mode < 0 || a.mode >= kNumCuts || a.Ng < 1 || a.Nc < 1 || a.Nb < 0 ||
      a.Nb > kMaxNb || a.cs.K < 1 || (a.cs.K > 1 && a.mode != FWD && a.mode != FWDGRAD))
    return static_cast<int>(cudaErrorInvalidValue);
  return counts_int16 ? pick_nh<int16_t>(a, op) : pick_nh<float>(a, op);
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
    // the caller's buffers were sized from vct_phase_plan
    if (p.grid != grid || p.pieces > pieces || p.loss_pieces != a.cs.loss_pieces ||
        (Flags<K::kCut>::cell_grads && (a.cell_piece == nullptr || a.dzeta == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return K::run(a, p);
  }
};

}  // namespace

extern "C" {

// The layout constants: {threads per CTA, cells per tile, genes per chunk,
// ring stages, max batches}.  Returns how many it wrote.
int vct_phase_layout(int* out, int n) {
  const int v[] = {kThreads, kCellsPerTile, kGeneChunk, kStages, kMaxNb};
  int i = 0;
  for (; i < n && i < 5; ++i) out[i] = v[i];
  return i;
}

// The plan of one call over K chains (K = 1: unbatched; K > 1 only for
// FWD and FWDGRAD): out = {grid, pieces, blocks_per_sm, dyn_smem,
// loss_pieces}.
// The caller sizes loss_part (K, loss_pieces) and, for the cell-gradient
// modes, cell_piece (pieces, Nh + 1, K * Nc) from it.
int vct_phase_plan(int mode, int counts_int16, int Ng, int Nc, int Nh, int Nb, int K,
                   int skip_k, int want_disp, int* out) {
  Args a{mode, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         Ng, Nc, Nh, Nb, 0, skip_k != 0, want_disp != 0};
  a.cs.K = K;
  Plan p{};
  const int rc = dispatch(a, counts_int16 != 0, PlanOp{a, p});
  out[0] = p.grid;
  out[1] = p.pieces;
  out[2] = p.blocks_per_sm;
  out[3] = p.dyn_smem;
  out[4] = p.loss_pieces;
  return rc;
}

// One launch of `mode` (a Cut) over K chains with the grid, pieces and loss
// pieces of its plan: loss_part (K, loss_pieces) doubles, zero where a chain
// has fewer pieces; the gradient modes gene_part (K, n_tiles, Ng, NV);
// FWDGRAD and V_NODIG dzeta (K, Nc, Nh) and dcf (K, Nc), through the
// cell_piece (pieces, Nh + 1, K * Nc) scratch.  Chain c reads nu + c *
// st_nu, zeta + c * st_zeta, cf + c * st_cf, disp + c * st_disp and dnu + c
// * st_dnu (strides in floats, 0 for an operand the chains share); S and Db
// are shared.  Pointers a mode does not read or write may be null.  Returns
// the CUDA error of the launches, or cudaErrorInvalidValue for arguments or
// buffers the plan does not match.
int vct_phase_run(int mode, const void* S, int counts_int16, const float* nu,
                  const float* zeta, const float* cf, const float* disp, const float* dnu,
                  const float* Db, int Ng, int Nc, int Nh, int Nb, int K, long long st_nu,
                  long long st_zeta, long long st_cf, long long st_disp, long long st_dnu,
                  int skip_k, int want_disp, int n_rep, int grid, int pieces, int loss_pieces,
                  double* loss_part, float* gene_part, float* cell_piece, float* dzeta,
                  float* dcf, void* stream) {
  const Args a{mode, S, nu, zeta, cf, disp, dnu, Db, Ng, Nc, Nh, Nb, n_rep,
               skip_k != 0, want_disp != 0,
               ChainStrides{K, loss_pieces, st_nu, st_zeta, 0, st_cf, 0, 0, 0, st_disp, st_dnu},
               loss_part, gene_part, cell_piece, dzeta, dcf, static_cast<cudaStream_t>(stream)};
  (void)cudaGetLastError();
  return dispatch(a, counts_int16 != 0, RunOp{a, grid, pieces});
}

}  // extern "C"
