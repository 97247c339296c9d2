// The wide-basis body of the fused NB kernels for Hopper (sm_90a): both
// stages' loss-only and fwd+grad cuts at a basis width W that is a runtime
// value, any width.  nb_wide.cu instantiates it and exports the C
// interface; ops/nb_kernels.py routes every shape past the narrow bodies'
// widest instantiation (16 columns) here, with the delta_nu batches folded
// into basis columns (`widen_inputs`).
//
// Why a second body.  The narrow bodies (phase_kernel.cuh, velo_kernel.cuh)
// keep each thread's basis rows, cell gradients and gene-sum values in
// registers sized by a template width, and reduce the gene sums with a warp
// reduce-scatter of at most 32 values: neither holds past a few dozen
// columns.  Here the three basis products of a unit are tile products out
// of shared memory.
//
// Layout.  A unit is one tile of kCellsPerTile = 128 cells by one chunk of
// kGeneChunk = 32 genes, chain-major and tile-major over a persistent grid
// that splits the units evenly.  Warp w carries genes 4w .. 4w + 3 of the
// chunk and lane l cells 4l .. 4l + 3 of the tile: each thread owns a 4 x 4
// register tile of elements, and a warp's elements at one step of the
// element loop are all of one gene (the dispersion-gradient form and the
// gene's columns are uniform across the warp).  Each unit, between three
// barriers:
//   A. ElogS (and dEs) of the thread's 16 elements, the product Nu Z^T over
//      the basis columns in order: per column a float4 of each gene's nu
//      row (a broadcast) and a float4 of the four cells' basis row feed 16
//      FMAs (ElogS); dEs takes each column quad's rounded products summed
//      pairwise into a compensated (Kahan) running sum, in the plain
//      version's order and arithmetic, so that x and the relu gate agree
//      with it bit for bit.  The compensation keeps dEs within about an ulp
//      at any width, where a plain running sum drifts with the column count
//      and the gate's 1 / xr magnifies the drift (the narrow bodies keep the
//      plain sum: at most 16 columns).  Then the NB
//      element: the loss; the factors (phase d lp / d ElogS; velocity g_e
//      and g_x * omega) into shared memory; the per-gene sums over the
//      tile's cells (ddisp; velocity also dlog_beta and sum g_x) by warp
//      butterflies straight from registers; the per-cell sums over genes
//      (dcf; velocity also domega) into registers kept for the tile.
//   B. dnu = F Z over the tile's cells: a lane owns 4 genes x 4 columns over
//      one quarter of the cells (float4s along the cells from both operands,
//      16 FMAs per pair), the quarters then reduce-scattered over the warp
//      in a fixed butterfly, into per-tile gene partials (K x tiles, Ng, NV)
//      that the caller sums over tiles.
//   C. the cell gradients dZ += F^T Nu over the unit's genes: a thread owns
//      4 columns x 4 cells of one basis block (a float4 of the factor row, a
//      broadcast float4 of nu, 16 FMAs per gene; the velocity stage's two
//      blocks are separate items, which keeps 16 accumulators live, not
//      32), added to the tile's accumulators in shared memory.  A thread's
//      cf and omega are read where the element needs them, not held in
//      registers across the passes.
// When a CTA's run leaves a tile, it writes the tile's accumulators (and the
// per-cell sums, each warp's, added in warp order) as one piece (pieces,
// rows, K * Nc); `wide_cell_sum_kernel` adds a tile's pieces in CTA order.
// The loss goes to per-(chain, CTA) doubles.  No float atomics and every sum
// in a fixed order: repeats are bit-identical.
//
// Counts reach the element through a one-stage ring of `cp.async` copies
// (as phase_kernel.cuh's: each row the 16-byte-aligned window around its
// segment, any Nc, any row alignment): the next unit's counts are issued as
// soon as this unit's element has read them, and fly during passes B and C.
// The next unit's nu rows and dispersions (velocity: log_beta, log_gamma)
// are issued into the other of two parameter slots at the start of a unit.
//
// Any width.  The tile's basis rows (zeta^T, velocity also zeta_dphi^T) and
// its cell-gradient accumulators live in shared memory for the Wz columns
// that fit kSmemBudget (`plan_shape`).  Up to that fit (152 columns for the
// phase pair, 72 for the velocity pair, int16 counts) a tile holds every
// column, and pass A reads them where passes B and C do.  Past it the body
// sweeps the tile's genes once per chunk of Wz columns (the units are chain
// x tile x sweep x gene chunk): pass A reads every column again, in chunks
// of chunk_cols through the factors' shared memory and in the same order
// (the same bits), the element is recomputed, and passes B and C do the
// sweep's columns; the loss and the per-gene and per-cell sums come from the
// first sweep.  The loss-only cut reads every column in chunks once its rows
// do not fit.  No width is refused.
//
// What bounds it: the NB element's arithmetic (its transcendentals) and,
// with width, the three products' FMAs (6 x W per element for the velocity
// pair) fed from shared memory at about one byte per FMA in passes A and B;
// the count stream is 2 bytes (int16) per element and matrix; the gene
// partials add 4 x NV bytes per gene and tile.  Tensor cores are not used.
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

constexpr int kThreads = 256;
constexpr int kGeneChunk = 32;        // genes of a unit: 4 per warp
constexpr int kCellsPerTile = 128;    // cells of a tile: 4 per lane
constexpr int kSmemBudget = 230400;   // bytes of dynamic shared memory a CTA takes at most
constexpr int kPhaseChunkCols = 24;   // basis columns per chunk of pass A past the fit
constexpr int kVeloChunkCols = 28;
constexpr int kMinBlocksPerSm = 2;    // caps registers at 128 per thread
constexpr int kWarps = kThreads / 32;
constexpr int kQuad = 4;                        // the edge of a thread's register tile
constexpr int kRowFloats = kCellsPerTile + 4;   // floats between two cell-indexed rows
constexpr int kColFloats = static_cast<int>(sizeof(GeneCols) / sizeof(float));
static_assert(kGeneChunk == kWarps * kQuad, "a warp carries 4 genes of the chunk");
static_assert(kCellsPerTile == 32 * kQuad, "a lane carries 4 cells of the tile");
static_assert(kGeneChunk == 32, "pass B: a lane's genes q + 8 i, 8 lanes per cell quarter");
static_assert(kRowFloats % 4 == 0 && (kRowFloats / 4) % 2 == 1,
              "rows are whole float4s, an odd number of them: no bank conflict in pass B");
static_assert(kPhaseChunkCols % 4 == 0 && kVeloChunkCols % 4 == 0, "chunks are whole quads");

// FWD: the loss alone.  FWDGRAD: the loss and every gradient.  PASS_A and
// PASS_AB, timing cuts of FWDGRAD: stop after pass A, the element and the
// factors (the per-gene sums written), and after pass B (nothing of the
// cell gradients is written).
enum Cut : int { FWD, FWDGRAD, PASS_A, PASS_AB, kNumCuts };
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
// cell-indexed basis blocks (zeta; velocity zeta, zeta_dphi), which are also
// the factor rows passes B and C read (phase g_elog; velocity g_e, g_x *
// omega) and the accumulator blocks; per-cell sums (dcf; velocity dcf,
// domega); per-gene inputs (disp; velocity disp, log_beta, log_gamma)
__host__ __device__ constexpr int basis_blocks(int stage) { return stage == PHASE ? 1 : 2; }
__host__ __device__ constexpr int cell_sums(int stage) { return stage == PHASE ? 1 : 2; }
__host__ __device__ constexpr int gene_inputs(int stage) { return stage == PHASE ? 1 : 3; }
__host__ __device__ constexpr int chunk_cols(int stage) {
  return stage == PHASE ? kPhaseChunkCols : kVeloChunkCols;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int window_bytes(int type_bytes) {
  return kCellsPerTile * type_bytes + 16;
}

// Offsets, in floats, of one CTA's shared memory when Wz basis columns are
// resident (`chunked`: pass A reads its columns in chunks of chunk_cols
// through the factor region).  s_bytes, u_bytes: the count types' sizes
// (u_bytes 0 for the phase stage).
struct Smem {
  int z;      // the tile's basis rows (basis_blocks, Wz, kRowFloats)
  int acc;    // its cell-gradient accumulators, the same shape (gradient cuts)
  int fac;    // the unit's factors (basis_blocks, kGeneChunk, kRowFloats); also pass A's
              // chunk buffer and the scratch of a tile's per-cell sums
  int prm;    // two slots of the unit's nu (kGeneChunk, Wz) and per-gene inputs
  int prm_size;
  int cols;   // GeneCols (kGeneChunk); velocity then -log_beta and exp(log_gamma)
  int ring;   // the counts: kGeneChunk windows of S (then of U)
  int total;  // bytes
};

__host__ __device__ inline Smem smem_layout(int stage, int cut, int Wz, bool chunked, int s_bytes,
                                            int u_bytes) {
  Smem s{};
  const int nb = basis_blocks(stage);
  const bool grad = cut != FWD;
  const int cw = chunk_cols(stage);
  int fac = grad ? nb * kGeneChunk * kRowFloats : 0;
  const int chunk = nb * cw * kRowFloats + kGeneChunk * cw;
  if (chunked && chunk > fac) fac = chunk;
  s.z = 0;
  s.acc = s.z + nb * Wz * kRowFloats;
  s.fac = s.acc + (grad ? nb * Wz * kRowFloats : 0);
  s.prm = s.fac + fac;
  s.prm_size = kGeneChunk * (Wz + gene_inputs(stage));
  s.cols = s.prm + 2 * s.prm_size;
  s.ring = round4(s.cols + kGeneChunk * (kColFloats + (stage == VELO ? 2 : 0)));
  s.total = s.ring * 4 +
            kGeneChunk * (window_bytes(s_bytes) + (u_bytes ? window_bytes(u_bytes) : 0));
  return s;
}

// How a call at width W runs: Wz resident columns, the sweeps over them,
// and whether pass A reads its columns in chunks.  Every column resident if
// that fits kSmemBudget; else, for the gradient cuts, the widest multiple of
// 4 columns that fits beside pass A's chunk buffer, balanced over the
// sweeps it takes; for the loss-only cut, no resident column.
struct Shape {
  int Wz, sweeps;
  bool chunked;
};

__host__ __device__ inline Shape plan_shape(int stage, int cut, int W, int s_bytes, int u_bytes) {
  const int Wp = round4(W);
  if (smem_layout(stage, cut, Wp, false, s_bytes, u_bytes).total <= kSmemBudget)
    return Shape{Wp, 1, false};
  if (cut == FWD) return Shape{0, 1, true};
  int fit = Wp;
  while (fit > 4 && smem_layout(stage, cut, fit, true, s_bytes, u_bytes).total > kSmemBudget)
    fit -= 4;
  const int sweeps = (Wp + fit - 1) / fit;
  return Shape{round4((Wp + sweeps - 1) / sweeps), sweeps, true};
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Starts the copies of rows g0 .. g0 + gn - 1, cells c0 .. c0 + 127 of the
// (Ng, Nc) count matrix M into `st`: each row the 16-byte-aligned window
// around its segment (window_bytes apart), the piece below a misaligned
// matrix start element by element, the piece past its end zero-filled.
template <typename TK>
__device__ __forceinline__ void copy_count_rows(unsigned char* st, const TK* M, int g0, int gn,
                                                int c0, int Ng, int Nc, int tid) {
  constexpr int ROW = window_bytes(sizeof(TK));
  constexpr int QR = ROW / 16;
  const char* begin = reinterpret_cast<const char*>(M);
  const char* end = begin + static_cast<size_t>(Ng) * Nc * sizeof(TK);
  const int seg = min(kCellsPerTile, Nc - c0) * static_cast<int>(sizeof(TK));
  for (int i = tid; i < gn * QR; i += kThreads) {
    const int r = i / QR;
    const int q = i - r * QR;
    const char* a = begin + (static_cast<size_t>(g0 + r) * Nc + c0) * sizeof(TK);
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15u);
    if (q * 16 >= lead + seg) continue;
    const char* src = a - lead + 16 * q;
    unsigned char* dst = st + r * ROW + 16 * q;
    if (src < begin) {
      for (const char* b = begin; b < src + 16 && b < end; b += sizeof(TK))
        *reinterpret_cast<TK*>(dst + (b - src)) = *reinterpret_cast<const TK*>(b);
    } else {
      const long long left = end - src;
      cp_async16(dst, src, left < 16 ? static_cast<int>(left) : 16);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Pass A over `ncols` basis columns (a multiple of 4) from shared memory:
// zt the columns' cell rows (kRowFloats apart), zdt the velocity stage's
// zeta_dphi rows, nub the unit's nu rows (ldn apart).  Each column in order:
// e = fma(nu, z, e).  dEs by column quads in order: the quad's four rounded
// products nu * zd summed pairwise, (p0 + p1) + (p2 + p3), then added to the
// running sum d with its compensation k (Kahan), each step rounded as
// written (no contraction).  A zero padding column adds an exact zero to
// its quad's sum.
template <bool VEL>
__device__ __forceinline__ void pass_a(const float* zt, const float* zdt, const float* nub,
                                       int ldn, int ncols, int warp, int lane,
                                       float (&e)[kQuad][kQuad], float (&d)[kQuad][kQuad],
                                       float (&k)[kQuad][kQuad]) {
  const float* nrow = nub + warp * kQuad * ldn;
  const float* zc = zt + lane * kQuad;
  const float* zdc = zdt + lane * kQuad;
  for (int h = 0; h < ncols; h += 4) {
    float4 nv[kQuad];
#pragma unroll
    for (int i = 0; i < kQuad; ++i) nv[i] = ld4(nrow + i * ldn + h);
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const float4 z = ld4(zc + (h + hh) * kRowFloats);
#pragma unroll
      for (int i = 0; i < kQuad; ++i)
#pragma unroll
        for (int j = 0; j < kQuad; ++j) e[i][j] = fmaf(elem(nv[i], hh), elem(z, j), e[i][j]);
    }
    if (VEL) {
      float4 zd[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) zd[hh] = ld4(zdc + (h + hh) * kRowFloats);
#pragma unroll
      for (int i = 0; i < kQuad; ++i)
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          const float p01 = __fadd_rn(__fmul_rn(nv[i].x, elem(zd[0], j)),
                                      __fmul_rn(nv[i].y, elem(zd[1], j)));
          const float p23 = __fadd_rn(__fmul_rn(nv[i].z, elem(zd[2], j)),
                                      __fmul_rn(nv[i].w, elem(zd[3], j)));
          const float y = __fsub_rn(__fadd_rn(p01, p23), k[i][j]);
          const float t = __fadd_rn(d[i][j], y);
          k[i][j] = __fsub_rn(__fsub_rn(t, d[i][j]), y);
          d[i][j] = t;
        }
    }
  }
}

// Adds the 4 products of a float4 pair along the cells (c .. c + 3) of f's
// and z's rows to o, cell by cell.
__device__ __forceinline__ void dot4(const float4& f, const float4& z, float& o) {
  o = fmaf(f.x, z.x, o);
  o = fmaf(f.y, z.y, o);
  o = fmaf(f.z, z.z, o);
  o = fmaf(f.w, z.w, o);
}

// The one body.  STAGE picks the phase or the velocity element; U,
// zeta_dphi, omega, log_beta and log_gamma are read by the velocity stage
// only.  `lgk_skip` drops lgamma(k + 1) (the caller adds its sum).  Wz,
// sweeps and chunked are the call's `plan_shape`.
template <int STAGE, typename TS, typename TU, int CUT, bool WANT_DISP>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
wide_kernel(const TS* __restrict__ S, const TU* __restrict__ U, const float* __restrict__ nu,
            const float* __restrict__ zeta, const float* __restrict__ zdphi,
            const float* __restrict__ cf, const float* __restrict__ omega,
            const float* __restrict__ lbeta, const float* __restrict__ lgamma,
            const float* __restrict__ disp, int Ng, int Nc, int W, int Wz, int sweeps,
            int chunked, int lgk_skip, ChainStrides cs, double* __restrict__ loss_part,
            float* __restrict__ gene_part, float* __restrict__ cell_piece) {
  constexpr bool VEL = STAGE == VELO;
  constexpr bool GRAD = CUT != FWD;
  constexpr bool PASS_B = CUT == FWDGRAD || CUT == PASS_AB;
  constexpr bool PASS_C = CUT == FWDGRAD;
  constexpr int G = kGeneChunk;
  constexpr int T = kCellsPerTile;
  constexpr int PT = kRowFloats;
  constexpr int Q = kQuad;
  constexpr int NB = basis_blocks(STAGE);
  constexpr int NS = cell_sums(STAGE);
  constexpr int NGS = VEL ? 3 : 1;   // per-gene sums over cells: g_r [, -g_U, g_x]
  constexpr int CW = chunk_cols(STAGE);
  constexpr int ROW_S = window_bytes(sizeof(TS));
  constexpr int ROW_U = window_bytes(sizeof(TU));
  extern __shared__ __align__(16) float sm[];
  __shared__ double s_loss[kWarps];

  const Smem L = smem_layout(STAGE, CUT, Wz, chunked != 0, sizeof(TS), VEL ? sizeof(TU) : 0);
  float* s_z = sm + L.z;
  float* s_acc = sm + L.acc;
  float* s_fac = sm + L.fac;
  GeneCols* s_cols = reinterpret_cast<GeneCols*>(sm + L.cols);
  float* s_nlb = sm + L.cols + G * kColFloats;
  float* s_gam = s_nlb + G;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sm + L.ring);
  unsigned char* ring_u = ring + G * ROW_S;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Wp = round4(W);
  const int Wq = Wz / Q;   // resident column quads
  const int n_chunks = (Ng + G - 1) / G;
  const int tiles = (Nc + T - 1) / T;
  const int pairs = tiles * sweeps;   // (tile, sweep) pairs of one chain
  const long long UC = static_cast<long long>(pairs) * n_chunks;  // units of one chain
  const long long n_units = UC * cs.K;
  const long long u0 = static_cast<long long>(blockIdx.x) * n_units / gridDim.x;
  const long long u1 = static_cast<long long>(blockIdx.x + 1) * n_units / gridDim.x;
  const size_t KNc = static_cast<size_t>(cs.K) * Nc;
  const int NV = gene_values(STAGE, W);
  const int NR = cell_rows(STAGE, W);
  const unsigned s_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(S) & 15u);
  const unsigned u_mis = VEL ? static_cast<unsigned>(reinterpret_cast<uintptr_t>(U) & 15u) : 0u;

  // unit u: gt = u / n_chunks counts the (chain, tile, sweep) triples
  struct Unit {
    int gt, chain, t, s, g0, gn;
  };
  auto unit_of = [&](long long u) {
    Unit x;
    x.gt = static_cast<int>(u / n_chunks);
    x.chain = x.gt / pairs;
    const int ts = x.gt - x.chain * pairs;
    x.t = ts / sweeps;
    x.s = ts - x.t * sweeps;
    x.g0 = static_cast<int>(u - static_cast<long long>(x.gt) * n_chunks) * G;
    x.gn = min(G, Ng - x.g0);
    return x;
  };

  // the copies of unit u's parameters into slot `slot`: nu's sweep columns
  // (zeros past W and past the last gene), then the per-gene inputs, each
  // copied by the thread that reads it
  auto issue_prm = [&](long long u, int slot) {
    const Unit x = unit_of(u);
    float* prm = sm + L.prm + slot * L.prm_size;
    const int a = x.s * Wz;
    const float* nu_c = nu + x.chain * cs.nu + static_cast<size_t>(x.g0) * W;
    for (int j = tid; j < G * Wz; j += kThreads) {
      const int gl = j / Wz;
      const int h = j - gl * Wz;
      const bool ok = gl < x.gn && a + h < W;
      cp_async4_zfill(prm + j, ok ? nu_c + static_cast<size_t>(gl) * W + a + h : nu, ok);
    }
    if (tid < G) {
      const bool ok = tid < x.gn;
      const int g = x.g0 + (ok ? tid : 0);
      float* gi = prm + G * Wz;
      cp_async4_zfill(gi + tid, disp + x.chain * cs.disp + g, ok);
      if (VEL) {
        cp_async4_zfill(gi + G + tid, lbeta + x.chain * cs.lbeta + g, ok);
        cp_async4_zfill(gi + 2 * G + tid, lgamma + x.chain * cs.lgamma + g, ok);
      }
    }
  };
  auto issue_counts = [&](long long u) {
    const Unit x = unit_of(u);
    copy_count_rows<TS>(ring, S, x.g0, x.gn, x.t * T, Ng, Nc, tid);
    if (VEL) copy_count_rows<TU>(ring_u, U, x.g0, x.gn, x.t * T, Ng, Nc, tid);
  };

  // this thread's cells' sums over the current tile's genes (dcf;
  // velocity domega)
  int cur = -1;
  float csum[NS][Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int v = 0; v < NS; ++v) csum[v][j] = 0.0f;

  // this CTA's piece of a (tile, sweep)'s cell gradients, in CTA order: the
  // accumulators' rows of the sweep's columns and, with the first sweep,
  // the per-cell sums (each warp's through the factor region, added in warp
  // order); everything zeroed for the next
  auto flush = [&](int gt) {
    const int k = static_cast<int>(blockIdx.x) -
                  unit_owner(static_cast<long long>(gt) * n_chunks, n_units, gridDim.x);
    const int ch = gt / pairs;
    const int ts = gt - ch * pairs;
    const int t = ts / sweeps;
    const int s = ts - t * sweeps;
    const int c0 = t * T;
    const int tn = min(T, Nc - c0);
    const int a = s * Wz;
    float* out = cell_piece + static_cast<size_t>(k) * NR * KNc + static_cast<size_t>(ch) * Nc + c0;
    for (int j = tid; j < NB * Wz * T; j += kThreads) {
      const int rr = j / T;
      const int cc = j - rr * T;
      const int blk = rr / Wz;
      const int col = a + rr - blk * Wz;
      if (col < W && cc < tn) out[static_cast<size_t>(blk * W + col) * KNc + cc] = s_acc[rr * PT + cc];
      s_acc[rr * PT + cc] = 0.0f;
    }
    if (s == 0) {
#pragma unroll
      for (int v = 0; v < NS; ++v) {
        *reinterpret_cast<float4*>(s_fac + (v * kWarps + warp) * T + lane * Q) =
            make_float4(csum[v][0], csum[v][1], csum[v][2], csum[v][3]);
#pragma unroll
        for (int j = 0; j < Q; ++j) csum[v][j] = 0.0f;
      }
      __syncthreads();
      for (int j = tid; j < NS * T; j += kThreads) {
        const int v = j / T;
        const int cc = j - v * T;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_fac[(v * kWarps + w) * T + cc];
        if (cc < tn) out[static_cast<size_t>(NB * W + v) * KNc + cc] = sum;
      }
      __syncthreads();
    }
  };

  int chain = static_cast<int>(u0 / UC);
  double loss = 0.0;
  auto flush_loss = [&]() {
    loss = warp_sum(loss);
    if (lane == 0) s_loss[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_loss[w];
      const int k = static_cast<int>(blockIdx.x) - unit_owner(chain * UC, n_units, gridDim.x);
      loss_part[static_cast<size_t>(chain) * cs.loss_pieces + k] = sum;
    }
    __syncthreads();
    loss = 0.0;
  };

  if (PASS_C)
    for (int j = tid; j < NB * Wz * PT; j += kThreads) s_acc[j] = 0.0f;
  if (u0 < u1) {
    issue_prm(u0, 0);
    issue_counts(u0);
  }
  cp_async_commit();

  for (long long u = u0; u < u1; ++u) {
    if (u / UC != chain) {  // uniform over the CTA: the next chain's units
      flush_loss();
      chain = static_cast<int>(u / UC);
    }
    const int iu = static_cast<int>(u - u0);
    const Unit x = unit_of(u);
    const int c0 = x.t * T;
    const int tn = min(T, Nc - c0);
    const int a = x.s * Wz;
    const int gtile = x.chain * tiles + x.t;

    // entering a (tile, sweep): the last one's piece out, then the sweep's
    // basis rows of the tile (the barrier that ended the last unit freed
    // the rows)
    if (x.gt != cur) {
      if (PASS_C && cur >= 0) flush(cur);
      cur = x.gt;
      for (int blk = 0; blk < NB; ++blk) {
        const float* src = (blk == 0 ? zeta + x.chain * cs.zeta : zdphi + x.chain * cs.zdphi) +
                           static_cast<size_t>(c0) * W;
        float* dst = s_z + blk * Wz * PT;
        for (int j = tid; j < T * Wz; j += kThreads) {
          const int cc = j / Wz;
          const int h = j - cc * Wz;
          dst[h * PT + cc] = (cc < tn && a + h < W) ? src[static_cast<size_t>(cc) * W + a + h] : 0.0f;
        }
      }
    }

    // this unit's copies (issued by the last unit) are in; its genes'
    // columns from its parameter slot
    cp_async_wait<0>();
    const float* prm = sm + L.prm + (iu & 1) * L.prm_size;
    if (tid < G) {
      const float* gi = prm + G * Wz;
      const bool ok = tid < x.gn;
      s_cols[tid] = gene_cols(ok ? gi[tid] : 1.0f);
      if (VEL) {
        s_nlb[tid] = ok ? -gi[G + tid] : 0.0f;
        s_gam[tid] = ok ? expf(gi[2 * G + tid]) : 1.0f;
      }
    }
    __syncthreads();  // the unit's rows, columns and counts are in place
    if (u + 1 < u1) issue_prm(u + 1, (iu + 1) & 1);
    cp_async_commit();

    // pass A: ElogS (and dEs) of the thread's 4 x 4 elements over every
    // basis column in order
    float e[Q][Q], d[Q][Q], kd[Q][Q];
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) e[i][j] = d[i][j] = kd[i][j] = 0.0f;
    if (!chunked) {
      pass_a<VEL>(s_z, s_z + Wz * PT, prm, Wz, Wp, warp, lane, e, d, kd);
    } else {
      // every column, in chunks of CW through the factor region
      float* ch_z = s_fac;
      float* ch_nu = s_fac + NB * CW * PT;
      const float* nu_c = nu + x.chain * cs.nu + static_cast<size_t>(x.g0) * W;
      for (int h0 = 0; h0 < Wp; h0 += CW) {
        const int cn = min(CW, Wp - h0);
        if (h0) __syncthreads();  // the last chunk is read
        for (int blk = 0; blk < NB; ++blk) {
          const float* src = (blk == 0 ? zeta + x.chain * cs.zeta : zdphi + x.chain * cs.zdphi) +
                             static_cast<size_t>(c0) * W;
          for (int j = tid; j < T * cn; j += kThreads) {
            const int cc = j / cn;
            const int h = j - cc * cn;
            ch_z[(blk * CW + h) * PT + cc] =
                (cc < tn && h0 + h < W) ? src[static_cast<size_t>(cc) * W + h0 + h] : 0.0f;
          }
        }
        for (int j = tid; j < G * cn; j += kThreads) {
          const int gl = j / cn;
          const int h = j - gl * cn;
          ch_nu[gl * CW + h] =
              (gl < x.gn && h0 + h < W) ? nu_c[static_cast<size_t>(gl) * W + h0 + h] : 0.0f;
        }
        __syncthreads();  // the chunk is in place
        pass_a<VEL>(ch_z, ch_z + CW * PT, ch_nu, CW, cn, warp, lane, e, d, kd);
      }
      __syncthreads();  // the chunk buffer is free for the factors
    }

    // the element, gene by gene of the thread's four (uniform over the
    // warp); this thread's cells' cf and omega read here, not held across
    // the passes
    bool cvalid[Q];
    float cfv[Q], omv[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int c = lane * Q + j;
      cvalid[j] = c < tn;
      cfv[j] = cvalid[j] ? cf[x.chain * cs.cf + c0 + c] : 0.0f;
      omv[j] = (VEL && cvalid[j]) ? omega[x.chain * cs.omega + c0 + c] : 0.0f;
    }
    const size_t rowS0 = (static_cast<size_t>(x.g0) * Nc + c0) * sizeof(TS) + s_mis;
    const size_t rowU0 = (static_cast<size_t>(x.g0) * Nc + c0) * sizeof(TU) + u_mis;
    const bool first = x.s == 0;
    float chunk_loss = 0.0f;
#pragma unroll 1
    for (int i = 0; i < Q; ++i) {
      const int gl = warp * Q + i;
      const bool gv = gl < x.gn;
      const GeneCols cc = s_cols[gl];
      const unsigned char* rs =
          ring + gl * ROW_S + ((rowS0 + static_cast<size_t>(gl) * Nc * sizeof(TS)) & 15u);
      const unsigned char* ru =
          ring_u + gl * ROW_U + ((rowU0 + static_cast<size_t>(gl) * Nc * sizeof(TU)) & 15u);
      float ev[Q], dv[Q], f0[Q], f1[Q], gs[NGS];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        ev[j] = i == 0 ? e[0][j] : i == 1 ? e[1][j] : i == 2 ? e[2][j] : e[3][j];
        dv[j] = i == 0 ? d[0][j] : i == 1 ? d[1][j] : i == 2 ? d[2][j] : d[3][j];
        f0[j] = f1[j] = 0.0f;
      }
#pragma unroll
      for (int v = 0; v < NGS; ++v) gs[v] = 0.0f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int c = lane * Q + j;
        const bool valid = gv && cvalid[j];
        const float kS = static_cast<float>(*reinterpret_cast<const TS*>(rs + c * sizeof(TS)));
        const float elogS = ev[j] + cfv[j];
        if constexpr (!VEL) {
          if constexpr (!GRAD) {
            float lp = nb_lp<true>(kS, -cc.log_r - elogS, cc);
            if (!lgk_skip) lp -= lgamma_pos(kS + 1.0f);
            chunk_loss += valid ? lp : 0.0f;
          } else {
            float lp, g_elog, g_r;
            nb_lp_grads<WANT_DISP, true>(kS, -cc.log_r - elogS, cc, lp, g_elog, g_r);
            if (!lgk_skip) lp -= lgamma_pos(kS + 1.0f);
            if (!valid) {
              lp = 0.0f;
              g_elog = 0.0f;
              g_r = 0.0f;
            }
            chunk_loss += lp;
            f0[j] = g_elog;
            gs[0] += g_r;
            if (first) csum[0][j] += g_elog;
          }
        } else {
          const float kU = static_cast<float>(*reinterpret_cast<const TU*>(ru + c * sizeof(TU)));
          const float dEi = dv[j];
          const float xg = __fadd_rn(__fmul_rn(dEi, omv[j]), s_gam[gl]);
          const float xr = fmaxf(xg, 0.0f) + 1e-5f;
          const float elogU = (s_nlb[gl] + logf(xr)) + elogS;
          const float log_bS = -cc.log_r - elogS;
          const float log_bU = -cc.log_r - elogU;
          if constexpr (!GRAD) {
            float lpS = nb_lp<true>(kS, log_bS, cc);
            if (!lgk_skip) lpS -= lgamma_pos(kS + 1.0f);
            float lpU = nb_lp<true>(kU, log_bU, cc);
            if (!lgk_skip) lpU -= lgamma_pos(kU + 1.0f);
            chunk_loss += valid ? lpS + lpU : 0.0f;
          } else {
            float lpS, gS, grS, lpU, gU, grU;
            nb_lp_grads<WANT_DISP, true>(kS, log_bS, cc, lpS, gS, grS);
            if (!lgk_skip) lpS -= lgamma_pos(kS + 1.0f);
            nb_lp_grads<WANT_DISP, true>(kU, log_bU, cc, lpU, gU, grU);
            if (!lgk_skip) lpU -= lgamma_pos(kU + 1.0f);
            float lp = lpS + lpU;
            float g_r = grS + grU;
            if (!valid) {
              lp = 0.0f;
              gS = 0.0f;
              gU = 0.0f;
              g_r = 0.0f;
            }
            const float g_e = gS + gU;                              // ElogU includes ElogS
            const float g_x = gU * (xg > 0.0f ? 1.0f / xr : 0.0f);  // relu + log chain
            chunk_loss += lp;
            f0[j] = g_e;
            f1[j] = g_x * omv[j];
            gs[0] += g_r;
            gs[NGS - 2] += -gU;
            gs[NGS - 1] += g_x;
            if (first) {
              csum[0][j] += g_e;
              csum[NS - 1][j] += g_x * dEi;
            }
          }
        }
      }
      if constexpr (GRAD) {
        *reinterpret_cast<float4*>(s_fac + gl * PT + lane * Q) = make_float4(f0[0], f0[1], f0[2], f0[3]);
        if (VEL)
          *reinterpret_cast<float4*>(s_fac + (G + gl) * PT + lane * Q) =
              make_float4(f1[0], f1[1], f1[2], f1[3]);
        // the gene's sums over the tile's cells: the warp holds every cell
        if (first) {
          float* gp = gene_part + (static_cast<size_t>(gtile) * Ng + x.g0 + gl) * NV + W;
#pragma unroll
          for (int v = 0; v < NGS; ++v) {
            const float sum = warp_sum(gs[v]);
            if (lane == 0 && gv) gp[v] = sum;
          }
        }
      }
    }
    if (first) loss += static_cast<double>(chunk_loss);
    __syncthreads();  // the counts are read; the factors are complete
    if (u + 1 < u1) issue_counts(u + 1);
    cp_async_commit();

    if constexpr (PASS_B) {
      // pass B: dnu of the sweep's columns; a lane's 4 genes (q + 8 i) x 4
      // columns over one quarter of the cells, then the quarters reduced
      const int q = lane & 7;
      const int ks = lane >> 3;
      for (int hq = warp; hq < Wq; hq += kWarps) {
        float o[Q * Q];
#pragma unroll
        for (int v = 0; v < Q * Q; ++v) o[v] = 0.0f;
        const float* zr = s_z + hq * Q * PT;
        for (int c = ks * (T / 4); c < (ks + 1) * (T / 4); c += 4) {
          float4 f[Q];
#pragma unroll
          for (int i = 0; i < Q; ++i) f[i] = ld4(s_fac + (q + 8 * i) * PT + c);
#pragma unroll
          for (int jj = 0; jj < Q; ++jj) {
            const float4 z = ld4(zr + jj * PT + c);
#pragma unroll
            for (int i = 0; i < Q; ++i) dot4(f[i], z, o[i * Q + jj]);
          }
          if (VEL) {
#pragma unroll
            for (int i = 0; i < Q; ++i) f[i] = ld4(s_fac + (G + q + 8 * i) * PT + c);
#pragma unroll
            for (int jj = 0; jj < Q; ++jj) {
              const float4 z = ld4(zr + (Wz + jj) * PT + c);
#pragma unroll
              for (int i = 0; i < Q; ++i) dot4(f[i], z, o[i * Q + jj]);
            }
          }
        }
        // reduce-scatter over the quarters (lane bits 3 and 4): afterwards
        // the lane holds gene q + 8 (2 b3 + b4), its 4 columns
        const bool up3 = (lane & 8) != 0;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const float send = up3 ? o[v] : o[v + 8];
          const float keep = up3 ? o[v + 8] : o[v];
          o[v] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        const bool up4 = (lane & 16) != 0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float send = up4 ? o[v] : o[v + 4];
          const float keep = up4 ? o[v + 4] : o[v];
          o[v] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        const int gl = q + 8 * (2 * static_cast<int>(up3) + static_cast<int>(up4));
        if (gl < x.gn) {
          float* gp = gene_part + (static_cast<size_t>(gtile) * Ng + x.g0 + gl) * NV + a + hq * Q;
#pragma unroll
          for (int jj = 0; jj < Q; ++jj)
            if (a + hq * Q + jj < W) gp[jj] = o[jj];
        }
      }
    }

    if constexpr (PASS_C) {
      // pass C: the sweep's cell gradients, a thread's 4 columns x 4 cells
      // of one basis block summed over the unit's genes in order, added to
      // the accumulators
      for (int m = tid; m < 32 * Wq * NB; m += kThreads) {
        const int blk = m / (32 * Wq);
        const int hq = (m >> 5) - blk * Wq;
        const int cq = m & 31;
        float o[Q][Q];
#pragma unroll
        for (int hh = 0; hh < Q; ++hh)
#pragma unroll
          for (int jj = 0; jj < Q; ++jj) o[hh][jj] = 0.0f;
        const float* fr = s_fac + blk * G * PT + cq * Q;
        const float* nr = prm + hq * Q;
#pragma unroll 4
        for (int g = 0; g < G; ++g) {
          const float4 f = ld4(fr + g * PT);
          const float4 n = ld4(nr + g * Wz);
#pragma unroll
          for (int hh = 0; hh < Q; ++hh)
#pragma unroll
            for (int jj = 0; jj < Q; ++jj) o[hh][jj] = fmaf(elem(f, jj), elem(n, hh), o[hh][jj]);
        }
#pragma unroll
        for (int hh = 0; hh < Q; ++hh) {
          float4* p = reinterpret_cast<float4*>(s_acc + (blk * Wz + hq * Q + hh) * PT + cq * Q);
          float4 v = *p;
          v.x += o[hh][0];
          v.y += o[hh][1];
          v.z += o[hh][2];
          v.w += o[hh][3];
          *p = v;
        }
      }
    }
    if (PASS_B) __syncthreads();  // the unit's factors, rows and nu are free
  }
  if (PASS_C && cur >= 0) flush(cur);
  cp_async_wait<0>();
  flush_loss();
}

// The cell gradients (K, Nc, W) per basis block and (K, Nc) per scalar row
// from the pieces (pieces, rows, K * Nc): each row's pieces (those of its
// column's sweep; the scalar rows the first sweep's) added in the order of
// the CTAs that wrote them.  Phase rows [dzeta, dcf]; velocity [dzeta,
// dzeta_dphi, dcf, domega].
template <int STAGE>
__global__ void wide_cell_sum_kernel(const float* __restrict__ cell_piece, int Ng, int Nc, int K,
                                     int W, int Wz, int sweeps, int grid,
                                     float* __restrict__ dzeta, float* __restrict__ dzdphi,
                                     float* __restrict__ dcf, float* __restrict__ domega) {
  const long long KNc = static_cast<long long>(K) * Nc;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= KNc) return;
  const int NR = cell_rows(STAGE, W);
  const int ch = static_cast<int>(v / Nc);
  const int c = static_cast<int>(v - static_cast<long long>(ch) * Nc);
  const int n_chunks = (Ng + kGeneChunk - 1) / kGeneChunk;
  const int tiles = (Nc + kCellsPerTile - 1) / kCellsPerTile;
  const long long n_units = static_cast<long long>(K) * tiles * sweeps * n_chunks;
  const long long gt0 = (static_cast<long long>(ch) * tiles + c / kCellsPerTile) * sweeps;
  for (int r = 0; r < NR; ++r) {
    const int col = r < W ? r : (STAGE == VELO && r < 2 * W) ? r - W : 0;
    const long long first = (gt0 + col / Wz) * n_chunks;
    const int n = unit_owner(first + n_chunks - 1, n_units, grid) -
                  unit_owner(first, n_units, grid) + 1;
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
