#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`velocycle_tpu_torch`).

    python3 chip_smoke.py [--seed 0] [--digest | --kernels | --mcmc | --smc |
                           --minibatch | --velo2d | --examples | --tiles |
                           --sharded | --wide | --plain [PARTS] |
                           --fwdgrad-times | --turns ROOT] [--package ROOT]

Run from the root of a checkout, on a machine with one CUDA card.  Phases,
in order; any failure exits non-zero and prints no result line:

  1. report the card (name, count, nvidia-smi name and power limit);
  2. build every CUDA kernel from velocycle_tpu_torch/csrc/ (one nvcc per
     source, started together; beside them, at niceness 19, the copies of
     [tiles]' other layouts) and print ptxas' registers / static shared
     memory / spills beside each main-path and ladder instantiation's
     dynamic shared memory;
  3. print a digest of each of the four kernels' full-width results
     (``--digest`` prints them alone, with any checkout's package: equal
     digests mean bit-identical results), then hold each kernel against
     its plain torch version on the card: at full width (2048 genes x
     102,400 cells, Nh=5, int16 counts), at ragged shapes, with delta_nu
     (Nb=2), with disp_grad True and False, for the velocity pair a gated
     case where omega ~ N(0, 1) puts a stated share of elements below the
     relu and float32 S beside int16 U (and the reverse), and in both
     stages basis widths off the instantiations (Nh = 4, 9, 11) and more
     batches than they take as such (Nb = 5, 6);
  4. time each kernel, its plain version and its bound with CUDA events
     (the kernel's ms: the median of 5 repetitions of 20 calls after one
     untimed repetition, every repetition printed), and print each
     main-path kernel's grid and resident CTAs and warps per SM
     (``--kernels``: build, then this for the four main-path kernels
     alone);
  5. the roofline ladder (the port of tools/kernel_profile.py: compile-time
     cuts of the phase kernels' one body, csrc/phase_kernel.cuh, launched
     through csrc/nb_phase.cu): hold each rung against its plain version
     (int16 and float32 at full width and at 257 x 3001, float32 at the
     ragged shapes) and require v_full to be bit-identical to
     phase_fwdgrad, time each rung beside its plain version and, where one
     PyTorch call computes it, that call, and the stream rung's achieved
     bytes per second; then drive the ladder tool's entry
     point `run_ladder` at full width for int16 and float32 counts, counting
     its launches (counts set to 0 just before, read just after), and print
     the rung differences;
  6. drive the two-stage workflow at full width through the user entry
     points, counting the kernel launches of each stage (counts set to 0
     just before it, read just after):
       stage 1: preprocess_for_phase_estimation(use_fused_nb=True) ->
       PhaseFitModel(num_samples=8).fit(num_steps=50) -> one loss-only
       evaluation;
       stage 2: preprocess_for_velocity_estimation(model_type="lrmn",
       use_fused_nb=True) -> VelocityFitModel conditioned on stage 1's nu,
       phi_xy and shape_inv, num_samples=2 -> fit(num_steps=50) -> one
       loss-only evaluation;
     before the stages, [tiles]: the layout ladder tool
     (velocycle_tpu_torch/tools/kernel_ladder.py) at its shapes, the
     package's layout of each family in this process and one other in a
     copy of the package built with other constants (16x512xi16 for phase,
     8x512xi16 for velo): ms per step of the fused call's loss and every
     gradient, each layout's loss within rel 1e-5 of the package layout's,
     the in-process rows' launches counted (``--tiles``: build, then the
     sweep alone, three layouts per family at int16 and float32);
     after each stage's [support], [sharded] (a) on its data (phase 11),
     then [wide] (a) on it (phase 14);
     after each stage's [minibatch] (below), [support] on its data:
     warmup on its metaparams (the build already done), 50 uninterrupted
     SVI steps against 25 + Checkpointer.save + restore into a fresh SVI's
     state + 25 (losses and every param and Adam moment bit-equal, exactly 50
     phase_fwdgrad or velo_fwdgrad launches per run; .npz bytes, save and
     restore ms), for stage 1 profiling.trace around 5 steps (the trace
     must name the phase kernel) with StepTimer and device_memory_stats,
     and check_model's site table;
     after each stage, [minibatch] on its preprocessed data (no second
     preprocessing): MinibatchSVI with 8 blocks of 12,800 cells.  Stage 1:
     the block objective (at the guide's draws, the mean of the scaled
     block losses against the full-batch loss, rel 1e-5, on the fused
     kernels), the on-device fit (2 epochs, falling epoch means, exactly
     one phase_fwdgrad per step), the streamed fit from pinned host int16
     blocks for one epoch against fit(shuffle=False) (losses and params
     rtol 1e-6; the device memory it needs below what full-batch SVI
     steps need: the data and their peak above it),
     steps/s, launches per step, busy share, and the host-to-device
     copies' overlap with kernels under torch.profiler.  Stage 2: the block
     objective (``--minibatch``: build, then both stages preprocessed and
     this phase alone);
  7. [quickstart]: the README quick start and example 06's gauge fixes at
     full width through the port's public API: the counts (the main path's
     draw, 1,918 cycling genes and 130 fillers, a three-class phase label)
     written to disk as CSR (.h5ad when h5py imports, else MatrixMarket) and
     read back, normalize_total, Phases.from_pca_heuristic on the card (a
     4,096-cell subset held against the CPU's float64 angles to 1e-5 rad)
     and from_lda_heuristic, invert_direction (twice: the same bits back) and
     shift_zero on the pair, the phase fit (check_model clean, 20 steps,
     two snapshots) and the LRMN velocity fit (20 steps), each counted
     (phase_fwdgrad and velo_fwdgrad once per step), CSV save / load exact,
     period_hours and the grid MLE prior (Poisson, 100 bins); every time
     printed beside the card;
  8. [variants]: the model variants at full width through the public entry
     points.  First phase_fwdgrad / phase_fwd and velo_fwdgrad / velo_fwd
     at the default spline basis' 11 columns, held against their plain
     versions (disp_grad both ways) and timed beside their bounds.  Then
     (a) the spline two-stage fit on example 04's draw (pseudotime t ~
     U(0, 1), an 11-column spline field, kinetic U at omega = 0.5, int16
     counts drawn on the card): Cycle.spline_prior, stage 1 with phi free
     (50 steps, exactly 50 phase_fwdgrad launches at width 11, one loss-only
     evaluation = one phase_fwd), stage 2 with a constant speed
     conditioned on stage 1's phi and nu (50 steps, 50 velo_fwdgrad at
     width 11, one velo_fwd), phi_locs inside (0, 1), period_hours over the
     domain finite and positive; (b) the wrapped phases on the main path's
     draw (50 phase_fwdgrad at width 5); (c) LBA, 20 steps of the analytic
     mixture, then the enumerated form under TraceEnum_ELBO at the fitted
     params (losses equal to rtol 1e-5, no kernel launch).  Losses finite
     and falling, steps/s, device profiles and peak memory printed;
  9. [mcmc]: NUTS over the phase model at the JAX package's MCMC design
     points (bench.py), the chains batched through ONE phase_fwdgrad launch
     per leapfrog step.  First, before phases 6-8 (which run after it), the
     chain-batched launch held against its plain version and against K
     single launches ([parity]: (a)'s shape at K = 64 with zeta batched,
     (b)'s at K = 256 with nu and r batched, full width at K = 4, and K = 1
     bit-identical to the unbatched launch) and timed beside K single
     launches and its bound ([timing]), with [variants]' 11-column kernels
     timed too: no other process shares the card while a kernel is timed.
     Then runs (a) and (b), host-bound, each in a process of its own
     (spawned after phase 6, whose stages run alone; stopped in every
     case) beside phases 7-8, their output printed when they end; so the
     runs' rates and phases 7-8's are not taken alone (``--mcmc``: build,
     then this phase alone, the runs in turn in one process, (c) with its
     ridge check and its plain run).  (a)
     `nuts_phi_wrapped`: 2,000 cells x 50 genes, an 800-step phase fit, then
     MCMCFitModel on the wrapped phases with the genes conditioned (400-step
     SVI warm start, the Hessian diagonal through the plain path), 64
     chains x (400 warmup + 150 draws; 200 + 100 in the default run),
     max_depth 6; gates: phi in [-pi,
     pi), accept > 0.6, circular correlation with the SVI phases > 0.95,
     max split R-hat < 1.05.  (b) `nuts`: 500 x 50, phases conditioned, a
     500-step SVI warm start, nu and shape_inv sampled in the whitened
     coordinates of the Fisher blocks and the Hessian diagonal, 256 chains
     x (400 + 100; 200 + 100 in the default run), max_depth 6; gates:
     accept > 0.3, finite draws,
     posterior-mean nu against the SVI locs corr > 0.95, max split R-hat
     < 1.05.  (c) velocity NUTS on fused int16 counts (50 x 500, the
     Fourier model, Nh = 3, phi_xy and shape_inv conditioned so that
     velo_fwdgrad runs without the dispersion gradient; MCMCFitModel with
     a 500-step SVI warm start, 64 chains x (200 + 100), max_depth 5; in a
     third process); gates: finite draws, accept > 0.5, exactly one K = 64
     velo_fwdgrad per batched evaluation (R-hat and ESS printed by site,
     no gate: the kinetic scale ridge).  ``--mcmc`` then holds (c)'s fused
     potential and gradient against the plain path's at 9 points of the
     (beta, gamma, omega) scale ridge (log_beta + t, log_gamma + t,
     nu_omega e^t, t in [-2, 2]) through a prior draw and through (c)'s
     last draw, one chain batch each (loss rel 1e-5, gradient 5e-4), and
     runs (c) again on the plain path with the same seeds, chains, warmup
     and depth, its R-hat and ESS by site printed beside the fused run's.
     Before the runs, [velo chains]: the
     chain-batched velo_fwdgrad and velo_fwd held against their plain
     versions mapped over the chains and K single launches (K = 1, 4, 64,
     256, the dispersion gradient both ways, full width at K = 4, 11
     columns, delta_nu; K = 1 bit-identical) and timed (rows 3'' and 4'').
     Each run:
     launches by chain count (exactly one per batched potential
     evaluation), evaluations per iteration, wall time, split R-hat and
     ESS, a device profile over four transitions, peak memory;
 10. [smc]: tempered SMC over the phase model at the JAX package's SMC
     design points (bench.py `_smc_row`), the particles batched through
     ONE phase_fwd launch per stage (its log-likelihood over the particles)
     and ONE phase_fwdgrad launch per leapfrog of the HMC moves.  First,
     beside [mcmc]'s, the chain-batched phase_fwd held against its plain
     version and K single launches (K = 256 at (a)'s and (b)'s shapes, full
     width at K = 4, K = 1 bit-identical) and timed beside K single launches
     and its bound.  Then, alone after the [mcmc] processes end,
     SMCFitModel on fused int16 counts, phases conditioned, 256 particles,
     2 moves of 8 leapfrogs per stage: (a) `smc`, prior tempering, 20 genes
     x 200 cells, target_ess 0.35, max_stages 60; (b) `smc_bridged`, the
     variational bridge after an 800-step SVI warm start, 50 x 500; then at
     16 x 60 (tests/test_fit_mcmc.py's fixture) the bridge against prior
     tempering.  Gates: beta reaches 1 on an increasing schedule, finite
     logZ and posterior, (b) fewer stages than (a), at 16 x 60 logZ within
     2 nats and posterior-mean nu within 0.2, and exactly one K = 256
     phase_fwd per stage and one K = 256 phase_fwdgrad per batched
     potential evaluation; then (c) velocity prior tempering at 20 x 200
     (phases conditioned, shape_inv free), one K = 256 velo_fwd per stage
     and one velo_fwdgrad per batched evaluation.  Each run: stages,
     particle-moves/s, wall time,
     host time per evaluation, a device profile over one stage, peak
     memory (``--smc``: build, then this phase alone);
 11. [sharded]: the port's parallel/ on the one card (one process per
     rank, torch.distributed; NCCL refuses two ranks on one device, so two
     ranks share it over gloo, which stages CUDA tensors through host
     memory: they show the sharded program correct on the card, they
     measure contention, not scaling).  (a) Inside phase 6, after each
     stage's [support], on its full-width data: one rank over NCCL, 50
     `SVI.update` steps, then 50 sharded steps (`shard_phase_data` /
     `shard_velocity_data`, `SVI.init_sharded`) from the same seed, bit for
     bit equal (losses, params, Adam moments), exactly 50 launches of the
     stage's kernel each.  Then, alone after [smc]: (b) two ranks sharing
     the card over gloo, 51,200 cells each, each drawing the [main] counts
     on the card from --seed and keeping its cells around a host template
     of (a)'s data (no second host preprocessing): 50 steps of stage 1 and
     of stage 2 (LRMN, conditioned on stage 1's fit), the losses against
     (a)'s within rtol 2e-4 over steps 1-20 and 2e-3 over all 50, the
     ranks' losses, replicated params and Adam moments bit-identical,
     exactly one launch per rank per step; per rank steps/s, busy share,
     peak memory and the ms per step in the all-reduce (torch.profiler).
     Then, beside [examples] at the end (host-bound both; their wall times
     are not taken alone): (c) at two ranks, [mcmc] (a)'s NUTS with its
     chains split (64 chains, cut to 100 warmup + 80 draws; its gates,
     R-hat < 1.05) and [smc] (a) and (c) (the fused velocity model) with
     their particles split (their gates, |delta log Z| < 2 against the
     one-rank runs), one launch of a rank's chains or particles per
     batched evaluation; (d) example 05 at its smoke size, --world 2
     --backend gloo, exit 0 with its four lines (``--sharded``: build, the
     stages at full width for (a)'s data, (a)-(d), then
     `parallel.phase_weak_scaling` at one and two ranks on the card, gloo);
 12. [velo2d], alone after [sharded] (b): the 2-D extension (twodim), which
     reaches none of the NB kernels (checked: every launch count stays 0).
     (a) the reference's published run, run_simulations' defaults: for
     seeds 0 and 1, generate_adata (1,000 cells x 200 genes) ->
     prepare_data on the card -> train_velo2d (1,000 steps per stage) ->
     evaluate_fit, gated as tests/test_twodim.py (both losses fall, corr
     ElogS > 0.9, ElogU > 0.6, log_beta > 0.4), the seven correlations
     printed; (b) the Stereo-seq-class width, 2048 genes x 102,400 cells:
     (a)'s seed-0 genes tiled, cells placed from --seed by the simulator's
     branching positions, ElogS / ElogU formed and S / U drawn on the card
     (float32), train_velo2d 200 steps per stage, gated on finite falling
     losses; the data's build time, each stage's steady-state steps/s,
     launches per step, busy share and peak memory, and the correlations
     with the tiled truth (``--velo2d``: build, then this phase alone);
 13. [examples], last, beside [sharded] (c) and (d): the port's examples
     01-04 and 06 through their command lines, each in a process of its
     own at its smoke size
     (VCT_SMOKE=1), all five at once; gates: exit 0, example 06 launches
     phase_fwdgrad, 01-04 no kernel (the plain path, as the JAX examples);
     each one's wall time, launches and output printed (``--examples``:
     build, then the five at their published sizes, in turn, with their
     quality lines);
 14. [wide]: the wide body (csrc/wide_kernel.cuh through csrc/nb_wide.cu),
     which runs every shape past the narrow bodies' 16 basis columns
     (delta_nu batches folded in), at any width.  (b) and (c) beside the
     other kernel timings, before the [mcmc] processes: (b) the four wide
     kernels against their plain versions (the wide twins) at 17, 21, 33,
     64, 130, 256 and 257 columns (Nh alone, and Nh 5 with 12, 16, 59 or
     252 batches; 21, 64 and 130 at full width; 130, 256 and 257 past the
     velocity pair's shared-memory fit, 256 and 257 past the phase pair's:
     the tile's genes swept once per chunk of columns), int16 and float32
     counts, the dispersion gradient both ways, both stages, a misaligned
     view (phase), mixed count types and a gated share (velocity); every
     width from 17 to 320 through phase_fwdgrad and velo_fwdgrad at 24 x
     300 (one wide launch each, none raises); the chain-batched pair at K =
     64, 50 x 2,000, 21 columns and at K = 4, 40 x 300, 257 columns against
     its plain version and single launches.  (c) each wide kernel at 21 and
     64 columns at full width (the median of 5 x 20 calls) beside its plain
     version and its bound, float32 counts at 21, the chain-batched
     launch's device time (``--wide`` adds the fwd+grad pair at 257 columns
     and the per-pass cuts at 21).  (a) inside phase 6, after
     each stage's [sharded] (a), on its preprocessed counts: the batch
     design of 16 sections of 6,400 cells (make_design_matrix on an obs
     column), delta_nu on (21 kernel columns): stage 1 PhaseFitModel, 50
     steps; stage 2 VelocityFitModel (LRMN) conditioned on (a)'s stage 1,
     50 steps; exactly one wide fwd+grad launch per step and one wide
     loss-only launch per evaluation, falling losses, the ELBO at step 0
     fused against plain (rel 1e-5), steps/s, busy share, peak memory.
     ``--wide``: build, (b), (c), then (a) on its own preprocessing through
     the front door (the batch design given to both preprocessing entry
     points, their Db, Nb, sd_dnu and mu_dnu compared with the default
     run's swap), then the batch-corrected paths on the wide body: (f)
     [minibatch]'s phase on (a)'s stage 1 data (8 blocks of 12,800 cells,
     Db cut per block; block objective rel 1e-5, streamed equal to
     resident, launches under phase_fwdgrad_wide); (g) the sharded step in
     both stages at 21 columns, one rank over NCCL bit-equal to
     SVI.update and two ranks over gloo with Db split by cells within rel
     2e-6 after 20 steps (correctness only); (d) phase NUTS at 50 x 2,000,
     16 batches of 125 cells, H = 2 (21 columns), nu, delta_nu and
     shape_inv sampled, 64 chains x (200 + 100), max_depth 5, a 500-step
     SVI warm start (finite draws, accept > 0.5, one K = 64
     phase_fwdgrad_wide launch per batched evaluation, no narrow launch,
     8 drawn states fused against plain; R-hat and ESS printed by site
     and for what the likelihood identifies: each gene's level in the
     mean batch, its offsets about it, nu's harmonics); (e) phase and
     velocity prior-tempering SMC at 20 x 200, 256 particles, 20 batches
     of 10 cells (23 columns: one K = 256 *_fwd_wide per stage; the final
     particles' log-likelihood against the plain path's; for each of 4
     seeds the run's log Z against the same run on the plain path, the
     plain log-likelihood at its stages' particles and betas, within
     LOSS_RTOL x |log Z|; independent plain runs, and each path run again
     from the first seed, printed beside it);
     one JSON line of the runs' launches by kernel and chain count;
 15. print each phase's seconds on one line ([phases]), the kernel table
     as one JSON line, the nvidia-smi line, and last {"ok": true,
     "device": {...}}.

``--plain`` (not in the default run; the build first, for the fused
element in (a) and (c)): the plain NB element (ops/likelihoods.py
NBLogPmf), the path of every use_fused_nb=False fit, on [main]'s counts
preprocessed with default metaparams.  (a) the plain and the fused
elements' dispersion gradients against float64 at full width, gene
dispersions spread 1.8x around each of shape_inv 1e-6 .. 1e-2 (both:
largest error below 1e-6 of the largest gradient over every gene, median
over the genes at most 1e-4), each worst gene named with its a = 1/r and
y - a - 2, and for the fused element the kernel on that gene's row
against its plain version on the same row; then every gene's a drawn
where y = a + 2 rounds in float32 (a < 2 and [2^n - 2, 2^n), n = 2..13;
no float32 r gives one from n = 14 on): the four fwd+grad kernels
(narrow at 5 columns, wide at 21) and the plain element, each within
1e-6 of float64's largest gradient; (b) PhaseFitModel, then
LRMN VelocityFitModel conditioned on it, and the LBA PhaseFitModel, 20
steps each at full width (no kernel launch, finite and falling losses, the step-0 loss equal to the
parent tree's at seed 0 bit for bit; steps/s, busy share, peak memory,
and the tensors autograd saves and the passes one element makes); (c)
[mcmc] (b)'s configuration: the shape_inv Hessian diagonal through the
plain path against float64's at the warm start and at fixed values at
shape_inv 1e-6 .. 1e-4 (median relative error at most 1e-3; the direct
form's beside it, which must miss that gate at one of the fixed values),
then MCMCFitModel on the fused and plain paths, split R-hat below 1.05
on both.  ``--plain b`` runs (b) alone, without the build.

The configuration is the repository's Stereo-seq-class fit (bench.py
"phase_scale" and "velo_scale_svi"): NB likelihood, fused kernels, int16
counts, ``lgamma_k_sum`` given, no delta_nu; spliced counts
floor(exp(N(1, 0.8^2))) and unspliced floor(exp(N(0.4, 0.8^2))) are drawn on
the card from --seed.  Nothing here falls back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
import types

NG, NC, H = 2048, 102_400, 2
NH = 2 * H + 1
RAGGED = [(1, 1), (129, 257), (3, 300)]
LOSS_RTOL = 1e-5        # tests/test_nb_kernels.py:32
GRAD_RTOL = 1e-4        # max|a-b| / max|a|, tests/test_nb_kernels.py:52
VELO_GRAD_RTOL = 5e-4   # max|a-b| / max|a|, tests/test_nb_kernels.py:199

# FP32 operations per count-matrix element, counted from csrc/phase_kernel.cuh
# with Nh = 5 and no delta_nu (a transcendental or a division counts 1):
#   common: ElogS dot + cf 11, log_b 1, count convert 1, lp 4, loss 1
#   fwdgrad: softplus + log sigmoid + sigmoid and its complement 13,
#            g_elog 3, dcf + ddisp 2, dzeta + dnu accumulation 20
#   fwd: softplus + log sigmoid 7
#   lgamma ratio: Stirling difference 22 (needed where k >= 2), small-k sum
#                 5 (where k < 2), branch select 2
#   the dispersion gradient g_r (disp_grad only): per element on the
#                 branch its gene and its inputs take,
#                 tools/kernel_profile.py DISP_OPS (_disp_ops)
OPS = {
    "common": 18,
    "fwdgrad": 38,
    "fwd": 7,
    "lg_stir": 22, "lg_small": 5, "lg_sel": 2,
}
# the cell sum of g_r, which disp_grad=False compiles out with g_r
OPS_DISP = 1
# FP32 operations per (S, U) element pair, counted from csrc/nb_velo.cu with
# Nh = 5 and no delta_nu; the NB terms as in OPS, once for S and once for U:
#   common: 2 count converts, ElogS dot + cf 11, dEs 10, x 2, xr 2,
#           ElogU log + 2 adds 3, 2 x (log_b 1, lp 4), lp sum + loss 2
#   fwdgrad: 2 x (softplus + log sigmoid + sigmoid and its complement 13,
#            g_elog 3), g_e 1, relu gate + 1/xr 4, g_x * omega 1, dcf 1,
#            domega 2, dzeta 10, dzeta_dphi 10, dnu terms 15, -gU 1, the
#            sums over cells of the 7 gene-indexed values 7
#   disp (disp_grad only): g_r sum 1, its cell sum 1 (and g_r of S and of
#         U as in OPS)
#   fwd: 2 x softplus + log sigmoid 7
#   lgamma ratio: per count as in OPS, over S and U
OPS_VELO = {"common": 43, "fwdgrad": 84, "disp": 2, "fwd": 14}
# each basis column past Nh = 5 adds, per element: phase common 2 (the
# ElogS dot), phase fwdgrad 4 (dzeta and dnu); velocity common 4 (the
# ElogS and dEs dots), velocity fwdgrad 7 (dzeta 2, dzeta_dphi 2, dnu 3)
OPS_PER_COLUMN = {"common": 2, "fwdgrad": 4, "velo_common": 4,
                  "velo_fwdgrad": 7}
# each delta_nu batch adds, per element and in either stage, what the
# function needs of it: its offset's multiply-add into ElogS 2 and, with
# the gradients, its ddelta_nu multiply-add 2.  No dzeta, no dEs, no
# dzeta_dphi: the wide body's folded columns do that work too, but the
# function does not need it (PERF.md section 6)
OPS_PER_BATCH = {"common": 2, "fwdgrad": 2}
W_SPLINE = 11           # the default spline basis: spline_n_basis + 1


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _basis(phi, nh, der=0):
    """The first nh Fourier basis columns at phases phi."""
    from velocycle_tpu_torch.ops.fourier import fourier_basis

    return fourier_basis(phi, nh // 2, der=der)[:, :nh].contiguous()


def make_inputs(torch, Ng, Nc, seed, Nb=0, int16=True, device="cuda",
                view=False, nh=NH):
    """Kernel inputs drawn on the card: counts floor(exp(N(1, 0.8^2))) (as
    bench.py's phase_scale), Fourier zeta (nh columns) at random phases.
    ``view``: S is rows 1: of an (Ng + 1, Nc) matrix, so with an odd Nc its
    first element is off a 16-byte boundary."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    S = torch.floor(torch.exp(rn(Ng + int(view), Nc) * 0.8 + 1.0))
    S = (S.to(torch.int16) if int16 else S)[int(view):]
    nu = rn(Ng, nh) * 0.4
    nu[:, 0] += 0.5
    zeta = _basis(rn(Nc) * 3.0, nh)
    cf = rn(Nc) * 0.1
    r = (rn(Ng) * 0.2 + 0.5).abs() + 0.05
    dnu = Db = None
    if Nb:
        dnu = rn(Nb, Ng) * 0.1
        groups = torch.randint(0, Nb, (Nc,), generator=g, device=device)
        Db = (torch.arange(Nb, device=device)[:, None] == groups[None, :]).float()
    return S, nu, zeta, cf, r, dnu, Db


def make_velo_inputs(torch, Ng, Nc, seed, Nb=0, int16=True, gated=False,
                     device="cuda", u_int16=None, nh=NH):
    """Velocity kernel inputs: the phase inputs of the same seed plus U
    floor(exp(N(0.4, 0.8^2))) (bench.py's velo_scale), zeta and zeta_dphi
    at new random phases, omega exp(N(-1, 0.2^2)), log_beta and log_gamma.
    ``gated``: omega ~ N(0, 1) and gamma near exp(-1), so that a large
    share of elements sits below the relu.  ``int16`` is S's count type,
    ``u_int16`` U's (default: the same)."""
    S, nu, zeta, cf, r, dnu, Db = make_inputs(torch, Ng, Nc, seed, Nb=Nb,
                                              int16=int16, device=device,
                                              nh=nh)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    U = torch.floor(torch.exp(rn(Ng, Nc) * 0.8 + 0.4))
    U = U.to(torch.int16) if (int16 if u_int16 is None else u_int16) else U
    phi = rn(Nc) * 3.0
    zeta = _basis(phi, nh)
    zdphi = _basis(phi, nh, der=1)
    omega = rn(Nc) if gated else torch.exp(rn(Nc) * 0.2 - 1.0)
    lbeta = rn(Ng) * 0.2
    lgamma = rn(Ng) * 0.2 - (1.0 if gated else 0.0)
    return S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, r, dnu, Db


def lgamma_k_sum(torch, *counts):
    return sum(torch.lgamma(K.double() + 1.0).sum() for K in counts).float()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"[device] {name} (count {count}); nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return name, count, smi


def _ptxas_summary(log):
    """{kernel symbol: (registers, smem bytes, spill stores, spill loads)}"""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, [0, 0, 0, 0])[2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, [0, 0, 0, 0])[:2] = [regs, int(sm.group(1)) if sm else 0]
    return out


# the velocity kernels on the main path as (cut of nb_kernels.VELO_CUTS,
# want_disp): int16 S and U, Nh = 5, no delta_nu, lgamma(k+1) skipped;
# stage 2 conditions shape_inv, so velo_fwdgrad has no dispersion gradient
VELO_MAIN = {"velo_fwdgrad": ("fwdgrad", False), "velo_fwd": ("fwd", False)}
# the phase kernels on the main path as (mode of nb_kernels.PHASE_MODES,
# want_disp): int16 counts, Nh = 5, no delta_nu, lgamma(k+1) skipped
PHASE_MAIN = {"phase_fwdgrad": ("fwdgrad", True), "phase_fwd": ("fwd", False)}
# the ladder's rungs in the order of ops/ladder_kernels.py RUNGS, and the
# line of tools/kernel_profile.py that holds each one's TPU kernel
LADDER_REPLACES = {"stream": 57, "matmul": 71, "logpmf": 83, "fwdgrad": 98,
                   "v_full": 167, "v_nodig": 167, "v_nocell": 167,
                   "vpu_only": 212}
PHASE_GRADS = ("dnu", "dzeta", "dcf", "ddisp", "ddnu")
VELO_GRADS = ("dnu", "dzeta", "dzdphi", "dcf", "domega", "dlog_beta",
              "dlog_gamma", "ddisp", "ddnu")


def _phase_symbol(K, mode, want_disp, int16):
    """The mangled name of phase_kernel<TK, 5, CUT, WANT_DISP, HAS_DNU=false,
    SKIP_K=true> (csrc/phase_kernel.cuh)."""
    return (f"phase_kernelI{'s' if int16 else 'f'}Li5ELi"
            f"{K.PHASE_MODES.index(mode)}ELb{int(want_disp)}ELb0ELb1E")


def _velo_symbol(K, cut, want_disp):
    """The mangled name of velo_kernel<int16_t, int16_t, 5, CUT, WANT_DISP,
    HAS_DNU=false, SKIP_K=true> (csrc/velo_kernel.cuh)."""
    return (f"velo_kernelIssLi5ELi{K.VELO_CUTS.index(cut)}ELb{int(want_disp)}"
            f"ELb0ELb1E")


def phase_build():
    from velocycle_tpu_torch.ops import cuda_build
    from velocycle_tpu_torch.ops import ladder_kernels as L
    from velocycle_tpu_torch.ops import nb_kernels as K

    t0 = time.perf_counter()
    cuda_build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {sorted(p.name for p in cuda_build.CSRC.glob('*.cu'))} "
          f"built in {dt:.1f} s (nvcc, concurrent)")
    infos = {}
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        log = cuda_build.build_log(src.stem)
        info = infos[src.stem] = _ptxas_summary(log)
        if not info:
            print(f"[build] {src.name}: {log.strip()[:200]}")
            continue
        regs = [v[0] for v in info.values()]
        spills = max(v[2] + v[3] for v in info.values())
        print(f"[build] {src.name}: {len(info)} kernels, registers "
              f"{min(regs)}..{max(regs)}, static smem <= "
              f"{max(v[1] for v in info.values())} B, max spill bytes {spills}")

    def show(label, info, sym, dyn=None):
        if not info:     # built before this process: no ptxas report
            return
        for full, (r, sm, ss, sl) in info.items():
            if sym in full:
                extra = "" if dyn is None else f", {dyn} B dynamic smem"
                print(f"[build]   {label}: {r} registers, {sm} B static "
                      f"smem{extra}, spill stores {ss} B, loads {sl} B")
                return
        fail(f"{label}: no instantiation {sym} in the ptxas output")

    for name, (cut, wd) in VELO_MAIN.items():
        dyn = K.velo_plan(cut, True, True, NG, NC, want_disp=wd).dyn_smem
        show(f"{name} (main path)", infos["nb_velo"],
             _velo_symbol(K, cut, wd), dyn)
    for name, (mode, wd) in PHASE_MAIN.items():
        dyn = K.phase_plan(mode, True, NG, NC, want_disp=wd).dyn_smem
        show(f"{name} (main path)", infos["nb_phase"],
             _phase_symbol(K, mode, wd, True), dyn)
    for rung, (mode, wd) in L.MODES.items():
        for int16 in (True, False):
            dyn = K.phase_plan(mode, int16, NG, NC, want_disp=wd).dyn_smem
            show(f"ladder {rung} ({'int16' if int16 else 'f32'})",
                 infos["nb_phase"], _phase_symbol(K, mode, wd, int16), dyn)
    secs = {n: cuda_build.build_seconds(n) for n in infos}
    print("[build] nvcc seconds per source (concurrent): " + ", ".join(
        f"{n} {'built before' if t is None else f'{t:.1f}'}"
        for n, t in sorted(secs.items())))
    # the wide body: every instantiation (its width a runtime value), and
    # its dynamic shared memory and tile by width at full width
    for full, (r, sm, ss, sl) in sorted(infos.get("nb_wide", {}).items()):
        print(f"[build]   wide {_wide_symbol_note(full)}: {r} registers, {sm} "
              f"B static smem, spill stores {ss} B, loads {sl} B")
    for stage in K.WIDE_STAGES:
        for cut in K.VELO_CUTS:
            plans = [(W, K.wide_plan(stage, cut, True, True, NG, NC, W,
                                     want_disp=cut == "fwdgrad"))
                     for W in WIDE_PLANNED]
            print(f"[build]   wide {stage} {cut} at {NG}x{NC} int16, by width: "
                  + "; ".join(f"{W}: {_wide_plan_note(p)}" for W, p in plans))
    return dt


def _wide_plan_note(p):
    """A `WidePlan` in words."""
    return (f"{p.dyn_smem} B dynamic smem, {p.sweep_cols} resident columns x "
            f"{p.sweeps} sweep{'s' if p.sweeps > 1 else ''}"
            f"{', pass A in chunks' if p.chunked else ''}, {p.blocks_per_sm} "
            f"CTAs per SM, grid {p.grid}")


def _wide_symbol_note(symbol):
    """wide_kernel<STAGE, TS, TU, CUT, WANT_DISP>'s arguments from its
    mangled name (csrc/wide_kernel.cuh)."""
    import re

    m = re.search(r"wide_kernelILi(\d)E(\w)(\w)Li(\d)ELb(\d)E", symbol)
    if m is None:
        m = re.search(r"wide_cell_sum_kernelILi(\d)E", symbol)
        return (f"cell sum {'phase' if m.group(1) == '0' else 'velo'}" if m
                else symbol[:60])
    from velocycle_tpu_torch.ops import nb_kernels as K

    types_ = {"s": "int16", "f": "f32"}
    stage = "phase" if m.group(1) == "0" else "velo"
    counts = types_[m.group(2)] + ("" if stage == "phase"
                                   else f"/{types_[m.group(3)]}")
    cut = K.WIDE_CUTS[int(m.group(4))]
    return (f"{stage} {cut} {counts}"
            + (f" disp_grad={m.group(5) == '1'}" if cut != "fwd" else ""))


def _plan_note(torch, K, mode, want_disp, int16, Ng=NG, Nc=NC, velo=False):
    """The grid of one phase- (or velocity-) kernel call and what is
    resident per SM."""
    if velo:
        p = K.velo_plan(mode, int16, int16, Ng, Nc, want_disp=want_disp)
        lay = K.velo_layout()
    else:
        p = K.phase_plan(mode, int16, Ng, Nc, want_disp=want_disp)
        lay = K.phase_layout()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"grid {p.grid} CTAs of {lay.threads} threads on {sms} SMs, "
            f"{p.blocks_per_sm} resident CTAs = "
            f"{p.blocks_per_sm * lay.threads // 32} warps per SM, "
            f"{p.dyn_smem} B dynamic smem per CTA")


def _rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _compare(tag, k_out, p_out, names=None, grad_rtol=GRAD_RTOL):
    """Hold a kernel's (loss[, grads]) against the plain version's; names
    None means a loss alone."""
    if names is None:
        kl, pl = float(k_out), float(p_out)
        rel = abs(kl - pl) / max(abs(pl), 1.0)
        print(f"[parity] {tag}: loss {kl:.9g} vs plain {pl:.9g} rel {rel:.2e}")
        return abs(kl - pl), rel, [rel < LOSS_RTOL]
    (kl, kg), (pl, pg) = k_out, p_out
    kl, pl = float(kl), float(pl)
    lrel = abs(kl - pl) / max(abs(pl), 1.0)
    oks = [lrel < LOSS_RTOL]
    worst_abs = 0.0
    parts = [f"loss rel {lrel:.2e}"]
    for name, a, b in zip(names, kg, pg):
        if b is None:
            check(a is None, f"{tag}: {name} returned without delta_nu")
            continue
        worst_abs = max(worst_abs, float((a - b).abs().max()))
        if float(b.abs().max()) == 0.0:      # disp_grad=False: exact zero
            ok = float(a.abs().max()) == 0.0
            parts.append(f"{name} zero {ok}")
        else:
            r = _rel(a, b)
            ok = r < grad_rtol
            parts.append(f"{name} {r:.2e}")
        oks.append(ok)
    print(f"[parity] {tag}: " + ", ".join(parts))
    return worst_abs, lrel, oks


def _f64_diagnosis(kern, plain, args, n_counts, lgk, want_disp, names):
    """Error of each side against an f64 evaluation, when parity fails."""
    d = lambda t: None if t is None else t.double()  # noqa: E731
    k = kern(*args, lgk, want_disp=want_disp)
    p = plain(*args, lgk, want_disp=want_disp)
    ref = plain(*args[:n_counts], *(d(t) for t in args[n_counts:]), lgk,
                want_disp=want_disp)
    for side_name, side in (("kernel", k), ("plain", p)):
        errs = [f"loss {abs(float(side[0]) - float(ref[0])):.3e}"]
        for gname, a, b in zip(names, side[1], ref[1]):
            if b is not None and float(b.abs().max()) > 0:
                errs.append(f"{gname} {_rel(a.double(), b):.2e}")
        print(f"[parity] f64 check, {side_name}: " + ", ".join(errs))


def _parity_cases(torch, seed, make, n_counts, kern, plain, fwd, fwd_plain,
                  names, grad_rtol, cases, record="full"):
    """Run the parity cases of one kernel pair; returns ({kernel: [max abs
    error, loss rel error]} of the case tagged ``record``, all ok)."""
    fwd_name, grad_name = fwd.__name__, kern.__name__
    results = {fwd_name: [0.0, 0.0], grad_name: [0.0, 0.0]}
    all_ok = True
    for tag, Ng, Nc, Nb, int16, skip_k, extra in cases:
        args = make(torch, Ng, Nc, seed + Ng + Nc, Nb=Nb, int16=int16, **extra)
        if extra.get("gated"):
            nu, zdphi, omega, lgamma = args[2], args[4], args[6], args[8]
            x = (nu @ zdphi.T) * omega[None, :] + torch.exp(lgamma)[:, None]
            share = float((x <= 0).float().mean())
            del x
            print(f"[parity] {tag}: {share:.4f} of elements have x <= 0 "
                  f"(below the relu)")
            check(share >= 0.10, f"gated case puts only {share:.4f} below the relu")
        lgk = lgamma_k_sum(torch, *args[:n_counts]) if skip_k else None
        dtypes = " / ".join("int16" if a.dtype == torch.int16 else "f32"
                            for a in args[:n_counts])
        desc = f"{tag} ({dtypes}, lgamma_k_sum {'given' if skip_k else 'no'})"
        for want_disp in (True, False):
            kout = kern(*args, lgk, want_disp=want_disp)
            pout = plain(*args, lgk, want_disp=want_disp)
            torch.cuda.synchronize()
            wabs, lrel, oks = _compare(
                f"{grad_name} {desc} disp_grad={want_disp}", kout, pout,
                names, grad_rtol,
            )
            if not all(oks):
                all_ok = False
                _f64_diagnosis(kern, plain, args, n_counts, lgk, want_disp,
                               names)
            if tag == record:
                results[grad_name] = [max(results[grad_name][0], wabs),
                                      max(results[grad_name][1], lrel)]
            del kout, pout
        kl = fwd(*args, lgk)
        pl = fwd_plain(*args, lgk)
        torch.cuda.synchronize()
        labs, lrel, oks = _compare(f"{fwd_name} {desc}", kl, pl)
        all_ok &= all(oks)
        if tag == record:
            results[fwd_name] = [labs, lrel]
        del args
        torch.cuda.empty_cache()
    return results, all_ok


def phase_parity(torch, seed):
    from velocycle_tpu_torch.ops import nb_kernels as K

    cases = [("full", NG, NC, 0, True, True, {})]
    cases += [(f"ragged {g}x{c}", g, c, 0, i % 2 == 0, i != 1, {})
              for i, (g, c) in enumerate(RAGGED)]
    cases += [("delta_nu Nb=2 257x3001", 257, 3001, 2, True, True, {}),
              ("delta_nu Nb=2 full", NG, NC, 2, True, False, {})]
    # basis widths off the instantiations (zero-padded) and batch counts
    # beyond them (folded into basis columns), in both stages
    wide = [(f"Nh={nh} Nb={nb} 257x3001", 257, 3001, nb, True, True, {"nh": nh})
            for nh, nb in ((4, 0), (9, 0), (11, 2), (5, 5), (5, 6))]
    vcases = (cases[:1] + [("gated full", NG, NC, 0, True, True, {"gated": True}),
                           ("full f32", NG, NC, 0, False, True, {}),
                           ("S f32, U int16, full", NG, NC, 0, False, True,
                            {"u_int16": True}),
                           ("S int16, U f32, 257x3001", 257, 3001, 2, True, False,
                            {"u_int16": False})]
              + cases[1:] + wide)
    cases += wide
    # the phase kernels' count ring: float32 counts at full width, and a
    # matrix whose rows (and first element) start off 16-byte boundaries
    cases += [("full f32", NG, NC, 0, False, True, {}),
              ("misaligned view 129x3001", 129, 3001, 0, True, True,
               {"view": True}),
              ("misaligned view 129x3001 f32", 129, 3001, 2, False, True,
               {"view": True})]
    results, ok_phase = _parity_cases(
        torch, seed, make_inputs, 1, K.phase_fwdgrad,
        K.phase_fwdgrad_plain, K.phase_fwd, K.phase_fwd_plain, PHASE_GRADS,
        GRAD_RTOL, cases,
    )
    vresults, ok_velo = _parity_cases(
        torch, seed, make_velo_inputs, 2, K.velo_fwdgrad,
        K.velo_fwdgrad_plain, K.velo_fwd, K.velo_fwd_plain, VELO_GRADS,
        VELO_GRAD_RTOL, vcases,
    )
    check(ok_phase and ok_velo,
          "a kernel disagrees with its plain version (see [parity] lines)")
    return {**results, **vresults}


TIMING_REPS = 5         # timed repetitions of TIMING_CALLS calls, after one untimed
TIMING_CALLS = 20


def _median_reps(TP, fns):
    """{name: (median ms, every repetition's ms)} of each of ``fns`` (name ->
    callable), CUDA events around TIMING_CALLS back-to-back calls: one
    untimed repetition each, then TIMING_REPS timed ones, in turns.  The
    median keeps an allocator stall in one repetition out of the figure."""
    import statistics

    for fn in fns.values():
        TP.event_ms(fn, reps=TIMING_CALLS, warmup=0)
    reps = {name: [] for name in fns}
    for _ in range(TIMING_REPS):
        for name, fn in fns.items():
            reps[name].append(TP.event_ms(fn, reps=TIMING_CALLS, warmup=0))
    return {name: (statistics.median(r), r) for name, r in reps.items()}


def _reps_note(reps):
    return "[" + ", ".join(f"{t:.4f}" for t in reps) + "]"


def _time_pair(torch, name, kern, plain, nbytes, nops, card, note,
               library=None):
    """Kernel and plain version in turns (plain, kernel, plain), and the
    library call where one PyTorch call computes the same function (in turns
    with the kernel's repetitions), against the bound max(bytes / HBM rate,
    FP32 operations / FP32 rate) of `tools.kernel_profile.bound_ms`.  The
    kernel's and the library's ms are medians (`_median_reps`)."""
    from velocycle_tpu_torch.tools import kernel_profile as TP

    p1 = TP.event_ms(plain, reps=3)
    # the plain version's temporaries leave the allocator's cache full
    torch.cuda.empty_cache()
    fns = {"kernel": kern}
    if library is not None:
        fns["library"] = library[1]
    med = _median_reps(TP, fns)
    p2 = TP.event_ms(plain, reps=3)
    t_bytes = nbytes / TP.PEAK_BYTES_PER_S * 1e3
    t_ops = nops / TP.PEAK_FP32_PER_S * 1e3
    bound, bound_by = TP.bound_ms(nbytes, nops)
    ms, plain_ms = med["kernel"][0], (p1 + p2) / 2
    lib_note = ("none (no single PyTorch call computes this function)"
                if library is None else
                f"median {med['library'][0]:.4f} ms of "
                f"{_reps_note(med['library'][1])} ({library[0]})")
    print(f"[timing] {name} @ {NG}x{NC} int16 on {card}: kernel median "
          f"{ms:.4f} ms of {_reps_note(med['kernel'][1])} ({TIMING_REPS} x "
          f"{TIMING_CALLS} calls), plain {p1:.3f} / {p2:.3f} ms, bound "
          f"{bound:.4f} ms (bytes {t_bytes:.4f} ms = {nbytes / 1e9:.3f} GB; "
          f"operations {t_ops:.4f} ms = {nops / 1e9:.2f} GFLOP, {note}), "
          f"{bound / ms:.1%} of bound; library_ms: {lib_note}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": med["library"][0] if library is not None else None}


def _ratio_ops(torch, counts):
    """(lgamma ratio operations over these counts, share of counts >= 2)."""
    N = sum(K.numel() for K in counts)
    n_ge2 = sum(int((K >= 2).sum()) for K in counts)
    n_lt2 = N - n_ge2
    lg = OPS["lg_stir"] * n_ge2 + OPS["lg_small"] * n_lt2 + OPS["lg_sel"] * N
    return lg, n_ge2 / N


def _disp_ops(torch, kind, counts, params, dnu=None, Db=None):
    """Operations of the dispersion gradient over these counts (S, or S and
    U) at one chain's parameters (``kind``'s call order, r last): each
    element on the branch its gene and its inputs take
    (kernel_profile.disp_ops at the log-means the plain version forms)."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    if kind == "phase":
        nu, zeta, cf, _ = params
        elogs = [K._phase_elog(nu, zeta, cf, dnu, Db)]
    else:
        elogs = K._velo_elogs(*params[:-1], dnu, Db)[:2]
    return sum(TP.disp_ops(k, e, params[-1]) for k, e in zip(counts, elogs))


def phase_timing(torch, seed, card):
    """Phase pair at the main path's variant (disp_grad on: stage 1 learns
    shape_inv)."""
    from velocycle_tpu_torch.ops import nb_kernels as K

    S, nu, zeta, cf, r, dnu, Db = make_inputs(torch, NG, NC, seed)
    lgk = lgamma_k_sum(torch, S)
    N = S.numel()
    lg, share = _ratio_ops(torch, [S])
    dg = _disp_ops(torch, "phase", [S], [nu, zeta, cf, r])
    params = 4 * (nu.numel() + zeta.numel() + cf.numel() + r.numel())
    in_bytes = S.numel() * S.element_size() + params
    note = f"{share:.3f} of counts >= 2"
    for name, (mode, wd) in PHASE_MAIN.items():
        print(f"[timing] {name} plan at {NG}x{NC} int16: "
              + _plan_note(torch, K, mode, wd, True))
    out = {
        "phase_fwdgrad": _time_pair(
            torch, "phase_fwdgrad",
            lambda: K.phase_fwdgrad(S, nu, zeta, cf, r, None, None, lgk),
            lambda: K.phase_fwdgrad_plain(S, nu, zeta, cf, r, None, None, lgk),
            in_bytes + params + 4,
            (OPS["common"] + OPS["fwdgrad"]) * N + lg + dg, card, note),
        "phase_fwd": _time_pair(
            torch, "phase_fwd",
            lambda: K.phase_fwd(S, nu, zeta, cf, r, None, None, lgk),
            lambda: K.phase_fwd_plain(S, nu, zeta, cf, r, None, None, lgk),
            in_bytes + 4, (OPS["common"] + OPS["fwd"]) * N + lg, card, note),
    }
    return out


def velo_timing(torch, seed, card):
    """Velocity pair at the main path's variant (disp_grad off: stage 2
    conditions shape_inv)."""
    from velocycle_tpu_torch.ops import nb_kernels as K

    args = make_velo_inputs(torch, NG, NC, seed)[:10]
    S, U = args[:2]
    lgk = lgamma_k_sum(torch, S, U)
    N = S.numel()
    lg, share = _ratio_ops(torch, [S, U])
    params = 4 * sum(t.numel() for t in args[2:])
    in_bytes = 2 * S.numel() * S.element_size() + params
    note = f"{share:.3f} of S and U counts >= 2"
    for name, (cut, wd) in VELO_MAIN.items():
        print(f"[timing] {name} plan at {NG}x{NC} int16: "
              + _plan_note(torch, K, cut, wd, True, velo=True))
    return {
        "velo_fwdgrad": _time_pair(
            torch, "velo_fwdgrad",
            lambda: K.velo_fwdgrad(*args, None, None, lgk, want_disp=False),
            lambda: K.velo_fwdgrad_plain(*args, None, None, lgk,
                                         want_disp=False),
            in_bytes + params + 4,
            (OPS_VELO["common"] + OPS_VELO["fwdgrad"]) * N + lg, card, note),
        "velo_fwd": _time_pair(
            torch, "velo_fwd",
            lambda: K.velo_fwd(*args, None, None, lgk),
            lambda: K.velo_fwd_plain(*args, None, None, lgk),
            in_bytes + 4, (OPS_VELO["common"] + OPS_VELO["fwd"]) * N + lg,
            card, note),
    }


LADDER_GRADS = {"fwdgrad": ("dnu",),
                "v_full": ("dnu_part", "ddisp_part", "dzeta", "dcf")}
LADDER_GRADS["v_nodig"] = LADDER_GRADS["v_nocell"] = LADDER_GRADS["v_full"]


def _ladder_parity(torch, seed):
    """Each rung against its plain version, at full width and at a shape
    with a partial last gene chunk and cell tile (257 x 3001) in int16 and
    float32, and in float32 at the ragged shapes; then v_full against
    phase_fwdgrad wherever there is more than one cell tile, which must be
    bit-identical: the rungs are cut from phase_fwdgrad, so a change to
    that kernel that leaves them behind fails here.  Returns {rung: [max
    abs error, loss rel error]} over the full-width cases."""
    from velocycle_tpu_torch.ops import ladder_kernels as L
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    results = {rung: [0.0, 0.0] for rung in L.RUNGS}
    all_ok, identical = True, True
    cases = [(tag, g, c, int16) for tag, g, c in (("full", NG, NC),
                                                  ("ragged 257x3001", 257, 3001))
             for int16 in (True, False)]
    cases += [(f"ragged {g}x{c}", g, c, int16) for g, c in RAGGED
              for int16 in (True, False)]
    for tag, Ng, Nc, int16 in cases:
        args = TP.make_inputs(Ng, Nc, int16, seed + Ng + Nc, "cuda")
        n_rep = max(Nc // TP.TPU_CELL_TILE, 1)
        desc = f"{tag} ({'int16' if int16 else 'f32'})"
        for rung in L.RUNGS:
            kout = L.run_rung(rung, *args, n_rep)
            pout = L.run_rung(rung, *args, n_rep, plain=True)
            torch.cuda.synchronize()
            names = LADDER_GRADS.get(rung)
            wabs, lrel, oks = _compare(
                f"ladder_{rung} {desc}",
                kout if names else kout[0], pout if names else pout[0], names)
            all_ok &= all(oks)
            if tag == "full":
                results[rung] = [max(results[rung][0], wabs),
                                 max(results[rung][1], lrel)]
            del kout, pout
        if Nc > K.phase_layout().cells_per_tile:
            # v_full is phase_fwdgrad with cf, no delta_nu, lgamma(k+1)
            # skipped and the dispersion gradient: same function, same layout
            # (both sum the raw gene partials over tiles in one call)
            out = L.ladder_run("v_full", *args)
            gene = out.gene_part.sum(0)
            mine = (out.loss_part.sum().float(), gene[:, :L.NH], out.dzeta,
                    out.dcf, gene[:, L.NH])
            ploss, pgrads = K.phase_fwdgrad(*args, None, None, 0.0,
                                            want_disp=True)
            theirs = (ploss, *pgrads[:4])
            same = [bool(torch.equal(a, b)) for a, b in zip(mine, theirs)]
            identical &= all(same)
            print(f"[ladder] v_full vs phase_fwdgrad ({desc}): bit-identical "
                  f"{all(same)} (loss, dnu, dzeta, dcf, ddisp: {same})")
        del args
        torch.cuda.empty_cache()
    check(all_ok, "a ladder rung disagrees with its plain version "
                  "(see [parity] lines)")
    check(identical, "v_full is not bit-identical to phase_fwdgrad: the "
                     "ladder no longer cuts down the production kernel")
    return results


def phase_ladder(torch, seed, card):
    """The roofline ladder: parity, timing of each rung (int16, full
    width), then `run_ladder` at full width for int16 and float32 counts
    with the launches counted.  Returns ({rung: [max abs error, loss rel
    error]}, {rung: timing}, {rung: launches})."""
    from velocycle_tpu_torch.ops import ladder_kernels as L
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    errs = _ladder_parity(torch, seed)

    args = TP.make_inputs(NG, NC, True, seed, "cuda")
    S, nu, zeta, cf, r = args
    n_rep = NC // TP.TPU_CELL_TILE
    S32 = S.float()
    libraries = {
        "stream": ("torch.sum(S, dtype=torch.float32) on the int16 counts",
                   lambda: torch.sum(S, dtype=torch.float32)),
        "matmul": ('torch.einsum("gc,gh,ch->", S, nu, zeta) on float32 counts',
                   lambda: torch.einsum("gc,gh,ch->", S32, nu, zeta)),
    }
    timing = {}
    for rung in L.RUNGS:
        nbytes, nops = TP.work(rung, *args)
        mode, wd = L.MODES[rung]
        print(f"[timing] ladder_{rung} plan at {NG}x{NC} int16: "
              + _plan_note(torch, K, mode, wd, True))
        timing[rung] = _time_pair(
            torch, f"ladder_{rung}",
            lambda: L.run_rung(rung, *args, n_rep),
            lambda: L.run_rung(rung, *args, n_rep, plain=True),
            nbytes, nops, card, "counted on this run's data",
            library=libraries.get(rung))
        if rung == "stream":
            rate = nbytes / (timing[rung]["ms"] * 1e-3)
            print(f"[timing] ladder_stream moves {nbytes / 1e9:.4f} GB at "
                  f"{rate / 1e12:.3f} TB/s, {rate / TP.PEAK_BYTES_PER_S:.1%} "
                  f"of the HBM rate")
    del S32, args, S, nu, zeta, cf, r
    torch.cuda.empty_cache()

    L.reset_launch_counts()
    rows = {}
    for dtype in ("int16", "float32"):
        rows[dtype] = TP.run_ladder(int16=dtype == "int16", seed=seed,
                                    device="cuda")
        torch.cuda.empty_cache()
    launches = dict(L.LAUNCHES)
    for dtype, dtype_rows in rows.items():
        print(f"[ladder] run_ladder, {dtype} counts, {NG}x{NC} on {card}:")
        for row in dtype_rows:
            check(math.isfinite(row["loss"]),
                  f"ladder {row['name']} ({dtype}): loss {row['loss']}")
            print(f"[ladder]   {TP.format_row(row)}")
        k = {row["name"]: row["kernel_ms"] for row in dtype_rows}
        diffs = [("matmul - stream (ElogS)", "matmul", "stream"),
                 ("logpmf - matmul (NB log-pmf)", "logpmf", "matmul"),
                 ("fwdgrad - logpmf (gradients)", "fwdgrad", "logpmf"),
                 ("v_full - v_nodig (digamma chain)", "v_full", "v_nodig"),
                 ("v_full - v_nocell (cell gradients)", "v_full", "v_nocell")]
        print(f"[ladder]   rung differences, kernel ms ({dtype}): " + "; ".join(
            f"{label} {k[a] - k[b]:+.4f}" for label, a, b in diffs))
    print(f"[ladder] launches in run_ladder: {launches}")
    return errs, timing, launches


def _make_adata(torch, seed, device):
    """AnnDataLite at full width with counts drawn on the card from seed:
    spliced, phases, then unspliced (drawn last, so that stage 1's inputs
    are those of the phase stage alone)."""
    import numpy as np
    import pandas as pd

    from velocycle_tpu_torch import AnnDataLite

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    counts = lambda mean: torch.floor(torch.exp(  # noqa: E731
        torch.randn((NC, NG), generator=g, device=device) * 0.8 + mean
    )).to(torch.int16).cpu().numpy()                      # (cells, genes)
    spliced = counts(1.0)
    angles = (torch.rand(NC, generator=g, device=device) * 2 * math.pi).cpu().numpy()
    unspliced = counts(0.4)
    genes = [f"G{i:05d}" for i in range(NG)]
    cells = [f"C{i:06d}" for i in range(NC)]
    adata = AnnDataLite(
        obs=pd.DataFrame(index=cells), var=pd.DataFrame(index=genes),
        layers={"spliced": spliced, "unspliced": unspliced},
    )
    return adata, genes, cells, np.asarray(angles, np.float64)


def _steady_state(torch, svi, state, data, tag):
    """Steps/s over 20 steps after 3 warm-up steps (host clock), then the
    profiler's summary of 5 more; not part of the counted run."""
    state, _ = svi.update_chunk(state, 3, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, chunk = svi.update_chunk(state, 20, data)
    chunk.cpu()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps_per_s = 20 / dt
    print(f"[{tag}] steady state: {steps_per_s:.2f} steps/s "
          f"({dt / 20 * 1e3:.2f} ms/step, host clock, 20 steps)")
    profile_steps(torch, svi, state, data, tag)
    return steps_per_s


def phase_main_path(torch, seed, adata, genes, cells, angles, num_steps=50,
                    num_samples=8, device="cuda"):
    """Stage 1; returns (launches, steps/s, peak bytes, what stage 2 takes
    from the fit)."""
    import numpy as np

    from velocycle_tpu_torch import (
        Cycle, PhaseFitModel, Phases, preprocess_for_phase_estimation,
    )
    from velocycle_tpu_torch.ops import nb_kernels as K

    t0 = time.perf_counter()
    cycle = Cycle.trivial_prior(genes, harmonics=H)
    phases = Phases.from_angles(angles, concentration=1.0, cell_names=cells)
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=H, with_delta_nu=False,
        use_fused_nb=True, device=device,
    )
    data = mp.data
    check(data.S.dtype == torch.int16 and data.S.device.type == device,
          "counts not int16 on the card")
    check(data.lgamma_k_sum is not None, "lgamma_k_sum missing")
    torch.cuda.synchronize()
    print(f"[main] preprocess_for_phase_estimation: "
          f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    fit = PhaseFitModel(mp, num_samples=num_samples, n_per_bin=num_samples)
    t0 = time.perf_counter()
    fit.fit(num_steps=num_steps, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after_fit = dict(K.LAUNCHES)
    with torch.no_grad():
        loss_only = fit.svi.loss_fn(fit.state.params, 7, data)
    loss_only = float(loss_only)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = np.asarray(fit.losses)
    print(f"[main] losses: first {losses[0]:.6g}, last {losses[-1]:.6g}, "
          f"mean of last 10 {losses[-10:].mean():.6g}")
    check(losses.shape == (num_steps,) and np.isfinite(losses).all(),
          "non-finite losses")
    check(losses[-10:].mean() < losses[0], "losses did not fall")
    check(after_fit["phase_fwdgrad"] == num_steps,
          f"phase_fwdgrad launched {after_fit['phase_fwdgrad']} times in "
          f"{num_steps} steps")
    check(after_fit["phase_fwd"] == 0, "phase_fwd launched during the fit")
    check(math.isfinite(loss_only), "loss-only evaluation not finite")
    check(launches["phase_fwd"] == 1, "the loss-only evaluation did not launch phase_fwd")
    check(fit.cycle_fit.means.shape == (NH, NG)
          and np.isfinite(fit.cycle_fit.means.values).all(), "bad Cycle")
    check(fit.phase_fit.shape == (2, NC)
          and np.isfinite(fit.phase_fit.phi_xy.values).all(), "bad Phases")
    post = fit.posterior
    want = {"nu": (num_samples, NG, NH), "phi_xy": (num_samples, NC, 2),
            "phi": (num_samples, NC), "zeta": (num_samples, NC, NH),
            "shape_inv": (num_samples, NG), "ElogS": (NG, NC)}
    for k, shape in want.items():
        check(post[k].shape == shape and np.isfinite(post[k]).all(),
              f"posterior {k}: {post[k].shape} (want {shape})")
    print(f"[main] fit of {num_steps} steps incl. init, extraction and "
          f"{num_samples} posterior draws: {fit_s:.2f} s; loss-only "
          f"evaluation {loss_only:.6g}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[main] launches in stage 1: {launches}")
    steps_per_s = _steady_state(torch, fit.svi, fit.state, data, "main")
    # what stage 2 needs; the fit's device tensors go with it
    stage1 = types.SimpleNamespace(cycle_fit=fit.cycle_fit,
                                   phase_fit=fit.phase_fit, params=fit.params,
                                   mp=mp)
    return launches, steps_per_s, peak, stage1


def velocity_main_path(torch, seed, adata, stage1, num_steps=50,
                       num_samples=2, device="cuda"):
    """Stage 2, conditioned on stage 1's point estimates; returns
    (launches, steps/s, peak bytes)."""
    import numpy as np

    from velocycle_tpu_torch import (
        AngularSpeed, VelocityFitModel, preprocess_for_velocity_estimation,
    )
    from velocycle_tpu_torch.ops import nb_kernels as K

    t0 = time.perf_counter()
    speed = AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2, stds=0.5)
    mp = preprocess_for_velocity_estimation(
        adata, stage1.cycle_fit, stage1.phase_fit, speed, n_harmonics=H,
        omega_n_harmonics=1, with_delta_nu=False, model_type="lrmn",
        use_fused_nb=True, device=device,
    )
    torch.cuda.synchronize()
    print(f"[velo] preprocess_for_velocity_estimation: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    data = mp.data
    check(data.S.dtype == torch.int16 and data.U.dtype == torch.int16
          and data.S.device.type == device and data.U.device.type == device,
          "S and U not int16 on the card")
    check(data.lgamma_k_sum is not None, "lgamma_k_sum missing")
    check((data.Ng, data.Nc) == (NG, NC), f"velocity data {data.Ng}x{data.Nc}")
    p = stage1.params
    cond = {"nu": p["nu_locs"], "phi_xy": p["phixy_locs"],
            "shape_inv": p["shape_inv_locs"]}

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    fit = VelocityFitModel(mp, condition_on=cond, num_samples=num_samples,
                           n_per_bin=1)
    data = fit.metaparams.data
    check(data.disp_grad is False, "disp_grad still on with shape_inv conditioned")
    t0 = time.perf_counter()
    fit.fit(num_steps=num_steps, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after_fit = dict(K.LAUNCHES)
    with torch.no_grad():
        loss_only = float(fit.svi.loss_fn(fit.state.params, 7, data))
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = np.asarray(fit.losses)
    print(f"[velo] losses: first {losses[0]:.6g}, last {losses[-1]:.6g}, "
          f"mean of last 10 {losses[-10:].mean():.6g}")
    check(losses.shape == (num_steps,) and np.isfinite(losses).all(),
          "non-finite velocity losses")
    check(losses[-10:].mean() < losses[0], "velocity losses did not fall")
    check(after_fit["velo_fwdgrad"] == num_steps,
          f"velo_fwdgrad launched {after_fit['velo_fwdgrad']} times in "
          f"{num_steps} steps")
    check(after_fit["velo_fwd"] == 0, "velo_fwd launched during the fit")
    check(math.isfinite(loss_only), "velocity loss-only evaluation not finite")
    check(launches["velo_fwd"] == 1,
          "the loss-only evaluation did not launch velo_fwd")
    check(launches["phase_fwd"] == launches["phase_fwdgrad"] == 0,
          "stage 2 launched a phase kernel")
    speed_fit = fit.speed_fit.means_array
    periods = fit.period_hours()
    check(speed_fit.shape == (1, 3) and np.isfinite(speed_fit).all(),
          f"bad AngularSpeed {speed_fit}")
    check(periods.shape == (1,) and np.isfinite(periods).all(),
          f"bad period {periods}")
    post = fit.posterior
    n = num_samples
    want = {"log_gamma": (n, NG), "log_beta": (n, NG), "nu_omega": (n, 1, 3),
            "gamma": (n, NG), "phi": (n, NC), "zeta": (n, NC, NH),
            "zeta_dphi": (n, NC, NH), "zeta_omega": (n, NC, 3),
            "omega": (n, NC), "ElogS": (n, NG, NC), "ElogU": (n, NG, NC),
            "rho_real": (n, NG)}
    check(sorted(post) == sorted(want), f"posterior sites {sorted(post)}")
    for k, shape in want.items():
        check(post[k].shape == shape and np.isfinite(post[k]).all(),
              f"posterior {k}: {post[k].shape} (want {shape})")
    print(f"[velo] fit of {num_steps} steps incl. init, extraction and "
          f"{num_samples} posterior draws: {fit_s:.2f} s; loss-only "
          f"evaluation {loss_only:.6g}; speed_fit nu_omega {speed_fit[0]}; "
          f"period_hours {periods[0]:.6g}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[velo] launches in stage 2: {launches}")
    del post
    fit.posterior = None
    steps_per_s = _steady_state(torch, fit.svi, fit.state, data, "velo")
    return launches, steps_per_s, peak, mp


def _write_counts(adata, layers, directory):
    """The counts on disk as CSR: one .h5ad if h5py imports, else a
    MatrixMarket file per layer with the cell and gene names beside them
    (the 10x layout).  Returns (route, read), ``read()`` loading them back
    into an AnnDataLite through the port."""
    import importlib.util
    import os

    import pandas as pd

    import velocycle_tpu_torch as vt
    from velocycle_tpu_torch import native

    if importlib.util.find_spec("h5py") is not None:
        path = os.path.join(directory, "counts.h5ad")
        vt.write_h5ad(vt.AnnDataLite(obs=adata.obs, var=adata.var, layers=layers),
                      path)
        return ".h5ad (write_h5ad / read_h5ad)", lambda: vt.read_h5ad(path)
    import scipy.io as sio

    for name, m in layers.items():
        sio.mmwrite(os.path.join(directory, f"{name}.mtx"), m)
    adata.obs.to_csv(os.path.join(directory, "barcodes.tsv"), sep="\t")
    adata.var.to_csv(os.path.join(directory, "features.tsv"), sep="\t")

    def read():
        kw = dict(sep="\t", index_col=0, dtype=str, keep_default_na=False)
        obs = pd.read_csv(os.path.join(directory, "barcodes.tsv"), **kw)
        var = pd.read_csv(os.path.join(directory, "features.tsv"), **kw)
        return vt.AnnDataLite(obs=obs, var=var, layers={
            name: native.read_mtx(os.path.join(directory, f"{name}.mtx")).tocsr()
            for name in layers})

    return "MatrixMarket (scipy.io.mmwrite / native.read_mtx)", read


def _eigh_note(torch, mat, device="cuda"):
    """Why the PCA prior takes its eigendecomposition on the host: the
    card's covariance against the host's, and the card's eigh of it
    against LAPACK's (top-2 eigenvectors, signs aligned)."""
    X = torch.log(torch.as_tensor(mat, device=device) + 0.1)
    Xc = X - X.mean(0)
    cov = Xc.T @ Xc / (X.shape[0] - 1)
    Xh = Xc.cpu()
    cov_err = float(((Xh.T @ Xh / (X.shape[0] - 1)) - cov.cpu()).abs().max()
                    / cov.abs().max())
    vd = torch.linalg.eigh(cov)[1][:, -2:].cpu()
    vh = torch.linalg.eigh(cov.cpu())[1][:, -2:]
    vd = vd * torch.sign((vd * vh).sum(0))
    print(f"[quickstart] PCA subset covariance, card vs host: max rel diff "
          f"{cov_err:.2e}; top-2 eigenvectors of that covariance, card eigh vs "
          f"host LAPACK: max diff {float((vd - vh).abs().max()):.2e}")


def phase_quickstart(torch, seed, card, num_steps=20, pca_subset=4096):
    """The README quick start and example 06's gauge fixes at full width,
    through the port's public API: counts from disk, normalize_total, the
    PCA prior (on the card) and the LDA prior, the joint gauge fixes, the
    phase fit with check_model and snapshots, CSV save / load, the velocity
    fit conditioned on it, period_hours, and the grid MLE prior.  Each fit
    is counted (counts set to 0 just before it, read just after).  Returns
    {kernel: launches}."""
    import importlib.util
    import resource
    import tempfile
    from pathlib import Path

    import numpy as np
    import scipy.sparse as sp

    import velocycle_tpu_torch as vt
    from velocycle_tpu_torch import native
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.ops.circular import circular_corrcoef, circular_distance

    def took(label, t0, sync=False):
        if sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[quickstart] {label}: {dt:.2f} s on {card}")
        return dt

    print("[quickstart] installed on this machine: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("h5py", "sklearn")))
    check(native.available(), f"native ingest not available: {native.build_error()}")
    print(f"[quickstart] native ingest library: available, g++ build "
          f"{native.build_seconds():.2f} s in this process")
    torch.cuda.reset_peak_memory_stats()

    # the counts of _make_adata, 1,918 cycling genes and 130 fillers, and
    # a three-class phase label cut from the drawn angles (example 06)
    drawn, _, cells, angles = _make_adata(torch, seed, "cuda")
    large = list(vt.genes.get_cycling_gene_set("Large"))
    names = large + [f"FILLER{i:03d}" for i in range(NG - len(large))]
    check(len(set(names)) == NG, "gene names are not unique")
    drawn.var.index = names
    drawn.obs["phase"] = np.select([angles < 2.0, angles < 4.0], ["G1", "S"], "G2M")
    layers = {k: sp.csr_matrix(drawn.layers[k]) for k in ("spliced", "unspliced")}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        route, read = _write_counts(drawn, layers, tmp)
        took(f"write {NG} x {NC} spliced + unspliced CSR ({route})", t0)
        t0 = time.perf_counter()
        adata = read()
        took("read back", t0)
        for k, m in layers.items():
            back = adata.layers[k]
            check(sp.issparse(back) and back.shape == (NC, NG)
                  and (back != m).nnz == 0, f"{k} changed on disk")
        check(list(adata.var.index) == names and list(adata.obs.index) == cells
              and list(adata.obs["phase"]) == list(drawn.obs["phase"]),
              "names or labels changed on disk")
        del drawn, layers

        t0 = time.perf_counter()
        vt.normalize_total(adata)
        took("normalize_total", t0)
        cycle = vt.Cycle.trivial_prior(list(adata.var.index), harmonics=H)

        t0 = time.perf_counter()
        pca = vt.Phases.from_pca_heuristic(adata, genes_to_use=large)
        took(f"Phases.from_pca_heuristic ({len(large)} genes, on the card)", t0,
             sync=True)
        sub = adata[np.arange(pca_subset), :]
        on_card = vt.Phases.from_pca_heuristic(sub, genes_to_use=large)
        on_cpu = vt.Phases.from_pca_heuristic(sub, genes_to_use=large, device="cpu")
        err = float(circular_distance(torch.as_tensor(on_card.phis),
                                      torch.as_tensor(on_cpu.phis)).abs().max())
        print(f"[quickstart] PCA angles on {pca_subset} cells, card vs CPU "
              f"(float64): max {err:.3e} rad")
        check(err <= 1e-5, f"card PCA angles differ from the CPU's by {err} rad")
        _eigh_note(torch, np.asarray(sub.layers["S_sz"])[
            :, np.isin(np.asarray(sub.var.index), large)])

        t0 = time.perf_counter()
        prior = vt.Phases.from_lda_heuristic(adata, labels="phase")
        took(f"Phases.from_lda_heuristic ({NG} genes, 3 classes, host)", t0)
        print(f"[quickstart] circular corr of the PCA and LDA priors: "
              f"{float(circular_corrcoef(torch.as_tensor(pca.phis), torch.as_tensor(prior.phis))):.4f}")

        # example 06's gauge fixes, jointly on (Cycle, Phases)
        before = prior.phi_xy.values.copy(), cycle.means.values.copy()
        vt.invert_direction(cycle, prior)
        vt.invert_direction(cycle, prior)
        check(np.array_equal(prior.phi_xy.values, before[0])
              and np.array_equal(cycle.means.values, before[1]),
              "invert_direction twice did not give the same bits back")
        shift, maxcor, _ = prior.max_corr(adata.obs["n_scounts"].values)
        vt.shift_zero(cycle, prior, phase=shift)
        print(f"[quickstart] gauge: invert_direction twice bit-identical; "
              f"shift_zero(phase={shift:.4f}) at UMI max-corr {maxcor:.4f}")

        t0 = time.perf_counter()
        mp = vt.preprocess_for_phase_estimation(
            adata, cycle, prior, n_harmonics=H, with_delta_nu=False,
            use_fused_nb=True)
        took("preprocess_for_phase_estimation", t0, sync=True)
        check(mp.data.S.dtype == torch.int16, "counts from disk not int16")
        fit = vt.PhaseFitModel(mp, num_samples=2, n_per_bin=2)
        problems = fit.check_model()
        check(problems == [], f"check_model found {problems}")
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        fit.fit(num_steps=num_steps, seed=seed, store_output=True,
                intermediate_output_step_size=num_steps // 2, store_num_samples=2)
        fit_s = took(f"PhaseFitModel.fit({num_steps} steps, 2 snapshots, 2 "
                     "posterior draws)", t0, sync=True)
        launches = dict(K.LAUNCHES)
        peak1 = torch.cuda.max_memory_allocated()
        losses = np.asarray(fit.losses)
        check(np.isfinite(losses).all() and losses[-10:].mean() < losses[0],
              f"stage-1 losses {losses[0]} -> {losses[-1]}")
        check(launches["phase_fwdgrad"] == num_steps and launches["phase_fwd"] == 0,
              f"stage 1 launched {launches}, want phase_fwdgrad x{num_steps}")
        snaps = fit.intermediate_output
        check([s["step"] for s in snaps] == [num_steps // 2, num_steps],
              f"snapshots at {[s['step'] for s in snaps]}")
        check(all(s["phi_xy"].shape == (2, NC, 2) for s in snaps), "snapshot shapes")

        t0 = time.perf_counter()
        fit.cycle_fit.save(Path(tmp) / "cycle.csv")
        fit.phase_fit.save(Path(tmp) / "phases.csv")
        cycle_fit = vt.Cycle.load(Path(tmp) / "cycle.csv")
        phase_fit = vt.Phases.load(Path(tmp) / "phases.csv")
        took("save + load of cycle_fit and phase_fit (CSV)", t0)
        for got, want in ((cycle_fit.means, fit.cycle_fit.means),
                          (cycle_fit.stds, fit.cycle_fit.stds),
                          (phase_fit.phi_xy, fit.phase_fit.phi_xy)):
            check(np.array_equal(got.values.astype(want.values.dtype), want.values)
                  and list(got.columns) == list(want.columns), "CSV round trip")

        t0 = time.perf_counter()
        speed = vt.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2, stds=0.5)
        vmp = vt.preprocess_for_velocity_estimation(
            adata, cycle_fit, phase_fit, speed, n_harmonics=H,
            omega_n_harmonics=1, with_delta_nu=False, model_type="lrmn",
            use_fused_nb=True)
        took("preprocess_for_velocity_estimation", t0, sync=True)
        p = fit.params
        vfit = vt.VelocityFitModel(vmp, condition_on={
            "nu": p["nu_locs"], "phi_xy": p["phixy_locs"],
            "shape_inv": p["shape_inv_locs"]}, num_samples=2, n_per_bin=1)
        del fit, mp
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        vfit.fit(num_steps=num_steps, seed=seed)
        vfit_s = took(f"VelocityFitModel.fit({num_steps} steps, LRMN, 2 posterior "
                      "draws)", t0, sync=True)
        vlaunches = dict(K.LAUNCHES)
        peak2 = torch.cuda.max_memory_allocated()
        vlosses = np.asarray(vfit.losses)
        check(np.isfinite(vlosses).all() and vlosses[-10:].mean() < vlosses[0],
              f"stage-2 losses {vlosses[0]} -> {vlosses[-1]}")
        check(vlaunches["velo_fwdgrad"] == num_steps and vlaunches["velo_fwd"] == 0,
              f"stage 2 launched {vlaunches}, want velo_fwdgrad x{num_steps}")
        periods = vfit.period_hours()
        check(periods.shape == (1,) and np.isfinite(periods).all(), f"period {periods}")
        vfit.posterior = None

        t0 = time.perf_counter()
        mle = vt.Phases.flat_prior(adata)
        mle.from_cycle_mle(cycle_fit, adata, noisemodel="Poisson", bins=100)
        took("Phases.from_cycle_mle (Poisson, 100 bins, on the card)", t0, sync=True)
        check(mle.shape == (2, NC) and np.isfinite(mle.phi_xy.values).all()
              and np.allclose(mle.concentrations, 10.0), "bad grid MLE phases")
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[quickstart] losses: stage 1 {losses[0]:.6g} -> {losses[-1]:.6g}, "
          f"stage 2 {vlosses[0]:.6g} -> {vlosses[-1]:.6g}; period_hours "
          f"{periods[0]:.6g}; fits {fit_s:.2f} s and {vfit_s:.2f} s")
    print(f"[quickstart] launches: stage 1 {launches}; stage 2 {vlaunches}")
    print(f"[quickstart] peak device memory: stage-1 fit {peak1 / 2**30:.2f} GiB, "
          f"stage-2 fit {peak2 / 2**30:.2f} GiB; host peak RSS of the process "
          f"{host_peak:.2f} GiB; on {card}")
    return launches, vlaunches


def _spline_adata(torch, seed, device):
    """Example 04's draw (`simulate_pseudotime_counts`) at full width, on the
    card from seed: t ~ U(0, 1), W (NG, 11) ~ N(0, 0.5^2) with W[:, 0] + 3,
    ElogS = W B(t)^T on the default spline basis, gamma = exp(N(0, 0.3^2)),
    beta = exp(N(2, 0.3^2)), ElogU = -log beta + log(relu(W dB(t)^T * 0.5 +
    gamma) + 1e-5) + ElogS; S and U Poisson, stored int16.  Returns
    (adata, t, W)."""
    import pandas as pd

    from velocycle_tpu_torch import AnnDataLite
    from velocycle_tpu_torch.ops.splines import spline_basis_auto

    g = torch.Generator(device=device)
    g.manual_seed(seed + 8)
    t = torch.rand(NC, generator=g, device=device).sort().values
    W = torch.randn((NG, W_SPLINE), generator=g, device=device) * 0.5
    W[:, 0] += 3.0
    B = spline_basis_auto(t, domain=(0.0, 1.0))
    dB = spline_basis_auto(t, der=1, domain=(0.0, 1.0))
    gamma = torch.exp(torch.randn(NG, generator=g, device=device) * 0.3)
    beta = torch.exp(torch.randn(NG, generator=g, device=device) * 0.3 + 2.0)
    ElogS = W @ B.T
    kin = (W @ dB.T) * 0.5 + gamma[:, None]
    ElogU = (-torch.log(beta)[:, None]
             + torch.log(torch.clamp(kin, min=0.0) + 1e-5) + ElogS)
    del kin
    layers = {}
    for name, elog in (("spliced", ElogS), ("unspliced", ElogU)):
        K = torch.poisson(torch.exp(elog), generator=g)
        check(float(K.max()) < 32767, f"{name} counts exceed int16")
        layers[name] = K.to(torch.int16).T.contiguous().cpu().numpy()
        del K
    del ElogS, ElogU
    adata = AnnDataLite(
        obs=pd.DataFrame(index=[f"C{i:06d}" for i in range(NC)]),
        var=pd.DataFrame(index=[f"G{i:05d}" for i in range(NG)]),
        layers=layers,
    )
    return adata, t, W


def _width_launches(K):
    """{kernel: {width: launches}} of the kernels launched since the last
    reset."""
    return {k: dict(v) for k, v in K.LAUNCH_WIDTHS.items() if v}


def _counted_fit(torch, K, fit, num_steps, seed, tag):
    """Fit with the launch counts set to 0 just before and read just after,
    then one loss-only evaluation read on its own; checks that the losses
    are finite and fall.  Returns (launches by width in the fit, in the
    evaluation, peak device bytes of both)."""
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    fit.fit(num_steps=num_steps, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    in_fit = _width_launches(K)
    K.reset_launch_counts()
    with torch.no_grad():
        loss_only = float(fit.svi.loss_fn(fit.state.params, 7,
                                          fit.metaparams.data))
    in_eval = _width_launches(K)
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(fit.losses)
    print(f"[variants] {tag}: losses {losses[0]:.6g} -> {losses[-1]:.6g} "
          f"(mean of last 10 {losses[-10:].mean():.6g}); fit of {num_steps} "
          f"steps incl. init, extraction and posterior draws {fit_s:.2f} s; "
          f"loss-only evaluation {loss_only:.6g}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches by width: fit {in_fit}, "
          f"evaluation {in_eval}")
    check(losses.shape == (num_steps,) and np.isfinite(losses).all()
          and losses[-10:].mean() < losses[0], f"{tag}: losses {losses}")
    check(math.isfinite(loss_only), f"{tag}: loss-only evaluation not finite")
    return in_fit, in_eval, peak


def _variant_kernels(torch, seed, card):
    """Both fwdgrad kernels at the spline path's 11 columns, full width:
    parity with their plain versions (disp_grad both ways), then time,
    plain time and bound; the bound counted as at Nh = 5, plus
    OPS_PER_COLUMN for each extra column (disp_grad on: the spline fits
    learn shape_inv)."""
    from velocycle_tpu_torch.ops import nb_kernels as K

    tag = f"Nh={W_SPLINE} full"
    case = [(tag, NG, NC, 0, True, True, {"nh": W_SPLINE})]
    res, ok = _parity_cases(torch, seed, make_inputs, 1, K.phase_fwdgrad,
                            K.phase_fwdgrad_plain, K.phase_fwd,
                            K.phase_fwd_plain, PHASE_GRADS, GRAD_RTOL, case,
                            record=tag)
    vres, vok = _parity_cases(torch, seed, make_velo_inputs, 2, K.velo_fwdgrad,
                              K.velo_fwdgrad_plain, K.velo_fwd, K.velo_fwd_plain,
                              VELO_GRADS, VELO_GRAD_RTOL, case, record=tag)
    check(ok and vok, f"a kernel disagrees with its plain version at "
          f"{W_SPLINE} columns (see [parity] lines)")
    extra = W_SPLINE - NH
    timing = {}
    S, nu, zeta, cf, r, _, _ = make_inputs(torch, NG, NC, seed, nh=W_SPLINE)
    lgk = lgamma_k_sum(torch, S)
    lg, share = _ratio_ops(torch, [S])
    dg = _disp_ops(torch, "phase", [S], [nu, zeta, cf, r])
    params = 4 * (nu.numel() + zeta.numel() + cf.numel() + r.numel())
    ops = (OPS["common"] + OPS["fwdgrad"] + extra * (
        OPS_PER_COLUMN["common"] + OPS_PER_COLUMN["fwdgrad"])) * S.numel()
    timing["phase_fwdgrad"] = _time_pair(
        torch, f"phase_fwdgrad at {W_SPLINE} columns",
        lambda: K.phase_fwdgrad(S, nu, zeta, cf, r, None, None, lgk),
        lambda: K.phase_fwdgrad_plain(S, nu, zeta, cf, r, None, None, lgk),
        S.numel() * S.element_size() + 2 * params + 4, ops + lg + dg, card,
        f"{share:.3f} of counts >= 2")
    del S, nu, zeta, cf, r
    args = make_velo_inputs(torch, NG, NC, seed, nh=W_SPLINE)[:10]
    S, U = args[:2]
    lgk = lgamma_k_sum(torch, S, U)
    lg, share = _ratio_ops(torch, [S, U])
    dg = _disp_ops(torch, "velo", [S, U], args[2:])
    params = 4 * sum(t.numel() for t in args[2:])
    ops = (OPS_VELO["common"] + OPS_VELO["fwdgrad"] + OPS_VELO["disp"]
           + extra * (OPS_PER_COLUMN["velo_common"]
                      + OPS_PER_COLUMN["velo_fwdgrad"])) * S.numel()
    timing["velo_fwdgrad"] = _time_pair(
        torch, f"velo_fwdgrad at {W_SPLINE} columns",
        lambda: K.velo_fwdgrad(*args, None, None, lgk, want_disp=True),
        lambda: K.velo_fwdgrad_plain(*args, None, None, lgk, want_disp=True),
        2 * S.numel() * S.element_size() + 2 * params + 4, ops + lg + dg,
        card, f"{share:.3f} of S and U counts >= 2, disp_grad on")
    del args, S, U
    torch.cuda.empty_cache()
    return {**res, **vres}, timing


def phase_variants(torch, seed, card, num_steps=50, lba_steps=20,
                   device="cuda"):
    """[variants]: the model variants at full width through the public entry
    points, each fit's kernel launches counted by width.  Returns {kernel:
    {width: launches}} over the variant fits (the 11-column kernels' parity
    and timing is `_variant_kernels`, run before the [mcmc] processes
    start)."""
    import numpy as np

    import velocycle_tpu_torch as vt
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, TraceEnum_ELBO
    from velocycle_tpu_torch.models import phase as P
    from velocycle_tpu_torch.ops import nb_kernels as K

    launches = {k: {} for k in K.LAUNCHES}

    def add(counts):
        for k, by_w in counts.items():
            for w, n in by_w.items():
                launches[k][w] = launches[k].get(w, 0) + n

    def took(label, t0):
        torch.cuda.synchronize()
        print(f"[variants] {label}: {time.perf_counter() - t0:.2f} s on {card}")

    # (a) the spline two-stage fit (example 04's workflow)
    t0 = time.perf_counter()
    adata, t, W = _spline_adata(torch, seed, device)
    took("spline draw (counts on the card, to the host as int16)", t0)
    genes, cells = list(adata.var.index), list(adata.obs.index)
    gp = torch.Generator(device=device)
    gp.manual_seed(seed + 9)
    prior_t = torch.clamp(t + torch.randn(NC, generator=gp, device=device) * 0.05,
                          0.0, 1.0).cpu().numpy()
    phases = vt.Phases.from_angles(prior_t, cell_names=cells)
    t0 = time.perf_counter()
    mp = vt.preprocess_for_phase_estimation(
        adata, vt.Cycle.spline_prior(genes, n_basis=W_SPLINE - 1, stds=3.0),
        phases, basis_kind="spline", spline_domain=(0.0, 1.0),
        noisemodel="NegativeBinomial", use_fused_nb=True, with_delta_nu=False,
        device=device)
    took("preprocess_for_phase_estimation (spline)", t0)
    check(mp.data.mu_nu.shape == (NG, W_SPLINE) and mp.data.S.dtype == torch.int16,
          f"spline PhaseData {tuple(mp.data.mu_nu.shape)} {mp.data.S.dtype}")
    fit = vt.PhaseFitModel(mp, num_samples=2, n_per_bin=2)
    in_fit, in_eval, peak1 = _counted_fit(torch, K, fit, num_steps, seed,
                                          "spline stage 1 (phi free)")
    check(in_fit == {"phase_fwdgrad": {W_SPLINE: num_steps}},
          f"spline stage 1 launched {in_fit}")
    check(in_eval == {"phase_fwd": {W_SPLINE: 1}},
          f"spline stage-1 evaluation launched {in_eval}")
    add(in_fit), add(in_eval)
    phi = fit.params["phi_locs"]
    check(np.isfinite(phi).all() and (phi > 0).all() and (phi < 1).all(),
          f"phi_locs outside (0, 1): [{phi.min()}, {phi.max()}]")
    check("phi_xy" not in fit.posterior, "spline posterior has phi_xy")
    sps1 = _steady_state(torch, fit.svi, fit.state, mp.data, "variants spline-1")

    from velocycle_tpu_torch.ops.splines import spline_basis_auto
    with torch.no_grad():
        B = spline_basis_auto(t, domain=(0.0, 1.0))
        x = torch.as_tensor(fit.params["nu_locs"], device=device) @ B.T
        y = W @ B.T
        x, y = x - x.mean(), y - y.mean()
        corr = float((x * y).mean() / (x.pow(2).mean() * y.pow(2).mean()).sqrt())
        pcorr = float(np.corrcoef(phi, t.cpu().numpy())[0, 1])
        del x, y, B
    print(f"[variants] spline stage 1: ElogS correlation with the truth "
          f"{corr:.4f}, phi_locs correlation with the true pseudotime "
          f"{pcorr:.4f} (printed, not gated)")

    t0 = time.perf_counter()
    speed = vt.AngularSpeed.from_array([[0.0]], [[1.0]], condition_names=["traj"],
                                       num_coeffs=1)
    vmp = vt.preprocess_for_velocity_estimation(
        adata, fit.cycle_fit, fit.phase_fit, speed, basis_kind="spline",
        spline_domain=(0.0, 1.0), model_type="fourier",
        noisemodel="NegativeBinomial", use_fused_nb=True, with_delta_nu=False,
        device=device)
    took("preprocess_for_velocity_estimation (spline)", t0)
    check(vmp.data.Nhw == 1 and vmp.data.U.dtype == torch.int16, "spline VelocityData")
    cond = {"phi": phi, "nu": fit.params["nu_locs"]}
    del fit, mp
    vfit = vt.VelocityFitModel(vmp, condition_on=cond, num_samples=2, n_per_bin=1)
    in_fit, in_eval, peak2 = _counted_fit(torch, K, vfit, num_steps, seed,
                                          "spline stage 2 (phi, nu conditioned)")
    check(in_fit == {"velo_fwdgrad": {W_SPLINE: num_steps}},
          f"spline stage 2 launched {in_fit}")
    check(in_eval == {"velo_fwd": {W_SPLINE: 1}},
          f"spline stage-2 evaluation launched {in_eval}")
    add(in_fit), add(in_eval)
    period = vfit.period_hours()
    omega = vfit.speed_fit.means_array
    print(f"[variants] spline stage 2: omega {float(omega.squeeze()):.6g}, "
          f"period_hours (transit time over the domain) {period[0]:.6g}")
    check(period.shape == (1,) and np.isfinite(period).all() and period[0] > 0,
          f"period_hours {period}")
    check("phi_xy" not in vfit.posterior, "spline velocity posterior has phi_xy")
    vfit.posterior = None
    sps2 = _steady_state(torch, vfit.svi, vfit.state, vfit.metaparams.data,
                         "variants spline-2")
    del vfit, vmp, adata, t, W
    torch.cuda.empty_cache()

    # (b) the wrapped stage 1 on the main path's draw
    adata, genes, cells, angles = _make_adata(torch, seed, device)
    t0 = time.perf_counter()
    mp = vt.preprocess_for_phase_estimation(
        adata, vt.Cycle.trivial_prior(genes, harmonics=H),
        vt.Phases.from_angles(angles, concentration=1.0, cell_names=cells),
        n_harmonics=H, with_delta_nu=False, phi_parametrization="wrapped",
        use_fused_nb=True, device=device)
    took("preprocess_for_phase_estimation (wrapped)", t0)
    fit = vt.PhaseFitModel(mp, num_samples=2, n_per_bin=2)
    in_fit, in_eval, peak3 = _counted_fit(torch, K, fit, num_steps, seed,
                                          "wrapped stage 1")
    check(in_fit == {"phase_fwdgrad": {NH: num_steps}},
          f"wrapped stage 1 launched {in_fit}")
    check(in_eval == {"phase_fwd": {NH: 1}}, f"wrapped evaluation launched {in_eval}")
    add(in_fit), add(in_eval)
    check("phi_locs" in fit.params and "phi_xy" not in fit.posterior,
          "wrapped guide family")
    check(fit.phase_fit.shape == (2, NC)
          and np.isfinite(fit.phase_fit.phi_xy.values).all(), "bad wrapped Phases")
    sps3 = _steady_state(torch, fit.svi, fit.state, mp.data, "variants wrapped")
    del fit, mp
    torch.cuda.empty_cache()

    # (c) LBA: the analytic mixture, then the enumerated form at its params
    t0 = time.perf_counter()
    mp = vt.preprocess_for_phase_estimation(
        adata, vt.Cycle.trivial_prior(genes, harmonics=H),
        vt.Phases.from_angles(angles, concentration=1.0, cell_names=cells),
        n_harmonics=H, with_delta_nu=False, gene_selection_model="lba",
        device=device)
    took("preprocess_for_phase_estimation (lba)", t0)
    del adata
    check(mp.model_fn is P.phase_model_lba, "lba model")
    fit = vt.PhaseFitModel(mp, num_samples=2, n_per_bin=2)
    in_fit, in_eval, peak4 = _counted_fit(torch, K, fit, lba_steps, seed,
                                          "lba (Trace_ELBO)")
    check(not in_fit and not in_eval, f"the LBA path launched {in_fit} {in_eval}")
    check(fit.periodic.shape == (NG,) and np.isfinite(fit.periodic).all(),
          "LBA periodic membership")
    sps4 = _steady_state(torch, fit.svi, fit.state, mp.data, "variants lba")
    values = []
    K.reset_launch_counts()
    for model, loss, name in ((P.phase_model_lba, Trace_ELBO(), "analytic"),
                              (P.phase_model_lba_enum, TraceEnum_ELBO(),
                               "enumerated")):
        svi = SVI(model, P.phase_guide_lba, None, loss)
        svi.constraints = fit.svi.constraints
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in fit.state.params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = svi.loss_fn(params, 11, mp.data)
        value.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        values.append((float(value.detach()),
                       {k: v.grad for k, v in params.items()}))
        print(f"[variants] lba {name} form at the fitted params: loss "
              f"{values[-1][0]:.9g}, loss and gradients {dt * 1e3:.1f} ms, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del value, params, svi
    check(sum(K.LAUNCHES.values()) == 0, "the LBA evaluations launched a kernel")
    (la, ga), (le, ge) = values
    rel = abs(le - la) / abs(la)
    grel = {k: _rel(ge[k], ga[k]) for k in ga}
    print(f"[variants] lba enumerated vs analytic: loss rel {rel:.3e} (gate "
          f"1e-5); gradients max|a-b|/max|a| "
          + ", ".join(f"{k} {v:.2e}" for k, v in grel.items()))
    check(rel < 1e-5, f"enumerated LBA loss {le} vs analytic {la}")
    del fit, mp, values
    torch.cuda.empty_cache()
    print(f"[variants] steps/s (host clock): spline stage 1 {sps1:.3f}, spline "
          f"stage 2 {sps2:.3f}, wrapped {sps3:.3f}, lba {sps4:.3f}; peak device "
          f"memory of the fits {peak1 / 2**30:.2f} / {peak2 / 2**30:.2f} / "
          f"{peak3 / 2**30:.2f} / {peak4 / 2**30:.2f} GiB; on {card}")
    print(f"[variants] launches by width over the variant fits: {launches}")
    return launches


# ---------------------------------------------------------------------------
# [mcmc]: NUTS over the phase model, the chains batched through one
# phase_fwdgrad launch per leapfrog step
# ---------------------------------------------------------------------------

# the JAX package's MCMC design points (bench.py): (a) `nuts_phi_wrapped`
# (bench.py:264-333), the wrapped phases sampled with the genes conditioned;
# (b) `nuts` (bench.py:163-262), nu and shape_inv sampled with the phases
# conditioned.  Nh = 3 (n_harmonics=1) in both.
MCMC_A = dict(Nc=2000, Ng=50, sim_seed=17, chains=64, warmup=400, samples=150,
              svi_fit=800, svi_warm=400, max_depth=6, init_jitter=1.0)
MCMC_B = dict(Nc=500, Ng=50, sim_seed=13, chains=256, warmup=400, samples=100,
              svi_fit=500, max_depth=6, init_jitter=2.0)
MCMC_NH = 3
# the default run's depth of (a) and (b): fewer warmup steps and draws, the
# same chains and gates (R-hat < 1.05 holds at this depth); ``--mcmc`` runs
# the design points above
MCMC_DEFAULT = {"a": dict(MCMC_A, warmup=200, samples=100),
                "b": dict(MCMC_B, warmup=200, samples=100)}

# the fused velocity samplers' shapes: [mcmc] (c) (bench.py's `nuts` draw,
# 50 x 500, 64 chains) and [smc] (c) (20 x 200, 256 particles), Nh = 3
VELO_MCMC = dict(Nc=500, Ng=50, sim_seed=13, chains=64, warmup=200,
                 samples=100, svi_fit=500, max_depth=5, init_jitter=1.0)
VELO_SMC = dict(Nc=200, Ng=20, sim_seed=14, chains=256, num_moves=2,
                target_ess=0.35, max_stages=60, svi_steps=0)


# the chain operands of each kernel pair after the counts, in call order
# (delta_nu, "dnu", then Db follow), each with its rank unbatched
CHAIN_OPERANDS = {
    "phase": (("nu", 2), ("zeta", 2), ("cf", 1), ("r", 1)),
    "velo": (("nu", 2), ("zeta", 2), ("zdphi", 2), ("cf", 1), ("omega", 1),
             ("lbeta", 1), ("lgamma", 1), ("r", 1)),
}


def _chain_inputs(torch, Ng, Nc, K, seed, batched, nh=MCMC_NH, kind="phase",
                  Nb=0):
    """make_inputs' (``kind="velo"``: make_velo_inputs') operands with a
    leading chain axis K on those named in ``batched`` (of
    CHAIN_OPERANDS[kind] and "dnu"): seeded perturbations per chain.
    Returns (counts, the parameters in call order with delta_nu last (None
    without Nb), Db)."""
    if kind == "velo":
        *vals, dnu, Db = make_velo_inputs(torch, Ng, Nc, seed, Nb=Nb, nh=nh)
        counts, vals = vals[:2], vals[2:]
    else:
        S, *vals, dnu, Db = make_inputs(torch, Ng, Nc, seed, Nb=Nb, nh=nh)
        counts = [S]
    names = [n for n, _ in CHAIN_OPERANDS[kind]] + ["dnu"]
    out = dict(zip(names, vals + [dnu]))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 5)
    for name in batched:
        x = out[name][None].repeat((K,) + (1,) * out[name].dim())
        x = x + 0.05 * torch.randn(x.shape, generator=g, device="cuda")
        out[name] = x.abs() + 0.05 if name == "r" else x
    return counts, [out[n] for n in names], Db


def _chain(t, c, base_dim):
    if t is None:
        return None
    return t[c] if t.dim() > base_dim else t


def _batched_parity_case(torch, tag, Ng, Nc, K, batched, seed, want_disp,
                         nh=MCMC_NH, plain_batched=True, mode="fwdgrad",
                         kind="phase", Nb=0, wide=False):
    """The chain-batched ``kind``_fwdgrad (or, ``mode="fwd"``, _fwd, of the
    phase or velocity pair; ``wide``: a width past 16 columns, on the wide
    body, counted as *_wide and held against the wide twin) against its
    plain version (over the chain batch, or chain by chain where a batched
    plain call would not fit) and against K unbatched launches.  Returns
    (max abs error, max loss rel error) over the chains and both
    references."""
    from velocycle_tpu_torch.ops import nb_kernels as K_

    grad = mode == "fwdgrad"
    name = f"{kind}_{mode}" + ("_wide" if wide else "")
    kern = getattr(K_, f"{kind}_{mode}")
    plain_one = getattr(K_, f"{name}_plain")
    # the phase pair's plain versions take the chain axis themselves
    plain_chains = (plain_one if kind == "phase"
                    else K_._velo_plain_chains(plain_one))
    grad_names = PHASE_GRADS if kind == "phase" else VELO_GRADS
    rtol = GRAD_RTOL if kind == "phase" else VELO_GRAD_RTOL
    kw = {"want_disp": want_disp} if grad else {}

    def split(out):   # (loss, grads) either way
        return out if grad else (out, ())

    counts, params, Db = _chain_inputs(torch, Ng, Nc, K, seed, batched, nh,
                                       kind, Nb)
    dims = [d for _, d in CHAIN_OPERANDS[kind]] + [2]
    lgk = lgamma_k_sum(torch, *counts)

    def call(fn, ps):
        return split(fn(*counts, *ps, Db, lgamma_k_sum=lgk, **kw))

    K_.reset_launch_counts()
    kl, kg = call(kern, params)
    check(K_.LAUNCH_CHAINS[name] == {K: 1},
          f"{tag}: {K_.LAUNCH_CHAINS[name]} launches, want one of {K} chains")
    if plain_batched:
        pl, pg = call(plain_chains, params)
    worst, lrel_max, oks = 0.0, 0.0, []
    for c in range(K):
        one = [_chain(t, c, d) for t, d in zip(params, dims)]
        sl, sg = call(kern, one)
        if plain_batched:
            refs = [(pl[c], [None if x is None else x[c] for x in pg])]
        else:
            refs = [call(plain_one, one)]
        refs.append((sl, sg))
        for ref_l, ref_g in refs:
            lrel = abs(float(kl[c]) - float(ref_l)) / max(abs(float(ref_l)), 1.0)
            lrel_max = max(lrel_max, lrel)
            worst = max(worst, abs(float(kl[c]) - float(ref_l)) if not grad else 0.0)
            oks.append(lrel < LOSS_RTOL)
            for gname, a, b in zip(grad_names, kg, ref_g):
                if b is None:
                    oks.append(a is None)
                    continue
                worst = max(worst, float((a[c] - b).abs().max()))
                if float(b.abs().max()) == 0.0:
                    oks.append(float(a[c].abs().max()) == 0.0)
                else:
                    oks.append(_rel(a[c], b) < rtol)
        if K == 1:   # the batched launch at K = 1 is the unbatched one
            same = torch.equal(kl[0], sl) and all(
                (a is None and b is None) or torch.equal(a[0], b)
                for a, b in zip(kg, sg))
            print(f"[parity] {tag}: K = 1 batched vs unbatched launch "
                  f"bit-identical: {same}")
            oks.append(same)
    what = f"disp_grad={want_disp}" if grad else "loss only"
    print(f"[parity] {name} {tag} ({'+'.join(batched)} batched, {what}): max "
          f"abs err {worst:.3e}, loss rel {lrel_max:.2e} against the plain "
          f"version and {K} single launches: {'ok' if all(oks) else 'FAIL'}")
    check(all(oks), f"{name} {tag}: the chain-batched kernel disagrees")
    return worst, lrel_max


def mcmc_kernel_parity(torch, seed):
    """[parity] of the chain-batched phase_fwdgrad at the [mcmc] shapes and
    at full width."""
    a, b = MCMC_A, MCMC_B
    out = {}
    out["a"] = _batched_parity_case(
        torch, f"(a) {a['Ng']}x{a['Nc']} K={a['chains']}", a["Ng"], a["Nc"],
        a["chains"], ("zeta",), seed, want_disp=False)
    out["b"] = _batched_parity_case(
        torch, f"(b) {b['Ng']}x{b['Nc']} K={b['chains']}", b["Ng"], b["Nc"],
        b["chains"], ("nu", "r"), seed, want_disp=True)
    out["full"] = _batched_parity_case(
        torch, f"full {NG}x{NC} K=4", NG, NC, 4, ("nu", "r"), seed,
        want_disp=True, nh=NH, plain_batched=False)
    out["k1"] = _batched_parity_case(
        torch, f"full {NG}x{NC} K=1", NG, NC, 1, ("nu", "zeta"), seed,
        want_disp=True, nh=NH, plain_batched=False)
    torch.cuda.empty_cache()
    worst = max(v[0] for v in out.values())
    lrel = max(v[1] for v in out.values())
    return {"max_abs_err": worst, "loss_rel_err": lrel}


def _kernel_device_ms(torch, fn, n=20):
    """Device time per call of ``fn`` spent in the port's own kernels (the
    events named vct::..., torch.profiler over ``n`` calls): at small
    shapes, where CUDA events around back-to-back calls time the wrapper's
    host work, the kernels' own time.  None when the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "vct::" in e.key:
            dt = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if dt is None else dt
    return total / n / 1e3 if total else None


def _batched_ops(torch, kind, mode, counts, chains, Db, nh, wd):
    """(FP32 operations of ``kind``_``mode`` over these counts at nh basis
    columns for every chain of ``chains`` (each its parameters in call
    order, delta_nu last), share of counts >= 2): OPS / OPS_VELO at Nh = 5
    less OPS_PER_COLUMN per missing column; with the dispersion gradient,
    its operations counted chain by chain on each element's branch."""
    grad = mode == "fwdgrad"
    lg, share = _ratio_ops(torch, counts)
    N = counts[0].numel()
    if kind == "phase":
        cols = OPS_PER_COLUMN["common"] + (
            OPS_PER_COLUMN["fwdgrad"] if grad else 0)
        per = (OPS["common"] - (NH - nh) * cols
               + (OPS["fwdgrad"] - (0 if wd else OPS_DISP) if grad
                  else OPS["fwd"]))
    else:
        cols = OPS_PER_COLUMN["velo_common"] + (
            OPS_PER_COLUMN["velo_fwdgrad"] if grad else 0)
        per = (OPS_VELO["common"] - (NH - nh) * cols
               + (OPS_VELO["fwdgrad"] + (OPS_VELO["disp"] if wd else 0)
                  if grad else OPS_VELO["fwd"]))
    ops = len(chains) * (per * N + lg)
    if grad and wd:
        ops += sum(_disp_ops(torch, kind, counts, o[:-1], o[-1], Db)
                   for o in chains)
    return ops, share


def _batched_timing(torch, seed, card, cfg, batched, mode, wd=False,
                    nh=MCMC_NH, kind="phase", wide=False):
    """One chain-batched launch of ``kind``_``mode`` (``wide``: a width past
    16 columns, on the wide body, beside the wide twin) against K unbatched
    launches at ``cfg``'s shape, each beside its bound (bytes: the counts
    once, every chain's operands and results; operations: every chain's)
    and the batched plain version.  No PyTorch call computes this
    function: no library column."""
    from velocycle_tpu_torch.ops import nb_kernels as K_
    from velocycle_tpu_torch.tools import kernel_profile as TP

    grad = mode == "fwdgrad"
    name = f"{kind}_{mode}" + ("_wide" if wide else "")
    kern = getattr(K_, f"{kind}_{mode}")
    plain_one = getattr(K_, f"{name}_plain")
    plain = (plain_one if kind == "phase"
             else K_._velo_plain_chains(plain_one))
    kw = {"want_disp": wd} if grad else {}
    Ng, Nc, Kc = cfg["Ng"], cfg["Nc"], cfg["chains"]
    counts, params, Db = _chain_inputs(torch, Ng, Nc, Kc, seed, batched, nh,
                                       kind)
    lgk = lgamma_k_sum(torch, *counts)
    dims = [d for _, d in CHAIN_OPERANDS[kind]] + [2]
    # the gradients: one per operand (the velocity pair's log_gamma
    # included), each the operand's unbatched size
    outs = Kc * sum(Ng * nh if d == 2 and n == "nu" else
                    Nc * nh if d == 2 else (Ng if n in ("r", "lbeta", "lgamma")
                                            else Nc)
                    for n, d in CHAIN_OPERANDS[kind]) if grad else 0
    nbytes = (sum(S.numel() * S.element_size() for S in counts)
              + 4 * sum(t.numel() for t in params if t is not None)
              + 4 * outs + 4 * Kc)
    ops_one = [[_chain(t, c, d) for t, d in zip(params, dims)]
               for c in range(Kc)]
    ops, share = _batched_ops(torch, kind, mode, counts, ops_one, Db, nh, wd)

    def batched_call():
        return kern(*counts, *params, Db, lgamma_k_sum=lgk, **kw)

    def single_calls():
        return [kern(*counts, *o, Db, lgamma_k_sum=lgk, **kw) for o in ops_one]

    def plain_call():
        return plain(*counts, *params, Db, lgamma_k_sum=lgk, **kw)

    s1 = TP.event_ms(single_calls, reps=3)
    ms, b_reps = _median_reps(TP, {"batched": batched_call})["batched"]
    s2 = TP.event_ms(single_calls, reps=3)
    p1 = TP.event_ms(plain_call, reps=3)
    dev_ms = _kernel_device_ms(torch, batched_call)
    bound, bound_by = TP.bound_ms(nbytes, ops)
    single = (s1 + s2) / 2
    what = f"disp_grad={wd}" if grad else "loss only"
    dev_note = ("not measured (no device time in the trace)" if dev_ms is None
                else f"{dev_ms:.4f} ms, {bound / dev_ms:.1%} of bound")
    print(f"[timing] {name} over {Kc} chains @ {Ng}x{Nc} int16, Nh={nh}, "
          f"{what} on {card}: one batched launch median {ms:.4f} ms of "
          f"{_reps_note(b_reps)}, "
          f"{Kc} single launches {s1:.3f} / {s2:.3f} ms "
          f"({single / ms:.1f}x), plain batched {p1:.3f} ms, bound "
          f"{bound:.4f} ms by {bound_by} ({nbytes / 1e6:.3f} MB, "
          f"{ops / 1e9:.3f} GFLOP, {share:.3f} of counts >= 2), "
          f"{bound / ms:.1%} of bound; its kernels' device time per launch "
          f"(torch.profiler) {dev_note}; library_ms: none")
    del counts, params, ops_one
    torch.cuda.empty_cache()
    return {"chains": Kc, "shape": [Ng, Nc], "ms": ms, "device_ms": dev_ms,
            "single_launches_ms": single, "plain_ms": p1, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None}


def mcmc_kernel_timing(torch, seed, card):
    """[timing] of the chain-batched phase_fwdgrad at [mcmc]'s shapes."""
    return {tag: _batched_timing(torch, seed, card, cfg, batched, "fwdgrad",
                                 wd)
            for tag, cfg, batched, wd in (("a", MCMC_A, ("zeta",), False),
                                          ("b", MCMC_B, ("nu", "r"), True))}


class _EvalCounter:
    """Counts the sampler's batched potential evaluations (each is one
    value-and-gradient of all chains or particles) while it is entered;
    ``module``: the sampler's module, `infer.mcmc` by default."""

    def __init__(self, module=None):
        self.module = module

    def __enter__(self):
        from velocycle_tpu_torch.infer import mcmc as TM

        mod = self.module or TM
        self.mod, self.orig, self.calls = mod, mod._batched_value_and_grad, 0

        def counted(potential_fn):
            vg = self.orig(potential_fn)

            def value_and_grad(q):
                self.calls += 1
                return vg(q)

            return value_and_grad

        mod._batched_value_and_grad = counted
        return self

    def __exit__(self, *exc):
        self.mod._batched_value_and_grad = self.orig


def _device_profile(torch, fn, tag, n, unit):
    """Device time by kernel over ``n`` units of ``fn()`` (torch.profiler):
    wall, device-busy share, launches per unit and the top kernels; only
    device-side kernel events are summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = e.self_cuda_time_total
        if dt:
            rows.append((dt, e.key, e.count))
    if not rows:
        print(f"[{tag}] profile: no device time in the trace: not measured")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[2] for r in rows) / n
    print(f"[{tag}] profile, {n} {unit}s: wall {wall * 1e3:.2f} ms (profiler "
          f"on), device kernels busy {busy * 1e3:.2f} ms ({busy / wall:.1%}), "
          f"{launches:.0f} kernel launches per {unit}")
    for dt, key, count in rows[:6]:
        print(f"[{tag}]   {dt / 1e3 / n:8.3f} ms/{unit}  x{count / n:<7.1f} "
              f"{key[:90]}")
    return busy / wall


def _mcmc_sim(torch, cfg, seed):
    """bench.py's `_sim` draw (the port's simulate_data, one harmonic)."""
    import numpy as np

    from velocycle_tpu_torch import Cycle, Phases, simulate_data

    adata = simulate_data(Nc=cfg["Nc"], Ng=cfg["Ng"], omegas_to_test=(0.4,),
                          seed=cfg["sim_seed"] + seed)
    cycle = Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = Phases.from_angles(np.asarray(adata.obs["simulated_phis"].values),
                                cell_names=list(adata.obs.index))
    return adata, cycle, phases


def _eval_ms(torch, info, q, n=20):
    """Host-clock ms of one batched value-and-gradient of the potential at
    the chains' states q (the rest of a leapfrog is the sampler's own
    bookkeeping)."""
    from velocycle_tpu_torch.infer import mcmc as TM

    vg = TM._batched_value_and_grad(info.potential_fn)
    vg(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        vg(q)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _mcmc_report(tag, K_, counter, iters, dt, chains, samples, card,
                 kind="phase"):
    """Print and check one run's launches: exactly one chain-batched
    ``kind``_fwdgrad launch per batched potential evaluation."""
    by_k = dict(K_.LAUNCH_CHAINS[f"{kind}_fwdgrad"])
    batched = by_k.get(chains, 0)
    print(f"[mcmc] {tag}: {kind}_fwdgrad launches by chain count {by_k}, "
          f"{kind}_fwd {K_.LAUNCHES[f'{kind}_fwd']}; {counter.calls} batched "
          f"potential evaluations over {iters} iterations "
          f"({counter.calls / iters:.1f} per iteration); wall {dt:.1f} s, "
          f"{chains * samples / dt:.1f} samples/s on {card}")
    check(batched == counter.calls and batched > 0,
          f"{tag}: {batched} launches of {chains} chains for "
          f"{counter.calls} batched evaluations")
    return by_k


# the runs' convergence gate (the JAX package's bench row for (a) reads
# 1.016, docs/phase_sampling.md; (b) on the plain path 1.026, PERF.md)
MCMC_MAX_RHAT = 1.05


def _local_count(n, mesh, axis):
    """This rank's share of ``n`` chains or particles on ``mesh``'s
    ``axis`` (all ``n`` without a mesh)."""
    if mesh is None:
        return n
    from velocycle_tpu_torch.parallel.mesh import axis_share

    share = axis_share(mesh, axis, n)
    return share.hi - share.lo


def mcmc_wrapped(torch, seed, card, cfg=MCMC_A, device="cuda", mesh=None):
    """(a) `nuts_phi_wrapped`: an 800-step phase fit locates the genes; the
    wrapped phases are sampled with the genes conditioned, through
    MCMCFitModel on the fused data (the warm start takes its Hessian
    diagonal on the same counts through the plain path).  With ``mesh``
    (a ("chains",) mesh) this rank runs its share of the chains, one
    launch of them per batched evaluation, and gates the gathered draws;
    the device profile is left out."""
    import numpy as np

    from velocycle_tpu_torch import (
        MCMCFitModel, PhaseFitModel, preprocess_for_phase_estimation,
    )
    from velocycle_tpu_torch.ops import nb_kernels as K_
    from velocycle_tpu_torch.ops.circular import circular_corrcoef

    t0 = time.perf_counter()
    adata, cycle, phases = _mcmc_sim(torch, cfg, seed)
    kw = dict(n_harmonics=1, with_delta_nu=False, device=device)
    mp = preprocess_for_phase_estimation(adata, cycle, phases,
                                         use_fused_nb=True, **kw)
    mp_w = preprocess_for_phase_estimation(
        adata, cycle, phases, use_fused_nb=True, phi_parametrization="wrapped",
        **kw)
    check(mp_w.data.S.dtype == torch.int16, "(a): counts not int16")
    svi = PhaseFitModel(mp, get_posterior=False)
    svi.fit(num_steps=cfg["svi_fit"], seed=seed + 2)
    svi_phis = np.arctan2(svi.params["phixy_locs"][:, 1],
                          svi.params["phixy_locs"][:, 0])
    cond = {"nu": svi.params["nu_locs"],
            "shape_inv": svi.params["shape_inv_locs"]}
    torch.cuda.synchronize()
    print(f"[mcmc] (a) set-up: simulate, preprocess x2, {cfg['svi_fit']}-step "
          f"phase fit: {time.perf_counter() - t0:.1f} s on {card}")

    fm = MCMCFitModel(
        mp_w, condition_on=cond, num_chains=cfg["chains"],
        num_warmup=cfg["warmup"], num_samples=cfg["samples"],
        svi_steps=cfg["svi_warm"], block_sites=(), max_depth=cfg["max_depth"],
        init_jitter=cfg["init_jitter"],
    )
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    with _EvalCounter() as counter:
        t0 = time.perf_counter()
        fm.run(seed + 9, mesh=mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    iters = cfg["warmup"] + cfg["samples"]
    by_k = _mcmc_report("(a) nuts_phi_wrapped", K_, counter, iters, dt,
                        _local_count(cfg["chains"], mesh, "chains"),
                        cfg["samples"], card)
    # single launches: the SVI warm start's steps, and one per init_model
    # on the fused data (its baseline, traced with gradients)
    check(by_k.get(1, 0) >= cfg["svi_warm"],
          f"(a): {by_k.get(1, 0)} single launches in a {cfg['svi_warm']}-step "
          f"SVI warm start")
    d = fm.diagnostics
    phi = fm.posterior["phi"]
    cc = float(circular_corrcoef(torch.as_tensor(fm.phase_fit.phis),
                                 torch.as_tensor(svi_phis)))
    print(f"[mcmc] (a): accept {d['accept_rate']:.4f}, max split R-hat "
          f"{d['max_split_rhat']:.4f}, min ESS {d['min_ess']:.1f}, median ESS "
          f"{d['median_ess']:.1f} of {cfg['chains'] * cfg['samples']} draws, "
          f"circular corr of posterior-mean phases with the SVI phases "
          f"{cc:.4f}; peak device memory {peak / 2**30:.3f} GiB on {card}")
    check(phi.shape == (cfg["chains"] * cfg["samples"], cfg["Nc"])
          and ((phi >= -np.pi) & (phi < np.pi)).all(), "(a): phi outside [-pi, pi)")
    check(d["accept_rate"] > 0.6, f"(a): accept rate {d['accept_rate']}")
    check(cc > 0.95, f"(a): circular correlation {cc}")
    check(d["max_split_rhat"] < MCMC_MAX_RHAT,
          f"(a): max split R-hat {d['max_split_rhat']} (gate "
          f"{MCMC_MAX_RHAT})")
    res = {"launches": by_k, "evals": counter.calls, "iters": iters,
           "wall_s": dt, "samples_per_s": cfg["chains"] * cfg["samples"] / dt,
           "accept": d["accept_rate"], "max_split_rhat": d["max_split_rhat"],
           "min_ess": d["min_ess"], "median_ess": d["median_ess"],
           "circ_corr": cc, "peak_gib": peak / 2**30}
    if mesh is not None:
        return res
    info = fm.mcmc.model_info
    q = fm.mcmc._samples_u[:, -1].contiguous()
    busy = _device_profile(torch, lambda: _nuts_transitions(info, q, cfg),
                           "mcmc", 4, "NUTS transition")
    ev = _eval_ms(torch, info, q)
    print(f"[mcmc] (a): per leapfrog {dt / counter.calls * 1e3:.2f} ms of "
          f"wall (run incl. warm start), of it {ev:.2f} ms one batched "
          f"evaluation alone (host clock) on {card}")
    return {**res, "busy": busy}


def _velo_sim(torch, cfg, seed, device, fused=True):
    """bench.py's `_sim` draw of ``cfg``'s size, preprocessed for the fused
    velocity kernels (``fused=False``: the plain path, float32 counts): the
    Fourier model, one harmonic (Nh = 3) and one for the angular speed,
    int16 S and U."""
    from velocycle_tpu_torch import (
        AngularSpeed, preprocess_for_velocity_estimation,
    )

    adata, cycle, phases = _mcmc_sim(torch, cfg, seed)
    speed = AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                       stds=0.5)
    mp = preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=1, omega_n_harmonics=1,
        with_delta_nu=False, model_type="fourier", use_fused_nb=fused,
        device=device)
    check(not fused or (mp.data.S.dtype == torch.int16
                        and mp.data.U.dtype == torch.int16),
          "velocity counts not int16")
    return adata, mp


# the (beta, gamma, omega) scale ridge of the velocity model: log_beta + t,
# log_gamma + t and nu_omega e^t leave ElogU as it is but for the relu
# gate's 1e-5 floor, so the likelihood is flat along it and only the
# priors bound it (tests/test_torch_mcmc.py walks the same points)
RIDGE_T = tuple(-2.0 + 0.5 * i for i in range(9))


def _flat_states(torch, info, values):
    """The flat unconstrained points (K, dim) of ``info``'s sites at the
    constrained ``values`` {site: (K, ...)}."""
    dev = info.init_u.device
    return torch.cat([
        c.inverse(torch.as_tensor(values[n], dtype=torch.float32, device=dev)
                  .reshape((-1,) + tuple(shape))).reshape(-1, size)
        for n, (shape, size, c) in info.site_meta.items()], -1)


def _ridge(torch, info, u):
    """RIDGE_T's points of the scale ridge through the flat point u (dim,):
    (len(RIDGE_T), dim)."""
    t = torch.tensor(RIDGE_T, device=u.device)[:, None]
    parts, i = [], 0
    for name, (_, size, _) in info.site_meta.items():
        x = u[i:i + size].expand(len(RIDGE_T), size)
        if name in ("log_beta", "log_gamma"):
            x = x + t
        elif name == "nu_omega":
            x = x * torch.exp(t)
        parts.append(x)
        i += size
    return torch.cat(parts, -1)


def _potential_parity(torch, tag, fused_info, plain_info, q, grad_rtol):
    """The fused path's potential and gradient over the chain batch q (ONE
    chain-batched launch) against the plain path's: each potential less its
    own baseline constant (minus the log joint), rel per point (gate
    LOSS_RTOL), and the gradient max|a-b|/max|a| per point (gate
    ``grad_rtol``).  Returns (loss rel, gradient rel), the worst points'."""
    from velocycle_tpu_torch.infer import mcmc as TM

    check(list(fused_info.site_meta) == list(plain_info.site_meta),
          f"{tag}: the paths' sites differ")
    vf, gf = TM._batched_value_and_grad(fused_info.potential_fn)(q)
    vp, gp = TM._batched_value_and_grad(plain_info.potential_fn)(q)
    jf = vf.double() - fused_info.log_offset
    jp = vp.double() - plain_info.log_offset
    loss_rel = float(((jf - jp).abs() / jp.abs()).max())
    grad_rel = max(_rel(gf[k], gp[k]) for k in range(q.shape[0]))
    ok = (bool(torch.isfinite(vf).all() and torch.isfinite(gf).all())
          and loss_rel < LOSS_RTOL and grad_rel < grad_rtol)
    print(f"{tag}: fused against plain at {q.shape[0]} points in one chain "
          f"batch: minus log joint rel {loss_rel:.2e} (gate {LOSS_RTOL:g}), "
          f"gradient {grad_rel:.2e} (gate {grad_rtol:g})")
    check(ok, f"{tag}: fused vs plain potential rel {loss_rel}, gradient "
          f"{grad_rel}")
    return loss_rel, grad_rel


def velo_ridge(torch, seed, card, fm, cfg=VELO_MCMC, device="cuda"):
    """[mcmc] (c)'s fused velocity potential and gradient held against the
    plain path's along the scale ridge, at (c)'s shape (its counts, float32
    on the plain side): through a prior draw (tests/test_torch_mcmc.py's
    point) and through the last draw of (c)'s first chain (``fm``, the
    fused run), RIDGE_T's 9 points each in one chain batch."""
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import mcmc as TM

    _, pmp = _velo_sim(torch, cfg, seed, device, fused=False)
    plain_model = handlers.condition(pmp.model_fn, data=fm.condition)
    draws = fm.mcmc.get_samples(group_by_chain=True)
    out = {}
    for point, init in (
            ("prior draw", None),
            ("(c)'s last draw", {k: v[0, -1] for k, v in draws.items()})):
        finfo = TM.init_model(fm.model, fm.metaparams.data, seed=seed + 13,
                              init_values=init)
        pinfo = TM.init_model(plain_model, pmp.data,
                              init_values=finfo.unflatten(finfo.init_u))
        out[point] = _potential_parity(
            torch, f"[mcmc] (c) ridge through the {point}", finfo, pinfo,
            _ridge(torch, finfo, finfo.init_u), VELO_GRAD_RTOL)
    return out


def _rhat_by_site(summ):
    """{site: (max split R-hat, min ESS)} of a sampler's summary."""
    import numpy as np

    return {k: (float(np.nanmax(v["rhat"])), float(np.nanmin(v["ess"])))
            for k, v in summ.items()}


def mcmc_velocity(torch, seed, card, cfg=VELO_MCMC, device="cuda",
                  fused=True, ridge=False):
    """(c) velocity NUTS on fused int16 counts: bench.py's `nuts` draw (50
    x 500), phi_xy and shape_inv conditioned (the simulated dispersions),
    so velo_fwdgrad runs without the dispersion gradient; MCMCFitModel with
    a 500-step SVI warm start, 64 chains x (200 warmup + 100 draws),
    max_depth 5.  Gates: finite draws, accept > 0.5, exactly one K = 64
    velo_fwdgrad per batched potential evaluation besides the single
    launches of the warm start and the baselines.  Split R-hat and ESS are
    printed by site without a gate: the (beta, gamma, omega) scale ridge is
    bounded by the priors alone.  ``fused=False``: the same run on the
    plain path (float32 counts, the same seeds; no launch at all), to read
    its R-hat beside the fused run's; ``ridge``: `velo_ridge` after the
    fused run."""
    import numpy as np

    from velocycle_tpu_torch import MCMCFitModel
    from velocycle_tpu_torch.ops import nb_kernels as K_

    path = "fused" if fused else "plain"
    t0 = time.perf_counter()
    adata, mp = _velo_sim(torch, cfg, seed, device, fused=fused)
    cond = {"phi_xy": mp.data.phixy_prior,
            "shape_inv": np.asarray(adata.var["simulated_shape_inv"],
                                    np.float32)}
    fm = MCMCFitModel(mp, condition_on=cond, num_chains=cfg["chains"],
                      num_warmup=cfg["warmup"], num_samples=cfg["samples"],
                      svi_steps=cfg["svi_fit"], max_depth=cfg["max_depth"],
                      init_jitter=cfg["init_jitter"])
    check(not (fused and fm.metaparams.data.disp_grad),
          "(c): the dispersion gradient on")
    print(f"[mcmc] (c) {path} set-up: simulate, preprocess: "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    with _EvalCounter() as counter:
        t0 = time.perf_counter()
        fm.run(seed + 11)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    iters = cfg["warmup"] + cfg["samples"]
    if fused:
        by_k = _mcmc_report("(c) velocity nuts", K_, counter, iters, dt,
                            cfg["chains"], cfg["samples"], card, kind="velo")
        check(set(by_k) <= {1, cfg["chains"]}
              and by_k.get(1, 0) >= cfg["svi_fit"],
              f"(c): launches by chain count {by_k}")
        check(K_.LAUNCH_CHAINS["phase_fwdgrad"] == {}, "(c): a phase launch")
    else:
        by_k = {}
        print(f"[mcmc] (c) plain velocity nuts: {counter.calls} batched "
              f"potential evaluations over {iters} iterations "
              f"({counter.calls / iters:.1f} per iteration); wall {dt:.1f} s, "
              f"{cfg['chains'] * cfg['samples'] / dt:.1f} samples/s on {card}")
        check(not any(K_.LAUNCHES.values()),
              f"(c) plain: a kernel launch {K_.LAUNCHES}")
    d = fm.diagnostics
    by_site = _rhat_by_site(fm.summary)
    print(f"[mcmc] (c) {path}: max split R-hat (min ESS) by site (no gate) "
          + ", ".join(f"{k} {r:.4f} ({e:.1f})" for k, (r, e) in by_site.items()))
    draws = fm.mcmc.get_samples()
    print(f"[mcmc] (c) {path}: accept {d['accept_rate']:.4f}, max split R-hat "
          f"{d['max_split_rhat']:.4f}, min ESS {d['min_ess']:.1f}, median ESS "
          f"{d['median_ess']:.1f} of {cfg['chains'] * cfg['samples']} draws; "
          f"peak device memory {peak / 2**30:.3f} GiB on {card}")
    check(all(np.isfinite(v).all() for v in draws.values()),
          f"(c) {path}: non-finite draws")
    check(d["accept_rate"] > 0.5, f"(c) {path}: accept rate {d['accept_rate']}")
    res = {"launches": by_k, "evals": counter.calls, "iters": iters,
           "wall_s": dt, "samples_per_s": cfg["chains"] * cfg["samples"] / dt,
           "accept": d["accept_rate"], "max_split_rhat": d["max_split_rhat"],
           "min_ess": d["min_ess"], "median_ess": d["median_ess"],
           "peak_gib": peak / 2**30}
    if not fused:
        return {**res, "by_site": by_site}
    if ridge:
        res["ridge"] = velo_ridge(torch, seed, card, fm, cfg, device)
        res["by_site"] = by_site
    info = fm.mcmc.model_info
    q = fm.mcmc._samples_u[:, -1].contiguous()
    busy = _device_profile(torch, lambda: _nuts_transitions(info, q, cfg),
                           "mcmc", 4, "NUTS transition")
    ev = _eval_ms(torch, info, q)
    print(f"[mcmc] (c): per leapfrog {dt / counter.calls * 1e3:.2f} ms of "
          f"wall (run incl. warm start), of it {ev:.2f} ms one batched "
          f"evaluation alone (host clock) on {card}")
    return {**res, "busy": busy, "leapfrog_ms": dt / counter.calls * 1e3,
            "eval_ms": ev}


def velo_plain_vs_fused(torch, seed, card, fused_run, device="cuda"):
    """``--mcmc``: (c) again on the plain path with the same seeds, chains,
    warmup and depth, its R-hat and ESS by site printed beside the fused
    run's (``fused_run``: `mcmc_velocity`'s with ``ridge``)."""
    plain = mcmc_velocity(torch, seed, card, device=device, fused=False)
    f, p = fused_run["by_site"], plain["by_site"]
    print("[mcmc] (c) max split R-hat by site, fused / plain: "
          + ", ".join(f"{k} {f[k][0]:.4f} / {p[k][0]:.4f}" for k in f))
    print("[mcmc] (c) min ESS by site, fused / plain: "
          + ", ".join(f"{k} {f[k][1]:.1f} / {p[k][1]:.1f}" for k in f))
    worst = {tag: max(d, key=lambda k: d[k][0]) for tag, d in
             (("fused", f), ("plain", p))}
    print(f"[mcmc] (c) fused: max R-hat {fused_run['max_split_rhat']:.4f}, "
          f"min ESS {fused_run['min_ess']:.1f}, worst site {worst['fused']}; "
          f"plain: max R-hat {plain['max_split_rhat']:.4f}, min ESS "
          f"{plain['min_ess']:.1f}, worst site {worst['plain']}; accept "
          f"{fused_run['accept']:.4f} / {plain['accept']:.4f}")
    return plain


def _nuts_transitions(info, q, cfg):
    """Four NUTS transitions of the chains at q, the shortest run of the
    sampler (three one-step warmup windows and one draw), for the profile."""
    from velocycle_tpu_torch.infer import mcmc as TM

    TM.nuts(info._replace(init_u=q), list(range(q.shape[0])), num_warmup=0,
            num_samples=1, max_depth=cfg["max_depth"], adapt_mass=False)


def mcmc_genes(torch, seed, card, cfg=MCMC_B, device="cuda"):
    """(b) `nuts`: the phases conditioned on the prior; a 500-step SVI warm
    start, then nu and shape_inv sampled through MCMC on the fused data in
    the whitened coordinates of the analytic Fisher blocks for nu and the
    Hessian diagonal for shape_inv (both on the same counts through the
    plain path), as bench.py builds them."""
    import numpy as np

    from velocycle_tpu_torch import PhaseFitModel, preprocess_for_phase_estimation
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import MCMC
    from velocycle_tpu_torch.infer import mcmc as TM
    from velocycle_tpu_torch.models.basis import expression_basis
    from velocycle_tpu_torch.ops import nb_kernels as K_

    t0 = time.perf_counter()
    adata, cycle, phases = _mcmc_sim(torch, cfg, seed)
    kw = dict(n_harmonics=1, with_delta_nu=False, device=device)
    mp = preprocess_for_phase_estimation(adata, cycle, phases,
                                         use_fused_nb=True, **kw)
    plain = preprocess_for_phase_estimation(adata, cycle, phases,
                                            use_fused_nb=False, **kw)
    cond = {"phi_xy": mp.data.phixy_prior}
    fm = PhaseFitModel(mp, condition_on=cond, get_posterior=False)
    fm.fit(num_steps=cfg["svi_fit"], seed=seed + 2)
    init_values = {"nu": fm.params["nu_locs"],
                   "shape_inv": fm.params["shape_inv_locs"]}
    # Fisher blocks of the NB GLM in each gene's harmonic block (bench.py)
    pxy = mp.data.phixy_prior.cpu().numpy()
    zeta = expression_basis(mp.data, torch.atan2(mp.data.phixy_prior[:, 1],
                                                 mp.data.phixy_prior[:, 0]))
    zeta = zeta.cpu().numpy().astype(np.float64)
    elog = fm.params["nu_locs"] @ zeta.T + mp.data.count_factor.cpu().numpy()[None]
    mu = np.exp(elog)
    r_hat = fm.params["shape_inv_locs"]
    w = mu * r_hat[:, None] / (mu + r_hat[:, None])
    F = np.einsum("gc,ci,cj->gij", w, zeta, zeta)
    sd_nu = mp.data.sd_nu.cpu().numpy()
    F += np.apply_along_axis(np.diag, -1, 1.0 / np.maximum(sd_nu ** 2, 1e-12))
    # shape_inv's Hessian diagonal: HVP probes through the plain path
    model_p = handlers.condition(plain.model_fn, data=cond)
    info0 = TM.init_model(model_p, plain.data, init_values=init_values)
    sizes = {n: meta[1] for n, meta in info0.site_meta.items()}
    dim = sum(sizes.values())
    grad = torch.func.grad(info0.potential_fn)
    u0 = info0.init_u
    with torch.no_grad():
        hdiag = torch.func.vmap(
            lambda v: torch.sum(v * torch.func.jvp(grad, (u0,), (v,))[1]),
            chunk_size=64)(torch.eye(dim, device=device)).cpu().numpy()
    i0 = sizes["nu"]
    pre = {"nu": np.linalg.inv(F),
           "shape_inv": 1.0 / np.maximum(hdiag[i0:i0 + sizes["shape_inv"]], 1.0)}
    torch.cuda.synchronize()
    print(f"[mcmc] (b) set-up: simulate, preprocess x2, {cfg['svi_fit']}-step "
          f"SVI, Fisher blocks and {dim} Hessian probes: "
          f"{time.perf_counter() - t0:.1f} s on {card}")

    model = handlers.condition(mp.model_fn, data=cond)
    m = MCMC(model, kernel="nuts", num_warmup=cfg["warmup"],
             num_samples=cfg["samples"], num_chains=cfg["chains"],
             max_depth=cfg["max_depth"], init_values=init_values,
             preconditioner=pre, init_jitter=cfg["init_jitter"])
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    with _EvalCounter() as counter:
        t0 = time.perf_counter()
        m.run(seed, mp.data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    iters = cfg["warmup"] + cfg["samples"]
    by_k = _mcmc_report("(b) nuts", K_, counter, iters, dt, cfg["chains"],
                        cfg["samples"], card)
    check(set(by_k) <= {1, cfg["chains"]} and by_k.get(1, 0) <= 1,
          f"(b): launches {by_k} (one single launch at most: the baseline)")
    summ = m.summary()
    ess = np.concatenate([v["ess"].reshape(-1) for v in summ.values()])
    rhat = np.concatenate([v["rhat"].reshape(-1) for v in summ.values()])
    print("[mcmc] (b): max split R-hat by site "
          + ", ".join(f"{k} {np.nanmax(v['rhat']):.4f} (median "
                      f"{np.nanmedian(v['rhat']):.4f})" for k, v in summ.items()))
    s = m.get_samples()
    nu_mean = s["nu"].mean(0)
    corr = float(np.corrcoef(nu_mean.ravel(), fm.params["nu_locs"].ravel())[0, 1])
    acc = m.accept_rate()
    print(f"[mcmc] (b): accept {acc:.4f}, max split R-hat {np.nanmax(rhat):.4f}, "
          f"min ESS {np.nanmin(ess):.1f}, median ESS {np.nanmedian(ess):.1f} of "
          f"{cfg['chains'] * cfg['samples']} draws, corr of posterior-mean nu "
          f"with the SVI locs {corr:.5f}; peak device memory "
          f"{peak / 2**30:.3f} GiB on {card}")
    check(acc > 0.3, f"(b): accept rate {acc}")
    check(all(np.isfinite(v).all() for v in s.values()), "(b): non-finite draws")
    check(corr > 0.95, f"(b): nu correlation {corr}")
    check(np.nanmax(rhat) < MCMC_MAX_RHAT,
          f"(b): max split R-hat {np.nanmax(rhat)} (gate {MCMC_MAX_RHAT})")
    q = m._samples_u[:, -1].contiguous()
    busy = _device_profile(
        torch, lambda: _nuts_transitions(m.model_info, q, cfg), "mcmc", 4,
        "NUTS transition")
    ev = _eval_ms(torch, m.model_info, q)
    print(f"[mcmc] (b): per leapfrog {dt / counter.calls * 1e3:.2f} ms of "
          f"wall, of it {ev:.2f} ms one batched evaluation alone (host "
          f"clock) on {card}")
    return {"launches": by_k, "evals": counter.calls, "iters": iters,
            "wall_s": dt, "samples_per_s": cfg["chains"] * cfg["samples"] / dt,
            "accept": acc, "max_split_rhat": float(np.nanmax(rhat)),
            "min_ess": float(np.nanmin(ess)),
            "median_ess": float(np.nanmedian(ess)), "nu_corr": corr,
            "peak_gib": peak / 2**30, "busy": busy}


def mcmc_kernels(torch, seed, card):
    """[mcmc]'s [parity] and [timing] of the chain-batched launch, in the
    main process before the runs start (so that no other process shares the
    card while it is timed)."""
    t0 = time.perf_counter()
    parity = mcmc_kernel_parity(torch, seed)
    timing = mcmc_kernel_timing(torch, seed, card)
    print(f"[mcmc] batched kernel parity and timing: "
          f"{time.perf_counter() - t0:.1f} s")
    return parity, timing


def velo_chain_kernels(torch, seed, card):
    """[parity] and [timing] of the chain-batched velocity pair (rows 3''
    and 4''), before any fit: K in {1, 4, 64, 256} with the dispersion
    gradient on and off at [mcmc] (c)'s and [smc] (c)'s shapes, full width
    at K = 4, the spline basis' 11 columns, delta_nu, and K = 1
    bit-identical to the unbatched launch; then one batched launch timed
    against K single launches, the batched plain version and the bound."""
    t0 = time.perf_counter()
    m, q = VELO_MCMC, VELO_SMC
    genes = ("nu", "lbeta", "lgamma", "r")
    cells = ("zeta", "zdphi", "cf", "omega")
    cases = []
    for mode in ("fwdgrad", "fwd"):
        wds = (True, False) if mode == "fwdgrad" else (False,)
        for wd in wds:
            cases += [
                (f"(mcmc c) {m['Ng']}x{m['Nc']} K={m['chains']}", m["Ng"],
                 m["Nc"], m["chains"], ("nu", "lbeta", "lgamma"), wd, mode,
                 {}),
                (f"(smc c) {q['Ng']}x{q['Nc']} K={q['chains']}", q["Ng"],
                 q["Nc"], q["chains"], genes, wd, mode, {}),
                (f"{m['Ng']}x{m['Nc']} K=4", m["Ng"], m["Nc"], 4,
                 genes + cells, wd, mode, {}),
                (f"full {NG}x{NC} K=1", NG, NC, 1, ("nu", "zeta"), wd, mode,
                 dict(nh=NH, plain_batched=False)),
            ]
        cases += [
            (f"full {NG}x{NC} K=4", NG, NC, 4, ("nu", "r", "omega"), True,
             mode, dict(nh=NH, plain_batched=False)),
            (f"Nh={W_SPLINE} 257x3001 K=4", 257, 3001, 4, genes + ("zeta",),
             True, mode, dict(nh=W_SPLINE)),
            ("delta_nu Nb=2 257x3001 K=4", 257, 3001, 4, ("nu", "dnu"), True,
             mode, dict(Nb=2)),
        ]
    parity = {}
    for tag, Ng, Nc, Kc, batched, wd, mode, kw in cases:
        parity[(mode, tag, wd)] = _batched_parity_case(
            torch, tag, Ng, Nc, Kc, batched, seed, wd, mode=mode, kind="velo",
            **kw)
        torch.cuda.empty_cache()
    timing = {
        "velo_fwdgrad": {
            "mcmc_c": _batched_timing(torch, seed, card, m,
                                      ("nu", "lbeta", "lgamma"), "fwdgrad",
                                      False, kind="velo"),
            "smc_c": _batched_timing(torch, seed, card, q, genes, "fwdgrad",
                                     True, kind="velo")},
        "velo_fwd": {"smc_c": _batched_timing(torch, seed, card, q, genes,
                                              "fwd", kind="velo")},
    }
    print(f"[velo chains] batched kernel parity and timing: "
          f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name in ("velo_fwdgrad", "velo_fwd"):
        errs = [v for (mode, _, _), v in parity.items()
                if name == f"velo_{mode}"]
        out[name] = {"batched_parity": {"max_abs_err": max(e[0] for e in errs),
                                        "loss_rel_err": max(e[1] for e in errs)},
                     "batched_timing": timing[name]}
    return out


# the sampler is host-bound (PERF.md section 5): each run has a process of
# its own, on the card beside [quickstart] and [variants], so that the
# script takes the longest of them and not their sum (in turn it ran past
# the time limit on a slow host); ``--mcmc`` runs them alone, in turn
MCMC_RUNS = {"a": ("mcmc_wrapped", MCMC_A), "b": ("mcmc_genes", MCMC_B),
             "c": ("mcmc_velocity", VELO_MCMC)}


def _mcmc_child(tag, seed, card, cfg, device):
    """Run ``tag`` of [mcmc] in this (spawned) process: (ok, its result or
    the failure with its traceback, what it printed)."""
    import contextlib
    import io
    import traceback

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            res = globals()[MCMC_RUNS[tag][0]](torch, seed, card, cfg=cfg,
                                               device=device)
            print(f"[mcmc] run ({tag}) in all: {time.perf_counter() - t0:.1f} "
                  f"s (its own process)")
        return True, res, out.getvalue()
    except (Exception, SystemExit):     # reported to the main process
        return False, traceback.format_exc(), out.getvalue()


def start_mcmc_runs(seed, card, device="cuda", cfgs=None):
    """Start runs (a) and (b) in two spawned processes; returns (pool,
    {tag: pending result}) for `finish_mcmc_runs`."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(len(MCMC_RUNS))
    pending = {tag: pool.apply_async(
        _mcmc_child, (tag, seed, card, (cfgs or {}).get(tag, cfg), device))
        for tag, (_, cfg) in MCMC_RUNS.items()}
    return pool, pending


def finish_mcmc_runs(pool, pending, timeout=1100):
    """Wait for the runs, print what each printed, fail on a failed one;
    the processes are stopped in every case.  Returns {tag: result}."""
    try:
        runs = {}
        for tag, res in pending.items():
            ok, out, text = res.get(timeout=timeout)
            print(text, end="")
            check(ok, f"[mcmc] run ({tag}) failed:\n{out}")
            runs[tag] = out
        return runs
    finally:
        pool.terminate()
        pool.join()


def _add_launches(total, by_k):
    for k, n in by_k.items():
        total[str(k)] = total.get(str(k), 0) + n
    return total


def _strip(run):
    return {k: v for k, v in run.items() if k != "launches"}


def mcmc_row(parity, timing, runs):
    """phase_fwdgrad's row additions from [mcmc]'s phase runs (a), (b)."""
    launches = {}
    for tag in ("a", "b"):
        _add_launches(launches, runs[tag]["launches"])
    return {"mcmc_launches_by_chains": launches,
            "batched_parity": parity, "batched_timing": timing,
            "mcmc_runs": {k: _strip(runs[k]) for k in ("a", "b")}}


def velo_rows(chain_kernels, mcmc_run, smc_run_):
    """velo_fwdgrad's and velo_fwd's row additions (rows 4'' and 3''): the
    chain-batched pair's parity and timing, and [mcmc] (c)'s and [smc]
    (c)'s launches by chain count and numbers."""
    grad = _add_launches({}, mcmc_run["launches"])
    _add_launches(grad, smc_run_["launches"]["velo_fwdgrad"])
    return {
        "velo_fwdgrad": {**chain_kernels["velo_fwdgrad"],
                         "chain_launches_by_chains": grad,
                         "mcmc_runs": {"c": _strip(mcmc_run)},
                         "smc_runs": {"c": _strip(smc_run_)}},
        "velo_fwd": {**chain_kernels["velo_fwd"],
                     "chain_launches_by_chains": _add_launches(
                         {}, smc_run_["launches"]["velo_fwd"])},
    }


# ---------------------------------------------------------------------------
# [smc]: tempered SMC over the phase model, the particles as one chain batch
# ---------------------------------------------------------------------------

# the JAX package's SMC design points (bench.py `_smc_row`): (a) prior
# tempering at 20 x 200, (b) the variational bridge at 50 x 500; both
# one harmonic, phases conditioned, fused int16 counts
SMC_A = dict(Nc=200, Ng=20, sim_seed=14, chains=256, num_moves=2,
             target_ess=0.35, max_stages=60, svi_steps=0)
SMC_B = dict(Nc=500, Ng=50, sim_seed=13, chains=256, num_moves=2,
             target_ess=0.5, max_stages=60, svi_steps=800)
# tests/test_fit_mcmc.py's fixture (16 x 60) for the bridge-vs-prior gate
SMC_CHECK = dict(Nc=60, Ng=16, sim_seed=5, chains=256, num_moves=2,
                 target_ess=0.5)
SMC_LEAPFROG = 8        # infer.smc's hmc_leapfrog default


def smc_kernels(torch, seed, card):
    """[smc]'s [parity] and [timing] of the chain-batched phase_fwd (each
    stage's likelihood over the particles), before any fit: at (a)'s and
    (b)'s shapes with nu and r batched (K = 256), at full width (K = 4),
    and K = 1 bit-identical to the unbatched launch."""
    t0 = time.perf_counter()
    parity = {}
    for tag, cfg in (("a", SMC_A), ("b", SMC_B)):
        parity[tag] = _batched_parity_case(
            torch, f"(smc {tag}) {cfg['Ng']}x{cfg['Nc']} K={cfg['chains']}",
            cfg["Ng"], cfg["Nc"], cfg["chains"], ("nu", "r"), seed,
            want_disp=False, mode="fwd")
    parity["full"] = _batched_parity_case(
        torch, f"full {NG}x{NC} K=4", NG, NC, 4, ("nu", "r"), seed,
        want_disp=False, nh=NH, plain_batched=False, mode="fwd")
    parity["k1"] = _batched_parity_case(
        torch, f"full {NG}x{NC} K=1", NG, NC, 1, ("nu", "zeta"), seed,
        want_disp=False, nh=NH, plain_batched=False, mode="fwd")
    torch.cuda.empty_cache()
    timing = {tag: _batched_timing(torch, seed, card, cfg, ("nu", "r"), "fwd")
              for tag, cfg in (("a", SMC_A), ("b", SMC_B))}
    print(f"[smc] batched kernel parity and timing: "
          f"{time.perf_counter() - t0:.1f} s")
    return ({"max_abs_err": max(v[0] for v in parity.values()),
             "loss_rel_err": max(v[1] for v in parity.values())}, timing)


def _smc_data(torch, cfg, seed, device):
    """bench.py's `_sim` draw (a), (b), or tests/test_fit_mcmc.py's fixture
    (the check), preprocessed for the fused kernels."""
    import numpy as np

    from velocycle_tpu_torch import (
        Cycle, Phases, preprocess_for_phase_estimation, simulate_data,
    )

    if cfg is SMC_CHECK:
        adata = simulate_data(Nc=cfg["Nc"], Ng=cfg["Ng"], seed=cfg["sim_seed"])
        rng = np.random.default_rng(0)
        nu = adata.uns["simulated_nu"]
        cycle = Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                                 np.full((3, cfg["Ng"]), 0.5),
                                 list(adata.var.index))
        phases = Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                    list(adata.obs.index))
    else:
        adata, cycle, phases = _mcmc_sim(torch, cfg, seed)
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=True, device=device)
    check(mp.data.S.dtype == torch.int16, "[smc]: counts not int16")
    return mp


def _kernel_name(data, grad=True):
    """The launch-count key of the fused kernel that ``data`` (a PhaseData
    or VelocityData, or a host template of one) runs on: ``phase_fwd``,
    ``velo_fwdgrad``, ..., with ``_wide`` where `kernel_width` routes its
    basis and batch columns past the narrow bodies."""
    from velocycle_tpu_torch.models.metapars import VelocityData
    from velocycle_tpu_torch.ops import nb_kernels as K_

    velo = isinstance(data, VelocityData)
    layout = K_.velo_layout() if velo else K_.phase_layout()
    width, _ = K_.kernel_width(data.mu_nu.shape[1],
                               data.Nb if data.with_delta_nu else 0,
                               layout.max_nb)
    return K_._counted(("velo" if velo else "phase")
                       + ("_fwdgrad" if grad else "_fwd"), width)


def smc_run(torch, seed, card, tag, cfg, mp, svi_steps, max_stages,
            target_ess, run_seed, device="cuda", mesh=None):
    """One SMCFitModel run on ``mp`` (phases conditioned), its launches
    counted under the kernels its data routes to (`_kernel_name`): exactly
    one chain-batched loss-only launch per stage (its log-likelihood or log
    ratio over the particles), one chain-batched fwd+grad launch per
    batched potential evaluation (1 + num_moves x leapfrog per stage) and,
    in prior tempering, one single loss-only launch in all (the prior draws
    compute no likelihood).  With ``mesh`` (a
    ("particles",) mesh) the launches are of this rank's share of the
    particles.  Returns its numbers and the fit."""
    import numpy as np

    from velocycle_tpu_torch import SMCFitModel
    from velocycle_tpu_torch.infer import smc as TS
    from velocycle_tpu_torch.ops import nb_kernels as K_

    moves = cfg["num_moves"]
    fm = SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                     num_particles=cfg["chains"], num_moves=moves,
                     target_ess=target_ess, max_stages=max_stages,
                     svi_steps=svi_steps)
    n = _local_count(cfg["chains"], mesh, "particles")
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    with _EvalCounter(TS) as counter:
        t0 = time.perf_counter()
        fm.run(run_seed, mesh=mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sched = fm.temperature_schedule
    stages = len(sched)
    fwd, grad = _kernel_name(mp.data, grad=False), _kernel_name(mp.data)
    fwd_k = dict(K_.LAUNCH_CHAINS[fwd])
    grad_k = dict(K_.LAUNCH_CHAINS[grad])
    per_stage = 1 + moves * SMC_LEAPFROG
    print(f"[smc] {tag}: {stages} stages, beta {', '.join(f'{b:.4g}' for b in sched)}; "
          f"logZ {fm.log_evidence:.3f}; {fwd} launches by chain "
          f"count {fwd_k}, {grad} {grad_k}, {counter.calls} "
          f"batched "
          f"potential evaluations; wall {dt:.2f} s, "
          f"{n * stages * moves / dt:.1f} particle-moves/s, peak device "
          f"memory {peak / 2**30:.3f} GiB on {card}")
    check(fwd_k.get(n, 0) == stages,
          f"{tag}: {fwd_k.get(n, 0)} {fwd} launches of {n} chains for "
          f"{stages} stages")
    check(grad_k.get(n, 0) == counter.calls == stages * per_stage,
          f"{tag}: {grad_k.get(n, 0)} {grad} launches of {n} chains "
          f"for {counter.calls} batched evaluations ({per_stage} per stage)")
    check(set(fwd_k) <= {1, n} and set(grad_k) <= {1, n},
          f"{tag}: launches by chain count {fwd_k}, {grad_k}")
    # prior tempering: the one single launch is init_model's first trace;
    # the prior draws stop short of the likelihood
    check(svi_steps or fwd_k.get(1, 0) == 1,
          f"{tag}: {fwd_k.get(1, 0)} single {fwd} launches, not 1")
    check(sched[-1] == 1.0 and bool((np.diff(sched) > 0).all()),
          f"{tag}: temperature schedule {sched}")
    check(np.isfinite(fm.log_evidence), f"{tag}: log evidence {fm.log_evidence}")
    check(all(np.isfinite(v).all() for v in fm.posterior.values()),
          f"{tag}: non-finite posterior")
    return fm, {"stages": stages, "log_evidence": fm.log_evidence,
                "wall_s": dt, "particle_moves_per_s": n * stages * moves / dt,
                "evals": counter.calls,
                "launches": {fwd: fwd_k, grad: grad_k},
                "peak_gib": peak / 2**30}


def _smc_host_and_device(torch, fm, tag, card):
    """Host ms of one batched value-and-gradient of the tempered potential
    (beta = 1) at the final particles, and a device profile over one stage
    (from beta = 0.5) on them."""
    from velocycle_tpu_torch.infer import mcmc as TM

    smc = fm.smc
    q = smc.particles
    vg = TM._batched_value_and_grad(smc.potential_at(1.0))
    vg(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        vg(q)
    torch.cuda.synchronize()
    ev = (time.perf_counter() - t0) / 20 * 1e3
    rng = TM._ChainRNG(range(q.shape[0]), q.device)
    gen = torch.Generator().manual_seed(0)
    busy = _device_profile(torch, lambda: smc.stage(q, 0.5, rng, gen), "smc",
                           1, "stage")
    print(f"[smc] {tag}: {ev:.2f} ms of host clock per batched potential "
          f"evaluation on {card}")
    return {"eval_ms": ev, "busy": busy}


def phase_smc(torch, seed, card, device="cuda"):
    """[smc]: (a) `smc`, prior tempering at 20 x 200 (target_ess 0.35); (b)
    `smc_bridged`, the variational bridge at 50 x 500 after an 800-step SVI
    warm start; then at 16 x 60 the bridge against prior tempering: logZ
    within 2 nats and posterior-mean nu within 0.2 (tests/test_fit_mcmc.py
    `test_bridged_smc_matches_prior_tempering_logz`).  (b) takes fewer
    stages than (a)."""
    import numpy as np

    out = {}
    for tag, cfg in (("a", SMC_A), ("b", SMC_B)):
        t0 = time.perf_counter()
        mp = _smc_data(torch, cfg, seed, device)
        name = "smc" if tag == "a" else "smc_bridged"
        fm, res = smc_run(torch, seed, card, f"({tag}) {name}", cfg, mp,
                          cfg["svi_steps"], cfg["max_stages"],
                          cfg["target_ess"], seed + 3, device)
        res.update(_smc_host_and_device(torch, fm, f"({tag})", card))
        print(f"[smc] ({tag}) in all, data included: "
              f"{time.perf_counter() - t0:.1f} s")
        out[tag] = res
        torch.cuda.empty_cache()
    check(out["b"]["stages"] < out["a"]["stages"],
          f"[smc]: the bridge took {out['b']['stages']} stages, prior "
          f"tempering {out['a']['stages']}")
    out["c"] = smc_velocity(torch, seed, card, device)
    t0 = time.perf_counter()
    mp = _smc_data(torch, SMC_CHECK, seed, device)
    prior, rp = smc_run(torch, seed, card, "(check) prior", SMC_CHECK, mp, 0,
                        200, SMC_CHECK["target_ess"], 1, device)
    bridged, rb = smc_run(torch, seed, card, "(check) bridged", SMC_CHECK, mp,
                          800, 60, SMC_CHECK["target_ess"], 2, device)
    dz = rb["log_evidence"] - rp["log_evidence"]
    dnu = float(np.abs(bridged.posterior["nu"].mean(0)
                       - prior.posterior["nu"].mean(0)).max())
    print(f"[smc] (check) {SMC_CHECK['Ng']}x{SMC_CHECK['Nc']}: bridged - prior "
          f"logZ {dz:.3f} nats (gate 2), posterior-mean nu max diff {dnu:.4f} "
          f"(gate 0.2), stages {rb['stages']} vs {rp['stages']}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(abs(dz) < 2.0, f"[smc] check: logZ differ by {dz}")
    check(dnu < 0.2, f"[smc] check: nu means differ by {dnu}")
    check(rb["stages"] < rp["stages"], "[smc] check: the bridge took more stages")
    out["check"] = {"dlogZ": dz, "dnu": dnu, "prior": rp, "bridged": rb}
    return out


def smc_velocity(torch, seed, card, device="cuda"):
    """[smc] (c): velocity prior tempering on fused int16 counts, 20 x 200,
    256 particles, the phases conditioned and shape_inv free (velo_fwdgrad
    with the dispersion gradient), max_stages 60: one K = 256 velo_fwd per
    stage, one K = 256 velo_fwdgrad per batched evaluation."""
    t0 = time.perf_counter()
    cfg = VELO_SMC
    _, mp = _velo_sim(torch, cfg, seed, device)
    check(mp.data.disp_grad, "(c): the dispersion gradient off")
    fm, res = smc_run(torch, seed, card, "(c) velocity smc", cfg, mp,
                      cfg["svi_steps"], cfg["max_stages"], cfg["target_ess"],
                      seed + 5, device)
    res.update(_smc_host_and_device(torch, fm, "(c)", card))
    print(f"[smc] (c) in all, data included: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return res


def smc_row(parity, timing, runs):
    """phase_fwd's row additions from [smc] (row 1'' of PERF.md)."""
    launches = {}
    for r in (runs["a"], runs["b"], runs["check"]["prior"],
              runs["check"]["bridged"]):
        _add_launches(launches, r["launches"]["phase_fwd"])
    return {"smc_launches_by_chains": launches,
            "batched_parity": parity, "batched_timing": timing,
            "smc_runs": {k: _strip(runs[k]) for k in ("a", "b")},
            "smc_check": {k: runs["check"][k] for k in ("dlogZ", "dnu")}}


# ---------------------------------------------------------------------------
# [velo2d]: the 2-D extension (twodim), no kernel of its own
# ---------------------------------------------------------------------------

# (a) run_simulations' defaults (the reference's run_simulations.py): 1,000
# cells x 200 genes, 1,000 steps per stage, seeds 0 and 1
VELO2D_A = dict(n_cells=1000, n_genes=200, steps=1000, seeds=(0, 1))
# (b) the Stereo-seq-class width: (a)'s seed-0 genes tiled to NG, NC cells
VELO2D_B = dict(Ng=NG, Nc=NC, steps=200)
VELO2D_GATES = {"ElogS": 0.9, "ElogU": 0.6, "log_beta": 0.4}  # tests/test_twodim.py


def _no_nb_launch(tag):
    """The 2-D path reaches none of the fused NB kernels (the JAX 2-D
    models reach no Pallas kernel): all launch counts still 0."""
    from velocycle_tpu_torch.ops import nb_kernels as K_

    check(not any(K_.LAUNCHES.values()),
          f"[velo2d] {tag} launched an NB kernel: {K_.LAUNCHES}")


def _falls(losses, tag):
    import numpy as np

    check(np.isfinite(losses).all(), f"[velo2d] {tag}: non-finite losses")
    check(losses[-10:].mean() < losses[0],
          f"[velo2d] {tag}: losses did not fall ({losses[0]} -> "
          f"{losses[-10:].mean()})")


def velo2d_published(torch, card, cfg=VELO2D_A, device="cuda"):
    """(a): run_simulations' loop (simulate -> prepare_data -> train_velo2d
    -> evaluate_fit) at its defaults for each seed, gated as
    tests/test_twodim.py.  Returns ({seed: numbers}, seed 0's AnnData)."""
    from velocycle_tpu_torch.ops import nb_kernels as K_
    from velocycle_tpu_torch.twodim import (
        evaluate_fit, generate_adata, prepare_data, train_velo2d,
    )

    out, first = {}, None
    for seed in cfg["seeds"]:
        t0 = time.perf_counter()
        adata = generate_adata(n_cells=cfg["n_cells"], n_genes=cfg["n_genes"],
                               seed=seed)
        t_sim = time.perf_counter() - t0
        pd = prepare_data(adata, device=device)
        check(pd.S.device.type == device and pd.S.dtype == torch.float32,
              "[velo2d] (a): counts not float32 on the card")
        K_.reset_launch_counts()
        t0 = time.perf_counter()
        results, ls, lu = train_velo2d(pd, n_steps_s=cfg["steps"],
                                       n_steps_u=cfg["steps"], key=seed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _no_nb_launch("(a)")
        corrs = evaluate_fit(adata, results)
        print(f"[velo2d] (a) seed {seed}, {cfg['n_cells']} cells x "
              f"{cfg['n_genes']} genes: simulate {t_sim:.2f} s (host), fit "
              f"{2 * cfg['steps']} steps {dt:.2f} s "
              f"({2 * cfg['steps'] / dt:.1f} steps/s) on {card}; stage S "
              f"loss {ls[0]:.6g} -> {ls[-1]:.6g}, stage U {lu[0]:.6g} -> "
              f"{lu[-1]:.6g}")
        print(f"[velo2d] (a) seed {seed} correlations: "
              + ", ".join(f"{k} {v:.4f}" for k, v in corrs.items()))
        _falls(ls, f"(a) seed {seed} stage S")
        _falls(lu, f"(a) seed {seed} stage U")
        for k, gate in VELO2D_GATES.items():
            check(corrs[k] > gate,
                  f"[velo2d] (a) seed {seed}: corr {k} {corrs[k]:.4f} <= {gate}")
        out[seed] = {"fit_s": dt, "corrs": corrs,
                     "loss_s": [float(ls[0]), float(ls[-1])],
                     "loss_u": [float(lu[0]), float(lu[-1])]}
        first = adata if first is None else first
        del pd, results
        torch.cuda.empty_cache()
    return out, first


def _velo2d_width_data(torch, seed, adata0, cfg, device):
    """(b)'s data: ``adata0``'s accepted genes tiled to Ng, Nc cells placed
    by the port's `_branching_positions` from ``seed`` with their designs,
    ElogS and ElogU formed on the card and S, U drawn there from a seeded
    generator as float32.  Returns (Velo2DData, truth dict on the card)."""
    import numpy as np

    from velocycle_tpu_torch.twodim import Velo2DData, make_designs
    from velocycle_tpu_torch.twodim.simulate import _branching_positions

    Ng, Nc = cfg["Ng"], cfg["Nc"]
    lo, hi = adata0.uns["phi_lower"], adata0.uns["phi_upper"]
    rng = np.random.default_rng(seed)
    # generate_adata's defaults: branch at x = 5, trunk at y = 5, position
    # noise sd 0.2-0.6
    phi, _ = _branching_positions(Nc, lo, hi, 5.0, 5.0, 0.2, 0.6, rng)
    design_s, design_dx, design_dy, design_omega = (
        torch.as_tensor(np.ascontiguousarray(d, np.float32), device=device)
        for d in make_designs(phi, lo, hi))
    idx = np.arange(Ng) % adata0.n_vars

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    w_s = put(adata0.uns["w_s"][idx])
    log_beta = put(adata0.var["log_beta"].values[idx])
    log_gamma = put(adata0.var["log_gamma"].values[idx])
    w_omega = put(adata0.uns["w_omega"])
    with torch.no_grad():
        ElogS = w_s @ design_s
        omega = w_omega @ design_omega
        inner = ((w_s @ design_dx) * omega[0] + (w_s @ design_dy) * omega[1]
                 + torch.exp(log_gamma)[:, None])
        ElogU = (-log_beta[:, None] + ElogS
                 + torch.log(torch.clamp(inner, min=0.0) + 1e-5))
        del inner
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        S = torch.poisson(torch.exp(ElogS), generator=gen)
        U = torch.poisson(torch.exp(ElogU), generator=gen)
    pd = Velo2DData(
        design_s=design_s, design_dx=design_dx, design_dy=design_dy,
        design_omega=design_omega, S=S, U=U,
        w_s=torch.zeros((Ng, design_s.shape[0]), device=device),
        ElogS=torch.zeros_like(S), Ng=Ng, Nc=Nc,
        n_coef_s=design_s.shape[0], n_coef_omega=design_omega.shape[0])
    truth = {"ElogS": ElogS, "ElogU": ElogU, "omega": omega,
             "log_beta": log_beta, "log_gamma": log_gamma}
    return pd, truth


def _corr(torch, a, b):
    """Pearson correlation of the tensor ``a`` and the same-size array
    ``b``, in float64 on ``a``'s device."""
    a = a.double().flatten()
    b = torch.as_tensor(b, device=a.device).double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def _velo2d_stage_rates(torch, pd, results, seed):
    """Each stage's steady state (`_steady_state`: steps/s, then launches
    per step and busy share under the profiler) and its peak device
    memory, on (b)'s data with `train_velo2d`'s SVI; stage U on the fitted
    w_s and ElogS."""
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, adam
    from velocycle_tpu_torch.infer.autoguide import AutoNormal
    from velocycle_tpu_torch.twodim import velo2d_s_model, velo2d_u_model

    w_s = torch.as_tensor(results["w_s"], device=pd.device)
    with torch.no_grad():
        pd_u = pd.replace(w_s=w_s, ElogS=w_s @ pd.design_s)
    out = {}
    for stage, model, data in (("S", velo2d_s_model, pd),
                               ("U", velo2d_u_model, pd_u)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        svi = SVI(model, AutoNormal(model), adam(1e-2), Trace_ELBO())
        tag = f"velo2d {stage}"
        steps_per_s = _steady_state(torch, svi, svi.init(seed, data), data, tag)
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[{tag}] peak device memory {peak / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB resident before the stage")
        out[stage] = {"steps_per_s": steps_per_s, "peak_gib": peak / 2**30}
        del svi
    return out


def velo2d_full_width(torch, seed, card, adata0, cfg=VELO2D_B, device="cuda"):
    """(b): `train_velo2d` at Ng x Nc on data built on the card from
    ``adata0``'s genes; gated on finite, falling losses."""
    import numpy as np

    from velocycle_tpu_torch.ops import nb_kernels as K_
    from velocycle_tpu_torch.twodim import train_velo2d

    t0 = time.perf_counter()
    pd, truth = _velo2d_width_data(torch, seed, adata0, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[velo2d] (b) data at {cfg['Ng']} genes x {cfg['Nc']} cells "
          f"({pd.n_coef_s} expression, {pd.n_coef_omega} velocity "
          f"coefficients): built in {build_s:.2f} s (host clock)")
    K_.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    results, ls, lu = train_velo2d(pd, n_steps_s=cfg["steps"],
                                   n_steps_u=cfg["steps"], key=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    _no_nb_launch("(b)")
    print(f"[velo2d] (b) train_velo2d, {cfg['steps']} + {cfg['steps']} "
          f"steps: {fit_s:.2f} s on {card}; stage S loss {ls[0]:.6g} -> "
          f"{ls[-1]:.6g}, stage U {lu[0]:.6g} -> {lu[-1]:.6g}; peak "
          f"{peak / 2**30:.3f} GiB above {base / 2**30:.3f} GiB resident")
    _falls(ls, "(b) stage S")
    _falls(lu, "(b) stage U")
    corrs = {
        "omega_x": _corr(torch, truth["omega"][0], results["omega"][0]),
        "omega_y": _corr(torch, truth["omega"][1], results["omega"][1]),
        "ElogS": _corr(torch, truth["ElogS"], results["ElogS"]),
        "ElogU": _corr(torch, truth["ElogU"], results["ElogU"]),
        "log_beta": _corr(torch, truth["log_beta"], results["log_beta"]),
        "log_gamma": _corr(torch, truth["log_gamma"], results["log_gamma"]),
        "gamma_beta_ratio": _corr(
            torch, torch.exp(truth["log_gamma"] - truth["log_beta"]),
            np.exp(results["log_gamma"] - results["log_beta"])),
    }
    print("[velo2d] (b) correlations with the tiled truth: "
          + ", ".join(f"{k} {v:.4f}" for k, v in corrs.items()))
    del truth
    rates = _velo2d_stage_rates(torch, pd, results, seed)
    del pd, results
    torch.cuda.empty_cache()
    return {"build_s": build_s, "fit_s": fit_s, "fit_peak_gib": peak / 2**30,
            "loss_s": [float(ls[0]), float(ls[-1])],
            "loss_u": [float(lu[0]), float(lu[-1])], "corrs": corrs,
            "stages": rates}


def phase_velo2d(torch, seed, card, a=VELO2D_A, b=VELO2D_B, device="cuda"):
    """[velo2d]: (a) the reference's published run, then (b) the
    full-width fit on (a)'s seed-0 genes."""
    t0 = time.perf_counter()
    published, adata0 = velo2d_published(torch, card, a, device)
    full = velo2d_full_width(torch, seed, card, adata0, b, device)
    print(f"[velo2d] in all: {time.perf_counter() - t0:.1f} s")
    return {"a": published, "b": full}


def profile_steps(torch, svi, state, data, tag, n=5):
    """Device time by kernel over a few SVI steps (`_device_profile`)."""
    _device_profile(torch, lambda: svi.update_chunk(state, n, data)[1].cpu(),
                    tag, n, "step")


def kernel_digest(torch, seed, narrow=True, wide=False):
    """sha256 of phase_fwdgrad's, phase_fwd's, velo_fwdgrad's and
    velo_fwd's outputs on the main path's full-width inputs (the
    dispersion gradient on) and, with ``wide`` (``--digest``, ``--wide``),
    of the four wide kernels' at 21 columns (Nh 5 + WIDE_BATCHES batches),
    each wide one computed twice and the two required bit-identical: equal
    digests from two checkouts mean bit-identical results.  Uses only the
    public kernel functions, whose signatures every version of the port
    shares.  Each kernel's combined line is followed by one line per
    output (the loss, then each gradient in the wrapper's order), so that
    a change shows which output it moved."""
    import hashlib

    from velocycle_tpu_torch.ops import nb_kernels as K

    def flat(out):
        loss, grads = out if isinstance(out, tuple) else (out, ())
        return [loss, *(g for g in grads if g is not None)]

    names = {"phase_fwdgrad": ("loss", "dnu", "dzeta", "dcf", "ddisp",
                               "ddelta_nu"),
             "velo_fwdgrad": ("loss", "dnu", "dzeta", "dzeta_dphi", "dcf",
                              "domega", "dlog_beta", "dlog_gamma", "ddisp",
                              "ddelta_nu")}

    def sha(t):
        return hashlib.sha256(
            t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()

    for Nb, tag in [(0, "")] * narrow + [(WIDE_BATCHES, "_wide")] * wide:
        S, nu, zeta, cf, r, dnu, Db = make_inputs(torch, NG, NC, seed, Nb=Nb)
        a = (S, nu, zeta, cf, r, dnu, Db, lgamma_k_sum(torch, S))
        # the genes whose y = a + 2 rounds in float32 (ops.special.y_shift,
        # written out: an older package has none); the velocity inputs
        # share r
        inv = 1.0 / r
        rounded = ((inv + 2.0) - torch.clamp(inv, min=2.0)
                   - torch.clamp(inv, max=2.0)) != 0.0
        calls = {"phase_fwdgrad": lambda: K.phase_fwdgrad(*a, want_disp=True),
                 "phase_fwd": lambda: K.phase_fwd(*a)}
        outs = {}
        for name, fn in calls.items():
            outs[name] = flat(fn())
        del S, nu, zeta, cf, r, dnu, Db
        v = make_velo_inputs(torch, NG, NC, seed, Nb=Nb)
        va = (*v, lgamma_k_sum(torch, *v[:2]))
        vcalls = {"velo_fwdgrad": lambda: K.velo_fwdgrad(*va, want_disp=True),
                  "velo_fwd": lambda: K.velo_fwd(*va)}
        for name, fn in vcalls.items():
            outs[name] = flat(fn())
        for name, tensors in outs.items():
            if tag:
                again = flat({**calls, **vcalls}[name]())
                check(all(torch.equal(x, y) for x, y in zip(tensors, again)),
                      f"{name}{tag}: a repeat differs in its bits")
            h = hashlib.sha256()
            for t in tensors:
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
            what = ("loss and gradients, disp_grad on" if len(tensors) > 1
                    else "loss")
            cols = f", {NH + Nb} columns, repeat bit-identical" if tag else ""
            print(f"[digest] {name}{tag} @ {NG}x{NC} int16 ({what}{cols}): "
                  f"sha256 {h.hexdigest()}")
            outs_named = [n for n in names.get(name, ("loss",))
                          if n != "ddelta_nu" or Nb]
            for out, t in zip(outs_named, tensors):
                print(f"[digest]   {name}{tag} {out}: sha256 {sha(t)}")
                if out == "ddisp":
                    for m, what in ((~rounded, "y exact"),
                                    (rounded, "y rounded")):
                        print(f"[digest]   {name}{tag} ddisp, {what} "
                              f"({int(m.sum())} genes): sha256 {sha(t[m])}")
        del v, va, a, outs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [wide]: the wide body (csrc/wide_kernel.cuh through csrc/nb_wide.cu) past
# the narrow bodies' 16 basis columns
# ---------------------------------------------------------------------------

WIDE_BATCHES = 16       # (a): 16 batches of NC / 16 = 6,400 cells: 21 columns
WIDE_STEPS = 50
# (b): (tag, Nh, Nb, Ng, Nc, int16 counts, lgamma_k_sum given); the
# Nh-alone widths are a spline basis' of n_basis 16, 20 and 32 (Fourier
# columns here: the kernel's arithmetic does not depend on the basis)
WIDE_CASES = [
    ("W17 Nh17", 17, 0, 257, 3001, True, True),
    ("W17 Nh5+Nb12 f32", 5, 12, 257, 3001, False, False),
    ("W21 Nh21 full", 21, 0, NG, NC, True, True),
    ("W21 Nh5+Nb16 full", 5, 16, NG, NC, True, True),
    ("W33 Nh33 129x3001", 33, 0, 129, 3001, True, True),
    ("W64 Nh5+Nb59 full", 5, 59, NG, NC, True, True),
    ("W130 Nh130 full", 130, 0, NG, NC, True, True),
    ("W256 Nh200+Nb56 129x1001 f32", 200, 56, 129, 1001, False, True),
    ("W257 Nh5+Nb252 257x3001", 5, 252, 257, 3001, True, True),
]
# per stage, the case that also takes its count-ring variant: the phase
# stage's a misaligned view, the velocity stage's mixed count types and a
# gated share below the relu
WIDE_PHASE_EXTRA = {"W33 Nh33 129x3001": {"view": True}}
WIDE_VELO_EXTRA = {"W33 Nh33 129x3001": {"u_int16": False},
                   "W17 Nh5+Nb12 f32": {"u_int16": True, "gated": True}}
WIDE_RECORD = "W21 Nh5+Nb16 full"   # (a)'s shape: the kernels line's error
WIDE_TIMED = {21: (5, 16), 64: (5, 59)}   # width: (Nh, Nb), full width
WIDE_SWEPT = {257: (5, 252)}   # --wide: past both pairs' shared-memory fit
WIDE_CHAIN = dict(Ng=50, Nc=2000, chains=64, nh=21)
# the chain axis past both pairs' shared-memory fit (several sweeps)
WIDE_CHAIN_SWEPT = dict(Ng=40, Nc=300, chains=4, nh=257)
WIDE_EVERY = range(17, 321)     # (b): every width through the route
WIDE_PLANNED = (17, 21, 64, 73, 130, 153, 257, 320)   # [build]'s plans by width
WIDE_KERNELS = ("phase_fwd_wide", "phase_fwdgrad_wide", "velo_fwd_wide",
                "velo_fwdgrad_wide")


def wide_parity(torch, seed):
    """[wide] (b): the four wide kernels, through the routed wrappers at
    shapes past 16 columns, against their plain versions (the wide twins)
    at WIDE_CASES, both stages, the dispersion gradient both ways; every
    width of WIDE_EVERY through phase_fwdgrad and velo_fwdgrad at 24 x 300,
    one wide launch each; the chain-batched pair at K = 64 (21 columns) and
    K = 4 (257).
    Returns ({kernel: [max abs error, loss rel error]} at WIDE_RECORD,
    {kernel: chain parity})."""
    from velocycle_tpu_torch.ops import nb_kernels as K

    t0 = time.perf_counter()
    pc = [(t + (" misaligned view" if t in WIDE_PHASE_EXTRA else ""), Ng, Nc,
           Nb, i16, sk, {"nh": nh, **WIDE_PHASE_EXTRA.get(t, {})})
          for t, nh, Nb, Ng, Nc, i16, sk in WIDE_CASES]
    vc = [(t, Ng, Nc, Nb, i16, sk, {"nh": nh, **WIDE_VELO_EXTRA.get(t, {})})
          for t, nh, Nb, Ng, Nc, i16, sk in WIDE_CASES]
    K.reset_launch_counts()
    res, ok = _parity_cases(
        torch, seed, make_inputs, 1, K.phase_fwdgrad,
        K.phase_fwdgrad_wide_plain, K.phase_fwd, K.phase_fwd_wide_plain,
        PHASE_GRADS, GRAD_RTOL, pc, record=WIDE_RECORD)
    vres, vok = _parity_cases(
        torch, seed, make_velo_inputs, 2, K.velo_fwdgrad,
        K.velo_fwdgrad_wide_plain, K.velo_fwd, K.velo_fwd_wide_plain,
        VELO_GRADS, VELO_GRAD_RTOL, vc, record=WIDE_RECORD)
    check(ok and vok, "a wide kernel disagrees with its plain version (see "
          "[parity] lines)")
    # every case is past 16 columns: the wide body and nothing else ran
    launched = {k for k, v in K.LAUNCHES.items() if v}
    check(launched == set(WIDE_KERNELS),
          f"the wide cases launched {K.LAUNCHES}")
    # every width through the route: none raises
    K.reset_launch_counts()
    worst = 0.0
    widths = WIDE_EVERY
    for W in widths:
        S, nu, zeta, cf, r, _, _ = make_inputs(torch, 24, 300, seed + W, nh=W)
        kl = K.phase_fwdgrad(S, nu, zeta, cf, r)[0]
        pl = K.phase_fwdgrad_wide_plain(S, nu, zeta, cf, r)[0]
        a = make_velo_inputs(torch, 24, 300, seed + W, nh=W)[:10]
        vkl = K.velo_fwdgrad(*a, want_disp=False)[0]
        vpl = K.velo_fwdgrad_wide_plain(*a, want_disp=False)[0]
        for k_, p_ in ((kl, pl), (vkl, vpl)):
            worst = max(worst, abs(float(k_) - float(p_)) / max(abs(float(p_)), 1.0))
    n = len(widths)
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"[wide] every width {widths.start}..{widths.stop - 1} at 24x300 "
          f"through phase_fwdgrad / velo_fwdgrad: launches {launches}, loss "
          f"rel against the wide twins at most {worst:.2e}")
    check(launches == {"phase_fwdgrad_wide": n, "velo_fwdgrad_wide": n},
          f"the route past {K.NARROW_WIDTH} columns launched {launches}")
    check(worst < LOSS_RTOL, f"a routed width's loss is off by {worst:.2e}")
    # the chain axis at 21 columns: one launch of K = 64 against the plain
    # version over the chains and 64 single launches
    chains = {}
    for c in (WIDE_CHAIN, WIDE_CHAIN_SWEPT):
        for kind in ("phase", "velo"):
            for mode, wd in (("fwdgrad", kind == "phase"), ("fwd", False)):
                err = _batched_parity_case(
                    torch, f"{c['Ng']}x{c['Nc']} K={c['chains']} W{c['nh']}",
                    c["Ng"], c["Nc"], c["chains"], ("nu", "r"), seed,
                    want_disp=wd, nh=c["nh"], mode=mode, kind=kind, wide=True)
                if c is WIDE_CHAIN:
                    chains[f"{kind}_{mode}_wide"] = err
    torch.cuda.empty_cache()
    print(f"[wide] (b) parity in {time.perf_counter() - t0:.1f} s")
    return {f"{k}_wide": v for k, v in {**res, **vres}.items()}, chains


def _wide_ops(kind, mode, Nh, Nb, N, lg, dg, wd):
    """FP32 operations the function of a wide kernel call needs over N
    elements at Nh basis columns and Nb delta_nu batches: OPS / OPS_VELO at
    Nh = 5, OPS_PER_COLUMN for each further basis column and
    OPS_PER_BATCH for each batch (the ElogS offset and its ddelta_nu sum
    alone, however the body computes them), the lgamma ratio's ``lg`` and,
    with the dispersion gradient, ``dg``."""
    extra = Nh - NH
    grad = mode == "fwdgrad"
    batches = Nb * (OPS_PER_BATCH["common"]
                    + (OPS_PER_BATCH["fwdgrad"] if grad else 0))
    if kind == "phase":
        per = OPS["common"] + extra * OPS_PER_COLUMN["common"] + (
            OPS["fwdgrad"] - (0 if wd else OPS_DISP)
            + extra * OPS_PER_COLUMN["fwdgrad"] if grad else OPS["fwd"])
    else:
        per = OPS_VELO["common"] + extra * OPS_PER_COLUMN["velo_common"] + (
            OPS_VELO["fwdgrad"] + (OPS_VELO["disp"] if wd else 0)
            + extra * OPS_PER_COLUMN["velo_fwdgrad"] if grad
            else OPS_VELO["fwd"])
    return (per + batches) * N + lg + (dg if grad and wd else 0)


def wide_timing(torch, seed, card, timed=WIDE_TIMED, full=True):
    """[wide] (c): each wide kernel at 21 and 64 columns (Nh 5 with 16 and
    59 batches) at full width, int16 counts, beside its plain version and
    its bound, as (a) runs it (the phase pair with the dispersion
    gradient, the velocity pair without); the fwd+grad kernels at 21
    columns on float32 counts (kernel only); the chain-batched fwd+grad
    pair at K = 64 against 64 single launches.  ``full=False``: the
    fwd+grad kernels alone at ``timed``'s widths (``--wide``'s 257
    columns).  Returns {kernel: {"w21": .., "w64": .., ...}}."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    t0 = time.perf_counter()
    out = {k: {} for k in WIDE_KERNELS}
    for W, (nh, nb) in timed.items():
        S, nu, zeta, cf, r, dnu, Db = make_inputs(torch, NG, NC, seed, Nb=nb,
                                                  nh=nh)
        lgk = lgamma_k_sum(torch, S)
        N = S.numel()
        lg, share = _ratio_ops(torch, [S])
        dg = _disp_ops(torch, "phase", [S], [nu, zeta, cf, r], dnu, Db)
        ins = [nu, zeta, cf, r, dnu]
        pbytes = 4 * sum(t.numel() for t in ins)
        in_bytes = S.numel() * S.element_size() + pbytes + 4 * Db.numel()
        note = f"{share:.3f} of counts >= 2, {W} columns"
        a = (S, nu, zeta, cf, r, dnu, Db, lgk)
        out["phase_fwdgrad_wide"][f"w{W}"] = _time_pair(
            torch, f"phase_fwdgrad_wide at {W} columns",
            lambda: K.phase_fwdgrad(*a, want_disp=True),
            lambda: K.phase_fwdgrad_wide_plain(*a, want_disp=True),
            in_bytes + pbytes + 4,
            _wide_ops("phase", "fwdgrad", nh, nb, N, lg, dg, True), card, note)
        if full:
            out["phase_fwd_wide"][f"w{W}"] = _time_pair(
                torch, f"phase_fwd_wide at {W} columns",
                lambda: K.phase_fwd(*a), lambda: K.phase_fwd_wide_plain(*a),
                in_bytes + 4,
                _wide_ops("phase", "fwd", nh, nb, N, lg, dg, False), card,
                note)
        if full and W == 21:
            Sf = S.float()
            af = (Sf, *a[1:])
            med = _median_reps(TP, {"f32": lambda: K.phase_fwdgrad(
                *af, want_disp=True)})["f32"]
            out["phase_fwdgrad_wide"]["f32_ms"] = med[0]
            print(f"[timing] phase_fwdgrad_wide at 21 columns, float32 "
                  f"counts: kernel median {med[0]:.4f} ms of "
                  f"{_reps_note(med[1])}")
            del Sf, af
        del S, nu, zeta, cf, r, dnu, Db, a, ins
        torch.cuda.empty_cache()
        v = make_velo_inputs(torch, NG, NC, seed, Nb=nb, nh=nh)
        S, U = v[:2]
        lgk = lgamma_k_sum(torch, S, U)
        lg, share = _ratio_ops(torch, [S, U])
        pbytes = 4 * sum(t.numel() for t in v[2:11])
        in_bytes = 2 * S.numel() * S.element_size() + pbytes + 4 * v[11].numel()
        note = f"{share:.3f} of S and U counts >= 2, {W} columns"
        a = (*v, lgk)
        out["velo_fwdgrad_wide"][f"w{W}"] = _time_pair(
            torch, f"velo_fwdgrad_wide at {W} columns",
            lambda: K.velo_fwdgrad(*a, want_disp=False),
            lambda: K.velo_fwdgrad_wide_plain(*a, want_disp=False),
            in_bytes + pbytes + 4,
            _wide_ops("velo", "fwdgrad", nh, nb, S.numel(), lg, 0,
                      False), card,
            note)
        if full:
            out["velo_fwd_wide"][f"w{W}"] = _time_pair(
                torch, f"velo_fwd_wide at {W} columns",
                lambda: K.velo_fwd(*a), lambda: K.velo_fwd_wide_plain(*a),
                in_bytes + 4,
                _wide_ops("velo", "fwd", nh, nb, S.numel(), lg, 0, False),
                card, note)
        if full and W == 21:
            af = (S.float(), U.float(), *a[2:])
            med = _median_reps(TP, {"f32": lambda: K.velo_fwdgrad(
                *af, want_disp=False)})["f32"]
            out["velo_fwdgrad_wide"]["f32_ms"] = med[0]
            print(f"[timing] velo_fwdgrad_wide at 21 columns, float32 S and "
                  f"U: kernel median {med[0]:.4f} ms of {_reps_note(med[1])}")
            del af
        del v, S, U, a
        torch.cuda.empty_cache()
    if full:
        out["fold"] = _wide_fold_cost(torch, seed, card)
        c = WIDE_CHAIN
        for kind, wd in (("phase", True), ("velo", False)):
            out[f"{kind}_fwdgrad_wide"]["chains"] = _batched_timing(
                torch, seed, card, c, ("nu", "r"), "fwdgrad", wd=wd,
                nh=c["nh"], kind=kind, wide=True)
    for k in WIDE_KERNELS if full else WIDE_KERNELS[1::2]:
        for W in timed:
            p = K.wide_plan(k.split("_")[0], "fwdgrad" if "fwdgrad" in k
                            else "fwd", True, True, NG, NC, W,
                            want_disp=k == "phase_fwdgrad_wide")
            out[k][f"w{W}"]["plan"] = p._asdict()
            print(f"[timing] {k} plan at {W} columns: {_wide_plan_note(p)}")
    print(f"[wide] (c) timing in {time.perf_counter() - t0:.1f} s")
    return out


def fwdgrad_times(torch, seed, card):
    """``--fwdgrad-times``: phase_fwdgrad and velo_fwdgrad with the
    dispersion gradient on, narrow (Nh 5) and wide (Nh 5 + WIDE_BATCHES
    batches, 21 columns), at full width on int16 counts: each kernel's
    median ms (`_median_reps`, the four in turns) beside its bound.  Uses
    only the public kernel functions, so it times any checkout's package
    (``--package``).  Returns {kernel: (median ms, bound ms)}."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    fns, bounds = {}, {}
    for Nb, tag in ((0, ""), (WIDE_BATCHES, "_wide")):
        S, nu, zeta, cf, r, dnu, Db = make_inputs(torch, NG, NC, seed, Nb=Nb)
        a = (S, nu, zeta, cf, r, dnu, Db, lgamma_k_sum(torch, S))
        lg, _ = _ratio_ops(torch, [S])
        dg = _disp_ops(torch, "phase", [S], [nu, zeta, cf, r], dnu, Db)
        pb = 4 * sum(t.numel() for t in a[1:6] if t is not None)
        db = 4 * Db.numel() if Nb else 0
        bounds[f"phase_fwdgrad{tag}"] = TP.bound_ms(
            S.numel() * S.element_size() + 2 * pb + db + 4,
            _wide_ops("phase", "fwdgrad", NH, Nb, S.numel(), lg, dg, True))[0]
        fns[f"phase_fwdgrad{tag}"] = functools.partial(
            K.phase_fwdgrad, *a, want_disp=True)
        v = make_velo_inputs(torch, NG, NC, seed, Nb=Nb)
        va = (*v, lgamma_k_sum(torch, *v[:2]))
        lg, _ = _ratio_ops(torch, list(v[:2]))
        dg = _disp_ops(torch, "velo", list(v[:2]), list(v[2:10]), v[10],
                       v[11])
        pb = 4 * sum(t.numel() for t in v[2:11] if t is not None)
        bounds[f"velo_fwdgrad{tag}"] = TP.bound_ms(
            2 * v[0].numel() * v[0].element_size() + 2 * pb + db + 4,
            _wide_ops("velo", "fwdgrad", NH, Nb, v[0].numel(), lg, dg, True))[0]
        fns[f"velo_fwdgrad{tag}"] = functools.partial(
            K.velo_fwdgrad, *va, want_disp=True)
    K.reset_launch_counts()
    med = _median_reps(TP, fns)
    check(all(K.LAUNCHES[n] > 0 for n in fns),
          f"--fwdgrad-times: a kernel not launched ({K.LAUNCHES})")
    out = {}
    for name, (ms, reps) in med.items():
        out[name] = (ms, bounds[name])
        print(f"[fwdgrad times] {name} @ {NG}x{NC} int16, disp_grad on, "
              f"{NH + (WIDE_BATCHES if 'wide' in name else 0)} columns: "
              f"median {ms:.4f} ms of {_reps_note(reps)}, bound "
              f"{bounds[name]:.4f} ms ({card})")
    return out


def turns(torch, seed, card, root, rounds=2):
    """``--turns ROOT``: `fwdgrad_times` of ROOT's package (another commit
    unpacked by ``git archive``) and of this checkout's, each in a process
    of its own, in turns ROOT, this, this, ROOT (``rounds`` times), after
    both packages are built (ROOT's nvcc beside this one's).  Prints each
    kernel's medians by tree and the ratio of their means."""
    import os
    import statistics

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(root)
    build = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from velocycle_tpu_torch.ops import cuda_build; "
         "cuda_build.build_all()", root], cwd=root)
    phase_build()
    check(build.wait() == 0, f"--turns: {root}'s package did not build")
    res = {root: [], here: []}
    for tree in [root, here, here, root] * rounds:
        run = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--package",
             tree, "--fwdgrad-times", "--seed", str(seed)],
            capture_output=True, text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"[turns] {'parent' if tree == root else 'this'} | {line}")
        check(run.returncode == 0 and lines and lines[-1].startswith("{"),
              f"--turns: {tree} exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        res[tree].append(json.loads(lines[-1])["fwdgrad_times"])
    for name in res[here][0]:
        a = [r[name][0] for r in res[root]]
        b = [r[name][0] for r in res[here]]
        print(f"[turns] {name}: parent {_reps_note(a)} ms, this "
              f"{_reps_note(b)} ms; this / parent "
              f"{statistics.mean(b) / statistics.mean(a):.4f}; bound parent "
              f"{res[root][0][name][1]:.4f}, this {res[here][0][name][1]:.4f} "
              f"ms ({card})")


def _wide_fold_cost(torch, seed, card):
    """What folding the 16 batches into basis columns costs, per stage: the
    fwd+grad kernel at 21 columns (Nh 5 + 16 batches, through the routed
    wrapper) against the wide body launched straight at Nh 5 alone (no
    batches; `_wide_launch`, uncounted: a measurement of its own), both at
    full width, and the fold's host-side work (`widen_inputs` +
    `narrow_grads`) per call.  A body that took delta_nu as it is would
    still add the batches' ElogS offsets and ddelta_nu sums to the Nh 5
    work, so the difference bounds from above what it could save; no such
    body is built, so the choice is not measured against one."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    out = {}
    for kind in ("phase", "velo"):
        make = make_inputs if kind == "phase" else make_velo_inputs
        v = make(torch, NG, NC, seed, Nb=WIDE_BATCHES)
        n_counts = 1 if kind == "phase" else 2
        counts, params = v[:n_counts], list(v[n_counts:-2])
        dnu, Db = v[-2:]
        lgk = lgamma_k_sum(torch, *counts)
        wd = kind == "phase"    # as (a) runs each stage
        routed = getattr(K, f"{kind}_fwdgrad")
        ops = (params[:2] + [None] + params[2:3] + [None] * 3 + params[3:]
               if kind == "phase" else params)

        def alone():
            return K._wide_launch(kind, "fwdgrad", counts, ops, True, wd, 1)

        med = _median_reps(TP, {
            "w21": lambda: routed(*v, lgk, want_disp=wd), "w5": alone})

        def fold():
            nu_w, zs, _, _ = K.widen_inputs(
                params[0], params[1:2 if kind == "phase" else 3], dnu, Db,
                NH + WIDE_BATCHES, True)
            return K.narrow_grads(nu_w, zs, None, NH, WIDE_BATCHES, True)

        fold_ms = TP.event_ms(fold, reps=20)
        w21, w5 = med["w21"][0], med["w5"][0]
        print(f"[timing] the fold of {WIDE_BATCHES} batches, {kind} stage, "
              f"on {card}: {kind}_fwdgrad_wide at 21 columns (Nh 5 + "
              f"{WIDE_BATCHES} batches) median {w21:.4f} ms of "
              f"{_reps_note(med['w21'][1])}, the wide body at Nh 5 alone "
              f"{w5:.4f} ms of {_reps_note(med['w5'][1])}: the batches add "
              f"{w21 - w5:.4f} ms; widen_inputs + narrow_grads "
              f"{fold_ms:.4f} ms per call")
        out[kind] = {"w21_ms": w21, "w5_ms": w5, "fold_host_ms": fold_ms}
        del v, counts, params, dnu, Db, ops
        torch.cuda.empty_cache()
    return out


def wide_passes(torch, seed, card):
    """``--wide`` (c): where the wide fwd+grad kernels' time goes, per pass,
    at 21 columns (Nh 5 + 16 batches folded in) at full width, int16, as
    (a) runs each stage: the loss-only cut, the timing cuts that stop after
    pass A and the factors (`pass_a`) and after pass B (`pass_ab`), and the
    whole fwd+grad cut, each through `_wide_launch` (uncounted, the
    wrapper's allocations and its sum of the gene partials over tiles
    included; the cell-sum kernel in fwdgrad only), medians of 5 x 20
    calls in turns.  Returns {stage: {cut: ms}}."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.tools import kernel_profile as TP

    out = {}
    for kind in ("phase", "velo"):
        make = make_inputs if kind == "phase" else make_velo_inputs
        v = make(torch, NG, NC, seed, Nb=WIDE_BATCHES)
        n_counts = 1 if kind == "phase" else 2
        counts, params = v[:n_counts], list(v[n_counts:-2])
        dnu, Db = v[-2:]
        nu_w, zs, _, _ = K.widen_inputs(
            params[0], params[1:2 if kind == "phase" else 3], dnu, Db,
            NH + WIDE_BATCHES, True)
        ops = ([nu_w, zs[0], None, params[2], None, None, None, params[3]]
               if kind == "phase" else [nu_w, *zs, *params[3:]])
        wd = kind == "phase"    # as (a) runs each stage
        med = _median_reps(TP, {
            cut: (lambda c=cut: K._wide_launch(kind, c, counts, ops, True,
                                               wd, 1))
            for cut in K.WIDE_CUTS})
        ms = {cut: med[cut][0] for cut in K.WIDE_CUTS}
        print(f"[timing] {kind}_fwdgrad_wide by pass at 21 columns on "
              f"{card}: " + ", ".join(
                  f"{c} median {ms[c]:.4f} ms of {_reps_note(med[c][1])}"
                  for c in K.WIDE_CUTS)
              + f"; pass A, the element and the factors beyond the "
              f"loss-only cut {ms['pass_a'] - ms['fwd']:.4f} ms, pass B "
              f"{ms['pass_ab'] - ms['pass_a']:.4f} ms, pass C and the cell "
              f"sums {ms['fwdgrad'] - ms['pass_ab']:.4f} ms")
        out[kind] = ms
        del v, counts, params, dnu, Db, ops, nu_w, zs
        torch.cuda.empty_cache()
    return out


def _batch_design(adata):
    """(a)'s batch design: an obs column of WIDE_BATCHES sections of NC /
    WIDE_BATCHES cells each, through make_design_matrix."""
    import numpy as np

    from velocycle_tpu_torch import make_design_matrix

    per = NC // WIDE_BATCHES
    adata.obs["batch"] = np.repeat(
        [f"section{b:02d}" for b in range(WIDE_BATCHES)], per)
    design = make_design_matrix(adata, "batch")
    check(design.shape == (NC, WIDE_BATCHES)
          and (design.sum(0) == per).all(), f"batch design {design.shape}")
    return design


def _with_batches(torch, mp, design):
    """A stage's metaparams on the same preprocessed counts with the batch
    design and delta_nu on (the stage's sd_dnu for every batch): the
    default run's (a) on [main]'s containers, which spares it a second host
    preprocessing of each stage (19.7 + 34.5 s through the front door in
    ``--wide`` on an H100 host, enough to carry the default run past its
    850-s aim);
    ``--wide`` preprocesses through the front door and holds these fields
    against it (`_front_door_vs_patch`), the only other use."""
    import dataclasses

    import numpy as np

    d = mp.data
    dev = d.S.device
    Db = torch.as_tensor(np.ascontiguousarray(design.T, dtype=np.float32),
                         device=dev)
    sd = torch.full((design.shape[1], 1), float(d.sd_dnu.reshape(-1)[0]),
                    dtype=torch.float32, device=dev)
    return dataclasses.replace(mp, data=d.replace(
        Db=Db, Nb=design.shape[1], sd_dnu=sd, with_delta_nu=True))


def wide_stage(torch, seed, card, mp, stage, cond=None,
               num_steps=WIDE_STEPS):
    """[wide] (a), one stage on ``mp`` (with the batch design): the fit
    through the user entry point with the launch counts set to 0 just
    before and read just after, one loss-only evaluation, the ELBO at the
    fit's first step (its init params and key) on the fused path against
    the plain path, steady-state steps/s and the device's busy share.
    Returns the stage's numbers (and the fit's params)."""
    import numpy as np

    from velocycle_tpu_torch import PhaseFitModel, VelocityFitModel
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.ops import nb_kernels as K

    kind = "phase" if stage == 1 else "velo"
    tag = f"wide stage {stage}"
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    if stage == 1:
        fit = PhaseFitModel(mp, num_samples=8, n_per_bin=8)
    else:
        fit = VelocityFitModel(mp, condition_on=cond, num_samples=2,
                               n_per_bin=1)
    data = fit.metaparams.data
    W = data.mu_nu.shape[1] + data.Db.shape[0]
    t0 = time.perf_counter()
    fit.fit(num_steps=num_steps, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    in_fit = {k: v for k, v in K.LAUNCHES.items() if v}
    widths = _width_launches(K)
    K.reset_launch_counts()
    with torch.no_grad():
        loss_only = float(fit.svi.loss_fn(fit.state.params, 7, data))
    in_eval = {k: v for k, v in K.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(fit.losses)
    print(f"[wide] (a) {tag}: {data.Ng} x {data.Nc}, {data.Db.shape[0]} "
          f"batches, {W} kernel columns; losses {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} (mean of last 10 {losses[-10:].mean():.6g}); "
          f"fit of {num_steps} steps incl. init, extraction and posterior "
          f"draws {fit_s:.2f} s; loss-only evaluation {loss_only:.6g}; "
          f"launches: fit {in_fit} by width {widths}, evaluation {in_eval}; "
          f"peak device memory {peak / 2**30:.2f} GiB on {card}")
    check(losses.shape == (num_steps,) and np.isfinite(losses).all()
          and losses[-10:].mean() < losses[0], f"{tag}: losses {losses}")
    check(in_fit == {f"{kind}_fwdgrad_wide": num_steps}
          and widths == {f"{kind}_fwdgrad_wide": {W: num_steps}},
          f"{tag}: launches in the fit {in_fit}, by width {widths}")
    check(in_eval == {f"{kind}_fwd_wide": 1} and math.isfinite(loss_only),
          f"{tag}: the loss-only evaluation launched {in_eval}")
    # the ELBO at step 0 (the fit's init params and its first step's key),
    # fused against plain
    state0 = fit.svi.init(seed, data)
    key = handlers.fold_in(state0.key, 1)
    with torch.no_grad():
        fused0 = float(fit.svi.loss_fn(state0.params, key, data))
        plain0 = float(fit.svi.loss_fn(state0.params, key,
                                       data.replace(use_fused_nb=False)))
    rel0 = abs(fused0 - plain0) / abs(plain0)
    print(f"[wide] (a) {tag}: ELBO at step 0 fused {fused0:.9g} vs plain "
          f"{plain0:.9g}, rel {rel0:.2e}; the fit's first loss "
          f"{losses[0]:.9g}")
    check(rel0 < LOSS_RTOL, f"{tag}: fused vs plain ELBO at step 0 rel {rel0:.2e}")
    del state0
    torch.cuda.empty_cache()
    # steady state: 3 warm-up steps, 20 timed (host clock), 5 profiled
    state, _ = fit.svi.update_chunk(fit.state, 3, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, chunk = fit.svi.update_chunk(state, 20, data)
    chunk.cpu()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    busy = _device_profile(
        torch, lambda: fit.svi.update_chunk(state, 5, data)[1].cpu(), tag, 5,
        "step")
    print(f"[wide] (a) {tag}: steady state {20 / dt:.3f} steps/s "
          f"({dt / 20 * 1e3:.2f} ms/step, host clock, 20 steps), "
          f"{in_fit[f'{kind}_fwdgrad_wide'] / num_steps:.0f} wide fwd+grad "
          f"launch per step, device busy "
          f"{'not measured' if busy is None else f'{busy:.1%}'} on {card}")
    out = {"steps_per_s": 20 / dt, "busy": busy, "peak_gib": peak / 2**30,
           "launches": in_fit, "eval_launches": in_eval,
           "elbo_step0_rel": rel0, "first_loss": float(losses[0]),
           "last_loss": float(losses[-1]), "fit_s": fit_s, "columns": W}
    # what stage 2 takes from a stage 1 fit (its conditioning; under
    # --wide its preprocessing too)
    fitted = types.SimpleNamespace(params=fit.params,
                                   cycle_fit=getattr(fit, "cycle_fit", None),
                                   phase_fit=getattr(fit, "phase_fit", None))
    del fit, state
    torch.cuda.empty_cache()
    return out, fitted


def _wide_cond(params):
    """Stage 2's conditioning on a stage 1 fit, as the two-stage workflow's."""
    return {"nu": params["nu_locs"], "phi_xy": params["phixy_locs"],
            "shape_inv": params["shape_inv_locs"]}


# --wide's batch-corrected runs past (a): (d) phase NUTS at WIDE_CHAIN's
# shape, 16 batches of 125 cells, H = 2 (5 + 16 = 21 columns), nu, delta_nu
# and shape_inv sampled, phases conditioned, as [mcmc] (b); (e) phase and
# velocity SMC at VELO_SMC's shape with 20 batches of 10 cells, H = 1 (3 +
# 20 = 23 columns); (g) the sharded step's steps
WIDE_NUTS = dict(Ng=WIDE_CHAIN["Ng"], Nc=WIDE_CHAIN["Nc"], sim_seed=17,
                 batches=16, H=2, chains=WIDE_CHAIN["chains"], warmup=200,
                 samples=100, svi_fit=500, max_depth=5, init_jitter=1.0)
WIDE_NUTS_CHECKED = 8   # drawn states held against the plain path
WIDE_SMC = dict(VELO_SMC, batches=20, H=1)
WIDE_SMC_SEEDS = 4
WIDE_SHARDED_STEPS = 20
WIDE_SHARDED_GATES = ((WIDE_SHARDED_STEPS, 2e-6),)


def _front_door_vs_patch(torch, mp, design, stage):
    """(a)'s container from the front door (the batch design given to the
    preprocessing) against the default run's swap of the same design into
    [main]'s container (`_with_batches`): Db, Nb, sd_dnu and mu_dnu.  A
    difference is printed; the front door's container is the one used."""
    d, patched = mp.data, _with_batches(torch, mp, design).data
    same = {f: bool(torch.equal(getattr(d, f), getattr(patched, f)))
            for f in ("Db", "sd_dnu", "mu_dnu")}
    same["Nb"] = d.Nb == patched.Nb
    print(f"[wide] (a) stage {stage} through the front door: Db "
          f"{tuple(d.Db.shape)}, Nb {d.Nb}, sd_dnu "
          f"{sorted(set(d.sd_dnu.reshape(-1).tolist()))}, mu_dnu "
          f"{float(d.mu_dnu)}; equal to the default run's swap: {same}"
          + ("" if all(same.values()) else " (they differ: the front door's "
             "container is used)"))
    check(d.with_delta_nu and d.Nb == WIDE_BATCHES
          and tuple(d.Db.shape) == (WIDE_BATCHES, NC),
          f"[wide] (a) stage {stage}: the front door's batch fields")


def wide_alone(torch, seed, card):
    """``--wide``: [wide] (b) and (c), then (a) on its own preprocessing of
    the [main] draw through the front door (the batch design given to
    preprocess_for_phase_estimation and preprocess_for_velocity_estimation;
    stage 2 preprocessed from (a)'s stage 1 fit), each stage followed by
    (g)'s one rank on its data and stage 1 by (f); then (g)'s two ranks,
    (d) and (e).  Prints one JSON line of the runs' launches by kernel and
    chain count ((f)'s are its own: launches per block step)."""
    from velocycle_tpu_torch import (
        AngularSpeed, Cycle, Phases, preprocess_for_phase_estimation,
        preprocess_for_velocity_estimation,
    )

    kernel_digest(torch, seed, narrow=False, wide=True)
    wide_parity(torch, seed)
    wide_timing(torch, seed, card)
    wide_timing(torch, seed, card, WIDE_SWEPT, full=False)
    wide_passes(torch, seed, card)
    torch.cuda.empty_cache()
    one_rank = dict(steps=WIDE_SHARDED_STEPS, tag="[wide] (g)")
    t0 = time.perf_counter()
    adata, genes, cells, angles = _make_adata(torch, seed, "cuda")
    design = _batch_design(adata)
    mp = preprocess_for_phase_estimation(
        adata, Cycle.trivial_prior(genes, harmonics=H),
        Phases.from_angles(angles, concentration=1.0, cell_names=cells),
        design_mtx=design, n_harmonics=H, with_delta_nu=True,
        use_fused_nb=True, device="cuda")
    print(f"[wide] (a) stage 1 preprocessing with the batch design: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    _front_door_vs_patch(torch, mp, design, 1)
    runs = {}
    runs["a_phase"], s1 = wide_stage(torch, seed, card, mp, 1)
    torch.cuda.empty_cache()
    runs["f"] = minibatch_phase_stage(torch, seed, card, mp, tag="[wide] (f)")
    torch.cuda.empty_cache()
    ref = sharded_stage_refs(torch, seed, card, "phase", mp.data, **one_rank)
    del mp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vmp = preprocess_for_velocity_estimation(
        adata, s1.cycle_fit, s1.phase_fit,
        AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2, stds=0.5),
        batch_design_mtx=design, n_harmonics=H, omega_n_harmonics=1,
        with_delta_nu=True, model_type="lrmn", use_fused_nb=True,
        device="cuda")
    print(f"[wide] (a) stage 2 preprocessing with the batch design: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    _front_door_vs_patch(torch, vmp, design, 2)
    cond = _wide_cond(s1.params)
    runs["a_velo"], _ = wide_stage(torch, seed, card, vmp, 2, cond=cond)
    torch.cuda.empty_cache()
    sharded_stage_refs(torch, seed, card, "velocity", vmp.data, cond, ref,
                       **one_rank)
    del vmp, adata, s1
    torch.cuda.empty_cache()
    runs["g"] = wide_sharded(torch, seed, card, ref)
    torch.cuda.empty_cache()
    runs["d"] = wide_nuts(torch, seed, card)
    torch.cuda.empty_cache()
    runs["e"] = wide_smc(torch, seed, card)
    # the runs' launches of each wide kernel by chain count
    by_kernel = {k: {} for k in WIDE_KERNELS}
    for stage, kind in (("a_phase", "phase"), ("a_velo", "velo")):
        for k, n in {**runs[stage]["launches"],
                     **runs[stage]["eval_launches"]}.items():
            _add_launches(by_kernel[k], {1: n})
    for stage, one in runs["g"]["a"].items():
        _add_launches(by_kernel[one["kernel"]], {1: 2 * one["launches"]})
        for r in runs["g"]["b"][stage]["ranks"]:
            _add_launches(by_kernel[r["kernel"]], {1: r["launches"]})
    _add_launches(by_kernel["phase_fwdgrad_wide"], runs["d"]["launches"])
    for kind in ("phase", "velo"):
        for k, by_k in runs["e"][kind]["launches"].items():
            _add_launches(by_kernel[k], by_k)
    print(json.dumps({"wide_runs": {
        "launches_by_chains": by_kernel,
        "d": {k: v for k, v in runs["d"].items() if k != "launches"},
        "e": {kind: {k: v for k, v in runs["e"][kind].items()
                     if k != "launches"} for kind in ("phase", "velo")},
        "f": {k: v for k, v in runs["f"].items()},
        "g": runs["g"]}}, default=float))


def wide_sharded(torch, seed, card, ref):
    """[wide] (g)'s two ranks sharing the card over gloo, each drawing the
    [main] counts and keeping its cells (``Db`` split by cells with them)
    around the host templates of (a)'s front-door data, WIDE_SHARDED_STEPS
    steps of each stage on the wide body, the losses against the one rank
    (bit-equal to `SVI.update`) within rel 2e-6.  Correctness only: two
    ranks on one card measure contention."""
    from velocycle_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    payload = {k: ref[k] for k in ("tmpl1", "tmpl2", "cond", "sums")}
    payload.update(seed=seed, steps=WIDE_SHARDED_STEPS, Ng=ref["tmpl1"].Ng,
                   Nc=ref["tmpl1"].Nc)
    ranks = run_ranks(_sharded_rank, SHARDED_WORLD, backend="gloo",
                      device="cuda", timeout=900, args=(payload,))
    out = {"a": ref["a"], "b": _gate_b(ranks, ref, card, WIDE_SHARDED_GATES,
                                       "[wide] (g)")}
    print(f"[wide] (g) two ranks in all, {SHARDED_WORLD} ranks spawned: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _batched_sim(torch, cfg, seed, harmonics):
    """bench.py's `_sim` draw of ``cfg``'s size with an obs column of
    cfg["batches"] batches of equal size (consecutive cells) and its design
    through make_design_matrix; a trivial Cycle prior of ``harmonics``."""
    import numpy as np

    from velocycle_tpu_torch import (
        Cycle, Phases, make_design_matrix, simulate_data,
    )

    nb = cfg["batches"]
    adata = simulate_data(Nc=cfg["Nc"], Ng=cfg["Ng"], omegas_to_test=(0.4,),
                          seed=cfg["sim_seed"] + seed)
    adata.obs["batch"] = np.repeat([f"b{b:02d}" for b in range(nb)],
                                   cfg["Nc"] // nb)
    design = make_design_matrix(adata, "batch")
    cycle = Cycle.trivial_prior(list(adata.var.index), harmonics=harmonics)
    phases = Phases.from_angles(np.asarray(adata.obs["simulated_phis"].values),
                                cell_names=list(adata.obs.index))
    return adata, cycle, phases, design


def _no_narrow_launch(K_, tag):
    narrow = {k: n for k, n in K_.LAUNCHES.items()
              if n and not k.endswith("_wide")}
    check(not narrow, f"{tag}: narrow launches {narrow}")


def wide_nuts(torch, seed, card, cfg=WIDE_NUTS, device="cuda"):
    """[wide] (d): phase NUTS on the wide body, 21 columns: MCMCFitModel on
    the front door's batch-corrected data, phases conditioned, nu,
    delta_nu and shape_inv sampled, a 500-step SVI warm start, 64 chains x
    (200 + 100), max_depth 5.  Gates: finite draws, accept > 0.5, every
    batched evaluation exactly one K = 64 phase_fwdgrad_wide launch, no
    narrow launch, and at WIDE_NUTS_CHECKED drawn states (one chain batch)
    the fused potential and gradient against the plain path's.  R-hat and
    ESS printed by site."""
    import numpy as np

    from velocycle_tpu_torch import MCMCFitModel, preprocess_for_phase_estimation
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import mcmc as TM
    from velocycle_tpu_torch.ops import nb_kernels as K_

    tag = "[wide] (d)"
    t0 = time.perf_counter()
    adata, cycle, phases, design = _batched_sim(torch, cfg, seed, cfg["H"])
    kw = dict(design_mtx=design, n_harmonics=cfg["H"], with_delta_nu=True,
              device=device)
    mp = preprocess_for_phase_estimation(adata, cycle, phases,
                                         use_fused_nb=True, **kw)
    plain = preprocess_for_phase_estimation(adata, cycle, phases,
                                            use_fused_nb=False, **kw)
    W = mp.data.mu_nu.shape[1] + mp.data.Nb
    check(W == WIDE_CHAIN["nh"] and mp.data.S.dtype == torch.int16,
          f"{tag}: {W} columns, counts {mp.data.S.dtype}")
    fm = MCMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                      num_chains=cfg["chains"], num_warmup=cfg["warmup"],
                      num_samples=cfg["samples"], svi_steps=cfg["svi_fit"],
                      max_depth=cfg["max_depth"],
                      init_jitter=cfg["init_jitter"])
    print(f"{tag} set-up: simulate, preprocess x2 ({cfg['Ng']} x "
          f"{cfg['Nc']}, {mp.data.Nb} batches of {cfg['Nc'] // mp.data.Nb} "
          f"cells, {W} columns): {time.perf_counter() - t0:.1f} s on {card}")
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    with _EvalCounter() as counter:
        t0 = time.perf_counter()
        fm.run(seed + 19)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    iters = cfg["warmup"] + cfg["samples"]
    by_k = dict(K_.LAUNCH_CHAINS["phase_fwdgrad_wide"])
    print(f"{tag} wide phase nuts: phase_fwdgrad_wide launches by chain "
          f"count {by_k}, phase_fwd_wide {K_.LAUNCHES['phase_fwd_wide']}; "
          f"{counter.calls} batched potential evaluations over {iters} "
          f"iterations ({counter.calls / iters:.1f} per iteration); wall "
          f"{dt:.1f} s, {cfg['chains'] * cfg['samples'] / dt:.1f} samples/s, "
          f"peak device memory {peak / 2**30:.3f} GiB on {card}")
    check(by_k.get(cfg["chains"], 0) == counter.calls > 0
          and set(by_k) <= {1, cfg["chains"]},
          f"{tag}: {by_k} for {counter.calls} batched evaluations")
    _no_narrow_launch(K_, tag)
    d = fm.diagnostics
    by_site = _rhat_by_site(fm.summary)
    print(f"{tag}: max split R-hat (min ESS) by site "
          + ", ".join(f"{k} {r:.4f} ({e:.1f})" for k, (r, e) in by_site.items()))
    print(f"{tag}: accept {d['accept_rate']:.4f}, max split R-hat "
          f"{d['max_split_rhat']:.4f}, min ESS {d['min_ess']:.1f}, median ESS "
          f"{d['median_ess']:.1f} of {cfg['chains'] * cfg['samples']} draws")
    ident = _identified_mixing(fm.mcmc.get_samples(group_by_chain=True),
                               mp.data.Nb, cfg["Ng"])
    print(f"{tag}: max split R-hat (min ESS) of what the likelihood "
          f"identifies (every cell in one batch): "
          + ", ".join(f"{k} {r:.4f} ({e:.1f})" for k, (r, e) in ident.items()))
    draws = fm.mcmc.get_samples()
    check(all(np.isfinite(v).all() for v in draws.values()),
          f"{tag}: non-finite draws")
    check(d["accept_rate"] > 0.5, f"{tag}: accept rate {d['accept_rate']}")
    info = fm.mcmc.model_info
    q = fm.mcmc._samples_u[:, -1].contiguous()
    busy = _device_profile(torch, lambda: _nuts_transitions(info, q, cfg),
                           "wide", 4, "NUTS transition")
    print(f"{tag}: device busy "
          f"{'not measured' if busy is None else f'{busy:.1%}'} over four "
          f"NUTS transitions, {dt / counter.calls * 1e3:.2f} ms of wall per "
          f"batched evaluation (run incl. warm start) on {card}")
    # drawn states: the fused wide potential against the plain path's
    n = next(iter(draws.values())).shape[0]
    idx = np.linspace(0, n - 1, WIDE_NUTS_CHECKED).astype(int)
    values = {k: v[idx] for k, v in draws.items()}
    first = {k: v[0] for k, v in values.items()}
    finfo = TM.init_model(fm.model, fm.metaparams.data, init_values=first)
    pinfo = TM.init_model(handlers.condition(plain.model_fn,
                                             data=fm.condition),
                          plain.data, init_values=first)
    K_.reset_launch_counts()
    rels = _potential_parity(torch, f"{tag} drawn states", finfo, pinfo,
                             _flat_states(torch, finfo, values), GRAD_RTOL)
    check(dict(K_.LAUNCH_CHAINS["phase_fwdgrad_wide"])
          == {WIDE_NUTS_CHECKED: 1},
          f"{tag}: the drawn states' evaluation launched "
          f"{K_.LAUNCH_CHAINS['phase_fwdgrad_wide']}")
    return {"launches": by_k, "evals": counter.calls, "iters": iters,
            "wall_s": dt, "samples_per_s": cfg["chains"] * cfg["samples"] / dt,
            "accept": d["accept_rate"], "max_split_rhat": d["max_split_rhat"],
            "min_ess": d["min_ess"], "median_ess": d["median_ess"],
            "by_site": by_site, "identified": ident, "peak_gib": peak / 2**30,
            "busy": busy, "drawn_states_rel": rels, "columns": W}


def _identified_mixing(by_chain, Nb, Ng):
    """{quantity: (max split R-hat, min ESS)} of the phase model's draws
    (grouped by chain) in the combinations the likelihood identifies when
    every cell is in one batch: each gene's level in the mean batch, nu's
    constant column plus the mean of its delta_nu over the batches; its
    batch offsets about that mean; nu's harmonic columns.  Along the rest,
    nu[:, 0] - c with delta_nu + c, only the priors bound the posterior."""
    from velocycle_tpu_torch.infer import mcmc as TM

    nu = by_chain["nu"]
    C, S = nu.shape[:2]
    dnu = by_chain["delta_nu"].reshape(C, S, Nb, Ng)
    parts = {"nu[:, 0] + mean delta_nu": nu[..., 0] + dnu.mean(2),
             "delta_nu - its batch mean": dnu - dnu.mean(2, keepdims=True),
             "nu[:, 1:]": nu[..., 1:]}
    out = {}
    for name, x in parts.items():
        x = x.reshape(C, S, -1)
        out[name] = (float(TM._split_rhat(x).max()),
                     float(TM.effective_sample_size(x).min()))
    return out


def _smc_loglik(torch, smc, q):
    """The absolute log-likelihood of the particles q (one chain batch,
    gradients off: one loss-only launch on fused data), float64."""
    with torch.no_grad():
        ll = torch.func.vmap(
            lambda u: smc.tempered.log_parts(u, prior=False)[1])(q)
    return ll.double() + smc.tempered.log_lik_offset


class _StagesRecorded:
    """Records, while entered, each stage an `infer.smc.SMC` runs: its
    particles before the reweighting, its beta and the next one."""

    def __init__(self, module):
        self.module, self.stages = module, []

    def __enter__(self):
        cls = self.module.SMC
        self.orig = orig = cls.stage
        stages = self.stages

        def stage(smc, particles, beta, *args, **kwargs):
            out = orig(smc, particles, beta, *args, **kwargs)
            stages.append((particles.detach().clone(), beta, out[1]))
            return out

        cls.stage = stage
        return self

    def __exit__(self, *exc):
        self.module.SMC.stage = self.orig


def _log_z_along(torch, tempered, stages):
    """log Z of the recorded ``stages`` (`_StagesRecorded`) with
    ``tempered``'s log-likelihood: each stage's increment as `SMC.stage`
    forms it (the float32 log weights at its particles, scaled by its step
    in beta) and the likelihood's offset added back, as
    `SMC.log_evidence`."""
    f32 = torch.float32
    log_z = 0.0
    for q, beta, new_beta in stages:
        with torch.no_grad():
            lw = torch.func.vmap(
                lambda u: tempered.log_parts(u, prior=False)[1])(q).float()
        log_w = (torch.tensor(new_beta, dtype=f32)
                 - torch.tensor(beta, dtype=f32)) * lw.cpu()
        log_z += float(torch.logsumexp(log_w, 0)) - math.log(q.shape[0])
    return log_z + tempered.log_lik_offset


def _smc_fit(mp, cfg):
    """SMCFitModel on ``mp`` with ``cfg``'s particles, moves, target ESS,
    stages and warm start, phases conditioned."""
    from velocycle_tpu_torch import SMCFitModel

    return SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                       num_particles=cfg["chains"],
                       num_moves=cfg["num_moves"],
                       target_ess=cfg["target_ess"],
                       max_stages=cfg["max_stages"],
                       svi_steps=cfg["svi_steps"])


def wide_smc(torch, seed, card, cfg=WIDE_SMC, device="cuda"):
    """[wide] (e): phase and velocity prior tempering on the wide body at
    VELO_SMC's shape with 20 batches of 10 cells (H = 1: 23 columns),
    phases conditioned, SMCFitModel on the front door's batch-corrected
    data, for WIDE_SMC_SEEDS seeds.  Gates (`smc_run`'s): the schedule
    reaches 1, finite log Z, one K = 256 ``*_fwd_wide`` launch per stage and
    one K = 256 ``*_fwdgrad_wide`` per batched evaluation; no narrow launch;
    the final particles' log-likelihood in one K = 256 loss-only launch
    against the plain path's at the same particles (rel LOSS_RTOL); and
    each run's log Z against the same run on the plain path: the plain
    path's log-likelihood at every stage's particles and betas of the fused
    run, summed as the run sums them, within LOSS_RTOL x |log Z| (the
    fused run's own sum recomputed from the record first, which must
    reproduce its log Z).  Then an independent plain run from each seed:
    its log Z and stages are printed beside the fused run's with the means,
    spreads and the standard error of their difference, ungated (once the
    two runs' trajectories part, each is a draw of the estimator's Monte
    Carlo noise); from the first seed each path is run again, and whether
    it repeats its own log Z printed."""
    import numpy as np

    from velocycle_tpu_torch import (
        AngularSpeed, preprocess_for_phase_estimation,
        preprocess_for_velocity_estimation,
    )
    from velocycle_tpu_torch.infer import smc as TS
    from velocycle_tpu_torch.ops import nb_kernels as K_

    adata, cycle, phases, design = _batched_sim(torch, cfg, seed, cfg["H"])
    speed = AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                       stds=0.5)
    out = {}
    for kind in ("phase", "velo"):
        t0 = time.perf_counter()
        tag = f"[wide] (e) {kind}"
        mps = {}
        for fused in (True, False):
            if kind == "phase":
                mps[fused] = preprocess_for_phase_estimation(
                    adata, cycle, phases, design_mtx=design,
                    n_harmonics=cfg["H"], with_delta_nu=True,
                    use_fused_nb=fused, device=device)
            else:
                mps[fused] = preprocess_for_velocity_estimation(
                    adata, cycle, phases, speed, batch_design_mtx=design,
                    n_harmonics=cfg["H"], omega_n_harmonics=1,
                    with_delta_nu=True, model_type="fourier",
                    use_fused_nb=fused, device=device)
        W = mps[True].data.mu_nu.shape[1] + mps[True].data.Nb
        check(W == 2 * cfg["H"] + 1 + cfg["batches"],
              f"{tag}: {W} columns")
        runs = []
        for i in range(WIDE_SMC_SEEDS):
            run_seed = seed + 5 + i
            with _StagesRecorded(TS) as rec:
                fm, res = smc_run(torch, seed, card, f"{tag} smc, {W} "
                                  f"columns, seed {run_seed}", cfg, mps[True],
                                  cfg["svi_steps"], cfg["max_stages"],
                                  cfg["target_ess"], run_seed, device)
            _no_narrow_launch(K_, tag)
            plain = _smc_fit(mps[False], cfg)
            K_.reset_launch_counts()
            t1 = time.perf_counter()
            plain.run(run_seed)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
            check(not any(K_.LAUNCHES.values()),
                  f"{tag}: the plain run launched {K_.LAUNCHES}")
            if i == 0:
                # the quantity log Z sums, at the fused run's final particles
                q = fm.smc.particles
                ll_f = _smc_loglik(torch, fm.smc, q)
                fwd = _kernel_name(mps[True].data, grad=False)
                launched = dict(K_.LAUNCH_CHAINS[fwd])
                ll_p = _smc_loglik(torch, plain.smc, q)
                ll_rel = float(((ll_f - ll_p).abs() / ll_p.abs()).max())
                print(f"{tag}: the final particles' log-likelihood, fused "
                      f"({launched} {fwd} launches by chain count) "
                      f"against plain: rel {ll_rel:.2e} (gate {LOSS_RTOL:g})")
                check(ll_rel < LOSS_RTOL and launched == {cfg["chains"]: 1},
                      f"{tag}: particles' log-likelihood rel {ll_rel}, "
                      f"launches {launched}")
                res["particle_loglik_rel"] = ll_rel
                res.update(_smc_host_and_device(torch, fm, tag, card))
                # each path run again from the seed: does it repeat itself?
                for name, m, first in (("fused", mps[True], fm),
                                       ("plain", mps[False], plain)):
                    again = _smc_fit(m, cfg)
                    again.run(run_seed)
                    res[f"{name}_repeats"] = (again.log_evidence
                                              == first.log_evidence)
                    print(f"{tag} seed {run_seed}: the {name} path run again: "
                          f"log Z {again.log_evidence:.6f} against "
                          f"{first.log_evidence:.6f}, "
                          f"{len(again.temperature_schedule)} stages "
                          f"(repeats: {res[name + '_repeats']})")
                    del again
            # the same run on the plain path: its particles and betas
            z_f = fm.log_evidence
            z_again = _log_z_along(torch, fm.smc.tempered, rec.stages)
            z_p = _log_z_along(torch, plain.smc.tempered, rec.stages)
            dz = z_f - z_p
            gate = LOSS_RTOL * abs(z_f)
            print(f"{tag} seed {run_seed}: log Z {z_f:.3f} fused "
                  f"({res['stages']} stages; from its record {z_again:.3f}), "
                  f"the plain path along the same stages {z_p:.3f}: "
                  f"{dz:+.2e} nats (gate {gate:.3f}); an independent plain "
                  f"run {plain.log_evidence:.3f} "
                  f"({len(plain.temperature_schedule)} stages, "
                  f"{plain_s:.2f} s; first betas fused "
                  f"{fm.temperature_schedule[:3].tolist()}, plain "
                  f"{plain.temperature_schedule[:3].tolist()})")
            check(abs(z_again - z_f) <= 1e-6 * abs(z_f),
                  f"{tag}: the record gives log Z {z_again}, the run {z_f}")
            check(abs(dz) < gate, f"{tag}: log Z fused {z_f}, plain along "
                  f"the same stages {z_p}")
            runs.append({**res, "paired_dlogZ": dz,
                         "plain_log_evidence": plain.log_evidence,
                         "plain_stages": len(plain.temperature_schedule)})
            del fm, plain, rec
            torch.cuda.empty_cache()
        zf = np.array([r["log_evidence"] for r in runs])
        zp = np.array([r["plain_log_evidence"] for r in runs])
        sf, sp = zf.std(ddof=1), zp.std(ddof=1)
        se = math.sqrt((sf ** 2 + sp ** 2) / len(runs))
        stages_f = [r["stages"] for r in runs]
        stages_p = [r["plain_stages"] for r in runs]
        print(f"{tag}: over {len(runs)} seeds, independent runs: log Z "
              f"fused mean {zf.mean():.3f} (sd {sf:.3f}), plain "
              f"{zp.mean():.3f} (sd {sp:.3f}); difference of the means "
              f"{zf.mean() - zp.mean():+.3f} nats, standard error {se:.3f} "
              f"(ungated); stages fused {stages_f}, plain {stages_p}; paired "
              f"max |dlogZ| {max(abs(r['paired_dlogZ']) for r in runs):.2e} "
              f"nats; in all, data included {time.perf_counter() - t0:.1f} "
              f"s on {card}")
        launches = {}
        for r in runs:
            for k, by_k in r["launches"].items():
                _add_launches(launches.setdefault(k, {}), by_k)
        out[kind] = {**{k: v for k, v in runs[0].items() if k != "launches"},
                     "launches": launches,
                     "paired_dlogZ_by_seed": [r["paired_dlogZ"] for r in runs],
                     "log_evidence_by_seed": zf.tolist(),
                     "plain_log_evidence_by_seed": zp.tolist(),
                     "stages_by_seed": stages_f,
                     "plain_stages_by_seed": stages_p,
                     "mean_difference": float(zf.mean() - zp.mean()),
                     "mean_difference_se": se, "columns": W}
    return out


def _stages(torch, seed, card):
    """Both stages at full width, alone on the host and the card, each
    followed by [minibatch], [support], [sharded] (a) and [wide] (a) on its
    preprocessed data.  Returns (launches by kernel from the stage that
    drives it, the wide kernels' from [wide] (a), (stage 1 steps/s, peak,
    stage 2 steps/s, peak), [minibatch]'s numbers, [support]'s, what
    [sharded] (b) takes from (a), [wide] (a)'s numbers)."""
    adata, genes, cells, angles = _make_adata(torch, seed, "cuda")
    launches, steps_per_s, peak, stage1 = phase_main_path(
        torch, seed, adata, genes, cells, angles)
    torch.cuda.empty_cache()
    mb = minibatch_phase_stage(torch, seed, card, stage1.mp)
    torch.cuda.empty_cache()
    support = {"phase": support_stage(torch, seed, card, stage1.mp, None,
                                      "phase", steps_per_s)}
    sharded = sharded_stage_refs(torch, seed, card, "phase", stage1.mp.data)
    # [wide] (a): the same counts in 16 batches, delta_nu on: 21 columns
    design = _batch_design(adata)
    wide = {}
    wide["phase"], wide1 = wide_stage(
        torch, seed, card, _with_batches(torch, stage1.mp, design), 1)
    stage1.mp = None
    torch.cuda.empty_cache()
    vlaunches, vsteps_per_s, vpeak, vmp = velocity_main_path(
        torch, seed, adata, stage1)
    launches.update(velo_fwd=vlaunches["velo_fwd"],
                    velo_fwdgrad=vlaunches["velo_fwdgrad"])
    mb["velocity_block_objective_rel"] = _block_objective(
        torch, seed, vmp, "velocity")
    torch.cuda.empty_cache()
    p = stage1.params
    cond = {"nu": p["nu_locs"], "phi_xy": p["phixy_locs"],
            "shape_inv": p["shape_inv_locs"]}
    support["velocity"] = support_stage(torch, seed, card, vmp, cond,
                                        "velocity", vsteps_per_s)
    sharded_stage_refs(torch, seed, card, "velocity", vmp.data, cond, sharded)
    wide["velo"], _ = wide_stage(
        torch, seed, card, _with_batches(torch, vmp, design), 2,
        cond=_wide_cond(wide1.params))
    for stage in ("phase", "velo"):
        for k, n in wide[stage]["launches"].items():
            launches[k] = n
        for k, n in wide[stage]["eval_launches"].items():
            launches[k] = launches.get(k, 0) + n
    del adata, stage1, vmp, wide1
    torch.cuda.empty_cache()
    return (launches, (steps_per_s, peak, vsteps_per_s, vpeak), mb, support,
            sharded, wide)


# ---------------------------------------------------------------------------
# [support]: warmup, checkpoint and resume, profiling and check_model on
# each stage's full-width data
# ---------------------------------------------------------------------------

SUPPORT_STEPS, SUPPORT_RESUME_AT = 50, 25
SUPPORT_DIR = "build/chip_smoke"      # checkpoints and traces (git-ignored)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _resume_check(torch, seed, driver, data, tag, kernel, device):
    """SUPPORT_STEPS uninterrupted SVI steps against SUPPORT_RESUME_AT steps,
    `Checkpointer.save`, `restore` into a fresh SVI's state and the rest:
    losses and every leaf of the state bit-equal, exactly one ``kernel``
    launch per step in each run.  Returns (the resumed SVI, its state, the
    numbers)."""
    import os
    import shutil

    from velocycle_tpu_torch.checkpoint import Checkpointer
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
    from velocycle_tpu_torch.ops import nb_kernels as K_

    n, k = SUPPORT_STEPS, SUPPORT_RESUME_AT

    def new_svi():
        return SVI(driver.model, driver.guide, clipped_adam(
            lr=0.05, betas=(0.80, 0.99), lrd=0.1 ** (1.0 / n)), Trace_ELBO())

    K_.reset_launch_counts()
    svi = new_svi()
    full, full_losses = svi.update_chunk(svi.init(seed, data), n, data)
    _sync(torch, device)
    full_launches = dict(K_.LAUNCHES)

    K_.reset_launch_counts()
    svi1 = new_svi()
    part, first = svi1.update_chunk(svi1.init(seed, data), k, data)
    directory = os.path.join(SUPPORT_DIR, f"ckpt_{tag}")
    shutil.rmtree(directory, ignore_errors=True)
    ckpt = Checkpointer(directory)
    _sync(torch, device)
    t0 = time.perf_counter()
    ckpt.save(part.step, part)
    save_ms = (time.perf_counter() - t0) * 1e3
    npz_bytes = os.path.getsize(os.path.join(directory, f"ckpt_{k}.npz"))
    svi2 = new_svi()
    like = svi2.init(seed + 1, data)      # a fresh state, as a new process has
    _sync(torch, device)
    t0 = time.perf_counter()
    resumed = ckpt.restore(like)
    _sync(torch, device)
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(ckpt.latest_step() == k and resumed.step == k,
          f"[support] {tag}: restored step {resumed.step}")
    resumed, rest = svi2.update_chunk(resumed, n - k, data)
    _sync(torch, device)
    resumed_launches = dict(K_.LAUNCHES)

    losses_equal = torch.equal(full_losses, torch.cat([first, rest]))
    pairs = ([(full.params, resumed.params)]
             + [(full.opt_state[m], resumed.opt_state[m]) for m in ("m", "v")])
    leaves_equal = all(list(a) == list(b) and all(torch.equal(a[x], b[x])
                                                  for x in a)
                       for a, b in pairs)
    leaves_equal &= (full.step, full.key, full.opt_state["count"]) == (
        resumed.step, resumed.key, resumed.opt_state["count"])
    print(f"[support] {tag}: {n} steps uninterrupted against {k} + save + "
          f"restore into a fresh SVI + {n - k}: losses bit-equal "
          f"{losses_equal}, every param and Adam moment bit-equal "
          f"{leaves_equal}; {kernel} launches {full_launches[kernel]} / "
          f"{resumed_launches[kernel]}; .npz {npz_bytes} bytes, save "
          f"{save_ms:.2f} ms, restore {restore_ms:.2f} ms")
    check(losses_equal and leaves_equal,
          f"[support] {tag}: the resumed fit differs from the uninterrupted")
    for launches in (full_launches, resumed_launches):
        check(launches[kernel] == n and sum(launches.values()) == n,
              f"[support] {tag}: launches {launches} in {n} steps")
    return svi2, resumed, {"npz_bytes": npz_bytes, "save_ms": save_ms,
                           "restore_ms": restore_ms,
                           "launches": full_launches[kernel]}


def _traced_steps(torch, card, svi, state, data, steps_per_s, device):
    """`profiling.trace` around 5 SVI steps, each under `StepTimer` (ending
    in a synchronize); the trace must name the phase kernel.  Returns the
    kernel's name in the trace."""
    import glob
    import os
    import shutil

    from velocycle_tpu_torch import profiling

    logdir = os.path.join(SUPPORT_DIR, "trace")
    shutil.rmtree(logdir, ignore_errors=True)
    timer = profiling.StepTimer()
    with profiling.trace(logdir):
        for i in range(5):
            with profiling.annotate(f"svi_step_{i}"), timer:
                state, _ = svi.update(state, data)
                _sync(torch, device)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                    and "phase_kernel" in e.get("name", "")})
    summary = timer.summary()
    stats = profiling.device_memory_stats()
    peak = stats[str(torch.device(device, 0))]["allocated_bytes.all.peak"]
    print(f"[support] trace of 5 steps: {os.path.getsize(path)} bytes, "
          f"{len(events)} events; the phase kernel in it: "
          f"{names[0][:100] if names else 'none'}")
    print(f"[support] StepTimer: {summary['steps_per_s']:.2f} steps/s "
          f"(p50 {summary['p50_ms']:.2f} ms, first {summary['compile_s'] * 1e3:.2f}"
          f" ms, profiler on) beside the stage's own {steps_per_s:.2f} steps/s "
          f"(host clock, 20 steps); device_memory_stats peak "
          f"{peak / 2**30:.3f} GiB beside max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, on {card}")
    check(names, "[support] the trace names no phase kernel")
    return names[0]


def support_stage(torch, seed, card, mp, cond, stage, steps_per_s,
                  device="cuda"):
    """[support] on one stage's preprocessed full-width data: (a) `warmup`
    on its metaparams (the build already done: ~0 s); (b) checkpoint and
    resume (`_resume_check`), conditioned as the stage's fit is; (c) for the
    phase stage, `profiling.trace` around 5 steps; (d) `check_model`'s site
    table."""
    from velocycle_tpu_torch import PhaseFitModel, VelocityFitModel, warmup
    from velocycle_tpu_torch.ops import cuda_build
    from velocycle_tpu_torch.plots import check_model

    t0 = time.perf_counter()
    phase = stage == "phase"
    timings = warmup(mp, condition_on=cond, num_steps=SUPPORT_STEPS,
                     num_posterior_samples=8 if phase else 2, seed=seed,
                     cache_dir=str(cuda_build.BUILD_DIR), verbose=False)
    print(f"[support] {stage} warmup: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in timings.items()))
    driver = (PhaseFitModel(mp, get_posterior=False) if phase else
              VelocityFitModel(mp, condition_on=cond, get_posterior=False))
    data = driver.metaparams.data
    kernel = "phase_fwdgrad" if phase else "velo_fwdgrad"
    svi, state, out = _resume_check(torch, seed, driver, data, stage, kernel,
                                    device)
    out["warmup"] = timings
    if phase:
        out["trace_kernel"] = _traced_steps(torch, card, svi, state, data,
                                            steps_per_s, device)
    del svi, state
    print(f"[support] {stage} check_model at {data.Ng} x {data.Nc}:")
    check_model(driver.model, data)
    out["seconds"] = time.perf_counter() - t0
    print(f"[support] {stage} in all: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [minibatch]: MinibatchSVI at full width on the [main] draw
# ---------------------------------------------------------------------------

MB_BLOCKS = 8           # B = 12,800 cells per block at full width
MB_EPOCHS = 2
MB_FULL_STEPS = 5       # the full-batch SVI steps whose peak memory is the reference


def _block_objective(torch, seed, mp, stage, tag="[minibatch]"):
    """At the guide's draws on the full data, substituted into model and
    guide: the mean of the num_blocks scaled block losses against the
    full-batch loss, on the fused kernels (loss-only launches).  Returns
    the relative difference (gate 1e-5)."""
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import Trace_ELBO
    from velocycle_tpu_torch.infer.minibatch import LOCAL_SITES, split_cells
    from velocycle_tpu_torch.ops import nb_kernels as K_

    data = mp.data
    with torch.no_grad():
        tr = handlers.trace(handlers.seed(mp.guide_fn, seed + 21)).get_trace(data)
        vals = {n: site["value"] for n, site in tr.items()
                if site["type"] == "sample"}
        K_.reset_launch_counts()
        full = float(Trace_ELBO().loss(
            0, handlers.substitute(mp.model_fn, data=vals),
            handlers.substitute(mp.guide_fn, data=vals), data))
        blocks = split_cells(data, MB_BLOCKS)
        B = blocks[0].Nc
        total = 0.0
        for i, blk in enumerate(blocks):
            v = dict(vals)
            v["phi_xy"] = vals["phi_xy"][i * B:(i + 1) * B]

            def scaled(fn):
                return handlers.scale(handlers.substitute(fn, data=v),
                                      scale_factor=float(MB_BLOCKS),
                                      site_filter=LOCAL_SITES.__contains__)

            total += float(Trace_ELBO().loss(0, scaled(mp.model_fn),
                                             scaled(mp.guide_fn), blk))
        fwd = _kernel_name(data, grad=False)
        launched = K_.LAUNCHES[fwd]
    del blocks
    torch.cuda.empty_cache()
    mean = total / MB_BLOCKS
    rel = abs(mean - full) / abs(full)
    print(f"{tag} {stage} block objective: mean of {MB_BLOCKS} scaled "
          f"block losses {mean:.9g} vs full batch {full:.9g}, rel {rel:.2e} "
          f"(gate 1e-5), {launched} {fwd} launches ({MB_BLOCKS} blocks of "
          f"{B} cells and the full batch)")
    check(rel < 1e-5, f"{tag} {stage} block objective rel {rel}")
    check(launched == MB_BLOCKS + 1, f"{tag} {launched} {fwd} launches")
    return rel


def _copy_overlap(torch, fn):
    """Run ``fn`` under torch.profiler: (its result, host-to-device copy
    device ms in all, the share of it that overlaps kernels of the other
    stream, copies counted, device busy share of the kernels over the
    wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append(iv)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(iv)
    merged = []
    for a, b in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    copy_us = sum(b - a for a, b in copies)
    over = sum(max(0.0, min(b, mb) - max(a, ma))
               for a, b in copies for ma, mb in merged)
    busy = sum(b - a for a, b in merged) / 1e6 / wall
    return (out, copy_us / 1e3, (over / copy_us if copy_us else None),
            len(copies), busy)


def minibatch_phase_stage(torch, seed, card, mp, device="cuda",
                          tag="[minibatch]"):
    """[minibatch] on stage 1's preprocessed full-width data: the block
    objective (gate rel 1e-5); the on-device `fit`, MB_EPOCHS epochs of
    MB_BLOCKS blocks (falling epoch-mean losses, exactly one phase_fwdgrad
    per step, each over B = Nc / MB_BLOCKS cells); `fit_streamed` for one
    epoch from pinned host int16 blocks against `fit(shuffle=False)` for one
    epoch (losses and params rtol 1e-6), the device memory it needs (its
    peak above what was resident before it) below what full-batch SVI
    steps need (the data on the card and their peak above it); steps/s, launches per step, the device busy share
    and the copies' overlap with compute under torch.profiler, each launch
    counted under the kernel its data routes to (`_kernel_name`: on the wide
    body for [wide] (f)'s batch-corrected data).  ``tag`` heads its
    lines."""
    import numpy as np

    from velocycle_tpu_torch.infer import (
        SVI, MinibatchSVI, Trace_ELBO, clipped_adam, init_template,
        iter_host_blocks, split_cells,
    )
    from velocycle_tpu_torch.ops import nb_kernels as K_

    t0 = time.perf_counter()
    data = mp.data
    out = {"phase_block_objective_rel": _block_objective(torch, seed, mp,
                                                         "phase", tag)}
    grad, fwd = _kernel_name(data), _kernel_name(data, grad=False)
    B = data.Nc // MB_BLOCKS
    steps = MB_EPOCHS * MB_BLOCKS

    # the full-batch reference: SVI steps alone (no posterior draws)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svi = SVI(mp.model_fn, mp.guide_fn, clipped_adam(), Trace_ELBO())
    svi.run(seed, MB_FULL_STEPS, data)
    torch.cuda.synchronize()
    full_peak = torch.cuda.max_memory_allocated() - base
    del svi
    torch.cuda.empty_cache()
    from velocycle_tpu_torch.models.metapars import PHASE_TENSOR_FIELDS

    data_bytes = sum(t.numel() * t.element_size()
                     for t in (getattr(data, f) for f in PHASE_TENSOR_FIELDS)
                     if isinstance(t, torch.Tensor) and t.is_cuda)
    full_need = data_bytes + full_peak
    print(f"{tag} full-batch SVI, {MB_FULL_STEPS} steps incl. init: "
          f"peak device memory above the resident data "
          f"{full_peak / 2**30:.3f} GiB; with the data it needs resident "
          f"({data_bytes / 2**30:.3f} GiB) {full_need / 2**30:.3f} GiB")

    # the on-device fit
    mb = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=MB_BLOCKS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    t1 = time.perf_counter()
    state, losses = mb.fit(seed, data, num_epochs=MB_EPOCHS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    fit_peak = torch.cuda.max_memory_allocated() - base
    launched = dict(K_.LAUNCH_CHAINS[grad])
    means = losses.reshape(MB_EPOCHS, MB_BLOCKS).mean(1)
    print(f"{tag} fit: {steps} steps ({MB_EPOCHS} epochs of "
          f"{MB_BLOCKS} blocks of {B} cells) in {dt:.2f} s incl. init and the "
          f"split, epoch-mean losses {', '.join(f'{m:.6g}' for m in means)}; "
          f"{grad} launches by chain count {launched}; peak device "
          f"memory above the resident data {fit_peak / 2**30:.3f} GiB")
    check(np.isfinite(losses).all() and bool((np.diff(means) < 0).all()),
          f"{tag} epoch-mean losses {means}")
    check(launched == {1: steps} and K_.LAUNCHES[fwd] == 0,
          f"{tag} {launched} {grad} launches in {steps} steps")
    # steady state: one epoch of block steps (host clock), then its profile
    blocks = split_cells(data, MB_BLOCKS)

    def epoch():
        nonlocal state
        for i in range(MB_BLOCKS):
            state, loss = mb.update_block(state, i, blocks[i])
        return loss

    epoch()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    epoch().cpu()
    ms = (time.perf_counter() - t1) / MB_BLOCKS * 1e3
    K_.reset_launch_counts()
    busy = _device_profile(torch, lambda: epoch().cpu(), "minibatch",
                           MB_BLOCKS, "step")
    per_step = K_.LAUNCHES[grad] / MB_BLOCKS
    print(f"{tag} steady state: {1e3 / ms:.2f} steps/s ({ms:.2f} ms "
          f"per step, host clock, {MB_BLOCKS} steps), {per_step:.0f} "
          f"{grad} per step, on {card}")
    del blocks, state, mb
    torch.cuda.empty_cache()

    # the streamed fit against fit(shuffle=False), one epoch each
    S = data.S.cpu().numpy()
    cf = data.count_factor.cpu().numpy()
    pp = data.phixy_prior.cpu().numpy()
    Db = data.Db.cpu().numpy()

    def factory():
        return iter_host_blocks(S, cf, pp, data, MB_BLOCKS, Db=Db)

    t1 = time.perf_counter()
    for _ in factory():     # the host's share: slices and lgamma sums
        pass
    prep_ms = (time.perf_counter() - t1) / MB_BLOCKS * 1e3
    ref = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=MB_BLOCKS)
    s_ref, l_ref = ref.fit(seed + 1, data, num_epochs=1, shuffle=False)
    first = next(iter(factory()))[1]
    tmpl = init_template(first, data.Nc, pp, count_factor=cf, Db=Db)
    check(tmpl.S.untyped_storage().nbytes() <= 4,
          f"{tag} the template holds counts")
    st = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=MB_BLOCKS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    t1 = time.perf_counter()
    (s_st, l_st), copy_ms, overlap, n_copies, sbusy = _copy_overlap(
        torch, lambda: st.fit_streamed(seed + 1, tmpl, factory, num_epochs=1))
    dts = time.perf_counter() - t1
    st_peak = torch.cuda.max_memory_allocated() - base
    l_rel = float(np.abs(l_st - l_ref).max() / np.abs(l_ref).max())
    pr, ps = ref.get_params(s_ref), st.get_params(s_st)
    p_rel = max(float(((pr[k] - ps[k]).abs() / (pr[k].abs() + 1e-30)).max())
                for k in pr)
    print(f"{tag} fit_streamed, 1 epoch from pinned host int16 blocks "
          f"({S.nbytes / MB_BLOCKS / 2**20:.1f} MiB of counts each), under "
          f"torch.profiler: {dts:.2f} s incl. init and the host blocks ({prep_ms:.1f} ms each to slice "
          f"and sum lgamma in float64, scipy); against fit(shuffle=False): "
          f"losses rel {l_rel:.2e}, params rel {p_rel:.2e} (gate 1e-6); "
          f"{K_.LAUNCHES[grad]} {grad} launches; peak "
          f"device memory above the resident data {st_peak / 2**30:.3f} GiB, "
          f"all it needs (full-batch SVI steps need {full_need / 2**30:.3f} "
          f"GiB: the data {data_bytes / 2**30:.3f} and "
          f"{full_peak / 2**30:.3f} above it; the on-device minibatch fit "
          f"the data and {fit_peak / 2**30:.3f} above it, the split's copy "
          f"of every cell field included)")
    check(l_rel < 1e-6 and p_rel < 1e-6,
          f"{tag} streamed vs on-device: losses {l_rel}, params {p_rel}")
    check(K_.LAUNCHES[grad] == MB_BLOCKS,
          f"{tag} streamed launches")
    check(st_peak < full_need, f"{tag} streamed peak {st_peak} >= "
          f"full-batch SVI steps' need {full_need}")
    print(f"{tag} the streamed epoch's trace: {n_copies} "
          f"host-to-device copies, {copy_ms / MB_BLOCKS:.3f} ms of copy per "
          f"block, "
          + ("overlap not measured (no copy in the trace)" if overlap is None
             else f"{overlap:.1%} of it overlapping kernels")
          + f"; kernels busy {sbusy:.1%} of the wall, on {card}")
    del S, s_ref, s_st, ref, st, tmpl
    torch.cuda.empty_cache()
    print(f"{tag} in all: {time.perf_counter() - t0:.1f} s")
    out.update(steps_per_s=1e3 / ms, ms_per_step=ms,
               launches_per_step=per_step, busy=busy,
               fit_peak_gib=fit_peak / 2**30,
               streamed_peak_gib=st_peak / 2**30,
               full_batch_peak_gib=full_peak / 2**30,
               full_batch_need_gib=full_need / 2**30,
               copy_ms_per_block=copy_ms / MB_BLOCKS, copy_overlap=overlap,
               host_block_ms=prep_ms, streamed_epoch_s=dts,
               streamed_vs_fit_rel=max(l_rel, p_rel))
    return out


def minibatch_alone(torch, seed, card):
    """``--minibatch``: the [main] draw preprocessed for both stages (stage 2
    on stage 1's priors: no fit), then [minibatch] on them."""
    from velocycle_tpu_torch import (
        AngularSpeed, Cycle, Phases, preprocess_for_phase_estimation,
        preprocess_for_velocity_estimation,
    )

    adata, genes, cells, angles = _make_adata(torch, seed, "cuda")
    cycle = Cycle.trivial_prior(genes, harmonics=H)
    phases = Phases.from_angles(angles, concentration=1.0, cell_names=cells)
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=H, with_delta_nu=False,
        use_fused_nb=True, device="cuda")
    out = minibatch_phase_stage(torch, seed, card, mp)
    del mp
    torch.cuda.empty_cache()
    speed = AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2, stds=0.5)
    vmp = preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=H, omega_n_harmonics=1,
        with_delta_nu=False, model_type="lrmn", use_fused_nb=True,
        device="cuda")
    out["velocity_block_objective_rel"] = _block_objective(torch, seed, vmp,
                                                           "velocity")
    return out


# ---------------------------------------------------------------------------
# [tiles]: the layout ladder tool (tools/kernel_ladder.py's port)
# ---------------------------------------------------------------------------

# the package's layout of each family and one other (more cells per
# thread, the open lever), int16; ``--tiles`` sweeps three layouts of each
# at both count types
TILES_DEFAULT = {"phase": ["16x256xi16", "16x512xi16"],
                 "velo": ["8x256xi16", "8x512xi16"]}
TILES_SWEEP = {kind: [f"{lay}x{dt}" for lay in lays for dt in ("i16", "f32")]
               for kind, lays in (("phase", ("16x256", "32x256", "16x512")),
                                  ("velo", ("8x256", "16x256", "8x512")))}


def start_tiles(layouts):
    """Start building the copies of every non-package layout of
    ``layouts``, at niceness 19: they take the host's cores only where the
    package's own build (and what follows it) leaves them idle."""
    from velocycle_tpu_torch.tools import kernel_ladder as KL

    return KL.start_builds([(kind, KL.parse_layout(kind, n))
                            for kind, names in layouts.items()
                            for n in names], nice=19)


def phase_tiles(torch, card, layouts, pending):
    """[tiles]: `kernel_ladder.run_sweep` of each family: ms per step of the
    fused call's loss and every gradient at each layout, each layout's loss
    against the package layout's (rel 1e-5); the package layout runs in this
    process, through phase_fwdgrad / velo_fwdgrad (counted: two loops of 25
    steps per row), the others in their copies."""
    from velocycle_tpu_torch.ops import nb_kernels as K_
    from velocycle_tpu_torch.tools import kernel_ladder as KL

    t0 = time.perf_counter()
    out = {}
    for kind, names in layouts.items():
        kernel = "phase_fwdgrad" if kind == "phase" else "velo_fwdgrad"
        K_.reset_launch_counts()
        rows = KL.run_sweep(kind, names, pending={
            k: v for k, v in pending.items() if k[0] == kind})
        here = sum(r["copy"] is None for r in rows)
        for row in rows:
            print(f"[tiles] {KL.format_row(row)}, on {card}")
            check(math.isfinite(row["ms"]) and row["ms"] > 0
                  and row["rel_to_package"] < KL.LOSS_RTOL,
                  f"[tiles] {kind} {row['layout']}: {row}")
        check(K_.LAUNCHES[kernel] == 2 * 25 * here
              and sum(K_.LAUNCHES.values()) == K_.LAUNCHES[kernel],
              f"[tiles] {kind}: launches {K_.LAUNCHES} for {here} rows in "
              "this process")
        print(f"[tiles] {kind}: {K_.LAUNCHES[kernel]} {kernel} launches in "
              f"this process ({here} package-layout rows x 2 loops x 25)")
        out[kind] = {r["layout"]: r["ms"] for r in rows}
    print(f"[tiles] in all: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [sharded]: parallel/ on the card, the cell-sharded SVI step, the chain-
# and particle-sharded samplers, example 05
# ---------------------------------------------------------------------------

SHARDED_STEPS = 50
# the JAX package's two trajectory gates (steps, rtol): the first 20 steps
# at 2e-4 (tests/test_distributed.py:255), all at 2e-3
# (tests/test_sharding.py:105)
SHARDED_GATES = ((20, 2e-4), (SHARDED_STEPS, 2e-3))
SHARDED_WORLD = 2       # ranks sharing the one card, over gloo
# (c): [mcmc] (a)'s and [smc] (a)'s shapes at two ranks, NUTS cut in draws
SHARDED_MCMC = dict(MCMC_A, warmup=100, samples=80)


def _stage_pair(stage, cond=None):
    """(model, guide) of a stage's SVI as the fit classes build them:
    stage 2 conditioned on ``cond`` (the guide hides those sites)."""
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.models.phase import phase_guide, phase_model
    from velocycle_tpu_torch.models.velocity import (
        velocity_guide_lrmn, velocity_model,
    )

    if stage == "phase":
        return phase_model, phase_guide
    return (handlers.condition(velocity_model, data=cond),
            handlers.block(velocity_guide_lrmn, hide=list(cond)))


def _host_template(data):
    """``data`` without its count matrices, every other tensor on the host:
    what a rank of (b) builds its shard around (the counts it draws)."""
    from velocycle_tpu_torch.parallel.sharding import _tensor_fields

    small = data.replace(**{f: None for f in ("S", "U", "logS", "logU")
                            if hasattr(data, f)})
    return small.replace(**{f: getattr(small, f).cpu()
                            for f in _tensor_fields(small)
                            if getattr(small, f) is not None})


def _count_sums(torch, data):
    """Each rank's share of the count sums (int64) of S (and U): (b)'s ranks
    check that they drew the counts (a) ran on."""
    from velocycle_tpu_torch.parallel import distributed

    out = {}
    for f in ("S", "U"):
        t = getattr(data, f, None)
        if t is not None:
            out[f] = [int(t[:, lo:hi].sum(dtype=torch.int64)) for lo, hi in (
                distributed.process_cell_slice(data.Nc, r, SHARDED_WORLD)
                for r in range(SHARDED_WORLD))]
    return out


def _digest(torch, tensors):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def sharded_one_rank(torch, seed, card, data, stage, cond=None,
                     steps=SHARDED_STEPS, tag="[sharded] (a)"):
    """[sharded] (a) on this process's full-width data of ``stage``: one
    rank over NCCL (a world of one over an in-memory store, destroyed
    before this returns, so that no later phase runs beside it).  50
    `SVI.update` steps, then 50 sharded steps of `SVI.init_sharded`'s
    state from the same seed: the losses, every param and both Adam
    moments bit for bit, exactly 50 launches of the kernel the data routes
    to (`_kernel_name`) and no other.  ``steps``: each run's steps; ``tag``
    heads its line.
    Returns the sharded losses ((b)'s reference) and the numbers."""
    import numpy as np
    import torch.distributed as dist

    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.parallel import (
        make_mesh, shard_phase_data, shard_velocity_data,
    )

    t0 = time.perf_counter()
    kernel = _kernel_name(data)
    if stage == "velocity":
        data = data.replace(disp_grad=False)    # shape_inv conditioned
        cond = {k: torch.as_tensor(v, dtype=torch.float32, device=data.device)
                for k, v in cond.items()}
    model, guide = _stage_pair(stage, cond)
    mesh = make_mesh(("cells",))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"(a): {dist.get_backend()} world of {dist.get_world_size()}")
        sdata = (shard_velocity_data if stage == "velocity"
                 else shard_phase_data)(data, mesh)
        check(sdata.S.data_ptr() == data.S.data_ptr() and sdata.Nc == data.Nc,
              "(a): one rank's shard copied the counts")
        runs = {}
        for mode in ("update", "sharded"):
            svi = SVI(model, guide, clipped_adam(), Trace_ELBO())
            state = (svi.init(seed, data) if mode == "update"
                     else svi.init_sharded(seed, mesh, sdata))
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, losses = svi.update_chunk(
                state, steps, data if mode == "update" else sdata)
            losses = losses.cpu()
            dt = time.perf_counter() - t1
            runs[mode] = (state, losses, dict(K.LAUNCHES), dt)
    finally:
        dist.destroy_process_group()
    ref, ref_l, ref_k, ref_dt = runs["update"]
    st, l, k, dt = runs["sharded"]
    check(k[kernel] == steps and sum(k.values()) == steps,
          f"{tag} {stage}: launches {k} in {steps} sharded steps")
    check(ref_k == k, f"{tag} {stage}: launches {ref_k} unsharded, {k} sharded")
    same = torch.equal(l, ref_l) and all(
        torch.equal(st.params[n], ref.params[n])
        and torch.equal(st.opt_state["m"][n], ref.opt_state["m"][n])
        and torch.equal(st.opt_state["v"][n], ref.opt_state["v"][n])
        for n in ref.params)
    print(f"{tag} {stage}: one rank over NCCL, {steps} "
          f"sharded steps bit-equal to SVI.update's: {same} (losses "
          f"{float(l[0]):.8g} -> {float(l[-1]):.8g}); {k[kernel]} {kernel} "
          f"launches; {steps / dt:.2f} steps/s sharded, "
          f"{steps / ref_dt:.2f} unsharded (host clock, one chunk); "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    check(same, f"{tag} {stage}: the sharded step is not SVI.update's bits")
    check(np.isfinite(l.numpy()).all() and float(l[-10:].mean()) < float(l[0]),
          f"{tag} {stage}: losses {l}")
    return l.numpy(), {"kernel": kernel, "launches": k[kernel],
                       "bit_equal": same,
                       "steps_per_s": steps / dt,
                       "unsharded_steps_per_s": steps / ref_dt}


def _rank_profile(torch, fn, n):
    """(wall s, device-busy share, ms per unit in collectives) of ``n``
    units of ``fn()`` under torch.profiler: device kernel time summed; the
    collectives are the profiler's all-reduce events (the outermost of
    them), on the host's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = coll = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dt = getattr(e, "self_device_time_total", None)
            busy += (e.self_cuda_time_total if dt is None else dt) / 1e6
        elif "allreduce" in e.key.replace("_", "").lower():
            coll = max(coll, e.cpu_time_total / 1e3)
    return wall, (busy / wall if busy else None), coll / n


def _rank_stage(torch, svi, state, data, kernel, steps, tag):
    """A rank's ``steps`` sharded steps, counted and timed (host clock,
    after a barrier), then 5 more under the profiler: its numbers."""
    import torch.distributed as dist

    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.parallel.sharding import PARAM_CELL_AXES

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    state, losses = svi.update_chunk(state, steps, data)
    losses = losses.cpu().numpy()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rep = {n: p for n, p in state.params.items() if n not in PARAM_CELL_AXES}
    moments = {f"{m}:{n}": state.opt_state[m][n] for m in ("m", "v")
               for n in rep}
    holder = [state]

    def more():
        holder[0], _ = svi.update_chunk(holder[0], 5, data)

    wall, busy, coll = _rank_profile(torch, more, 5)
    return {"losses": losses, "kernel": kernel, "launches": launches[kernel],
            "other_launches": sum(launches.values()) - launches[kernel],
            "steps_per_s": steps / dt, "busy": busy, "coll_ms": coll,
            "profiled_ms_per_step": wall / 5 * 1e3,
            "peak_gib": peak / 2**30, "replicated": _digest(torch, rep),
            "moments": _digest(torch, moments), "tag": tag}


def _sharded_rank(p):
    """One rank of [sharded] (b): draw the [main] counts on the card from
    the seed, keep its cells (`shard_phase_data` / `shard_velocity_data`
    around the host templates of (a)'s data), then stage 1's and stage 2's
    sharded steps."""
    import torch
    import torch.distributed as dist

    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
    from velocycle_tpu_torch.parallel import (
        distributed, make_mesh, shard_phase_data, shard_velocity_data,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.rank_device("cuda")
    mesh = make_mesh(("cells",))
    rank = dist.get_rank()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(p["seed"])
    Ng, Nc = p["Ng"], p["Nc"]

    def counts(mean):          # _make_adata's draws, (genes, cells)
        return torch.floor(torch.exp(
            torch.randn((Nc, Ng), generator=g, device=dev) * 0.8 + mean
        )).to(torch.int16).T

    def local_logs(data):      # the fused path reads no log counts
        return {f"log{f}": torch.log(getattr(data, f).float() + 1.0 + 1e-16)
                for f in ("S", "U") if hasattr(data, f)}

    spliced = counts(1.0)
    torch.rand(Nc, generator=g, device=dev)           # the phases' draw
    unspliced = counts(0.4)
    none = torch.zeros((), device=dev).expand(Ng, Nc)
    out = {}
    for stage, tmpl in (("phase", p["tmpl1"]), ("velocity", p["tmpl2"])):
        full = dict(S=spliced, logS=none)
        if stage == "velocity":
            full.update(U=unspliced, logU=none)
        data = (shard_velocity_data if stage == "velocity"
                else shard_phase_data)(tmpl.replace(**full), mesh)
        data = data.replace(**local_logs(data))
        if stage == "velocity":
            # as (a): shape_inv is conditioned
            data = data.replace(disp_grad=False)
        for f, sums in p["sums"][stage].items():
            got = int(getattr(data, f).sum(dtype=torch.int64))
            check(got == sums[rank], f"(b) rank {rank}: {f} sums to {got}, "
                  f"(a)'s cells {sums[rank]}")
        cond = None
        if stage == "velocity":
            lo, hi = data.shard.lo, data.shard.hi
            cond = {k: torch.as_tensor(v[lo:hi] if k == "phi_xy" else v,
                                       dtype=torch.float32, device=dev)
                    for k, v in p["cond"].items()}
        model, guide = _stage_pair(stage, cond)
        svi = SVI(model, guide, clipped_adam(), Trace_ELBO())
        state = svi.init_sharded(p["seed"], mesh, data)
        prep = time.perf_counter() - t0
        out[stage] = _rank_stage(torch, svi, state, data, _kernel_name(data),
                                 p["steps"],
                                 f"rank {rank} cells [{data.shard.lo}, "
                                 f"{data.shard.hi})")
        out[stage]["prep_s"] = prep
        del data, state, svi
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return out


def _sharded_samplers_rank(p):
    """One rank of [sharded] (c): [mcmc] (a) with its chains split, then
    [smc] (a) and (c) with their particles split; what they print comes
    back with their numbers."""
    import contextlib
    import io

    import torch

    from velocycle_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            t0 = time.perf_counter()
            out["mcmc"] = mcmc_wrapped(
                torch, p["seed"], p["card"], cfg=SHARDED_MCMC,
                mesh=make_mesh(("chains",)))
            out["mcmc"]["run_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mp = _smc_data(torch, SMC_A, p["seed"], "cuda")
            out["smc"] = smc_run(
                torch, p["seed"], p["card"], "(a) smc", SMC_A, mp,
                SMC_A["svi_steps"], SMC_A["max_stages"],
                SMC_A["target_ess"], p["seed"] + 3,
                mesh=make_mesh(("particles",)))[1]
            out["smc"]["run_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, vmp = _velo_sim(torch, VELO_SMC, p["seed"], "cuda")
            out["smc_velo"] = smc_run(
                torch, p["seed"], p["card"], "(c) velocity smc", VELO_SMC,
                vmp, VELO_SMC["svi_steps"], VELO_SMC["max_stages"],
                VELO_SMC["target_ess"], p["seed"] + 5,
                mesh=make_mesh(("particles",)))[1]
            out["smc_velo"]["run_s"] = time.perf_counter() - t0
    except BaseException:
        print(text.getvalue(), file=sys.stderr)
        raise
    out["text"] = text.getvalue()
    return out


def _start_example_05():
    """Example 05 at its smoke size over two ranks sharing the card (gloo),
    through its command line, in a process of its own: (process, start)."""
    import os
    from pathlib import Path

    import velocycle_tpu_torch

    path = Path(velocycle_tpu_torch.__file__).parent / "examples" / \
        "05_sharded_fit.py"
    env = dict(os.environ, VCT_SMOKE="1")
    env.pop("VCT_FIGDIR", None)
    proc = subprocess.Popen(
        [sys.executable, str(path), "--device", "cuda", "--world", "2",
         "--backend", "gloo"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _finish_example_05(proc, start, timeout=600):
    """(exit code, stdout, the end of stderr, wall s); the process is
    stopped in every case."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        _stop(proc)
    return proc.returncode, out, err[-3000:], time.perf_counter() - start


def _gate_b(ranks, ref, card, gates=SHARDED_GATES, tag="[sharded] (b)"):
    """[sharded] (b)'s gates on the ranks' results: the losses against
    (a)'s within the JAX package's two gates (``gates``: (steps, rtol)
    pairs), every rank's losses, replicated params and Adam moments
    bit-identical, exactly one launch of the stage's kernel (the one its
    data routes to) per rank per step; prints per rank steps/s, busy share, peak memory
    and the ms per step in collectives."""
    import numpy as np

    out = {}
    for stage in ("phase", "velocity"):
        one = ref["losses"][stage]
        steps = len(one)
        r0 = ranks[0][stage]
        rel = np.abs(r0["losses"] - one) / np.abs(one)
        for r in ranks:
            x = r[stage]
            busy = "not measured" if x["busy"] is None else f"{x['busy']:.1%}"
            print(f"{tag} {stage} {x['tag']}: {x['steps_per_s']:.2f} "
                  f"steps/s (host clock, two ranks on one card), busy {busy}, "
                  f"{x['coll_ms']:.3f} ms per step in all-reduce (profiler, "
                  f"{x['profiled_ms_per_step']:.2f} ms per profiled step), "
                  f"peak {x['peak_gib']:.2f} GiB, {x['launches']} {x['kernel']} "
                  f"launches, shard built in {x['prep_s']:.1f} s on {card}")
            check(x["launches"] == steps and x["other_launches"] == 0,
                  f"{tag} {stage} {x['tag']}: {x['launches']} {x['kernel']} and "
                  f"{x['other_launches']} other launches in {steps} steps")
            check(np.array_equal(x["losses"], r0["losses"])
                  and x["replicated"] == r0["replicated"]
                  and x["moments"] == r0["moments"],
                  f"{tag} {stage}: the ranks' losses or replicated params "
                  "differ")
        print(f"{tag} {stage}: losses {r0['losses'][0]:.8g} -> "
              f"{r0['losses'][-1]:.8g}, against one rank max rel "
              + ", ".join(f"{rel[:n].max():.3g} (steps 1-{n}, gate {rtol:g})"
                          for n, rtol in gates)
              + f"; replicated params {r0['replicated']}, moments "
              f"{r0['moments']} on both ranks")
        for n, rtol in gates:
            check(rel[:n].max() < rtol, f"{tag} {stage}: rel "
                  f"{rel[:n].max()} over steps 1-{n} (gate {rtol})")
        out[stage] = {f"max_rel_{n}": float(rel[:n].max()) for n, _ in gates}
        out[stage].update({
            "ranks": [{k: v for k, v in r[stage].items()
                       if k not in ("losses", "tag")} for r in ranks]})
    return out


def _gate_cd(torch, ranks, example, seed, card, smc_refs):
    """[sharded] (c) and (d)'s gates: the runs' own gates held inside them
    on every rank (R-hat < 1.05, accept, the circular correlation; beta
    reaching 1, finite log Z; one launch of a rank's chains or particles
    per batched evaluation), the same R-hat and log Z on both ranks,
    |delta log Z| < 2 against the one-rank [smc] (a) and (c) (``smc_refs``
    {"a": log Z, "c": log Z}; run here when not given); example 05 exits 0
    with its four lines (``example``: `_finish_example_05`'s)."""
    for r, res in enumerate(ranks):
        for line in res["text"].splitlines():
            print(f"[sharded] (c) rank {r} | {line}")
    m0 = ranks[0]["mcmc"]
    check(all(r["mcmc"]["max_split_rhat"] == m0["max_split_rhat"]
              for r in ranks), "(c): the ranks' R-hat differ")
    print(f"[sharded] (c) NUTS at two ranks, {SHARDED_MCMC['chains']} chains "
          f"x ({SHARDED_MCMC['warmup']} + {SHARDED_MCMC['samples']}): accept "
          f"{m0['accept']:.4f}, max split R-hat {m0['max_split_rhat']:.4f}, "
          f"run {m0['run_s']:.1f} s per rank on {card}")
    refs = dict(smc_refs or {})
    smc = {}
    for tag, key, cfg, kind, run_seed in (
            ("a", "smc", SMC_A, "phase", seed + 3),
            ("c", "smc_velo", VELO_SMC, "velo", seed + 5)):
        s0 = ranks[0][key]
        check(all(r[key]["log_evidence"] == s0["log_evidence"]
                  for r in ranks), f"(c) [smc] ({tag}): the ranks' log Z "
              "differ")
        if tag not in refs:
            mp = (_smc_data(torch, cfg, seed, "cuda") if kind == "phase"
                  else _velo_sim(torch, cfg, seed, "cuda")[1])
            refs[tag] = smc_run(torch, seed, card, f"({tag}) one rank", cfg,
                                mp, cfg["svi_steps"], cfg["max_stages"],
                                cfg["target_ess"],
                                run_seed)[1]["log_evidence"]
        dz = s0["log_evidence"] - refs[tag]
        print(f"[sharded] (c) [smc] ({tag}) at two ranks ({kind} model, "
              f"{cfg['chains']} particles): {s0['stages']} stages, log Z "
              f"{s0['log_evidence']:.3f} against one rank's {refs[tag]:.3f} "
              f"({dz:+.3f} nats, gate 2), {s0['run_s']:.1f} s on {card}")
        check(abs(dz) < 2.0, f"(c) [smc] ({tag}): log Z two ranks - one "
              f"rank = {dz}")
        smc[key] = {"launches": s0["launches"], "stages": s0["stages"],
                    "log_evidence": s0["log_evidence"], "dlogZ": dz,
                    "run_s": s0["run_s"]}
    rc, out_ex, err_ex, dt_ex = example
    print(f"[sharded] (d) example 05 (smoke size, --world 2 --backend gloo), "
          f"beside (c): exit {rc} in {dt_ex:.1f} s")
    for line in out_ex.strip().splitlines():
        print(f"[sharded] (d)   | {line}")
    if rc != 0:
        print(err_ex, file=sys.stderr)
    check(rc == 0, f"(d): example 05 exited {rc}")
    for want in ("2-rank mesh: ELBO", "S sharding: cells", "sharded NUTS: 2",
                 "sharded SMC: "):
        check(want in out_ex, f"(d): example 05 printed no {want!r}")
    return {"mcmc": {k: m0[k] for k in ("launches", "evals", "accept",
                                        "max_split_rhat", "run_s")},
            **smc, "example_05_s": dt_ex}


def sharded_stage_refs(torch, seed, card, stage, data, cond=None, ref=None,
                       **one_rank):
    """(a) for ``stage`` inside [main]'s stages, and what (b) takes from it:
    the host template, the count sums, the losses; ``ref`` collects them.
    ``one_rank``: `sharded_one_rank`'s steps and tag."""
    ref = ref if ref is not None else {"losses": {}, "sums": {}, "a": {}}
    losses, nums = sharded_one_rank(torch, seed, card, data, stage, cond,
                                    **one_rank)
    ref["losses"][stage] = losses
    ref["a"][stage] = nums
    ref["sums"][stage] = _count_sums(torch, data)
    ref["tmpl1" if stage == "phase" else "tmpl2"] = _host_template(data)
    if stage == "velocity":
        ref["cond"] = {k: (v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else v)
                       for k, v in cond.items()}
    return ref


def sharded_row(kernel, sharded):
    """A kernel's [sharded] numbers for the JSON table: (a) and (b) for the
    fwdgrad kernels, (c)'s launches per rank (by chain count)."""
    smc = sharded["smc" if kernel.startswith("phase") else "smc_velo"]
    row = {"smc_launches_per_rank": smc["launches"][kernel]}
    if kernel.endswith("fwdgrad"):
        stage = "phase" if kernel.startswith("phase") else "velocity"
        row.update(one_rank_nccl=sharded["a"][stage],
                   two_ranks_gloo=sharded["b"][stage])
    if kernel == "phase_fwdgrad":
        row["mcmc_launches_per_rank"] = sharded["mcmc"]["launches"]
    return row


def sharded_alone(torch, seed, card):
    """``--sharded``: [main]'s stages at full width for (a)'s data (their
    own gates), [sharded] (a)-(d), then `parallel.phase_weak_scaling` at one
    and two ranks on the card over gloo (two ranks on one card: contention,
    not scaling)."""
    from velocycle_tpu_torch.parallel import format_report, phase_weak_scaling

    adata, genes, cells, angles = _make_adata(torch, seed, "cuda")
    _, _, _, stage1 = phase_main_path(torch, seed, adata, genes, cells, angles)
    ref = sharded_stage_refs(torch, seed, card, "phase", stage1.mp.data)
    stage1.mp = None
    torch.cuda.empty_cache()
    _, _, _, vmp = velocity_main_path(torch, seed, adata, stage1)
    p = stage1.params
    cond = {"nu": p["nu_locs"], "phi_xy": p["phixy_locs"],
            "shape_inv": p["shape_inv_locs"]}
    sharded_stage_refs(torch, seed, card, "velocity", vmp.data, cond, ref)
    del adata, stage1, vmp
    torch.cuda.empty_cache()
    phase_sharded(torch, seed, card, ref)
    finish_sharded_samplers(torch, start_sharded_samplers(seed, card), seed,
                            card)
    for cells_per_rank, genes_ in ((512, 64), (25_600, 256)):
        t0 = time.perf_counter()
        rows = phase_weak_scaling(per_device_cells=cells_per_rank, Ng=genes_,
                                  steps=50, device_counts=[1, 2], repeats=3,
                                  device="cuda", backend="gloo")
        print(f"[sharded] weak scaling, {cells_per_rank} cells x {genes_} "
              f"genes per rank, gloo; two ranks on one card: contention, "
              f"not scaling ({time.perf_counter() - t0:.1f} s, {card}):")
        for line in format_report(rows).splitlines():
            print(f"[sharded]   {line}")


def phase_sharded(torch, seed, card, ref):
    """[sharded] (b), alone on the host and the card, in one spawn of two
    ranks sharing the card over gloo ((a) ran inside the stages)."""
    from velocycle_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    payload = {k: ref[k] for k in ("tmpl1", "tmpl2", "cond", "sums")}
    payload.update(seed=seed, steps=SHARDED_STEPS, Ng=ref["tmpl1"].Ng,
                   Nc=ref["tmpl1"].Nc)
    ranks = run_ranks(_sharded_rank, SHARDED_WORLD, backend="gloo",
                      device="cuda", timeout=900, args=(payload,))
    out = {"a": ref["a"], "b": _gate_b(ranks, ref, card)}
    print(f"[sharded] (b) in all, {SHARDED_WORLD} ranks spawned: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def start_sharded_samplers(seed, card):
    """Start [sharded] (c) (two ranks over gloo, `run_ranks` in a thread of
    this process) and (d) (example 05's process), to run beside the
    phase that follows; `finish_sharded_samplers` waits for both."""
    import threading

    from velocycle_tpu_torch.parallel import run_ranks

    payload = dict(seed=seed, card=card)
    pending = {"start": time.perf_counter()}

    def ranks():
        try:
            pending["ranks"] = run_ranks(
                _sharded_samplers_rank, SHARDED_WORLD, backend="gloo",
                device="cuda", timeout=1000, args=(payload,))
        except BaseException as e:       # read by finish_sharded_samplers
            pending["error"] = e

    # daemonic: if this process fails meanwhile, its exit does not wait
    # for the ranks (run_ranks' processes are daemonic too)
    pending["thread"] = threading.Thread(target=ranks, daemon=True)
    pending["thread"].start()
    pending["example"] = _start_example_05()
    return pending


def finish_sharded_samplers(torch, pending, seed, card, smc_refs=None):
    """Wait for [sharded] (c) and (d) and hold them to their gates
    (`_gate_cd`); example 05's process is stopped in every case."""
    try:
        pending["thread"].join()
        example = _finish_example_05(*pending["example"])
    finally:
        _stop(pending["example"][0])
    if "error" in pending:
        raise pending["error"]
    out = _gate_cd(torch, pending["ranks"], example, seed, card, smc_refs)
    print(f"[sharded] (c) and (d), start to gates: "
          f"{time.perf_counter() - pending['start']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [examples]: the port's examples 01-04 and 06, each in a process of its own
# ---------------------------------------------------------------------------

EXAMPLES = ("01_phase_and_velocity_one_sample.py",
            "02_two_sample_condition_contrast.py",
            "03_mcmc_and_smc_posteriors.py", "04_pancreas_1d_spline.py",
            "06_stereoseq_spatial.py")
EXAMPLE_FUSED = "06_stereoseq_spatial.py"   # the one on the fused kernels
# runs an example as its command line does, then prints its launch counts
EXAMPLE_RUNNER = """\
import json, runpy, sys
sys.path.insert(0, {dir!r})
sys.argv = [{path!r}, "--device", "cuda"]
from velocycle_tpu_torch.ops import nb_kernels as K
K.reset_launch_counts()
runpy.run_path({path!r}, run_name="__main__")
print("[launches] " + json.dumps(K.LAUNCHES))
"""


def _start_example(name, smoke):
    """Start example ``name`` in a process of its own, its output into
    files under SUPPORT_DIR (no pipe to fill while others run)."""
    import os
    from pathlib import Path

    import velocycle_tpu_torch

    path = str(Path(velocycle_tpu_torch.__file__).parent / "examples" / name)
    env = {k: v for k, v in os.environ.items()
           if k not in ("VCT_SMOKE", "VCT_FIGDIR")}
    if smoke:
        env["VCT_SMOKE"] = "1"
    code = EXAMPLE_RUNNER.format(dir=os.path.dirname(path), path=path)
    logs = Path(SUPPORT_DIR) / "examples"
    logs.mkdir(parents=True, exist_ok=True)
    with open(logs / f"{name}.out", "w") as out, \
            open(logs / f"{name}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=out, stderr=err)
    return {"proc": proc, "start": time.perf_counter(), "logs": logs}


def phase_examples(torch, card, smoke=True, timeout=600):
    """[examples]: each example in a process of its own on the card, through
    its command line: at its smoke size (``VCT_SMOKE=1``) all five at once,
    else (``--examples``) at its published size, one after the other.  Gates:
    exit code 0; example 06 launches phase_fwdgrad, the others no kernel
    (they run the plain path, as the JAX examples do).  Prints each one's
    wall time (start to exit), launches and output lines."""
    t0 = time.perf_counter()
    out, running = {}, {}
    try:
        for name in EXAMPLES:
            running[name] = _start_example(name, smoke)
            while running and (not smoke or name == EXAMPLES[-1]):
                for n, run in list(running.items()):
                    if run["proc"].poll() is not None:
                        run["wall"] = time.perf_counter() - run["start"]
                        out[n] = _finish_example(n, running.pop(n), card)
                    elif time.perf_counter() - run["start"] > timeout:
                        fail(f"[examples] {n} ran past {timeout} s")
                time.sleep(0.05)
    finally:
        for run in running.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
    for name, launches in out.items():
        if name == EXAMPLE_FUSED:
            check(launches["phase_fwdgrad"] > 0,
                  f"[examples] {name} launched no phase_fwdgrad")
        else:
            check(sum(launches.values()) == 0,
                  f"[examples] {name} launched {launches}")
    print(f"[examples] {'smoke size, all at once' if smoke else 'published sizes, in turn'}"
          f": {time.perf_counter() - t0:.1f} s")
    return out


def _finish_example(name, run, card):
    logs = run["logs"]
    lines = (logs / f"{name}.out").read_text().strip().splitlines()
    rc = run["proc"].returncode
    launches = json.loads(lines[-1][len("[launches] "):]) if (
        lines and lines[-1].startswith("[launches] ")) else None
    print(f"[examples] {name}: exit {rc} in {run['wall']:.1f} s wall, on "
          f"{card}; launches {launches}")
    for line in lines[:-1]:
        print(f"[examples]   | {line}")
    if rc != 0 or launches is None:
        print((logs / f"{name}.err").read_text()[-3000:], file=sys.stderr)
        fail(f"[examples] {name} exited {rc}")
    return launches


PLAIN_STEPS = 20        # --plain (b): SVI steps of each stage
PLAIN_CHUNK = 256       # --plain (a): genes per float64 pass
PLAIN_MAX_REL = 1e-6    # (a): max error / max |gradient|, both elements
PLAIN_MEDIAN_REL = 1e-4  # (a): median of the genes' relative errors
PLAIN_HDIAG_REL = 1e-3  # (c): median relative error of the Hessian diagonal
PLAIN_FIXED_SI = (1e-6, 1e-5, 1e-4)  # (c): fixed shape_inv of the curvature
PLAIN_WINDOWS = range(1, 17)  # (a): a in [2^n - 2, 2^n) (n = 1: a < 2)
PLAIN_NUTS = True       # (c): NUTS on both paths after the curvature
# (b): the plain step-0 losses of the parent tree (before NBLogPmf) at seed
# 0 on the NVIDIA H100 80GB HBM3, read with this script's --plain b
PLAIN_STEP0 = {"stage 1": 672579328.0, "stage 2": 1443198976.0,
               "lba": 666607168.0}


def plain_element(torch, card, data, device="cuda"):
    """--plain (a): the plain and the fused NB elements' dispersion
    gradients against float64 (`tools.nb_noise.disp_grad_error`) at full
    width on ``data``'s counts, gene dispersions spread by 1.8x around each
    of shape_inv 1e-6 .. 1e-2: the largest error over every gene below
    PLAIN_MAX_REL of the largest gradient, the median over the genes at
    most PLAIN_MEDIAN_REL (the largest over the genes whose y = a + 2 is
    exact in float32 printed beside it).  Each worst gene is named with its
    a = 1/r and y - a - 2 (`ops.special.y_shift`); for the fused element,
    the kernel and its plain version on that gene's row alone
    (`tools.nb_noise.gene_grad_error`)."""
    from velocycle_tpu_torch.ops.special import y_shift
    from velocycle_tpu_torch.tools import nb_noise

    for path in ("plain", "fused"):
        t0 = time.perf_counter()
        res = nb_noise.disp_grad_error(device, plain=path == "plain",
                                       data=data, chunk=PLAIN_CHUNK)
        for si, (mx, med, dl, j, a, mx_exact) in res.items():
            a32 = torch.tensor([a], dtype=torch.float32)
            shift = float(y_shift(a32, a32 + 2.0)[0])
            print(f"[plain] (a) {path} element at shape_inv {si:g}, "
                  f"{data.Ng} x {data.Nc}: dispersion gradient against "
                  f"float64 {mx:.3e} of the largest (gene {j}, a {a:.7g}, "
                  f"y - a - 2 = {shift:.3e}; {mx_exact:.3e} where y is "
                  f"exact), median over genes {med:.3e}; loss {dl:+.4e} "
                  f"nats ({card})")
            if path == "fused":
                kern, twin, plain = nb_noise.gene_grad_error(device, data,
                                                             si, j)
                print(f"[plain] (a)   gene {j} alone against float64: the "
                      f"kernel {kern:.3e}, its plain version on the same "
                      f"tensors {twin:.3e}, the plain element {plain:.3e}")
            check(math.isfinite(mx) and med <= PLAIN_MEDIAN_REL
                  and mx < PLAIN_MAX_REL,
                  f"[plain] (a) {path} element at shape_inv {si:g}: "
                  f"{mx:.3e} / {med:.3e} against float64")
        print(f"[plain] (a) {path}: {time.perf_counter() - t0:.1f} s")


def _disp_grad64(torch, ref, counts, params, r, dnu, Db, chunk):
    """Each gene's dispersion gradient of ``ref`` (nb_loglik_reference or
    nbsu_loglik_reference) in float64, ``chunk`` genes a pass; ``params``
    in the reference's order after the counts, the gene-indexed ones
    (first dimension NG) cut with the genes."""
    out = []
    for i in range(0, r.shape[0], chunk):
        p = slice(i, i + chunk)
        cut = [x[p] if x.shape[0] == NG else x for x in params]
        r64 = r[p].double().requires_grad_(True)
        extra = () if dnu is None else (dnu[:, p].double(), Db.double())
        loss = ref(*[c[p].double() for c in counts],
                   *[x.double() for x in cut], r64, *extra)
        out.append(torch.autograd.grad(loss, r64)[0])
    return torch.cat(out)


def plain_windows(torch, card, seed, device="cuda"):
    """--plain (a), the rounded y = a + 2 (csrc/nb_common.cuh y_shift) at
    full width on [main]'s counts (make_inputs, make_velo_inputs): every
    gene's a = 1/r drawn where y = a + 2 rounds in float32, an equal share
    in each window of PLAIN_WINDOWS ([2^n - 2, 2^n); n = 1: a < 2; a window
    where no float32 r gives one is named and skipped).  The dispersion
    gradients of phase_fwdgrad and velo_fwdgrad, narrow (Nh 5) and wide (Nh
    5 + WIDE_BATCHES batches), and of the plain element (the models'
    NegativeBinomial log-prob, [main]'s phase log-means), each against
    float64 (`_disp_grad64`): the largest error below PLAIN_MAX_REL of the
    largest gradient, the worst gene named with its a and delta."""
    import numpy as np

    from velocycle_tpu_torch.core import distributions as dist
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.ops.special import y_shift
    from velocycle_tpu_torch.tools import nb_noise

    t0 = time.perf_counter()
    windows = []
    for n in PLAIN_WINDOWS:
        try:
            nb_noise.window_a([n], 1, True)
            windows.append(n)
        except ValueError:
            print(f"[plain] (a) window n = {n}: no float32 r gives an a = 1/r "
                  f"in [{2.0 ** n - 2:g}, {2.0 ** n:g}) whose y = a + 2 "
                  f"rounds (those a lie on even multiples of a's spacing)")
    per = -(-NG // len(windows))
    rows = dict(zip(windows, nb_noise.window_a(windows, per, True, seed)))
    # the windows interleaved along the genes, so each chunk holds them all
    a = np.stack(list(rows.values()), 1).ravel()[:NG]
    a_t = torch.as_tensor(a, device=device)
    r = 1.0 / a_t
    delta = y_shift(1.0 / r, 1.0 / r + 2.0)
    check(bool((delta != 0.0).all()) and torch.equal(1.0 / r, a_t),
          "[plain] (a) windows: every gene's y = a + 2 rounds")
    print(f"[plain] (a) windows: {NG} genes, a in windows {windows} (n = 1: "
          f"a < 2), up to {per} each, every y = a + 2 rounded "
          f"(|y - a - 2| {float(delta.abs().min()):.3e} .. "
          f"{float(delta.abs().max()):.3e})")

    def gate(tag, g, g64):
        err = (g.double() - g64).abs()
        j = int(err.argmax())
        rel = float(err.max() / g64.abs().max())
        by_window = {n: float(err[torch.as_tensor(
            (a >= (0.0 if n == 1 else 2.0 ** n - 2)) & (a < 2.0 ** n),
            device=device)].max() / g64.abs().max()) for n in rows}
        print(f"[plain] (a) windows, {tag} @ {NG}x{NC}: dispersion gradient "
              f"against float64 {rel:.3e} of the largest (gene {j}, a "
              f"{a[j]:.7g}, y - a - 2 = {float(delta[j]):.3e}); by window "
              + ", ".join(f"{n}: {v:.2e}" for n, v in by_window.items())
              + f" ({card})")
        check(math.isfinite(rel) and rel < PLAIN_MAX_REL,
              f"[plain] (a) windows, {tag}: {rel:.3e} against float64")

    for Nb, tag in ((0, "narrow, 5 columns"),
                    (WIDE_BATCHES, f"wide, {NH + WIDE_BATCHES} columns")):
        S, nu, zeta, cf, _, dnu, Db = make_inputs(torch, NG, NC, seed, Nb=Nb,
                                                  device=device)
        lgk = lgamma_k_sum(torch, S)
        g = K.phase_fwdgrad(S, nu, zeta, cf, r, dnu, Db, lgk,
                            want_disp=True)[1][3]
        g64 = _disp_grad64(torch, K.nb_loglik_reference, [S],
                           [nu, zeta, cf], r, dnu, Db, PLAIN_CHUNK)
        gate(f"phase_fwdgrad {tag}", g, g64)
        if not Nb:      # the plain element on the same log-means
            gp = []
            for i in range(0, NG, PLAIN_CHUNK):
                p = slice(i, i + PLAIN_CHUNK)
                rp = r[p].clone().requires_grad_(True)
                elog = nu[p] @ zeta.T + cf
                lp = dist.NegativeBinomial(
                    mean=torch.exp(elog), dispersion=rp[:, None]).log_prob(
                        S[p].float()).sum()
                gp.append(torch.autograd.grad(lp, rp)[0])
            gate("the plain element", torch.cat(gp), g64)
        del S, nu, zeta, cf, dnu, Db, g, g64
        v = make_velo_inputs(torch, NG, NC, seed, Nb=Nb, device=device)
        (S, U, nu, zeta, zdphi, cf, omega, lb, lg, _, dnu, Db) = v
        lgk = lgamma_k_sum(torch, S, U)
        g = K.velo_fwdgrad(S, U, nu, zeta, zdphi, cf, omega, lb, lg, r, dnu,
                           Db, lgk, want_disp=True)[1][7]
        g64 = _disp_grad64(torch, K.nbsu_loglik_reference, [S, U],
                           [nu, zeta, zdphi, cf, omega, lb, lg], r, dnu, Db,
                           PLAIN_CHUNK)
        gate(f"velo_fwdgrad {tag}", g, g64)
        del v, S, U, nu, zeta, zdphi, cf, omega, lb, lg, dnu, Db, g, g64
        torch.cuda.empty_cache()
    print(f"[plain] (a) windows: {time.perf_counter() - t0:.1f} s")


def _step0(torch, fit, data, seed, tag):
    """The fit's step-0 loss, again from its initial state, and at seed 0
    against the parent tree's (PLAIN_STEP0): equal, bit for bit."""
    import numpy as np

    from velocycle_tpu_torch.core import handlers

    state = fit.svi.init(seed, data)
    key = handlers.fold_in(state.key, 1)
    with torch.no_grad():
        now = float(fit.svi.loss_fn(state.params, key, data))
    first = float(np.float32(fit.losses[0]))
    parent = PLAIN_STEP0.get(tag) if seed == 0 else None
    print(f"[plain] (b) {tag} step-0 loss {first!r}; again {now!r}; the "
          f"parent tree's {parent!r} (seed 0)")
    check(first == now and parent in (None, first),
          f"[plain] (b) {tag}: step-0 loss {first!r} / {now!r} against the "
          f"parent's {parent!r}")


def _plain_fit(torch, seed, card, fit, data, tag):
    """One stage's fit of PLAIN_STEPS steps with no kernel launched,
    losses finite and falling, the step-0 loss against the direct form;
    steps/s, busy share and peak memory.  Returns the fit."""
    import numpy as np

    from velocycle_tpu_torch.ops import nb_kernels as K

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    fit.fit(num_steps=PLAIN_STEPS, seed=seed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(not any(K.LAUNCHES.values()),
          f"[plain] (b) {tag} launched an NB kernel: {K.LAUNCHES}")
    losses = np.asarray(fit.losses)
    print(f"[plain] (b) {tag} losses: first {losses[0]:.6g}, last "
          f"{losses[-1]:.6g}, mean of last 5 {losses[-5:].mean():.6g}")
    check(losses.shape == (PLAIN_STEPS,) and np.isfinite(losses).all(),
          f"[plain] (b) {tag}: non-finite losses")
    check(losses[-5:].mean() < losses[0], f"[plain] (b) {tag}: losses did "
          "not fall")
    _step0(torch, fit, data, seed, tag)
    print(f"[plain] (b) {tag}: fit of {PLAIN_STEPS} steps incl. init, "
          f"extraction and posterior draws {fit_s:.2f} s; peak device memory "
          f"{peak / 2**30:.3f} GiB (fit); no NB kernel launched ({card})")
    _steady_state(torch, fit.svi, fit.state, data, f"plain (b) {tag}")
    return fit


def plain_fits(torch, seed, card, adata, angles, mp, device="cuda"):
    """--plain (b): the default entry points at full width: PhaseFitModel
    on ``mp`` (preprocessed with default metaparams, use_fused_nb=False),
    then LRMN VelocityFitModel conditioned on it, then the LBA PhaseFitModel
    on ``adata`` at cell phases ``angles``, PLAIN_STEPS steps each."""
    from velocycle_tpu_torch import (
        AngularSpeed, Cycle, PhaseFitModel, Phases, VelocityFitModel,
        preprocess_for_phase_estimation, preprocess_for_velocity_estimation,
    )
    from velocycle_tpu_torch.tools.nb_noise import element_costs

    print(f"[plain] (b) one NB element's (Ng, Nc) tensors saved for the "
          f"backward beside the counts and the mean, forward passes and "
          f"bytes per element, backward passes and bytes per element: "
          f"{element_costs(device)}")
    check(not mp.data.use_fused_nb and mp.data.S.dtype == torch.float32,
          "[plain] (b): the default metaparams are not the plain path")
    fit = _plain_fit(torch, seed, card, PhaseFitModel(mp, num_samples=2,
                                                      n_per_bin=2),
                     mp.data, "stage 1")
    p = fit.params
    cond = {"nu": p["nu_locs"], "phi_xy": p["phixy_locs"],
            "shape_inv": p["shape_inv_locs"]}
    speed = AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                       stds=0.5)
    t0 = time.perf_counter()
    vmp = preprocess_for_velocity_estimation(
        adata, fit.cycle_fit, fit.phase_fit, speed, n_harmonics=H,
        omega_n_harmonics=1, with_delta_nu=False, model_type="lrmn",
        device=device)
    print(f"[plain] (b) preprocess_for_velocity_estimation: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    del fit
    check(not vmp.data.use_fused_nb, "[plain] (b): stage 2 not plain")
    vfit = VelocityFitModel(vmp, condition_on=cond, num_samples=2,
                            n_per_bin=1)
    _plain_fit(torch, seed, card, vfit, vfit.metaparams.data, "stage 2")
    del vfit, vmp
    # LBA ([variants] (c)'s fit), which has no kernel and runs the element
    t0 = time.perf_counter()
    genes, cells = list(adata.var.index), list(adata.obs.index)
    lmp = preprocess_for_phase_estimation(
        adata, Cycle.trivial_prior(genes, harmonics=H),
        Phases.from_angles(angles, concentration=1.0, cell_names=cells),
        n_harmonics=H, with_delta_nu=False, gene_selection_model="lba",
        device=device)
    print(f"[plain] (b) preprocess_for_phase_estimation (lba): "
          f"{time.perf_counter() - t0:.1f} s (host)")
    _plain_fit(torch, seed, card, PhaseFitModel(lmp, num_samples=2,
                                                n_per_bin=2),
               lmp.data, "lba")


def _hdiag_line(torch, card, what, name, hd, ref, t0):
    """Print and return the median relative error of a shape_inv Hessian
    diagonal against float64's."""
    import numpy as np

    rel = np.abs(hd - ref) / np.abs(ref)
    print(f"[plain] (c) {name}, {what}: its Hessian diagonal against "
          f"float64: median rel {np.median(rel):.3e}, max {rel.max():.3e}, "
          f"finite {bool(np.isfinite(hd).all())} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    return float(np.median(rel)) if np.isfinite(hd).all() else math.inf


def plain_mcmc(torch, seed, card, device="cuda"):
    """--plain (c): [mcmc] (b)'s configuration: the shape_inv Hessian
    diagonal through the plain path (the warm start's probes) against
    float64's at the warm start and at fixed values at PLAIN_FIXED_SI, the
    direct form's beside it (`tools.nb_noise.direct_element`); then, with
    PLAIN_NUTS, MCMCFitModel on both paths (`tools.nb_noise.nuts_by_path`),
    split R-hat below MCMC_MAX_RHAT on both."""
    import numpy as np

    from velocycle_tpu_torch.tools import nb_noise

    paths = (("plain", contextlib.nullcontext),
             ("direct form", nb_noise.direct_element))
    for name, ctx in paths:
        t0 = time.perf_counter()
        with ctx():
            hd, ref, init = nb_noise.warm_start_curvature(device, seed)
        si = np.asarray(init["shape_inv"])
        med = _hdiag_line(torch, card, f"warm start, shape_inv "
                          f"{np.median(si):.3e} (median; {si.min():.3e} .. "
                          f"{si.max():.3e})", name, hd, ref, t0)
        if name == "plain":
            check(med <= PLAIN_HDIAG_REL, f"[plain] (c) warm start Hessian "
                  f"diagonal: median rel {med:.3e}")
    direct_misses = False
    for si in PLAIN_FIXED_SI:
        for name, ctx in paths:
            t0 = time.perf_counter()
            with ctx():
                hd, ref = nb_noise.fixed_point_curvature(device, si)
            med = _hdiag_line(torch, card, f"fixed at shape_inv {si:g}",
                              name, hd, ref, t0)
            if name == "plain":
                check(med <= PLAIN_HDIAG_REL, f"[plain] (c) shape_inv "
                      f"{si:g}: Hessian diagonal median rel {med:.3e}")
            else:
                direct_misses |= med > PLAIN_HDIAG_REL
    # the gate reaches the region the repair is for
    check(direct_misses, "[plain] (c) the direct form's Hessian diagonal met "
          f"the gate at every shape_inv in {PLAIN_FIXED_SI}")
    if not PLAIN_NUTS:
        return
    for name, (acc, rhat, ess, dt) in nb_noise.nuts_by_path(
            device, seed).items():
        print(f"[plain] (c) MCMCFitModel {name}: accept {acc:.4f}, max split "
              f"R-hat by site {rhat}, min ESS {ess:.1f}, {dt:.1f} s ({card})")
        check(max(rhat.values()) < MCMC_MAX_RHAT,
              f"[plain] (c) {name}: R-hat {rhat}")


def plain_alone(torch, seed, card, parts, device="cuda"):
    """``--plain``: (a) and (b) on [main]'s counts, preprocessed once with
    the default metaparams, then (c); ``parts`` picks among them."""
    t0 = time.perf_counter()
    if "a" in parts or "b" in parts:
        from velocycle_tpu_torch import (
            Cycle, Phases, preprocess_for_phase_estimation,
        )

        adata, genes, cells, angles = _make_adata(torch, seed, device)
        mp = preprocess_for_phase_estimation(
            adata, Cycle.trivial_prior(genes, harmonics=H),
            Phases.from_angles(angles, concentration=1.0, cell_names=cells),
            n_harmonics=H, with_delta_nu=False, device=device)
        print(f"[plain] preprocess_for_phase_estimation (default "
              f"metaparams): {time.perf_counter() - t0:.1f} s (host)")
        if "a" in parts:
            plain_element(torch, card, mp.data, device)
            torch.cuda.empty_cache()
            plain_windows(torch, card, seed, device)
            torch.cuda.empty_cache()
        if "b" in parts:
            plain_fits(torch, seed, card, adata, angles, mp, device)
        del mp
        torch.cuda.empty_cache()
        print(f"[plain] (a), (b): {time.perf_counter() - t0:.1f} s")
    if "c" in parts:
        t0 = time.perf_counter()
        plain_mcmc(torch, seed, card, device)
        print(f"[plain] (c): {time.perf_counter() - t0:.1f} s")


def mcmc_in_turn(torch, seed, card, device="cuda"):
    """``--mcmc``: [mcmc]'s runs one after the other in this process, with
    nothing else on the host or the card (the runs' own numbers)."""
    runs = {}
    for tag, (fn, cfg) in MCMC_RUNS.items():
        t0 = time.perf_counter()
        kw = {"ridge": True} if tag == "c" else {}
        runs[tag] = globals()[fn](torch, seed, card, cfg=cfg, device=device,
                                  **kw)
        print(f"[mcmc] run ({tag}) in all: {time.perf_counter() - t0:.1f} s "
              f"(alone, in turn)")
        torch.cuda.empty_cache()
    # (c) on the plain path: its R-hat beside the fused run's
    t0 = time.perf_counter()
    velo_plain_vs_fused(torch, seed, card, runs["c"], device)
    print(f"[mcmc] run (c) plain in all: {time.perf_counter() - t0:.1f} s "
          f"(alone, in turn)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--digest", action="store_true",
                    help="print kernel_digest's lines and stop (no result "
                         "line)")
    ap.add_argument("--kernels", action="store_true",
                    help="build, then time the four main-path kernels and "
                         "stop (no result line): for comparing layouts")
    ap.add_argument("--mcmc", action="store_true",
                    help="build, then [mcmc] alone: the chain-batched "
                         "kernel's parity and timing, and runs (a) and (b) "
                         "in turn in this process (no result line)")
    ap.add_argument("--minibatch", action="store_true",
                    help="build, then [minibatch] alone on the [main] draw "
                         "(no result line)")
    ap.add_argument("--smc", action="store_true",
                    help="build, then [smc] alone: the chain-batched "
                         "phase_fwd's parity and timing, runs (a) and (b) "
                         "and the bridge-vs-prior check (no result line)")
    ap.add_argument("--velo2d", action="store_true",
                    help="build, then [velo2d] alone: the 2-D extension's "
                         "published run and its full-width fit (no result "
                         "line)")
    ap.add_argument("--examples", action="store_true",
                    help="build, then [examples] alone: examples 01-04 and "
                         "06 at their published sizes, in turn, with their "
                         "quality lines (no result line)")
    ap.add_argument("--sharded", action="store_true",
                    help="build, then [sharded] alone: the stages at full "
                         "width for (a)'s data, (a)-(d) and the weak-scaling "
                         "harness at one and two ranks on the card (no "
                         "result line)")
    ap.add_argument("--wide", action="store_true",
                    help="build, then [wide] alone: the wide kernels' parity "
                         "and timing, then both stages at full width with 16 "
                         "batches (21 columns) on the wide body (no result "
                         "line)")
    ap.add_argument("--plain", nargs="?", const="abc", default=None,
                    metavar="PARTS",
                    help="[plain] alone: (a) the plain and fused NB "
                         "elements' dispersion gradients against float64 at "
                         "full width, (b) both stages' "
                         "default-metaparams fits at full width, (c) [mcmc] "
                         "(b)'s warm-start curvature and NUTS on both paths; "
                         "PARTS picks some of a, b, c (no result line)")
    ap.add_argument("--package", metavar="ROOT", default=None,
                    help="import velocycle_tpu_torch from the checkout at "
                         "ROOT (a git archive of another commit) in place "
                         "of this one's: with --digest or --fwdgrad-times")
    ap.add_argument("--fwdgrad-times", action="store_true",
                    help="build, then time the four fwd+grad kernels with "
                         "the dispersion gradient on (narrow at 5 columns, "
                         "wide at 21) and print one JSON line")
    ap.add_argument("--turns", metavar="ROOT", default=None,
                    help="build this checkout's and ROOT's packages, then "
                         "--fwdgrad-times of each in turns: ROOT, this, "
                         "this, ROOT, twice (no result line)")
    ap.add_argument("--tiles", action="store_true",
                    help="build, then [tiles] alone: the layout ladder's "
                         "sweep, three layouts of each family at int16 and "
                         "float32 counts (no result line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    if args.package is not None:
        sys.path.insert(0, os.path.abspath(args.package))
    try:
        import velocycle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: velocycle_tpu_torch not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, count, smi = phase_device(torch)
    if args.package is not None:
        where = os.path.dirname(os.path.dirname(
            os.path.abspath(velocycle_tpu_torch.__file__)))
        check(where == os.path.abspath(args.package),
              f"--package {args.package}: imported from {where}")
        print(f"[package] velocycle_tpu_torch from {where}")
    if args.digest:
        kernel_digest(torch, args.seed, wide=True)
        return 0
    if args.fwdgrad_times:
        phase_build()
        out = fwdgrad_times(torch, args.seed, smi)
        print(json.dumps({"fwdgrad_times": out}))
        return 0
    if args.turns is not None:
        turns(torch, args.seed, smi, args.turns)
        return 0
    if args.plain is not None:
        check(set(args.plain) <= set("abc"), f"--plain {args.plain}: parts "
              "are a, b, c")
        if set(args.plain) & set("ac"):     # the fused element's kernels
            phase_build()
        plain_alone(torch, args.seed, smi, args.plain)
        return 0
    alone = (args.kernels or args.mcmc or args.smc or args.minibatch
             or args.velo2d or args.examples or args.sharded or args.wide)
    tiles = TILES_SWEEP if args.tiles else {} if alone else TILES_DEFAULT
    # the copies of [tiles]' other layouts build beside the package's build
    pending = start_tiles(tiles)
    try:
        return _run(torch, args, name, count, smi, t_start, tiles, pending)
    finally:
        from velocycle_tpu_torch.tools import kernel_ladder as KL

        KL.stop(pending)


class _Spans:
    """Each phase's seconds of the default run, on the host clock, from
    the end of the one before it (the first from the script's start)."""

    def __init__(self, t0):
        self.t, self.rows = t0, []

    def mark(self, name):
        now = time.perf_counter()
        self.rows.append((name, now - self.t))
        self.t = now

    def line(self):
        return "[phases] " + ", ".join(f"{n} {s:.1f} s" for n, s in self.rows)


def _run(torch, args, name, count, smi, t_start, tiles, pending):
    """main's phases from the build on."""
    spans = _Spans(t_start)
    phase_build()
    spans.mark("build")
    if args.tiles:
        phase_tiles(torch, smi, tiles, pending)
        return 0
    if args.examples:
        phase_examples(torch, smi, smoke=False, timeout=1500)
        return 0
    if args.kernels:
        phase_timing(torch, args.seed, smi)
        velo_timing(torch, args.seed, smi)
        return 0
    if args.mcmc:
        mcmc_kernels(torch, args.seed, smi)
        velo_chain_kernels(torch, args.seed, smi)
        mcmc_in_turn(torch, args.seed, smi)
        return 0
    if args.smc:
        smc_kernels(torch, args.seed, smi)
        phase_smc(torch, args.seed, smi)
        return 0
    if args.minibatch:
        minibatch_alone(torch, args.seed, smi)
        return 0
    if args.velo2d:
        phase_velo2d(torch, args.seed, smi)
        return 0
    if args.sharded:
        sharded_alone(torch, args.seed, smi)
        return 0
    if args.wide:
        wide_alone(torch, args.seed, smi)
        return 0
    kernel_digest(torch, args.seed)
    errs = phase_parity(torch, args.seed)
    timing = phase_timing(torch, args.seed, smi)
    timing.update(velo_timing(torch, args.seed, smi))
    torch.cuda.empty_cache()
    spans.mark("digest, parity, timing")
    ladder_errs, ladder_timing, ladder_launches = phase_ladder(
        torch, args.seed, smi)
    torch.cuda.empty_cache()
    spans.mark("[ladder]")
    # every kernel timing before the [mcmc] processes share the card
    variant_errs, variant_timing = _variant_kernels(torch, args.seed, smi)
    mcmc_parity, mcmc_timing = mcmc_kernels(torch, args.seed, smi)
    smc_parity, smc_timing = smc_kernels(torch, args.seed, smi)
    chain_kernels = velo_chain_kernels(torch, args.seed, smi)
    torch.cuda.empty_cache()
    spans.mark("[variants], [mcmc], [smc], [velo chains] kernels")
    # [wide] (b) and (c): the wide body past 16 columns
    wide_errs, wide_chains = wide_parity(torch, args.seed)
    wide_timings = wide_timing(torch, args.seed, smi)
    torch.cuda.empty_cache()
    spans.mark("[wide] (b), (c)")
    # the layouts, alone on the card before the [mcmc] processes
    layouts = phase_tiles(torch, smi, tiles, pending)
    torch.cuda.empty_cache()
    spans.mark("[tiles]")
    launches, rates, minibatch, support, sharded_ref, wide = _stages(
        torch, args.seed, smi)
    spans.mark("stages")
    # the [mcmc] runs, host-bound, beside [quickstart] and [variants]
    pool, pending = start_mcmc_runs(args.seed, smi, cfgs=MCMC_DEFAULT)
    try:
        phase_quickstart(torch, args.seed, smi)
        torch.cuda.empty_cache()
        variant_launches = phase_variants(torch, args.seed, smi)
        spans.mark("[quickstart], [variants]")
        mcmc_runs = finish_mcmc_runs(pool, pending)
        mcmc = mcmc_row(mcmc_parity, mcmc_timing, mcmc_runs)
    finally:
        pool.terminate()
        pool.join()
    torch.cuda.empty_cache()
    spans.mark("[mcmc] runs after them")
    # [smc] alone on the host and the card, after the [mcmc] processes
    smc_runs = phase_smc(torch, args.seed, smi)
    smc = smc_row(smc_parity, smc_timing, smc_runs)
    velo = velo_rows(chain_kernels, mcmc_runs["c"], smc_runs["c"])
    torch.cuda.empty_cache()
    spans.mark("[smc]")
    # [sharded] (b) alone after [smc]
    sharded = phase_sharded(torch, args.seed, smi, sharded_ref)
    del sharded_ref
    torch.cuda.empty_cache()
    spans.mark("[sharded] (b)")
    # [velo2d] alone after [smc]: the 2-D extension, no kernel of its own
    phase_velo2d(torch, args.seed, smi)
    torch.cuda.empty_cache()
    spans.mark("[velo2d]")
    # [examples] last: five processes of their own at once, beside
    # [sharded] (c) and (d), host-bound too; [smc] (a) and (c) are (c)'s
    # one-rank references
    pending = start_sharded_samplers(args.seed, smi)
    try:
        examples = phase_examples(torch, smi)
    except BaseException:
        _stop(pending["example"][0])
        raise
    sharded.update(finish_sharded_samplers(
        torch, pending, args.seed, smi,
        {tag: smc_runs[tag]["log_evidence"] for tag in ("a", "c")}))
    spans.mark("[examples], [sharded] (c), (d)")
    steps_per_s, peak, vsteps_per_s, vpeak = rates

    print("kernels: " + ", ".join(f"{k} ({v} launches)" for k, v in sorted(launches.items())))
    base = "velocycle_tpu/ops/nb_kernels.py"
    kernels = {
        "phase_fwd": ("phase_kernel.cuh", f"{base}:261"),
        "phase_fwdgrad": ("phase_kernel.cuh", f"{base}:287"),
        "velo_fwd": ("velo_kernel.cuh", f"{base}:624"),
        "velo_fwdgrad": ("velo_kernel.cuh", f"{base}:659"),
    }
    table = []
    for k, (src, replaces) in kernels.items():
        check(launches[k] > 0, f"{k} was not launched on the main path")
        table.append({
            "name": k, "route": "cuda",
            "source": f"velocycle_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": errs[k][0], "loss_rel_err": errs[k][1],
            **timing[k],
            # the [variants] fits' launches by basis width; at 11 columns
            # the parity, kernel and plain ms and bound of the spline path
            "variant_launches": {str(w): n for w, n in
                                 sorted(variant_launches[k].items())},
            **({f"w{W_SPLINE}": {"max_abs_err": variant_errs[k][0],
                                 **variant_timing[k]}}
               if k in variant_timing else {}),
            # [mcmc]: launches by chain count, the chain-batched launch's
            # parity and timing, and the runs' numbers
            **(mcmc if k == "phase_fwdgrad" else {}),
            # [smc]: the chain-batched phase_fwd (row 1'')
            **(smc if k == "phase_fwd" else {}),
            # the chain-batched velocity pair (rows 3'', 4''), [mcmc] (c)
            # and [smc] (c)
            **velo.get(k, {}),
            # [minibatch]: MinibatchSVI's block steps at B = Nc / 8
            **({"minibatch": minibatch} if k == "phase_fwdgrad" else {}),
            # [support] (checkpoint and resume, warmup, trace) and example
            # 06's launches on the phase kernel; [tiles]' ms per layout
            **({"support": support,
                "example_06_launches": examples[EXAMPLE_FUSED][k]}
               if k == "phase_fwdgrad" else {}),
            **({"layouts_ms": layouts["phase" if k.startswith("phase")
                                      else "velo"]}
               if k.endswith("fwdgrad") else {}),
            # [sharded]: (a) one rank over NCCL, (b) two ranks over gloo
            # (per-rank numbers), (c) the samplers' per-rank launches
            **{"sharded": sharded_row(k, sharded)},
        })
    # the wide body: its launches from [wide] (a); ms, plain ms and bound at
    # 21 columns ((a)'s shape), the same at 64 columns, float32 counts and
    # the chain-batched launch beside them
    for k in WIDE_KERNELS:
        src, line = kernels[k.replace("_wide", "")]
        check(launches.get(k, 0) > 0, f"{k} was not launched on [wide] (a)'s path")
        w21 = {key: v for key, v in wide_timings[k]["w21"].items() if key != "plan"}
        table.append({
            "name": k, "route": "cuda",
            "source": "velocycle_tpu_torch/csrc/wide_kernel.cuh",
            "replaces": line, "launches": launches[k],
            "max_abs_err": wide_errs[k][0], "loss_rel_err": wide_errs[k][1],
            **w21, "columns": 21,
            "w64": wide_timings[k]["w64"],
            **({"f32_ms": wide_timings[k]["f32_ms"]}
               if "f32_ms" in wide_timings[k] else {}),
            "chains": {"parity": wide_chains[k],
                       **({"timing": wide_timings[k]["chains"]}
                          if "chains" in wide_timings[k] else {})},
            "stage": wide["phase" if k.startswith("phase") else "velo"],
            **({"fold": wide_timings["fold"][k.split("_")[0]]}
               if k.endswith("fwdgrad_wide") else {}),
        })
    # the ladder's launches come from its own entry point, run_ladder
    for rung, line in LADDER_REPLACES.items():
        check(ladder_launches[rung] > 0,
              f"ladder_{rung} was not launched by run_ladder")
        table.append({
            "name": f"ladder_{rung}", "route": "cuda",
            "source": "velocycle_tpu_torch/csrc/phase_kernel.cuh",
            "replaces": f"tools/kernel_profile.py:{line}",
            "launches": ladder_launches[rung],
            "max_abs_err": ladder_errs[rung][0],
            "loss_rel_err": ladder_errs[rung][1], **ladder_timing[rung],
        })
    print(spans.line())
    print(f"[done] {time.perf_counter() - t_start:.1f} s; stage 1 "
          f"{steps_per_s:.3f} steps/s, peak {peak / 2**30:.2f} GiB; stage 2 "
          f"{vsteps_per_s:.3f} steps/s, peak {vpeak / 2**30:.2f} GiB")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
