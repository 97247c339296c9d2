"""Stereo-seq spatial workflow (the port of the JAX package's example 06,
which mirrors `tutorials/Stereo_seq_BrainRG.ipynb`, the reference's
large, noisy-data demonstration).  Its three departures from the canonical
pipeline:

  * ALL genes (no curated set) with data-driven nu priors: nu0 from the
    per-gene log-mean, harmonic stds from the log-count std ladder
    (notebook cell 63);
  * a supervised LDA phase prior from categorical cell-cycle labels
    (cells 68-73), orientation fixed jointly with
    `preprocessing.invert_direction` + `max_corr` (cells 75-76);
  * the phase fit conditioned on ``delta_nu = 0`` (cells 81-83): the
    batch-offset machinery stays in the model but is pinned.

The fused Negative-Binomial likelihood carries the all-genes fit: on the
card, one `phase_fwdgrad` kernel launch per SVI step.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/06_stereoseq_spatial.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the steps so that it finishes in
seconds; ``VCT_FIGDIR=dir`` saves its figures.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    Cycle, Phases, PhaseFitModel, preprocessing,
    preprocess_for_phase_estimation,
)
from velocycle_tpu_torch.ops.circular import circular_corrcoef  # noqa: E402
from velocycle_tpu_torch.simulate import simulate_data  # noqa: E402

from _smoke import sz  # noqa: E402
import _figs  # noqa: E402

NC, NG = sz(600, 80), sz(150, 24)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # -- data: all genes, no curated subset -------------------------------
    adata = simulate_data(Nc=NC, Ng=NG, omegas_to_test=(0.4,), seed=21)
    true_phis = np.array(adata.obs["simulated_phis"].values)
    S = np.asarray(adata.layers["spliced"], np.float32)
    adata.layers["S_sz"] = S

    # categorical phase labels (the notebook uses Seurat S/G2M scores)
    adata.obs["phase"] = np.select(
        [true_phis < 2.0, true_phis < 4.0], ["G1", "S"], "G2M"
    )

    # -- data-driven nu prior over ALL genes (notebook cell 63) -----------
    nu0 = np.log(S.mean(axis=0) + 1e-9)
    nu0_std = np.std(np.log(S + 1), axis=0) / 2
    means = np.vstack([nu0, 0 * nu0, 0 * nu0])
    stds = np.vstack([nu0_std, 0.5 * nu0_std, 0.5 * nu0_std])
    cycle_prior = Cycle.from_array(means, stds, list(adata.var.index))

    # -- LDA phase prior from the labels (cells 68-73) --------------------
    phase_prior = Phases.from_lda_heuristic(
        adata, labels="phase", layer="S_sz", concentration=1.0,
    )

    # orientation + zero-point fixes, jointly on (Cycle, Phases) ----------
    n_scounts = S.sum(axis=1)
    rho_fwd = float(circular_corrcoef(phase_prior.phis, true_phis))
    preprocessing.invert_direction(cycle_prior, phase_prior)
    rho_inv = float(circular_corrcoef(phase_prior.phis, true_phis))
    if rho_fwd > rho_inv:  # keep the better orientation
        preprocessing.invert_direction(cycle_prior, phase_prior)
    shift, maxcor, _ = phase_prior.max_corr(n_scounts)
    phase_prior.rotate(angle=-shift)
    print(f"LDA prior: UMI max-corr {maxcor:.3f} at shift {shift:.2f}")

    # -- phase fit conditioned on delta_nu = 0 (cells 81-83) --------------
    delta_nu0 = np.zeros((1, NG), np.float32)
    mp = preprocess_for_phase_estimation(
        adata, cycle_prior, phase_prior, n_harmonics=1,
        with_delta_nu=True, condition_on={"delta_nu": delta_nu0},
        use_fused_nb=True, device=device,
    )
    fit = PhaseFitModel(
        mp, condition_on={"delta_nu": delta_nu0},
        num_samples=50, n_per_bin=50,
    )
    fit.check_model()
    fit.fit(num_steps=sz(2000, 40), seed=0)

    _figs.fig_elbo(fit.losses, "stereoseq_elbo.png",
                   title="all-genes fused-NB SVI ELBO")
    _figs.fig_phase_scatter(fit.phase_fit.phis, true_phis,
                            "stereoseq_phase_scatter.png",
                            title="LDA-prior phase fit vs truth")
    cc = float(circular_corrcoef(fit.phase_fit.phis, true_phis))
    print(
        f"phase fit (all {NG} genes, delta_nu=0 pinned, fused NB): "
        f"ELBO {fit.losses[0]:.0f} -> {fit.losses[-1]:.0f}, "
        f"circular corr {cc:.3f}"
    )
    assert fit.losses[-1] < fit.losses[0]
    assert "delta_nu" not in fit.posterior  # conditioned site is pinned
    return fit


if __name__ == "__main__":
    main()
