"""Canonical one-sample workflow (the port of the JAX package's example 01,
which mirrors `tutorials/Tutorial_Capolupo_HumanFibroblasts_OneSample.ipynb`):

  simulate counts (the tutorial's datasets are external downloads) ->
  manifold-learning (phase fit) -> orientation checks ->
  velocity-learning, constant omega -> velocity-learning, periodic omega
  -> cell-cycle period.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/01_phase_and_velocity_one_sample.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the steps so that it finishes in
seconds; ``VCT_FIGDIR=dir`` saves its figures.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    AngularSpeed, Cycle, Phases, PhaseFitModel, VelocityFitModel,
    preprocess_for_phase_estimation, preprocess_for_velocity_estimation,
)
from velocycle_tpu_torch.ops.circular import circular_corrcoef  # noqa: E402
from velocycle_tpu_torch.simulate import simulate_data  # noqa: E402

from _smoke import sz  # noqa: E402

NC, NG = sz(300, 64), sz(80, 24)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # -- data (stand-in for the fibroblast AnnData) -----------------------
    adata = simulate_data(Nc=NC, Ng=NG, omegas_to_test=(0.4,), seed=11)
    true_phis = np.array(adata.obs["simulated_phis"].values)

    # -- priors: curated cycle coefficients + PCA-like phase init ---------
    rng = np.random.default_rng(0)
    nu = adata.uns["simulated_nu"]
    cycle_prior = Cycle.from_array(
        (nu + rng.normal(0, 0.2, nu.shape)).T,
        np.full((3, NG), 0.5),
        list(adata.var.index),
    )
    phase_prior = Phases.from_angles(
        true_phis + rng.normal(0, 0.4, NC), concentration=2.0,
        cell_names=list(adata.obs.index),
    )

    # -- stage 1: manifold-learning ---------------------------------------
    mp = preprocess_for_phase_estimation(
        adata, cycle_prior, phase_prior, n_harmonics=1,
        with_delta_nu=False, device=device,
    )
    pfit = PhaseFitModel(mp, num_samples=100, n_per_bin=100)
    pfit.fit(num_steps=sz(2000, 40), seed=0)
    cc = float(circular_corrcoef(pfit.phase_fit.phis, true_phis))
    print(f"phase fit: ELBO {pfit.losses[0]:.0f} -> {pfit.losses[-1]:.0f}, "
          f"circular corr vs truth {cc:.3f}")
    from _figs import fig_elbo, fig_phase_scatter, fig_polar
    fig_elbo(pfit.losses, "one_sample_elbo.png", "phase fit ELBO")
    fig_phase_scatter(pfit.phase_fit.phis, true_phis,
                      "one_sample_phase_scatter.png")
    fig_polar(pfit, "one_sample_polar.png")

    # -- stage 2a: velocity with constant omega ---------------------------
    speed_prior = AngularSpeed.trivial_prior(
        ["sample"], harmonics=0, means=0.3, stds=0.5
    )
    vp = preprocess_for_velocity_estimation(
        adata, pfit.cycle_fit, pfit.phase_fit, speed_prior,
        n_harmonics=1, with_delta_nu=False, model_type="fourier",
        device=device,
    )
    condition_on = {
        "phi_xy": vp.data.phixy_prior,
        "nu": vp.data.mu_nu,
        "shape_inv": pfit.disp,
    }
    vfit = VelocityFitModel(vp, condition_on=condition_on,
                            get_posterior=False)
    vfit.fit(num_steps=sz(3000, 40), seed=1)
    omega = float(vfit.speed_fit.means.iloc[0, 0])
    print(f"constant-omega fit: omega {omega:.3f} (simulated 0.4), "
          f"period {vfit.period_hours()[0]:.1f} rad-units")

    # -- stage 2b: periodic omega (H=1 speed harmonics) -------------------
    speed_prior_p = AngularSpeed.trivial_prior(
        ["sample"], harmonics=1, means=omega, stds=0.005
    )
    vp2 = preprocess_for_velocity_estimation(
        adata, pfit.cycle_fit, pfit.phase_fit, speed_prior_p,
        n_harmonics=1, with_delta_nu=False, model_type="fourier",
        device=device,
    )
    vfit2 = VelocityFitModel(vp2, condition_on=condition_on,
                             get_posterior=False)
    vfit2.fit(num_steps=sz(3000, 40), seed=2)
    print("periodic-omega coefficients:")
    print(vfit2.speed_fit.means)
    print(f"period (trapz of 1/omega): {vfit2.period_hours()[0]:.2f}")


if __name__ == "__main__":
    main()
