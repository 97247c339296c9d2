"""1D linear-manifold (pseudotime) workflow with a B-spline basis (the port
of the JAX package's example 04, which mirrors
`tutorials/1D_Pancreas_Analysis.ipynb`).

The reference generalizes VeloCycle beyond the cell-cycle circle by
redefining both models inline with a spline basis over a *fixed* diffusion
pseudotime and a scalar velocity (notebook cells 28/46).  Here that path is
first-class: pass ``basis_kind="spline"`` to the preprocessors and condition
the ``phi`` site on the pseudotime.

  simulate a branchless differentiation trajectory ->
  stage 1: spline expression field (phi conditioned on pseudotime) ->
  stage 2: kinetics (log_gamma, log_beta) + scalar speed omega ->
  transit time = integral of 1/omega over the pseudotime domain.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/04_pancreas_1d_spline.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the steps so that it finishes in
seconds; ``VCT_FIGDIR=dir`` saves its figures.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import pandas as pd

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    AngularSpeed, Cycle, Phases, PhaseFitModel, VelocityFitModel,
    preprocess_for_phase_estimation, preprocess_for_velocity_estimation,
)
from velocycle_tpu_torch.anndata_lite import AnnDataLite  # noqa: E402
from velocycle_tpu_torch.ops.splines import spline_basis_auto  # noqa: E402

from _smoke import sz  # noqa: E402
import _figs  # noqa: E402

NC, NG, N_BASIS = sz(400, 64), sz(60, 16), sz(8, 6)
OMEGA_TRUE = 0.5
DOMAIN = (0.0, 1.0)


def simulate_pseudotime_counts(seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(*DOMAIN, NC)).astype(np.float32)
    W = rng.normal(0, 0.5, (NG, N_BASIS + 1)).astype(np.float32)
    W[:, 0] += 3.0
    B = spline_basis_auto(t, n_basis=N_BASIS, degree=3,
                          domain=DOMAIN).numpy()
    dB = spline_basis_auto(t, der=1, n_basis=N_BASIS, degree=3,
                           domain=DOMAIN).numpy()
    ElogS = W @ B.T
    gamma = np.exp(rng.normal(0.0, 0.3, NG)).astype(np.float32)
    beta = np.exp(rng.normal(2.0, 0.3, NG)).astype(np.float32)
    kin = (W @ dB.T) * OMEGA_TRUE + gamma[:, None]
    ElogU = (
        -np.log(beta)[:, None] + np.log(np.maximum(kin, 0) + 1e-5) + ElogS
    )
    S = rng.poisson(np.exp(ElogS)).astype(np.float32)
    U = rng.poisson(np.exp(ElogU)).astype(np.float32)
    genes = [f"g{i:03d}" for i in range(NG)]
    cells = [f"c{i}" for i in range(NC)]
    adata = AnnDataLite(
        X=S.T, layers={"spliced": S.T, "unspliced": U.T},
        obs=pd.DataFrame({"pseudotime": t}, index=cells),
        var=pd.DataFrame(index=genes),
    )
    return adata, dict(t=t, W=W, B=B, ElogS=ElogS, gamma=gamma, beta=beta)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    adata, truth = simulate_pseudotime_counts()
    genes = list(adata.var.index)
    cells = list(adata.obs.index)
    t = truth["t"]

    # -- stage 1: expression field over the pseudotime manifold -----------
    cycle_prior = Cycle.spline_prior(genes, n_basis=N_BASIS, stds=3.0)
    phase_prior = Phases.from_angles(t, cell_names=cells)
    mp = preprocess_for_phase_estimation(
        adata, cycle_prior, phase_prior, noisemodel="Poisson",
        with_delta_nu=False, basis_kind="spline", spline_domain=DOMAIN,
        device=device,
    )
    fit = PhaseFitModel(
        mp, condition_on={"phi": t}, get_posterior=False,
    )
    fit.fit(num_steps=sz(1200, 40), seed=0)
    nu_hat = fit.params["nu_locs"]
    corr = np.corrcoef(
        (nu_hat @ truth["B"].T).ravel(), truth["ElogS"].ravel()
    )[0, 1]
    print(f"stage 1: ElogS corr vs truth = {corr:.4f}")
    _figs.fig_elbo(fit.losses, "pancreas_elbo.png",
                   title="stage-1 spline SVI ELBO")
    _figs.fig_spline_field(
        t, nu_hat @ truth["B"].T, truth["ElogS"], "pancreas_field.png",
    )

    # -- stage 2: kinetics + scalar speed ---------------------------------
    cycle_fit = Cycle.from_array(
        nu_hat.T, fit.params["nu_scales"].T, genes
    )
    speed_prior = AngularSpeed.from_array(
        np.array([[0.0]]), np.array([[1.0]]),
        condition_names=["traj"], num_coeffs=1,
    )
    mpv = preprocess_for_velocity_estimation(
        adata, cycle_fit, phase_prior, speed_prior, noisemodel="Poisson",
        with_delta_nu=False, model_type="fourier",
        basis_kind="spline", spline_domain=DOMAIN, device=device,
    )
    vfit = VelocityFitModel(
        mpv, condition_on={"phi": t, "nu": nu_hat}, get_posterior=False,
    )
    vfit.fit(num_steps=sz(3000, 40), seed=1)
    omega_hat = float(vfit.speed_fit.means_array.squeeze())
    shift = np.mean(np.log(truth["gamma"])) - np.mean(
        vfit.cycle_fit.log_gammas
    )
    print(
        f"stage 2: omega_hat = {omega_hat:.3f} "
        f"(scale-corrected {omega_hat * np.exp(shift):.3f}, "
        f"true {OMEGA_TRUE})"
    )
    print(
        "stage 2: log_gamma corr =",
        round(np.corrcoef(
            vfit.cycle_fit.log_gammas, np.log(truth["gamma"])
        )[0, 1], 3),
        " log_beta corr =",
        round(np.corrcoef(
            vfit.cycle_fit.log_betas, np.log(truth["beta"])
        )[0, 1], 3),
    )
    # the kinetic model identifies RATIOS, not absolute rates: scaling
    # (omega, gamma) by c and absorbing log c into beta leaves ElogU
    # unchanged, so absolute gamma/beta/omega are prior-dominated (the
    # reference has the same degeneracy; its tutorials fix scale with
    # informative priors).  The identifiable combination:
    ratio_corr = np.corrcoef(
        vfit.cycle_fit.log_gammas - vfit.cycle_fit.log_betas,
        np.log(truth["gamma"]) - np.log(truth["beta"]),
    )[0, 1]
    print(f"stage 2: gamma/beta ratio corr = {ratio_corr:.3f} "
          "(the identifiable kinetic combination)")
    print(
        f"transit time over the manifold = {vfit.period_hours()[0]:.2f} "
        "(domain units)"
    )


if __name__ == "__main__":
    main()
