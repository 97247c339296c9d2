"""Two-sample workflow with batch correction and a condition-level speed
contrast (the port of the JAX package's example 02, which mirrors
`tutorials/Tutorial_Aissa_PC9_TwoSample.ipynb`):

  two batches with different true omega -> joint phase fit with per-batch
  delta_nu offsets (asymmetric priors: tight on batch 1, loose on batch 2)
  -> velocity fit with a per-condition angular speed -> speed comparison.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/02_two_sample_condition_contrast.py [--device cpu]

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
    make_design_matrix, preprocess_for_phase_estimation,
    preprocess_for_velocity_estimation,
)
from velocycle_tpu_torch.simulate import simulate_data  # noqa: E402

from _smoke import sz  # noqa: E402

NC_PER, NG = sz(200, 48), sz(60, 20)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    adata = simulate_data(
        Nc=NC_PER, Ng=NG, omegas_to_test=(0.3, 0.6), seed=21
    )  # two blocks, batch column = omega label
    Nc = adata.shape[0]
    rng = np.random.default_rng(0)
    nu = adata.uns["simulated_nu"]
    cycle_prior = Cycle.from_array(
        (nu + rng.normal(0, 0.2, nu.shape)).T, np.full((3, NG), 0.5),
        list(adata.var.index),
    )
    phase_prior = Phases.from_angles(
        adata.obs["simulated_phis"].values + rng.normal(0, 0.4, Nc),
        concentration=2.0, cell_names=list(adata.obs.index),
    )
    Db = make_design_matrix(adata, ids="batch")

    # per-batch offset prior: pin batch 1 (reference batch), free batch 2
    # (`Tutorial_Aissa_PC9_TwoSample.ipynb` cell 24)
    mp = preprocess_for_phase_estimation(
        adata, cycle_prior, phase_prior, design_mtx=Db, n_harmonics=1,
        with_delta_nu=True, sd_dnu=np.array([0.001, 0.1]), device=device,
    )
    pfit = PhaseFitModel(mp, get_posterior=False)
    pfit.fit(num_steps=sz(2000, 40), seed=0)
    print(f"phase fit ELBO {pfit.losses[0]:.0f} -> {pfit.losses[-1]:.0f}")
    from _figs import fig_elbo, fig_phase_scatter
    fig_elbo(pfit.losses, "two_sample_elbo.png", "joint phase fit ELBO")
    fig_phase_scatter(pfit.phase_fit.phis,
                      adata.obs["simulated_phis"].values,
                      "two_sample_phase_scatter.png")

    # velocity with one omega per condition; condition design = batches
    speed_prior = AngularSpeed.trivial_prior(
        ["d0", "d3"], harmonics=0, means=0.4, stds=0.5
    )
    vp = preprocess_for_velocity_estimation(
        adata, pfit.cycle_fit, pfit.phase_fit, speed_prior,
        condition_design_mtx=Db, batch_design_mtx=Db,
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
    om = vfit.speed_fit.means.iloc[0]
    periods = vfit.period_hours()
    print(f"omega d0 {om['d0']:.3f} (true 0.3)  d3 {om['d3']:.3f} "
          f"(true 0.6)  speed ratio {om['d3'] / om['d0']:.2f} (true 2.0)")
    print(f"periods: {periods.round(2)}")


if __name__ == "__main__":
    main()
