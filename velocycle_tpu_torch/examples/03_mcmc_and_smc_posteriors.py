"""Full-posterior inference on the phase model with the MCMC and SMC
backends (the port of the JAX package's example 03).

The `MCMCFitModel` / `SMCFitModel` drivers own the whole workflow the SVI
drivers have: conditioning, an SVI warm start with automatic
Fisher/Hessian preconditioning, posterior containers and diagnostics, one
``.run()`` call each.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/03_mcmc_and_smc_posteriors.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data, the chains and the stages so that it
finishes in seconds.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    Cycle, MCMCFitModel, Phases, SMCFitModel,
    preprocess_for_phase_estimation,
)
from velocycle_tpu_torch.simulate import simulate_data  # noqa: E402

from _smoke import sz  # noqa: E402

NC, NG = sz(60, 30), sz(20, 8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    sim = simulate_data(Nc=NC, Ng=NG, seed=5)
    rng = np.random.default_rng(0)
    nu = sim.uns["simulated_nu"]
    cycle = Cycle.from_array(
        (nu + rng.normal(0, 0.2, nu.shape)).T, np.full((3, NG), 0.5),
        list(sim.var.index),
    )
    phases = Phases.from_angles(
        sim.obs["simulated_phis"].values, 2.0, list(sim.obs.index)
    )
    mp = preprocess_for_phase_estimation(
        sim, cycle, phases, n_harmonics=1, with_delta_nu=False,
        device=device,
    )

    # -- NUTS --------------------------------------------------------------
    fm = MCMCFitModel(mp, num_chains=sz(4, 2), num_warmup=sz(400, 60),
                      num_samples=sz(400, 40))
    fm.run(0)
    d = fm.diagnostics
    print(f"NUTS accept {d['accept_rate']:.2f} "
          f"max split-Rhat {d['max_split_rhat']:.3f} "
          f"ESS min/med {d['min_ess']:.0f}/{d['median_ess']:.0f}")
    nu_mean = fm.posterior["nu"].mean(0)
    nu_sd = fm.posterior["nu"].std(0)
    print(f"  nu[0,0]: mean {nu_mean[0, 0]:.3f} sd {nu_sd[0, 0]:.3f}")
    cc = np.abs(np.exp(
        1j * (fm.phase_fit.phis - sim.obs["simulated_phis"].values)
    ).mean())
    print(f"  posterior-mean phase vs truth: circular corr {cc:.3f}")

    # -- SMC ---------------------------------------------------------------
    sm = SMCFitModel(
        mp, condition_on={"phi_xy": mp.data.phixy_prior},
        num_particles=sz(512, 64), num_moves=sz(3, 1),
        max_stages=sz(200, 40),
    )
    sm.run(1)
    print(f"SMC: {len(sm.temperature_schedule)} tempering stages, "
          f"logZ {sm.log_evidence:.1f}")
    print(f"  nu[0,0] particle mean "
          f"{sm.posterior['nu'][:, 0, 0].mean():.3f}; "
          f"dispersion extracted: {sm.cycle_fit.disp is not None}")


if __name__ == "__main__":
    main()
