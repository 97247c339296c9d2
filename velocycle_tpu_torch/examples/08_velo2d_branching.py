"""2-D branching-manifold workflow (the port of the JAX package's example
08): simulate a Y-shaped trajectory with a spline velocity field, fit the
two stages, and print the correlations with the ground truth.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/08_velo2d_branching.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the steps so that it finishes in
seconds (the CPU test runs it so); ``VCT_FIGDIR=dir`` saves the fitted
against the true velocity field as a quiver plot.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch.twodim import (  # noqa: E402
    evaluate_fit, generate_adata, prepare_data, train_velo2d,
)

from _smoke import sz  # noqa: E402
import _figs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    adata = generate_adata(n_cells=sz(400, 96), n_genes=sz(48, 12), seed=0)
    pd = prepare_data(adata, device=device)
    results, losses_s, losses_u = train_velo2d(
        pd, n_steps_s=sz(800, 30), n_steps_u=sz(800, 30), key=0,
    )
    print(f"stage S ELBO {losses_s[0]:.0f} -> {losses_s[-1]:.0f}")
    print(f"stage U ELBO {losses_u[0]:.0f} -> {losses_u[-1]:.0f}")
    corrs = evaluate_fit(adata, results)
    for k, v in corrs.items():
        print(f"  corr[{k}] = {v:.3f}")
    _figs.fig_quiver2d(
        adata.obs["cell_x"].values, adata.obs["cell_y"].values,
        results["omega"],
        np.stack([adata.obs["omega_x"].values,
                  adata.obs["omega_y"].values]),
        "velo2d_quiver.png",
    )
    return losses_s, losses_u, corrs


if __name__ == "__main__":
    main()
