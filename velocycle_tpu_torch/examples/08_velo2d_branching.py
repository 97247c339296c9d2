"""2-D branching-manifold workflow (the port of the JAX package's example
08): simulate a Y-shaped trajectory with a spline velocity field, fit the
two stages, and print the correlations with the ground truth.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/08_velo2d_branching.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the steps so that it finishes in
seconds (the CPU test runs it so).  This example draws no figure: the JAX
example's quiver plot comes from the reference's plotting helpers, and
waits for the port of `plots.py`.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch.twodim import (  # noqa: E402
    evaluate_fit, generate_adata, prepare_data, train_velo2d,
)

SMOKE = os.environ.get("VCT_SMOKE") == "1"


def sz(full, tiny):
    """The full-size value, or the tiny one under VCT_SMOKE=1."""
    return tiny if SMOKE else full


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
    return losses_s, losses_u, corrs


if __name__ == "__main__":
    main()
