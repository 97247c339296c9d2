"""2-D branching-trajectory ground-truth simulator (port of
`velocycle_tpu/twodim/simulate.py`).

Cells on a Y-shaped branching structure in a square domain, a random
smooth spline velocity field, and per-gene expression drawn from
branch-biased archetype modules with accept/reject constraints (positive
kinetic inner term, bounded counts, enough expressed cells), Poisson
spliced/unspliced sampling.  All ground truths are stored on the returned
`AnnDataLite`.  Host-side numpy over the port's spline bases (evaluated in
float32 on the CPU, as the JAX file's are): fixture code, not a compute
path.  The same seed draws the same genes and counts as the JAX package
wherever the two float32 bases agree to the bit.
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from ..anndata_lite import AnnDataLite
from ..ops.splines import (
    spline_basis_2d,
    spline_basis_2d_der,
    spline_knots,
)

__all__ = ["generate_adata", "make_designs"]

N_BASIS = 6
DEGREE = 3


def _branching_positions(n_cells, lo, hi, x_branch, y_init, sd_min, sd_max,
                         rng):
    """Y-shaped trajectory: a trunk then two symmetric branches, with
    position noise largest near the branch point."""
    n_before = n_cells // 3
    n_after = n_cells - n_before
    pad = 0.1 * (hi - lo)
    x0, x1 = lo + pad, hi - pad

    sd = np.concatenate([
        np.linspace(sd_min, sd_max, n_before),
        np.linspace(sd_max, sd_min, n_after),
    ])
    slope = (x1 - y_init) / (x1 - x_branch)

    phi = np.zeros((2, n_cells))
    phi[0, :n_before] = np.linspace(x0, x_branch, n_before)
    phi[0, n_before:] = np.linspace(x_branch, x1, n_after)
    phi[1, :n_before] = y_init
    upper = rng.random(n_after) > 0.5
    dx = phi[0, n_before:] - x_branch
    phi[1, n_before:] = y_init + np.where(upper, slope * dx, -slope * dx)

    phi += rng.normal(0, sd, (2, n_cells))
    return np.clip(phi, lo, hi), np.concatenate(
        [np.full(n_before, False), upper]
    )


def make_designs(phi, lo, hi, n_basis=N_BASIS, degree=DEGREE):
    """Spline design matrices at cell positions ``phi`` (2, Nc):
    (design_s, design_dx, design_dy, design_omega) — expression designs have
    a leading constant row; the omega design does not
    (`simulate_2D.py:61-111`)."""
    knots = spline_knots(lo, hi, n_basis, degree)
    x, y = phi[0], phi[1]
    design_s = np.asarray(
        spline_basis_2d(x, y, knots, knots, degree, include_constant=True)
    ).T  # (n_basis^2 + 1, Nc)
    ddx, ddy = spline_basis_2d_der(
        x, y, knots, knots, degree, include_constant=True
    )
    design_omega = np.asarray(
        spline_basis_2d(x, y, knots, knots, degree, include_constant=False)
    ).T  # (n_basis^2, Nc)
    return design_s, np.asarray(ddx).T, np.asarray(ddy).T, design_omega


# branch-biased archetype means on a (root, middle, upper-tip, lower-tip)
# skeleton — same 8 patterns as `simulate_2D.py:141-190`
_MODULE_PATTERNS = {
    0: dict(root=1.0, upper=1.0, lower=0.0),   # lower in lower branch
    1: dict(root=1.0, upper=0.0, lower=1.0),
    2: dict(root=0.0, upper=0.0, lower=1.0),
    3: dict(root=0.0, upper=1.0, lower=0.0),
    4: dict(root=0.0, upper=1.0, lower=1.0),   # higher in both branches
    5: dict(root=1.0, upper=0.0, lower=0.0),   # lower in both branches
    6: dict(root=0.5, upper=0.0, lower=1.0),
    7: dict(root=0.5, upper=1.0, lower=0.0),
}


def _module_weights(module, n_basis, rng):
    """(n_basis, n_basis) spline-weight grid realizing a branch-biased
    pattern, plus noise."""
    pat = _MODULE_PATTERNS[module % 8]
    w = np.zeros((n_basis, n_basis))
    mid = n_basis // 2
    # trunk along y = mid for low x
    w[: mid + 1, mid - 1: mid + 1] = pat["root"]
    # upper branch: high x, high y; lower branch: high x, low y
    w[mid:, mid + 1:] = pat["upper"]
    w[mid:, : mid - 1] = pat["lower"]
    w += rng.normal(0, 0.25, w.shape)
    return w.reshape(-1)


def _sample_gene(module, designs, omega, rng,
                 log_beta_mean=2.0, log_beta_scale=0.7,
                 log_gamma_mean=0.25, log_gamma_scale=0.1,
                 max_tries=200):
    """Accept/reject one gene (`simulate_2D.py:127-227` constraints:
    positive kinetic inner term, counts < 1000, >=20% cells expressed)."""
    design_s, design_dx, design_dy, _ = designs
    n_basis2 = design_s.shape[0] - 1
    for _ in range(max_tries):
        log_beta = rng.normal(log_beta_mean, log_beta_scale)
        log_gamma = rng.normal(log_gamma_mean, log_gamma_scale)
        gamma = np.exp(log_gamma)
        w_grid = _module_weights(module, int(np.sqrt(n_basis2)), rng)
        intercept = rng.normal(2.0, 1.0)
        w_s = np.concatenate([[intercept], w_grid])[None, :]

        inner = (
            (w_s @ design_dx) * omega[0]
            + (w_s @ design_dy) * omega[1]
            + gamma
        )
        if not (inner > 0).all():
            continue
        ElogS = (w_s @ design_s)[0]
        ElogU = -log_beta + ElogS + np.log(np.maximum(inner[0], 0) + 1e-5)
        s_mean, u_mean = np.exp(ElogS), np.exp(ElogU)
        if ((s_mean > 1000) | (u_mean > 1000)).any():
            continue
        if (s_mean > 10).sum() < 0.2 * len(s_mean):
            continue
        return ElogS, ElogU, log_beta, log_gamma, w_s[0]
    raise RuntimeError(f"gene simulation failed for module {module}")


def generate_adata(
    n_cells: int = 1000,
    n_genes: int = 200,
    phi_lower: float = 0.0,
    phi_upper: float = 10.0,
    x_branching: float = 5.0,
    y_initial: float = 5.0,
    cell_sd_min: float = 0.2,
    cell_sd_max: float = 0.6,
    w_omega=None,
    seed: int = 0,
):
    """Simulate a 2-D branching dataset with known expression/velocity
    fields (`simulate_2D.py:230-364`)."""
    rng = np.random.default_rng(seed)
    phi, upper_mask = _branching_positions(
        n_cells, phi_lower, phi_upper, x_branching, y_initial,
        cell_sd_min, cell_sd_max, rng,
    )
    designs = make_designs(phi, phi_lower, phi_upper)
    design_s, design_dx, design_dy, design_omega = designs

    if w_omega is None:
        w_omega = rng.normal(0, 1, (2, design_omega.shape[0]))
    omega = w_omega @ design_omega  # (2, Nc)

    ElogS = np.zeros((n_genes, n_cells))
    ElogU = np.zeros((n_genes, n_cells))
    log_betas = np.zeros(n_genes)
    log_gammas = np.zeros(n_genes)
    w_s_all = np.zeros((n_genes, design_s.shape[0]))
    for g in range(n_genes):
        ElogS[g], ElogU[g], log_betas[g], log_gammas[g], w_s_all[g] = (
            _sample_gene(g % 8, designs, omega, rng)
        )

    S = rng.poisson(np.exp(ElogS)).astype(np.int64)  # (Ng, Nc)
    U = rng.poisson(np.exp(ElogU)).astype(np.int64)

    genes = [f"G{i:05d}" for i in range(n_genes)]
    cells = [f"C{i:05d}" for i in range(n_cells)]
    adata = AnnDataLite(
        X=S.T,
        obs=pd.DataFrame(
            {
                "cell_x": phi[0],
                "cell_y": phi[1],
                "upper_branch": upper_mask,
                "omega_x": omega[0],
                "omega_y": omega[1],
            },
            index=cells,
        ),
        var=pd.DataFrame(
            {
                "log_beta": log_betas,
                "log_gamma": log_gammas,
                "module": [g % 8 for g in range(n_genes)],
            },
            index=genes,
        ),
        layers={
            "spliced": S.T,
            "unspliced": U.T,
            "ElogS": ElogS.T,
            "ElogU": ElogU.T,
        },
        uns={
            "w_omega": w_omega,
            "w_s": w_s_all,
            "phi_lower": phi_lower,
            "phi_upper": phi_upper,
        },
    )
    return adata
