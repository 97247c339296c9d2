"""2-D benchmark driver: simulate -> two-stage fit -> ground-truth
correlations (port of `velocycle_tpu/twodim/driver.py`).

Stage 1 fits the spliced spline field (`velo2d_s_model` + `AutoNormal`,
plain Adam), freezes ``w_s`` and ``ElogS``; stage 2 fits the kinetics and
the velocity field (`velo2d_u_model` + `AutoNormal`); `evaluate_fit`
correlates the results with the simulator's ground truth.  The data and
both fits stay on one device (the card unless ``device="cpu"``), and the
results dict is formed there before it is copied to the host.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..core.handlers import fold_in
from ..device import resolve_device
from ..infer import SVI, Trace_ELBO, adam
from ..infer.autoguide import AutoNormal
from .models import Velo2DData, velo2d_s_model, velo2d_u_model
from .simulate import generate_adata, make_designs

__all__ = [
    "prepare_data", "train_velo2d", "evaluate_fit", "run_simulations",
]


def prepare_data(adata, device=None):
    """The models' `Velo2DData` from a simulated (or real) 2-D AnnData:
    the designs and the float32 S and U on ``device`` (the card by
    default; raises without one)."""
    dev = resolve_device(device)
    phi = np.stack([adata.obs["cell_x"].values, adata.obs["cell_y"].values])
    lo, hi = adata.uns["phi_lower"], adata.uns["phi_upper"]
    designs = make_designs(phi, lo, hi)

    def put(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.float32), device=dev)

    design_s, design_dx, design_dy, design_omega = (put(d) for d in designs)
    S = put(np.asarray(adata.layers["spliced"]).T)
    U = put(np.asarray(adata.layers["unspliced"]).T)
    Ng, Nc = S.shape
    return Velo2DData(
        design_s=design_s, design_dx=design_dx, design_dy=design_dy,
        design_omega=design_omega, S=S, U=U,
        w_s=torch.zeros((Ng, design_s.shape[0]), device=dev),
        ElogS=torch.zeros_like(S),
        Ng=Ng, Nc=Nc, n_coef_s=design_s.shape[0],
        n_coef_omega=design_omega.shape[0],
    )


def train_velo2d(pd: Velo2DData, n_steps_s=1000, n_steps_u=1000,
                 lr_s=1e-2, lr_u=1e-2, key=None):
    """Two-stage SVI.  ``key`` is an integer seed (0 by default); the
    stages take ``fold_in(key, 0)`` and ``fold_in(key, 1)``.  Returns
    (results dict of numpy arrays, losses_s, losses_u)."""
    key = 0 if key is None else int(key)
    k_s, k_u = fold_in(key, 0), fold_in(key, 1)

    guide_s = AutoNormal(velo2d_s_model)
    svi_s = SVI(velo2d_s_model, guide_s, adam(lr_s), Trace_ELBO())
    state_s, losses_s = svi_s.run(k_s, n_steps_s, pd)
    w_s = svi_s.get_params(state_s)["AutoNormal.locs.w_s"]
    del state_s
    with torch.no_grad():
        ElogS = w_s @ pd.design_s

    pd_u = pd.replace(w_s=w_s, ElogS=ElogS)
    guide_u = AutoNormal(velo2d_u_model)
    svi_u = SVI(velo2d_u_model, guide_u, adam(lr_u), Trace_ELBO())
    state_u, losses_u = svi_u.run(k_u, n_steps_u, pd_u)
    med = guide_u.median(svi_u.get_params(state_u))
    del state_u

    with torch.no_grad():
        w_omega = med["w_omega"]
        omega = w_omega @ pd.design_omega
        log_beta, log_gamma = med["log_beta"], med["log_gamma"]
        dEs_dx = w_s @ pd.design_dx
        dEs_dy = w_s @ pd.design_dy
        ElogU = (
            -log_beta[:, None]
            + ElogS
            + torch.log(torch.clamp(
                dEs_dx * omega[0] + dEs_dy * omega[1]
                + torch.exp(log_gamma)[:, None], min=0.0,
            ) + 1e-5)
        )
        del dEs_dx, dEs_dy
        results = {
            "w_s": w_s, "ElogS": ElogS, "w_omega": w_omega, "omega": omega,
            "log_beta": log_beta, "log_gamma": log_gamma, "ElogU": ElogU,
        }
        results = {k: v.cpu().numpy() for k, v in results.items()}
    return results, losses_s, losses_u


def evaluate_fit(adata, results):
    """Correlations with the simulated ground truth (the reference's
    `run_simulations.py` metrics)."""
    true_omega = np.stack(
        [adata.obs["omega_x"].values, adata.obs["omega_y"].values]
    )
    out = {
        "omega_x": np.corrcoef(true_omega[0], results["omega"][0])[0, 1],
        "omega_y": np.corrcoef(true_omega[1], results["omega"][1])[0, 1],
        "ElogS": np.corrcoef(
            np.asarray(adata.layers["ElogS"]).T.ravel(),
            results["ElogS"].ravel(),
        )[0, 1],
        "ElogU": np.corrcoef(
            np.asarray(adata.layers["ElogU"]).T.ravel(),
            results["ElogU"].ravel(),
        )[0, 1],
        "log_beta": np.corrcoef(
            adata.var["log_beta"].values, results["log_beta"]
        )[0, 1],
        "log_gamma": np.corrcoef(
            adata.var["log_gamma"].values, results["log_gamma"]
        )[0, 1],
        "gamma_beta_ratio": np.corrcoef(
            np.exp(adata.var["log_gamma"].values
                   - adata.var["log_beta"].values),
            np.exp(results["log_gamma"] - results["log_beta"]),
        )[0, 1],
    }
    return {k: float(v) for k, v in out.items()}


def run_simulations(n_seeds=10, n_cells=1000, n_genes=200,
                    n_steps_s=1000, n_steps_u=1000, out_path=None,
                    device=None):
    """Multi-seed closed loop: simulate -> fit -> correlate, seed ``s``
    simulating and fitting with ``s``.  Writes JSON if ``out_path`` is
    given."""
    all_corrs = {}
    for seed in range(n_seeds):
        adata = generate_adata(n_cells=n_cells, n_genes=n_genes, seed=seed)
        pd = prepare_data(adata, device=device)
        results, _, _ = train_velo2d(
            pd, n_steps_s=n_steps_s, n_steps_u=n_steps_u, key=seed,
        )
        corrs = evaluate_fit(adata, results)
        for k, v in corrs.items():
            all_corrs.setdefault(k, []).append(v)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(all_corrs, f, indent=2)
    return all_corrs
