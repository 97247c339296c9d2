"""2-D manifold velocity models (port of `velocycle_tpu/twodim/models.py`).

The S^1 Fourier model generalized to a 2-D latent manifold with a spline
velocity vector field:

  velo2d_s_model:  w_s ~ Normal per gene over the spline coefficients;
                   ElogS = w_s @ design_s;  S ~ Poisson(exp(ElogS))
  velo2d_u_model:  log_beta, log_gamma ~ Normal per gene;
                   omega = w_omega @ design_omega (the 2-component field);
                   ElogU = -log_beta + ElogS
                           + log(relu(dEs/dx * omega_x + dEs/dy * omega_y
                                      + gamma) + 1e-5);
                   U ~ Poisson(exp(ElogU))

Layouts: coefficients ``(Ng, n_coef)``, designs ``(n_coef, Nc)``.  The
products are plain `torch.matmul`; the likelihood is the Poisson log-pmf in
plain torch (the JAX package reaches no Pallas kernel here either).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import distributions as dist
from ..core.handlers import deterministic, plate, sample

__all__ = ["Velo2DData", "velo2d_s_model", "velo2d_u_model",
           "VELO2D_TENSOR_FIELDS", "VELO2D_PRIOR_FIELDS"]

VELO2D_TENSOR_FIELDS = ("design_s", "design_dx", "design_dy", "design_omega",
                        "S", "U", "w_s", "ElogS")
# scalars by default; a tensor broadcast against the site's shape otherwise
VELO2D_PRIOR_FIELDS = ("w_s_mean", "w_s_scale", "w_omega_mean",
                       "w_omega_scale", "log_beta_mean", "log_beta_scale",
                       "log_gamma_mean", "log_gamma_scale")


@dataclasses.dataclass
class Velo2DData:
    """Designs, counts and priors of the 2-D models; every tensor on one
    device, the sizes static ints.  ``replace(**changes)`` returns a copy
    with fields changed (the driver's stage 2 swaps in the frozen stage-1
    ``w_s`` and ``ElogS``)."""

    design_s: torch.Tensor        # (n_coef_s, Nc) spline design (+const row)
    design_dx: torch.Tensor       # (n_coef_s, Nc) d/dx design
    design_dy: torch.Tensor       # (n_coef_s, Nc) d/dy design
    design_omega: torch.Tensor    # (n_coef_omega, Nc) velocity spline design
    S: torch.Tensor               # (Ng, Nc) float32 counts
    U: torch.Tensor               # (Ng, Nc)
    w_s: torch.Tensor             # (Ng, n_coef_s) frozen stage-1 weights
    ElogS: torch.Tensor           # (Ng, Nc) frozen stage-1 expectation
    w_s_mean: Any = 0.0
    w_s_scale: Any = 1.0
    w_omega_mean: Any = 0.0
    w_omega_scale: Any = 1.0
    log_beta_mean: Any = 0.0
    log_beta_scale: Any = 1.0
    log_gamma_mean: Any = 0.0
    log_gamma_scale: Any = 1.0
    Ng: int = 0
    Nc: int = 0
    n_coef_s: int = 0
    n_coef_omega: int = 0

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @property
    def device(self):
        return self.S.device


def _full(pd, shape, value):
    """``value`` broadcast to ``shape`` on the data's device (jnp.full)."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=pd.device).expand(shape)


def velo2d_s_model(pd: Velo2DData):
    """Stage 1: the per-gene spline expression field."""
    shape = (pd.Ng, pd.n_coef_s)
    with plate("genes", pd.Ng, dim=-2):
        w_s = sample(
            "w_s",
            dist.Normal(_full(pd, shape, pd.w_s_mean),
                        _full(pd, shape, pd.w_s_scale)).to_event(1),
        )  # (Ng, n_coef_s)
    ElogS = w_s @ pd.design_s  # (Ng, Nc)
    deterministic("ElogS", ElogS)
    with plate("cells", pd.Nc, dim=-1):
        sample("S", dist.Poisson(torch.exp(ElogS)), obs=pd.S)


def velo2d_u_model(pd: Velo2DData):
    """Stage 2: kinetics and the 2-component velocity spline field,
    given the frozen stage-1 ``w_s`` and ``ElogS``."""
    with plate("genes", pd.Ng, dim=-2):
        log_beta = sample(
            "log_beta",
            dist.Normal(_full(pd, (pd.Ng,), pd.log_beta_mean),
                        _full(pd, (pd.Ng,), pd.log_beta_scale)),
        )
        log_gamma = sample(
            "log_gamma",
            dist.Normal(_full(pd, (pd.Ng,), pd.log_gamma_mean),
                        _full(pd, (pd.Ng,), pd.log_gamma_scale)),
        )
    gamma = torch.exp(log_gamma)
    deterministic("gamma", gamma)

    shape = (2, pd.n_coef_omega)
    w_omega = sample(
        "w_omega",
        dist.Normal(_full(pd, shape, pd.w_omega_mean),
                    _full(pd, shape, pd.w_omega_scale)).to_event(2),
    )  # (2, n_coef_omega)
    omega = w_omega @ pd.design_omega  # (2, Nc)
    deterministic("omega", omega)

    dEs_dx = pd.w_s @ pd.design_dx  # (Ng, Nc)
    dEs_dy = pd.w_s @ pd.design_dy
    ElogU = (
        -log_beta[:, None]
        + pd.ElogS
        + torch.log(
            torch.clamp(
                dEs_dx * omega[0][None, :]
                + dEs_dy * omega[1][None, :]
                + gamma[:, None],
                min=0.0,
            )
            + 1e-5
        )
    )
    deterministic("ElogU", ElogU)
    with plate("cells", pd.Nc, dim=-1):
        sample("U", dist.Poisson(torch.exp(ElogU)), obs=pd.U)
