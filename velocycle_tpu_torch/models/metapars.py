"""Metaparameter containers: host preprocessing -> device tensors.

`PhaseData` and `VelocityData` are the ports of the JAX package's
`flax.struct` pytrees of the same names (`velocycle_tpu/models/
metapars.py`): dataclasses whose array fields are tensors on one explicit
device and whose config fields (sizes, flags, strings) are plain Python
values.  ``.replace(**kw)`` returns a copy with fields changed, as `fit.py`
uses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

__all__ = [
    "PhaseData", "VelocityData", "Metapars", "PHASE_TENSOR_FIELDS",
    "VELOCITY_TENSOR_FIELDS",
]


class _DeviceData:
    """``replace`` and ``device`` of the device-side containers."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def device(self):
        return self.S.device


@dataclasses.dataclass
class PhaseData(_DeviceData):
    """Device-side data/priors for manifold learning (phase inference)."""

    # observed data
    S: torch.Tensor             # (Ng, Nc) counts; int16 on the fused path
    logS: torch.Tensor          # (Ng, Nc) log counts for the Lognormal model
    count_factor: torch.Tensor  # (Nc,)
    # priors
    mu_nu: torch.Tensor         # (Ng, Nh)
    sd_nu: torch.Tensor         # (Ng, Nh)
    phixy_prior: torch.Tensor   # (Nc, 2)
    Db: torch.Tensor            # (Nb, Nc) batch design
    mu_dnu: torch.Tensor        # scalar
    sd_dnu: torch.Tensor        # (Nb, 1)
    gamma_alpha: torch.Tensor   # scalar NB dispersion Gamma prior
    gamma_beta: torch.Tensor
    sigma_gc: torch.Tensor      # scalar Lognormal noise scale
    beta0: torch.Tensor         # LBA Beta prior
    beta1: torch.Tensor
    # (Nc,) spline basis: the latent coordinate's prior location
    phi_prior: Optional[torch.Tensor] = None
    # precomputed sum(lgamma(S+1)): the fused kernels skip that term
    lgamma_k_sum: Optional[torch.Tensor] = None
    # static config
    Ng: int = 0
    Nc: int = 0
    Nb: int = 1
    num_harmonics_S: int = 2
    noisemodel: str = "NegativeBinomial"
    with_delta_nu: bool = True
    gene_selection_model: str = "all"
    basis_kind: str = "fourier"
    # "xy" (phi = atan2 of a Normal 2-vector) or "wrapped" (phi on S^1
    # proper, VonMises prior); any other value acts as "xy"
    phi_parametrization: str = "xy"
    # spline basis (basis_kind == "spline"): spline_n_basis + 1 columns
    # (leading constant) over spline_domain
    spline_n_basis: int = 10
    spline_degree: int = 3
    spline_domain: tuple = (0.0, 6.283185307179586)
    # fused CUDA NB likelihood (ops/nb_kernels.py); NegativeBinomial only
    use_fused_nb: bool = False
    # compile the dispersion gradient in; `fit.py` sets False when
    # shape_inv is conditioned and that gradient is discarded
    disp_grad: bool = True


# the tensor fields, in declaration order (the rest are static config)
PHASE_TENSOR_FIELDS = (
    "S", "logS", "count_factor", "mu_nu", "sd_nu", "phixy_prior", "Db",
    "mu_dnu", "sd_dnu", "gamma_alpha", "gamma_beta", "sigma_gc", "beta0",
    "beta1", "phi_prior", "lgamma_k_sum",
)


@dataclasses.dataclass
class VelocityData(_DeviceData):
    """Device-side data/priors for velocity learning."""

    S: torch.Tensor             # (Ng, Nc) counts; int16 on the fused path
    U: torch.Tensor             # (Ng, Nc)
    logS: torch.Tensor
    logU: torch.Tensor
    count_factor: torch.Tensor  # (Nc,)
    mu_nu: torch.Tensor         # (Ng, Nh)
    sd_nu: torch.Tensor
    phixy_prior: torch.Tensor   # (Nc, 2)
    D: torch.Tensor             # (Nx, Nc) condition design
    Db: torch.Tensor            # (Nb, Nc) batch design
    mu_dnu: torch.Tensor
    sd_dnu: torch.Tensor
    mu_gamma: torch.Tensor      # (Ng,) log-degradation prior
    sd_gamma: torch.Tensor
    mu_beta: torch.Tensor       # (Ng,) log-splicing prior
    sd_beta: torch.Tensor
    mu_nuomega: torch.Tensor    # (Nx, Nhw) angular-speed prior
    sd_nuomega: torch.Tensor
    gamma_alpha: torch.Tensor
    gamma_beta: torch.Tensor
    sigma_s_gc: torch.Tensor
    sigma_u_gc: torch.Tensor
    # LRMN hyperparameters
    rho_mean: torch.Tensor
    rho_std: torch.Tensor
    rho_scale: torch.Tensor
    phi_prior: Optional[torch.Tensor] = None
    # precomputed sum(lgamma(S+1)) + sum(lgamma(U+1)) for the fused kernels
    lgamma_k_sum: Optional[torch.Tensor] = None
    # static config
    Ng: int = 0
    Nc: int = 0
    Nb: int = 1
    Nx: int = 1
    Nhw: int = 3
    num_harmonics_S: int = 2
    omega_harmonics: int = 1
    noisemodel: str = "NegativeBinomial"
    with_delta_nu: bool = True
    model_type: str = "lrmn"
    rho_rank: int = 5
    basis_kind: str = "fourier"
    # see PhaseData.phi_parametrization and the spline fields
    phi_parametrization: str = "xy"
    spline_n_basis: int = 10
    spline_degree: int = 3
    spline_domain: tuple = (0.0, 6.283185307179586)
    # fused CUDA S+U NB likelihood (ops/nb_kernels.py); NegativeBinomial only
    use_fused_nb: bool = False
    # see PhaseData.disp_grad
    disp_grad: bool = True


VELOCITY_TENSOR_FIELDS = (
    "S", "U", "logS", "logU", "count_factor", "mu_nu", "sd_nu",
    "phixy_prior", "D", "Db", "mu_dnu", "sd_dnu", "mu_gamma", "sd_gamma",
    "mu_beta", "sd_beta", "mu_nuomega", "sd_nuomega", "gamma_alpha",
    "gamma_beta", "sigma_s_gc", "sigma_u_gc", "rho_mean", "rho_std",
    "rho_scale", "phi_prior", "lgamma_k_sum",
)


@dataclasses.dataclass
class Metapars:
    """Host-side wrapper: device data + prior containers + model selection."""

    data: Any                     # PhaseData or VelocityData
    model_fn: Callable
    guide_fn: Callable
    cycle_prior: Any = None       # Cycle
    phase_prior: Any = None       # Phases
    speed_prior: Any = None       # AngularSpeed
    condition: Any = None         # names conditioned on (informational)
    extras: Optional[dict] = None

    def __getattr__(self, name):
        # convenience passthrough to the device container's fields
        data = object.__getattribute__(self, "data")
        try:
            return getattr(data, name)
        except AttributeError as e:
            raise AttributeError(name) from e
