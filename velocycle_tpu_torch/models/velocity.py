"""Velocity-learning model and its two guides.

Port of `velocity_model`, `velocity_guide` and `velocity_guide_lrmn` of
`velocycle_tpu/models/velocity.py`:

  log_gamma, log_beta ~ Normal         per gene, (Ng,)
  nu        ~ Normal(mu_nu, sd_nu)     (Ng, Nh)
  delta_nu  ~ Normal(0, sd_dnu)        (Nb, Ng)
  phi_xy    ~ Normal(prior, 1)         (Nc, 2)
  nu_omega  ~ Normal                   (Nx, Nhw) condition-level speed coeffs
  zeta, zeta_dphi = fourier(phi), d/dphi fourier(phi)        (Nc, Nh)
  zeta_omega      = fourier(phi, omega harmonics)            (Nc, Nhw)
  ElogS = nu @ zeta^T + batch offsets + count_factor         (Ng, Nc)
  omega_c = sum_x sum_h nu_omega[x,h] zeta_omega[c,h] D[x,c]   (Nc,)
  ElogU = -log_beta + log(relu((nu @ zeta_dphi^T) * omega + gamma) + 1e-5)
          + ElogS
  S, U | ... ~ NB / Poisson / Lognormal  (both observed)

With ``use_fused_nb`` (NB only) the S+U likelihood is one fused call
(`ops.nb_kernels.nbsu_loglik_fused`: the CUDA kernels on the card), and no
(Ng, Nc) ElogS, ElogU or dEs is ever formed.

The LRMN guide is the structured family: one LowRankMultivariateNormal draw
over [log_gamma (Ng), nu_omega (Nx*Nhw)] feeding Delta sites, plus a
conditional-Normal regression of log_beta on log_gamma with correlation
rho = 1.998*sigmoid(rho_real/rho_scale) - 0.999.  The draw is an auxiliary
site: it carries no ELBO term, as in pyro, where it happens outside any
sample statement.
"""
from __future__ import annotations

import torch

from ..core import constraints
from ..core import distributions as dist
from ..core import handlers
from ..core.handlers import deterministic, param, plate, sample
from ..ops.nb_kernels import nbsu_loglik_fused
from .basis import expression_basis, guide_phi, omega_basis, sample_phi

__all__ = ["velocity_model", "velocity_guide", "velocity_guide_lrmn"]


def _omega(nu_omega, zeta_omega, D):
    """Per-cell angular speed, conditions routed by the one-hot design D:
    sum_x sum_h nu_omega[x, h] zeta_omega[c, h] D[x, c]."""
    return ((nu_omega @ zeta_omega.T) * D).sum(0)


def _velocity_core(mp, nu, delta_nu, phi, log_gamma, log_beta, nu_omega):
    """Shared deterministic pipeline: phi -> bases -> ElogS/omega/ElogU."""
    zeta = expression_basis(mp, phi, der=0)       # (Nc, Nh)
    zeta_dphi = expression_basis(mp, phi, der=1)  # (Nc, Nh)
    zeta_omega = omega_basis(mp, phi)             # (Nc, Nhw)
    deterministic("zeta", zeta)
    deterministic("zeta_dphi", zeta_dphi)
    deterministic("zeta_omega", zeta_omega)

    ElogS = nu @ zeta.T
    if mp.with_delta_nu and delta_nu is not None:
        ElogS = ElogS + delta_nu.T @ mp.Db
    ElogS = ElogS + mp.count_factor.expand(mp.Nc)[None, :]
    deterministic("ElogS", ElogS)

    omega = _omega(nu_omega, zeta_omega, mp.D)
    deterministic("omega", omega)

    dEs_dphi = nu @ zeta_dphi.T  # (Ng, Nc)
    gamma = torch.exp(log_gamma)
    ElogU = (
        -log_beta[:, None]
        + torch.log(
            torch.clamp(dEs_dphi * omega[None, :] + gamma[:, None], min=0.0)
            + 1e-5
        )
        + ElogS
    )
    deterministic("ElogU", ElogU)
    return ElogS, ElogU


def _sample_shape_inv(mp):
    with plate("genes", mp.Ng, dim=-1):
        return sample(
            "shape_inv",
            dist.Gamma(
                mp.gamma_alpha.expand(mp.Ng), mp.gamma_beta.expand(mp.Ng)
            ),
        )


def _observe_counts(mp, ElogS, ElogU):
    if mp.noisemodel == "Lognormal":
        sample("logS", dist.Normal(ElogS, mp.sigma_s_gc), obs=mp.logS)
        sample("logU", dist.Normal(ElogU, mp.sigma_u_gc), obs=mp.logU)
    elif mp.noisemodel == "Poisson":
        sample("S", dist.Poisson(torch.exp(ElogS)), obs=mp.S)
        sample("U", dist.Poisson(torch.exp(ElogU)), obs=mp.U)
    elif mp.noisemodel == "NegativeBinomial":
        r = _sample_shape_inv(mp)[:, None]
        sample(
            "S",
            dist.NegativeBinomial(mean=torch.exp(ElogS), dispersion=r),
            obs=mp.S,
        )
        sample(
            "U",
            dist.NegativeBinomial(mean=torch.exp(ElogU), dispersion=r),
            obs=mp.U,
        )
    else:
        raise ValueError(f"{mp.noisemodel} not allowed")


def velocity_model(mp):
    """mp: a `VelocityData`.  Also the LRMN model: with model_type "lrmn"
    it samples the rho_real site the LRMN guide pins."""
    with plate("genes", mp.Ng, dim=-2):
        log_gamma = sample(
            "log_gamma", dist.Normal(mp.mu_gamma, mp.sd_gamma)
        )  # (Ng,)
        log_beta = sample("log_beta", dist.Normal(mp.mu_beta, mp.sd_beta))
        if mp.model_type == "lrmn":
            sample(
                "rho_real",
                dist.Normal(mp.rho_mean.expand(mp.Ng), mp.rho_std),
            )
        deterministic("gamma", torch.exp(log_gamma))
        nu = sample("nu", dist.Normal(mp.mu_nu, mp.sd_nu).to_event(1))
        delta_nu = None
        if mp.with_delta_nu:
            with plate("batches", mp.Nb, dim=-3):
                delta_nu = sample(
                    "delta_nu",
                    dist.Normal(
                        torch.zeros((mp.Nb, mp.Ng), device=mp.device),
                        mp.sd_dnu,
                    ),
                )

    phi = sample_phi(mp)

    with plate("conditions", mp.Nx, dim=-4):
        with plate("harmonics", mp.Nhw, dim=-3):
            nu_omega = sample(
                "nu_omega", dist.Normal(mp.mu_nuomega, mp.sd_nuomega)
            )  # (Nx, Nhw)

    if mp.use_fused_nb and mp.noisemodel == "NegativeBinomial":
        zeta = expression_basis(mp, phi, der=0)
        zeta_dphi = expression_basis(mp, phi, der=1)
        omega = _omega(nu_omega, omega_basis(mp, phi), mp.D).contiguous()
        deterministic("omega", omega)
        shape_inv = _sample_shape_inv(mp)
        cf = mp.count_factor.expand(mp.Nc).contiguous()
        handlers.factor(
            "SU_fused",
            nbsu_loglik_fused(
                mp.S, mp.U, nu, zeta, zeta_dphi, cf, omega,
                log_beta, log_gamma, shape_inv,
                delta_nu if mp.with_delta_nu else None,
                mp.Db if mp.with_delta_nu else None,
                lgamma_k_sum=mp.lgamma_k_sum,
                disp_grad=mp.disp_grad,
            ),
        )
        return

    ElogS, ElogU = _velocity_core(
        mp, nu, delta_nu, phi, log_gamma, log_beta, nu_omega
    )
    _observe_counts(mp, ElogS, ElogU)


def _guide_tail(mp):
    """delta_nu and shape_inv Delta sites, shared by both guides."""
    if mp.with_delta_nu:
        dnu_locs = param(
            "delta_nu_locs",
            torch.ones((mp.Nb, mp.Ng), device=mp.device) * mp.mu_dnu,
        )
        with plate("batches", mp.Nb, dim=-3):
            sample("delta_nu", dist.Delta(dnu_locs))
    if mp.noisemodel == "NegativeBinomial":
        shape_inv_locs = param(
            "shape_inv_locs",
            torch.ones((mp.Ng,), device=mp.device)
            * mp.gamma_alpha / mp.gamma_beta,
            constraint=constraints.positive,
        )
        sample("shape_inv", dist.Delta(shape_inv_locs))


def velocity_guide(mp):
    """Mean-field guide."""
    lg_locs = param("log_gamma_locs", mp.mu_gamma)
    lg_scales = param(
        "log_gamma_scales", mp.sd_gamma, constraint=constraints.positive
    )
    lb_locs = param("log_beta_locs", mp.mu_beta)
    lb_scales = param(
        "log_beta_scales", mp.sd_beta, constraint=constraints.positive
    )
    nu_locs = param("nu_locs", mp.mu_nu)
    nu_scales = param("nu_scales", mp.sd_nu, constraint=constraints.positive)
    nuw_locs = param("nu_omega_locs", mp.mu_nuomega)
    nuw_scales = param(
        "nu_omega_scales", mp.sd_nuomega, constraint=constraints.positive
    )

    with plate("genes", mp.Ng, dim=-2):
        sample("log_gamma", dist.Normal(lg_locs, lg_scales))
        sample("log_beta", dist.Normal(lb_locs, lb_scales))
        sample("nu", dist.Normal(nu_locs, nu_scales).to_event(1))
        _guide_tail(mp)

    with plate("conditions", mp.Nx, dim=-4):
        with plate("harmonics", mp.Nhw, dim=-3):
            sample("nu_omega", dist.Normal(nuw_locs, nuw_scales))

    guide_phi(mp)


def velocity_guide_lrmn(mp):
    """Structured LRMN guide: joint low-rank MVN over [log_gamma (Ng),
    nu_omega (Nx*Nhw)], Delta-pinned slices, and a conditional-Normal
    regression of log_beta on log_gamma."""
    nu_locs = param("nu_locs", mp.mu_nu)
    nu_scales = param("nu_scales", mp.sd_nu, constraint=constraints.positive)
    lb_locs = param("log_beta_locs", mp.mu_beta)
    lb_scales = param(
        "log_beta_scales", mp.sd_beta, constraint=constraints.positive
    )

    lrmv_dims = mp.Ng + mp.Nhw * mp.Nx
    loc = param("loc", torch.cat([mp.mu_gamma, mp.mu_nuomega.reshape(-1)]))
    # a small constant init (the reference clips a small random one)
    cov_factor = param(
        "cov_factor",
        torch.full((lrmv_dims, mp.rho_rank), 0.01, device=mp.device),
        constraint=constraints.positive,
    )
    cov_diag = param(
        "cov_diag",
        torch.cat([mp.sd_gamma, mp.sd_nuomega.reshape(-1)]) ** 2,
        constraint=constraints.positive,
    )
    rho_real_loc = param(
        "rho_real_loc", torch.ones((mp.Ng,), device=mp.device) * mp.rho_mean
    )

    lrmn = dist.LowRankMultivariateNormal(
        loc=loc, cov_factor=cov_factor, cov_diag=cov_diag
    )
    # a single reparameterized draw feeding the Delta sites below
    x = sample("_lrmn_draw", lrmn, infer={"is_auxiliary": True})

    with plate("genes", mp.Ng, dim=-2):
        log_gamma = sample("log_gamma", dist.Delta(x[: mp.Ng]))
        sample("nu", dist.Normal(nu_locs, nu_scales).to_event(1))
        rho_real = sample("rho_real", dist.Delta(rho_real_loc))
        rho = torch.reciprocal(1.0 + torch.exp(-rho_real / mp.rho_scale))
        rho = rho * 1.998 - 0.999
        _guide_tail(mp)

    # conditional regression beta | gamma with per-gene correlation rho
    loc_gammas = loc[: mp.Ng]
    cov_gamma_diag = (cov_factor[: mp.Ng] ** 2).sum(-1) + cov_diag[: mp.Ng]
    scale_gammas = torch.sqrt(cov_gamma_diag)
    mu_beta_given_gamma = lb_locs + rho * lb_scales * (
        log_gamma - loc_gammas
    ) / scale_gammas
    std_beta_given_gamma = lb_scales * torch.sqrt(1.0 - rho**2)
    with plate("genes", mp.Ng, dim=-2):
        sample(
            "log_beta",
            dist.Normal(mu_beta_given_gamma, std_beta_given_gamma),
        )

    with plate("conditions", mp.Nx, dim=-4):
        with plate("harmonics", mp.Nhw, dim=-3):
            sample(
                "nu_omega",
                dist.Delta(x[mp.Ng:].reshape((mp.Nx, mp.Nhw))),
            )

    guide_phi(mp)
