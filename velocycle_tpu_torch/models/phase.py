"""Manifold-learning (phase inference) model and guide.

Port of `phase_model` / `phase_guide` of `velocycle_tpu/models/phase.py`:

  nu        ~ Normal(mu_nu, sd_nu)           per gene, (Ng, Nh) coeffs
  delta_nu  ~ Normal(0, sd_dnu)              per batch x gene, (Nb, Ng)
  phi_xy    ~ Normal(phixy_prior, 1)         per cell, (Nc, 2)
  phi       = atan2(phi_xy)                  deterministic
  zeta      = fourier_basis(phi)             (Nc, Nh)
  ElogS     = nu @ zeta^T + Db-weighted delta_nu + count_factor   (Ng, Nc)
  S | ...   ~ NegativeBinomial / Poisson / Lognormal

With ``use_fused_nb`` (NB only) the likelihood is one fused call
(`ops.nb_kernels.nb_loglik_fused`: the CUDA kernels on the card), and no
(Ng, Nc) ElogS is ever formed.

The LBA variant (`phase_model_lba`/`phase_guide_lba`) puts a per-gene
Bernoulli "is this gene periodic?" indicator over two branches, the full
basis and the constant column alone, and sums it out analytically;
`phase_model_lba_enum` writes the same mixture with an explicit enumerated
``periodic`` site for `infer.TraceEnum_ELBO`.  Both run in plain torch
(the JAX package runs them in plain jnp: no kernel).
"""
from __future__ import annotations

import torch

from ..core import constraints
from ..core import distributions as dist
from ..core import handlers
from ..core.handlers import deterministic, param, plate, sample
from ..ops.likelihoods import nb_logpmf
from ..ops.nb_kernels import nb_loglik_fused
from .basis import expression_basis, guide_phi, sample_phi

__all__ = [
    "phase_model",
    "phase_guide",
    "phase_model_lba",
    "phase_guide_lba",
    "phase_model_lba_enum",
]


def _expected_log_s(nu, zeta, delta_nu, mp):
    """ElogS (Ng, Nc) = nu @ zeta^T [+ batch offsets] + count_factor."""
    ElogS = nu @ zeta.T
    if mp.with_delta_nu and delta_nu is not None:
        ElogS = ElogS + delta_nu.T @ mp.Db
    return ElogS + mp.count_factor[None, :]


def _sample_shape_inv(mp):
    with plate("genes", mp.Ng, dim=-1):
        return sample(
            "shape_inv",
            dist.Gamma(
                mp.gamma_alpha.expand(mp.Ng), mp.gamma_beta.expand(mp.Ng)
            ),
        )


def _observe_spliced(mp, ElogS):
    if mp.noisemodel == "Lognormal":
        sample("logS", dist.Normal(ElogS, mp.sigma_gc), obs=mp.logS)
        return
    if mp.noisemodel == "Poisson":
        sample("S", dist.Poisson(torch.exp(ElogS)), obs=mp.S)
        return
    if mp.noisemodel == "NegativeBinomial":
        shape_inv = _sample_shape_inv(mp)
        sample(
            "S",
            dist.NegativeBinomial(
                mean=torch.exp(ElogS), dispersion=shape_inv[:, None]
            ),
            obs=mp.S,
        )
        return
    raise ValueError(f"{mp.noisemodel} not allowed")


def _sample_delta_nu(mp):
    """The batch offsets (Nb, Ng) inside the genes plate, or None."""
    if not mp.with_delta_nu:
        return None
    with plate("batches", mp.Nb, dim=-3):
        return sample(
            "delta_nu",
            dist.Normal(
                torch.zeros((mp.Nb, mp.Ng), device=mp.device), mp.sd_dnu
            ),
        )


def phase_model(mp):
    """mp: a `PhaseData` (models.metapars)."""
    with plate("genes", mp.Ng, dim=-2):
        nu = sample(
            "nu", dist.Normal(mp.mu_nu, mp.sd_nu).to_event(1)
        )  # (Ng, Nh)
        delta_nu = _sample_delta_nu(mp)
    phi = sample_phi(mp)
    zeta = expression_basis(mp, phi, der=0)  # (Nc, Nh)
    deterministic("zeta", zeta)

    if mp.use_fused_nb and mp.noisemodel == "NegativeBinomial":
        shape_inv = _sample_shape_inv(mp)
        cf = mp.count_factor.expand(mp.Nc).contiguous()
        handlers.factor(
            "S_fused",
            nb_loglik_fused(
                mp.S, nu, zeta, cf, shape_inv,
                delta_nu if mp.with_delta_nu else None,
                mp.Db if mp.with_delta_nu else None,
                lgamma_k_sum=mp.lgamma_k_sum,
                disp_grad=mp.disp_grad,
            ),
        )
        return

    ElogS = _expected_log_s(nu, zeta, delta_nu, mp)
    deterministic("ElogS", ElogS)
    _observe_spliced(mp, ElogS)


def _guide_gene_tail(mp):
    """shape_inv and delta_nu Delta sites of both phase guides (inside
    the genes plate)."""
    if mp.noisemodel == "NegativeBinomial":
        shape_inv_locs = param(
            "shape_inv_locs",
            torch.ones((mp.Ng,), device=mp.device)
            * mp.gamma_alpha / mp.gamma_beta,
            constraint=constraints.positive,
        )
        sample("shape_inv", dist.Delta(shape_inv_locs))
    if mp.with_delta_nu:
        dnu_locs = param(
            "delta_nu_locs",
            torch.ones((mp.Nb, mp.Ng), device=mp.device) * mp.mu_dnu,
        )
        with plate("batches", mp.Nb, dim=-3):
            sample("delta_nu", dist.Delta(dnu_locs))


def phase_guide(mp):
    """Mean-field guide: Normal for nu with learnable scales, Delta for
    delta_nu and shape_inv, `guide_phi`'s family for the phases."""
    nu_locs = param("nu_locs", mp.mu_nu)
    nu_scales = param("nu_scales", mp.sd_nu, constraint=constraints.positive)

    with plate("genes", mp.Ng, dim=-2):
        sample("nu", dist.Normal(nu_locs, nu_scales).to_event(1))
        _guide_gene_tail(mp)

    guide_phi(mp)


# ---------------------------------------------------------------------------
# LBA: a per-gene Bernoulli "is this gene periodic?" indicator
# ---------------------------------------------------------------------------

def _lba_prologue(mp):
    """The sites both LBA models share, in the JAX package's order:
    (nu, delta_nu, periodic_prob, zeta, shape_inv or None)."""
    with plate("genes", mp.Ng, dim=-2):
        nu = sample("nu", dist.Normal(mp.mu_nu, mp.sd_nu).to_event(1))
        delta_nu = _sample_delta_nu(mp)
        periodic_prob = sample(
            "periodic_prob",
            dist.Beta(mp.beta0.expand(mp.Ng), mp.beta1.expand(mp.Ng)),
        )  # (Ng,)
    phi = sample_phi(mp)
    zeta = expression_basis(mp, phi, der=0)
    deterministic("zeta", zeta)
    # the dispersion is shared by both branches
    shape_inv = (_sample_shape_inv(mp)
                 if mp.noisemodel == "NegativeBinomial" else None)
    return nu, delta_nu, periodic_prob, zeta, shape_inv


def _flat_log_s(nu, zeta, delta_nu, mp):
    """ElogS of the constant-only branch: the nu0 column alone."""
    return _expected_log_s(nu[:, :1], zeta.new_ones((mp.Nc, 1)), delta_nu,
                           mp)


def _lba_branch_loglik(mp, ElogS, shape_inv):
    """Per-gene data log-likelihood (Ng,) for a given ElogS."""
    if mp.noisemodel == "NegativeBinomial":
        lp = nb_logpmf(mp.S, ElogS, shape_inv[:, None])
    elif mp.noisemodel == "Poisson":
        lp = dist.Poisson(torch.exp(ElogS)).log_prob(mp.S)
    elif mp.noisemodel == "Lognormal":
        lp = dist.Normal(ElogS, mp.sigma_gc).log_prob(mp.logS)
    else:
        raise ValueError(f"{mp.noisemodel} not allowed")
    return lp.sum(-1)


def phase_model_lba(mp):
    """LBA phase model: the per-gene mixture over periodicity, summed out
    analytically (one factor per gene)."""
    nu, delta_nu, periodic_prob, zeta, shape_inv = _lba_prologue(mp)
    ElogS_full = _expected_log_s(nu, zeta, delta_nu, mp)
    ElogS_flat = _flat_log_s(nu, zeta, delta_nu, mp)
    deterministic("ElogS", ElogS_full)

    p = torch.clamp(periodic_prob, 1e-6, 1 - 1e-6).expand(mp.Ng)
    joint = torch.stack([
        torch.log1p(-p) + _lba_branch_loglik(mp, ElogS_flat, shape_inv),
        torch.log(p) + _lba_branch_loglik(mp, ElogS_full, shape_inv),
    ])  # (2, Ng)
    marginal = torch.logsumexp(joint, dim=0)
    handlers.factor("S_mixture", marginal)
    # posterior membership, the reference's `periodic` site
    deterministic("periodic", torch.exp(joint[1] - marginal))


def phase_model_lba_enum(mp):
    """The LBA model with an explicit enumerated Bernoulli ``periodic``
    site, the reference's form: fit it with `infer.TraceEnum_ELBO`, which
    sums the indicator out exactly (the same ELBO and gradients as
    `phase_model_lba`).  Under enumeration ``periodic`` carries a leading
    (2,) axis and ``torch.where`` broadcasts the two branches over it."""
    nu, delta_nu, periodic_prob, zeta, shape_inv = _lba_prologue(mp)
    p = torch.clamp(periodic_prob, 1e-6, 1 - 1e-6)[:, None]  # (Ng, 1)
    periodic = sample(
        "periodic", dist.Bernoulli(p), infer={"enumerate": "parallel"}
    )
    ElogS_full = _expected_log_s(nu, zeta, delta_nu, mp)
    ElogS = torch.where(periodic == 1.0, ElogS_full,
                        _flat_log_s(nu, zeta, delta_nu, mp))
    deterministic("ElogS", ElogS_full)

    if mp.noisemodel == "NegativeBinomial":
        sample(
            "S",
            dist.NegativeBinomial(
                mean=torch.exp(ElogS), dispersion=shape_inv[:, None]
            ),
            obs=mp.S,
        )
    elif mp.noisemodel == "Poisson":
        sample("S", dist.Poisson(torch.exp(ElogS)), obs=mp.S)
    elif mp.noisemodel == "Lognormal":
        sample("logS", dist.Normal(ElogS, mp.sigma_gc), obs=mp.logS)
    else:
        raise ValueError(f"{mp.noisemodel} not allowed")


def _clipped_sigmoid(x):
    finfo = torch.finfo(torch.float32)
    z = torch.clamp(x, finfo.min + 10 * finfo.eps, finfo.max - 10 * finfo.eps)
    s = torch.reciprocal(1.0 + torch.exp(-z))
    return torch.clamp(s, finfo.eps, 1.0 - finfo.eps)


def phase_guide_lba(mp):
    """LBA guide: the mean-field guide plus a Delta at
    ``clipped_sigmoid(logit + logit(beta0 / (beta0 + beta1)))`` for
    periodic_prob."""
    nu_locs = param("nu_locs", mp.mu_nu)
    nu_scales = param("nu_scales", mp.sd_nu, constraint=constraints.positive)

    avg_p = mp.beta0 / (mp.beta0 + mp.beta1)
    logit_avg = torch.log(avg_p / (1.0 - avg_p))
    logit_locs = param("logit_locs", torch.zeros((mp.Ng,), device=mp.device))

    with plate("genes", mp.Ng, dim=-2):
        sample("nu", dist.Normal(nu_locs, nu_scales).to_event(1))
        _guide_gene_tail(mp)
        sample(
            "periodic_prob",
            dist.Delta(_clipped_sigmoid(logit_locs + logit_avg)),
        )

    guide_phi(mp)
