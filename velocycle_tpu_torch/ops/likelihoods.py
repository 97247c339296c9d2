"""The Negative-Binomial and Poisson count likelihoods and the log-normal
density in plain torch.

NB parameterization: ``GammaPoisson(1/r, 1/(r * exp(ElogS)))`` with
per-gene dispersion r, in the cancellation-free form of
`velocycle_tpu/ops/likelihoods.py`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["lgamma_diff", "nb_logpmf", "poisson_logpmf", "lognormal_logpdf"]


def _stirling_rc(z):
    z2 = z * z
    return (
        (1.0 / 12.0) / z
        - (1.0 / 360.0) / (z * z2)
        + (1.0 / 1260.0) / (z * z2 * z2)
    )


def lgamma_diff(k, a):
    """``lgamma(k + a) - lgamma(a)``, as a Stirling log1p expansion for
    a >= 8, where every intermediate is O(k log a) instead of O(a log a)."""
    direct = torch.lgamma(k + a) - torch.lgamma(a)
    a_big = torch.clamp(a, min=8.0)
    stirling = (
        (a_big - 0.5) * torch.log1p(k / a_big)
        + k * torch.log(a_big + k)
        - k
        + _stirling_rc(a_big + k)
        - _stirling_rc(a_big)
    )
    return torch.where(a >= 8.0, stirling, direct)


def nb_logpmf(k, elog_mu, dispersion):
    """Negative-Binomial log-pmf at counts ``k``.

      lgamma(k+a) - lgamma(a)    -> `lgamma_diff`
      a*log b - (a+k)*log1p(b)   -> -a*softplus(s) - k*softplus(-s),
                                    s = elog_mu + log(r)

    ``k`` may be an integer tensor (int16 count storage); it is upcast
    once here."""
    k = k.to(torch.float32)
    a = 1.0 / dispersion
    s = elog_mu + torch.log(dispersion)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return (
        lgamma_diff(k, a)
        - torch.lgamma(k + 1.0)
        - a * torch.logaddexp(s, zero)
        - k * torch.logaddexp(-s, zero)
    )


def poisson_logpmf(k, elog_mu):
    """Poisson log-pmf at counts ``k`` with log-mean ``elog_mu``."""
    return k * elog_mu - torch.exp(elog_mu) - torch.lgamma(k + 1.0)


def lognormal_logpdf(logx, elog_mu, sigma):
    """Normal log-density of ``logx`` around ``elog_mu`` with scale
    ``sigma`` (the log-normal likelihood on log counts, no Jacobian)."""
    z = (logx - elog_mu) / sigma
    return -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi)
