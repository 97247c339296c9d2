"""Basis and latent-coordinate plumbing for the phase and velocity models.

Port of `velocycle_tpu/models/basis.py`.  Every model calls these helpers,
so ``basis_kind="spline"`` turns the S^1 Fourier model into a
bounded-interval B-spline model (the 1-D pseudotime workflow) and
``phi_parametrization="wrapped"`` puts the phase itself on S^1, with no
change to the models.  As in the JAX package, any ``phi_parametrization``
other than ``"wrapped"`` acts as ``"xy"``.
"""
from __future__ import annotations

import torch

from ..core import constraints
from ..core import distributions as dist
from ..core.handlers import deterministic, param, plate, sample
from ..ops.circular import pack_direction
from ..ops.fourier import fourier_basis
from ..ops.splines import spline_basis_auto

__all__ = ["expression_basis", "omega_basis", "sample_phi", "guide_phi"]


def expression_basis(mp, phi, der=0):
    """Design matrix zeta (or d zeta/d phi) of the gene-expression series:
    ``2*num_harmonics_S + 1`` Fourier columns, or ``spline_n_basis + 1``
    spline columns (leading constant)."""
    if mp.basis_kind == "fourier":
        return fourier_basis(phi, mp.num_harmonics_S, der=der)
    if mp.basis_kind == "spline":
        return spline_basis_auto(
            phi, der=der, n_basis=mp.spline_n_basis, degree=mp.spline_degree,
            domain=mp.spline_domain, include_constant=True,
        )
    raise ValueError(f"basis_kind={mp.basis_kind!r} not in ('fourier', 'spline')")


def omega_basis(mp, phi):
    """Design matrix zeta_omega of the angular-speed series (Nhw columns).

    Spline: ``Nhw == 1`` is a constant speed over the manifold; otherwise
    a ``Nhw - 1``-function spline with a leading constant column."""
    if mp.basis_kind == "fourier":
        return fourier_basis(phi, mp.omega_harmonics, der=0)
    if mp.Nhw == 1:
        phi = torch.as_tensor(phi)
        return torch.ones(phi.shape + (1,), dtype=torch.float32,
                          device=phi.device)
    return spline_basis_auto(
        phi, der=0, n_basis=mp.Nhw - 1, degree=mp.spline_degree,
        domain=mp.spline_domain, include_constant=True,
    )


def _prior_angles(mp):
    return torch.atan2(mp.phixy_prior[:, 1], mp.phixy_prior[:, 0])


def sample_phi(mp):
    """Latent manifold coordinate, one per cell.

    Fourier, ``xy``: ``phi_xy ~ Normal(prior, 1)``, ``phi = atan2(phi_xy)``.
    Fourier, ``wrapped``: ``phi ~ VonMises(angle(prior), max(|prior|^2,
    1e-3))``.  Spline: ``phi ~ Uniform(spline_domain)``."""
    if mp.basis_kind == "fourier":
        if mp.phi_parametrization == "wrapped":
            kappa = torch.clamp((mp.phixy_prior**2).sum(-1), min=1e-3)
            with plate("cells", mp.Nc, dim=-1):
                return sample("phi", dist.VonMises(_prior_angles(mp), kappa))
        with plate("cells", mp.Nc, dim=-1):
            phi_xy = sample(
                "phi_xy", dist.Normal(mp.phixy_prior, 1.0).to_event(1)
            )  # (Nc, 2)
        phi = pack_direction(phi_xy)
        deterministic("phi", phi)
        return phi
    lo, hi = mp.spline_domain
    full = dict(dtype=torch.float32, device=mp.device)
    with plate("cells", mp.Nc, dim=-1):
        return sample(
            "phi",
            dist.Uniform(torch.full((mp.Nc,), lo, **full),
                         torch.full((mp.Nc,), hi, **full)),
        )


def guide_phi(mp):
    """Variational family of the manifold coordinate.

    Fourier, ``xy``: ``phi_xy ~ Normal(learnable locs, 1.0)``.  Fourier,
    ``wrapped``: a Delta at unconstrained ``phi_locs`` initialized at the
    prior angles.  Spline: a Delta at interval-constrained ``phi_locs``
    initialized at the phi prior, clipped 1e-4 of the domain inside it
    (or at its middle without a prior)."""
    if mp.basis_kind == "fourier":
        if mp.phi_parametrization == "wrapped":
            phi_locs = param("phi_locs", _prior_angles(mp))
            with plate("cells", mp.Nc, dim=-1):
                sample("phi", dist.Delta(phi_locs))
            return
        phixy_locs = param("phixy_locs", mp.phixy_prior)
        with plate("cells", mp.Nc, dim=-1):
            sample("phi_xy", dist.Normal(phixy_locs, 1.0).to_event(1))
        return
    lo, hi = mp.spline_domain
    init = mp.phi_prior
    if init is None:
        init = torch.full((mp.Nc,), 0.5 * (lo + hi), dtype=torch.float32,
                          device=mp.device)
    eps = 1e-4 * (hi - lo)
    init = torch.clamp(init.to(torch.float32), lo + eps, hi - eps)
    phi_locs = param(
        "phi_locs", init, constraint=constraints.interval(lo, hi)
    )
    with plate("cells", mp.Nc, dim=-1):
        sample("phi", dist.Delta(phi_locs))
