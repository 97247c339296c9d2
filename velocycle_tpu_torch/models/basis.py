"""Basis and latent-coordinate plumbing for the phase and velocity models:
the Fourier kind with the ``xy`` parametrization of `velocycle_tpu/models/
basis.py` (the spline kind and the wrapped phases are not ported yet)."""
from __future__ import annotations

from ..core import distributions as dist
from ..core.handlers import deterministic, param, plate, sample
from ..ops.circular import pack_direction
from ..ops.fourier import fourier_basis

__all__ = ["expression_basis", "omega_basis", "sample_phi", "guide_phi"]


def _check_supported(mp):
    if mp.basis_kind != "fourier" or mp.phi_parametrization != "xy":
        raise NotImplementedError(
            f"basis_kind={mp.basis_kind!r}, phi_parametrization="
            f"{mp.phi_parametrization!r}: the port has the Fourier basis "
            "with the 'xy' phase parametrization only"
        )


def expression_basis(mp, phi, der=0):
    """Design matrix zeta (or d zeta/d phi), ``2*num_harmonics_S + 1``
    columns."""
    _check_supported(mp)
    return fourier_basis(phi, mp.num_harmonics_S, der=der)


def omega_basis(mp, phi):
    """Design matrix zeta_omega of the angular-speed series,
    ``2*omega_harmonics + 1`` columns."""
    _check_supported(mp)
    return fourier_basis(phi, mp.omega_harmonics, der=0)


def sample_phi(mp):
    """``phi_xy ~ Normal(prior, 1)`` per cell, ``phi = atan2(phi_xy)``."""
    _check_supported(mp)
    with plate("cells", mp.Nc, dim=-1):
        phi_xy = sample(
            "phi_xy", dist.Normal(mp.phixy_prior, 1.0).to_event(1)
        )  # (Nc, 2)
    phi = pack_direction(phi_xy)
    deterministic("phi", phi)
    return phi


def guide_phi(mp):
    """``phi_xy ~ Normal(learnable locs, 1.0)``."""
    _check_supported(mp)
    phixy_locs = param("phixy_locs", mp.phixy_prior)
    with plate("cells", mp.Nc, dim=-1):
        sample("phi_xy", dist.Normal(phixy_locs, 1.0).to_event(1))
