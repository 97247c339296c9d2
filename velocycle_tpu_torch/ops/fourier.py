"""Fourier basis on S^1, and the basis dispatcher.

Columns ``[1, cos(phi), sin(phi), cos(2 phi), sin(2 phi), ...]`` or the
phi-derivative ``[0, -sin, cos, -2 sin(2 phi), 2 cos(2 phi), ...]`` — the
column order of `velocycle_tpu/ops/fourier.py`.  `basis` picks the Fourier
basis or the B-spline basis of `ops/splines.py` by ``kind``.
"""
from __future__ import annotations

import torch

__all__ = ["fourier_basis", "basis"]


def fourier_basis(phi, num_harmonics, der=0):
    """Fourier design matrix of shape ``phi.shape + (2*H + 1,)``."""
    phi = torch.as_tensor(phi, dtype=torch.float32)
    h = torch.arange(1, num_harmonics + 1, dtype=phi.dtype, device=phi.device)
    hphi = phi[..., None] * h                      # (..., H)
    cos, sin = torch.cos(hphi), torch.sin(hphi)
    if der == 0:
        pairs = torch.stack([cos, sin], dim=-1)    # (..., H, 2)
        head = torch.ones_like(phi)[..., None]
    elif der == 1:
        pairs = torch.stack([-h * sin, h * cos], dim=-1)
        head = torch.zeros_like(phi)[..., None]
    else:
        raise ValueError(f"der={der} is not allowed, use 0 or 1")
    interleaved = pairs.reshape(*pairs.shape[:-2], 2 * num_harmonics)
    return torch.cat([head, interleaved], dim=-1)


def basis(x, der=0, kind="fourier", **kwargs):
    """The basis at ``x``: ``kind="fourier"`` takes ``num_harmonics``
    (`fourier_basis`), ``kind="spline"`` the keywords of
    `ops.splines.spline_basis_auto` (n_basis, degree, domain)."""
    if kind == "fourier":
        if "num_harmonics" not in kwargs:
            raise ValueError(
                "num_harmonics needs to be provided if kind='fourier'"
            )
        return fourier_basis(x, num_harmonics=kwargs["num_harmonics"], der=der)
    if kind == "spline":
        from .splines import spline_basis_auto

        return spline_basis_auto(x, der=der, **kwargs)
    raise ValueError(f"kind={kind!r} is not valid; use 'fourier' or 'spline'")
