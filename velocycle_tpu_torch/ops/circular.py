"""Circular (S^1) helpers: direction packing and circular statistics.

Port of `velocycle_tpu/ops/circular.py` on tensors.  The circular std is
the exact Bessel ratio sqrt(1 - I1(k)/I0(k)) (`torch.special.i0e`/`i1e`).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "pack_direction",
    "unpack_direction",
    "wrap_angle",
    "circular_std_from_concentration",
    "circular_corrcoef",
    "circular_mean",
    "circular_distance",
]


def unpack_direction(loc, concentration=1.0):
    """angle -> 2-vector on the circle scaled by concentration."""
    loc = torch.as_tensor(loc)
    return torch.stack([torch.cos(loc), torch.sin(loc)], dim=-1) * concentration


def pack_direction(xy_pair):
    """2-vector -> angle (atan2)."""
    return torch.atan2(xy_pair[..., 1], xy_pair[..., 0])


def wrap_angle(phi):
    """Wrap into [0, 2*pi)."""
    return torch.remainder(torch.as_tensor(phi), 2.0 * math.pi)


def circular_std_from_concentration(kappa):
    """sqrt(1 - I1(kappa)/I0(kappa)): the projected-normal circular std."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    ratio = torch.special.i1e(kappa) / torch.special.i0e(kappa)
    return torch.sqrt(1.0 - ratio)


def circular_corrcoef(x1, x2):
    """|mean(exp(i(x1 - x2)))|."""
    d = torch.as_tensor(x1) - torch.as_tensor(x2)
    return torch.sqrt(torch.mean(torch.cos(d)) ** 2
                      + torch.mean(torch.sin(d)) ** 2)


def circular_mean(phi, axis=None):
    """atan2 of the mean sine and cosine (over ``axis``, all when None)."""
    phi = torch.as_tensor(phi)
    dims = {} if axis is None else {"dim": axis}
    return torch.atan2(torch.mean(torch.sin(phi), **dims),
                       torch.mean(torch.cos(phi), **dims))


def circular_distance(a, b):
    """Shortest signed arc from b to a, in [-pi, pi)."""
    d = torch.as_tensor(a) - torch.as_tensor(b)
    return torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi
