"""Constraint transforms: the bijections of variational parameters and of
the MCMC backend's latent sites.

Parameters live unconstrained in the SVI state (and latent sites in the
sampler's flat vector) and are mapped through a bijector, so updates are
unconstrained.  As in `velocycle_tpu/core/constraints.py`: ``positive`` is
softplus (not exp), ``interval(low, high)`` a scaled sigmoid,
``unit_interval`` the interval (0, 1), and ``circular`` wraps into [-pi,
pi).  `log_abs_det_jacobian` is the change-of-variables term the MCMC
backend adds, and `biject_to` maps a distribution's named support to its
bijection.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "Constraint", "real", "positive", "circular", "interval",
    "unit_interval", "biject_to",
]


class Constraint:
    name = "real"

    def forward(self, u):
        """unconstrained -> constrained"""
        return u

    def inverse(self, x):
        """constrained -> unconstrained (used once at init)"""
        return x

    def log_abs_det_jacobian(self, u):
        """log |d forward(u) / du| elementwise: the change-of-variables term
        the MCMC backend adds to the unconstrained log-density."""
        return torch.zeros_like(torch.as_tensor(u))


class _Real(Constraint):
    name = "real"


class _Circular(Constraint):
    """S^1 wrapping: the unconstrained value is an angle on the real line and
    `forward` wraps it into [-pi, pi).  A circular density is periodic, so
    the Jacobian is 1 and HMC trajectories simply wrap."""

    name = "circular"

    def forward(self, u):
        return torch.remainder(u + math.pi, 2.0 * math.pi) - math.pi

    def inverse(self, x):
        return torch.as_tensor(x)


class _Positive(Constraint):
    """softplus bijection: smooth, no overflow for large |u|."""

    name = "positive"

    def forward(self, u):
        return _softplus(u)

    def inverse(self, x):
        x = torch.as_tensor(x)
        return x + torch.log(-torch.expm1(-x))

    def log_abs_det_jacobian(self, u):
        """d softplus(u) / du = sigmoid(u), whose log is -softplus(-u)."""
        return -_softplus(-torch.as_tensor(u))


class _Interval(Constraint):
    """``low + (high - low) * sigmoid(u)``."""

    name = "interval"

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def forward(self, u):
        return self.low + (self.high - self.low) * torch.reciprocal(
            1.0 + torch.exp(-u)
        )

    def inverse(self, x):
        p = (torch.as_tensor(x) - self.low) / (self.high - self.low)
        p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
        return torch.log(p) - torch.log1p(-p)

    def log_abs_det_jacobian(self, u):
        """log |d forward(u) / du| elementwise: log((high - low) s (1 - s))
        with s = sigmoid(u).  The bounds may be tensors (a Uniform's)."""
        u = torch.as_tensor(u)
        width = self.high - self.low
        log_w = (torch.log(width) if isinstance(width, torch.Tensor)
                 else math.log(width))
        return log_w - _softplus(-u) - _softplus(u)


def _softplus(u):
    return torch.logaddexp(u, torch.zeros((), dtype=u.dtype, device=u.device))


def interval(low, high):
    return _Interval(low, high)


real = _Real()
positive = _Positive()
circular = _Circular()
unit_interval = _Interval(0.0, 1.0)


def biject_to(support_name):
    """Constraint for a named support ("real", "positive", "unit_interval",
    "circular", or ("interval", low, high))."""
    if isinstance(support_name, tuple) and support_name[0] == "interval":
        return _Interval(support_name[1], support_name[2])
    return {
        "real": real,
        "positive": positive,
        "unit_interval": unit_interval,
        "circular": circular,
    }[support_name]
