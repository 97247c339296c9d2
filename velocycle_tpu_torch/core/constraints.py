"""Constraint transforms for variational parameters.

Parameters live unconstrained in the SVI state and are mapped through a
bijector inside each step, so Adam updates are unconstrained.  ``positive``
is softplus (not exp) and ``interval(low, high)`` a scaled sigmoid, as in
`velocycle_tpu/core/constraints.py`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Constraint", "real", "positive", "interval"]


class Constraint:
    name = "real"

    def forward(self, u):
        """unconstrained -> constrained"""
        return u

    def inverse(self, x):
        """constrained -> unconstrained (used once at init)"""
        return x


class _Real(Constraint):
    name = "real"


class _Positive(Constraint):
    """softplus bijection: smooth, no overflow for large |u|."""

    name = "positive"

    def forward(self, u):
        return _softplus(u)

    def inverse(self, x):
        x = torch.as_tensor(x)
        return x + torch.log(-torch.expm1(-x))


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
        with s = sigmoid(u)."""
        u = torch.as_tensor(u)
        return (math.log(self.high - self.low) - _softplus(-u)
                - _softplus(u))


def _softplus(u):
    return torch.logaddexp(u, torch.zeros((), dtype=u.dtype, device=u.device))


def interval(low, high):
    return _Interval(low, high)


real = _Real()
positive = _Positive()
