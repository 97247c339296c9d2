"""B-spline bases on 1-D and 2-D manifolds.

Port of `velocycle_tpu/ops/splines.py`: the Cox-de Boor recursion unrolled
over the (static) degree as vectorized torch on a ``(..., n_knots)``
lattice, with the last nonempty knot interval closed on the right so that
the domain's end is supported; derivatives by the analytic B-spline
derivative recurrence.  Everything is differentiable in the evaluation
points, so gradients reach the latent coordinate through the basis.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "spline_knots",
    "spline_basis",
    "spline_basis_auto",
    "spline_basis_2d",
    "spline_basis_2d_der",
]


def spline_knots(low, high, n_basis, degree=3):
    """Open (clamped) uniform knot vector with ``n_basis`` basis functions:
    length n_basis + degree + 1, endpoints repeated degree+1 times."""
    interior = n_basis - degree - 1
    if interior < 0:
        raise ValueError(
            f"n_basis={n_basis} must be > degree={degree}"
        )
    inner = np.linspace(low, high, interior + 2)
    return np.concatenate([
        np.full(degree, low), inner, np.full(degree, high),
    ]).astype(np.float32)


def _degree0(x, t, domain_end):
    xe = x[..., None]
    inside = (xe >= t[:-1]) & (xe < t[1:])
    # right-closed last nonempty interval so x == domain end is supported
    at_end = (xe == domain_end) & (t[:-1] < t[1:]) & (t[1:] == domain_end)
    return (inside | at_end).to(x.dtype)


def _ratio(num, den):
    """``num / den`` where the knot span ``den`` is positive, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros((), dtype=num.dtype, device=num.device))


def _cox_de_boor(x, t, degree):
    """All degree-``degree`` B-spline basis values: (..., n_basis)."""
    B = _degree0(x, t, t[-1])
    xe = x[..., None]
    for k in range(1, degree + 1):
        w1 = _ratio(xe - t[: -k - 1], t[k:-1] - t[: -k - 1])
        w2 = _ratio(t[k + 1:] - xe, t[k + 1:] - t[1:-k])
        B = w1 * B[..., :-1] + w2 * B[..., 1:]
    return B


def spline_basis(x, knots, degree=3, der=0):
    """B-spline design matrix (or its derivative) at points ``x``.

    Args:
      x: evaluation points, any shape.
      knots: knot vector of length n_basis + degree + 1.
      degree: spline degree (static).
      der: 0 for the basis, 1 for d/dx.

    Returns:
      (..., n_basis) tensor on ``x``'s device.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    t = torch.as_tensor(np.asarray(knots, np.float32), device=x.device)
    if der == 0:
        return _cox_de_boor(x, t, degree)
    if der == 1:
        # B'_{i,k} = k * (B_{i,k-1}/(t_{i+k}-t_i) - B_{i+1,k-1}/(t_{i+k+1}-t_{i+1}))
        if degree == 0:
            return torch.zeros(x.shape + (len(t) - 1,), dtype=x.dtype,
                               device=x.device)
        Bm1 = _cox_de_boor(x, t, degree - 1)  # (..., n_basis + 1)
        term1 = _ratio(Bm1[..., :-1], t[degree:-1] - t[: -degree - 1])
        term2 = _ratio(Bm1[..., 1:], t[degree + 1:] - t[1:-degree])
        return degree * (term1 - term2)
    raise ValueError(f"der={der} is not allowed, use 0 or 1")


def spline_basis_auto(x, der=0, n_basis=10, degree=3, domain=None,
                      include_constant=True):
    """Basis with knots over ``domain`` (default: the range of ``x``), with
    an optional leading constant column (zero for the derivative)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if domain is None:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = domain
    B = spline_basis(x, spline_knots(lo, hi, n_basis, degree), degree, der)
    if include_constant:
        head = (torch.ones_like(x) if der == 0 else torch.zeros_like(x))
        B = torch.cat([head[..., None], B], dim=-1)
    return B


def _outer(a, b):
    return (a[..., :, None] * b[..., None, :]).reshape(
        *a.shape[:-1], a.shape[-1] * b.shape[-1]
    )


def spline_basis_2d(x, y, knots_x, knots_y, degree=3,
                    include_constant=True):
    """Tensor-product 2-D basis: (..., nx*ny [+1]) with an optional leading
    constant column."""
    prod = _outer(spline_basis(x, knots_x, degree),
                  spline_basis(y, knots_y, degree))
    if include_constant:
        prod = torch.cat([torch.ones_like(prod[..., :1]), prod], dim=-1)
    return prod


def spline_basis_2d_der(x, y, knots_x, knots_y, degree=3,
                        include_constant=True):
    """(d/dx, d/dy) of the tensor-product basis."""
    Bx = spline_basis(x, knots_x, degree)
    By = spline_basis(y, knots_y, degree)
    dBx = spline_basis(x, knots_x, degree, der=1)
    dBy = spline_basis(y, knots_y, degree, der=1)

    def _prod(a, b):
        out = _outer(a, b)
        if include_constant:
            out = torch.cat([torch.zeros_like(out[..., :1]), out], dim=-1)
        return out

    return _prod(dBx, By), _prod(Bx, dBy)
