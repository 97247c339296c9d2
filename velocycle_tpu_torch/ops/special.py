"""Special functions as plain arithmetic: the plain versions of the device
functions in `csrc/nb_common.cuh`.

The fused NB kernels evaluate lgamma/digamma differences for integer counts
in the threshold-2 ratio form of `velocycle_tpu/ops/special.py`; these are
the same formulas in torch, in the same operation order, so the CPU tests
and the kernels' on-card comparisons hold one arithmetic.

  * `lgamma_pos`: Lanczos (g=7, n=9), for lgamma(k+1).
  * `softplus_log_sigmoid`: softplus, log sigmoid, sigmoid and its
    complement, overflow-safe, sharing one exp, and free of the
    cancellation of ``x - softplus(x)`` and ``1 - sigmoid(x)`` at large x
    (the NB element at small dispersion).
  * `lgamma_digamma_ratio`: (lgamma(k+a) - lgamma(a), digamma(k+a) -
    digamma(a)) with exact masked sums for k < 2 and shared Stirling
    differences at arguments >= a+2.  Its digamma half truncates to about
    1.6e-5 absolute near k+a = 2 (see tests/test_torch_special.py).
"""
from __future__ import annotations

import torch

__all__ = [
    "lgamma_pos", "softplus_log_sigmoid", "lgamma_digamma_ratio",
]

_LANCZOS_G = 7.0
_LANCZOS_C0 = 0.99999999999980993
_LANCZOS_C = (
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)
_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)


def lgamma_pos(x):
    """log Gamma(x) for x > 0 (Lanczos, g=7, n=9)."""
    z = x - 1.0
    series = _LANCZOS_C0
    for i, c in enumerate(_LANCZOS_C):
        series = series + c / (z + (i + 1.0))
    t = z + _LANCZOS_G + 0.5
    return _HALF_LOG_2PI + (z + 0.5) * torch.log(t) - t + torch.log(series)


def softplus_log_sigmoid(x, with_sigmoid=True):
    """(softplus(x), log sigmoid(x), sigmoid(x), 1 - sigmoid(x)) sharing one
    exp, one log1p and one reciprocal; ``with_sigmoid=False`` returns the
    first two only.

    log sigmoid(x) = x - softplus(x) is taken as min(x, 0) - log1p(exp(-|x|))
    and 1 - sigmoid(x) as sigmoid(-x): both keep their float32 precision
    where x is large, when the differences would cancel."""
    e = torch.exp(-torch.abs(x))
    l1 = torch.log1p(e)
    sp = torch.clamp(x, min=0.0) + l1
    log_sig = torch.clamp(x, max=0.0) - l1
    if not with_sigmoid:
        return sp, log_sig
    d = 1.0 / (1.0 + e)
    ed = e * d
    pos = x >= 0.0
    return sp, log_sig, torch.where(pos, d, ed), torch.where(pos, ed, d)


def lgamma_digamma_ratio(k, a):
    """(lgamma(k+a) - lgamma(a), digamma(k+a) - digamma(a)) for integer
    counts ``k >= 0`` and per-gene ``a > 0`` broadcast along the cells."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    masks = [k > j for j in range(2)]
    logs = [torch.log(a + j) for j in range(2)]    # per-gene columns
    invs = [1.0 / (a + j) for j in range(2)]
    small_l = sum(torch.where(masks[j], logs[j], zero) for j in range(2))
    small_d = sum(torch.where(masks[j], invs[j], zero) for j in range(2))
    full_l = sum(logs)
    full_d = sum(invs)

    # Stirling differences at args >= 2: y = a+2, x = k-2 (clamped)
    y = a + 2.0
    x = torch.clamp(k - 2.0, min=0.0)
    ka = y + x
    inv_y = 1.0 / y
    inv2_y = inv_y * inv_y
    log_y = torch.log(y)
    l1p = torch.log1p(x * inv_y)
    inv = 1.0 / ka
    inv2 = inv * inv
    rc_ka = inv * (1.0 / 12.0 - inv2 * (
        1.0 / 360.0 - inv2 * (1.0 / 1260.0 - inv2 * (1.0 / 1680.0))
    ))
    rc_y = inv_y * (1.0 / 12.0 - inv2_y * (
        1.0 / 360.0 - inv2_y * (1.0 / 1260.0 - inv2_y * (1.0 / 1680.0))
    ))
    stir_l = (y - 0.5 + x) * l1p + x * log_y - x + rc_ka - rc_y
    tail_ka = -0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)
    )
    tail_y = -0.5 * inv_y - inv2_y * (
        1.0 / 12.0 - inv2_y * (1.0 / 120.0 - inv2_y / 252.0)
    )
    stir_d = l1p + tail_ka - tail_y

    lt = k < 2
    return (
        torch.where(lt, small_l, full_l + stir_l),
        torch.where(lt, small_d, full_d + stir_d),
    )
