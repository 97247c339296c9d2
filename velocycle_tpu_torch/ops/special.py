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
  * `lgamma_ratio2`: the lgamma half alone (the loss-only element).
  * `lgamma_digamma_excess`: both ratios and ``k - a * (digamma(k+a) -
    digamma(a))`` = sum_{j<k} j / (a+j) from the same Stirling branch, the
    last with no difference of two O(k) or two O(1/a) numbers (the NB
    element's dispersion gradient from a = 1/r = EXCESS_FROM on).
  * `y_shift`: y - a - 2 for y = a + 2 rounded, exactly; both digamma
    forms take their Stirling difference at y and move it back to a + 2.
  * `log1p_excess`, `log1m_excess`: t - log1p(t) and -log1p(-s) - s, by
    their series below 1/8.

The JAX package's standalone forms, ported in its operation order and on
no kernel's path:

  * `digamma_pos`: a 6-step upward recurrence into the asymptotic series.
  * `lgamma_ratio`, `digamma_ratio`: lgamma(k+a) - lgamma(a) and
    digamma(k+a) - digamma(a) with exact masked sums for k < 8 and
    Stirling differences at arguments >= a+8 (threshold 8, where the
    kernels' forms above take threshold 2).
"""
from __future__ import annotations

import torch

__all__ = [
    "lgamma_pos", "softplus", "softplus_sigmoid", "softplus_log_sigmoid",
    "lgamma_ratio2",
    "lgamma_digamma_ratio", "lgamma_digamma_excess", "log1p_excess",
    "log1m_excess", "y_shift", "digamma_pos", "lgamma_ratio",
    "digamma_ratio",
]

# below this argument `log1p_excess` and `log1m_excess` take their series
# (through the 9th power: truncated at ~1.4e-8 relative); above it the
# direct differences lose at most ~30 float32 ulps
SERIES_BELOW = 0.125
# from this a = 1/r on the NB element's dispersion gradient is taken from
# the digamma excess, whose terms do not cancel; below it from the digamma
# ratio, whose float32 error grows as a / mu but is no larger than the
# excess form's there (csrc/nb_common.cuh kExcessFrom)
EXCESS_FROM = 64.0

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


def _relu_abs(x):
    """(max(x, 0), |x|) with the JAX package's derivatives at x = 0: 1/2
    (jnp.maximum's) and 1 (jnp.abs's)."""
    return torch.maximum(x, x.new_zeros(())), torch.where(x >= 0.0, x, -x)


def softplus(x):
    """log(1 + exp(x)), safe for large |x| (no exp overflow); at x = 0 its
    gradient is the JAX package's (0, from the conventions of
    `_relu_abs`)."""
    relu, ab = _relu_abs(x)
    return relu + torch.log(1.0 + torch.exp(-ab))


def softplus_sigmoid(x):
    """(softplus(x), sigmoid(x)) sharing one exp and one reciprocal:
    sigmoid(x) = 1/(1+e) for x >= 0 and e/(1+e) for x < 0, with e =
    exp(-|x|); both branches overflow-safe, gradients as `softplus`'s."""
    relu, ab = _relu_abs(x)
    e = torch.exp(-ab)
    d = 1.0 / (1.0 + e)
    return relu + torch.log1p(e), torch.where(x >= 0.0, d, e * d)


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


def log1p_excess(t, l1p):
    """t - log1p(t) for t >= 0, given ``l1p`` = log1p(t): the series t^2/2 -
    t^3/3 + ... - t^9/9 below SERIES_BELOW, where the difference cancels,
    the difference above."""
    ser = t * t * (0.5 - t * (1.0 / 3.0 - t * (0.25 - t * (0.2 - t * (
        1.0 / 6.0 - t * (1.0 / 7.0 - t * (0.125 - t / 9.0)))))))
    return torch.where(t < SERIES_BELOW, ser, t - l1p)


def log1m_excess(s):
    """-log1p(-s) - s = s^2/2 + s^3/3 + ... + s^9/9 for 0 <= s <
    SERIES_BELOW (the caller selects)."""
    return s * s * (0.5 + s * (1.0 / 3.0 + s * (0.25 + s * (0.2 + s * (
        1.0 / 6.0 + s * (1.0 / 7.0 + s * (0.125 + s / 9.0)))))))


def y_shift(a, y):
    """y - a - 2 for y = a + 2 rounded in ``a``'s type, exactly
    (csrc/nb_common.cuh `y_shift`, a gene column there: `GeneCols.delta`;
    here per gene too, a broadcast along the cells): Fast2Sum with the
    larger operand first,
    (y - a) - 2 for a >= 2 and (y - 2) - a below, is exact under
    round-to-nearest.  Not 0 wherever y has a larger exponent than a: every
    a < 2 and a in [2^n - 2, 2^n) for n >= 2."""
    return (y - torch.clamp(a, min=2.0)) - torch.clamp(a, max=2.0)


def _ratio_parts(k, a):
    """The per-gene columns and Stirling pieces shared by the lgamma ratio,
    the digamma ratio and the digamma excess (csrc/nb_common.cuh
    `GeneCols`, `lgamma_digamma_ratio`), in the kernels' operation order.
    y = a + 2 rounds (`y_shift`); the lgamma ratio takes its Stirling
    difference at y as it is."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    masks = [k > j for j in range(2)]
    logs = [torch.log(a + j) for j in range(2)]    # per-gene columns
    invs = [1.0 / (a + j) for j in range(2)]
    small_l = sum(torch.where(masks[j], logs[j], zero) for j in range(2))

    # Stirling differences at args >= 2: y = a+2, x = k-2 (clamped)
    y = a + 2.0
    x = torch.clamp(k - 2.0, min=0.0)
    ka = y + x
    inv_y = 1.0 / y
    inv2_y = inv_y * inv_y
    log_y = torch.log(y)
    t = x * inv_y
    l1p = torch.log1p(t)
    inv = 1.0 / ka
    inv2 = inv * inv
    rc_ka = inv * (1.0 / 12.0 - inv2 * (
        1.0 / 360.0 - inv2 * (1.0 / 1260.0 - inv2 * (1.0 / 1680.0))
    ))
    rc_y = inv_y * (1.0 / 12.0 - inv2_y * (
        1.0 / 360.0 - inv2_y * (1.0 / 1260.0 - inv2_y * (1.0 / 1680.0))
    ))
    stir_l = (y - 0.5 + x) * l1p + x * log_y - x + rc_ka - rc_y
    lt = k < 2
    lgr = torch.where(lt, small_l, sum(logs) + stir_l)
    return dict(zero=zero, masks=masks, invs=invs, a=a, y=y, x=x, t=t,
                l1p=l1p, inv=inv, inv2=inv2, inv_y=inv_y, inv2_y=inv2_y,
                lt=lt, lgr=lgr)


def lgamma_ratio2(k, a):
    """lgamma(k+a) - lgamma(a) for integer counts ``k >= 0`` and per-gene
    ``a > 0`` broadcast along the cells, in the threshold-2 form of
    `lgamma_digamma_ratio`."""
    return _ratio_parts(k, a)["lgr"]


def _digamma_ratio(p):
    """digamma(k+a) - digamma(a); the Stirling difference at the rounded
    y less delta d1 (delta = `y_shift`, d1 = 1/ka - 1/y, about its
    derivative in y): at a + 2."""
    invs, inv, inv2 = p["invs"], p["inv"], p["inv2"]
    inv_y, inv2_y = p["inv_y"], p["inv2_y"]
    small_d = sum(torch.where(p["masks"][j], invs[j], p["zero"])
                  for j in range(2))
    tail_ka = -0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)
    )
    tail_y = -0.5 * inv_y - inv2_y * (
        1.0 / 12.0 - inv2_y * (1.0 / 120.0 - inv2_y / 252.0)
    )
    d1 = -p["x"] * inv * inv_y             # 1/ka - 1/y
    stir_d = p["l1p"] + tail_ka - tail_y - y_shift(p["a"], p["y"]) * d1
    return torch.where(p["lt"], small_d, sum(invs) + stir_d)


def _digamma_excess(p, a):
    x, y, inv, inv2, inv_y = p["x"], p["y"], p["inv"], p["inv2"], p["inv_y"]
    l1p = p["l1p"]
    d1 = -x * inv * inv_y                  # 1/ka - 1/y
    iy2 = inv_y * inv_y
    d2 = d1 * (inv + inv_y)                # 1/ka^2 - 1/y^2
    td = -0.5 * d1 - d2 * (1.0 / 12.0 - (inv2 + iy2) * (1.0 / 120.0)
                           + (inv2 * inv2 + inv2 * iy2 + iy2 * iy2)
                           * (1.0 / 252.0))
    stir_k = (p["invs"][1] + y * log1p_excess(p["t"], l1p) + (y - a) * l1p
              - a * td)
    return torch.where(p["lt"], p["zero"],
                       stir_k + a * y_shift(a, y) * d1)


def lgamma_digamma_ratio(k, a):
    """(lgamma(k+a) - lgamma(a), digamma(k+a) - digamma(a)) for integer
    counts ``k >= 0`` and per-gene ``a > 0`` broadcast along the cells."""
    p = _ratio_parts(k, a)
    return p["lgr"], _digamma_ratio(p)


def lgamma_digamma_excess(k, a):
    """(lgamma(k+a) - lgamma(a), dgr = digamma(k+a) - digamma(a), k - a
    dgr) for integer counts ``k >= 0``.  The third is sum_{j<k} j / (a+j),
    0 for k < 2, and for k >= 2 the Stirling branch of the ratios taken as
    1/(a+1) + (x - a log1p(t)) - a (tail(a+k) - tail(y)) with y = a+2, x =
    k-2, t = x/y: the middle term as y (t - log1p t) + (y - a) log1p t
    (`log1p_excess`; y - a is exact, 2 + `y_shift`) and the tail
    difference through 1/ka - 1/y = -x / (ka y), so that no two terms of
    size k, or of size 1/a, cancel when a is large; + a delta (1/ka - 1/y)
    moves its Stirling difference from the rounded y to a + 2."""
    p = _ratio_parts(k, a)
    return p["lgr"], _digamma_ratio(p), _digamma_excess(p, a)


def digamma_pos(x):
    """digamma(x) for x > 0: shift x above 6 with psi(x) = psi(x+1) - 1/x,
    then the asymptotic series (A&S 6.3.18)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    for _ in range(6):
        small = x < 6.0
        acc = acc - torch.where(small, 1.0 / x, zero)
        x = x + torch.where(small, 1.0, 0.0).to(x.dtype)
    inv = 1.0 / x
    inv2 = inv * inv
    series = (
        torch.log(x)
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0)))
    )
    return acc + series


def _stirling_rc(z):
    """Stirling-series correction 1/(12z) - 1/(360z^3) + 1/(1260z^5)."""
    inv = 1.0 / z
    inv2 = inv * inv
    return inv * (
        1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 * (1.0 / 1260.0))
    )


def lgamma_ratio(k, a):
    """lgamma(k + a) - lgamma(a) for integer-valued counts ``k >= 0`` and
    ``a > 0`` broadcast against them: sum_{j<k} log(a + j) for k < 8, and
    sum_{j<8} log(a+j) + [lgamma(k+a) - lgamma(a+8)] by Stirling's series
    at arguments >= 8 above (no difference of two O(a log a) lgammas)."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    logs = [torch.log(a + j) for j in range(8)]
    full8 = sum(logs)
    small = sum(torch.where(k > j, logs[j], zero) for j in range(8))
    # (y-1/2) log1p(x/y) + x log(y+x) - x + rc(y+x) - rc(y), y = a+8, x = k-8
    y = a + 8.0
    x = torch.clamp(k - 8.0, min=0.0)       # keep the unselected branch finite
    ka = a + torch.clamp(k, min=8.0)
    stir = (
        (y - 0.5) * torch.log1p(x / y)
        + x * torch.log(ka)
        - x
        + _stirling_rc(ka)
        - _stirling_rc(y)
    )
    return torch.where(k < 8, small, full8 + stir)


def _digamma_tail(z):
    inv = 1.0 / z
    inv2 = inv * inv
    return (
        -0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    )


def digamma_ratio(k, a):
    """digamma(k + a) - digamma(a), as `lgamma_ratio`: sum_{j<k} 1/(a+j)
    for k < 8, the asymptotic series' difference at arguments >= 8
    above."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    invs = [1.0 / (a + j) for j in range(8)]
    full8 = sum(invs)
    small = sum(torch.where(k > j, invs[j], zero) for j in range(8))
    y = a + 8.0
    x = torch.clamp(k - 8.0, min=0.0)
    ka = a + torch.clamp(k, min=8.0)
    stir = torch.log1p(x / y) + _digamma_tail(ka) - _digamma_tail(y)
    return torch.where(k < 8, small, full8 + stir)
