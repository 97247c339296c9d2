"""The Negative-Binomial and Poisson count likelihoods and the log-normal
density in plain torch.

NB parameterization: ``GammaPoisson(1/r, 1/(r * exp(ElogS)))`` with
per-gene dispersion r, in the cancellation-free form of
`velocycle_tpu/ops/likelihoods.py`.

The plain NB element (`nb_logpmf`, and the models' ``NegativeBinomial``
log-prob) is the `torch.autograd.Function` `NBLogPmf`: its value is the
direct form's, bit for bit; its derivatives in (ElogS, r) take the form
of the fused kernels' element (`ops.nb_kernels._nb_lp_and_grads`), which
does not cancel as r falls, where autograd of the direct form does in
float32.  `nb_logpmf_direct` keeps the direct form and its autograd
derivatives: the float64 yardstick the repaired ones are held against.
"""
from __future__ import annotations

import math

import torch

from .special import EXCESS_FROM

__all__ = ["NBLogPmf", "gamma_poisson_logpmf", "lgamma_diff", "nb_logpmf",
           "nb_logpmf_direct", "poisson_logpmf", "lognormal_logpdf"]


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


def nb_logpmf_direct(k, elog_mu, dispersion):
    """Negative-Binomial log-pmf at counts ``k``, differentiated by
    autograd (the float64 yardstick; in float32 its dispersion gradient
    cancels as r falls: use `nb_logpmf`).

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


def gamma_poisson_logpmf(k, a, b):
    """``GammaPoisson(a, b)`` log-pmf at ``k`` (the JAX package's
    cancellation-free form): the lgamma difference through
    `lgamma_diff`."""
    k = k.to(a.dtype)
    return (
        lgamma_diff(k, a)
        - torch.lgamma(k + 1.0)
        - a * torch.log1p(1.0 / b)
        - k * torch.log1p(b)
    )


def _sum_to(g, shape):
    """``g`` summed over the axes it was broadcast along to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and g.shape[lead + i] != 1]
    return g.sum(dims, keepdim=True).reshape(shape)


def _element_grads(k, elog, r, want_r=True):
    """(d lp/d elog, d lp/d r) of the NB element, elementwise, in the
    form of the kernels' element (`ops.nb_kernels._nb_lp_and_grads`, the
    kernels' plain version): g_elog = k sig - a sig_c,
    and d lp/d r by its excess form a ((k - a dgr) - k sig_c + a q), q =
    -(log sig + sig_c), from a = 1/r = EXCESS_FROM on and by its ratio form
    a (g_elog - a (dgr + log sig)) below.  For real counts ``k >= 0``
    (fractional too), and without the kernels' series: the pieces that
    cancel are taken in float64 from the float32 log b, namely dgr + log
    sig (``torch.digamma``), q (O(sig_c^2) from two O(sig_c) terms) and t -
    log1p t, t = k / a, of k - a dgr = a (t - log1p t) - a (tail(a+k) -
    tail(a)) (`_tail_diff`, at a >= EXCESS_FROM); the rest in the inputs'
    dtype.  Plain differentiable torch; each form's a is clamped into its
    own domain, so that the form `torch.where` does not select stays
    finite under second derivatives.  ``want_r=False`` returns ``None`` for
    d lp/d r (the dispersion conditioned) and computes none of it."""
    k = k.to(torch.float32)
    a = 1.0 / r
    x = -torch.log(r) - elog                # log b = log(a / mu)
    dtype = x.dtype
    x64 = x.double()
    sig_c64 = torch.sigmoid(-x64)
    sig_c = sig_c64.to(dtype)
    g_elog = k * torch.sigmoid(x64).to(dtype) - a * sig_c
    if not want_r:
        return g_elog, None
    k64 = k.double()
    log_sig = torch.nn.functional.logsigmoid(x64)
    q = (-(log_sig + sig_c64)).to(dtype)
    a_r = torch.clamp(a, max=EXCESS_FROM)
    a_r64 = a_r.double()
    g_r = (g_elog - a_r * (torch.digamma(k64 + a_r64) - torch.digamma(a_r64)
                           + log_sig).to(dtype)) * a_r
    a_e = torch.clamp(a, min=EXCESS_FROM)
    t = k64 / a_e
    kad = a_e * ((t - torch.log1p(t)).to(dtype) - _tail_diff(k, a_e))
    return g_elog, torch.where(a < EXCESS_FROM, g_r,
                               ((kad - k * sig_c) + a_e * q) * a_e)


def _tail_diff(k, y):
    """tail(y + k) - tail(y) of the digamma series, tail(z) = -1/(2z) -
    1/(12z^2) + 1/(120z^4) - ..., through 1/(y+k) - 1/y = -k / ((y+k) y),
    so that no two terms of size 1/y cancel; for y >= EXCESS_FROM, where
    the next term, 1/(252z^6), moves d lp/d r by less than 1e-10 of it."""
    inv, inv_y = 1.0 / (y + k), 1.0 / y
    d1 = k * inv * (-inv_y)                 # 1/(y+k) - 1/y
    d2 = d1 * (inv + inv_y)                 # 1/(y+k)^2 - 1/y^2
    return -0.5 * d1 - d2 * (1.0 / 12.0
                             - (inv * inv + inv_y * inv_y) * (1.0 / 120.0))


# elements of the broadcast (..., Ng, Nc) element per block of rows in which
# `NBLogPmf` forms its derivatives: their float64 intermediates live for one
# block at a time, not over the whole element
BLOCK_ELEMENTS = 1 << 26


def _by_rows(t):
    """Whether ``t`` varies along the rows (dim -2) of the element."""
    return t is not None and t.dim() >= 2 and t.shape[-2] != 1


def _row_blocks(shape, *ts):
    """[the tensors ``ts`` (None passes through) for each block of rows of
    their broadcast ``shape`` of at most BLOCK_ELEMENTS elements]; a tensor
    broadcast along the rows goes whole into every block."""
    rows = shape[-2] if len(shape) >= 2 else 1
    step = max(1, BLOCK_ELEMENTS * rows // max(1, math.prod(shape)))
    if step >= rows:
        return [ts]
    return [tuple(t[..., i:i + step, :] if _by_rows(t) else t for t in ts)
            for i in range(0, rows, step)]


def _cat_rows(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, -2)


class NBLogPmf(torch.autograd.Function):
    """The plain NB element over (k, elog, r): its value the direct form's
    (`nb_logpmf_direct`; with ``a`` and ``b`` given, `gamma_poisson_logpmf`
    at them, the models' ``NegativeBinomial`` log-prob), its derivatives in
    elog and r those of `_element_grads` in every mode: backward (built from
    differentiable ops, so that a Hessian is the derivative of the
    repaired gradient), forward (`jvp`) and under `torch.func.vmap` (the
    generated rule).  k, a and b take no gradient: a = 1/r and b =
    1/(r mu) only carry the value, and recombining d/da and d/db into d/dr
    would bring the cancellation back."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k, elog, r, a=None, b=None):
        if a is None:
            return nb_logpmf_direct(k, elog, r)
        return gamma_poisson_logpmf(k, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, elog, r = inputs[:3]
        ctx.save_for_backward(k, elog, r)
        ctx.save_for_forward(k, elog, r)

    @staticmethod
    def backward(ctx, g):
        k, elog, r = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_elog, d_r = [], []
        for kb, eb, rb, gb in _row_blocks(g.shape, k, elog, r, g):
            g_elog, g_r = _element_grads(kb, eb, rb, want_r=need[2])
            if need[1]:
                d_elog.append(gb * g_elog)
            if need[2]:
                d_r.append(_sum_to(gb * g_r, rb.shape))
        if d_r:
            d_r = (_cat_rows(d_r) if _by_rows(r) else sum(d_r)).to(r.dtype)
        return (None,
                _sum_to(_cat_rows(d_elog), elog.shape).to(elog.dtype)
                if need[1] else None,
                d_r if need[2] else None, None, None)

    @staticmethod
    def jvp(ctx, k_dot, elog_dot, r_dot, a_dot=None, b_dot=None):
        k, elog, r = ctx.saved_tensors
        shape = torch.broadcast_shapes(k.shape, elog.shape, r.shape)
        out = []
        for kb, eb, rb, edb, rdb in _row_blocks(shape, k, elog, r, elog_dot,
                                                r_dot):
            g_elog, g_r = _element_grads(kb, eb, rb, want_r=rdb is not None)
            o = g_elog * edb if edb is not None else torch.zeros_like(g_elog)
            out.append(o + g_r * rdb if rdb is not None else o)
        return _cat_rows(out)


def nb_logpmf(k, elog_mu, dispersion):
    """Negative-Binomial log-pmf at counts ``k`` (`NBLogPmf`): the value of
    `nb_logpmf_direct`, bit for bit, with derivatives in ``elog_mu`` and
    ``dispersion`` that stay within float32 rounding of float64's at any
    dispersion.  ``k`` may be an integer tensor (int16 count storage) or
    fractional."""
    return NBLogPmf.apply(k, elog_mu, dispersion)


def poisson_logpmf(k, elog_mu):
    """Poisson log-pmf at counts ``k`` with log-mean ``elog_mu``."""
    return k * elog_mu - torch.exp(elog_mu) - torch.lgamma(k + 1.0)


def lognormal_logpdf(logx, elog_mu, sigma):
    """Normal log-density of ``logx`` around ``elog_mu`` with scale
    ``sigma`` (the log-normal likelihood on log counts, no Jacobian)."""
    z = (logx - elog_mu) / sigma
    return -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi)
