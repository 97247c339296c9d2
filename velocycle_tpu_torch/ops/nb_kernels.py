"""Fused NB log-likelihoods of both stages: CUDA kernels, their plain
versions, and the autograd bindings.

Every SVI step is dominated by a Negative-Binomial log-likelihood over the
dense genes x cells count matrix.  Phase stage: ``sum_{g,c} NB_logpmf(S |
ElogS, r)`` with ``ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]``.
Velocity stage: the same for S plus ``NB_logpmf(U | ElogU, r)`` with the
kinetic coupling ``ElogU = -log_beta + log(relu(dEs * omega + exp(
log_gamma)) + 1e-5) + ElogS``, ``dEs = nu @ zeta_dphi^T``.  Four
hand-written CUDA kernels carry them on the card:

  * ``phase_fwd`` / ``phase_fwdgrad`` (`csrc/nb_phase.cu`, two
    instantiations of the one body in `csrc/phase_kernel.cuh`, which also
    carries the roofline ladder of `ops/ladder_kernels.py`) replace the
    Pallas kernels `_phase_fwd_kernel` / `_phase_fwdgrad_kernel` of
    velocycle_tpu/ops/nb_kernels.py;
  * ``velo_fwd`` / ``velo_fwdgrad`` (`csrc/nb_velo.cu`, two
    instantiations of the one body in `csrc/velo_kernel.cuh`) replace
    `_velo_fwd_kernel` / `_velo_fwdgrad_kernel`.

Count matrices are int16 or float32, S and U each on its own.  Basis
widths: the narrow bodies are instantiated for Nh in (3, 5, 7) with up to
four delta_nu batches, and 11 and 16 without; `kernel_width` sends any
other shape of at most NARROW_WIDTH = 16 basis columns to the next width,
with zero columns and the batches folded into basis columns
(`widen_inputs`, `narrow_grads`).  Past that, at any width, the same four
wrappers launch the wide body (`csrc/nb_wide.cu` over
`csrc/wide_kernel.cuh`, the basis width a runtime value) at Nh + Nb
columns, the batches folded in, and count those launches under
``phase_fwd_wide`` / ``phase_fwdgrad_wide`` / ``velo_fwd_wide`` /
``velo_fwdgrad_wide``.  Its plain versions, the ``*_wide_plain`` twins,
are the references of the tests and of chip_smoke.py.

The ``*_fwd`` kernel gives the loss alone (loss-only evaluations); the
``*_fwdgrad`` kernel gives the loss AND every gradient in one pass (every
SVI step).  `nb_loglik_fused` and `nbsu_loglik_fused` keep the JAX
signatures and wrap them in a `torch.autograd.Function`: when a gradient
is needed the forward launches the fwd+grad kernel and saves its
gradients, and the backward scales them by ``grad_output`` (the gradients
of a scalar sum do not depend on the cotangent).  Otherwise it launches
the loss-only kernel.  A CUDA tensor reaches a kernel or raises; a CPU
tensor runs the plain version below, which repeats the kernels'
per-element arithmetic over the whole matrix (the "tile-math twin") with
the contractions in `torch.matmul`/`sum`.

INTEGER-COUNT REQUIREMENT: the lgamma/digamma ratio forms are exact only
for integer-valued counts (raw counts, possibly stored as float or int16).
Use the plain model path (``use_fused_nb=False``) for fractional data.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from . import cuda_build
from .likelihoods import nb_logpmf_direct
from .special import (EXCESS_FROM, SERIES_BELOW, lgamma_digamma_excess,
                      lgamma_pos, lgamma_ratio2, log1m_excess,
                      softplus_log_sigmoid)

__all__ = [
    "KERNEL_WIDTHS",
    "LAUNCHES",
    "LAUNCH_CHAINS",
    "LAUNCH_WIDTHS",
    "Layout",
    "NARROW_WIDTH",
    "PHASE_MODES",
    "Plan",
    "VELO_CUTS",
    "WIDE_CUTS",
    "WIDE_STAGES",
    "WideLayout",
    "WidePlan",
    "kernel_width",
    "narrow_grads",
    "nb_loglik_fused",
    "nb_loglik_reference",
    "nbsu_loglik_fused",
    "nbsu_loglik_reference",
    "phase_fwd",
    "phase_fwd_plain",
    "phase_fwdgrad",
    "phase_fwdgrad_plain",
    "phase_fwdgrad_wide_plain",
    "phase_fwd_wide_plain",
    "phase_layout",
    "phase_plan",
    "reset_launch_counts",
    "velo_fwd",
    "velo_fwd_plain",
    "velo_fwdgrad",
    "velo_fwdgrad_plain",
    "velo_fwdgrad_wide_plain",
    "velo_fwd_wide_plain",
    "velo_layout",
    "velo_plan",
    "wide_layout",
    "wide_plan",
    "widen_inputs",
]

# kernel launches on the card, by kernel, by kernel and basis width
# (`kernel_width`), and by kernel and chain count K (a chain-batched launch
# counts once, under its K); the wide body's launches count under the
# ``*_wide`` names.  chip_smoke.py resets these just before it drives each
# stage of the main path and reads them just after
LAUNCHES = {"phase_fwd": 0, "phase_fwdgrad": 0, "velo_fwd": 0,
            "velo_fwdgrad": 0, "phase_fwd_wide": 0, "phase_fwdgrad_wide": 0,
            "velo_fwd_wide": 0, "velo_fwdgrad_wide": 0}
LAUNCH_WIDTHS = {k: {} for k in LAUNCHES}
LAUNCH_CHAINS = {k: {} for k in LAUNCHES}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_WIDTHS[k].clear()
        LAUNCH_CHAINS[k].clear()


def _count_launch(name, width, chains):
    LAUNCHES[name] += 1
    LAUNCH_WIDTHS[name][width] = LAUNCH_WIDTHS[name].get(width, 0) + 1
    LAUNCH_CHAINS[name][chains] = LAUNCH_CHAINS[name].get(chains, 0) + 1


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def nb_loglik_reference(S, nu, zeta, count_factor, dispersion,
                        delta_nu=None, Db=None):
    """sum of NB log-pmfs with ElogS = nu @ zeta^T [+ Db-routed batch
    offsets] + count_factor, through `ops.likelihoods.nb_logpmf_direct`:
    its gradients are autograd's of the direct form (the float64 yardstick
    of every repaired gradient, independent of them)."""
    elog = _phase_elog(nu, zeta, count_factor, delta_nu, Db)
    return nb_logpmf_direct(S, elog, dispersion[:, None]).sum()


def nbsu_loglik_reference(S, U, nu, zeta, zeta_dphi, count_factor, omega,
                          log_beta, log_gamma, dispersion,
                          delta_nu=None, Db=None):
    """Velocity-stage joint NB log-likelihood of S and U through
    `ops.likelihoods.nb_logpmf_direct` (as `nb_loglik_reference`), with
    ElogS as there and ElogU = -log_beta + log(relu(dEs * omega +
    exp(log_gamma)) + 1e-5) + ElogS."""
    elogS, elogU, *_ = _velo_elogs(nu, zeta, zeta_dphi, count_factor, omega,
                                   log_beta, log_gamma, delta_nu, Db)
    r = dispersion[:, None]
    return (nb_logpmf_direct(S, elogS, r)
            + nb_logpmf_direct(U, elogU, r)).sum()


def _phase_elog(nu, zeta, cf, delta_nu, Db):
    """ElogS (..., Ng, Nc); the parameters may carry a leading chain axis
    each (`phase_fwdgrad_plain`)."""
    elog = nu @ zeta.transpose(-1, -2) + cf[..., None, :]
    if delta_nu is not None:
        elog = elog + delta_nu.transpose(-1, -2) @ Db
    return elog


def _velo_elogs(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma,
                delta_nu, Db, compensated=False):
    """(ElogS, ElogU, dEs, gamma, x, xr) in the kernels' operation order;
    x is the pre-relu argument and xr = relu(x) + 1e-5.

    dEs is summed over the basis columns in order, one rounded product and
    one rounded sum at a time, exactly as `csrc/nb_velo.cu` forms it: the
    gradients carry 1/xr, up to 1e5 just above the relu, so x must agree
    bit for bit between the kernel and this version (a matmul's summation
    order would not).  ``compensated``: as the wide body
    (`csrc/wide_kernel.cuh`) forms it, by column quads (zero columns up to a
    multiple of 4), each quad's rounded products summed pairwise and added
    to a compensated (Kahan) running sum: the plain sum's rounding drifts
    with the column count."""
    elogS = _phase_elog(nu, zeta, cf, delta_nu, Db)
    if compensated:
        dEs = comp = torch.zeros(nu.shape[0], zeta_dphi.shape[0],
                                 dtype=nu.dtype, device=nu.device)
        W = nu.shape[1]
        pad = -W % 4
        nu_p = torch.cat([nu, nu.new_zeros(nu.shape[0], pad)], 1)
        zd_p = torch.cat([zeta_dphi, zeta_dphi.new_zeros(zeta_dphi.shape[0],
                                                         pad)], 1)
        for h in range(0, W + pad, 4):
            p = [nu_p[:, c:c + 1] * zd_p[:, c][None, :]
                 for c in range(h, h + 4)]
            y = ((p[0] + p[1]) + (p[2] + p[3])) - comp
            t = dEs + y
            comp = (t - dEs) - y
            dEs = t
    else:
        dEs = nu[:, :1] * zeta_dphi[:, 0][None, :]
        for h in range(1, nu.shape[1]):
            dEs = dEs + nu[:, h:h + 1] * zeta_dphi[:, h][None, :]
    gamma = torch.exp(log_gamma)
    x = dEs * omega[None, :] + gamma[:, None]
    xr = torch.clamp(x, min=0.0) + 1e-5
    elogU = -log_beta[:, None] + torch.log(xr) + elogS
    return elogS, elogU, dEs, gamma, x, xr


def _nb_lp(k, elog, a, log_r, skip_lgamma_k=False):
    """NB log-pmf as the loss-only kernel computes it (threshold-2 ratio
    lgamma): lgr + a * log sigmoid(log_b) - k * softplus(log_b), with
    log_b = log(a / mu).  The a-weighted term is the log sigmoid itself, not
    ``a * log_b - a * softplus(log_b)``, whose two halves cancel where a =
    1/r is large (small dispersion)."""
    log_b = -log_r - elog
    lgr = lgamma_ratio2(k, a)
    sp, log_sig = softplus_log_sigmoid(log_b, with_sigmoid=False)
    lp = lgr + a * log_sig - k * sp
    if not skip_lgamma_k:
        lp = lp - lgamma_pos(k + 1.0)
    return lp


def _nb_lp_and_grads(k, a, log_r, elog, skip_k, want_r=True):
    """(log-pmf, d lp/d elog, d lp/d r) as the fwd+grad kernel computes
    them; ``want_r=False`` returns ``None`` for the dispersion term.

    Free of the small-dispersion cancellations: the log-pmf as in `_nb_lp`,
    d lp/d elog = k * sigmoid(log_b) - a * (1 - sigmoid(log_b)) (not
    ``(a + k) * sigmoid - a``), and for genes with a >= EXCESS_FROM

        d lp/d r = a ((k - a dgr) - k sig_c - a (log sig + sig_c)),

    sig_c = 1 - sigmoid(log_b), whose three terms are each O(mu^2 / a):
    k - a dgr from `lgamma_digamma_excess`, and -(log sig + sig_c)
    where log_b >= 0 as `log1m_excess(sig_c)` below SERIES_BELOW (mu / a
    small: the difference of two O(mu / a) numbers otherwise).  Below
    EXCESS_FROM, d lp/d r = -a^2 (dgr + log sig) + a g_elog: its error grows
    as a / mu, but there it is no larger than the other form's, which costs
    more operations."""
    log_b = -log_r - elog
    sp, log_sig, sig, sig_c = softplus_log_sigmoid(log_b)
    if want_r:
        lgr, dgr, kad = lgamma_digamma_excess(k, a)
    else:
        lgr = lgamma_ratio2(k, a)
    lp = lgr + a * log_sig - k * sp
    if not skip_k:
        lp = lp - lgamma_pos(k + 1.0)
    g_elog = k * sig - a * sig_c
    if not want_r:
        return lp, g_elog, None
    dlp_da = dgr + log_sig
    g_r_ratio = (dlp_da * (-a) + g_elog) * a
    q = torch.where((log_b >= 0.0) & (sig_c < SERIES_BELOW),
                    log1m_excess(sig_c), -(log_sig + sig_c))
    g_r_excess = ((kad - k * sig_c) + a * q) * a
    return lp, g_elog, torch.where(a < EXCESS_FROM, g_r_ratio, g_r_excess)


def _finish_loss(total64, lgamma_k_sum):
    if lgamma_k_sum is not None:
        total64 = total64 - torch.as_tensor(
            lgamma_k_sum, dtype=torch.float32, device=total64.device
        ).double()
    return total64.float()


def phase_fwd_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                    lgamma_k_sum=None):
    """Plain version of ``phase_fwd``: the loss; (K,) over a chain batch,
    as `phase_fwdgrad_plain`."""
    elog = _phase_elog(nu, zeta, cf, delta_nu, Db)
    a = 1.0 / r[..., None]
    lp = _nb_lp(S.float(), elog, a, torch.log(r)[..., None],
                skip_lgamma_k=lgamma_k_sum is not None)
    return _finish_loss(lp.sum((-2, -1), dtype=torch.float64), lgamma_k_sum)


def phase_fwdgrad_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                        lgamma_k_sum=None, want_disp=True):
    """Plain version of ``phase_fwdgrad``: (loss, (dnu, dzeta, dcf, ddisp,
    ddelta_nu)); ddisp is exactly zero when ``want_disp`` is False and
    ddelta_nu is None without delta_nu.

    Chain-batched like the kernel: any of nu, zeta, cf, r and delta_nu may
    carry a leading chain axis K (the others are shared by the chains), and
    then the loss is (K,) and every gradient has the leading K."""
    elog = _phase_elog(nu, zeta, cf, delta_nu, Db)
    a = 1.0 / r[..., None]
    lp, g_elog, g_r = _nb_lp_and_grads(
        S.float(), a, torch.log(r)[..., None], elog,
        lgamma_k_sum is not None, want_r=want_disp,
    )
    loss = _finish_loss(lp.sum((-2, -1), dtype=torch.float64), lgamma_k_sum)
    dnu = g_elog @ zeta
    dzeta = g_elog.transpose(-1, -2) @ nu
    dcf = g_elog.sum(-2)
    ddisp = g_r.sum(-1) if want_disp else torch.zeros(
        g_elog.shape[:-1], dtype=r.dtype, device=r.device)
    ddnu = None
    if delta_nu is not None:
        # chain by chain, as a single call rounds it (and as each chain of
        # a chain-batched launch does): one matmul over the chain batch
        # rounds otherwise at a narrow design (Nb = 2)
        ddnu = (torch.stack([g @ Db.T for g in g_elog]) if g_elog.dim() == 3
                else g_elog @ Db.T).transpose(-1, -2)
    return loss, (dnu, dzeta, dcf, ddisp, ddnu)


def velo_fwd_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                   log_gamma, r, delta_nu=None, Db=None, lgamma_k_sum=None,
                   compensated=False):
    """Plain version of ``velo_fwd``: the loss (``compensated``: dEs as
    the wide body forms it, `_velo_elogs`)."""
    elogS, elogU, *_ = _velo_elogs(nu, zeta, zeta_dphi, cf, omega, log_beta,
                                   log_gamma, delta_nu, Db, compensated)
    a = 1.0 / r[:, None]
    log_r = torch.log(r)[:, None]
    skip = lgamma_k_sum is not None
    lp = (_nb_lp(S.float(), elogS, a, log_r, skip)
          + _nb_lp(U.float(), elogU, a, log_r, skip))
    return _finish_loss(lp.sum(dtype=torch.float64), lgamma_k_sum)


def velo_fwdgrad_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                       log_gamma, r, delta_nu=None, Db=None,
                       lgamma_k_sum=None, want_disp=True, compensated=False):
    """Plain version of ``velo_fwdgrad``: (loss, (dnu, dzeta, dzeta_dphi,
    dcf, domega, dlog_beta, dlog_gamma, ddisp, ddelta_nu)); ddisp is
    exactly zero when ``want_disp`` is False and ddelta_nu is None without
    delta_nu.  The relu gate passes gradient where x > 0 (strictly).
    ``compensated``: dEs as the wide body forms it (`_velo_elogs`)."""
    elogS, elogU, dEs, gamma, x, xr = _velo_elogs(
        nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, delta_nu, Db,
        compensated
    )
    a = 1.0 / r[:, None]
    log_r = torch.log(r)[:, None]
    skip = lgamma_k_sum is not None
    lpS, gS, g_rS = _nb_lp_and_grads(S.float(), a, log_r, elogS, skip,
                                     want_r=want_disp)
    lpU, gU, g_rU = _nb_lp_and_grads(U.float(), a, log_r, elogU, skip,
                                     want_r=want_disp)
    loss = _finish_loss((lpS + lpU).sum(dtype=torch.float64), lgamma_k_sum)
    g_elogS = gS + gU                      # ElogU includes ElogS
    g_x = gU * torch.where(x > 0.0, 1.0 / xr, torch.zeros_like(xr))
    g_x_om = g_x * omega[None, :]
    dnu = g_elogS @ zeta + g_x_om @ zeta_dphi
    dzeta = g_elogS.T @ nu
    dzdphi = g_x_om.T @ nu
    dcf = g_elogS.sum(0)
    domega = (g_x * dEs).sum(0)
    dlbeta = -gU.sum(1)
    dlgamma = g_x.sum(1) * gamma
    ddisp = (g_rS + g_rU).sum(1) if want_disp else torch.zeros_like(r)
    ddnu = (g_elogS @ Db.T).T if delta_nu is not None else None
    return loss, (dnu, dzeta, dzdphi, dcf, domega, dlbeta, dlgamma, ddisp,
                  ddnu)


# the wide body's plain versions (its "wide twins"): the batches folded into
# basis columns as the kernel takes them, then the plain versions above at
# Nh + Nb columns, then the folded columns' gradients back to ddelta_nu

def _fold(nu, zetas, delta_nu, Db):
    """(inputs at W = Nh + Nb columns as the wide body takes them, Nh, Nb,
    fold)."""
    Nh = nu.shape[-1]
    Nb = 0 if delta_nu is None else delta_nu.shape[-2]
    nu_w, zetas_w, _, _ = widen_inputs(nu, zetas, delta_nu, Db, Nh + Nb,
                                       Nb > 0)
    return nu_w, zetas_w, Nh, Nb, Nb > 0


def phase_fwd_wide_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                         lgamma_k_sum=None):
    """Plain version of `phase_fwd` on the wide body: the loss, as
    `phase_fwd_plain` with the batches folded into basis columns
    (chain-batched as it)."""
    nu_w, (zeta_w,), *_ = _fold(nu, [zeta], delta_nu, Db)
    return phase_fwd_plain(S, nu_w, zeta_w, cf, r, None, None, lgamma_k_sum)


def phase_fwdgrad_wide_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                             lgamma_k_sum=None, want_disp=True):
    """Plain version of `phase_fwdgrad` on the wide body: (loss, (dnu,
    dzeta, dcf, ddisp, ddelta_nu)) as `phase_fwdgrad_plain`, the batches
    folded into basis columns (chain-batched as it)."""
    nu_w, (zeta_w,), Nh, Nb, fold = _fold(nu, [zeta], delta_nu, Db)
    loss, (dnu, dzeta, dcf, ddisp, _) = phase_fwdgrad_plain(
        S, nu_w, zeta_w, cf, r, None, None, lgamma_k_sum, want_disp)
    dnu, (dzeta,), ddnu = narrow_grads(dnu, [dzeta], None, Nh, Nb, fold)
    return loss, (dnu, dzeta, dcf, ddisp, ddnu)


def velo_fwd_wide_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                        log_gamma, r, delta_nu=None, Db=None,
                        lgamma_k_sum=None):
    """Plain version of `velo_fwd` on the wide body: the loss, as
    `velo_fwd_plain` with the batches folded into basis columns and dEs
    compensated as the wide body forms it."""
    nu_w, (z_w, zd_w), *_ = _fold(nu, [zeta, zeta_dphi], delta_nu, Db)
    return velo_fwd_plain(S, U, nu_w, z_w, zd_w, cf, omega, log_beta,
                          log_gamma, r, None, None, lgamma_k_sum,
                          compensated=True)


def velo_fwdgrad_wide_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                            log_gamma, r, delta_nu=None, Db=None,
                            lgamma_k_sum=None, want_disp=True):
    """Plain version of `velo_fwdgrad` on the wide body: the loss and
    every gradient as `velo_fwdgrad_plain`, the batches folded into basis
    columns (whose zeta_dphi columns are zero) and dEs compensated as the
    wide body forms it."""
    nu_w, (z_w, zd_w), Nh, Nb, fold = _fold(nu, [zeta, zeta_dphi], delta_nu,
                                            Db)
    loss, g = velo_fwdgrad_plain(S, U, nu_w, z_w, zd_w, cf, omega, log_beta,
                                 log_gamma, r, None, None, lgamma_k_sum,
                                 want_disp, compensated=True)
    dnu, (dzeta, dzdphi), ddnu = narrow_grads(g[0], [g[1], g[2]], None, Nh,
                                              Nb, fold)
    return loss, (dnu, dzeta, dzdphi, *g[3:8], ddnu)


# ---------------------------------------------------------------------------
# basis widths: padding and batch folding for the kernels' instantiations
# ---------------------------------------------------------------------------

# the basis widths the narrow bodies are instantiated for (csrc/nb_phase.cu
# and csrc/nb_velo.cu, `pick_nh`); up to DNU_WIDTH also with delta_nu
# batches as such (csrc/nb_common.cuh kMaxDnuWidth).  Past NARROW_WIDTH
# columns the wide body (csrc/wide_kernel.cuh) runs any width
KERNEL_WIDTHS = (3, 5, 7, 11, 16)
NARROW_WIDTH = KERNEL_WIDTHS[-1]
DNU_WIDTH = 7


def kernel_width(Nh, Nb, max_nb):
    """(width, fold): the basis width that runs Nh basis columns and Nb
    delta_nu batches, and whether the batches are folded into basis
    columns.

    Nh <= DNU_WIDTH with Nb <= max_nb runs at the next width of (3, 5, 7)
    with delta_nu as such.  Otherwise the batches become Nb extra columns
    (`widen_inputs`) and Nh + Nb runs at the next of KERNEL_WIDTHS, or past
    NARROW_WIDTH on the wide body at Nh + Nb itself, whatever the width."""
    if Nb <= max_nb:
        for w in KERNEL_WIDTHS:
            if Nh <= w <= DNU_WIDTH:
                return w, False
    n = Nh + Nb
    for w in KERNEL_WIDTHS:
        if n <= w:
            return w, Nb > 0
    return n, Nb > 0


def widen_inputs(nu, zetas, delta_nu, Db, width, fold):
    """The kernels' inputs at ``width`` basis columns (`kernel_width`).

    With ``fold`` the batch offsets become basis columns: nu' = [nu |
    delta_nu^T], zetas[0]' = [zeta | Db^T] and every other cell basis (the
    velocity stage's zeta_dphi) [z | 0], so that ElogS and dEs keep their
    values; then zero columns up to ``width``, which add exact zeros to
    every dot product.  Returns (nu', [zetas'], delta_nu or None (folded),
    Db or None); the inputs themselves when nothing changes."""
    Nh = nu.shape[-1]
    if width == Nh and not fold:
        return nu, list(zetas), delta_nu, Db
    Nb = delta_nu.shape[-2] if fold else 0
    pad = width - Nh - Nb
    cols_nu = [nu] + ([delta_nu.transpose(-1, -2)] if fold else [])
    out = []
    for i, z in enumerate(zetas):
        cols = [z]
        if fold:
            cols.append(Db.T if i == 0 else z.new_zeros(z.shape[-2], Nb))
        out.append(cols)
    if pad:
        cols_nu.append(nu.new_zeros(nu.shape[-2], pad))
        for cols, z in zip(out, zetas):
            cols.append(z.new_zeros(z.shape[-2], pad))
    nu_w = _cat_columns(cols_nu)
    zetas_w = [_cat_columns(cols) for cols in out]
    return nu_w, zetas_w, (None if fold else delta_nu), (None if fold else Db)


def _cat_columns(cols):
    """Concatenate along the last axis, each piece broadcast to the leading
    (chain) axis of any that has one."""
    lead = max((c.shape[:-2] for c in cols), key=len)
    return torch.cat([c.expand(lead + c.shape[-2:]) for c in cols],
                     -1).contiguous()


def narrow_grads(dnu, dzetas, ddnu, Nh, Nb, fold):
    """The gradients of `widen_inputs`'s inputs from those of its outputs:
    dnu[..., :Nh] and each dzeta[..., :Nh]; with ``fold`` ddelta_nu is
    dnu[..., Nh:Nh + Nb]^T.  The padded columns' gradients are dropped."""
    if fold:
        ddnu = dnu[..., Nh:Nh + Nb].transpose(-1, -2).contiguous()
    return (dnu[..., :Nh].contiguous(),
            [d[..., :Nh].contiguous() for d in dzetas], ddnu)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/nb_phase.cu over csrc/phase_kernel.cuh, csrc/nb_velo.cu
# over csrc/velo_kernel.cuh)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# the `Cut` order of csrc/phase_kernel.cuh: the modes of vct_phase_run.  fwd
# and fwdgrad are phase_fwd / phase_fwdgrad; the rest are the roofline
# ladder's rungs (ops/ladder_kernels.py), whose v_full is fwdgrad itself
PHASE_MODES = ("fwd", "fwdgrad", "stream", "matmul", "logpmf", "grad_nu",
               "v_nodig", "v_nocell", "vpu_only")
# gene-partial columns of the gradient modes besides dnu (Nh) and ddelta_nu
# (Nb): the ddisp slot; and the modes that write dzeta and dcf
_PHASE_GENE_EXTRA = {"fwdgrad": 1, "grad_nu": 0, "v_nodig": 1, "v_nocell": 1}
_PHASE_CELL_GRADS = ("fwdgrad", "v_nodig")
# the `Cut` order of csrc/velo_kernel.cuh
VELO_CUTS = ("fwd", "fwdgrad")
# gene-partial columns of velo_fwdgrad besides dnu and ddelta_nu: ddisp,
# dlog_beta and sum_c g_x (velo_kernel.cuh kGeneExtra)
_VELO_GENE_EXTRA = 3
_LAYOUT_NAMES = ("kThreads", "kCellsPerTile", "kGeneChunk", "kStages",
                 "kMaxNb")
# the stages and cuts of csrc/wide_kernel.cuh `Stage` and `Cut`: fwd and
# fwdgrad are the kernels the wrappers launch; pass_a and pass_ab are timing
# cuts of fwdgrad (chip_smoke.py [wide] (c)), which stop after pass A and
# the factors and after pass B
WIDE_STAGES = ("phase", "velo")
WIDE_CUTS = ("fwd", "fwdgrad", "pass_a", "pass_ab")
_WIDE_LAYOUT_NAMES = ("kThreads", "kGeneChunk", "kCellsPerTile",
                      "kSmemBudget", "kPhaseChunkCols", "kVeloChunkCols")


class Layout(NamedTuple):
    """A kernel body's layout constants (csrc/phase_kernel.cuh,
    csrc/velo_kernel.cuh)."""
    threads: int
    cells_per_tile: int     # cells of one tile: the gene partials' first axis
    gene_chunk: int         # genes staged per step of the sweep
    stages: int             # count-ring stages in shared memory
    max_nb: int             # most delta_nu batches taken as such


class Plan(NamedTuple):
    """How one call of a kernel is laid out on the card (vct_phase_plan,
    vct_velo_plan)."""
    grid: int               # CTAs
    pieces: int             # cell-gradient pieces per cell (0: none)
    blocks_per_sm: int      # resident CTAs per SM
    dyn_smem: int           # dynamic shared memory per CTA, bytes
    loss_pieces: int        # loss partials per chain


class WideLayout(NamedTuple):
    """The wide body's layout constants (csrc/wide_kernel.cuh)."""
    threads: int
    gene_chunk: int         # genes of a unit
    cells_per_tile: int     # cells of a tile: the gene partials' tiles
    smem_budget: int        # dynamic shared memory a CTA takes at most, bytes
    phase_chunk_cols: int   # basis columns per chunk of pass A past the fit
    velo_chunk_cols: int


class WidePlan(NamedTuple):
    """How one call of the wide body is laid out on the card
    (vct_wide_plan)."""
    grid: int
    pieces: int
    blocks_per_sm: int
    dyn_smem: int
    loss_pieces: int
    sweep_cols: int         # basis columns resident per sweep of a tile
    sweeps: int             # sweeps of a tile's genes: 1 up to the fit
    chunked: int            # 1: pass A reads the columns in chunks


def _read_layout(header, names=_LAYOUT_NAMES, kind=Layout):
    text = (cuda_build.CSRC / header).read_text()
    vals = []
    for name in names:
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        if m is None:
            raise RuntimeError(f"csrc/{header} defines no {name}")
        vals.append(int(m.group(1)))
    return kind(*vals)


@functools.lru_cache(maxsize=None)
def phase_layout():
    """The layout constants of the phase kernels, from csrc/phase_kernel.cuh,
    their one definition; the built library reports the same numbers
    (`vct_phase_layout`, checked when it is loaded).  The plain versions
    read them here to cut their partials as the kernels do."""
    return _read_layout("phase_kernel.cuh")


@functools.lru_cache(maxsize=None)
def velo_layout():
    """The layout constants of the velocity kernels, from
    csrc/velo_kernel.cuh, their one definition; the built library reports
    the same numbers (`vct_velo_layout`, checked when it is loaded)."""
    return _read_layout("velo_kernel.cuh")


@functools.lru_cache(maxsize=None)
def wide_layout():
    """The layout constants of the wide body, from csrc/wide_kernel.cuh,
    their one definition; the built library reports the same numbers
    (`vct_wide_layout`, checked when it is loaded)."""
    return _read_layout("wide_kernel.cuh", _WIDE_LAYOUT_NAMES, WideLayout)


def _typed_lib(name, prefix, layout, argtypes):
    """The loaded library of csrc/<name>.cu with its C functions typed and
    its layout (``lib.layout``, as the library reports it); raises unless
    that is ``layout``."""
    lib = cuda_build.load(name)
    if getattr(lib, "_vct_typed", False):
        return lib
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = _I
    out = (ctypes.c_int * len(layout))()
    getattr(lib, f"{prefix}_layout")(out, len(out))
    lib.layout = type(layout)(*out)
    if lib.layout != layout:
        raise RuntimeError(f"lib{name} reports {lib.layout}, the kernel "
                           f"source {layout}")
    lib._vct_typed = True
    return lib


def _phase_lib():
    """The loaded library of csrc/nb_phase.cu, typed and checked."""
    return _typed_lib("nb_phase", "vct_phase", phase_layout(), {
        "vct_phase_layout": [_P, _I],
        # mode, int16 flag, Ng, Nc, Nh, Nb, K, skip_k, want_disp, out
        "vct_phase_plan": [_I] * 9 + [_P],
        # mode, S, int16 flag, nu, zeta, cf, disp, dnu, Db, Ng, Nc, Nh, Nb,
        # K, the strides of nu, zeta, cf, disp, dnu, skip_k, want_disp,
        # n_rep, grid, pieces, loss_pieces, loss_part, gene_part,
        # cell_piece, dzeta, dcf, stream
        "vct_phase_run": ([_I, _P, _I] + [_P] * 6 + [_I] * 5 + [_L] * 5
                          + [_I] * 6 + [_P] * 6),
    })


def _velo_lib():
    """The loaded library of csrc/nb_velo.cu, typed and checked."""
    # S, S int16 flag, U, U int16 flag, nu, zeta, zeta_dphi, cf, omega,
    # log_beta, log_gamma, disp, dnu, Db, Ng, Nc, Nh, Nb, K, the strides of
    # nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, disp, dnu, skip_k
    common = [_P, _I, _P, _I] + [_P] * 10 + [_I] * 5 + [_L] * 9 + [_I]
    return _typed_lib("nb_velo", "vct_velo", velo_layout(), {
        "vct_velo_layout": [_P, _I],
        # cut, S int16, U int16, Ng, Nc, Nh, Nb, K, skip_k, want_disp, out
        "vct_velo_plan": [_I] * 10 + [_P],
        # ..., grid, loss_pieces, loss_part, stream
        "vct_velo_fwd": common + [_I, _I, _P, _P],
        # ..., want_disp, grid, pieces, loss_pieces, loss_part, gene_part,
        # cell_piece, dzeta, dzeta_dphi, dcf, domega, stream
        "vct_velo_fwdgrad": common + [_I] * 4 + [_P] * 8,
    })


def _wide_lib():
    """The loaded library of csrc/nb_wide.cu, typed and checked."""
    return _typed_lib("nb_wide", "vct_wide", wide_layout(), {
        "vct_wide_layout": [_P, _I],
        # stage, cut, S int16, U int16, Ng, Nc, W, K, want_disp, out
        "vct_wide_plan": [_I] * 9 + [_P],
        # stage, cut, S, S int16, U, U int16, nu, zeta, zeta_dphi, cf,
        # omega, log_beta, log_gamma, disp, Ng, Nc, W, K, the strides of
        # nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, disp,
        # skip_k, want_disp, grid, pieces, loss_pieces, loss_part,
        # gene_part, cell_piece, dzeta, dzeta_dphi, dcf, domega, stream
        "vct_wide_run": ([_I, _I, _P, _I, _P, _I] + [_P] * 8 + [_I] * 4
                         + [_L] * 8 + [_I] * 5 + [_P] * 8),
    })


def _device_index(device):
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=256)
def _plan(lib_fn, device_index, args):
    lib, kind = {"vct_phase_plan": (_phase_lib, Plan),
                 "vct_velo_plan": (_velo_lib, Plan),
                 "vct_wide_plan": (_wide_lib, WidePlan)}[lib_fn]
    out = (ctypes.c_int * len(kind._fields))()
    with torch.cuda.device(device_index):
        rc = getattr(lib(), lib_fn)(*args, out)
    _raise_on(rc, f"{lib_fn} {args}")
    return kind(*out)


def phase_plan(mode, int16, Ng, Nc, Nh=5, Nb=0, skip_k=True, want_disp=True,
               device=None, chains=1):
    """The `Plan` of one call of the phase kernel in ``mode``
    (`PHASE_MODES`) on ``device`` (default: the current card), for int16
    or float32 counts, at an instantiated width Nh, over ``chains``
    parameter sets (more than one for fwd and fwdgrad only)."""
    return _plan("vct_phase_plan", _device_index(device), (
        PHASE_MODES.index(mode), int(bool(int16)), Ng, Nc, Nh, Nb,
        int(chains), int(bool(skip_k)), int(bool(want_disp))))


def velo_plan(cut, s_int16, u_int16, Ng, Nc, Nh=5, Nb=0, skip_k=True,
              want_disp=False, device=None, chains=1):
    """The `Plan` of one call of the velocity kernel cut ``cut``
    (`VELO_CUTS`) on ``device`` (default: the current card), for int16 or
    float32 S and U each, at an instantiated width Nh, over ``chains``
    parameter sets."""
    return _plan("vct_velo_plan", _device_index(device), (
        VELO_CUTS.index(cut), int(bool(s_int16)), int(bool(u_int16)), Ng, Nc,
        Nh, Nb, int(chains), int(bool(skip_k)), int(bool(want_disp))))


def wide_plan(stage, cut, s_int16, u_int16, Ng, Nc, W, want_disp=False,
              device=None, chains=1):
    """The `WidePlan` of one call of the wide body for ``stage``
    (`WIDE_STAGES`) and ``cut`` (`WIDE_CUTS`) on ``device`` (default: the
    current card), for int16 or float32 S (and U), at W basis columns, over
    ``chains`` parameter sets."""
    return _plan("vct_wide_plan", _device_index(device), (
        WIDE_STAGES.index(stage), WIDE_CUTS.index(cut), int(bool(s_int16)),
        int(bool(u_int16)), Ng, Nc, W, int(chains), int(bool(want_disp))))


def _chain_stride(t, base_dim):
    """Floats between two chains' copies of a parameter operand: its size
    per chain when it carries the leading chain axis, else 0 (shared)."""
    if t is None or t.dim() == base_dim:
        return 0
    return t[0].numel()


def _phase_launch(mode, S, nu, zeta, cf, r, delta_nu=None, Db=None,
                  skip_k=True, want_disp=False, n_rep=0, chains=1):
    """One launch of csrc/nb_phase.cu in ``mode`` (`PHASE_MODES`) on checked
    CUDA tensors at an instantiated width; inputs the mode does not read may
    be None.  With ``chains`` = K > 1 (fwd and fwdgrad only) each of nu,
    zeta, cf, r
    and delta_nu either carries a leading axis K or is shared by the chains.
    Returns (loss partials (K, loss_pieces) float64, gene partials (K,
    n_tiles, Ng, NV) or None, dzeta (K, Nc, Nh) or None, dcf (K, Nc) or
    None)."""
    lib = _phase_lib()
    Ng, Nh = nu.shape[-2:]
    Nc = zeta.shape[-2] if S is None else S.shape[1]
    Nb = 0 if delta_nu is None else delta_nu.shape[-2]
    int16 = S is not None and S.dtype == torch.int16
    K = int(chains)
    dev = nu.device
    plan = phase_plan(mode, int16, Ng, Nc, Nh, Nb, skip_k, want_disp, dev,
                      chains=K)
    f32 = dict(dtype=torch.float32, device=dev)
    # zeros: a chain with fewer loss pieces than the most leaves the rest
    loss_part = torch.zeros((K, plan.loss_pieces), dtype=torch.float64,
                            device=dev)
    gene_part = cell_piece = dzeta = dcf = None
    if mode in _PHASE_GENE_EXTRA:
        tiles = -(-Nc // lib.layout.cells_per_tile)
        gene_part = torch.empty(
            (K, tiles, Ng, Nh + _PHASE_GENE_EXTRA[mode] + Nb), **f32)
    if mode in _PHASE_CELL_GRADS:
        dzeta = torch.empty((K, Nc, Nh), **f32)
        dcf = torch.empty((K, Nc), **f32)
        if plan.pieces:
            cell_piece = torch.empty((plan.pieces, Nh + 1, K * Nc), **f32)
    strides = [_chain_stride(t, d) for t, d in
               ((nu, 2), (zeta, 2), (cf, 1), (r, 1), (delta_nu, 2))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_phase_run(
            PHASE_MODES.index(mode), _ptr(S), int(int16), _ptr(nu),
            _ptr(zeta), _ptr(cf), _ptr(r), _ptr(delta_nu), _ptr(Db), Ng, Nc,
            Nh, Nb, K, *strides, int(skip_k), int(want_disp), int(n_rep),
            plan.grid, plan.pieces, plan.loss_pieces, loss_part.data_ptr(),
            _ptr(gene_part), _ptr(cell_piece), _ptr(dzeta), _ptr(dcf),
            stream,
        )
    _raise_on(rc, f"phase {mode}")
    return loss_part, gene_part, dzeta, dcf


# the ranks of the wide body's parameter operands: nu, zeta, zeta_dphi,
# cf, omega, log_beta, log_gamma, r
_WIDE_OPERAND_DIMS = (2, 2, 2, 1, 1, 1, 1, 1)


def _wide_launch(stage, cut, counts, ops, skip_k, want_disp, chains):
    """One launch of csrc/nb_wide.cu for ``stage`` (`WIDE_STAGES`) and
    ``cut`` (`WIDE_CUTS`) on checked CUDA tensors at W = nu's columns, no
    delta_nu (folded in): counts [S] or [S, U]; ops [nu, zeta, zeta_dphi,
    cf, omega, log_beta, log_gamma, r], None where the stage reads none,
    each with a leading chain axis K = ``chains`` or shared.  Returns (loss
    partials (K, loss_pieces) float64, gene partials summed over the cell
    tiles (K, Ng, NV) or None (fwd), [dzeta, dzeta_dphi, dcf, domega] (K,
    ...) with None where the stage has none (fwdgrad), or [])."""
    lib = _wide_lib()
    S = counts[0]
    U = counts[1] if len(counts) > 1 else None
    Ng, Nc = S.shape
    W = ops[0].shape[-1]
    K = int(chains)
    velo = stage == "velo"
    s16 = S.dtype == torch.int16
    u16 = U is not None and U.dtype == torch.int16
    dev = S.device
    plan = wide_plan(stage, cut, s16, u16, Ng, Nc, W, want_disp, dev,
                     chains=K)
    f32 = dict(dtype=torch.float32, device=dev)
    # zeros: a chain with fewer loss pieces than the most leaves the rest
    loss_part = torch.zeros((K, plan.loss_pieces), dtype=torch.float64,
                            device=dev)
    gene_part = cell_piece = None
    cell = []
    if cut != "fwd":
        tiles = -(-Nc // lib.layout.cells_per_tile)
        gene_part = torch.empty((K, tiles, Ng, W + (3 if velo else 1)), **f32)
    if cut == "fwdgrad":
        cell_piece = torch.empty(
            (plan.pieces, 2 * W + 2 if velo else W + 1, K * Nc), **f32)
        cell = [torch.empty((K, Nc, W), **f32),
                torch.empty((K, Nc, W), **f32) if velo else None,
                torch.empty((K, Nc), **f32),
                torch.empty((K, Nc), **f32) if velo else None]
    strides = [_chain_stride(t, d) for t, d in zip(ops, _WIDE_OPERAND_DIMS)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_wide_run(
            WIDE_STAGES.index(stage), WIDE_CUTS.index(cut), _ptr(S), int(s16),
            _ptr(U), int(u16), *(_ptr(t) for t in ops), Ng, Nc, W, K,
            *strides, int(skip_k), int(want_disp), plan.grid, plan.pieces,
            plan.loss_pieces, loss_part.data_ptr(),
            _ptr(gene_part), _ptr(cell_piece),
            *(None if t is None else t.data_ptr()
              for t in (cell or [None] * 4)),
            stream,
        )
    _raise_on(rc, f"{stage} wide {cut}")
    return loss_part, None if gene_part is None else gene_part.sum(1), cell


# parameter shapes over g = genes, c = cells, h = basis columns
_SHAPES = {"nu": "gh", "zeta": "ch", "zeta_dphi": "ch", "count_factor": "c",
           "omega": "c", "log_beta": "g", "log_gamma": "g",
           "dispersion": "g"}


# the operands the kernels take per chain in a chain-batched call (every
# parameter; the phase kernels have no zeta_dphi, omega, log_beta or
# log_gamma); the counts and Db are shared by every chain
_CHAIN_OPERANDS = ("nu", "zeta", "zeta_dphi", "count_factor", "omega",
                   "log_beta", "log_gamma", "dispersion", "delta_nu")


def _check_inputs(counts, params, delta_nu, Db, chains=False, device=True):
    """Shapes always; device, dtype and contiguity for the kernels
    (``device=False``: shapes only).

    counts: [(name, (Ng, Nc) tensor)], or empty for a kernel that reads no
    count matrix (Ng and Nc then come from nu and zeta), each int16 or
    float32 on its own; params: {name: tensor}, names from `_SHAPES`;
    ``chains``: the
    `_CHAIN_OPERANDS` may each carry a leading chain axis K.  Returns K, or
    None when no operand carries one."""
    if counts:
        S = counts[0][1]
        if S.dim() != 2:
            raise ValueError(f"S must be (Ng, Nc), got {tuple(S.shape)}")
        Ng, Nc = S.shape
    else:
        S = params["nu"]
        Ng, Nc = S.shape[-2], params["zeta"].shape[-2]
    Nh = params["nu"].shape[-1]
    dims = {"g": Ng, "c": Nc, "h": Nh}
    want = {name: tuple(dims[d] for d in _SHAPES[name]) for name in params}
    got = dict(params)
    for name, t in counts[1:]:
        want[name] = (Ng, Nc)
        got[name] = t
    if (delta_nu is None) != (Db is None):
        raise ValueError("delta_nu and Db must be given together")
    Nb = 0
    if delta_nu is not None:
        Nb = delta_nu.shape[-2]
        want.update(delta_nu=(Nb, Ng), Db=(Nb, Nc))
        got.update(delta_nu=delta_nu, Db=Db)
    K = None
    for name, t in got.items():
        shape = tuple(t.shape)
        if chains and name in _CHAIN_OPERANDS and len(shape) == len(want[name]) + 1:
            if K not in (None, shape[0]) or shape[0] < 1:
                raise ValueError(f"{name} has {shape[0]} chains, another "
                                 f"operand {K}")
            K, shape = shape[0], shape[1:]
        if shape != want[name]:
            raise ValueError(
                f"{name} must have shape {want[name]}"
                + (" (with a leading chain axis or without)"
                   if chains and name in _CHAIN_OPERANDS else "")
                + f", got {tuple(t.shape)}"
            )
    if not device or S.device.type != "cuda":
        return K
    for name, t in counts:
        if t.dtype not in (torch.int16, torch.float32):
            raise TypeError(f"{name} must be int16 or float32, got {t.dtype}")
    if Ng < 1 or Nc < 1:
        raise ValueError(f"empty count matrix {(Ng, Nc)}")
    for name, t in [*counts, *got.items()]:
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, counts on {S.device}")
        if name not in ("S", "U") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _on_card(name, counts, params, delta_nu, Db, max_nb):
    """Check a kernel call and choose its width: (width, fold) of
    `kernel_width` and the chain count of `_check_inputs` (every parameter
    may carry a leading chain axis); raises for CPU tensors."""
    K = _check_inputs(counts, params, delta_nu, Db, chains=True)
    ref = counts[0][1]
    if ref.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got CPU tensors")
    Nb = 0 if delta_nu is None else delta_nu.shape[-2]
    return (*kernel_width(params["nu"].shape[-1], Nb, max_nb), K)


def _phase_params(nu, zeta, cf, r):
    return {"nu": nu, "zeta": zeta, "count_factor": cf, "dispersion": r}


def _counted(name, width):
    """The name a launch at ``width`` counts under: ``*_wide`` past
    NARROW_WIDTH, where the wide body runs it."""
    return name + "_wide" if width > NARROW_WIDTH else name


def _phase_call(name, S, nu, zeta, cf, r, delta_nu, Db, lgamma_k_sum,
                want_disp=False):
    """Check, widen where the shape needs it, launch and count one phase
    kernel (over a chain batch where operands carry a leading chain axis):
    the narrow body, or the wide body past NARROW_WIDTH columns.  Returns
    (loss, gene partials summed over the cell tiles or None, dzeta or None,
    dcf or None, (Nh, Nb, fold, kernel delta_nu)), each with the leading
    chain axis in a chain-batched call."""
    grad = name == "phase_fwdgrad"
    width, fold, K = _on_card(name, [("S", S)], _phase_params(nu, zeta, cf, r),
                              delta_nu, Db, phase_layout().max_nb)
    Nb = 0 if delta_nu is None else delta_nu.shape[-2]
    counted = _counted(name, width)
    nu_k, (zeta_k,), dnu_k, Db_k = widen_inputs(nu, [zeta], delta_nu, Db,
                                                width, fold)
    skip_k = lgamma_k_sum is not None
    if counted.endswith("_wide"):
        loss_part, gene, cell = _wide_launch(
            "phase", "fwdgrad" if grad else "fwd", [S],
            [nu_k, zeta_k, None, cf, None, None, None, r], skip_k,
            bool(want_disp), K or 1)
        dzeta, dcf = (cell[0], cell[2]) if grad else (None, None)
    else:
        loss_part, gene_part, dzeta, dcf = _phase_launch(
            "fwdgrad" if grad else "fwd", S, nu_k, zeta_k, cf, r, dnu_k, Db_k,
            skip_k=skip_k, want_disp=bool(want_disp), chains=K or 1)
        gene = None if gene_part is None else gene_part.sum(1)
    _count_launch(counted, width, K or 1)
    # fixed-order reductions over each chain's loss pieces and cell tiles
    # (no float atomics)
    loss = _finish_loss(loss_part.sum(-1), lgamma_k_sum)
    if K is None:   # unbatched: drop the chain axis of one
        loss, gene, dzeta, dcf = (None if t is None else t[0]
                                  for t in (loss, gene, dzeta, dcf))
    return loss, gene, dzeta, dcf, (nu.shape[-1], Nb, fold, dnu_k)


def _phase_grads(S, nu, zeta, cf, r, delta_nu, Db, lgamma_k_sum,
                 want_disp):
    loss, gene, dzeta, dcf, (Nh, Nb, fold, dnu_k) = _phase_call(
        "phase_fwdgrad", S, nu, zeta, cf, r, delta_nu, Db, lgamma_k_sum,
        want_disp)
    W = dzeta.shape[-1]
    ddnu = (gene[..., W + 1:].transpose(-1, -2).contiguous()
            if dnu_k is not None else None)
    dnu, (dzeta,), ddnu = narrow_grads(gene[..., :W], [dzeta], ddnu, Nh, Nb,
                                       fold)
    return loss, (dnu, dzeta, dcf, gene[..., W].contiguous(), ddnu)


def phase_fwd(S, nu, zeta, cf, r, delta_nu=None, Db=None, lgamma_k_sum=None):
    """Loss of the fused phase NB likelihood on the card (CUDA tensors); past
    NARROW_WIDTH basis columns on the wide body, counted as phase_fwd_wide.

    Chain-batched as `phase_fwdgrad`: where any of nu, zeta, cf, r and
    delta_nu carries a leading chain axis K, ONE launch computes the K
    losses (K,); counted once in LAUNCHES and under K in LAUNCH_CHAINS."""
    return _phase_call("phase_fwd", S, nu, zeta, cf, r, delta_nu, Db,
                       lgamma_k_sum)[0]


def phase_fwdgrad(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                  lgamma_k_sum=None, want_disp=True):
    """Loss and every gradient of the fused phase NB likelihood on the card:
    (loss, (dnu, dzeta, dcf, ddisp, ddelta_nu)), as `phase_fwdgrad_plain`.
    The kernel's gene partials hold [dnu (width), ddisp, ddelta_nu (Nb)].
    Past NARROW_WIDTH basis columns on the wide body, counted as
    phase_fwdgrad_wide.

    Chain-batched as `phase_fwdgrad_plain`: where any of nu, zeta, cf, r and
    delta_nu carries a leading chain axis K, ONE launch computes all K
    chains (the operands without the axis shared by them) and the loss is
    (K,) and every gradient (K, ...); counted once in LAUNCHES and under K
    in LAUNCH_CHAINS."""
    return _phase_grads(S, nu, zeta, cf, r, delta_nu, Db, lgamma_k_sum,
                        want_disp)


def _velo_params(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r):
    return {"nu": nu, "zeta": zeta, "zeta_dphi": zeta_dphi,
            "count_factor": cf, "omega": omega, "log_beta": log_beta,
            "log_gamma": log_gamma, "dispersion": r}


def _velo_call(name, S, U, params, delta_nu, Db, lgamma_k_sum,
               want_disp=False):
    """Check, widen where the shape needs it, size the buffers from the
    plan, launch and count one velocity kernel (over a chain batch where
    operands carry a leading chain axis): the narrow body, or the wide body
    past NARROW_WIDTH columns.  Returns (loss, gene
    partials summed over the cell tiles (Ng, W + 3 + Nb) or None, [dzeta,
    dzeta_dphi, dcf, domega] at width W or [], (Nh, Nb, fold, kernel
    delta_nu)), each with the leading chain axis in a chain-batched call."""
    width, fold, K = _on_card(name, [("S", S), ("U", U)], params, delta_nu,
                              Db, velo_layout().max_nb)
    Nb = 0 if delta_nu is None else delta_nu.shape[-2]
    counted = _counted(name, width)
    nu, (zeta, zdphi), dnu_k, Db_k = widen_inputs(
        params["nu"], [params["zeta"], params["zeta_dphi"]], delta_nu, Db,
        width, fold)
    Kc = K or 1
    cut = "fwdgrad" if name == "velo_fwdgrad" else "fwd"
    skip_k = lgamma_k_sum is not None
    ops = [zeta, zdphi, *(params[k] for k in (
        "count_factor", "omega", "log_beta", "log_gamma", "dispersion"))]
    if counted.endswith("_wide"):
        loss_part, gene, cell = _wide_launch(
            "velo", cut, [S, U], [nu, *ops], skip_k, bool(want_disp), Kc)
    else:
        loss_part, gene, cell = _velo_launch(
            cut, S, U, nu, ops, dnu_k, Db_k, skip_k, bool(want_disp), Kc)
    _count_launch(counted, width, Kc)
    # fixed-order reductions over each chain's loss pieces and cell tiles
    # (no float atomics)
    loss = _finish_loss(loss_part.sum(-1), lgamma_k_sum)
    if K is None:   # unbatched: drop the chain axis of one
        loss = loss[0]
        gene = None if gene is None else gene[0]
        cell = [t[0] for t in cell]
    return loss, gene, cell, (params["nu"].shape[-1], Nb, fold, dnu_k)


def _velo_launch(cut, S, U, nu, ops, dnu_k, Db_k, skip_k, want_disp, Kc):
    """One launch of csrc/nb_velo.cu at an instantiated width: (loss
    partials (K, loss_pieces), gene partials summed over the cell tiles
    (K, Ng, W + 3 + Nb) or None, [dzeta, dzeta_dphi, dcf, domega] (K, ...)
    or [])."""
    lib = _velo_lib()
    Ng, Nc = S.shape
    width = nu.shape[-1]
    Nb_k = 0 if dnu_k is None else dnu_k.shape[-2]
    s16, u16 = S.dtype == torch.int16, U.dtype == torch.int16
    dev = S.device
    plan = velo_plan(cut, s16, u16, Ng, Nc, width, Nb_k, skip_k, want_disp,
                     dev, chains=Kc)
    f32 = dict(dtype=torch.float32, device=dev)
    # zeros: a chain with fewer loss pieces than the most leaves the rest
    loss_part = torch.zeros((Kc, plan.loss_pieces), dtype=torch.float64,
                            device=dev)
    strides = [_chain_stride(t, d) for t, d in zip(
        [nu, *ops, dnu_k], (2, 2, 2, 1, 1, 1, 1, 1, 2))]
    args = [_ptr(S), int(s16), _ptr(U), int(u16), _ptr(nu),
            *(_ptr(t) for t in ops), _ptr(dnu_k), _ptr(Db_k), Ng, Nc, width,
            Nb_k, Kc, *strides, int(skip_k)]
    gene_part, cell = None, []
    if cut == "fwd":
        fn = lib.vct_velo_fwd
        tail = [plan.grid, plan.loss_pieces, loss_part.data_ptr()]
    else:
        tiles = -(-Nc // lib.layout.cells_per_tile)
        gene_part = torch.empty(
            (Kc, tiles, Ng, width + _VELO_GENE_EXTRA + Nb_k), **f32)
        cell_piece = torch.empty((plan.pieces, 2 * width + 2, Kc * Nc), **f32)
        cell = [torch.empty(shape, **f32) for shape in (
            (Kc, Nc, width), (Kc, Nc, width), (Kc, Nc), (Kc, Nc))]
        fn = lib.vct_velo_fwdgrad
        tail = [int(want_disp), plan.grid, plan.pieces,
                plan.loss_pieces, loss_part.data_ptr(), gene_part.data_ptr(),
                cell_piece.data_ptr(), *(t.data_ptr() for t in cell)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, *tail, stream)
    _raise_on(rc, f"velo_{cut}")
    return loss_part, None if gene_part is None else gene_part.sum(1), cell


def _velo_grads(args, delta_nu, Db, lgamma_k_sum, want_disp):
    loss, gene, (dzeta, dzdphi, dcf, domega), (Nh, Nb, fold, dnu_k) = \
        _velo_call("velo_fwdgrad", args[0], args[1], _velo_params(*args[2:]),
                   delta_nu, Db, lgamma_k_sum, want_disp)
    W = dzeta.shape[-1]
    ddnu = (gene[..., W + 3:].transpose(-1, -2).contiguous()
            if dnu_k is not None else None)
    dnu, (dzeta, dzdphi), ddnu = narrow_grads(
        gene[..., :W], [dzeta, dzdphi], ddnu, Nh, Nb, fold)
    return loss, (dnu, dzeta, dzdphi, dcf, domega,
                  gene[..., W + 1].contiguous(),
                  gene[..., W + 2] * torch.exp(args[8]),
                  gene[..., W].contiguous(), ddnu)


def velo_fwd(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r,
             delta_nu=None, Db=None, lgamma_k_sum=None):
    """Loss of the fused velocity S+U NB likelihood on the card; past
    NARROW_WIDTH basis columns on the wide body, counted as velo_fwd_wide.

    Chain-batched as `phase_fwd`: where any parameter carries a leading
    chain axis K, ONE launch computes the K losses (K,); counted once in
    LAUNCHES and under K in LAUNCH_CHAINS."""
    return _velo_call(
        "velo_fwd", S, U,
        _velo_params(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r),
        delta_nu, Db, lgamma_k_sum)[0]


def velo_fwdgrad(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma,
                 r, delta_nu=None, Db=None, lgamma_k_sum=None,
                 want_disp=True):
    """Loss and every gradient of the fused velocity S+U NB likelihood on
    the card, as `velo_fwdgrad_plain`.  The kernel's gene partials hold
    [dnu (width), ddisp, dlog_beta, sum_c g_x, ddelta_nu (Nb)] per gene;
    dlog_gamma is sum_c g_x times exp(log_gamma), applied after the sum.
    Past NARROW_WIDTH basis columns on the wide body, counted as
    velo_fwdgrad_wide.

    Chain-batched as `phase_fwdgrad`: where any of the parameters (nu,
    zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r, delta_nu) carries a
    leading chain axis K, ONE launch computes all K chains (the operands
    without the axis shared by them, S, U and Db always), and the loss is
    (K,) and every gradient (K, ...); counted once in LAUNCHES and under K
    in LAUNCH_CHAINS."""
    return _velo_grads((S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                        log_gamma, r), delta_nu, Db, lgamma_k_sum, want_disp)


# ---------------------------------------------------------------------------
# autograd bindings
# ---------------------------------------------------------------------------

_NO_SECOND_DERIVATIVE = (
    "the fused NB likelihood has no second derivative: its backward scales "
    "gradients the kernel computed in the forward pass.  Take Hessians, "
    "Hessian-vector products and forward-mode derivatives through the plain "
    "model path (use_fused_nb=False)")

def _velo_plain_chains(plain):
    """``plain`` (`velo_fwd_plain` or `velo_fwdgrad_plain`) over a chain
    batch (the CPU path): each operand with a leading chain axis mapped
    over it."""

    def over_chains(S, U, *params, lgamma_k_sum=None, **kw):
        dims = tuple(0 if t is not None and t.dim() > d else None
                     for t, d in zip(params, _VELO_OPERAND_DIMS))

        def one_chain(*p):
            out = plain(S, U, *p, lgamma_k_sum=lgamma_k_sum, **kw)
            if isinstance(out, torch.Tensor):
                return out
            loss, grads = out
            return loss, [d for d in grads if d is not None]

        out = torch.func.vmap(one_chain, in_dims=dims)(*params)
        if isinstance(out, torch.Tensor):
            return out
        loss, grads = out
        grads = iter(grads)
        # ddelta_nu, the last gradient, is None without delta_nu
        return loss, tuple(next(grads) if i < 8 or params[8] is not None
                           else None for i in range(9))

    return over_chains


# the ranks of the velocity kernels' operands after S and U: nu, zeta,
# zeta_dphi, cf, omega, log_beta, log_gamma, r, delta_nu, Db
_VELO_OPERAND_DIMS = (2, 2, 2, 1, 1, 1, 1, 1, 2, 2)


class _NoSecondDerivative(torch.autograd.Function):
    """The identity on a gradient of the fused likelihood, tied to the
    likelihood's inputs so that differentiating it (double backward, or a
    forward-mode derivative of the gradient) raises instead of silently
    dropping the likelihood's curvature."""

    generate_vmap_rule = True

    @staticmethod
    def forward(grad, *inputs):
        return grad.view_as(grad)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(_NO_SECOND_DERIVATIVE)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(_NO_SECOND_DERIVATIVE)


class _FusedNBLogLik(torch.autograd.Function):
    """One fwd+grad pass in forward; backward scales the saved gradients.

    ``fwdgrad(*inputs, want_disp=...)`` returns (loss, grads) with one
    gradient per differentiable input but the last (Db), None where that
    input is None; ``n_data`` leading inputs are data (counts) and take no
    gradient.  The gradients leave `forward` as outputs marked
    non-differentiable, so that under `torch.func.vmap` they are batched
    like the loss; the `vmap` rule makes ONE chain-batched call for the
    whole batch (`phase_fwdgrad` or `velo_fwdgrad` over its chain axis).
    The likelihood has no second derivative: differentiating its gradient
    raises, and so does a forward-mode derivative."""

    @staticmethod
    def forward(fwdgrad, n_data, lgamma_k_sum, disp_grad, *inputs):
        loss, grads = fwdgrad(*inputs, lgamma_k_sum=lgamma_k_sum,
                              want_disp=disp_grad)
        return (loss, *(d for d in grads if d is not None))

    @staticmethod
    def setup_context(ctx, inputs, output):
        grads = output[1:]
        ctx.mark_non_differentiable(*grads)
        ctx.n_data = inputs[1]
        ctx.n_inputs = len(inputs) - 4
        ctx.save_for_backward(*inputs[4:], *grads)

    @staticmethod
    def backward(ctx, g, *_):
        saved = ctx.saved_tensors
        diff = saved[ctx.n_data:ctx.n_inputs]
        grads = iter(saved[ctx.n_inputs:])
        live = [t for t in diff if t is not None]
        out = [None] * (4 + ctx.n_data)
        for i, t in enumerate(diff):
            if t is None or i == len(diff) - 1:   # absent, or Db
                out.append(None)
                continue
            d = next(grads)
            # g is (K,) over a chain batch, d (K, ...)
            gd = g.reshape(g.shape + (1,) * (d.dim() - g.dim())) * d
            out.append(_NoSecondDerivative.apply(gd, *live)
                       if ctx.needs_input_grad[4 + ctx.n_data + i] else None)
        return tuple(out)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(_NO_SECOND_DERIVATIVE)

    @staticmethod
    def vmap(info, in_dims, fwdgrad, n_data, lgamma_k_sum, disp_grad,
             *inputs):
        moved = _chain_major(in_dims[2], in_dims[4:], n_data, inputs)
        # the chain-batched call, itself differentiable by the autograd
        # outside the vmap
        out = _FusedNBLogLik.apply(_CHAINS[fwdgrad], n_data, lgamma_k_sum,
                                   disp_grad, *moved)
        return out, (0,) * len(out)


class _FusedNBLoss(torch.autograd.Function):
    """The loss-only kernel under `torch.func.vmap`: its `vmap` rule makes
    ONE chain-batched call for the whole batch (`phase_fwd` or `velo_fwd`
    over its chain axis).  `_fused` sends a batched call here only with
    gradients disabled, so it has no backward."""

    @staticmethod
    def forward(fwd, n_data, lgamma_k_sum, *inputs):
        return fwd(*inputs, lgamma_k_sum=lgamma_k_sum)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the loss-only fused likelihood has no gradient: "
                           "evaluate it with gradients enabled")

    @staticmethod
    def vmap(info, in_dims, fwd, n_data, lgamma_k_sum, *inputs):
        moved = _chain_major(in_dims[2], in_dims[3:], n_data, inputs)
        return _FusedNBLoss.apply(_CHAINS[fwd], n_data, lgamma_k_sum,
                                  *moved), 0


def _chain_major(lgk_dim, dims, n_data, inputs):
    """The inputs of one chain-batched call: each batched parameter with its
    chain axis moved to the front.  The counts, lgamma_k_sum and Db (the
    last input) are shared by the chains and must not be batched."""
    if (lgk_dim is not None or dims[-1] is not None
            or any(d is not None for d in dims[:n_data])):
        raise ValueError("a chain batch shares the counts, lgamma_k_sum "
                         "and Db; only the parameters may be batched")
    return [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip(inputs, dims)]


def _fused(kernels, plains, n_data, inputs, lgamma_k_sum, disp_grad):
    """The loss through the (loss-only, fwd+grad) kernel pair on CUDA
    tensors or its plain pair on CPU tensors: the fwd+grad one when a
    differentiable input needs a gradient, and under `torch.func.vmap`
    with gradients enabled (a batched input reports no ``requires_grad``
    whatever it wraps); the loss-only one otherwise, under `vmap` through
    `_FusedNBLoss` (each binding's `vmap` rule makes the one chain-batched
    call)."""
    fwd, fwdgrad = kernels if inputs[0].device.type == "cuda" else plains
    params = [t for t in inputs[n_data:] if t is not None]
    batched = any(torch._C._functorch.is_batchedtensor(t) for t in params)
    if torch.is_grad_enabled() and (
            batched or any(t.requires_grad for t in params)):
        return _FusedNBLogLik.apply(fwdgrad, n_data, lgamma_k_sum,
                                    bool(disp_grad), *inputs)[0]
    if batched:
        return _FusedNBLoss.apply(fwd, n_data, lgamma_k_sum, *inputs)
    return fwd(*inputs, lgamma_k_sum=lgamma_k_sum)


def nb_loglik_fused(S, nu, zeta, count_factor, dispersion,
                    delta_nu=None, Db=None, lgamma_k_sum=None,
                    disp_grad=True):
    """Fused ``sum NB_logpmf(S | nu @ zeta^T [+ dnu offsets] + cf, r)``.

    Args:
      S: integer-valued counts (Ng, Nc), int16 or float32.
      nu: harmonic coefficients (Ng, Nh).
      zeta: basis at cell phases (Nc, Nh).
      count_factor: per-cell size factor (Nc,).
      dispersion: per-gene NB dispersion r (Ng,).
      delta_nu: optional per-batch offsets (Nb, Ng).
      Db: batch design (Nb, Nc), required with delta_nu.
      lgamma_k_sum: optional precomputed ``sum(lgamma(S + 1))``; the kernel
        then skips that per-element term.
      disp_grad: False compiles the dispersion gradient out; the returned
        dispersion gradient is then ZERO (valid only when it is discarded,
        e.g. shape_inv conditioned).

    Returns a 0-d float32 tensor, differentiable w.r.t. nu, zeta,
    count_factor, dispersion and delta_nu.

    On the card, shapes of at most NARROW_WIDTH = 16 basis columns (Nh <=
    7 with Nb <= 4 batches, else Nh + Nb) run on the narrow body's
    instantiations, wider ones, at any width, on the wide body at Nh + Nb
    columns, the batches folded in (`kernel_width`).  CPU tensors take any
    shape, through the plain versions.
    """
    _check_inputs([("S", S)], _phase_params(nu, zeta, count_factor,
                                            dispersion), delta_nu, Db,
                  device=False)
    return _fused(
        (phase_fwd, phase_fwdgrad), (phase_fwd_plain, phase_fwdgrad_plain), 1,
        (S, nu, zeta, count_factor, dispersion, delta_nu, Db),
        lgamma_k_sum, disp_grad,
    )


def nbsu_loglik_fused(S, U, nu, zeta, zeta_dphi, count_factor, omega,
                      log_beta, log_gamma, dispersion,
                      delta_nu=None, Db=None, lgamma_k_sum=None,
                      disp_grad=True):
    """Fused velocity-stage joint NB log-likelihood of S and U.

    Same contract as `nb_loglik_fused`, the widths included, plus
    U (Ng, Nc) counts, int16 or float32 whatever S is, zeta_dphi (Nc, Nh),
    omega (Nc,), log_beta and log_gamma (Ng,).  ``lgamma_k_sum`` is ``sum(lgamma(S+1)) + sum(lgamma(U+1))``.
    Differentiable w.r.t. nu, zeta, zeta_dphi, count_factor, omega,
    log_beta, log_gamma, dispersion and delta_nu; ``disp_grad=False``
    returns a ZERO dispersion gradient.
    """
    params = _velo_params(nu, zeta, zeta_dphi, count_factor, omega,
                          log_beta, log_gamma, dispersion)
    _check_inputs([("S", S), ("U", U)], params, delta_nu, Db, device=False)
    return _fused(
        (velo_fwd, velo_fwdgrad), (velo_fwd_plain, velo_fwdgrad_plain), 2,
        (S, U, *params.values(), delta_nu, Db), lgamma_k_sum, disp_grad,
    )


# each kernel function's call over a chain batch, for the `vmap` rules of
# `_FusedNBLogLik` and `_FusedNBLoss` (the kernels and the phase pair's
# plain versions take the chain axis themselves; the velocity pair's plain
# versions are mapped over it)
_CHAINS = {
    phase_fwd: phase_fwd,
    phase_fwdgrad: phase_fwdgrad,
    phase_fwd_plain: phase_fwd_plain,
    phase_fwdgrad_plain: phase_fwdgrad_plain,
    velo_fwd: velo_fwd,
    velo_fwdgrad: velo_fwdgrad,
    velo_fwd_plain: _velo_plain_chains(velo_fwd_plain),
    velo_fwdgrad_plain: _velo_plain_chains(velo_fwdgrad_plain),
}
