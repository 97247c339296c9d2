"""Fused NB log-likelihoods of both stages: CUDA kernels, their plain
versions, and the autograd bindings.

Every SVI step is dominated by a Negative-Binomial log-likelihood over the
dense genes x cells count matrix.  Phase stage: ``sum_{g,c} NB_logpmf(S |
ElogS, r)`` with ``ElogS = nu @ zeta^T + cf [+ delta_nu^T @ Db]``.
Velocity stage: the same for S plus ``NB_logpmf(U | ElogU, r)`` with the
kinetic coupling ``ElogU = -log_beta + log(relu(dEs * omega + exp(
log_gamma)) + 1e-5) + ElogS``, ``dEs = nu @ zeta_dphi^T``.  Four
hand-written CUDA kernels carry them on the card:

  * ``phase_fwd`` / ``phase_fwdgrad`` (`csrc/nb_phase.cu`) replace the
    Pallas kernels `_phase_fwd_kernel` / `_phase_fwdgrad_kernel` of
    velocycle_tpu/ops/nb_kernels.py;
  * ``velo_fwd`` / ``velo_fwdgrad`` (`csrc/nb_velo.cu`) replace
    `_velo_fwd_kernel` / `_velo_fwdgrad_kernel`.

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

import torch

from . import cuda_build
from .likelihoods import nb_logpmf
from .special import (
    lgamma_digamma_ratio, lgamma_pos, softplus, softplus_sigmoid,
)

__all__ = [
    "LAUNCHES",
    "SUPPORTED_NH",
    "nb_loglik_fused",
    "nb_loglik_reference",
    "nbsu_loglik_fused",
    "nbsu_loglik_reference",
    "phase_fwd",
    "phase_fwd_plain",
    "phase_fwdgrad",
    "phase_fwdgrad_plain",
    "reset_launch_counts",
    "velo_fwd",
    "velo_fwd_plain",
    "velo_fwdgrad",
    "velo_fwdgrad_plain",
]

# kernel launches on the card, by kernel; chip_smoke.py resets these just
# before it drives each stage of the main path and reads them just after
LAUNCHES = {"phase_fwd": 0, "phase_fwdgrad": 0, "velo_fwd": 0,
            "velo_fwdgrad": 0}
SUPPORTED_NH = (3, 5, 7)   # template instantiations in csrc/*.cu


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def nb_loglik_reference(S, nu, zeta, count_factor, dispersion,
                        delta_nu=None, Db=None):
    """sum of NB log-pmfs with ElogS = nu @ zeta^T [+ Db-routed batch
    offsets] + count_factor, through `ops.likelihoods.nb_logpmf`."""
    elog = _phase_elog(nu, zeta, count_factor, delta_nu, Db)
    return nb_logpmf(S, elog, dispersion[:, None]).sum()


def nbsu_loglik_reference(S, U, nu, zeta, zeta_dphi, count_factor, omega,
                          log_beta, log_gamma, dispersion,
                          delta_nu=None, Db=None):
    """Velocity-stage joint NB log-likelihood of S and U through
    `ops.likelihoods.nb_logpmf`, with ElogS as in `nb_loglik_reference` and
    ElogU = -log_beta + log(relu(dEs * omega + exp(log_gamma)) + 1e-5)
    + ElogS."""
    elogS, elogU, *_ = _velo_elogs(nu, zeta, zeta_dphi, count_factor, omega,
                                   log_beta, log_gamma, delta_nu, Db)
    r = dispersion[:, None]
    return (nb_logpmf(S, elogS, r) + nb_logpmf(U, elogU, r)).sum()


def _phase_elog(nu, zeta, cf, delta_nu, Db):
    elog = nu @ zeta.T + cf[None, :]
    if delta_nu is not None:
        elog = elog + delta_nu.T @ Db
    return elog


def _velo_elogs(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma,
                delta_nu, Db):
    """(ElogS, ElogU, dEs, gamma, x, xr) in the kernels' operation order;
    x is the pre-relu argument and xr = relu(x) + 1e-5.

    dEs is summed over the basis columns in order, one rounded product and
    one rounded sum at a time, exactly as `csrc/nb_velo.cu` forms it: the
    gradients carry 1/xr, up to 1e5 just above the relu, so x must agree
    bit for bit between the kernel and this version (a matmul's summation
    order would not)."""
    elogS = _phase_elog(nu, zeta, cf, delta_nu, Db)
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
    lgamma, softplus)."""
    log_b = -log_r - elog
    lgr, _ = lgamma_digamma_ratio(k, a)
    lp = lgr + a * log_b - (a + k) * softplus(log_b)
    if not skip_lgamma_k:
        lp = lp - lgamma_pos(k + 1.0)
    return lp


def _nb_lp_and_grads(k, a, log_r, elog, skip_k, want_r=True):
    """(log-pmf, d lp/d elog, d lp/d r) as the fwd+grad kernel computes
    them; ``want_r=False`` returns ``None`` for the dispersion term."""
    log_b = -log_r - elog
    sp, sig = softplus_sigmoid(log_b)
    lgr, dgr = lgamma_digamma_ratio(k, a)
    a_k = a + k
    lp = lgr + a * log_b - a_k * sp
    if not skip_k:
        lp = lp - lgamma_pos(k + 1.0)
    g_sig = a_k * sig
    g_elog = g_sig - a
    if not want_r:
        return lp, g_elog, None
    dlp_da = dgr + log_b - sp
    g_r = (dlp_da * (-a) + (g_sig - a)) * a
    return lp, g_elog, g_r


def _finish_loss(total64, lgamma_k_sum):
    if lgamma_k_sum is not None:
        total64 = total64 - torch.as_tensor(
            lgamma_k_sum, dtype=torch.float32, device=total64.device
        ).double()
    return total64.float()


def phase_fwd_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                    lgamma_k_sum=None):
    """Plain version of ``phase_fwd``: the loss."""
    elog = _phase_elog(nu, zeta, cf, delta_nu, Db)
    a = 1.0 / r[:, None]
    lp = _nb_lp(S.float(), elog, a, torch.log(r)[:, None],
                skip_lgamma_k=lgamma_k_sum is not None)
    return _finish_loss(lp.sum(dtype=torch.float64), lgamma_k_sum)


def phase_fwdgrad_plain(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                        lgamma_k_sum=None, want_disp=True):
    """Plain version of ``phase_fwdgrad``: (loss, (dnu, dzeta, dcf, ddisp,
    ddelta_nu)); ddisp is exactly zero when ``want_disp`` is False and
    ddelta_nu is None without delta_nu."""
    elog = _phase_elog(nu, zeta, cf, delta_nu, Db)
    a = 1.0 / r[:, None]
    lp, g_elog, g_r = _nb_lp_and_grads(
        S.float(), a, torch.log(r)[:, None], elog,
        lgamma_k_sum is not None, want_r=want_disp,
    )
    loss = _finish_loss(lp.sum(dtype=torch.float64), lgamma_k_sum)
    dnu = g_elog @ zeta
    dzeta = g_elog.T @ nu
    dcf = g_elog.sum(0)
    ddisp = g_r.sum(1) if want_disp else torch.zeros_like(r)
    ddnu = (g_elog @ Db.T).T if delta_nu is not None else None
    return loss, (dnu, dzeta, dcf, ddisp, ddnu)


def velo_fwd_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                   log_gamma, r, delta_nu=None, Db=None, lgamma_k_sum=None):
    """Plain version of ``velo_fwd``: the loss."""
    elogS, elogU, *_ = _velo_elogs(nu, zeta, zeta_dphi, cf, omega, log_beta,
                                   log_gamma, delta_nu, Db)
    a = 1.0 / r[:, None]
    log_r = torch.log(r)[:, None]
    skip = lgamma_k_sum is not None
    lp = (_nb_lp(S.float(), elogS, a, log_r, skip)
          + _nb_lp(U.float(), elogU, a, log_r, skip))
    return _finish_loss(lp.sum(dtype=torch.float64), lgamma_k_sum)


def velo_fwdgrad_plain(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta,
                       log_gamma, r, delta_nu=None, Db=None,
                       lgamma_k_sum=None, want_disp=True):
    """Plain version of ``velo_fwdgrad``: (loss, (dnu, dzeta, dzeta_dphi,
    dcf, domega, dlog_beta, dlog_gamma, ddisp, ddelta_nu)); ddisp is
    exactly zero when ``want_disp`` is False and ddelta_nu is None without
    delta_nu.  The relu gate passes gradient where x > 0 (strictly)."""
    elogS, elogU, dEs, gamma, x, xr = _velo_elogs(
        nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, delta_nu, Db
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


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/nb_phase.cu, csrc/nb_velo.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


# the C interface of each csrc/ source: count matrices, float parameters,
# gene-partial columns besides dnu and ddelta_nu, and cell-indexed gradients
# ((Nc, Nh) ones first, then (Nc,) ones)
_ABI = {
    "nb_phase": {"counts": 1, "params": 4, "gene_extra": 1, "cell_grads": 2},
    "nb_velo": {"counts": 2, "params": 8, "gene_extra": 3, "cell_grads": 4},
}


def _lib(name):
    """The loaded library of csrc/<name>.cu with its C functions typed."""
    lib = cuda_build.load(name)
    if getattr(lib, "_vct_typed", False):
        return lib
    abi = _ABI[name]
    stem = name.replace("nb_", "vct_")
    # counts..., int16 flag, params..., dnu, Db, Ng, Nc, Nh, Nb, skip_k
    common = ([_P] * abi["counts"] + [_I] + [_P] * abi["params"] + [_P, _P]
              + [_I] * 5)
    for fn, argtypes in (
        (f"{stem}_cells_per_block", []),
        (f"{stem}_max_nb", []),
        (f"{stem}_fwd", common + [_P, _P]),
        # ..., want_disp, loss_part, gene_part, cell grads..., stream
        (f"{stem}_fwdgrad",
         common + [_I, _P, _P] + [_P] * abi["cell_grads"] + [_P]),
    ):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib._vct_typed = True
    return lib


# parameter shapes over g = genes, c = cells, h = basis columns
_SHAPES = {"nu": "gh", "zeta": "ch", "zeta_dphi": "ch", "count_factor": "c",
           "omega": "c", "log_beta": "g", "log_gamma": "g",
           "dispersion": "g"}


def _check_inputs(counts, params, delta_nu, Db, lib_name):
    """Shapes always; device, dtype and contiguity for the kernels.

    counts: [(name, (Ng, Nc) tensor)], or empty for a kernel that reads no
    count matrix (Ng and Nc then come from nu and zeta); params: {name:
    tensor}, names from `_SHAPES`; lib_name: the csrc/ source whose kernels
    take them."""
    if counts:
        S = counts[0][1]
        if S.dim() != 2:
            raise ValueError(f"S must be (Ng, Nc), got {tuple(S.shape)}")
        Ng, Nc = S.shape
    else:
        S = params["nu"]
        Ng, Nc = S.shape[0], params["zeta"].shape[0]
    Nh = params["nu"].shape[-1]
    dims = {"g": Ng, "c": Nc, "h": Nh}
    want = {name: tuple(dims[d] for d in _SHAPES[name]) for name in params}
    got = dict(params)
    for name, t in counts[1:]:
        want[name] = (Ng, Nc)
        got[name] = t
    if (delta_nu is None) != (Db is None):
        raise ValueError("delta_nu and Db must be given together")
    if delta_nu is not None:
        Nb = delta_nu.shape[0]
        want.update(delta_nu=(Nb, Ng), Db=(Nb, Nc))
        got.update(delta_nu=delta_nu, Db=Db)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must have shape {want[name]}, got {tuple(t.shape)}"
            )
    if S.device.type != "cuda":
        return
    if S.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"counts must be int16 or float32, got {S.dtype}")
    for name, t in counts[1:]:
        if t.dtype != S.dtype:
            raise TypeError(f"{name} is {t.dtype}, S is {S.dtype}")
    if Nh not in SUPPORTED_NH:
        raise ValueError(
            f"the NB kernels are built for Nh in {SUPPORTED_NH}, got {Nh}"
        )
    if Ng < 1 or Nc < 1:
        raise ValueError(f"empty count matrix {(Ng, Nc)}")
    if delta_nu is not None:
        lib = _lib(lib_name)
        max_nb = getattr(lib, lib_name.replace("nb_", "vct_") + "_max_nb")()
        if delta_nu.shape[0] > max_nb:
            raise ValueError(
                f"the NB kernels take at most {max_nb} batches, got "
                f"{delta_nu.shape[0]}"
            )
    for name, t in [*counts, *got.items()]:
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, counts on {S.device}")
        if name not in ("S", "U") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _launch(name, lib_name, counts, params, delta_nu, Db, lgamma_k_sum,
            want_disp=None):
    """Check, allocate the partial buffers, launch one kernel and count it:
    the loss-only kernel, or with ``want_disp`` given the fwd+grad one.

    Returns (loss, gene partials summed over the cell tiles (Ng, NV) or
    None, [cell-indexed gradients])."""
    _check_inputs(counts, params, delta_nu, Db, lib_name)
    S = counts[0][1]
    if S.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got CPU tensors")
    lib = _lib(lib_name)
    stem = lib_name.replace("nb_", "vct_")
    Ng, Nc = S.shape
    nu = params["nu"]
    Nh = nu.shape[1]
    Nb = 0 if delta_nu is None else delta_nu.shape[0]
    tiles = -(-Nc // getattr(lib, f"{stem}_cells_per_block")())
    dev = S.device
    args = [*(_ptr(t) for _, t in counts), int(S.dtype == torch.int16),
            *(_ptr(t) for t in params.values()), _ptr(delta_nu), _ptr(Db),
            Ng, Nc, Nh, Nb, int(lgamma_k_sum is not None)]
    loss_part = torch.empty(tiles, dtype=torch.float64, device=dev)
    gene_part, cell = None, []
    if want_disp is None:
        tail = [loss_part.data_ptr()]
        fn = getattr(lib, f"{stem}_fwd")
    else:
        abi = _ABI[lib_name]
        gene_part = torch.empty((tiles, Ng, Nh + abi["gene_extra"] + Nb),
                                dtype=torch.float32, device=dev)
        half = abi["cell_grads"] // 2
        cell = [torch.empty(shape, dtype=torch.float32, device=dev)
                for shape in [(Nc, Nh)] * half + [(Nc,)] * half]
        tail = [int(bool(want_disp)), loss_part.data_ptr(),
                gene_part.data_ptr(), *(t.data_ptr() for t in cell)]
        fn = getattr(lib, f"{stem}_fwdgrad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, *tail, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    loss = _finish_loss(loss_part.sum(), lgamma_k_sum)
    # fixed-order reduction over the cell tiles (no float atomics)
    gene = None if gene_part is None else gene_part.sum(0)
    return loss, gene, cell


def _phase_params(nu, zeta, cf, r):
    return {"nu": nu, "zeta": zeta, "count_factor": cf, "dispersion": r}


def phase_fwd(S, nu, zeta, cf, r, delta_nu=None, Db=None, lgamma_k_sum=None):
    """Loss of the fused phase NB likelihood on the card (CUDA tensors)."""
    loss, _, _ = _launch("phase_fwd", "nb_phase", [("S", S)],
                         _phase_params(nu, zeta, cf, r), delta_nu, Db,
                         lgamma_k_sum)
    return loss


def phase_fwdgrad(S, nu, zeta, cf, r, delta_nu=None, Db=None,
                  lgamma_k_sum=None, want_disp=True):
    """Loss and every gradient of the fused phase NB likelihood on the card:
    (loss, (dnu, dzeta, dcf, ddisp, ddelta_nu)), as `phase_fwdgrad_plain`."""
    loss, gene, (dzeta, dcf) = _launch(
        "phase_fwdgrad", "nb_phase", [("S", S)],
        _phase_params(nu, zeta, cf, r), delta_nu, Db, lgamma_k_sum,
        want_disp=want_disp,
    )
    Nh = nu.shape[1]
    dnu = gene[:, :Nh].contiguous()
    ddisp = gene[:, Nh].contiguous()
    ddnu = gene[:, Nh + 1:].T.contiguous() if delta_nu is not None else None
    return loss, (dnu, dzeta, dcf, ddisp, ddnu)


def _velo_params(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r):
    return {"nu": nu, "zeta": zeta, "zeta_dphi": zeta_dphi,
            "count_factor": cf, "omega": omega, "log_beta": log_beta,
            "log_gamma": log_gamma, "dispersion": r}


def velo_fwd(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r,
             delta_nu=None, Db=None, lgamma_k_sum=None):
    """Loss of the fused velocity S+U NB likelihood on the card."""
    loss, _, _ = _launch(
        "velo_fwd", "nb_velo", [("S", S), ("U", U)],
        _velo_params(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r),
        delta_nu, Db, lgamma_k_sum,
    )
    return loss


def velo_fwdgrad(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma,
                 r, delta_nu=None, Db=None, lgamma_k_sum=None,
                 want_disp=True):
    """Loss and every gradient of the fused velocity S+U NB likelihood on
    the card, as `velo_fwdgrad_plain`.  The kernel's gene partials hold
    [dnu (Nh), ddisp, dlog_beta, sum_c g_x, ddelta_nu (Nb)] per gene;
    dlog_gamma is sum_c g_x times exp(log_gamma), applied after the sum."""
    loss, gene, (dzeta, dzdphi, dcf, domega) = _launch(
        "velo_fwdgrad", "nb_velo", [("S", S), ("U", U)],
        _velo_params(nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r),
        delta_nu, Db, lgamma_k_sum, want_disp=want_disp,
    )
    Nh = nu.shape[1]
    dnu = gene[:, :Nh].contiguous()
    ddisp = gene[:, Nh].contiguous()
    dlbeta = gene[:, Nh + 1].contiguous()
    dlgamma = gene[:, Nh + 2] * torch.exp(log_gamma)
    ddnu = gene[:, Nh + 3:].T.contiguous() if delta_nu is not None else None
    return loss, (dnu, dzeta, dzdphi, dcf, domega, dlbeta, dlgamma, ddisp,
                  ddnu)


# ---------------------------------------------------------------------------
# autograd bindings
# ---------------------------------------------------------------------------

class _FusedNBLogLik(torch.autograd.Function):
    """One fwd+grad pass in forward; backward scales the saved gradients.

    ``fwdgrad(*inputs, want_disp=...)`` returns (loss, grads) with one
    gradient (or None) per differentiable input; ``n_data`` leading inputs
    are data (counts) and take no gradient."""

    @staticmethod
    def forward(ctx, fwdgrad, n_data, lgamma_k_sum, disp_grad, *inputs):
        loss, grads = fwdgrad(*inputs, lgamma_k_sum=lgamma_k_sum,
                              want_disp=disp_grad)
        ctx.grads = grads
        ctx.n_data = n_data
        return loss

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[4 + ctx.n_data:]
        out = [None] * (4 + ctx.n_data)
        for d, needed in zip(ctx.grads, need):
            out.append(g * d if (d is not None and needed) else None)
        out += [None] * (len(need) - len(ctx.grads))   # Db
        return tuple(out)


def _fused(kernels, plains, n_data, inputs, lgamma_k_sum, disp_grad):
    """The loss through the (loss-only, fwd+grad) kernel pair on CUDA
    tensors or its plain pair on CPU tensors; the fwd+grad one when a
    differentiable input needs a gradient."""
    fwd, fwdgrad = kernels if inputs[0].device.type == "cuda" else plains
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs[n_data:]
    ):
        return _FusedNBLogLik.apply(fwdgrad, n_data, lgamma_k_sum,
                                    bool(disp_grad), *inputs)
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
    """
    _check_inputs([("S", S)], _phase_params(nu, zeta, count_factor,
                                            dispersion), delta_nu, Db,
                  "nb_phase")
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

    Same contract as `nb_loglik_fused`, plus U (Ng, Nc) counts of the same
    dtype as S, zeta_dphi (Nc, Nh), omega (Nc,), log_beta and log_gamma
    (Ng,).  ``lgamma_k_sum`` is ``sum(lgamma(S+1)) + sum(lgamma(U+1))``.
    Differentiable w.r.t. nu, zeta, zeta_dphi, count_factor, omega,
    log_beta, log_gamma, dispersion and delta_nu; ``disp_grad=False``
    returns a ZERO dispersion gradient.
    """
    params = _velo_params(nu, zeta, zeta_dphi, count_factor, omega,
                          log_beta, log_gamma, dispersion)
    _check_inputs([("S", S), ("U", U)], params, delta_nu, Db, "nb_velo")
    return _fused(
        (velo_fwd, velo_fwdgrad), (velo_fwd_plain, velo_fwdgrad_plain), 2,
        (S, U, *params.values(), delta_nu, Db), lgamma_k_sum, disp_grad,
    )
