"""The roofline ladder of the phase fwd+grad kernel: CUDA kernels and their
plain versions.

Each rung is `phase_fwdgrad` cut down by one piece of work: a compile-time
cut (`Cut`) of the one body in csrc/phase_kernel.cuh that `phase_fwd` and
`phase_fwdgrad` instantiate too, launched through the same library
(csrc/nb_phase.cu) in the same layout, so that the differences between rungs
say where that kernel's time goes on the card.  The rungs replace the
Pallas TPU kernels of tools/kernel_profile.py:

  rung       TPU kernel                 computes (no lgamma(k+1) term)
  stream     k_stream        :57        sum float(S) + n_rep * sum(nu)
  matmul     k_matmul        :71        sum S * (nu @ zeta^T)
  logpmf     k_logpmf        :83        sum NB_logpmf(S | nu @ zeta^T, r)
  fwdgrad    k_fwdgrad       :98        logpmf's loss + dnu; no digamma chain
  v_full     _variant_kernel :167       loss, dnu, ddisp, dzeta, dcf, cf in
                                        ElogS: phase_fwdgrad's instantiation
  v_nodig    _variant_kernel            v_full without the digamma chain; the
                                        ddisp slot holds sum_c g_elog
  v_nocell   _variant_kernel            v_full without dzeta and dcf
  vpu_only   k_vpu_only      :212       sum NB_logpmf(floor(3 |elog|) | elog,
                                        r): no count matrix read

``n_rep`` is the TPU tool's cell-tile count N_C (its stream kernel adds the
nu block once per grid cell).  Gene-indexed gradients come out per cell tile
of `nb_kernels.phase_layout().cells_per_tile` cells, as the kernel writes
them; the variants return those partials and `ladder_fwdgrad` their sum
(fixed order, no float atomics).  Nh = 5 only, as the TPU tool fixes it.

The kernel functions take CUDA tensors and raise on CPU tensors; the
``*_plain`` functions are their plain torch versions (the CPU path and the
kernels' reference on the card), on `nb_kernels._nb_lp` /
`_nb_lp_and_grads`.  `velocycle_tpu_torch.tools.kernel_profile` drives the
ladder at full width.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import nb_kernels as K

__all__ = [
    "LAUNCHES", "MODES", "NH", "READS", "RUNGS", "LadderOut",
    "ladder_fwdgrad", "ladder_fwdgrad_plain", "ladder_logpmf",
    "ladder_logpmf_plain", "ladder_matmul", "ladder_matmul_plain",
    "ladder_run", "ladder_stream", "ladder_stream_plain", "ladder_variant",
    "ladder_variant_plain", "ladder_vpu_only", "ladder_vpu_only_plain",
    "reset_launch_counts", "run_rung",
]

RUNGS = ("stream", "matmul", "logpmf", "fwdgrad", "v_full", "v_nodig",
         "v_nocell", "vpu_only")
# each rung's mode of vct_phase_run (nb_kernels.PHASE_MODES) and the
# want_disp it is built with; v_full is phase_fwdgrad's own instantiation
MODES = {"stream": ("stream", False), "matmul": ("matmul", False),
         "logpmf": ("logpmf", False), "fwdgrad": ("grad_nu", False),
         "v_full": ("fwdgrad", True), "v_nodig": ("v_nodig", False),
         "v_nocell": ("v_nocell", True), "vpu_only": ("vpu_only", False)}
NH = 5
# kernel launches on the card, by rung; chip_smoke.py resets these just
# before it drives the ladder and reads them just after
LAUNCHES = {r: 0 for r in RUNGS}

# the parameters each rung reads besides S
READS = {
    "stream": ("nu",), "matmul": ("nu", "zeta"),
    "logpmf": ("nu", "zeta", "dispersion"),
    "fwdgrad": ("nu", "zeta", "dispersion"),
    "v_full": ("nu", "zeta", "count_factor", "dispersion"),
    "v_nodig": ("nu", "zeta", "count_factor", "dispersion"),
    "v_nocell": ("nu", "zeta", "count_factor", "dispersion"),
    "vpu_only": ("nu", "zeta", "dispersion"),
}
_VARIANTS = {(True, True): "v_full", (False, True): "v_nodig",
             (True, False): "v_nocell"}


class LadderOut(NamedTuple):
    """What one rung's kernel writes: loss partials (one per CTA) float64,
    gene partials (n_tiles, Ng, Nh) for fwdgrad and (n_tiles, Ng, Nh + 1)
    for the variants (last column ddisp, or sum_c g_elog for v_nodig),
    dzeta (Nc, Nh) and dcf (Nc,) for v_full and v_nodig; None where the
    rung writes nothing."""
    loss_part: torch.Tensor
    gene_part: Optional[torch.Tensor]
    dzeta: Optional[torch.Tensor]
    dcf: Optional[torch.Tensor]


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/phase_kernel.cuh through csrc/nb_phase.cu)
# ---------------------------------------------------------------------------

def _check(rung, S, params):
    """What the kernels take: Nh = 5, int16/float32 counts, float32
    parameters, CUDA tensors; then `nb_kernels._check_inputs` (shapes, one
    device, contiguity)."""
    missing = [n for n in READS[rung] if params.get(n) is None]
    if missing:
        raise ValueError(f"ladder rung {rung} needs {missing}")
    if (S is None) != (rung == "vpu_only"):
        raise ValueError(f"ladder rung {rung} "
                         + ("reads no counts" if S is not None else "needs S"))
    nu = params["nu"]
    if nu.dim() != 2 or nu.shape[1] != NH:
        raise ValueError(f"the ladder kernels are built for Nh = {NH}, got "
                         f"nu of shape {tuple(nu.shape)}")
    if S is not None and S.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"counts must be int16 or float32, got {S.dtype}")
    for name, t in params.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    ref = nu if S is None else S
    if ref.device.type != "cuda":
        raise ValueError(f"ladder_{rung} launches a CUDA kernel; got CPU "
                         f"tensors")
    K._check_inputs([] if S is None else [("S", S)], params, None, None)


def ladder_run(rung, S, nu, zeta=None, cf=None, r=None, n_rep=0):
    """Launch one rung on CUDA tensors and count it; returns its raw
    `LadderOut`.  Parameters the rung does not read may be given (they are
    checked) or None."""
    if rung not in LAUNCHES:
        raise ValueError(f"unknown ladder rung {rung!r}; rungs: {RUNGS}")
    given = {"nu": nu, "zeta": zeta, "count_factor": cf, "dispersion": r}
    params = {n: t for n, t in given.items() if t is not None}
    _check(rung, S, params)
    mode, want_disp = MODES[rung]
    out = K._phase_launch(mode, S, nu, zeta, cf, r, skip_k=True,
                          want_disp=want_disp, n_rep=n_rep)
    LAUNCHES[rung] += 1
    # one parameter set: drop the chain axis of one
    return LadderOut(*(None if t is None else t[0] for t in out))


def _loss(out):
    return out.loss_part.sum().float()


def ladder_stream(S, nu, n_rep):
    """sum float(S) + n_rep * sum(nu) on the card."""
    return _loss(ladder_run("stream", S, nu, n_rep=n_rep))


def ladder_matmul(S, nu, zeta):
    """sum S * (nu @ zeta^T) on the card."""
    return _loss(ladder_run("matmul", S, nu, zeta))


def ladder_logpmf(S, nu, zeta, r):
    """sum NB_logpmf(S | nu @ zeta^T, r) without lgamma(k+1), on the card."""
    return _loss(ladder_run("logpmf", S, nu, zeta, r=r))


def ladder_fwdgrad(S, nu, zeta, r):
    """(loss as `ladder_logpmf` in the fwd+grad form, dnu (Ng, Nh)) on the
    card, dnu summed over the cell tiles in a fixed order."""
    out = ladder_run("fwdgrad", S, nu, zeta, r=r)
    return _loss(out), out.gene_part.sum(0)


def _variant(want_dig, cell_parts):
    rung = _VARIANTS.get((bool(want_dig), bool(cell_parts)))
    if rung is None:
        raise ValueError("the ladder has no variant without both the "
                         "digamma chain and the cell gradients")
    return rung


def ladder_variant(S, nu, zeta, cf, r, want_dig=True, cell_parts=True):
    """One of the TPU tool's three variant settings on the card: (loss,
    dnu partials (n_tiles, Ng, Nh), ddisp partials (n_tiles, Ng), dzeta
    (Nc, Nh) or None, dcf (Nc,) or None).  Without ``want_dig`` the ddisp
    partials hold sum_c g_elog."""
    out = ladder_run(_variant(want_dig, cell_parts), S, nu, zeta, cf, r)
    g = out.gene_part
    return _loss(out), g[..., :NH], g[..., NH], out.dzeta, out.dcf


def ladder_vpu_only(nu, zeta, r):
    """sum NB_logpmf(floor(3 |elog|) | elog, r), elog = nu @ zeta^T, on the
    card: no count matrix."""
    return _loss(ladder_run("vpu_only", None, nu, zeta, r=r))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _per_tile(x, Nc):
    """(Ng, Nc) -> (n_tiles, Ng): sums over each kernel cell tile."""
    B = K.phase_layout().cells_per_tile
    return torch.stack([x[:, s:s + B].sum(1) for s in range(0, Nc, B)])


def _per_tile_mm(g, zeta):
    """(n_tiles, Ng, Nh): g @ zeta over each kernel cell tile."""
    B = K.phase_layout().cells_per_tile
    return torch.stack([g[:, s:s + B] @ zeta[s:s + B]
                        for s in range(0, zeta.shape[0], B)])


def _a_log_r(r):
    return 1.0 / r[:, None], torch.log(r)[:, None]


def ladder_stream_plain(S, nu, n_rep):
    return (S.sum(dtype=torch.float64)
            + n_rep * nu.sum(dtype=torch.float64)).float()


def ladder_matmul_plain(S, nu, zeta):
    return (S.float() * (nu @ zeta.T)).sum(dtype=torch.float64).float()


def ladder_logpmf_plain(S, nu, zeta, r):
    a, log_r = _a_log_r(r)
    lp = K._nb_lp(S.float(), nu @ zeta.T, a, log_r, skip_lgamma_k=True)
    return lp.sum(dtype=torch.float64).float()


def ladder_fwdgrad_plain(S, nu, zeta, r):
    a, log_r = _a_log_r(r)
    lp, g, _ = K._nb_lp_and_grads(S.float(), a, log_r, nu @ zeta.T, True,
                                  want_r=False)
    return lp.sum(dtype=torch.float64).float(), g @ zeta


def ladder_variant_plain(S, nu, zeta, cf, r, want_dig=True, cell_parts=True):
    _variant(want_dig, cell_parts)
    a, log_r = _a_log_r(r)
    elog = nu @ zeta.T + cf[None, :]
    lp, g, g_r = K._nb_lp_and_grads(S.float(), a, log_r, elog, True,
                                    want_r=want_dig)
    Nc = S.shape[1]
    loss = lp.sum(dtype=torch.float64).float()
    ddisp = _per_tile(g_r if want_dig else g, Nc)
    dzeta, dcf = (g.T @ nu, g.sum(0)) if cell_parts else (None, None)
    return loss, _per_tile_mm(g, zeta), ddisp, dzeta, dcf


def ladder_vpu_only_plain(nu, zeta, r):
    a, log_r = _a_log_r(r)
    elog = nu @ zeta.T
    k = torch.floor(torch.abs(elog) * 3.0)
    lp = K._nb_lp(k, elog, a, log_r, skip_lgamma_k=True)
    return lp.sum(dtype=torch.float64).float()


# ---------------------------------------------------------------------------
# every rung behind one signature
# ---------------------------------------------------------------------------

# rung -> (kernel function, its plain twin, their arguments taken from
# (S, nu, zeta, cf, r, n_rep)): each rung is given only the inputs it reads
_BY_RUNG = {
    "stream": (ladder_stream, ladder_stream_plain,
               lambda S, nu, zeta, cf, r, n_rep: (S, nu, n_rep)),
    "matmul": (ladder_matmul, ladder_matmul_plain,
               lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta)),
    "logpmf": (ladder_logpmf, ladder_logpmf_plain,
               lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta, r)),
    "fwdgrad": (ladder_fwdgrad, ladder_fwdgrad_plain,
                lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta, r)),
    "v_full": (ladder_variant, ladder_variant_plain,
               lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta, cf, r, True, True)),
    "v_nodig": (ladder_variant, ladder_variant_plain,
                lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta, cf, r, False, True)),
    "v_nocell": (ladder_variant, ladder_variant_plain,
                 lambda S, nu, zeta, cf, r, n_rep: (S, nu, zeta, cf, r, True, False)),
    "vpu_only": (ladder_vpu_only, ladder_vpu_only_plain,
                 lambda S, nu, zeta, cf, r, n_rep: (nu, zeta, r)),
}


def run_rung(rung, S, nu, zeta, cf, r, n_rep=0, plain=False):
    """One rung by name, through its kernel or with ``plain`` its plain
    version: (loss, gradients), the gradients () for the loss-only rungs,
    (dnu,) for fwdgrad and (dnu partials, ddisp partials, dzeta, dcf) for
    the variants."""
    if rung not in _BY_RUNG:
        raise ValueError(f"unknown ladder rung {rung!r}; rungs: {RUNGS}")
    kern, twin, pick = _BY_RUNG[rung]
    out = (twin if plain else kern)(*pick(S, nu, zeta, cf, r, n_rep))
    if isinstance(out, tuple):
        return out[0], out[1:]
    return out, ()
