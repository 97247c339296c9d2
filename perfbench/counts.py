"""The yardstick's operation and byte counts of the NB kernels.

A frozen copy of the counts the repository's chip runs use (chip_smoke.py
``OPS``, ``OPS_DISP``, ``OPS_VELO``, ``OPS_PER_COLUMN``, ``OPS_PER_BATCH``,
``_wide_ops``, ``_ratio_ops``, ``_disp_ops``; tools/kernel_profile.py
``DISP_OPS``, ``disp_ops``), so that a later change to the program cannot
move the yardstick.  FP32 operations per count-matrix element, counted from
the kernels' source with Nh = 5 and no delta_nu (a transcendental or a
division counts one); what each entry covers is written beside it in
chip_smoke.py.  The counts are those of the function the likelihood and its
gradients need, whichever code computes it: the fused kernel and the plain
element are held to the same number.
"""
from __future__ import annotations

import math

import torch

NH = 5
OPS = {"common": 18, "fwdgrad": 38, "fwd": 7,
       "lg_stir": 22, "lg_small": 5, "lg_sel": 2}
OPS_DISP = 1
OPS_VELO = {"common": 43, "fwdgrad": 84, "disp": 2, "fwd": 14}
OPS_PER_COLUMN = {"common": 2, "fwdgrad": 4, "velo_common": 4,
                  "velo_fwdgrad": 7}
OPS_PER_BATCH = {"common": 2, "fwdgrad": 2}
DISP_OPS = {"ratio": 5, "dg_stir": 15, "dg_small": 3, "dg_sel": 1,
            "excess": 5, "q_series": 16, "q_direct": 2, "q_test": 3,
            "kad_stir": 29, "t_series": 16, "t_direct": 1, "t_test": 2,
            "kad_sel": 1}
EXCESS_FROM = 64.0      # a = 1/r from which the excess form runs
SERIES_BELOW = 0.125    # the series branches' threshold

# published peaks by device name (NVIDIA's data sheet, dense, no
# sparsity): FP32 outside the tensor cores, HBM bytes/s
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32": 67e12, "bytes": 3.35e12}}


def wide_ops(kind, mode, Nh, Nb, N, lg, dg, wd):
    """FP32 operations of one NB call over N elements at Nh basis columns
    and Nb delta_nu batches: OPS / OPS_VELO at Nh = 5, OPS_PER_COLUMN for
    each further column, OPS_PER_BATCH for each batch, the lgamma ratio's
    ``lg`` and, with the dispersion gradient (``wd``), ``dg``."""
    extra = Nh - NH
    grad = mode == "fwdgrad"
    batches = Nb * (OPS_PER_BATCH["common"]
                    + (OPS_PER_BATCH["fwdgrad"] if grad else 0))
    if kind == "phase":
        per = OPS["common"] + extra * OPS_PER_COLUMN["common"] + (
            OPS["fwdgrad"] - (0 if wd else OPS_DISP)
            + extra * OPS_PER_COLUMN["fwdgrad"] if grad else OPS["fwd"])
    else:
        per = OPS_VELO["common"] + extra * OPS_PER_COLUMN["velo_common"] + (
            OPS_VELO["fwdgrad"] + (OPS_VELO["disp"] if wd else 0)
            + extra * OPS_PER_COLUMN["velo_fwdgrad"] if grad
            else OPS_VELO["fwd"])
    return (per + batches) * N + lg + (dg if grad and wd else 0)


def ratio_ops(N, n_ge2):
    """Operations of the lgamma ratio over N counts, n_ge2 of them >= 2."""
    return (OPS["lg_stir"] * n_ge2 + OPS["lg_small"] * (N - n_ge2)
            + OPS["lg_sel"] * N)


def disp_ops(k, elog, r):
    """Operations of the dispersion gradient over counts ``k`` (Ng, Nc) at
    dispersions ``r`` (Ng,): each element counted on the branch its gene
    and its inputs take.  ``elog()`` gives the log-means (broadcast to k),
    called only where a gene takes the excess form."""
    D = DISP_OPS
    a = 1.0 / r[..., None]
    shape = torch.broadcast_shapes(k.shape, a.shape)
    ex = (a >= EXCESS_FROM).expand(shape)
    ge2 = (k >= 2).expand(shape)
    n = math.prod(shape)
    n_ex = int(ex.sum())
    n_ra = n - n_ex
    ra_ge2 = int((ge2 & ~ex).sum())
    ops = ((D["ratio"] + D["dg_sel"]) * n_ra + D["dg_stir"] * ra_ge2
           + D["dg_small"] * (n_ra - ra_ge2))
    if n_ex:
        log_b = -torch.log(r)[..., None] - elog()
        e = torch.exp(-log_b.abs())
        q_ser = (log_b >= 0) & (e / (1.0 + e) < SERIES_BELOW)
        t_ser = torch.clamp(k.float() - 2.0, min=0.0) / (a + 2.0) < SERIES_BELOW
        n_q = int((ex & q_ser).sum())
        ex_ge2 = ex & ge2
        n_k = int(ex_ge2.sum())
        n_t = int((ex_ge2 & t_ser).sum())
        ops += ((D["excess"] + D["q_test"] + D["kad_sel"]) * n_ex
                + D["q_series"] * n_q + D["q_direct"] * (n_ex - n_q)
                + (D["kad_stir"] + D["t_test"]) * n_k
                + D["t_series"] * n_t + D["t_direct"] * (n_k - n_t))
    return ops


def phase_fwdgrad(S, r, Nh, Nb, elog=None, disp_grad=True):
    """(FP32 operations, bytes) of one phase fwd+grad NB call on counts
    ``S`` (Ng, Nc) at dispersions ``r``: the operations on the branches
    these counts and dispersions take (``elog()`` gives the log-means
    where a gene takes the excess form), the bytes each input read once
    (int16 or float32 counts, float32 operands, the section design) and
    each gradient written once."""
    Ng, Nc = S.shape
    N = Ng * Nc
    lg = ratio_ops(N, int((S >= 2).sum()))
    dg = disp_ops(S, elog, r) if disp_grad else 0
    ops = wide_ops("phase", "fwdgrad", Nh, Nb, N, lg, dg, disp_grad)
    params = Ng * Nh + Nc * Nh + Nc + Ng + Nb * Ng
    nbytes = N * S.element_size() + 4 * (2 * params + Nb * Nc) + 4
    return ops, nbytes
