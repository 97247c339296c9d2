"""Preprocessing: AnnData + prior containers -> device-ready metaparameters.

Port of `velocycle_tpu/preprocessing.py` (Fourier and spline bases, both
phase parametrizations, both gene-selection models).  All host work
(gene filtering, densification through the native ingest, design matrices,
size factors, the int16 count compaction and the f64 ``sum(lgamma(K+1))``
constant) is numpy and produces the same arrays as the JAX package; the
result is one `PhaseData` or `VelocityData` whose tensors sit on
``device`` (the card unless ``device="cpu"``).

Each front door is the span ``preprocess`` (`profiling.span`), its passes
the spans ``preprocess.dense`` (dense float32 counts), ``.logs`` (the log
layers), ``.compact`` and ``.lgamma`` (the fused path's int16 counts and
``sum(lgamma(K+1))``) and ``.upload`` (the transposed copies and the
copies to ``device``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .containers import AngularSpeed, Cycle, Phases, reorder
from .device import resolve_device
from .models.metapars import Metapars, PhaseData, VelocityData
from .profiling import span

__all__ = [
    "filter_shared_genes",
    "make_design_matrix",
    "normalize_total",
    "preprocess_for_phase_estimation",
    "preprocess_for_velocity_estimation",
    "invert_direction",
    "shift_zero",
]

# the joint (Cycle, Phases) gauge fixes, reachable here as in the JAX
# package (the reference star-imports them into its preprocessing module)
from .alignment import invert_direction, shift_zero  # noqa: E402,F401


def _dense(x):
    if hasattr(x, "todense"):
        from . import native

        return native.csr_to_dense(x)
    return np.asarray(x)


def filter_shared_genes(cycle, data, filter_type="intersection"):
    """Subset a Cycle and an AnnData to a common, sorted gene set.

    "intersection" keeps genes present in both; "union" keeps all AnnData
    genes, extending the Cycle with flat priors for genes it lacks (and
    requires every Cycle gene to exist in the AnnData).
    """
    cycle_genes = set(cycle.genes)
    data_genes = set(data.var.index)
    if filter_type == "intersection":
        keep = np.sort(np.array(list(cycle_genes & data_genes)))
        new_data = data[:, list(keep)].copy()
        new_cycle = Cycle.from_array(
            means_array=cycle.means[keep].values,
            stds_array=cycle.stds[keep].values,
            gene_names=list(keep),
        )
    elif filter_type == "union":
        missing = cycle_genes - data_genes
        if missing:
            raise ValueError(
                f"Cycle genes not present in the AnnData: {sorted(missing)[:5]}"
            )
        keep = np.sort(np.array(list(cycle_genes | data_genes)))
        new_data = data[:, list(keep)].copy()
        new_cycle = cycle.copy()
        new_cycle.extend(names=sorted(data_genes - cycle_genes))
        new_cycle = reorder(new_cycle, list(keep))
    else:
        raise ValueError(f"invalid filter_type {filter_type!r}")
    return new_cycle, new_data


def make_design_matrix(adata, ids="batch"):
    """One-hot design matrix (Nc, Nk) from a categorical obs column.
    Column order = order of first appearance."""
    if ids not in adata.obs.columns:
        raise ValueError(f"{ids!r} is not a column of adata.obs")
    values = np.asarray(adata.obs[ids])
    _, first_idx = np.unique(values, return_index=True)
    categories = values[np.sort(first_idx)]
    return (values[:, None] == categories[None, :]).astype(np.int64)


def _basis_config(basis_kind, cycle_obj, phase_obj, n_harmonics,
                  spline_degree, spline_domain):
    """Static basis fields (and the spline path's phi prior) of
    `PhaseData`/`VelocityData`.

    Validates the Cycle prior's coefficient count against the basis:
    ``2*n_harmonics + 1`` (fourier) or ``spline_n_basis + 1`` (spline, with
    ``spline_n_basis`` read from the prior).  The spline domain defaults to
    the range of the prior's phases.
    """
    n_coeffs = cycle_obj.means_array.shape[1]
    if basis_kind == "fourier":
        if n_coeffs != 2 * n_harmonics + 1:
            raise ValueError(
                f"Cycle prior has {n_coeffs} coefficient rows but "
                f"n_harmonics={n_harmonics} needs {2 * n_harmonics + 1}"
            )
        return {"basis_kind": "fourier"}
    if basis_kind != "spline":
        raise ValueError(
            f"{basis_kind=} is not valid; use 'fourier' or 'spline'"
        )
    spline_n_basis = n_coeffs - 1
    if spline_n_basis <= spline_degree:
        raise ValueError(
            f"spline basis needs > degree+2 = {spline_degree + 2} Cycle "
            f"coefficient rows (constant + n_basis), got {n_coeffs}"
        )
    phis = np.asarray(phase_obj.phis, np.float32).reshape(-1)
    if spline_domain is None:
        spline_domain = (float(phis.min()), float(phis.max()))
    lo, hi = float(spline_domain[0]), float(spline_domain[1])
    if not hi > lo:
        raise ValueError(f"empty spline domain {spline_domain}")
    return {
        "basis_kind": "spline",
        "spline_n_basis": spline_n_basis,
        "spline_degree": int(spline_degree),
        "spline_domain": (lo, hi),
        "phi_prior": phis,
    }


def normalize_total(adata):
    """Add size-normalized layers ``S_sz``/``U_sz`` and per-cell totals
    ``n_scounts``/``n_ucounts``.  In place."""
    S = _dense(adata.layers["spliced"])
    U = _dense(adata.layers["unspliced"])
    adata.obs["n_scounts"] = S.sum(1)
    adata.obs["n_ucounts"] = U.sum(1)
    adata.layers["S_sz"] = S * (
        adata.obs["n_scounts"].mean() / adata.obs["n_scounts"].values
    )[:, None]
    adata.layers["U_sz"] = U * (
        adata.obs["n_ucounts"].mean() / adata.obs["n_ucounts"].values
    )[:, None]


def _extract_counts(adata, normalize):
    """(S, U) as dense (Nc, Ng) float32 arrays."""
    if normalize:
        if "S_sz" not in adata.layers or "U_sz" not in adata.layers:
            normalize_total(adata)
        return (
            np.asarray(adata.layers["S_sz"], dtype=np.float32),
            np.asarray(adata.layers["U_sz"], dtype=np.float32),
        )
    return (
        _dense(adata.layers["spliced"]).astype(np.float32),
        _dense(adata.layers["unspliced"]).astype(np.float32),
    )


def _compact_counts(K):
    """Integer-valued counts as int16 for the fused kernels (half the count
    stream); float32 when values are fractional or exceed int16 range."""
    if (
        np.all(K == np.floor(K))
        and K.min() >= 0
        and K.max() < np.iinfo(np.int16).max
    ):
        return K.astype(np.int16)
    return K


def _lgamma_k_sum(*counts):
    """Dataset constant ``sum(lgamma(K+1))``, in float64 on the host."""
    from scipy.special import gammaln

    total = 0.0
    for K in counts:
        total += float(gammaln(np.asarray(K, np.float64) + 1.0).sum())
    return np.float32(total)


def _fused_counts(*counts):
    """The fused path's passes, each a span: ([each count matrix transposed
    to (Ng, Nc), int16 where `_compact_counts` takes it],
    ``sum(lgamma(K+1))``)."""
    with span("preprocess.compact"):
        compact = [_compact_counts(K.T) for K in counts]
    with span("preprocess.lgamma"):
        return compact, _lgamma_k_sum(*counts)


def _to_device(value, device):
    if value is None:
        return None
    return torch.as_tensor(np.require(value, requirements="CW"), device=device)


def _front_door(fn):
    """``fn`` in the span ``preprocess``."""
    @functools.wraps(fn)
    def in_span(*args, **kwargs):
        with span("preprocess"):
            return fn(*args, **kwargs)
    return in_span


@_front_door
def preprocess_for_phase_estimation(
    adata,
    cycle_obj: Cycle,
    phase_obj: Phases,
    design_mtx=None,
    n_harmonics: int = 2,
    gene_selection_model: str = "all",
    normalize: bool = False,
    noisemodel: str = "NegativeBinomial",
    with_delta_nu: bool = True,
    condition_on=None,
    mu_dnu: float = 0.0,
    sd_dnu=0.5,
    gamma_alpha: float = 1.0,
    gamma_beta: float = 2.0,
    beta0: float = 0.10,
    beta1: float = 0.90,
    basis_kind: str = "fourier",
    phi_parametrization: str = "xy",
    spline_degree: int = 3,
    spline_domain=None,
    use_fused_nb: bool = False,
    device=None,
):
    """Assemble `Metapars` for manifold learning; ``.data`` is a
    `PhaseData` on ``device``.

    ``gene_selection_model`` picks the model and guide: "all"
    (`phase_model`/`phase_guide`) or "lba" (`phase_model_lba`/
    `phase_guide_lba`, a per-gene periodic-or-flat mixture).
    ``basis_kind="spline"`` puts the model on an interval with a B-spline
    basis: the Cycle prior then carries ``n_basis + 1`` coefficient rows
    (`Cycle.spline_prior`), phi ~ Uniform(``spline_domain``), whose default
    is the range of ``phase_obj``'s angles, and the guide starts at those
    angles.  ``phi_parametrization="wrapped"`` puts phi on S^1 with a
    VonMises prior at the prior's angles; any other value acts as "xy".
    """
    from .models.phase import (
        phase_guide, phase_guide_lba, phase_model, phase_model_lba,
    )

    dev = resolve_device(device)
    with span("preprocess.dense"):
        S, U = _extract_counts(adata, normalize)
        s_umi = _dense(adata.layers["spliced"]).sum(1).astype(np.float32)
        count_factor = np.log(s_umi / s_umi.mean())

    with span("preprocess.logs"):
        adata.layers["logS"] = np.log(S + 1 + 1e-16)
        adata.layers["logU"] = np.log(U + 1 + 1e-16)

    if design_mtx is None:
        design_mtx = np.ones((adata.shape[0], 1), dtype=np.int64)
    design_mtx = np.asarray(design_mtx)

    if gene_selection_model == "all":
        model_fn, guide_fn = phase_model, phase_guide
    elif gene_selection_model == "lba":
        model_fn, guide_fn = phase_model_lba, phase_guide_lba
    else:
        raise ValueError(
            f"{gene_selection_model=} is not a valid model; use 'all'|'lba'"
        )

    Ng, Nc, Nb = len(cycle_obj), len(phase_obj), design_mtx.shape[-1]
    sd_dnu_arr = np.broadcast_to(
        np.asarray(sd_dnu, np.float32), (Nb,)
    ).reshape(Nb, 1)
    basis_cfg = _basis_config(basis_kind, cycle_obj, phase_obj, n_harmonics,
                              spline_degree, spline_domain)
    phi_prior = basis_cfg.pop("phi_prior", None)
    S_k, lgamma_k_sum = S.T, None
    if use_fused_nb:
        (S_k,), lgamma_k_sum = _fused_counts(S)
    arrays = dict(
        S=S_k,
        logS=np.asarray(adata.layers["logS"], np.float32).T,
        count_factor=count_factor,
        mu_nu=cycle_obj.means_array,
        sd_nu=cycle_obj.stds_array,
        phixy_prior=phase_obj.phi_xy_array,
        Db=design_mtx.T.astype(np.float32),
        mu_dnu=np.float32(mu_dnu),
        sd_dnu=sd_dnu_arr,
        gamma_alpha=np.float32(gamma_alpha),
        gamma_beta=np.float32(gamma_beta),
        sigma_gc=np.float32(0.5),
        beta0=np.float32(beta0),
        beta1=np.float32(beta1),
        lgamma_k_sum=lgamma_k_sum,
        phi_prior=phi_prior,
    )
    with span("preprocess.upload"):
        arrays = {k: _to_device(v, dev) for k, v in arrays.items()}
    data = PhaseData(
        **arrays,
        Ng=Ng,
        Nc=Nc,
        Nb=Nb,
        num_harmonics_S=n_harmonics,
        noisemodel=noisemodel,
        with_delta_nu=with_delta_nu,
        gene_selection_model=gene_selection_model,
        phi_parametrization=phi_parametrization,
        use_fused_nb=use_fused_nb,
        **basis_cfg,
    )
    return Metapars(
        data=data,
        model_fn=model_fn,
        guide_fn=guide_fn,
        cycle_prior=cycle_obj,
        phase_prior=phase_obj,
        condition=list((condition_on or {}).keys()),
        extras={"condition_on": dict(condition_on or {})},
    )


@_front_door
def preprocess_for_velocity_estimation(
    adata,
    cycle_obj: Cycle,
    phase_obj: Phases,
    speed_obj: AngularSpeed,
    condition_design_mtx=None,
    batch_design_mtx=None,
    n_harmonics: int = 2,
    omega_n_harmonics=None,
    normalize: bool = False,
    behavior: str = "intersection",
    noisemodel: str = "NegativeBinomial",
    with_delta_nu: bool = True,
    condition_on=None,
    count_factor=0.0,
    mu_gamma: float = 0.0,
    sd_gamma: float = 0.5,
    mu_beta: float = 2.0,
    sd_beta: float = 3.0,
    mu_dnu: float = 0.0,
    sd_dnu=0.1,
    gamma_alpha: float = 1.0,
    gamma_beta: float = 2.0,
    model_type: str = "lrmn",
    rho_mean: float = 4.0,
    rho_std: float = 1.0,
    rho_scale: float = 1.0,
    rho_rank: int = 5,
    basis_kind: str = "fourier",
    phi_parametrization: str = "xy",
    spline_degree: int = 3,
    spline_domain=None,
    use_fused_nb: bool = False,
    device=None,
):
    """Assemble `Metapars` for velocity learning; ``.data`` is a
    `VelocityData` on ``device``.  Genes are filtered against the Cycle
    (`filter_shared_genes` with ``behavior``); ``model_type`` selects the
    LRMN guide ("lrmn") or the mean-field guide ("fourier", "meanfield",
    "all").  ``basis_kind``, ``phi_parametrization``, ``spline_degree`` and
    ``spline_domain`` as in `preprocess_for_phase_estimation`; on the
    spline basis the AngularSpeed prior's coefficient count is the speed
    basis size (1: a constant speed; else constant + an (Nhw-1)-function
    spline)."""
    from .models.velocity import (
        velocity_guide, velocity_guide_lrmn, velocity_model,
    )

    dev = resolve_device(device)
    if omega_n_harmonics is None:
        omega_n_harmonics = speed_obj.harmonics
    if basis_kind == "fourier" and speed_obj.harmonics != omega_n_harmonics:
        raise ValueError(
            f"speed prior has {speed_obj.harmonics} harmonics but "
            f"omega_n_harmonics={omega_n_harmonics}"
        )
    if model_type == "lrmn":
        guide_fn = velocity_guide_lrmn
    elif model_type in ("fourier", "meanfield", "all"):
        guide_fn = velocity_guide
    else:
        raise ValueError(
            f"{model_type=} is not valid; use 'lrmn' or 'fourier'"
        )
    basis_cfg = _basis_config(basis_kind, cycle_obj, phase_obj, n_harmonics,
                              spline_degree, spline_domain)
    phi_prior = basis_cfg.pop("phi_prior", None)
    if basis_kind == "fourier":
        Nhw = 2 * omega_n_harmonics + 1
    else:
        Nhw = speed_obj.means_array.shape[1]
        if Nhw != 1 and Nhw - 1 <= spline_degree:
            raise ValueError(
                f"speed spline needs 1 or > degree+2 coefficient rows, "
                f"got {Nhw} (degree {spline_degree})"
            )
    cycle_obj, adata = filter_shared_genes(
        cycle_obj, adata, filter_type=behavior
    )
    with span("preprocess.dense"):
        S, U = _extract_counts(adata, normalize)
    with span("preprocess.logs"):
        adata.layers["logS"] = np.log(S + 1 + 1e-16)
        adata.layers["logU"] = np.log(U + 1 + 1e-16)

    Nc = len(phase_obj)
    if condition_design_mtx is None:
        condition_design_mtx = np.ones((Nc, 1), dtype=np.int64)
    if batch_design_mtx is None:
        batch_design_mtx = np.ones((Nc, 1), dtype=np.int64)
    condition_design_mtx = np.asarray(condition_design_mtx)
    batch_design_mtx = np.asarray(batch_design_mtx)

    Ng = len(cycle_obj)
    Nb = batch_design_mtx.shape[-1]
    Nx = condition_design_mtx.shape[-1]
    sd_dnu_arr = np.broadcast_to(
        np.asarray(sd_dnu, np.float32), (Nb,)
    ).reshape(Nb, 1)
    S_k, U_k, lgamma_k_sum = S.T, U.T, None
    if use_fused_nb:
        (S_k, U_k), lgamma_k_sum = _fused_counts(S, U)
    arrays = dict(
        S=S_k,
        U=U_k,
        logS=np.asarray(adata.layers["logS"], np.float32).T,
        logU=np.asarray(adata.layers["logU"], np.float32).T,
        count_factor=np.broadcast_to(
            np.asarray(count_factor, np.float32), (Nc,)
        ).copy(),
        mu_nu=cycle_obj.means_array,
        sd_nu=cycle_obj.stds_array,
        phixy_prior=phase_obj.phi_xy_array,
        D=condition_design_mtx.T.astype(np.float32),
        Db=batch_design_mtx.T.astype(np.float32),
        mu_dnu=np.float32(mu_dnu),
        sd_dnu=sd_dnu_arr,
        mu_gamma=np.full((Ng,), mu_gamma, np.float32),
        sd_gamma=np.full((Ng,), sd_gamma, np.float32),
        mu_beta=np.full((Ng,), mu_beta, np.float32),
        sd_beta=np.full((Ng,), sd_beta, np.float32),
        mu_nuomega=speed_obj.means_array,   # (Nx, Nhw)
        sd_nuomega=speed_obj.stds_array,
        gamma_alpha=np.float32(gamma_alpha),
        gamma_beta=np.float32(gamma_beta),
        sigma_s_gc=np.float32(0.1),
        sigma_u_gc=np.float32(0.1),
        rho_mean=np.float32(rho_mean),
        rho_std=np.float32(rho_std),
        rho_scale=np.float32(rho_scale),
        lgamma_k_sum=lgamma_k_sum,
        phi_prior=phi_prior,
    )
    with span("preprocess.upload"):
        arrays = {k: _to_device(v, dev) for k, v in arrays.items()}
    data = VelocityData(
        **arrays,
        Ng=Ng,
        Nc=Nc,
        Nb=Nb,
        Nx=Nx,
        Nhw=Nhw,
        num_harmonics_S=n_harmonics,
        omega_harmonics=omega_n_harmonics,
        noisemodel=noisemodel,
        with_delta_nu=with_delta_nu,
        model_type=model_type,
        rho_rank=rho_rank,
        phi_parametrization=phi_parametrization,
        use_fused_nb=use_fused_nb,
        **basis_cfg,
    )
    return Metapars(
        data=data,
        model_fn=velocity_model,
        guide_fn=guide_fn,
        cycle_prior=cycle_obj,
        phase_prior=phase_obj,
        speed_prior=speed_obj,
        condition=list((condition_on or {}).keys()),
        extras={"condition_on": dict(condition_on or {}), "adata": adata},
    )
