"""Carry JAX-package state into the port.

  * `params_from_jax` takes the JAX SVI's unconstrained params (any of
    either stage's guides, e.g. ``nu_locs``, ``phixy_locs``, or the LRMN
    ``loc``, ``cov_factor``, ``cov_diag``, ``rho_real_loc``, as numpy
    arrays) and returns leaf tensors ready for the port's SVI.
  * `phase_data_from_jax` / `velocity_data_from_jax` take a JAX
    `PhaseData` / `VelocityData` (its arrays as numpy, or anything with the
    same attributes) and return the port's container with the same arrays
    and config; `velo2d_data_from_jax` does the same for the 2-D models'
    `Velo2DData`.
  * `svi_state_from_jax` takes a JAX `SVIState` of a ``clipped_adam`` (or
    ``adam``) fit and returns the port's `SVIState`, so that a JAX
    checkpoint resumes here.

Neither imports jax: the inputs are read through ``np.asarray``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .infer.svi import SVIState
from .models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS, PhaseData, VelocityData,
)
from .twodim.models import (
    VELO2D_PRIOR_FIELDS, VELO2D_TENSOR_FIELDS, Velo2DData,
)

__all__ = ["params_from_jax", "phase_data_from_jax", "velocity_data_from_jax",
           "velo2d_data_from_jax", "svi_state_from_jax"]


def params_from_jax(params, device=None):
    """{name: array} of unconstrained params -> {name: float32 leaf
    tensor on ``device`` that requires grad}; names are kept as they are
    (``nu_locs``, ``AutoNormal.locs.w_s``, ...)."""
    dev = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
        .requires_grad_(True)
        for k, v in params.items()
    }


def _data_from_jax(cls, tensor_fields, data, device):
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(data, f.name)
        if f.name in tensor_fields:
            kw[f.name] = None if v is None else torch.as_tensor(
                np.require(np.asarray(v), requirements="CW"), device=dev
            )
        else:
            kw[f.name] = v
    return cls(**kw)


def phase_data_from_jax(data, device=None):
    """JAX `PhaseData` (arrays readable by ``np.asarray``) -> port
    `PhaseData` on ``device``; dtypes kept (int16 counts stay int16)."""
    return _data_from_jax(PhaseData, PHASE_TENSOR_FIELDS, data, device)


def velocity_data_from_jax(data, device=None):
    """JAX `VelocityData` -> port `VelocityData` on ``device``, as
    `phase_data_from_jax`."""
    return _data_from_jax(VelocityData, VELOCITY_TENSOR_FIELDS, data, device)


def velo2d_data_from_jax(data, device=None):
    """JAX `Velo2DData` -> port `Velo2DData` on ``device``: the designs,
    counts and frozen stage-1 arrays as float32 tensors, a prior that is a
    scalar as a Python float, one that is an array as a tensor."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(Velo2DData):
        v = getattr(data, f.name)
        if f.name in VELO2D_TENSOR_FIELDS or (
                f.name in VELO2D_PRIOR_FIELDS and np.ndim(v) > 0):
            kw[f.name] = torch.as_tensor(
                np.require(np.asarray(v, np.float32), requirements="CW"),
                device=dev)
        elif f.name in VELO2D_PRIOR_FIELDS:
            kw[f.name] = float(v)
        else:
            kw[f.name] = int(v)
    return Velo2DData(**kw)


def svi_state_from_jax(state, key, device=None):
    """JAX `SVIState` -> port `SVIState` on ``device``: the step, the params
    through `params_from_jax`, the optimizer's ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``, found by its fields in the optax chain's
    state) as ``{count, m, v}``, and ``key``, an integer seed: the two
    packages' random streams differ, so the JAX key does not carry over."""
    dev = resolve_device(device)
    adam = [s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError("the JAX optimizer state holds no single Adam state "
                         "(ScaleByAdamState with mu and nu)")
    (adam,) = adam

    def moments(tree):
        return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
                for k, v in tree.items()}

    return SVIState(
        step=int(np.asarray(state.step)),
        params=params_from_jax(state.params, device=dev),
        opt_state={"count": int(np.asarray(adam.count)),
                   "m": moments(adam.mu), "v": moments(adam.nu)},
        key=int(key),
    )
