"""Sharding rules: which axes of the data containers and the params are
split over the mesh's cell axis (port of `velocycle_tpu/parallel/
sharding.py`).

  * The **cell axis** (Nc) is split: counts ``S, U, logS, logU (Ng, Nc)``
    on their last dim, per-cell vectors (``count_factor``, ``phixy_prior``,
    ``phi_prior``) on their first, design matrices ``(Nb|Nx, Nc)`` on their
    last.  Rank r of the axis' group holds cells `distributed.
    process_cell_slice` gives it.
  * **Gene-wise** fields (priors, scalars) are replicated.
  * Variational params: ``phixy_locs``/``phi_locs (Nc, ...)`` are split
    with their cells; every gene/global param is replicated.

Each rank's shard is an ordinary container of local tensors on its own
device, whose ``Nc`` is its own cell count, so that the models run on it
unchanged; its ``shard`` records ``CellShard(lo, hi, Nc_global, group)``.
The dataset constant ``lgamma_k_sum`` stays on the group's rank 0 and is
0.0 on the others: the fused kernels keep skipping the per-element
``lgamma(k + 1)`` (they do so when the constant is given) and the sum over
the ranks counts it once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS, PhaseData, VelocityData,
)
from . import distributed

__all__ = [
    "CellShard",
    "ShardedPhaseData",
    "ShardedVelocityData",
    "data_sharding_spec",
    "param_sharding_spec",
    "shard_phase_data",
    "shard_velocity_data",
    "shard_params",
    "replicate",
    "PHASE_CELL_AXES",
    "VELOCITY_CELL_AXES",
    "PARAM_CELL_AXES",
]

# field name -> index of the cell axis in that field's shape
PHASE_CELL_AXES = {
    "S": 1, "logS": 1, "count_factor": 0, "phixy_prior": 0, "Db": 1,
    "phi_prior": 0,
}
VELOCITY_CELL_AXES = {
    "S": 1, "U": 1, "logS": 1, "logU": 1, "count_factor": 0,
    "phixy_prior": 0, "Db": 1, "D": 1, "phi_prior": 0,
}
# variational params with a leading cell axis
PARAM_CELL_AXES = {"phixy_locs": 0, "phi_locs": 0}


class CellShard(NamedTuple):
    """This rank's cells [lo, hi) of ``Nc_global``, split over ``group``
    (the mesh axis' process group)."""
    lo: int
    hi: int
    Nc_global: int
    group: Any

    @property
    def rank(self):
        return dist.get_rank(self.group)

    @property
    def size(self):
        return dist.get_world_size(self.group)


@dataclasses.dataclass
class ShardedPhaseData(PhaseData):
    """A rank's `PhaseData` shard (``Nc`` is its own cell count)."""
    shard: Optional[CellShard] = None


@dataclasses.dataclass
class ShardedVelocityData(VelocityData):
    """A rank's `VelocityData` shard (``Nc`` is its own cell count)."""
    shard: Optional[CellShard] = None


def _is_velocity(data):
    return hasattr(data, "U")


def _cell_axes_for_data(data):
    return VELOCITY_CELL_AXES if _is_velocity(data) else PHASE_CELL_AXES


def _tensor_fields(data):
    return (VELOCITY_TENSOR_FIELDS if _is_velocity(data)
            else PHASE_TENSOR_FIELDS)


def _cell_axis(name, leaf, cell_axes):
    ax = cell_axes.get(name)
    if ax is None or leaf is None or leaf.dim() <= ax:
        return None            # absent or broadcast leaf: replicated
    return ax


def data_sharding_spec(data):
    """{tensor field: the index of its cell axis, or None (replicated)} of
    a PhaseData / VelocityData."""
    cell_axes = _cell_axes_for_data(data)
    return {name: _cell_axis(name, getattr(data, name), cell_axes)
            for name in _tensor_fields(data)}


def param_sharding_spec(params):
    """{param: the index of its cell axis, or None (replicated)}."""
    return {name: _cell_axis(name, v, PARAM_CELL_AXES)
            for name, v in params.items()}


def _as_sharded(data, shard, device):
    """``data`` (already this rank's rows) as its sharded container on
    ``device``: contiguous tensors, ``lgamma_k_sum`` on the group's rank 0
    only, ``Nc`` the local count."""
    fields = {}
    for name in _tensor_fields(data):
        leaf = getattr(data, name)
        if leaf is not None:
            fields[name] = leaf.to(device).contiguous()
    lgk = fields.get("lgamma_k_sum")
    if lgk is not None and shard.rank != 0:
        fields["lgamma_k_sum"] = torch.zeros_like(lgk)
    cls = ShardedVelocityData if _is_velocity(data) else ShardedPhaseData
    base = {f.name: getattr(data, f.name) for f in dataclasses.fields(
        VelocityData if _is_velocity(data) else PhaseData)}
    base.update(fields, Nc=shard.hi - shard.lo)
    return cls(**base, shard=shard)


def _shard_data(data, mesh, axis):
    if getattr(data, "shard", None) is not None:
        raise ValueError("the data are sharded already")
    group = mesh.get_group(axis)
    lo, hi = distributed.process_cell_slice(
        data.Nc, dist.get_rank(group), dist.get_world_size(group))
    rows = {}
    for name, ax in data_sharding_spec(data).items():
        if ax is not None:
            rows[name] = getattr(data, name).narrow(ax, lo, hi - lo)
    return _as_sharded(data.replace(**rows), CellShard(lo, hi, data.Nc, group),
                       distributed.rank_device(mesh.device_type))


def shard_phase_data(data, mesh, axis="cells"):
    """This rank's shard of a full `PhaseData` (its cells on its device)."""
    return _shard_data(data, mesh, axis)


def shard_velocity_data(data, mesh, axis="cells"):
    """This rank's shard of a full `VelocityData`."""
    return _shard_data(data, mesh, axis)


def shard_params(params, mesh, axis="cells"):
    """This rank's params: per-cell params cut to its cells, the rest
    replicated; leaf tensors on its device that require grad."""
    group = mesh.get_group(axis)
    dev = distributed.rank_device(mesh.device_type)
    out = {}
    for name, v in params.items():
        t = torch.as_tensor(v).detach()
        ax = _cell_axis(name, t, PARAM_CELL_AXES)
        if ax is not None:
            lo, hi = distributed.process_cell_slice(
                t.shape[ax], dist.get_rank(group), dist.get_world_size(group))
            t = t.narrow(ax, lo, hi - lo)
        out[name] = t.to(dev, dtype=torch.float32).contiguous().clone(
        ).requires_grad_(True)
    return out


def replicate(tree, mesh):
    """Every tensor of ``tree`` (dicts, lists, tuples) moved to this rank's
    device and broadcast from rank 0 to every rank of the mesh (which spans
    the process group, as `make_mesh`'s do), so that every rank holds the
    same bits; other leaves are returned as they are."""
    dev = distributed.rank_device(mesh.device_type)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        t = x.detach().to(dev).clone()
        dist.broadcast(t, src=0)
        return t

    return one(tree)
