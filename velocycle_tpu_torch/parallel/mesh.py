"""Device mesh construction (port of `velocycle_tpu/parallel/mesh.py`).

The framework's scaling axis is **cells**, with optional axes for MCMC
chains and SMC particles.  A mesh is a `torch.distributed.device_mesh.
DeviceMesh` over the ranks of the default process group, one rank per
device, with named axes; ``mesh.get_group(name)`` is each axis' group.
Not DTensor: the fused likelihood is an autograd Function over a
ctypes-loaded kernel, through which DTensor cannot propagate a sharding,
so each rank keeps plain local shards and the collectives are explicit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from . import distributed

__all__ = ["make_mesh", "local_mesh", "AxisShare", "axis_share",
           "refuse_other_axes"]


def make_mesh(axis_names=("cells",), shape=None, device=None, backend=None):
    """A named `DeviceMesh` over every rank of the process group.

    Args:
      axis_names: mesh axis names; default a 1-D ("cells",) mesh.
      shape: per-axis sizes; default puts every rank on the first axis.
      device: the ranks' device kind (None: the card; "cpu" asks for the
        CPU).  Each rank's device is `distributed.rank_device`'s.
      backend: the process group's backend when this call creates it
        (default: NCCL on the card, gloo on the CPU).

    With no process group and no torchrun environment this creates a
    world of one process over an in-memory store, so that a
    single-process program runs unchanged.
    """
    dev = distributed.rank_device(device)
    if not distributed.initialize(device=dev, backend=backend) \
            and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or distributed.default_backend(dev),
            store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        # the rank's card is current before the mesh sets one itself
        torch.cuda.set_device(dev)
        torch.cuda.init()
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def local_mesh(n=None, axis_names=("cells",), device=None):
    """A 1-D mesh over the ranks, which must number ``n`` when given."""
    if n is not None and dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(f"mesh shape ({n},) != {dist.get_world_size()} "
                         "devices")
    return make_mesh(axis_names, shape=None if n is None else (n,),
                     device=device)


class AxisShare(NamedTuple):
    """This rank's share [lo, hi) of items split over one mesh axis: the
    axis' process group and every member's count (group-rank order)."""
    group: Any
    counts: list
    lo: int
    hi: int


def axis_share(mesh, axis, n):
    """This rank's share of ``n`` chains or particles split over ``mesh``'s
    ``axis``, as `distributed.process_cell_slice` splits cells."""
    group = mesh.get_group(axis)
    counts = distributed.split_counts(n, group.size())
    lo = sum(counts[:group.rank()])
    return AxisShare(group, counts, lo, lo + counts[group.rank()])


def refuse_other_axes(mesh, axis, what):
    """Raise ValueError unless ``mesh`` names ``axis`` and its other axes
    have one rank each (``what`` names the caller that splits ``axis``
    only)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names or any(mesh.get_group(a).size() > 1
                                for a in names if a != axis):
        raise ValueError(f"{what} splits {axis!r} only; the mesh's axes "
                         f"{names} (cell-sharded sampling: MCMC with this "
                         "rank's data shard)")
