"""Multi-process wiring: process-group initialisation, the per-rank cell
slices, per-rank loading, and the collectives the samplers use (port of
`velocycle_tpu/parallel/distributed.py`).

One process per device, under `torch.distributed`.  Each rank holds its
shard as ordinary local tensors on its own device (``cuda:{local_rank %
device_count}``, or the CPU when asked) and the collectives are explicit:
the JAX package's SPMD program inserts them, here the sharded SVI step and
the samplers call them.  Under ``torchrun``:

    from velocycle_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # env:// from torchrun's environment
    mesh = make_mesh(("cells",))
    lo, hi = distributed.process_cell_slice(Nc)   # this rank's cells
    # ... load cells [lo:hi) only, `globalize_data`, then SVI.init_sharded

`launch.run_ranks` starts the ranks itself (spawned processes over a
``file://`` store) for the examples, the tests and `scaling`.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_initialized",
    "process_index",
    "process_count",
    "process_cell_slice",
    "split_counts",
    "local_data_slice",
    "globalize_data",
    "globalize_params",
    "replicate_global",
    "default_backend",
    "rank_device",
    "gather_rows",
    "group_src",
    "group_device",
]

# torchrun's environment: all three say a multi-process launch
_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def default_backend(device):
    """NCCL for a CUDA device, gloo for the CPU.  Two ranks cannot share
    one card over NCCL: pass ``backend="gloo"`` for that."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device=None):
    """Initialise the default process group (`torch.distributed.
    init_process_group`).

    A no-op returning False when a group exists already, or when neither
    ``init_method`` nor torchrun's environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) is given, so that a program can call it
    unconditionally.  ``backend`` defaults from ``device`` (None: the card)
    as `default_backend` says; an NCCL failure propagates."""
    from ..device import resolve_device

    if dist.is_initialized():
        return False
    if init_method is None:
        if not all(v in os.environ for v in _ENV):
            return False
        init_method = "env://"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(
        backend or default_backend(dev), init_method=init_method,
        world_size=world_size, rank=rank)
    return True


def is_initialized():
    return dist.is_initialized()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None, rank=None):
    """The device of this rank: ``cuda:{local_rank % device_count}`` (the
    local rank from ``LOCAL_RANK``, else the rank), or the CPU."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", int(rank) % torch.cuda.device_count())


def process_cell_slice(n_cells, index=None, count=None):
    """This rank's contiguous [lo, hi) slice of the global cell axis.

    Cells are split as evenly as possible (the first ``n_cells % count``
    ranks take one extra), the layout `sharding.shard_phase_data` gives, so
    per-rank loading feeds the right shard with no resharding."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base, extra = divmod(int(n_cells), count)
    lo = index * base + min(index, extra)
    hi = lo + base + (1 if index < extra else 0)
    return lo, hi


def split_counts(n, count):
    """The row counts `process_cell_slice` gives each of ``count`` ranks."""
    return [hi - lo for lo, hi in (process_cell_slice(n, r, count)
                                   for r in range(count))]


def local_data_slice(array, axis=-1, index=None, count=None):
    """Slice a host-side array to this rank's cell range along ``axis``."""
    lo, hi = process_cell_slice(np.shape(array)[axis], index, count)
    sl = [slice(None)] * np.ndim(array)
    sl[axis] = slice(lo, hi)
    return array[tuple(sl)]


def group_src(group):
    """The global rank of ``group``'s rank 0 (the source of its
    broadcasts)."""
    return dist.get_global_rank(group, 0) if group is not None else 0


def gather_rows(t, group, counts):
    """Every member's rows of ``t`` concatenated in group-rank order, on
    every member: ``counts[r]`` rows from group rank r.  One ``all_reduce``
    of a zero-filled buffer (gloo reduces CUDA tensors; it gathers only on
    the host), so all members hold the same bits."""
    r = dist.get_rank(group)
    lo = sum(counts[:r])
    out = torch.zeros((sum(counts),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[lo:lo + counts[r]] = t
    dist.all_reduce(out, group=group)
    return out


def _member_sizes(n, group):
    """Every group member's ``n``, in group-rank order."""
    sizes = torch.zeros(dist.get_world_size(group), dtype=torch.int64,
                        device=group_device(group))
    sizes[dist.get_rank(group)] = int(n)
    dist.all_reduce(sizes, group=group)
    return [int(s) for s in sizes]


def group_device(group):
    """The device a collective over ``group`` takes: this rank's card under
    NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- per-rank loading ---------------------------------------------------------
# Each rank loads only its own cells host-side; these assemble the sharded
# containers and params that `SVI.init_sharded` takes, the same ones
# `sharding.shard_phase_data` / `shard_params` cut from a full container.

def globalize_data(local_data, mesh, global_Nc, axis="cells"):
    """A sharded PhaseData / VelocityData from THIS rank's cells.

    ``local_data`` carries the rank's rows in its cell-axis fields (counts,
    count_factor, phixy_prior, design rows) and the full gene-side priors;
    ``lgamma_k_sum`` must already be the GLOBAL sum (compute it before
    slicing, or all-reduce it).  The ranks' row counts must add up to
    ``global_Nc``; each rank's offset is the sum of the rows before it.
    The result lives on the rank's device, its ``Nc`` is the local row
    count (the models see their shard) and its ``shard`` records ``(lo, hi,
    global_Nc, group)``."""
    from .sharding import CellShard, _as_sharded

    group = mesh.get_group(axis)
    sizes = _member_sizes(local_data.Nc, group)
    if sum(sizes) != int(global_Nc):
        raise ValueError(f"the ranks hold {sizes} cells, {sum(sizes)} in all, "
                         f"not global_Nc={global_Nc}")
    r = dist.get_rank(group)
    lo = sum(sizes[:r])
    shard = CellShard(lo, lo + sizes[r], int(global_Nc), group)
    return _as_sharded(local_data, shard, rank_device(mesh.device_type))


def globalize_params(local_params, mesh, global_Nc, axis="cells"):
    """Variational params from per-rank host values: per-cell rows
    (``phixy_locs``/``phi_locs``) from each rank's slice; gene/global
    params must be identical on every rank (the same init) and are taken
    from the group's rank 0.  Leaf tensors on the rank's device that
    require grad."""
    from .sharding import PARAM_CELL_AXES

    group = mesh.get_group(axis)
    dev = rank_device(mesh.device_type)
    out = {}
    for name, v in local_params.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v, dtype=torch.float32).to(dev).clone()
        ax = PARAM_CELL_AXES.get(name)
        if ax is None:
            dist.broadcast(t, src=group_src(group), group=group)
        elif sum(_member_sizes(t.shape[ax], group)) != int(global_Nc):
            raise ValueError(f"{name}: the ranks' rows do not add up to "
                             f"global_Nc={global_Nc}")
        out[name] = t.requires_grad_(True)
    return out


def replicate_global(tree, mesh):
    """Replicate values that are identical on every rank over the mesh
    (`sharding.replicate`)."""
    from .sharding import replicate

    return replicate(tree, mesh)
