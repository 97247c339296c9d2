"""Multi-device runs of the port: one process per device under
`torch.distributed`, cell-sharded SVI (`SVI.init_sharded`), chain-sharded
MCMC and particle-sharded SMC (``mesh=``).  Port of
`velocycle_tpu/parallel/`, plus `launch.run_ranks`, which starts the ranks
of one host (the JAX package's virtual devices)."""
from . import distributed  # noqa: F401
from .launch import run_ranks  # noqa: F401
from .mesh import local_mesh, make_mesh  # noqa: F401
from .scaling import format_report, phase_weak_scaling  # noqa: F401
from .sharding import (  # noqa: F401
    CellShard,
    data_sharding_spec,
    param_sharding_spec,
    replicate,
    shard_params,
    shard_phase_data,
    shard_velocity_data,
)
