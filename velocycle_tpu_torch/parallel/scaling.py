"""Weak-scaling harness (port of `velocycle_tpu/parallel/scaling.py`).

Weak scaling holds the cells per rank constant while the ranks grow; the
ideal step time is flat, and

    efficiency(n) = t_step(1 rank) / t_step(n ranks)

The harness times the same sharded SVI program (`SVI.init_sharded` then
`update_chunk`) over cell-sharded data at 1, 2, 4, ... ranks, each world
started by `launch.run_ranks`.  Across cards this measures the replicated
gradients' all-reduce.  Ranks that share one card (over gloo), or the CPU
cores, contend for it: their efficiency measures that contention, not
scaling; the harness still shows that the program runs and reduces
correctly at every size.
"""
from __future__ import annotations

import time

import numpy as np

from .launch import run_ranks

__all__ = ["phase_weak_scaling", "format_report"]


def _rank_timing(Nc, Ng, n_harmonics, steps, seed, repeats, device):
    """One rank of one world: the best of ``repeats`` timed chunks of
    ``steps`` sharded steps, after one untimed chunk; the slowest rank's
    time is the world's."""
    import torch
    import torch.distributed as dist

    from .. import Cycle, Phases, preprocess_for_phase_estimation
    from ..infer import SVI, Trace_ELBO, clipped_adam
    from ..simulate import simulate_data
    from .distributed import group_device, rank_device
    from .mesh import make_mesh
    from .sharding import shard_phase_data

    adata = simulate_data(Nc=Nc, Ng=Ng, omegas_to_test=(0.4,), seed=seed)
    cycle = Cycle.trivial_prior(list(adata.var.index), harmonics=n_harmonics)
    phases = Phases.from_angles(np.asarray(adata.obs["simulated_phis"].values),
                                cell_names=list(adata.obs.index))
    dev = rank_device(device)
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=n_harmonics, with_delta_nu=False,
        device=dev)
    mesh = make_mesh(("cells",), device=dev.type)
    data = shard_phase_data(mp.data, mesh)
    svi = SVI(mp.model_fn, mp.guide_fn, clipped_adam(), Trace_ELBO())
    state = svi.init_sharded(seed, mesh, data)

    def chunk(state):
        state, losses = svi.update_chunk(state, steps, data)
        losses.cpu()          # the losses on the host: the chunk is done
        return state

    state = chunk(state)
    best = np.inf
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        state = chunk(state)
        best = min(best, time.perf_counter() - t0)
    slowest = torch.tensor([best], dtype=torch.float64,
                           device=group_device(None))
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return float(slowest)


def phase_weak_scaling(per_device_cells=512, Ng=64, n_harmonics=1,
                       steps=50, device_counts=None, seed=0, repeats=3,
                       device=None, backend=None, timeout=600):
    """Weak-scaling report for the phase-stage SVI step.

    Returns a list of dicts {devices, Nc, steps_per_s, step_ms,
    efficiency}, efficiency normalised to the smallest world measured.
    ``device``: None is the card ("cpu" the CPU); ``device_counts``
    defaults to 1, 2, 4, ... up to the cards present (on the CPU: 1 and
    2); ``backend`` as `run_ranks` (gloo for ranks that share a card)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if device_counts is None:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 2
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    rows = []
    for n in device_counts:
        Nc = per_device_cells * n
        t = run_ranks(_rank_timing, n, backend=backend, device=dev.type,
                      timeout=timeout,
                      args=(Nc, Ng, n_harmonics, steps, seed, repeats,
                            dev.type))[0]
        rows.append({"devices": n, "Nc": Nc, "steps_per_s": steps / t,
                     "step_ms": t / steps * 1e3})
    t1 = rows[0]["step_ms"]
    for r in rows:
        r["efficiency"] = t1 / r["step_ms"]
    return rows


def format_report(rows):
    lines = ["devices    Nc  steps/s  step_ms  efficiency"]
    for r in rows:
        lines.append(
            f"{r['devices']:>7} {r['Nc']:>5} {r['steps_per_s']:>8.1f} "
            f"{r['step_ms']:>8.3f} {r['efficiency']:>10.2f}"
        )
    return "\n".join(lines)
