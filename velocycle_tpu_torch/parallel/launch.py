"""Start the ranks of a multi-process program on one host: the port's
counterpart of the JAX package's virtual devices.

`run_ranks(fn, world)` spawns ``world`` processes that join one process
group over a ``file://`` store in a temporary directory (concurrent
callers never collide on a TCP port), calls ``fn(*args)`` in each, and
returns each rank's result.  A rank that raises or exits non-zero, or a
run past ``timeout``, stops every rank and raises here.  Under
``torchrun`` the same entry points read the environment instead
(`distributed.initialize`).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import distributed

__all__ = ["run_ranks"]


def _rank_main(fn, rank, world, backend, device, url, results, args):
    """A spawned rank: one intra-op thread, join the group, run ``fn``,
    report its result (or the traceback) to the parent."""
    torch.set_num_threads(1)
    try:
        distributed.initialize(init_method=url, world_size=world, rank=rank,
                               backend=backend, device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, backend=None, device=None, timeout=600, args=()):
    """``[fn(*args) on rank r for r in range(world)]``, each rank a spawned
    process in one process group.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).
    ``device``: None is the card (every rank on ``cuda:{rank %
    device_count}``), "cpu" the CPU; ``backend`` defaults to NCCL on the
    card and gloo on the CPU (two ranks sharing one card need gloo).  On the
    card the CUDA libraries are built here first, so that the ranks load
    them instead of each building them.  Raises RuntimeError naming the rank
    when one fails, TimeoutError after ``timeout`` seconds; every rank is
    stopped either way.  The ranks are daemonic: they end with this
    process, and cannot start processes of `multiprocessing` themselves
    (`subprocess` they can)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    backend = backend or distributed.default_backend(dev)
    if dev.type == "cuda":
        from ..ops import cuda_build

        cuda_build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="vct_ranks_") as tmp:
        url = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, backend, dev.type, url, results, tuple(args)))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"run_ranks: {world} ranks of {fn.__name__} not "
                            f"done after {timeout} s") from None
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"run_ranks: rank {r} of {fn.__name__} "
                                f"exited with code {p.exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"run_ranks: rank {rank} of {fn.__name__} failed:\n"
                        f"{payload}")
                out[rank] = payload
            for r, p in enumerate(procs):
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise RuntimeError(f"run_ranks: rank {r} of {fn.__name__} "
                                       f"exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(world)]
