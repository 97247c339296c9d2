"""Stochastic Variational Inference (port of `velocycle_tpu/infer/svi.py`).

The param "store" is an explicit dict of unconstrained leaf tensors.  One
`update` does

    params -> constrain -> guide trace -> model replay -> ELBO
           -> autograd -> ClippedAdam (in place)

eagerly.  The JAX package scans a chunk of steps as one XLA program; here a
chunk is a Python loop whose losses stay on the device, and `run` copies
them to the host once per chunk (the only host sync of the loop).

`init_sharded` lays the state out over a mesh's cell axis (one process per
device, `parallel`); `update` on such a state is the sharded step, which
gives the one-device fit up to summation order:

  * each rank evaluates the ELBO on its cells.  The cell-local sites
    (`minibatch.LOCAL_SITES`: the likelihoods, ``phi_xy``/``phi``) enter on
    every rank, the gene-global sites' model and guide terms on the group's
    rank 0 only;
  * a draw of a site in the ``"cells"`` plate is made at the GLOBAL shape
    and cut to the rank's cells, so that every world follows the random
    path of one device;
  * one ``all_reduce`` of one flat buffer per step sums the replicated
    params' gradients and the loss; the per-cell params need none.
    ClippedAdam clamps element by element, so every rank applies the same
    update and the replicated params stay bit-identical across ranks.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import handlers
from ..core.distributions import Distribution
from ..profiling import span
from .elbo import Trace_ELBO

__all__ = ["SVI", "SVIState", "init_params", "constrain"]


class _ParamCollector(handlers.Messenger):
    """Collect param init values + constraints from a guide execution."""

    def __enter__(self):
        super().__enter__()
        self.params = {}
        self.constraints = {}
        return self

    def process_message(self, msg):
        if msg["type"] == "param" and msg["name"] not in self.params:
            init = msg["init"]
            if callable(init):
                init = init()
            self.params[msg["name"]] = torch.as_tensor(
                init, dtype=torch.float32
            ).detach().clone()
            self.constraints[msg["name"]] = msg["constraint"]


def init_params(guide, key, *args, **kwargs):
    """Run ``guide`` once to harvest parameter inits and constraints.

    Returns (unconstrained leaf tensors with requires_grad, constraints)."""
    with _ParamCollector() as collector:
        handlers.trace(handlers.seed(guide, key)).get_trace(*args, **kwargs)
    unconstrained = {}
    for name, value in collector.params.items():
        c = collector.constraints[name]
        u = c.inverse(value) if c is not None else value
        unconstrained[name] = u.detach().clone().requires_grad_(True)
    return unconstrained, collector.constraints


def constrain(unconstrained, constraints):
    return {
        name: (constraints[name].forward(u) if constraints.get(name) else u)
        for name, u in unconstrained.items()
    }


@dataclasses.dataclass
class SVIState:
    step: int
    params: dict      # name -> unconstrained leaf tensor (requires_grad)
    opt_state: dict
    key: int
    # `parallel.sharding.CellShard` of a sharded state (`init_sharded`)
    shard: Any = None


def _widen(d, ax, ndim, lo, n, N):
    """A copy of distribution ``d`` whose parameters that run over this
    rank's ``n`` cells on axis ``ax`` of its ``ndim``-dim draw run over all
    ``N``: the rank's rows at [lo, lo + n), the edge rows repeated around
    them (their draws are cut away)."""
    d = copy.copy(d)
    for k, v in list(vars(d).items()):
        if isinstance(v, Distribution):
            setattr(d, k, _widen(v, ax, ndim, lo, n, N))
        elif isinstance(v, torch.Tensor):
            i = ax - (ndim - v.dim())
            if i < 0 or v.shape[i] != n:
                continue
            edge = v.detach().narrow(i, 0, 1)
            shape = list(v.shape)
            parts = []
            if lo:
                shape[i] = lo
                parts.append(edge.expand(shape))
            parts.append(v)
            if N - lo - n:
                shape[i] = N - lo - n
                parts.append(edge.expand(shape))
            setattr(d, k, torch.cat(parts, i))
    return d


class _global_cell_draws(handlers.Messenger):
    """Draw every sample site of the ``"cells"`` plate at the GLOBAL cell
    count and keep this rank's cells, so that a sharded step draws the
    noise the one-device step draws (``Nc_global x event`` floats per site
    and step).  Installed outermost, it acts after the seed, replay and
    substitute handlers: sites given a value are left as they are.  A site
    of the plate that is not in ``local_sites`` is refused: off rank 0 the
    sharded step scales every other site by 0, so its terms would count
    rank 0's cells only."""

    def __init__(self, shard, local_sites):
        super().__init__(None)
        self.shard = shard
        self.local_sites = local_sites

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        cells = [(size, dim) for name, size, dim
                 in msg.get("cond_indep_stack", ()) if name == "cells"]
        if cells and msg["name"] not in self.local_sites:
            raise ValueError(
                f"site {msg['name']!r} lies in the 'cells' plate but not in "
                "minibatch.LOCAL_SITES: the sharded step would count its "
                "terms on rank 0's cells only")
        if msg["value"] is not None or msg.get("key") is None:
            return
        lo, hi, N = self.shard.lo, self.shard.hi, self.shard.Nc_global
        if hi - lo == N:
            return
        for size, dim in cells:
            if size != hi - lo or dim is None:
                continue
            fn = msg["fn"]
            ndim = len(fn.batch_shape) + len(fn.event_shape)
            ax = len(fn.batch_shape) + dim
            wide = _widen(fn, ax, ndim, lo, hi - lo, N)
            msg["value"] = wide.sample(msg["key"]).narrow(ax, lo, hi - lo)
            return


class SVI:
    def __init__(self, model, guide, optim, loss=None):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.loss = loss if loss is not None else Trace_ELBO()
        self.constraints = None

    def init(self, key, *args, **kwargs):
        key_init, key_state = handlers.fold_in(key, 0), handlers.fold_in(key, 1)
        params, self.constraints = init_params(
            self.guide, key_init, *args, **kwargs
        )
        return SVIState(0, params, self.optim.init(params), key_state)

    def init_sharded(self, key, mesh, data, *args, **kwargs):
        """`init` on this rank's shard (``data`` from `parallel.
        shard_phase_data` / `shard_velocity_data` / `distributed.
        globalize_data`, whose ``shard`` names the cell axis' group): the
        per-cell params cover the rank's cells, the replicated params are
        broadcast from the group's rank 0 in one flat buffer.  `update` and
        `update_chunk` on the returned state take the same ``data`` and
        run the sharded step (module docstring).  ``mesh`` is the data's."""
        from ..parallel import distributed
        from ..parallel.sharding import PARAM_CELL_AXES

        shard = getattr(data, "shard", None)
        if shard is None:
            raise ValueError(
                "init_sharded takes this rank's shard of the data: "
                "parallel.shard_phase_data / shard_velocity_data(data, mesh) "
                "or distributed.globalize_data")
        if getattr(data, "gene_selection_model", "all") == "lba":
            raise ValueError(
                "the LBA mixture model does not shard: its per-gene "
                "logsumexp runs over all cells (models/phase.py "
                "phase_model_lba)")
        state = self.init(key, data, *args, **kwargs)
        rep = [p for n, p in state.params.items() if n not in PARAM_CELL_AXES]
        if rep:
            with torch.no_grad():
                flat = torch.cat([p.reshape(-1) for p in rep])
                torch.distributed.broadcast(
                    flat, src=distributed.group_src(shard.group),
                    group=shard.group)
                for p, v in zip(rep, flat.split([p.numel() for p in rep])):
                    p.copy_(v.view_as(p))
        state.shard = shard
        return state

    def loss_fn(self, params, key, *args, **kwargs):
        constrained = constrain(params, self.constraints)
        guide = handlers.substitute(self.guide, data=constrained)
        model = handlers.substitute(self.model, data=constrained)
        return self.loss.loss(key, model, guide, *args, **kwargs)

    def _sharded_value_and_grad(self, params, key, shard, *args, **kwargs):
        """(the global loss, {param: gradient}) of one sharded step: the
        replicated params' gradients and the loss summed over the cell
        group in one ``all_reduce``, the per-cell params' local."""
        from ..parallel.sharding import PARAM_CELL_AXES
        from .minibatch import LOCAL_SITES

        constrained = constrain(params, self.constraints)
        guide = handlers.substitute(self.guide, data=constrained)
        model = handlers.substitute(self.model, data=constrained)
        if shard.rank != 0:     # the gene-global terms enter on rank 0 only
            def once(fn):
                return handlers.scale(fn, scale_factor=0.0,
                                      site_filter=lambda n: n not in LOCAL_SITES)
            guide, model = once(guide), once(model)
        with span("svi.elbo"), _global_cell_draws(shard, LOCAL_SITES):
            loss = self.loss.loss(key, model, guide, *args, **kwargs)
        with span("svi.backward"):
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [params[n] for n in names], allow_unused=True)))
            rep = [n for n in names if n not in PARAM_CELL_AXES]
            flat = torch.cat(
                [(torch.zeros_like(params[n]) if grads[n] is None
                  else grads[n]).reshape(-1) for n in rep]
                + [loss.detach().reshape(1)])
            torch.distributed.all_reduce(flat, group=shard.group)
        parts = flat.split([params[n].numel() for n in rep] + [1])
        for n, g in zip(rep, parts):
            grads[n] = g.view_as(params[n])
        return parts[-1].reshape(()), grads

    def update(self, state, *args, **kwargs):
        """One SVI step; returns (state, loss as a 0-d device tensor).  On
        a state from `init_sharded`, the sharded step: the loss is the
        global one, on every rank.  The step is the span ``svi.step``, with
        ``svi.elbo``, ``svi.backward`` and ``svi.optim`` inside it
        (`profiling.span`)."""
        with span("svi.step"):
            key = handlers.fold_in(state.key, 0)
            sub = handlers.fold_in(state.key, 1)
            if state.shard is not None:
                loss, grads = self._sharded_value_and_grad(
                    state.params, sub, state.shard, *args, **kwargs)
            else:
                names = list(state.params)
                with span("svi.elbo"):
                    loss = self.loss_fn(state.params, sub, *args, **kwargs)
                with span("svi.backward"):
                    grads = dict(zip(names, torch.autograd.grad(
                        loss, [state.params[n] for n in names],
                        allow_unused=True)))
            with span("svi.optim"):
                self.optim.update(grads, state.opt_state, state.params)
            return SVIState(state.step + 1, state.params, state.opt_state,
                            key, state.shard), loss.detach()

    def update_chunk(self, state, num_steps, *args, **kwargs):
        """``num_steps`` updates; the losses come back as one device tensor
        with no host sync in between."""
        losses = []
        for _ in range(num_steps):
            state, loss = self.update(state, *args, **kwargs)
            losses.append(loss)
        return state, torch.stack(losses)

    def get_params(self, state):
        with torch.no_grad():
            return {
                k: v.detach()
                for k, v in constrain(state.params, self.constraints).items()
            }

    def run(self, key, num_steps, *args, log_every=0, callback=None,
            early_exit=False, early_exit_patience=200, chunk_size=None,
            **kwargs):
        """Run ``num_steps`` updates; returns (state, losses ndarray).

        Host-side checks happen only at chunk boundaries: the log line,
        ``callback(step, state, last_loss)`` and `early_exit`, which stops
        after ``early_exit_patience`` steps once |mean(last 100) - mean(last
        10)| < 5.  Chunks are 100 steps when any of them is asked for, else
        ``min(num_steps, 1000)``, unless ``chunk_size`` is given."""
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        if chunk_size is None:
            chunk_size = 100 if (early_exit or log_every or callback) else (
                min(num_steps, 1000)
            )
        state = self.init(key, *args, **kwargs)
        losses = []
        done = 0
        while done < num_steps:
            n = min(chunk_size, num_steps - done)
            state, chunk_losses = self.update_chunk(state, n, *args, **kwargs)
            losses.append(chunk_losses.cpu().numpy())
            done += n
            if log_every:
                print(f"step {done}: elbo loss = {float(losses[-1][-1]):.3f}")
            if callback is not None:
                callback(done, state, losses[-1][-1])
            if early_exit and done > early_exit_patience:
                recent = np.concatenate(losses)[-100:]
                if abs(recent.mean() - recent[-10:].mean()) < 5:
                    break
        return state, np.concatenate(losses)
