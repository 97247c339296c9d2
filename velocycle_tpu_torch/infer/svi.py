"""Stochastic Variational Inference (port of `velocycle_tpu/infer/svi.py`).

The param "store" is an explicit dict of unconstrained leaf tensors.  One
`update` does

    params -> constrain -> guide trace -> model replay -> ELBO
           -> autograd -> ClippedAdam (in place)

eagerly.  The JAX package scans a chunk of steps as one XLA program; here a
chunk is a Python loop whose losses stay on the device, and `run` copies
them to the host once per chunk (the only host sync of the loop).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import handlers
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

    def loss_fn(self, params, key, *args, **kwargs):
        constrained = constrain(params, self.constraints)
        guide = handlers.substitute(self.guide, data=constrained)
        model = handlers.substitute(self.model, data=constrained)
        return self.loss.loss(key, model, guide, *args, **kwargs)

    def update(self, state, *args, **kwargs):
        """One SVI step; returns (state, loss as a 0-d device tensor)."""
        key, sub = handlers.fold_in(state.key, 0), handlers.fold_in(state.key, 1)
        names = list(state.params)
        loss = self.loss_fn(state.params, sub, *args, **kwargs)
        grads = torch.autograd.grad(
            loss, [state.params[n] for n in names], allow_unused=True
        )
        self.optim.update(dict(zip(names, grads)), state.opt_state,
                          state.params)
        state = SVIState(state.step + 1, state.params, state.opt_state, key)
        return state, loss.detach()

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
