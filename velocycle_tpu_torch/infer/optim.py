"""ClippedAdam, as `velocycle_tpu/infer/optim.py` composes it from optax:

  1. clamp each gradient element to [-clip_norm, clip_norm];
  2. bias-corrected Adam moments, betas (0.80, 0.99) by default, with eps
     outside the square root;
  3. step ``-lr * lrd**t``, t counted from 0.

`ClippedAdam.update` writes the new parameters in place (no second copy of
each parameter per step).  `adam` is the same update with no clamp and no
decay, as `optax.adam` (the 2-D driver's optimizer).
"""
from __future__ import annotations

import torch

__all__ = ["ClippedAdam", "clipped_adam", "adam"]


class ClippedAdam:
    def __init__(self, lr=0.05, betas=(0.80, 0.99), eps=1e-8, clip_norm=10.0,
                 lrd=1.0):
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.clip_norm = clip_norm
        self.lrd = lrd

    def init(self, params):
        """Optimizer state: step count and the two moments per parameter."""
        return {
            "count": 0,
            "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: ``params`` (a dict of tensors) is updated in place;
        ``state`` is advanced in place.  A missing or None gradient counts
        as zero; ``clip_norm=None`` clamps nothing."""
        b1, b2 = self.betas
        t = state["count"]
        bc1 = 1.0 - b1 ** (t + 1)
        bc2 = 1.0 - b2 ** (t + 1)
        step = -self.lr * self.lrd ** t
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            elif self.clip_norm is not None:
                g = g.clamp(-self.clip_norm, self.clip_norm)
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            p.add_(upd, alpha=step)
        state["count"] = t + 1


def clipped_adam(lr=0.05, betas=(0.80, 0.99), eps=1e-8, clip_norm=10.0,
                 lrd=1.0):
    """The ClippedAdam the reference tutorials use (see `ClippedAdam`)."""
    return ClippedAdam(lr=lr, betas=betas, eps=eps, clip_norm=clip_norm,
                       lrd=lrd)


def adam(lr=1e-2, betas=(0.9, 0.999), eps=1e-8):
    """Plain Adam, as ``optax.adam``: bias-corrected moments, eps outside the
    square root, no clamp, no decay."""
    return ClippedAdam(lr=lr, betas=betas, eps=eps, clip_norm=None)
