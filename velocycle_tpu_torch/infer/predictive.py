"""Posterior predictive sampling (port of `velocycle_tpu/infer/
predictive.py`): draw from the guide, replay the model, collect the
requested latent and deterministic sites.

The JAX package vmaps the draws inside one jitted program, where the
compiler drops intermediates no requested site needs.  Eager torch computes
every intermediate of every draw (the plain path's (Ng, Nc) ElogS among
them), so the draws run one at a time and only the requested sites are
kept.
"""
from __future__ import annotations

import torch

from ..core import handlers

__all__ = ["Predictive"]


class Predictive:
    """Sample sites from guide-replayed model executions.

    Args:
      model, guide: callables (without a guide, the prior predictive).
      params: dict of *constrained* parameter values substituted into both.
      num_samples: number of posterior draws.
      return_sites: site names to collect; None = all sample and
        deterministic sites except auxiliary ones.
    """

    def __init__(self, model, guide=None, params=None, num_samples=1,
                 return_sites=None):
        self.model = model
        self.guide = guide
        self.params = params or {}
        self.num_samples = num_samples
        self.return_sites = return_sites

    def _single(self, key, args, kwargs):
        k_guide, k_model = handlers.fold_in(key, 0), handlers.fold_in(key, 1)
        model = handlers.substitute(self.model, data=self.params)
        guide_tr = {}
        if self.guide is not None:
            guide = handlers.substitute(self.guide, data=self.params)
            guide_tr = handlers.trace(
                handlers.seed(guide, k_guide)
            ).get_trace(*args, **kwargs)
            model = handlers.replay(model, guide_trace=guide_tr)
        model_tr = handlers.trace(
            handlers.seed(model, k_model)
        ).get_trace(*args, **kwargs)

        out = {}
        for name, site in {**guide_tr, **model_tr}.items():
            if site["type"] not in ("sample", "deterministic"):
                continue
            if site.get("infer", {}).get("is_auxiliary"):
                continue
            if self.return_sites is not None and name not in self.return_sites:
                continue
            out[name] = site["value"]
        if self.return_sites is not None:
            missing = set(self.return_sites) - set(out)
            if missing:
                raise KeyError(
                    f"return_sites not found in trace: {sorted(missing)}"
                )
        return out

    @torch.no_grad()
    def __call__(self, key, *args, **kwargs):
        """Returns {site: (num_samples, ...) tensor}."""
        draws = [
            self._single(handlers.fold_in(key, i), args, kwargs)
            for i in range(self.num_samples)
        ]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
