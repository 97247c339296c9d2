"""Automatic guides (port of `velocycle_tpu/infer/autoguide.py`).

`AutoNormal` is the mean-field Normal guide over every latent site of a
model, as the 2-D driver uses it; `AutoDelta` is its MAP form.  Their
locs start at one seeded draw of the model (init_to_sample): the model is
traced once, at the first call, and its observed and auxiliary sites are
skipped.

``init_key`` is an integer seed, as in every entry point of the port; the
port's draws are not the JAX package's (`core.handlers.seed`).
"""
from __future__ import annotations

import torch

from ..core import constraints, handlers
from ..core import distributions as dist

__all__ = ["AutoNormal", "AutoDelta"]


class _AutoGuide:
    def __init__(self, model, prefix=None, init_key=None):
        self.model = model
        self.prefix = prefix or type(self).__name__
        self.init_key = 0 if init_key is None else int(init_key)
        self._prototype = None

    def _get_prototype(self, *args, **kwargs):
        if self._prototype is None:
            with torch.no_grad():
                tr = handlers.trace(
                    handlers.seed(self.model, self.init_key)
                ).get_trace(*args, **kwargs)
            proto = {}
            for name, site in tr.items():
                if site["type"] != "sample" or site["is_observed"]:
                    continue
                if site.get("infer", {}).get("is_auxiliary"):
                    continue
                proto[name] = torch.as_tensor(site["value"]).detach()
            self._prototype = proto
        return self._prototype

    def median(self, params):
        """{site: loc} from a constrained param dict."""
        head = f"{self.prefix}.locs."
        return {name[len(head):]: v for name, v in params.items()
                if name.startswith(head)}


class AutoNormal(_AutoGuide):
    """Mean-field Normal guide: per-site ``loc``/``scale`` params, the
    scales positive and starting at ``init_scale``."""

    def __init__(self, model, init_scale=0.1, **kwargs):
        super().__init__(model, **kwargs)
        self.init_scale = init_scale

    def __call__(self, *args, **kwargs):
        proto = self._get_prototype(*args, **kwargs)
        for name, value in proto.items():
            loc = handlers.param(f"{self.prefix}.locs.{name}", value)
            scale = handlers.param(
                f"{self.prefix}.scales.{name}",
                torch.full(value.shape, self.init_scale, dtype=value.dtype,
                           device=value.device),
                constraint=constraints.positive,
            )
            handlers.sample(
                name, dist.Normal(loc, scale).to_event(value.ndim)
            )


class AutoDelta(_AutoGuide):
    """MAP guide: a Delta at a learnable point per site."""

    def __call__(self, *args, **kwargs):
        proto = self._get_prototype(*args, **kwargs)
        for name, value in proto.items():
            loc = handlers.param(f"{self.prefix}.locs.{name}", value)
            handlers.sample(name, dist.Delta(loc).to_event(value.ndim))
