"""Single-particle reparameterized Trace ELBO (port of `Trace_ELBO` in
`velocycle_tpu/infer/elbo.py`): one draw from the guide, replayed through
the model; loss = -(sum model log p - sum guide log q).  Delta guide sites
contribute log q = 0, and auxiliary sites (``infer={"is_auxiliary": True}``,
such as the LRMN guide's single draw feeding its Delta sites) contribute
nothing, as in pyro, where that draw happens outside any sample site."""
from __future__ import annotations

from ..core import handlers

__all__ = ["Trace_ELBO"]


def _logp_sum(tr):
    total = 0.0
    for site in tr.values():
        if site["type"] != "sample" or site.get("hidden"):
            continue
        if site.get("infer", {}).get("is_auxiliary"):
            continue
        total = total + site["fn"].log_prob(site["value"]).sum()
    return total


class Trace_ELBO:
    """Negated single-particle ELBO."""

    def loss(self, key, model, guide, *args, **kwargs):
        k_guide, k_model = handlers.fold_in(key, 0), handlers.fold_in(key, 1)
        guide_tr = handlers.trace(
            handlers.seed(guide, k_guide)
        ).get_trace(*args, **kwargs)
        model_tr = handlers.trace(
            handlers.seed(
                handlers.replay(model, guide_trace=guide_tr), k_model
            )
        ).get_trace(*args, **kwargs)
        return -(_logp_sum(model_tr) - _logp_sum(guide_tr))
