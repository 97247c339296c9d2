"""ELBO estimators (port of `velocycle_tpu/infer/elbo.py`).

`Trace_ELBO` is the single-particle reparameterized Trace ELBO: one draw
from the guide, replayed through the model; loss = -(sum model log p - sum
guide log q), each site's term weighted by its ``scale`` (`handlers.scale`,
as the minibatch path sets it).  Delta guide sites contribute log q = 0, and auxiliary sites
(``infer={"is_auxiliary": True}``, such as the LRMN guide's single draw
feeding its Delta sites) contribute nothing, as in pyro, where that draw
happens outside any sample site.

`TraceEnum_ELBO` adds exact parallel enumeration of marked discrete model
sites (`handlers.enum`).  Both draw the guide and the model from the same
seeds for one key, so at one key they see the same guide draws.

Both take ``num_particles``: 1 (the default) evaluates one particle at
``key``; N > 1 the mean of N particles, the i-th at ``fold_in(key, i)``
(the JAX package splits its key instead; the port's draws differ anyway).
"""
from __future__ import annotations

import torch

from ..core import handlers

__all__ = ["Trace_ELBO", "TraceEnum_ELBO"]


def _elbo_term(site):
    """A site's elementwise log-prob, or None for sites with no ELBO term
    (non-sample, hidden and auxiliary sites)."""
    if site["type"] != "sample" or site.get("hidden"):
        return None
    if site.get("infer", {}).get("is_auxiliary"):
        return None
    return site["fn"].log_prob(site["value"])


def _logp_sum(tr):
    """Sum over the trace of each site's summed log-prob times its scale
    (`handlers.scale`; 1 unless a handler set one).  A site scaled by 0 (a
    sharded step's gene-global sites off the group's rank 0) is left out,
    its log-prob not computed."""
    total = 0.0
    for site in tr.values():
        if site.get("scale", 1.0) == 0.0:
            continue
        lp = _elbo_term(site)
        if lp is not None:
            total = total + lp.sum() * site.get("scale", 1.0)
    return total


def _traces(key, model, guide, args, kwargs):
    """(guide trace, the model replayed against it and seeded), both
    seeded from ``key``."""
    k_guide, k_model = handlers.fold_in(key, 0), handlers.fold_in(key, 1)
    guide_tr = handlers.trace(
        handlers.seed(guide, k_guide)
    ).get_trace(*args, **kwargs)
    replayed = handlers.seed(
        handlers.replay(model, guide_trace=guide_tr), k_model
    )
    return guide_tr, replayed


class _ELBO:
    def __init__(self, num_particles=1):
        if int(num_particles) < 1:
            raise ValueError(
                f"num_particles must be >= 1, got {num_particles}")
        self.num_particles = int(num_particles)

    def loss(self, key, model, guide, *args, **kwargs):
        """The negated ELBO: one particle at ``key``, or the mean of
        ``num_particles`` at ``fold_in(key, i)``."""
        if self.num_particles == 1:
            return self._particle(key, model, guide, args, kwargs)
        return torch.stack([
            self._particle(handlers.fold_in(key, i), model, guide, args,
                           kwargs)
            for i in range(self.num_particles)
        ]).mean()


class Trace_ELBO(_ELBO):
    """Negated reparameterized Trace ELBO."""

    def _particle(self, key, model, guide, args, kwargs):
        guide_tr, replayed = _traces(key, model, guide, args, kwargs)
        model_tr = handlers.trace(replayed).get_trace(*args, **kwargs)
        return -(_logp_sum(model_tr) - _logp_sum(guide_tr))


class TraceEnum_ELBO(_ELBO):
    """Trace ELBO with exact parallel enumeration of marked discrete sites
    (pyro's ``TraceEnum_ELBO`` with ``config_enumerate``).

    Sites sampled in the MODEL with ``infer={"enumerate": "parallel"}``
    and absent from the guide are summed out of the model log-joint:

        log p(x, z_cont) = logsumexp_k [ sum_{factors on k} log p ]
                           + sum_{factors independent of k} log p

    where the logsumexp runs per element of the enumerated sites' batch
    profile (a per-gene Bernoulli is marginalized per gene), and factor
    axes the profile does not carry (the cell axis of the likelihood) are
    summed INSIDE the logsumexp.  Enumerated sites broadcast on leading
    axes (`handlers.enum`), so a model mixing with ``torch.where`` needs no
    changes.  Continuous sites keep the reparameterized estimator.

    Limits, as the JAX package's: a factor may not couple an enumerated
    variable across its own batch axes, and several enumerated sites
    should share one batch profile.  A factor whose trailing axes do not
    broadcast against the profile raises ValueError instead of
    marginalizing the wrong axis.
    """

    def _particle(self, key, model, guide, args, kwargs):
        guide_tr, replayed = _traces(key, model, guide, args, kwargs)
        # the model with its enumerated sites drawn: only the ndim of each
        # log-prob is read, so no graph is kept
        base_ndim = {}
        with torch.no_grad():
            base_tr = handlers.trace(replayed).get_trace(*args, **kwargs)
            for name, site in base_tr.items():
                lp = _elbo_term(site)
                if lp is not None:
                    base_ndim[name] = lp.ndim
        del base_tr
        model_tr = handlers.trace(
            handlers.enum(replayed)
        ).get_trace(*args, **kwargs)

        # profile = broadcast batch shape of the enumerated sites
        profile = ()
        for site in model_tr.values():
            if site.get("infer", {}).get("_enumerated"):
                profile = tuple(torch.broadcast_shapes(
                    profile, tuple(site["fn"].batch_shape)))

        lps = {}
        for name, site in model_tr.items():
            lp = _elbo_term(site)
            if lp is not None:
                # weighted by the site's scale (handlers.scale) inside the
                # marginalization, as the JAX package weights it
                lps[name] = lp * site["scale"] if "scale" in site else lp
        dep_names = [n for n, lp in lps.items() if lp.ndim > base_ndim[n]]
        total = 0.0
        for n, lp in lps.items():
            if n not in dep_names:
                total = total + lp.sum()
        if dep_names:
            # one base width for every factor, so that each enum prefix
            # sits left of the same number of batch axes
            M = max(base_ndim[n] for n in dep_names)
            dep = None
            for n in dep_names:
                lp, nb = lps[n], base_ndim[n]
                extra = lp.ndim - nb
                # the factor's trailing base axes must broadcast against the
                # profile (equal, or 1 on either side): a positional
                # reduction on a mismatched axis would marginalize the
                # wrong axis and return a wrong ELBO with no error
                for r in range(1, min(nb, len(profile)) + 1):
                    ls, ps = lp.shape[-r], profile[-r]
                    if ls != ps and ls != 1 and ps != 1:
                        raise ValueError(
                            f"enumerated-dependent factor {n!r} has batch "
                            f"shape {tuple(lp.shape[extra:])} whose axis "
                            f"-{r} (size {ls}) is not broadcast-compatible "
                            f"with the enumeration profile {profile} (size "
                            f"{ps}); reshape the factor so its trailing "
                            "axes line up with the enumerated sites' batch "
                            "shape"
                        )
                # sum the base axes the profile does not carry INSIDE the
                # marginalization (keepdim keeps the alignment)
                reduce_axes = tuple(
                    lp.ndim - r for r in range(1, nb + 1)
                    if r > len(profile) or profile[-r] == 1
                )
                if reduce_axes:
                    lp = lp.sum(dim=reduce_axes, keepdim=True)
                lp = lp.reshape(
                    lp.shape[:extra] + (1,) * (M - nb) + lp.shape[extra:]
                )
                dep = lp if dep is None else dep + lp
            n_enum = dep.ndim - M
            total = total + torch.logsumexp(
                dep, dim=tuple(range(n_enum))).sum()
        return -(total - _logp_sum(guide_tr))
