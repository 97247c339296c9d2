"""Sequential Monte Carlo: likelihood-tempered SMC and the variational
bridge.

Port of `velocycle_tpu/infer/smc.py`.  Del Moral-style adaptive tempering:

  1. particles ~ prior (unconstrained space, through the bijections of
     `infer.mcmc`);
  2. the likelihood exponent beta anneals from 0 to 1, each increment
     chosen by bisection so that the effective sample size of the
     incremental weights stays at ``target_ess``;
  3. systematic resampling;
  4. rejuvenation: a few HMC transitions at the current tempered
     posterior.

The particles are ONE batch, (n, dim) tensors, as `infer.mcmc`'s chains
are: each stage's log-likelihood is `torch.func.vmap` of the model over
the particles with gradients disabled, and each HMC leapfrog one batched
value-and-gradient of the tempered potential (`mcmc._batched_value_and_
grad`).  On fused NB data that is ONE chain-batched ``phase_fwd`` (on
velocity data ``velo_fwd``) launch per stage and ONE chain-batched
``phase_fwdgrad`` (``velo_fwdgrad``) launch per leapfrog (`ops.nb_kernels`).  The tempered potential takes prior and likelihood
from ONE trace of the model per evaluation (`mcmc.ModelInfo.log_parts`);
a prior draw stops the model at its last latent site, so no likelihood is
computed for it.
The ESS/beta arithmetic is the JAX package's: float32 weights, bisection
of 30 steps to a width of 1e-4, on the host.

With ``mesh=`` the particles are split over the mesh's particle axis, each
rank holding its `distributed.process_cell_slice` of them and drawing from
their own per-particle generators, so that a world of any size follows the
one-device run.  Per stage: the rank's log-weights in ONE batched call,
an all-gather of them, the next beta, the ESS, the log-evidence increment
and the resampling indices computed identically on every rank from one
identically seeded generator, an all-gather of the particles from which
each rank takes its resampled slice, then the HMC moves on its own.  log Z
comes out bit-identical on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import handlers
from ..parallel.distributed import gather_rows
from ..parallel.mesh import axis_share, refuse_other_axes
from .mcmc import _ChainRNG, _batched_value_and_grad, _hmc_step, init_model

__all__ = ["SMC", "BridgedSMC", "init_tempered_model"]


def _particle_shard(mesh, particle_axis, n):
    """This rank's share of the particles (None without a mesh)."""
    if mesh is None:
        return None
    refuse_other_axes(mesh, particle_axis, "SMC")
    return axis_share(mesh, particle_axis, n)


def _gathered(t, part):
    return t if part is None else gather_rows(t, part.group, part.counts)


class TemperedModel(NamedTuple):
    log_prior_fn: callable     # flat_u -> log p(latents) + log|J| - C_prior
    log_lik_fn: callable       # flat_u -> log p(obs | latents) - C_lik
    unflatten: callable        # flat_u (..., dim) -> {site: constrained}
    sample_prior_u: callable   # seed -> flat_u (one prior draw)
    dim: int
    log_lik_offset: float = 0.0   # C_lik: add back for ABSOLUTE logZ
    log_parts: callable = None    # flat_u -> (log prior, log lik), ONE trace


class _Drawn(Exception):
    """Raised by `_draw_latents` once every latent site has its draw."""


class _draw_latents(handlers.Messenger):
    """Record the draws of the latent sites ``names`` and stop the model at
    the last of them, so that nothing after it runs: on fused NB data the
    likelihood's kernel is not launched for a prior draw."""

    def __init__(self, fn, names):
        super().__init__(fn)
        self.names = set(names)
        self.values = {}

    def postprocess_message(self, msg):
        if (msg["type"] == "sample" and not msg["is_observed"]
                and msg["name"] in self.names):
            self.values[msg["name"]] = msg["value"]
            if len(self.values) == len(self.names):
                raise _Drawn


def init_tempered_model(model, *args, seed=0, **kwargs):
    """Split the model's joint into prior and likelihood parts over a flat
    unconstrained vector (observed sites, conditioned ones included: the
    likelihood; latent sites: the prior, with the bijections' log-dets).

    Built on `mcmc.init_model` at the reference prior draw (the trace
    seeded by ``seed``): both parts are its `ModelInfo.log_parts`, each
    site BASELINED at that draw as in the JAX package, and the
    likelihood's constant, summed in float64 on the host, is its
    ``log_lik_offset``, which `SMC.log_evidence` adds back."""
    info = init_model(model, *args, seed=seed, **kwargs)
    site_meta = info.site_meta

    def log_prior_fn(flat_u):
        return info.log_parts(flat_u, lik=False)[0]

    def log_lik_fn(flat_u):
        return info.log_parts(flat_u, prior=False)[1]

    def sample_prior_u(draw_seed):
        draw = _draw_latents(handlers.seed(model, draw_seed), site_meta)
        with torch.no_grad():
            try:
                draw(*args, **kwargs)
            except _Drawn:
                pass
            return torch.cat([
                c.inverse(torch.as_tensor(draw.values[name]).float()
                          ).reshape(-1)
                for name, (_, _, c) in site_meta.items()])

    return TemperedModel(log_prior_fn, log_lik_fn, info.unflatten,
                         sample_prior_u, int(info.init_u.numel()),
                         info.log_lik_offset, info.log_parts)


def _systematic_resample(u0, log_weights, n):
    """Systematic resampling: indices (n,) from one uniform ``u0`` in [0,
    1).  An index past the last particle (the cumulative weights' float32
    sum short of 1) takes the last one, as the JAX package's gather does."""
    w = torch.softmax(log_weights, 0)
    cum = torch.cumsum(w, 0)
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.clamp(torch.searchsorted(cum, pts), max=n - 1)


def _ess(log_w):
    log_norm = torch.logsumexp(log_w, 0)
    w = torch.exp(log_w - log_norm)
    return 1.0 / torch.sum(w * w)


def _next_beta(beta, loglik, target):
    """The largest beta' <= 1 with ESS((beta' - beta) * loglik) >= target:
    1 where that holds at 1, else bisection from [beta, 1] for at most 30
    steps to a width of 1e-4, in float32 (the JAX package's `next_beta`)."""
    f32 = torch.float32
    loglik = loglik.to(f32)
    beta = torch.tensor(beta, dtype=f32)

    def ess_at(b):
        return float(_ess((b - beta) * loglik))

    one = torch.tensor(1.0, dtype=f32)
    if ess_at(one) >= target:
        return 1.0
    lo, hi = beta, one
    for _ in range(30):
        if not float(hi - lo) > 1e-4:
            break
        mid = 0.5 * (lo + hi)
        if ess_at(mid) >= target:
            lo = mid
        else:
            hi = mid
    return float(lo)


class _Tempering:
    """The stage loop shared by `SMC` and `BridgedSMC`, which give
    ``log_weight(u)``, a particle's log incremental weight per unit of beta
    (the log-likelihood, or the bridge's log ratio), and
    ``potential_at(beta)``, the tempered potential of the rejuvenation
    moves."""

    def __init__(self, num_particles, num_moves, target_ess, hmc_step_size,
                 hmc_leapfrog, max_stages):
        self.num_particles = num_particles
        self.num_moves = num_moves
        self.target_ess = target_ess
        self.hmc_step_size = hmc_step_size
        self.hmc_leapfrog = hmc_leapfrog
        self.max_stages = max_stages
        self._particles = None
        self._log_Z = None
        self._betas = None

    def _anneal(self, particles, seed, what, part=None):
        """Temper ``particles`` (this rank's, under ``part``) to beta=1."""
        n = self.num_particles
        lo, hi = (0, n) if part is None else (part.lo, part.hi)
        rng = _ChainRNG([handlers.fold_in(seed, i) for i in range(lo, hi)],
                        particles.device)
        res_gen = torch.Generator().manual_seed(handlers.fold_in(seed, n))
        beta, log_Z, betas = 0.0, 0.0, []
        for _ in range(self.max_stages):
            particles, beta, inc = self.stage(particles, beta, rng, res_gen,
                                              part)
            log_Z += inc
            betas.append(beta)
            if beta >= 1.0:
                break
        else:
            raise RuntimeError(
                f"{what} did not reach beta=1 in {self.max_stages} stages "
                f"(beta={beta:.4f}); " + (
                    "increase max_stages or target_ess" if what == "SMC" else
                    "the variational start may be poor — more SVI steps, or "
                    "increase max_stages"))
        self._particles = _gathered(particles, part)
        self._log_Z = log_Z
        self._betas = np.asarray(betas)
        return self

    def stage(self, particles, beta, rng, res_gen, part=None):
        """One stage from ``beta``: (particles, the next beta, the log
        evidence increment), drawing from ``rng`` (a `mcmc._ChainRNG` over
        the particles) and ``res_gen`` (the resampling's generator).  Its
        weights are ONE batched evaluation of ``log_weight``, each of its
        leapfrogs ONE batched value-and-gradient of the tempered
        potential.  Under ``part`` the particles are this rank's and the
        weights and particles are gathered from every rank (module
        docstring)."""
        n = self.num_particles
        with torch.no_grad():
            lw = torch.func.vmap(self.log_weight)(particles).float()
        lw = _gathered(lw, part).cpu()
        new_beta = _next_beta(beta, lw, self.target_ess * n)
        log_w = (torch.tensor(new_beta, dtype=torch.float32)
                 - torch.tensor(beta, dtype=torch.float32)) * lw
        inc = float(torch.logsumexp(log_w, 0)) - math.log(n)
        u0 = torch.rand((), generator=res_gen)
        idx = _systematic_resample(u0, log_w, n)
        particles = _gathered(particles, part)[idx.to(particles.device)]
        # rejuvenation: HMC at the new tempered posterior, the gradient
        # carried across the moves
        vg = _batched_value_and_grad(self.potential_at(new_beta))
        inv_mass = torch.clamp(torch.var(particles, 0, correction=0), min=1e-6)
        if part is not None:
            particles = particles[part.lo:part.hi]
        step = torch.full((particles.shape[0],), float(self.hmc_step_size),
                          device=particles.device)
        with torch.no_grad():
            pot, grad = vg(particles)
            for _ in range(self.num_moves):
                particles, _, pot, grad = _hmc_step(
                    vg, particles, rng, step, inv_mass, self.hmc_leapfrog,
                    pot, grad)
        return particles, new_beta, inc

    def _samples(self, unflatten):
        with torch.no_grad():
            out = unflatten(self._particles)
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    @property
    def temperature_schedule(self):
        return self._betas

    @property
    def particles(self):
        """The final particles (n, dim), in the sampler's flat coordinates."""
        return self._particles


class SMC(_Tempering):
    """Adaptive tempered SMC driver.

    Example::

        smc = SMC(model, num_particles=512)
        smc.run(0, data)
        samples = smc.get_samples()        # {site: (num_particles, ...)}
        logZ = smc.log_evidence()
    """

    def __init__(self, model, num_particles=512, num_moves=3,
                 target_ess=0.5, hmc_step_size=0.1, hmc_leapfrog=8,
                 max_stages=50):
        super().__init__(num_particles, num_moves, target_ess, hmc_step_size,
                         hmc_leapfrog, max_stages)
        self.model = model
        self.tempered = None

    def run(self, seed, *args, mesh=None, particle_axis="particles",
            **kwargs):
        """Run the sampler from the integer ``seed``; with ``mesh=`` (a
        `parallel.make_mesh` mesh carrying ``particle_axis``) the particles
        are split over that axis (module docstring)."""
        part = _particle_shard(mesh, particle_axis, self.num_particles)
        tm = init_tempered_model(self.model, *args,
                                 seed=handlers.fold_in(seed, 0), **kwargs)
        self.tempered = tm
        k_prior = handlers.fold_in(seed, 1)
        lo, hi = ((0, self.num_particles) if part is None
                  else (part.lo, part.hi))
        particles = torch.stack([
            tm.sample_prior_u(handlers.fold_in(k_prior, i))
            for i in range(lo, hi)])
        return self._anneal(particles, handlers.fold_in(seed, 2), "SMC", part)

    def log_weight(self, u):
        """The baselined log-likelihood at ``u``."""
        return self.tempered.log_parts(u, prior=False)[1]

    def potential_at(self, beta):
        def pot(u):
            lp, ll = self.tempered.log_parts(u)
            return -(lp + beta * ll)
        return pot

    def get_samples(self):
        return self._samples(self.tempered.unflatten)

    def log_evidence(self):
        """log Z.  The tempered weights used the BASELINED likelihood
        (l - C); over the full 0 -> 1 schedule that under-counts by exactly
        C = ``log_lik_offset``, added back here."""
        return self._log_Z + self.tempered.log_lik_offset


class BridgedSMC(_Tempering):
    """Variational-bridge tempered SMC (annealed importance sampling with
    adaptive tempering and HMC rejuvenation) on a WHITENED `ModelInfo`
    (`mcmc.init_model` + `mcmc.block_precondition`, the geometry NUTS
    uses), tempering from the normalized start N(0, I):

        gamma_beta(v) = N(v; 0, I)^(1-beta) * exp(-pot(v))^beta

    The stage count follows how far the posterior is from its Gaussian
    approximation, not the data size.  log Z = the accumulated increments
    + ``log_offset`` + ``log_det_scale`` (the potential's baseline and the
    whitening's change of variables)."""

    def __init__(self, model_info, num_particles=512, num_moves=3,
                 target_ess=0.5, hmc_step_size=0.25, hmc_leapfrog=8,
                 max_stages=50):
        super().__init__(num_particles, num_moves, target_ess, hmc_step_size,
                         hmc_leapfrog, max_stages)
        self.info = model_info

    def run(self, seed, mesh=None, particle_axis="particles"):
        """Temper from the integer ``seed``; ``mesh`` as `SMC.run`."""
        part = _particle_shard(mesh, particle_axis, self.num_particles)
        init_u = self.info.init_u
        gen = torch.Generator().manual_seed(handlers.fold_in(seed, 0))
        particles = torch.randn((self.num_particles, init_u.shape[0]),
                                generator=gen)
        if part is not None:
            particles = particles[part.lo:part.hi]
        return self._anneal(particles.to(init_u.device),
                            handlers.fold_in(seed, 1), "bridged SMC", part)

    def log_weight(self, v):
        """log [exp(-pot(v)) / N(v; 0, I)]; the N constant matters for
        logZ."""
        norm = 0.5 * v.shape[-1] * math.log(2.0 * math.pi)
        return -self.info.potential_fn(v) + 0.5 * torch.sum(v * v) + norm

    def potential_at(self, beta):
        def tempered_pot(v):
            return ((1.0 - beta) * 0.5 * torch.sum(v * v)
                    + beta * self.info.potential_fn(v))
        return tempered_pot

    def get_samples(self):
        return self._samples(self.info.unflatten)

    def log_evidence(self):
        return self._log_Z + self.info.log_offset + self.info.log_det_scale
