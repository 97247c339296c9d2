"""MCMC inference engines: HMC and NUTS with the chains as one batch.

Port of `velocycle_tpu/infer/mcmc.py`.

  * The model's joint density becomes a **potential function** over a flat
    unconstrained vector, through the effect handlers and
    `constraints.biject_to` (positive -> softplus, unit interval ->
    sigmoid, S^1 -> wrap), with the change-of-variables log-dets added.
  * The JAX package runs each chain as a `vmap` lane of one jitted scan.
    Here the sampler state is (K, dim) tensors, K chains in lockstep: the
    control flow of every transition runs once for the batch, with
    per-chain masks where the JAX scans branch by `where`, and the
    potential's value and gradient are computed for all K chains at once:
    `torch.func.vmap(potential_fn)` over the chains, then one reverse pass
    of autograd (`_batched_value_and_grad`).  On fused NB data that is ONE
    chain-batched kernel launch per leapfrog step
    (`ops.nb_kernels.phase_fwdgrad`, or `velo_fwdgrad` on velocity data,
    over its chain axis).
  * Randomness: one `torch.Generator` per chain (on the host), seeded from
    the caller's integer seed, so chain k's draws do not depend on which
    other chains share its batch: K chains batched give the K single-chain
    runs of the same seeds.
  * NUTS is the iterative multinomial variant (Hoffman & Gelman 2014, with
    multinomial state sampling a la Betancourt 2017) with a static maximum
    tree depth and the checkpoint-stack U-turn checks.  As in the JAX
    package every subtree that is started runs all its leaves, and a chain
    that stopped keeps its state; the depth loop ends early once every
    chain of the batch has stopped, which changes no draw and no statistic.
  * The potential runs its float32 matmuls in full precision (no TF32),
    whatever the caller set: Metropolis energy differences do not survive
    TF32's rounding (the JAX package's ``default_matmul_precision
    ("highest")``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import constraints as C
from ..core import handlers
from ..parallel.distributed import gather_rows
from ..parallel.mesh import axis_share

__all__ = ["init_model", "hmc", "nuts", "MCMC", "effective_sample_size",
           "block_precondition", "cell_sharded"]


@contextlib.contextmanager
def _full_fp32():
    """float32 matmuls in full precision on the card for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _latent_sites(tr):
    """The (name, site) pairs of a trace's sample sites that enter the
    joint density (auxiliary sites excluded)."""
    for name, site in tr.items():
        if site["type"] == "sample" and not site.get("infer", {}).get(
                "is_auxiliary"):
            yield name, site


# ---------------------------------------------------------------------------
# model -> potential function over a flat unconstrained vector
# ---------------------------------------------------------------------------

class ModelInfo(NamedTuple):
    potential_fn: callable        # (flat_u) -> -log p(u) + log_offset
    unflatten: callable           # flat_u (..., dim) -> {site: constrained}
    init_u: torch.Tensor          # a flat init point (dim,)
    site_meta: dict               # {site: (shape, size, constraint)}
    wrap_fn: callable = None      # flat_u -> flat_u with S^1 coords wrapped
    log_offset: float = 0.0       # constant subtracted from -potential (the
    #                               per-element baseline sum; add back when
    #                               an ABSOLUTE log density is needed)
    log_det_scale: float = 0.0    # log |det d(original u)/d(these coords)|
    #                               (block_precondition sets it)
    log_parts: callable = None    # (flat_u, prior=True, lik=True) ->
    #                               (log prior + log|J|, log lik), each less
    #                               its baseline, from ONE trace
    log_lik_offset: float = 0.0   # the observed sites' share of log_offset
    reduce: callable = None       # (values (K,), grads (K, dim)) -> the same
    #                               summed over a cell-sharded group
    #                               (`cell_sharded`); None: local
    cell_sites: tuple = ()        # the latent sites in a "cells" plate


def _split(flat_u, site_meta):
    """Yield (name, u of the site's shape, constraint), with any leading
    batch axes of ``flat_u`` kept."""
    lead = flat_u.shape[:-1]
    i = 0
    for name, (shape, size, constraint) in site_meta.items():
        yield name, flat_u[..., i:i + size].reshape(lead + shape), constraint
        i += size


def init_model(model, *args, seed=0, init_strategy="prior", init_values=None,
               subtract_baseline=True, **kwargs):
    """Trace the model once to discover latent sites, build bijections, and
    return a `ModelInfo` with a flat potential function.

    ``init_values`` maps site names to CONSTRAINED initial values (e.g. a
    converged SVI guide's locs), the recommended warm start for posteriors
    far tighter than the prior.  ``seed`` is the integer root of the prior
    draws of the sites it does not give.

    ``subtract_baseline`` (default True) subtracts each sample site's
    ELEMENTWISE log-prob at the init point, a constant recorded in
    ``log_offset`` (summed in float64 on the host), from the site's
    log-prob before the reduction: the same posterior and gradients, but
    float32 reduction noise in the potential drops by about two orders of
    magnitude (see the JAX package's docstring).  The baseline is a
    site-shaped float32 tensor per observed site: (Ng, Nc) for the plain
    count likelihood, a scalar for the fused path's one ``factor`` site.
    """
    with torch.no_grad():
        tr = handlers.trace(handlers.seed(model, seed)).get_trace(
            *args, **kwargs)

    site_meta = {}
    init_parts = []
    cell_sites = []
    for name, site in _latent_sites(tr):
        if site["is_observed"]:
            continue
        if any(p[0] == "cells" for p in site.get("cond_indep_stack", ())):
            cell_sites.append(name)
        fn = site["fn"]
        if not getattr(fn, "has_rsample", True) and getattr(
            fn, "support", "real"
        ) not in ("real", "positive", "unit_interval", "circular"):
            raise ValueError(f"site {name!r} has unsupported support")
        value = torch.as_tensor(site["value"]).detach().float()
        if init_values is not None and name in init_values:
            value = torch.as_tensor(
                np.asarray(init_values[name]) if not isinstance(
                    init_values[name], torch.Tensor) else init_values[name],
                dtype=torch.float32, device=value.device,
            ).reshape(value.shape)
        constraint = C.biject_to(getattr(fn, "support", "real"))
        site_meta[name] = (tuple(value.shape), int(value.numel()), constraint)
        u0 = constraint.inverse(value)
        if init_strategy == "zero" and (
            init_values is None or name not in init_values
        ):
            u0 = torch.zeros_like(u0)
        init_parts.append(u0.reshape(-1))
    init_u = (torch.cat(init_parts) if init_parts
              else torch.zeros((0,)))

    def unflatten(flat_u):
        return {name: c.forward(u) for name, u, c in _split(flat_u, site_meta)}

    circular_mask = torch.cat([
        torch.full((size,), c.name == "circular", device=init_u.device)
        for shape, size, c in site_meta.values()
    ]) if site_meta else torch.zeros((0,), dtype=torch.bool)

    def wrap_fn(flat_u):
        """Wrap circular coordinates back into [-pi, pi): a measure-
        preserving move for periodic potentials that keeps warmup variance
        estimates finite when chains drift across period copies."""
        wrapped = torch.remainder(flat_u + math.pi, 2.0 * math.pi) - math.pi
        return torch.where(circular_mask, wrapped, flat_u)

    # -- per-element baselines at the init point (see docstring) ----------
    # Traced with the flat point requiring grad, which marks the sites whose
    # log-prob does not depend on it (conditioned sites with constant
    # parameters): minus their baselines they are exactly zero at every
    # point, so the potential skips them.
    baselines = {}
    constant = set()
    log_offset = log_lik_offset = 0.0
    if subtract_baseline:
        with torch.enable_grad(), _full_fp32():
            values0 = unflatten(init_u.detach().requires_grad_(True))
            sub0 = handlers.substitute(model, data=values0)
            tr0 = handlers.trace(handlers.seed(sub0, 0)).get_trace(
                *args, **kwargs)
            for name, site in _latent_sites(tr0):
                lp0 = site["fn"].log_prob(site["value"])
                if not lp0.requires_grad:
                    constant.add(name)
                lp0 = lp0.detach()
                baselines[name] = lp0
                # exact constant, accumulated in f64 on the host
                c0 = float(np.sum(lp0.cpu().numpy().astype(np.float64)))
                log_offset += c0
                if site["is_observed"]:
                    log_lik_offset += c0
    # constraints whose log-det is identically zero (real, circular)
    zero_det = {name for name, (_, _, c) in site_meta.items()
                if type(c).log_abs_det_jacobian is C.Constraint.log_abs_det_jacobian}

    def terms(flat_u, prior, lik):
        """(the latent sites' log-prob, the observed sites', log|J|) at
        ``flat_u``, each site less its baseline, from ONE trace of the
        model; a part not asked for is 0 and its terms are not computed."""
        with _full_fp32():
            values = {}
            log_det = 0.0
            for name, u, constraint in _split(flat_u, site_meta):
                values[name] = constraint.forward(u)
                if prior and name not in zero_det:
                    log_det = log_det + constraint.log_abs_det_jacobian(
                        u).sum()
            sub = handlers.substitute(model, data=values)
            tr = handlers.trace(handlers.seed(sub, 0)).get_trace(
                *args, **kwargs)
            lat = obs = 0.0
            for name, site in _latent_sites(tr):
                observed = site["is_observed"]
                if name in constant or not (lik if observed else prior):
                    continue
                lp = site["fn"].log_prob(site["value"])
                b = baselines.get(name)
                if b is not None:
                    lp = lp - b  # same trace, same shapes by construction
                if observed:
                    obs = obs + lp.sum()
                else:
                    lat = lat + lp.sum()
            return lat, obs, log_det

    def log_parts(flat_u, prior=True, lik=True):
        """(log prior + log|J|, log lik) at ``flat_u`` from ONE trace."""
        lat, obs, log_det = terms(flat_u, prior, lik)
        return lat + log_det, obs

    def potential_fn(flat_u):
        lat, obs, log_det = terms(flat_u, True, True)
        return -((lat + obs) + log_det)

    return ModelInfo(potential_fn, unflatten, init_u, site_meta, wrap_fn,
                     log_offset, 0.0, log_parts, log_lik_offset,
                     cell_sites=tuple(cell_sites))


def block_precondition(info: ModelInfo, blocks):
    """Whiten a `ModelInfo` with a per-site linear preconditioner.

    ``blocks`` maps site names to either a per-coordinate variance vector
    (diagonal scaling) or an SPD covariance of shape ``(B, k, k)`` for a
    site of shape ``(B, k)``.  The returned ModelInfo's coordinates are
    ``v`` with ``u = L v`` + the original init, where ``L`` is the (block)
    Cholesky factor: the whitened posterior is near-isotropic.

    Circular (wrapped) coordinates must not be block-preconditioned:
    wrapping is only measure-preserving under a per-coordinate scaling.
    """
    dev = info.init_u.device
    mats = {}
    log_det_scale = 0.0
    for name, (shape, size, constraint) in info.site_meta.items():
        if name not in blocks:
            continue
        b = blocks[name]
        b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                       np.float64)
        if b.ndim == 3 and b.shape[-1] == b.shape[-2]:
            if constraint.name == "circular":
                raise ValueError(
                    f"site {name!r} is circular; only DIAGONAL "
                    "preconditioning is valid for wrapped coordinates (pass "
                    "a variance vector, not covariance blocks: wrapping is "
                    "only measure-preserving under a per-coordinate scaling)"
                )
            L = np.linalg.cholesky(b + 1e-12 * np.eye(b.shape[-1]))
            log_det_scale += float(
                np.sum(np.log(np.diagonal(L, axis1=-2, axis2=-1))))
            mats[name] = ("block", torch.as_tensor(L, dtype=torch.float32,
                                                   device=dev))
        else:
            d = np.sqrt(b).reshape(-1)
            log_det_scale += float(np.sum(np.log(d)))
            mats[name] = ("diag", torch.as_tensor(d, dtype=torch.float32,
                                                  device=dev))

    def transform(v):
        """whitened flat v (..., dim) -> original flat u (around the init
        point)."""
        lead = v.shape[:-1]
        parts = []
        i = 0
        for name, (shape, size, _) in info.site_meta.items():
            vs = v[..., i:i + size]
            kind = mats.get(name)
            if kind is None:
                parts.append(vs)
            elif kind[0] == "diag":
                parts.append(kind[1] * vs)
            else:
                L = kind[1]
                B, k = L.shape[0], L.shape[1]
                parts.append(torch.einsum(
                    "bij,...bj->...bi", L, vs.reshape(lead + (B, k))
                ).reshape(lead + (size,)))
            i += size
        return torch.cat(parts, -1) + info.init_u

    # circular coords keep their (diagonal) scale for wrapping
    scales = torch.cat([
        mats[name][1] if name in mats and mats[name][0] == "diag"
        else torch.ones((size,), device=dev)
        for name, (shape, size, _) in info.site_meta.items()
    ])
    circ = torch.cat([
        torch.full((size,), c.name == "circular", device=dev)
        for shape, size, c in info.site_meta.values()
    ])
    init_off = info.init_u

    def wrap_fn(v):
        u = scales * v + init_off
        wrapped = torch.remainder(u + math.pi, 2.0 * math.pi) - math.pi
        v_wrapped = (wrapped - init_off) / scales
        return torch.where(circ, v_wrapped, v)

    has_circ = bool(circ.any())
    return ModelInfo(
        potential_fn=lambda v: info.potential_fn(transform(v)),
        unflatten=lambda v: info.unflatten(transform(v)),
        init_u=torch.zeros_like(info.init_u),
        site_meta=info.site_meta,
        wrap_fn=wrap_fn if has_circ else None,
        log_offset=info.log_offset,
        log_det_scale=info.log_det_scale + log_det_scale,
        log_parts=lambda v, **kw: info.log_parts(transform(v), **kw),
        log_lik_offset=info.log_lik_offset,
        reduce=info.reduce,
        cell_sites=info.cell_sites,
    )


def cell_sharded(info: ModelInfo, group):
    """A `ModelInfo` built on this rank's cells (cell-sharded data) as one
    term of the potential summed over the cell axis' process ``group``:
    the latent sites' log-prior and the log-dets on the group's rank 0
    only, the observed sites' terms on every rank, and every batched
    value-and-gradient all-reduced over the group in one flat buffer
    (``reduce``), so that every member holds the same bits and the
    members' chains run in lockstep.  ``log_offset`` and
    ``log_lik_offset`` become the group's sums and ``init_u`` rank 0's.
    The chain state must be the same on every member: a latent site in
    the ``"cells"`` plate (phi_xy, phi) is refused with a ValueError; it
    must be conditioned on the rank's cells."""
    import torch.distributed as dist

    from ..parallel import distributed

    if info.log_det_scale:
        raise ValueError("cell_sharded takes the ModelInfo of init_model, "
                         "before block_precondition")
    if info.cell_sites:
        raise ValueError(
            f"cell-sharded sampling needs one chain state on every rank, but "
            f"the latent sites {list(info.cell_sites)} lie in the 'cells' "
            "plate: condition them (phi_xy, phi) on this rank's cells so "
            "that the chains carry gene-global sites only")
    rank0 = dist.get_rank(group) == 0
    offsets = torch.tensor(
        [info.log_offset if rank0 else info.log_lik_offset,
         info.log_lik_offset], dtype=torch.float64,
        device=distributed.group_device(group))
    dist.all_reduce(offsets, group=group)
    init_u = info.init_u.detach().clone()
    dist.broadcast(init_u, src=distributed.group_src(group), group=group)
    base_parts = info.log_parts

    def log_parts(u, prior=True, lik=True):
        return base_parts(u, prior=prior and rank0, lik=lik)

    def potential_fn(u):
        lp, ll = log_parts(u)
        return -(lp + ll)

    def reduce(value, grad):
        flat = torch.cat([value.reshape(-1), grad.reshape(-1)])
        dist.all_reduce(flat, group=group)
        return flat[:value.numel()].view_as(value), \
            flat[value.numel():].view_as(grad)

    return info._replace(
        potential_fn=potential_fn if not rank0 else info.potential_fn,
        log_parts=log_parts, init_u=init_u,
        log_offset=float(offsets[0]), log_lik_offset=float(offsets[1]),
        reduce=reduce)


def _batched_value_and_grad(potential_fn):
    """(K, dim) -> (potential (K,), gradient (K, dim)) for K chains in one
    call: `potential_fn` mapped over the chains by `torch.func.vmap`, and
    its gradient by one reverse pass of autograd over the batch (the
    chains are independent, so the gradient of the sum is each chain's
    gradient; measured here about 1.4x faster than `torch.func.grad`
    inside the vmap, with the same numbers)."""
    batched = torch.func.vmap(potential_fn)

    def value_and_grad(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            value = batched(q)
            (grad,) = torch.autograd.grad(value.sum(), q)
        return value.detach(), grad

    return value_and_grad


# ---------------------------------------------------------------------------
# per-chain randomness
# ---------------------------------------------------------------------------

class _ChainRNG:
    """One host `torch.Generator` per chain; every draw is a (K, n) tensor
    on ``device``, row k from chain k's generator."""

    def __init__(self, seeds, device):
        self.gens = []
        for s in seeds:
            g = torch.Generator()
            g.manual_seed(int(s))
            self.gens.append(g)
        self.device = device

    def normal(self, n):
        return torch.stack([torch.randn(n, generator=g) for g in self.gens]
                           ).to(self.device)

    def uniform(self, n):
        return torch.stack([torch.rand(n, generator=g) for g in self.gens]
                           ).to(self.device)


# ---------------------------------------------------------------------------
# leapfrog + dual averaging
# ---------------------------------------------------------------------------

def _leapfrog(potential_vg, q, p, pot, grad, step_size, inv_mass, n_steps):
    """``n_steps`` leapfrog steps under a diagonal mass matrix, for K chains:
    q, p, grad and inv_mass (K, dim), pot and step_size (K,).  The gradient
    at the current position is carried, so each step costs exactly ONE
    batched value-and-gradient evaluation."""
    half = 0.5 * step_size[:, None]
    eps_im = step_size[:, None] * inv_mass
    for _ in range(n_steps):
        p = torch.addcmul(p, half, grad, value=-1.0)
        q = torch.addcmul(q, eps_im, p)
        pot, grad = potential_vg(q)
        p = torch.addcmul(p, half, grad, value=-1.0)
    return q, p, pot, grad


class DAState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def _da_init(step_size):
    log_step = torch.log(step_size)
    z = torch.zeros_like(log_step)
    return DAState(log_step, z, z, math.log(10.0) + log_step, z)


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75):
    # a NaN accept stat (from a divergent transition) must not poison the
    # averages: treat it as a full rejection
    accept_prob = torch.where(torch.isfinite(accept_prob), accept_prob,
                              torch.zeros_like(accept_prob))
    t = state.t + 1.0
    h_sum = state.h_sum + (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * h_sum / (t + t0)
    # keep the step within sane bounds (an unlucky warmup must not drive it
    # to numerical zero and freeze the chain)
    log_step_c = torch.clamp(log_step, math.log(1e-5), math.log(1e2))
    # anti-windup: while the clip binds, cap the integral error at the
    # value consistent with the bound, so a run of high accepts lifts a
    # chain off the floor in ~20 steps
    h_sum = torch.where(
        log_step_c == log_step, h_sum,
        gamma * (state.mu - log_step_c) * (t + t0) / torch.sqrt(t),
    )
    eta = t ** (-kappa)
    log_step_avg = eta * log_step_c + (1 - eta) * state.log_step_avg
    return DAState(log_step_c, log_step_avg, h_sum, state.mu, t)


def _da_where(mask, new, old):
    return DAState(*(torch.where(mask, a, b) for a, b in zip(new, old)))


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------

def _kinetic(p, inv_mass):
    return 0.5 * torch.linalg.vecdot(p, p * inv_mass)


def _rows(mask, a, b):
    """Per-chain select: rows of ``a`` where ``mask`` (K,), else of ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _hmc_step(potential_vg, q, rng, step_size, inv_mass, num_leapfrog, pot,
              grad):
    """One HMC transition of K chains from (q, pot, grad).  Returns (q,
    accept_prob, pot, grad)."""
    z = rng.normal(q.shape[-1])
    u_acc = rng.uniform(1)[:, 0]
    p = z / torch.sqrt(inv_mass)
    energy0 = pot + _kinetic(p, inv_mass)
    q_new, p_new, pot_new, grad_new = _leapfrog(
        potential_vg, q, p, pot, grad, step_size, inv_mass, num_leapfrog
    )
    energy1 = pot_new + _kinetic(p_new, inv_mass)
    delta = energy0 - energy1
    delta = torch.where(
        torch.isfinite(delta) & torch.isfinite(q_new.sum(-1)), delta,
        torch.full_like(delta, -math.inf),
    )
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = u_acc < accept_prob
    return (_rows(accept, q_new, q), accept_prob,
            torch.where(accept, pot_new, pot), _rows(accept, grad_new, grad))


# ---------------------------------------------------------------------------
# NUTS (iterative, multinomial, static max depth)
# ---------------------------------------------------------------------------

def _popcount(i, nbits=16):
    return sum(((i >> k) & 1) for k in range(nbits))


def _trailing_zeros(i, nbits=16):
    """Trailing zeros of a positive int."""
    tz = 0
    while tz < nbits and not (i >> tz) & 1:
        tz += 1
    return tz


def _nuts_step(potential_vg, q0, rng, step_size, inv_mass, max_depth=8,
               max_delta_energy=1000.0, pot0=None, grad0=None):
    """One NUTS transition of K chains in lockstep: iterative multinomial
    NUTS (Hoffman & Gelman 2014; multinomial state selection and the
    generalized momentum-sum U-turn criterion per Betancourt 2017), with
    per-subtree U-turn checks done iteratively via a checkpoint stack.

    Within a new subtree of 2^depth leaves, leaf j (0-based, in build
    order) pushes (momentum r_j, prefix momentum sum before j) into
    checkpoint slot popcount(j) when j is even; at odd leaf b every
    complete binary subtree ending at b (spans [b+1-2^k, b] for k = 1 ..
    tz(b+1)) is checked against slots [popcount(m'-1), popcount(m'-1)+K-1]
    (b+1 = m' * 2^K).  Criterion per span with momentum sum R: turning iff
    R.(M^-1 r_start) < 0 or R.(M^-1 r_end) < 0.  The leaf index is the
    same for every chain, so the slot arithmetic is on Python ints.

    Each chain draws, per transition, its momentum and one block of
    uniforms: max_depth directions, max_depth subtree merges and the 2^
    max_depth - 1 leaves' multinomial choices.
    """
    K, dim = q0.shape
    if pot0 is None or grad0 is None:
        pot0, grad0 = potential_vg(q0)
    z = rng.normal(dim)
    u = rng.uniform(2 * max_depth + 2 ** max_depth - 1)
    log_u = torch.log(u)
    p0 = z / torch.sqrt(inv_mass)
    energy0 = pot0 + _kinetic(p0, inv_mass)
    n_slots = max_depth + 1

    def turning_at(R, pm_a, pm_b):
        """turning iff R.(M^-1 r_a) < 0 or R.(M^-1 r_b) < 0, given M^-1 r."""
        return ((torch.linalg.vecdot(R, pm_a) < 0)
                | (torch.linalg.vecdot(R, pm_b) < 0))

    false = torch.zeros(K, dtype=torch.bool, device=q0.device)
    q_minus = q_plus = q_prop = q0
    p_minus = p_plus = p0
    g_minus = g_plus = g_prop = grad0
    pot_prop = pot0
    log_weight = torch.zeros_like(pot0)    # root: exp(-(E0 - E0)) = 1
    sum_p = p0
    turning = diverging = false
    sum_accept = torch.zeros_like(pot0)
    n_steps = torch.ones_like(pot0)
    leaf = 2 * max_depth
    for depth in range(max_depth):
        stopped = turning | diverging
        if bool(stopped.all()):
            break                       # every chain frozen: nothing changes
        forward = u[:, depth] < 0.5
        eps = torch.where(forward, 1.0, -1.0)[:, None] * step_size[:, None]
        half = 0.5 * eps
        eps_im = eps * inv_mass
        n_new = 2 ** depth

        q = _rows(forward, q_plus, q_minus)
        p = _rows(forward, p_plus, p_minus)
        g = _rows(forward, g_plus, g_minus)
        log_w = torch.full_like(pot0, -math.inf)
        q_prop_new, pot_prop_new, g_prop_new = q, torch.zeros_like(pot0), g
        S = torch.zeros_like(q0)
        # checkpoints of M^-1 r (the U-turn checks' only use of r) and of
        # the momentum prefix sums
        ckpt_pm = torch.zeros((K, n_slots, dim), device=q0.device)
        ckpt_S = torch.zeros((K, n_slots, dim), device=q0.device)
        sub_turning = false
        div = diverging
        sum_acc = torch.zeros_like(pot0)
        for i in range(n_new):
            p = torch.addcmul(p, half, g, value=-1.0)
            q = torch.addcmul(q, eps_im, p)
            pot, g = potential_vg(q)
            p = torch.addcmul(p, half, g, value=-1.0)
            pm = p * inv_mass
            delta = torch.add(pot, torch.linalg.vecdot(p, pm), alpha=0.5) - energy0
            div = div | ~(torch.isfinite(delta) & (delta <= max_delta_energy))
            log_w_i = torch.neg(delta).masked_fill_(div, -math.inf)
            # min(1, exp(-delta)), and 0 where divergent
            sum_acc = sum_acc + torch.exp(torch.clamp(log_w_i, max=0.0))
            # multinomial within the subtree (a divergent leaf, log weight
            # -inf, is never taken)
            log_w_tot = torch.logaddexp(log_w, log_w_i)
            keep_new = log_u[:, leaf] < (log_w_i - log_w_tot)
            leaf += 1
            q_prop_new = _rows(keep_new, q, q_prop_new)
            pot_prop_new = torch.where(keep_new, pot, pot_prop_new)
            g_prop_new = _rows(keep_new, g, g_prop_new)
            log_w = log_w_tot

            if i % 2 == 0:
                # checkpoint push (prefix sum BEFORE this leaf)
                slot = _popcount(i)
                ckpt_pm[:, slot] = pm
                ckpt_S[:, slot] = S
                S = S + p
            else:
                S = S + p
                # U-turn checks of all complete subtrees ending here, slots
                # idx_min .. idx_min + tz - 1 at once
                tz = _trailing_zeros(i + 1)
                lo = _popcount(((i + 1) >> tz) - 1)
                R = S[:, None] - ckpt_S[:, lo:lo + tz]
                sub_turning = sub_turning | turning_at(
                    R, ckpt_pm[:, lo:lo + tz], pm[:, None]).any(-1)

        # trajectory ends
        q_minus_n = _rows(forward, q_minus, q)
        p_minus_n = _rows(forward, p_minus, p)
        g_minus_n = _rows(forward, g_minus, g)
        q_plus_n = _rows(forward, q, q_plus)
        p_plus_n = _rows(forward, p, p_plus)
        g_plus_n = _rows(forward, g, g_plus)

        # biased-progressive multinomial merge: take the new subtree's
        # proposal with prob min(1, w_new / w_old)
        log_w_tot = torch.logaddexp(log_weight, log_w)
        keep_new = (log_u[:, max_depth + depth] < (log_w - log_weight)) & ~div
        q_prop_m = _rows(keep_new, q_prop_new, q_prop)
        pot_prop_m = torch.where(keep_new, pot_prop_new, pot_prop)
        g_prop_m = _rows(keep_new, g_prop_new, g_prop)

        # full-trajectory U-turn (generalized momentum-sum criterion)
        sum_p_n = sum_p + S
        traj_turning = turning_at(sum_p_n, inv_mass * p_minus_n,
                                  inv_mass * p_plus_n)
        invalid = sub_turning | traj_turning | div
        # a turning/diverging subtree's proposal is rejected, and a chain
        # that had stopped keeps everything
        live = ~stopped
        take = live & ~invalid
        q_minus = _rows(live, q_minus_n, q_minus)
        p_minus = _rows(live, p_minus_n, p_minus)
        g_minus = _rows(live, g_minus_n, g_minus)
        q_plus = _rows(live, q_plus_n, q_plus)
        p_plus = _rows(live, p_plus_n, p_plus)
        g_plus = _rows(live, g_plus_n, g_plus)
        q_prop = _rows(take, q_prop_m, q_prop)
        pot_prop = torch.where(take, pot_prop_m, pot_prop)
        g_prop = _rows(take, g_prop_m, g_prop)
        log_weight = torch.where(take, log_w_tot, log_weight)
        sum_p = _rows(live, sum_p_n, sum_p)
        turning = torch.where(live, turning | invalid, turning)
        diverging = torch.where(live, div, diverging)
        sum_accept = torch.where(live, sum_accept + sum_acc, sum_accept)
        n_steps = torch.where(live, n_steps + n_new, n_steps)

    accept_prob = sum_accept / torch.clamp(n_steps - 1.0, min=1.0)
    return q_prop, accept_prob, pot_prop, g_prop


# ---------------------------------------------------------------------------
# warmup + sampling drivers
# ---------------------------------------------------------------------------

def _warmup_and_sample(step_fn, potential_vg, q0, rng, num_warmup,
                       num_samples, step_size, adapt_mass, wrap_fn=None,
                       inv_mass0=None, q_safe=None):
    """Generic driver over K chains (q0 (K, dim)): dual-averaging warmup
    (with a diagonal mass estimate from the middle window), then sampling.

    The three Stan-style warmup windows, (1) step size only, (2) step size
    + variance collection, (3) re-adapt the step size under the NEW mass,
    and the sampling phase run in ONE loop; window transitions are
    step-index comparisons, as in the JAX package's one scan.

    ``step_fn(q, rng, eps, inv_mass, pot, grad)`` returns ``(q',
    accept_prob, pot', grad')`` (cached-gradient chaining: exactly one
    value-and-gradient evaluation per leapfrog across the whole chain).

    Returns (samples (K, num_samples, dim), accept_probs (K, num_samples),
    final_step (K,), inv_mass (K, dim)).
    """
    K, dim = q0.shape
    dev = q0.device
    if inv_mass0 is None:
        inv_mass0 = torch.ones((dim,), device=dev)
    inv_mass0 = inv_mass0.expand(K, dim)
    if wrap_fn is None:
        wrap_fn = lambda q: q  # noqa: E731

    # window boundaries (Python ints)
    n1 = max(num_warmup * 2 // 5, 1)
    n2 = max(num_warmup * 2 // 5, 1)
    n3 = max(num_warmup - n1 - n2, 1)
    warm_end = n1 + n2 + n3
    total = warm_end + num_samples

    pot, grad = potential_vg(q0)
    if q_safe is None:
        q_safe, pot_safe, grad_safe = q0, pot, grad
    else:
        q_safe = q_safe.expand(K, dim)
        pot_safe, grad_safe = potential_vg(q_safe)

    step0 = torch.full((K,), float(step_size), device=dev)
    q = q0
    da = _da_init(step0)
    inv_mass = inv_mass0
    w_mean = torch.zeros((K, dim), device=dev)
    w_m2 = torch.zeros((K, dim), device=dev)
    count = 0
    samples = torch.empty((K, num_samples, dim), device=dev)
    accepts = torch.empty((K, num_samples), device=dev)
    for i in range(total):
        # -- window-2 -> window-3 boundary: switch the metric, reset DA ----
        if i == n1 + n2 and adapt_mass:
            var = w_m2 / max(count - 1.0, 1.0)
            # Stan-style shrinkage toward a small diagonal
            var = (count / (count + 5.0)) * var + 1e-3 * (5.0 / (count + 5.0))
            var = torch.where(torch.isfinite(var) & (var > 0), var,
                              torch.ones_like(var))
            # frozen-chain guard: a metric that shrinks the typical
            # coordinate by >1e4x relative to the one the chain sampled
            # under is never evidence, only freeze: keep the old one
            switch = torch.quantile(
                var / torch.clamp(inv_mass, min=1e-30), 0.5, dim=-1) > 1e-4
            inv_mass = _rows(switch, var, inv_mass)
            da = _da_where(switch, _da_init(torch.exp(da.log_step_avg)), da)

        # -- warmup rescue: a chain whose step size fell >150x below its
        # initial value (an init on a numerical cliff) restarts from the
        # known-good init with fresh DA state and metric; warmup draws are
        # discarded, so this is free of detailed-balance concerns
        if i in (n1, n1 + n2):
            stuck = da.log_step < math.log(step_size) - 5.0
            q = _rows(stuck, q_safe, q)
            pot = torch.where(stuck, pot_safe, pot)
            grad = _rows(stuck, grad_safe, grad)
            inv_mass = _rows(stuck, inv_mass0, inv_mass)
            da = _da_where(stuck, _da_init(step0), da)

        in_warmup = i < warm_end
        eps = torch.exp(da.log_step if in_warmup else da.log_step_avg)
        q_new, accept_prob, pot_new, grad_new = step_fn(
            q, rng, eps, inv_mass, pot, grad)
        # reject non-finite states outright: NaN must never become an
        # absorbing state of the chain
        ok = torch.isfinite(q_new).all(-1)
        q = _rows(ok, q_new, q)
        pot = torch.where(ok, pot_new, pot)
        grad = _rows(ok, grad_new, grad)
        # wrapping is a period shift on circular coords: the (periodic)
        # potential and its gradient are unchanged, so pot/grad stay valid
        q = wrap_fn(q)

        if in_warmup:
            da = _da_update(da, accept_prob)
        else:
            samples[:, i - warm_end] = q
            accepts[:, i - warm_end] = accept_prob

        # Welford accumulation for the mass matrix, window 2 only
        if n1 <= i < n1 + n2:
            count += 1
            delta = q - w_mean
            w_mean = w_mean + delta / count
            w_m2 = w_m2 + delta * (q - w_mean)

    return samples, accepts, torch.exp(da.log_step_avg), inv_mass


def _chains(model_info, seeds):
    """(K, dim) init, the chains' RNG and the batched value-and-gradient of
    one sampler call; a single int seed is one chain."""
    single = isinstance(seeds, (int, np.integer))
    seeds = [int(seeds)] if single else [int(s) for s in seeds]
    q0 = model_info.init_u
    if q0.dim() == 1:
        q0 = q0.expand(len(seeds), -1)
    if q0.shape[0] != len(seeds):
        raise ValueError(f"{q0.shape[0]} init points for {len(seeds)} seeds")
    rng = _ChainRNG(seeds, q0.device)
    vg = _batched_value_and_grad(model_info.potential_fn)
    if model_info.reduce is not None:
        local_vg, reduce = vg, model_info.reduce

        def vg(q):
            return reduce(*local_vg(q))
    return single, q0.contiguous(), rng, vg


def _unbatch(single, out):
    return tuple(t[0] for t in out) if single else out


def hmc(model_info: ModelInfo, seeds, num_warmup=500, num_samples=500,
        step_size=0.1, num_leapfrog=16, adapt_mass=True, inv_mass0=None,
        q_safe=None):
    """HMC on a `ModelInfo`: one chain per seed in ``seeds`` (an int: one
    chain, and the results carry no chain axis), from ``model_info.init_u``
    ((dim,) shared, or (K, dim))."""
    single, q0, rng, vg = _chains(model_info, seeds)

    def step_fn(q, rng, eps, inv_mass, pot, grad):
        return _hmc_step(vg, q, rng, eps, inv_mass, num_leapfrog, pot, grad)

    with torch.no_grad():
        return _unbatch(single, _warmup_and_sample(
            step_fn, vg, q0, rng, num_warmup, num_samples, step_size,
            adapt_mass, model_info.wrap_fn, inv_mass0, q_safe))


def nuts(model_info: ModelInfo, seeds, num_warmup=500, num_samples=500,
         step_size=0.1, max_depth=8, adapt_mass=True, inv_mass0=None,
         q_safe=None):
    """NUTS on a `ModelInfo`: one chain per seed in ``seeds`` (an int: one
    chain, and the results carry no chain axis), from ``model_info.init_u``
    ((dim,) shared, or (K, dim))."""
    single, q0, rng, vg = _chains(model_info, seeds)

    def step_fn(q, rng, eps, inv_mass, pot, grad):
        return _nuts_step(vg, q, rng, eps, inv_mass, max_depth, pot0=pot,
                          grad0=grad)

    with torch.no_grad():
        return _unbatch(single, _warmup_and_sample(
            step_fn, vg, q0, rng, num_warmup, num_samples, step_size,
            adapt_mass, model_info.wrap_fn, inv_mass0, q_safe))


# ---------------------------------------------------------------------------
# user-facing driver
# ---------------------------------------------------------------------------

def _leaves(tree):
    """The leaves of nested dicts, lists and tuples (anything else is a
    leaf), in order: what `MCMC.run` compares by identity."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class MCMC:
    """Multi-chain MCMC driver: the chains run as one batch.

    Example::

        mcmc = MCMC(model, kernel="nuts", num_warmup=500, num_samples=500,
                    num_chains=4)
        mcmc.run(0, data)
        samples = mcmc.get_samples()          # {site: (chains*samples, ...)}
    """

    def __init__(self, model, kernel="nuts", num_warmup=500,
                 num_samples=500, num_chains=1, step_size=0.1,
                 num_leapfrog=16, max_depth=8, adapt_mass=True,
                 init_jitter=1.0, init_values=None, inv_mass=None,
                 preconditioner=None):
        """``init_values``: {site: constrained value} warm start (e.g. SVI
        guide locs), see `init_model`; pair it with a small ``init_jitter``
        (the jitter is in unconstrained space).

        ``inv_mass``: {site: per-coordinate variance in UNCONSTRAINED
        space}, the initial diagonal metric; sites not in the dict get 1.0.
        With ``adapt_mass=True`` window-2 adaptation refines it.

        ``preconditioner``: {site: covariance} linear whitening, per-site
        variance vectors or per-block (B, k, k) SPD covariances, see
        `block_precondition`.  ``init_jitter`` then acts in whitened
        coordinates, i.e. in units of approximate posterior sds."""
        self.model = model
        self.init_values = init_values
        self.inv_mass = inv_mass
        self.preconditioner = preconditioner
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.step_size = step_size
        self.num_leapfrog = num_leapfrog
        self.max_depth = max_depth
        self.adapt_mass = adapt_mass
        self.init_jitter = init_jitter
        self._samples_u = None
        self._accepts = None
        self.model_info = None
        self._built = None
        self._built_args = None

    def run(self, seed, *args, mesh=None, chain_axis="chains", **kwargs):
        """Run the chains from the integer ``seed``.

        With ``mesh=`` (a `parallel.make_mesh` mesh carrying ``chain_axis``)
        this rank runs its `distributed.process_cell_slice` of the chains,
        the same chain seeds as one device runs, as one batch; the chains
        are independent, so no collective runs until the end, when every
        rank gathers all chains' draws and accepts.  A ``"cells"`` axis of
        more than one rank (the model's data that rank's shard, its
        per-cell sites conditioned) makes each batched value-and-gradient
        a sum over the cell group (`cell_sharded`), identical on every
        member.

        Repeated ``run`` calls with the SAME ``*args``/``**kwargs`` objects
        reuse the built potential (its baselines and bijections); passing
        different argument objects rebuilds it.
        """
        chains, cells = _mesh_groups(mesh, chain_axis)
        k_init = handlers.fold_in(seed, 0)
        k_run = handlers.fold_in(seed, 1)
        flat_args = _leaves((args, kwargs, self.init_values, self.inv_mass,
                             self.preconditioner))
        reusable = (
            self._built is not None
            and len(flat_args) == len(self._built_args)
            and all(a is b for a, b in zip(flat_args, self._built_args))
        )
        if not reusable:
            info = init_model(self.model, *args, seed=k_init,
                              init_values=self.init_values, **kwargs)
            if cells is not None:
                info = cell_sharded(info, cells)
            if self.preconditioner is not None:
                info = block_precondition(info, self.preconditioner)
            inv_mass0 = None
            jitter_scale = 1.0
            if self.inv_mass is not None:
                parts = []
                for name, (shape, size, _) in info.site_meta.items():
                    v = self.inv_mass.get(name)
                    parts.append(
                        torch.ones((size,)) if v is None
                        else torch.as_tensor(np.asarray(v), dtype=torch.float32
                                             ).reshape(-1))
                inv_mass0 = torch.cat(parts).to(info.init_u.device)
                # jitter scaled by the preconditioner: over-dispersed
                # starts relative to the (approximate) posterior
                jitter_scale = torch.sqrt(inv_mass0)
            self.model_info = info
            self._built = (inv_mass0, jitter_scale)
            self._built_args = flat_args
        info = self.model_info
        inv_mass0, jitter_scale = self._built

        chain_seeds = [handlers.fold_in(k_run, c)
                       for c in range(self.num_chains)]
        share = None
        if chains:
            share = axis_share(mesh, chain_axis, self.num_chains)
            chain_seeds = chain_seeds[share.lo:share.hi]
        dim = info.init_u.shape[0]
        jitter = torch.stack([
            torch.randn(dim, generator=torch.Generator().manual_seed(
                handlers.fold_in(s, 0)))
            for s in chain_seeds
        ]).to(info.init_u.device)
        q0 = info.init_u + self.init_jitter * jitter_scale * jitter
        chain_info = info._replace(init_u=q0)
        seeds = [handlers.fold_in(s, 1) for s in chain_seeds]
        if self.kernel == "nuts":
            out = nuts(chain_info, seeds, self.num_warmup, self.num_samples,
                       self.step_size, self.max_depth, self.adapt_mass,
                       inv_mass0, q_safe=info.init_u)
        else:
            out = hmc(chain_info, seeds, self.num_warmup, self.num_samples,
                      self.step_size, self.num_leapfrog, self.adapt_mass,
                      inv_mass0, q_safe=info.init_u)
        samples_u, accepts = out[:2]               # (chains, samples, dim)
        if share is not None:
            samples_u = gather_rows(samples_u, share.group, share.counts)
            accepts = gather_rows(accepts, share.group, share.counts)
        self._samples_u, self._accepts = samples_u, accepts
        return self

    def get_samples(self, group_by_chain=False):
        """Constrained samples per site, as numpy arrays."""
        flat = self._samples_u
        if not group_by_chain:
            flat = flat.reshape(-1, flat.shape[-1])
        with torch.no_grad():
            out = self.model_info.unflatten(flat)
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def accept_rate(self):
        return float(self._accepts.mean())

    def summary(self):
        samples = self.get_samples(group_by_chain=True)
        out = {}
        for name, arr in samples.items():
            c, n = arr.shape[:2]
            flat = arr.reshape(c * n, -1)
            x = arr.reshape(c, n, -1)
            out[name] = {"mean": flat.mean(0), "sd": flat.std(0),
                         "rhat": _split_rhat(x),
                         "ess": effective_sample_size(x)}
        return out


def _mesh_groups(mesh, chain_axis):
    """(whether ``mesh`` names ``chain_axis``, the ``"cells"`` axis' group
    when it has more than one rank); (False, None) without a mesh."""
    if mesh is None:
        return False, None
    names = tuple(mesh.mesh_dim_names or ())
    if chain_axis not in names and "cells" not in names:
        raise ValueError(f"the mesh's axes {names} name neither "
                         f"{chain_axis!r} nor 'cells'")
    cells = mesh.get_group("cells") if "cells" in names else None
    if cells is not None and cells.size() == 1:
        cells = None
    return chain_axis in names, cells


def _split_rhat(x):
    """Split-R-hat per scalar parameter; x: (chains, samples, dim)."""
    c, n, d = x.shape
    half = n // 2
    halves = np.concatenate([x[:, :half, :], x[:, half:2 * half, :]], 0)
    m, hn = halves.shape[0], halves.shape[1]
    chain_means = halves.mean(1)
    chain_vars = halves.var(1, ddof=1)
    W = chain_vars.mean(0)
    B = hn * chain_means.var(0, ddof=1)
    var_est = (hn - 1) / hn * W + B / hn
    return np.sqrt(var_est / np.maximum(W, 1e-12))


def _autocov_fft(x):
    """Per-chain autocovariance via FFT; x: (chains, samples, dim) ->
    (chains, samples, dim), biased (normalized by n, the convention the
    split-ESS estimator below expects)."""
    c, n, d = x.shape
    xc = x - x.mean(1, keepdims=True)
    m = 1 << (2 * n - 1).bit_length()          # zero-pad to avoid wraparound
    f = np.fft.rfft(xc, n=m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=1)[:, :n, :]
    return acov / n


def effective_sample_size(x):
    """Split-chain bulk ESS per scalar parameter (Vehtari et al. 2021 /
    Stan's estimator: multi-chain autocorrelation from within/between-chain
    variances, Geyer initial-monotone-positive-sequence truncation).

    x: (chains, samples, dim) numpy array -> (dim,) ESS estimates.
    """
    x = np.asarray(x, np.float64)
    c, n, d = x.shape
    half = n // 2
    if half < 2:
        return np.full((d,), np.nan)
    x = np.concatenate([x[:, :half, :], x[:, half:2 * half, :]], 0)
    m, n = 2 * c, half

    acov = _autocov_fft(x)                      # (m, n, d)
    chain_var = acov[:, 0, :] * n / (n - 1.0)   # unbiased per-chain var
    W = chain_var.mean(0)
    mean_acov = acov.mean(0)                    # (n, d)
    if m > 1:
        B_over_n = x.mean(1).var(0, ddof=1)
        var_plus = W * (n - 1.0) / n + B_over_n
    else:
        var_plus = W * (n - 1.0) / n
    var_plus = np.maximum(var_plus, 1e-300)

    rho = 1.0 - (W[None, :] - mean_acov) / var_plus[None, :]   # (n, d)
    rho[0] = 1.0
    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}; truncate at first negative
    # pair, then enforce monotone non-increase
    n_pairs = n // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]        # (n_pairs, d)
    pos = pairs > 0
    first_neg = np.where(
        pos.all(0), n_pairs, np.argmin(pos, axis=0)
    )
    keep = np.arange(n_pairs)[:, None] < first_neg[None, :]
    pairs = np.where(keep, pairs, 0.0)
    pairs = np.minimum.accumulate(pairs + 1e300 * (~keep), axis=0)
    pairs = np.where(keep, pairs, 0.0)
    tau = np.maximum(-1.0 + 2.0 * pairs.sum(0), 1.0 / (m * n))
    return np.minimum(m * n / tau, m * n * np.log10(max(m * n, 10.0)))
