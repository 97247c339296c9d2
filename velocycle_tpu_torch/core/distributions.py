"""The distribution library of the model DSL, in plain torch.

Same parameterizations and log-densities as `velocycle_tpu/core/
distributions.py`, including the f32-hardened Gamma-Poisson.  ``sample``
takes an integer seed and draws from an explicit `torch.Generator` on the
parameters' device (`core.handlers.seed` derives one seed per site);
location-scale draws are reparameterized.

One density departs from the JAX package's arithmetic on purpose:
`ProjectedNormal.log_prob` takes its Mills-ratio term through a stable
log-Phi in float64, where the JAX package's float32 ``exp(0.5 t^2)``
overflows to +inf from t = |loc| / scale ~ 13.3 at the mode and loses
the tail (ROADMAP.md section 3).
"""
from __future__ import annotations

import math

import torch

from ..ops.likelihoods import NBLogPmf, gamma_poisson_logpmf

__all__ = [
    "Distribution",
    "Independent",
    "Normal",
    "LogNormal",
    "Gamma",
    "Poisson",
    "GammaPoisson",
    "NBMeanDispersion",
    "NegativeBinomial",
    "Delta",
    "LowRankMultivariateNormal",
    "Beta",
    "Bernoulli",
    "Uniform",
    "MultivariateNormal",
    "VonMises",
    "ProjectedNormal",
    "log_i0",
    "log_i1",
    "generator",
]

_LOG_2PI = math.log(2.0 * math.pi)


def generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _promote(*xs):
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [x if isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.device == device
            else torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in xs]


class Distribution:
    """Base class: batch_shape/event_shape bookkeeping + to_event.

    ``support`` names the support (`constraints.biject_to` maps it to the
    MCMC backend's bijection) and ``has_rsample`` says whether draws are
    reparameterized, as in the JAX package."""

    event_shape: tuple = ()
    support = "real"
    has_rsample = True

    @property
    def batch_shape(self):
        raise NotImplementedError

    def sample(self, key, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def to_event(self, n=1):
        if n == 0:
            return self
        return Independent(self, n)


class Independent(Distribution):
    """Reinterpret the last ``n`` batch dims of ``base`` as event dims."""

    def __init__(self, base, reinterpreted_batch_ndims):
        self.base = base
        self.ndims = int(reinterpreted_batch_ndims)

    @property
    def batch_shape(self):
        bs = self.base.batch_shape
        return bs[: len(bs) - self.ndims]

    @property
    def event_shape(self):
        bs = self.base.batch_shape
        return bs[len(bs) - self.ndims:] + self.base.event_shape

    def sample(self, key, sample_shape=()):
        return self.base.sample(key, sample_shape)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        if self.ndims:
            lp = lp.sum(dim=tuple(range(-self.ndims, 0)))
        return lp

    def to_event(self, n=1):
        if n == 0:
            return self
        return Independent(self.base, self.ndims + n)

    @property
    def support(self):
        return self.base.support


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _promote(loc, scale)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.randn(shape, generator=generator(key, self.loc.device),
                          device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI


class LogNormal(Distribution):
    """exp of a Normal(loc, scale) variable; draws reparameterized."""

    support = "positive"

    def __init__(self, loc, scale):
        self.loc, self.scale = _promote(loc, scale)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.randn(shape, generator=generator(key, self.loc.device),
                          device=self.loc.device, dtype=self.loc.dtype)
        return torch.exp(self.loc + self.scale * eps)

    def log_prob(self, value):
        logv = torch.log(value)
        z = (logv - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI - logv


class Gamma(Distribution):
    """Gamma(concentration, rate)."""

    support = "positive"

    def __init__(self, concentration, rate):
        self.concentration, self.rate = _promote(concentration, rate)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.concentration.shape, self.rate.shape
        ))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = self.concentration.expand(shape).contiguous()
        g = torch._standard_gamma(c, generator=generator(key, c.device))
        return g / self.rate

    def log_prob(self, value):
        c, r = self.concentration, self.rate
        return (
            c * torch.log(r)
            + (c - 1.0) * torch.log(value)
            - r * value
            - torch.lgamma(c)
        )


class Poisson(Distribution):
    has_rsample = False

    def __init__(self, rate):
        (self.rate,) = _promote(rate)

    @property
    def batch_shape(self):
        return tuple(self.rate.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        rate = self.rate.expand(shape).contiguous()
        return torch.poisson(rate, generator=generator(key, rate.device))

    def log_prob(self, value):
        value = value.to(self.rate.dtype)
        return value * torch.log(self.rate) - self.rate - torch.lgamma(value + 1.0)


class GammaPoisson(Distribution):
    """Gamma-Poisson compound (== NegativeBinomial), pyro's
    ``GammaPoisson(concentration, rate)`` parameterization."""

    has_rsample = False

    def __init__(self, concentration, rate):
        self.concentration, self.rate = _promote(concentration, rate)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.concentration.shape, self.rate.shape
        ))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = self.concentration.expand(shape).contiguous()
        g = generator(key, c.device)
        lam = torch._standard_gamma(c, generator=g) / self.rate.expand(shape)
        return torch.poisson(lam, generator=g)

    def log_prob(self, value):
        """Cancellation-free form (see the JAX package's derivation): the
        lgamma difference through `ops.likelihoods.lgamma_diff`."""
        return gamma_poisson_logpmf(value, self.concentration, self.rate)


class NBMeanDispersion(GammaPoisson):
    """``GammaPoisson(1/r, 1/(r*mu))`` that remembers ``mean`` and ``r``:
    the same draws and log-prob values, the log-prob differentiated in
    (log mean, r) by `ops.likelihoods.NBLogPmf`, whose dispersion gradient
    does not cancel in float32 as r falls (autograd through concentration
    and rate would)."""

    def __init__(self, mean, dispersion):
        r = dispersion
        with torch.no_grad():   # they carry the value only (`NBLogPmf`)
            super().__init__(1.0 / r, 1.0 / (r * mean))
        self.mean, self.dispersion = (
            x if isinstance(x, torch.Tensor) else torch.as_tensor(
                x, dtype=torch.float32, device=self.concentration.device)
            for x in (mean, r))

    def log_prob(self, value):
        return NBLogPmf.apply(value, torch.log(self.mean), self.dispersion,
                              self.concentration, self.rate)


def NegativeBinomial(mean, dispersion):
    """NB in (mean, dispersion) form: ``GammaPoisson(1/r, 1/(r*mu))``, as
    `NBMeanDispersion`."""
    return NBMeanDispersion(mean, dispersion)


class Delta(Distribution):
    """Point mass.  log_prob is ``log_density`` at the point (0 by default):
    a Delta guide site contributes zero entropy to the ELBO."""

    def __init__(self, v, log_density=0.0):
        (self.v,) = _promote(v)
        self.log_density = log_density

    @property
    def batch_shape(self):
        return tuple(self.v.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.v.expand(shape)

    def log_prob(self, value):
        ld = torch.as_tensor(self.log_density, dtype=self.v.dtype,
                             device=self.v.device)
        return ld.expand(torch.broadcast_shapes(value.shape, self.v.shape))


class LowRankMultivariateNormal(Distribution):
    """N(loc, W W^T + D): the LRMN velocity guide's joint family.

    ``sample`` is reparameterized, ``loc + W eps_w + sqrt(D) eps_d`` with
    both noises from one generator; ``log_prob`` uses the Woodbury identity
    with the Cholesky factor of the (rank x rank) capacitance matrix."""

    def __init__(self, loc, cov_factor, cov_diag):
        self.loc, self.cov_factor, self.cov_diag = _promote(
            loc, cov_factor, cov_diag
        )

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-1:])

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.loc.shape[:-1], self.cov_factor.shape[:-2],
            self.cov_diag.shape[:-1],
        ))

    def rsample_from(self, eps_w, eps_d):
        """The draw for given standard-normal noise (..., rank) and
        (..., dim)."""
        return (
            self.loc
            + (self.cov_factor @ eps_w[..., None])[..., 0]
            + torch.sqrt(self.cov_diag) * eps_d
        )

    def sample(self, key, sample_shape=()):
        g = generator(key, self.loc.device)
        shape = tuple(sample_shape) + self.batch_shape
        rank = self.cov_factor.shape[-1]
        kw = dict(generator=g, device=self.loc.device, dtype=self.loc.dtype)
        eps_w = torch.randn(shape + (rank,), **kw)
        eps_d = torch.randn(shape + self.event_shape, **kw)
        return self.rsample_from(eps_w, eps_d)

    def log_prob(self, value):
        W, D = self.cov_factor, self.cov_diag
        diff = value - self.loc
        d = self.loc.shape[-1]
        rank = W.shape[-1]
        Wt_Dinv = W.transpose(-1, -2) / D[..., None, :]
        cap = torch.eye(rank, dtype=W.dtype, device=W.device) + Wt_Dinv @ W
        L = torch.linalg.cholesky(cap)
        rhs = (Wt_Dinv @ diff[..., None])
        bshape = torch.broadcast_shapes(rhs.shape[:-2], L.shape[:-2])
        y = torch.linalg.solve_triangular(
            L.expand(bshape + L.shape[-2:]),
            rhs.expand(bshape + rhs.shape[-2:]), upper=False,
        )[..., 0]
        mahal = (diff * (diff / D)).sum(-1) - (y * y).sum(-1)
        logdet = torch.log(D).sum(-1) + 2.0 * torch.log(
            torch.diagonal(L, dim1=-2, dim2=-1)
        ).sum(-1)
        return -0.5 * (mahal + logdet + d * _LOG_2PI)


class MultivariateNormal(Distribution):
    """N(loc, L L^T) with ``scale_tril`` L given, or taken as the Cholesky
    factor of ``covariance_matrix``; draws ``loc + L eps``,
    reparameterized."""

    def __init__(self, loc, covariance_matrix=None, scale_tril=None):
        (self.loc,) = _promote(loc)
        kw = dict(dtype=self.loc.dtype, device=self.loc.device)
        if scale_tril is None:
            scale_tril = torch.linalg.cholesky(
                torch.as_tensor(covariance_matrix, **kw))
        self.scale_tril = torch.as_tensor(scale_tril, **kw)

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-1:])

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape[:-1],
                                            self.scale_tril.shape[:-2]))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = torch.randn(shape, generator=generator(key, self.loc.device),
                          device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

    def log_prob(self, value):
        L = self.scale_tril
        diff = value - self.loc
        bshape = torch.broadcast_shapes(diff.shape[:-1], L.shape[:-2])
        y = torch.linalg.solve_triangular(
            L.expand(bshape + L.shape[-2:]),
            diff.expand(bshape + diff.shape[-1:])[..., None], upper=False,
        )[..., 0]
        d = self.loc.shape[-1]
        half_logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (y * y).sum(-1) - half_logdet - 0.5 * d * _LOG_2PI


class Beta(Distribution):
    support = "unit_interval"

    def __init__(self, concentration1, concentration0):
        self.concentration1, self.concentration0 = _promote(
            concentration1, concentration0
        )

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.concentration1.shape, self.concentration0.shape
        ))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        g = generator(key, self.concentration1.device)
        x = torch._standard_gamma(
            self.concentration1.expand(shape).contiguous(), generator=g)
        y = torch._standard_gamma(
            self.concentration0.expand(shape).contiguous(), generator=g)
        return x / (x + y)

    def log_prob(self, value):
        c1, c0 = self.concentration1, self.concentration0
        # log B(c1, c0) in float64: the float32 lgamma sum cancels
        a, b = c1.double(), c0.double()
        betaln = (torch.lgamma(a) + torch.lgamma(b)
                  - torch.lgamma(a + b)).to(c1.dtype)
        return (
            (c1 - 1.0) * torch.log(value)
            + (c0 - 1.0) * torch.log1p(-value)
            - betaln
        )


class Bernoulli(Distribution):
    has_rsample = False

    def __init__(self, probs):
        (self.probs,) = _promote(probs)

    @property
    def batch_shape(self):
        return tuple(self.probs.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        p = self.probs.expand(shape).contiguous()
        return torch.bernoulli(p, generator=generator(key, p.device))

    def log_prob(self, value):
        p = torch.clamp(self.probs, 1e-7, 1.0 - 1e-7)
        return value * torch.log(p) + (1.0 - value) * torch.log1p(-p)

    def enumerate_support(self):
        """Support values stacked on a new leading axis, for parallel
        enumeration: shape (2,) + batch_shape."""
        zero = torch.zeros(self.batch_shape, dtype=self.probs.dtype,
                           device=self.probs.device)
        return torch.stack([zero, zero + 1.0], dim=0)


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low, self.high = _promote(low, high)

    @property
    def support(self):
        return ("interval", self.low, self.high)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.low.shape, self.high.shape))

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=generator(key, self.low.device),
                       device=self.low.device, dtype=self.low.dtype)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inside = (value >= self.low) & (value <= self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))


def log_i0(x):
    """log of the modified Bessel function I0, numerically stable."""
    return torch.log(torch.special.i0e(x)) + torch.abs(x)


def log_i1(x):
    return torch.log(torch.special.i1e(x)) + torch.abs(x)


class VonMises(Distribution):
    """Circular distribution on S^1: the prior of the wrapped phase
    parametrization."""

    has_rsample = False
    support = "circular"

    def __init__(self, loc, concentration):
        self.loc, self.concentration = _promote(loc, concentration)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.loc.shape, self.concentration.shape
        ))

    def log_prob(self, value):
        return (
            self.concentration * torch.cos(value - self.loc)
            - _LOG_2PI
            - log_i0(self.concentration)
        )

    def sample(self, key, sample_shape=()):
        """Best-Fisher (1979) rejection sampling with the JAX package's
        fixed budget of 16 proposals per draw; a draw none of them accepts
        returns ``loc`` (probability below 1e-6 per draw)."""
        shape = tuple(sample_shape) + self.batch_shape
        kappa = self.concentration.expand(shape)
        loc = self.loc.expand(shape)
        g = generator(key, loc.device)
        kw = dict(generator=g, device=loc.device, dtype=loc.dtype)

        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa**2)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa + 1e-12)
        r = (1.0 + rho**2) / (2.0 * rho + 1e-12)

        found = torch.zeros(shape, dtype=torch.bool, device=loc.device)
        out = torch.zeros(shape, **{k: kw[k] for k in ("device", "dtype")})
        for _ in range(16):
            u1, u2, u3 = (torch.rand(shape, **kw) for _ in range(3))
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            accept = (c * (2.0 - c) - u2 > 0) | (
                torch.log(c / torch.clamp(u2, min=1e-12)) + 1.0 - c >= 0
            )
            theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
            out = torch.where(accept & ~found, theta, out)
            found = found | accept
        return torch.remainder(out + loc + math.pi, 2.0 * math.pi) - math.pi


class ProjectedNormal(Distribution):
    """The angle of a 2-D isotropic normal centred at ``loc_xy`` (last axis
    x, y) with standard deviation ``scale``: the implicit phase prior of
    the phi_xy parametrization."""

    def __init__(self, loc_xy, scale=1.0):
        self.loc_xy, self.scale = _promote(loc_xy, scale)

    @property
    def batch_shape(self):
        return tuple(self.loc_xy.shape[:-1])

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + (2,)
        eps = torch.randn(shape, generator=generator(key, self.loc_xy.device),
                          device=self.loc_xy.device, dtype=self.loc_xy.dtype)
        xy = self.loc_xy + self.scale[..., None] * eps
        return torch.atan2(xy[..., 1], xy[..., 0])

    def log_prob(self, value):
        """The exact density, p = exp(-r^2/2) / (2 pi) (1 + t Phi(t) /
        phi(t)) with m = loc / scale, r = |m|, t = m . (cos, sin).  As a
        log, -u^2/2 - log(2 pi)/2 + log g(t), with u^2 = r^2 - t^2 the
        squared normal component (u = m x (cos, sin)) and g = phi + t Phi:
        where t >= 0, g >= phi(0) is summed directly; where t < 0, log g =
        log phi(t) + log1p(t Phi(t) / phi(t)), the Mills ratio taken from
        log_ndtr.  In float64 (the result in the input's dtype), so that
        neither term overflows nor underflows: finite for every t; the
        log1p's float64 cancellation grows as t^2 and stays far below
        float32 resolution for |t| < 1e3."""
        dtype = torch.promote_types(self.loc_xy.dtype,
                                    torch.as_tensor(value).dtype)
        m = (self.loc_xy / self.scale[..., None]).double()
        v = torch.as_tensor(value, device=m.device).double()
        c, s = torch.cos(v), torch.sin(v)
        t = m[..., 0] * c + m[..., 1] * s
        u = m[..., 0] * s - m[..., 1] * c
        half_log_2pi = 0.5 * _LOG_2PI
        tp = torch.clamp(t, min=0.0)
        log_g_pos = torch.log(tp * torch.special.ndtr(tp)
                              + torch.exp(-0.5 * tp * tp - half_log_2pi))
        tn = torch.clamp(t, max=0.0)
        log_phi_n = -0.5 * tn * tn - half_log_2pi
        log_g_neg = log_phi_n + torch.log1p(
            tn * torch.exp(torch.special.log_ndtr(tn) - log_phi_n))
        log_g = torch.where(t >= 0.0, log_g_pos, log_g_neg)
        return (-0.5 * u * u - half_log_2pi + log_g).to(dtype)
