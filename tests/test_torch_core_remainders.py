"""The core remainders of the port against the JAX package, on the same
numpy inputs: `LogNormal`, `MultivariateNormal`, `ProjectedNormal`
(`core/distributions.py`), `uncondition`, `Trace.log_prob_sum` /
`Trace.nodes` and `param(event_dim=)` (`core/handlers.py`),
``num_particles`` of both ELBOs (`infer/elbo.py`), `digamma_pos`,
`lgamma_ratio`, `digamma_ratio` (`ops/special.py`) and `lognormal_logpdf`
(`ops/likelihoods.py`).

Tolerances:
  * log-densities against the JAX package: rtol 1e-6 (LogNormal,
    lognormal_logpdf: the same float32 formula), rtol 1e-5 (the
    MultivariateNormal's triangular solve), and against scipy the JAX
    suite's own (tests/test_distributions.py);
  * `ProjectedNormal.log_prob`, which the port takes in float64: within
    2e-6 absolute (plus 2e-6 relative) of a float64 scipy evaluation of the
    same density for every |t| <= 30, and where |t| <= 12 no further from
    JAX than JAX's own float32 error against that float64 value, plus
    2e-6 (1 + |value|) (JAX's error there: up to 2.5e-3 absolute, 5e-4
    relative, on these grids); finite at |loc| / scale = 14 and 20, where
    the JAX package returns +inf at the mode;
  * sample statistics over 20,000 draws as tests/test_distributions.py;
  * reparameterized gradients against their closed forms, rtol 1e-5
    (1e-4 where float32 sums run over the 20,000 draws), and
    ProjectedNormal's log-density gradients against central differences
    of the float64 density, rtol 1e-4, atol 1e-4;
  * the special functions on tests/test_nb_kernels.py's grids: against
    JAX rtol 1e-6 (atol 1e-6 where the value is near 0), against scipy
    as that suite (5e-4 for digamma_pos, 5e-6 for the ratios), and near
    z = 2 at atol 2e-5 (the digamma hazard of ROADMAP.md section 3);
  * ``num_particles``: N = 1 bit-equal to the single-particle loss and
    gradients, N = 4 equal to the mean of four single-particle losses
    (rtol 1e-6: the same float32 numbers, summed once more), N = 4096
    within 0.02 of the closed-form KL (tests/test_elbo.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as st
import torch

from velocycle_tpu.core import distributions as jd
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.ops import likelihoods as jlik
from velocycle_tpu.ops import special as jsp
from velocycle_tpu_torch.core import constraints
from velocycle_tpu_torch.core import distributions as td
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import Trace_ELBO, TraceEnum_ELBO
from velocycle_tpu_torch.infer.elbo import _logp_sum, _traces
from velocycle_tpu_torch.ops import likelihoods as tlik
from velocycle_tpu_torch.ops import special as tsp

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, **kw):
    return torch.as_tensor(np.asarray(x, np.float32), **kw)


# ---------------------------------------------------------------------------
# LogNormal
# ---------------------------------------------------------------------------

def test_lognormal_log_prob_matches_jax_and_scipy():
    x = np.linspace(0.1, 5, 11).astype(np.float32)
    got = td.LogNormal(0.3, 0.8).log_prob(_t(x)).numpy()
    np.testing.assert_allclose(
        got, st.lognorm(s=0.8, scale=np.exp(0.3)).logpdf(x), rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jd.LogNormal(0.3, 0.8).log_prob(jnp.asarray(x))),
        rtol=1e-6)
    # MCMC maps a LogNormal site through the positive bijection
    assert constraints.biject_to(td.LogNormal(0.3, 0.8).support) is constraints.positive


def test_lognormal_samples_and_their_gradient():
    loc = torch.tensor(0.3, requires_grad=True)
    scale = torch.tensor(0.8, requires_grad=True)
    s = td.LogNormal(loc, scale).sample(0, (20000,))
    logs = torch.log(s.detach()).numpy()
    assert abs(logs.mean() - 0.3) < 0.02 and abs(logs.std() - 0.8) < 0.02
    s.sum().backward()
    eps = (torch.log(s.detach()) - 0.3) / 0.8
    np.testing.assert_allclose(loc.grad.item(), s.detach().sum().item(), rtol=1e-5)
    np.testing.assert_allclose(scale.grad.item(),
                               (s.detach() * eps).sum().item(), rtol=1e-5)


# ---------------------------------------------------------------------------
# MultivariateNormal
# ---------------------------------------------------------------------------

def _mvn_case():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    cov = A @ A.T + 3 * np.eye(3, dtype=np.float32)
    loc = rng.normal(size=3).astype(np.float32)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    return loc, cov, x


@pytest.mark.parametrize("form", ["covariance_matrix", "scale_tril"])
def test_mvn_log_prob_matches_jax_and_scipy(form):
    loc, cov, x = _mvn_case()
    arg = cov if form == "covariance_matrix" else np.linalg.cholesky(cov)
    d = td.MultivariateNormal(_t(loc), **{form: _t(arg)})
    got = d.log_prob(_t(x)).numpy()
    np.testing.assert_allclose(got, st.multivariate_normal(loc, cov).logpdf(x),
                               rtol=1e-4)
    jdist = jd.MultivariateNormal(jnp.asarray(loc), **{form: jnp.asarray(arg)})
    np.testing.assert_allclose(got, np.asarray(jdist.log_prob(jnp.asarray(x))),
                               rtol=1e-5)
    assert d.event_shape == (3,) and d.batch_shape == ()
    # a batch of locs against one covariance, and the reverse
    locs = np.stack([loc, loc + 1.0])
    got_b = td.MultivariateNormal(_t(locs), **{form: _t(arg)}).log_prob(_t(x[:2]))
    want_b = jd.MultivariateNormal(jnp.asarray(locs), **{form: jnp.asarray(arg)}
                                   ).log_prob(jnp.asarray(x[:2]))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5)
    covs = np.stack([arg, 2 * arg])
    got_c = td.MultivariateNormal(_t(loc), **{form: _t(covs)}).log_prob(_t(x[:1]))
    want_c = jd.MultivariateNormal(jnp.asarray(loc), **{form: jnp.asarray(covs)}
                                   ).log_prob(jnp.asarray(x[:1]))
    assert got_c.shape == (2,)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5)


def test_mvn_samples_and_their_gradient():
    loc, cov, _ = _mvn_case()
    L = torch.tensor(np.linalg.cholesky(cov), requires_grad=True)
    m = torch.tensor(loc, requires_grad=True)
    s = td.MultivariateNormal(m, scale_tril=L).sample(1, (20000,))
    sn = s.detach().numpy()
    np.testing.assert_allclose(sn.mean(0), loc, atol=0.05)
    np.testing.assert_allclose(np.cov(sn.T), cov, atol=0.12 * np.abs(cov).max())
    s.sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.full(3, 20000.0), rtol=1e-5)
    eps = torch.linalg.solve_triangular(L.detach(), (s.detach() - m.detach()).T,
                                        upper=False)
    # d sum(loc + L eps) / d L_ij = sum_n eps_nj on every entry L enters
    np.testing.assert_allclose(L.grad.numpy(),
                               np.broadcast_to(eps.sum(1).numpy(), (3, 3)),
                               rtol=1e-4, atol=1e-2)


# ---------------------------------------------------------------------------
# ProjectedNormal
# ---------------------------------------------------------------------------

def _pn_float64(loc, scale, theta):
    """The projected-normal log-density in float64 from scipy, in the
    textbook form exp(-r^2/2)/(2 pi) (1 + t Phi(t)/phi(t))."""
    m = np.asarray(loc, np.float64) / scale
    t = m[0] * np.cos(theta) + m[1] * np.sin(theta)
    r2 = m @ m
    ratio = sps.ndtr(t) * np.exp(0.5 * t * t) * np.sqrt(2 * np.pi)
    return -0.5 * r2 - np.log(2 * np.pi) + np.log1p(t * ratio)


def test_projected_normal_normalizes():
    theta = np.linspace(-np.pi, np.pi, 4001)
    for loc in ([1.2, 0.8], [14.0, 0.0], [0.0, -20.0]):
        p = np.exp(td.ProjectedNormal(_t(loc)).log_prob(
            torch.as_tensor(theta)).numpy())
        assert abs(np.trapezoid(p, theta) - 1.0) < 1e-3, loc


@pytest.mark.parametrize("r", [0.3, 1.5, 5.0, 8.0, 10.0, 12.0, 14.0, 20.0, 30.0])
def test_projected_normal_log_prob_matches_float64_and_jax(r):
    """|t| <= r on the whole circle.  Against float64 everywhere; against
    JAX where its float32 form holds (|t| <= 12)."""
    theta = np.linspace(-np.pi, np.pi, 721).astype(np.float32)
    loc = np.array([r * np.cos(0.7), r * np.sin(0.7)], np.float32)
    scale = 1.3
    got = td.ProjectedNormal(_t(loc), scale).log_prob(_t(theta)).numpy()
    want = _pn_float64(loc, scale, theta.astype(np.float64))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    jgot = np.asarray(jd.ProjectedNormal(jnp.asarray(loc), scale).log_prob(
        jnp.asarray(theta)))
    t = (loc[0] * np.cos(theta) + loc[1] * np.sin(theta)) / scale
    near = np.abs(t) <= 12
    jax_err = np.abs(jgot - want)
    assert np.all(np.abs(got - jgot)[near]
                  <= (jax_err + 2e-6 * (1 + np.abs(want)))[near])


@pytest.mark.parametrize("r", [14.0, 20.0])
def test_projected_normal_stays_finite_where_the_jax_form_overflows(r):
    """At the mode the JAX package's exp(0.5 t^2) overflows in float32 to
    +inf; at value pi its ndtr(-r) underflows.  The port is finite and
    within 2e-6 of float64 at both (r = 14, pi: about -105.13)."""
    loc = np.array([r, 0.0], np.float32)
    theta = np.array([0.0, np.pi, 1.0], np.float32)
    got = td.ProjectedNormal(_t(loc)).log_prob(_t(theta)).numpy()
    np.testing.assert_allclose(got, _pn_float64(loc, 1.0, theta.astype(np.float64)),
                               rtol=2e-6, atol=2e-6)
    jgot = np.asarray(jd.ProjectedNormal(jnp.asarray(loc)).log_prob(
        jnp.asarray(theta)))
    assert np.isposinf(jgot[0])        # the reference's hazard, kept as is


def test_projected_normal_gradients_are_finite_and_exact():
    """d log p / d loc, d theta by autograd against central differences of
    the float64 density, at r = 3 and 20 (both signs of t)."""
    for r in (3.0, 20.0):
        loc = torch.tensor([r * 0.6, r * 0.8], requires_grad=True)
        theta = torch.tensor([0.9, -2.2, 2.8], requires_grad=True)
        td.ProjectedNormal(loc, 1.0).log_prob(theta).sum().backward()
        h = 1e-5
        ln, th_ = loc.detach().double().numpy(), theta.detach().double().numpy()
        num_loc = [(_pn_float64(ln + h * e, 1.0, th_).sum()
                    - _pn_float64(ln - h * e, 1.0, th_).sum()) / (2 * h)
                   for e in np.eye(2)]
        num_th = (_pn_float64(ln, 1.0, th_ + h) - _pn_float64(ln, 1.0, th_ - h)) / (2 * h)
        np.testing.assert_allclose(loc.grad.numpy(), num_loc, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(theta.grad.numpy(), num_th, rtol=1e-4, atol=1e-4)


def test_projected_normal_samples_and_their_gradient():
    loc = torch.tensor([1.2, 0.8], requires_grad=True)
    d = td.ProjectedNormal(loc, 0.9)
    s = d.sample(2, (20000,))
    sn = s.detach().numpy()
    assert np.all(np.abs(sn) <= np.pi)
    # circular mean direction and the histogram against the density
    assert abs(np.angle(np.exp(1j * sn).mean()) - math.atan2(0.8, 1.2)) < 0.03
    edges = np.linspace(-np.pi, np.pi, 25)
    hist = np.histogram(sn, edges)[0] / len(sn)
    fine = np.linspace(-np.pi, np.pi, 24 * 200 + 1)
    dens = np.exp(d.log_prob(torch.as_tensor(fine)).detach().numpy())
    want = np.array([np.trapezoid(dens[i * 200:(i + 1) * 200 + 1],
                                  fine[i * 200:(i + 1) * 200 + 1])
                     for i in range(24)])
    np.testing.assert_allclose(hist, want, atol=0.01)
    # d atan2(y, x) / d (x, y) = (-y, x) / (x^2 + y^2) at each draw
    s.sum().backward()
    xy = torch.stack([torch.cos(s.detach()), torch.sin(s.detach())], -1)
    # the draw's radius is not kept: recompute it from the same seed
    eps = torch.randn((20000, 2), generator=td.generator(2, "cpu"))
    pts = loc.detach() + 0.9 * eps
    rad2 = (pts * pts).sum(-1, keepdim=True)
    want_g = (torch.stack([-pts[:, 1], pts[:, 0]], -1) / rad2).sum(0)
    np.testing.assert_allclose(loc.grad.numpy(), want_g.numpy(), rtol=1e-4)
    assert torch.allclose(xy, pts / rad2.sqrt(), atol=1e-5)


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------

def _model(pkg, y):
    h, d = (jh, jd) if pkg == "jax" else (th, td)
    x = h.sample("x", d.Normal(0.0, 1.0))
    h.param("p", (jnp if pkg == "jax" else torch).ones(3), event_dim=1)
    with h.plate("obs", 5, dim=-1):
        h.sample("y", d.Normal(x * (jnp if pkg == "jax" else torch).ones(5), 0.5),
                 obs=y)
    h.sample("aux", d.Normal(0.0, 2.0), infer={"is_auxiliary": True})
    h.deterministic("twice", 2 * x)


def _traces_at(x_val, scale=1.0):
    y = np.linspace(-1, 1, 5).astype(np.float32)
    data = {"x": np.float32(x_val), "aux": np.float32(0.3)}
    jtr = jh.trace(jh.scale(jh.substitute(
        lambda: _model("jax", jnp.asarray(y)),
        data={k: jnp.asarray(v) for k, v in data.items()}),
        scale_factor=scale, site_filter=lambda n: n == "y")).get_trace()
    ttr = th.trace(th.scale(th.substitute(
        lambda: _model("torch", _t(y)), data={k: _t(v) for k, v in data.items()}),
        scale_factor=scale, site_filter=lambda n: n == "y")).get_trace()
    return jtr, ttr


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_trace_log_prob_sum_and_nodes_match_jax(scale):
    jtr, ttr = _traces_at(0.4, scale)
    assert ttr.nodes() is ttr and jtr.nodes() is jtr
    assert list(ttr.nodes()) == list(jtr.nodes())
    for filt in (lambda n, s: True, lambda n, s: n != "aux",
                 lambda n, s: s["is_observed"]):
        got = float(ttr.log_prob_sum(filt))
        np.testing.assert_allclose(got, float(jtr.log_prob_sum(filt)), rtol=1e-6)
    # every sample site counts, auxiliary and observed too; y by its scale
    want = sum(float(ttr[n]["fn"].log_prob(ttr[n]["value"]).sum())
               * (scale if n == "y" else 1.0) for n in ("x", "y", "aux"))
    np.testing.assert_allclose(float(ttr.log_prob_sum()), want, rtol=1e-6)


def test_param_takes_event_dim_as_jax():
    """``event_dim`` is accepted and changes nothing: the init comes back."""
    for h, ones in ((jh, jnp.ones(3)), (th, torch.ones(3))):
        with h.trace() as tr:
            v = h.param("p", ones, event_dim=1)
        assert np.array_equal(np.asarray(v), np.ones(3))
        assert tr.trace["p"]["type"] == "param"


def test_uncondition_draws_the_observed_sites():
    """Under uncondition an observed site takes a fresh draw instead of its
    data and is no longer marked observed, as in the JAX package; the
    draw is reproducible by the seed."""
    y = np.full(5, 100.0, np.float32)
    outs = []
    for pkg, h in (("jax", jh), ("torch", th)):
        key = KEY if pkg == "jax" else 0
        yy = jnp.asarray(y) if pkg == "jax" else _t(y)
        with h.uncondition():
            tr = h.trace(h.seed(lambda: _model(pkg, yy), key)).get_trace()
        assert not tr["y"]["is_observed"]
        assert np.shape(tr["y"]["value"]) == (5,)
        assert np.abs(np.asarray(tr["y"]["value"]) - 100.0).max() > 50
        outs.append(tr)
    with th.uncondition():
        again = th.trace(th.seed(lambda: _model("torch", _t(y)), 0)).get_trace()
    assert torch.equal(again["y"]["value"], outs[1]["y"]["value"])
    # outside the handler the data is observed again
    tr = th.trace(th.seed(lambda: _model("torch", _t(y)), 0)).get_trace()
    assert tr["y"]["is_observed"] and torch.equal(tr["y"]["value"], _t(y))


# ---------------------------------------------------------------------------
# num_particles
# ---------------------------------------------------------------------------

def _normal_pair(m=0.4, s=0.8):
    def model():
        th.sample("x", td.Normal(0.0, 1.0))

    loc = torch.tensor(m, requires_grad=True)
    scale = torch.tensor(s, requires_grad=True)

    def guide():
        th.sample("x", td.Normal(loc, scale))

    return model, guide, (loc, scale)


def _enum_pair():
    """A per-gene Bernoulli mixture, marginalized by TraceEnum_ELBO."""
    y = _t(np.random.default_rng(4).normal(size=(3, 7)))
    mu = torch.tensor([0.5, -0.2, 1.0], requires_grad=True)

    def model():
        with th.plate("genes", 3, dim=-2):
            z = th.sample("z", td.Bernoulli(torch.full((3, 1), 0.3)),
                          infer={"enumerate": "parallel"})
            m = th.sample("m", td.Normal(torch.zeros(3, 1), 1.0))
        th.sample("y", td.Normal(m * z, 1.0), obs=y)

    def guide():
        th.sample("m", td.Normal(mu[:, None], 0.5))

    return model, guide, (mu,)


@pytest.mark.parametrize("kind", ["trace", "enum"])
def test_one_particle_is_bit_equal_to_the_single_particle_loss(kind):
    make, elbo = ((_normal_pair, Trace_ELBO) if kind == "trace"
                  else (_enum_pair, TraceEnum_ELBO))
    model, guide, leaves = make()
    a = elbo(num_particles=1).loss(7, model, guide)
    ga = torch.autograd.grad(a, leaves)
    b = elbo().loss(7, model, guide)
    gb = torch.autograd.grad(b, leaves)
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ga, gb))
    if kind == "trace":
        # the single-particle formula, written out
        guide_tr, replayed = _traces(7, model, guide, (), {})
        model_tr = th.trace(replayed).get_trace()
        assert torch.equal(a, -(_logp_sum(model_tr) - _logp_sum(guide_tr)))


@pytest.mark.parametrize("kind", ["trace", "enum"])
def test_four_particles_are_the_mean_of_four_single_particles(kind):
    make, elbo = ((_normal_pair, Trace_ELBO) if kind == "trace"
                  else (_enum_pair, TraceEnum_ELBO))
    model, guide, leaves = make()
    four = elbo(num_particles=4).loss(3, model, guide)
    singles = [elbo().loss(th.fold_in(3, i), model, guide) for i in range(4)]
    np.testing.assert_allclose(float(four.detach()),
                               float(torch.stack(singles).mean().detach()),
                               rtol=1e-6)
    assert len({float(x.detach()) for x in singles}) == 4   # four draws
    g4 = torch.autograd.grad(four, leaves)
    g1 = torch.autograd.grad(torch.stack(singles).mean(), leaves)
    for x, y in zip(g4, g1):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)


def test_trace_enum_elbo_weights_scaled_sites_as_jax():
    """Under handlers.scale the enumerated ELBO weights each model site's
    log-prob by its scale inside the marginalization, as the JAX package's
    TraceEnum_ELBO does (rtol 1e-6), at the same guide draw."""
    from velocycle_tpu.infer import TraceEnum_ELBO as JTraceEnum_ELBO

    y = np.random.default_rng(4).normal(size=(3, 7)).astype(np.float32)
    m_val = np.array([[0.3], [-0.6], [1.1]], np.float32)
    out = []
    for pkg, h, d, lib, elbo, key in (
            ("jax", jh, jd, jnp, JTraceEnum_ELBO, KEY),
            ("torch", th, td, torch, TraceEnum_ELBO, 0)):
        yy = lib.asarray(y) if pkg == "jax" else _t(y)
        mm = lib.asarray(m_val) if pkg == "jax" else _t(m_val)

        def model(h=h, d=d, lib=lib, yy=yy):
            with h.plate("genes", 3, dim=-2):
                z = h.sample("z", d.Bernoulli(lib.full((3, 1), 0.3)),
                             infer={"enumerate": "parallel"})
                m = h.sample("m", d.Normal(lib.zeros((3, 1)), 1.0))
            h.sample("y", d.Normal(m * z, 1.0), obs=yy)

        def guide(h=h, d=d, mm=mm):
            h.sample("m", d.Delta(mm))

        for s in (1.0, 2.5):
            scaled = h.scale(model, scale_factor=s,
                             site_filter=lambda n: n == "y")
            out.append((pkg, s, float(elbo().loss(key, scaled, guide))))
    (_, _, j1), (_, _, j2), (_, _, t1), (_, _, t2) = out
    np.testing.assert_allclose([t1, t2], [j1, j2], rtol=1e-6)
    assert abs(t2 - t1) > 1.0


def test_many_particles_give_the_closed_form_elbo():
    """tests/test_elbo.py's check: model x ~ N(0, 1), guide N(m, s):
    ELBO = -KL = 0.5 (1 + log s^2 - m^2 - s^2)."""
    m, s = 0.4, 0.8
    model, guide, _ = _normal_pair(m, s)
    with torch.no_grad():
        loss = Trace_ELBO(num_particles=4096).loss(0, model, guide)
    expected = -0.5 * (1 + np.log(s**2) - m**2 - s**2)
    assert abs(float(loss) - expected) < 0.02
    with pytest.raises(ValueError, match="num_particles"):
        Trace_ELBO(num_particles=0)


# ---------------------------------------------------------------------------
# special functions and lognormal_logpdf
# ---------------------------------------------------------------------------

def _x_pos():
    """tests/test_nb_kernels.py's grid for lgamma_pos / digamma_pos."""
    return np.concatenate([
        np.linspace(1e-3, 0.5, 57), np.linspace(0.5, 30, 101),
        np.logspace(1.5, 6, 53),
    ]).astype(np.float32)


RATIO_K = np.concatenate([np.arange(0, 12), [20, 50, 119, 500, 2000]]).astype(np.float32)
RATIO_A = [0.02, 0.5, 2.0, 7.9, 8.0, 8.1, 59.0, 2000.0]


def _close_to_jax(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(1.0, np.abs(want).max() * 1e-3))


def test_digamma_pos_matches_jax_and_scipy():
    x = _x_pos()
    got = tsp.digamma_pos(_t(x)).numpy()
    _close_to_jax(got, jsp.digamma_pos(jnp.asarray(x)))
    want = sps.digamma(x.astype(np.float64))
    assert np.max(np.abs(got - want) / (np.abs(want) + 1.0)) < 5e-4
    near2 = np.linspace(1.5, 2.5, 101).astype(np.float32)
    np.testing.assert_allclose(tsp.digamma_pos(_t(near2)).numpy(),
                               sps.digamma(near2.astype(np.float64)), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("a", RATIO_A)
def test_ratio_forms_match_jax_and_scipy(a):
    k = RATIO_K
    got_l = tsp.lgamma_ratio(_t(k), _t(a)).numpy()
    got_d = tsp.digamma_ratio(_t(k), _t(a)).numpy()
    _close_to_jax(got_l, jsp.lgamma_ratio(jnp.asarray(k), jnp.float32(a)))
    _close_to_jax(got_d, jsp.digamma_ratio(jnp.asarray(k), jnp.float32(a)))
    k64 = k.astype(np.float64)
    np.testing.assert_allclose(got_l, sps.gammaln(k64 + a) - sps.gammaln(a),
                               rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(got_d, sps.digamma(k64 + a) - sps.digamma(a),
                               rtol=5e-6, atol=5e-6)


def test_digamma_ratio_near_two_and_broadcast():
    """k + a near 2 (the digamma hazard's neighbourhood), and counts x
    per-gene a broadcast as the kernels' twins take them."""
    k = np.array([[0, 1, 2, 3, 9]], np.float32)
    a = np.array([[0.02], [0.5], [1.0], [1.5]], np.float32)
    got = tsp.digamma_ratio(_t(k), _t(a)).numpy()
    want = sps.digamma(k.astype(np.float64) + a) - sps.digamma(a.astype(np.float64))
    assert got.shape == (4, 5)
    assert np.all(np.abs(got - want) <= 2e-5 * np.maximum(1, np.abs(want)))


def test_the_kernels_lgamma_half_is_renamed_not_changed():
    """`lgamma_ratio2` is the threshold-2 lgamma half of
    `lgamma_digamma_ratio` (the loss-only element's), bit for bit."""
    k, a = np.meshgrid(RATIO_K, np.array(RATIO_A, np.float32))
    assert torch.equal(tsp.lgamma_ratio2(_t(k), _t(a)),
                       tsp.lgamma_digamma_ratio(_t(k), _t(a))[0])


def test_lognormal_logpdf_matches_jax():
    rng = np.random.default_rng(8)
    logx = rng.normal(1, 1, (6, 40)).astype(np.float32)
    mu = rng.normal(1, 0.5, (6, 40)).astype(np.float32)
    sigma = np.float32(0.7)
    got = tlik.lognormal_logpdf(_t(logx), _t(mu), _t(sigma)).numpy()
    want = np.asarray(jlik.lognormal_logpdf(jnp.asarray(logx), jnp.asarray(mu),
                                            jnp.float32(sigma)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, st.norm(mu, 0.7).logpdf(logx), rtol=1e-5,
                               atol=1e-5)
