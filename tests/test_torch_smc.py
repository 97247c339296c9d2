"""The SMC engine (`velocycle_tpu_torch/infer/smc.py`) against the JAX
package's (`velocycle_tpu/infer/smc.py`).

On the same numpy arrays in both packages: `init_tempered_model`'s sites,
`unflatten`, the baselined prior and likelihood parts and their gradients
on the phase model, plain and fused (the fused kernels' plain versions
here), at the same reference draw (the first trace of each package's model
is given the same latent values); `_ess`, `_systematic_resample` (the same
indices for the same uniform) and the bisection for the next beta.  The
particles as one chain batch: a stage's log-likelihood is ONE chain-batched
call of the loss-only plain version, a leapfrog's value-and-gradient ONE
of the fwd+grad one.  Short runs on the phase model; the statistical gates
of tests/test_smc.py (the conjugate Gaussian's logZ within 0.15 of the
analytic value, the Gamma-Poisson posterior).

Tolerances: ``dim`` and the sites exact, ``unflatten`` 1e-6; the parts'
values 1e-5 of the magnitude of the un-baselined part plus 1e-6, their
gradients max|a-b|/max|b| 1e-4 (tests/test_torch_mcmc.py's potential);
``log_lik_offset`` rel 1e-6 plain, 5e-6 fused (the fused likelihood's
constant is a float32 sum).  The port's fused path is held against the JAX
package's PLAIN path, as in tests/test_torch_mcmc.py: the JAX package's
fused element cancels in float32 at small dispersion, the port's does not.
The bisection to 1e-4, its own width.
"""
import math

import numpy as np
import pytest
import scipy.stats as st
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import smc as JS
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import smc as TS
from velocycle_tpu_torch.models.phase import phase_model
from velocycle_tpu_torch.models.velocity import velocity_model
from velocycle_tpu_torch.ops import nb_kernels as K

from _torch_parity import first_trace_at

VAL_RTOL, VAL_ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _phase_case(fused, Nc=30, Ng=10, seed=5):
    """(JAX model, JAX data, port model, port data, reference values) of the
    phase model with phi_xy conditioned; the reference values are a JAX
    prior draw of nu and shape_inv."""
    sim = V.simulate.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    rng = np.random.default_rng(0)
    nu = sim.uns["simulated_nu"]
    cycle = V.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                               np.full((3, Ng), 0.5), list(sim.var.index))
    phases = V.Phases.from_angles(sim.obs["simulated_phis"].values, 2.0,
                                  list(sim.obs.index))
    mp = V.preprocess_for_phase_estimation(
        sim, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused)
    jd = mp.data
    cond = np.asarray(jd.phixy_prior)
    jmodel = jh.condition(mp.model_fn, data={"phi_xy": jnp.asarray(cond)})
    tdata = phase_data_from_jax(jd, device="cpu")
    tmodel = th.condition(phase_model, data={"phi_xy": torch.as_tensor(cond)})
    tr = jh.trace(jh.seed(jmodel, jax.random.PRNGKey(0))).get_trace(jd)
    ref = {k: np.asarray(tr[k]["value"]) for k in ("nu", "shape_inv")}
    return jmodel, jd, tmodel, tdata, ref


@pytest.mark.parametrize("fused", [False, True])
def test_init_tempered_model_matches_jax(fused):
    jmodel, jd, tmodel, td, ref = _phase_case(fused)
    if fused:   # the reference: the JAX package's plain path (docstring)
        jmodel, jd = _phase_case(False)[:2]
    jtm = JS.init_tempered_model(
        first_trace_at(jh, jmodel, {k: jnp.asarray(v) for k, v in ref.items()}),
        jd, key=jax.random.PRNGKey(1))
    ttm = TS.init_tempered_model(
        first_trace_at(th, tmodel, {k: torch.as_tensor(v)
                                     for k, v in ref.items()}),
        td, seed=1)
    assert ttm.dim == jtm.dim == 10 * 3 + 10
    off_rtol = 5e-6 if fused else 1e-6
    assert abs(ttm.log_lik_offset - jtm.log_lik_offset) < off_rtol * abs(
        jtm.log_lik_offset), (ttm.log_lik_offset, jtm.log_lik_offset)
    # the un-baselined magnitudes: the likelihood's offset; the prior's
    # log-density at the reference draw, from the JAX package's plain terms
    jtr = jh.trace(jh.substitute(jmodel, data=ref)).get_trace(jd)
    prior_mag = abs(sum(float(jtr[k]["fn"].log_prob(jtr[k]["value"]).sum())
                        for k in ref))
    rng = np.random.default_rng(2)
    # the reference draw's flat point, in the sites' order (shape_inv
    # through the inverse softplus)
    order = list(jtm.unflatten(jnp.zeros(jtm.dim)))
    assert order == list(ttm.unflatten(torch.zeros(ttm.dim)))
    u_ref = np.concatenate([
        np.log(np.expm1(ref[k].astype(np.float64))).ravel()
        if k == "shape_inv" else ref[k].ravel() for k in order
    ]).astype(np.float32)
    for _ in range(3):
        u = (u_ref + rng.normal(0, 0.05, u_ref.shape)).astype(np.float32)
        tu = torch.as_tensor(u)
        for name in order:
            np.testing.assert_allclose(
                ttm.unflatten(tu)[name].numpy(),
                np.asarray(jtm.unflatten(jnp.asarray(u))[name]),
                rtol=1e-6, atol=1e-6)
        for part, mag in (("log_prior_fn", prior_mag),
                          ("log_lik_fn", abs(jtm.log_lik_offset))):
            jv, jg = jax.value_and_grad(getattr(jtm, part))(jnp.asarray(u))
            q = tu.clone().requires_grad_(True)
            tv = getattr(ttm, part)(q)
            (tg,) = torch.autograd.grad(tv, q)
            assert abs(float(tv) - float(jv)) < VAL_RTOL * mag + VAL_ATOL, (
                part, float(tv), float(jv))
            assert _rel(tg.numpy(), np.asarray(jg)) < GRAD_RTOL, part
        # one trace gives both parts
        lp, ll = ttm.log_parts(tu)
        assert float(lp) == float(ttm.log_prior_fn(tu))
        assert float(ll) == float(ttm.log_lik_fn(tu))


@pytest.mark.parametrize("n,spread", [(8, 0.5), (64, 3.0), (1000, 10.0),
                                      (257, 40.0)])
def test_ess_and_systematic_resample_match_jax(n, spread):
    rng = np.random.default_rng(n)
    log_w = (spread * rng.normal(size=n)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    u0 = float(jax.random.uniform(key, ()))
    want = np.asarray(JS._systematic_resample(key, jnp.asarray(log_w), n))
    got = TS._systematic_resample(torch.tensor(u0), torch.as_tensor(log_w), n)
    # the JAX gather clamps an index past the end; the port clamps it
    np.testing.assert_array_equal(got.numpy(), np.minimum(want, n - 1))
    np.testing.assert_allclose(float(TS._ess(torch.as_tensor(log_w))),
                               float(JS._ess(jnp.asarray(log_w))), rtol=1e-6)


def _jax_next_beta(beta, loglik, target):
    """`velocycle_tpu/infer/smc.py`'s `next_beta` (a closure of `SMC.run`),
    with its arithmetic as written there."""
    beta = jnp.asarray(beta, jnp.float32)

    def ess_at(b):
        return JS._ess((b - beta) * loglik)

    def cond(carry):
        lo, hi, it = carry
        return (it < 30) & ((hi - lo) > 1e-4)

    def body(carry):
        lo, hi, it = carry
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid), it + 1

    full = ess_at(1.0) >= target
    lo, _, _ = jax.lax.while_loop(cond, body, (beta, jnp.asarray(1.0), 0))
    return float(jnp.where(full, 1.0, lo))


@pytest.mark.parametrize("beta,scale,target", [
    (0.0, 50.0, 0.5), (0.0, 3000.0, 0.35), (0.31, 200.0, 0.5),
    (0.9, 1.0, 0.5), (0.5, 1e5, 0.35),
])
def test_next_beta_matches_jax(beta, scale, target):
    rng = np.random.default_rng(int(scale))
    n = 256
    loglik = (-scale * rng.gamma(2.0, 1.0, n)).astype(np.float32)
    got = TS._next_beta(beta, torch.as_tensor(loglik), target * n)
    want = _jax_next_beta(beta, jnp.asarray(loglik), target * n)
    assert abs(got - want) < 1e-4, (got, want)
    assert beta <= got <= 1.0


def _counting(monkeypatch, calls, *fns):
    """Count the chain-batched calls of each function in ``fns`` (by name)
    through `nb_kernels._CHAINS`."""
    for fn in fns:
        inner = K._CHAINS[fn]

        def counted(*args, _inner=inner, _name=fn.__name__, **kwargs):
            calls.append((_name, tuple(args[1].shape)))
            return _inner(*args, **kwargs)

        monkeypatch.setitem(K._CHAINS, fn, counted)


def test_batched_loss_only_evaluation_takes_the_loss_only_plain_version(
        monkeypatch):
    """A stage's log-likelihood over the particles (`torch.func.vmap` with
    gradients disabled) is ONE chain-batched call of `phase_fwd_plain` (the
    loss-only kernel's plain version), and not of the fwd+grad one; each
    particle's value equals its own evaluation.  A batched value-and-
    gradient of the tempered potential is ONE call of the fwd+grad one."""
    _, _, tmodel, td, ref = _phase_case(True)
    tm = TS.init_tempered_model(tmodel, td, seed=3)
    q = torch.stack([tm.sample_prior_u(s) for s in range(5)])
    calls = []
    _counting(monkeypatch, calls, K.phase_fwd_plain, K.phase_fwdgrad_plain)
    with torch.no_grad():
        ll = torch.func.vmap(tm.log_lik_fn)(q)
    assert calls == [("phase_fwd_plain", (5, 10, 3))]
    for c in range(5):
        with torch.no_grad():
            one = tm.log_lik_fn(q[c])
        assert abs(float(ll[c]) - float(one)) < 1e-5 * abs(tm.log_lik_offset)
    calls.clear()

    def pot(u):
        lp, lk = tm.log_parts(u)
        return -(lp + 0.3 * lk)

    v, g = TS._batched_value_and_grad(pot)(q)
    assert calls == [("phase_fwdgrad_plain", (5, 10, 3))]
    assert v.shape == (5,) and g.shape == q.shape


def test_prior_draws_compute_no_likelihood(monkeypatch):
    """A prior draw of `init_tempered_model` stops the model at its last
    latent site: the fused likelihood is not evaluated, and the draw is the
    latent values of the full trace under the same seed."""
    from velocycle_tpu_torch.models import phase as TP

    _, _, tmodel, td, _ = _phase_case(True)
    tm = TS.init_tempered_model(tmodel, td, seed=3)
    calls = []
    fused = TP.nb_loglik_fused
    monkeypatch.setattr(TP, "nb_loglik_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    u = tm.sample_prior_u(11)
    assert calls == []
    tr = th.trace(th.seed(tmodel, 11)).get_trace(td)
    assert calls == [1]
    got = tm.unflatten(u)
    for name in ("nu", "shape_inv"):
        np.testing.assert_allclose(got[name].numpy(),
                                   tr[name]["value"].numpy(), rtol=1e-6)


def test_fused_velocity_smc_runs_on_a_chain_batch():
    """The velocity pair takes the chain axis itself (on the card one
    velo_fwd launch per stage and one velo_fwdgrad per batched
    evaluation): the loss-only plain version mapped over the chains equals
    the per-chain losses, and a short SMC run on fused velocity data (the
    plain versions on the CPU) reaches beta = 1 with finite particles and
    log Z."""
    assert K._CHAINS[K.velo_fwd] is K.velo_fwd
    rng = np.random.default_rng(4)
    Ng, Nc, Kc = 5, 30, 3
    S = torch.as_tensor(rng.poisson(3, (Ng, Nc)).astype(np.int16))
    U = torch.as_tensor(rng.poisson(2, (Ng, Nc)).astype(np.int16))
    f32 = lambda *s: torch.as_tensor(rng.normal(0, 0.3, s).astype(np.float32))  # noqa: E731
    nu, zeta, zdphi = f32(Kc, Ng, 3), f32(Nc, 3), f32(Nc, 3)
    cf, omega, lb, lg = f32(Nc), f32(Nc) + 0.5, f32(Ng), f32(Ng) - 1.0
    r = torch.full((Ng,), 0.3)
    batched = K._CHAINS[K.velo_fwd_plain](S, U, nu, zeta, zdphi, cf, omega,
                                          lb, lg, r, None, None)
    for c in range(Kc):
        one = K.velo_fwd_plain(S, U, nu[c], zeta, zdphi, cf, omega, lb, lg, r)
        assert abs(float(batched[c]) - float(one)) < 1e-5 * abs(float(one))
    sim = V.simulate.simulate_data(Nc=20, Ng=5, seed=3)
    mp = V.preprocess_for_velocity_estimation(
        sim, V.Cycle.trivial_prior(list(sim.var.index), harmonics=1),
        V.Phases.from_angles(sim.obs["simulated_phis"].values,
                             cell_names=list(sim.obs.index)),
        V.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                     stds=0.5),
        n_harmonics=1, omega_n_harmonics=1, with_delta_nu=False,
        model_type="fourier", use_fused_nb=True)
    td = velocity_data_from_jax(mp.data, device="cpu")
    tmodel = th.condition(velocity_model, data={"phi_xy": td.phixy_prior})
    smc = TS.SMC(tmodel, num_particles=16, num_moves=1, max_stages=60)
    smc.run(3, td)
    s = smc.get_samples()
    sched = smc.temperature_schedule
    assert sched[-1] == 1.0 and (np.diff(sched) > 0).all()
    assert np.isfinite(smc.log_evidence())
    assert all(np.isfinite(v).all() for v in s.values())
    assert s["nu"].shape == (16, 5, 3)


def test_smc_runs_on_the_phase_model_and_refuses_a_mesh():
    """tests/test_smc.py's small phase model, cut to 64 particles: the
    schedule rises to 1, the particles are finite and in their supports,
    logZ is finite; over a ("particles",) mesh of two spawned ranks the
    same run gives one log Z on both ranks, within 2 nats of this one."""
    from _torch_parallel_ranks import spawn

    _, _, tmodel, td, _ = _phase_case(True, Nc=20, Ng=8, seed=9)
    smc = TS.SMC(tmodel, num_particles=64, num_moves=2, max_stages=100)
    smc.run(2, td)
    s = smc.get_samples()
    assert s["nu"].shape == (64, 8, 3) and np.isfinite(s["nu"]).all()
    assert s["shape_inv"].min() > 0
    sched = smc.temperature_schedule
    assert sched[-1] == 1.0 and (np.diff(sched) > 0).all()
    assert np.isfinite(smc.log_evidence())
    ranks = spawn(2, [("smc", "smc_phase", (td, 64, 2))])
    log_z = ranks[0]["smc"][0]
    assert ranks[1]["smc"][0] == log_z and np.isfinite(log_z)
    assert abs(log_z - smc.log_evidence()) < 2.0
    assert ranks[0]["smc"][1].shape == (64, 8, 3)


def test_smc_refuses_to_stop_short_of_beta_one():
    def model():
        x = th.sample("x", tdist.Normal(0.0, 1.0))
        th.sample("y", tdist.Normal(x, 0.01).to_event(1),
                  obs=torch.tensor([3.0, 3.1, 2.9]))

    with pytest.raises(RuntimeError, match="did not reach beta=1 in 2 stages"):
        TS.SMC(model, num_particles=32, max_stages=2).run(0)


# ---------------------------------------------------------------------------
# statistical gates of tests/test_smc.py (about a second each here: fast
# lane)
# ---------------------------------------------------------------------------

def test_conjugate_posterior_and_evidence():
    y = torch.tensor([1.0, 1.4, 0.8, 1.2])

    def model():
        x = th.sample("x", tdist.Normal(0.0, 1.0))
        th.sample("y", tdist.Normal(x, 1.0).to_event(1), obs=y)

    smc = TS.SMC(model, num_particles=1024, num_moves=3)
    smc.run(0)
    s = smc.get_samples()
    n = len(y)
    assert abs(s["x"].mean() - float(y.sum()) / (n + 1)) < 0.05
    assert abs(s["x"].std() - math.sqrt(1.0 / (n + 1))) < 0.05
    cov = np.eye(n) + np.ones((n, n))
    logZ_true = st.multivariate_normal(np.zeros(n), cov).logpdf(y.numpy())
    assert abs(smc.log_evidence() - logZ_true) < 0.15
    sched = smc.temperature_schedule
    assert sched[-1] == 1.0 and (np.diff(sched) > 0).all()


def test_positive_support_particles():
    k = torch.tensor([3.0, 5.0, 4.0, 2.0, 6.0])

    def model():
        rate = th.sample("rate", tdist.Gamma(2.0, 1.0))
        th.sample("k", tdist.Poisson(rate * torch.ones(5)).to_event(1), obs=k)

    smc = TS.SMC(model, num_particles=512, num_moves=3)
    smc.run(1)
    rate = smc.get_samples()["rate"]
    assert (rate > 0).all()
    post = st.gamma(a=2 + float(k.sum()), scale=1.0 / (1 + 5))
    assert abs(rate.mean() - post.mean()) < 0.25
    assert abs(rate.std() - post.std()) < 0.15
