"""The wrapped phases and LBA gene selection, port against the JAX package.

`VonMises` (log-density and, by statistics, the Best-Fisher sampler with
its 16-proposal budget), `Beta`, `Bernoulli` (with `enumerate_support`),
the wrapped and LBA containers of both preprocessors, and at fixed params
the ELBO and every param gradient of the wrapped phase and velocity stages
(plain and fused), of `phase_model_lba`, and of `phase_model_lba_enum`
under `TraceEnum_ELBO`, against JAX and against the port's own analytic
form.  The `enum` handler and `TraceEnum_ELBO` hold against hand-computed
marginals and refuse what the JAX package refuses.  Short fits: the wrapped
fit's posterior, the enumerated fit, and LBA separating periodic genes from
flat ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.special import betaln, i0e, i1e

import velocycle_tpu as V
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import TraceEnum_ELBO as JEnum
from velocycle_tpu.models import phase as jphase
from velocycle_tpu.models import velocity as jvel
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import TraceEnum_ELBO as TEnum, Trace_ELBO as TELBO
from velocycle_tpu_torch.models import phase as tphase
from velocycle_tpu_torch.models import velocity as tvel
from velocycle_tpu_torch.models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS,
)

from _torch_parity import (
    VELO_GRAD_RTOL, assert_elbo_and_grads_close, elbo_and_grads,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

def test_von_mises_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    loc = rng.uniform(-np.pi, np.pi, 6)
    kappa = np.array([1e-3, 0.5, 2.0, 50.0, 300.0, 3.0])
    value = rng.uniform(-2 * np.pi, 2 * np.pi, (4, 6))
    got = tdist.VonMises(_t(loc), _t(kappa)).log_prob(_t(value)).numpy()
    want = np.asarray(jdist.VonMises(jnp.asarray(loc, jnp.float32),
                                     jnp.asarray(kappa, jnp.float32)).log_prob(
        jnp.asarray(value, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # log(i0e(x)) + |x| cancels at small x (log I0(1e-3) = 2.5e-7): both
    # packages are off there by about one float32 rounding of i0e's result
    for fn, jfn in ((tdist.log_i0, jdist.log_i0), (tdist.log_i1, jdist.log_i1)):
        np.testing.assert_allclose(fn(_t(kappa)).numpy(),
                                   np.asarray(jfn(jnp.asarray(kappa, jnp.float32))),
                                   rtol=1e-6, atol=1.2e-7)


def _circular_stats(x):
    c, s = np.cos(x).mean(), np.sin(x).mean()
    return np.arctan2(s, c), np.hypot(c, s)


@pytest.mark.parametrize("kappa", [0.5, 2.0, 50.0])
def test_von_mises_sampler_matches_jax_by_statistics(kappa):
    """2e5 draws of each package's Best-Fisher sampler (16 proposals): the
    circular means within 0.02 rad of each other and of loc, the mean
    resultant lengths within 0.01 of each other and of I1/I0(kappa).  The
    standard error of a circular mean is 0.0064 rad at kappa = 0.5 and
    smaller above; of a resultant length at most 0.0016."""
    loc, n = 2.9, 200_000
    t = tdist.VonMises(_t(loc), _t(kappa)).sample(11, (n,)).numpy()
    j = np.asarray(jdist.VonMises(jnp.float32(loc), jnp.float32(kappa)).sample(
        jax.random.PRNGKey(11), (n,)))
    assert t.shape == j.shape == (n,)
    assert (t >= -np.pi).all() and (t < np.pi).all()
    (mt, rt), (mj, rj) = _circular_stats(t), _circular_stats(j)
    wrap = lambda d: abs((d + np.pi) % (2 * np.pi) - np.pi)  # noqa: E731
    assert wrap(mt - mj) < 0.02 and wrap(mt - loc) < 0.02, (mt, mj)
    r_true = i1e(kappa) / i0e(kappa)
    assert abs(rt - rj) < 0.01 and abs(rt - r_true) < 0.01, (rt, rj, r_true)


def test_beta_and_bernoulli_log_prob_match_jax():
    rng = np.random.default_rng(1)
    c1, c0 = rng.uniform(0.1, 5, 8), rng.uniform(0.1, 5, 8)
    value = rng.uniform(0.01, 0.99, (3, 8))
    got = tdist.Beta(_t(c1), _t(c0)).log_prob(_t(value)).numpy()
    want = np.asarray(jdist.Beta(jnp.asarray(c1, jnp.float32), jnp.asarray(c0, jnp.float32))
                      .log_prob(jnp.asarray(value, jnp.float32)))
    # the JAX package's float32 betaln is off by up to 1.8e-6 here against
    # float64; the port takes log B in float64: hold it to a float64
    # reference at 1e-6, and to JAX within JAX's own betaln error
    c1, c0, value = (np.float32(x).astype(np.float64) for x in (c1, c0, value))
    ref = ((c1 - 1) * np.log(value) + (c0 - 1) * np.log1p(-value)
           - betaln(c1, c0))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)
    draw = tdist.Beta(_t(2.0), _t(5.0)).sample(3, (20_000,)).numpy()
    assert ((draw > 0) & (draw < 1)).all() and abs(draw.mean() - 2 / 7) < 0.01

    p = np.array([0.0, 1e-9, 0.3, 0.9, 1.0], np.float32)
    b = tdist.Bernoulli(_t(p))
    for v in (np.zeros(5), np.ones(5)):
        np.testing.assert_allclose(
            b.log_prob(_t(v)).numpy(),
            np.asarray(jdist.Bernoulli(jnp.asarray(p)).log_prob(jnp.asarray(v, jnp.float32))),
            rtol=1e-6)
    sup = tdist.Bernoulli(torch.full((3, 1), 0.2)).enumerate_support()
    assert sup.shape == (2, 3, 1)
    assert (sup[0] == 0).all() and (sup[1] == 1).all()
    draw = tdist.Bernoulli(torch.full((20_000,), 0.3)).sample(5).numpy()
    assert set(np.unique(draw)) == {0.0, 1.0} and abs(draw.mean() - 0.3) < 0.02


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def _sim(pkg, Ng, Nc, seed):
    sim = T.simulate_data if pkg is T else V.simulate.simulate_data
    return sim(Nc=Nc, Ng=Ng, seed=seed)


def _phase_mp(pkg, fused=False, with_dnu=False, wrapped=False, lba=False,
              noisemodel="NegativeBinomial", Ng=12, Nc=50, seed=17):
    """test_enum.py's LBA fixture (first harmonic, cycle near the truth)."""
    adata = _sim(pkg, Ng, Nc, seed)
    rng = np.random.default_rng(0)
    nu = adata.uns["simulated_nu"]
    cycle = pkg.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                                 np.full((3, Ng), 0.5), list(adata.var.index))
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                    list(adata.obs.index))
    kw = dict(n_harmonics=1, with_delta_nu=with_dnu, use_fused_nb=fused,
              noisemodel=noisemodel,
              phi_parametrization="wrapped" if wrapped else "xy",
              gene_selection_model="lba" if lba else "all")
    if with_dnu:
        kw["design_mtx"] = (np.arange(Nc)[:, None] % 2
                            == np.arange(2)[None, :]).astype(np.int64)
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.preprocess_for_phase_estimation(adata, cycle, phases, **kw)


def _velocity_mp(pkg, fused=False, Ng=12, Nc=50, seed=17):
    adata = _sim(pkg, Ng, Nc, seed)
    cycle = pkg.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                    list(adata.obs.index))
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2, stds=0.5)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=2, omega_n_harmonics=1,
        with_delta_nu=False, model_type="lrmn", use_fused_nb=fused,
        phi_parametrization="wrapped", **kw)


def _assert_data_equal(ours, theirs, tensor_fields):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name not in tensor_fields:
            assert a == b, (f.name, a, b)
        elif b is None:
            assert a is None, f.name
        else:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("kw", [
    dict(wrapped=True, fused=True), dict(lba=True), dict(lba=True, with_dnu=True),
    dict(lba=True, wrapped=True),
], ids=["wrapped", "lba", "lba-dnu", "lba-wrapped"])
def test_phase_containers_match_jax(kw):
    ours, theirs = _phase_mp(T, **kw), _phase_mp(V, **kw)
    _assert_data_equal(ours.data, theirs.data, PHASE_TENSOR_FIELDS)
    assert ours.model_fn.__name__ == theirs.model_fn.__name__
    assert ours.guide_fn.__name__ == theirs.guide_fn.__name__
    _assert_data_equal(phase_data_from_jax(theirs.data, device="cpu"),
                       theirs.data, PHASE_TENSOR_FIELDS)


def test_velocity_container_wrapped_matches_jax():
    ours, theirs = _velocity_mp(T, True), _velocity_mp(V, True)
    _assert_data_equal(ours.data, theirs.data, VELOCITY_TENSOR_FIELDS)
    assert ours.data.phi_parametrization == "wrapped"


@pytest.mark.parametrize("pkg", [T, V], ids=["port", "jax"])
def test_unknown_gene_selection_model_is_refused(pkg):
    adata = _sim(pkg, 12, 50, 17)
    cycle = pkg.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                    list(adata.obs.index))
    kw = {"device": "cpu"} if pkg is T else {}
    with pytest.raises(ValueError, match="gene_selection_model='mixture' is not a valid model"):
        pkg.preprocess_for_phase_estimation(adata, cycle, phases, n_harmonics=1,
                                            gene_selection_model="mixture", **kw)


# ---------------------------------------------------------------------------
# ELBO and param gradients at fixed params
# ---------------------------------------------------------------------------

def _phase_eps(jdata, rng, xy=True):
    eps = {"nu": rng.normal(size=jdata.mu_nu.shape)}
    if xy:
        eps["phi_xy"] = rng.normal(size=jdata.phixy_prior.shape)
    return eps


@pytest.mark.parametrize("fused", [False, True])
def test_wrapped_stage_one_elbo_and_gradients_match_jax(fused):
    """The VonMises prior at the prior's angles and the Delta at
    unconstrained phi_locs; phi_locs takes its gradient through the
    Fourier basis (dzeta from the fused kernel's plain version)."""
    jmp = _phase_mp(V, fused=fused, wrapped=True)
    jdata = jmp.data.replace(use_fused_nb=False)
    tdata = phase_data_from_jax(jmp.data, device="cpu")
    jl, jg, tl, tg = elbo_and_grads(
        jphase.phase_model, jphase.phase_guide, tphase.phase_model,
        tphase.phase_guide, jdata, tdata,
        _phase_eps(jdata, np.random.default_rng(2), xy=False))
    assert "phi_locs" in tg and "phixy_locs" not in tg
    assert_elbo_and_grads_close(jl, jg, tl, tg)


@pytest.mark.parametrize("fused", [False, True])
def test_wrapped_stage_two_elbo_and_gradients_match_jax(fused):
    """LRMN guide, phi unconditioned: phi_locs takes its gradient through
    zeta, zeta_dphi and zeta_omega."""
    jmp = _velocity_mp(V, fused)
    jdata = jmp.data.replace(use_fused_nb=False)
    tdata = velocity_data_from_jax(jmp.data, device="cpu")
    rng = np.random.default_rng(3)
    Ng, Nx, Nhw = jdata.Ng, jdata.Nx, jdata.Nhw
    eps = {"nu": rng.normal(size=jdata.mu_nu.shape), "log_beta": rng.normal(size=Ng),
           "_lrmn_draw": (rng.normal(size=jdata.rho_rank),
                          rng.normal(size=Ng + Nx * Nhw))}
    jl, jg, tl, tg = elbo_and_grads(
        jvel.velocity_model, jvel.velocity_guide_lrmn, tvel.velocity_model,
        tvel.velocity_guide_lrmn, jdata, tdata, eps)
    assert np.abs(tg["phi_locs"]).max() > 0
    assert_elbo_and_grads_close(jl, jg, tl, tg, grad_rtol=VELO_GRAD_RTOL)


LBA_CASES = [
    dict(), dict(with_dnu=True), dict(noisemodel="Poisson"), dict(wrapped=True),
]
LBA_IDS = ["nb", "nb-dnu", "poisson", "nb-wrapped"]


def _lba_eps(jdata, seed=4):
    return _phase_eps(jdata, np.random.default_rng(seed),
                      xy=jdata.phi_parametrization != "wrapped")


@pytest.mark.parametrize("kw", LBA_CASES, ids=LBA_IDS)
def test_lba_elbo_and_gradients_match_jax(kw):
    jdata = _phase_mp(V, lba=True, **kw).data
    tdata = phase_data_from_jax(jdata, device="cpu")
    jl, jg, tl, tg = elbo_and_grads(
        jphase.phase_model_lba, jphase.phase_guide_lba, tphase.phase_model_lba,
        tphase.phase_guide_lba, jdata, tdata, _lba_eps(jdata))
    assert np.abs(tg["logit_locs"]).max() > 0
    assert_elbo_and_grads_close(jl, jg, tl, tg)


@pytest.mark.parametrize("kw", LBA_CASES, ids=LBA_IDS)
def test_enumerated_lba_matches_jax_and_the_analytic_form(kw):
    """phase_model_lba_enum under TraceEnum_ELBO: against JAX's at the
    stated tolerances, and against the port's analytic phase_model_lba at
    tests/test_enum.py's (loss rtol 1e-5, gradients rtol 1e-4, atol 1e-5)."""
    jdata = _phase_mp(V, lba=True, **kw).data
    tdata = phase_data_from_jax(jdata, device="cpu")
    eps = _lba_eps(jdata)
    jl, jg, tl, tg = elbo_and_grads(
        jphase.phase_model_lba_enum, jphase.phase_guide_lba,
        tphase.phase_model_lba_enum, tphase.phase_guide_lba, jdata, tdata, eps,
        jloss=JEnum(), tloss=TEnum())
    assert_elbo_and_grads_close(jl, jg, tl, tg)
    _, _, al, ag = elbo_and_grads(
        jphase.phase_model_lba, jphase.phase_guide_lba, tphase.phase_model_lba,
        tphase.phase_guide_lba, jdata, tdata, eps)
    assert np.isclose(tl, al, rtol=1e-5), (tl, al)
    for k in ag:
        np.testing.assert_allclose(tg[k], ag[k], rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the enum handler and TraceEnum_ELBO on their own
# ---------------------------------------------------------------------------

def test_trace_enum_matches_the_hand_marginal():
    """A per-row Bernoulli mixture of two Normal means (test_enum.py)."""
    y = torch.tensor([[-1.2], [0.3], [2.1], [1.7]])
    p, mus = 0.3, (-1.0, 2.0)

    def model():
        z = th.sample("z", tdist.Bernoulli(torch.full((4, 1), p)),
                      infer={"enumerate": "parallel"})
        th.sample("y", tdist.Normal(torch.where(z == 1.0, mus[1], mus[0]), 1.0), obs=y)

    loss = float(TEnum().loss(0, model, lambda: None))
    comp = np.stack([np.log1p(-p) + tdist.Normal(mus[0], 1.0).log_prob(y).numpy()[:, 0],
                     np.log(p) + tdist.Normal(mus[1], 1.0).log_prob(y).numpy()[:, 0]])
    assert np.isclose(loss, -np.logaddexp(comp[0], comp[1]).sum(), rtol=1e-6)


def test_trace_enum_counts_independent_factors_once():
    y = torch.tensor([[0.5]])

    def model():
        w = th.sample("w", tdist.Normal(0.0, 1.0))
        z = th.sample("z", tdist.Bernoulli(torch.full((1, 1), 0.4)),
                      infer={"enumerate": "parallel"})
        th.sample("y", tdist.Normal(torch.where(z == 1.0, w, -w), 1.0), obs=y)

    def guide():
        th.sample("w", tdist.Delta(torch.tensor(0.7)))

    loss = float(TEnum().loss(1, model, guide))
    w = 0.7
    lp = lambda m, v: float(tdist.Normal(m, 1.0).log_prob(torch.tensor(v)))  # noqa: E731
    mix = np.logaddexp(np.log(0.6) + lp(-w, 0.5), np.log(0.4) + lp(w, 0.5))
    assert np.isclose(loss, -(lp(0.0, w) + mix), rtol=1e-6)


def _mixed_rank_model(h, d, xp):
    def model():
        h.sample("a", d.Bernoulli(xp.full((3, 1), 0.3)), infer={"enumerate": "parallel"})
        h.sample("b", d.Bernoulli(xp.full((3,), 0.4)), infer={"enumerate": "parallel"})
    return model


def _misaligned_model(h, d, xp):
    def model():
        z = h.sample("z", d.Bernoulli(xp.full((3,), 0.3)), infer={"enumerate": "parallel"})
        mu = xp.where(z == 1.0, 1.0, -1.0)
        h.sample("y", d.Normal(mu[..., None], 1.0), obs=xp.zeros((3, 4)))
    return model


@pytest.mark.parametrize("build,match", [
    (_mixed_rank_model, "batch ndim"), (_misaligned_model, "not broadcast-compatible"),
], ids=["mixed-batch-ranks", "misaligned-factor"])
def test_enum_errors_raise_as_in_jax(build, match):
    """Enumerated sites of different batch ranks, and a factor whose
    trailing axis does not line up with the enumeration profile (which a
    positional reduction would marginalize wrongly): ValueError in both."""
    with pytest.raises(ValueError, match=match):
        JEnum().loss(jax.random.PRNGKey(0), build(jh, jdist, jnp), lambda: None)
    with pytest.raises(ValueError, match=match):
        TEnum().loss(0, build(th, tdist, torch), lambda: None)


def test_enum_leaves_fixed_sites_alone():
    """A conditioned enumerated site keeps its value; enumeration stacks
    the support only where nothing fixed the site."""
    seen = {}

    def model():
        seen["z"] = th.sample("z", tdist.Bernoulli(torch.full((2,), 0.5)),
                              infer={"enumerate": "parallel"})

    th.trace(th.enum(th.condition(model, data={"z": torch.ones(2)}))).get_trace()
    assert seen["z"].shape == (2,)
    tr = th.trace(th.enum(th.seed(model, 0))).get_trace()
    assert tr["z"]["value"].shape == (2, 2) and tr["z"]["infer"]["_enumerated"]


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

def test_wrapped_fit_posterior_has_no_phi_xy():
    """The wrapped fit's posterior Phases come from phi_locs and its
    posterior has no phi_xy site.  The JAX package asks its Predictive for
    phi_xy there and raises KeyError (a known difference, ROADMAP §3)."""
    mp = _phase_mp(T, fused=True, wrapped=True, Ng=20, Nc=80)
    fit = T.PhaseFitModel(mp, num_samples=3, n_per_bin=3).fit(num_steps=30)
    assert np.isfinite(fit.losses).all() and fit.losses[-5:].mean() < fit.losses[:5].mean()
    assert "phi_locs" in fit.params and "phi_xy" not in fit.posterior
    phi = fit.params["phi_locs"]
    np.testing.assert_allclose(np.cos(fit.phase_fit.phis), np.cos(phi), atol=1e-5)
    assert fit.posterior["phi"].shape == (3, 80) and np.isfinite(fit.phase_fit.phi_xy.values).all()
    with pytest.raises(KeyError, match="phi_xy"):
        V.PhaseFitModel(_phase_mp(V, wrapped=True, Ng=20, Nc=80), num_samples=1,
                        n_per_bin=1).fit(num_steps=2)


def test_enumerated_lba_fit_runs_through_the_fit_class():
    """fit(loss=TraceEnum_ELBO()) on the enumerated form: the losses fall
    and equal the analytic form's fit step for step (the same draws)."""
    mp = _phase_mp(T, lba=True)
    enum_mp = dataclasses.replace(mp, model_fn=tphase.phase_model_lba_enum)
    fit = T.PhaseFitModel(enum_mp, num_samples=4, n_per_bin=4).fit(
        num_steps=20, loss=TEnum())
    ref = T.PhaseFitModel(mp, get_posterior=False).fit(num_steps=20, loss=TELBO())
    assert np.isfinite(fit.losses).all() and fit.losses[-5:].mean() < fit.losses[:5].mean()
    np.testing.assert_allclose(fit.losses, ref.losses, rtol=1e-5)
    assert fit.periodic_logits.shape == (12,)
    assert fit.posterior["periodic_prob"].shape == (4, 12)


def _lba_sim(Ng=40, Nc=200, n_flat=20, seed=0):
    """tests/test_variants.py's draw: NB counts whose first Ng - n_flat
    genes have a strong first harmonic and whose last n_flat are flat."""
    rng = np.random.default_rng(seed)
    phis = rng.uniform(0, 2 * np.pi, Nc)
    nu = np.zeros((Ng, 3), np.float32)
    nu[:, 0] = rng.normal(2.0, 0.3, Ng)
    amp = rng.uniform(0.8, 1.5, Ng)
    theta = rng.uniform(0, 2 * np.pi, Ng)
    nu[:-n_flat, 1] = (amp * np.cos(theta))[:-n_flat]
    nu[:-n_flat, 2] = (amp * np.sin(theta))[:-n_flat]
    zeta = np.stack([np.ones_like(phis), np.cos(phis), np.sin(phis)], 1)
    lam = rng.gamma(1.0 / 0.3, 0.3 * np.exp(nu @ zeta.T))
    S = rng.poisson(lam).astype(np.float32)
    adata = T.AnnDataLite(
        X=S.T, obs=pd.DataFrame(index=[f"c{i}" for i in range(Nc)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(Ng)]),
        layers={"spliced": S.T, "unspliced": S.T},
    )
    return adata, phis, n_flat


def test_lba_separates_periodic_from_flat():
    """tests/test_variants.py::test_lba_separates_periodic_from_flat on
    the port, at its gates: 800 steps, posterior membership above 0.8 for
    the periodic genes, below 0.4 for the flat ones."""
    adata, phis, n_flat = _lba_sim()
    Ng = adata.shape[1]
    cycle = T.Cycle.from_array(np.zeros((3, Ng)), np.full((3, Ng), 1.0),
                               list(adata.var.index))
    phases = T.Phases.from_angles(phis, concentration=5.0,
                                  cell_names=list(adata.obs.index))
    mp = T.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        gene_selection_model="lba", device="cpu")
    fit = T.PhaseFitModel(mp, num_samples=20, n_per_bin=20).fit(num_steps=800)
    periodic = fit.periodic
    np.testing.assert_array_equal(periodic, fit.posterior["periodic"].mean(0))
    p_periodic, p_flat = periodic[: Ng - n_flat], periodic[Ng - n_flat:]
    assert p_periodic.mean() > 0.8, p_periodic.mean()
    assert p_flat.mean() < 0.4, p_flat.mean()
    assert p_periodic.mean() - p_flat.mean() > 0.5
