"""The velocity stage end to end, port against the JAX package.

Host layer: `filter_shared_genes` in both modes and every `VelocityData`
field of `preprocess_for_velocity_estimation` equal the JAX package's.
Core: `LowRankMultivariateNormal.log_prob`.  At fixed params carried over
by `convert.py`, with every guide draw built from the same numpy noise in
both packages (Normal sites: loc + scale * eps; the LRMN draw: loc + W eps_w
+ sqrt(D) eps_d), the ELBO and every param gradient agree for the
mean-field and the LRMN guide, on the plain and the fused NB path, with and
without delta_nu, and conditioned as the two-stage workflow conditions
stage 2.  The auxiliary LRMN draw adds no ELBO term and no Predictive site.
A short conditioned `VelocityFitModel` fit runs, its extraction and
`period_hours` equal the JAX package's at the same params, and (slow) the
mean-field fit matches the golden reference fit.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import SVI as JSVI, Trace_ELBO as JELBO
from velocycle_tpu.infer.svi import init_params as j_init_params
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import params_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import SVI as TSVI, Trace_ELBO as TELBO
from velocycle_tpu_torch.infer import Predictive as TPredictive
from velocycle_tpu_torch.models import velocity as tvel
from velocycle_tpu_torch.models.metapars import VELOCITY_TENSOR_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# host layer
# ---------------------------------------------------------------------------

def _simulate(pkg, Ng, Nc, seed=7):
    sim = T.simulate_data if pkg is T else V.simulate.simulate_data
    return sim(Nc=Nc, Ng=Ng, seed=seed)


def _metapars(pkg, fused=False, with_dnu=False, model_type="lrmn", Ng=24,
              Nc=90, normalize=False, behavior="intersection", big_s=False):
    """``big_s``: one spliced count of 40,000, beyond int16, so that the
    fused path keeps S in float32 and compacts U to int16."""
    adata = _simulate(pkg, Ng, Nc)
    if big_s:
        adata.layers["spliced"][3, 2] = 40_000
    genes = list(adata.var.index)
    cycle = pkg.Cycle.trivial_prior(genes, harmonics=2)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                    cell_names=list(adata.obs.index))
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                           stds=0.5)
    kw = dict(n_harmonics=2, omega_n_harmonics=1, with_delta_nu=with_dnu,
              model_type=model_type, use_fused_nb=fused, normalize=normalize,
              behavior=behavior)
    if with_dnu:
        kw["batch_design_mtx"] = (np.arange(Nc)[:, None] % 2
                                  == np.arange(2)[None, :]).astype(np.int64)
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.preprocess_for_velocity_estimation(adata, cycle, phases, speed,
                                                  **kw)


def _assert_velocity_data_equal(ours, theirs):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name not in VELOCITY_TENSOR_FIELDS:
            assert a == b, f.name
        elif b is None:
            assert a is None, f.name
        else:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("fused,with_dnu,model_type,normalize", [
    (True, False, "lrmn", False), (False, True, "fourier", False),
    (True, True, "lrmn", False), (False, False, "lrmn", True),
])
def test_velocity_data_fields_match_jax(fused, with_dnu, model_type,
                                        normalize):
    ours = _metapars(T, fused, with_dnu, model_type, normalize=normalize)
    theirs = _metapars(V, fused, with_dnu, model_type, normalize=normalize)
    _assert_velocity_data_equal(ours.data, theirs.data)
    if fused and not normalize:
        assert ours.data.S.dtype == torch.int16
        assert ours.data.U.dtype == torch.int16
    assert ours.guide_fn.__name__ == theirs.guide_fn.__name__
    assert ours.speed_prior.conditions == ["c0"]
    _assert_velocity_data_equal(
        velocity_data_from_jax(theirs.data, device="cpu"), theirs.data)


def test_mixed_count_dtypes_match_jax():
    """One spliced count beyond int16: both packages keep S in float32 and
    compact U to int16, with equal values (and lgamma_k_sum)."""
    ours = _metapars(T, True, big_s=True)
    theirs = _metapars(V, True, big_s=True)
    _assert_velocity_data_equal(ours.data, theirs.data)
    assert ours.data.S.dtype == torch.float32
    assert ours.data.U.dtype == torch.int16
    assert float(ours.data.S.max()) == 40_000.0


@pytest.mark.parametrize("behavior", ["intersection", "union"])
def test_filter_shared_genes_matches_jax(behavior):
    """The Cycle covers genes 3.. of the AnnData (shuffled order); the
    intersection drops genes 0-2, the union extends the Cycle with flat
    priors for them."""
    out = {}
    for pkg in (T, V):
        adata = _simulate(pkg, 12, 20)
        genes = list(adata.var.index)
        rng = np.random.default_rng(0)
        sub = [genes[i] for i in rng.permutation(np.arange(3, 12))]
        cycle = pkg.Cycle.from_array(rng.normal(size=(5, 9)),
                                     np.abs(rng.normal(size=(5, 9))), sub)
        filt = (T.filter_shared_genes if pkg is T
                else V.preprocessing.filter_shared_genes)
        out[pkg] = filt(cycle, adata, filter_type=behavior)
    (tc, ta), (jc, ja) = out[T], out[V]
    assert tc.genes == jc.genes and list(ta.var.index) == list(ja.var.index)
    np.testing.assert_array_equal(tc.means_array, jc.means_array)
    np.testing.assert_array_equal(tc.stds_array, jc.stds_array)
    np.testing.assert_array_equal(ta.layers["spliced"], ja.layers["spliced"])
    assert len(tc) == (9 if behavior == "intersection" else 12)
    with pytest.raises(ValueError, match="filter_type"):
        T.filter_shared_genes(tc, ta, filter_type="outer")


def test_angularspeed_matches_jax():
    for pkg_args in (dict(harmonics=1, means=0.2, stds=0.5),
                     dict(harmonics=2)):
        a = T.AngularSpeed.trivial_prior(["a", "b"], **pkg_args)
        b = V.AngularSpeed.trivial_prior(["a", "b"], **pkg_args)
        np.testing.assert_array_equal(a.means_array, b.means_array)
        np.testing.assert_array_equal(a.stds_array, b.stds_array)
        assert a.conditions == b.conditions and a.harmonics == b.harmonics
    rng = np.random.default_rng(1)
    for m in (rng.normal(size=(1, 3)), rng.normal(size=3), rng.normal(size=(3, 2))):
        a = T.AngularSpeed.from_array(m, np.abs(m), num_coeffs=3)
        b = V.AngularSpeed.from_array(m, np.abs(m), num_coeffs=3)
        np.testing.assert_array_equal(a.means_array, b.means_array)


# ---------------------------------------------------------------------------
# core: the LRMN family
# ---------------------------------------------------------------------------

def test_lrmn_log_prob_matches_jax():
    rng = np.random.default_rng(4)
    d, rank = 11, 3
    loc = rng.normal(size=d).astype(np.float32)
    W = (rng.normal(size=(d, rank)) * 0.3).astype(np.float32)
    D = (np.abs(rng.normal(size=d)) + 0.1).astype(np.float32)
    values = rng.normal(size=(4, d)).astype(np.float32)
    t = tdist.LowRankMultivariateNormal(*(torch.as_tensor(x) for x in (loc, W, D)))
    j = jdist.LowRankMultivariateNormal(*(jnp.asarray(x) for x in (loc, W, D)))
    np.testing.assert_allclose(t.log_prob(torch.as_tensor(values)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(values))),
                               rtol=1e-5)
    # against the dense covariance, in float64
    cov = W.astype(np.float64) @ W.T + np.diag(D)
    ref = torch.distributions.MultivariateNormal(
        torch.as_tensor(loc, dtype=torch.float64),
        covariance_matrix=torch.as_tensor(cov))
    np.testing.assert_allclose(
        t.log_prob(torch.as_tensor(values)).numpy(),
        ref.log_prob(torch.as_tensor(values, dtype=torch.float64)).numpy(),
        rtol=1e-5)
    draw = t.sample(3, sample_shape=(2000,))
    assert draw.shape == (2000, d)
    np.testing.assert_allclose(draw.mean(0).numpy(), loc, atol=0.1)


# ---------------------------------------------------------------------------
# ELBO and param gradients at fixed params
# ---------------------------------------------------------------------------

def _noise_messenger(base, lrmn_draw):
    """A guide wrapper that builds each listed site's draw from given noise
    (reparameterized, so gradients reach the guide's params), in either
    package's handler DSL."""

    class Noise(base):
        def __init__(self, fn, eps):
            super().__init__(fn)
            self.eps = eps

        def process_message(self, msg):
            if (msg["type"] == "sample" and msg["value"] is None
                    and msg["name"] in self.eps):
                d = getattr(msg["fn"], "base", msg["fn"])
                e = self.eps[msg["name"]]
                if msg["name"] == "_lrmn_draw":
                    msg["value"] = lrmn_draw(d, *e)
                else:
                    msg["value"] = d.loc + d.scale * e

    return Noise


JNoise = _noise_messenger(
    jh.Messenger,
    lambda d, ew, ed: d.loc + d.cov_factor @ ew + jnp.sqrt(d.cov_diag) * ed)
TNoise = _noise_messenger(th.Messenger, lambda d, ew, ed: d.rsample_from(ew, ed))


def _conditioning(jdata, rng):
    return {"nu": (np.asarray(jdata.mu_nu)
                   + rng.normal(0, 0.2, jdata.mu_nu.shape)).astype(np.float32),
            "phi_xy": np.asarray(jdata.phixy_prior, np.float32),
            "shape_inv": rng.uniform(0.2, 0.8, jdata.Ng).astype(np.float32)}


def _elbo_and_grads(jmp, fused_port, conditioned=False, disp_grad=True,
                    jax_fused=False):
    """JAX ELBO and gradients on the plain path (or the fused one) vs the
    port's on the plain (``fused_port=False``) or fused path, at the same
    params and noise."""
    jdata = jmp.data.replace(use_fused_nb=jax_fused)
    rng = np.random.default_rng(0)
    cond = _conditioning(jdata, rng) if conditioned else {}
    jmodel, jguide = V.models.velocity_model, jmp.guide_fn
    tmodel, tguide = tvel.velocity_model, getattr(tvel, jmp.guide_fn.__name__)
    if cond:
        jmodel = jh.condition(jmodel, data={k: jnp.asarray(v) for k, v in cond.items()})
        jguide = jh.block(jguide, hide=list(cond))
        tmodel = th.condition(tmodel, data={k: torch.as_tensor(v) for k, v in cond.items()})
        tguide = th.block(tguide, hide=list(cond))
    params, jcons = j_init_params(jguide, jax.random.PRNGKey(0), jdata)
    params = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
              for k, v in params.items()}
    Ng, Nc, Nx, Nhw = jdata.Ng, jdata.Nc, jdata.Nx, jdata.Nhw
    eps = {"nu": rng.normal(size=jdata.mu_nu.shape),
           "phi_xy": rng.normal(size=jdata.phixy_prior.shape),
           "log_beta": rng.normal(size=Ng)}
    if jdata.model_type == "lrmn":
        eps["_lrmn_draw"] = (rng.normal(size=jdata.rho_rank),
                             rng.normal(size=Ng + Nx * Nhw))
    else:
        eps.update(log_gamma=rng.normal(size=Ng),
                   nu_omega=rng.normal(size=(Nx, Nhw)))
    to_j = lambda e: tuple(jnp.asarray(x, jnp.float32) for x in e) if isinstance(e, tuple) else jnp.asarray(e, jnp.float32)  # noqa: E731
    to_t = lambda e: tuple(torch.as_tensor(x, dtype=torch.float32) for x in e) if isinstance(e, tuple) else torch.as_tensor(e, dtype=torch.float32)  # noqa: E731

    jsvi = JSVI(jmodel, JNoise(jguide, {k: to_j(v) for k, v in eps.items()}),
                None, JELBO())
    jsvi.constraints = jcons
    jl, jg = jax.value_and_grad(jsvi.loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()}, jax.random.PRNGKey(1),
        jdata)

    tdata = velocity_data_from_jax(jmp.data, device="cpu").replace(
        use_fused_nb=fused_port, disp_grad=disp_grad)
    tsvi = TSVI(tmodel, TNoise(tguide, {k: to_t(v) for k, v in eps.items()}),
                None, TELBO())
    _, tsvi.constraints = T.infer.svi.init_params(tsvi.guide, 0, tdata)
    tparams = params_from_jax(params, device="cpu")
    tl = tsvi.loss_fn(tparams, 1, tdata)
    tl.backward()
    tg = {k: (np.zeros_like(v.detach().numpy()) if v.grad is None
              else v.grad.numpy()) for k, v in tparams.items()}
    return float(jl), {k: np.asarray(v) for k, v in jg.items()}, float(tl.detach()), tg


@pytest.mark.parametrize("model_type,fused,with_dnu", [
    ("lrmn", False, False), ("lrmn", True, False), ("lrmn", False, True),
    ("lrmn", True, True), ("fourier", False, False), ("fourier", True, False),
    ("fourier", False, True), ("fourier", True, True),
])
def test_elbo_and_param_gradients_match_jax(model_type, fused, with_dnu):
    """Port plain vs JAX plain, and port fused vs JAX plain.  The JAX
    suite holds fused vs plain at rtol 5e-4 (tests/test_fused_models.py:
    48); here it holds as tight as the phase stage: ELBO rel 1e-5 and
    max|a-b|/max|a| 1e-5 on each param gradient (measured: at most 3.8e-7
    for the ELBO and 7.8e-7 for the gradients, on both paths)."""
    jmp = _metapars(V, fused, with_dnu, model_type)
    jl, jg, tl, tg = _elbo_and_grads(jmp, fused)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
        assert err < 1e-5, (k, err)


@pytest.mark.parametrize("fused", [False, True])
def test_conditioned_stage_two_elbo_matches_jax(fused):
    """The two-stage configuration: nu, phi_xy and shape_inv conditioned,
    LRMN guide, and on the fused path the dispersion gradient compiled out
    (its param gets no gradient in either package)."""
    jmp = _metapars(V, fused, False, "lrmn")
    jl, jg, tl, tg = _elbo_and_grads(jmp, fused, conditioned=True,
                                     disp_grad=not fused)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
        assert err < 1e-5, (k, err)
    for k in ("nu_locs", "phixy_locs", "shape_inv_locs"):
        assert np.abs(tg[k]).max() == 0.0 and np.abs(jg[k]).max() == 0.0


@pytest.mark.parametrize("conditioned", [False, True])
def test_fused_elbo_on_mixed_count_dtypes_matches_jax(conditioned):
    """float32 S beside int16 U on the fused path: the ELBO and every
    param gradient as the JAX package's, at the gates above."""
    jmp = _metapars(V, True, False, "lrmn", big_s=True)
    assert jmp.data.S.dtype == jnp.float32 and jmp.data.U.dtype == jnp.int16
    jl, jg, tl, tg = _elbo_and_grads(jmp, True, conditioned=conditioned,
                                     disp_grad=not conditioned)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
        assert err < 1e-5, (k, err)


def test_lrmn_draw_is_auxiliary_in_elbo_and_predictive():
    mp = _metapars(T)
    data = mp.data
    tr = th.trace(th.seed(tvel.velocity_guide_lrmn, 3)).get_trace(data)
    assert tr["_lrmn_draw"]["infer"] == {"is_auxiliary": True}
    # the ELBO's guide term: every non-auxiliary site, nothing else
    lrmn_term = tr["_lrmn_draw"]["fn"].log_prob(tr["_lrmn_draw"]["value"]).sum()
    assert float(lrmn_term) != 0.0
    want = sum(s["fn"].log_prob(s["value"]).sum() for n, s in tr.items()
               if s["type"] == "sample" and n != "_lrmn_draw")
    from velocycle_tpu_torch.infer.elbo import _logp_sum

    assert float(_logp_sum(tr)) == float(want)
    pred = TPredictive(tvel.velocity_model, guide=tvel.velocity_guide_lrmn,
                       num_samples=2)(5, data)
    assert "_lrmn_draw" not in pred
    assert pred["log_gamma"].shape == (2, data.Ng)
    assert pred["nu_omega"].shape == (2, data.Nx, data.Nhw)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

def _stage_two(fused, model_type="lrmn", Ng=20, Nc=100):
    mp = _metapars(T, fused, False, model_type, Ng=Ng, Nc=Nc)
    rng = np.random.default_rng(2)
    cond = {"nu": mp.data.mu_nu.numpy() + rng.normal(0, 0.2, (Ng, 5)),
            "phi_xy": mp.data.phixy_prior.numpy(),
            "shape_inv": np.full(Ng, 0.4)}
    return mp, cond


@pytest.mark.parametrize("fused", [False, True])
def test_conditioned_velocity_fit_runs_and_extracts(fused):
    mp, cond = _stage_two(fused)
    fit = T.VelocityFitModel(mp, condition_on=cond, num_samples=3, n_per_bin=2)
    assert fit.metaparams.data.disp_grad is (not fused)
    fit.fit(num_steps=30)
    losses = fit.losses
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert fit.speed_fit.means.shape == (3, 1)
    assert fit.speed_fit.conditions == ["c0"]
    assert np.isfinite(fit.speed_fit.means_array).all()
    assert fit.cycle_fit.log_gammas.shape == (20,)
    periods = fit.period_hours()
    assert periods.shape == (1,) and np.isfinite(periods).all()
    post = fit.posterior
    want = {"log_gamma": (3, 20), "log_beta": (3, 20), "nu_omega": (3, 1, 3),
            "gamma": (3, 20), "phi": (3, 100), "zeta": (3, 100, 5),
            "zeta_dphi": (3, 100, 5), "zeta_omega": (3, 100, 3),
            "omega": (3, 100), "ElogS": (3, 20, 100), "ElogU": (3, 20, 100),
            "rho_real": (3, 20)}
    assert sorted(post) == sorted(want)
    for k, shape in want.items():
        assert post[k].shape == shape and np.isfinite(post[k]).all(), k
    # same seed, same fit: bit-reproducible
    again = T.VelocityFitModel(mp, condition_on=cond, get_posterior=False)
    np.testing.assert_array_equal(again.fit(num_steps=30).losses, losses)


def test_fused_and_plain_velocity_fits_track_each_other():
    """use_fused_nb is a performance switch: same seed, same draws, losses
    equal to rtol 5e-4 step for step (tests/test_fused_models.py:48)."""
    runs = []
    for fused in (False, True):
        mp, cond = _stage_two(fused)
        fit = T.VelocityFitModel(mp, condition_on=cond, get_posterior=False)
        runs.append(fit.fit(num_steps=10).losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=5e-4)


@pytest.mark.parametrize("model_type", ["lrmn", "fourier"])
def test_extraction_and_period_match_jax_at_the_same_params(model_type):
    mp, cond = _stage_two(False, model_type)
    fit = T.VelocityFitModel(mp, condition_on=cond, get_posterior=False)
    fit.fit(num_steps=5)
    jfit = V.VelocityFitModel(_metapars(V, False, False, model_type, Ng=20,
                                        Nc=100),
                              condition_on=cond, get_posterior=False)
    jfit.params = dict(fit.params)
    jfit._extract()
    for a, b in ((fit.speed_fit, jfit.speed_fit), (fit.cycle_fit, jfit.cycle_fit)):
        np.testing.assert_array_equal(a.means_array, b.means_array)
        np.testing.assert_array_equal(a.stds_array, b.stds_array)
    np.testing.assert_array_equal(fit.cycle_fit.log_gammas,
                                  jfit.cycle_fit.log_gammas)
    np.testing.assert_array_equal(fit.log_gamma_sd, jfit.log_gamma_sd)
    np.testing.assert_allclose(fit.period_hours(), jfit.period_hours(),
                               rtol=1e-6)
    np.testing.assert_allclose(fit.period_hours(n_grid=64),
                               jfit.period_hours(n_grid=64), rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("big_s", [False, True])
def test_fused_elbo_matches_jax_fused_interpret_mode(big_s):
    """Port fused vs the JAX package's fused (interpret-mode Pallas) path;
    ``big_s``: float32 S beside int16 U."""
    jmp = _metapars(V, True, True, "lrmn", big_s=big_s)
    jl, jg, tl, tg = _elbo_and_grads(jmp, True, jax_fused=True)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    for k in jg:
        err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
        assert err < 1e-5, (k, err)


def _golden_velocity_metapars(pkg, model_type, fused):
    """The golden configuration of tools/golden_vs_reference.py (simulated
    data with true omega 0.4), stage 2 conditioned on the phase artifact."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import golden_vs_reference as gold

    simulate = T.simulate_data if pkg is T else V.simulate.simulate_data
    adata = simulate(Nc=gold.NC, Ng=gold.NG, omegas_to_test=(0.4,),
                     seed=gold.SEED)
    nu_means, nu_stds, _ = gold._priors(adata)
    cond = gold.velocity_conditioning()
    cycle = pkg.Cycle.from_array(nu_means, nu_stds, list(adata.var.index))
    phases = pkg.Phases.from_angles(
        np.arctan2(cond["phi_xy"][:, 1], cond["phi_xy"][:, 0]),
        concentration=2.0, cell_names=list(adata.obs.index))
    speed = pkg.AngularSpeed.trivial_prior(
        ["c0"], harmonics=gold.OMEGA_HARMONICS, means=0.2, stds=0.5)
    kw = dict(n_harmonics=gold.HARMONICS,
              omega_n_harmonics=gold.OMEGA_HARMONICS, with_delta_nu=False,
              model_type=model_type, use_fused_nb=fused)
    if pkg is T:
        kw["device"] = "cpu"
    mp = pkg.preprocess_for_velocity_estimation(adata, cycle, phases, speed,
                                                **kw)
    return mp, {k: v.astype(np.float32) for k, v in cond.items()}, gold


@pytest.mark.slow
def test_lrmn_fit_recovers_the_speed_as_jax_does():
    """The two-stage configuration (LRMN guide, shape_inv conditioned) on
    simulated data with a true speed of 0.4: the port's fused fit and the
    JAX package's plain fit, 3000 steps each, land on the same speed,
    period and degradation rates.  Random streams differ, so the gates are
    Monte-Carlo ones: the golden log_gamma correlation > 0.95, omega_0
    within 0.03 and the period within 5%."""
    fits = {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for pkg, fused in ((T, True), (V, False)):
            mp, cond, gold = _golden_velocity_metapars(pkg, "lrmn", fused)
            fit = pkg.VelocityFitModel(mp, condition_on=cond,
                                       get_posterior=False)
            if pkg is T:
                fit.fit(num_steps=3000, seed=0)
            else:
                fit.fit(num_steps=3000, key=jax.random.PRNGKey(0))
            fits[pkg] = (fit.speed_fit.means_array[0], fit.period_hours()[0],
                         np.asarray(fit.cycle_fit.log_gammas))
    finally:
        torch.set_num_threads(n_threads)
    (tw, tp, tg), (jw, jp, jg) = fits[T], fits[V]
    corr = float(np.corrcoef(tg, jg)[0, 1])
    print(f"port omega {tw} period {tp:.4f}; JAX omega {jw} period "
          f"{jp:.4f}; log_gamma corr {corr:.4f}")
    assert abs(tw[0] - 0.4) < 0.1 and abs(tw[0] - jw[0]) < 0.03, (tw, jw)
    assert abs(tp / jp - 1) < 0.05, (tp, jp)
    assert corr > gold.LOG_GAMMA_CORR_MIN, corr


@pytest.mark.slow
def test_port_velocity_fit_matches_reference_golden():
    """The mean-field velocity fit against tests/golden/
    reference_velocity_fit.npz with the gates of
    tools/golden_vs_reference.py (compare_velocity)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        mp, cond, gold = _golden_velocity_metapars(T, "fourier", False)
        fit = T.VelocityFitModel(mp, condition_on=cond, get_posterior=False)
        fit.fit(num_steps=gold.VELO_NUM_STEPS, seed=0)
    finally:
        torch.set_num_threads(n_threads)
    p = fit.params
    ours = {
        "log_gamma_mean": p["log_gamma_locs"],
        "log_gamma_sd": p["log_gamma_scales"],
        "log_beta_mean": p["log_beta_locs"],
        "log_beta_sd": p["log_beta_scales"],
        "nu_omega_mean": p["nu_omega_locs"].reshape(-1),
        "nu_omega_sd": p["nu_omega_scales"].reshape(-1),
    }
    gold.compare_velocity(jax_moments=ours, verbose=False)
