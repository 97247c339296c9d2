"""The MCMC engine (`velocycle_tpu_torch/infer/mcmc.py`) against the JAX
package's (`velocycle_tpu/infer/mcmc.py`).

On the same numpy arrays in both packages: the bijections and the named
supports; `init_model`'s sites, baselines and potential (value and
gradient) on the phase model, plain and fused (the fused kernels' plain
versions here), with phi_xy conditioned and with the wrapped phases
sampled; `block_precondition`; the leapfrog; dual averaging; the NUTS
checkpoint arithmetic; split R-hat and ESS.  The second-derivative repair:
Hessian-vector products through the plain phase and velocity paths equal
the JAX package's, and through the fused path both packages raise.  K
chains batched equal K single-chain runs.  The statistical gates of
tests/test_mcmc.py (slow).

Tolerances: bijections, log-dets and supports 1e-6; ``log_offset`` rel
1e-6 on the plain path; the potential rel 1e-5 of the magnitude of the log
joint (|potential - log_offset|) and its gradient max|a-b|/max|a| 1e-4; the
leapfrog rtol 1e-5; diagnostics 1e-12.  The port's fused path is held
against the JAX package's PLAIN path (the same model on float32 counts):
the JAX package's fused NB element cancels in float32 at small dispersion,
and the prior-drawn init has one gene at shape_inv ~1e-3, where the port's
repaired element does not.  There ``log_offset`` holds to rel 5e-6: the
fused likelihood's constant is a float32 sum (``lgamma_k_sum`` precomputed
in float32, the loss rounded to float32), about 12 float32 ulps from the
plain path's float64 sum of per-element baselines at these sizes; the log
joint (the potential less ``log_offset``) and its gradient hold to the
plain path's tolerances.  The fused likelihood and its dispersion gradient
are held against the plain path in float64 at shape_inv down to 1e-5.
"""
import inspect
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu.core import constraints as jc
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import mcmc as JM
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import constraints as tc
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import mcmc as TM
from velocycle_tpu_torch.models.phase import phase_model
from velocycle_tpu_torch.models.velocity import velocity_model
from velocycle_tpu_torch.ops import nb_kernels as K

POT_RTOL = 1e-5
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


# ---------------------------------------------------------------------------
# bijections and supports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("support", ["real", "positive", "unit_interval",
                                     "circular", ("interval", -1.5, 4.0)])
def test_biject_to_forward_inverse_and_log_det_match_jax(support):
    u = np.random.default_rng(0).normal(0, 3, 200).astype(np.float32)
    j, t = jc.biject_to(support), tc.biject_to(support)
    assert t.name == j.name
    tu = torch.as_tensor(u)
    np.testing.assert_allclose(t.forward(tu).numpy(),
                               np.asarray(j.forward(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.log_abs_det_jacobian(tu).numpy(),
                               np.asarray(j.log_abs_det_jacobian(
                                   jnp.asarray(u))), rtol=1e-6, atol=1e-6)
    x = np.asarray(j.forward(jnp.asarray(u)))
    np.testing.assert_allclose(t.inverse(torch.as_tensor(x)).numpy(),
                               np.asarray(j.inverse(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)


def test_circular_forward_wraps_into_the_half_open_period():
    u = torch.tensor([-math.pi, math.pi, 3 * math.pi + 0.1, -7.0])
    x = tc.circular.forward(u)
    assert bool(((x >= -math.pi) & (x < math.pi)).all())
    np.testing.assert_allclose(torch.cos(x).numpy(), torch.cos(u).numpy(),
                               atol=1e-6)


def _dists(pkg):
    d = jdist if pkg == "jax" else tdist
    a = (jnp.asarray if pkg == "jax" else torch.as_tensor)(
        np.array([0.5, 1.5], np.float32))
    return {
        "Normal": d.Normal(a, a),
        "Gamma": d.Gamma(a, a),
        "Poisson": d.Poisson(a),
        "GammaPoisson": d.GammaPoisson(a, a),
        "Beta": d.Beta(a, a),
        "Bernoulli": d.Bernoulli(a * 0.5),
        "Uniform": d.Uniform(a * 0.0, a),
        "VonMises": d.VonMises(a, a),
        "Delta": d.Delta(a),
        "Independent(Gamma)": d.Gamma(a, a).to_event(1),
        "Independent(Beta)": d.Beta(a, a).to_event(1),
    }


def test_distribution_supports_match_jax():
    jd, td = _dists("jax"), _dists("torch")
    for name in jd:
        js, ts = jd[name].support, td[name].support
        if isinstance(js, tuple):
            assert isinstance(ts, tuple) and ts[0] == js[0], name
            for a, b in zip(ts[1:], js[1:]):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-6)
        else:
            assert ts == js, name
        assert td[name].has_rsample == jd[name].has_rsample, name


# ---------------------------------------------------------------------------
# init_model and the potential on the phase model
# ---------------------------------------------------------------------------

NC, NG = 40, 12


def _phase_case(par, fused, Nc=NC, Ng=NG, seed=5):
    """(JAX model, JAX data, port model, port data, init values) of the
    phase model with phi_xy conditioned ("xy") or the genes conditioned
    ("wrapped"); the init values are a JAX prior draw of the latent sites,
    given to both packages."""
    sim = V.simulate.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    rng = np.random.default_rng(0)
    nu = sim.uns["simulated_nu"]
    cycle = V.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                               np.full((3, Ng), 0.5), list(sim.var.index))
    phases = V.Phases.from_angles(sim.obs["simulated_phis"].values, 2.0,
                                  list(sim.obs.index))
    mp = V.preprocess_for_phase_estimation(
        sim, cycle, phases, n_harmonics=1, with_delta_nu=False,
        phi_parametrization=par, use_fused_nb=fused)
    jd = mp.data
    if par == "xy":
        cond = {"phi_xy": np.asarray(jd.phixy_prior)}
    else:
        cond = {"nu": np.asarray(jd.mu_nu),
                "shape_inv": np.full(Ng, 0.3, np.float32)}
    jmodel = jh.condition(mp.model_fn,
                          data={k: jnp.asarray(v) for k, v in cond.items()})
    tdata = phase_data_from_jax(jd, device="cpu")
    if fused and par == "wrapped":
        tdata = tdata.replace(disp_grad=False)
        jd = jd.replace(disp_grad=False)
    tmodel = th.condition(phase_model, data={k: torch.as_tensor(v)
                                             for k, v in cond.items()})
    info0 = JM.init_model(jmodel, jd, key=jax.random.PRNGKey(0))
    init = {k: np.asarray(v) for k, v in info0.unflatten(info0.init_u).items()}
    return jmodel, jd, tmodel, tdata, init


def _jax_vg(info, u):
    v, g = jax.value_and_grad(info.potential_fn)(jnp.asarray(u))
    return float(v), np.asarray(g)


CASES = [("xy", False), ("xy", True), ("wrapped", False), ("wrapped", True)]


@pytest.mark.parametrize("par,fused", CASES)
def test_init_model_potential_and_gradient_match_jax(par, fused):
    jmodel, jd, tmodel, td, init = _phase_case(par, fused)
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    tinfo = TM.init_model(tmodel, td, init_values=init)
    assert list(tinfo.site_meta) == list(jinfo.site_meta)
    for name, (shape, size, c) in jinfo.site_meta.items():
        tshape, tsize, tcn = tinfo.site_meta[name]
        assert (tuple(tshape), tsize, tcn.name) == (tuple(shape), size, c.name)
    np.testing.assert_allclose(tinfo.init_u.numpy(), np.asarray(jinfo.init_u),
                               rtol=1e-6, atol=1e-6)
    if fused:   # the reference: the JAX package's plain path (docstring)
        jmodel, jd = _phase_case(par, False)[:2]
        if par == "wrapped":
            jd = jd.replace(disp_grad=False)
        jinfo = JM.init_model(jmodel, jd, init_values=init)
    off_rtol = 5e-6 if fused else 1e-6
    assert abs(tinfo.log_offset - jinfo.log_offset) < off_rtol * abs(
        jinfo.log_offset), (tinfo.log_offset, jinfo.log_offset)
    vg = TM._batched_value_and_grad(tinfo.potential_fn)
    rng = np.random.default_rng(1)
    for _ in range(3):
        u = (np.asarray(jinfo.init_u)
             + rng.normal(0, 0.05, jinfo.init_u.shape)).astype(np.float32)
        jv, jg = _jax_vg(jinfo, u)
        tv, tg = vg(torch.as_tensor(u)[None])
        # the log joints: each potential less its own baseline constant
        t_joint = float(tv[0]) - tinfo.log_offset
        j_joint = jv - jinfo.log_offset
        assert abs(t_joint - j_joint) < POT_RTOL * abs(j_joint), (t_joint,
                                                                  j_joint)
        assert _rel(tg[0].numpy(), jg) < GRAD_RTOL


def test_baseline_is_one_scalar_on_the_fused_path():
    """subtract_baseline keeps an (Ng, Nc) float32 baseline per observed
    site on the plain path; the fused path observes one ``factor`` site, so
    its baseline is a scalar."""
    for fused in (False, True):
        _, _, tmodel, td, init = _phase_case("xy", fused)
        info = TM.init_model(tmodel, td, init_values=init)
        terms = inspect.getclosurevars(info.potential_fn).nonlocals["terms"]
        b = inspect.getclosurevars(terms).nonlocals["baselines"]
        shapes = {k: tuple(v.shape) for k, v in b.items()}
        if fused:
            assert shapes["S_fused"] == ()
            assert "S" not in shapes
        else:
            assert shapes["S"] == (NG, NC)


def test_init_model_refuses_an_unsupported_support():
    class Odd(tdist.Poisson):
        support = "integers"

    def model():
        th.sample("k", Odd(torch.tensor(2.0)))

    with pytest.raises(ValueError, match="unsupported support"):
        TM.init_model(model)


# ---------------------------------------------------------------------------
# block_precondition
# ---------------------------------------------------------------------------

def test_block_precondition_matches_jax():
    jmodel, jd, tmodel, td, init = _phase_case("xy", False)
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    tinfo = TM.init_model(tmodel, td, init_values=init)
    rng = np.random.default_rng(2)
    A = rng.normal(0, 0.3, (NG, 3, 3))
    blocks = {"nu": np.einsum("bij,bkj->bik", A, A) + 0.05 * np.eye(3),
              "shape_inv": rng.uniform(0.01, 0.2, NG)}
    jp = JM.block_precondition(jinfo, blocks)
    tp = TM.block_precondition(tinfo, blocks)
    assert abs(tp.log_det_scale - jp.log_det_scale) < 1e-9 * max(
        abs(jp.log_det_scale), 1.0)
    assert tp.wrap_fn is None and jp.wrap_fn is None
    vg = TM._batched_value_and_grad(tp.potential_fn)
    for _ in range(3):
        v = rng.normal(0, 1, jp.init_u.shape).astype(np.float32)
        jv, jg = _jax_vg(jp, v)
        tv, tg = vg(torch.as_tensor(v)[None])
        assert abs(float(tv[0]) - jv) < POT_RTOL * abs(jv - jp.log_offset)
        assert _rel(tg[0].numpy(), jg) < GRAD_RTOL
        for k, a in tp.unflatten(torch.as_tensor(v)).items():
            np.testing.assert_allclose(a.numpy(), np.asarray(
                jp.unflatten(jnp.asarray(v))[k]), rtol=1e-5, atol=1e-6)


def test_block_precondition_on_circular_sites_matches_jax_and_refuses_blocks():
    jmodel, jd, tmodel, td, init = _phase_case("wrapped", False)
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    tinfo = TM.init_model(tmodel, td, init_values=init)
    var = np.random.default_rng(3).uniform(0.05, 0.5, NC)
    jp = JM.block_precondition(jinfo, {"phi": var})
    tp = TM.block_precondition(tinfo, {"phi": var})
    v = np.random.default_rng(4).normal(0, 30, NC).astype(np.float32)
    np.testing.assert_allclose(tp.wrap_fn(torch.as_tensor(v)).numpy(),
                               np.asarray(jp.wrap_fn(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tinfo.wrap_fn(torch.as_tensor(v)).numpy(),
                               np.asarray(jinfo.wrap_fn(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-5)
    # the wrap is a period shift: potential and gradient unchanged
    vg = TM._batched_value_and_grad(tp.potential_fn)
    a = vg(torch.as_tensor(v)[None])
    b = vg(tp.wrap_fn(torch.as_tensor(v))[None])
    assert abs(float(a[0][0]) - float(b[0][0])) < 1e-3
    assert _rel(b[1].numpy(), a[1].numpy()) < 1e-3
    cov = np.tile(np.eye(1), (NC, 1, 1))[:, :, :]
    blocks = {"phi": cov}
    for pkg, info in ((JM, jinfo), (TM, tinfo)):
        with pytest.raises(ValueError, match="circular"):
            pkg.block_precondition(info, blocks)


# ---------------------------------------------------------------------------
# leapfrog, dual averaging, NUTS arithmetic, diagnostics
# ---------------------------------------------------------------------------

def test_leapfrog_matches_jax():
    jmodel, jd, tmodel, td, init = _phase_case("xy", False)
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    tinfo = TM.init_model(tmodel, td, init_values=init)
    rng = np.random.default_rng(5)
    dim = jinfo.init_u.shape[0]
    q = np.asarray(jinfo.init_u).astype(np.float32)
    p = rng.normal(0, 1, dim).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, dim).astype(np.float32)
    eps = 0.002
    jvg = jax.value_and_grad(jinfo.potential_fn)
    pot, grad = jvg(jnp.asarray(q))
    jq, jp_, jpot, jgrad = JM._leapfrog(jvg, jnp.asarray(q), jnp.asarray(p),
                                        pot, grad, eps,
                                        jnp.asarray(inv_mass), 10)
    tvg = TM._batched_value_and_grad(tinfo.potential_fn)
    tq0 = torch.as_tensor(q)[None]
    tpot, tgrad = tvg(tq0)
    tq, tp_, tpot, tgrad = TM._leapfrog(
        tvg, tq0, torch.as_tensor(p)[None], tpot, tgrad,
        torch.tensor([eps]), torch.as_tensor(inv_mass)[None], 10)
    np.testing.assert_allclose(tq[0].numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp_[0].numpy(), np.asarray(jp_), rtol=1e-5,
                               atol=1e-4)
    assert abs(float(tpot[0]) - float(jpot)) < POT_RTOL * abs(
        float(jpot) - jinfo.log_offset)


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(6).uniform(0, 1, 120)
    accepts[[5, 50]] = np.nan
    accepts[60:80] = 0.0      # drive the step to the floor: the clip binds
    js = JM._da_init(jnp.asarray(0.1))
    ts = TM._da_init(torch.tensor([0.1], dtype=torch.float64))
    for a in accepts:
        js = JM._da_update(js, jnp.asarray(a))
        ts = TM._da_update(ts, torch.tensor([a], dtype=torch.float64))
        for x, y in zip(ts, js):
            np.testing.assert_allclose(float(x[0]), float(y), rtol=1e-5,
                                       atol=1e-6)


def test_popcount_and_trailing_zeros_match_jax():
    for i in range(1, 700):
        assert TM._popcount(i) == int(JM._popcount(i))
        assert TM._trailing_zeros(i) == int(JM._trailing_zeros(i))
    assert TM._popcount(0) == 0


def test_split_rhat_and_ess_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (4, 200, 5)).cumsum(1) * 0.1 + rng.normal(0, 1, (4, 1, 5))
    np.testing.assert_allclose(TM._split_rhat(x), JM._split_rhat(x),
                               rtol=1e-12)
    np.testing.assert_allclose(TM.effective_sample_size(x),
                               JM.effective_sample_size(x), rtol=1e-12)
    np.testing.assert_allclose(TM._autocov_fft(x), JM._autocov_fft(x),
                               rtol=1e-12, atol=1e-14)
    assert np.isnan(TM.effective_sample_size(x[:, :3])).all()


# ---------------------------------------------------------------------------
# the second-derivative repair
# ---------------------------------------------------------------------------

def _velocity_case(fused):
    sim = V.simulate.simulate_data(Nc=30, Ng=8, seed=7)
    genes = list(sim.var.index)
    cycle = V.Cycle.trivial_prior(genes, harmonics=1)
    phases = V.Phases.from_angles(sim.obs["simulated_phis"].values,
                                  cell_names=list(sim.obs.index))
    speed = V.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                         stds=0.5)
    mp = V.preprocess_for_velocity_estimation(
        sim, cycle, phases, speed, n_harmonics=1, omega_n_harmonics=1,
        with_delta_nu=False, model_type="fourier", use_fused_nb=fused)
    cond = {"phi_xy": np.asarray(mp.data.phixy_prior)}
    jmodel = jh.condition(mp.model_fn,
                          data={k: jnp.asarray(v) for k, v in cond.items()})
    tmodel = th.condition(velocity_model, data={k: torch.as_tensor(v)
                                                for k, v in cond.items()})
    info0 = JM.init_model(jmodel, mp.data, key=jax.random.PRNGKey(0))
    init = {k: np.asarray(v) for k, v in info0.unflatten(info0.init_u).items()}
    return jmodel, mp.data, tmodel, velocity_data_from_jax(mp.data, "cpu"), init


@pytest.mark.parametrize("stage", ["phase", "velocity"])
def test_hessian_vector_products_match_jax_plain_and_raise_fused(stage):
    """The fused likelihood's backward scales gradients computed in its
    forward pass, so it has no second derivative: the plain path's HVPs
    equal the JAX package's, and on the fused path both packages raise
    (the port naming the plain path) instead of dropping the likelihood's
    curvature."""
    for fused in (False, True):
        if stage == "phase":
            jmodel, jd, tmodel, td, init = _phase_case("xy", fused)
        else:
            jmodel, jd, tmodel, td, init = _velocity_case(fused)
        jinfo = JM.init_model(jmodel, jd, init_values=init)
        tinfo = TM.init_model(tmodel, td, init_values=init)
        v = np.random.default_rng(8).normal(
            0, 1, jinfo.init_u.shape).astype(np.float32)
        u = np.asarray(jinfo.init_u)

        def jhvp():
            return np.asarray(jax.jvp(jax.grad(jinfo.potential_fn),
                                      (jnp.asarray(u),), (jnp.asarray(v),))[1])

        tu, tv = torch.as_tensor(u), torch.as_tensor(v)

        def thvp():
            return torch.func.jvp(torch.func.grad(tinfo.potential_fn),
                                  (tu,), (tv,))[1]

        def tdouble():
            x = tu.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(tinfo.potential_fn(x), x,
                                       create_graph=True)
            return torch.autograd.grad((g * tv).sum(), x)[0]

        if not fused:
            ref = jhvp()
            assert _rel(thvp().numpy(), ref) < GRAD_RTOL
            assert _rel(tdouble().numpy(), ref) < GRAD_RTOL
        else:
            with pytest.raises(Exception):
                jhvp()
            for f in (thvp, tdouble):
                with pytest.raises(RuntimeError, match="use_fused_nb=False"):
                    f()


# ---------------------------------------------------------------------------
# the chain batch
# ---------------------------------------------------------------------------

def test_fused_plain_version_takes_a_chain_axis():
    """phase_fwdgrad_plain over a chain batch (each operand batched or
    shared) equals it chain by chain."""
    rng = np.random.default_rng(9)
    Ng, Nc, Kc = 7, 50, 3
    S = torch.as_tensor(rng.poisson(3, (Ng, Nc)).astype(np.int16))
    nu = torch.as_tensor(rng.normal(0.5, 0.3, (Kc, Ng, 3)).astype(np.float32))
    zeta = torch.as_tensor(rng.normal(0, 0.7, (Nc, 3)).astype(np.float32))
    cf = torch.as_tensor(rng.normal(0, 0.2, (Kc, Nc)).astype(np.float32))
    r = torch.as_tensor((np.abs(rng.normal(0.5, 0.2, Ng)) + 0.05
                         ).astype(np.float32))
    dnu = torch.as_tensor(rng.normal(0, 0.1, (Kc, 2, Ng)).astype(np.float32))
    Db = torch.as_tensor((rng.integers(0, 2, Nc)[None] == np.arange(2)[:, None]
                          ).astype(np.float32))
    loss, grads = K.phase_fwdgrad_plain(S, nu, zeta, cf, r, dnu, Db)
    assert loss.shape == (Kc,)
    for c in range(Kc):
        l1, g1 = K.phase_fwdgrad_plain(S, nu[c], zeta, cf[c], r, dnu[c], Db)
        assert abs(float(loss[c]) - float(l1)) < 1e-5 * abs(float(l1))
        for a, b in zip(grads, g1):
            assert _rel(a[c].numpy(), b.numpy()) < 1e-6


def test_fused_velocity_potential_over_a_chain_batch_matches_plain():
    """On the CPU the fused velocity likelihood's chain batch maps its
    plain version over the chains (on the card, ONE chain-batched
    velo_fwdgrad launch): the batched potential and gradient equal the
    plain model path's."""
    out = {}
    for fused in (False, True):
        _, _, tmodel, td, init = _velocity_case(fused)
        info = TM.init_model(tmodel, td, init_values=init)
        q = info.init_u + torch.as_tensor(np.random.default_rng(12).normal(
            0, 0.02, (2, info.init_u.shape[0])).astype(np.float32))
        out[fused] = TM._batched_value_and_grad(info.potential_fn)(q)
        scale = abs(info.log_offset)
    (vp, gp), (vf, gf) = out[False], out[True]
    assert float((vf - vp).abs().max()) < POT_RTOL * scale
    assert _rel(gf.numpy(), gp.numpy()) < GRAD_RTOL


def test_fused_velocity_nuts_samples_a_chain_batch():
    """The velocity pair takes the chain axis itself (on the card one
    velo_fwdgrad launch per batched evaluation; CPU tensors reach no
    kernel): a short NUTS run on fused velocity data, its chains batched
    through the plain version mapped over them, returns finite draws, and
    the batched plain gradient equals the per-chain ones."""
    assert K._CHAINS[K.velo_fwdgrad] is K.velo_fwdgrad
    assert K._CHAINS[K.velo_fwd] is K.velo_fwd
    _, _, tmodel, td, init = _velocity_case(True)
    info = TM.init_model(tmodel, td, init_values=init)
    q = info.init_u + torch.as_tensor(np.random.default_rng(13).normal(
        0, 0.02, (3, info.init_u.shape[0])).astype(np.float32))
    v, g = TM._batched_value_and_grad(info.potential_fn)(q)
    for c in range(3):
        v1, g1 = TM._batched_value_and_grad(info.potential_fn)(q[c:c + 1])
        assert abs(float(v[c]) - float(v1[0])) <= 1e-6 * abs(float(v1[0]))
        assert _rel(g[c].numpy(), g1[0].numpy()) < 1e-5
    draws, acc, step, _ = TM.nuts(info, [1, 2], num_warmup=10, num_samples=5,
                                  max_depth=4)
    assert draws.shape == (2, 5, info.init_u.shape[0])
    assert bool(torch.isfinite(draws).all()) and bool(torch.isfinite(acc).all())


# the (beta, gamma, omega) scale ridge: log_beta + t, log_gamma + t and
# nu_omega e^t leave ElogU as it is but for the relu gate's 1e-5 floor
RIDGE_T = np.linspace(-2.0, 2.0, 9)
VELO_GRAD_RTOL = 5e-4    # the velocity pair's gradient gate, as on the card


def _ridge(u, site_meta):
    """RIDGE_T's points of the scale ridge through the flat point u."""
    out = np.repeat(np.asarray(u, np.float32)[None], len(RIDGE_T), 0)
    i, seen = 0, set()
    for name, (_, size, c) in site_meta.items():
        if name in ("log_beta", "log_gamma", "nu_omega"):
            assert c.name == "real"
            seen.add(name)
            if name == "nu_omega":
                out[:, i:i + size] *= np.exp(RIDGE_T)[:, None]
            else:
                out[:, i:i + size] += RIDGE_T[:, None]
        i += size
    assert seen == {"log_beta", "log_gamma", "nu_omega"}
    return out.astype(np.float32)


def test_velocity_potential_along_the_scale_ridge_fused_plain_and_jax():
    """[mcmc] (c)'s mixing is slow along the scale ridge.  Walked from
    `_velocity_case`'s init point at 9 points of t in [-2, 2], as one chain
    batch: the fused potential (less its baseline constant) within rel 1e-5
    of the plain path's and its gradient within 5e-4 (max|a-b|/max|a|, the
    velocity pair's gate); the plain path against the JAX package's at the
    tolerances of `test_init_model_potential_and_gradient_match_jax`."""
    jmodel, jd, tmodel, td_plain, init = _velocity_case(False)
    td_fused = _velocity_case(True)[3]
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    pinfo = TM.init_model(tmodel, td_plain, init_values=init)
    finfo = TM.init_model(tmodel, td_fused, init_values=init)
    q = _ridge(pinfo.init_u.numpy(), pinfo.site_meta)
    vp, gp = TM._batched_value_and_grad(pinfo.potential_fn)(torch.as_tensor(q))
    vf, gf = TM._batched_value_and_grad(finfo.potential_fn)(torch.as_tensor(q))
    for k, u in enumerate(q):
        p_joint = float(vp[k]) - pinfo.log_offset
        f_joint = float(vf[k]) - finfo.log_offset
        assert abs(f_joint - p_joint) < POT_RTOL * abs(p_joint), (k, f_joint,
                                                                  p_joint)
        assert _rel(gf[k].numpy(), gp[k].numpy()) < VELO_GRAD_RTOL, k
        jv, jg = _jax_vg(jinfo, u)
        j_joint = jv - jinfo.log_offset
        assert abs(p_joint - j_joint) < POT_RTOL * abs(j_joint), (k, p_joint,
                                                                  j_joint)
        assert _rel(gp[k].numpy(), jg) < GRAD_RTOL, k


def _small_phase_info(fused, par="xy"):
    _, _, tmodel, td, init = _phase_case(par, fused, Nc=20, Ng=6)
    return TM.init_model(tmodel, td, init_values=init)


def _every_support():
    th.sample("x", tdist.Normal(torch.zeros(3), 2.0).to_event(1))
    th.sample("y", tdist.Gamma(2.0, 1.0))
    th.sample("p", tdist.Beta(2.0, 5.0))
    th.sample("phi", tdist.VonMises(1.0, 4.0))


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_batched_chains_equal_single_chain_runs(kernel):
    """Three chains in one batch give the three single-chain runs of the
    same seeds: the same accepts over 20 iterations (warmup windows, the
    mass switch and the wrap included) and states within 1e-6.  On a model
    whose potential is elementwise per chain, so that a batched evaluation
    rounds as a single one does (see the next test for the phase model)."""
    info = TM.init_model(_every_support, seed=3)
    jit = torch.as_tensor(np.random.default_rng(10).normal(
        0, 0.5, (3, info.init_u.shape[0])).astype(np.float32))
    seeds = [11, 12, 13]
    run = TM.nuts if kernel == "nuts" else TM.hmc
    kw = dict(num_warmup=10, num_samples=10, step_size=0.3)
    kw.update(max_depth=5) if kernel == "nuts" else kw.update(num_leapfrog=6)
    batched = run(info._replace(init_u=info.init_u + jit), seeds,
                  q_safe=info.init_u, **kw)
    for c, s in enumerate(seeds):
        single = run(info._replace(init_u=info.init_u + jit[c]), s,
                     q_safe=info.init_u, **kw)
        np.testing.assert_allclose(batched[1][c].numpy(), single[1].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(batched[0][c].numpy(), single[0].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(batched[2][c].numpy(), single[2].numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
@pytest.mark.parametrize("fused", [False, True])
def test_batched_chains_equal_single_chain_runs_on_the_phase_model(fused,
                                                                   kernel):
    """Whole runs on the phase model, 8 iterations (warmup windows and
    draws): three chains in one batch against the three single-chain runs
    of the same seeds.  Fused, the chain-batched call (its plain version
    here) rounds each chain as a single call does: states and accept
    probabilities within 1e-6 (measured equal).  Plain, the batched matmuls
    round otherwise than single ones (measured up to 5.3e-5 in the states
    and 9.3e-5 in the accept probabilities): held at 5e-4 and 1e-3."""
    info = _small_phase_info(fused)
    jit = torch.as_tensor(np.random.default_rng(10).normal(
        0, 0.05, (3, info.init_u.shape[0])).astype(np.float32))
    seeds = [11, 12, 13]
    run = TM.nuts if kernel == "nuts" else TM.hmc
    kw = dict(num_warmup=4, num_samples=4, step_size=0.05)
    kw.update(max_depth=4) if kernel == "nuts" else kw.update(num_leapfrog=6)
    batched = run(info._replace(init_u=info.init_u + jit), seeds,
                  q_safe=info.init_u, **kw)
    q_tol, acc_tol = (1e-6, 1e-6) if fused else (5e-4, 1e-3)
    for c, s in enumerate(seeds):
        single = run(info._replace(init_u=info.init_u + jit[c]), s,
                     q_safe=info.init_u, **kw)
        np.testing.assert_allclose(batched[0][c].numpy(), single[0].numpy(),
                                   rtol=0, atol=q_tol)
        np.testing.assert_allclose(batched[1][c].numpy(), single[1].numpy(),
                                   rtol=0, atol=acc_tol)


@pytest.mark.parametrize("fused", [False, True])
def test_batched_potential_equals_single_evaluations_on_the_phase_model(
        fused, monkeypatch):
    """On the phase model a batched evaluation (one batched matmul, or ONE
    chain-batched fused call: the `_FusedNBLogLik.vmap` rule, counted
    here) gives each chain's potential and gradient as its single
    evaluation does, to float32 rounding (whole runs: the test above)."""
    calls = []
    batched_call = K._CHAINS[K.phase_fwdgrad_plain]

    def counted(*args, **kwargs):
        calls.append(args[1].shape)      # nu: (K, Ng, Nh) when batched
        return batched_call(*args, **kwargs)

    monkeypatch.setitem(K._CHAINS, K.phase_fwdgrad_plain, counted)
    info = _small_phase_info(fused)
    vg = TM._batched_value_and_grad(info.potential_fn)
    q = info.init_u + torch.as_tensor(np.random.default_rng(11).normal(
        0, 0.05, (3, info.init_u.shape[0])).astype(np.float32))
    v3, g3 = vg(q)
    assert len(calls) == (1 if fused else 0)
    if fused:
        assert calls[0][0] == 3
    # torch.func's own composition (grad inside vmap) reaches the same
    # chain-batched call through `_FusedNBLogLik.vmap`
    g_f, v_f = torch.func.vmap(torch.func.grad_and_value(info.potential_fn))(q)
    assert len(calls) == (2 if fused else 0)
    assert torch.equal(v_f, v3) and _rel(g_f.numpy(), g3.numpy()) < 1e-6
    for c in range(3):
        v1, g1 = vg(q[c:c + 1])
        assert abs(float(v3[c] - v1[0])) < POT_RTOL * abs(info.log_offset)
        assert _rel(g3[c].numpy(), g1[0].numpy()) < 1e-5


def test_nuts_runs_on_the_wrapped_phases_and_keeps_them_in_the_period():
    info = _small_phase_info(False, par="wrapped")
    q, acc, step, inv_mass = TM.nuts(info, [1, 2], num_warmup=10,
                                     num_samples=5, max_depth=4)
    assert q.shape == (2, 5, info.init_u.shape[0])
    assert bool(((q >= -math.pi) & (q < math.pi)).all())
    assert bool(torch.isfinite(acc).all()) and step.shape == (2,)


def test_mcmc_driver_reuses_the_potential_and_refuses_a_mesh():
    """`MCMC` reuses its potential across runs; over a ("chains",) mesh
    of two spawned ranks (tests/test_torch_parallel_samplers.py has the
    statistics) each rank runs its half of the chains, the same chain seeds,
    and every rank gathers the draws of one process."""
    from _torch_parallel_ranks import gauss, spawn

    def model():
        th.sample("x", tdist.Normal(0.0, 1.0))

    m = TM.MCMC(model, kernel="hmc", num_warmup=4, num_samples=3,
                num_chains=2, num_leapfrog=2)
    m.run(0)
    info = m.model_info
    m.run(1)
    assert m.model_info is info
    assert m.get_samples()["x"].shape == (6,)
    assert m.get_samples(group_by_chain=True)["x"].shape == (2, 3)
    one = TM.MCMC(gauss, kernel="hmc", num_warmup=20, num_samples=10,
                  num_chains=3)
    one.run(5)
    want = one.get_samples(group_by_chain=True)["x"]
    for r in spawn(2, [("x", "gauss_chains", ("hmc", 20, 10, 3, 5))]):
        np.testing.assert_allclose(r["x"][0], want, rtol=1e-5, atol=1e-6)


# the fused likelihood against float64 at small dispersion: its loss to
# 5e-4 nats (the float32 rounding of a loss of ~1,400 nats is ~1e-4) and its
# dispersion gradient to max|a-b|/max|b| 2e-6 (measured at most 5.8e-7, at
# 1e-4, with the gradient's terms taken without cancellation: 1.7e-7 at
# 1e-3, 4.1e-7 at 1e-5, 8.1e-7 at 1e-6; before that form 1.7e-3 at 1e-5);
# the JAX package's fused form is off by 4e-3 nats and 4e-3 at 1e-3, 5e-2
# and 0.5 at 1e-4
SMALL_R_LOSS_ATOL = 5e-4
SMALL_R_GRAD_RTOL = 2e-6


@pytest.mark.parametrize("shape_inv", [1e-6, 1e-5, 1e-4, 1e-3, 1e-2])
def test_fused_likelihood_and_dispersion_gradient_match_float64_at_small_shape_inv(
        shape_inv):
    """The repaired NB element (ROADMAP.md section 3): the fused
    likelihood of the phase model's potential (the kernels' plain version,
    float32, int16 counts, lgamma_k_sum given) and its gradient in every
    gene's shape_inv, spread over a factor 1.8 around ``shape_inv``,
    against the plain path's `nb_loglik_reference` in float64 on the same
    values.  The potential's other terms are the same code on both paths."""
    from velocycle_tpu_torch.models.basis import expression_basis

    _, _, _, td, init = _phase_case("xy", True)
    zeta = expression_basis(td, torch.atan2(td.phixy_prior[:, 1],
                                            td.phixy_prior[:, 0]))
    nu, cf = torch.as_tensor(init["nu"]), td.count_factor
    r = shape_inv * torch.exp(torch.linspace(-0.3, 0.3, NG))
    r32 = r.clone().requires_grad_(True)
    loss = K.nb_loglik_fused(td.S, nu, zeta, cf, r32,
                              lgamma_k_sum=td.lgamma_k_sum)
    (g32,) = torch.autograd.grad(loss, r32)
    r64 = r.double().requires_grad_(True)
    ref = K.nb_loglik_reference(td.S.double(), nu.double(), zeta.double(),
                                cf.double(), r64)
    (g64,) = torch.autograd.grad(ref, r64)
    assert abs(float(loss) - float(ref)) < SMALL_R_LOSS_ATOL, (
        float(loss), float(ref))
    assert _rel(g32.numpy(), g64.numpy()) < SMALL_R_GRAD_RTOL


# ---------------------------------------------------------------------------
# statistical gates of tests/test_mcmc.py
# ---------------------------------------------------------------------------

def _gauss_gamma():
    th.sample("x", tdist.Normal(2.0, 3.0))
    th.sample("y", tdist.Gamma(2.0, 1.0))


@pytest.mark.slow
@pytest.mark.parametrize("kernel", ["hmc", "nuts"])
def test_moments_normal_gamma(kernel):
    m = TM.MCMC(_gauss_gamma, kernel=kernel, num_warmup=500,
                num_samples=1500, num_chains=2)
    m.run(0)
    s = m.get_samples()
    assert abs(s["x"].mean() - 2.0) < 0.3
    assert abs(s["x"].std() - 3.0) < 0.4
    assert abs(s["y"].mean() - 2.0) < 0.25
    assert abs(s["y"].std() - np.sqrt(2.0)) < 0.3
    assert (s["y"] > 0).all()
    summ = m.summary()
    assert float(summ["x"]["rhat"][0]) < 1.1
    assert float(summ["y"]["rhat"][0]) < 1.1
    assert m.accept_rate() > 0.5


@pytest.mark.slow
def test_nuts_circular_von_mises():
    import scipy.stats as st

    def cmodel():
        th.sample("phi", tdist.VonMises(1.0, 4.0))

    m = TM.MCMC(cmodel, kernel="nuts", num_warmup=500, num_samples=2000,
                num_chains=4, init_jitter=0.5)
    m.run(2)
    phi = m.get_samples()["phi"]
    assert (phi >= -np.pi).all() and (phi < np.pi).all()
    z = np.exp(1j * phi).mean()
    R_expected = st.vonmises(kappa=4.0).expect(lambda t: np.cos(t))
    assert abs(np.angle(z) - 1.0) < 0.1
    assert abs(np.abs(z) - R_expected) < 0.04


@pytest.mark.slow
def test_beta_unit_interval_support():
    def bmodel():
        th.sample("p", tdist.Beta(2.0, 5.0))

    m = TM.MCMC(bmodel, kernel="hmc", num_warmup=400, num_samples=1500,
                num_chains=2)
    m.run(3)
    p = m.get_samples()["p"]
    assert (p > 0).all() and (p < 1).all()
    assert abs(p.mean() - 2.0 / 7.0) < 0.05


@pytest.mark.slow
def test_posterior_conditioning():
    y_obs = torch.tensor([1.0, 1.4, 0.8, 1.2])

    def model():
        x = th.sample("x", tdist.Normal(0.0, 1.0))
        th.sample("y", tdist.Normal(x, 1.0).to_event(1), obs=y_obs)

    n = len(y_obs)
    m = TM.MCMC(model, kernel="nuts", num_warmup=500, num_samples=2000,
                num_chains=2)
    m.run(4)
    x = m.get_samples()["x"]
    assert abs(x.mean() - float(y_obs.sum()) / (n + 1)) < 0.06
    assert abs(x.std() - np.sqrt(1.0 / (n + 1))) < 0.06


def test_nb_noise_tool_measures_the_fused_rounding_by_decade():
    """tools/nb_noise.py (the source of ROADMAP's small-dispersion
    numbers) runs on the CPU: one entry per decade of shape_inv, finite; in
    the smallest decade the repaired fused path's noise is below 0.01 nats
    (0.130 before the repair; measured 0.0022, the float32 rounding of the
    loss itself) and its gradient's median error below 0.5% (5.2%
    before)."""
    from velocycle_tpu_torch.tools import nb_noise

    res = nb_noise.line_noise("cpu", n=40)
    assert list(res) == list(nb_noise.DECADES)
    assert all(np.isfinite(v).all() for v in res.values())
    sd, _, g_median, _ = res[nb_noise.DECADES[0]]
    assert sd < 0.01 and g_median < 5e-3, res[nb_noise.DECADES[0]]


def test_nb_noise_tool_holds_both_elements_against_float64():
    """tools/nb_noise.py's dispersion gradients against float64 on the CPU
    (the source of ROADMAP's note on the plain element): one entry per
    shape_inv, finite, both elements within 1e-6 of their largest gradient
    at every shape_inv (the fused measured <= 1.3e-7) and their median
    error over the genes at most 1e-4.  The plain path's element, the
    models' NegativeBinomial log-prob, takes the fused element's gradient
    form (ops.likelihoods.NBLogPmf); differentiated by autograd, as in the
    JAX package's plain path, it cancelled in float32 as shape_inv fell
    (median error 9.1e-2 at 1e-6)."""
    from velocycle_tpu_torch.tools import nb_noise

    fused = nb_noise.disp_grad_error("cpu")
    plain = nb_noise.disp_grad_error("cpu", plain=True)
    for res in (fused, plain):
        assert list(res) == list(nb_noise.SHAPE_INVS)
        assert all(np.isfinite(v).all() for v in res.values())
        assert max(v[0] for v in res.values()) < 1e-6, res
        assert max(v[1] for v in res.values()) <= 1e-4, res
