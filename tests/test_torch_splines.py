"""The B-spline manifold, port against the JAX package.

`ops/splines.py` (1-D and 2-D bases and derivatives at random points, at
the knots and at both domain ends, and gradients through the recursion),
the `interval` constraint and `Uniform`, `Cycle.spline_prior`, the spline
containers of both preprocessors, and at fixed params the ELBO and every
param gradient of both stages on the plain and the fused path (the fused
one runs the kernels' plain versions here: the 11-column basis of the
default spline; on the card the 11-column kernel instantiations, see
tests/test_torch_gpu.py).  A short two-stage fit gives `period_hours` over
the spline domain equal to the JAX package's at the same params.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import velocycle_tpu as V
from velocycle_tpu.core import constraints as jcons
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.models import phase as jphase
from velocycle_tpu.models import velocity as jvel
from velocycle_tpu.ops import splines as js
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import constraints as tcons
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.models import phase as tphase
from velocycle_tpu_torch.models import velocity as tvel
from velocycle_tpu_torch.models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS,
)
from velocycle_tpu_torch.ops import splines as ts

from _torch_parity import (
    VELO_GRAD_RTOL, assert_elbo_and_grads_close, elbo_and_grads,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the basis
# ---------------------------------------------------------------------------

DOMAIN = (0.2, 1.7)


def _points(knots, n=64, seed=0):
    """Random points in the domain, every knot and both ends."""
    rng = np.random.default_rng(seed)
    lo, hi = float(knots[0]), float(knots[-1])
    x = np.concatenate([rng.uniform(lo, hi, n), np.unique(knots), [lo, hi]])
    return x.astype(np.float32)


@pytest.mark.parametrize("n_basis,degree", [(10, 3), (6, 2), (4, 3), (5, 1)])
@pytest.mark.parametrize("der", [0, 1])
def test_basis_matches_jax_at_points_knots_and_ends(n_basis, degree, der):
    knots = ts.spline_knots(*DOMAIN, n_basis, degree)
    np.testing.assert_array_equal(knots, js.spline_knots(*DOMAIN, n_basis, degree))
    x = _points(knots, seed=n_basis + der)
    got = ts.spline_basis(torch.as_tensor(x), knots, degree, der).numpy()
    want = np.asarray(js.spline_basis(jnp.asarray(x), knots, degree, der))
    assert got.shape == (len(x), n_basis)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if der == 0:
        # partition of unity everywhere, the closed right end included
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
        assert got[-1, -1] == 1.0 and got[-2, 0] == 1.0


def test_second_derivative_is_refused_as_in_jax():
    knots = ts.spline_knots(*DOMAIN, 10, 3)
    for fn, x in ((ts.spline_basis, torch.zeros(3)), (js.spline_basis, jnp.zeros(3))):
        with pytest.raises(ValueError, match="der=2 is not allowed"):
            fn(x, knots, 3, der=2)
    with pytest.raises(ValueError, match="must be > degree"):
        ts.spline_knots(0.0, 1.0, 3, 3)


@pytest.mark.parametrize("domain", [DOMAIN, None])
@pytest.mark.parametrize("der", [0, 1])
def test_basis_auto_matches_jax(domain, der):
    """The constant column (ones; zeros for the derivative); without a
    domain the knots span the data, so the largest point sits at the
    closed end."""
    x = np.random.default_rng(3).uniform(*DOMAIN, 50).astype(np.float32)
    for const in (True, False):
        got = ts.spline_basis_auto(torch.as_tensor(x), der=der, n_basis=10,
                                   domain=domain, include_constant=const)
        want = js.spline_basis_auto(jnp.asarray(x), der=der, n_basis=10,
                                    domain=domain, include_constant=const)
        assert got.shape == (50, 11 if const else 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if der == 0 and domain is None:
        assert got[int(np.argmax(x))].sum() == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("const", [True, False])
def test_basis_2d_and_its_derivatives_match_jax(const):
    kx = ts.spline_knots(0.0, 1.0, 6, 3)
    ky = ts.spline_knots(-1.0, 2.0, 5, 3)
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(0, 1, 40), [0.0, 1.0, 1.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-1, 2, 40), [-1.0, 2.0, -1.0]]).astype(np.float32)
    tx, ty, jx, jy = torch.as_tensor(x), torch.as_tensor(y), jnp.asarray(x), jnp.asarray(y)
    got = ts.spline_basis_2d(tx, ty, kx, ky, degree=3, include_constant=const)
    want = js.spline_basis_2d(jx, jy, kx, ky, degree=3, include_constant=const)
    assert got.shape == (43, 6 * 5 + const)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for g, w in zip(ts.spline_basis_2d_der(tx, ty, kx, ky, 3, const),
                    js.spline_basis_2d_der(jx, jy, kx, ky, 3, const)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("der", [0, 1])
def test_gradient_through_the_recursion_matches_jax(der):
    """d/dx of a weighted sum of basis values, in float32, at random points,
    at the knots and 1e-4 of the domain inside both ends (where the
    spline guide clips its init): finite, and as JAX's autodiff."""
    knots = ts.spline_knots(*DOMAIN, 10, 3)
    eps = 1e-4 * (DOMAIN[1] - DOMAIN[0])
    x = np.concatenate([_points(knots)[:-2], [DOMAIN[0] + eps, DOMAIN[1] - eps]])
    w = np.random.default_rng(1).normal(size=11).astype(np.float32)

    def jf(x):
        return (js.spline_basis_auto(x, der=der, n_basis=10, domain=DOMAIN) @ w).sum()

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tx = torch.as_tensor(x).requires_grad_(True)
    (ts.spline_basis_auto(tx, der=der, n_basis=10, domain=DOMAIN)
     @ torch.as_tensor(w)).sum().backward()
    got = tx.grad.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# the interval constraint and Uniform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.5, 4.0)])
def test_interval_forward_inverse_log_det_match_jax(low, high):
    u = np.linspace(-12, 12, 101).astype(np.float32)
    t, j = tcons.interval(low, high), jcons.interval(low, high)
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    # low + (high - low) * sigmoid(u) cancels where it crosses 0: there one
    # float32 rounding of the operands (a 1e-7 share of the width) shows
    x = t.forward(tu)
    np.testing.assert_allclose(x.numpy(), np.asarray(j.forward(ju)), rtol=1e-6,
                               atol=1e-7 * (high - low))
    np.testing.assert_allclose(t.log_abs_det_jacobian(tu).numpy(),
                               np.asarray(j.log_abs_det_jacobian(ju)), rtol=1e-6)
    inner = np.linspace(low, high, 41).astype(np.float32)
    np.testing.assert_allclose(t.inverse(torch.as_tensor(inner)).numpy(),
                               np.asarray(j.inverse(jnp.asarray(inner))),
                               rtol=1e-6, atol=1e-6)
    # round trip where the sigmoid is not saturated
    mid = torch.as_tensor(u[30:71])
    np.testing.assert_allclose(t.inverse(t.forward(mid)).numpy(), mid.numpy(), atol=1e-4)
    # the log-det is log d forward / du
    ad = torch.func.vmap(torch.func.grad(lambda v: t.forward(v)))(mid)
    np.testing.assert_allclose(t.log_abs_det_jacobian(mid).numpy(),
                               np.log(ad.numpy()), atol=1e-5)
    assert tcons.interval(low, high).name == "interval"


def test_uniform_log_prob_matches_jax():
    rng = np.random.default_rng(2)
    low = rng.uniform(-1, 0, 7).astype(np.float32)
    high = (low + rng.uniform(0.5, 2, 7)).astype(np.float32)
    value = np.concatenate([low, high, (low + high) / 2, low - 0.1, high + 0.1]).reshape(5, 7)
    got = tdist.Uniform(torch.as_tensor(low), torch.as_tensor(high)).log_prob(
        torch.as_tensor(value)).numpy()
    want = np.asarray(jdist.Uniform(jnp.asarray(low), jnp.asarray(high)).log_prob(
        jnp.asarray(value)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    draw = tdist.Uniform(torch.as_tensor(low), torch.as_tensor(high)).sample(3, (4000,))
    assert draw.shape == (4000, 7)
    assert (draw >= torch.as_tensor(low)).all() and (draw <= torch.as_tensor(high)).all()


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def test_cycle_spline_prior_matches_jax():
    genes = [f"g{i}" for i in range(7)]
    for kw in ({}, {"n_basis": 8, "means": 0.5, "stds": 3.0}):
        a = T.Cycle.spline_prior(genes, **kw)
        b = V.Cycle.spline_prior(genes, **kw)
        np.testing.assert_array_equal(a.means_array, b.means_array)
        np.testing.assert_array_equal(a.stds_array, b.stds_array)
        assert a.genes == b.genes


def _spline_counts(Ng=24, Nc=90, n_basis=10, seed=0):
    """Example 04's draw at a small size: pseudotime t ~ U(0, 1), W (Ng,
    n_basis + 1), S and U Poisson from the kinetic ElogU at omega = 0.5;
    one cell at each end of the domain."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, Nc)).astype(np.float32)
    t[0], t[-1] = 0.0, 1.0
    W = rng.normal(0, 0.5, (Ng, n_basis + 1)).astype(np.float32)
    W[:, 0] += 2.0
    B = np.asarray(js.spline_basis_auto(jnp.asarray(t), n_basis=n_basis, domain=(0.0, 1.0)))
    dB = np.asarray(js.spline_basis_auto(jnp.asarray(t), der=1, n_basis=n_basis,
                                         domain=(0.0, 1.0)))
    ElogS = W @ B.T
    kin = (W @ dB.T) * 0.5 + np.exp(rng.normal(0, 0.3, Ng))[:, None]
    ElogU = -2.0 + np.log(np.maximum(kin, 0) + 1e-5) + ElogS
    S = rng.poisson(np.exp(ElogS)).astype(np.float32)
    U = rng.poisson(np.exp(ElogU)).astype(np.float32)
    return t, S, U


def _adata(pkg, S, U):
    Ng, Nc = S.shape
    return pkg.AnnDataLite(
        X=S.T.copy(), layers={"spliced": S.T.copy(), "unspliced": U.T.copy()},
        obs=pd.DataFrame(index=[f"c{i}" for i in range(Nc)]),
        var=pd.DataFrame(index=[f"g{i:03d}" for i in range(Ng)]),
    )


def _spline_mp(pkg, stage, fused, Nhw=1, with_dnu=False, domain=(0.0, 1.0),
               model_type="fourier", noise=0.05, seed=0):
    t, S, U = _spline_counts(seed=seed)
    Ng, Nc = S.shape
    adata = _adata(pkg, S, U)
    genes, cells = list(adata.var.index), list(adata.obs.index)
    rng = np.random.default_rng(seed + 1)
    phases = pkg.Phases.from_angles(np.clip(t + rng.normal(0, noise, Nc), 0, 1),
                                    cell_names=cells)
    kw = dict(basis_kind="spline", spline_domain=domain, use_fused_nb=fused,
              with_delta_nu=with_dnu, noisemodel="NegativeBinomial")
    if with_dnu:
        design = (np.arange(Nc)[:, None] % 2 == np.arange(2)[None, :]).astype(np.int64)
        kw["design_mtx" if stage == 1 else "batch_design_mtx"] = design
    if pkg is T:
        kw["device"] = "cpu"
    if stage == 1:
        cycle = pkg.Cycle.spline_prior(genes, n_basis=10, stds=3.0)
        return pkg.preprocess_for_phase_estimation(adata, cycle, phases, **kw)
    cycle = pkg.Cycle.from_array(
        rng.normal(0, 0.5, (11, Ng)) + np.eye(11, 1).repeat(Ng, 1) * 2.0,
        np.full((11, Ng), 0.5), genes)
    speed = pkg.AngularSpeed.from_array(np.full((Nhw, 1), 0.3), np.full((Nhw, 1), 0.5),
                                        condition_names=["traj"], num_coeffs=Nhw)
    return pkg.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, model_type=model_type, **kw)


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


@pytest.mark.parametrize("fused,with_dnu,domain", [
    (False, False, (0.0, 1.0)), (True, False, None), (True, True, (0.0, 1.0)),
])
def test_phase_container_matches_jax(fused, with_dnu, domain):
    ours = _spline_mp(T, 1, fused, with_dnu=with_dnu, domain=domain)
    theirs = _spline_mp(V, 1, fused, with_dnu=with_dnu, domain=domain)
    _assert_data_equal(ours.data, theirs.data, PHASE_TENSOR_FIELDS)
    assert ours.data.spline_n_basis == 10 and ours.data.mu_nu.shape == (24, 11)
    if domain is None:
        phis = np.asarray(theirs.phase_prior.phis, np.float32)
        assert ours.data.spline_domain == (float(phis.min()), float(phis.max()))
    _assert_data_equal(phase_data_from_jax(theirs.data, device="cpu"),
                       theirs.data, PHASE_TENSOR_FIELDS)


@pytest.mark.parametrize("fused,Nhw,model_type", [
    (False, 1, "fourier"), (True, 1, "fourier"), (True, 5, "lrmn"),
])
def test_velocity_container_matches_jax(fused, Nhw, model_type):
    ours = _spline_mp(T, 2, fused, Nhw=Nhw, model_type=model_type)
    theirs = _spline_mp(V, 2, fused, Nhw=Nhw, model_type=model_type)
    _assert_data_equal(ours.data, theirs.data, VELOCITY_TENSOR_FIELDS)
    assert ours.data.Nhw == Nhw
    _assert_data_equal(velocity_data_from_jax(theirs.data, device="cpu"),
                       theirs.data, VELOCITY_TENSOR_FIELDS)


@pytest.mark.parametrize("pkg", [T, V], ids=["port", "jax"])
def test_spline_preprocessing_refusals(pkg):
    t, S, U = _spline_counts()
    adata = _adata(pkg, S, U)
    genes, cells = list(adata.var.index), list(adata.obs.index)
    phases = pkg.Phases.from_angles(t, cell_names=cells)
    kw = {"device": "cpu"} if pkg is T else {}
    with pytest.raises(ValueError, match="basis_kind='bspline' is not valid"):
        pkg.preprocess_for_phase_estimation(
            adata, pkg.Cycle.spline_prior(genes), phases, basis_kind="bspline", **kw)
    with pytest.raises(ValueError, match="spline basis needs"):
        pkg.preprocess_for_phase_estimation(
            adata, pkg.Cycle.spline_prior(genes, n_basis=3), phases,
            basis_kind="spline", **kw)
    with pytest.raises(ValueError, match="empty spline domain"):
        pkg.preprocess_for_phase_estimation(
            adata, pkg.Cycle.spline_prior(genes), phases, basis_kind="spline",
            spline_domain=(1.0, 1.0), **kw)
    speed = pkg.AngularSpeed.from_array(np.zeros((3, 1)), np.ones((3, 1)), num_coeffs=3)
    with pytest.raises(ValueError, match="speed spline needs"):
        pkg.preprocess_for_velocity_estimation(
            adata, pkg.Cycle.spline_prior(genes), phases, speed,
            basis_kind="spline", **kw)


# ---------------------------------------------------------------------------
# ELBO and param gradients at fixed params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused,with_dnu", [(False, False), (True, False), (True, True)])
def test_stage_one_elbo_and_gradients_match_jax(fused, with_dnu):
    """phi unconditioned: the Delta at interval-constrained phi_locs takes
    its gradient through the basis (dzeta from the fused kernel's plain
    version on the fused path) and the interval bijector."""
    jmp = _spline_mp(V, 1, fused, with_dnu=with_dnu)
    jdata = jmp.data.replace(use_fused_nb=False)
    tdata = phase_data_from_jax(jmp.data, device="cpu")
    eps = {"nu": np.random.default_rng(9).normal(size=jdata.mu_nu.shape)}
    jl, jg, tl, tg = elbo_and_grads(
        jphase.phase_model, jphase.phase_guide, tphase.phase_model,
        tphase.phase_guide, jdata, tdata, eps)
    assert "phi_locs" in tg and np.abs(tg["phi_locs"]).max() > 0
    assert_elbo_and_grads_close(jl, jg, tl, tg)


def _stage_two_eps(jdata, rng):
    Ng, Nx, Nhw = jdata.Ng, jdata.Nx, jdata.Nhw
    eps = {"nu": rng.normal(size=jdata.mu_nu.shape), "log_beta": rng.normal(size=Ng)}
    if jdata.model_type == "lrmn":
        eps["_lrmn_draw"] = (rng.normal(size=jdata.rho_rank),
                             rng.normal(size=Ng + Nx * Nhw))
    else:
        eps.update(log_gamma=rng.normal(size=Ng), nu_omega=rng.normal(size=(Nx, Nhw)))
    return eps


@pytest.mark.parametrize("Nhw,model_type", [(1, "fourier"), (5, "lrmn")])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("conditioned", [False, True])
def test_stage_two_elbo_and_gradients_match_jax(Nhw, model_type, fused, conditioned):
    """A constant speed (Nhw = 1) and a 4-function speed spline (Nhw = 5);
    unconditioned (phi_locs takes its gradient through zeta, zeta_dphi and
    zeta_omega) and conditioned on phi, nu and shape_inv as the two-stage
    workflow conditions stage 2."""
    jmp = _spline_mp(V, 2, fused, Nhw=Nhw, model_type=model_type)
    rng = np.random.default_rng(4)
    cond = None
    if conditioned:
        cond = {"phi": np.asarray(jmp.data.phi_prior),
                "nu": np.asarray(jmp.data.mu_nu) + rng.normal(0, 0.1, jmp.data.mu_nu.shape),
                "shape_inv": rng.uniform(0.2, 0.8, jmp.data.Ng)}
    jdata = jmp.data.replace(use_fused_nb=False)
    tdata = velocity_data_from_jax(jmp.data, device="cpu").replace(
        disp_grad=not (fused and conditioned))
    jguide = getattr(jvel, jmp.guide_fn.__name__)
    tguide = getattr(tvel, jmp.guide_fn.__name__)
    jl, jg, tl, tg = elbo_and_grads(
        jvel.velocity_model, jguide, tvel.velocity_model, tguide, jdata, tdata,
        _stage_two_eps(jdata, rng), cond=cond)
    assert_elbo_and_grads_close(jl, jg, tl, tg, grad_rtol=VELO_GRAD_RTOL)
    # a conditioned site's guide param stays, with no gradient in either
    moved = bool(np.abs(tg["phi_locs"]).max() > 0)
    assert moved is (not conditioned)
    assert bool(np.abs(jg["phi_locs"]).max() > 0) is moved


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_two_stage_spline_fit_and_period_over_the_domain(fused):
    """Stage 1 with phi unconditioned keeps phi_locs inside the domain and
    lowers the loss; stage 2 conditioned on its phi and nu (example 04's
    constant speed) gives the posterior without phi_xy, and period_hours
    (the transit time over the domain) and the extraction equal the JAX
    package's at the same params."""
    mp = _spline_mp(T, 1, fused)
    fit = T.PhaseFitModel(mp, num_samples=3, n_per_bin=3).fit(num_steps=30)
    assert np.isfinite(fit.losses).all() and fit.losses[-5:].mean() < fit.losses[:5].mean()
    phi = fit.params["phi_locs"]
    assert phi.shape == (90,) and (phi > 0).all() and (phi < 1).all()
    assert "phi_xy" not in fit.posterior and fit.posterior["zeta"].shape == (3, 90, 11)
    np.testing.assert_allclose(np.mod(fit.phase_fit.phis, 2 * np.pi), phi, atol=1e-5)

    cond = {"phi": phi, "nu": fit.params["nu_locs"]}
    vmp = _spline_mp(T, 2, fused)
    vfit = T.VelocityFitModel(vmp, condition_on=cond, num_samples=2, n_per_bin=1)
    vfit.fit(num_steps=30)
    assert np.isfinite(vfit.losses).all() and vfit.losses[-5:].mean() < vfit.losses[:5].mean()
    assert "phi_xy" not in vfit.posterior and vfit.posterior["zeta_omega"].shape == (2, 90, 1)
    period = vfit.period_hours(n_grid=200)
    omega = float(vfit.speed_fit.means_array.squeeze())
    np.testing.assert_allclose(period, 1.0 / omega, rtol=1e-5)

    jfit = V.VelocityFitModel(_spline_mp(V, 2, fused), get_posterior=False,
                              condition_on={k: jnp.asarray(v) for k, v in cond.items()})
    jfit.params = dict(vfit.params)
    jfit._extract()
    np.testing.assert_allclose(vfit.period_hours(), jfit.period_hours(), rtol=1e-6)
    np.testing.assert_array_equal(vfit.speed_fit.means_array, jfit.speed_fit.means_array)
    np.testing.assert_array_equal(vfit.cycle_fit.log_gammas, jfit.cycle_fit.log_gammas)
