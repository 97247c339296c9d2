"""The MCMC fit driver (`velocycle_tpu_torch/fit_mcmc.py`) against the JAX
package's (`velocycle_tpu/fit_mcmc.py`).

The warm start's preconditioner from the same SVI params (the SVI run is
replaced by one that returns them, in both packages): init values, the
Hessian diagonal and the per-gene Hessian blocks with their eigenvalue
clamp, rtol 1e-4.  On fused data the warm start takes its curvature
through the plain path on the same counts (the fused likelihood raises).
`_extract` and `period_hours` from the same draws.  A short
`MCMCFitModel` run fills every container; (slow) the phase recovery gate
of tests/test_fit_mcmc.py:50-56.  `SMCFitModel` at tests/test_fit_mcmc.py's
16 genes x 60 cells: the driver test, the evidence that reacts to the
fit of the data, and the variational bridge against prior tempering (logZ
within 2 nats, posterior-mean nu within 0.2, fewer stages), each on the
fused data through the kernels' plain versions.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
import velocycle_tpu.fit_mcmc as JF
from velocycle_tpu.infer import mcmc as JM
import velocycle_tpu_torch as T
import velocycle_tpu_torch.fit_mcmc as TF

PRE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phase_mp(pkg, Nc=40, Ng=12, seed=5, par="xy", fused=False):
    sim = (T.simulate_data if pkg is T else V.simulate.simulate_data)(
        Nc=Nc, Ng=Ng, seed=seed)
    rng = np.random.default_rng(0)
    nu = sim.uns["simulated_nu"]
    cycle = pkg.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                                 np.full((3, Ng), 0.5), list(sim.var.index))
    phases = pkg.Phases.from_angles(sim.obs["simulated_phis"].values, 2.0,
                                    list(sim.obs.index))
    kw = dict(n_harmonics=1, with_delta_nu=False, phi_parametrization=par,
              use_fused_nb=fused)
    if pkg is T:
        kw["device"] = "cpu"
    mp = pkg.preprocess_for_phase_estimation(sim, cycle, phases, **kw)
    mp.true_phis = np.asarray(sim.obs["simulated_phis"].values)
    return mp


def _svi_params(mp, par, rng):
    d = mp.data
    Ng = int(d.Ng)
    p = {"nu_locs": np.asarray(d.mu_nu) + rng.normal(0, 0.1, (Ng, 3)),
         "nu_scales": rng.uniform(0.05, 0.3, (Ng, 3)),
         "shape_inv_locs": rng.uniform(0.2, 0.6, Ng)}
    prior = np.asarray(d.phixy_prior)
    if par == "xy":
        p["phixy_locs"] = prior + rng.normal(0, 0.1, prior.shape)
    else:
        p["phi_locs"] = (np.arctan2(prior[:, 1], prior[:, 0])
                         + rng.normal(0, 0.1, prior.shape[0]))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _fake_svi(params, tensors):
    class FakeSVI:
        def __init__(self, *args, **kwargs):
            pass

        def run(self, *args, **kwargs):
            return None, np.zeros(1, np.float32)

        def get_params(self, state):
            return {k: (torch.as_tensor(v) if tensors else jnp.asarray(v))
                    for k, v in params.items()}

    return FakeSVI


@pytest.mark.parametrize("par,cond,blocks", [
    ("xy", ("phi_xy",), ("nu",)),
    ("wrapped", ("nu", "shape_inv"), ()),
])
def test_warm_start_preconditioner_matches_jax(monkeypatch, par, cond,
                                               blocks):
    """The same SVI params give the same init values and preconditioner:
    with phi_xy conditioned, nu's per-gene 3x3 Hessian blocks (eigenvalues
    clamped at 1) and shape_inv's Hessian diagonal; with the genes
    conditioned, the wrapped phases' Hessian diagonal (circular, so no
    guide scales)."""
    jmp, tmp = _phase_mp(V, par=par), _phase_mp(T, par=par)
    params = _svi_params(jmp, par, np.random.default_rng(1))
    conds = {"phi_xy": np.asarray(jmp.data.phixy_prior),
             "nu": params["nu_locs"], "shape_inv": params["shape_inv_locs"]}
    conds = {k: conds[k] for k in cond}
    monkeypatch.setattr(JF, "SVI", _fake_svi(params, tensors=False))
    monkeypatch.setattr(TF, "SVI", _fake_svi(params, tensors=True))
    jfm = JF.MCMCFitModel(jmp, condition_on=conds, svi_steps=10,
                          block_sites=blocks)
    tfm = TF.MCMCFitModel(tmp, condition_on=conds, svi_steps=10,
                          block_sites=blocks)
    j_init, j_pre = jfm._warm_start(jax.random.PRNGKey(0))
    t_init, t_pre = tfm._warm_start(0)
    assert sorted(t_init) == sorted(j_init)
    for k in j_init:
        np.testing.assert_allclose(np.asarray(t_init[k]),
                                   np.asarray(j_init[k]), rtol=1e-6)
    assert sorted(t_pre) == sorted(j_pre)
    for k in j_pre:
        a, b = np.asarray(t_pre[k]), np.asarray(j_pre[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=PRE_RTOL,
                                   atol=PRE_RTOL * np.abs(b).max(), err_msg=k)


def test_fused_warm_start_needs_the_plain_path_for_curvature(monkeypatch):
    """On fused data the curvature probes cannot run through the fused
    likelihood (it has no second derivative and raises, as in the JAX
    package): the warm start takes them through the plain path on the same
    counts, so its init values and preconditioner are the plain warm
    start's, bit for bit."""
    par = "wrapped"
    tmp = _phase_mp(T, par=par, fused=True)
    plain = _phase_mp(T, par=par)
    params = _svi_params(tmp, par, np.random.default_rng(2))
    conds = {"nu": params["nu_locs"], "shape_inv": params["shape_inv_locs"]}
    monkeypatch.setattr(TF, "SVI", _fake_svi(params, tensors=True))
    fm = TF.MCMCFitModel(tmp, condition_on=conds, svi_steps=10,
                         block_sites=())
    assert fm.metaparams.data.disp_grad is False   # shape_inv conditioned
    info = TF.init_model(fm.model, fm.metaparams.data)
    grad = torch.func.grad(info.potential_fn)
    with pytest.raises(RuntimeError, match="use_fused_nb=False"):
        torch.func.jvp(grad, (info.init_u,), (torch.ones_like(info.init_u),))
    ref = TF.MCMCFitModel(plain, condition_on=conds, svi_steps=10,
                          block_sites=())
    (i1, p1), (i2, p2) = fm._warm_start(0), ref._warm_start(0)
    assert fm.metaparams.data.use_fused_nb     # the chains still run fused
    np.testing.assert_array_equal(p1["phi"], p2["phi"])
    np.testing.assert_array_equal(np.asarray(i1["phi"]),
                                  np.asarray(i2["phi"]))


def _velocity_mp(pkg, Ng=10, Nc=30):
    adata = (T.simulate_data if pkg is T else V.simulate.simulate_data)(
        Nc=Nc, Ng=Ng, seed=7)
    genes = list(adata.var.index)
    cycle = pkg.Cycle.trivial_prior(genes, harmonics=1)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                    cell_names=list(adata.obs.index))
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                           stds=0.5)
    kw = dict(n_harmonics=1, omega_n_harmonics=1, with_delta_nu=False,
              model_type="fourier")
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.preprocess_for_velocity_estimation(adata, cycle, phases, speed,
                                                  **kw)


def test_extract_and_period_hours_match_jax():
    """From the same draws of every latent site of the velocity model: the
    posterior Cycle (means, sds, dispersion, log gammas and betas), the
    mean phases, the AngularSpeed, ElogS / ElogS2 and period_hours."""
    jmp, tmp = _velocity_mp(V), _velocity_mp(T)
    info = JM.init_model(jmp.model_fn, jmp.data, key=jax.random.PRNGKey(0))
    u = np.asarray(info.init_u)[None] + np.random.default_rng(3).normal(
        0, 0.1, (6, info.init_u.shape[0]))
    samples = {k: np.asarray(v) for k, v in jax.vmap(info.unflatten)(
        jnp.asarray(u, jnp.float32)).items()}
    assert {"nu", "phi_xy", "nu_omega", "log_gamma"} <= set(samples)
    jfm, tfm = JF.MCMCFitModel(jmp, svi_steps=0), TF.MCMCFitModel(
        tmp, svi_steps=0)
    jfm._extract(dict(samples))
    tfm._extract(dict(samples))
    jc, tc = jfm.cycle_fit, tfm.cycle_fit
    assert tc.genes == jc.genes
    for attr in ("means_array", "stds_array"):
        np.testing.assert_allclose(getattr(tc, attr), getattr(jc, attr),
                                   rtol=1e-6)
    for attr in ("disp", "log_gammas", "log_betas"):
        a, b = getattr(tc, attr), getattr(jc, attr)
        if b is None:
            assert a is None, attr
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, err_msg=attr)
    np.testing.assert_allclose(tfm.phase_fit.phis, jfm.phase_fit.phis,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tfm.speed_fit.means_array,
                               jfm.speed_fit.means_array, rtol=1e-6)
    for k in ("ElogS", "ElogS2", "phi"):
        np.testing.assert_allclose(tfm.posterior[k], jfm.posterior[k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tfm.period_hours(), jfm.period_hours(),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="nu_omega"):
        TF.MCMCFitModel(_phase_mp(T), svi_steps=0).period_hours()


def test_short_mcmc_fit_fills_every_container():
    mp = _phase_mp(T, Nc=30, Ng=8)
    fm = T.MCMCFitModel(mp, num_chains=2, num_warmup=6, num_samples=4,
                        svi_steps=40, max_depth=3)
    fm.run(0)
    assert fm.cycle_fit.genes == mp.cycle_prior.genes
    assert fm.cycle_fit.disp is not None
    assert fm.posterior["nu"].shape == (8, 8, 3)
    assert fm.posterior["phi_xy"].shape == (8, 30, 2)
    assert fm.posterior["phi"].shape == (8, 30)
    assert fm.posterior["ElogS"].shape == (8, 30)
    assert np.isfinite(fm.posterior["nu"]).all()
    assert len(fm.phase_fit.phis) == 30
    assert set(fm.diagnostics) == {"accept_rate", "max_split_rhat",
                                   "min_ess", "median_ess"}
    assert 0.0 <= fm.diagnostics["accept_rate"] <= 1.0
    assert fm.svi_losses.shape == (40,)


@pytest.mark.slow
def test_mcmc_driver_phase_recovery():
    """tests/test_fit_mcmc.py:40-56 on the port: NUTS-driver posterior
    phases track the simulation truth at 60 cells x 16 genes."""
    mp = _phase_mp(T, Nc=60, Ng=16)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        fm = T.MCMCFitModel(mp, num_chains=4, num_warmup=200,
                            num_samples=150, svi_steps=500)
        fm.run(0)
    finally:
        torch.set_num_threads(n)
    cc = np.abs(np.exp(1j * (fm.phase_fit.phis - mp.true_phis)).mean())
    assert cc > 0.8, cc
    d = fm.diagnostics
    assert 0.3 < d["accept_rate"] <= 1.0
    assert d["min_ess"] > 20.0 and d["max_split_rhat"] < 1.2, d


# ---------------------------------------------------------------------------
# SMCFitModel (tests/test_fit_mcmc.py:125-178)
# ---------------------------------------------------------------------------

NC, NG = 60, 16


@pytest.fixture(scope="module")
def smc_mp():
    return _phase_mp(T, Nc=NC, Ng=NG, fused=True)


def test_smc_driver(smc_mp):
    mp = smc_mp
    sm = T.SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                       num_particles=128, num_moves=2, max_stages=200)
    sm.run(1)
    assert np.isfinite(sm.log_evidence)
    assert sm.temperature_schedule[-1] == pytest.approx(1.0, abs=1e-3)
    assert sm.cycle_fit is not None
    assert sm.posterior["nu"].shape == (128, NG, 3)
    # the conditioned site is NOT in the posterior (it was pinned)
    assert "phi_xy" not in sm.posterior
    # the particles split over two spawned ranks: one log Z on both, within
    # 2 nats of this run's
    from _torch_parallel_ranks import spawn

    ranks = spawn(2, [("fit", "smc_fit", (mp, 128, 1))])
    log_z, sched, nu = ranks[0]["fit"]
    assert ranks[1]["fit"][0] == log_z and np.isfinite(log_z)
    assert abs(log_z - sm.log_evidence) < 2.0
    assert sched[-1] == pytest.approx(1.0, abs=1e-3)
    assert nu.shape == (128, NG, 3)


def test_smc_driver_evidence_reacts_to_data_fit(smc_mp):
    """logZ is much lower for a model conditioned on shuffled (wrong)
    phases than for the true ones: the evidence discriminates."""
    mp = smc_mp
    rng = np.random.default_rng(0)
    good = mp.data.phixy_prior
    bad = good[torch.as_tensor(rng.permutation(NC))]
    sm_good = T.SMCFitModel(mp, condition_on={"phi_xy": good},
                            num_particles=64, num_moves=2,
                            max_stages=200).run(2)
    sm_bad = T.SMCFitModel(mp, condition_on={"phi_xy": bad},
                           num_particles=64, num_moves=2,
                           max_stages=200).run(2)
    assert sm_good.log_evidence > sm_bad.log_evidence + 10


def test_bridged_smc_matches_prior_tempering_logz(smc_mp):
    """The variational-bridge path (svi_steps > 0) estimates the SAME
    log-evidence as prior-to-posterior tempering (within 2 nats of SMC
    noise), and the same posterior, with fewer stages."""
    mp = smc_mp
    cond = {"phi_xy": mp.data.phixy_prior}
    prior_smc = T.SMCFitModel(mp, condition_on=cond, num_particles=256,
                              num_moves=2, max_stages=200).run(1)
    bridged = T.SMCFitModel(mp, condition_on=cond, num_particles=256,
                            num_moves=2, max_stages=60, svi_steps=800).run(2)
    dz = bridged.log_evidence - prior_smc.log_evidence
    assert abs(dz) < 2.0, (bridged.log_evidence, prior_smc.log_evidence)
    assert (len(bridged.temperature_schedule)
            < len(prior_smc.temperature_schedule)), (
        bridged.temperature_schedule, prior_smc.temperature_schedule)
    dmean = np.abs(bridged.posterior["nu"].mean(0)
                   - prior_smc.posterior["nu"].mean(0)).max()
    assert dmean < 0.2, dmean
