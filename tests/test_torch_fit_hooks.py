"""The fit hooks of the port against the JAX package: `SVI.run(callback=)`
with its chunk-size rule, `fit(store_output=...)` snapshots,
`sample_posterior(params=, data=)`, `check_model` / `check_guide` over
`handlers.check_plate_shapes`, and the plots.py hooks (`fit(live_plot=)`
and `polar_plot`).  Both packages fit the same small simulated data on the CPU.

Random streams differ between the packages, so the comparisons are of
structure: the steps the callback sees, the snapshot steps, sites and
shapes, and the exact strings check_plate_shapes reports; losses are
compared with the losses each fit returns (bit for bit)."""
import numpy as np
import pytest
import torch
import jax

import velocycle_tpu as V
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.simulate import simulate_data as j_simulate
import velocycle_tpu_torch as T
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phase_mp(pkg, Ng=6, Nc=20, fused=False):
    adata = (T.simulate_data if pkg is T else j_simulate)(Nc=Nc, Ng=Ng, seed=1)
    cycle = pkg.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                    cell_names=list(adata.obs.index))
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused, **kw)


def _velocity_fit(pkg, Ng=6, Nc=20):
    adata = (T.simulate_data if pkg is T else j_simulate)(Nc=Nc, Ng=Ng, seed=2)
    cycle = pkg.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                    cell_names=list(adata.obs.index))
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2)
    kw = {"device": "cpu"} if pkg is T else {}
    vmp = pkg.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=1, omega_n_harmonics=1,
        with_delta_nu=False, **kw)
    cond = {"nu": np.asarray(vmp.data.mu_nu) + 0.1,
            "phi_xy": np.asarray(vmp.data.phixy_prior),
            "shape_inv": np.full(Ng, 0.4, np.float32)}
    return pkg.VelocityFitModel(vmp, condition_on=cond, num_samples=2, n_per_bin=2)


def _fit(pkg, model, num_steps, **kw):
    if pkg is T:
        return model.fit(num_steps=num_steps, seed=0, **kw)
    return model.fit(num_steps=num_steps, key=jax.random.PRNGKey(0), **kw)


# ---------------------------------------------------------------------------
# SVI.run(callback=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_steps,chunk_size", [(230, None), (7, 3), (40, None)])
def test_svi_callback_sees_chunk_ends_as_jax(num_steps, chunk_size):
    """The callback runs at chunk ends: 100-step chunks when a callback is
    given (the JAX rule), or ``chunk_size``; ``last_loss`` is the loss of
    that chunk's last step."""
    seen = {T: [], V: []}
    losses = {}
    for pkg in (T, V):
        mp = _phase_mp(pkg)
        svi = pkg.infer.SVI(mp.model_fn, mp.guide_fn, pkg.infer.clipped_adam(lr=0.01))
        key = 0 if pkg is T else jax.random.PRNGKey(0)
        _, losses[pkg] = svi.run(
            key, num_steps, mp.data, chunk_size=chunk_size,
            callback=lambda step, state, last, _p=pkg: seen[_p].append((step, float(last))))
    assert [s for s, _ in seen[T]] == [s for s, _ in seen[V]]
    assert seen[T][-1][0] == num_steps
    for step, last in seen[T]:
        assert last == float(losses[T][step - 1])
    assert losses[T].shape == losses[V].shape == (num_steps,)


# ---------------------------------------------------------------------------
# fit(store_output=...) and sample_posterior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["phase", "velocity"])
@pytest.mark.parametrize("num_steps,every", [(20, 10), (25, 10)])
def test_snapshots_match_jax_in_count_steps_and_shapes(stage, num_steps, every):
    calls = {T: [], V: []}
    fits = {}
    for pkg in (T, V):
        model = (pkg.PhaseFitModel(_phase_mp(pkg), num_samples=3)
                 if stage == "phase" else _velocity_fit(pkg))
        fits[pkg] = _fit(pkg, model, num_steps, store_output=True,
                         intermediate_output_step_size=every, store_num_samples=4,
                         callback=lambda s, st, l, _p=pkg: calls[_p].append(s))
    ours, theirs = fits[T].intermediate_output, fits[V].intermediate_output
    assert len(ours) == len(theirs) == -(-num_steps // every)
    assert [s["step"] for s in ours] == [s["step"] for s in theirs] == calls[T] == calls[V]
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        assert "ElogS" not in a and "ElogU" not in a
        for k in a:
            if k != "step":
                assert a[k].shape == np.shape(b[k]) and a[k].shape[0] == 4, k
                assert np.isfinite(a[k]).all(), k
    # each snapshot is the fit's draw at that step's params, seeded by the step
    again = fits[T].sample_posterior(
        num_samples=4, rs=[k for k in ours[-1] if k != "step"], seed=ours[-1]["step"],
        params=fits[T].params)
    for k, v in again.items():
        np.testing.assert_array_equal(v, ours[-1][k])


def test_sample_posterior_takes_params_and_data():
    fit = T.PhaseFitModel(_phase_mp(T), num_samples=2).fit(num_steps=5)
    base = fit.sample_posterior(num_samples=2, rs=["nu", "phi"], seed=3)
    moved = {k: v + (0.5 if k == "nu_locs" else 0.0) for k, v in fit.params.items()}
    shifted = fit.sample_posterior(num_samples=2, rs=["nu", "phi"], seed=3, params=moved)
    np.testing.assert_allclose(shifted["nu"] - base["nu"], 0.5, atol=1e-5)
    np.testing.assert_array_equal(shifted["phi"], base["phi"])
    other = _phase_mp(T, Nc=20).data.replace(use_fused_nb=True)
    same = fit.sample_posterior(num_samples=2, rs=["nu", "phi"], seed=3, data=other)
    np.testing.assert_array_equal(same["nu"], base["nu"])


def test_plots_wait_for_their_port():
    """plots.py is ported: `fit(live_plot=True)` redraws at each chunk end
    and `polar_plot` returns its polar axis (the Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fit = T.PhaseFitModel(_phase_mp(T), get_posterior=False)
    before = len(plt.get_fignums())
    fit.fit(num_steps=4, live_plot=True, intermediate_output_step_size=2)
    assert len(plt.get_fignums()) - before == 2   # one figure per chunk end
    ax = fit.polar_plot()
    assert ax.name == "polar"
    plt.close("all")


# ---------------------------------------------------------------------------
# check_plate_shapes, check_model, check_guide
# ---------------------------------------------------------------------------

def _misplated(pkg, dist, handlers, tensor):
    def model():
        with handlers.plate("genes", 5, dim=-1):
            handlers.sample("a", dist.Normal(tensor(np.zeros(3, np.float32)), 1.0))
        with handlers.plate("cells", 4, dim=-1):
            handlers.sample("b", dist.Normal(tensor(np.zeros(4, np.float32)), 1.0))
        handlers.sample("c", dist.Normal(tensor(np.zeros((2, 3), np.float32)), 1.0)
                        .to_event(1), obs=tensor(np.zeros((3,), np.float32)))
    return model


def test_check_plate_shapes_reports_what_jax_reports():
    ours = th.check_plate_shapes(_misplated(T, tdist, th, torch.as_tensor))
    theirs = jh.check_plate_shapes(_misplated(V, jdist, jh, jax.numpy.asarray))
    assert ours == theirs
    assert len(ours) == 2
    assert "plate 'genes' (size 5) does not appear in value shape (3,)" in ours[0]
    assert "log_prob shape (2,) does not align with value shape (3,)" in ours[1]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("which", ["model", "guide"])
def test_check_model_and_guide_are_clean_as_in_jax(which, fused, capsys):
    ours = T.PhaseFitModel(_phase_mp(T, fused=fused))
    theirs = V.PhaseFitModel(_phase_mp(V, fused=fused))
    assert getattr(ours, f"check_{which}")() == []
    printed = capsys.readouterr().out
    assert getattr(theirs, f"check_{which}")() == []
    assert printed == capsys.readouterr().out
    fn = ours.model if which == "model" else ours.guide
    assert th.check_plate_shapes(fn, ours.metaparams.data) == []


def test_check_model_raises_on_request():
    fit = T.PhaseFitModel(_phase_mp(T))
    misplated = _misplated(T, tdist, th, torch.as_tensor)
    with pytest.raises(ValueError, match="plate 'genes'"):
        fit._check_plates(lambda data: misplated(), raise_on_error=True)
    assert len(fit._check_plates(lambda data: misplated(), raise_on_error=False)) == 2


@pytest.mark.parametrize("stage", ["phase", "velocity"])
def test_fit_takes_verbose_as_jax(stage, capsys):
    """``fit(verbose=...)`` with the JAX package's meaning
    (velocycle_tpu/fit.py `fit`): accepted by both fit models, True and
    False alike, printing nothing beyond what ``log_every`` asks for; the
    losses do not depend on it."""
    losses = {}
    for verbose in (True, False):
        for pkg in (V, T):
            model = (pkg.PhaseFitModel(_phase_mp(pkg), num_samples=2,
                                       n_per_bin=2)
                     if stage == "phase" else _velocity_fit(pkg))
            _fit(pkg, model, 4, verbose=verbose)
            out = capsys.readouterr().out
            if pkg is T:
                assert out == ""
                losses[verbose] = np.asarray(model.losses)
    np.testing.assert_array_equal(losses[True], losses[False])
