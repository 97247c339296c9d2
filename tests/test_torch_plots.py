"""`velocycle_tpu_torch/plots.py` against the JAX package's
(`velocycle_tpu/plots.py`), on the Agg backend.

  * `check_model`'s site / type / shape table of the phase and velocity
    models (and their guides) equals the JAX package's, line for line (the
    draws differ; the table holds none of them).
  * `pplot`'s scatter offsets (angles and radii) and colours for a `Cycle`
    built from the same arrays equal the JAX package's (atol 1e-6).
  * `plot_elbo` draws the losses given.
  * `fit(live_plot=True)` redraws at each chunk end; `polar_plot` returns
    its polar axis.
"""
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import velocycle_tpu as V  # noqa: E402
from velocycle_tpu import plots as jplots  # noqa: E402
from velocycle_tpu.simulate import simulate_data as j_simulate  # noqa: E402
import velocycle_tpu_torch as T  # noqa: E402
from velocycle_tpu_torch import plots as tplots  # noqa: E402

NG, NC = 8, 30


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _mps(pkg, model_type):
    adata = (T.simulate_data if pkg is T else j_simulate)(Nc=NC, Ng=NG, seed=1)
    genes = list(adata.var.index)
    cycle = pkg.Cycle.trivial_prior(genes, harmonics=1)
    phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                    cell_names=list(adata.obs.index))
    kw = {"device": "cpu"} if pkg is T else {}
    mp = pkg.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False, **kw)
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2)
    vmp = pkg.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=1, omega_n_harmonics=1,
        with_delta_nu=False, model_type=model_type, **kw)
    return mp, vmp


@pytest.mark.parametrize("model_type", ["lrmn", "fourier"])
def test_check_model_tables_equal_jax_line_for_line(model_type, capsys):
    ours, theirs = _mps(T, model_type), _mps(V, model_type)
    for t_mp, j_mp in zip(ours, theirs):
        for fn in ("model_fn", "guide_fn"):
            got = tplots.check_model(getattr(t_mp, fn), t_mp.data)
            want = jplots.check_model(getattr(j_mp, fn), j_mp.data)
            assert got.splitlines() == want.splitlines()
    table = tplots.check_model(ours[1].model_fn, ours[1].data)
    assert "       sample S                        (8, 30) obs" in table
    assert table in capsys.readouterr().out


def _cycle(pkg):
    rng = np.random.default_rng(4)
    genes = ["MCM5", "PCNA", "TOP2A", "CDK1", "G0", "G1", "G2", "G3"]
    means = rng.normal(0, 1, (3, len(genes))).astype(np.float32)
    stds = np.abs(rng.normal(0.5, 0.1, (3, len(genes)))).astype(np.float32)
    return pkg.Cycle.from_array(means, stds, genes)


@pytest.mark.parametrize("kw", [{}, {"show_markers": False},
                                {"min_amplitude": 0.5, "show_names": True}])
def test_pplot_scatters_the_jax_offsets(kw):
    ours = tplots.pplot(_cycle(T), **kw)
    theirs = jplots.pplot(_cycle(V), **kw)
    assert ours.name == theirs.name == "polar"
    assert len(ours.collections) == len(theirs.collections) >= 1
    for a, b in zip(ours.collections, theirs.collections):
        np.testing.assert_allclose(a.get_offsets(), b.get_offsets(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(a.get_facecolors(), b.get_facecolors())
    assert [t.get_text() for t in ours.texts] == [t.get_text()
                                                  for t in theirs.texts]
    plt.close("all")


def test_plot_elbo_draws_the_losses():
    losses = np.linspace(100.0, 10.0, 7)
    ax = tplots.plot_elbo(losses)
    (line,) = ax.get_lines()
    np.testing.assert_array_equal(line.get_ydata(), losses)
    jax_line = jplots.plot_elbo(losses).get_lines()[0]
    np.testing.assert_array_equal(line.get_xdata(), jax_line.get_xdata())
    assert ax.get_ylabel() == "ELBO loss"
    plt.close("all")


def test_live_plot_fit_and_polar_plot():
    mp, _ = _mps(T, "lrmn")
    fit = T.PhaseFitModel(mp, get_posterior=False)
    before = len(plt.get_fignums())
    fit.fit(num_steps=20, live_plot=True, intermediate_output_step_size=10)
    figs = [plt.figure(n) for n in plt.get_fignums()[before:]]
    assert len(figs) == 2                     # one redraw per chunk end
    left = figs[-1].axes[0].get_lines()[0].get_ydata()
    np.testing.assert_allclose(left, fit.losses[[9, 19]], rtol=1e-6)
    assert fit.polar_plot().name == "polar"
    plt.close("all")
