"""The support modules of the port (`velocycle_tpu_torch/checkpoint.py`,
`warmup.py`, `profiling.py`, `convert.svi_state_from_jax`) against the JAX
package's, the cases of tests/test_checkpoint_profiling.py and
tests/test_warmup.py on the CPU.

  * The ``.npz`` round trip is bit-equal; the toy fit the JAX tests save
    reaches the JAX package's params (atol 5e-6: Adam's float64 bias
    corrections, ROADMAP section 3).
  * Restore at step k, then N - k updates, equals N uninterrupted updates
    bit for bit on the phase model at 40 genes x 300 cells with fused data
    (the kernels' plain versions on the CPU); `latest_step`,
    ``restore(step=)``, the orbax refusal and the missing checkpoint.
  * A JAX `SVIState` carried into the port takes one ClippedAdam update as
    the JAX package's does (atol 5e-6, the bias-correction difference).
  * `StepTimer`'s summary has the JAX package's keys; `trace` writes a file
    that names an `annotate` region; `device_memory_stats`.
  * `warmup`'s keys, its conditioning (the conditioned site is observed in
    the model and absent from the blocked guide; the params are those of
    the JAX package's conditioned pair), ``num_steps=0``;
    `_chunk_lengths` equal to the JAX package's and to the chunks the
    port's `SVI.run` takes; `enable_compile_cache`.
"""
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu import checkpoint as jckpt
from velocycle_tpu.core import handlers as jh
from velocycle_tpu import profiling as jprof
from velocycle_tpu.infer import SVI as JSVI, Trace_ELBO as JELBO
from velocycle_tpu.infer import clipped_adam as j_clipped_adam
from velocycle_tpu.warmup import _chunk_lengths as j_chunk_lengths
import velocycle_tpu_torch as T
from velocycle_tpu_torch import checkpoint as tckpt
from velocycle_tpu_torch import profiling as tprof
from velocycle_tpu_torch.convert import svi_state_from_jax
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import svi as tsvi
from velocycle_tpu_torch.ops import cuda_build
from velocycle_tpu_torch.warmup import _chunk_lengths

Y = np.asarray([1.0, 2.0, 1.5], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(pkg, optim):
    """tests/test_checkpoint_profiling.py's toy fit in either package: mu ~
    N(0, 10), y ~ N(mu, 1); a Delta guide at param ``loc``; five steps."""
    if pkg == "jax":
        from velocycle_tpu.core import distributions as dist
        from velocycle_tpu.core.handlers import param, sample
        from velocycle_tpu.infer import SVI, Trace_ELBO, adam
        zeros, y, key = jnp.zeros, jnp.asarray(Y), jax.random.PRNGKey(0)
    else:
        from velocycle_tpu_torch.core import distributions as dist
        from velocycle_tpu_torch.core.handlers import param, sample
        from velocycle_tpu_torch.infer import SVI, Trace_ELBO, adam
        zeros, y, key = torch.zeros, torch.as_tensor(Y), 0

    def model():
        mu = sample("mu", dist.Normal(0.0, 10.0))
        sample("y", dist.Normal(mu, 1.0).to_event(1), obs=y)

    def guide():
        sample("mu", dist.Delta(param("loc", zeros(()))))

    svi = SVI(model, guide, optim or adam(0.1), Trace_ELBO())
    state = svi.init(key)
    for _ in range(5):
        state, _ = svi.update(state)
    return svi, state


def _leaves(state):
    return [state.step, state.key, state.opt_state["count"],
            *state.params.values(), *state.opt_state["m"].values(),
            *state.opt_state["v"].values()]


def _assert_same_state(a, b):
    assert list(a.params) == list(b.params)
    for x, y in zip(_leaves(a), _leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_npz_roundtrip_is_bit_equal_and_the_toy_fit_matches_jax(tmp_path):
    svi, state = _toy("torch", None)
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, state)
    restored = tckpt.load_state(path[:-4], state)    # without ".npz" too
    _assert_same_state(restored, state)
    assert all(p.is_leaf and p.requires_grad for p in restored.params.values())
    assert not any(m.requires_grad for m in restored.opt_state["m"].values())
    assert list(np.load(path).keys()) == [
        "step", "key", "opt/count", "params/loc", "opt/m/loc", "opt/v/loc"]
    _, jstate = _toy("jax", None)
    np.testing.assert_allclose(state.params["loc"].detach().numpy(),
                               np.asarray(jstate.params["loc"]), rtol=0,
                               atol=5e-6)


def test_checkpointer_resume_latest_step_and_refusals(tmp_path):
    svi, state = _toy("torch", None)
    ckpt = tckpt.Checkpointer(str(tmp_path / "run"), use_orbax=False)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(state_like=state)
    ckpt.save(5, state)
    saved5 = tckpt.load_state(os.path.join(ckpt.directory, "ckpt_5.npz"),
                              state)
    state2 = state
    for _ in range(3):
        state2, _ = svi.update(state2)
    ckpt.save(8, state2)
    assert ckpt.latest_step() == 8
    _assert_same_state(ckpt.restore(state_like=state), state2)
    old = ckpt.restore(state_like=state, step=5)
    _assert_same_state(old, saved5)
    # resuming continues training identically
    resumed = svi.update(ckpt.restore(state_like=state))[0]
    direct = svi.update(state2)[0]
    _assert_same_state(resumed, direct)
    # the JAX package's same sequence of calls
    jsvi, jstate = _toy("jax", None)
    jc = jckpt.Checkpointer(str(tmp_path / "jrun"), use_orbax=False)
    jc.save(5, jstate)
    jc.save(8, jsvi.update(jstate)[0])
    assert jc.latest_step() == ckpt.latest_step()
    with pytest.raises(ValueError, match=r"\.npz"):
        tckpt.Checkpointer(str(tmp_path / "orun"), use_orbax=True)
    assert tckpt.Checkpointer(str(tmp_path / "drun")).use_orbax is False


def _phase_mp(fused=True, Nc=300, Ng=40):
    adata = T.simulate_data(Nc=Nc, Ng=Ng, omegas_to_test=(0.4,), seed=3)
    rng = np.random.default_rng(0)
    nu = adata.uns["simulated_nu"]
    cycle = T.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                               np.full((3, Ng), 0.5), list(adata.var.index))
    phases = T.Phases.from_angles(
        adata.obs["simulated_phis"].values + rng.normal(0, 0.3, Nc),
        concentration=2.0, cell_names=list(adata.obs.index))
    return adata, T.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused, device="cpu")


def test_restore_then_continue_equals_uninterrupted_bit_for_bit(tmp_path):
    _, mp = _phase_mp()
    assert mp.data.use_fused_nb and mp.data.S.dtype == torch.int16
    N, k = 12, 5

    def new_svi():
        fit = T.PhaseFitModel(mp, get_posterior=False)
        return tsvi.SVI(fit.model, fit.guide, T.infer.clipped_adam(
            lr=0.05, betas=(0.80, 0.99), lrd=0.1 ** (1.0 / N)),
            T.infer.Trace_ELBO())

    svi = new_svi()
    state = svi.init(7, mp.data)
    full, full_losses = state, []
    for _ in range(N):
        full, loss = svi.update(full, mp.data)
        full_losses.append(loss)

    svi1 = new_svi()
    part = svi1.init(7, mp.data)
    part_losses = []
    for _ in range(k):
        part, loss = svi1.update(part, mp.data)
        part_losses.append(loss)
    ckpt = tckpt.Checkpointer(str(tmp_path / "run"))
    ckpt.save(part.step, part)
    svi2 = new_svi()                      # a fresh SVI, as a new process has
    resumed = ckpt.restore(svi2.init(11, mp.data))
    assert resumed.step == k
    for _ in range(N - k):
        resumed, loss = svi2.update(resumed, mp.data)
        part_losses.append(loss)
    assert torch.equal(torch.stack(full_losses), torch.stack(part_losses))
    _assert_same_state(resumed, full)


def test_jax_state_carried_across_takes_one_update_as_jax():
    """`svi_state_from_jax`: three JAX ClippedAdam steps of a two-param
    fit, carried into the port, then one update with the same gradient on
    both sides."""
    import optax
    from velocycle_tpu.core import distributions as jdist
    from velocycle_tpu.core.handlers import param, sample

    def model():
        mu = sample("mu", jdist.Normal(0.0, 10.0))
        w = sample("w", jdist.Normal(jnp.zeros(4), 1.0).to_event(1))
        sample("y", jdist.Normal(mu + w[:3], 1.0).to_event(1),
               obs=jnp.asarray(Y))

    def guide():
        sample("mu", jdist.Delta(param("loc", jnp.zeros(()))))
        sample("w", jdist.Delta(param("w_loc", jnp.full(4, 0.3))).to_event(1))

    kw = dict(lr=0.05, betas=(0.80, 0.99), lrd=0.97)
    jsvi = JSVI(model, guide, j_clipped_adam(**kw), JELBO())
    js = jsvi.init(jax.random.PRNGKey(0))
    for _ in range(3):
        js, _ = jsvi.update(js)
    ts = svi_state_from_jax(js, key=42, device="cpu")
    assert (ts.step, ts.opt_state["count"], ts.key) == (3, 3, 42)
    assert list(ts.params) == list(js.params)
    g = {"loc": np.float32(-1.7),
         "w_loc": np.asarray([0.4, -12.0, 3.0, 1e-3], np.float32)}
    updates, _ = jsvi.optim.update({k: jnp.asarray(v) for k, v in g.items()},
                                   js.opt_state, js.params)
    jnew = optax.apply_updates(js.params, updates)
    T.infer.clipped_adam(**kw).update(
        {k: torch.as_tensor(v) for k, v in g.items()}, ts.opt_state, ts.params)
    for k in g:
        np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                   np.asarray(jnew[k]), rtol=0, atol=5e-6)
    assert ts.opt_state["count"] == 4


def test_step_timer_summary_has_the_jax_keys():
    timers = [tprof.StepTimer(), jprof.StepTimer()]
    for t in timers:
        assert t.summary() == {"steps": 0}
        for _ in range(4):
            with t:
                pass
    ours, theirs = (t.summary() for t in timers)
    assert list(ours) == list(theirs)
    assert ours["steps"] == 4 and ours["steps_per_s"] > 0
    assert np.isfinite(ours["mean_ms"]) and ours["compile_s"] >= 0


def test_trace_writes_a_file_that_names_the_annotated_region(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir):
        with tprof.annotate("velocycle_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert "velocycle_region" in open(path).read()


def test_device_memory_stats(monkeypatch):
    assert tprof.device_memory_stats(device="cpu") == {"cpu": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.device_memory_stats()


def test_warmup_returns_its_keys_and_refuses_zero_steps():
    """The port builds, steps once and draws once; it compiles no program
    per chunk length, so it has no ``svi_chunk_<n>`` keys."""
    _, mp = _phase_mp(fused=True, Nc=30, Ng=10)
    timings = T.warmup(mp, num_steps=25, num_posterior_samples=4,
                       cache_dir=False, verbose=False)
    assert list(timings) == ["build", "svi_step", "predictive"]
    assert timings["build"] >= 0 and timings["svi_step"] > 0
    assert timings["predictive"] > 0
    with pytest.raises(ValueError, match="num_steps"):
        T.warmup(mp, num_steps=0, cache_dir=False)


def test_warmup_respects_conditioning(monkeypatch):
    adata, mp = _phase_mp(fused=False, Nc=30, Ng=10)
    phi_xy = np.stack([np.cos(adata.obs["simulated_phis"]),
                       np.sin(adata.obs["simulated_phis"])],
                      axis=-1).astype(np.float32)
    seen = []
    init = tsvi.SVI.init

    def spy(self, *a, **k):
        state = init(self, *a, **k)
        seen.append((self, sorted(state.params)))
        return state

    monkeypatch.setattr(tsvi.SVI, "init", spy)
    timings = T.warmup(mp, condition_on={"phi_xy": phi_xy}, num_steps=10,
                       predictive=False, cache_dir=False, verbose=False)
    assert list(timings) == ["build", "svi_step"]
    ((svi, names),) = seen
    model_tr = th.trace(th.seed(svi.model, 0)).get_trace(mp.data)
    assert model_tr["phi_xy"]["is_observed"]
    np.testing.assert_array_equal(model_tr["phi_xy"]["value"].numpy(), phi_xy)
    assert "phi_xy" not in th.trace(th.seed(svi.guide, 0)).get_trace(mp.data)
    # the JAX package's conditioned pair has the same params (a conditioned
    # site keeps its guide params in both packages, ROADMAP section 3)
    jad = V.simulate.simulate_data(Nc=30, Ng=10, key=jax.random.PRNGKey(7))
    jmp = V.preprocess_for_phase_estimation(
        jad, V.Cycle.trivial_prior(list(jad.var.index), harmonics=1),
        V.Phases.from_angles(jad.obs["simulated_phis"].values,
                             cell_names=list(jad.obs.index)),
        n_harmonics=1, with_delta_nu=False)
    jsvi = JSVI(jh.condition(jmp.model_fn, data={"phi_xy": phi_xy}),
                jh.block(jmp.guide_fn, hide=["phi_xy"]), j_clipped_adam(),
                JELBO())
    assert names == sorted(jsvi.init(jax.random.PRNGKey(0), jmp.data).params)


def test_chunk_lengths_match_jax_and_svi_run(monkeypatch):
    for args in ((500,), (1000,), (3000,), (2500,), (25, 10)):
        assert _chunk_lengths(*args) == j_chunk_lengths(*args)
    assert _chunk_lengths(2500) == [500, 1000]
    # the port's SVI.run takes the chunks _chunk_lengths derives
    svi, _ = _toy("torch", None)
    seen = []

    def chunk(self, state, n, *a, **k):
        seen.append(n)
        return state, torch.zeros(n)

    monkeypatch.setattr(tsvi.SVI, "update_chunk", chunk)
    for num_steps, chunk_size in ((2500, None), (25, 10), (700, None)):
        seen.clear()
        svi.run(0, num_steps, chunk_size=chunk_size)
        assert sorted(set(seen)) == _chunk_lengths(num_steps, chunk_size)


def test_enable_compile_cache_sets_and_returns_the_directory(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("VELOCYCLE_TPU_CACHE", raising=False)
    d = str(tmp_path / "cc")
    assert T.enable_compile_cache(d, min_compile_seconds=2.0) == d
    assert os.path.isdir(d) and cuda_build.BUILD_DIR == tmp_path / "cc"
    monkeypatch.setenv("VELOCYCLE_TPU_CACHE", str(tmp_path / "env"))
    assert T.enable_compile_cache() == str(tmp_path / "env")
    monkeypatch.delenv("VELOCYCLE_TPU_CACHE")
    assert T.enable_compile_cache() == str(cuda_build.DEFAULT_BUILD_DIR)
    # a library loaded from one directory pins it
    monkeypatch.setitem(cuda_build._LIBS, "nb_phase", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        T.enable_compile_cache(d)
    assert T.enable_compile_cache() == str(cuda_build.DEFAULT_BUILD_DIR)
