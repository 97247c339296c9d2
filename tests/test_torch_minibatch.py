"""Minibatch and streaming SVI (`velocycle_tpu_torch/infer/minibatch.py`)
against the JAX package's (`velocycle_tpu/infer/minibatch.py`), the cases
of tests/test_minibatch.py at small sizes.

  * The blockwise objective is exact: with the JAX package's guide draws
    substituted on both sides, the mean of the port's scaled block losses
    over one epoch equals the JAX package's full-batch loss (phase and
    velocity, plain and fused paths), rtol 1e-5 (tests/test_minibatch.py's).
  * ``num_blocks=1`` reproduces the port's full-batch `SVI` step for step:
    losses rtol 1e-5, params rtol 1e-4 (tests/test_minibatch.py's; the
    per-cell rows' bias corrections are float32 powers of their counts).
  * Per-row Adam visit counts, and a row's first visit bias-corrected as a
    first visit (rtol 1e-4, atol 1e-6 as there).
  * The streamed fit equals the on-device fit, and one initialised from
    `init_template`, rtol 1e-6 (as there).
  * The port's block order: the same seed reproduces it, another seed
    changes it (numpy's permutation, not the JAX package's); a one-argument
    factory is called with the epoch.
  * The guard: a cell-axis site left out of ``local_sites`` warns.
  * `handlers.scale` with ``site_filter``, and the ELBO's use of it: the
    likelihood's gradient at scale s is s times its gradient at scale 1 on
    the plain and the fused path (rtol 1e-5: the same float32 gradients
    scaled).
  * Example 07's smoke run on the CPU.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import Trace_ELBO as JTrace_ELBO
from velocycle_tpu.infer.minibatch import LOCAL_SITES as J_LOCAL_SITES
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
from velocycle_tpu_torch.infer.minibatch import (
    LOCAL_SITES, MinibatchSVI, init_template, iter_host_blocks, split_cells,
)
from velocycle_tpu_torch.models.phase import phase_guide, phase_model
from velocycle_tpu_torch.models.velocity import velocity_guide, velocity_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, NG, NBLK = 120, 40, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return V.simulate.simulate_data(Nc=NC, Ng=NG, omegas_to_test=(0.4,),
                                    key=jax.random.PRNGKey(42))


def _phase_mp(sim, fused):
    rng = np.random.default_rng(0)
    true_nu = sim.uns["simulated_nu"]
    cycle = V.Cycle.from_array((true_nu + rng.normal(0, 0.2, true_nu.shape)).T,
                               np.full((3, NG), 0.5), list(sim.var.index))
    init = sim.obs["simulated_phis"].values + rng.normal(0, 0.3, NC)
    phases = V.Phases.from_angles(init, concentration=2.0,
                                  cell_names=list(sim.obs.index))
    return V.preprocess_for_phase_estimation(
        sim, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused)


@pytest.fixture(scope="module")
def port_phase(sim):
    """(model, guide, port PhaseData) of the phase fit, plain path."""
    return phase_model, phase_guide, phase_data_from_jax(
        _phase_mp(sim, False).data, device="cpu")


def _velocity_mp(sim, fused):
    pm = _phase_mp(sim, False)
    speed = V.AngularSpeed.trivial_prior(["cond"], harmonics=0, means=0.3,
                                         stds=0.5)
    return V.preprocess_for_velocity_estimation(
        sim, pm.cycle_prior, pm.phase_prior, speed, n_harmonics=1,
        with_delta_nu=False, model_type="fourier", use_fused_nb=fused)


def _jax_values(guide, data, key):
    tr = jh.trace(jh.seed(guide, key)).get_trace(data)
    return {n: np.asarray(s["value"]) for n, s in tr.items()
            if s["type"] == "sample"}


def _port_block_mean(model, guide, blocks, values, nblk):
    """Mean over the blocks of the port's scaled block loss at ``values``
    (phi_xy sliced per block)."""
    B = blocks[0].Nc
    total = 0.0
    for i, blk in enumerate(blocks):
        v = {k: torch.as_tensor(x) for k, x in values.items()}
        v["phi_xy"] = v["phi_xy"][i * B:(i + 1) * B]

        def scaled(fn):
            return th.scale(th.substitute(fn, data=v), scale_factor=float(nblk),
                            site_filter=LOCAL_SITES.__contains__)

        total += float(Trace_ELBO().loss(0, scaled(model), scaled(guide), blk))
    return total / len(blocks)


@pytest.mark.parametrize("stage", ["phase", "velocity"])
@pytest.mark.parametrize("fused", [False, True])
def test_block_objective_exact_matches_jax(sim, stage, fused):
    """The mean of the port's scaled block losses over one epoch equals
    the JAX package's full-batch loss at the JAX guide's draws (both
    packages' plain path as the reference: the JAX package's fused
    element cancels at small dispersion)."""
    if stage == "phase":
        jmp, jplain = _phase_mp(sim, fused), _phase_mp(sim, False)
        model, guide, conv = phase_model, phase_guide, phase_data_from_jax
    else:
        jmp, jplain = _velocity_mp(sim, fused), _velocity_mp(sim, False)
        model, guide = velocity_model, velocity_guide
        conv = velocity_data_from_jax
    key = jax.random.PRNGKey(1 if stage == "phase" else 2)
    vals = _jax_values(jplain.guide_fn, jplain.data, key)
    jv = {k: jnp.asarray(x) for k, x in vals.items()}
    full = float(JTrace_ELBO().loss(
        key, jh.substitute(jplain.model_fn, data=jv),
        jh.substitute(jplain.guide_fn, data=jv), jplain.data))
    blocks = split_cells(conv(jmp.data, device="cpu"), NBLK)
    assert len(blocks) == NBLK and all(b.Nc == NC // NBLK for b in blocks)
    assert all(b.S.is_contiguous() for b in blocks)
    got = _port_block_mean(model, guide, blocks, vals, NBLK)
    assert np.isclose(got, full, rtol=1e-5), (got, full)
    assert J_LOCAL_SITES == LOCAL_SITES


def test_single_block_matches_full_batch_svi(port_phase):
    model, guide, data = port_phase
    svi = SVI(model, guide, clipped_adam(lr=0.05), Trace_ELBO())
    state_full = svi.init(3, data)
    mb = MinibatchSVI(model, guide, num_blocks=1, lr=0.05)
    state_mb = mb.init(3, data)
    (block,) = split_cells(data, 1)
    for _ in range(5):
        state_full, loss_full = svi.update(state_full, data)
        state_mb, loss_mb = mb.update_block(state_mb, 0, block)
        assert np.isclose(float(loss_full), float(loss_mb), rtol=1e-5)
    for name, p in svi.get_params(state_full).items():
        np.testing.assert_allclose(p.numpy(), mb.get_params(state_mb)[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_per_row_adam_visit_counts(port_phase):
    """Each phixy row is visited once per epoch, the global params NBLK
    times."""
    model, guide, data = port_phase
    mb = MinibatchSVI(model, guide, num_blocks=NBLK)
    state, losses = mb.fit(5, data, num_epochs=3, shuffle=False)
    assert losses.shape == (3 * NBLK,) and np.isfinite(losses).all()
    assert state.step == 3 * NBLK
    np.testing.assert_array_equal(state.counts["phixy_locs"].numpy(), 3)
    assert state.counts["nu_locs"] == 3 * NBLK


def test_first_visit_bias_correction_matches_fresh_adam(port_phase):
    """A row first visited at global step 2 takes the fresh-Adam step:
    mu_hat = clip(g), nu_hat = clip(g)^2, lr undecayed."""
    model, guide, data = port_phase
    blocks2 = split_cells(data, 2)
    mb = MinibatchSVI(model, guide, num_blocks=2, lrd=0.9)
    s = mb.init(6, data)
    s, _ = mb.update_block(s, 0, blocks2[0])
    params_pre = {k: v.detach().clone().requires_grad_(True)
                  for k, v in s.params.items()}
    step_key = th.fold_in(s.key, 1)
    s, _ = mb.update_block(s, 1, blocks2[1])
    loss = mb._block_loss(params_pre, step_key, 1, blocks2[1])
    (g,) = torch.autograd.grad(loss, [params_pre["phixy_locs"]])
    B = data.Nc // 2
    g = np.clip(g.numpy()[B:], -mb.clip_norm, mb.clip_norm)
    expect = params_pre["phixy_locs"].detach().numpy()[B:] - (
        mb.lr * g / (np.abs(g) + mb.eps))
    np.testing.assert_allclose(s.params["phixy_locs"].detach().numpy()[B:],
                               expect, rtol=1e-4, atol=1e-6)
    # the first block's rows kept their first step's values
    np.testing.assert_array_equal(s.counts["phixy_locs"].numpy(), 1)


def test_block_adam_matches_jax_update_block():
    """The block-masked ClippedAdam against the JAX package's
    `MinibatchSVI.update_block`: both start from the same params, moments
    and visit counts (phixy_locs per row, most of its second block's rows
    never visited before), each package's block loss replaced by <params, G> so that both
    step on the same gradient G, over three steps on blocks 1, 0, 1 with
    lrd = 0.9 and gradients past the clip: params, moments and counts agree
    at rtol 1e-5 after every step."""
    from velocycle_tpu.infer.minibatch import MinibatchState as JState
    from velocycle_tpu.infer.minibatch import MinibatchSVI as JMinibatchSVI
    from velocycle_tpu_torch.infer.minibatch import MinibatchState

    rng = np.random.default_rng(7)
    Nc, B = 12, 6
    shapes = {"nu_locs": (5, 3), "phixy_locs": (Nc, 2), "shape_inv_locs": (5,)}

    def draw(scale, low=None):
        return {n: (rng.uniform(low, scale, s) if low is not None
                    else rng.normal(0.0, scale, s)).astype(np.float32)
                for n, s in shapes.items()}

    params, mu, nu = draw(1.0), draw(0.1), draw(0.1, low=0.0)
    # each row its own count; block 1's rows mostly never visited
    row_counts = np.array([2, 1, 3, 0, 2, 1, 0, 0, 1, 0, 2, 0], np.int32)[
        :, None].repeat(2, 1)
    grads = [draw(8.0) for _ in range(3)]
    assert max(np.abs(g).max() for G in grads for g in G.values()) > 10.0

    def linear_loss(prm, key, idx, G):
        return sum((prm[n] * G[n]).sum() for n in prm)

    jmb = JMinibatchSVI(None, None, num_blocks=2, lrd=0.9)
    jmb.block_size = B
    jmb._block_loss = linear_loss
    jstate = JState(jnp.asarray(4, jnp.int32),
                    {n: jnp.asarray(v) for n, v in params.items()},
                    {n: jnp.asarray(v) for n, v in mu.items()},
                    {n: jnp.asarray(v) for n, v in nu.items()},
                    {"nu_locs": jnp.asarray(4, jnp.int32),
                     "shape_inv_locs": jnp.asarray(4, jnp.int32),
                     "phixy_locs": jnp.asarray(row_counts)},
                    jax.random.PRNGKey(0))
    mb = MinibatchSVI(None, None, num_blocks=2, lrd=0.9)
    mb.block_size = B
    mb._block_loss = linear_loss
    state = MinibatchState(
        4, {n: torch.tensor(v, requires_grad=True) for n, v in params.items()},
        {n: torch.tensor(v) for n, v in mu.items()},
        {n: torch.tensor(v) for n, v in nu.items()},
        {"nu_locs": 4, "shape_inv_locs": 4,
         "phixy_locs": torch.tensor(row_counts)}, th.fold_in(0, 1))
    for blk, G in zip((1, 0, 1), grads):
        jstate, _ = jmb.update_block(jstate, blk,
                                     {n: jnp.asarray(g) for n, g in G.items()})
        state, _ = mb.update_block(state, blk,
                                   {n: torch.as_tensor(g) for n, g in G.items()})
        for name in shapes:
            for got, want in ((state.params[name].detach(), jstate.params[name]),
                              (state.mu[name], jstate.mu[name]),
                              (state.nu[name], jstate.nu[name])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, err_msg=name)
            np.testing.assert_array_equal(np.asarray(state.counts[name]),
                                          np.asarray(jstate.counts[name]))
    assert state.step == int(jstate.step) == 7
    # block 0's rows visited once more, block 1's twice
    np.testing.assert_array_equal(state.counts["phixy_locs"].numpy(),
                                  row_counts + np.repeat([1, 2], B)[:, None])


def _host_factory(data, nblk=NBLK):
    S, cf, pp, logS, Db = (np.asarray(x) for x in (
        data.S, data.count_factor, data.phixy_prior, data.logS, data.Db))

    def factory():
        return iter_host_blocks(S, cf, pp, data, nblk, logS=logS, Db=Db)

    return factory, pp, cf, Db


def _assert_same_fit(a, b, rtol=1e-6):
    (mb1, s1, l1), (mb2, s2, l2) = a, b
    np.testing.assert_allclose(l1, l2, rtol=rtol)
    p2 = mb2.get_params(s2)
    for name, p in mb1.get_params(s1).items():
        np.testing.assert_allclose(p.numpy(), p2[name].numpy(), rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_streamed_fit_matches_on_device(sim, fused):
    data = phase_data_from_jax(_phase_mp(sim, fused).data, device="cpu")
    mb1 = MinibatchSVI(phase_model, phase_guide, num_blocks=NBLK)
    s1, l1 = mb1.fit(4, data, num_epochs=3, shuffle=False)
    factory = _host_factory(data)[0]
    blk = next(iter(factory()))[1]
    assert isinstance(blk.S, np.ndarray) and blk.Nc == NC // NBLK
    assert (blk.lgamma_k_sum is None) == (not fused)
    mb2 = MinibatchSVI(phase_model, phase_guide, num_blocks=NBLK)
    s2, l2 = mb2.fit_streamed(4, data, factory, num_epochs=3)
    _assert_same_fit((mb1, s1, l1), (mb2, s2, l2))


def test_init_template_streamed_matches_full_init(port_phase):
    """`init_template` (zero-strided counts, no bytes) gives the same
    streamed fit as initialising from the full container."""
    model, guide, data = port_phase
    factory, pp, cf, Db = _host_factory(data)
    mb1 = MinibatchSVI(model, guide, num_blocks=NBLK)
    s1, l1 = mb1.fit_streamed(9, data, factory, num_epochs=2)
    first = next(iter(factory()))[1]
    tmpl = init_template(first, NC, pp, count_factor=cf, Db=Db)
    assert tmpl.S.shape == (NG, NC) and tmpl.S.stride() == (0, 0)
    mb2 = MinibatchSVI(model, guide, num_blocks=NBLK)
    s2, l2 = mb2.fit_streamed(9, tmpl, factory, num_epochs=2)
    _assert_same_fit((mb1, s1, l1), (mb2, s2, l2))


def test_shuffle_reproducible_and_seed_dependent(port_phase):
    model, guide, data = port_phase

    def run(seed):
        return MinibatchSVI(model, guide, num_blocks=NBLK).fit(
            seed, data, num_epochs=2)[1]

    l1, l2, l3 = run(7), run(7), run(8)
    np.testing.assert_array_equal(l1, l2)   # same seed, same block order
    assert not np.array_equal(l1, l3)       # another seed, another run
    orders = {tuple(np.random.default_rng(th.fold_in(s, 0x5B)).permutation(
        NBLK)) for s in range(6)}
    assert len(orders) > 1                  # the order itself moves


def test_streamed_epoch_aware_factory_shuffles(port_phase):
    """A one-argument factory receives the epoch so it can permute its
    blocks; the visiting order differs across epochs."""
    model, guide, data = port_phase
    factory = _host_factory(data)[0]
    seen = []

    def by_epoch(epoch):
        order = np.random.default_rng(epoch).permutation(NBLK)
        blocks = list(factory())
        for i in order:
            seen.append(int(i))
            yield blocks[int(i)]

    MinibatchSVI(model, guide, num_blocks=NBLK).fit_streamed(
        10, data, by_epoch, num_epochs=2)
    assert len(seen) == 2 * NBLK
    assert seen[:NBLK] != seen[NBLK:]


def test_warns_on_nonlocal_cell_site(port_phase):
    """Dropping phi_xy from local_sites warns that the blockwise objective
    is biased; the default set does not."""
    model, guide, data = port_phase
    mb = MinibatchSVI(model, guide, num_blocks=NBLK,
                      local_sites=LOCAL_SITES - {"phi_xy"})
    with pytest.warns(UserWarning, match="phi_xy"):
        mb.init(0, data)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        MinibatchSVI(model, guide, num_blocks=NBLK).init(0, data)


def test_refuses_lba_and_uneven_blocks(port_phase):
    model, guide, data = port_phase
    with pytest.raises(ValueError, match="LBA"):
        MinibatchSVI(model, guide, NBLK).init(
            0, data.replace(gene_selection_model="lba"))
    with pytest.raises(ValueError, match="not divisible"):
        MinibatchSVI(model, guide, 7).init(0, data)
    with pytest.raises(ValueError, match="not divisible"):
        split_cells(data, 7)


def test_scale_handler_multiplies_the_selected_sites():
    """`handlers.scale` sets ``scale`` on the sample sites its filter
    selects (all without one); nested scales multiply; other sites keep
    none."""
    from velocycle_tpu_torch.core import distributions as tdist

    def model():
        th.sample("a", tdist.Normal(0.0, 1.0))
        th.sample("b", tdist.Normal(0.0, 1.0))
        th.deterministic("c", torch.zeros(()))

    inner = th.scale(model, scale_factor=3.0, site_filter=lambda n: n == "a")
    tr = th.trace(th.seed(th.scale(inner, scale_factor=2.0), 0)).get_trace()
    assert tr["a"]["scale"] == 6.0 and tr["b"]["scale"] == 2.0
    assert "scale" not in tr["c"]
    tr = th.trace(th.seed(inner, 0)).get_trace()
    assert "scale" not in tr["b"]
    # the ELBO weights each site's summed log-prob by its scale
    lp = float(tdist.Normal(0.0, 1.0).log_prob(tr["a"]["value"]))
    loss = Trace_ELBO().loss(0, th.substitute(inner, data={
        "a": tr["a"]["value"], "b": tr["b"]["value"]}), lambda: None)
    lpb = float(tdist.Normal(0.0, 1.0).log_prob(tr["b"]["value"]))
    assert np.isclose(float(loss), -(3.0 * lp + lpb), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_elbo_scale_reaches_the_likelihood_gradient(sim, fused):
    """On the plain path (site ``S``) and the fused one (``S_fused``, one
    scalar whose backward scales the kernel's gradients by the incoming
    cotangent), the likelihood's gradient in nu at scale s is s times its
    gradient at scale 1: g(s) - g(0) = s (g(1) - g(0))."""
    data = phase_data_from_jax(_phase_mp(sim, fused).data, device="cpu")
    site = "S_fused" if fused else "S"
    vals = _jax_values(_phase_mp(sim, False).guide_fn,
                       _phase_mp(sim, False).data, jax.random.PRNGKey(3))

    def grad_nu(s):
        nu = torch.as_tensor(vals["nu"]).requires_grad_(True)
        v = {k: torch.as_tensor(x) for k, x in vals.items() if k != "nu"}
        v["nu"] = nu
        model = th.scale(th.substitute(phase_model, data=v), scale_factor=s,
                         site_filter=lambda n: n == site)
        tr = th.trace(th.seed(model, 0)).get_trace(data)
        assert tr[site]["scale"] == s
        loss = Trace_ELBO().loss(0, model, lambda d: None, data)
        (g,) = torch.autograd.grad(loss, nu)
        return g.numpy().astype(np.float64)

    g0, g1, g25 = grad_nu(0.0), grad_nu(1.0), grad_nu(2.5)
    np.testing.assert_allclose(g25 - g0, 2.5 * (g1 - g0), rtol=1e-5,
                               atol=1e-5 * np.abs(g1 - g0).max())


def test_example_07_smoke():
    env = dict(os.environ, VCT_SMOKE="1", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(
            REPO, "velocycle_tpu_torch", "examples",
            "07_minibatch_streaming.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "on-device minibatch: 32 steps" in out.stdout
    assert "host-streamed: 12 steps" in out.stdout
