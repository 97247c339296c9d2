"""The 2-D extension of the port (`velocycle_tpu_torch/twodim/`,
`infer/autoguide.py`, `infer.adam`) against the JAX package's
(`velocycle_tpu/twodim/`, `velocycle_tpu/infer/autoguide.py`,
`optax.adam`), on the same numpy inputs.

Tolerances:
  * `adam` against `optax.adam` over 20 updates: rtol 1e-6, atol 5e-6.
    The update is the same, but optax forms the bias correction 1 - b2^t
    in float32, where 0.999 is inexact: 1.3e-5 relative off at t = 1, so
    its update is up to ~6.5e-6 relative off the port's float64 one, and
    after 20 steps of lr 3e-2 a parameter by up to 20 * 3e-2 * 6.5e-6 =
    3.9e-6 (1.1e-6 measured).
  * The models' log-joint and `Trace_ELBO` under `AutoNormal` / `AutoDelta`,
    at the JAX guide's params perturbed by seeded noise and with the same
    guide noise on both sides (`tests/_torch_parity.py`): loss rel 1e-5,
    every gradient max|a-b| / max|a| 1e-4 (the suite's kernel gates; only
    the float32 matmul order differs).
  * `make_designs` and `generate_adata` at one seed: designs within 1e-6,
    the same accepted modules, log_beta, log_gamma and counts (the two
    float32 spline bases agree, so the accept/reject draws do too), ElogS
    and ElogU within 1e-6.
  * `evaluate_fit` on one fixed results dict: rtol 1e-12 (the same numpy).
  * The slow lane's 200 x 24, 600-step fit: tests/test_twodim.py's gates.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from velocycle_tpu import twodim as J2
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer.autoguide import (
    AutoDelta as JAutoDelta, AutoNormal as JAutoNormal,
)
import velocycle_tpu_torch.infer as TI
from velocycle_tpu_torch import twodim as T2
from velocycle_tpu_torch.convert import velo2d_data_from_jax
from velocycle_tpu_torch.core import constraints as tcons
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer.autoguide import AutoDelta, AutoNormal

from _torch_parity import assert_elbo_and_grads_close, elbo_and_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, NG = 96, 12
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sims():
    """(JAX AnnData, port AnnData) at one seed."""
    return (J2.generate_adata(n_cells=NC, n_genes=NG, seed=0),
            T2.generate_adata(n_cells=NC, n_genes=NG, seed=0))


def _frozen(pd, adata, pkg):
    """The data with the simulator's true w_s and its ElogS as the frozen
    stage-1 fields (stage 2's inputs)."""
    w_s = np.asarray(adata.uns["w_s"], np.float32)
    ElogS = w_s @ np.asarray(pd.design_s)
    if pkg == "jax":
        return pd.replace(w_s=jnp.asarray(w_s), ElogS=jnp.asarray(ElogS))
    return pd.replace(w_s=torch.as_tensor(w_s), ElogS=torch.as_tensor(ElogS))


@pytest.fixture(scope="module")
def datas(sims):
    """{stage: (JAX Velo2DData, port Velo2DData)} from the same arrays."""
    jpd = J2.prepare_data(sims[0])
    tpd = velo2d_data_from_jax(jpd, device="cpu")
    return {"s": (jpd, tpd),
            "u": (_frozen(jpd, sims[0], "jax"), _frozen(tpd, sims[0], "torch"))}


MODELS = {"s": (J2.velo2d_s_model, T2.velo2d_s_model),
          "u": (J2.velo2d_u_model, T2.velo2d_u_model)}


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=7).astype(np.float32)}
    grads = [{k: rng.normal(0, 10.0 ** rng.integers(-3, 2), v.shape)
              .astype(np.float32) for k, v in p0.items()} for _ in range(20)]
    opt = optax.adam(3e-2, b1=0.9, b2=0.999, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tadam = TI.adam(3e-2)
    tstate = tadam.init(tp)
    for g in grads:
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tadam.update({k: torch.tensor(v) for k, v in g.items()}, tstate, tp)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=5e-6)
    assert tstate["count"] == 20


def test_adam_clamps_nothing_where_clipped_adam_clamps():
    """A gradient past ClippedAdam's clip_norm moves plain Adam's moments
    by its full size: the second moment after one step is (1 - b2) g^2."""
    p = {"x": torch.zeros(2)}
    opt = TI.adam(1e-2)
    state = opt.init(p)
    g = torch.tensor([50.0, -0.5])
    opt.update({"x": g}, state, p)
    torch.testing.assert_close(state["v"]["x"], (1 - 0.999) * g * g)


# ---------------------------------------------------------------------------
# AutoNormal / AutoDelta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["s", "u"])
@pytest.mark.parametrize("kind", ["AutoNormal", "AutoDelta"])
def test_autoguide_params_match_jax(datas, stage, kind):
    """Param names, shapes and constraints of the port's guide equal the
    JAX package's; `median` maps the locs back to the site names."""
    jpd, tpd = datas[stage]
    jmodel, tmodel = MODELS[stage]
    jguide = {"AutoNormal": JAutoNormal, "AutoDelta": JAutoDelta}[kind](jmodel)
    tguide = {"AutoNormal": AutoNormal, "AutoDelta": AutoDelta}[kind](tmodel)
    from velocycle_tpu.infer.svi import init_params as j_init_params

    jparams, jcons = j_init_params(jguide, jax.random.PRNGKey(0), jpd)
    tparams, tcons_ = TI.init_params(tguide, 0, tpd)
    assert sorted(tparams) == sorted(jparams)
    for k in jparams:
        assert tuple(tparams[k].shape) == tuple(np.shape(jparams[k])), k
        assert (tcons_[k] is tcons.positive) == (
            jcons[k] is not None and jcons[k].name == "positive"), k
        if ".scales." in k:
            # init_scale through the same positive bijection
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6)
    sites = ({"w_s"} if stage == "s"
             else {"log_beta", "log_gamma", "w_omega"})
    assert {k.split(".")[-1] for k in jparams} == sites
    med = tguide.median(TI.svi.constrain(tparams, tcons_))
    jmed = jguide.median(jparams)
    assert sorted(med) == sorted(jmed) == sorted(sites)
    for k in sites:
        assert med[k] is not None and tuple(med[k].shape) == np.shape(jmed[k])


def test_autoguide_prototype_is_one_seeded_draw_of_the_model(datas):
    """The locs start at one draw of the model's latent sites, reproducible
    by its seed; observed sites are skipped."""
    tpd = datas["u"][1]
    a, b, c = (AutoNormal(T2.velo2d_u_model, init_key=k) for k in (3, 3, 4))
    pa = a._get_prototype(tpd)
    assert sorted(pa) == ["log_beta", "log_gamma", "w_omega"]
    for k, v in pa.items():
        assert torch.equal(v, b._get_prototype(tpd)[k])
        assert not torch.equal(v, c._get_prototype(tpd)[k])
        assert not v.requires_grad


@pytest.mark.parametrize("stage", ["s", "u"])
@pytest.mark.parametrize("kind", ["AutoNormal", "AutoDelta"])
def test_autoguide_elbo_and_grads_match_jax(datas, stage, kind):
    """`Trace_ELBO` of each 2-D model under each guide, and its gradient
    with respect to every param, at the same params and guide noise."""
    jpd, tpd = datas[stage]
    jmodel, tmodel = MODELS[stage]
    jguide = {"AutoNormal": JAutoNormal, "AutoDelta": JAutoDelta}[kind](jmodel)
    tguide = {"AutoNormal": AutoNormal, "AutoDelta": AutoDelta}[kind](tmodel)
    rng = np.random.default_rng(5)
    shapes = ({"w_s": (NG, jpd.n_coef_s)} if stage == "s" else
              {"log_beta": (NG,), "log_gamma": (NG,),
               "w_omega": (2, jpd.n_coef_omega)})
    eps = ({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
           if kind == "AutoNormal" else {})
    jl, jg, tl, tg = elbo_and_grads(jmodel, jguide, tmodel, tguide, jpd, tpd,
                                    eps)
    assert_elbo_and_grads_close(jl, jg, tl, tg, grad_rtol=GRAD_RTOL,
                                loss_rtol=LOSS_RTOL)


@pytest.mark.parametrize("stage", ["s", "u"])
def test_model_log_joint_and_gradients_match_jax(datas, stage):
    """Each model's log-joint (every sample site's summed log-prob) at the
    same latent values, and its gradient with respect to them."""
    jpd, tpd = datas[stage]
    jmodel, tmodel = MODELS[stage]
    rng = np.random.default_rng(11)
    if stage == "s":
        lat = {"w_s": np.asarray(datas["u"][0].w_s)
               + rng.normal(0, 0.05, (NG, jpd.n_coef_s)).astype(np.float32)}
    else:
        lat = {"log_beta": rng.normal(2.0, 0.5, NG).astype(np.float32),
               "log_gamma": rng.normal(0.25, 0.1, NG).astype(np.float32),
               "w_omega": rng.normal(0, 1, (2, jpd.n_coef_omega))
               .astype(np.float32)}

    def jlogp(v):
        tr = jh.trace(jh.substitute(jmodel, data=v)).get_trace(jpd)
        return sum(s["fn"].log_prob(s["value"]).sum() for s in tr.values()
                   if s["type"] == "sample")

    jl, jg = jax.value_and_grad(jlogp)({k: jnp.asarray(x) for k, x in lat.items()})
    tv = {k: torch.tensor(x, requires_grad=True) for k, x in lat.items()}
    tr = th.trace(th.substitute(tmodel, data=tv)).get_trace(tpd)
    tl = sum(s["fn"].log_prob(s["value"]).sum() for s in tr.values()
             if s["type"] == "sample")
    tl.backward()
    tl = float(tl.detach())
    assert abs(tl - float(jl)) / abs(float(jl)) < LOSS_RTOL
    for k in lat:
        err = np.abs(tv[k].grad.numpy() - np.asarray(jg[k])).max() / (
            np.abs(np.asarray(jg[k])).max())
        assert err < GRAD_RTOL, (k, err)
    # the deterministic sites too
    jtr = jh.trace(jh.substitute(jmodel, data={k: jnp.asarray(x) for k, x in lat.items()})).get_trace(jpd)
    for name, site in tr.items():
        if site["type"] == "deterministic":
            np.testing.assert_allclose(site["value"].detach().numpy(),
                                       np.asarray(jtr[name]["value"]),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# simulator, data, driver
# ---------------------------------------------------------------------------

def test_make_designs_matches_jax():
    phi = np.random.default_rng(3).uniform(0, 10, (2, 300))
    phi[:, :2] = [[0.0, 10.0], [10.0, 0.0]]     # the domain's corners
    got = T2.make_designs(phi, 0.0, 10.0)
    want = J2.make_designs(phi, 0.0, 10.0)
    assert [g.shape for g in got] == [(37, 300), (37, 300), (37, 300), (36, 300)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_generate_adata_matches_jax(sims):
    j, t = sims
    assert t.shape == j.shape == (NC, NG)
    np.testing.assert_array_equal(t.var["module"], j.var["module"])
    for k in ("log_beta", "log_gamma"):
        np.testing.assert_array_equal(t.var[k].values, j.var[k].values)
    for k in ("cell_x", "cell_y", "upper_branch", "omega_x", "omega_y"):
        np.testing.assert_array_equal(t.obs[k].values, j.obs[k].values)
    for k in ("ElogS", "ElogU"):
        np.testing.assert_allclose(t.layers[k], j.layers[k], rtol=0, atol=1e-6)
    for k in ("spliced", "unspliced"):
        np.testing.assert_array_equal(t.layers[k], j.layers[k])
    for k in ("w_omega", "w_s"):
        np.testing.assert_allclose(t.uns[k], j.uns[k], rtol=0, atol=1e-12)


def test_velo2d_data_from_jax_equals_prepare_data(sims):
    jpd = J2.prepare_data(sims[0])
    got = velo2d_data_from_jax(jpd, device="cpu")
    want = T2.prepare_data(sims[1], device="cpu")
    for f in ("design_s", "design_dx", "design_dy", "design_omega", "S", "U",
              "w_s", "ElogS"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == torch.float32, f
        assert torch.equal(a, b), f
    for f in ("Ng", "Nc", "n_coef_s", "n_coef_omega", "w_s_mean",
              "log_gamma_scale"):
        assert getattr(got, f) == getattr(want, f) == getattr(jpd, f), f
    arr = jpd.replace(log_beta_mean=np.full(NG, 1.5, np.float32))
    t = velo2d_data_from_jax(arr, device="cpu")
    assert torch.equal(t.log_beta_mean, torch.full((NG,), 1.5))


def test_prepare_data_defaults_to_the_card(sims, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T2.prepare_data(sims[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        velo2d_data_from_jax(J2.prepare_data(sims[0]))


def test_evaluate_fit_matches_jax(sims):
    j, t = sims
    rng = np.random.default_rng(2)
    results = {
        "omega": rng.normal(size=(2, NC)),
        "ElogS": rng.normal(size=(NG, NC)) + j.layers["ElogS"].T,
        "ElogU": rng.normal(size=(NG, NC)) + j.layers["ElogU"].T,
        "log_beta": rng.normal(size=NG), "log_gamma": rng.normal(size=NG),
    }
    got, want = T2.evaluate_fit(t, results), J2.evaluate_fit(j, results)
    assert sorted(got) == sorted(want) == sorted(
        ["omega_x", "omega_y", "ElogS", "ElogU", "log_beta", "log_gamma",
         "gamma_beta_ratio"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_short_two_stage_fit_losses_fall(sims):
    pd = T2.prepare_data(sims[1], device="cpu")
    results, ls, lu = T2.train_velo2d(pd, n_steps_s=30, n_steps_u=30, key=0)
    assert ls.shape == lu.shape == (30,)
    assert np.isfinite(ls).all() and np.isfinite(lu).all()
    assert ls[-5:].mean() < ls[0] and lu[-5:].mean() < lu[0]
    shapes = {"w_s": (NG, 37), "ElogS": (NG, NC), "w_omega": (2, 36),
              "omega": (2, NC), "log_beta": (NG,), "log_gamma": (NG,),
              "ElogU": (NG, NC)}
    for k, s in shapes.items():
        assert isinstance(results[k], np.ndarray) and results[k].shape == s, k
        assert np.isfinite(results[k]).all(), k
    np.testing.assert_allclose(results["ElogS"],
                               results["w_s"] @ np.asarray(pd.design_s),
                               rtol=1e-5, atol=1e-4)
    # the same seed, the same fit
    again, ls2, _ = T2.train_velo2d(pd, n_steps_s=30, n_steps_u=30, key=0)
    np.testing.assert_array_equal(ls, ls2)
    np.testing.assert_array_equal(results["omega"], again["omega"])


def test_run_simulations_writes_every_metric(tmp_path):
    out = tmp_path / "corrs.json"
    corrs = T2.run_simulations(n_seeds=2, n_cells=60, n_genes=8, n_steps_s=5,
                               n_steps_u=5, out_path=str(out), device="cpu")
    import json

    assert json.loads(out.read_text()) == corrs
    assert len(corrs) == 7 and all(len(v) == 2 for v in corrs.values())


def test_exports_match_jax():
    import velocycle_tpu.twodim as jt
    import velocycle_tpu_torch.infer.autoguide as ta

    for name in ("prepare_data", "train_velo2d", "evaluate_fit",
                 "run_simulations", "generate_adata", "make_designs",
                 "Velo2DData", "velo2d_s_model", "velo2d_u_model"):
        assert hasattr(jt, name) and hasattr(T2, name), name
    assert callable(TI.adam) and ta.__all__ == ["AutoNormal", "AutoDelta"]


def test_example_08_smoke():
    env = dict(os.environ, VCT_SMOKE="1", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(
            REPO, "velocycle_tpu_torch", "examples", "08_velo2d_branching.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "stage S ELBO" in out.stdout and "stage U ELBO" in out.stdout
    assert out.stdout.count("corr[") == 7


@pytest.mark.slow
def test_two_stage_fit_recovers_fields(monkeypatch):
    """tests/test_twodim.py's fit and gates on the port, from the JAX
    package's init draw.  The guides' locs start at one prior draw of the
    model, and the gates at 24 genes hold only from some draws, in the JAX
    package too: from its own draw log_beta's correlation is 0.652, from
    init keys 1 and 2 it is 0.325 and 0.267; the port from its own draw
    (seeds 0-3) reaches 0.318-0.347 at a lower stage-2 loss, and from the
    JAX package's draw 0.654 (ROADMAP.md section 3).  So the port starts
    from the JAX package's prototype, as the parity tests substitute draws."""
    import velocycle_tpu_torch.twodim.driver as TD

    sim = T2.generate_adata(n_cells=200, n_genes=24, seed=0)
    jpd = J2.prepare_data(sim)
    protos = {}
    for jmodel, tmodel in MODELS.values():
        proto = JAutoNormal(jmodel)._get_prototype(jpd)
        protos[tmodel] = {k: torch.tensor(np.asarray(v)) for k, v in proto.items()}

    class FromJax(AutoNormal):
        def __init__(self, model):
            super().__init__(model, prefix="AutoNormal")

        def _get_prototype(self, *args, **kwargs):
            if self._prototype is None:
                self._prototype = protos[self.model]
            return self._prototype

    monkeypatch.setattr(TD, "AutoNormal", FromJax)
    pd = T2.prepare_data(sim, device="cpu")
    assert pd.design_s.shape[0] == 6 * 6 + 1
    results, losses_s, losses_u = T2.train_velo2d(
        pd, n_steps_s=600, n_steps_u=600, key=0)
    assert losses_s[-1] < losses_s[0]
    assert losses_u[-1] < losses_u[0]
    corrs = T2.evaluate_fit(sim, results)
    assert corrs["ElogS"] > 0.9, corrs
    assert corrs["ElogU"] > 0.6, corrs
    assert corrs["log_beta"] > 0.4, corrs
