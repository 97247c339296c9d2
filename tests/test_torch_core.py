"""The port's core (distributions, constraints, handlers) against the JAX
package on shared values, the trace structure of the phase model and guide,
and the import hygiene of the port."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import velocycle_tpu as V
from velocycle_tpu.core import constraints as jcon
from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.simulate import simulate_data as j_simulate
from velocycle_tpu_torch.convert import phase_data_from_jax
from velocycle_tpu_torch.core import constraints as tcon
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.models.phase import phase_guide, phase_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng():
    return np.random.default_rng(42)


def _dist_cases():
    rng = _rng()
    x = rng.normal(0, 2, (7, 5)).astype(np.float32)
    loc = rng.normal(0, 1, (7, 5)).astype(np.float32)
    scale = (np.abs(rng.normal(1, 0.3, (7, 5))) + 0.1).astype(np.float32)
    pos = (np.abs(rng.normal(2, 1, (7, 5))) + 0.05).astype(np.float32)
    conc = (np.abs(rng.normal(1.5, 0.5, (7, 5))) + 0.1).astype(np.float32)
    k = rng.poisson(4, (7, 5)).astype(np.float32)
    big_a = np.full((7, 5), 2000.0, np.float32)
    return {
        "Normal": (("Normal", loc, scale), x),
        "Independent": (("Normal", loc, scale), x),
        "Gamma": (("Gamma", conc, pos), pos[::-1].copy()),
        "Poisson": (("Poisson", pos), k),
        "GammaPoisson": (("GammaPoisson", conc, pos), k),
        "GammaPoisson_large_a": (("GammaPoisson", big_a, pos), k),
        "NegativeBinomial": (("NegativeBinomial", pos, scale), k),
        "Delta": (("Delta", loc), loc),
    }


@pytest.mark.parametrize("case", sorted(_dist_cases()))
def test_log_prob_matches_jax(case):
    (name, *params), value = _dist_cases()[case]
    td = getattr(tdist, name)(*[torch.as_tensor(p) for p in params])
    jd = getattr(jdist, name)(*[jnp.asarray(p) for p in params])
    if case == "Independent":
        td, jd = td.to_event(1), jd.to_event(1)
        assert td.batch_shape == tuple(jd.batch_shape)
        assert td.event_shape == tuple(jd.event_shape)
    got = td.log_prob(torch.as_tensor(value)).numpy()
    want = np.asarray(jd.log_prob(jnp.asarray(value)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_delta_log_density_is_the_factor():
    ld = torch.tensor(-3.25, requires_grad=True)
    d = tdist.Delta(torch.zeros(()), log_density=ld)
    out = d.log_prob(torch.zeros(()))
    out.backward()
    assert float(out.detach()) == -3.25 and float(ld.grad) == 1.0


def test_sampling_shapes_and_reparameterization():
    loc = torch.zeros(4, 3, requires_grad=True)
    d = tdist.Normal(loc, torch.ones(4, 3)).to_event(1)
    x = d.sample(7)
    assert x.shape == (4, 3)
    x.sum().backward()
    assert torch.equal(loc.grad, torch.ones(4, 3))   # reparameterized
    assert torch.equal(d.sample(7), tdist.Normal(loc, 1.0).sample(7))
    assert not torch.equal(d.sample(7), d.sample(8))
    g = tdist.Gamma(torch.full((5,), 2.0), torch.full((5,), 3.0)).sample(1)
    assert g.shape == (5,) and bool((g > 0).all())
    n = tdist.GammaPoisson(torch.full((5,), 2.0), torch.ones(5)).sample(1)
    assert n.shape == (5,) and bool((n >= 0).all())


def test_softplus_constraint_forward_and_inverse():
    u = np.linspace(-30, 30, 121).astype(np.float32)
    np.testing.assert_allclose(
        tcon.positive.forward(torch.as_tensor(u)).numpy(),
        np.asarray(jcon.positive.forward(jnp.asarray(u))), rtol=1e-6, atol=1e-7,
    )
    x = np.logspace(-4, 2, 61).astype(np.float32)
    inv = tcon.positive.inverse(torch.as_tensor(x))
    np.testing.assert_allclose(
        inv.numpy(), np.asarray(jcon.positive.inverse(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(tcon.positive.forward(inv).numpy(), x, rtol=1e-5)
    assert tcon.real.forward(torch.as_tensor(u)) is not None


def test_seed_is_per_site_and_reproducible():
    def model():
        a = th.sample("a", tdist.Normal(torch.zeros(3), 1.0))
        b = th.sample("b", tdist.Normal(torch.zeros(3), 1.0))
        return a, b

    a1, b1 = th.seed(model, 5)()
    a2, b2 = th.seed(model, 5)()
    a3, _ = th.seed(model, 6)()
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, b1) and not torch.equal(a1, a3)
    with pytest.raises(RuntimeError, match="no seed"):
        th.trace(model).get_trace()


def test_condition_block_replay_substitute():
    def model():
        th.sample("z", tdist.Normal(torch.zeros(2), 1.0))
        th.sample("w", tdist.Normal(torch.zeros(2), 1.0))

    fixed = torch.tensor([1.0, 2.0])
    tr = th.trace(th.seed(th.condition(model, data={"z": fixed}), 0)).get_trace()
    assert tr["z"]["is_observed"] and torch.equal(tr["z"]["value"], fixed)
    tr = th.trace(th.block(th.seed(model, 0), hide=["w"])).get_trace()
    assert list(tr) == ["z"]
    g = th.trace(th.seed(model, 1)).get_trace()
    tr = th.trace(th.seed(th.replay(model, guide_trace=g), 2)).get_trace()
    assert torch.equal(tr["w"]["value"], g["w"]["value"])
    tr = th.trace(th.seed(th.substitute(model, data={"w": fixed}), 0)).get_trace()
    assert torch.equal(tr["w"]["value"], fixed)


def _jax_phase_data(fused, with_dnu, Ng=16, Nc=40):
    adata = j_simulate(Nc=Nc, Ng=Ng, seed=3)
    cycle = V.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = V.Phases.from_angles(adata.obs["simulated_phis"].values,
                                  cell_names=list(adata.obs.index))
    design = None
    if with_dnu:
        design = (np.arange(Nc)[:, None] % 2 == np.arange(2)[None, :]).astype(np.int64)
    mp = V.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=2, with_delta_nu=with_dnu,
        design_mtx=design, use_fused_nb=fused,
    )
    return mp.data


def _structure(tr):
    return {
        name: (site["type"], tuple(np.shape(np.asarray(
            site["value"].detach().numpy() if isinstance(site["value"], torch.Tensor)
            else site["value"]))))
        for name, site in tr.items()
    }


@pytest.mark.parametrize("fused,with_dnu", [
    (False, False), (False, True), (True, False), (True, True),
])
def test_phase_trace_structure_matches_jax(fused, with_dnu):
    from velocycle_tpu.models import phase as jphase

    jdata = _jax_phase_data(fused, with_dnu)
    tdata = phase_data_from_jax(jdata, device="cpu")
    for jfn, tfn in ((jphase.phase_guide, phase_guide),
                     (jphase.phase_model, phase_model)):
        jtr = jh.trace(jh.seed(jfn, jax.random.PRNGKey(0))).get_trace(jdata)
        ttr = th.trace(th.seed(tfn, 0)).get_trace(tdata)
        assert list(ttr) == list(jtr)
        assert _structure(ttr) == _structure(jtr)
        for name in jtr:
            assert (ttr[name].get("cond_indep_stack")
                    == jtr[name].get("cond_indep_stack")), name


def test_package_never_imports_jax():
    """velocycle_tpu_torch and chip_smoke.py import no jax/flax/optax and
    nothing of velocycle_tpu, at module level or lazily."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|velocycle_tpu)\b",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "velocycle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders
    assert os.path.join(REPO, "velocycle_tpu_torch", "native", "__init__.py") in files
    assert os.path.join(REPO, "velocycle_tpu_torch", "genes.py") in files
    for f in (("twodim", "models.py"), ("twodim", "simulate.py"),
              ("twodim", "driver.py"), ("infer", "autoguide.py"),
              ("examples", "08_velo2d_branching.py")):
        assert os.path.join(REPO, "velocycle_tpu_torch", *f) in files, f
    code = ("import sys, velocycle_tpu_torch, velocycle_tpu_torch.fit, "
            "velocycle_tpu_torch.twodim, velocycle_tpu_torch.infer.autoguide, "
            "velocycle_tpu_torch.convert, velocycle_tpu_torch.ops.nb_kernels, "
            "velocycle_tpu_torch.ops.ladder_kernels, "
            "velocycle_tpu_torch.tools.kernel_profile, "
            "velocycle_tpu_torch.native, velocycle_tpu_torch.genes, "
            "velocycle_tpu_torch.alignment, velocycle_tpu_torch.anndata_lite; "
            "velocycle_tpu_torch.native.available(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'velocycle_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from velocycle_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
