"""Shared harness of the port-against-JAX ELBO tests of the model variants
(tests/test_torch_splines.py, tests/test_torch_variants.py).

At fixed params (the JAX guide's init, perturbed by seeded numpy noise and
carried into the port by `convert.params_from_jax`), with every
reparameterized guide draw built from the same numpy noise in both
packages (Normal sites: loc + scale * eps; the LRMN draw: loc + W eps_w +
sqrt(D) eps_d), `elbo_and_grads` returns each package's loss and its
gradient with respect to every param.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import SVI as JSVI, Trace_ELBO as JELBO
from velocycle_tpu.infer.svi import init_params as j_init_params
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import params_from_jax
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import SVI as TSVI, Trace_ELBO as TELBO

# the stated tolerances: ELBO relative, gradients max|a-b| / max|a|
ELBO_RTOL = 5e-4
GRAD_RTOL = 1e-4
VELO_GRAD_RTOL = 5e-4


def _noise_messenger(base, lrmn_draw):
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


def _to(pkg, e):
    if isinstance(e, tuple):
        return tuple(_to(pkg, x) for x in e)
    if pkg == "jax":
        return jnp.asarray(e, jnp.float32)
    return torch.as_tensor(np.asarray(e), dtype=torch.float32)


def elbo_and_grads(jmodel, jguide, tmodel, tguide, jdata, tdata, eps,
                   cond=None, jloss=None, tloss=None, seed=0):
    """(JAX loss, {param: JAX grad}, port loss, {param: port grad}).

    ``eps`` maps guide sample sites to numpy noise (a tuple for the LRMN
    draw); ``cond`` maps model sites to conditioned numpy values (the
    guide then hides them, as the fit classes do)."""
    if cond:
        jmodel = jh.condition(jmodel, data={k: _to("jax", v) for k, v in cond.items()})
        jguide = jh.block(jguide, hide=list(cond))
        tmodel = th.condition(tmodel, data={k: _to("torch", v) for k, v in cond.items()})
        tguide = th.block(tguide, hide=list(cond))
    rng = np.random.default_rng(seed)
    params, jcons = j_init_params(jguide, jax.random.PRNGKey(0), jdata)
    params = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
              for k, v in params.items()}

    jsvi = JSVI(jmodel, JNoise(jguide, {k: _to("jax", v) for k, v in eps.items()}),
                None, jloss or JELBO())
    jsvi.constraints = jcons
    jl, jg = jax.value_and_grad(jsvi.loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()}, jax.random.PRNGKey(1),
        jdata)

    tsvi = TSVI(tmodel, TNoise(tguide, {k: _to("torch", v) for k, v in eps.items()}),
                None, tloss or TELBO())
    _, tsvi.constraints = T.infer.svi.init_params(tsvi.guide, 0, tdata)
    tparams = params_from_jax(params, device="cpu")
    tl = tsvi.loss_fn(tparams, 1, tdata)
    tl.backward()
    tg = {k: (np.zeros_like(v.detach().numpy()) if v.grad is None
              else v.grad.numpy()) for k, v in tparams.items()}
    return float(jl), {k: np.asarray(v) for k, v in jg.items()}, float(tl.detach()), tg


def assert_elbo_and_grads_close(jl, jg, tl, tg, grad_rtol=GRAD_RTOL,
                                loss_rtol=ELBO_RTOL):
    assert np.isfinite(tl) and abs(tl - jl) / abs(jl) < loss_rtol, (tl, jl)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert np.isfinite(tg[k]).all(), k
        err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
        assert err < grad_rtol, (k, err)


def jax_elbo(jmodel, jguide, jdata, eps, cond=None, seed=0):
    """(fixed params as numpy, the JAX loss, {param: JAX gradient}) at the
    JAX guide's init perturbed by seeded noise, the guide's draws from
    ``eps`` (tests/_torch_parity.py's `elbo_and_grads`, JAX half)."""
    if cond:
        jmodel = jh.condition(jmodel, data={k: jnp.asarray(v)
                                            for k, v in cond.items()})
        jguide = jh.block(jguide, hide=list(cond))
    rng = np.random.default_rng(seed)
    params, jcons = j_init_params(jguide, jax.random.PRNGKey(0), jdata)
    params = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(
        np.float32) for k, v in params.items()}
    jeps = {k: (tuple(jnp.asarray(x, jnp.float32) for x in v)
                if isinstance(v, tuple) else jnp.asarray(v, jnp.float32))
            for k, v in eps.items()}
    jsvi = JSVI(jmodel, JNoise(jguide, jeps), None, JELBO())
    jsvi.constraints = jcons
    jl, jg = jax.value_and_grad(jsvi.loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()},
        jax.random.PRNGKey(1), jdata)
    return params, float(jl), {k: np.asarray(v) for k, v in jg.items()}


def first_trace_at(pkg_handlers, model, values):
    """``model`` whose FIRST call has its latent sites substituted by
    ``values``: the reference draw of `init_tempered_model` in either
    package; later calls are the model's own."""
    calls = []

    def wrapped(*args, **kwargs):
        if not calls:
            calls.append(1)
            return pkg_handlers.substitute(model, data=values)(*args, **kwargs)
        return model(*args, **kwargs)

    return wrapped
