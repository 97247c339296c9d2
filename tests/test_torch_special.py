"""The port's special functions (velocycle_tpu_torch/ops/special.py) against
their JAX twins (velocycle_tpu/ops/special.py) and against f64 scipy, on the
same numpy inputs."""
import numpy as np
import pytest
import scipy.special as ss
import torch
import jax.numpy as jnp

from velocycle_tpu.ops import special as jsp_special
from velocycle_tpu_torch.ops import special as tsp


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    """Integer counts x per-gene a = 1/r over the range the NB models hit."""
    k = np.array([0, 1, 2, 3, 4, 5, 7, 8, 20, 200, 5000], np.float32)[None, :]
    a = np.array([0.05, 0.3, 1.0, 4.0, 50.0, 2000.0], np.float32)[:, None]
    return np.ascontiguousarray(np.broadcast_to(k, (a.shape[0], k.shape[1]))), a


def _x_pos():
    return np.concatenate([
        np.linspace(1e-3, 0.5, 57), np.linspace(0.5, 30, 101),
        np.logspace(1.5, 6, 53),
    ]).astype(np.float32)


def _x_real():
    return np.linspace(-40, 40, 401).astype(np.float32)


def _t(x):
    return torch.as_tensor(x)


# name: (inputs, the JAX twin's outputs, the port's same outputs).  The
# JAX package's softplus and softplus_sigmoid are held against the halves
# of the port's softplus_log_sigmoid, which replaced them in the NB element
CASES = {
    "lgamma_pos": (lambda: (_x_pos(),), lambda f, x: [f(x)], None),
    "softplus": (lambda: (_x_real(),), lambda f, x: [f(x)],
                 lambda x: [tsp.softplus_log_sigmoid(x)[0]]),
    "softplus_sigmoid": (lambda: (_x_real(),), lambda f, x: list(f(x)),
                         lambda x: list(tsp.softplus_log_sigmoid(x)[::2])),
    "lgamma_digamma_ratio": (_grid, lambda f, k, a: list(f(k, a)), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_twin(name):
    """Same formulas in the same order: f32 agreement at 1e-6 (relative,
    with an absolute floor of 1e-6 for values near zero)."""
    make, call, port = CASES[name]
    inputs = make()
    got = (port(*[_t(x) for x in inputs]) if port is not None
           else call(getattr(tsp, name), *[_t(x) for x in inputs]))
    want = call(getattr(jsp_special, name), *[jnp.asarray(x) for x in inputs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_lgamma_pos_and_softplus_vs_scipy():
    x = _x_pos()
    x64 = x.astype(np.float64)
    lg = tsp.lgamma_pos(_t(x)).numpy()
    assert np.max(np.abs(lg - ss.gammaln(x64)) / (np.abs(ss.gammaln(x64)) + 1.0)) < 5e-4
    y = _x_real()
    y64 = y.astype(np.float64)
    sp, log_sig, sig, sig_c = tsp.softplus_log_sigmoid(_t(y))
    np.testing.assert_allclose(sp.numpy(), np.logaddexp(0.0, y64),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sig.numpy(), 1.0 / (1.0 + np.exp(-y64)),
                               rtol=1e-6, atol=1e-7)
    # log sigmoid and 1 - sigmoid keep their RELATIVE precision where they
    # are tiny (x large), which the differences x - softplus and 1 - sigmoid
    # would not
    np.testing.assert_allclose(log_sig.numpy(), -np.logaddexp(0.0, -y64),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(sig_c.numpy(), 1.0 / (1.0 + np.exp(y64)),
                               rtol=1e-6, atol=0)
    sp2, log_sig2 = tsp.softplus_log_sigmoid(_t(y), with_sigmoid=False)
    assert torch.equal(sp2, sp) and torch.equal(log_sig2, log_sig)


def test_lgamma_digamma_ratio_vs_scipy():
    """The lgamma half holds the JAX suite's tolerance (rtol 3e-6, atol
    1e-5, tests/test_nb_kernels.py:304).  The digamma half truncates its
    asymptotic tail at z^-6, evaluated at y = a + 2: the dropped term
    1/(240 y^8) tends to 1.6e-5 as a = 1/r -> 0 (y -> 2).  Measured below
    at a = 0.05 (below that, f32 rounding of the exact 1/a terms takes
    over): 0.9e-5 .. 1.2e-5 absolute for every k >= 3, against 0.7e-6 at
    a = 1.  It is held to atol 2e-5 — the measurement, not the docstring's
    ~2e-7 claim."""
    k, a = _grid()
    lgr, dgr = tsp.lgamma_digamma_ratio(_t(k), _t(a))
    k64, a64 = k.astype(np.float64), a.astype(np.float64)
    want_l = ss.gammaln(k64 + a64) - ss.gammaln(a64)
    want_d = ss.digamma(k64 + a64) - ss.digamma(a64)
    np.testing.assert_allclose(lgr.numpy(), want_l, rtol=3e-6, atol=1e-5)
    np.testing.assert_allclose(dgr.numpy(), want_d, rtol=3e-6, atol=2e-5)

    # the truncation, measured: a constant offset for k >= 3 at small a
    k = np.arange(0, 40, dtype=np.float32)[None, :].repeat(3, 0)
    a = np.array([0.05, 1.0, 50.0], np.float32)[:, None]
    _, dgr = tsp.lgamma_digamma_ratio(_t(k), _t(a))
    k64, a64 = k.astype(np.float64), a.astype(np.float64)
    err = np.abs(dgr.numpy() - (ss.digamma(k64 + a64) - ss.digamma(a64)))
    assert 8e-6 < err[0, 3:].min() and err.max() < 2e-5
    assert err[:, :3].max() < 1e-6          # k < 3: exact sums, no tail
    assert err[1:].max() < 1e-6             # larger a: the tail is negligible
