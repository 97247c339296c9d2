"""The port's fused velocity S+U NB likelihood (velocycle_tpu_torch/ops/
nb_kernels.py) against the JAX package, on the same numpy inputs.

On the CPU `nbsu_loglik_fused` runs its plain version (the kernels'
per-element arithmetic over the whole matrix); the JAX side is its plain
`nbsu_loglik_reference` + `jax.grad` in the fast lane, and interpret-mode
Pallas in one slow case.  Tolerances are the JAX suite's velocity gates
(tests/test_nb_kernels.py): loss rel 1e-5, gradients max|a-b|/max|a| 5e-4.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import scipy.special as sps
import torch
import jax
import jax.numpy as jnp

from velocycle_tpu.ops import nb_kernels as JK
from velocycle_tpu_torch.ops import nb_kernels as TK

NAMES = ("nu", "zeta", "zeta_dphi", "cf", "omega", "log_beta", "log_gamma",
         "disp", "dnu")
LOSS_RTOL, GRAD_RTOL = 1e-5, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Ng=60, Nc=90, Nh=5, seed=0, Nb=0, gated=False):
    """numpy (S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r
    [, dnu, Db]).  ``gated``: omega ~ N(0, 1) and gamma ~ exp(-1), so that a
    large share of elements sits below the relu (x <= 0)."""
    rng = np.random.default_rng(seed)
    H = Nh // 2   # the first Nh Fourier columns of H harmonics
    hphi = np.outer(rng.uniform(0, 2 * np.pi, Nc), np.arange(1, H + 1))
    h = np.arange(1, H + 1)
    zeta = np.concatenate(
        [np.ones((Nc, 1)),
         np.stack([np.cos(hphi), np.sin(hphi)], -1).reshape(Nc, -1)], 1)[:, :Nh]
    zdphi = np.concatenate(
        [np.zeros((Nc, 1)),
         np.stack([-h * np.sin(hphi), h * np.cos(hphi)], -1).reshape(Nc, -1)],
        1)[:, :Nh]
    omega = rng.normal(0, 1, Nc) if gated else np.exp(rng.normal(-1, 0.2, Nc))
    out = [
        rng.poisson(3, (Ng, Nc)).astype(np.float32),
        rng.poisson(1.5, (Ng, Nc)).astype(np.float32),
        rng.normal(0.5, 0.5, (Ng, Nh)).astype(np.float32),
        zeta.astype(np.float32),
        zdphi.astype(np.float32),
        rng.normal(0, 0.2, Nc).astype(np.float32),
        omega.astype(np.float32),
        rng.normal(0, 0.2, Ng).astype(np.float32),
        rng.normal(-1.0 if gated else 0.0, 0.2, Ng).astype(np.float32),
        (np.abs(rng.normal(0.5, 0.2, Ng)) + 0.05).astype(np.float32),
    ]
    if Nb:
        groups = rng.integers(0, Nb, Nc)
        out += [rng.normal(0, 0.1, (Nb, Ng)).astype(np.float32),
                (np.arange(Nb)[:, None] == groups[None, :]).astype(np.float32)]
    return out


def _share_below_relu(args):
    x = (args[2] @ args[4].T) * args[6][None, :] + np.exp(args[8])[:, None]
    return float((x <= 0).mean())


def _lgk(args):
    return np.float32(sum(sps.gammaln(k.astype(np.float64) + 1.0).sum()
                          for k in args[:2]))


def _torch_value_and_grads(args, lgk=None, disp_grad=True, scale=1.0):
    S, U = (torch.as_tensor(a) for a in args[:2])
    leaves = [torch.tensor(a, requires_grad=True) for a in args[2:10]]
    extra = [torch.tensor(args[10], requires_grad=True),
             torch.as_tensor(args[11])] if len(args) > 10 else [None, None]
    loss = TK.nbsu_loglik_fused(S, U, *leaves, *extra, lgamma_k_sum=lgk,
                                disp_grad=disp_grad)
    (scale * loss).backward()
    grads = [t.grad.numpy() for t in leaves]
    if extra[0] is not None:
        grads.append(extra[0].grad.numpy())
    return float(loss.detach()), grads


def _jax_value_and_grads(fn, args):
    argnums = tuple(range(2, 11 if len(args) > 10 else 10))
    val, grads = jax.value_and_grad(fn, argnums=argnums)(
        *[jnp.asarray(a) for a in args])
    return float(val), [np.asarray(g) for g in grads]


def _max_rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _assert_match(t, j):
    (tl, tg), (jl, jg) = t, j
    assert abs(tl - jl) / max(abs(jl), 1.0) < LOSS_RTOL, (tl, jl)
    for name, a, b in zip(NAMES, tg, jg):
        assert _max_rel(a, b) < GRAD_RTOL, (name, _max_rel(a, b))


@pytest.mark.parametrize("Ng,Nc,Nb,gated", [
    (60, 90, 0, False), (1, 1, 0, False), (129, 257, 0, False),
    (3, 300, 0, False), (60, 90, 2, False), (60, 90, 0, True),
    (40, 120, 2, True),
])
def test_fused_loss_and_grads_match_jax(Ng, Nc, Nb, gated):
    args = _inputs(Ng=Ng, Nc=Nc, seed=Ng + Nc, Nb=Nb, gated=gated)
    if gated:
        # the relu gate and the 1/xr chain are exercised for real
        assert _share_below_relu(args) >= 0.10
    _assert_match(_torch_value_and_grads(args),
                  _jax_value_and_grads(JK.nbsu_loglik_reference, args))


def test_reference_matches_jax_reference():
    for Nb in (0, 2):
        args = _inputs(Ng=40, Nc=90, seed=3, Nb=Nb, gated=True)
        t = float(TK.nbsu_loglik_reference(*[torch.as_tensor(a) for a in args]))
        j = float(JK.nbsu_loglik_reference(*[jnp.asarray(a) for a in args]))
        assert abs(t - j) / abs(j) < 1e-6


def test_elogs_match_jax_elementwise():
    """_velo_elogs against the JAX function the Pallas kernels run, with
    the (ElogS, ElogU, dEs, gamma, x, xr) intermediates the gradients use."""
    args = _inputs(Ng=30, Nc=200, seed=5, Nb=2, gated=True)
    nu, zeta, zdphi, cf, om, lb, lg = args[2:9]
    dnu, Db = args[10:]
    got = TK._velo_elogs(*(torch.as_tensor(a) for a in
                           (nu, zeta, zdphi, cf, om, lb, lg, dnu, Db)))
    refs = {"nu": nu, "zeta": zeta, "zdphi": zdphi, "cf": cf[None, :],
            "omega": om[None, :], "lbeta": lb[:, None], "lgamma": lg[:, None],
            "dnuT": dnu.T, "Db": Db}

    class Ref:
        def __init__(self, a):
            self.a = jnp.asarray(a)

        def __getitem__(self, _):
            return self.a

    want = JK._velo_elogs(*(Ref(refs[k]) for k in (
        "nu", "zeta", "zdphi", "cf", "omega", "lbeta", "lgamma", "dnuT", "Db")),
        True)
    for name, g, w in zip(("elogS", "elogU", "dEs", "gamma", "x", "xr"), got, want):
        w = np.asarray(w).reshape(tuple(g.shape))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_disp_grad_false_zero_dispersion_rest_unchanged():
    args = _inputs(Ng=40, Nc=200, seed=13)
    l_on, g_on = _torch_value_and_grads(args, disp_grad=True)
    l_off, g_off = _torch_value_and_grads(args, disp_grad=False)
    assert l_on == l_off
    for i in range(7):
        np.testing.assert_array_equal(g_on[i], g_off[i])
    assert np.abs(g_on[7]).max() > 0
    assert np.abs(g_off[7]).max() == 0.0


def test_int16_counts_match_float32():
    args = _inputs(Ng=40, Nc=200, seed=11, gated=True)
    l32, g32 = _torch_value_and_grads(args)
    l16, g16 = _torch_value_and_grads(
        [args[0].astype(np.int16), args[1].astype(np.int16)] + args[2:])
    assert l32 == l16
    for a, b in zip(g32, g16):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("s_int16,u_int16", [(True, False), (False, True)])
def test_mixed_count_dtypes_match_float32(s_int16, u_int16):
    """S and U each int16 or float32 on its own, as preprocessing leaves a
    dataset with a count beyond int16 in one matrix only: the same loss and
    gradients as float32 counts in both."""
    args = _inputs(Ng=40, Nc=200, seed=11, gated=True)
    l32, g32 = _torch_value_and_grads(args)
    mixed = [args[0].astype(np.int16) if s_int16 else args[0],
             args[1].astype(np.int16) if u_int16 else args[1]] + args[2:]
    lm, gm = _torch_value_and_grads(mixed)
    assert lm == l32
    for a, b in zip(gm, g32):
        np.testing.assert_array_equal(a, b)


WIDE = [(4, 0), (9, 0), (11, 0), (5, 5), (5, 6), (9, 2)]


def _widened_value_and_grads(args, want_disp=True):
    """Loss and gradients through the kernels' width route with the plain
    version in place of the kernel: widen (zeta takes Db's columns,
    zeta_dphi zeros), fwd+grad, narrow."""
    t = [torch.as_tensor(a) for a in args] + [None, None][:12 - len(args)]
    nu, zeta, zdphi, dnu, Db = t[2], t[3], t[4], t[10], t[11]
    Nb = 0 if dnu is None else dnu.shape[0]
    width, fold = TK.kernel_width(nu.shape[1], Nb, TK.velo_layout().max_nb)
    assert width in TK.KERNEL_WIDTHS
    nu_w, (zeta_w, zdphi_w), dnu_w, Db_w = TK.widen_inputs(
        nu, [zeta, zdphi], dnu, Db, width, fold)
    assert nu_w.shape[1] == zeta_w.shape[1] == zdphi_w.shape[1] == width
    loss, g = TK.velo_fwdgrad_plain(*t[:2], nu_w, zeta_w, zdphi_w, *t[5:10],
                                    dnu_w, Db_w, want_disp=want_disp)
    gnu, (gzeta, gzdphi), gdnu = TK.narrow_grads(g[0], [g[1], g[2]], g[8],
                                                 nu.shape[1], Nb, fold)
    return loss, (gnu, gzeta, gzdphi, *g[3:8], gdnu)


@pytest.mark.parametrize("Nh,Nb", WIDE)
def test_widened_inputs_narrow_back_to_the_plain_result(Nh, Nb):
    """Zero columns add exact zeros (dEs, so x and the relu gate, keep
    their bits) and folded batches are basis columns: the plain fwd+grad of
    the widened inputs, narrowed back, is the plain fwd+grad of the
    originals (to f32 rounding of the reordered ElogS sum)."""
    args = _inputs(Ng=30, Nc=70, Nh=Nh, seed=Nh + Nb, Nb=Nb, gated=True)
    t = [torch.as_tensor(a) for a in args] + [None, None][:12 - len(args)]
    x = TK._velo_elogs(*t[2:9], t[10], t[11])[4]
    nu_w, (zeta_w, zdphi_w), _, _ = TK.widen_inputs(
        t[2], [t[3], t[4]], t[10], t[11], *TK.kernel_width(Nh, Nb, 4))
    assert torch.equal(TK._velo_elogs(nu_w, zeta_w, zdphi_w, *t[5:9], None,
                                      None)[4], x)
    for want_disp in (True, False):
        loss, grads = TK.velo_fwdgrad_plain(*t, want_disp=want_disp)
        wloss, wgrads = _widened_value_and_grads(args, want_disp)
        assert abs(float(wloss) - float(loss)) / abs(float(loss)) < 1e-6
        for name, a, b in zip(NAMES, wgrads, grads):
            if b is None:
                assert a is None
            else:
                assert a.shape == b.shape, name
                assert _max_rel(a.numpy(), b.numpy()) < 1e-5, name


@pytest.mark.parametrize("Nh,Nb", WIDE)
def test_wide_and_batched_shapes_match_jax(Nh, Nb):
    """Basis widths off the kernels' instantiations and more batches than
    they take as such, against the JAX package: the port's fused
    likelihood (its plain version here) and the kernels' width route."""
    args = _inputs(Ng=30, Nc=70, Nh=Nh, seed=Nh + Nb, Nb=Nb, gated=True)
    j = _jax_value_and_grads(JK.nbsu_loglik_reference, args)
    wl, wg = _widened_value_and_grads(args)
    _assert_match(_torch_value_and_grads(args), j)
    _assert_match((float(wl), [g.numpy() for g in wg if g is not None]), j)


def test_lgamma_k_sum_shortcut_matches():
    """The constant is the sum over S AND U."""
    args = _inputs(Ng=60, Nc=90)
    full, gfull = _torch_value_and_grads(args)
    short, gshort = _torch_value_and_grads(args, lgk=_lgk(args))
    assert abs(full - short) / abs(full) < 1e-5
    for a, b in zip(gfull, gshort):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_output_scaling():
    args = _inputs(Ng=20, Nc=30, Nb=2)
    _, g1 = _torch_value_and_grads(args, scale=2.5)
    _, g0 = _torch_value_and_grads(args)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, 2.5 * b, rtol=1e-6)


def test_loss_only_path_without_grad():
    """No gradient needed -> the loss-only route (its softplus form differs
    from the fwd+grad route's log1p form by f32 rounding only)."""
    args = [torch.as_tensor(a) for a in _inputs(Ng=40, Nc=90, seed=2)]
    with torch.no_grad():
        l_fwd = float(TK.nbsu_loglik_fused(*args))
    l_grad, _ = TK.velo_fwdgrad_plain(*args)
    assert abs(l_fwd - float(l_grad)) / abs(l_fwd) < 1e-6
    assert l_fwd == float(TK.velo_fwd_plain(*args))


def test_kernel_wrappers_refuse_what_they_cannot_take():
    args = [torch.as_tensor(a) for a in _inputs(Ng=8, Nc=16, seed=1)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.velo_fwd(*args)
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.velo_fwdgrad(*args)
    with pytest.raises(ValueError, match="U must have shape"):
        TK.nbsu_loglik_fused(args[0], args[1][:, :15], *args[2:])
    with pytest.raises(ValueError, match="zeta_dphi must have shape"):
        TK.nbsu_loglik_fused(*args[:4], args[4][:15], *args[5:])
    with pytest.raises(ValueError, match="log_gamma must have shape"):
        TK.nbsu_loglik_fused(*args[:8], args[8][:7], args[9])
    with pytest.raises(ValueError, match="together"):
        TK.nbsu_loglik_fused(*args, delta_nu=torch.zeros(1, 8))


@pytest.mark.slow
def test_fused_matches_jax_interpret_mode_pallas():
    """Against the JAX package's fused kernels themselves (interpret mode):
    `_velo_fwdgrad_impl` through `nbsu_loglik_fused`'s VJP, and
    `_velo_fused_impl` for the loss alone."""
    for Nb, gated in ((0, False), (2, True)):
        args = _inputs(Ng=60, Nc=90, seed=1, Nb=Nb, gated=gated)
        const = _lgk(args)
        t = _torch_value_and_grads(args, lgk=const)
        j = _jax_value_and_grads(
            lambda *a: JK.nbsu_loglik_fused(*a, lgamma_k_sum=const), args)
        _assert_match(t, j)
        jargs = [jnp.asarray(a) for a in args] + [None, None][:12 - len(args)]
        j_fwd = float(JK._velo_fused_impl(*jargs, const))
        with torch.no_grad():
            t_fwd = float(TK.nbsu_loglik_fused(
                *[torch.as_tensor(a) for a in args], lgamma_k_sum=const))
        assert abs(t_fwd - j_fwd) / abs(j_fwd) < LOSS_RTOL
