"""The plain NB element (velocycle_tpu_torch/ops/likelihoods.py `NBLogPmf`:
`nb_logpmf` and the models' ``NegativeBinomial`` log-prob).

Its value is the element's before `NBLogPmf` (frozen below), bit for bit,
and within the gates of the JAX package's `nb_logpmf`; its derivatives in
ElogS and r take the fused kernels' element's form, held against float64
autograd of the direct form at shape_inv 1e-6 .. 1e-2 (the direct form's
own float32 gradient cancels there), against the JAX package's plain
gradient at ordinary dispersion, under `torch.func.vmap`, as the NUTS warm
start's Hessian diagonal (`torch.func.jvp` of `grad` under `vmap`), and by
gradcheck / gradgradcheck in float64.  Counts int16 and float32 with k in
{0, 1, 2, large}, from numpy seeds.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from velocycle_tpu.core import distributions as jdist
from velocycle_tpu.ops.likelihoods import nb_logpmf as j_nb_logpmf
import velocycle_tpu_torch.fit_mcmc as TF
from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.ops import likelihoods as L
from velocycle_tpu_torch.tools import nb_noise

SHAPE_INVS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
MAX_REL = 1e-6          # max error / max |gradient| against float64
MEDIAN_REL = 1e-4       # median over the genes of the relative error
HDIAG_REL = 1e-3        # the warm start's Hessian diagonal, median
GRAD_RTOL = 1e-4        # max|a-b| / max|a| against the JAX package
                        # (tests/_torch_parity.py)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the element before NBLogPmf, frozen -----------------------------------

def _frozen_lgamma_diff(k, a):
    def rc(z):
        z2 = z * z
        return ((1.0 / 12.0) / z - (1.0 / 360.0) / (z * z2)
                + (1.0 / 1260.0) / (z * z2 * z2))

    direct = torch.lgamma(k + a) - torch.lgamma(a)
    a_big = torch.clamp(a, min=8.0)
    stirling = ((a_big - 0.5) * torch.log1p(k / a_big)
                + k * torch.log(a_big + k) - k + rc(a_big + k) - rc(a_big))
    return torch.where(a >= 8.0, stirling, direct)


def _frozen_nb_logpmf(k, elog_mu, dispersion):
    k = k.to(torch.float32)
    a = 1.0 / dispersion
    s = elog_mu + torch.log(dispersion)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return (_frozen_lgamma_diff(k, a) - torch.lgamma(k + 1.0)
            - a * torch.logaddexp(s, zero) - k * torch.logaddexp(-s, zero))


def _frozen_negative_binomial_log_prob(value, mean, r):
    a, b = 1.0 / r, 1.0 / (r * mean)
    value = value.to(a.dtype)
    return (_frozen_lgamma_diff(value, a) - torch.lgamma(value + 1.0)
            - a * torch.log1p(1.0 / b) - value * torch.log1p(b))


# -- data ------------------------------------------------------------------

def _counts(rng, Ng, Nc, int16):
    """Counts with every gene holding 0, 1, 2 and a large count (an outlier
    far above its mean), the rest from floor(exp(N(1, 0.8^2)))
    (chip_smoke.py's draw)."""
    k = np.floor(np.exp(rng.normal(1.0, 0.8, (Ng, Nc))))
    k[:, :4] = [0.0, 1.0, 2.0, 30000.0 if int16 else 1e5]
    dtype = np.int16 if int16 else np.float32
    return torch.as_tensor(k.astype(dtype))


def _case(seed=0, Ng=40, Nc=300, int16=False):
    rng = np.random.default_rng(seed)
    k = _counts(rng, Ng, Nc, int16)
    elog = torch.as_tensor(rng.normal(1.0, 0.6, (Ng, Nc)).astype(np.float32))
    return k, elog


def _spread(si, Ng, dtype=torch.float32):
    return si * torch.exp(torch.linspace(-0.3, 0.3, Ng, dtype=dtype))


def _grads(fn, k, elog, r):
    e = elog.clone().requires_grad_(True)
    rr = r.clone().requires_grad_(True)
    return torch.autograd.grad(fn(k, e, rr[:, None]).sum(), (e, rr))


def _via_distribution(k, elog, r):
    return tdist.NegativeBinomial(mean=torch.exp(elog),
                                  dispersion=r).log_prob(k)


def _against_f64(k, elog, r, fn):
    """(elog max rel, r max rel, r median rel over genes) of ``fn``'s
    float32 gradients against float64 autograd of the direct form."""
    g_e, g_r = _grads(fn, k, elog, r)
    w_e, w_r = _grads(L.nb_logpmf_direct, k.double(), elog.double(),
                      r.double())
    err_r = (g_r.double() - w_r).abs()
    return (float((g_e.double() - w_e).abs().max() / w_e.abs().max()),
            float(err_r.max() / w_r.abs().max()),
            float((err_r / w_r.abs()).median()))


# -- the value ---------------------------------------------------------------

@pytest.mark.parametrize("int16", [True, False], ids=["int16", "f32"])
def test_value_is_the_parent_elements_bit_for_bit(int16):
    k, elog = _case(int16=int16)
    for si in SHAPE_INVS + (0.3, 3.0):
        r = _spread(si, k.shape[0])[:, None]
        assert torch.equal(L.nb_logpmf(k, elog, r),
                           _frozen_nb_logpmf(k, elog, r)), si
        mean = torch.exp(elog)
        assert torch.equal(
            tdist.NegativeBinomial(mean=mean, dispersion=r).log_prob(k),
            _frozen_negative_binomial_log_prob(k, mean, r)), si


def _assert_close_to_jax(got, want, k):
    """The gates of tests/test_torch_core.py::test_log_prob_matches_jax
    (rtol = atol = 1e-5) for the ordinary counts; for the large count,
    whose terms are O(k log k) and round to ~0.03 in float32, within 1e-6
    of lgamma(k + 1)."""
    big = k.numpy()[0].astype(np.float64) >= 1e4
    np.testing.assert_allclose(got[:, ~big], want[:, ~big], rtol=1e-5,
                               atol=1e-5)
    scale = torch.lgamma(torch.as_tensor(k.numpy()[:, big],
                                         dtype=torch.float64) + 1.0).numpy()
    assert (np.abs(got[:, big] - want[:, big]) <= 1e-6 * scale).all()


@pytest.mark.parametrize("int16", [True, False], ids=["int16", "f32"])
def test_value_within_the_jax_element(int16):
    k, elog = _case(int16=int16)
    for si in SHAPE_INVS + (0.3,):
        r = _spread(si, k.shape[0])[:, None]
        got = L.nb_logpmf(k, elog, r).numpy()
        want = np.asarray(j_nb_logpmf(jnp.asarray(k.numpy()),
                                      jnp.asarray(elog.numpy()),
                                      jnp.asarray(r.numpy())))
        _assert_close_to_jax(got, want, k)
        mean = torch.exp(elog)
        got = _via_distribution(k, elog, r).numpy()
        want = np.asarray(jdist.NegativeBinomial(
            jnp.asarray(mean.numpy()), jnp.asarray(r.numpy())).log_prob(
                jnp.asarray(k.numpy().astype(np.float32))))
        _assert_close_to_jax(got, want, k)


def test_negative_binomial_draws_the_parents_draws():
    rng = np.random.default_rng(3)
    mean = torch.as_tensor(np.exp(rng.normal(1, 0.6, (7, 50))).astype(
        np.float32))
    r = torch.as_tensor(rng.uniform(1e-4, 2.0, (7, 1)).astype(np.float32))
    d = tdist.NegativeBinomial(mean=mean, dispersion=r)
    parent = tdist.GammaPoisson(1.0 / r, 1.0 / (r * mean))
    assert isinstance(d, tdist.GammaPoisson)
    for seed in (0, 11):
        for shape in ((), (3,)):
            assert torch.equal(d.sample(seed, shape),
                               parent.sample(seed, shape))


# -- the gradient ------------------------------------------------------------

@pytest.mark.parametrize("si", SHAPE_INVS)
@pytest.mark.parametrize("int16", [True, False], ids=["int16", "f32"])
def test_gradients_against_float64(si, int16):
    """Both entry points of the element, `nb_logpmf` and the models'
    ``NegativeBinomial``: the r gradient within MAX_REL of the largest and
    MEDIAN_REL over the genes, the elog gradient within MAX_REL."""
    k, elog = _case(seed=1, int16=int16)
    r = _spread(si, k.shape[0])
    for fn in (L.nb_logpmf, _via_distribution):
        e_max, r_max, r_med = _against_f64(k, elog, r, fn)
        assert e_max < MAX_REL and r_max < MAX_REL and r_med <= MEDIAN_REL, (
            fn, e_max, r_max, r_med)


def test_fractional_counts_against_float64():
    """The plain path takes fractional counts: the ratio form's digamma
    difference and the excess form's excess hold for real k."""
    k, elog = _case(seed=2)
    k = k + torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, tuple(k.shape)).astype(np.float32))
    for si in SHAPE_INVS + (0.3, 3.0):
        e_max, r_max, r_med = _against_f64(k, elog, _spread(si, k.shape[0]),
                                           L.nb_logpmf)
        assert e_max < MAX_REL and r_max < MAX_REL and r_med <= MEDIAN_REL, (
            si, e_max, r_max, r_med)


@pytest.mark.parametrize("si", [1e-2, 0.1, 1.0])
def test_gradients_match_jax_at_ordinary_dispersion(si):
    k, elog = _case(seed=4)
    r = _spread(si, k.shape[0])
    g_e, g_r = _grads(L.nb_logpmf, k, elog, r)
    j_e, j_r = jax.grad(
        lambda e, rr: j_nb_logpmf(jnp.asarray(k.numpy()), e,
                                  rr[:, None]).sum(),
        argnums=(0, 1))(jnp.asarray(elog.numpy()), jnp.asarray(r.numpy()))
    for got, want in ((g_e, j_e), (g_r, j_r)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < GRAD_RTOL, (si, err)


def test_vmap_over_chains_equals_a_loop():
    """Chain batches of the plain NUTS / SMC paths: `torch.func.vmap` of
    the gradient over 3 chains, bit for bit a loop of single chains."""
    k, elog = _case(seed=5)
    rng = np.random.default_rng(5)
    E = elog[None] + torch.as_tensor(rng.normal(0, 0.1, (3,) + tuple(
        elog.shape)).astype(np.float32))
    R = torch.as_tensor((1e-3 * np.exp(rng.normal(0, 1, (3, k.shape[0]))))
                        .astype(np.float32))

    def potential(e, r):
        return -_via_distribution(k, e, r[:, None]).sum()

    grad = torch.func.grad(potential, argnums=(0, 1))
    batched = torch.func.vmap(grad)(E, R)
    for c in range(3):
        single = grad(E[c], R[c])
        for b, s in zip(batched, single):
            assert torch.equal(b[c], s)


def _every_mode(k, E, R):
    """The element's first derivatives by autograd, `torch.func.vmap` of
    `grad` over the chains and the HVPs along every dispersion (`jvp` of
    `grad` under `vmap`), and its double backward, at chain batch (E, R)."""
    def potential(e, r):
        return -_via_distribution(k, e, r[:, None]).sum()

    grad = torch.func.grad(potential, argnums=(0, 1))
    g_r = lambda e, r: grad(e, r)[1]                          # noqa: E731
    e0, r0 = E[0].clone().requires_grad_(True), R[0].clone()
    r0.requires_grad_(True)
    first = torch.autograd.grad(potential(e0, r0), (e0, r0),
                                create_graph=True)
    second = torch.autograd.grad(first[1].sum(), (e0, r0))
    hvp = torch.func.vmap(lambda v: torch.func.jvp(
        lambda r: g_r(E[0], r), (R[0],), (v,))[1])(torch.eye(R.shape[1]))
    return (*first, *second, *torch.func.vmap(grad)(E, R), hvp)


def test_blocks_of_rows_give_the_same_bits(monkeypatch):
    """`NBLogPmf` forms its derivatives over blocks of BLOCK_ELEMENTS
    elements of rows (genes), so that its float64 intermediates live for
    one block: with blocks of 3 rows (the last one short) every derivative
    in every mode equals the one-block result, bit for bit."""
    k, elog = _case(seed=10, Ng=11, Nc=40)
    rng = np.random.default_rng(10)
    E = elog[None] + torch.as_tensor(rng.normal(0, 0.1, (2,) + tuple(
        elog.shape)).astype(np.float32))
    R = torch.as_tensor((3e-3 * np.exp(rng.normal(0, 2, (2, 11))))
                        .astype(np.float32))
    whole = _every_mode(k, E, R)
    monkeypatch.setattr(L, "BLOCK_ELEMENTS", 3 * 40)
    assert len(L._row_blocks((11, 40), k)) == 4
    for b, w in zip(_every_mode(k, E, R), whole):
        assert torch.equal(b, w)


@pytest.mark.parametrize("int16", [True, False], ids=["int16", "f32"])
def test_gradcheck_and_gradgradcheck_in_float64(int16):
    """In log r (finite differences relative to r), over a spread of
    dispersions from the excess form's domain into the ratio form's; the
    large count at 60, where the float64 value's finite differences are
    still exact to the tolerance."""
    k, elog = _case(seed=6, Ng=6, Nc=8, int16=int16)
    k[:, 3] = 60
    e = elog.double().requires_grad_(True)
    u = torch.log(torch.as_tensor([1e-4, 1e-3, 0.01, 0.05, 0.5, 20.0],
                                  dtype=torch.float64)).requires_grad_(True)

    def f(e, u):
        return L.nb_logpmf(k, e, torch.exp(u)[:, None])

    assert torch.autograd.gradcheck(f, (e, u), atol=1e-6, rtol=1e-5)
    assert torch.autograd.gradgradcheck(f, (e, u), atol=1e-6, rtol=1e-5)


def test_second_derivatives_stay_finite_off_each_form():
    """`torch.where` evaluates both forms: under double and forward AD an
    inf in the form not taken would poison the result.  Dispersions from
    1e-12 to 1e3 beside counts up to 1e6."""
    rng = np.random.default_rng(7)
    k = torch.as_tensor(np.array([0, 1, 2, 7, 3e4, 1e6], np.float32))[None]
    k = k.expand(16, -1)
    elog = torch.as_tensor(rng.normal(1, 2, (16, 6)).astype(np.float32))
    r0 = torch.logspace(-12, 3, 16)

    def potential(r):
        return -L.nb_logpmf(k, elog, r[:, None]).sum()

    grad = torch.func.grad(potential)
    hd = torch.func.vmap(lambda v: torch.func.jvp(grad, (r0,), (v,))[1])(
        torch.eye(16))
    assert torch.isfinite(grad(r0)).all() and torch.isfinite(hd).all()
    rr = r0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(potential(rr), rr, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), rr)
    assert torch.isfinite(h).all()


# -- the rounded y = a + 2 (csrc/nb_common.cuh y_shift) ----------------------

def _window_errors(n, per_window, Nc, seed):
    """Each gene's |sum error| / |sum gradient| of the dispersion gradient
    and of the log-pmf against float64 (`nb_noise.gene_errors`), for the
    kernels' plain element and the element before the y repair, over
    ``per_window`` genes whose y = a + 2 rounds and as many whose y is
    exact, a in window n ([2^n - 2, 2^n); n = 1: a < 2).  Returns {name:
    (shifted genes' errors, exact genes' errors)}."""
    a = np.concatenate([nb_noise.window_a([n], per_window, s, seed)[0]
                        for s in (True, False)])
    k, elog, r = nb_noise.gene_rows(a, Nc, seed=seed)
    g, lp = nb_noise.gene_errors(k, elog, r)
    g_par, lp_par = nb_noise.gene_errors(k, elog, r, nb_noise.parent_element)
    assert np.array_equal(lp, lp_par)
    halves = lambda e: (e[:per_window], e[per_window:])      # noqa: E731
    return {"grad": halves(g), "parent grad": halves(g_par),
            "loss": halves(lp)}


def test_window_a_draws_the_rounded_and_the_exact_y():
    """`nb_noise.window_a` keeps the a whose y = a + 2 rounds (or not) as
    `ops.special.y_shift` says, every a inside its window and unchanged by
    1 / (1 / a); y_shift is y - a - 2 exactly (float64 arithmetic on the
    float32 values), 0 exactly where y is exact.  From n = 14 on no
    float32 r gives a shifted a = 1/r: it raises."""
    from velocycle_tpu_torch.ops.special import y_shift

    for shifted in (True, False):
        windows = range(1, 14 if shifted else 17)
        a = nb_noise.window_a(windows, 8, shifted, seed=3)
        for n, row in zip(windows, a):
            lo = 0.05 if n == 1 else 2.0 ** n - 2.0
            assert ((row >= lo) & (row < 2.0 ** n)).all(), (n, row)
        a = torch.as_tensor(a.ravel())
        assert torch.equal(1.0 / (1.0 / a), a)
        y = a + 2.0
        delta = y_shift(a, y)
        assert ((delta != 0.0) == shifted).all()
        assert torch.equal(delta.double(), y.double() - a.double() - 2.0)
    for n in (14, 15, 16):
        with pytest.raises(ValueError):
            nb_noise.window_a([n], 1, True)


@pytest.mark.parametrize("n", range(7, 14))
def test_excess_form_at_a_rounded_y_against_float64(n):
    """The excess form (a >= EXCESS_FROM), a in [2^n - 2, 2^n) with y = a +
    2 rounded in float32 (delta from -7.6e-6 at n = 7 to -4.9e-4 at n =
    13): the dispersion gradient of each of 4 genes of 20,000 cells within
    MAX_REL of float64.  The element before the y repair misses MAX_REL on
    every one of them (its error grows as delta: 2.6e-6 at n = 7, 1.6e-4
    at n = 13)."""
    a = nb_noise.window_a([n], 4, True, seed=n)[0]
    k, elog, r = nb_noise.gene_rows(a, 20_000, seed=n)
    g = nb_noise.gene_errors(k, elog, r)[0]
    g_par = nb_noise.gene_errors(k, elog, r, nb_noise.parent_element)[0]
    assert g.max() < MAX_REL, (a, g)
    assert g_par.min() > MAX_REL, (a, g_par)


RATIO_BITES = (3, 4, 5, 6)   # windows where the parent's shift shows


@pytest.mark.parametrize("n", range(1, 7), ids=[
    "a_below_2", "n2", "n3", "n4", "n5", "n6"])
def test_ratio_form_at_a_rounded_y_against_float64(n):
    """The ratio form (a < EXCESS_FROM), window n: over 1,000 genes whose y
    = a + 2 rounds and 1,000 whose y is exact, 2,000 cells each, the
    shifted genes' median dispersion-gradient error against float64 at
    most 1.5x the exact-y genes'.  From n = 3 on (y >= 8) the element
    before the y repair misses that gate (1.6x .. 2.4x measured).  Below,
    its shift is under the element's own rounding and it passes too: at
    a < 2 the shift, <= 1.2e-7 x |1/ka - 1/y|, rounds away in the digamma
    ratio (medians equal), and in [2, 4) the rounding of a + 1 (1/(a + 1),
    the same genes for a in [3, 4)) weighs as much (1.2-1.4x both)."""
    res = _window_errors(n, 1000, 2000, seed=n)
    sh, ex = res["grad"]
    assert np.median(sh) <= 1.5 * np.median(ex), (np.median(sh),
                                                   np.median(ex))
    p_sh, p_ex = res["parent grad"]
    if n in RATIO_BITES:
        assert np.median(p_sh) > 1.5 * np.median(p_ex), (
            np.median(p_sh), np.median(p_ex))
    else:
        assert np.median(p_sh) <= 1.5 * np.median(p_ex)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 7, 10, 13])
def test_lgamma_ratio_at_a_rounded_y_against_float64(n):
    """The log-pmf (the lgamma ratio's Stirling difference stays at the
    rounded y, as before): over 200 genes whose y rounds and 200 whose y is
    exact, 2,000 cells each, the shifted genes' median loss error against
    float64 at most 1.5x the exact-y genes' (the ratio form's gate), and
    every gene's within 1e-6; bit for bit the element's before the y
    repair (`_window_errors`)."""
    sh, ex = _window_errors(n, 200, 2000, seed=100 + n)["loss"]
    assert np.median(sh) <= 1.5 * np.median(ex), (np.median(sh),
                                                   np.median(ex))
    assert max(sh.max(), ex.max()) < 1e-6


@pytest.mark.parametrize("skip_k", [True, False], ids=["skip_k", "with_k"])
def test_y_repair_moves_only_the_dispersion_gradient(skip_k):
    """Against the element before the y repair, on genes from the windows
    n = 1..16 (y rounded: 1..13; exact) over counts 0..60 and log-means across
    both signs of log b: the log-pmf (also the loss-only element's,
    `_nb_lp`) and d lp/d elog bit for bit everywhere, d lp/d r bit for bit
    wherever delta = 0 or k < 2, and not where both forms take the
    shift."""
    from velocycle_tpu_torch.ops import nb_kernels as TK
    from velocycle_tpu_torch.ops.special import y_shift

    a = np.concatenate([nb_noise.window_a(range(1, 14 if s else 17), 3, s,
                                          seed=5).ravel()
                        for s in (True, False)])
    r = torch.as_tensor(1.0 / a)
    a_t = 1.0 / r[:, None]
    k = torch.arange(0.0, 61.0)[None, :].expand(len(a), -1)
    elog = torch.linspace(-3.0, 9.0, 61)[None, :] + torch.log(a_t)
    log_r = torch.log(r)[:, None]
    lp, g_e, g_r = TK._nb_lp_and_grads(k, a_t, log_r, elog, skip_k)
    p_lp, p_e, p_r = nb_noise.parent_element(k, a_t, log_r, elog, skip_k)
    assert torch.equal(lp, p_lp) and torch.equal(g_e, p_e)
    assert torch.equal(TK._nb_lp(k, elog, a_t, log_r, skip_k), p_lp)
    same = (y_shift(a_t, a_t + 2.0) == 0.0) | (k < 2.0)
    assert torch.equal(g_r[same], p_r[same])
    assert not torch.equal(g_r[~same], p_r[~same])


# -- the NUTS warm start's curvature ------------------------------------------

@pytest.mark.parametrize("si", SHAPE_INVS)
def test_warm_start_hessian_diagonal_against_float64(si):
    """The NUTS warm start's probes (`torch.func.jvp` of `grad` under
    `vmap`, `tools.nb_noise.fixed_point_curvature`) on the plain path at
    [mcmc] (b)'s data, at fixed values with every gene's shape_inv spread
    1.8x around ``si``: the Hessian diagonal in shape_inv against float64
    double backward of the direct form, median over the genes within
    HDIAG_REL, every entry finite; the direct form's own (the element
    before NBLogPmf) misses that gate from 1e-4 down."""
    hd, ref = nb_noise.fixed_point_curvature("cpu", si)
    assert np.isfinite(hd).all()
    rel = np.abs(hd - ref) / np.abs(ref)
    assert np.median(rel) <= HDIAG_REL, (np.median(rel), rel.max())
    if si <= 1e-4:
        with nb_noise.direct_element():
            hd, _ = nb_noise.fixed_point_curvature("cpu", si)
        assert np.median(np.abs(hd - ref) / np.abs(ref)) > HDIAG_REL


def test_warm_start_curvature_tool_probes_the_warm_starts_point():
    """`tools.nb_noise.warm_start_curvature` (printed by chip_smoke.py
    --plain (c)): at the warm start's point the probes' diagonal agrees
    with float64's, and where the warm start's preconditioner did not
    clamp it, 1 / that preconditioner is the same diagonal."""
    hd, ref, init = nb_noise.warm_start_curvature("cpu", svi_steps=50)
    assert np.isfinite(hd).all()
    assert np.median(np.abs(hd - ref) / np.abs(ref)) <= HDIAG_REL
    mp = nb_noise._data(False, "cpu")
    fm = TF.MCMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                         svi_steps=50)
    _, pre = fm._warm_start(0)
    free = pre["shape_inv"] < 1.0
    assert free.any()
    np.testing.assert_allclose(1.0 / pre["shape_inv"][free], hd[free],
                               rtol=1e-5)


def test_excess_y_shift_tool():
    """`tools.nb_noise.excess_y_shift`: y = a + 2 rounds in float32 where
    a + 2 reaches the next power of two with a's last bit set; the kernels'
    plain element is within MAX_REL of float64 at every a, and the element
    before the y repair (`nb_noise.parent_element`) misses MAX_REL where y
    rounds."""
    res = nb_noise.excess_y_shift("cpu", (1000.0, 1022.6, 254.3, 8191.5),
                                  Nc=20_000)
    assert [v[0] != 0.0 for v in res.values()] == [False, True, True, False]
    assert all(v[1] < MAX_REL for v in res.values()), res
    assert res[1022.6][2] > MAX_REL and res[254.3][2] > MAX_REL, res


def test_gene_grad_error_tool():
    """`tools.nb_noise.gene_grad_error` on the CPU: the fused likelihood
    runs its plain version there, so both agree bit for bit, and all three
    lie within 1e-6 of float64 on (b)'s data."""
    d = nb_noise._data(True, "cpu").data
    kern, twin, plain = nb_noise.gene_grad_error("cpu", d, 1e-3, 3)
    assert kern == twin and max(kern, plain) < 1e-6


def test_element_costs_tool():
    """tools/nb_noise.py's `element_costs` (printed by chip_smoke.py --plain
    (b)): the element saves one (Ng, Nc) tensor for its backward (elog)
    against the direct form's many, and its backward moves fewer bytes;
    `direct_element` restores the models' NegativeBinomial."""
    nb = tdist.NegativeBinomial
    costs = nb_noise.element_costs("cpu")
    assert tdist.NegativeBinomial is nb
    assert costs["NBLogPmf"][0] == 1 < costs["direct"][0]
    assert costs["NBLogPmf"][4] < costs["direct"][4]


def test_elog_gradient_alone_with_the_dispersion_conditioned():
    """With r taking no gradient (shape_inv conditioned, as in the velocity
    stage after the phase stage) the element computes no dispersion
    gradient; its elog gradient is the one it gives beside it, bit for
    bit, and so is the jvp along elog alone."""
    k, elog = _case(seed=9)
    r = _spread(1e-3, k.shape[0])[:, None]
    e1 = elog.clone().requires_grad_(True)
    (alone,) = torch.autograd.grad(L.nb_logpmf(k, e1, r).sum(), e1)
    both, _ = _grads(L.nb_logpmf, k, elog, r[:, 0])
    assert torch.equal(alone, both)
    v = torch.ones_like(elog)
    _, t_alone = torch.func.jvp(lambda e: L.nb_logpmf(k, e, r), (elog,),
                                (v,))
    _, t_both = torch.func.jvp(lambda e, rr: L.nb_logpmf(k, e, rr),
                               (elog, r), (v, torch.zeros_like(r)))
    assert torch.equal(t_alone, t_both)


def test_nb_noise_tool_names_its_functions():
    assert all(hasattr(nb_noise, name) for name in nb_noise.__all__)
