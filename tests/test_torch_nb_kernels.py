"""The port's fused phase NB likelihood (velocycle_tpu_torch/ops/nb_kernels.py)
against the JAX package, on the same numpy inputs.

On the CPU `nb_loglik_fused` runs its plain version (the kernels' per-element
arithmetic over the whole matrix); the JAX side is its plain
`nb_loglik_reference` + `jax.grad` in the fast lane, and interpret-mode
Pallas in one slow case.  Tolerances are the JAX suite's
(tests/test_nb_kernels.py): loss rel 1e-5, gradients max|a-b|/max|a| 1e-4.
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

NAMES = ("nu", "zeta", "cf", "disp", "dnu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Ng=50, Nc=70, Nh=5, seed=0, Nb=0):
    """numpy (S, nu, zeta, cf, r[, dnu, Db]) as in tests/test_nb_kernels.py."""
    rng = np.random.default_rng(seed)
    out = [
        rng.poisson(3, (Ng, Nc)).astype(np.float32),
        rng.normal(0.5, 0.5, (Ng, Nh)).astype(np.float32),
        rng.normal(0, 0.7, (Nc, Nh)).astype(np.float32),
        rng.normal(0, 0.2, Nc).astype(np.float32),
        (np.abs(rng.normal(0.5, 0.2, Ng)) + 0.05).astype(np.float32),
    ]
    if Nb:
        groups = rng.integers(0, Nb, Nc)
        out += [rng.normal(0, 0.1, (Nb, Ng)).astype(np.float32),
                (np.arange(Nb)[:, None] == groups[None, :]).astype(np.float32)]
    return out


def _torch_value_and_grads(args, lgk=None, disp_grad=True, scale=1.0):
    S = torch.as_tensor(args[0])
    leaves = [torch.tensor(a, requires_grad=True) for a in args[1:5]]
    extra = [torch.tensor(args[5], requires_grad=True),
             torch.as_tensor(args[6])] if len(args) > 5 else [None, None]
    loss = TK.nb_loglik_fused(S, *leaves, *extra, lgamma_k_sum=lgk,
                              disp_grad=disp_grad)
    (scale * loss).backward()
    grads = [t.grad.numpy() for t in leaves]
    if extra[0] is not None:
        grads.append(extra[0].grad.numpy())
    return float(loss.detach()), grads


def _jax_value_and_grads(args):
    argnums = tuple(range(1, len(args) - (1 if len(args) > 5 else 0)))
    jargs = [jnp.asarray(a) for a in args]
    val, grads = jax.value_and_grad(JK.nb_loglik_reference, argnums=argnums)(*jargs)
    return float(val), [np.asarray(g) for g in grads]


def _max_rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("Ng,Nc,Nb", [
    (50, 70, 0), (1, 1, 0), (129, 257, 0), (3, 300, 0), (60, 90, 2),
])
def test_fused_loss_and_grads_match_jax(Ng, Nc, Nb):
    args = _inputs(Ng=Ng, Nc=Nc, seed=Ng + Nc, Nb=Nb)
    tl, tg = _torch_value_and_grads(args)
    jl, jg = _jax_value_and_grads(args)
    assert abs(tl - jl) / max(abs(jl), 1.0) < 1e-5
    for name, a, b in zip(NAMES, tg, jg):
        assert _max_rel(a, b) < 1e-4, (name, _max_rel(a, b))


def test_reference_matches_jax_reference():
    for Nb in (0, 2):
        args = _inputs(Ng=40, Nc=90, seed=3, Nb=Nb)
        t = float(TK.nb_loglik_reference(*[torch.as_tensor(a) for a in args]))
        j = float(JK.nb_loglik_reference(*[jnp.asarray(a) for a in args]))
        assert abs(t - j) / abs(j) < 1e-6


def test_tile_math_twin_matches_jax_elementwise():
    """_nb_lp and _nb_lp_and_grads, elementwise, against the JAX functions
    the Pallas kernels run (same formulas: f32 agreement at 1e-5)."""
    S, nu, zeta, cf, r = _inputs(Ng=30, Nc=200, seed=5)
    elog = (nu @ zeta.T + cf[None, :]).astype(np.float32)
    a = (1.0 / r[:, None]).astype(np.float32)
    log_r = np.log(r)[:, None].astype(np.float32)
    for skip in (False, True):
        for want_r in (True, False):
            got = TK._nb_lp_and_grads(torch.as_tensor(S), torch.as_tensor(a),
                                      torch.as_tensor(log_r),
                                      torch.as_tensor(elog), skip, want_r)
            want = JK._nb_lp_and_grads(jnp.asarray(S), jnp.asarray(a),
                                       jnp.asarray(log_r), jnp.asarray(elog),
                                       skip, want_r)
            lp, g_elog, g_r = got
            for g, w in zip((lp, g_elog), want[:2]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)
            if want[2] is None:
                assert g_r is None
            else:
                # d lp/d r scales f32 rounding by a^2 = 1/r^2 (up to 311
                # here): held as the gradients are, max|a-b|/max|a|
                assert _max_rel(g_r.numpy(), np.asarray(want[2])) < 1e-4
        got = TK._nb_lp(torch.as_tensor(S), torch.as_tensor(elog),
                        torch.as_tensor(a), torch.as_tensor(log_r), skip)
        want = JK._nb_lp(jnp.asarray(S), jnp.asarray(elog), jnp.asarray(a),
                         jnp.asarray(log_r), skip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# the small-dispersion grid: shape_inv in [1e-6, 1e-1] (51 values, log
# spaced: 1e-6, 1e-5 and 1e-3 among them), counts 0..200, log-means
# -2..5.5 (7 values)
SMALL_R = np.logspace(-6, -1, 51)


def _small_r_grid():
    r = SMALL_R
    R, Kc, E = np.meshgrid(r, np.arange(201), np.linspace(-2, 5.5, 7),
                           indexing="ij")
    return R.astype(np.float32), Kc.astype(np.float32), E.astype(np.float32)


def _nb_element_f64(r, k, elog):
    """(lp, d lp/d elog, d lp/d r) in float64 at the float32 inputs, the
    lgamma and digamma ratios as exact sums over the count."""
    a = 1.0 / r.astype(np.float64)
    mu = np.exp(elog.astype(np.float64))
    k = k.astype(np.float64)
    lgr = np.zeros(r.shape)
    dgr = np.zeros(r.shape)
    for j in range(int(k.max())):
        lgr += np.where(k > j, np.log(a + j), 0.0)
        dgr += np.where(k > j, 1.0 / (a + j), 0.0)
    log_sig = -np.log1p(mu / a)                    # log(a / (a + mu))
    lp = lgr - sps.gammaln(k + 1) + a * log_sig + k * (np.log(mu) - np.log(a + mu))
    g_elog = a * (k - mu) / (a + mu)
    g_r = -a * a * (dgr + log_sig + (mu - k) / (a + mu))
    return lp, g_elog, g_r


def _element_error(name, got, want):
    """lp: max abs error (nats); g_elog: max |err| / (|want| + 1); g_r: the
    largest over shape_inv of max|err| / max|want| over its (count,
    log-mean) points."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    if name == "g_elog":
        return float((err / (np.abs(want) + 1.0)).max())
    if name == "g_r":
        n = want.shape[0]
        return float((err.reshape(n, -1).max(1)
                      / np.abs(want).reshape(n, -1).max(1)).max())
    return float(err.max())


# the repaired twins' tolerances on the grid (measured: lp 5.3e-4, the
# O(k log a) float32 rounding of lgr and k * softplus at k = 200; g_elog
# 2.9e-5; g_r 1.7e-6, its three terms taken without cancellation, 3.6x
# below), each at least 10x below the JAX package's fused form's error on
# the same grid (measured: 0.157, 3.7e-3, 0.30)
SMALL_R_TOL = {"lp_fwd": 1e-3, "lp": 1e-3, "g_elog": 1e-4, "g_r": 6e-6}


@pytest.mark.parametrize("name", sorted(SMALL_R_TOL))
def test_repaired_element_matches_float64_at_small_dispersion(name):
    """The NB element of both kernel pairs (`_nb_lp`, `_nb_lp_and_grads`,
    the kernels' arithmetic in csrc/nb_common.cuh) against float64 over
    shape_inv in [1e-5, 1e-1] and counts 0-200: within SMALL_R_TOL, and
    at least 10x closer than the JAX package's fused form
    (`velocycle_tpu/ops/nb_kernels.py`, whose ``a * log_b - (a + k) *
    softplus(log_b)`` cancels where a = 1/r is large) on the same grid."""
    R, Kc, E = _small_r_grid()
    a = (1.0 / R).astype(np.float32)
    log_r = np.log(R).astype(np.float32)
    want = dict(zip(("lp", "g_elog", "g_r"), _nb_element_f64(R, Kc, E)))
    want["lp_fwd"] = want["lp"]
    t = [torch.as_tensor(x) for x in (Kc, a, log_r, E)]
    j = [jnp.asarray(x) for x in (Kc, a, log_r, E)]
    if name == "lp_fwd":
        got = TK._nb_lp(t[0], t[3], t[1], t[2])
        jax_got = JK._nb_lp(j[0], j[3], j[1], j[2])
    else:
        i = ("lp", "g_elog", "g_r").index(name)
        got = TK._nb_lp_and_grads(*t, False)[i]
        jax_got = JK._nb_lp_and_grads(*j, False)[i]
    port = _element_error(name, got, want[name])
    jax_err = _element_error(name, jax_got, want[name])
    assert port < SMALL_R_TOL[name], (name, port)
    assert jax_err >= 10 * SMALL_R_TOL[name], (name, jax_err)


def _g_r_error_by_shape_inv(got, want):
    """The dispersion gradient's error at each shape_inv of the grid:
    max|err| / max|want| over its (count, log-mean) points."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = want.shape[0]
    return (np.abs(got - want).reshape(n, -1).max(1)
            / np.abs(want).reshape(n, -1).max(1))


def test_dispersion_gradient_error_does_not_grow_with_a():
    """The dispersion gradient's float32 error against float64 stops
    growing with a = 1/r: at shape_inv 1e-5 and 1e-6 it is at most 2x its
    error at 1e-3 (k - a dgr, -(log sig + sig_c) and k sig_c each O(mu^2 /
    a), no term of size k or mu cancelling); the JAX package's fused form
    on the same grid grows past that bound, so the check can fail."""
    R, Kc, E = _small_r_grid()
    a = (1.0 / R).astype(np.float32)
    log_r = np.log(R).astype(np.float32)
    want = _nb_element_f64(R, Kc, E)[2]
    got = TK._nb_lp_and_grads(*[torch.as_tensor(x) for x in (Kc, a, log_r, E)],
                              False)[2]
    jax_got = JK._nb_lp_and_grads(*[jnp.asarray(x) for x in (Kc, a, log_r, E)],
                                  False)[2]
    at = {v: int(np.argmin(np.abs(SMALL_R - v))) for v in (1e-6, 1e-5, 1e-3)}
    err = _g_r_error_by_shape_inv(got, want)
    jax_err = _g_r_error_by_shape_inv(jax_got, want)
    for v in (1e-5, 1e-6):
        assert err[at[v]] <= 2.0 * err[at[1e-3]], (v, err[at[v]], err[at[1e-3]])
    assert jax_err[at[1e-5]] > 2.0 * jax_err[at[1e-3]]


@pytest.mark.parametrize("fn", ["log1p_excess", "log1m_excess"])
def test_series_excesses_match_float64(fn):
    """t - log1p(t) and -log1p(-s) - s, the two differences the repaired
    dispersion gradient takes by series below SERIES_BELOW, against float64
    over [0, 1/2]: relative error below 2e-6 (at most ~30 ulps where the
    direct difference takes over, 1e-7 in the series)."""
    from velocycle_tpu_torch.ops import special as tsp

    x = np.concatenate([np.logspace(-8, -1, 200), np.linspace(0.1, 0.5, 200)])
    x32 = torch.as_tensor(x.astype(np.float32))
    x64 = x32.double().numpy()
    if fn == "log1p_excess":
        got = tsp.log1p_excess(x32, torch.log1p(x32))
        want = x64 - np.log1p(x64)
        keep = slice(None)
    else:
        keep = x64 < tsp.SERIES_BELOW          # the caller selects
        got = tsp.log1m_excess(x32)
        want = -np.log1p(-x64) - x64
    rel = np.abs(got.double().numpy() - want) / want
    assert rel[keep].max() < 2e-6, rel[keep].max()


def test_digamma_excess_matches_float64():
    """k - a (digamma(k + a) - digamma(a)) = sum_{j<k} j / (a + j) from
    `lgamma_digamma_excess` against float64 over counts 0..300 and a in
    [1e-1, 1e7]: relative error below 1e-5 (the Stirling branch's
    truncation at small a sets it; at large a the terms no longer cancel,
    where a - a * digamma ratio in float32 would lose everything), and the
    ratios equal to `lgamma_digamma_ratio`'s and `lgamma_ratio2`'s."""
    from velocycle_tpu_torch.ops import special as tsp

    a = np.logspace(-1, 7, 60)
    A, Kc = np.meshgrid(a, np.arange(301), indexing="ij")
    A32 = A.astype(np.float32)
    k32 = Kc.astype(np.float32)
    lgr, dgr, kad = tsp.lgamma_digamma_excess(torch.as_tensor(k32),
                                              torch.as_tensor(A32))
    lgr2, dgr2 = tsp.lgamma_digamma_ratio(torch.as_tensor(k32), torch.as_tensor(A32))
    assert torch.equal(lgr, lgr2) and torch.equal(dgr, dgr2)
    assert torch.equal(lgr, tsp.lgamma_ratio2(torch.as_tensor(k32),
                                             torch.as_tensor(A32)))
    a64 = A32.astype(np.float64)
    want = np.zeros(A.shape)
    for j in range(1, 300):
        want += np.where(Kc > j, j / (a64 + j), 0.0)
    got = kad.double().numpy()
    assert np.abs(got[Kc < 2]).max() == 0.0
    rel = np.abs(got - want)[Kc >= 2] / want[Kc >= 2]
    assert rel.max() < 1e-5, rel.max()


def test_disp_grad_false_zero_dispersion_rest_unchanged():
    args = _inputs(Ng=40, Nc=200, seed=13)
    l_on, g_on = _torch_value_and_grads(args, disp_grad=True)
    l_off, g_off = _torch_value_and_grads(args, disp_grad=False)
    assert l_on == l_off
    for i in (0, 1, 2):
        np.testing.assert_array_equal(g_on[i], g_off[i])
    assert np.abs(g_on[3]).max() > 0
    assert np.abs(g_off[3]).max() == 0.0


def test_int16_counts_match_float32():
    args = _inputs(Ng=40, Nc=200, seed=11)
    l32, g32 = _torch_value_and_grads(args)
    l16, g16 = _torch_value_and_grads([args[0].astype(np.int16)] + args[1:])
    assert l32 == l16
    for a, b in zip(g32, g16):
        np.testing.assert_array_equal(a, b)


def test_lgamma_k_sum_shortcut_matches():
    args = _inputs(Ng=60, Nc=90)
    const = np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
    full, gfull = _torch_value_and_grads(args)
    short, gshort = _torch_value_and_grads(args, lgk=const)
    assert abs(full - short) / abs(full) < 1e-5
    for a, b in zip(gfull, gshort):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_output_scaling():
    args = _inputs(Ng=20, Nc=30)
    _, g1 = _torch_value_and_grads(args, scale=2.5)
    _, g0 = _torch_value_and_grads(args)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, 2.5 * b, rtol=1e-6)


def test_loss_only_path_without_grad():
    """No gradient needed -> the loss-only route (its softplus form differs
    from the fwd+grad route's log1p form by f32 rounding only)."""
    args = [torch.as_tensor(a) for a in _inputs(Ng=40, Nc=90, seed=2)]
    with torch.no_grad():
        l_fwd = float(TK.nb_loglik_fused(*args))
    l_grad, _ = TK.phase_fwdgrad_plain(*args, None, None)
    assert abs(l_fwd - float(l_grad)) / abs(l_fwd) < 1e-6


def test_kernel_wrappers_refuse_what_they_cannot_take():
    args = [torch.as_tensor(a) for a in _inputs(Ng=8, Nc=16, seed=1)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.phase_fwd(*args)
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.phase_fwdgrad(*args)
    with pytest.raises(ValueError, match="shape"):
        TK.nb_loglik_fused(args[0], args[1][:4], *args[2:])
    with pytest.raises(ValueError, match="together"):
        TK.nb_loglik_fused(*args, delta_nu=torch.zeros(1, 8))


def test_phase_layout_is_the_kernel_sources_one_definition():
    """phase_layout() reads csrc/phase_kernel.cuh, which the library
    reports back on the card: the tile is whole cells per thread and its
    rows are whole 16-byte pieces in both count types."""
    import re

    from velocycle_tpu_torch.ops import cuda_build

    lay = TK.phase_layout()
    text = (cuda_build.CSRC / "phase_kernel.cuh").read_text()
    for name, value in zip(("kThreads", "kCellsPerTile", "kGeneChunk",
                            "kStages", "kMaxNb"), lay):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]
    assert lay.cells_per_tile % lay.threads == 0 and lay.threads % 32 == 0
    assert lay.cells_per_tile * 2 % 16 == 0
    assert lay.stages >= 2 and lay.gene_chunk >= 1 and lay.max_nb >= 2
    assert TK.PHASE_MODES[:2] == ("fwd", "fwdgrad")


def test_velo_layout_is_the_kernel_sources_one_definition():
    """velo_layout() reads csrc/velo_kernel.cuh, which the library reports
    back on the card: the tile is whole cells per thread and its rows are
    whole 16-byte pieces in both count types."""
    import re

    from velocycle_tpu_torch.ops import cuda_build

    lay = TK.velo_layout()
    text = (cuda_build.CSRC / "velo_kernel.cuh").read_text()
    for name, value in zip(("kThreads", "kCellsPerTile", "kGeneChunk",
                            "kStages", "kMaxNb"), lay):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]
    assert lay.cells_per_tile % lay.threads == 0 and lay.threads % 32 == 0
    assert lay.cells_per_tile * 2 % 16 == 0
    assert lay.stages >= 2 and lay.gene_chunk >= 1 and lay.max_nb >= 2
    assert TK.VELO_CUTS == ("fwd", "fwdgrad")


def test_kernel_widths_are_the_sources_instantiations():
    """KERNEL_WIDTHS and DNU_WIDTH are the widths `pick_nh` dispatches to in
    both narrow kernel sources and the delta_nu bound of
    csrc/nb_common.cuh; past NARROW_WIDTH, the widest of them, the wide
    body (csrc/nb_wide.cu) takes any runtime width."""
    import re

    from velocycle_tpu_torch.ops import cuda_build

    for src in ("nb_phase.cu", "nb_velo.cu"):
        text = (cuda_build.CSRC / src).read_text()
        cases = re.findall(r"case (\d+): return pick_(?:mode|cut)<", text)
        assert tuple(int(c) for c in cases) == TK.KERNEL_WIDTHS, src
    common = (cuda_build.CSRC / "nb_common.cuh").read_text()
    assert re.findall(r"constexpr int kMaxDnuWidth = (\d+);", common) == [
        str(TK.DNU_WIDTH)]
    assert TK.NARROW_WIDTH == max(TK.KERNEL_WIDTHS)
    wide = (cuda_build.CSRC / "wide_kernel.cuh").read_text()
    assert "kMaxWidth" not in wide
    assert "a.W > " not in (cuda_build.CSRC / "nb_wide.cu").read_text()
    for Nh, Nb in ((16, 0), (12, 4), (7, 4), (8, 8)):
        assert TK.kernel_width(Nh, Nb, 4)[0] in TK.KERNEL_WIDTHS
    for Nh, Nb in ((17, 0), (8, 9), (5, 12), (256, 0), (1000, 24)):
        assert TK.kernel_width(Nh, Nb, 4) == (Nh + Nb, Nb > 0)


def test_dispersion_gradient_takes_its_form_by_gene():
    """The element's two dispersion-gradient forms, chosen per gene at a =
    1/r = EXCESS_FROM (csrc/nb_common.cuh kExcessFrom; the series below
    SERIES_BELOW as kSeriesBelow): below it exactly -a^2 (dgr + log sig) +
    a g_elog, from it on exactly the excess form; the kernel's constants are
    the twin's."""
    import re

    from velocycle_tpu_torch.ops import cuda_build
    from velocycle_tpu_torch.ops import special as tsp

    common = (cuda_build.CSRC / "nb_common.cuh").read_text()
    assert [float(v) for v in re.findall(
        r"constexpr float kExcessFrom = ([0-9.]+)f;", common)] == [tsp.EXCESS_FROM]
    assert [float(v) for v in re.findall(
        r"constexpr float kSeriesBelow = ([0-9.]+)f;", common)] == [tsp.SERIES_BELOW]
    a = torch.tensor([1.5, 20.0, np.nextafter(np.float32(64.0), np.float32(0.0)),
                      64.0, 65.0, 1e4])[:, None]
    k = torch.arange(0.0, 40.0)[None, :]
    elog = torch.linspace(-2.0, 5.0, 40)[None, :]
    log_r = -torch.log(a)
    _, g_elog, g_r = TK._nb_lp_and_grads(k, a, log_r, elog, False)
    log_b = -log_r - elog
    _, log_sig, _, sig_c = tsp.softplus_log_sigmoid(log_b)
    _, dgr, kad = tsp.lgamma_digamma_excess(k, a)
    ratio = ((dgr + log_sig) * (-a) + g_elog) * a
    q = torch.where((log_b >= 0) & (sig_c < tsp.SERIES_BELOW),
                    tsp.log1m_excess(sig_c), -(log_sig + sig_c))
    excess = ((kad - k * sig_c) + a * q) * a
    assert torch.equal(g_r[:3], ratio[:3]) and torch.equal(g_r[3:], excess[3:])
    assert not torch.equal(ratio[3:], excess[3:])


@pytest.mark.parametrize("Nh,Nb,want", [
    (5, 0, (5, False)), (3, 4, (3, False)), (4, 0, (5, False)),
    (7, 4, (7, False)), (8, 0, (11, False)), (9, 2, (11, True)),
    (11, 0, (11, False)), (5, 5, (11, True)), (5, 6, (11, True)),
    (12, 0, (16, False)), (16, 0, (16, False)), (11, 5, (16, True)),
    # past 16 columns: the wide body at Nh + Nb, the batches folded in
    (5, 16, (21, True)), (20, 0, (20, False)), (5, 59, (64, True)),
    (250, 6, (256, True)),
])
def test_kernel_width_picks_the_next_instantiation(Nh, Nb, want):
    assert TK.kernel_width(Nh, Nb, 4) == want


@pytest.mark.parametrize("Nh,Nb", [(17, 0), (11, 6), (16, 1)])
def test_kernel_width_names_its_limit(Nh, Nb):
    """One column past the widest narrow instantiation goes to the wide
    body at Nh + Nb columns, the batches folded in; so does 257: the wide
    body takes any width."""
    assert TK.kernel_width(Nh, Nb, 4) == (Nh + Nb, Nb > 0)
    assert TK.kernel_width(257 - Nb, Nb, 4) == (257, Nb > 0)


WIDE = [(4, 0), (9, 0), (11, 0), (5, 5), (5, 6), (9, 2)]


def _widened_value_and_grads(args, want_disp=True):
    """Loss and gradients through the kernels' width route with the plain
    version in place of the kernel: widen, fwd+grad, narrow."""
    t = [torch.as_tensor(a) for a in args] + [None, None][:7 - len(args)]
    S, nu, zeta, cf, r, dnu, Db = t
    Nb = 0 if dnu is None else dnu.shape[0]
    width, fold = TK.kernel_width(nu.shape[1], Nb, TK.phase_layout().max_nb)
    assert width in TK.KERNEL_WIDTHS
    nu_w, (zeta_w,), dnu_w, Db_w = TK.widen_inputs(nu, [zeta], dnu, Db, width,
                                                   fold)
    assert nu_w.shape[1] == zeta_w.shape[1] == width
    assert (dnu_w is None) == (fold or Nb == 0)
    loss, g = TK.phase_fwdgrad_plain(S, nu_w, zeta_w, cf, r, dnu_w, Db_w,
                                     want_disp=want_disp)
    gnu, (gzeta,), gdnu = TK.narrow_grads(g[0], [g[1]], g[4], nu.shape[1], Nb,
                                          fold)
    return loss, (gnu, gzeta, g[2], g[3], gdnu)


@pytest.mark.parametrize("Nh,Nb", WIDE)
def test_widened_inputs_narrow_back_to_the_plain_result(Nh, Nb):
    """Zero columns add exact zeros and folded batches are basis columns:
    the plain fwd+grad of the widened inputs, narrowed back, is the plain
    fwd+grad of the originals (to f32 rounding of the reordered sums)."""
    args = _inputs(Ng=30, Nc=70, Nh=Nh, seed=Nh + Nb, Nb=Nb)
    t = [torch.as_tensor(a) for a in args] + [None, None][:7 - len(args)]
    for want_disp in (True, False):
        loss, grads = TK.phase_fwdgrad_plain(*t, want_disp=want_disp)
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
    args = _inputs(Ng=30, Nc=70, Nh=Nh, seed=Nh + Nb, Nb=Nb)
    jl, jg = _jax_value_and_grads(args)
    wl, wg = _widened_value_and_grads(args)
    wg = [g.numpy() for g in wg if g is not None]
    for tl, tg in (_torch_value_and_grads(args), (float(wl), wg)):
        assert abs(tl - jl) / max(abs(jl), 1.0) < 1e-5
        for name, a, b in zip(NAMES, tg, jg):
            assert _max_rel(a, b) < 5e-4, (name, _max_rel(a, b))


@pytest.mark.slow
def test_fused_matches_jax_interpret_mode_pallas():
    """Against the JAX package's fused kernel itself (interpret mode)."""
    for Nb in (0, 2):
        args = _inputs(Ng=60, Nc=90, seed=1, Nb=Nb)
        const = np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
        jargs = [jnp.asarray(a) for a in args]
        argnums = tuple(range(1, 6 if Nb else 5))
        jl, jg = jax.value_and_grad(
            lambda *a: JK.nb_loglik_fused(*a, lgamma_k_sum=const),
            argnums=argnums,
        )(*jargs)
        tl, tg = _torch_value_and_grads(args, lgk=const)
        assert abs(tl - float(jl)) / abs(float(jl)) < 1e-5
        for name, a, b in zip(NAMES, tg, jg):
            assert _max_rel(a, np.asarray(b)) < 1e-4, (name, Nb)
