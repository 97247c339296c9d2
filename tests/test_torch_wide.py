"""The wide-basis route of the fused NB likelihoods, port against the JAX
package, on the same numpy inputs.

Past 16 basis columns (Nh, plus one column per delta_nu batch where the
narrow kernels do not take the batches as such) the port's kernels run on
the wide body (csrc/wide_kernel.cuh through csrc/nb_wide.cu), whose plain
versions, the wide twins (`phase_fwdgrad_wide_plain`,
`velo_fwdgrad_wide_plain`, ...), are held here against the JAX package's
fused Pallas kernels in interpret mode: the loss and every gradient, both
stages, at Nh 21 alone, Nh 5 with 16 batches, Nh 11 with 6, past both
stages' shared-memory fit at Nh 257 alone and Nh 5 with 252 batches, and
over a chain axis of K = 3.  On the CPU `nb_loglik_fused` and `nbsu_loglik_fused`
take the plain pair at those shapes, which agrees with the twins, and the
fused ELBO of each model matches the JAX package's fused ELBO at a spline basis of n_basis 20 and
at a Fourier basis of H 2 with 16 batches.  The kernels themselves are
held against the twins on the card (tests/test_torch_gpu.py,
chip_smoke.py [wide]).  Also the last public names: `ops.fourier.basis`,
`ops.special.softplus` and `softplus_sigmoid`.

Tolerances: the kernels' gates (tests/test_nb_kernels.py): loss rel 1e-5,
gradients max|a-b|/max|a| 1e-4 for the phase pair and 5e-4 for the
velocity pair; the ELBOs rel 5e-4 (tests/test_fused_models.py:48).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import velocycle_tpu as V
from velocycle_tpu.models import phase as jphase
from velocycle_tpu.models import velocity as jvel
from velocycle_tpu.ops import fourier as jfourier
from velocycle_tpu.ops import nb_kernels as JK
from velocycle_tpu.ops import special as jspecial
import velocycle_tpu_torch as T
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.models import phase as tphase
from velocycle_tpu_torch.models import velocity as tvel
from velocycle_tpu_torch.ops import fourier as tfourier
from velocycle_tpu_torch.ops import nb_kernels as TK
from velocycle_tpu_torch.ops import special as tspecial

from _torch_parity import (
    VELO_GRAD_RTOL, assert_elbo_and_grads_close, elbo_and_grads,
)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# (Nh, Nb): the basis alone past 16 columns, the Fourier basis with 16
# batches (21 columns), the default spline's 11 columns with 6 batches, and
# 257 columns (a spline basis, and a multi-donor atlas's 252 batches), past
# both stages' shared-memory fit on the card
SHAPES = [(21, 0), (5, 16), (11, 6), (257, 0), (5, 252)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-9))


def _inputs(stage, Ng, Nc, Nh, Nb, seed):
    """numpy inputs of the stage's kernels, in their call order: (S, nu,
    zeta, cf, r[, dnu, Db]) or (S, U, nu, zeta, zeta_dphi, cf, omega,
    log_beta, log_gamma, r[, dnu, Db])."""
    rng = np.random.default_rng(seed)
    f = lambda *a: a[0](*a[1:]).astype(np.float32)  # noqa: E731
    S = rng.poisson(3, (Ng, Nc)).astype(np.float32)
    nu = f(rng.normal, 0.3, 0.3, (Ng, Nh))
    zeta = f(rng.normal, 0, 0.4, (Nc, Nh))
    cf = f(rng.normal, 0, 0.2, Nc)
    r = (np.abs(rng.normal(0.5, 0.2, Ng)) + 0.05).astype(np.float32)
    extra = []
    if Nb:
        groups = rng.integers(0, Nb, Nc)
        extra = [f(rng.normal, 0, 0.1, (Nb, Ng)),
                 (np.arange(Nb)[:, None] == groups[None, :]).astype(np.float32)]
    if stage == "phase":
        return [S, nu, zeta, cf, r, *extra]
    U = rng.poisson(1.5, (Ng, Nc)).astype(np.float32)
    zdphi = f(rng.normal, 0, 0.4, (Nc, Nh))
    omega = np.exp(rng.normal(-1, 0.2, Nc)).astype(np.float32)
    lbeta = f(rng.normal, 0, 0.2, Ng)
    lgamma = f(rng.normal, 0, 0.2, Ng)
    return [S, U, nu, zeta, zdphi, cf, omega, lbeta, lgamma, r, *extra]


def _jax_fused(stage, args):
    """The JAX package's fused kernel (interpret-mode Pallas on the CPU):
    loss and the gradient of every parameter (not the counts, not Db)."""
    n_data = 1 if stage == "phase" else 2
    fn = JK.nb_loglik_fused if stage == "phase" else JK.nbsu_loglik_fused
    n_params = len(args) - n_data - (1 if len(args) in (7, 12) else 0)
    jargs = [jnp.asarray(a) for a in args]
    loss, grads = jax.value_and_grad(
        lambda *p: fn(*jargs[:n_data], *p, *jargs[n_data + n_params:]),
        argnums=tuple(range(n_params)),
    )(*jargs[n_data:n_data + n_params])
    return float(loss), [np.asarray(g) for g in grads]


def _twin(stage, args, chains=False):
    """The wide twin's loss and gradients, in the parameters' call order
    (the JAX kernel's argument order)."""
    t = [torch.as_tensor(a) for a in args]
    if stage == "phase":
        fn = TK.phase_fwdgrad_wide_plain   # takes the chain axis itself
        if len(t) == 5:
            t += [None, None]
        loss, (dnu, dzeta, dcf, ddisp, ddnu) = fn(*t)
        grads = [dnu, dzeta, dcf, ddisp, ddnu]
    else:
        fn = (TK._velo_plain_chains(TK.velo_fwdgrad_wide_plain) if chains
              else TK.velo_fwdgrad_wide_plain)
        if len(t) == 10:
            t += [None, None]
        # (dnu, dzeta, dzdphi, dcf, domega, dlog_beta, dlog_gamma, ddisp,
        # ddelta_nu): the parameters' call order
        loss, grads = fn(*t)
    return loss, [g.numpy() for g in grads if g is not None]


def _assert_close(tl, tg, jl, jg, grad_rtol):
    assert abs(float(tl) - jl) / max(abs(jl), 1.0) < LOSS_RTOL, (float(tl), jl)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert _max_rel(a, b) < grad_rtol, (i, _max_rel(a, b))


@pytest.mark.parametrize("stage", ["phase", "velo"])
@pytest.mark.parametrize("Nh,Nb", SHAPES)
def test_wide_twin_matches_jax_fused_kernel(stage, Nh, Nb):
    """The wide twin against the JAX package's fused kernel in interpret
    mode, the loss and every gradient; these shapes run on the wide body on
    the card (`kernel_width` past 16 columns)."""
    max_nb = (TK.phase_layout() if stage == "phase" else TK.velo_layout()).max_nb
    width, fold = TK.kernel_width(Nh, Nb, max_nb)
    assert width == Nh + Nb > TK.NARROW_WIDTH and fold == (Nb > 0)
    args = _inputs(stage, 24, 60, Nh, Nb, seed=Nh + Nb)
    jl, jg = _jax_fused(stage, args)
    tl, tg = _twin(stage, args)
    _assert_close(tl, tg, jl, jg,
                  GRAD_RTOL if stage == "phase" else VELO_GRAD_RTOL)


@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_wide_twin_chain_axis_matches_jax(stage):
    """K = 3 parameter sets over shared counts and batches (nu and r
    batched, Nh 5 with 16 batches: 21 columns), each chain against the JAX
    fused kernel at its own parameters."""
    args = _inputs(stage, 20, 50, 5, 16, seed=11)
    rng = np.random.default_rng(12)
    i_nu, i_r = (1, 4) if stage == "phase" else (2, 9)
    batched = list(args)
    for i in (i_nu, i_r):
        batched[i] = np.stack([args[i] * (1.0 + 0.1 * k) for k in range(3)])
    batched[i_nu] = (batched[i_nu]
                     + rng.normal(0, 0.05, batched[i_nu].shape)).astype(np.float32)
    batched[i_r] = batched[i_r].astype(np.float32)
    tl, tg = _twin(stage, batched, chains=True)
    assert tl.shape == (3,)
    for k in range(3):
        one = list(args)
        one[i_nu], one[i_r] = batched[i_nu][k], batched[i_r][k]
        jl, jg = _jax_fused(stage, one)
        _assert_close(tl[k], [g[k] for g in tg], jl, jg,
                      GRAD_RTOL if stage == "phase" else VELO_GRAD_RTOL)


@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_fused_wrapper_on_the_cpu_matches_the_wide_twin(stage):
    """nb_loglik_fused / nbsu_loglik_fused on CPU tensors at a wide shape
    (the plain pair, delta_nu as such): the loss and the autograd gradients
    agree with the wide twin's (the batches folded into columns) within the
    kernels' gates."""
    args = [torch.as_tensor(a) for a in _inputs(stage, 16, 40, 5, 16, seed=5)]
    n_data = 1 if stage == "phase" else 2
    leaves = [t.clone().requires_grad_(True) for t in args[n_data:-1]]
    fused = TK.nb_loglik_fused if stage == "phase" else TK.nbsu_loglik_fused
    loss = fused(*args[:n_data], *leaves, args[-1])
    loss.backward()
    twin = (TK.phase_fwdgrad_wide_plain if stage == "phase"
            else TK.velo_fwdgrad_wide_plain)
    want_loss, want = twin(*args)
    _assert_close(loss.detach(), [leaf.grad.numpy() for leaf in leaves],
                  float(want_loss), [g.numpy() for g in want],
                  GRAD_RTOL if stage == "phase" else VELO_GRAD_RTOL)


# ---------------------------------------------------------------------------
# the fused ELBO of each model against the JAX package's fused ELBO
# ---------------------------------------------------------------------------

NG, NC = 16, 64


def _adata(pkg, seed):
    rng = np.random.default_rng(seed)
    S = rng.poisson(4, (NC, NG)).astype(np.float32)
    U = rng.poisson(2, (NC, NG)).astype(np.float32)
    return pkg.AnnDataLite(
        X=S.copy(), layers={"spliced": S, "unspliced": U},
        obs=pd.DataFrame(index=[f"c{i}" for i in range(NC)]),
        var=pd.DataFrame(index=[f"g{i:03d}" for i in range(NG)]),
    )


def _wide_mp(pkg, stage, config):
    """The JAX package's (or the port's) metaparams of one stage on the
    fused path: ``config`` "spline20" (a spline basis of n_basis 20: 21
    columns) or "fourier_b16" (H 2 and 16 batches, delta_nu on: 21
    columns)."""
    adata = _adata(pkg, seed=3)
    genes, cells = list(adata.var.index), list(adata.obs.index)
    rng = np.random.default_rng(4)
    kw = dict(use_fused_nb=True, noisemodel="NegativeBinomial")
    if pkg is T:
        kw["device"] = "cpu"
    if config == "spline20":
        t = np.sort(rng.uniform(0, 1, NC))
        phases = pkg.Phases.from_angles(t, cell_names=cells)
        kw.update(basis_kind="spline", spline_domain=(0.0, 1.0),
                  with_delta_nu=False)
        n_coef = 21
        cycle = (pkg.Cycle.spline_prior(genes, n_basis=20, stds=1.0)
                 if stage == 1 else None)
    else:
        phases = pkg.Phases.from_angles(rng.uniform(0, 2 * np.pi, NC),
                                        cell_names=cells)
        design = (np.arange(NC)[:, None] % 16 == np.arange(16)[None, :]
                  ).astype(np.int64)
        kw.update(n_harmonics=2, with_delta_nu=True,
                  **{"design_mtx" if stage == 1 else "batch_design_mtx": design})
        n_coef = 5
        cycle = pkg.Cycle.trivial_prior(genes, harmonics=2) if stage == 1 else None
    if stage == 1:
        return pkg.preprocess_for_phase_estimation(adata, cycle, phases, **kw)
    cycle = pkg.Cycle.from_array(
        rng.normal(0, 0.3, (n_coef, NG)) + np.eye(n_coef, 1).repeat(NG, 1),
        np.full((n_coef, NG), 0.5), genes)
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                           stds=0.5)
    if config == "spline20":
        speed = pkg.AngularSpeed.from_array(
            np.full((1, 1), 0.3), np.full((1, 1), 0.5), condition_names=["c0"],
            num_coeffs=1)
    else:
        kw["omega_n_harmonics"] = 1
    return pkg.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, model_type="lrmn", **kw)


@pytest.mark.parametrize("config", ["spline20", "fourier_b16"])
@pytest.mark.parametrize("stage", [1, 2])
def test_fused_elbo_at_wide_bases_matches_jax_fused(stage, config):
    """At fixed params and guide draws built from the same numpy noise, the
    port's fused ELBO (the plain pair on the CPU; the wide body on the
    card) and every param gradient against the JAX package's fused ELBO
    (its Pallas kernels in interpret mode)."""
    jmp = _wide_mp(V, stage, config)
    jdata = jmp.data
    assert jdata.use_fused_nb
    Nh = jdata.mu_nu.shape[1]
    Nb = jdata.Db.shape[0] if jdata.with_delta_nu else 0
    assert TK.kernel_width(Nh, Nb, 4) == (21, Nb > 0)
    rng = np.random.default_rng(9)
    if stage == 1:
        tdata = phase_data_from_jax(jdata, device="cpu")
        eps = {"nu": rng.normal(size=jdata.mu_nu.shape)}
        if jdata.basis_kind == "fourier":
            eps["phi_xy"] = rng.normal(size=jdata.phixy_prior.shape)
        jl, jg, tl, tg = elbo_and_grads(
            jphase.phase_model, jphase.phase_guide, tphase.phase_model,
            tphase.phase_guide, jdata, tdata, eps)
        grad_rtol = 1e-4
    else:
        tdata = velocity_data_from_jax(jdata, device="cpu")
        Ng, Nx, Nhw = jdata.Ng, jdata.Nx, jdata.Nhw
        eps = {"nu": rng.normal(size=jdata.mu_nu.shape),
               "log_beta": rng.normal(size=Ng),
               "_lrmn_draw": (rng.normal(size=jdata.rho_rank),
                              rng.normal(size=Ng + Nx * Nhw))}
        if jdata.basis_kind == "fourier":
            eps["phi_xy"] = rng.normal(size=jdata.phixy_prior.shape)
        jguide = getattr(jvel, jmp.guide_fn.__name__)
        tguide = getattr(tvel, jmp.guide_fn.__name__)
        jl, jg, tl, tg = elbo_and_grads(
            jvel.velocity_model, jguide, tvel.velocity_model, tguide, jdata,
            tdata, eps)
        grad_rtol = VELO_GRAD_RTOL
    assert_elbo_and_grads_close(jl, jg, tl, tg, grad_rtol=grad_rtol)


# ---------------------------------------------------------------------------
# the width route
# ---------------------------------------------------------------------------

def _wide_smem(stage, W, chunked, s_bytes, u_bytes, lay):
    """One CTA's dynamic shared memory of the fwd+grad cut with W resident
    columns, as csrc/wide_kernel.cuh `smem_layout` counts it: the tile's
    basis rows and accumulators (a block each per basis), the factors (or
    pass A's chunk buffer, the larger), two slots of nu and the per-gene
    inputs, the gene columns (GeneCols, 14 floats; velocity two more), and
    the count windows."""
    G, T = lay.gene_chunk, lay.cells_per_tile
    PT = T + 4
    nb = 1 if stage == "phase" else 2
    cw = lay.phase_chunk_cols if stage == "phase" else lay.velo_chunk_cols
    fac = nb * G * PT
    if chunked:
        fac = max(fac, nb * cw * PT + G * cw)
    floats = 2 * nb * W * PT + fac + 2 * G * (W + (1 if stage == "phase" else 3))
    floats = -(-(floats + G * (14 + (0 if stage == "phase" else 2))) // 4) * 4
    windows = (T * s_bytes + 16) + ((T * u_bytes + 16) if u_bytes else 0)
    return floats * 4 + G * windows


def test_wide_layout_is_the_kernel_sources_one_definition():
    """wide_layout() reads csrc/wide_kernel.cuh, which the library reports
    back on the card.  A CTA's shared memory, as smem_layout counts it, fits
    the budget (and the card's 227 KB) with every column of 21 and 64
    resident in both stages (int16 counts); the widest resident chunk
    leaves room for at least one column quad whatever the count types, so
    no width is refused; and the fits (152 phase, 72 velocity columns at
    int16) are the ones the kernel source states."""
    import re

    from velocycle_tpu_torch.ops import cuda_build

    lay = TK.wide_layout()
    text = (cuda_build.CSRC / "wide_kernel.cuh").read_text()
    for name, value in zip(TK._WIDE_LAYOUT_NAMES, lay):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]
    assert "kMaxWidth" not in text
    assert lay.smem_budget <= 227 * 1024
    assert lay.threads == 256 and lay.gene_chunk == lay.threads // 32 * 4
    assert lay.cells_per_tile == 32 * 4
    assert lay.phase_chunk_cols % 4 == 0 and lay.velo_chunk_cols % 4 == 0
    fits = {}
    for stage, u in (("phase", 0), ("velo", 2)):
        for W in (24, 64):
            assert _wide_smem(stage, W, False, 2, u, lay) <= lay.smem_budget
        fits[stage] = max(W for W in range(4, 1024, 4)
                          if _wide_smem(stage, W, False, 2, u, lay)
                          <= lay.smem_budget)
        for sb in (2, 4):
            assert _wide_smem(stage, 4, True, sb, sb if u else 0,
                              lay) <= lay.smem_budget
    assert fits == {"phase": 152, "velo": 72}
    assert re.search(r"fit \(152 columns for the\s+//\s+phase pair, 72 for the "
                     r"velocity pair", text)


@pytest.mark.parametrize("Nh,Nb", [(257, 0), (200, 57), (5, 252)])
def test_kernel_width_names_the_wide_ceiling(Nh, Nb):
    """The wide body has no ceiling: 257 columns, past both stages'
    shared-memory fit, go to it at Nh + Nb, the batches folded in."""
    assert not hasattr(TK, "MAX_WIDTH")
    assert TK.kernel_width(Nh, Nb, 4) == (Nh + Nb, Nb > 0)


# ---------------------------------------------------------------------------
# the last public names
# ---------------------------------------------------------------------------

def test_softplus_and_softplus_sigmoid_match_jax():
    x = np.concatenate([np.linspace(-90, 90, 181),
                        [-1e-3, 0.0, 1e-3, 30.0, -30.0]]).astype(np.float32)
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(tspecial.softplus(tx).numpy(),
                               np.asarray(jspecial.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    tsp, tsig = tspecial.softplus_sigmoid(tx)
    jsp, jsig = jspecial.softplus_sigmoid(jnp.asarray(x))
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=1e-6, atol=1e-30)
    # gradients of a weighted sum of each output
    w = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    for tf, jf in ((lambda v: tspecial.softplus(v),
                    lambda v: jspecial.softplus(v)),
                   (lambda v: tspecial.softplus_sigmoid(v)[0],
                    lambda v: jspecial.softplus_sigmoid(v)[0]),
                   (lambda v: tspecial.softplus_sigmoid(v)[1],
                    lambda v: jspecial.softplus_sigmoid(v)[1])):
        tv = tx.clone().requires_grad_(True)
        (tf(tv) * torch.as_tensor(w)).sum().backward()
        jgrad = jax.grad(lambda v: (jf(v) * jnp.asarray(w)).sum())(jnp.asarray(x))
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-7)
    assert {"softplus", "softplus_sigmoid"} <= set(tspecial.__all__)


@pytest.mark.parametrize("kind,kw", [
    ("fourier", {"num_harmonics": 3}),
    ("spline", {"n_basis": 8, "domain": (0.0, 2.0)}),
])
@pytest.mark.parametrize("der", [0, 1])
def test_basis_dispatcher_matches_jax(kind, kw, der):
    x = np.linspace(0.01, 1.99, 37).astype(np.float32)
    got = tfourier.basis(torch.as_tensor(x), der=der, kind=kind, **kw)
    want = np.asarray(jfourier.basis(jnp.asarray(x), der=der, kind=kind, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    tv = torch.as_tensor(x).requires_grad_(True)
    (tfourier.basis(tv, der=der, kind=kind, **kw) * torch.as_tensor(w)).sum().backward()
    jgrad = jax.grad(lambda v: (jfourier.basis(v, der=der, kind=kind, **kw)
                                * jnp.asarray(w)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad),
                               atol=1e-4 * max(1.0, np.abs(np.asarray(jgrad)).max()))
    assert "basis" in tfourier.__all__


@pytest.mark.parametrize("pkg", [tfourier, jfourier], ids=["port", "jax"])
def test_basis_dispatcher_refusals(pkg):
    with pytest.raises(ValueError, match="num_harmonics needs to be provided"):
        pkg.basis(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="kind='wavelet' is not valid"):
        pkg.basis(np.zeros(3, np.float32), kind="wavelet")


def test_every_public_name_of_the_jax_package_is_ported():
    """Every name in an ``__all__`` of velocycle_tpu exists in the module of
    the same path in velocycle_tpu_torch."""
    import importlib
    import pkgutil

    missing = []
    for info in pkgutil.walk_packages(V.__path__, "velocycle_tpu."):
        if info.name.split(".")[-1].startswith("_"):
            continue
        mod = importlib.import_module(info.name)
        names = getattr(mod, "__all__", ())
        if not names:
            continue
        port = importlib.import_module(
            info.name.replace("velocycle_tpu", "velocycle_tpu_torch", 1))
        missing += [f"{port.__name__}.{n}" for n in names if not hasattr(port, n)]
    assert missing == []

