"""The port's roofline ladder (velocycle_tpu_torch/ops/ladder_kernels.py and
velocycle_tpu_torch/tools/kernel_profile.py) against the JAX tool's own
Pallas kernels (tools/kernel_profile.py), on the same numpy inputs.

The JAX tool is loaded from its file and cut to 16 genes x 256 cells (gene
tiles of 8, cell tiles of 128); its kernels run in TPU interpret mode.  On
the CPU the port's rungs run as their plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_gpu.py, chip_smoke.py).
Tolerances are the JAX suite's (tests/test_nb_kernels.py): loss
|a-b|/max(|b|, 1) 1e-5, gradients max|a-b|/max|b| 1e-4.
"""
import functools
import importlib.util
import os
import sys

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from velocycle_tpu.ops import nb_kernels as JK
from velocycle_tpu_torch.ops import ladder_kernels as L
from velocycle_tpu_torch.ops import nb_kernels as TK
from velocycle_tpu_torch.tools import kernel_profile as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(Ng=16, Nc=256, TG=8, TC=128, N_G=2, N_C=2)
VARIANTS = {"v_full": (True, True), "v_nodig": (False, True),
            "v_nocell": (True, False)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jtool():
    """tools/kernel_profile.py as a module, cut to SMALL.  Its import sets
    two jax.config values and puts the repository on sys.path: both are
    undone at once."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_jax_kernel_profile", os.path.join(REPO, "tools", "kernel_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    for k, v in SMALL.items():
        setattr(mod, k, v)
    return mod


def _inputs(int16=False, seed=0, Ng=16, Nc=256):
    """numpy (S, nu, zeta, cf, r) from the distributions of
    tools/kernel_profile.py."""
    rng = np.random.default_rng(seed)
    S = np.floor(np.exp(rng.normal(size=(Ng, Nc)) * 0.8 + 1.0))
    nu = rng.normal(size=(Ng, 5)) * 0.5
    ang = rng.uniform(0, 6.28, Nc)
    zeta = np.stack([np.ones_like(ang), np.cos(ang), np.sin(ang),
                     np.cos(2 * ang), np.sin(2 * ang)], -1)
    cf = rng.normal(size=Nc) * 0.2
    r = np.exp(rng.normal(size=Ng) * 0.3)
    S = S.astype(np.int16 if int16 else np.float32)
    return [S] + [a.astype(np.float32) for a in (nu, zeta, cf, r)]


def _jax_vpu_only(m, nu, zeta, disp):
    """k_vpu_only through the pallas_call of run_vpu_only (:231-246), which
    itself returns a time."""
    in_specs = [
        pl.BlockSpec((m.TG, m.Nh), lambda i, j: (i, 0)),
        pl.BlockSpec((m.TC, m.Nh), lambda i, j: (j, 0)),
        pl.BlockSpec((m.TG, 1), lambda i, j: (i, 0)),
    ]
    return pl.pallas_call(
        m.k_vpu_only, grid=(m.Ng // m.TG, m.Nc // m.TC), in_specs=in_specs,
        out_specs=[pl.BlockSpec((1, 1), lambda i, j: (0, 0),
                                memory_space=pltpu.SMEM)],
        out_shape=[jax.ShapeDtypeStruct((1, 1), jnp.float32)],
    )(nu, zeta, disp)


def _jax_rung(m, rung, S, nu, zeta, cf, r):
    """(loss, {gradient: array}) of the JAX tool's kernel, with the Mosaic
    padding taken off and the per-tile partials summed over cell tiles."""
    disp = r.reshape(-1, 1)
    with pltpu.force_tpu_interpret_mode():
        if rung == "vpu_only":
            outs = _jax_vpu_only(m, nu, zeta, disp)
        elif rung in VARIANTS:
            want_dig, cell = VARIANTS[rung]
            kern = functools.partial(m._variant_kernel, want_dig, True, cell)
            outs = m._mk_variant(kern, True, cell)(S, nu, zeta,
                                                  cf.reshape(1, -1), disp)
        else:
            outs = m._mk(getattr(m, f"k_{rung}"), int(rung == "fwdgrad"))(
                S, nu, zeta, disp)
    outs = [np.asarray(o) for o in outs]
    grads = {}
    if rung == "fwdgrad":
        grads["dnu"] = outs[1]
    if rung in VARIANTS:
        grads["dnu"] = outs[1].reshape(m.N_C, m.Ng, m.Nh).sum(0)
        grads["ddisp"] = outs[2].reshape(m.N_C, m.Ng).sum(0)
        if VARIANTS[rung][1]:
            grads["dzeta"] = outs[3][:m.Nh].T
            grads["dcf"] = outs[4][0]
    return float(outs[0][0, 0]), grads


def _port_rung(rung, S, nu, zeta, cf, r, n_rep):
    """(loss, {gradient: array}) of the port's plain version, the per-tile
    partials summed over cell tiles."""
    args = (torch.as_tensor(a) for a in (S, nu, zeta, cf, r))
    loss, grads = L.run_rung(rung, *args, n_rep=n_rep, plain=True)
    if rung in VARIANTS:
        dnu_part, ddisp_part, dzeta, dcf = grads
        grads = {"dnu": dnu_part.sum(0), "ddisp": ddisp_part.sum(0),
                 "dzeta": dzeta, "dcf": dcf}
    else:
        grads = dict(zip(("dnu",), grads))
    return float(loss), {k: v.numpy() for k, v in grads.items() if v is not None}


def _max_rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "i16"])
@pytest.mark.parametrize("rung", L.RUNGS)
def test_rung_plain_matches_the_jax_tools_kernel(jtool, rung, int16):
    args = _inputs(int16=int16, seed=L.RUNGS.index(rung))
    jl, jg = _jax_rung(jtool, rung, *args)
    tl, tg = _port_rung(rung, *args, n_rep=jtool.N_C)
    assert abs(tl - jl) / max(abs(jl), 1.0) < 1e-5, (tl, jl)
    assert sorted(tg) == sorted(jg)
    for name in jg:
        assert _max_rel(tg[name], jg[name]) < 1e-4, (name, _max_rel(tg[name], jg[name]))


@pytest.mark.parametrize("Nc", [256, 1100])
def test_plain_v_full_is_phase_fwdgrad_plain(Nc):
    """V_FULL is phase_fwdgrad with cf, no delta_nu, lgamma(k+1) skipped and
    the dispersion gradient: bit for bit, with the gene partials of one cell
    tile; summed over three tiles they agree to f32 rounding."""
    S, nu, zeta, cf, r = (torch.as_tensor(a) for a in _inputs(Nc=Nc, seed=7))
    loss, dnu_p, ddisp_p, dzeta, dcf = L.ladder_variant_plain(S, nu, zeta, cf, r)
    ploss, (pdnu, pdzeta, pdcf, pddisp, pddnu) = TK.phase_fwdgrad_plain(
        S, nu, zeta, cf, r, lgamma_k_sum=0.0, want_disp=True)
    assert pddnu is None
    tile = TK.phase_layout().cells_per_tile
    assert dnu_p.shape == (-(-Nc // tile), 16, 5)
    assert torch.equal(loss, ploss)
    assert torch.equal(dzeta, pdzeta) and torch.equal(dcf, pdcf)
    if Nc <= tile:
        assert torch.equal(dnu_p[0], pdnu) and torch.equal(ddisp_p[0], pddisp)
    else:
        assert _max_rel(dnu_p.sum(0).numpy(), pdnu.numpy()) < 1e-6
        assert _max_rel(ddisp_p.sum(0).numpy(), pddisp.numpy()) < 1e-6


_TILE = TK.phase_layout().cells_per_tile


@pytest.mark.parametrize("Nc", [_TILE - 27, 2 * _TILE, 3 * _TILE + 37],
                         ids=["below-one-tile", "exact-multiple", "ragged"])
def test_plain_tile_partials_sum_to_the_untiled_gradients(Nc):
    """The gene partials of v_full's plain twin, one per cell tile of the
    kernels' layout, summed over tiles in the kernel wrapper's order (one
    torch sum over the first axis) are phase_fwdgrad's untiled plain
    gradients and the JAX reference's."""
    args = _inputs(Nc=Nc, seed=11)
    S, nu, zeta, cf, r = (torch.as_tensor(a) for a in args)
    loss, dnu_p, ddisp_p, dzeta, dcf = L.ladder_variant_plain(S, nu, zeta, cf, r)
    assert dnu_p.shape == (-(-Nc // _TILE), 16, 5)
    assert ddisp_p.shape == (-(-Nc // _TILE), 16)
    ploss, (pdnu, pdzeta, pdcf, pddisp, _) = TK.phase_fwdgrad_plain(
        S, nu, zeta, cf, r, lgamma_k_sum=0.0, want_disp=True)
    for part, whole in ((dnu_p, pdnu), (ddisp_p, pddisp)):
        assert _max_rel(part.sum(0).numpy(), whole.numpy()) < 1e-6
    # the JAX reference: value and gradients of the NB log-likelihood with
    # ElogS = nu zeta^T + cf (lgamma(k+1) kept, so only the gradients compare)
    jargs = [jnp.asarray(a) for a in args]
    _, jg = jax.value_and_grad(JK.nb_loglik_reference,
                               argnums=(1, 2, 3, 4))(*jargs)
    for got, want in zip((dnu_p.sum(0), dzeta, dcf, ddisp_p.sum(0)), jg):
        assert _max_rel(got.numpy(), np.asarray(want)) < 1e-4


def test_run_ladder_on_the_cpu_gives_the_eight_rows():
    rows = TP.run_ladder(device="cpu", Ng=16, Nc=256, n_it=2)
    assert [row["name"] for row in rows] == list(TP.ROWS)
    assert sorted(TP.ROWS) == sorted(L.RUNGS)
    S = TP.make_inputs(16, 256, device="cpu")[0]
    # Nc < the TPU tool's cell tile: no nu term, so the stream loss is sum(S)
    assert rows[0]["loss"] == float(S.sum())
    for row in rows:
        assert row["device"] == "cpu" and row["kernel_ms"] is None
        assert np.isfinite(row["loss"]) and row["ms_per_step"] > 0
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")
        assert TP.format_row(row).startswith(row["name"])
    by = {row["name"]: row for row in rows}
    # the variants chain through dnu; every rung starts from the same nu
    assert by["v_full"]["loss"] == by["v_nodig"]["loss"] == by["v_nocell"]["loss"]


def _g_r_ops_by_element(k, log_b, a):
    """The dispersion gradient's operations, element by element, on the
    branch each gene and element take (csrc/nb_common.cuh nb_lp_grads)."""
    if a < 64.0:
        return 5 + (15 if k >= 2 else 3) + 1
    e = np.exp(-abs(log_b))
    sig_c = e / (1 + e) if log_b >= 0 else 1 / (1 + e)
    ops = 5 + (16 if log_b >= 0 and sig_c < 0.125 else 2) + 3 + 1
    if k >= 2:
        ops += 29 + 2 + (16 if (k - 2) / (a + 2) < 0.125 else 1)
    return ops


def test_ladder_work_counts_bytes_and_operations():
    S, nu, zeta, cf, r = TP.make_inputs(8, 600, int16=True, device="cpu")
    # three genes at small dispersion take the cancellation-free branch
    r = r.clone()
    r[:3] = torch.tensor([1e-3, 5e-3, 1e-4])
    N = S.numel()
    small = 2 * N + 8 * 5 * 4 + 4
    assert TP.work("stream", S, nu, zeta, cf, r) == (small, 2 * N)
    n_ge2 = int((S >= 2).sum())
    lg = 22 * n_ge2 + 5 * (N - n_ge2) + 2 * N
    log_b = (-torch.log(r)[:, None] - (nu @ zeta.T + cf[None, :])).numpy()
    a = (1.0 / r).numpy()
    Sn = S.numpy()
    dg = sum(_g_r_ops_by_element(float(Sn[g, c]), float(log_b[g, c]), float(a[g]))
             for g in range(8) for c in range(600))
    assert dg > 21 * N      # past the ratio branch's most: the excess branch counts
    nbytes, ops = TP.work("v_full", S, nu, zeta, cf, r)
    assert ops == 56 * N + lg + dg
    assert nbytes == (2 * N + 4 * (8 * 5 + 600 * 5 + 600 + 8) + 4
                      + 4 * 8 * 6 + 4 * 600 * 6)
    assert TP.work("v_nocell", S, nu, zeta, cf, r)[1] == 45 * N + lg + dg
    assert TP.work("v_nodig", S, nu, zeta, cf, r)[1] == 56 * N + lg
    assert TP.work("vpu_only", S, nu, zeta, cf, r)[0] == 4 * (40 + 3000 + 8) + 4
    ms, by = TP.bound_ms(3.35e9, 0)
    assert (ms, by) == (1.0, "bytes")
    assert TP.bound_ms(0, 67e9) == (1.0, "operations")


def test_ladder_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_ladder(Ng=16, Nc=256, n_it=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.main(["i16"])


def test_kernel_wrappers_refuse_what_they_cannot_take():
    S, nu, zeta, cf, r = (torch.as_tensor(a) for a in _inputs())
    calls = {
        "stream": lambda S, nu: L.ladder_stream(S, nu, 2),
        "matmul": lambda S, nu: L.ladder_matmul(S, nu, zeta),
        "logpmf": lambda S, nu: L.ladder_logpmf(S, nu, zeta, r),
        "fwdgrad": lambda S, nu: L.ladder_fwdgrad(S, nu, zeta, r),
        "v_full": lambda S, nu: L.ladder_variant(S, nu, zeta, cf, r),
        "v_nodig": lambda S, nu: L.ladder_variant(S, nu, zeta, cf, r, False),
        "v_nocell": lambda S, nu: L.ladder_variant(S, nu, zeta, cf, r, True,
                                                   False),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA kernel"):
            call(S, nu)
        with pytest.raises(ValueError, match="Nh = 5"):
            call(S, nu[:, :4].contiguous())
        with pytest.raises(TypeError, match="counts"):
            call(S.double(), nu)
        with pytest.raises(TypeError, match="nu must be float32"):
            call(S, nu.double())
    with pytest.raises(ValueError, match="CUDA kernel"):
        L.ladder_vpu_only(nu, zeta, r)
    with pytest.raises(TypeError, match="dispersion"):
        L.ladder_vpu_only(nu, zeta, r.double())
    with pytest.raises(ValueError, match="no variant"):
        L.ladder_variant(S, nu, zeta, cf, r, False, False)
    with pytest.raises(ValueError, match="no variant"):
        L.ladder_variant_plain(S, nu, zeta, cf, r, False, False)
    with pytest.raises(ValueError, match="unknown ladder rung"):
        L.ladder_run("memcpy", S, nu)
    with pytest.raises(ValueError, match="unknown ladder rung"):
        L.run_rung("memcpy", S, nu, zeta, cf, r, plain=True)
    with pytest.raises(ValueError, match="needs S"):
        L.ladder_run("stream", None, nu)
    with pytest.raises(ValueError, match=r"needs \['dispersion'\]"):
        L.ladder_run("logpmf", S, nu, zeta)
