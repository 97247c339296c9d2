"""The port's CUDA kernels on the card (marker ``gpu``).

Each test skips inside itself when no CUDA device is present.  This file
imports no JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances are those the kernels' plain versions are held to against the
JAX package (tests/test_torch_nb_kernels.py, tests/test_torch_velocity_
kernels.py, tests/test_torch_ladder.py): loss rel 1e-5, gradients
max|a-b|/max|a| 1e-4 for the phase pair and the ladder, 5e-4 for the
velocity pair.
"""
import dataclasses

import numpy as np
import pytest
import scipy.special as sps
import torch

from velocycle_tpu_torch.ops import ladder_kernels as L
from velocycle_tpu_torch.ops import nb_kernels as K
from velocycle_tpu_torch.tools import kernel_profile as TP

pytestmark = pytest.mark.gpu


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(Ng, Nc, Nh=5, seed=0, Nb=0):
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


def _max_rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


@pytest.mark.parametrize("Ng,Nc,Nh,Nb,int16,skip_k", [
    (1, 1, 5, 0, True, True), (129, 257, 5, 0, False, False),
    (3, 300, 3, 0, True, True), (257, 3001, 5, 2, True, True),
    (64, 1030, 7, 3, False, False),
])
def test_cuda_kernels_match_plain(Ng, Nc, Nh, Nb, int16, skip_k):
    dev = _cuda_or_skip()
    args = _inputs(Ng, Nc, Nh=Nh, seed=Ng + Nc, Nb=Nb)
    if int16:
        args[0] = args[0].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args]
    if not Nb:
        t += [None, None]
    lgk = (np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
           if skip_k else None)
    for want_disp in (True, False):
        kl, kg = K.phase_fwdgrad(*t, lgk, want_disp=want_disp)
        pl, pg = K.phase_fwdgrad_plain(*t, lgk, want_disp=want_disp)
        assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
        for name, a, b in zip(("dnu", "dzeta", "dcf", "ddisp", "ddnu"), kg, pg):
            if b is None:
                assert a is None
            elif not want_disp and name == "ddisp":
                assert float(a.abs().max()) == 0.0
            else:
                assert _max_rel(a, b) < 1e-4, name
    kf = float(K.phase_fwd(*t, lgk))
    pf = float(K.phase_fwd_plain(*t, lgk))
    assert abs(kf - pf) / max(abs(pf), 1.0) < 1e-5


_LAYOUT = K.phase_layout()
_GC = _LAYOUT.gene_chunk
_TILE = _LAYOUT.cells_per_tile


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
@pytest.mark.parametrize("Nc", [_TILE // 2 + 13, 3 * _TILE + 5],
                         ids=["odd-below-one-tile", "several-tiles-unaligned"])
@pytest.mark.parametrize("Ng", [1, _GC - 1, _GC + 1, _LAYOUT.stages * _GC + 1])
def test_cuda_phase_kernels_at_the_ring_edges(Ng, Nc, int16):
    """Gene counts at the edges of a chunk and of the ring of staged chunks,
    odd cell counts (so most rows of S start off a 16-byte boundary), with
    and without delta_nu; then the same call again, bit for bit."""
    dev = _cuda_or_skip()
    Nb = 2 if (Ng + int16) % 2 else 0
    args = _inputs(Ng, Nc, seed=Ng * Nc, Nb=Nb)
    if int16:
        args[0] = args[0].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args]
    if not Nb:
        t += [None, None]
    lgk = np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
    for want_disp in (True, False):
        kl, kg = K.phase_fwdgrad(*t, lgk, want_disp=want_disp)
        pl, pg = K.phase_fwdgrad_plain(*t, lgk, want_disp=want_disp)
        assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
        for name, a, b in zip(("dnu", "dzeta", "dcf", "ddisp", "ddnu"), kg, pg):
            if b is None:
                assert a is None
            elif not want_disp and name == "ddisp":
                assert float(a.abs().max()) == 0.0
            else:
                assert _max_rel(a, b) < 1e-4, name
        again = K.phase_fwdgrad(*t, lgk, want_disp=want_disp)
        assert torch.equal(again[0], kl)
        for a, b in zip(again[1], kg):
            assert (a is None and b is None) or torch.equal(a, b)
    kf = K.phase_fwd(*t, lgk)
    pf = float(K.phase_fwd_plain(*t, lgk))
    assert abs(float(kf) - pf) / max(abs(pf), 1.0) < 1e-5
    assert torch.equal(K.phase_fwd(*t, lgk), kf)


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
def test_cuda_phase_kernels_take_a_misaligned_view(int16):
    """S as rows 1: of a larger matrix with an odd cell count: contiguous,
    but its first element is off a 16-byte boundary, so the ring copies
    the piece below it element by element."""
    dev = _cuda_or_skip()
    Ng, Nc = 40, 2 * _TILE + 3
    big, nu, zeta, cf, r = _inputs(Ng + 1, Nc, seed=5)
    if int16:
        big = big.astype(np.int16)
    S = torch.as_tensor(big, device=dev)[1:]
    assert S.is_contiguous() and S.data_ptr() % 16 != 0
    t = [S] + [torch.as_tensor(a, device=dev) for a in (nu[1:], zeta, cf, r[1:])]
    kl, kg = K.phase_fwdgrad(*t)
    pl, pg = K.phase_fwdgrad_plain(*t)
    assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
    for a, b in zip(kg[:4], pg[:4]):
        assert _max_rel(a, b) < 1e-4
    pf = float(K.phase_fwd_plain(*t))
    assert abs(float(K.phase_fwd(*t)) - pf) / max(abs(pf), 1.0) < 1e-5


def test_cuda_phase_plan_fills_every_sm_evenly():
    """At full width the grid is every CTA the card holds at once, each
    carrying the same number of units to within one, so that the most
    loaded SM carries at most 10% more than the mean, with at least 24
    warps' worth of cells (768) resident per SM on the main path."""
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Ng, Nc = 2048, 102_400
    units = (Ng // _GC) * (Nc // _TILE)
    for mode, wd in (("fwdgrad", True), ("fwd", False)):
        p = K.phase_plan(mode, True, Ng, Nc, want_disp=wd)
        assert p.grid == sms * p.blocks_per_sm
        assert p.blocks_per_sm * _LAYOUT.cells_per_tile >= 24 * 32
        most = -(-units // p.grid)
        assert most - units // p.grid <= 1
        assert p.blocks_per_sm * most <= 1.1 * units / sms
        assert p.dyn_smem > 0
        assert (p.pieces > 0) == (mode == "fwdgrad")


def test_cuda_kernel_is_bit_reproducible_and_counts_launches():
    dev = _cuda_or_skip()
    t = [torch.as_tensor(a, device=dev) for a in _inputs(300, 5000)]
    K.reset_launch_counts()
    a = K.phase_fwdgrad(*t)
    b = K.phase_fwdgrad(*t)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "phase_fwdgrad": 2}
    assert float(a[0]) == float(b[0])
    for x, y in zip(a[1], b[1]):
        if x is not None:
            assert torch.equal(x, y)


# the chain-batched phase_fwdgrad: which of (nu, zeta, cf, r) carry the
# chain axis, every mix
_MIXES = [tuple(bool(m >> i & 1) for i in range(4)) for m in range(16)]


def _chain_operands(t, K, mix, seed, dnu_batched=False):
    """The unbatched operands t = [S, nu, zeta, cf, r, dnu, Db] with the
    chain axis K added (seeded perturbations per chain) to each operand
    ``mix`` (and delta_nu) names."""
    g = torch.Generator(device=t[1].device).manual_seed(seed)
    out = list(t)
    flags = list(mix) + [dnu_batched and t[5] is not None]
    for i, on in zip((1, 2, 3, 4, 5), flags):
        if on:
            x = t[i][None].repeat((K,) + (1,) * t[i].dim())
            x = x + 0.05 * torch.randn(x.shape, generator=g, device=x.device)
            out[i] = x.abs() + 0.05 if i == 4 else x
    return out


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
@pytest.mark.parametrize("Nh,Nb", [(3, 0), (3, 2), (5, 0), (11, 0)])
@pytest.mark.parametrize("chains", [1, 3, 64])
def test_cuda_chain_batched_fwdgrad_matches_plain_and_single_launches(
        chains, Nh, Nb, int16):
    """ONE launch over K chains, for every batched/shared mix of (nu, zeta,
    cf, r) (delta_nu batched with them where there is one), disp_grad both
    ways: each chain's loss and gradients agree with the chain-batched plain
    version and with K single-chain launches at the suite tolerances (loss
    rel 1e-5, gradients 1e-4); at K = 1 the batched launch gives the
    unbatched launch's bits."""
    dev = _cuda_or_skip()
    args = _inputs(37, 300, Nh=Nh, seed=Nh + Nb, Nb=Nb)
    if int16:
        args[0] = args[0].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args]
    if not Nb:
        t += [None, None]
    lgk = np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
    for m, mix in enumerate(_MIXES):
        if not any(mix):
            continue
        b = _chain_operands(t, chains, mix, seed=m, dnu_batched=m % 2 == 1)
        for want_disp in (True, False):
            K.reset_launch_counts()
            kl, kg = K.phase_fwdgrad(*b, lgk, want_disp=want_disp)
            assert K.LAUNCHES["phase_fwdgrad"] == 1
            assert K.LAUNCH_CHAINS["phase_fwdgrad"] == {chains: 1}
            pl, pg = K.phase_fwdgrad_plain(*b, lgk, want_disp=want_disp)
            assert kl.shape == (chains,)
            for c in range(chains):
                one = [x if x is None or x.dim() == y.dim() or i == 0
                       else x[c] for i, (x, y) in enumerate(zip(b, t))]
                sl, sg = K.phase_fwdgrad(*one, lgk, want_disp=want_disp)
                for ref_l, ref_g in ((pl[c], [None if x is None else x[c]
                                              for x in pg]), (sl, sg)):
                    assert (abs(float(kl[c]) - float(ref_l))
                            / max(abs(float(ref_l)), 1.0) < 1e-5)
                    for name, a, r in zip(("dnu", "dzeta", "dcf", "ddisp",
                                           "ddnu"), kg, ref_g):
                        if r is None:
                            assert a is None
                        elif not want_disp and name == "ddisp":
                            assert float(a[c].abs().max()) == 0.0
                        else:
                            assert _max_rel(a[c], r) < 1e-4, (name, c, mix)
                if chains == 1:   # the same bits as the unbatched launch
                    assert torch.equal(kl[0], sl)
                    for a, r in zip(kg, sg):
                        assert (a is None) == (r is None)
                        if a is not None:
                            assert torch.equal(a[0], r)


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
@pytest.mark.parametrize("Nh,Nb", [(3, 0), (3, 2), (5, 0), (11, 0)])
@pytest.mark.parametrize("chains", [1, 3, 64, 256])
def test_cuda_chain_batched_fwd_matches_plain_and_single_launches(
        chains, Nh, Nb, int16):
    """The loss-only kernel over K chains in ONE launch, for every
    batched/shared mix of (nu, zeta, cf, r) (delta_nu batched with them
    where there is one): each chain's loss agrees with the chain-batched
    plain version and with K single launches (loss rel 1e-5); at K = 1 the
    batched launch gives the unbatched launch's bits."""
    dev = _cuda_or_skip()
    args = _inputs(37, 300, Nh=Nh, seed=Nh + Nb + 1, Nb=Nb)
    if int16:
        args[0] = args[0].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args]
    if not Nb:
        t += [None, None]
    lgk = np.float32(sps.gammaln(args[0].astype(np.float64) + 1.0).sum())
    for m, mix in enumerate(_MIXES):
        if not any(mix):
            continue
        b = _chain_operands(t, chains, mix, seed=m, dnu_batched=m % 2 == 1)
        K.reset_launch_counts()
        kl = K.phase_fwd(*b, lgk)
        assert K.LAUNCH_CHAINS["phase_fwd"] == {chains: 1}
        assert kl.shape == (chains,)
        pl = K.phase_fwd_plain(*b, lgk)
        sl = torch.stack([K.phase_fwd(*[
            x if x is None or x.dim() == y.dim() or i == 0 else x[c]
            for i, (x, y) in enumerate(zip(b, t))], lgk)
            for c in range(chains)])
        for ref in (pl, sl):
            rel = (kl - ref).abs() / ref.abs().clamp(min=1.0)
            assert float(rel.max()) < 1e-5, mix
        if chains == 1:   # the same bits as the unbatched launch
            assert torch.equal(kl, sl)


@pytest.mark.parametrize("shape_inv", [1e-5, 1e-4, 1e-3, 1e-2])
@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_cuda_kernels_match_float64_at_small_dispersion(stage, shape_inv):
    """The repaired NB element on the card: each fused likelihood (the
    fwd+grad kernel, and the loss-only kernel) and its dispersion gradient,
    every gene's shape_inv spread over a factor 1.8 around ``shape_inv``,
    against the plain reference in float64 on the CPU: loss within 5e-4
    nats, dispersion gradient max|a-b|/max|b| 3e-3 (the CPU tests' bounds
    before the gradient's terms were taken without cancellation; the CPU
    twins now hold 2e-6, tests/test_torch_mcmc.py SMALL_R_*, and the card
    reads 1.2e-7 at 50 x 500 in `tools/nb_noise.py`)."""
    dev = _cuda_or_skip()
    Ng, Nc = 12, 40
    args = _inputs(Ng, Nc, Nh=3, seed=21)
    rng = np.random.default_rng(22)
    r = (shape_inv * np.exp(np.linspace(-0.3, 0.3, Ng))).astype(np.float32)
    cpu = [torch.as_tensor(a) for a in args[:4]]
    cpu[0] = cpu[0].to(torch.int16)
    if stage == "phase":
        fused, ref = K.nb_loglik_fused, K.nb_loglik_reference
        counts = cpu[:1]
        params = cpu[1:4]
    else:
        U = torch.as_tensor(rng.poisson(2, (Ng, Nc)).astype(np.int16))
        zdphi = torch.as_tensor(rng.normal(0, 0.7, (Nc, 3)).astype(np.float32))
        omega = torch.as_tensor(rng.normal(0.5, 0.1, Nc).astype(np.float32))
        lb = torch.as_tensor(rng.normal(0, 0.3, Ng).astype(np.float32))
        lg = torch.as_tensor(rng.normal(-1, 0.3, Ng).astype(np.float32))
        fused, ref = K.nbsu_loglik_fused, K.nbsu_loglik_reference
        counts = [cpu[0], U]
        params = [cpu[1], cpu[2], zdphi, cpu[3], omega, lb, lg]
    lgk = np.float32(sum(float(sps.gammaln(c.double().numpy() + 1.0).sum())
                         for c in counts))
    r64 = torch.as_tensor(r).double().requires_grad_(True)
    want = ref(*[c.double() for c in counts], *[p.double() for p in params],
               r64)
    (g64,) = torch.autograd.grad(want, r64)
    on_card = [x.to(dev) for x in (*counts, *params)]
    rc = torch.as_tensor(r, device=dev).requires_grad_(True)
    K.reset_launch_counts()
    loss = fused(*on_card, rc, lgamma_k_sum=lgk)
    (g,) = torch.autograd.grad(loss, rc)
    with torch.no_grad():
        loss_only = fused(*on_card, rc, lgamma_k_sum=lgk)
    name = "phase" if stage == "phase" else "velo"
    assert K.LAUNCHES[f"{name}_fwdgrad"] == 1 and K.LAUNCHES[f"{name}_fwd"] == 1
    for got in (loss, loss_only):
        assert abs(float(got) - float(want)) < 5e-4, (float(got), float(want))
    assert _max_rel(g.double().cpu(), g64) < 3e-3


def test_cuda_chain_batched_plan_splits_chains_evenly():
    """K chains multiply the units; the grid still holds the card, and the
    per-chain loss pieces and the cell pieces cover every chain."""
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for Ng, Nc, chains in ((50, 2000, 64), (50, 500, 256), (2048, 102_400, 4)):
        p = K.phase_plan("fwdgrad", True, Ng, Nc, Nh=3, want_disp=False,
                         chains=chains)
        units = chains * -(-Ng // _GC) * -(-Nc // _TILE)
        assert p.grid == min(units, sms * p.blocks_per_sm)
        assert 1 <= p.loss_pieces <= p.grid
        assert p.pieces >= 1
        f = K.phase_plan("fwd", True, Ng, Nc, Nh=3, chains=chains)
        assert f.grid == min(units, sms * f.blocks_per_sm)
        assert 1 <= f.loss_pieces <= f.grid and f.pieces == 0
    with pytest.raises(RuntimeError):   # K > 1 is for fwd and fwdgrad only
        K.phase_plan("stream", True, 50, 500, Nh=5, chains=2)


def test_cuda_wrappers_refuse_what_the_kernels_cannot_take():
    dev = _cuda_or_skip()
    t = [torch.as_tensor(a, device=dev) for a in _inputs(8, 16)]
    with pytest.raises(TypeError):
        K.phase_fwd(t[0].double(), *t[1:])
    with pytest.raises(ValueError, match="contiguous"):
        K.phase_fwd(t[0], t[1], t[2].T.contiguous().T, *t[3:])
    with pytest.raises(ValueError, match="is on"):
        K.phase_fwd(t[0], t[1].cpu(), *t[2:])


@pytest.mark.parametrize("stage", ["phase", "velo"])
@pytest.mark.parametrize("Nh,Nb", [(17, 0), (11, 6), (16, 1)])
def test_cuda_wrappers_run_wide_shapes_on_the_wide_body(stage, Nh, Nb):
    """One column past the widest narrow instantiation: the routed wrappers
    launch the wide body (csrc/nb_wide.cu) once per call, counted under its
    own name, and agree with the wide twins; so they do one column past the
    shared-memory fit of the tile's accumulators and at 257 columns, where
    the body sweeps the tile's genes once per chunk of columns."""
    dev = _cuda_or_skip()
    make = _inputs if stage == "phase" else _velo_inputs
    name = "phase" if stage == "phase" else "velo"
    fwd, fwdgrad = getattr(K, f"{name}_fwd"), getattr(K, f"{name}_fwdgrad")
    fwd_p = getattr(K, f"{name}_fwd_wide_plain")
    fwdgrad_p = getattr(K, f"{name}_fwdgrad_wide_plain")
    names = (("dnu", "dzeta", "dcf", "ddisp", "ddnu") if stage == "phase"
             else VELO_GRADS)
    rtol = 1e-4 if stage == "phase" else 5e-4
    # the first width whose tile does not fit shared memory at once (these
    # counts are float32)
    u16 = False if stage == "velo" else True
    swept = next(W for W in range(17, 4096)
                 if K.wide_plan(stage, "fwdgrad", False, u16, 40, 300, W,
                                want_disp=True).sweeps > 1)
    for W in (Nh + Nb, swept, 257):
        t = [torch.as_tensor(a, device=dev)
             for a in make(40, 300, Nh=W - Nb, Nb=Nb)]
        assert (K.wide_plan(stage, "fwdgrad", False, u16, 40, 300, W,
                            want_disp=True).sweeps > 1) == (W != Nh + Nb)
        for want_disp in (True, False):
            K.reset_launch_counts()
            kl, kg = fwdgrad(*t, want_disp=want_disp)
            assert {k: v for k, v in K.LAUNCHES.items() if v} == {
                f"{name}_fwdgrad_wide": 1}
            assert K.LAUNCH_WIDTHS[f"{name}_fwdgrad_wide"] == {W: 1}
            pl, pg = fwdgrad_p(*t, want_disp=want_disp)
            assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
            for gname, a, b in zip(names, kg, pg):
                if b is None:
                    assert a is None
                elif not want_disp and gname == "ddisp":
                    assert float(a.abs().max()) == 0.0
                else:
                    assert _max_rel(a, b) < rtol, (W, gname)
        K.reset_launch_counts()
        kf = float(fwd(*t))
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {
            f"{name}_fwd_wide": 1}
        assert abs(kf - float(fwd_p(*t))) / max(abs(kf), 1.0) < 1e-5


@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_wide_kernels_repeat_bit_identically(stage):
    """Two calls of each wide kernel on the same inputs give the same bits,
    at 21 columns (every column resident) and at 257 (the tile's genes swept
    once per chunk of columns): every sum in a fixed order, no atomics."""
    dev = _cuda_or_skip()
    make = _inputs if stage == "phase" else _velo_inputs
    fwd, fwdgrad = getattr(K, f"{stage}_fwd"), getattr(K, f"{stage}_fwdgrad")
    for Nh, Nb in ((5, 16), (5, 252)):
        t = [torch.as_tensor(a, device=dev) for a in make(70, 700, Nh=Nh, Nb=Nb)]
        t[0] = t[0].to(torch.int16)
        K.reset_launch_counts()
        runs = [fwdgrad(*t, want_disp=True) for _ in range(2)]
        losses = [float(fwd(*t)) for _ in range(2)]
        assert K.LAUNCHES[f"{stage}_fwdgrad_wide"] == 2
        assert K.LAUNCHES[f"{stage}_fwd_wide"] == 2
        (l1, g1), (l2, g2) = runs
        assert torch.equal(l1, l2) and losses[0] == losses[1]
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)


@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_wide_fused_loglik_launches_one_wide_kernel_per_call(stage):
    """nb_loglik_fused / nbsu_loglik_fused at 5 columns and 16 batches (21
    kernel columns): one wide fwd+grad launch per differentiated call, one
    wide loss-only launch per call without gradients, and no narrow
    launch; the loss and the autograd gradients those of the wide twin."""
    dev = _cuda_or_skip()
    make = _inputs if stage == "phase" else _velo_inputs
    t = [torch.as_tensor(a, device=dev) for a in make(60, 500, Nh=5, Nb=16)]
    n_data = 1 if stage == "phase" else 2
    name = "phase" if stage == "phase" else "velo"
    fused = K.nb_loglik_fused if stage == "phase" else K.nbsu_loglik_fused
    leaves = [x.clone().requires_grad_(True) for x in t[n_data:-1]]
    K.reset_launch_counts()
    loss = fused(*t[:n_data], *leaves, t[-1])
    loss.backward()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        f"{name}_fwdgrad_wide": 1}
    with torch.no_grad():
        fused(*t[:n_data], *leaves, t[-1])
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        f"{name}_fwdgrad_wide": 1, f"{name}_fwd_wide": 1}
    twin = getattr(K, f"{name}_fwdgrad_wide_plain")
    pl, pg = twin(*t)
    assert abs(float(loss.detach()) - float(pl)) / abs(float(pl)) < 1e-5
    rtol = 1e-4 if stage == "phase" else 5e-4
    for leaf, g in zip(leaves, pg):
        assert _max_rel(leaf.grad, g) < rtol


def test_fused_fit_on_the_card_launches_one_fwdgrad_per_step():
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=600, Ng=40, seed=1)
    cycle = T.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = T.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    mp = T.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=2, with_delta_nu=False,
        use_fused_nb=True, device=dev,
    )
    assert mp.data.S.is_cuda and mp.data.S.dtype == torch.int16
    K.reset_launch_counts()
    fit = T.PhaseFitModel(mp, num_samples=4, n_per_bin=4).fit(num_steps=25)
    assert K.LAUNCHES["phase_fwdgrad"] == 25
    assert np.isfinite(fit.losses).all()
    assert fit.losses[-5:].mean() < fit.losses[:5].mean()
    # the same fit with the plain path on the card tracks it
    plain_mp = dataclasses.replace(mp, data=mp.data.replace(use_fused_nb=False))
    plain = T.PhaseFitModel(plain_mp, get_posterior=False).fit(num_steps=25)
    np.testing.assert_allclose(fit.losses, plain.losses, rtol=5e-4)


def _velo_inputs(Ng, Nc, Nh=5, seed=0, Nb=0, gated=False):
    """(S, U, nu, zeta, zeta_dphi, cf, omega, log_beta, log_gamma, r
    [, dnu, Db]); ``gated`` puts a large share of elements below the relu.
    zeta and zeta_dphi are the first Nh Fourier columns."""
    rng = np.random.default_rng(seed)
    S, nu, zeta, cf, r = _inputs(Ng, Nc, Nh=Nh, seed=seed)[:5]
    H = Nh // 2
    h = np.arange(1, H + 1)
    hphi = np.outer(rng.uniform(0, 2 * np.pi, Nc), h)
    zeta = np.concatenate(
        [np.ones((Nc, 1)),
         np.stack([np.cos(hphi), np.sin(hphi)], -1).reshape(Nc, -1)], 1)[:, :Nh]
    zdphi = np.concatenate(
        [np.zeros((Nc, 1)),
         np.stack([-h * np.sin(hphi), h * np.cos(hphi)], -1).reshape(Nc, -1)],
        1)[:, :Nh]
    omega = rng.normal(0, 1, Nc) if gated else np.exp(rng.normal(-1, 0.2, Nc))
    out = [S, rng.poisson(1.5, (Ng, Nc)).astype(np.float32), nu,
           zeta.astype(np.float32), zdphi.astype(np.float32), cf,
           omega.astype(np.float32),
           rng.normal(0, 0.2, Ng).astype(np.float32),
           rng.normal(-1.0 if gated else 0.0, 0.2, Ng).astype(np.float32), r]
    if Nb:
        groups = rng.integers(0, Nb, Nc)
        out += [rng.normal(0, 0.1, (Nb, Ng)).astype(np.float32),
                (np.arange(Nb)[:, None] == groups[None, :]).astype(np.float32)]
    return out


VELO_GRADS = ("dnu", "dzeta", "dzdphi", "dcf", "domega", "dlog_beta",
              "dlog_gamma", "ddisp", "ddnu")
_VLAYOUT = K.velo_layout()
_VGC = _VLAYOUT.gene_chunk
_VTILE = _VLAYOUT.cells_per_tile


def _check_velo(t, lgk=None, repeat=False):
    """velo_fwdgrad (both dispersion settings) and velo_fwd against their
    plain versions on the card tensors ``t``; with ``repeat``, each kernel
    call again, bit for bit."""
    for want_disp in (True, False):
        kl, kg = K.velo_fwdgrad(*t, lgk, want_disp=want_disp)
        pl, pg = K.velo_fwdgrad_plain(*t, lgk, want_disp=want_disp)
        assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
        for name, a, b in zip(VELO_GRADS, kg, pg):
            if b is None:
                assert a is None
            elif not want_disp and name == "ddisp":
                assert float(a.abs().max()) == 0.0
            else:
                assert a.shape == b.shape, name
                assert _max_rel(a, b) < 5e-4, name
        if repeat:
            again = K.velo_fwdgrad(*t, lgk, want_disp=want_disp)
            assert torch.equal(again[0], kl)
            for a, b in zip(again[1], kg):
                assert (a is None and b is None) or torch.equal(a, b)
    kf = K.velo_fwd(*t, lgk)
    pf = float(K.velo_fwd_plain(*t, lgk))
    assert abs(float(kf) - pf) / max(abs(pf), 1.0) < 1e-5
    if repeat:
        assert torch.equal(K.velo_fwd(*t, lgk), kf)


def _velo_tensors(args, dev, s_int16, u_int16, skip_k=True):
    if s_int16:
        args[0] = args[0].astype(np.int16)
    if u_int16:
        args[1] = args[1].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args]
    if len(t) == 10:
        t += [None, None]
    lgk = (np.float32(sum(sps.gammaln(a.astype(np.float64) + 1.0).sum()
                          for a in args[:2])) if skip_k else None)
    return t, lgk


@pytest.mark.parametrize("Ng,Nc,Nh,Nb,int16,skip_k,gated", [
    (1, 1, 5, 0, True, True, False), (129, 257, 5, 0, False, False, False),
    (3, 300, 3, 0, True, True, False), (257, 3001, 5, 2, True, True, False),
    (64, 1030, 7, 3, False, False, False), (300, 5000, 5, 0, True, True, True),
])
def test_cuda_velocity_kernels_match_plain(Ng, Nc, Nh, Nb, int16, skip_k,
                                          gated):
    dev = _cuda_or_skip()
    args = _velo_inputs(Ng, Nc, Nh=Nh, seed=Ng + Nc, Nb=Nb, gated=gated)
    _check_velo(*_velo_tensors(args, dev, int16, int16, skip_k))


@pytest.mark.parametrize("s_int16,u_int16", [(True, True), (True, False),
                                             (False, True), (False, False)],
                         ids=["i16-i16", "i16-f32", "f32-i16", "f32-f32"])
def test_cuda_velocity_kernels_take_mixed_count_types(s_int16, u_int16):
    """S and U each int16 or float32 on its own, over several cell tiles,
    with delta_nu and the relu gate exercised."""
    dev = _cuda_or_skip()
    args = _velo_inputs(131, 3 * _VTILE + 7, seed=7, Nb=2, gated=True)
    _check_velo(*_velo_tensors(args, dev, s_int16, u_int16), repeat=True)


@pytest.mark.parametrize("stage", ["phase", "velo"])
@pytest.mark.parametrize("Nh,Nb", [(4, 0), (9, 0), (11, 0), (5, 5), (5, 6),
                                   (9, 2), (16, 0)])
def test_cuda_kernels_take_any_width_and_batch_count(stage, Nh, Nb):
    """Widths off the instantiations run zero-padded and batches beyond
    them folded into basis columns, in both stages, against the plain
    versions at the original shapes."""
    dev = _cuda_or_skip()
    Ng, Nc = 70, 2 * _VTILE + 9
    if stage == "velo":
        args = _velo_inputs(Ng, Nc, Nh=Nh, seed=Nh + Nb, Nb=Nb, gated=True)
        _check_velo(*_velo_tensors(args, dev, True, False), repeat=True)
        return
    args = _inputs(Ng, Nc, Nh=Nh, seed=Nh + Nb, Nb=Nb)
    args[0] = args[0].astype(np.int16)
    t = [torch.as_tensor(a, device=dev) for a in args] + [None, None][:7 - len(args)]
    for want_disp in (True, False):
        kl, kg = K.phase_fwdgrad(*t, want_disp=want_disp)
        pl, pg = K.phase_fwdgrad_plain(*t, want_disp=want_disp)
        assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
        for name, a, b in zip(("dnu", "dzeta", "dcf", "ddisp", "ddnu"), kg, pg):
            if b is None:
                assert a is None
            elif not want_disp and name == "ddisp":
                assert float(a.abs().max()) == 0.0
            else:
                assert a.shape == b.shape, name
                assert _max_rel(a, b) < 1e-4, name
    pf = float(K.phase_fwd_plain(*t))
    assert abs(float(K.phase_fwd(*t)) - pf) / max(abs(pf), 1.0) < 1e-5


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
@pytest.mark.parametrize("Nc", [_VTILE // 2 + 13, 3 * _VTILE + 5],
                         ids=["odd-below-one-tile", "several-tiles-unaligned"])
@pytest.mark.parametrize("Ng", [1, _VGC - 1, _VGC + 1, _VLAYOUT.stages * _VGC + 1])
def test_cuda_velocity_kernels_at_the_ring_edges(Ng, Nc, int16):
    """Gene counts at the edges of a chunk and of the ring of staged chunks,
    odd cell counts (most rows of S and U start off a 16-byte boundary),
    with and without delta_nu; each call again, bit for bit."""
    dev = _cuda_or_skip()
    Nb = 2 if (Ng + int16) % 2 else 0
    args = _velo_inputs(Ng, Nc, seed=Ng * Nc, Nb=Nb, gated=True)
    _check_velo(*_velo_tensors(args, dev, int16, not int16), repeat=True)


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
def test_cuda_velocity_kernels_take_a_misaligned_view(int16):
    """S and U as rows 1: of larger matrices with an odd cell count:
    contiguous, but their first elements are off 16-byte boundaries."""
    dev = _cuda_or_skip()
    Ng, Nc = 40, 2 * _VTILE + 3
    big = _velo_inputs(Ng + 1, Nc, seed=5)
    args = _velo_inputs(Ng, Nc, seed=6)
    t, _ = _velo_tensors(big, dev, int16, int16)
    S, U = t[0][1:], t[1][1:]
    assert S.is_contiguous() and S.data_ptr() % 16 != 0 and U.data_ptr() % 16 != 0
    rest, _ = _velo_tensors(args, dev, False, False)
    _check_velo([S, U] + rest[2:])


def test_cuda_velo_plan_fills_every_sm_evenly():
    """At full width the grid is every CTA the card holds at once, each
    carrying the same number of units to within one, so that the most
    loaded SM carries at most 10% more than the mean."""
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Ng, Nc = 2048, 102_400
    units = (Ng // _VGC) * (Nc // _VTILE)
    for cut in K.VELO_CUTS:
        p = K.velo_plan(cut, True, True, Ng, Nc)
        assert p.grid == sms * p.blocks_per_sm
        most = -(-units // p.grid)
        assert most - units // p.grid <= 1
        assert p.blocks_per_sm * most <= 1.1 * units / sms
        assert p.dyn_smem > 0
        assert (p.pieces > 0) == (cut == "fwdgrad")


def test_cuda_velocity_kernel_is_bit_reproducible_and_counts_launches():
    dev = _cuda_or_skip()
    t = [torch.as_tensor(a, device=dev) for a in _velo_inputs(300, 5000, Nb=2)]
    K.reset_launch_counts()
    a = K.velo_fwdgrad(*t)
    b = K.velo_fwdgrad(*t)
    K.velo_fwd(*t)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "velo_fwd": 1,
                          "velo_fwdgrad": 2}
    assert float(a[0]) == float(b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def test_cuda_velocity_wrappers_refuse_what_the_kernels_cannot_take():
    dev = _cuda_or_skip()
    t = [torch.as_tensor(a, device=dev) for a in _velo_inputs(8, 16)]
    with pytest.raises(TypeError, match="U must be int16 or float32"):
        K.velo_fwd(t[0], t[1].double(), *t[2:])
    with pytest.raises(ValueError, match="contiguous"):
        K.velo_fwd(*t[:4], t[4].T.contiguous().T, *t[5:])
    with pytest.raises(ValueError, match="is on"):
        K.velo_fwd(*t[:6], t[6].cpu(), *t[7:])


def test_fused_velocity_fit_on_the_card_launches_one_fwdgrad_per_step():
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=600, Ng=40, seed=1)
    cycle = T.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = T.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    speed = T.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                         stds=0.5)
    mp = T.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=2, omega_n_harmonics=1,
        with_delta_nu=False, model_type="lrmn", use_fused_nb=True, device=dev,
    )
    assert mp.data.S.is_cuda and mp.data.U.dtype == torch.int16
    rng = np.random.default_rng(0)
    cond = {"nu": mp.data.mu_nu.cpu().numpy() + rng.normal(0, 0.2, (40, 5)),
            "phi_xy": mp.data.phixy_prior.cpu().numpy(),
            "shape_inv": np.full(40, 0.4)}
    K.reset_launch_counts()
    fit = T.VelocityFitModel(mp, condition_on=cond, num_samples=2,
                             n_per_bin=1).fit(num_steps=25)
    assert fit.metaparams.data.disp_grad is False
    assert K.LAUNCHES["velo_fwdgrad"] == 25 and K.LAUNCHES["velo_fwd"] == 0
    assert np.isfinite(fit.losses).all()
    assert fit.losses[-5:].mean() < fit.losses[:5].mean()
    assert np.isfinite(fit.period_hours()).all()
    assert fit.posterior["ElogU"].shape == (2, 40, 600)
    # the same fit with the plain path on the card tracks it
    plain_mp = dataclasses.replace(mp, data=mp.data.replace(use_fused_nb=False))
    plain = T.VelocityFitModel(plain_mp, condition_on=cond,
                               get_posterior=False).fit(num_steps=25)
    np.testing.assert_allclose(fit.losses, plain.losses, rtol=5e-4)


def test_fused_velocity_fit_on_mixed_count_types():
    """One spliced count beyond int16: S stays float32 and U compacts to
    int16; the fused fit launches one velo_fwdgrad per step and tracks the
    plain path."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=600, Ng=40, seed=1)
    adata.layers["spliced"][3, 2] = 40_000
    cycle = T.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = T.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    speed = T.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                         stds=0.5)
    mp = T.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=2, omega_n_harmonics=1,
        with_delta_nu=False, model_type="lrmn", use_fused_nb=True, device=dev,
    )
    assert mp.data.S.dtype == torch.float32 and mp.data.U.dtype == torch.int16
    rng = np.random.default_rng(0)
    cond = {"nu": mp.data.mu_nu.cpu().numpy() + rng.normal(0, 0.2, (40, 5)),
            "phi_xy": mp.data.phixy_prior.cpu().numpy(),
            "shape_inv": np.full(40, 0.4)}
    K.reset_launch_counts()
    fit = T.VelocityFitModel(mp, condition_on=cond,
                             get_posterior=False).fit(num_steps=25)
    assert K.LAUNCHES["velo_fwdgrad"] == 25
    assert np.isfinite(fit.losses).all()
    plain_mp = dataclasses.replace(mp, data=mp.data.replace(use_fused_nb=False))
    plain = T.VelocityFitModel(plain_mp, condition_on=cond,
                               get_posterior=False).fit(num_steps=25)
    np.testing.assert_allclose(fit.losses, plain.losses, rtol=5e-4)


# ---------------------------------------------------------------------------
# the roofline ladder (cuts of csrc/phase_kernel.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
@pytest.mark.parametrize("Ng,Nc", [(1, 1), (129, 257), (3, 300), (64, 1030)])
def test_cuda_ladder_rungs_match_plain(Ng, Nc, int16):
    dev = _cuda_or_skip()
    args = TP.make_inputs(Ng, Nc, int16, seed=Ng + Nc, device=dev)
    for rung in L.RUNGS:
        kl, kg = L.run_rung(rung, *args, n_rep=3)
        pl, pg = L.run_rung(rung, *args, n_rep=3, plain=True)
        assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5, rung
        assert len(kg) == len(pg)
        for a, b in zip(kg, pg):
            if b is None:
                assert a is None, rung
            else:
                assert _max_rel(a, b) < 1e-4, rung


@pytest.mark.parametrize("int16", [True, False], ids=["i16", "f32"])
def test_cuda_ladder_v_full_is_phase_fwdgrad(int16):
    """Bit for bit: the rungs are cut from phase_fwdgrad's body and layout,
    so a change to that kernel that leaves them behind fails here."""
    dev = _cuda_or_skip()
    S, nu, zeta, cf, r = TP.make_inputs(300, 5000, int16, device=dev)
    out = L.ladder_run("v_full", S, nu, zeta, cf, r)
    gene = out.gene_part.sum(0)
    pl, (pdnu, pdzeta, pdcf, pddisp, _) = K.phase_fwdgrad(
        S, nu, zeta, cf, r, None, None, 0.0, want_disp=True)
    assert torch.equal(out.loss_part.sum().float(), pl)
    for a, b in ((gene[:, :5], pdnu), (gene[:, 5], pddisp), (out.dzeta, pdzeta),
                 (out.dcf, pdcf)):
        assert torch.equal(a, b)


def test_cuda_ladder_is_bit_reproducible_and_counts_launches():
    dev = _cuda_or_skip()
    args = TP.make_inputs(300, 5000, False, device=dev)
    L.reset_launch_counts()
    for rung in L.RUNGS:
        la, ga = L.run_rung(rung, *args, n_rep=3)
        lb, gb = L.run_rung(rung, *args, n_rep=3)
        assert float(la) == float(lb), rung
        for x, y in zip(ga, gb):
            assert (x is None and y is None) or torch.equal(x, y), rung
    assert L.LAUNCHES == {rung: 2 for rung in L.RUNGS}
    with pytest.raises(ValueError, match="Nh = 5"):
        L.ladder_matmul(args[0], args[1][:, :3].contiguous(),
                        args[2][:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        L.ladder_matmul(args[0], args[1], args[2].T.contiguous().T)
    assert L.LAUNCHES["matmul"] == 2


# ---------------------------------------------------------------------------
# the real-data front door on the card machine
# ---------------------------------------------------------------------------

def _normalized_sim(Nc, Ng, seed):
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    T.normalize_total(adata)
    return T, adata


def test_cuda_pca_prior_matches_the_cpu_path():
    """The PCA prior on the card against the same function on the CPU, both
    float64: angles within 1e-5 rad, the same components (no sign flip)."""
    dev = _cuda_or_skip()
    T, adata = _normalized_sim(3000, 200, seed=4)
    genes = list(adata.var.index[::2])
    a = T.Phases.from_pca_heuristic(adata, genes_to_use=genes, device=dev)
    b = T.Phases.from_pca_heuristic(adata, genes_to_use=genes, device="cpu")
    arc = np.abs(np.angle(np.exp(1j * (a.phis - b.phis)))).max()
    assert arc <= 1e-5, arc
    np.testing.assert_allclose(a.pca.components_, b.pca.components_, atol=1e-9)
    np.testing.assert_allclose(a.pcs, b.pcs, atol=1e-9 * np.abs(b.pcs).max())


@pytest.mark.parametrize("noisemodel", ["Poisson", "NegativeBinomial"])
def test_cuda_cycle_mle_in_chunks_matches_one_chunk(noisemodel, monkeypatch):
    """The grid MLE on the card walks the cells in chunks; the result is the
    one-chunk result bit for bit."""
    from velocycle_tpu_torch.containers import phases as PH

    dev = _cuda_or_skip()
    T, adata = _normalized_sim(2000, 60, seed=5)
    nu = np.asarray(adata.uns["simulated_nu"]).T
    cycle = T.Cycle.from_array(nu, np.full(nu.shape, 0.3), list(adata.var.index))
    one = T.Phases.flat_prior(adata)
    one.from_cycle_mle(cycle, adata, noisemodel=noisemodel, device=dev)
    monkeypatch.setattr(PH, "MLE_CHUNK_BYTES", 100 * 60 * 4 * 37)
    chunked = T.Phases.flat_prior(adata)
    chunked.from_cycle_mle(cycle, adata, noisemodel=noisemodel, device=dev)
    np.testing.assert_array_equal(chunked.phi_xy.values, one.phi_xy.values)
    assert np.allclose(one.concentrations, 10.0)


def test_native_ingest_builds_on_the_card_machine():
    import scipy.sparse as sp

    from velocycle_tpu_torch import native

    _cuda_or_skip()
    assert native.available(), native.build_error()
    m = sp.random(300, 70, density=0.1, format="csr", random_state=0,
                  dtype=np.float32)
    np.testing.assert_array_equal(native.csr_to_dense(m, transpose=True),
                                  m.toarray().T)


# ---------------------------------------------------------------------------
# the model variants: the spline basis (11 columns), wrapped phases, LBA
# ---------------------------------------------------------------------------

def _spline_adata(Ng=64, Nc=3000, seed=0):
    """Example 04's draw at a small size: pseudotime t ~ U(0, 1), S and U
    Poisson from the kinetic ElogU of an 11-column spline field."""
    import pandas as pd

    import velocycle_tpu_torch as T
    from velocycle_tpu_torch.ops.splines import spline_basis_auto

    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, Nc)).astype(np.float32)
    W = rng.normal(0, 0.5, (Ng, 11)).astype(np.float32)
    W[:, 0] += 2.0
    B = spline_basis_auto(torch.as_tensor(t), domain=(0.0, 1.0)).numpy()
    dB = spline_basis_auto(torch.as_tensor(t), der=1, domain=(0.0, 1.0)).numpy()
    ElogS = W @ B.T
    kin = (W @ dB.T) * 0.5 + np.exp(rng.normal(0, 0.3, Ng))[:, None]
    ElogU = -2.0 + np.log(np.maximum(kin, 0) + 1e-5) + ElogS
    S = rng.poisson(np.exp(ElogS)).astype(np.float32)
    U = rng.poisson(np.exp(ElogU)).astype(np.float32)
    cells = [f"c{i}" for i in range(Nc)]
    adata = T.AnnDataLite(
        X=S.T.copy(), layers={"spliced": S.T.copy(), "unspliced": U.T.copy()},
        obs=pd.DataFrame(index=cells),
        var=pd.DataFrame(index=[f"g{i:03d}" for i in range(Ng)]))
    phases = T.Phases.from_angles(np.clip(t + rng.normal(0, 0.05, Nc), 0, 1),
                                  cell_names=cells)
    return adata, phases


def _fused_and_plain(fit_cls, mp, steps, **kw):
    """(fused fit, {kernel: {width: launches}} of its steps, plain fit)
    with the same seed."""
    K.reset_launch_counts()
    fused = fit_cls(mp, get_posterior=False, **kw).fit(num_steps=steps)
    widths = {k: dict(v) for k, v in K.LAUNCH_WIDTHS.items() if v}
    plain_mp = dataclasses.replace(mp, data=mp.data.replace(use_fused_nb=False))
    plain = fit_cls(plain_mp, get_posterior=False, **kw).fit(num_steps=steps)
    return fused, widths, plain


@pytest.mark.parametrize("Nb,width", [(0, 11), (2, 16)], ids=["11", "11+2"])
def test_spline_fused_fits_match_plain_on_the_card(Nb, width):
    """The default spline basis (11 columns) through both stages' kernels:
    at width 11, and with two delta_nu batches folded into basis columns
    (13, run at 16).  Stage 1 leaves phi free (its gradient comes back
    through dzeta); stage 2 is conditioned on stage 1's phi and nu.  Three
    steps each: the losses equal the plain path's at rtol 5e-4."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    adata, phases = _spline_adata()
    genes = list(adata.var.index)
    design = None
    if Nb:
        design = (np.arange(adata.shape[0])[:, None] % Nb
                  == np.arange(Nb)[None, :]).astype(np.int64)
    mp = T.preprocess_for_phase_estimation(
        adata, T.Cycle.spline_prior(genes, n_basis=10, stds=3.0), phases,
        basis_kind="spline", spline_domain=(0.0, 1.0), use_fused_nb=True,
        with_delta_nu=bool(Nb), design_mtx=design, device=dev)
    fit, widths, plain = _fused_and_plain(T.PhaseFitModel, mp, 3)
    assert widths == {"phase_fwdgrad": {width: 3}}
    np.testing.assert_allclose(fit.losses, plain.losses, rtol=5e-4)
    phi = fit.params["phi_locs"]
    assert ((phi > 0) & (phi < 1)).all()

    speed = T.AngularSpeed.from_array([[0.0]], [[1.0]], num_coeffs=1)
    vmp = T.preprocess_for_velocity_estimation(
        adata, fit.cycle_fit, phases, speed, basis_kind="spline",
        spline_domain=(0.0, 1.0), model_type="fourier", use_fused_nb=True,
        with_delta_nu=bool(Nb), batch_design_mtx=design, device=dev)
    cond = {"phi": phi, "nu": fit.params["nu_locs"]}
    vfit, vwidths, vplain = _fused_and_plain(T.VelocityFitModel, vmp, 3,
                                             condition_on=cond)
    assert vwidths == {"velo_fwdgrad": {width: 3}}
    np.testing.assert_allclose(vfit.losses, vplain.losses, rtol=5e-4)
    assert np.isfinite(vfit.period_hours()).all()


def test_wrapped_fused_fit_matches_plain_on_the_card():
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=600, Ng=40, seed=1)
    cycle = T.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = T.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    mp = T.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=2, with_delta_nu=False,
        phi_parametrization="wrapped", use_fused_nb=True, device=dev)
    fit, widths, plain = _fused_and_plain(T.PhaseFitModel, mp, 25)
    assert widths == {"phase_fwdgrad": {5: 25}}
    assert np.isfinite(fit.losses).all()
    assert fit.losses[-5:].mean() < fit.losses[:5].mean()
    np.testing.assert_allclose(fit.losses, plain.losses, rtol=5e-4)
    assert np.isfinite(fit.phase_fit.phi_xy.values).all()


def test_lba_enumerated_form_matches_the_analytic_form_on_the_card():
    """tests/test_enum.py's fixture (12 genes x 50 cells, first harmonic)
    on the card, at the point a 20-step fit reaches: the loss of
    phase_model_lba_enum under TraceEnum_ELBO equals phase_model_lba's
    under Trace_ELBO (rtol 1e-5) and so does every param gradient (rtol
    1e-4, atol 1e-5), as there; neither launches a kernel."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, TraceEnum_ELBO
    from velocycle_tpu_torch.models import phase as P

    adata = T.simulate_data(Nc=50, Ng=12, seed=17)
    rng = np.random.default_rng(0)
    nu = adata.uns["simulated_nu"]
    cycle = T.Cycle.from_array((nu + rng.normal(0, 0.2, nu.shape)).T,
                               np.full((3, 12), 0.5), list(adata.var.index))
    phases = T.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    mp = T.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        gene_selection_model="lba", device=dev)
    K.reset_launch_counts()
    fit = T.PhaseFitModel(mp, get_posterior=False).fit(num_steps=20)
    out = []
    for model, loss in ((P.phase_model_lba, Trace_ELBO()),
                        (P.phase_model_lba_enum, TraceEnum_ELBO())):
        svi = SVI(model, P.phase_guide_lba, None, loss)
        svi.constraints = fit.svi.constraints
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in fit.state.params.items()}
        value = svi.loss_fn(params, 5, mp.data)
        value.backward()
        out.append((float(value.detach()),
                    {k: v.grad.cpu().numpy() for k, v in params.items()}))
    assert sum(K.LAUNCHES.values()) == 0
    (la, ga), (le, ge) = out
    assert np.isclose(le, la, rtol=1e-5), (la, le)
    for k in ga:
        np.testing.assert_allclose(ge[k], ga[k], rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# MCMC with the chains batched through the kernel
# ---------------------------------------------------------------------------

def test_fused_nuts_matches_plain_on_the_card():
    """tests/test_fused_models.py:115-139 on the card: NUTS on the phase
    model with phi_xy conditioned, 2 chains, through the chain-batched
    kernel (one launch of 2 chains per batched evaluation) and through the
    plain path; healthy mixing on both (accept > 0.3) and posterior means
    of nu that agree (corr > 0.95)."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import MCMC

    adata = T.simulate_data(Nc=80, Ng=16, omegas_to_test=(0.4,), seed=9)
    cycle = T.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = T.Phases.from_angles(np.asarray(adata.obs["simulated_phis"]),
                                  cell_names=list(adata.obs.index))
    means = {}
    for fused in (False, True):
        mp = T.preprocess_for_phase_estimation(
            adata, cycle, phases, n_harmonics=2, with_delta_nu=False,
            use_fused_nb=fused, device=dev)
        model = handlers.condition(mp.model_fn,
                                   data={"phi_xy": mp.data.phixy_prior})
        m = MCMC(model, kernel="nuts", num_warmup=150, num_samples=120,
                 num_chains=2, max_depth=6)
        K.reset_launch_counts()
        m.run(0, mp.data)
        chains = dict(K.LAUNCH_CHAINS["phase_fwdgrad"])
        if fused:   # init_model's baseline, then the chains' evaluations
            assert chains[1] == 1 and set(chains) == {1, 2}
            assert chains[2] > 150
        else:
            assert chains == {}
        assert m.accept_rate() > 0.3
        means[fused] = m.get_samples()["nu"].mean(0)
    r = np.corrcoef(means[True].ravel(), means[False].ravel())[0, 1]
    assert r > 0.95, r


def _velocity_mp(dev, fused, Nc=40, Ng=8, seed=3):
    import velocycle_tpu_torch as T

    adata = T.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    genes = list(adata.var.index)
    return T.preprocess_for_velocity_estimation(
        adata, T.Cycle.trivial_prior(genes, harmonics=1),
        T.Phases.from_angles(np.asarray(adata.obs["simulated_phis"]),
                             cell_names=list(adata.obs.index)),
        T.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                     stds=0.5),
        n_harmonics=1, omega_n_harmonics=1, with_delta_nu=False,
        model_type="fourier", use_fused_nb=fused, device=dev)


def test_fused_velocity_nuts_matches_plain_on_the_card():
    """Velocity NUTS at 8 genes x 40 cells with phi_xy conditioned, 2
    chains, through the chain-batched velo_fwdgrad (one launch of 2 chains
    per batched evaluation, besides init_model's single baseline launch)
    and through the plain path: healthy mixing on both (accept > 0.3) and
    posterior means of nu that agree (corr > 0.95), as the phase test
    above."""
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import MCMC

    means = {}
    for fused in (False, True):
        mp = _velocity_mp(dev, fused)
        model = handlers.condition(mp.model_fn,
                                   data={"phi_xy": mp.data.phixy_prior})
        m = MCMC(model, kernel="nuts", num_warmup=150, num_samples=120,
                 num_chains=2, max_depth=6)
        K.reset_launch_counts()
        m.run(0, mp.data)
        chains = dict(K.LAUNCH_CHAINS["velo_fwdgrad"])
        if fused:
            assert chains[1] == 1 and set(chains) == {1, 2}
            assert chains[2] > 150
        else:
            assert chains == {}
        assert K.LAUNCH_CHAINS["phase_fwdgrad"] == {}
        assert m.accept_rate() > 0.3
        s = m.get_samples()
        assert all(np.isfinite(v).all() for v in s.values())
        means[fused] = s["nu"].mean(0)
    r = np.corrcoef(means[True].ravel(), means[False].ravel())[0, 1]
    assert r > 0.95, r


def test_fused_velocity_smc_runs_on_the_card():
    """SMCFitModel over fused velocity data (prior tempering, phases
    conditioned, shape_inv free): beta reaches 1 on an increasing
    schedule, log Z and the posterior are finite, and each stage's
    log-likelihood over the particles is ONE chain-batched velo_fwd, each
    batched potential evaluation ONE chain-batched velo_fwdgrad."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    mp = _velocity_mp(dev, True)
    n = 32
    fm = T.SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                       num_particles=n, num_moves=2, max_stages=40,
                       svi_steps=0)
    K.reset_launch_counts()
    fm.run(0)
    sched = np.asarray(fm.temperature_schedule)
    assert sched[-1] == 1.0 and (np.diff(sched) > 0).all()
    assert np.isfinite(fm.log_evidence)
    assert all(np.isfinite(v).all() for v in fm.posterior.values())
    fwd = dict(K.LAUNCH_CHAINS["velo_fwd"])
    grad = dict(K.LAUNCH_CHAINS["velo_fwdgrad"])
    assert fwd.get(n) == len(sched) and set(fwd) <= {1, n}
    assert set(grad) <= {1, n} and grad.get(n, 0) > 0


def _velo_chain_operands(t, Kc, batched, seed):
    """The unbatched velocity operands t = [S, U, nu, zeta, zdphi, cf,
    omega, lbeta, lgamma, r, dnu, Db] with the chain axis Kc added (seeded
    perturbations per chain) at the positions in ``batched``."""
    g = torch.Generator(device=t[2].device).manual_seed(seed)
    out = list(t)
    for i in batched:
        if t[i] is None:
            continue
        x = t[i][None].repeat((Kc,) + (1,) * t[i].dim())
        x = x + 0.05 * torch.randn(x.shape, generator=g, device=x.device)
        out[i] = x.abs() + 0.05 if i == 9 else x
    return out


# which velocity operands carry the chain axis: genes, cells, all (delta_nu
# with them), and a single one
_VELO_MIXES = [(2, 7, 8, 9, 10), (3, 4, 5, 6), tuple(range(2, 11)), (6,)]


def _velo_single(b, t, c):
    return [x if x is None or i < 2 or x.dim() == y.dim() else x[c]
            for i, (x, y) in enumerate(zip(b, t))]


@pytest.mark.parametrize("Nh,Nb", [(3, 0), (3, 2), (5, 0), (11, 0)])
@pytest.mark.parametrize("chains", [1, 4, 64, 256])
def test_cuda_velocity_chain_batched_fwdgrad_matches_plain_and_single_launches(
        chains, Nh, Nb):
    """ONE velo_fwdgrad launch over K chains (rows 4''), for gene-side,
    cell-side, all and one batched operands, the dispersion gradient on
    and off: each chain's loss and gradients agree with the plain version
    mapped over the chains and with K single launches (loss rel 1e-5,
    gradients 5e-4); at K = 1 the batched launch gives the unbatched
    launch's bits."""
    dev = _cuda_or_skip()
    args = _velo_inputs(37, 300, Nh=Nh, seed=Nh + Nb + 5, Nb=Nb)
    t, lgk = _velo_tensors(args, dev, True, True)
    plain = K._CHAINS[K.velo_fwdgrad_plain]
    for m, mix in enumerate(_VELO_MIXES):
        b = _velo_chain_operands(t, chains, mix, seed=m)
        for want_disp in (True, False):
            K.reset_launch_counts()
            kl, kg = K.velo_fwdgrad(*b, lgamma_k_sum=lgk, want_disp=want_disp)
            assert K.LAUNCH_CHAINS["velo_fwdgrad"] == {chains: 1}
            assert kl.shape == (chains,)
            pl, pg = plain(*b, lgamma_k_sum=lgk, want_disp=want_disp)
            for c in range(chains):
                sl, sg = K.velo_fwdgrad(*_velo_single(b, t, c),
                                        lgamma_k_sum=lgk, want_disp=want_disp)
                for ref_l, ref_g in ((pl[c], [None if x is None else x[c]
                                              for x in pg]), (sl, sg)):
                    assert (abs(float(kl[c]) - float(ref_l))
                            / max(abs(float(ref_l)), 1.0) < 1e-5)
                    for name, a, r in zip(VELO_GRADS, kg, ref_g):
                        if r is None:
                            assert a is None
                        elif not want_disp and name == "ddisp":
                            assert float(a[c].abs().max()) == 0.0
                        else:
                            assert _max_rel(a[c], r) < 5e-4, (name, c, mix)
                if chains == 1:   # the same bits as the unbatched launch
                    assert torch.equal(kl[0], sl)
                    for a, r in zip(kg, sg):
                        assert (a is None) == (r is None)
                        if a is not None:
                            assert torch.equal(a[0], r)


@pytest.mark.parametrize("Nh,Nb", [(3, 0), (5, 2), (11, 0)])
@pytest.mark.parametrize("chains", [1, 4, 64, 256])
def test_cuda_velocity_chain_batched_fwd_matches_plain_and_single_launches(
        chains, Nh, Nb):
    """The loss-only velo_fwd over K chains in ONE launch (rows 3''):
    each chain's loss agrees with the mapped plain version and K single
    launches (loss rel 1e-5); at K = 1 the unbatched launch's bits."""
    dev = _cuda_or_skip()
    args = _velo_inputs(37, 300, Nh=Nh, seed=Nh + Nb + 6, Nb=Nb)
    t, lgk = _velo_tensors(args, dev, True, True)
    plain = K._CHAINS[K.velo_fwd_plain]
    for m, mix in enumerate(_VELO_MIXES):
        b = _velo_chain_operands(t, chains, mix, seed=m)
        K.reset_launch_counts()
        kl = K.velo_fwd(*b, lgamma_k_sum=lgk)
        assert K.LAUNCH_CHAINS["velo_fwd"] == {chains: 1}
        assert kl.shape == (chains,)
        pl = plain(*b, lgamma_k_sum=lgk)
        sl = torch.stack([K.velo_fwd(*_velo_single(b, t, c), lgamma_k_sum=lgk)
                          for c in range(chains)])
        for ref in (pl, sl):
            rel = (kl - ref).abs() / ref.abs().clamp(min=1.0)
            assert float(rel.max()) < 1e-5, mix
        if chains == 1:
            assert torch.equal(kl, sl)


def test_cuda_velo_chain_plan_splits_chains_evenly():
    """K chains multiply the velocity units; the grid still holds the
    card, and the per-chain loss pieces and the cell pieces cover every
    chain."""
    _cuda_or_skip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for Ng, Nc, chains in ((50, 500, 64), (20, 200, 256), (2048, 102_400, 4)):
        for cut in K.VELO_CUTS:
            p = K.velo_plan(cut, True, True, Ng, Nc, Nh=3, chains=chains)
            units = chains * -(-Ng // _VGC) * -(-Nc // _VTILE)
            assert p.grid == min(units, sms * p.blocks_per_sm)
            assert 1 <= p.loss_pieces <= p.grid
            assert (p.pieces >= 1) == (cut == "fwdgrad")
        one = K.velo_plan("fwdgrad", True, True, Ng, Nc, Nh=3)
        assert one.loss_pieces == one.grid


@pytest.mark.parametrize("stage", ["phase", "velocity"])
def test_cuda_minibatch_block_objective_matches_full_batch(stage):
    """[minibatch]'s gate at a small size on the card: at the guide's
    draws, the mean of the scaled block losses (one loss-only launch per
    block of B = Nc / 4 cells) equals the full-batch loss, rtol 1e-5."""
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import Trace_ELBO
    from velocycle_tpu_torch.infer.minibatch import LOCAL_SITES, split_cells

    if stage == "phase":
        adata = T.simulate_data(Nc=1000, Ng=64, seed=4)
        mp = T.preprocess_for_phase_estimation(
            adata, T.Cycle.trivial_prior(list(adata.var.index), harmonics=2),
            T.Phases.from_angles(np.asarray(adata.obs["simulated_phis"]),
                                 cell_names=list(adata.obs.index)),
            n_harmonics=2, with_delta_nu=False, use_fused_nb=True, device=dev)
    else:
        mp = _velocity_mp(dev, True, Nc=1000, Ng=64, seed=4)
    data = mp.data
    with torch.no_grad():
        tr = handlers.trace(handlers.seed(mp.guide_fn, 1)).get_trace(data)
        vals = {n: s["value"] for n, s in tr.items() if s["type"] == "sample"}
        K.reset_launch_counts()
        full = float(Trace_ELBO().loss(
            0, handlers.substitute(mp.model_fn, data=vals),
            handlers.substitute(mp.guide_fn, data=vals), data))
        blocks = split_cells(data, 4)
        total = 0.0
        for i, blk in enumerate(blocks):
            v = dict(vals, phi_xy=vals["phi_xy"][i * 250:(i + 1) * 250])

            def scaled(fn):
                return handlers.scale(handlers.substitute(fn, data=v),
                                      scale_factor=4.0,
                                      site_filter=LOCAL_SITES.__contains__)

            total += float(Trace_ELBO().loss(0, scaled(mp.model_fn),
                                             scaled(mp.guide_fn), blk))
    name = "phase_fwd" if stage == "phase" else "velo_fwd"
    assert K.LAUNCHES[name] == 5
    assert np.isclose(total / 4, full, rtol=1e-5), (total / 4, full)


# ---------------------------------------------------------------------------
# the 2-D extension (twodim, AutoNormal / AutoDelta, plain Adam) on the card
# against its CPU run: no kernel of its own, plain torch on cuda tensors.
# Tolerances: ELBO rel 1e-5, gradients max|a-b| / max|a| 1e-4 (only the
# float32 reduction and matmul order differs); Adam rtol 1e-6, atol 1e-6
# ---------------------------------------------------------------------------

def _velo2d_data(device, Nc=300, Ng=40, seed=0):
    from velocycle_tpu_torch import twodim as T2

    adata = T2.generate_adata(n_cells=Nc, n_genes=Ng, seed=seed)
    pd = T2.prepare_data(adata, device=device)
    w_s = torch.as_tensor(np.asarray(adata.uns["w_s"], np.float32),
                          device=device)
    return adata, pd, pd.replace(w_s=w_s, ElogS=w_s @ pd.design_s)


def _velo2d_elbo_and_grads(device, stage, kind):
    """The ELBO of one 2-D model under one autoguide at fixed params and
    fixed guide noise (both from numpy), and its param gradients."""
    from velocycle_tpu_torch import twodim as T2
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, adam
    from velocycle_tpu_torch.infer import autoguide as AG

    def model_and_data(dev):
        _, pd_s, pd_u = _velo2d_data(dev)
        return ((T2.velo2d_s_model, pd_s) if stage == "s"
                else (T2.velo2d_u_model, pd_u))

    # the params of a CPU init (a card's generator draws other numbers)
    model, cpu_data = model_and_data(torch.device("cpu"))
    base = SVI(model, getattr(AG, kind)(model), adam(),
               Trace_ELBO()).init(0, cpu_data).params
    model, data = model_and_data(device)
    guide = getattr(AG, kind)(model)
    svi = SVI(model, guide, adam(), Trace_ELBO())
    svi.init(0, data)
    rng = np.random.default_rng(3)
    params = {k: torch.tensor(v.detach().numpy()
                              + rng.normal(0, 0.1, v.shape).astype(np.float32),
                              device=device, requires_grad=True)
              for k, v in base.items()}
    eps = {k: torch.as_tensor(rng.normal(size=v.shape).astype(np.float32),
                              device=device)
           for k, v in guide._get_prototype(data).items()}

    class Noise(handlers.Messenger):
        def process_message(self, msg):
            if (msg["type"] == "sample" and msg["value"] is None
                    and msg["name"] in eps and kind == "AutoNormal"):
                d = msg["fn"].base
                msg["value"] = d.loc + d.scale * eps[msg["name"]]

    svi.guide = Noise(guide)
    loss = svi.loss_fn(params, 1, data)
    loss.backward()
    return float(loss.detach()), {k: v.grad.cpu().numpy()
                                  for k, v in params.items()}


@pytest.mark.parametrize("stage", ["s", "u"])
@pytest.mark.parametrize("kind", ["AutoNormal", "AutoDelta"])
def test_velo2d_elbo_on_the_card_matches_the_cpu(stage, kind):
    dev = _cuda_or_skip()
    gl, gg = _velo2d_elbo_and_grads(dev, stage, kind)
    cl, cg = _velo2d_elbo_and_grads(torch.device("cpu"), stage, kind)
    assert np.isfinite(gl) and abs(gl - cl) / abs(cl) < 1e-5, (gl, cl)
    assert sorted(gg) == sorted(cg)
    for k in cg:
        assert _max_rel(torch.as_tensor(gg[k]), torch.as_tensor(cg[k])) < 1e-4, k


def test_adam_on_the_card_matches_the_cpu():
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.infer import adam

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(64, 37)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(20)]
    out = {}
    for d in (dev, torch.device("cpu")):
        p = {"w": torch.tensor(p0, device=d)}
        opt = adam(1e-2)
        state = opt.init(p)
        for g in grads:
            opt.update({"w": torch.tensor(g, device=d)}, state, p)
        out[d.type] = p["w"].cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-6, atol=1e-6)


def test_train_velo2d_on_the_card_defaults_to_it():
    """prepare_data with no device puts the data on the card; a short
    two-stage fit there launches no NB kernel, and its losses fall."""
    _cuda_or_skip()
    from velocycle_tpu_torch import twodim as T2

    adata = T2.generate_adata(n_cells=300, n_genes=40, seed=1)
    pd = T2.prepare_data(adata)
    assert pd.S.device.type == "cuda" and pd.design_s.device.type == "cuda"
    K.reset_launch_counts()
    results, ls, lu = T2.train_velo2d(pd, n_steps_s=60, n_steps_u=60, key=1)
    assert not any(K.LAUNCHES.values())
    assert np.isfinite(ls).all() and np.isfinite(lu).all()
    assert ls[-10:].mean() < ls[0] and lu[-10:].mean() < lu[0]
    assert results["ElogU"].shape == (40, 300)
    assert np.isfinite(results["ElogU"]).all()


# ---------------------------------------------------------------------------
# the core remainders on cuda tensors against the CPU: the same float32
# formulas (ProjectedNormal in float64), rtol 1e-5 / atol 1e-5; the
# ELBO's num_particles on the card against the mean of single particles
# ---------------------------------------------------------------------------

def _remainder_cases():
    import math

    from velocycle_tpu_torch.core import distributions as D
    from velocycle_tpu_torch.ops import likelihoods as LK
    from velocycle_tpu_torch.ops import special as SP

    rng = np.random.default_rng(6)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    cov = A @ A.T + 3 * np.eye(3, dtype=np.float32)
    theta = np.linspace(-math.pi, math.pi, 361).astype(np.float32)
    k = np.concatenate([np.arange(12), [20, 50, 500]]).astype(np.float32)
    a = np.array([[0.02], [0.5], [8.0], [59.0], [2000.0]], np.float32)
    return {
        "LogNormal": (lambda x: D.LogNormal(x[0], x[1]).log_prob(x[2]),
                      [np.float32(0.3), np.float32(0.8),
                       np.linspace(0.1, 5, 50).astype(np.float32)]),
        "MultivariateNormal": (
            lambda x: D.MultivariateNormal(
                x[0], covariance_matrix=x[1]).log_prob(x[2]),
            [rng.normal(size=3).astype(np.float32), cov,
             rng.normal(size=(40, 3)).astype(np.float32)]),
        "ProjectedNormal": (
            lambda x: D.ProjectedNormal(x[0], 1.0).log_prob(x[1]),
            [np.array([[1.2, 0.8], [14.0, 0.0], [0.0, -20.0]],
                      np.float32)[:, None, :], theta]),
        "digamma_pos": (lambda x: SP.digamma_pos(x[0]),
                        [np.linspace(1e-3, 40, 300).astype(np.float32)]),
        "lgamma_ratio": (lambda x: SP.lgamma_ratio(x[0], x[1]), [k, a]),
        "digamma_ratio": (lambda x: SP.digamma_ratio(x[0], x[1]), [k, a]),
        "lognormal_logpdf": (lambda x: LK.lognormal_logpdf(*x),
                             [rng.normal(size=50).astype(np.float32),
                              rng.normal(size=50).astype(np.float32),
                              np.float32(0.7)]),
    }


@pytest.mark.parametrize("name", sorted(_remainder_cases()))
def test_core_remainders_on_the_card_match_the_cpu(name):
    dev = _cuda_or_skip()
    fn, args = _remainder_cases()[name]
    got = fn([torch.as_tensor(x, device=dev) for x in args])
    want = fn([torch.as_tensor(x) for x in args])
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_num_particles_on_the_card():
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.core import distributions as D
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import Trace_ELBO

    loc = torch.tensor(0.4, device=dev, requires_grad=True)

    def model():
        handlers.sample("x", D.Normal(torch.zeros((), device=dev), 1.0))

    def guide():
        handlers.sample("x", D.Normal(loc, 0.8))

    four = Trace_ELBO(num_particles=4).loss(3, model, guide)
    singles = torch.stack([Trace_ELBO().loss(handlers.fold_in(3, i), model,
                                             guide) for i in range(4)])
    assert four.device.type == "cuda"
    assert torch.allclose(four, singles.mean(), rtol=1e-6)
    with torch.no_grad():
        many = float(Trace_ELBO(num_particles=4096).loss(0, model, guide))
    assert abs(many + 0.5 * (1 + np.log(0.64) - 0.16 - 0.64)) < 0.02


# ---------------------------------------------------------------------------
# the support modules on the card (checkpoint, warmup, profiling) and the
# layout ladder tool's package layout
# ---------------------------------------------------------------------------

def _support_driver(dev, stage):
    """A fit driver of one stage on fused int16 counts at 40 genes x 300
    cells: the phase stage, or the velocity stage conditioned as the
    two-stage workflow conditions it (velo_fwdgrad without the dispersion
    gradient)."""
    import velocycle_tpu_torch as T

    if stage == "phase":
        adata = T.simulate_data(Nc=300, Ng=40, seed=3)
        mp = T.preprocess_for_phase_estimation(
            adata, T.Cycle.trivial_prior(list(adata.var.index), harmonics=2),
            T.Phases.from_angles(np.asarray(adata.obs["simulated_phis"]),
                                 cell_names=list(adata.obs.index)),
            n_harmonics=2, with_delta_nu=False, use_fused_nb=True, device=dev)
        return T.PhaseFitModel(mp, get_posterior=False), None
    mp = _velocity_mp(dev, True, Nc=300, Ng=40)
    cond = {"nu": mp.data.mu_nu, "phi_xy": mp.data.phixy_prior,
            "shape_inv": torch.full((40,), 0.3, device=dev)}
    return T.VelocityFitModel(mp, condition_on=cond, get_posterior=False), cond


@pytest.mark.parametrize("stage,kernel", [("phase", "phase_fwdgrad"),
                                          ("velocity", "velo_fwdgrad")])
def test_checkpoint_resume_is_bit_equal_on_the_card(stage, kernel, tmp_path):
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.checkpoint import Checkpointer
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam

    driver, _ = _support_driver(dev, stage)
    data = driver.metaparams.data

    def new_svi():
        return SVI(driver.model, driver.guide, clipped_adam(lrd=0.1 ** 0.1),
                   Trace_ELBO())

    K.reset_launch_counts()
    svi = new_svi()
    full, full_losses = svi.update_chunk(svi.init(5, data), 10, data)
    assert K.LAUNCHES[kernel] == 10
    svi1 = new_svi()
    part, first = svi1.update_chunk(svi1.init(5, data), 4, data)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(part.step, part)
    svi2 = new_svi()
    resumed = ckpt.restore(svi2.init(9, data))
    assert all(p.device.type == "cuda" and p.is_leaf and p.requires_grad
               for p in resumed.params.values())
    resumed, rest = svi2.update_chunk(resumed, 6, data)
    assert torch.equal(full_losses, torch.cat([first, rest]))
    for a, b in ((full.params, resumed.params),
                 (full.opt_state["m"], resumed.opt_state["m"]),
                 (full.opt_state["v"], resumed.opt_state["v"])):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert K.LAUNCHES[kernel] == 20


@pytest.mark.parametrize("stage", ["phase", "velocity"])
def test_warmup_on_the_card(stage):
    dev = _cuda_or_skip()
    import velocycle_tpu_torch as T

    driver, cond = _support_driver(dev, stage)
    K.reset_launch_counts()
    timings = T.warmup(driver.metaparams, condition_on=cond, num_steps=20,
                       num_posterior_samples=2, cache_dir=False,
                       verbose=False)
    assert list(timings) == ["build", "svi_step", "predictive"]
    assert timings["build"] >= 0 and timings["svi_step"] > 0
    kernel = "phase_fwdgrad" if stage == "phase" else "velo_fwdgrad"
    assert K.LAUNCHES[kernel] == 1 and sum(K.LAUNCHES.values()) == 1


def test_trace_names_the_kernel_and_memory_stats(tmp_path):
    dev = _cuda_or_skip()
    import glob
    import json
    import os

    from velocycle_tpu_torch import profiling
    from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam

    driver, _ = _support_driver(dev, "phase")
    data = driver.metaparams.data
    svi = SVI(driver.model, driver.guide, clipped_adam(), Trace_ELBO())
    state = svi.init(0, data)
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.annotate("support_step"), timer:
                state, _ = svi.update(state, data)
                torch.cuda.synchronize()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("phase_kernel" in n for n in names), sorted(names)[:20]
    assert any(e.get("name") == "support_step" for e in events)
    assert timer.summary()["steps"] == 3
    stats = profiling.device_memory_stats()
    assert list(stats) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert stats["cuda:0"]["allocated_bytes.all.peak"] == \
        torch.cuda.max_memory_allocated(0)
    assert list(profiling.device_memory_stats("cuda:0")) == ["cuda:0"]


@pytest.mark.parametrize("kind", ["phase", "velo"])
def test_kernel_ladder_package_layout_matches_the_fused_call(kind):
    """The tool's package layout, one step: its loss is the fused call's
    on the tool's inputs (loss only, phase_fwd / velo_fwd) and the plain
    version's (loss rel 1e-5)."""
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.tools import kernel_ladder as KL

    ms, loss = (KL.measure_phase if kind == "phase" else KL.measure_velo)(
        *KL.package_layout(kind)[:2], "i16", n_it=1)
    assert ms > 0
    counts, args, lgk = KL.make_inputs(kind, 0, dev)
    counts = [c.to(torch.int16) for c in counts]
    fused = K.nb_loglik_fused if kind == "phase" else K.nbsu_loglik_fused
    with torch.no_grad():
        direct = float(fused(*counts, *args, lgamma_k_sum=lgk))
        plain = (K.phase_fwd_plain(*counts, *args, None, None, lgk)
                 if kind == "phase" else
                 K.velo_fwd_plain(*counts, *args, None, None, lgk))
    for want in (direct, float(plain)):
        assert abs(loss - want) / abs(want) < 1e-5, (loss, want)


# ---------------------------------------------------------------------------
# the sharded SVI step on the card (velocycle_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Ng,Nc", [(24, 64), (2048, 12_800)])
def test_sharded_svi_on_the_card(Ng, Nc):
    """One rank over NCCL: 20 sharded steps bit-equal to 20 `SVI.update`
    steps on cuda tensors.  Two ranks sharing the card over gloo: losses
    and phixy_locs within rtol 2e-4 of the one rank's
    (tests/test_distributed.py:255), the replicated params and their Adam
    moments bit-identical across the ranks."""
    _cuda_or_skip()
    from _torch_parallel_ranks import run_all
    from velocycle_tpu_torch.parallel import run_ranks

    tasks = [("t", "card_trajectory", (Ng, Nc, 20))]
    one = run_ranks(run_all, 1, device="cuda", timeout=600,
                    args=(tasks,))[0]["t"]
    np.testing.assert_array_equal(one["losses"], one["unsharded_losses"])
    for k, v in one["unsharded_params"].items():
        np.testing.assert_array_equal(one["params"][k], v, err_msg=k)
    two = [r["t"] for r in run_ranks(run_all, 2, backend="gloo",
                                     device="cuda", timeout=600,
                                     args=(tasks,))]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=2e-4)
    ph = one["cells"]["phixy_locs"]
    np.testing.assert_allclose(two[0]["cells"]["phixy_locs"], ph, rtol=2e-4,
                               atol=2e-4 * np.abs(ph).max())
    np.testing.assert_array_equal(two[1]["losses"], two[0]["losses"])
    assert two[1]["replicated"] == two[0]["replicated"]
    assert two[1]["moments"] == two[0]["moments"]


# ---------------------------------------------------------------------------
# the plain NB element on the card (ops/likelihoods.py NBLogPmf)
# ---------------------------------------------------------------------------

def test_plain_element_dispersion_gradient_against_float64_on_the_card():
    """The models' ``NegativeBinomial`` log-prob on cuda tensors, [mcmc]
    (b)'s data (tools/nb_noise.py) at shape_inv 1e-6 spread 1.8x over the
    genes: the dispersion gradient within 1e-6 of the largest and 1e-4
    (median over the genes) of float64 autograd of the direct form, as on
    the CPU (tests/test_torch_nb_element.py)."""
    _cuda_or_skip()
    from velocycle_tpu_torch.tools import nb_noise

    d = nb_noise._data(False, "cuda").data
    res = nb_noise.disp_grad_error("cuda", plain=True, data=d)
    mx, med = res[1e-6][:2]
    assert mx < 1e-6 and med <= 1e-4, res


def test_plain_phase_model_hvp_on_the_card():
    """The NUTS warm start's probes on the plain path on the card
    (`tools.nb_noise.fixed_point_curvature`: `torch.func.jvp` of `grad`
    under `vmap`) at shape_inv 1e-6: the Hessian diagonal in shape_inv
    finite and within 1e-3 (median over the genes) of float64 double
    backward of the direct form."""
    _cuda_or_skip()
    from velocycle_tpu_torch.tools import nb_noise

    hd, ref = nb_noise.fixed_point_curvature("cuda", 1e-6)
    assert np.isfinite(hd).all()
    rel = np.abs(hd - ref) / np.abs(ref)
    assert np.median(rel) <= 1e-3, (np.median(rel), rel.max())


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("stage", ["phase", "velo"])
def test_fwdgrad_kernels_at_a_rounded_y_against_float64(stage, width):
    """The NB element's y = a + 2 rounded in float32 (csrc/nb_common.cuh
    `y_shift`): phase_fwdgrad and velo_fwdgrad, narrow (Nh 5) and wide (Nh
    5 + 16 batches, 21 columns), on 52 genes of 20,000 cells whose a = 1/r
    lie in the windows [2^n - 2, 2^n), n = 1..13 (n = 1: a < 2; from n = 14
    on no float32 r gives a rounded y), 4 each, every y rounded: the
    dispersion gradient within 1e-6 of float64's largest (the reference in
    float64, autograd of the direct form), and the kernel within the parity
    gates of its plain version (loss rel 1e-5; gradients max|a-b|/max|a|
    1e-4 phase, 5e-4 velocity)."""
    dev = _cuda_or_skip()
    from velocycle_tpu_torch.ops.special import y_shift
    from velocycle_tpu_torch.tools import nb_noise

    a = nb_noise.window_a(range(1, 14), 4, True, seed=7).T.ravel()
    Ng, Nc, Nb = a.size, 20_000, 16 if width == "wide" else 0
    name = f"{stage}_fwdgrad" + ("_wide" if Nb else "")
    if stage == "phase":
        args = _inputs(Ng, Nc, seed=31, Nb=Nb)
        args[4] = (np.float32(1.0) / a).astype(np.float32)
        ref, names, rtol, i_r = K.nb_loglik_reference, (
            "dnu", "dzeta", "dcf", "ddisp", "ddnu"), 1e-4, 4
    else:
        args = _velo_inputs(Ng, Nc, seed=31, Nb=Nb)
        args[9] = (np.float32(1.0) / a).astype(np.float32)
        ref, names, rtol, i_r = K.nbsu_loglik_reference, VELO_GRADS, 5e-4, 9
    n_counts = 1 if stage == "phase" else 2
    t = [torch.as_tensor(x, device=dev) for x in args]
    for i in range(n_counts):
        t[i] = t[i].to(torch.int16)
    if not Nb:
        t += [None, None]
    r = t[i_r]
    assert bool((y_shift(1.0 / r, 1.0 / r + 2.0) != 0.0).all())
    lgk = np.float32(sum(sps.gammaln(x.astype(np.float64) + 1.0).sum()
                         for x in args[:n_counts]))
    K.reset_launch_counts()
    kl, kg = getattr(K, f"{stage}_fwdgrad")(*t, lgk, want_disp=True)
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {name: 1}
    plain = getattr(K, f"{stage}_fwdgrad" + ("_wide_plain" if Nb
                                             else "_plain"))
    pl, pg = plain(*t, lgk, want_disp=True)
    assert abs(float(kl) - float(pl)) / max(abs(float(pl)), 1.0) < 1e-5
    for gname, x, y in zip(names, kg, pg):
        if y is None:
            assert x is None
        else:
            assert _max_rel(x, y) < rtol, gname
    r64 = r.double().requires_grad_(True)
    params = [x.double() for x in t[n_counts:i_r]]
    extra = [] if not Nb else [x.double() for x in t[i_r + 1:]]
    (g64,) = torch.autograd.grad(ref(*[x.double() for x in t[:n_counts]],
                                     *params, r64, *extra), r64)
    g = kg[names.index("ddisp")].double()
    assert _max_rel(g, g64) < 1e-6, (
        _max_rel(g, g64), a[int((g - g64).abs().argmax())])
