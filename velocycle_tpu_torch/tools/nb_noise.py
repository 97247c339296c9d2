"""The NB element's float32 noise at small dispersion, and what it does to
NUTS.

    python -m velocycle_tpu_torch.tools.nb_noise [--device cuda] [--nuts]

On `chip_smoke.py` `[mcmc]` (b)'s data (`simulate_data` 500 cells x 50
genes, seed 13, one harmonic, phases conditioned on the prior) the
potential of `infer.mcmc.init_model` is evaluated on the fused path and on
the plain path at 400 points along one gene's unconstrained dispersion,
shape_inv = softplus(u) for u in [-9, 0], as ONE chain batch of 400.  The
two differ by a constant (their baselines); what is left after removing
it is the fused path's rounding.  Printed per decade of shape_inv: its
standard deviation and maximum in nats, and the relative error of the
fused gradient along the line.  Then the fused likelihood's dispersion
gradient against float64 (`nb_loglik_reference`, autograd of the direct
form, on the same values) at every gene's shape_inv spread by a factor 1.8
around each of 1e-6 .. 1e-2: its largest error over the genes relative to
the largest gradient, and the median of the genes' relative errors; and
the same for the plain path's element (the models' ``NegativeBinomial``
log-prob in float32, `ops.likelihoods.NBLogPmf`, whose derivatives are the
fused element's form) with its loss error in nats, each with its worst
gene.  Then the rounded y = a + 2 (`excess_y_shift`: the kernels' plain
element's error at a = 1/r where a + 2 rounds in float32, beside the
element's before its repair, `parent_element`).  Then the
Hessian diagonal in shape_inv through the plain path (the NUTS warm
start's probes) against float64's double backward of the direct form: at
the warm start of `MCMCFitModel` (500 SVI steps) and at fixed values at
every shape_inv above, where also the direct form's.  Then the tensors
autograd saves for one element and the passes over the elements its
log-prob and gradient make, the direct form's against `NBLogPmf`'s.
With ``--nuts``, `MCMCFitModel` samples nu and shape_inv at (b)'s chain
count, warmup, draws and depth on both paths (the warm start's curvature
through the plain path) and prints split R-hat by site.  Runs on
the card by default, on the CPU with ``--device cpu`` (the kernels' plain
versions, in the kernels' float32 arithmetic but without the card's fused
multiply-adds).
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

__all__ = ["direct_element", "disp_grad_error", "element_costs",
           "excess_y_shift", "fixed_point_curvature", "gene_errors",
           "gene_grad_error", "gene_rows", "line_noise", "nuts_by_path",
           "parent_element", "warm_start_curvature", "window_a"]

DECADES = ((1e-4, 1e-3), (1e-3, 1e-2), (1e-2, 1e-1), (1e-1, 1.0))
SHAPE_INVS = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def _data(fused, device):
    import velocycle_tpu_torch as vt

    adata = vt.simulate_data(Nc=500, Ng=50, omegas_to_test=(0.4,), seed=13)
    cycle = vt.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = vt.Phases.from_angles(
        np.asarray(adata.obs["simulated_phis"].values),
        cell_names=list(adata.obs.index))
    return vt.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused, device=device)


def line_noise(device, gene=0, n=400):
    """{(lo, hi): (noise std, noise max, median and max gradient rel
    error)} of the fused potential against the plain one along gene
    ``gene``'s unconstrained shape_inv."""
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.infer import mcmc as TM

    us = np.linspace(-9.0, 0.0, n)
    out = {}
    for fused in (False, True):
        mp = _data(fused, device)
        model = handlers.condition(mp.model_fn,
                                   data={"phi_xy": mp.data.phixy_prior})
        init = {"nu": mp.data.mu_nu + 0.1,
                "shape_inv": torch.full((mp.Ng,), 0.3, device=device)}
        info = TM.init_model(model, mp.data, init_values=init)
        i = mp.Ng * mp.data.mu_nu.shape[1] + gene     # after nu's entries
        q = info.init_u.expand(n, -1).clone()
        q[:, i] = torch.as_tensor(us, dtype=torch.float32, device=device)
        v, g = TM._batched_value_and_grad(info.potential_fn)(q)
        out[fused] = (v.double().cpu().numpy(), g[:, i].double().cpu().numpy())
    r = np.log1p(np.exp(us))
    d = out[True][0] - out[False][0]
    d -= d.mean()
    res = {}
    for lo, hi in DECADES:
        m = (r >= lo) & (r < hi)
        ge = (np.abs(out[True][1][m] - out[False][1][m])
              / (np.abs(out[False][1][m]) + 1e-9))
        res[(lo, hi)] = (d[m].std(), np.abs(d[m]).max(), np.median(ge),
                         ge.max())
    return res


def disp_grad_error(device, seed=0, plain=False, data=None, chunk=None):
    """{shape_inv: (max error / max |gradient|, median relative error over
    the genes, loss error in nats, the worst gene's index, its a = 1/r,
    max error over the genes whose y = a + 2 is exact in float32 / max
    |gradient|, a figure to print beside the first since the y repair
    (`excess_y_shift`))} of the fused likelihood's dispersion
    gradient (``plain``: the plain path's NB element, the models'
    ``NegativeBinomial`` log-prob summed, in float32) against float64, nu
    drawn around the prior mean, the phases at their prior.  ``data``: a
    phase stage's data in place of (b)'s, the genes taken ``chunk`` at a
    time (each gene's gradient is its own)."""
    from velocycle_tpu_torch.core import distributions as dist
    from velocycle_tpu_torch.models.basis import expression_basis
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.ops.special import y_shift

    d = _data(True, device).data if data is None else data
    zeta = expression_basis(d, torch.atan2(d.phixy_prior[:, 1],
                                           d.phixy_prior[:, 0]))
    rng = np.random.default_rng(seed)
    nu = d.mu_nu + torch.as_tensor(rng.normal(0, 0.1, tuple(d.mu_nu.shape)),
                                   dtype=torch.float32, device=device)
    cf = d.count_factor
    Ng = d.S.shape[0]
    parts = [slice(i, i + (chunk or Ng)) for i in range(0, Ng, chunk or Ng)]
    out = {}
    for si in SHAPE_INVS:
        r = si * torch.exp(torch.linspace(-0.3, 0.3, Ng, device=device))
        g32, g64, dl = [], [], 0.0
        for p in parts:
            S, nu_p = d.S[p], nu[p]
            r32 = r[p].clone().requires_grad_(True)
            if plain:
                elog = nu_p @ zeta.T + cf
                loss = dist.NegativeBinomial(
                    mean=torch.exp(elog), dispersion=r32[:, None]
                ).log_prob(S.float()).sum()
            else:
                lgk = (d.lgamma_k_sum if len(parts) == 1 else None)
                loss = K.nb_loglik_fused(S, nu_p, zeta, cf, r32,
                                         lgamma_k_sum=lgk)
            g32.append(torch.autograd.grad(loss, r32)[0].double())
            r64 = r[p].double().requires_grad_(True)
            ref = K.nb_loglik_reference(S.double(), nu_p.double(),
                                        zeta.double(), cf.double(), r64)
            g64.append(torch.autograd.grad(ref, r64)[0])
            dl += float(loss.detach()) - float(ref.detach())
        g32, g64 = torch.cat(g32), torch.cat(g64)
        err = (g32 - g64).abs()
        j = int(err.argmax())
        a = 1.0 / r
        exact = y_shift(a, a + 2.0) == 0.0
        out[si] = (float(err.max() / g64.abs().max()),
                   float((err / g64.abs()).median()), dl, j, float(a[j]),
                   float(err[exact].max() / g64.abs().max()))
    return out


def gene_grad_error(device, data, si, j, seed=0):
    """(fused likelihood's, its plain version's on ``device``'s tensors,
    the plain element's) dispersion gradient errors against float64 relative
    to it, for gene ``j`` of ``data`` alone, its r as in `disp_grad_error`
    at ``si``: the kernel on that gene's row (on the card) against the same
    arithmetic in torch (`ops.nb_kernels.phase_fwdgrad_plain`)."""
    from velocycle_tpu_torch.core import distributions as dist
    from velocycle_tpu_torch.models.basis import expression_basis
    from velocycle_tpu_torch.ops import nb_kernels as K

    zeta = expression_basis(data, torch.atan2(data.phixy_prior[:, 1],
                                              data.phixy_prior[:, 0]))
    rng = np.random.default_rng(seed)
    nu = data.mu_nu + torch.as_tensor(
        rng.normal(0, 0.1, tuple(data.mu_nu.shape)), dtype=torch.float32,
        device=device)
    Ng = data.S.shape[0]
    r = (si * torch.exp(torch.linspace(-0.3, 0.3, Ng, device=device)))[
        j:j + 1]
    S, nu, cf = data.S[j:j + 1], nu[j:j + 1], data.count_factor
    r64 = r.double().requires_grad_(True)
    (g64,) = torch.autograd.grad(K.nb_loglik_reference(
        S.double(), nu.double(), zeta.double(), cf.double(), r64), r64)
    r32 = r.clone().requires_grad_(True)
    (fused,) = torch.autograd.grad(K.nb_loglik_fused(S, nu, zeta, cf, r32),
                                   r32)
    twin = K.phase_fwdgrad_plain(S, nu, zeta, cf, r)[1][3]
    elog = nu @ zeta.T + cf
    (plain,) = torch.autograd.grad(dist.NegativeBinomial(
        mean=torch.exp(elog), dispersion=r32[:, None]).log_prob(
            S.float()).sum(), r32)
    return tuple(float(((g.double() - g64).abs() / g64.abs())[0])
                 for g in (fused, twin, plain))


def _parent_stirling(k, a):
    """(lgr, dgr, kad) as the element took them before its y repair: the
    threshold-2 Stirling branch at y = a + 2 rounded, with y - a taken as 2
    (frozen; the element's other pieces are the live ones, which the repair
    does not touch)."""
    from velocycle_tpu_torch.ops.special import log1p_excess

    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    masks = [k > j for j in range(2)]
    logs = [torch.log(a + j) for j in range(2)]
    invs = [1.0 / (a + j) for j in range(2)]
    small_l = sum(torch.where(masks[j], logs[j], zero) for j in range(2))
    y = a + 2.0
    x = torch.clamp(k - 2.0, min=0.0)
    inv_y = 1.0 / y
    inv2_y = inv_y * inv_y
    t = x * inv_y
    l1p = torch.log1p(t)
    inv = 1.0 / (y + x)
    inv2 = inv * inv
    rc_ka = inv * (1.0 / 12.0 - inv2 * (
        1.0 / 360.0 - inv2 * (1.0 / 1260.0 - inv2 * (1.0 / 1680.0))))
    rc_y = inv_y * (1.0 / 12.0 - inv2_y * (
        1.0 / 360.0 - inv2_y * (1.0 / 1260.0 - inv2_y * (1.0 / 1680.0))))
    stir_l = (y - 0.5 + x) * l1p + x * torch.log(y) - x + rc_ka - rc_y
    lt = k < 2
    lgr = torch.where(lt, small_l, sum(logs) + stir_l)
    small_d = sum(torch.where(masks[j], invs[j], zero) for j in range(2))
    tail_ka = -0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (
        1.0 / 120.0 - inv2 / 252.0))
    tail_y = -0.5 * inv_y - inv2_y * (1.0 / 12.0 - inv2_y * (
        1.0 / 120.0 - inv2_y / 252.0))
    dgr = torch.where(lt, small_d, sum(invs) + (l1p + tail_ka - tail_y))
    d1 = -x * inv * inv_y
    d2 = d1 * (inv + inv_y)
    td = -0.5 * d1 - d2 * (1.0 / 12.0 - (inv2 + inv2_y) * (1.0 / 120.0)
                           + (inv2 * inv2 + inv2 * inv2_y + inv2_y * inv2_y)
                           * (1.0 / 252.0))
    kad = torch.where(lt, zero, invs[1] + y * log1p_excess(t, l1p)
                      + (y - a) * l1p - a * td)
    return lgr, dgr, kad


def parent_element(k, a, log_r, elog, skip_k=True):
    """(log-pmf, d lp/d elog, d lp/d r) of the kernels' NB element as its
    plain version (`ops.nb_kernels._nb_lp_and_grads`) computed them before
    the y repair: its Stirling pieces frozen (`_parent_stirling`), so that
    the dispersion gradient's digamma differences sit at the rounded y =
    a + 2.  The yardstick the repair is held against."""
    from velocycle_tpu_torch.ops.special import (
        EXCESS_FROM, SERIES_BELOW, lgamma_pos, log1m_excess,
        softplus_log_sigmoid)

    log_b = -log_r - elog
    sp, log_sig, sig, sig_c = softplus_log_sigmoid(log_b)
    lgr, dgr, kad = _parent_stirling(k, a)
    lp = lgr + a * log_sig - k * sp
    if not skip_k:
        lp = lp - lgamma_pos(k + 1.0)
    g_elog = k * sig - a * sig_c
    g_r_ratio = ((dgr + log_sig) * (-a) + g_elog) * a
    q = torch.where((log_b >= 0.0) & (sig_c < SERIES_BELOW),
                    log1m_excess(sig_c), -(log_sig + sig_c))
    g_r_excess = ((kad - k * sig_c) + a * q) * a
    return lp, g_elog, torch.where(a < EXCESS_FROM, g_r_ratio, g_r_excess)


def window_a(windows, per_window, shifted=True, seed=0):
    """float32 a = 1/r, (len(windows), per_window): in each window n of
    ``windows`` a drawn uniformly in [2^n - 2, 2^n) ([0.05, 2) for n = 1),
    keeping those whose y = a + 2 rounds in float32 (``shifted``) or those
    whose y is exact; each a as the element forms it, 1 / fl(1 / a), and
    1 / fl(1 / a) again (r = 1 / a gives it back).  From
    n = 14 on no float32 r gives a shifted a = 1/r (those a lie 2^-9 apart,
    twice a's spacing, on even multiples of it): ValueError."""
    rng = np.random.default_rng(seed)
    out = []
    for n in windows:
        lo, hi = (0.05, 2.0) if n == 1 else (2.0 ** n - 2.0, 2.0 ** n)
        got = np.zeros(0, np.float32)
        for _ in range(64):
            if got.size >= per_window:
                break
            a = rng.uniform(lo, hi, 4 * per_window).astype(np.float32)
            a = np.float32(1.0) / (np.float32(1.0) / a)
            y = a + np.float32(2.0)
            delta = (y - np.maximum(a, np.float32(2.0))) - np.minimum(
                a, np.float32(2.0))
            keep = (((delta != 0.0) == shifted) & (a >= lo) & (a < hi)
                    & (np.float32(1.0) / (np.float32(1.0) / a) == a))
            got = np.concatenate([got, a[keep]])
        if got.size < per_window:
            raise ValueError(f"window {n}: no a = 1/r with y = a + 2 "
                             f"{'rounded' if shifted else 'exact'}")
        out.append(got[:per_window])
    return np.stack(out)


def gene_rows(a_values, Nc, seed=0, device="cpu"):
    """(k, elog, r) for one gene per a = 1/r in ``a_values``, each on
    counts drawn as chip_smoke.py's (floor exp N(1, 0.8^2)) at log-means
    about log 3 (sd 0.3)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = len(a_values)
    k = torch.floor(torch.exp(torch.randn((n, Nc), generator=g,
                                          device=device) * 0.8 + 1.0))
    elog = torch.log(torch.full((n, Nc), 3.0, device=device)) + 0.3 * (
        torch.randn((n, Nc), generator=g, device=device))
    a = torch.as_tensor(np.asarray(a_values, np.float32), device=device)
    return k, elog, 1.0 / a


def gene_errors(k, elog, r, element=None):
    """Each gene's (row's) summed dispersion gradient against float64
    autograd of the direct form, |sum error| / |sum gradient|, and the same
    for its log-pmf: two numpy arrays.  ``element``: `parent_element` or
    the kernels' plain element (`ops.nb_kernels._nb_lp_and_grads`, the
    default)."""
    from velocycle_tpu_torch.ops import nb_kernels as K
    from velocycle_tpu_torch.ops.likelihoods import nb_logpmf_direct

    r64 = r.double()[:, None].expand(k.shape).clone().requires_grad_(True)
    lp64 = nb_logpmf_direct(k.double(), elog.double(), r64)
    (g64,) = torch.autograd.grad(lp64.sum(), r64)
    a = 1.0 / r[:, None]
    lp, _, g_r = (element or K._nb_lp_and_grads)(
        k, a, torch.log(r)[:, None], elog, False)
    lp64 = lp64.detach().sum(1)
    g64 = g64.sum(1)

    def rel(got, want):
        return ((got.double().sum(1) - want).abs() / want.abs()).cpu().numpy()

    return rel(g_r, g64), rel(lp, lp64)


def excess_y_shift(device, a_values, Nc=102_400, seed=0):
    """{a: (delta = y - a - 2 with y = a + 2 rounded in float32
    (`ops.special.y_shift`), the kernels' plain element's dispersion
    gradient against float64 relative to it, the same for the element
    before the y repair (`parent_element`))} for one gene at each a = 1/r
    on counts drawn as chip_smoke.py's (`gene_rows`), mu about 3.  Before
    the repair the Stirling pieces sat at the rounded y, and where delta
    != 0 (a in [126, 128), [1022, 1024), ...) k - a dgr moved by about
    delta a x / (y (y + x)), x = k - 2, of one sign over the gene's
    cells."""
    from velocycle_tpu_torch.ops.special import y_shift

    k, elog, r = gene_rows(a_values, Nc, seed, device)
    a = 1.0 / r
    delta = y_shift(a, a + 2.0)
    fixed = gene_errors(k, elog, r)[0]
    parent = gene_errors(k, elog, r, parent_element)[0]
    return {a_val: (float(delta[i]), float(fixed[i]), float(parent[i]))
            for i, a_val in enumerate(a_values)}


@contextlib.contextmanager
def direct_element():
    """The models' ``NegativeBinomial`` as the plain ``GammaPoisson(1/r,
    1/(r mu))``, differentiated by autograd of its direct form (the JAX
    package's): the element before `ops.likelihoods.NBLogPmf`."""
    from velocycle_tpu_torch.core import distributions as dist

    nb = dist.NegativeBinomial
    dist.NegativeBinomial = lambda mean, dispersion: dist.GammaPoisson(
        1.0 / dispersion, 1.0 / (dispersion * mean))
    try:
        yield
    finally:
        dist.NegativeBinomial = nb


def _shape_inv_index(info):
    """(offset, size) of shape_inv in `init_model`'s flat coordinates."""
    o = 0
    for name, meta in info.site_meta.items():
        if name == "shape_inv":
            return o, meta[1]
        o += meta[1]
    raise KeyError("shape_inv")


def _shape_inv_hdiag(model, data, init, seed=0):
    """shape_inv's diagonal of the potential's Hessian in its unconstrained
    coordinate at ``init`` on the plain path, by the NUTS warm start's
    probes (`fit_mcmc`: `torch.func.jvp` of `torch.func.grad` of
    `init_model`'s potential under `torch.func.vmap`), one per gene."""
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.fit_mcmc import _PROBE_CHUNK, _plain_view
    from velocycle_tpu_torch.infer.mcmc import init_model

    info = init_model(model, _plain_view(data), init_values=init,
                      seed=handlers.fold_in(seed, 8))
    o, n = _shape_inv_index(info)
    u0 = info.init_u
    grad = torch.func.grad(info.potential_fn)
    probes = torch.eye(u0.shape[-1], device=u0.device)[o:o + n]
    with torch.no_grad():
        hd = torch.func.vmap(
            lambda v: torch.sum(v * torch.func.jvp(grad, (u0,), (v,))[1]),
            chunk_size=_PROBE_CHUNK)(probes)
    return hd.double().cpu().numpy()


def _shape_inv_hdiag_f64(model, data, init):
    """The same diagonal by float64 double backward of the direct form:
    Gamma prior, the softplus Jacobian and the NB element at the model's
    own ElogS (traced at ``init``, widened to float64)."""
    from velocycle_tpu_torch.core import constraints, handlers
    from velocycle_tpu_torch.fit_mcmc import _plain_view
    from velocycle_tpu_torch.ops.likelihoods import nb_logpmf_direct

    data = _plain_view(data)
    cond = {k: torch.as_tensor(np.asarray(init[k]), dtype=torch.float32,
                               device=data.device)
            for k in ("nu", "shape_inv")}
    with torch.no_grad():
        tr = handlers.trace(handlers.seed(handlers.condition(
            model, data=cond), 0)).get_trace(data)
    elog = tr["ElogS"]["value"].double()
    u = constraints.positive.inverse(cond["shape_inv"].double())
    u.requires_grad_(True)
    zero = u.new_zeros(())
    s = torch.logaddexp(u, zero)
    alpha, beta = data.gamma_alpha.double(), data.gamma_beta.double()
    log_joint = ((alpha - 1.0) * torch.log(s) - beta * s
                 - torch.logaddexp(-u, zero)
                 + nb_logpmf_direct(data.S.double(), elog,
                                    s[:, None]).sum(-1))
    (g,) = torch.autograd.grad(-log_joint.sum(), u, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), u)
    return h.cpu().numpy()


def warm_start_curvature(device, seed=0, svi_steps=500):
    """(the Hessian diagonal in shape_inv through the plain path, float64's,
    the init values) at `MCMCFitModel`'s warm start (its SVI run) at (b)'s
    configuration on the plain path."""
    import velocycle_tpu_torch as vt

    mp = _data(False, device)
    fm = vt.MCMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                         svi_steps=svi_steps)
    init, _ = fm._warm_start(seed)
    return (_shape_inv_hdiag(fm.model, mp.data, init, seed),
            _shape_inv_hdiag_f64(fm.model, mp.data, init), init)


def fixed_point_curvature(device, si, seed=8):
    """(the Hessian diagonal in shape_inv through the plain path, float64's)
    on (b)'s data at fixed values: nu drawn around the prior mean, every
    gene's shape_inv spread by a factor 1.8 around ``si`` (where the warm
    start's SVI run does not go)."""
    from velocycle_tpu_torch.core import handlers

    mp = _data(False, device)
    d = mp.data
    Ng, Nh = tuple(d.mu_nu.shape)
    rng = np.random.default_rng(seed)
    init = {"nu": (d.mu_nu.cpu().numpy() + rng.normal(0, 0.1, (Ng, Nh))
                   ).astype(np.float32),
            "shape_inv": (si * np.exp(np.linspace(-0.3, 0.3, Ng))).astype(
                np.float32)}
    model = handlers.condition(mp.model_fn, data={"phi_xy": d.phixy_prior})
    return (_shape_inv_hdiag(model, d, init),
            _shape_inv_hdiag_f64(model, d, init))


def element_costs(device, Ng=8, Nc=64):
    """{element: (tensors of the counts' (Ng, Nc) shape that autograd saves
    for the backward beside the counts and the mean, forward passes, their
    bytes per element, backward passes, their bytes per element)} of one
    NB log-prob at (mean, dispersion) and its gradient in both: a pass is
    an operation with an output of the counts' size, its bytes those of
    that output and of its inputs of that size (a broadcast input counts
    none).  The direct form (`direct_element`) against `NBLogPmf`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from velocycle_tpu_torch.core import distributions as dist

    n_el = Ng * Nc

    def full(t):
        return (isinstance(t, torch.Tensor) and t.numel() >= n_el
                and 0 not in t.stride())

    class Passes(TorchDispatchMode):
        n = nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if full(out):
                self.n += 1
                self.nbytes += out.element_size() + sum(
                    t.element_size()
                    for t in (*args, *(kwargs or {}).values()) if full(t))
            return out

    k = torch.ones((Ng, Nc), device=device)

    def element():
        elog = torch.zeros((Ng, Nc), device=device, requires_grad=True)
        r = torch.full((Ng, 1), 0.1, device=device, requires_grad=True)
        mean = torch.exp(elog)
        return mean, r, lambda: dist.NegativeBinomial(mean, r).log_prob(
            k).sum()

    out = {}
    for name, ctx in (("direct", direct_element),
                      ("NBLogPmf", contextlib.nullcontext)):
        with ctx():
            mean, r, lp = element()
            saved = []
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append(t) or t, lambda t: t):
                lp()
            mean_, r, lp = element()     # passes without the hooks
            with Passes() as fwd:
                loss = lp()
            with Passes() as bwd:
                torch.autograd.grad(loss, (mean_, r))
        n_saved = len({t.data_ptr() for t in saved
                       if tuple(t.shape) == (Ng, Nc)}
                      - {k.data_ptr(), mean.data_ptr()})
        out[name] = (n_saved, fwd.n, fwd.nbytes, bwd.n, bwd.nbytes)
    return out


def nuts_by_path(device, seed=0):
    """{path: (accept, max split R-hat by site, min ESS, seconds)} of
    `MCMCFitModel` at (b)'s configuration on the fused and plain paths."""
    import velocycle_tpu_torch as vt

    out = {}
    for name, mp in (("fused", _data(True, device)),
                     ("plain", _data(False, device))):
        t0 = time.perf_counter()
        fm = vt.MCMCFitModel(
            mp, condition_on={"phi_xy": mp.data.phixy_prior},
            num_chains=256, num_warmup=400, num_samples=100, max_depth=6,
            init_jitter=2.0, svi_steps=500)
        fm.run(seed)
        rhat = {k: float(np.nanmax(v["rhat"])) for k, v in fm.summary.items()}
        out[name] = (fm.diagnostics["accept_rate"], rhat,
                     fm.diagnostics["min_ess"], time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nuts", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        where = torch.cuda.get_device_name(0)
    else:
        where = "cpu (plain versions)"
    for (lo, hi), (sd, mx, gmed, gmax) in line_noise(args.device).items():
        print(f"[nb_noise] shape_inv in [{lo:g}, {hi:g}): fused - plain "
              f"potential noise std {sd:.4f} max {mx:.4f} nats; fused "
              f"gradient rel error median {gmed:.2e} max {gmax:.2e} ({where})")
    errs = disp_grad_error(args.device)
    for path, res in (("fused", errs),
                      ("plain", disp_grad_error(args.device, plain=True))):
        for si, (mx, med, dl, j, a, mx_exact) in res.items():
            print(f"[nb_noise] {path} dispersion gradient at shape_inv "
                  f"{si:g}: error against float64 {mx:.2e} of the largest "
                  f"(gene {j}, a {a:.6g}; {mx_exact:.2e} where y = a + 2 "
                  f"is exact), median over genes {med:.2e}; loss {dl:+.2e} "
                  f"nats ({where})")
    for a, (delta, err, parent) in excess_y_shift(
            args.device, (1000.0, 1022.6, 126.1, 127.9)).items():
        print(f"[nb_noise] excess form at a {a:g}: y - a - 2 = {delta:.3e}; "
              f"kernels' plain version against float64 {err:.2e}, the "
              f"element before the y repair {parent:.2e} ({where})")
    print(f"[nb_noise] dispersion gradient error at shape_inv 1e-5 / 1e-3: "
          f"{errs[1e-5][0] / errs[1e-3][0]:.2f}x (largest), "
          f"{errs[1e-5][1] / errs[1e-3][1]:.2f}x (median) ({where})")
    hd, ref, _ = warm_start_curvature(args.device)
    rel = np.abs(hd - ref) / np.abs(ref)
    print(f"[nb_noise] plain warm start, shape_inv Hessian diagonal against "
          f"float64: median rel {np.median(rel):.2e}, max {rel.max():.2e} "
          f"({where})")
    for si in SHAPE_INVS:
        for name, ctx in (("plain", contextlib.nullcontext),
                          ("direct form", direct_element)):
            with ctx():
                hd, ref = fixed_point_curvature(args.device, si)
            rel = np.abs(hd - ref) / np.abs(ref)
            print(f"[nb_noise] {name}, shape_inv {si:g} (fixed), its "
                  f"Hessian diagonal against float64: median rel "
                  f"{np.median(rel):.2e}, max {rel.max():.2e} ({where})")
    print(f"[nb_noise] one element's (Ng, Nc) tensors saved for the "
          f"backward, forward passes and bytes per element, backward passes "
          f"and bytes per element: {element_costs(args.device)} ({where})")
    if args.nuts:
        for name, (acc, rhat, ess, dt) in nuts_by_path(args.device).items():
            print(f"[nb_noise] MCMCFitModel (b) {name}: accept {acc:.4f}, max "
                  f"split R-hat by site {rhat}, min ESS {ess:.1f}, {dt:.1f} s "
                  f"({where})")


if __name__ == "__main__":
    main()
