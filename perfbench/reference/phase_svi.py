"""Plain reference of the phase-stage SVI step, written from the model.

The model (VeloCycle's manifold-learning stage, Fourier basis, "xy" phases,
Negative-Binomial counts, optional per-section offsets):

    nu[g]        ~ Normal(mu_nu, sd_nu)                 (Ng, Nh)
    delta_nu[b]  ~ Normal(0, sd_dnu)                    (Nb, Ng), with offsets
                   (one section where the data has none; a pinned value
                   is observed: its log density enters the loss, no leaf)
    phi_xy[c]    ~ Normal(concentration (cos, sin)(angle_c), 1)   (Nc, 2)
    shape_inv[g] ~ Gamma(alpha, beta)                   rate parametrization
    zeta[c]      = [1, cos phi, sin phi, cos 2 phi, sin 2 phi, ...],
                   phi the direction of phi_xy[c]
    ElogS[g, c]  = nu[g] . zeta[c] + delta_nu[b(c), g] + log(s_c / mean s)
    S[g, c]      ~ NB(mean exp(ElogS), dispersion shape_inv[g])

and the mean-field guide: nu ~ Normal(nu_locs, softplus(nu_scales)),
phi_xy ~ Normal(phixy_locs, 1), point masses at softplus(shape_inv_locs)
and delta_nu_locs; the leaves start at the prior's means (delta_nu_locs at
mu_dnu), its scales and the Gamma's mean.  The prior on nu is the trivial
one (zero means, the std ladder of ``nu_stds``) or, with ``nu_prior``
"log_mean", the one a user's script works out from the counts
(`perfbench.inputs.nu_prior`).  One step is the single-draw reparameterized ELBO, its
gradient by autograd, and Adam with each gradient element clamped to
[-clip, clip], bias-corrected moments, eps outside the square root and the
step ``lr * lrd**t``.

Everything the program derives from the inputs (size factors, the phase
prior, the section design, the initial parameters) is worked out again
here.  The likelihood runs in blocks of genes, so that a block's
temporaries are all that it adds to the device's memory.  Nothing here
imports the program.

``precision="tf32"`` is the control: float32 with every matrix product in
TF32 (on the card by cuBLAS, on the CPU by rounding each operand of the
product and of its gradients to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import inputs as _inputs
from . import keys

BLOCK_ELEMENTS = 1 << 24


@dataclasses.dataclass
class Readings:
    """What a run's first steps give: each step's loss, the norm of each
    leaf's first gradient, and the norm of each leaf's change over the
    steps and over the first step alone (unconstrained leaves)."""
    losses: list
    grad_norms: dict
    change_norms: dict
    first_change_norms: dict = None


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).T, _tf32(a).T @ g


class _Precision:
    def __init__(self, precision, device):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.emulate = precision == "tf32" and device.type != "cuda"
        self.tf32 = precision == "tf32"

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.emulate else a @ b

    @contextlib.contextmanager
    def matmuls(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def _normal_lp(x, loc, scale):
    return (-0.5 * ((x - loc) / scale) ** 2 - torch.log(scale)
            - 0.5 * math.log(2 * math.pi))


def fourier(phi_xy, H):
    """[1, cos phi, sin phi, ..., cos H phi, sin H phi] of phi_xy's
    direction, from its unit vector by the angle-addition rule."""
    rho = torch.sqrt((phi_xy ** 2).sum(-1))
    c1, s1 = phi_xy[:, 0] / rho, phi_xy[:, 1] / rho
    cols, c, s = [torch.ones_like(c1)], c1, s1
    for h in range(H):
        cols += [c, s]
        c, s = c * c1 - s * s1, s * c1 + c * s1
    return torch.stack(cols, dim=1)


def _nb_lp(k, elog, r):
    """log NB(k | mean exp(elog), dispersion r), r (B, 1)."""
    a = 1.0 / r
    log_a = -torch.log(r)
    lse = torch.logaddexp(log_a, elog)
    return (torch.lgamma(k + a) - torch.lgamma(a) - torch.lgamma(k + 1.0)
            + a * (log_a - lse) + k * (elog - lse))


class PhaseSVI:
    """The reference's fit state: data worked out from the inputs, leaves,
    Adam's moments.  ``model`` holds the configuration's stated priors
    (``configs/*.json`` key ``model``), ``optim`` the traffic's optimizer
    (``traffic/*.json`` key ``optimizer``)."""

    def __init__(self, inputs, model, optim, precision="float64", fault=None):
        dev = inputs.spliced.device
        self.p = _Precision(precision, dev)
        dt = self.p.dtype
        self.fault = fault
        self.S = inputs.spliced                       # (Nc, Ng) int16
        Nc, Ng = self.S.shape
        self.H = int(model["harmonics"])
        Nh = 2 * self.H + 1
        s_umi = self.S.sum(1, dtype=torch.int64).to(dt)
        self.cf = torch.log(s_umi / s_umi.mean())
        conc = float(model["phase_concentration"])
        ang = inputs.angles.to(dt)
        prior_xy = torch.stack([torch.cos(ang), torch.sin(ang)], 1) * conc
        self.prior_xy = prior_xy
        if model.get("nu_prior") == "log_mean":
            mu, sd = _inputs.nu_prior(inputs, self.H)
            self.mu_nu, self.sd_nu = mu.T.to(dt), sd.T.to(dt)
        else:
            self.mu_nu = torch.full((Ng, Nh), float(model["nu_means"]),
                                    dtype=dt, device=dev)
            self.sd_nu = torch.tensor(model["nu_stds"], dtype=dt,
                                      device=dev).expand(Ng, Nh)
        self.alpha = float(model["gamma_alpha"])
        self.beta = float(model["gamma_beta"])
        self.Db = self.pinned = None
        if model.get("with_delta_nu", inputs.batch is not None):
            if inputs.batch is None:
                self.Db = torch.ones((1, Nc), dtype=dt, device=dev)
            else:
                Nb = int(inputs.batch.max()) + 1
                self.Db = (torch.arange(Nb, device=dev)[:, None]
                           == inputs.batch[None, :]).to(dt)
            self.mu_dnu = float(model["mu_dnu"])
            self.sd_dnu = float(model["sd_dnu"])
            value = model.get("condition_on", {}).get("delta_nu")
            if value is not None:
                self.pinned = torch.full((self.Db.shape[0], Ng), float(value),
                                         dtype=dt, device=dev)

        def inv_softplus(x):
            return x + torch.log(-torch.expm1(-x))

        leaves = {
            "nu_locs": self.mu_nu.clone(),
            "nu_scales": inv_softplus(self.sd_nu.clone()),
            "shape_inv_locs": inv_softplus(torch.full(
                (Ng,), self.alpha / self.beta, dtype=dt, device=dev)),
            "phixy_locs": prior_xy.clone(),
        }
        if self.Db is not None and self.pinned is None:
            leaves["delta_nu_locs"] = torch.full(
                (self.Db.shape[0], Ng), self.mu_dnu, dtype=dt, device=dev)
        self.leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0
        self.optim = optim

    # -- the ELBO ---------------------------------------------------------
    def _likelihood(self, nu, zeta, r, dnu):
        """(sum of the log-likelihood, its gradients in nu, zeta, r, dnu),
        gene block by gene block; with ``fault="half"`` the first half of
        the cells alone, doubled."""
        Nc, Ng = self.S.shape
        n = Nc // 2 if self.fault == "half" else Nc
        rows = max(1, BLOCK_ELEMENTS // n)
        ins = [t for t in (nu, zeta, r, dnu) if t is not None]
        total = torch.zeros((), dtype=self.p.dtype, device=nu.device)
        grads = [torch.zeros_like(t) for t in ins]
        for g0 in range(0, Ng, rows):
            g1 = min(Ng, g0 + rows)
            k = self.S[:n, g0:g1].T.to(self.p.dtype)
            with torch.enable_grad(), self.p.matmuls():
                elog = self.p.mm(nu[g0:g1], zeta[:n].T) + self.cf[None, :n]
                if dnu is not None:
                    elog = elog + self.p.mm(dnu[:, g0:g1].T, self.Db[:, :n])
                lp = _nb_lp(k, elog, r[g0:g1, None]).sum()
                if self.fault == "half":
                    lp = 2.0 * lp
                for acc, d in zip(grads, torch.autograd.grad(lp, ins)):
                    acc += d
            total += lp.detach()
            del k, elog, lp
        return total, grads + ([None] if dnu is None else [])

    def step(self, gkey):
        """One step with the guide's key ``gkey``: (loss, {leaf:
        gradient})."""
        L = self.leaves
        dev, dt = L["nu_locs"].device, self.p.dtype
        eps_nu = keys.site_normal(gkey, "nu", L["nu_locs"].shape, dev).to(dt)
        eps_phi = keys.site_normal(gkey, "phi_xy", L["phixy_locs"].shape,
                                   dev).to(dt)
        with torch.enable_grad():
            scales = F.softplus(L["nu_scales"])
            nu = L["nu_locs"] + scales * eps_nu
            shape_inv = F.softplus(L["shape_inv_locs"])
            phi_xy = L["phixy_locs"] + eps_phi
            zeta = fourier(phi_xy, self.H)
            dnu = L.get("delta_nu_locs", self.pinned)
            a, b = self.alpha, self.beta
            logp = (_normal_lp(nu, self.mu_nu, self.sd_nu).sum()
                    + _normal_lp(phi_xy, self.prior_xy,
                                 torch.ones_like(phi_xy)).sum()
                    + (a * math.log(b) + (a - 1) * torch.log(shape_inv)
                       - b * shape_inv - math.lgamma(a)).sum())
            if dnu is not None:
                logp = logp + _normal_lp(
                    dnu, torch.full_like(dnu, 0.0),
                    torch.full_like(dnu, self.sd_dnu)).sum()
            logq = (_normal_lp(nu, L["nu_locs"], scales).sum()
                    + _normal_lp(phi_xy, L["phixy_locs"],
                                 torch.ones_like(phi_xy)).sum())
            small = logp - logq
        inner = [None if t is None else t.detach().requires_grad_(True)
                 for t in (nu, zeta, shape_inv, dnu)]
        ll, g = self._likelihood(*inner)
        if self.pinned is not None:     # a constant: no gradient flows back
            dnu, g = None, g[:3] + [None]
        outs = [small, nu, zeta, shape_inv] + ([dnu] if dnu is not None else [])
        gouts = [torch.ones_like(small)] + [-x for x in g if x is not None]
        names = list(L)
        grads = torch.autograd.grad([-outs[0], *outs[1:]],
                                    [L[k] for k in names], gouts)
        loss = -(small.detach() + ll)
        grads = dict(zip(names, grads))
        if self.fault == "disp":
            grads["shape_inv_locs"] = 2.0 * grads["shape_inv_locs"]
        return loss, grads

    @torch.no_grad()
    def adam(self, grads):
        o = self.optim
        b1, b2 = o["betas"]
        t = self.t
        bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
        lrd = 0.1 ** (1.0 / o["fit_steps"])
        step = o["lr"] * lrd ** t
        for k, p in self.leaves.items():
            g = grads[k].clamp(-o["clip_norm"], o["clip_norm"])
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o["eps"])
            p -= step * upd


def follow(inputs, model, optim, root_key, steps=3, precision="float64",
           fault=None):
    """The reference's `Readings` over the first ``steps`` steps.
    ``fault``: None; "half" (the likelihood of the first half of the cells,
    doubled); "frozen" (no step moves the leaves); "disp" (the dispersion
    leaf's gradient doubled where it is produced)."""
    ref = PhaseSVI(inputs, model, optim, precision, fault)
    start = {k: v.detach().clone() for k, v in ref.leaves.items()}

    def change():
        return {k: float((v.detach() - start[k]).double().norm())
                for k, v in ref.leaves.items()}

    losses, first, first_change = [], None, None
    for gkey in keys.step_keys(root_key, steps):
        loss, grads = ref.step(gkey)
        losses.append(float(loss))
        if first is None:
            first = {k: float(g.double().norm()) for k, g in grads.items()}
        if fault != "frozen":
            ref.adam(grads)
        ref.t += 1
        if first_change is None:
            first_change = change()
    return Readings(losses, first, change(), first_change)
