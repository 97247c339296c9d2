"""The fused NB likelihood's float32 noise at small dispersion, and what it
does to NUTS.

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
gradient against float64 (`nb_loglik_reference` on the same values) at
every gene's shape_inv spread by a factor 1.8 around each of 1e-6 .. 1e-2:
its largest error over the genes relative to the largest gradient, and the
median of the genes' relative errors; and the same for the plain path's
element (the models' ``NegativeBinomial`` log-prob in float32, its
gradient by autograd) with its loss error in nats.  With ``--nuts``, `MCMCFitModel` samples
nu and shape_inv at (b)'s chain count, warmup, draws and depth on both
paths (the warm start's curvature through the plain path) and prints
split R-hat by site.  Runs on the card by default, on the CPU with
``--device cpu`` (the kernels' plain versions, in the kernels' float32
arithmetic but without the card's fused multiply-adds).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["disp_grad_error", "line_noise", "nuts_by_path"]

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


def disp_grad_error(device, seed=0, plain=False):
    """{shape_inv: (max error / max |gradient|, median relative error over
    the genes, loss error in nats)} of the fused likelihood's dispersion
    gradient (``plain``: the plain path's NB element, the models'
    ``NegativeBinomial`` log-prob summed, in float32) against float64, nu
    drawn around the prior mean, the phases at their prior."""
    from velocycle_tpu_torch.core import distributions as dist
    from velocycle_tpu_torch.models.basis import expression_basis
    from velocycle_tpu_torch.ops import nb_kernels as K

    d = _data(True, device).data
    zeta = expression_basis(d, torch.atan2(d.phixy_prior[:, 1],
                                           d.phixy_prior[:, 0]))
    rng = np.random.default_rng(seed)
    nu = d.mu_nu + torch.as_tensor(rng.normal(0, 0.1, tuple(d.mu_nu.shape)),
                                   dtype=torch.float32, device=device)
    cf = d.count_factor
    out = {}
    for si in SHAPE_INVS:
        r = si * torch.exp(torch.linspace(-0.3, 0.3, d.S.shape[0],
                                          device=device))
        r32 = r.clone().requires_grad_(True)
        if plain:
            elog = nu @ zeta.T + cf
            loss = dist.NegativeBinomial(
                mean=torch.exp(elog), dispersion=r32[:, None]
            ).log_prob(d.S.float()).sum()
        else:
            loss = K.nb_loglik_fused(d.S, nu, zeta, cf, r32,
                                     lgamma_k_sum=d.lgamma_k_sum)
        (g32,) = torch.autograd.grad(loss, r32)
        r64 = r.double().requires_grad_(True)
        ref = K.nb_loglik_reference(d.S.double(), nu.double(), zeta.double(),
                                    cf.double(), r64)
        (g64,) = torch.autograd.grad(ref, r64)
        err = (g32.double() - g64).abs()
        out[si] = (float(err.max() / g64.abs().max()),
                   float((err / g64.abs()).median()),
                   float(loss.detach()) - float(ref.detach()))
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
        for si, (mx, med, dl) in res.items():
            print(f"[nb_noise] {path} dispersion gradient at shape_inv "
                  f"{si:g}: error against float64 {mx:.2e} of the largest, "
                  f"median over genes {med:.2e}; loss {dl:+.2e} nats "
                  f"({where})")
    print(f"[nb_noise] dispersion gradient error at shape_inv 1e-5 / 1e-3: "
          f"{errs[1e-5][0] / errs[1e-3][0]:.2f}x (largest), "
          f"{errs[1e-5][1] / errs[1e-3][1]:.2f}x (median) ({where})")
    if args.nuts:
        for name, (acc, rhat, ess, dt) in nuts_by_path(args.device).items():
            print(f"[nb_noise] MCMCFitModel (b) {name}: accept {acc:.4f}, max "
                  f"split R-hat by site {rhat}, min ESS {ess:.1f}, {dt:.1f} s "
                  f"({where})")


if __name__ == "__main__":
    main()
