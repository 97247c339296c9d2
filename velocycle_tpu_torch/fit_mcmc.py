"""The sampling fit drivers: `MCMCFitModel` and `SMCFitModel` (port of
`velocycle_tpu/fit_mcmc.py`).

The NUTS/HMC and SMC engines (`infer/mcmc.py`, `infer/smc.py`) with the
SVI drivers' experience:
conditioning, one ``.run()``, posterior containers (`Cycle`, `Phases`,
`AngularSpeed`), a posterior-sample dict with the ``ElogS`` recompute,
`period_hours`, and convergence diagnostics.  The warm start:

  1. a short SVI fit locates the posterior (thousands of prior sds from any
     prior draw: Nc x Ng observations);
  2. guide locs become `init_values`, and the posterior GEOMETRY becomes a
     preconditioner: guide scales for real sites, the Hessian diagonal at
     the SVI point (a batch of Hessian-vector probes) for the rest, and
     per-row Hessian blocks for ``block_sites`` whose rows are
     conditionally independent (genes given phases);
  3. chains start over-dispersed in whitened units and NUTS adapts from a
     sane metric.

The fused NB likelihood has no second derivative (`ops/nb_kernels.py`), so
on fused data the warm start takes its Hessian probes through the plain
model path on the same counts (`_plain_view`) while the chains (or the
particles) run fused.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .containers import AngularSpeed, Cycle, Phases
from .core import handlers
from .infer import SVI, Trace_ELBO, clipped_adam
from .infer.mcmc import MCMC, block_precondition, init_model
from .infer.smc import SMC, BridgedSMC
from .models.basis import expression_basis, omega_basis
from .parallel.mesh import refuse_other_axes

__all__ = ["MCMCFitModel", "SMCFitModel"]

# Hessian-vector probes per batched evaluation in the warm start
_PROBE_CHUNK = 64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _plain_view(data):
    """The same data on the plain model path: float32 counts (the plain NB
    log-prob's), no precomputed ``lgamma_k_sum`` (the fused kernels')."""
    if not data.use_fused_nb:
        return data
    counts = {k: getattr(data, k).float() for k in ("S", "U")
              if hasattr(data, k)}
    return data.replace(use_fused_nb=False, lgamma_k_sum=None, **counts)


def _chains_only(mesh, axis):
    """Refuse a mesh that splits anything but ``axis``: the warm start runs
    on the full data of every rank."""
    if mesh is not None:
        refuse_other_axes(mesh, axis, "the fit models")


class _SamplingFitModel:
    """Shared conditioning / warm start / extraction machinery."""

    def __init__(self, metaparams, condition_on=None, svi_steps=2000,
                 block_sites=("nu",), hessian_dim_cap=4096):
        device = metaparams.data.device
        self.condition = {
            k: torch.as_tensor(_np(v), dtype=torch.float32, device=device)
            for k, v in (condition_on or {}).items()
        }
        self.condition_on = list(self.condition)
        # shape_inv conditioned => its gradient is discarded; run the fused
        # kernels without the digamma chain (see fit._FitModel)
        if (
            "shape_inv" in self.condition
            and metaparams.data.use_fused_nb
            and metaparams.data.disp_grad
        ):
            metaparams = dataclasses.replace(
                metaparams, data=metaparams.data.replace(disp_grad=False)
            )
        self.metaparams = metaparams
        model, guide = metaparams.model_fn, metaparams.guide_fn
        if self.condition:
            model = handlers.condition(model, data=self.condition)
            guide = handlers.block(guide, hide=self.condition_on)
        self.model = model
        self.guide = guide
        self.svi_steps = svi_steps
        self.block_sites = tuple(block_sites)
        self.hessian_dim_cap = hessian_dim_cap
        self.svi_params = None
        self.posterior = None
        self.cycle_fit = None
        self.phase_fit = None
        self.speed_fit = None

    # -- warm start --------------------------------------------------------
    def _warm_start(self, seed):
        """SVI locate + geometry: returns (init_values, preconditioner).

        Sites whose guide exposes ``{site}_locs`` get warm-started there;
        real-supported sites with ``{site}_scales`` get a diagonal metric
        from the guide; everything else gets the exact local curvature
        (Hessian diagonal at the SVI point, probes batched through
        `torch.func.vmap` of a forward-over-reverse HVP), capped at
        variance 1.0 so flat directions cannot jitter inits into
        numerically degenerate regions.  Sites named in ``block_sites`` with
        shape (B, k) get per-row (k, k) Hessian blocks, exact when rows are
        conditionally independent given the conditioned sites.  On fused
        data the probes run on its plain view (the fused likelihood has no
        second derivative).
        """
        data = self.metaparams.data
        if self.svi_steps:
            svi = SVI(self.model, self.guide, clipped_adam(
                lr=0.05, betas=(0.80, 0.99),
                lrd=0.1 ** (1.0 / max(self.svi_steps, 1)),
            ), Trace_ELBO())
            state, losses = svi.run(seed, self.svi_steps, data)
            params = {k: _np(v) for k, v in svi.get_params(state).items()}
            self.svi_params = params
            self.svi_losses = np.asarray(losses)
        else:
            params = {}

        info = init_model(self.model, data, seed=handlers.fold_in(seed, 7))
        init_values = {name: params[f"{name}_locs"] for name in info.site_meta
                       if f"{name}_locs" in params}
        if not params:
            return init_values or None, None

        info = init_model(self.model, _plain_view(data),
                          init_values=init_values or None,
                          seed=handlers.fold_in(seed, 8))
        sizes = {n: meta[1] for n, meta in info.site_meta.items()}
        shapes = {n: meta[0] for n, meta in info.site_meta.items()}
        constraints = {n: meta[2] for n, meta in info.site_meta.items()}
        dim = sum(sizes.values())

        pre = {}
        need_hdiag = []
        offset = 0
        offsets = {}
        for name in sizes:
            offsets[name] = offset
            offset += sizes[name]
            if name in self.block_sites and len(shapes[name]) == 2:
                continue  # handled by block probes below
            scales = params.get(f"{name}_scales")
            if scales is not None and constraints[name].name == "real":
                pre[name] = np.asarray(scales, np.float64).reshape(-1) ** 2
            else:
                need_hdiag.append(name)

        u0 = info.init_u
        grad = torch.func.grad(info.potential_fn)

        def hvp(v):
            return torch.func.jvp(grad, (u0,), (v,))[1]

        def probe(fn, probes):
            with torch.no_grad():
                return _np(torch.func.vmap(fn, chunk_size=_PROBE_CHUNK)(
                    probes))

        if need_hdiag and dim <= self.hessian_dim_cap:
            eye = torch.eye(dim, device=u0.device)
            hd = probe(lambda v: torch.sum(v * hvp(v)), eye)
            for name in need_hdiag:
                o, s = offsets[name], sizes[name]
                pre[name] = 1.0 / np.maximum(hd[o:o + s], 1.0)

        for name in self.block_sites:
            if name not in sizes or len(shapes[name]) != 2:
                continue
            B, k = shapes[name]
            probes = np.zeros((k, dim), np.float32)
            o = offsets[name]
            for j in range(k):
                probes[j, o + j:o + sizes[name]:k] = 1.0
            cols = probe(hvp, torch.as_tensor(probes, device=u0.device))
            blocks = cols[:, o:o + sizes[name]].reshape(k, B, k)
            H = np.transpose(blocks, (1, 2, 0)).astype(np.float64)
            H = 0.5 * (H + np.transpose(H, (0, 2, 1)))
            # PD guard via eigenvalue clamp: Hessian blocks at an SVI point
            # can have flat or slightly indefinite directions; clamp the
            # eigenvalues to >= 1.0 (whitened variance <= 1.0, the diagonal
            # path's cap)
            w, V = np.linalg.eigh(H)
            w = np.maximum(w, 1.0)
            pre[name] = np.einsum("bik,bk,bjk->bij", V, 1.0 / w, V)

        return init_values or None, pre or None

    # -- extraction --------------------------------------------------------
    def _extract(self, samples):
        """Posterior containers from a {site: (draws, ...)} dict, mirroring
        the SVI drivers' extraction."""
        mp = self.metaparams
        post = dict(samples)

        if "nu" in samples:
            nu = samples["nu"]
            cycle = Cycle.from_array(
                nu.mean(0).T, nu.std(0).T, mp.cycle_prior.genes
            )
            if "shape_inv" in samples:
                cycle.set_disp(samples["shape_inv"].mean(0))
            if "log_gamma" in samples:
                cycle.set_log_gammas(samples["log_gamma"].mean(0))
            if "log_beta" in samples:
                cycle.set_log_betas(samples["log_beta"].mean(0))
            self.cycle_fit = cycle

        cells = mp.phase_prior.phi_xy.columns
        if "phi_xy" in samples:
            xy = samples["phi_xy"]                  # (draws, Nc, 2)
            ang = np.arctan2(xy[..., 1], xy[..., 0])
            mean_ang = np.angle(np.exp(1j * ang).mean(0))
            self.phase_fit = Phases.from_angles(mean_ang, cell_names=cells)
            post["phi"] = ang
        elif "phi" in samples:
            ang = samples["phi"].reshape(samples["phi"].shape[0], -1)
            mean_ang = np.angle(np.exp(1j * ang).mean(0))
            self.phase_fit = Phases.from_angles(mean_ang, cell_names=cells)
        else:
            self.phase_fit = mp.phase_prior.copy()

        if "nu_omega" in samples and mp.speed_prior is not None:
            nw = samples["nu_omega"]
            self.speed_fit = AngularSpeed.from_array(
                nw.mean(0).T, nw.std(0).T,
                condition_names=mp.speed_prior.conditions,
                num_coeffs=nw.shape[-1],
            )

        # point-estimate ElogS from posterior means, as the SVI driver does
        # from guide locs
        if "nu" in samples and self.phase_fit is not None:
            dev = mp.data.device
            f32 = dict(dtype=torch.float32, device=dev)
            with torch.no_grad():
                nu_mean = torch.as_tensor(samples["nu"].mean(0), **f32)
                phi = torch.as_tensor(np.asarray(self.phase_fit.phis), **f32)
                zeta = expression_basis(mp.data, phi)
                base = nu_mean @ zeta.T
                if "delta_nu" in samples:
                    base = base + torch.einsum(
                        "bg,bc->gc",
                        torch.as_tensor(samples["delta_nu"].mean(0), **f32),
                        mp.data.Db,
                    )
                cf = mp.data.count_factor
                post["ElogS"] = _np(base + cf[None, :])
                post["ElogS2"] = _np(base + torch.mean(cf))
        self.posterior = post

    def period_hours(self, n_grid=1000):
        """Cell-cycle period per condition from the posterior-mean omega
        coefficients (same statistic as `fit.VelocityFitModel`)."""
        if self.speed_fit is None:
            raise ValueError("no nu_omega site in the posterior")
        mp = self.metaparams
        if mp.basis_kind == "fourier":
            grid = np.linspace(0, 2 * np.pi, n_grid, endpoint=False)
        else:
            lo, hi = mp.spline_domain
            grid = np.linspace(lo, hi, n_grid)
        zeta_w = _np(omega_basis(mp.data, torch.as_tensor(
            grid, dtype=torch.float32, device=mp.data.device)))
        omega = self.speed_fit.means_array @ zeta_w.T
        return np.trapezoid(1.0 / omega, grid, axis=-1)


class MCMCFitModel(_SamplingFitModel):
    """NUTS/HMC driver with SVI warm start and automatic preconditioning.

    Example::

        fm = MCMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                          num_chains=8)
        fm.run(0)
        fm.cycle_fit          # posterior Cycle (nu mean/sd, dispersion)
        fm.posterior["nu"]    # (chains*samples, Ng, Nh) draws
        fm.diagnostics        # accept rate, max split-Rhat, min/med ESS
    """

    def __init__(self, metaparams, condition_on=None, kernel="nuts",
                 num_warmup=400, num_samples=500, num_chains=4,
                 max_depth=6, step_size=0.1, init_jitter=2.0,
                 svi_steps=2000, block_sites=("nu",), **kwargs):
        super().__init__(metaparams, condition_on, svi_steps, block_sites)
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.max_depth = max_depth
        self.step_size = step_size
        self.init_jitter = init_jitter
        self.mcmc_kwargs = kwargs
        self.mcmc = None
        self.diagnostics = None

    def run(self, seed=0, mesh=None, chain_axis="chains"):
        """Warm start, then the chains, from the integer ``seed``.  With
        ``mesh=`` every rank runs the same warm start on the full data and
        its share of the chains (`MCMC.run`); the mesh's other axes must
        have one rank each."""
        _chains_only(mesh, chain_axis)
        init_values, pre = self._warm_start(handlers.fold_in(seed, 0))
        self.mcmc = MCMC(
            self.model, kernel=self.kernel, num_warmup=self.num_warmup,
            num_samples=self.num_samples, num_chains=self.num_chains,
            max_depth=self.max_depth, step_size=self.step_size,
            init_values=init_values, preconditioner=pre,
            init_jitter=self.init_jitter, **self.mcmc_kwargs,
        )
        self.mcmc.run(handlers.fold_in(seed, 1), self.metaparams.data,
                      mesh=mesh, chain_axis=chain_axis)

        by_chain = self.mcmc.get_samples(group_by_chain=True)
        flat = {k: v.reshape((-1,) + v.shape[2:])
                for k, v in by_chain.items()}
        self._extract(flat)

        summ = self.mcmc.summary()
        rhat = np.concatenate(
            [v["rhat"].reshape(-1) for v in summ.values()]
        )
        ess = np.concatenate([v["ess"].reshape(-1) for v in summ.values()])
        self.summary = summ
        self.diagnostics = {
            "accept_rate": self.mcmc.accept_rate(),
            "max_split_rhat": float(np.nanmax(rhat)),
            "min_ess": float(np.nanmin(ess)),
            "median_ess": float(np.nanmedian(ess)),
        }
        return self


class SMCFitModel(_SamplingFitModel):
    """Adaptive-tempering SMC driver with the same extraction surface, plus
    the model-evidence estimate SMC uniquely provides.

    Two tempering paths:

    * ``svi_steps=0`` (default): prior-to-posterior likelihood tempering
      (`infer.smc.SMC`).  Exact, but the stage count grows with data size
      (posterior concentration).
    * ``svi_steps>0``: VARIATIONAL-BRIDGE tempering
      (`infer.smc.BridgedSMC`): a short SVI fit locates the posterior, the
      preconditioner NUTS uses whitens it, and the particles anneal from
      the normalized Gaussian start N(0, I) to the posterior.  The stage
      count follows how non-Gaussian the posterior is, not Ng x Nc: the
      path that scales.

    Example::

        fm = SMCFitModel(mp, condition_on={...}, num_particles=512,
                         svi_steps=1000)
        fm.run(0)
        fm.log_evidence       # log Z estimate
        fm.cycle_fit          # posterior Cycle from the particle cloud
    """

    def __init__(self, metaparams, condition_on=None, num_particles=512,
                 num_moves=3, target_ess=0.5, max_stages=200,
                 svi_steps=0, block_sites=("nu",), **kwargs):
        super().__init__(metaparams, condition_on, svi_steps, block_sites)
        self.num_particles = num_particles
        self.num_moves = num_moves
        self.target_ess = target_ess
        self.max_stages = max_stages
        self.smc_kwargs = kwargs
        self.smc = None
        if not svi_steps:
            self.smc = SMC(self.model, num_particles=num_particles,
                           num_moves=num_moves, target_ess=target_ess,
                           max_stages=max_stages, **kwargs)
        self.log_evidence = None
        self.temperature_schedule = None

    def run(self, seed=0, mesh=None, particle_axis="particles"):
        """Temper from the integer ``seed`` (the bridge after its warm
        start).  With ``mesh=`` the particles are split over
        ``particle_axis`` (`SMC.run`), the warm start repeated on every
        rank."""
        _chains_only(mesh, particle_axis)
        if self.svi_steps:
            k_warm = handlers.fold_in(seed, 0)
            init_values, pre = self._warm_start(k_warm)
            info = init_model(self.model, self.metaparams.data,
                              init_values=init_values,
                              seed=handlers.fold_in(k_warm, 11))
            # Always recenter, even with an empty preconditioner (possible
            # when dim > hessian_dim_cap and the guide exposes no *_scales):
            # block_precondition's transform applies the +init_u offset, so
            # the N(0, I) bridge start sits at the SVI mode instead of the
            # origin of raw unconstrained coordinates (where the bridge
            # would exhaust max_stages).
            info = block_precondition(info, pre or {})
            self.smc = BridgedSMC(
                info, num_particles=self.num_particles,
                num_moves=self.num_moves, target_ess=self.target_ess,
                max_stages=self.max_stages, **self.smc_kwargs,
            )
            self.smc.run(handlers.fold_in(seed, 1), mesh=mesh,
                         particle_axis=particle_axis)
        else:
            self.smc.run(seed, self.metaparams.data, mesh=mesh,
                         particle_axis=particle_axis)
        self._extract(self.smc.get_samples())
        self.log_evidence = self.smc.log_evidence()
        self.temperature_schedule = self.smc.temperature_schedule
        return self
