"""The fit classes of both stages (port of `_FitModel`, `PhaseFitModel` and
`VelocityFitModel` of `velocycle_tpu/fit.py`).

Construct with metaparameters and an optional ``condition_on`` dict (the
velocity stage conditions on the phase stage's point estimates), call
``.fit(...)``, read back the posterior `Cycle`, `Phases` (and
`AngularSpeed`) and a dict of posterior draws.  Conditioning on
``shape_inv`` turns the fused kernels' dispersion gradient off
(``disp_grad=False``), and posterior draws replay through the plain model
path even when the fit ran fused, so the sites the reference's Predictive
exposes are all present.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .containers import AngularSpeed, Cycle, Phases
from .core import handlers
from .infer import SVI, Trace_ELBO, clipped_adam
from .infer.predictive import Predictive
from .models.basis import expression_basis, omega_basis

__all__ = ["PhaseFitModel", "VelocityFitModel"]


def _np(x):
    return x.detach().cpu().numpy()


def _phases_from_params(p, mp):
    """Posterior Phases from whichever phi parametrization the fit used:
    ``phixy_locs`` (Fourier, "xy"), ``phi_locs`` (wrapped or spline), or
    the prior unchanged when phi was conditioned."""
    cells = mp.phase_prior.phi_xy.columns
    if "phixy_locs" in p:
        return Phases.from_array(p["phixy_locs"].T, cell_names=cells)
    if "phi_locs" in p:
        return Phases.from_angles(np.asarray(p["phi_locs"]).reshape(-1),
                                  cell_names=cells)
    return mp.phase_prior.copy()


def _has_phi_xy(mp):
    """Whether the models sample the phi_xy site: the Fourier basis with
    the "xy" parametrization."""
    return mp.basis_kind == "fourier" and mp.phi_parametrization != "wrapped"


class _FitModel:
    """Shared conditioning / SVI / predictive machinery."""

    def __init__(self, metaparams, condition_on=None, early_exit=False,
                 get_posterior=True, num_samples=500, n_per_bin=500):
        device = metaparams.data.device
        self.condition = {
            k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v), dtype=torch.float32,
                               device=device)
            for k, v in (condition_on or {}).items()
        }
        self.condition_on = list(self.condition)
        # shape_inv conditioned => its gradient is discarded; run the fused
        # kernels without the digamma chain
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
        self.early_exit = early_exit
        self.get_posterior = get_posterior
        self.num_samples = num_samples
        self.n_per_bin = n_per_bin
        self.posterior = None
        self.losses = None
        self.params = None
        self.state = None
        self.svi = None

    def fit(self, optimizer=None, loss=None, num_steps=1000, seed=0,
            log_every=0, verbose=False, callback=None, store_output=False,
            intermediate_output_step_size=100, store_num_samples=50,
            live_plot=False):
        """Run SVI and extract posterior estimates.

        Args:
          optimizer: defaults to the reference tutorials' ClippedAdam (lr
            0.05, betas (0.80, 0.99), lrd decaying to 0.1x over
            ``num_steps``).
          loss: ELBO object (default `Trace_ELBO()`).
          num_steps: SVI steps (>= 1).
          seed: root integer seed of the fit's random draws.
          log_every: print the loss at chunk ends when non-zero.
          verbose: accepted for the reference's callers; as in the JAX
            package's ``fit`` it prints nothing beyond what ``log_every``
            asks for.
          callback: ``callback(step, state, last_loss)`` at chunk ends.
          store_output: keep a posterior snapshot every
            ``intermediate_output_step_size`` steps (chunk ends) in
            ``self.intermediate_output``: ``store_num_samples`` draws of the
            latent sites (no ElogS/ElogU), seeded by the step.
          live_plot: redraw the live ELBO curve (`plots.live_plot`, for
            notebooks) at every chunk end, chunks of
            ``intermediate_output_step_size`` steps.
        """
        if optimizer is None:
            optimizer = clipped_adam(
                lr=0.05, betas=(0.80, 0.99),
                lrd=0.1 ** (1.0 / max(num_steps, 1)),
            )
        self.svi = SVI(self.model, self.guide, optimizer,
                       loss or Trace_ELBO())
        self.intermediate_output = []
        loss_history = []
        chunk_size = None
        if store_output or live_plot:
            chunk_size = min(intermediate_output_step_size, num_steps)
            user_callback = callback

            def callback(step, state, last_loss):
                loss_history.append(float(last_loss))
                if store_output:
                    params = {k: _np(v)
                              for k, v in self.svi.get_params(state).items()}
                    self.intermediate_output.append(self._snapshot_posterior(
                        params, step, store_num_samples))
                if live_plot:
                    from .plots import live_plot as _live_plot

                    _live_plot({"ELBO": loss_history})
                if user_callback is not None:
                    user_callback(step, state, last_loss)

        self.state, self.losses = self.svi.run(
            seed, num_steps, self.metaparams.data,
            log_every=log_every, callback=callback,
            early_exit=self.early_exit, chunk_size=chunk_size,
        )
        self.params = {
            k: _np(v) for k, v in self.svi.get_params(self.state).items()
        }
        self._extract()
        if self.get_posterior:
            self.posterior = self._build_posterior(
                seed=handlers.fold_in(seed, 1)
            )
        return self

    def _extract(self):
        raise NotImplementedError

    def _posterior_sites(self):
        raise NotImplementedError

    def sample_posterior(self, num_samples=1, rs=None, seed=1, data=None,
                         params=None):
        """Guide->model replayed draws of the requested sites at ``params``
        (default: the fitted params) on ``data`` (default: the fit's):
        {site: (num_samples, ...) numpy array}.  Draws replay through the
        plain model path even for fused data, so every site is present."""
        data = self.metaparams.data if data is None else data
        data = data.replace(use_fused_nb=False)
        constrained = {
            k: torch.as_tensor(v, dtype=torch.float32, device=data.device)
            for k, v in (self.params if params is None else params).items()
        }
        pred = Predictive(
            self.model, guide=self.guide, params=constrained,
            num_samples=num_samples, return_sites=rs,
        )
        return {k: _np(v) for k, v in pred(seed, data).items()}

    def _snapshot_posterior(self, params, step, num_samples):
        """One intermediate posterior snapshot: ``num_samples`` draws of the
        latent sites (no ElogS/ElogU), seeded by ``step``."""
        sites = [s for s in self._posterior_sites()
                 if s not in ("ElogS", "ElogU")]
        snap = self.sample_posterior(num_samples=num_samples, rs=sites,
                                     seed=step, params=params)
        snap["step"] = step
        return snap

    def _build_posterior(self, seed):
        rs = self._posterior_sites()
        n = self.num_samples
        per = min(self.n_per_bin, n)
        chunks = []
        drawn = 0
        while drawn < n:
            take = min(per, n - drawn)
            chunks.append(self.sample_posterior(
                num_samples=take, rs=rs, seed=handlers.fold_in(seed, drawn)
            ))
            drawn += take
        return {
            k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in chunks[0]
        }

    # -- debugging ---------------------------------------------------------
    def _format_shapes(self, fn):
        tr = handlers.trace(handlers.seed(fn, 0)).get_trace(self.metaparams.data)
        return "\n".join(
            f"{site['type']:>13} {name:<20} {tuple(np.shape(site['value']))}"
            for name, site in tr.items()
        )

    def check_model(self, raise_on_error=False):
        """Print the model's trace shapes and verify its plate/log_prob
        shape consistency (`handlers.check_plate_shapes`); returns the
        problems found (empty = clean)."""
        print(self._format_shapes(self.model))
        return self._check_plates(self.model, raise_on_error)

    def check_guide(self, raise_on_error=False):
        """As `check_model`, for the guide."""
        print(self._format_shapes(self.guide))
        return self._check_plates(self.guide, raise_on_error)

    def _check_plates(self, fn, raise_on_error):
        problems = handlers.check_plate_shapes(fn, self.metaparams.data)
        for p in problems:
            print(f"PLATE CHECK: {p}")
        if problems and raise_on_error:
            raise ValueError("\n".join(problems))
        return problems


class PhaseFitModel(_FitModel):
    """Manifold-learning (phase-stage) fit.

    After ``.fit()``:
      * ``cycle_fit``  — posterior `Cycle` (nu means/stds, NB dispersion)
      * ``phase_fit``  — posterior `Phases` (phi_xy point estimates)
      * ``posterior``  — sampled sites + point-estimate ``ElogS``/``ElogS2``
    """

    def _extract(self):
        mp = self.metaparams
        p = self.params
        nu_locs = p["nu_locs"]          # (Ng, Nh)
        nu_scales = p["nu_scales"]
        cycle = Cycle.from_array(nu_locs.T, nu_scales.T, mp.cycle_prior.genes)
        if "shape_inv_locs" in p:
            cycle.set_disp(p["shape_inv_locs"])
        phases = _phases_from_params(p, mp)
        self.cycle_fit = cycle
        self.phase_fit = phases
        self.fourier_coef = nu_locs.T
        self.fourier_coef_sd = nu_scales.T
        self.phis_fit = phases.phi_xy_array.T
        self.disp = p.get("shape_inv_locs")
        self.delta_nus = p.get("delta_nu_locs")
        if mp.gene_selection_model == "lba":
            self.periodic_logits = p.get("logit_locs")
        # reference-compatible aliases
        self.cycle_pyro = cycle
        self.phase_pyro = phases

    def _posterior_sites(self):
        mp = self.metaparams
        rs = ["nu", "phi", "zeta"]
        if _has_phi_xy(mp):
            rs.insert(1, "phi_xy")
        if mp.noisemodel == "NegativeBinomial":
            rs.append("shape_inv")
        if mp.with_delta_nu and "delta_nu" not in self.condition_on:
            rs.append("delta_nu")
        if mp.gene_selection_model == "lba":
            rs += ["periodic", "periodic_prob"]
        return [s for s in rs if s not in self.condition_on]

    @torch.no_grad()
    def _build_posterior(self, seed):
        out = super()._build_posterior(seed)
        data = self.metaparams.data
        dev = data.device
        # point-estimate ElogS with raw and averaged count factors
        nu = torch.as_tensor(self.params["nu_locs"], device=dev)
        phi = torch.as_tensor(self.phase_fit.phis, dtype=torch.float32,
                              device=dev)
        base = nu @ expression_basis(data, phi).T
        if data.with_delta_nu and self.delta_nus is not None:
            base = base + torch.as_tensor(self.delta_nus, device=dev).T @ data.Db
        cf = data.count_factor
        out["ElogS"] = _np(base + cf[None, :])
        out["ElogS2"] = _np(base + cf.mean())
        if data.gene_selection_model == "lba" and "periodic" in out:
            self.periodic = out["periodic"].mean(0)
        return out

    def polar_plot(self, **kwargs):
        """`plots.pplot` of this fit; returns the polar axis."""
        from .plots import pplot

        return pplot(self, **kwargs)


class VelocityFitModel(_FitModel):
    """Velocity-learning fit.

    After ``.fit()``:
      * ``cycle_fit`` — `Cycle` with ``log_gammas``/``log_betas``/``disp``
      * ``phase_fit`` — `Phases`
      * ``speed_fit`` — posterior `AngularSpeed` (condition-level omega
        Fourier coefficients)
      * ``posterior`` — sampled sites, ``ElogS``/``ElogU`` among them
    """

    def _extract(self):
        mp = self.metaparams
        p = self.params
        Ng, Nx, Nhw = mp.Ng, mp.Nx, mp.Nhw
        if mp.model_type == "lrmn":
            # the joint low-rank MVN packs [log_gamma (Ng), nu_omega
            # (Nx*Nhw)]; marginal sds from the diagonal of W W^T + D
            loc = p["loc"]
            sd = np.sqrt((p["cov_factor"] ** 2).sum(-1) + p["cov_diag"])
            log_gamma, log_gamma_sd = loc[:Ng], sd[:Ng]
            nuw = loc[Ng:].reshape(Nx, Nhw)
            nuw_sd = sd[Ng:].reshape(Nx, Nhw)
            self.rho_real = p.get("rho_real_loc")
        else:
            log_gamma = p["log_gamma_locs"]
            log_gamma_sd = p["log_gamma_scales"]
            nuw = p["nu_omega_locs"]
            nuw_sd = p["nu_omega_scales"]
            self.rho_real = None

        cycle = Cycle.from_array(
            p["nu_locs"].T, p["nu_scales"].T, mp.cycle_prior.genes
        )
        cycle.set_log_gammas(log_gamma)
        cycle.set_log_betas(p["log_beta_locs"])
        if "shape_inv_locs" in p:
            cycle.set_disp(p["shape_inv_locs"])
        self.cycle_fit = cycle
        self.log_gamma_sd = log_gamma_sd
        self.log_beta_sd = p.get("log_beta_scales")
        self.phase_fit = _phases_from_params(p, mp)
        self.speed_fit = AngularSpeed.from_array(
            nuw.T, nuw_sd.T,
            condition_names=mp.speed_prior.conditions,
            num_coeffs=Nhw,
        )
        self.delta_nus = p.get("delta_nu_locs")
        # reference-compatible aliases
        self.cycle_pyro = cycle
        self.phase_pyro = self.phase_fit
        self.speed_pyro = self.speed_fit

    def _posterior_sites(self):
        mp = self.metaparams
        rs = [
            "log_gamma", "log_beta", "nu_omega", "gamma", "nu",
            "phi", "zeta", "zeta_dphi", "zeta_omega", "omega",
            "ElogS", "ElogU",
        ]
        if _has_phi_xy(mp):
            rs.insert(5, "phi_xy")
        if mp.noisemodel == "NegativeBinomial":
            rs.append("shape_inv")
        if mp.with_delta_nu and "delta_nu" not in self.condition_on:
            rs.append("delta_nu")
        if mp.model_type == "lrmn":
            rs.append("rho_real")
        return [s for s in rs if s not in self.condition_on]

    def period_hours(self, n_grid=1000):
        """Cell-cycle period per condition: the trapezoid integral of
        1/omega over the manifold on an ``n_grid`` grid (the statistic the
        reference tutorials compute as ``trapz(1/omega)``): over the circle,
        or over the spline domain, ends included (a transit time in domain
        units)."""
        mp = self.metaparams
        if mp.basis_kind == "fourier":
            grid = np.linspace(0, 2 * np.pi, n_grid, endpoint=False)
        else:
            lo, hi = mp.spline_domain
            grid = np.linspace(lo, hi, n_grid)
        zeta_w = _np(omega_basis(
            self.metaparams.data, torch.as_tensor(grid, dtype=torch.float32)
        ))
        omega = self.speed_fit.means_array @ zeta_w.T   # (Nx, n_grid)
        return np.trapezoid(1.0 / omega, grid, axis=-1)
