"""The program's side of a phase-stage SVI cell.

Set-up builds the fit through the port's public entry points as a user's
script does: the AnnData into `preprocess_for_phase_estimation` with the
configuration's Cycle prior (the trivial one, or the notebook's from the
counts: `inputs.nu_prior`) and the phase prior at the cells' angles, a
`PhaseFitModel` with the configuration's sites pinned (``condition_on``),
and its step built as `PhaseFitModel.fit` builds it
(`SVI` over the fit's model and guide, the tutorials' ClippedAdam, a
`Trace_ELBO`), then `svi.init`.  The first steps run through the
window's own call, `SVI.update_chunk`, on the same state the window
continues; they give the readings that the check holds against the plain
reference (`reference.phase_svi`).  Nothing here calls `fit.fit`, whose
posterior draws are no part of the loop.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .reference.phase_svi import Readings


# the shape of each site a configuration may pin, from the fit's data
_SITES = {"delta_nu": lambda d: (d.Nb, d.Ng)}


class ProgramRun:
    def __init__(self, cfg, mix, seed, device, spans):
        from velocycle_tpu_torch import (
            Cycle, PhaseFitModel, Phases, make_design_matrix,
            preprocess_for_phase_estimation,
        )
        from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam

        from . import inputs

        if mix["stage"] != "phase":
            raise ValueError("ProgramRun runs the phase stage")
        data, model = cfg["data"], cfg["model"]
        H = model["harmonics"]
        self.chunk = int(mix["chunk"])
        with spans("inputs"):
            made = inputs.make(data, seed, device)
            angles = made.angles.double().cpu().numpy()
            prior = (inputs.nu_prior(made, H)
                     if model.get("nu_prior") == "log_mean" else None)
            adata = inputs.to_adata(made)
            del made
        genes, cells = list(adata.var.index), list(adata.obs.index)
        with spans("preprocess"):
            design = (make_design_matrix(adata, "batch")
                      if data.get("batches") else None)
            cycle = (Cycle.trivial_prior(genes, harmonics=H) if prior is None
                     else Cycle.from_array(*(t.cpu().numpy() for t in prior),
                                           gene_names=genes))
            mp = preprocess_for_phase_estimation(
                adata, cycle,
                Phases.from_angles(angles, model["phase_concentration"],
                                   cell_names=cells),
                design_mtx=design, n_harmonics=H,
                with_delta_nu=bool(model.get("with_delta_nu",
                                             data.get("batches"))),
                mu_dnu=model["mu_dnu"], sd_dnu=model["sd_dnu"],
                gamma_alpha=model["gamma_alpha"],
                gamma_beta=model["gamma_beta"],
                use_fused_nb=bool(mix["use_fused_nb"]), device=device)
            if mp.data.S.is_cuda:
                torch.cuda.synchronize()
        del adata
        self.data = mp.data
        self.pinned = {k: torch.full(_SITES[k](mp.data), float(v),
                                     device=device)
                       for k, v in model.get("condition_on", {}).items()}
        o = mix["optimizer"]
        with spans("build"):
            self.fit = PhaseFitModel(mp, condition_on=self.pinned or None,
                                     get_posterior=False)
            self.svi = SVI(self.fit.model, self.fit.guide, clipped_adam(
                lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                clip_norm=o["clip_norm"],
                lrd=0.1 ** (1.0 / o["fit_steps"])), Trace_ELBO())
            self.state = self.svi.init(seed, self.data)

    def first_steps(self, steps):
        """Run the first ``steps`` steps through `update_chunk` and read
        them: each step's loss, the norm of the gradient the optimizer gets
        in step 1 (autograd hooks on the leaves, removed after it), and the
        norm of each leaf's change after step 1 and once the last step has
        run."""
        params = self.state.params
        start = {k: v.detach().clone() for k, v in params.items()}
        first = {}
        hooks = [p.register_hook(
            lambda g, k=k: first.__setitem__(k, g.detach().double().norm()))
            for k, p in params.items()]
        try:
            self.state, l1 = self.svi.update_chunk(self.state, 1, self.data)
        finally:
            for h in hooks:
                h.remove()
        def change():
            return {k: float((v.detach() - start[k]).double().norm())
                    for k, v in self.state.params.items()}

        first_change = change()
        self.state, rest = self.svi.update_chunk(self.state, steps - 1,
                                                 self.data)
        losses = torch.cat([l1, rest]).double().cpu().tolist()
        return Readings(losses, {k: float(v) for k, v in first.items()},
                        change(), first_change)

    def chunks(self, n_chunks, span=None):
        """``n_chunks`` chunks of the window's loop: `update_chunk`, then
        the chunk's losses read on the host as `SVI.run` reads them.  With
        ``span`` (the traced run), the same loop written out: each
        `SVI.update` that `update_chunk` loops over in a span
        ``svi.update``, each read in a span ``chunk.read``.  Returns
        (steps, non-finite losses)."""
        bad = 0
        for _ in range(n_chunks):
            if span is None:
                self.state, losses = self.svi.update_chunk(
                    self.state, self.chunk, self.data)
                bad += int((~np.isfinite(losses.cpu().numpy())).sum())
                continue
            out = []
            for _ in range(self.chunk):
                with span("svi.update"):
                    self.state, loss = self.svi.update(self.state, self.data)
                out.append(loss)
            with span("chunk.read"):
                bad += int((~np.isfinite(torch.stack(out).cpu().numpy())).sum())
        return n_chunks * self.chunk, bad

    def window(self, seconds):
        """Chunks until ``seconds`` have passed, then one sync: (steps,
        seconds from the start to that sync, non-finite losses)."""
        steps = bad = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n, b = self.chunks(1)
            steps, bad = steps + n, bad + b
        if self.data.S.is_cuda:
            torch.cuda.synchronize()
        return steps, time.perf_counter() - t0, bad

