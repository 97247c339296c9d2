"""Rank-side halves of tests/test_torch_parallel.py (not collected).

`parallel.run_ranks` pickles these functions by their import path and runs
them in spawned ranks (gloo, the CPU), so this module imports torch and the
port only: no JAX.  Each returns numpy arrays and Python numbers, which the
test compares with the JAX package's results and across the ranks.
"""
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from velocycle_tpu_torch.core import distributions as tdist
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
from velocycle_tpu_torch.infer import mcmc as TM
from velocycle_tpu_torch.infer import smc as TS
from velocycle_tpu_torch.infer.svi import init_params
from velocycle_tpu_torch.models import phase as tphase
from velocycle_tpu_torch.models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS,
)
from velocycle_tpu_torch.models import velocity as tvel
from velocycle_tpu_torch.parallel import (
    distributed, make_mesh, shard_params, shard_phase_data,
    shard_velocity_data,
)
from velocycle_tpu_torch.parallel.sharding import (
    PARAM_CELL_AXES, data_sharding_spec,
)

MODELS = {
    "phase": (tphase.phase_model, tphase.phase_guide),
    "lrmn": (tvel.velocity_model, tvel.velocity_guide_lrmn),
}


class Noise(th.Messenger):
    """The guide's reparameterized draws from given noise (tests/
    _torch_parity.py's), the per-cell noise cut to this rank's cells."""

    def __init__(self, fn, eps):
        super().__init__(fn)
        self.eps = eps

    def process_message(self, msg):
        if (msg["type"] == "sample" and msg["value"] is None
                and msg["name"] in self.eps):
            d = getattr(msg["fn"], "base", msg["fn"])
            e = self.eps[msg["name"]]
            if msg["name"] == "_lrmn_draw":
                msg["value"] = d.rsample_from(*e)
            else:
                msg["value"] = d.loc + d.scale * e


def _mesh_and_shard(tdata, device="cpu"):
    mesh = make_mesh(("cells",), device=device)
    shard = shard_velocity_data if hasattr(tdata, "U") else shard_phase_data
    return mesh, shard(tdata, mesh)


def _cells_cut(arrays, shard):
    """Per-cell arrays (leading axis Nc_global) cut to the shard's cells."""
    return {k: (torch.as_tensor(np.asarray(v), dtype=torch.float32)
                [shard.lo:shard.hi] if np.shape(v)[:1] == (shard.Nc_global,)
                else torch.as_tensor(np.asarray(v), dtype=torch.float32))
            for k, v in arrays.items()}


def _model_pair(kind, cond, shard):
    model, guide = MODELS[kind]
    if cond:
        model = th.condition(model, data=_cells_cut(cond, shard))
        guide = th.block(guide, hide=list(cond))
    return model, guide


def _gathered_cells(t, shard):
    counts = distributed.split_counts(shard.Nc_global, shard.size)
    return distributed.gather_rows(t, shard.group, counts)


def elbo_grads(kind, tdata, params, eps, cond=None):
    """The sharded loss and every param gradient at ``params`` with the
    guide's noise ``eps`` (numpy, global shapes): (loss, {param: gradient
    over all cells}, this shard's lgamma_k_sum or None)."""
    mesh, data = _mesh_and_shard(tdata)
    shard = data.shard
    model, guide = _model_pair(kind, cond, shard)
    e = {k: (tuple(torch.as_tensor(x, dtype=torch.float32) for x in v)
             if isinstance(v, tuple) else v) for k, v in eps.items()}
    e = {**e, **_cells_cut({k: v for k, v in e.items()
                            if not isinstance(v, tuple)}, shard)}
    svi = SVI(model, Noise(guide, e), None, Trace_ELBO())
    _, svi.constraints = init_params(svi.guide, 0, data)
    p = shard_params(params, mesh)
    loss, grads = svi._sharded_value_and_grad(p, 1, shard, data)
    grads = {k: torch.zeros_like(p[k]) if g is None else g
             for k, g in grads.items()}      # a param the loss does not read
    out = {k: (_gathered_cells(g, shard) if k in PARAM_CELL_AXES else g)
           for k, g in grads.items()}
    lgk = data.lgamma_k_sum
    return (float(loss), {k: g.numpy() for k, g in out.items()},
            None if lgk is None else float(lgk))


def _digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def trajectory(kind, tdata, steps, cond=None, device="cpu"):
    """``steps`` sharded SVI steps from seed 0: the losses, the per-cell
    params over all cells, a digest of the replicated params and of their
    Adam moments; at world 1 also the losses and params of ``steps``
    unsharded `SVI.update` steps from the same seed (same process, same
    threads, so bits compare)."""
    mesh, data = _mesh_and_shard(tdata, device)
    fields = VELOCITY_TENSOR_FIELDS if hasattr(tdata, "U") else \
        PHASE_TENSOR_FIELDS
    tdata = tdata.replace(**{f: getattr(tdata, f).to(data.device)
                             for f in fields if getattr(tdata, f) is not None})
    model, guide = _model_pair(kind, cond, data.shard)
    svi = SVI(model, guide, clipped_adam(), Trace_ELBO())
    state = svi.init_sharded(0, mesh, data)
    state, losses = svi.update_chunk(state, steps, data)
    rep = {k: v for k, v in state.params.items() if k not in PARAM_CELL_AXES}
    moments = {f"{m}:{k}": state.opt_state[m][k] for m in ("m", "v")
               for k in rep}
    out = {
        "losses": losses.cpu().numpy(),
        "cells": {k: _gathered_cells(v.detach(), data.shard).cpu().numpy()
                  for k, v in state.params.items() if k in PARAM_CELL_AXES},
        "replicated": _digest(rep), "moments": _digest(moments),
        "params": {k: v.detach().cpu().numpy()
                   for k, v in state.params.items()},
    }
    if dist.get_world_size() == 1:
        model, guide = _model_pair(kind, cond, data.shard)
        ref = SVI(model, guide, clipped_adam(), Trace_ELBO())
        s = ref.init(0, tdata)
        s, ref_losses = ref.update_chunk(s, steps, tdata)
        out["unsharded_losses"] = ref_losses.cpu().numpy()
        out["unsharded_params"] = {k: v.detach().cpu().numpy()
                                   for k, v in s.params.items()}
    return out


def drawn_phase_data(Ng, Nc, seed=0):
    """The phase stage's fused int16 container (host tensors) of counts
    floor(exp(N(1, 0.8^2))) and uniform phases drawn from ``seed``, through
    the public preprocessing: every rank builds the same."""
    import pandas as pd

    from velocycle_tpu_torch import (
        AnnDataLite, Cycle, Phases, preprocess_for_phase_estimation,
    )

    rng = np.random.default_rng(seed)
    counts = np.floor(np.exp(rng.normal(1.0, 0.8, (Nc, Ng)))).astype(np.int16)
    genes = [f"G{i}" for i in range(Ng)]
    cells = [f"C{i}" for i in range(Nc)]
    adata = AnnDataLite(obs=pd.DataFrame(index=cells),
                        var=pd.DataFrame(index=genes),
                        layers={"spliced": counts, "unspliced": counts})
    mp = preprocess_for_phase_estimation(
        adata, Cycle.trivial_prior(genes, harmonics=2),
        Phases.from_angles(rng.uniform(0, 2 * np.pi, Nc), cell_names=cells),
        n_harmonics=2, with_delta_nu=False, use_fused_nb=True, device="cpu")
    return mp.data


def card_trajectory(Ng, Nc, steps):
    """`trajectory` of the phase stage on the card, on `drawn_phase_data`."""
    return trajectory("phase", drawn_phase_data(Ng, Nc), steps,
                      device="cuda")


def gauss():
    th.sample("x", tdist.Normal(2.0, 3.0))


def gauss_chains(kernel, num_warmup, num_samples, num_chains, seed):
    """`gauss` with its chains split over a ("chains",) mesh: every rank's
    draws (chains, samples) and max split R-hat."""
    m = TM.MCMC(gauss, kernel=kernel, num_warmup=num_warmup,
                num_samples=num_samples, num_chains=num_chains)
    m.run(seed, mesh=make_mesh(("chains",), device="cpu"))
    return (m.get_samples(group_by_chain=True)["x"],
            float(m.summary()["x"]["rhat"].max()), m.accept_rate())


def two_axis_nuts(tdata):
    """A (cells, chains) = (2, 2) mesh: the phase model's cells split, its
    per-cell phases conditioned, 2 NUTS chains split; returns the draws of
    nu, two points q and the cell-summed potential, gradient and
    ``log_offset`` there (the absolute -log density is potential -
    log_offset)."""
    mesh = make_mesh(("cells", "chains"), shape=(2, 2), device="cpu")
    data = shard_phase_data(tdata, mesh)
    model = th.condition(tphase.phase_model,
                         data={"phi_xy": data.phixy_prior})
    m = TM.MCMC(model, kernel="nuts", num_warmup=60, num_samples=60,
                num_chains=2, max_depth=6)
    m.run(0, data, mesh=mesh)
    info = m.model_info
    q = torch.stack([info.init_u, info.init_u + 0.01])
    value, grad = info.reduce(*TM._batched_value_and_grad(info.potential_fn)(q))
    return {"nu": m.get_samples()["nu"], "q": q.numpy(),
            "value": value.numpy(), "grad": grad.numpy(),
            "log_offset": info.log_offset,
            "cells_rank": mesh.get_local_rank("cells"),
            "chains_rank": mesh.get_local_rank("chains")}


def unconditioned_cells_refusal(tdata):
    """NUTS on a ("cells",) mesh with the phase model's per-cell phi_xy
    left latent: the ValueError's message (None if nothing was raised)."""
    mesh = make_mesh(("cells",), device="cpu")
    data = shard_phase_data(tdata, mesh)
    m = TM.MCMC(tphase.phase_model, kernel="nuts", num_warmup=2,
                num_samples=2, num_chains=1, max_depth=2)
    try:
        m.run(0, data, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def conjugate():
    mu = th.sample("mu", tdist.Normal(0.0, 3.0))
    th.sample("y", tdist.Normal(mu, 1.0),
              obs=torch.tensor([1.8, 2.2, 2.0, 1.9]))


def smc_conjugate(num_particles, seed):
    """tests/test_distributed.py's conjugate model, particles split."""
    smc = TS.SMC(conjugate, num_particles=num_particles, num_moves=2)
    smc.run(seed, mesh=make_mesh(("particles",), device="cpu"))
    return smc.get_samples()["mu"], smc.log_evidence()


def smc_phase(tdata, num_particles, seed):
    """SMC over the phase model (phi_xy conditioned), particles split:
    (log Z, the draws of nu, the schedule)."""
    model = th.condition(tphase.phase_model,
                         data={"phi_xy": tdata.phixy_prior})
    smc = TS.SMC(model, num_particles=num_particles, num_moves=2,
                 max_stages=100)
    smc.run(seed, tdata, mesh=make_mesh(("particles",), device="cpu"))
    return (smc.log_evidence(), smc.get_samples()["nu"],
            smc.temperature_schedule)


def smc_velocity(tdata, num_particles, seed):
    """SMC over the fused velocity model (phi_xy conditioned), particles
    split: (log Z, the draws of nu)."""
    model = th.condition(tvel.velocity_model,
                         data={"phi_xy": tdata.phixy_prior})
    smc = TS.SMC(model, num_particles=num_particles, num_moves=1,
                 max_stages=60)
    smc.run(seed, tdata, mesh=make_mesh(("particles",), device="cpu"))
    return smc.log_evidence(), smc.get_samples()["nu"]


def smc_fit(mp, num_particles, seed):
    """`SMCFitModel` (prior tempering, phi_xy conditioned on its prior) with
    its particles split: (log Z, the schedule, the posterior nu)."""
    from velocycle_tpu_torch import SMCFitModel

    sm = SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                     num_particles=num_particles, num_moves=2, max_stages=200)
    sm.run(seed, mesh=make_mesh(("particles",), device="cpu"))
    return sm.log_evidence, sm.temperature_schedule, sm.posterior["nu"]


def per_rank_loading(tdata):
    """This rank's cells cut from the full container (`local_data_slice`)
    and assembled by `globalize_data` / `globalize_params`, against
    `shard_phase_data`'s / `shard_params`' shard: (the shard's fields as
    numpy, whether the data are equal field for field, whether the params
    are, (lo, hi))."""
    mesh = make_mesh(("cells",), device="cpu")
    velo = hasattr(tdata, "U")
    ref = (shard_velocity_data if velo else shard_phase_data)(tdata, mesh)
    spec = data_sharding_spec(tdata)
    rows = {k: torch.as_tensor(distributed.local_data_slice(
        getattr(tdata, k).numpy(), axis=ax))
        for k, ax in spec.items() if ax is not None}
    lo, hi = distributed.process_cell_slice(tdata.Nc)
    got = distributed.globalize_data(tdata.replace(**rows, Nc=hi - lo), mesh,
                                     tdata.Nc)
    fields = {k: getattr(ref, k) for k in spec if getattr(ref, k) is not None}
    same = (all(torch.equal(getattr(got, k), v) for k, v in fields.items())
            and got.shard[:3] == ref.shard[:3] and got.Nc == ref.Nc)
    params, _ = init_params(MODELS["lrmn" if velo else "phase"][1], 0, tdata)
    local = {k: (distributed.local_data_slice(v.detach().numpy(), axis=0)
                 if k in PARAM_CELL_AXES else v.detach().numpy())
             for k, v in params.items()}
    a = distributed.globalize_params(local, mesh, tdata.Nc)
    b = shard_params({k: v.detach() for k, v in params.items()}, mesh)
    same_params = sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k]) for k in b)
    return ({k: v.numpy() for k, v in fields.items()}, same, same_params,
            (lo, hi))


def replicated(value):
    """`sharding.replicate` of ``{"x": [value + rank]}``: rank 0's value
    on every rank (a nested tree, a non-tensor leaf kept), and
    `param_sharding_spec` of a phase guide's params."""
    from velocycle_tpu_torch.parallel import param_sharding_spec, replicate

    mesh = make_mesh(("cells",), device="cpu")
    tree = {"x": [torch.tensor([value + dist.get_rank()], dtype=torch.float32),
                  "label"]}
    got = replicate(tree, mesh)
    spec = param_sharding_spec({"phixy_locs": torch.zeros(4, 2),
                                "nu_locs": torch.zeros(3, 3)})
    return float(got["x"][0]), got["x"][1], spec


def mesh_refusal():
    """make_mesh with a shape that does not match the world: the message."""
    try:
        make_mesh(("cells",), shape=(3,), device="cpu")
    except ValueError as e:
        return str(e)
    return None


def unlisted_cell_site_refusal(tdata):
    """A sharded SVI step on the phase model plus an observed site in the
    "cells" plate that `minibatch.LOCAL_SITES` does not name: the
    ValueError's message (None if nothing was raised)."""
    def model(mp):
        tphase.phase_model(mp)
        with th.plate("cells", mp.Nc, dim=-1):
            th.sample("extra", tdist.Normal(0.0, 1.0),
                      obs=torch.zeros(mp.Nc))

    mesh, data = _mesh_and_shard(tdata)
    svi = SVI(model, tphase.phase_guide, clipped_adam(), Trace_ELBO())
    state = svi.init_sharded(0, mesh, data)
    try:
        svi.update(state, data)
    except ValueError as e:
        return str(e)
    return None


def run_all(tasks):
    """Run ``tasks`` [(name, function name, args)] in turn on this rank:
    {name: result}.  One spawn of the ranks serves many checks."""
    return {name: globals()[fn](*args) for name, fn, args in tasks}


TIMEOUT = 120


def spawn(world, tasks):
    """``tasks`` run on each of ``world`` spawned ranks (gloo, the CPU;
    killed and failed after ``TIMEOUT`` seconds): one result dict per
    rank."""
    from velocycle_tpu_torch.parallel import run_ranks

    return run_ranks(run_all, world, device="cpu", timeout=TIMEOUT,
                     args=(tasks,))
