"""Multi-device runs (the port of the JAX package's example 05): shard the
cell axis over a mesh and run the sharded SVI step; shard NUTS chains and
SMC particles the same way.

One process per device under torch.distributed.  Start the ranks here:

    python velocycle_tpu_torch/examples/05_sharded_fit.py [--device cpu] \\
        [--world N] [--backend gloo]

or with torchrun, which starts them itself (one per card):

    torchrun --nproc-per-node N velocycle_tpu_torch/examples/05_sharded_fit.py

``--world`` defaults to the cards present (1 on the CPU); NCCL is the card's
backend, gloo the CPU's; ranks that share one card need ``--backend gloo``.
``VCT_SMOKE=1`` shrinks the data, the steps, the chains and the particles.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    Cycle, Phases, preprocess_for_phase_estimation,
)
from velocycle_tpu_torch.core import handlers  # noqa: E402
from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam  # noqa: E402
from velocycle_tpu_torch.infer.mcmc import MCMC  # noqa: E402
from velocycle_tpu_torch.infer.smc import SMC  # noqa: E402
from velocycle_tpu_torch.parallel import (  # noqa: E402
    distributed, make_mesh, run_ranks, shard_phase_data,
)
from velocycle_tpu_torch.simulate import simulate_data  # noqa: E402

from _smoke import sz  # noqa: E402


def rank_main(device):
    """One rank's part; returns the four lines rank 0 prints."""
    import torch.distributed as dist

    world = dist.get_world_size()
    dev = distributed.rank_device(device)
    Nc = sz(128, 16) * world
    adata = simulate_data(Nc=Nc, Ng=sz(64, 16), seed=4)
    cycle = Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = Phases.from_angles(adata.obs["simulated_phis"].values,
                                cell_names=list(adata.obs.index))
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False, device=dev,
    )

    mesh = make_mesh(("cells",), device=dev.type)
    data = shard_phase_data(mp.data, mesh)
    svi = SVI(mp.model_fn, mp.guide_fn, clipped_adam(), Trace_ELBO())
    state = svi.init_sharded(0, mesh, data)
    state, losses = svi.update_chunk(state, sz(200, 20), data)
    losses = losses.cpu().numpy()
    lines = [f"{world}-rank mesh: ELBO {losses[0]:.0f} -> {losses[-1]:.0f}"]
    counts = distributed.split_counts(Nc, world)
    lines.append("S sharding: cells " + " ".join(
        f"[{sum(counts[:r])}, {sum(counts[:r + 1])})" for r in range(world))
        + f" of {Nc} over {world} ranks, {tuple(data.S.shape)} "
        f"{data.S.dtype} on {data.S.device.type} each")

    # -- sharded NUTS chains (gene posteriors, phases pinned) -------------
    model = handlers.condition(
        mp.model_fn, data={"phi_xy": mp.data.phixy_prior}
    )
    m = MCMC(model, kernel="nuts", num_warmup=sz(100, 30),
             num_samples=sz(100, 20), num_chains=world, max_depth=6)
    m.run(1, mp.data, mesh=make_mesh(("chains",), device=dev.type))
    rhat = float(m.summary()["nu"]["rhat"].max())
    lines.append(f"sharded NUTS: {world} chains, accept "
                 f"{m.accept_rate():.2f}, max rhat {rhat:.3f}")

    # -- sharded SMC particles --------------------------------------------
    n = sz(32, 8) * world
    smc = SMC(model, num_particles=n, num_moves=sz(2, 1))
    smc.run(2, mp.data, mesh=make_mesh(("particles",), device=dev.type))
    lines.append(f"sharded SMC: {n} particles, "
                 f"{len(smc.temperature_schedule)} stages, "
                 f"logZ {smc.log_evidence():.1f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to start here (default: the cards present, "
                         "1 on the CPU); ignored under torchrun")
    ap.add_argument("--backend", default=None,
                    help="process group backend (default: nccl on the card, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)
    device = distributed.rank_device(args.device).type
    if all(v in os.environ for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        distributed.initialize(device=device, backend=args.backend)
        lines = rank_main(device)
        if distributed.process_index() == 0:
            print("\n".join(lines))
        return
    world = args.world
    if world is None:
        import torch

        world = torch.cuda.device_count() if device == "cuda" else 1
    lines = run_ranks(rank_main, world, backend=args.backend, device=device,
                      timeout=1800, args=(device,))[0]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
