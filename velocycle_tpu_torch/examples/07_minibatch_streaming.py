"""Minibatched and host-streamed SVI for cell counts beyond device memory
(the port of the JAX package's example 07).

Full-batch SVI evaluates the whole genes x cells matrix every step, so the
largest dataset it fits is whatever fits in device memory.
`velocycle_tpu_torch.infer.MinibatchSVI` removes that bound:

  * cells are split into equal blocks; one step evaluates one block, with
    the cell-local ELBO terms upweighted so that every step is an unbiased
    full-ELBO gradient;
  * per-cell variational parameters (``phixy_locs``) update block by block:
    only the visited block's rows move;
  * `fit_streamed` takes blocks from HOST memory (numpy, np.memmap) and
    copies each to the card from pinned memory on a side stream while the
    step on the previous block runs: at most two blocks are on the card, so
    Nc is bounded by host storage, not device memory.

Run (from the root of a checkout):

    python velocycle_tpu_torch/examples/07_minibatch_streaming.py [--device cpu]

``VCT_SMOKE=1`` shrinks the data and the epochs so that it finishes in
seconds (the CPU test runs it so).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from velocycle_tpu_torch import (  # noqa: E402
    Cycle, Phases, preprocess_for_phase_estimation, simulate_data,
)
from velocycle_tpu_torch.infer import MinibatchSVI, iter_host_blocks  # noqa: E402
from velocycle_tpu_torch.ops.circular import circular_corrcoef  # noqa: E402

from _smoke import sz  # noqa: E402

NC, NG, NBLK = sz(2000, 256), sz(120, 24), sz(8, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    adata = simulate_data(Nc=NC, Ng=NG, omegas_to_test=(0.4,), seed=11)
    true_phis = np.array(adata.obs["simulated_phis"].values)

    rng = np.random.default_rng(0)
    true_nu = adata.uns["simulated_nu"]
    cycle = Cycle.from_array(
        (true_nu + rng.normal(0, 0.2, true_nu.shape)).T,
        np.full((3, NG), 0.5), list(adata.var.index),
    )
    phases = Phases.from_angles(
        true_phis + rng.normal(0, 0.5, NC), concentration=2.0,
        cell_names=list(adata.obs.index),
    )
    mp = preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=True, device=device,
    )

    # ---- minibatch fit on the card (blocks split once in device memory) --
    mb = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=NBLK, lr=0.05)
    state, losses = mb.fit(0, mp.data, num_epochs=sz(150, 8))
    locs = mb.get_params(state)["phixy_locs"].cpu().numpy()
    cc = float(circular_corrcoef(np.arctan2(locs[:, 1], locs[:, 0]),
                                 true_phis))
    print(f"on-device minibatch: {len(losses)} steps, "
          f"loss {losses[0]:.0f} -> {losses[-1]:.0f}, circ-corr {cc:.3f}")

    # ---- streamed fit: the blocks stay on the HOST until their step -------
    # (a stand-in for np.memmap over an on-disk Stereo-seq-scale matrix)
    d = mp.data
    S_host, cf_host, pp_host, logS_host, Db_host = (
        x.cpu().numpy() for x in (d.S, d.count_factor, d.phixy_prior, d.logS,
                                  d.Db))

    def factory():
        return iter_host_blocks(S_host, cf_host, pp_host, d, NBLK,
                                logS=logS_host, Db=Db_host)

    mb2 = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=NBLK, lr=0.05)
    state2, losses2 = mb2.fit_streamed(0, d, factory, num_epochs=sz(20, 3))
    print(f"host-streamed: {len(losses2)} steps, "
          f"loss {losses2[0]:.0f} -> {losses2[-1]:.0f} "
          "(at most 2 blocks on the card at any time)")
    return losses, losses2


if __name__ == "__main__":
    main()
