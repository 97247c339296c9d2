"""The yardstick's operation counts give the repository's recorded
bounds: 19.05 GFLOP for `phase_fwdgrad` and 32.47 GFLOP for
`phase_fwdgrad_wide` at 21 columns, both at 2048 x 102,400 on counts
floor(exp(N(1, 0.8^2))) at dispersions a = 1/r <= 20 (the ratio form)."""
import math

import pytest
import torch

from perfbench import counts

NG, NC = 2048, 102_400


def _share_ge2(mean=1.0, sd=0.8):
    """P(floor(exp(x)) >= 2) for x ~ N(mean, sd^2)."""
    z = (math.log(2.0) - mean) / sd
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def _ops(Nh, Nb, N=NG * NC):
    n_ge2 = round(_share_ge2() * N)
    D = counts.DISP_OPS
    dg = ((D["ratio"] + D["dg_sel"]) * N + D["dg_stir"] * n_ge2
          + D["dg_small"] * (N - n_ge2))
    return counts.wide_ops("phase", "fwdgrad", Nh, Nb, N,
                           counts.ratio_ops(N, n_ge2), dg, True)


@pytest.mark.parametrize("Nh, Nb, gflop", [(5, 0, 19.05), (5, 16, 32.47)])
def test_recorded_bounds(Nh, Nb, gflop):
    assert round(_ops(Nh, Nb) / 1e9, 2) == gflop


def test_fewer_columns_and_a_folded_batch():
    """H = 1 with one section's offsets: two basis columns fewer than the
    counted Nh = 5, one batch more."""
    N = NG * NC
    per_column = (counts.OPS_PER_COLUMN["common"]
                  + counts.OPS_PER_COLUMN["fwdgrad"])
    per_batch = counts.OPS_PER_BATCH["common"] + counts.OPS_PER_BATCH["fwdgrad"]
    assert _ops(3, 1) == _ops(5, 0) - 2 * per_column * N + per_batch * N


def test_phase_fwdgrad_counts_the_branches_of_its_inputs():
    g = torch.Generator().manual_seed(5)
    S = torch.floor(torch.exp(torch.randn(64, 3000, generator=g) * 0.8 + 1.0))
    r = torch.full((64,), 0.5)
    ops, nbytes = counts.phase_fwdgrad(S.to(torch.int16), r, 5, 0)
    N, n2 = S.numel(), int((S >= 2).sum())
    assert ops == (56 + 2 + 6) * N + 22 * n2 + 5 * (N - n2) + 15 * n2 + 3 * (N - n2)
    assert nbytes == 2 * N + 4 * 2 * (64 * 5 + 3000 * 5 + 3000 + 64) + 4
    # a gene past EXCESS_FROM takes the excess form and reads the log-means
    r[0] = 1.0 / 100.0
    called = []
    ops2, _ = counts.phase_fwdgrad(
        S.to(torch.int16), r, 5, 0,
        elog=lambda: called.append(1) or torch.zeros(64, 3000))
    assert called and ops2 != ops


def test_peaks_table():
    p = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert p == {"fp32": 67e12, "bytes": 3.35e12}


def test_a_kernels_roofline_share_from_its_trace():
    """`metrics.roofline`: the counted bound over the named kernels' mean
    device time per step; nothing where the mix names no kernel."""
    from types import SimpleNamespace

    from perfbench import metrics, trace

    events = [{"cat": "kernel", "name": n, "ts": t, "dur": d}
              for n, t, d in (("void vct::phase::phase_kernel<short>()", 0, 300),
                              ("vct::phase::cell_sum_kernel()", 300, 100),
                              ("at::native::reduce_kernel<>()", 400, 600),
                              ("void vct::phase::phase_kernel<short>()", 1000, 300),
                              ("vct::phase::cell_sum_kernel()", 1300, 100))]
    tr = trace.Trace(events, window_s=2e-3)
    run = SimpleNamespace(
        mix={"kernels": {"k": ["phase::phase_kernel<", "phase::cell_sum_kernel"]}},
        trace=tr, traced_steps=2, work=(67e6, 3.35e5),
        peaks={"fp32": 67e12, "bytes": 3.35e12})
    # bound 1 us (operations) over 400 us per step
    assert metrics.roofline(run, "k") == pytest.approx(0.25)
    assert metrics.roofline(run, "other") is None
    assert tr.busy_s == pytest.approx(1.4e-3)
