"""Roofline ladder of the phase fwd+grad kernel on the card.

    python -m velocycle_tpu_torch.tools.kernel_profile [i16]

The port of tools/kernel_profile.py.  It runs each rung of
`ops.ladder_kernels` (`phase_fwdgrad` stripped down step by step: compile-time
cuts of its body, csrc/phase_kernel.cuh, in its launch layout) at the TPU
tool's shape, 2048 genes x 102,400
cells, Nh = 5, float32 counts or with ``i16`` int16 ones, from the same
distributions.  As there, each rung runs ``n_it`` steps chained through nu
(``nu - 1e-30 * loss``, and ``nu - 1e-12 * sum_tiles dnu`` for the
variants), and its row gives the steps' host-clock time per step under the
TPU tool's row name.  Each row adds the kernel-only time (CUDA events around
``n_it`` launches of the kernel alone, back to back) and the rung's bound:
the larger of the bytes it must move over 3.35 TB/s and its FP32 operations,
counted on this run's data, over 67 TFLOP/s (the H100 SXM's published
peaks).  The differences between rungs say where `phase_fwdgrad`'s time
goes.  It runs on the card and raises without one; ``device="cpu"`` runs
the plain versions instead (no kernel time then).
"""
from __future__ import annotations

import math
import sys
import time

import torch

from ..device import resolve_device
from ..ops import ladder_kernels as L
from ..ops.special import EXCESS_FROM, SERIES_BELOW

NG, NC = 2048, 102_400
TPU_CELL_TILE = 4096      # the TPU tool's TC: its stream rung adds nu Nc // TC times
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
ROWS = ("stream", "matmul", "logpmf", "fwdgrad", "vpu_only", "v_full",
        "v_nodig", "v_nocell")   # the TPU tool's print order

# FP32 operations per count-matrix element, counted from csrc/phase_kernel.cuh
# with Nh = 5 as chip_smoke.py counts the phase kernels (a transcendental or
# a division counts 1), besides the lgamma ratio and the dispersion
# gradient below:
#   stream    count convert 1, sum 1
#   matmul    count convert 1, ElogS dot 10, product 1, sum 1
#   logpmf    convert 1, dot 10, log_b 1, lp 4, softplus + log sigmoid 7,
#             sum 1
#   fwdgrad   logpmf's 17 besides softplus + log sigmoid, softplus + log
#             sigmoid + sigmoid and its complement 13, g_elog 3, dnu
#             accumulation 10
#   v_full    fwdgrad + cf 1, ddisp 1, dzeta 10, dcf 1 (and g_r, DISP_OPS)
#   v_nodig   v_full without g_r (its sum of g_elog replaces ddisp)
#   v_nocell  v_full without dzeta and dcf
#   vpu_only  dot 10, floor(3 |elog|) 3, log_b 1, lp 4, softplus + log
#             sigmoid 7, sum 1 (on its synthetic counts)
ELEMENT_OPS = {"stream": 2, "matmul": 13, "logpmf": 24, "fwdgrad": 43,
               "v_full": 56, "v_nodig": 56, "v_nocell": 45, "vpu_only": 26}
# lgamma ratio: Stirling difference 22 where k >= 2, small-k sum 5 where
# k < 2, branch select 2
LGAMMA_OPS = (22, 5, 2)
# the dispersion gradient g_r of one element (csrc/nb_common.cuh
# nb_lp_grads), counted on the branch its gene and its inputs take:
#   a < EXCESS_FROM: dlp_da + g_r 5; the digamma ratio: Stirling 10,
#     1/a + 1/(a + 1) 1 and the move from the rounded y = a + 2 to a + 2,
#     1/ka - 1/y 2 and - delta (1/ka - 1/y) 2 (delta a gene column,
#     GeneCols), where k >= 2 (15); small-k sum 3 where k < 2, select 1
#   a >= EXCESS_FROM: ((k - a dgr) - k sig_c + a q) a 5; q = -(log sig +
#     sig_c) by series 16 where log_b >= 0 and sig_c < 1/8, else directly
#     2, the test 3; the digamma excess k - a dgr where k >= 2: 1/ka - 1/y
#     3, its square 3, the tail difference 13, the sum 7, the move from the
#     rounded y, + a delta (1/ka - 1/y) 3 (29), and t - log1p t
#     by series 16 where t = (k - 2) / (a + 2) < 1/8, else directly 1, the
#     test 2; 0 where k < 2; select 1
DISP_OPS = {"ratio": 5, "dg_stir": 15, "dg_small": 3, "dg_sel": 1,
            "excess": 5, "q_series": 16, "q_direct": 2, "q_test": 3,
            "kad_stir": 29, "t_series": 16, "t_direct": 1, "t_test": 2,
            "kad_sel": 1}
DISP_RUNGS = ("v_full", "v_nocell")


def disp_ops(k, elog, r):
    """FP32 operations of the dispersion gradient (DISP_OPS) over counts
    ``k`` at log-means ``elog`` (each (..., Ng, Nc) or broadcast to it) and
    dispersions ``r`` (..., Ng): each element counted on the branch its
    gene and its inputs take, as the lgamma ratio is."""
    D = DISP_OPS
    a = 1.0 / r[..., None]
    log_b = -torch.log(r)[..., None] - elog
    shape = torch.broadcast_shapes(k.shape, log_b.shape)
    ex = (a >= EXCESS_FROM).expand(shape)
    ge2 = (k >= 2).expand(shape)
    n = math.prod(shape)
    n_ex = int(ex.sum())
    n_ra = n - n_ex
    ra_ge2 = int((ge2 & ~ex).sum())
    ops = ((D["ratio"] + D["dg_sel"]) * n_ra + D["dg_stir"] * ra_ge2
           + D["dg_small"] * (n_ra - ra_ge2))
    if n_ex:
        e = torch.exp(-log_b.abs())
        q_ser = (log_b >= 0) & (e / (1.0 + e) < SERIES_BELOW)
        t_ser = torch.clamp(k.float() - 2.0, min=0.0) / (a + 2.0) < SERIES_BELOW
        n_q = int((ex & q_ser).sum())
        ex_ge2 = ex & ge2
        n_k = int(ex_ge2.sum())
        n_t = int((ex_ge2 & t_ser).sum())
        ops += ((D["excess"] + D["q_test"] + D["kad_sel"]) * n_ex
                + D["q_series"] * n_q + D["q_direct"] * (n_ex - n_q)
                + (D["kad_stir"] + D["t_test"]) * n_k
                + D["t_series"] * n_t + D["t_direct"] * (n_k - n_t))
    return ops


def make_inputs(Ng=NG, Nc=NC, int16=False, seed=0, device=None):
    """(S, nu, zeta, cf, r) drawn on ``device`` as tools/kernel_profile.py
    draws them: S = floor(exp(0.8 N + 1)), nu = 0.5 N, zeta the Fourier
    basis [1, cos, sin, cos 2, sin 2] at U(0, 6.28) angles, cf = 0.2 N,
    r = exp(0.3 N)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    S = torch.floor(torch.exp(rn(Ng, Nc) * 0.8 + 1.0))
    S = S.to(torch.int16) if int16 else S
    nu = rn(Ng, L.NH) * 0.5
    ang = torch.rand(Nc, generator=g, device=dev) * 6.28
    zeta = torch.stack([torch.ones_like(ang), torch.cos(ang), torch.sin(ang),
                        torch.cos(2 * ang), torch.sin(2 * ang)], -1)
    r = torch.exp(rn(Ng) * 0.3)
    cf = rn(Nc) * 0.2
    return S, nu, zeta.contiguous(), cf, r


def work(rung, S, nu, zeta, cf, r):
    """(bytes, FP32 operations) of one rung on these inputs: each input read
    once, each output written once; the lgamma ratio and the dispersion
    gradient counted by branch on this data (vpu_only's synthetic counts
    included)."""
    Ng, Nc = nu.shape[0], zeta.shape[0]
    sizes = {"nu": nu.numel(), "zeta": zeta.numel(), "count_factor": Nc,
             "dispersion": Ng}
    nbytes = 4 * sum(sizes[n] for n in L.READS[rung]) + 4   # + the loss
    if rung != "vpu_only":
        nbytes += S.numel() * S.element_size()
    if rung == "fwdgrad":
        nbytes += 4 * Ng * L.NH
    elif rung.startswith("v_"):
        nbytes += 4 * Ng * (L.NH + 1)
        if rung != "v_nocell":
            nbytes += 4 * Nc * (L.NH + 1)
    N = Ng * Nc
    ops = ELEMENT_OPS[rung] * N
    if rung not in ("stream", "matmul"):
        k = torch.floor(torch.abs(nu @ zeta.T) * 3.0) if rung == "vpu_only" else S
        n_ge2 = int((k >= 2).sum())
        n_lt2 = N - n_ge2
        stir, small, sel = LGAMMA_OPS
        ops += stir * n_ge2 + small * n_lt2 + sel * N
    if rung in DISP_RUNGS:
        elog = nu @ zeta.T
        if "count_factor" in L.READS[rung]:
            elog = elog + cf[None, :]
        ops += disp_ops(S, elog, r)
    return nbytes, ops


def bound_ms(nbytes, ops):
    """(least time in ms on the H100 at its published peaks, "bytes" or
    "operations": whichever sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn, reps, warmup=1):
    """Mean ms of ``reps`` back-to-back calls of ``fn`` on the card, CUDA
    events around them all, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run_ladder(int16=False, seed=0, device=None, Ng=NG, Nc=NC, n_it=25):
    """One row per rung, in the TPU tool's order: {"name", "ms_per_step"
    (host clock over ``n_it`` chained steps), "kernel_ms" (CUDA events; None
    on the CPU), "bound_ms", "bound_by", "bytes", "ops", "loss" (the last
    step's), "device"}.  On the card the rungs run as CUDA kernels; with
    ``device="cpu"`` as their plain versions."""
    dev = resolve_device(device)
    S, nu0, zeta, cf, r = make_inputs(Ng, Nc, int16, seed, dev)
    n_rep = Nc // TPU_CELL_TILE
    cuda = dev.type == "cuda"
    rows = []
    for name in ROWS:
        def step(nu):
            # chained as the TPU tool chains its scan: through the loss, or
            # for the variants through the dnu partials summed over tiles
            loss, grads = L.run_rung(name, S, nu, zeta, cf, r, n_rep,
                                     plain=not cuda)
            if name.startswith("v_"):
                return loss, nu - 1e-12 * grads[0].sum(0)
            return loss, nu - 1e-30 * loss

        step(nu0)                                 # warm-up (and first build)
        _sync(dev)
        nu = nu0
        t0 = time.perf_counter()
        for _ in range(n_it):
            loss, nu = step(nu)
        last = float(loss)
        _sync(dev)
        ms_step = (time.perf_counter() - t0) / n_it * 1e3
        kernel_ms = None
        if cuda:
            counts = None if name == "vpu_only" else S
            kernel_ms = event_ms(
                lambda: L.ladder_run(name, counts, nu0, zeta, cf, r, n_rep),
                n_it)
        nbytes, ops = work(name, S, nu0, zeta, cf, r)
        bound, by = bound_ms(nbytes, ops)
        rows.append({"name": name, "ms_per_step": ms_step,
                     "kernel_ms": kernel_ms, "bound_ms": bound,
                     "bound_by": by, "bytes": nbytes, "ops": ops,
                     "loss": last, "device": str(dev)})
    return rows


def format_row(row):
    """The TPU tool's row (name, ms/step), then kernel-only time and bound."""
    width = 9 if row["name"].startswith("v_") else 8
    out = f"{row['name']:{width}s} {row['ms_per_step']:6.2f} ms/step"
    if row["kernel_ms"] is not None:
        out += f"  kernel {row['kernel_ms']:.4f} ms"
    out += f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
    if row["kernel_ms"]:
        out += f", {row['bound_ms'] / row['kernel_ms']:.1%} of roofline"
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    int16 = "i16" in argv
    dev = resolve_device(None)
    print(f"# {torch.cuda.get_device_name(dev)}: "
          f"{'int16' if int16 else 'float32'} counts, {NG} x {NC}, "
          f"Nh {L.NH}, 25 chained steps per rung", flush=True)
    for row in run_ladder(int16=int16, device=dev):
        if not math.isfinite(row["loss"]):
            raise SystemExit(f"{row['name']}: non-finite loss {row['loss']}")
        print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
