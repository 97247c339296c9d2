"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result line.

Set-up is everything from the process's start to the window's start:
imports, the inputs drawn on the card, the front door, the fit and its
step, the kernels' load (their build, in a checkout's first run), the
first steps that the check reads and one warm-up chunk.  The window calls
`update_chunk` and reads each chunk's losses on the host, as a user's fit
does, for ``--seconds``, then syncs once; its rate is every step over all
that time.  With ``--trace 1`` a separate segment of ``trace_chunks``
chunks after the window runs under the profiler, with the benchmark's
spans around each `SVI.update` and each chunk's read; the per-layer
metrics are read from it and from the run (`metrics/`).  The check runs
after the window, once the peak memory is read and the program's state is
freed (`check`).
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from collections import defaultdict

import torch

from . import check, counts, inputs, spec
from . import trace as tracing
from .phase_cell import ProgramRun
from .reference.phase_svi import follow, fourier


class Spans:
    """Host-clock seconds by span name; inside a traced segment each span
    is also a `torch.profiler.record_function` range."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ctx:
            yield
        self.seconds[name] += time.perf_counter() - t


class RunView:
    """What a per-layer metric's reader reads: the cell, the run's spans,
    its window's rate, the traced segment, the work of one step by the
    yardstick's count, and the device's peaks."""

    def __init__(self, cell, spans, rate, trace, traced_steps, work, peaks):
        self.cell, self.mix = cell, cell.mix
        self.spans = dict(spans.seconds)
        self.rate = rate
        self.trace = trace
        self.traced_steps = traced_steps
        self.work = work
        self.peaks = peaks


def _work(prog, harmonics):
    """(FP32 operations, bytes) of one step's NB likelihood and its
    gradients at the run's counts and its current point estimates (the
    dispersions pick each gene's branch; the log-means matter only where
    a gene takes the excess form)."""
    d = prog.data
    p = prog.svi.get_params(prog.state)

    def elog():
        e = p["nu_locs"] @ fourier(p["phixy_locs"], harmonics).T
        if d.with_delta_nu:
            dnu = prog.pinned.get("delta_nu", p.get("delta_nu_locs"))
            e = e + dnu.T @ d.Db
        return e + d.count_factor[None]

    return counts.phase_fwdgrad(
        d.S, p["shape_inv_locs"], 2 * harmonics + 1,
        d.Nb if d.with_delta_nu else 0, elog=elog, disp_grad=d.disp_grad)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed, seconds, traced, device, t_start):
    """The result dict of one run (the line run.py prints last), with the
    host spans under ``spans`` for the caller to print and drop."""
    spans = Spans()
    mix, cfg = cell.mix, cell.config
    prog = ProgramRun(cfg, mix, seed, device, spans)
    mine = prog.first_steps(int(mix["checked_steps"]))
    prog.chunks(int(mix["warmup_chunks"]))
    _sync(device)
    setup_s = time.perf_counter() - t_start
    steps, window_s, bad = prog.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = spec.forbidden_modules(sys.modules)
    if found:
        raise SystemExit(f"the run holds {', '.join(found)} after its window")
    rate = steps / window_s
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    attempted = steps
    if traced:
        work = _work(prog, cfg["model"]["harmonics"])
        spans.annotate = True
        (n, b), tr = tracing.profiled(
            lambda: prog.chunks(int(mix["trace_chunks"]), span=spans), device)
        spans.annotate = False
        attempted, bad = attempted + n, bad + b
        view = RunView(cell, spans, rate, tr, n, work,
                       counts.PEAKS.get(dev["kind"]))
        for m in cell.per_layer:
            value = spec.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        e2e = {"svi_steps_per_s": rate, "peak_device_gib": peak / 2**30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[spec.base(m["name"])],
                                  "unit": m["unit"]}
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    made = inputs.make(cfg["data"], seed, device, unspliced=False)
    ref = follow(made, cfg["model"], mix["optimizer"], seed,
                 steps=int(mix["checked_steps"]))
    numbers = check.gaps(mine, ref)
    ok, shown = check.verdict(numbers, cell.limits)
    result = {"correct": bool(ok and bad == 0), "attempted": attempted,
              "failed": bad, "metrics": metrics, "device": dev,
              "spans": dict(spans.seconds)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    shown["nonfinite_losses"] = {"value": bad, "limit": 0}
    result["checked"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                         for k, v in shown.items()}
    return result


def _num(x):
    return x if math.isfinite(x) else str(x)
