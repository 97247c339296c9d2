"""Profiling and observability (port of `velocycle_tpu/profiling.py`).

  * `trace(logdir)`: a `torch.profiler.profile` over the enclosed block,
    CPU and (with a card) CUDA activities, written into ``logdir`` as a
    Chrome trace (``*.pt.trace.json``; open it in Perfetto, chrome://tracing
    or TensorBoard).
  * `span(name)`, also named `annotate(name)`: a named region; the
    program's spans are `SVI.update`'s ``svi.step`` and its ``svi.elbo``,
    ``svi.backward``, ``svi.optim``, and the front doors' ``preprocess``
    and its ``preprocess.<pass>``.  Off, it is one shared no-op; under an
    active profiler it is a `record_function` range on the trace's clock
    beside the card's operations; under `recording` its calls and
    host-clock seconds are added to the recording.  One step's spans are
    tied together by nesting inside that step's ``svi.step``.
  * `recording()`: yields ``{span name: [calls, host seconds]}``, filled
    by every span closed while it is open.
  * `StepTimer`: wall-clock step timing that keeps the first step apart:
    on the card that step pays the kernel build and the CUDA context.
  * `device_memory_stats()`: `torch.cuda.memory_stats` of each card.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import numpy as np
import torch

from .device import resolve_device

__all__ = ["trace", "annotate", "span", "recording", "StepTimer",
           "device_memory_stats"]

# True inside a `torch.profiler.profile` session
_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = contextvars.ContextVar("velocycle_span_recording", default=None)
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block (CPU and, with a card, CUDA activities)
    and write it into ``logdir`` as a Chrome trace; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof


def span(name):
    """The span ``name``: a shared no-op context unless a profiler is
    active or a `recording` is open (module docstring)."""
    rec = _recording.get()
    if rec is None and not _profiler_enabled():
        return _OFF
    return _span(name, rec)


@contextlib.contextmanager
def _span(name, rec):
    t0 = time.perf_counter()
    with (torch.profiler.record_function(name) if _profiler_enabled()
          else _OFF):
        yield
    if rec is not None:
        entry = rec.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += time.perf_counter() - t0


annotate = span


@contextlib.contextmanager
def recording():
    """Record the program's spans while open: yields ``{name: [calls,
    host-clock seconds]}``.  Where recordings nest, a span is added to the
    innermost one open when it started."""
    rec = {}
    token = _recording.set(rec)
    try:
        yield rec
    finally:
        _recording.reset(token)


class StepTimer:
    """Wall-clock step timing that separates the first (build) step.

    On the card the caller synchronizes inside the ``with``, or the timer
    measures the enqueue::

        timer = StepTimer()
        for i in range(n):
            with timer:
                state, loss = svi.update(state, data)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def compile_time(self):
        return self.times[0] if self.times else None

    @property
    def steady_times(self):
        return self.times[1:] if len(self.times) > 1 else self.times

    def steps_per_second(self):
        ts = self.steady_times
        return 1.0 / float(np.mean(ts)) if ts else float("nan")

    def summary(self):
        ts = np.asarray(self.steady_times)
        if len(ts) == 0:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "compile_s": self.compile_time,
            "mean_ms": float(ts.mean() * 1e3),
            "p50_ms": float(np.percentile(ts, 50) * 1e3),
            "p95_ms": float(np.percentile(ts, 95) * 1e3),
            "steps_per_s": self.steps_per_second(),
        }


def device_memory_stats(device=None):
    """{device name: `torch.cuda.memory_stats` dict}: every visible card
    for ``device=None``, else the one asked for; ``device="cpu"`` gives
    ``{"cpu": None}`` (no stats, as the JAX package reports for such a
    backend).  Raises with no card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {str(dev): None}
    if device is not None:
        return {str(dev): torch.cuda.memory_stats(dev)}
    return {
        str(torch.device("cuda", i)): torch.cuda.memory_stats(i)
        for i in range(torch.cuda.device_count())
    }
