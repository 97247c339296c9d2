"""A traced segment of the loop and its reduction to numbers.

`profiled(fn)` runs ``fn`` under `torch.profiler` (CPU and CUDA
activities), writes the Chrome trace into a temporary directory (under
``TMPDIR``), reads it back and deletes it.  `Trace` holds the device's
operations (kernels, copies, sets) and the benchmark's host spans, on the
trace's one clock, and reduces them: the union of device intervals (busy
time), the kernels launched, the device time of named kernels, the
operations that took the most time, and the idle gaps, each labelled by
the host span open across most of it.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")


class Trace:
    def __init__(self, events, window_s):
        self.window_s = window_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        self.spans = [(e["ts"], e["ts"] + e["dur"], e["name"])
                      for e in events if e.get("cat") == SPAN_CAT
                      and "dur" in e]
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") in HOST_CATS
                     and "dur" in e]
        self.ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                          for e in dev)
        merged = []
        for a, b, _ in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e6

    def launches(self):
        return len(self.kernels)

    def kernel_seconds(self, patterns):
        """(device seconds, launches) of the kernels whose name matches one
        of the regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        hit = [e for e in self.kernels if any(r.search(e["name"]) for r in rx)]
        return sum(e["dur"] for e in hit) / 1e6, len(hit)

    def device_ops(self, n=10):
        """The ``n`` device operations (by short name) that took the most
        time: [[name, seconds], ...]."""
        by = defaultdict(float)
        for a, b, name in self.ops:
            by[_short(name)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between device operations inside the
        traced window, each named by what the host was doing at its middle:
        the benchmark's span open there and the innermost host operation
        (an aten op or a CUDA runtime call) around that instant:
        [["span: operation", seconds], ...]."""
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(self.merged,
                                                     self.merged[1:])]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[f"{_at(self.spans, (a + b) / 2) or 'no span'}: "
                 f"{_at(self.host, (a + b) / 2) or 'python'}",
                 (b - a) / 1e6] for a, b in gaps[:n]]


def _at(events, t):
    """The name of the shortest of ``events`` open at instant ``t``."""
    open_ = [(e - s, name) for s, e, name in events if s <= t <= e]
    return _short(min(open_)[1]) if open_ else None


def _short(name):
    """A device operation's name without its return type, anonymous
    namespaces and argument list, at most 120 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:120]


def profiled(fn, device):
    """Run ``fn()`` under the profiler; returns (fn's result, `Trace`).
    The traced window is the host's clock from the profiler's start to
    the sync that ends ``fn``."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace(events, window_s)
