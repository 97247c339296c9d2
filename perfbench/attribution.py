"""The program's own spans in a traced segment
(`velocycle_tpu_torch.profiling.span`): the device time launched inside
each, and the synchronizing runtime calls made inside each step.

A device operation belongs to the innermost program span open when its
launching runtime call started, on whatever thread the call was made: the
backward's kernels launch from autograd's device thread while the caller
waits inside ``svi.backward``.  `trace.Trace` keeps each kernel's
correlation id but not the runtime calls', so the join goes by order:
CUPTI numbers the calls in the order they start, so kernels in the order
of their correlation ids are launch calls in the order of their starts;
on the one stream a step runs on, copies (sets) in the order of their
device starts are copy (set) calls in the order of theirs.  The order is
paired from the trace's end: on the card CUPTI can leave out the records
of the first few kernels launched after the profiler starts (8 in two of
three traces), whose calls it keeps.  An operation left with no call
counts as outside every span.  A record lost later in the trace slips
the pairs before it by one; where a slip pairs an operation with a call
that starts after it, the join gives nothing to read (a slip that pairs
each with an earlier call does not show).  A program without these
spans, or a trace with no device operation, gives nothing to read
either.  `correlation_join` is the exact join, for the raw events of a
trace that keeps every call's correlation id; the tests hold the order
join against it on the card.
"""
from __future__ import annotations

import re

from .trace import DEVICE_CATS

STEP = "svi.step"
PROGRAM = (STEP, "svi.elbo", "svi.backward", "svi.optim")
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize"})
_LAUNCH = re.compile(r"^cu(da)?Launch")
# (the runtime or driver calls, the start of the device operations' names)
# of copies and of sets
_COPIES = ((re.compile(r"^cu(da)?Memcpy"), "Memcpy"),
           (re.compile(r"^cu(da)?Memset"), "Memset"))


def launched(trace):
    """[(the launching call's start, or None where the trace kept no call
    for it; device microseconds)] of every device operation of
    ``trace``, or None where a paired call starts after its operation."""
    calls = sorted(trace.host)
    kernels = sorted(trace.kernels, key=lambda e: e["args"]["correlation"])
    kinds = [([a for a, _, n in calls if _LAUNCH.match(n)],
              [(e["ts"], e["dur"]) for e in kernels])]
    for rx, prefix in _COPIES:
        kinds.append(([a for a, _, n in calls if rx.match(n)],
                      [(a, b - a) for a, b, n in trace.ops
                       if n.startswith(prefix)]))
    out = []
    for starts, ops in kinds:
        lost = len(ops) - len(starts)
        starts = [None] * lost + starts[max(0, -lost):]
        for t, (a, dur) in zip(starts, ops):
            if t is not None and t > a:
                return None
            out.append((t, dur))
    return out


def _innermost(spans, t):
    """The last item of the shortest of ``spans`` ((start, end, item))
    open at instant ``t``, or None."""
    inside = [s for s in spans if t is not None and s[0] <= t <= s[1]]
    return min(inside, key=lambda s: s[1] - s[0])[2] if inside else None


def device_seconds(trace):
    """{program span (None: none open): device seconds of the operations
    launched inside it}, or None where the trace holds no program span or
    no device operation, or the join slipped (`launched`)."""
    spans = [s for s in trace.spans if s[2] in PROGRAM]
    pairs = launched(trace) if spans and trace.ops else None
    if pairs is None:
        return None
    out = dict.fromkeys(PROGRAM + (None,), 0.0)
    for t, dur in pairs:
        out[_innermost(spans, t)] += dur / 1e6
    return out


def device_ms(run, name):
    """Device milliseconds per traced step launched inside the program's
    span ``name``, or None where the run gives nothing to read."""
    if run.trace is None or not run.traced_steps:
        return None
    by = device_seconds(run.trace)
    return None if by is None else 1e3 * by[name] / run.traced_steps


def syncs_per_step(run):
    """Synchronizing runtime calls (`SYNCS`) that start inside a
    ``svi.step`` span, per traced step, or None where the trace holds no
    such span or no device operation."""
    if run.trace is None or not run.traced_steps or not run.trace.ops:
        return None
    steps = [(a, b) for a, b, name in run.trace.spans if name == STEP]
    if not steps:
        return None
    n = sum(1 for t, _, name in run.trace.host
            if name in SYNCS and any(a <= t <= b for a, b in steps))
    return n / run.traced_steps


def correlation_join(events):
    """The exact join of raw Kineto ``events``: ([(device operation, its
    launching runtime or driver call, the innermost program span open at
    the call's start or None)], [the synchronizing calls that start inside
    a ``svi.step`` span]), each an event."""
    spans = [(e["ts"], e["ts"] + e["dur"], e) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in PROGRAM]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    ops = []
    for op in events:
        if op.get("cat") in DEVICE_CATS:
            call = calls[op["args"]["correlation"]]
            ops.append((op, call, _innermost(spans, call["ts"])))
    steps = [(a, b) for a, b, e in spans if e["name"] == STEP]
    syncs = [c for c in calls.values() if c["name"] in SYNCS
             and any(a <= c["ts"] <= b for a, b in steps)]
    return ops, syncs
