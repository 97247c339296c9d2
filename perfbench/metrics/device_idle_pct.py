"""Share of the untraced window in which no operation ran on the card, in
%: 100 - 100 x (device-busy seconds per step in the traced segment: the
union of its kernel, copy and set intervals over its steps) x (the
window's steps per second).  The profiler slows the host's side of a step
(traced steps run 20-30% longer where the host paces them), not the
device's, so the busy time per step is read from the trace and the
step's length from the untraced window.  Moves ``svi_steps_per_s``."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.rate:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_steps * run.rate)
