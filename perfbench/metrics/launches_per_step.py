"""CUDA kernels launched per SVI step in the traced segment (the
profiler's kernel events over the segment's steps).  Moves
``svi_steps_per_s`` where the host's launches pace the step."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace.launches() / run.traced_steps
