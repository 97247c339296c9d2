"""One reader per per-layer metric, found by the metric's name: each
module's ``read(run)`` takes a `harness.RunView` and returns the number, or
None where the run gives it nothing to read (the harness then leaves the
metric out of the result)."""


def roofline(run, name):
    """A kernel's share of its roofline, in %: the least time the card
    could take for one call of the NB fwd+grad (the larger of the counted
    FP32 operations over the FP32 peak and the counted bytes over the HBM
    peak, `counts.phase_fwdgrad` at the run's counts and dispersions) over
    the mean device time per step of the kernels that the traffic's file
    names under ``kernels.<name>``; None where the mix names none or the
    trace holds none of them."""
    patterns = run.mix.get("kernels", {}).get(name)
    if not patterns or run.trace is None or run.peaks is None:
        return None
    seconds, launches = run.trace.kernel_seconds(patterns)
    if not launches or not run.traced_steps:
        return None
    ops, nbytes = run.work
    bound = max(ops / run.peaks["fp32"], nbytes / run.peaks["bytes"])
    return 100.0 * bound / (seconds / run.traced_steps)
