"""The whole step's share of the card's FP32 peak, in %: the operations
the NB likelihood and its gradients need per step (`counts.phase_fwdgrad`
at the run's counts and dispersions, the same whichever code computes
them) times the window's steps per second, over the published FP32 peak.
It bounds every kernel's gain: a kernel taken off the path leaves its
roofline silent, not this.  Moves ``svi_steps_per_s``."""


def read(run):
    if run.peaks is None or not run.rate:
        return None
    return 100.0 * run.work[0] * run.rate / run.peaks["fp32"]
