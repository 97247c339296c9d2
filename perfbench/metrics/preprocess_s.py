"""Seconds of the front door, `preprocess_for_phase_estimation`, on the
host clock around the call (the benchmark's span ``preprocess``, which
ends in the copy of its tensors to the card).  Moves ``setup_s``."""


def read(run):
    return run.spans.get("preprocess")
