"""Device milliseconds per traced step of the operations launched inside
the program's span ``svi.elbo``: the guide trace, the model replay and
every site's ``log_prob`` sum (`attribution`).  Moves
``svi_steps_per_s``."""
from ..attribution import device_ms


def read(run):
    return device_ms(run, "svi.elbo")
