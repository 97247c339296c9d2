"""Synchronizing CUDA runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``) that start inside the
program's span ``svi.step``, per traced step: each one holds the host until
the card has caught up (`attribution`).  Moves ``svi_steps_per_s``."""
from ..attribution import syncs_per_step


def read(run):
    return syncs_per_step(run)
