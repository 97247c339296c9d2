"""Joint (Cycle, Phases) gauge fixes (port of `velocycle_tpu/alignment.py`).

The circle has two gauge freedoms, the zero point and the direction, and a
fitted (Cycle, Phases) pair stays consistent only if both are transformed
together: these helpers do that, on the host.
"""
from __future__ import annotations

import numpy as np

__all__ = ["invert_direction", "shift_zero"]


def invert_direction(cycle, phases):
    """Mirror the cycle direction of a (Cycle, Phases) pair, in place:
    negate every sin harmonic row of ``cycle`` and reflect every cell phase
    across the x axis, so ElogS(phi_c) is unchanged for every cell."""
    cycle.invert_direction()
    phases.invert_direction()


def shift_zero(cycle, phases, gene=None, phase=None):
    """Rotate the manifold zero point of a (Cycle, Phases) pair, in place.

    With ``gene=``: the Cycle is rotated so that gene's first-harmonic peak
    lands at phase zero, and the Phases by the phase of the cell where the
    gene's expected expression is largest.  With ``phase=``: both are
    rotated by the same fixed angle.
    """
    if gene is not None:
        if gene not in cycle.genes:
            raise KeyError(f"gene {gene!r} not found in Cycle")
        from .ops.fourier import fourier_basis

        phis = np.asarray(phases.phis, np.float32)
        zeta = fourier_basis(phis, cycle.harmonics).numpy()     # (Nc, Nh)
        row = list(cycle.genes).index(gene)
        elog_gene = cycle.means_array[row] @ zeta.T             # (Nc,)
        phase_shift = float(phis[int(np.argmax(elog_gene))])
        cycle.shift_zero(gene=gene)
        phases.shift_zero(phase=phase_shift)
    elif phase is not None:
        cycle.shift_zero(phase=phase)
        phases.shift_zero(phase=phase)
    else:
        raise ValueError("must specify gene= or phase= for the shift")
