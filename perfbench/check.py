"""The comparison that decides ``correct``.

The program's first steps (`phase_cell.ProgramRun.first_steps`) against
the plain reference's (`reference.phase_svi.follow`) from the same inputs
and root key, by five relative gaps.  A leaf's gap is |program -
reference| of a norm over the larger of the reference's norm of that leaf
and of the median leaf.

  loss_gap          the first step's |loss - reference| / |reference|;
  grad_gap_median   the median leaf's gap of the first gradient's norm,
                    steady from seed to seed, which TF32 moves;
  grad_gap_worst    the worst leaf's gap of it: a fault in one leaf's
                    gradient (a dispersion gradient scaled by a constant,
                    to which Adam's first steps are all but blind);
  change_gap        the worst leaf's gap of the norm of its change over the
                    first step: a leaf left unmoved, or moved twice;
  change_gap_steps  the same over all the steps, which follows Adam's
                    moments past the first step.
The change gaps take the leaves whose reference gradient is at least a
thousandth of the median leaf's (the others move under Adam by round-off
alone).  The later steps' losses and changes are compared loosely, or not
at all: Adam moves each element of the first step by the learning rate
whatever its gradient's size, so an element whose gradient is zero to
rounding goes either way, and on about one seed in a hundred that shifts
the later steps' losses by 1e-5 (PERF.md section 2).

A number whose limit is null is printed and not compared.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap_median", "grad_gap_worst", "change_gap",
           "change_gap_steps")
MOVED = 1e-3


def _max(values):
    """The largest of ``values``; inf if any is not finite (max() would
    pass over a NaN)."""
    values = list(values)
    return max(values) if all(map(math.isfinite, values)) else math.inf


def _leaf_gaps(prog, ref, names):
    floor = statistics.median(ref[k] for k in names)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor)
            for k in names]


def gaps(prog, ref):
    """{number: value} of the program's `Readings` against the
    reference's; leaves the two do not share, or any non-finite reading,
    give inf."""
    if set(prog.grad_norms) != set(ref.grad_norms) or len(
            prog.losses) != len(ref.losses):
        return {k: math.inf for k in NUMBERS}
    loss = _max([abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0])]
                + [0.0 * x for x in prog.losses])   # inf if any is not finite
    g = ref.grad_norms
    grads = _leaf_gaps(prog.grad_norms, g, list(g))
    worst = _max(grads)
    grad = statistics.median(grads) if worst < math.inf else math.inf
    moved = [k for k in g if g[k] >= MOVED * statistics.median(g.values())]
    change = _max(_leaf_gaps(prog.change_norms, ref.change_norms, moved))
    first = _max(_leaf_gaps(prog.first_change_norms, ref.first_change_norms,
                            moved))
    return {"loss_gap": loss, "grad_gap_median": grad,
            "grad_gap_worst": worst, "change_gap": first,
            "change_gap_steps": change}


def verdict(numbers, limits):
    """(every compared number within its limit, the numbers with their
    limits as {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": limits.get(k)}
             for k in NUMBERS}
    ok = all(math.isfinite(numbers[k]) and (
        limits.get(k) is None or numbers[k] <= limits[k]) for k in NUMBERS)
    return ok, shown
