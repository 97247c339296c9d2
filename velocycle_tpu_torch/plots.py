"""Visualization and diagnostics, host-side (port of
`velocycle_tpu/plots.py`):

  * `check_model`: trace a model (or guide) once and print its site table;
  * `live_plot`: the two-panel ELBO curve a notebook fit redraws;
  * `plot_elbo`: one ELBO curve on an axis;
  * `pplot`: the polar plot of each gene's peak phase against its
    log-amplitude, coloured by S / G2M marker class.

Matplotlib is imported inside the functions, so importing the package
never needs it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["check_model", "live_plot", "pplot", "plot_elbo"]


def check_model(model, *args, **kwargs):
    """Print (and return) a site / type / shape table of one seeded
    execution of ``model(*args, **kwargs)``."""
    from .core import handlers

    tr = handlers.trace(handlers.seed(model, 0)).get_trace(*args, **kwargs)
    lines = []
    for name, site in tr.items():
        value = site["value"]
        shape = tuple(value.shape) if hasattr(value, "shape") else np.shape(value)
        obs = " obs" if site.get("is_observed") else ""
        lines.append(f"{site['type']:>13} {name:<24} {shape}{obs}")
    out = "\n".join(lines)
    print(out)
    return out


def live_plot(data_dict, figsize=(12, 5), title=""):
    """Two-panel live ELBO curve: the full history and the last 300 steps.
    Call from a notebook; it clears the cell's output each call."""
    import matplotlib.pyplot as plt

    try:
        from IPython.display import clear_output

        clear_output(wait=True)
    except ImportError:
        pass
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=figsize)
    for label, losses in data_dict.items():
        losses = np.asarray(losses)
        ax0.plot(losses, label=label)
        tail = losses[-300:]
        ax1.plot(np.arange(len(losses) - len(tail), len(losses)), tail,
                 label=label)
    ax0.set_xlabel("step")
    ax0.set_ylabel("ELBO loss")
    ax0.set_title(title or "ELBO")
    ax1.set_title("last 300 steps")
    ax0.legend(loc="upper right")
    plt.show()
    return fig


def plot_elbo(losses, ax=None):
    """Simple ELBO curve for scripts and tests."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.plot(np.asarray(losses))
    ax.set_xlabel("step")
    ax.set_ylabel("ELBO loss")
    return ax


def pplot(fit, show_names=False, show_markers=True, species="Human",
          min_amplitude=0.0, ax=None):
    """Polar plot of gene peak phase (angle) against log10 of amplitude over
    the harmonics' summed sd (radius), coloured by S / G2M marker
    membership.

    Args:
      fit: a `PhaseFitModel` after ``.fit()`` (or anything with a
        ``cycle_fit`` attribute), or a `Cycle`.
    """
    import matplotlib.pyplot as plt

    from .genes import (
        G2M_GENES_HUMAN, G2M_GENES_MOUSE, S_GENES_HUMAN, S_GENES_MOUSE,
    )

    cycle = getattr(fit, "cycle_fit", fit)
    genes = np.asarray(cycle.genes)
    theta = cycle.peak_phases()
    amp = cycle.amplitudes()
    sd_total = cycle.stds.values[1:3].sum(0)
    r = np.log10(amp / np.maximum(sd_total, 1e-12) + 1e-12)

    s_set = set(S_GENES_HUMAN if species == "Human" else S_GENES_MOUSE)
    g2m_set = set(G2M_GENES_HUMAN if species == "Human" else G2M_GENES_MOUSE)
    colors = np.array([
        "tab:red" if g in s_set else
        "tab:blue" if g in g2m_set else "lightgray"
        for g in genes
    ])

    keep = amp >= min_amplitude
    if ax is None:
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="polar")
    if show_markers:
        for cls, color in (("other", "lightgray"), ("S", "tab:red"),
                           ("G2M", "tab:blue")):
            mask = keep & (colors == color)
            ax.scatter(theta[mask], r[mask], s=12, c=color, label=cls,
                       alpha=0.8)
        ax.legend(loc="lower left", bbox_to_anchor=(1.0, 0.9))
    else:
        ax.scatter(theta[keep], r[keep], s=12, c="tab:gray")
    if show_names:
        for t, rr, g in zip(theta[keep], r[keep], genes[keep]):
            ax.annotate(g, (t, rr), fontsize=6)
    ax.set_title("gene peak phase vs log10 amplitude/sd")
    return ax
