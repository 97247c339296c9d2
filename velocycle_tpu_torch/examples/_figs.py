"""Optional figure capture for the port's example scripts.

``VCT_FIGDIR=dir python velocycle_tpu_torch/examples/01_... .py`` saves the
workflow's key figures (ELBO curve, fitted-vs-true phase scatter, polar
coefficient plot) as PNGs into ``dir``; without the variable every helper
does nothing, so the examples need no matplotlib by default.
"""
import os

FIGDIR = os.environ.get("VCT_FIGDIR")


def _save(fig, name):
    import matplotlib

    matplotlib.use("Agg")
    os.makedirs(FIGDIR, exist_ok=True)
    path = os.path.join(FIGDIR, name)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    print(f"[fig] {path}")


def fig_elbo(losses, name, title="SVI ELBO"):
    if not FIGDIR:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(np.asarray(losses))
    ax.set_xlabel("step")
    ax.set_ylabel("-ELBO")
    ax.set_title(title)
    ax.set_yscale("log")
    _save(fig, name)
    plt.close(fig)


def fig_phase_scatter(fit_phis, true_phis, name,
                      title="fitted vs simulated phase"):
    if not FIGDIR:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(np.mod(np.asarray(true_phis), 2 * np.pi),
               np.mod(np.asarray(fit_phis), 2 * np.pi), s=6, alpha=0.5)
    ax.set_xlabel("simulated phase")
    ax.set_ylabel("fitted phase")
    ax.set_title(title)
    _save(fig, name)
    plt.close(fig)


def fig_polar(fit, name, title="harmonic coefficients (polar)"):
    if not FIGDIR:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    cyc = fit.cycle_fit
    m = np.asarray(cyc.means.values)                # (Nh, Ng)
    amp = np.hypot(m[1], m[2])
    ang = np.arctan2(m[2], m[1])
    fig = plt.figure(figsize=(4.5, 4.5))
    ax = fig.add_subplot(projection="polar")
    ax.scatter(ang, amp, s=10)
    ax.set_title(title)
    _save(fig, name)
    plt.close(fig)


def fig_spline_field(t, fit_curves, true_curves, name, n_genes=4,
                     title="spline expression field: fit vs truth"):
    """Fitted vs true ElogS over the pseudotime manifold, first
    ``n_genes`` genes (example 04)."""
    if not FIGDIR:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    t = np.asarray(t)
    order = np.argsort(t)
    fig, ax = plt.subplots(figsize=(5.5, 3.5))
    for g in range(min(n_genes, len(fit_curves))):
        (line,) = ax.plot(t[order], np.asarray(true_curves)[g][order],
                          lw=2, alpha=0.6)
        ax.plot(t[order], np.asarray(fit_curves)[g][order], "--",
                color=line.get_color(), lw=1.5)
    ax.set_xlabel("pseudotime")
    ax.set_ylabel("ElogS (solid: truth, dashed: fit)")
    ax.set_title(title)
    _save(fig, name)
    plt.close(fig)


def fig_quiver2d(x, y, v_fit, v_true, name,
                 title="2-D velocity field: fit (black) vs truth (red)"):
    """Fitted vs true velocity vectors at the cell positions
    (example 08)."""
    if not FIGDIR:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    x, y = np.asarray(x), np.asarray(y)
    v_fit, v_true = np.asarray(v_fit), np.asarray(v_true)
    stride = max(1, x.size // 120)
    sl = slice(None, None, stride)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.quiver(x[sl], y[sl], v_true[0][sl], v_true[1][sl], color="crimson",
              alpha=0.55, width=0.004, label="truth")
    ax.quiver(x[sl], y[sl], v_fit[0][sl], v_fit[1][sl], color="black",
              alpha=0.8, width=0.003, label="fit")
    ax.set_xlabel("manifold x")
    ax.set_ylabel("manifold y")
    ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    _save(fig, name)
    plt.close(fig)
