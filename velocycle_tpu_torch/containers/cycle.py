"""Cycle: per-gene Fourier harmonic coefficients of the cell-cycle manifold.

Port of `velocycle_tpu/containers/cycle.py` on the shared `FourierTable`
base.  Columns are genes; rows are ``nu0, nu1_cos, nu1_sin, ...``.  After a
fit the container also holds the per-gene NB dispersion (``disp``) and, after
a velocity fit, the kinetics (``log_gammas``, ``log_betas``);
`Cycle.spline_prior` builds the B-spline manifold's prior.

`shift_zero` keeps the JAX package's deliberate divergence from the
reference: harmonic ``h`` is rotated by ``h*delta`` (the correct phase
shift of a Fourier series), where the reference rotates every harmonic by
the first harmonic's angle.
"""
from __future__ import annotations

from math import atan2

import numpy as np

from .fourier_table import FourierTable

__all__ = ["Cycle", "reorder"]


class Cycle(FourierTable):
    def __init__(self, means=None, stds=None):
        super().__init__(means, stds)
        self.log_gammas = None
        self.log_betas = None
        self.disp = None
        self.periodic = None

    # reference-compatible alias (`cycle.py:137-144`)
    @property
    def disp_pyro(self):
        return self.disp

    def set_log_gammas(self, v):
        self.log_gammas = v

    def set_log_betas(self, v):
        self.log_betas = v

    def set_disp(self, v):
        self.disp = v

    set_disp_pyro = set_disp

    @property
    def genes(self):
        return list(self.means.columns)

    @classmethod
    def from_array(cls, means_array, stds_array, gene_names=None):
        if gene_names is not None:
            n = np.asarray(means_array).shape[1]
            if len(gene_names) != n:
                raise ValueError(f"{len(gene_names)} gene names for {n} genes")
        return cls._table_from_arrays(means_array, stds_array, gene_names)

    @classmethod
    def trivial_prior(cls, gene_names, harmonics=2, means=0.0, stds=3.0):
        """Flat prior over genes.  For H in {1,2} the reference hard-codes a
        per-harmonic std ladder overriding the ``stds`` argument
        (`cycle.py:342-345`); reproduced for drop-in parity."""
        if harmonics == 1:
            stds = np.array([0.1, 0.2, 0.2])[:, None]
        elif harmonics == 2:
            stds = np.array([0.1, 0.2, 0.2, 0.1, 0.1])[:, None]
        k = 2 * harmonics + 1
        n = len(gene_names)
        return cls._table_from_arrays(
            np.broadcast_to(means, (k, n)).copy(),
            np.broadcast_to(stds, (k, n)).copy(),
            gene_names,
        )

    @classmethod
    def spline_prior(cls, gene_names, n_basis=10, means=0.0, stds=1.0):
        """Flat prior for a B-spline expression basis: ``n_basis + 1``
        coefficient rows (leading constant column)."""
        k = n_basis + 1
        n = len(gene_names)
        return cls._table_from_arrays(
            np.broadcast_to(means, (k, n)).copy(),
            np.broadcast_to(stds, (k, n)).copy(),
            gene_names,
        )

    # -- circle-symmetry operations ---------------------------------------
    def shift_zero(self, gene=None, phase=None):
        """Rotate the manifold so ``gene``'s first-harmonic peak (or the
        given ``phase``) lands at phase zero.  In place."""
        if gene is not None:
            if gene not in self.means.columns:
                raise KeyError(f"gene {gene!r} not found in Cycle")
            c1, s1 = self.means[gene].iloc[1:3].values
            delta = atan2(s1, c1)
        elif phase is not None:
            delta = float(phase)
        else:
            raise ValueError("specify either gene= or phase= for the shift")

        vals = self.means.values.copy()
        for h in range(1, self.harmonics + 1):
            ch, sh = np.cos(h * delta), np.sin(h * delta)
            c_rows = vals[2 * h - 1, :].copy()
            s_rows = vals[2 * h, :].copy()
            # nu expressed in phi' = phi - delta coordinates
            vals[2 * h - 1, :] = c_rows * ch + s_rows * sh
            vals[2 * h, :] = -c_rows * sh + s_rows * ch
        self.set_means(vals)

    def invert_direction(self):
        """Mirror the cycle direction: negate every sin row.  In place."""
        vals = self.means.values.copy()
        sin_rows = 2 * (1 + np.arange(self.harmonics))
        vals[sin_rows, :] = -vals[sin_rows, :]
        self.set_means(vals)

    def check_orientation(self, gene_pair=("TOP2A", "E2F1")):
        """True when the first gene peaks before the second going around the
        circle (the reference's TOP2A/E2F1 orientation test)."""
        g1, g2 = gene_pair
        if g1 not in self.means.columns or g2 not in self.means.columns:
            raise KeyError(f"gene pair {gene_pair} not found in Cycle")
        phi = []
        for g in (g1, g2):
            c1, s1 = self.means[g].iloc[1:3].values
            a = atan2(s1, c1)
            phi.append(a + 2 * np.pi if a < 0 else a)
        return (phi[1] - phi[0]) > 0

    def peak_phases(self):
        """Per-gene first-harmonic peak phase in [0, 2*pi)."""
        c1 = self.means.iloc[1].values
        s1 = self.means.iloc[2].values
        return np.mod(np.arctan2(s1, c1), 2 * np.pi)

    def amplitudes(self):
        """Per-gene first-harmonic amplitude |nu1|."""
        return np.hypot(self.means.iloc[1].values, self.means.iloc[2].values)


def reorder(cycle, gene_list):
    """New Cycle with columns in ``gene_list`` order."""
    return Cycle.from_array(
        means_array=cycle.means[gene_list].values,
        stds_array=cycle.stds[gene_list].values,
        gene_names=list(gene_list),
    )
