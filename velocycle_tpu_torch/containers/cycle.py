"""Cycle: per-gene Fourier harmonic coefficients of the cell-cycle manifold.

Port of the array, constructor and CSV part of `velocycle_tpu/containers/
cycle.py` on the shared `FourierTable` base.  Columns are genes; rows are
``nu0, nu1_cos, nu1_sin, ...``.  After a fit the container also holds the
per-gene NB dispersion (``disp``).  The circle-symmetry operations
(shift_zero, invert_direction, orientation checks) and the spline prior are
not ported yet.
"""
from __future__ import annotations

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


def reorder(cycle, gene_list):
    """New Cycle with columns in ``gene_list`` order."""
    return Cycle.from_array(
        means_array=cycle.means[gene_list].values,
        stds_array=cycle.stds[gene_list].values,
        gene_names=list(gene_list),
    )
