"""Shared base for Fourier-coefficient tables (Cycle, AngularSpeed).

The reference implements two near-identical pandas-backed containers
(reference `velocycle/cycle.py:10-466`,
reference `velocycle/angularspeed.py:10-354`) for "a table of Fourier
coefficients per column-entity" — genes for Cycle, conditions for
AngularSpeed.  Here the shared structure lives once: two DataFrames
(`means`, `stds`) with rows ``nu0, nu1_cos, nu1_sin, nu2_cos, ...`` and one
column per entity, CSV persistence in the reference's exact on-disk format
(means stacked above stds, `cycle.py:252-260,166-185`).  Array views are numpy, transposed to the ``(entities, coeffs)``
layout the models use.  Port of `velocycle_tpu/containers/fourier_table.py`.
"""
from __future__ import annotations

import copy as _copy

import numpy as np
import pandas as pd

__all__ = ["FourierTable", "harmonic_index"]


def harmonic_index(num_coeffs):
    """Row labels ``["nu0", "nu1_cos", "nu1_sin", ...]`` for a coefficient
    table with ``num_coeffs`` rows (same naming as `cycle.py:319-322`)."""
    labels = ["nu0"]
    for i in range(num_coeffs - 1):
        labels.append(f"nu{i // 2 + 1}_{'sin' if i % 2 else 'cos'}")
    return labels


class FourierTable:
    """means/stds DataFrames of Fourier coefficients, columns = entities."""

    def __init__(self, means=None, stds=None):
        self.means: pd.DataFrame = means
        self.stds: pd.DataFrame = stds

    # -- basic protocol ----------------------------------------------------
    def __len__(self):
        return self.shape[-1]

    def __getitem__(self, key):
        out = type(self)()
        out.means = self.means[key]
        out.stds = self.stds[key]
        return out

    @property
    def shape(self):
        return self.means.shape

    @property
    def harmonics(self):
        """Number of harmonics H; the table has 2H+1 coefficient rows."""
        return (self.means.shape[0] - 1) // 2

    def copy(self):
        return _copy.deepcopy(self)

    # -- setters (accept array-likes, keep index/columns) ------------------
    def _coerce(self, new, like):
        if isinstance(new, pd.DataFrame):
            return new
        arr = np.asarray(new)
        df = pd.DataFrame(arr)
        df.index = like.index
        df.columns = like.columns
        return df

    def set_means(self, new_means):
        self.means = self._coerce(new_means, self.means)

    def set_stds(self, new_stds):
        self.stds = self._coerce(new_stds, self.stds)

    def extend(self, names, means=0.0, stds=10.0):
        """Append new column entities with a flat prior (in place)."""
        n = len(names)
        k = self.means.shape[0]
        ext_means = pd.DataFrame(
            np.broadcast_to(means, (k, n)).copy(),
            index=self.means.index, columns=names,
        )
        ext_stds = pd.DataFrame(
            np.broadcast_to(stds, (k, n)).copy(),
            index=self.stds.index, columns=names,
        )
        self.means = pd.concat([self.means, ext_means], axis=1)
        self.stds = pd.concat([self.stds, ext_stds], axis=1)

    def add_harmonics(self, extra_harmonics=1, means=None, stds=None):
        """Append ``extra_harmonics`` cos/sin row pairs (defaults: mean 0,
        std 10).  In place."""
        n_cols = self.shape[1]
        base = int(self.harmonics)
        mean_rows = (
            None if means is None
            else np.broadcast_to(means, (2 * extra_harmonics, n_cols)).copy()
        )
        std_rows = (
            None if stds is None
            else np.broadcast_to(stds, (2 * extra_harmonics, n_cols)).copy()
        )
        for i in range(extra_harmonics):
            h = base + 1 + i
            for j, trig in enumerate(("cos", "sin")):
                row = f"nu{h}_{trig}"
                self.means.loc[row] = (
                    np.zeros(n_cols) if mean_rows is None
                    else mean_rows[2 * i + j]
                )
                self.stds.loc[row] = (
                    10.0 * np.ones(n_cols) if std_rows is None
                    else std_rows[2 * i + j]
                )

    def remove_harmonics(self, n=1):
        """Drop the last ``n`` coefficient rows.  In place."""
        self.means = self.means.iloc[:-n, :]
        self.stds = self.stds.iloc[:-n, :]

    # -- device views ------------------------------------------------------
    @property
    def means_tensor(self):
        """(coeffs, entities) f32 array — same orientation as the reference's
        `means_tensor` (`cycle.py:271-279`)."""
        return self.means.values.astype(np.float32)

    @property
    def stds_tensor(self):
        return self.stds.values.astype(np.float32)

    @property
    def means_array(self):
        """(entities, coeffs) f32 array: model layout."""
        return self.means.values.astype(np.float32).T

    @property
    def stds_array(self):
        return self.stds.values.astype(np.float32).T

    # -- persistence (reference CSV format) --------------------------------
    def save(self, pathname):
        pd.concat([self.means, self.stds]).to_csv(pathname)

    @classmethod
    def load(cls, filepath):
        stacked = pd.read_csv(filepath, index_col=0)
        half = stacked.shape[0] // 2
        out = cls()
        out.means = stacked.iloc[:half, :]
        out.stds = stacked.iloc[half:, :]
        return out

    @classmethod
    def from_file(cls, filepath):
        return cls.load(filepath)

    # -- construction ------------------------------------------------------
    @classmethod
    def _table_from_arrays(cls, means_array, stds_array, columns=None):
        means_array = np.asarray(means_array)
        stds_array = np.asarray(stds_array)
        if means_array.shape != stds_array.shape:
            raise ValueError(
                f"means {means_array.shape} and stds {stds_array.shape} "
                "arrays must have equal shapes"
            )
        idx = harmonic_index(means_array.shape[0])
        out = cls()
        out.means = pd.DataFrame(means_array, index=idx, columns=columns)
        out.stds = pd.DataFrame(stds_array, index=idx, columns=columns)
        return out
