"""AngularSpeed: Fourier coefficients of the angular velocity per condition.

Port of `velocycle_tpu/containers/angularspeed.py` on the shared
`FourierTable` base.  Columns are experimental conditions; rows ``nu0,
nu1_cos, ...`` describe the velocity Fourier series
``omega(phi) = sum_h nu_omega_h zeta_h(phi)``.
"""
from __future__ import annotations

import numpy as np

from .fourier_table import FourierTable

__all__ = ["AngularSpeed"]


class AngularSpeed(FourierTable):
    @property
    def conditions(self):
        return list(self.means.columns)

    @classmethod
    def from_array(cls, means_array, stds_array, condition_names=None,
                   num_coeffs=None):
        """Build from posterior arrays that may arrive transposed or with
        extra singleton dims.  ``num_coeffs`` = 2*harmonics + 1."""
        m = np.asarray(means_array).squeeze()
        s = np.asarray(stds_array).squeeze()
        if m.shape != s.shape:
            raise ValueError(
                f"means {m.shape} and stds {s.shape} arrays must have equal "
                "shapes"
            )
        if num_coeffs is None:
            num_coeffs = m.shape[0] if m.ndim else 1
        if m.ndim == 0:
            m = m.reshape(1, 1)
            s = s.reshape(1, 1)
        elif m.ndim == 1:
            # ambiguous: one condition (coeffs,) or one coeff (conditions,)
            if m.shape[0] == num_coeffs and (
                condition_names is None or len(condition_names) != num_coeffs
            ):
                m = m.reshape(num_coeffs, 1)
                s = s.reshape(num_coeffs, 1)
            else:
                m = m.reshape(1, -1)
                s = s.reshape(1, -1)
        elif m.shape[0] != num_coeffs and m.shape[1] == num_coeffs:
            m, s = m.T, s.T
        return cls._table_from_arrays(m, s, condition_names)

    @classmethod
    def trivial_prior(cls, condition_names, harmonics=1, means=0.0,
                      stds=3.0):
        """Default prior: constant-term mean/std from the arguments, higher
        harmonics tightly shrunk to 0 with std 0.05."""
        k = 2 * harmonics + 1
        n = len(condition_names)
        mu = np.concatenate([[means], np.zeros(k - 1)])
        sd = np.concatenate([[stds], np.full(k - 1, 0.05)])
        return cls._table_from_arrays(
            np.tile(mu[:, None], (1, n)),
            np.tile(sd[:, None], (1, n)),
            condition_names,
        )
