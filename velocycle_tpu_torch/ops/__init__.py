from .fourier import fourier_basis  # noqa: F401
from .circular import circular_corrcoef, pack_direction  # noqa: F401
from .likelihoods import nb_logpmf  # noqa: F401
from .splines import (  # noqa: F401
    spline_basis,
    spline_basis_2d,
    spline_basis_2d_der,
    spline_basis_auto,
    spline_knots,
)
