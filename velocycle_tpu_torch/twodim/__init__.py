"""The 2-D extension: models, simulator and driver (port of
`velocycle_tpu/twodim`)."""
from .models import Velo2DData, velo2d_s_model, velo2d_u_model  # noqa: F401
from .simulate import generate_adata, make_designs  # noqa: F401
from .driver import (  # noqa: F401
    prepare_data, train_velo2d, evaluate_fit, run_simulations,
)
