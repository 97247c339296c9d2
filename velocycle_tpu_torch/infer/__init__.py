from .elbo import Trace_ELBO, TraceEnum_ELBO  # noqa: F401
from .svi import SVI, init_params  # noqa: F401
from .optim import ClippedAdam, adam, clipped_adam  # noqa: F401
from .autoguide import AutoDelta, AutoNormal  # noqa: F401
from .predictive import Predictive  # noqa: F401
from .mcmc import MCMC, hmc, init_model, nuts  # noqa: F401
from .smc import SMC, BridgedSMC  # noqa: F401
from .minibatch import (  # noqa: F401
    MinibatchSVI, split_cells, iter_host_blocks, init_template,
)
