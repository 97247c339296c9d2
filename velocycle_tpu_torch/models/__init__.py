from .metapars import Metapars, PhaseData, VelocityData  # noqa: F401
from .basis import expression_basis, guide_phi, omega_basis, sample_phi  # noqa: F401
from .phase import (  # noqa: F401
    phase_guide,
    phase_guide_lba,
    phase_model,
    phase_model_lba,
    phase_model_lba_enum,
)
from .velocity import velocity_guide, velocity_guide_lrmn, velocity_model  # noqa: F401
