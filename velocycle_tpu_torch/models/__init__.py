from .metapars import Metapars, PhaseData, VelocityData  # noqa: F401
from .basis import expression_basis, guide_phi, omega_basis, sample_phi  # noqa: F401
from .phase import phase_model, phase_guide  # noqa: F401
from .velocity import velocity_guide, velocity_guide_lrmn, velocity_model  # noqa: F401
