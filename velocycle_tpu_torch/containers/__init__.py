from .fourier_table import FourierTable, harmonic_index  # noqa: F401
from .cycle import Cycle, reorder  # noqa: F401
from .phases import Phases  # noqa: F401
from .angularspeed import AngularSpeed  # noqa: F401
