from .surface import Surface  # noqa: F401
from .circular_surface import CircularSurface  # noqa: F401
from .ring_surface import RingSurface  # noqa: F401
from .conic_surface import ConicSurface  # noqa: F401
from .spherical_surface import SphericalSurface  # noqa: F401
from .rectangular_surface import RectangularSurface  # noqa: F401
from .aspheric_surface import AsphericSurface  # noqa: F401
from .tilted_surface import TiltedSurface  # noqa: F401
from .slit_surface import SlitSurface  # noqa: F401
from .function_surface import FunctionSurface1D, FunctionSurface2D  # noqa: F401
from .data_surface import DataSurface1D, DataSurface2D  # noqa: F401
