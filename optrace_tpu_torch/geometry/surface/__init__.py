from .surface import Surface  # noqa: F401
from .circular_surface import CircularSurface  # noqa: F401
from .ring_surface import RingSurface  # noqa: F401
from .conic_surface import ConicSurface  # noqa: F401
from .spherical_surface import SphericalSurface  # noqa: F401
from .rectangular_surface import RectangularSurface  # noqa: F401
