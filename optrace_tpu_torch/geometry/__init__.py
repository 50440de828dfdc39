"""Scene geometry: surfaces, elements, groups (counterpart of
``optrace_tpu/geometry``)."""

from .surface import (Surface, CircularSurface, RingSurface, ConicSurface,  # noqa: F401
                      SphericalSurface, RectangularSurface, AsphericSurface,
                      TiltedSurface, SlitSurface)
from .point import Point  # noqa: F401
from .line import Line  # noqa: F401
from .element import Element  # noqa: F401
from .lens import Lens  # noqa: F401
from .ideal_lens import IdealLens  # noqa: F401
from .filter import Filter  # noqa: F401
from .aperture import Aperture  # noqa: F401
from .detector import Detector  # noqa: F401
from .ray_source import RaySource  # noqa: F401
from .group import Group  # noqa: F401
