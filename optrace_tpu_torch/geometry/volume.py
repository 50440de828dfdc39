"""Non-interacting display volumes (counterpart of
``optrace_tpu/geometry/volume.py``): drawn with the scene, never traced."""

from typing import Any

import numpy as np

from .element import Element
from .surface import (RectangularSurface, SphericalSurface, CircularSurface)
from ..utils.property_checker import PropertyChecker as pc


class Volume(Element):
    """Two-surface display volume with color/opacity."""

    abbr: str = "V"

    def __init__(self, front, back, pos, d1, d2, color: tuple = None,
                 opacity: float = 0.3, **kwargs) -> None:
        self.opacity = opacity
        self.color = color
        super().__init__(front, pos, back, d1, d2, **kwargs)
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "opacity":
            pc.check_type(key, val, (float, int))
            val = float(val)
            pc.check_above(key, val, 0)
            pc.check_not_above(key, val, 1)
        elif key == "color" and val is not None:
            pc.check_type(key, val, (tuple, list))
        super().__setattr__(key, val)


class BoxVolume(Volume):
    """Axis-aligned box."""

    def __init__(self, dim, length: float, pos, color: tuple = None,
                 opacity: float = 0.3, **kwargs) -> None:
        pc.check_above("length", length, 0)
        front = RectangularSurface(dim=dim)
        back = RectangularSurface(dim=dim)
        super().__init__(front, back, pos, d1=0, d2=length, color=color,
                         opacity=opacity, **kwargs)


class SphereVolume(Volume):
    """Sphere from two hemispheres."""

    def __init__(self, R: float, pos, color: tuple = None,
                 opacity: float = 0.3, **kwargs) -> None:
        pc.check_above("R", R, 0)
        front = SphericalSurface(r=R * (1 - 1e-9), R=-R)
        back = SphericalSurface(r=R * (1 - 1e-9), R=R)
        super().__init__(front, back, pos, d1=R, d2=R, color=color,
                         opacity=opacity, **kwargs)

    @property
    def R(self) -> float:
        return abs(self.front.R)


class CylinderVolume(Volume):
    """z-axis cylinder."""

    def __init__(self, r: float, length: float, pos, color: tuple = None,
                 opacity: float = 0.3, **kwargs) -> None:
        pc.check_above("length", length, 0)
        front = CircularSurface(r=r)
        back = CircularSurface(r=r)
        super().__init__(front, back, pos, d1=0, d2=length, color=color,
                         opacity=opacity, **kwargs)
