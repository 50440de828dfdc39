"""Element: front (+ optional back) surface container
(counterpart of ``optrace_tpu/geometry/element.py``).

front = surface with smaller z; d1/d2 = z-distances of front/back surface
centers from the element position; geometry lock forbids direct surface
reassignment (use set_surface)."""

from typing import Any

import numpy as np

from .surface import Surface
from .point import Point
from .line import Line
from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc


class Element(BaseClass):

    abbr: str = "EL"
    _allow_non_2D: bool = True

    def __init__(self, front, pos, back=None, d1: float = None, d2: float = None,
                 **kwargs) -> None:
        self._geometry_lock = False
        self.front = front
        self.back = back
        self.d1 = d1
        self.d2 = d2

        if self.has_back():
            if d1 is None or d2 is None:
                raise ValueError("d1 and d2 need to be specified for a Element with a back surface")
            if d1 < 0 or d2 < 0:
                raise ValueError(f"Thicknesses d1, d2 need to be non-negative but are {d1=} and {d2=}.")

        self.move_to(pos)
        super().__init__(**kwargs)
        self._geometry_lock = True

    # ------------------------------------------------------------------
    def has_back(self) -> bool:
        return self.back is not None

    def set_surface(self, surf: Surface) -> None:
        """Assign a new surface (single-surface elements only)."""
        if self.has_back():
            raise RuntimeError("Replacing of Surfaces only supported for objects with one surface")
        self._geometry_lock = False
        pos = self.front.pos
        object.__setattr__(self, "front", surf.copy())
        self.front.move_to(pos)
        self._geometry_lock = True

    def move_to(self, pos) -> None:
        pc.check_type("pos", pos, (list, np.ndarray))
        pos = np.asarray(pos, dtype=np.float64)
        pc.check_finite("pos", pos)
        if pos.shape[0] != 3:
            raise ValueError("pos needs to have 3 elements.")
        if not self.has_back():
            self.front.move_to(pos)
        else:
            self.front.move_to(pos - [0, 0, self.d1])
            self.back.move_to(pos + [0, 0, self.d2])

    @property
    def surface(self):
        return self.front

    @property
    def pos(self) -> np.ndarray:
        return self.front.pos + [0, 0, 0 if not self.has_back() else self.d1]

    @property
    def extent(self):
        if not self.has_back():
            return self.front.extent
        exts = np.column_stack((self.front.extent, self.back.extent))
        ext = np.zeros(6, dtype=np.float64)
        ext[[0, 2, 4]] = np.min(exts, axis=1)[[0, 2, 4]]
        ext[[1, 3, 5]] = np.max(exts, axis=1)[[1, 3, 5]]
        return tuple(ext)

    def get_desc(self, fallback: str = None) -> str:
        stype1 = type(self.front).__name__
        if self.has_back():
            fallback = f"{stype1} + {type(self.back).__name__}, z = {self.pos[2]:.04g}"
        else:
            fallback = f"{stype1}, z = {self.pos[2]:.04g}"
        return super().get_desc(fallback)

    def cylinder_surface(self, nc: int = 100):
        """3D cylinder side mesh between front and back edge (for plotting)."""
        X1, Y1, Z1 = self.front.edge(nc)
        X2, Y2, Z2 = self.back.edge(nc) if self.has_back() else (X1, Y1, Z1)
        return np.column_stack((X1, X2)), np.column_stack((Y1, Y2)), np.column_stack((Z1, Z2))

    def flip(self) -> None:
        """Flip around the x-axis; absolute position stays the same."""
        if self.has_back():
            self._geometry_lock = False
            self.back.flip()
            self.front.flip()
            zp = self.pos[2]
            self.front.move_to([*self.front.pos[:2], zp + self.d1])
            self.back.move_to([*self.back.pos[:2], zp - self.d2])
            front, back = self.front, self.back
            object.__setattr__(self, "front", back)
            object.__setattr__(self, "back", front)
            self.d1, self.d2 = self.d2, self.d1
            self._geometry_lock = True
        else:
            self.front.flip()

    def rotate(self, angle: float) -> None:
        self.front.rotate(angle)
        if self.has_back():
            self.back.rotate(angle)

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if self.__dict__.get("_geometry_lock", False):
            if key in ("d1", "d2", "front", "surface", "back"):
                raise RuntimeError("Use set_surface to reassign a new Surface or its thickness.")
            if key == "pos":
                raise RuntimeError("Use move_to(pos) to move the object")

        if key == "front":
            types = (Surface, Point, Line) if self._allow_non_2D else Surface
            pc.check_type(key, val, types)
            super().__setattr__(key, val.copy())
            return
        if key == "back" and val is not None:
            types = (Surface, Point, Line) if self._allow_non_2D else Surface
            pc.check_type(key, val, types)
            super().__setattr__(key, val.copy())
            return
        if key in ("d1", "d2") and val is not None:
            pc.check_type(key, val, (int, float))
            val = float(val)
        super().__setattr__(key, val)
