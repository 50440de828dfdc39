"""Lens: two refracting surfaces + media (counterpart of
``optrace_tpu/geometry/lens.py``). Thickness conventions d / de / (d1, d2)
with overlap handling, paraxial analysis of the lens alone (``tma``)."""

from typing import Any

from .element import Element
from .surface import Surface
from ..spectrum.refraction_index import RefractionIndex
from ..utils.property_checker import PropertyChecker as pc


class Lens(Element):

    abbr: str = "L"
    _allow_non_2D: bool = False
    is_ideal: bool = False

    def __init__(self, front: Surface, back: Surface, n: RefractionIndex, pos,
                 de: float = 0, d: float = None, d1: float = None, d2: float = None,
                 n2: RefractionIndex = None, **kwargs) -> None:
        self.n = n
        self.n2 = n2
        d1 = float(d1) if d1 is not None else d1
        d2 = float(d2) if d2 is not None else d2

        if isinstance(front, Surface) and isinstance(back, Surface):
            if d is not None:
                de = d - front.dp - back.dn
                if de < 0:
                    # surfaces overlap in z (meniscus shapes): split d equally
                    d1 = d / 2
                    d2 = d / 2

            if de is not None and d1 is None and d2 is None:
                if de < 0:
                    d1 = -de / 2
                    d2 = -de / 2
                else:
                    d1 = de / 2. + front.dp
                    d2 = de / 2. + back.dn
            elif d1 is None or d2 is None:
                raise ValueError("Both thicknesses d1, d2 need to be specified")

        super().__init__(front, pos, back, d1, d2, **kwargs)
        self._new_lock = True

    @property
    def d(self) -> float:
        """center thickness"""
        return self.d1 + self.d2

    @property
    def de(self) -> float:
        """thickness extension between surface z-extents"""
        return float(self.back.z_min - self.front.z_max)

    def tma(self, wl: float = 555., n0: RefractionIndex = None):
        """Paraxial transfer-matrix analysis for this lens alone."""
        from ..analysis.tma import TMA
        return TMA([self], wl, n0)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "n2" and val is not None:
            pc.check_type(key, val, RefractionIndex)
        if key == "n":
            pc.check_type(key, val, RefractionIndex)
        super().__setattr__(key, val)
