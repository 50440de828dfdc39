"""Ideal (aberration-free) thin lens with optical power D in dpt
(counterpart of ``optrace_tpu/geometry/ideal_lens.py``). The trace applies
the ideal-lens refraction rule instead of Snell's law at its one surface."""

from .lens import Lens
from .surface import CircularSurface
from ..spectrum.refraction_index import RefractionIndex
from ..utils.property_checker import PropertyChecker as pc


class IdealLens(Lens):

    is_ideal: bool = True

    def __init__(self, r: float, D: float, pos, n2: RefractionIndex = None, **kwargs) -> None:
        pc.check_type("D", D, (int, float))
        pc.check_finite("D", D)
        self.D = float(D)
        if not D:
            raise ValueError("Optical Power needs to be non-zero")
        super().__init__(front=CircularSurface(r=r), back=CircularSurface(r=r),
                         n=RefractionIndex("Constant", n=1), pos=pos, d=0, n2=n2, **kwargs)

    @property
    def f(self) -> float:
        """geometrical focal length in mm (D in dpt = 1/m, so f = 1000/D)"""
        return 1000.0 / self.D
