"""Even asphere: conic + polynomial Σ aᵢ r^(2(i+1))
(counterpart of ``optrace_tpu/geometry/surface/aspheric_surface.py``)."""

from typing import Any

import numpy as np

from .conic_surface import ConicSurface
from ...ops import geom
from ...utils.property_checker import PropertyChecker as pc


class AsphericSurface(ConicSurface):

    rotational_symmetry: bool = True

    def __init__(self, r: float, R: float, k: float, coeff: list, **kwargs) -> None:
        self._lock = False
        self.coeff = coeff
        super(ConicSurface, self).__init__(r, **kwargs)
        self.R, self.k = R, k

        # paraxial curvature includes the r² polynomial term: 1/roc = 1/R + 2·a0
        self.parax_roc = 1.0 / (1.0 / R + 2.0 * self.coeff[0])

        if (self.k + 1) * (self.r / self.R) ** 2 >= 1:
            raise ValueError("Surface radius r larger than radius of conic section.")

        self.z_min, self.z_max = 0.0, 0.0
        self.z_min, self.z_max = self._find_bounds()
        self.z_min += self.pos[2]
        self.z_max += self.pos[2]
        self.lock()

    @property
    def info(self) -> str:
        return super().info + f", coeff = {self.coeff}"

    def _sag(self, x, y):
        return geom.sag_asphere(x, y, 1.0 / self.R, self.k, self.coeff)

    def _normals_rel(self, x, y):
        return geom.normal_asphere(x, y, 1.0 / self.R, self.k, self.coeff)

    def _hit_t(self, o, s):
        z0 = self.z_min - self.pos[2]
        z1 = self.z_max - self.pos[2]
        return geom.hit_newton(self._sag, o, s, z0, z1)

    def flip(self) -> None:
        """Flip around the x-axis: negate R and all polynomial coefficients."""
        self._lock = False
        self.R *= -1
        self.parax_roc *= -1
        self.coeff = [-c for c in self.coeff]
        a = self.pos[2] - (self.z_max - self.pos[2])
        b = self.pos[2] + (self.pos[2] - self.z_min)
        self.z_min, self.z_max = a, b
        self.lock()

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "coeff":
            pc.check_type(key, val, (list, np.ndarray))
            val = [float(v) for v in val]
            if len(val) == 0:
                raise ValueError("coeff can't be empty.")
            if not all(np.isfinite(val)):
                raise ValueError("coeff must be finite.")
        super().__setattr__(key, val)
