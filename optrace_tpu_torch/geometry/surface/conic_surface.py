"""Conic section surface with closed-form intersection
(counterpart of ``optrace_tpu/geometry/surface/conic_surface.py``)."""

from typing import Any

import numpy as np
import torch

from .surface import Surface
from ...ops import geom
from ...utils.property_checker import PropertyChecker as pc


class ConicSurface(Surface):

    rotational_symmetry: bool = True

    def __init__(self, r: float, R: float, k: float, **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)
        self.R, self.k = R, k
        self.parax_roc = R

        # the conic section has an edge at (k+1)·(r/R)² = 1
        if (self.k + 1) * (self.r / self.R) ** 2 >= 1:
            raise ValueError("Surface radius r larger than radius of conic section.")

        z0 = self.pos[2]
        z1 = z0 + float(self._values(np.array([r]), np.array([0.]))[0])
        self.z_min, self.z_max = min(z0, z1), max(z0, z1)
        self.lock()

    @property
    def info(self) -> str:
        return super().info + f", R = {self.R:.5g} mm, k = {self.k:.5g}"

    def _sag(self, x, y):
        return geom.sag_conic(x, y, 1.0 / self.R, self.k)

    def _normals_rel(self, x, y):
        return geom.normal_conic(x, y, 1.0 / self.R, self.k)

    def _hit_t(self, o, s):
        z0 = self.z_min - self.pos[2]
        z1 = self.z_max - self.pos[2]
        t, valid = geom.hit_conic(o, s, 1.0 / self.R, self.k, z0, z1)
        return t, valid, torch.zeros(t.shape, dtype=torch.bool)

    def flip(self) -> None:
        """Flip around the x-axis: negates R and mirrors the z-extent."""
        self._lock = False
        self.R *= -1
        self.parax_roc *= -1
        a = self.pos[2] - (self.z_max - self.pos[2])
        b = self.pos[2] + (self.pos[2] - self.z_min)
        self.z_min, self.z_max = a, b
        self.lock()

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("R", "k"):
            pc.check_type(key, val, (float, int))
            val = float(val)
            if key == "R" and (val == 0 or not np.isfinite(val)):
                raise ValueError("R needs to be non-zero and finite. Use planar surface types instead.")
        super().__setattr__(key, val)
