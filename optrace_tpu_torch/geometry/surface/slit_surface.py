"""Rectangle with rectangular hole (slit aperture), with HURB edge distances
(counterpart of ``optrace_tpu/geometry/surface/slit_surface.py``)."""

from typing import Any

import numpy as np

from .rectangular_surface import RectangularSurface
from ...utils.property_checker import PropertyChecker as pc


class SlitSurface(RectangularSurface):

    rotational_symmetry: bool = False

    def __init__(self, dim, dimi, **kwargs) -> None:
        super().__init__(dim, **kwargs)
        self._lock = False
        self._new_lock = False
        self.dimi = np.asarray(dimi, dtype=np.float64)
        pc.check_finite("dimi", self.dimi)
        self.lock()

    @property
    def info(self) -> str:
        return super().info + f", dimi = [{self.dimi[0]:.5g} mm, {self.dimi[1]:.5g} mm]"

    def mask(self, x, y) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        xr, yr = self._rotate_rc(x - self.pos[0], y - self.pos[1], -self._angle)
        xs, xe, ys, ye = -self.dimi[0] / 2, self.dimi[0] / 2, -self.dimi[1] / 2, self.dimi[1] / 2
        inside = ((xs + self.N_EPS <= xr) & (xr <= xe - self.N_EPS)
                  & (ys + self.N_EPS <= yr) & (yr <= ye - self.N_EPS))
        return super().mask(x, y) & ~inside

    def hurb_props(self, x, y):
        """HURB distances to the slit edges (Freniere/Gregory/Hassler edge
        diffraction scheme).

        :return: (a = y-distances, b = x-distances, x-axis vectors, inside mask)
        """
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        x_, y_ = self._rotate_rc(x - self.pos[0], y - self.pos[1], -self._angle)
        a_ = self.dimi[1] / 2 - np.abs(y_)
        b_ = self.dimi[0] / 2 - np.abs(x_)
        inside = (a_ > 0) & (b_ > 0)
        b = np.zeros((b_.shape[0], 3))
        b[:, 0] = np.cos(self._angle)
        b[:, 1] = np.sin(self._angle)
        return a_, b_, b, inside

    def plotting_mesh(self, N: int):
        y = np.array([self._extent[2], -self.dimi[1] / 2, -self.dimi[1] / 2 + self.N_EPS,
                      self.dimi[1] / 2 - self.N_EPS, self.dimi[1] / 2, self._extent[3]])
        x = np.array([self._extent[0], -self.dimi[0] / 2, -self.dimi[0] / 2 + self.N_EPS,
                      self.dimi[0] / 2 - self.N_EPS, self.dimi[0] / 2, self._extent[1]])
        Y, X = np.meshgrid(y, x)
        x2, y2 = self._rotate_rc(X.flatten(), Y.flatten(), self._angle)
        X = self.pos[0] + x2.reshape(X.shape)
        Y = self.pos[1] + y2.reshape(Y.shape)
        Z = np.full(Y.shape, np.float64(self.pos[2]))
        nm = np.zeros(Y.shape, dtype=bool)
        nm[2:4, 2:4] = True
        Z[nm] = np.nan
        return X, Y, Z

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "dimi":
            pc.check_type(key, val, np.ndarray)
            if val.ndim != 1 or val.shape[0] != 2:
                raise TypeError("dimi needs to have two elements.")
            if val[0] >= self.dim[0] or val[1] >= self.dim[1]:
                raise ValueError("Dimensions dimi must be smaller than dimension dim.")
            if val[0] <= 0 or val[1] <= 0:
                raise ValueError(f"Dimensions dimi need to be positive, but are {val}")
        super().__setattr__(key, val)
