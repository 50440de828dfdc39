"""Flat rectangular surface with in-plane rotation
(counterpart of ``optrace_tpu/geometry/surface/rectangular_surface.py``)."""

from typing import Any

import numpy as np
import torch

from .surface import Surface
from ...ops import sampling
from ...utils.property_checker import PropertyChecker as pc


class RectangularSurface(Surface):

    rotational_symmetry: bool = False

    def __init__(self, dim, **kwargs) -> None:
        self._lock = False
        self._angle = 0.0
        super().__init__(1, **kwargs)
        self.dim = np.asarray(dim, dtype=np.float64)
        pc.check_finite("dim", self.dim)
        self.parax_roc = np.inf
        self.z_min = self.z_max = self.pos[2]
        self.lock()

    @property
    def info(self) -> str:
        return (f"{type(self).__name__}, pos = [{self.pos[0]:.5g} mm, {self.pos[1]:.5g} mm, "
                f"{self.pos[2]:.5g} mm], dim = [{self.dim[0]:.5g} mm, {self.dim[1]:.5g} mm]")

    @property
    def extent(self):
        sx = abs(self.dim[0] * np.cos(self._angle)) + abs(self.dim[1] * np.sin(self._angle))
        sy = abs(self.dim[0] * np.sin(self._angle)) + abs(self.dim[1] * np.cos(self._angle))
        return (self.pos[0] - sx / 2, self.pos[0] + sx / 2,
                self.pos[1] - sy / 2, self.pos[1] + sy / 2,
                self.z_min, self.z_max)

    @property
    def _extent(self):
        """extent relative to center, unrotated"""
        return -self.dim[0] / 2, self.dim[0] / 2, -self.dim[1] / 2, self.dim[1] / 2, 0., 0.

    def rotate(self, angle: float) -> None:
        self._lock = False
        self._angle += np.deg2rad(angle)
        self.lock()

    def flip(self) -> None:
        self._lock = False
        self._angle *= -1
        self.lock()

    def mask(self, x, y) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        xr, yr = self._rotate_rc(x - self.pos[0], y - self.pos[1], -self._angle)
        xs, xe, ys, ye = self._extent[:4]
        return ((xs - self.N_EPS <= xr) & (xr <= xe + self.N_EPS)
                & (ys - self.N_EPS <= yr) & (yr <= ye + self.N_EPS))

    def plotting_mesh(self, N: int):
        xs, xe, ys, ye = self._extent[:4]
        Y, X = np.mgrid[ys:ye:5j, xs:xe:5j]
        x2, y2 = self._rotate_rc(X.flatten(), Y.flatten(), self._angle)
        X = self.pos[0] + x2.reshape(X.shape)
        Y = self.pos[1] + y2.reshape(Y.shape)
        Z = np.broadcast_to(np.float64(self.pos[2]), Y.shape)
        return X, Y, Z

    def edge(self, nc: int):
        if nc < 20:
            raise ValueError("Expected at least nc=20")
        N4 = int(nc / 4)
        dn = nc - 4 * N4
        xs, xe, ys, ye = self._extent[:4]
        x = np.concatenate((np.linspace(xs, xe, N4), np.full(N4, xe),
                            np.flip(np.linspace(xs, xe, N4)), np.full(N4 + dn, xs)))
        y = np.concatenate((np.full(N4, ys), np.linspace(ys, ye, N4),
                            np.full(N4, ye), np.flip(np.linspace(ys, ye, N4 + dn))))
        x, y = self._rotate_rc(x, y, self._angle)
        return self.pos[0] + x, self.pos[1] + y, np.full_like(y, self.pos[2])

    def random_positions(self, gen: torch.Generator, N: int):
        x, y = sampling.stratified_rectangle_sampling(gen, N, *self._extent[:4])
        if self._angle:
            c, s = np.cos(self._angle), np.sin(self._angle)
            x, y = x * c - y * s, x * s + y * c
        return torch.stack([x + self.pos[0], y + self.pos[1],
                            torch.full_like(x, self.pos[2])], dim=-1)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "dim":
            pc.check_type(key, val, np.ndarray)
            if val.ndim != 1 or val.shape[0] != 2:
                raise TypeError("dim needs to have two elements.")
            if val[0] <= 0 or val[1] <= 0:
                raise ValueError(f"Dimensions dim need to be positive, but are {val}")
        super().__setattr__(key, val)
