"""Annulus surface (aperture opening), with HURB ellipse properties
(counterpart of ``optrace_tpu/geometry/surface/ring_surface.py``)."""

from typing import Any

import numpy as np
import torch

from .surface import Surface, _t64
from ...ops import sampling, geom
from ...utils.property_checker import PropertyChecker as pc


class RingSurface(Surface):

    rotational_symmetry: bool = True

    def __init__(self, r: float, ri: float, **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)
        self.r, self.ri = r, ri
        self.parax_roc = np.inf
        self.z_min = self.z_max = self.pos[2]
        if ri >= r:
            raise ValueError("ri needs to be smaller than r.")
        self.lock()

    @property
    def info(self) -> str:
        return super().info + f", ri = {self.ri:.5g} mm"

    def mask(self, x, y) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        return geom.mask_ring(_t64(x - self.pos[0]), _t64(y - self.pos[1]), self.ri, self.r).numpy()

    def hurb_props(self, x, y):
        """HURB inscribed-ellipse axes for rays inside the opening:
        minor b = R−r to the edge, major a = √(bR) (curvature-matched
        ellipse).

        :return: (a, b, minor-axis unit vectors (N,3), inside mask)
        """
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        r = np.hypot(x - self.pos[0], y - self.pos[1])
        theta = np.arctan2(y - self.pos[1], x - self.pos[0])
        R = self.ri
        inside = r < R
        b_ = R - r
        with np.errstate(invalid="ignore"):
            a_ = np.sqrt(np.maximum(b_ * R, 0.0))
        b = np.zeros((b_.shape[0], 3))
        b[:, 0] = np.cos(theta)
        b[:, 1] = np.sin(theta)
        return a_, b_, b, inside

    def random_positions(self, gen: torch.Generator, N: int):
        x, y = sampling.stratified_ring_sampling(gen, N, self.ri, self.r)
        return torch.stack([x + self.pos[0], y + self.pos[1],
                            torch.full_like(x, self.pos[2])], dim=-1)

    def plotting_mesh(self, N: int):
        X0, Y0, Z = super().plotting_mesh(N)
        X, Y = X0 - self.pos[0], Y0 - self.pos[1]
        R = np.sqrt(X ** 2 + Y ** 2)
        Phi = np.arctan2(Y, X)
        if self.ri < self.r / 2:
            rr = self.r - self.ri
            mask4 = R <= (self.ri + rr / 3)
            mask5 = (R > (self.ri + rr / 3)) & (R < (self.ri + 2 / 3 * rr))
        else:
            mask4 = R < self.ri / 2
            mask5 = (R < self.ri) & (R >= self.ri / 2)
        X[mask4] = (self.ri - 4 * self.N_EPS) * np.cos(Phi[mask4])
        Y[mask4] = (self.ri - 4 * self.N_EPS) * np.sin(Phi[mask4])
        Z[mask4] = np.nan
        X[mask5] = (self.ri + 4 * self.N_EPS) * np.cos(Phi[mask5])
        Y[mask5] = (self.ri + 4 * self.N_EPS) * np.sin(Phi[mask5])
        Z[mask5] = self.pos[2]
        return X + self.pos[0], Y + self.pos[1], Z

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "ri":
            pc.check_type(key, val, (float, int))
            val = float(val)
            pc.check_above(key, val, 0)
        super().__setattr__(key, val)
