"""Spherical surface (conic with k=0) plus sphere→plane projections for
detector unwrapping (counterpart of
``optrace_tpu/geometry/surface/spherical_surface.py``)."""

import numpy as np

from .conic_surface import ConicSurface


class SphericalSurface(ConicSurface):

    sphere_projection_methods: list = ["Equidistant", "Orthographic", "Equal-Area", "Stereographic"]

    rotational_symmetry: bool = True

    def __init__(self, r: float, R: float, **kwargs) -> None:
        self._lock = False
        super().__init__(r, R, k=0.0, **kwargs)
        self.lock()

    @property
    def info(self) -> str:
        return (f"{type(self).__name__}, pos = [{self.pos[0]:.5g} mm, {self.pos[1]:.5g} mm, "
                f"{self.pos[2]:.5g} mm], r = {self.r:.5g} mm, R = {self.R:.5g} mm")

    def sphere_projection(self, p: np.ndarray, projection_method: str = "Equidistant") -> np.ndarray:
        """Project cartesian points on the sphere onto plane coordinates
        . Sign convention: projected
        coordinates share the sign of the cartesian offsets."""
        p = np.asarray(p, dtype=np.float64)
        if projection_method == "Orthographic":
            return p.copy()

        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        x0, y0, z0 = self.pos
        zm = z0 + self.R    # sphere center z

        p_hit = p.copy()
        if projection_method == "Equidistant":
            r = np.hypot(x - x0, y - y0)
            theta = -np.sign(self.R) * np.arctan(r / (z - zm))
            phi = np.arctan2(y - y0, x - x0)
            p_hit[:, 0] = theta * np.cos(phi)
            p_hit[:, 1] = theta * np.sin(phi)

        elif projection_method == "Stereographic":
            r = np.hypot(x - x0, y - y0)
            theta = np.pi / 2 - np.arctan(r / (z - zm))
            phi = np.arctan2(y - y0, x - x0)
            rp = -2 * np.sign(self.R) * np.tan(np.pi / 4 - theta / 2)
            p_hit[:, 0] = rp * np.cos(phi)
            p_hit[:, 1] = rp * np.sin(phi)

        elif projection_method == "Equal-Area":
            x_ = (x - x0) / np.abs(self.R)
            y_ = (y - y0) / np.abs(self.R)
            z_ = (z - zm) / self.R
            p_hit[:, 0] = np.sqrt(2 / (1 - z_)) * x_
            p_hit[:, 1] = np.sqrt(2 / (1 - z_)) * y_

        else:
            raise ValueError(f"Invalid projection_method {projection_method}, "
                             f"must be one of {self.sphere_projection_methods}.")
        return p_hit
