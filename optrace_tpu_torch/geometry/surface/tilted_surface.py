"""Tilted plane surface
(counterpart of ``optrace_tpu/geometry/surface/tilted_surface.py``)."""

from typing import Any

import numpy as np
import torch

from .surface import Surface
from ...ops import geom
from ...utils.property_checker import PropertyChecker as pc


class TiltedSurface(Surface):

    rotational_symmetry: bool = False

    def __init__(self, r: float, normal=None, normal_sph=None, **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)
        self.parax_roc = None
        self.z_min = self.z_max = self.pos[2]

        if normal is not None:
            self.normal = normal
        elif normal_sph is not None:
            pc.check_type("normal_sph", normal_sph, (list, np.ndarray))
            theta, phi = np.radians(normal_sph[0]), np.radians(normal_sph[1])
            self.normal = [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
        else:
            raise RuntimeError("normal or normal_sph parameter needs to be specified.")

        phi = np.arctan2(self.normal[1], self.normal[0])
        R = self.r
        v1 = self.pos[2] + float(self._values(np.array([R * np.cos(phi)]), np.array([R * np.sin(phi)]))[0])
        v2 = self.pos[2] + float(self._values(np.array([-R * np.cos(phi)]), np.array([-R * np.sin(phi)]))[0])
        self.z_min, self.z_max = min(v1, v2), max(v1, v2)
        self.lock()

    @property
    def info(self) -> str:
        return super().info + (f", normal = [{self.normal[0]:.4f}, {self.normal[1]:.4f}, "
                               f"{self.normal[2]:.4f}]")

    def _sag(self, x, y):
        mx = -self.normal[0] / self.normal[2]
        my = -self.normal[1] / self.normal[2]
        return x * mx + y * my

    def _normals_rel(self, x, y):
        n = torch.as_tensor(self.normal, dtype=x.dtype, device=x.device)
        return n.expand(*x.shape, 3)

    def _hit_t(self, o, s):
        t = geom.hit_tilted(o, s, self.normal)
        valid = torch.isfinite(t)
        return t, valid, torch.zeros(t.shape, dtype=torch.bool)

    def flip(self) -> None:
        self._lock = False
        n = self.normal.copy()
        n[0] *= -1
        object.__setattr__(self, "normal", n)
        self.lock()

    def rotate(self, angle: float) -> None:
        self._lock = False
        n = self.normal.copy()
        n[0], n[1] = self._rotate_rc(n[0], n[1], np.deg2rad(angle))
        object.__setattr__(self, "normal", n)
        self.lock()

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "normal" and val is not None:
            pc.check_type(key, val, (list, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            val2 = val2 / np.linalg.norm(val2)
            pc.check_above("normal[2]", val2[2], 0)
            super().__setattr__(key, val2)
            return
        super().__setattr__(key, val)
