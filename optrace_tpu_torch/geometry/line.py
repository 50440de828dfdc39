"""One-dimensional geometry: a line in a z-plane (counterpart of
``optrace_tpu/geometry/line.py``). Used by line sources."""

from typing import Any

import numpy as np
import torch

from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc
from ..ops import sampling


class Line(BaseClass):

    def __init__(self, r: float, angle: float = 0, **kwargs) -> None:
        self._lock = False
        self.pos = np.array([0., 0., 0.], dtype=np.float64)
        self.r = r
        self.angle = angle
        self.z_min = self.z_max = self.pos[2]
        super().__init__(**kwargs)
        self.lock()

    def move_to(self, pos) -> None:
        self._lock = False
        pos = np.asarray(pos, dtype=np.float64)
        pc.check_finite("pos", pos)
        self.pos = pos
        self.z_min = self.z_max = pos[2]
        self.lock()

    @property
    def extent(self):
        ang = np.deg2rad(self.angle)
        return (self.pos[0] - self.r * np.cos(ang), self.pos[0] + self.r * np.cos(ang),
                self.pos[1] - self.r * np.sin(ang), self.pos[1] + self.r * np.sin(ang),
                self.z_min, self.z_max)

    def flip(self) -> None:
        self._lock = False
        self.angle *= -1
        self.lock()

    def rotate(self, angle: float) -> None:
        self._lock = False
        self.angle += angle
        self.lock()

    def random_positions(self, gen: torch.Generator, N: int):
        ang = np.deg2rad(self.angle)
        t = sampling.stratified_interval_sampling(gen, N, -self.r, self.r)
        return torch.stack([self.pos[0] + float(np.cos(ang)) * t,
                            self.pos[1] + float(np.sin(ang)) * t,
                            torch.full_like(t, self.pos[2])], dim=-1)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "r":
            pc.check_type(key, val, (float, int))
            val = float(val)
            pc.check_above(key, val, 0)
        elif key == "angle":
            pc.check_type(key, val, (float, int))
            val = float(val)
        super().__setattr__(key, val)
