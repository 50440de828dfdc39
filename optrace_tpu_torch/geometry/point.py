"""Zero-dimensional geometry: a position in space (counterpart of
``optrace_tpu/geometry/point.py``). Used by point sources."""

import numpy as np
import torch

from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc


class Point(BaseClass):

    def __init__(self, **kwargs) -> None:
        self._lock = False
        self.pos = np.array([0., 0., 0.], dtype=np.float64)
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

    def flip(self) -> None:
        pass

    def rotate(self, angle: float) -> None:
        pass

    @property
    def extent(self):
        return tuple(self.pos.repeat(2))

    def random_positions(self, gen: torch.Generator, N: int):
        pos = torch.as_tensor(self.pos, dtype=torch.float32, device=gen.device)
        return pos.expand(N, 3)
