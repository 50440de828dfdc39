"""Flat disc surface (counterpart of
``optrace_tpu/geometry/surface/circular_surface.py``)."""

import numpy as np
import torch

from .surface import Surface
from ...ops import sampling


class CircularSurface(Surface):

    rotational_symmetry: bool = True

    def __init__(self, r: float, **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)
        self.parax_roc = np.inf
        self.z_min = self.z_max = self.pos[2]
        self.lock()

    def random_positions(self, gen: torch.Generator, N: int):
        """N stratified-uniform positions on the disc, (N, 3) on the
        generator's device."""
        x, y = sampling.stratified_ring_sampling(gen, N, 0.0, self.r)
        return torch.stack([x + self.pos[0], y + self.pos[1],
                            torch.full_like(x, self.pos[2])], dim=-1)
