"""Detector element: non-interacting surface for image/spectrum rendering
(counterpart of ``optrace_tpu/geometry/detector.py``)."""

from typing import Any

from .element import Element
from .surface import (Surface, DataSurface1D, DataSurface2D,
                      FunctionSurface1D, FunctionSurface2D)


class Detector(Element):

    abbr: str = "DET"
    _allow_non_2D: bool = False

    def __init__(self, surface: Surface, pos, **kwargs) -> None:
        super().__init__(surface, pos, **kwargs)
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "front" and isinstance(val, (DataSurface2D, DataSurface1D,
                                               FunctionSurface1D, FunctionSurface2D)):
            raise RuntimeError("Data/Function surfaces are not supported as Detector surfaces.")
        super().__setattr__(key, val)
