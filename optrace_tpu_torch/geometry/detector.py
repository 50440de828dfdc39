"""Detector element: non-interacting surface for image/spectrum rendering
(counterpart of ``optrace_tpu/geometry/detector.py``)."""

from .element import Element
from .surface import Surface


class Detector(Element):

    abbr: str = "DET"
    _allow_non_2D: bool = False

    def __init__(self, surface: Surface, pos, **kwargs) -> None:
        super().__init__(surface, pos, **kwargs)
        self._new_lock = True

