"""Aperture element: absorbs rays hitting the surface mask
(reference optrace/tracer/geometry/aperture.py)."""

from .element import Element
from .surface import Surface


class Aperture(Element):

    abbr: str = "AP"
    _allow_non_2D: bool = False

    def __init__(self, surface: Surface, pos, **kwargs) -> None:
        super().__init__(surface, pos, **kwargs)
        self._new_lock = True
