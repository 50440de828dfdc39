"""Annotation markers (counterpart of ``optrace_tpu/geometry/marker.py``):
drawn with the scene, never traced."""

from typing import Any

from .element import Element
from .point import Point
from .line import Line
from ..utils.property_checker import PropertyChecker as pc


class PointMarker(Element):
    """Point + text annotation in the scene."""

    abbr: str = "M"

    def __init__(self, desc: str, pos, text_factor: float = 1.,
                 marker_factor: float = 1., label_only: bool = False, **kwargs) -> None:
        self.marker_factor = marker_factor
        self.text_factor = text_factor
        self.label_only = label_only
        super().__init__(Point(), pos, desc=desc, **kwargs)
        self._geometry_lock = True
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("text_factor", "marker_factor"):
            pc.check_type(key, val, (float, int))
        elif key == "label_only":
            pc.check_type(key, val, bool)
        super().__setattr__(key, val)


class LineMarker(Element):
    """Line + text annotation in the scene."""

    abbr: str = "LM"

    def __init__(self, r: float, pos, desc: str = "", angle: float = 0,
                 text_factor: float = 1., line_factor: float = 1., **kwargs) -> None:
        self.text_factor = text_factor
        self.line_factor = line_factor
        super().__init__(Line(r=r, angle=angle), pos, desc=desc, **kwargs)
        self._geometry_lock = True
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("text_factor", "line_factor"):
            pc.check_type(key, val, (float, int))
        super().__setattr__(key, val)
