"""Scene container (counterpart of ``optrace_tpu/geometry/group.py``): typed
element lists, z-sorted iteration, flip with media-chain remap, rotation.
Markers, volumes and the group TMA arrive with their slices."""

from __future__ import annotations

from typing import Any

import numpy as np

from .lens import Lens
from .ideal_lens import IdealLens
from .filter import Filter
from .aperture import Aperture
from .detector import Detector
from .ray_source import RaySource
from .surface import Surface
from ..spectrum.refraction_index import RefractionIndex
from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc
from ..utils.warnings import warning


class Group(BaseClass):

    def __init__(self, elements: list = None, n0: RefractionIndex = None, **kwargs) -> None:
        self.lenses = []
        self.apertures = []
        self.filters = []
        self.detectors = []
        self.ray_sources = []
        self.n0 = n0
        super().__init__(**kwargs)
        if elements is not None:
            self.add(elements)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "n0":
            if val is None:
                val = RefractionIndex("Constant", n=1)
            pc.check_type(key, val, RefractionIndex)
        super().__setattr__(key, val)

    # ------------------------------------------------------------------
    @property
    def elements(self) -> list:
        """all elements, z-sorted"""
        return sorted(self._elements, key=lambda el: el.pos[2])

    @property
    def _elements(self) -> list:
        return [*self.lenses, *self.apertures, *self.filters, *self.ray_sources,
                *self.detectors]

    @property
    def pos(self) -> np.ndarray:
        return self.elements[0].pos if len(self._elements) else np.array([0., 0., 0.])

    @property
    def tracing_surfaces(self) -> list[Surface]:
        """All light-interacting surfaces (lens front/back, filters,
        apertures), z-sorted. IdealLens contributes one surface."""
        surfs = []
        for el in self.elements:
            if isinstance(el, (Lens, Filter, Aperture)):
                surfs.append(el.front)
                if el.has_back() and not isinstance(el, IdealLens):
                    surfs.append(el.back)
        return surfs

    @property
    def extent(self):
        els = self._elements
        if not len(els):
            return 0, 0, 0, 0, 0, 0
        ext = np.array([el.extent for el in els])
        mn, mx = np.min(ext, axis=0), np.max(ext, axis=0)
        return mn[0], mx[1], mn[2], mx[3], mn[4], mx[5]

    # ------------------------------------------------------------------
    def move_to(self, pos) -> None:
        """Move so that the z-first element sits at pos; relative distances kept."""
        pc.check_type("pos", pos, (list, np.ndarray))
        pos = np.asarray(pos, dtype=np.float64)
        pc.check_finite("pos", pos)
        if pos.shape[0] != 3:
            raise ValueError("pos needs to have exactly 3 elements.")
        pos0 = self.pos
        for el in self._elements:
            el.move_to(el.pos - (pos0 - pos))

    def flip(self, y0: float = 0, z0: float = None) -> None:
        """Flip the whole group around an x-parallel axis through (y0, z0),
        reversing element order and remapping the media chain n0/n2
       ."""
        if not len(self._elements):
            return
        els = self.elements
        ns = [self.n0] + [L.n2 for L in els if isinstance(L, Lens)]
        z0 = np.mean(self.extent[4:]) if z0 is None else z0

        self.clear()
        els.reverse()
        self.add(els)
        for el in els:
            el.flip()
            el.move_to([el.pos[0], y0 - (el.pos[1] - y0), z0 - (el.pos[2] - z0)])

        ns.reverse()
        ns = [nsi if nsi is not None else self.n0 for nsi in ns]
        self.n0 = ns[0]
        for n2, L in zip(ns[1:], self.lenses):
            L.n2 = n2

    def rotate(self, angle: float, x0: float = 0, y0: float = 0) -> None:
        """Rotate the group around a z-parallel axis through (x0, y0)."""
        if not len(self._elements):
            return
        ang = np.deg2rad(angle)
        for el in self.elements:
            xr = el.pos[0] - x0
            yr = el.pos[1] - y0
            posr = [x0 + xr * np.cos(ang) - yr * np.sin(ang),
                    y0 + xr * np.sin(ang) + yr * np.cos(ang), el.pos[2]]
            el.rotate(angle)
            el.move_to(posr)

    # ------------------------------------------------------------------
    def add(self, el) -> None:
        """Add an element, list of elements or another group."""
        if not isinstance(el, (list, Group)) and self.has(el):
            warning(f"Element {self.get_desc(hex(id(self)))} already included in geometry. "
                    "Make a copy to include it another time.")
            return

        if isinstance(el, Aperture):
            self.apertures.append(el)
        elif isinstance(el, Filter):
            self.filters.append(el)
        elif isinstance(el, RaySource):
            self.ray_sources.append(el)
        elif isinstance(el, Detector):
            self.detectors.append(el)
        elif isinstance(el, Lens):
            self.lenses.append(el)
        elif isinstance(el, Group):
            if self.n0 != el.n0:
                warning("Overwriting ambient index with index from new Group.")
                self.n0 = el.n0
            for eli in el.elements:
                self.add(eli)
        elif isinstance(el, list):
            for eli in el:
                self.add(eli)
        else:
            raise TypeError(f"Unsupported element type {type(el).__name__}.")

    def remove(self, el) -> bool:
        """Remove element(s); returns True if anything was removed."""
        success = False
        if isinstance(el, list):
            for eli in el.copy():
                success = self.remove(eli) or success
        elif isinstance(el, Group):
            for eli in el._elements.copy():
                success = self.remove(eli) or success
        else:
            for list_ in [self.lenses, self.apertures, self.detectors,
                          self.filters, self.ray_sources]:
                for lel in list_.copy():
                    if lel is el:
                        list_.remove(lel)
                        success = True
        return success

    def has(self, el) -> bool:
        return any(eli is el for eli in self._elements)

    def clear(self) -> None:
        for list_ in [self.lenses, self.apertures, self.filters, self.detectors,
                      self.ray_sources]:
            list_[:] = []
