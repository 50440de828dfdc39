"""Filter element: surface + transmission spectrum (counterpart of
``optrace_tpu/geometry/filter.py``)."""

from typing import Any

from .element import Element
from .surface import Surface
from ..spectrum.transmission_spectrum import TransmissionSpectrum
from ..utils.property_checker import PropertyChecker as pc


class Filter(Element):

    abbr: str = "F"
    _allow_non_2D: bool = False

    def __init__(self, surface: Surface, pos, spectrum: TransmissionSpectrum, **kwargs) -> None:
        super().__init__(surface, pos, **kwargs)
        self.spectrum = spectrum
        self._new_lock = True

    def __call__(self, wl):
        """Transmittance at wavelengths wl."""
        return self.spectrum(wl)

    def color(self, rendering_intent="Absolute", clip=True, L_th=0.0, chroma_scale=None):
        """Filter color under D65, pass-through of spectrum.color."""
        return self.spectrum.color(rendering_intent, clip, L_th=L_th, chroma_scale=chroma_scale)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "spectrum":
            pc.check_type(key, val, TransmissionSpectrum)
        super().__setattr__(key, val)
