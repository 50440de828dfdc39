"""Filter transmittance spectrum.

Counterpart of ``optrace_tpu/spectrum/transmission_spectrum.py``: restricted
types, values in [0, 1], optional ``inverse`` (absorptance), colour under
D65. ``__call__`` evaluates a tensor on its device (the filter step of the
trace) and host data in numpy, like every spectrum of the port.
"""

import numpy as np

from .spectrum import Spectrum
from .. import color
from ..utils.property_checker import PropertyChecker as pc


class TransmissionSpectrum(Spectrum):

    spectrum_types: list = ["Constant", "Data", "Rectangle", "Gaussian", "Function"]

    quantity: str = "Transmission T"
    unit: str = ""

    def __init__(self, spectrum_type: str = "Gaussian", inverse: bool = False, **sargs) -> None:
        self.inverse = inverse
        super().__init__(spectrum_type, **sargs)

    def xyz(self) -> np.ndarray:
        """XYZ color of the filter under D65 daylight."""
        wl = color.wavelengths(5000)
        spec = color.d65_illuminant(wl) * self(wl)
        return color.xyz_from_spectrum(wl, spec).numpy()

    def color(self, rendering_intent="Absolute", clip=True, L_th=0.0, chroma_scale=None):
        """(R, G, B, opacity) of the filter under D65."""
        XYZ = self.xyz()
        wl = color.wavelengths(5000)
        Y0 = float(color.xyz_from_spectrum(wl, color.d65_illuminant(wl))[1])
        alpha = (1 - XYZ[1] / Y0) ** (1 / 2.4)
        RGB = color.xyz_to_srgb((XYZ / Y0)[None, None, :], rendering_intent=rendering_intent,
                                clip=clip, L_th=L_th, chroma_scale=chroma_scale)[0, 0]
        return float(RGB[0]), float(RGB[1]), float(RGB[2]), float(alpha)

    def __call__(self, wl):
        vals = super().__call__(wl)
        return 1.0 - vals if self.inverse else vals

    def __setattr__(self, key, val) -> None:
        if key == "val" and isinstance(val, (int, float)):
            pc.check_not_above(key, val, 1)
        if key == "_vals" and isinstance(val, (list, np.ndarray)):
            if np.max(val) > 1:
                raise ValueError("all elements in vals need to be in range [0, 1].")
        if key == "inverse":
            pc.check_type(key, val, bool)
        if key == "func" and callable(val):
            wls = np.asarray(color.wavelengths(1000))
            T = np.asarray(val(wls))
            if np.any(T > 1):
                raise RuntimeError("Function func needs to return values in range [0, 1] over the visible range.")
        super().__setattr__(key, val)
