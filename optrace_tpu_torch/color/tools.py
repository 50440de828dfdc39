"""Wavelength grids and Planck blackbody radiators.

Counterpart of ``optrace_tpu/color/tools.py`` (``wavelengths``,
``blackbody``, ``normalized_blackbody``).
"""

import numpy as np
import scipy.constants
import torch

from ..utils.global_options import global_options

WL_MIN0: float = 380.0   #: lower bound of the visible range used for color features
WL_MAX0: float = 780.0   #: upper bound of the visible range used for color features


def wavelengths(N: int) -> np.ndarray:
    """N equally spaced wavelengths spanning ``global_options.wavelength_range``
    as a host numpy array."""
    lo, hi = global_options.wavelength_range
    return np.linspace(lo, hi, N)


def blackbody(wl, T: float = 6504.0):
    """Planck spectral radiance in W/(sr m³) for wavelengths ``wl`` (nm, a
    tensor or host data) at temperature T (K)."""
    c = scipy.constants.c
    h = scipy.constants.h
    k_B = scipy.constants.k
    if isinstance(wl, torch.Tensor):
        wl_m = wl * 1e-9
        return 2.0 * h * c ** 2 / wl_m ** 5 / (torch.exp(h * c / (wl_m * k_B * T)) - 1.0)
    wl_m = np.asarray(wl) * 1e-9
    return 2.0 * h * c ** 2 / wl_m ** 5 / (np.exp(h * c / (wl_m * k_B * T)) - 1.0)


def normalized_blackbody(wl, T: float = 6504.0):
    """Blackbody curve normalized to peak 1 within the visible range."""
    ref = blackbody(wavelengths(2000), T)
    return blackbody(wl, T) / float(np.max(ref))
