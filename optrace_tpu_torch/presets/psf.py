"""Analytic PSF presets: circle, gaussian, airy, glare, halo as
GrayscaleImages (counterpart of ``optrace_tpu/presets/psf.py``). Sizes in
µm, image side lengths in mm. The kernels are evaluated with numpy in f64
and gamma-encoded on the host."""

import numpy as np
import scipy.special

from ..image.grayscale_image import GrayscaleImage
from ..utils.property_checker import PropertyChecker as pc
from .. import color


def _to_srgb(Z):
    return np.clip(color.srgb_linear_to_srgb(Z).numpy(), 0, 1)


def circle(d: float = 1.0) -> GrayscaleImage:
    """Circle kernel with diameter d (µm), smoothed 1-pixel edge."""
    pc.check_above("d", d, 0)
    ds = 1.05 / 2
    sz = 601
    Y, X = np.mgrid[-ds:ds:sz * 1j, -ds:ds:sz * 1j]
    R2 = X ** 2 + Y ** 2
    Z = np.zeros((sz, sz), dtype=np.float64)
    Z[R2 <= (0.5 + ds / Y.shape[0]) ** 2] = 0.25
    Z[R2 <= 0.5 ** 2] = 0.75
    Z[R2 <= (0.5 - ds / Y.shape[0]) ** 2] = 1.0
    return GrayscaleImage(_to_srgb(Z), [2 * ds * d / 1000, 2 * ds * d / 1000])


def gaussian(sig: float = 0.5) -> GrayscaleImage:
    """Gaussian kernel with standard deviation sig (µm), plotted to 5σ."""
    pc.check_above("sig", sig, 0)
    ds = 5 * sig
    sz = 401
    Y, X = np.mgrid[-ds:ds:sz * 1j, -ds:ds:sz * 1j]
    Z = np.exp(-(X ** 2 + Y ** 2) / 2 / sig ** 2)
    return GrayscaleImage(_to_srgb(Z), [2 * ds / 1000, 2 * ds / 1000])


def airy(r: float = 1.0) -> GrayscaleImage:
    """Airy disc kernel with resolution limit r (µm), up to the third zero."""
    pc.check_above("r", r, 0)
    ds = 10.1735 / 3.8317
    sz = 401
    Z = np.ones((sz, sz), dtype=np.float64)
    Y, X = np.mgrid[-ds:ds:sz * 1j, -ds:ds:sz * 1j]
    R = np.sqrt(X ** 2 + Y ** 2) * 3.8317
    Rnz = R[R != 0]
    Z[R != 0] = (2 * scipy.special.j1(Rnz) / Rnz) ** 2
    Z[R > 10.1735] = 0
    return GrayscaleImage(_to_srgb(Z), [2 * ds * r / 1000, 2 * ds * r / 1000])


def glare(sig1: float = 0.5, sig2: float = 3.0, a: float = 0.15) -> GrayscaleImage:
    """Glare kernel: small focus gaussian + larger glare gaussian."""
    pc.check_above("sig1", sig1, 0)
    pc.check_above("sig2", sig2, 0)
    pc.check_not_below("a", a, 0)
    pc.check_not_above("a", a, 1)
    if sig2 <= sig1:
        raise ValueError("sig2 must be larger than sig1.")
    ds = 5 * sig2
    sz = 801
    Y, X = np.mgrid[-ds:ds:sz * 1j, -ds:ds:sz * 1j]
    R2 = X ** 2 + Y ** 2
    Z = a * np.exp(-R2 / 2 / sig2 ** 2) + (1 - a) * np.exp(-R2 / 2 / sig1 ** 2)
    Z /= Z.max()
    return GrayscaleImage(_to_srgb(Z), [2 * ds / 1000, 2 * ds / 1000])


def halo(sig1: float = 0.5, sig2: float = 0.25, r: float = 4.0, a: float = 0.3) -> GrayscaleImage:
    """Halo kernel: central gaussian + gaussian ring at radius r (µm)."""
    pc.check_above("sig1", sig1, 0)
    pc.check_above("sig2", sig2, 0)
    pc.check_not_below("a", a, 0)
    pc.check_not_above("a", a, 1)
    pc.check_not_below("r", r, 0)
    ds = r + 5 * sig2
    sz = 801
    Y, X = np.mgrid[-ds:ds:sz * 1j, -ds:ds:sz * 1j]
    R = np.sqrt(X ** 2 + Y ** 2)
    Z = np.exp(-R ** 2 / 2 / sig1 ** 2) + a * np.exp(-(R - r) ** 2 / 2 / sig2 ** 2)
    Z /= Z.max()
    return GrayscaleImage(_to_srgb(Z), [2 * ds / 1000, 2 * ds / 1000])
