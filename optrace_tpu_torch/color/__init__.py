"""Colorimetry of the port: CIE observers, illuminants, wavelength grids and
blackbody radiators. The XYZ/CIELUV/sRGB conversions arrive with the image
slice."""

from .observers import x_observer, y_observer, z_observer, observers  # noqa: F401
from .tools import wavelengths, blackbody, normalized_blackbody, WL_MIN0, WL_MAX0  # noqa: F401
from .illuminants import (ILLUMINANT_NAMES, illuminant,  # noqa: F401
                          a_illuminant, c_illuminant, e_illuminant,
                          d50_illuminant, d55_illuminant, d65_illuminant, d75_illuminant,
                          f2_illuminant, f7_illuminant, f11_illuminant,
                          led_b1_illuminant, led_b2_illuminant, led_b3_illuminant,
                          led_b4_illuminant, led_b5_illuminant, led_bh1_illuminant,
                          led_rgb1_illuminant, led_v1_illuminant, led_v2_illuminant)
