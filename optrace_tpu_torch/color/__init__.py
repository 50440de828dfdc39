"""Colorimetry of the port: CIE observers, XYZ/xyY/CIELUV/sRGB conversions,
illuminants, wavelength grids and blackbody radiators. All conversions are
branchless functions over torch tensors with the channel axis last."""

from .observers import x_observer, y_observer, z_observer, observers  # noqa: F401
from .tools import wavelengths, blackbody, normalized_blackbody, WL_MIN0, WL_MAX0  # noqa: F401
from .xyz import (WP_D65_XYZ, WP_D65_XY, xyz_to_xyY, xyY_to_xyz,  # noqa: F401
                  xyz_from_spectrum, dominant_wavelength, complementary_wavelength)
from .luv import (WP_D65_LUV, WP_D65_UV, SRGB_R_UV, SRGB_G_UV, SRGB_B_UV,  # noqa: F401
                  xyz_to_luv, luv_to_xyz, luv_to_u_v_l, luv_saturation, luv_chroma, luv_hue)
from .srgb import (SRGB_RENDERING_INTENTS, SRGB_R_XY, SRGB_G_XY, SRGB_B_XY,  # noqa: F401
                   SRGB_PRIMARY_POWER_FACTORS,
                   srgb_to_srgb_linear, srgb_linear_to_srgb, srgb_linear_to_xyz,
                   srgb_to_xyz, xyz_to_srgb_linear, xyz_to_srgb, outside_srgb_gamut,
                   get_chroma_scale, log_srgb,
                   srgb_r_primary, srgb_g_primary, srgb_b_primary,
                   power_from_srgb_linear, spectral_colormap)
from .illuminants import (ILLUMINANT_NAMES, illuminant,  # noqa: F401
                          a_illuminant, c_illuminant, e_illuminant,
                          d50_illuminant, d55_illuminant, d65_illuminant, d75_illuminant,
                          f2_illuminant, f7_illuminant, f11_illuminant,
                          led_b1_illuminant, led_b2_illuminant, led_b3_illuminant,
                          led_b4_illuminant, led_b5_illuminant, led_bh1_illuminant,
                          led_rgb1_illuminant, led_v1_illuminant, led_v2_illuminant)
