"""sRGB conversions, gamut mapping (rendering intents), primary spectra.

Counterpart of ``optrace_tpu/color/srgb.py``. Everything is branchless over
(..., 3) torch tensors (host data is taken as a CPU tensor of its own type),
so it can sit at the end of a render on any device.

Numeric constants (sRGB primary chromaticities, Lindbloom conversion
matrices, CIELUV gamut polygon, synthetic-primary Gaussian parameters and
power factors) are *behavioral spec*: the synthetic r/g/b primary spectra
must reproduce exactly the sRGB primary xyY coordinates so that image
sources mix to correct colors. Sampling wavelengths from an sRGB image is
split into the draw (``random_wavelengths_from_srgb``) and a pure function
of the uniforms (``wavelengths_from_srgb``).
"""

import functools

import math

import torch

from .observers import x_observer, y_observer, z_observer
from .xyz import xyz_to_xyY, WP_D65_XY, as_tensor
from .luv import (xyz_to_luv, luv_to_xyz, luv_to_u_v_l,
                  SRGB_R_UV, SRGB_G_UV, SRGB_B_UV, WP_D65_UV)
from . import tools
from ..utils.global_options import global_options

SRGB_RENDERING_INTENTS = ["Ignore", "Absolute", "Perceptual"]
"""Rendering intents for XYZ → sRGB conversion."""

SRGB_R_XY = [0.64, 0.33]   #: sRGB red primary xy chromaticity (IEC 61966-2-1)
SRGB_G_XY = [0.30, 0.60]   #: sRGB green primary xy chromaticity
SRGB_B_XY = [0.15, 0.06]   #: sRGB blue primary xy chromaticity

# Relative radiant powers of the synthetic primary curves below over the
# default wavelength range; needed so per-pixel emission probability is
# proportional to radiant power.
_SRGB_R_PRIMARY_POWER_FACTOR = 0.885651229244
_SRGB_G_PRIMARY_POWER_FACTOR = 1.000000000000
_SRGB_B_PRIMARY_POWER_FACTOR = 0.775993481741
SRGB_PRIMARY_POWER_FACTORS = [_SRGB_R_PRIMARY_POWER_FACTOR,
                              _SRGB_G_PRIMARY_POWER_FACTOR,
                              _SRGB_B_PRIMARY_POWER_FACTOR]

# Lindbloom sRGB (D65) matrices
_M_RGB_TO_XYZ = [[0.4124564, 0.3575761, 0.1804375],
                 [0.2126729, 0.7151522, 0.0721750],
                 [0.0193339, 0.1191920, 0.9503041]]
_M_XYZ_TO_RGB = [[3.2404542, -1.5371385, -0.4985314],
                 [-0.9692660, 1.8760108, 0.0415560],
                 [0.0556434, -0.2040259, 1.0572252]]


# ----------------------------------------------------------------------
# gamma

def srgb_to_srgb_linear(rgb) -> torch.Tensor:
    """Remove sRGB gamma (IEC 61966-2-1 EOTF). Odd-extended to negatives."""
    rgb = as_tensor(rgb)
    a = 0.055
    absr = torch.abs(rgb)
    lin = torch.sign(rgb) * ((absr + a) / (1 + a)) ** 2.4
    return torch.where(absr <= 0.04045, rgb / 12.92, lin)


def srgb_linear_to_srgb(rgbl) -> torch.Tensor:
    """Apply sRGB gamma (inverse EOTF). Odd-extended to negatives."""
    rgbl = as_tensor(rgbl)
    a = 0.055
    absr = torch.abs(rgbl)
    enc = torch.sign(rgbl) * ((1 + a) * torch.clamp(absr, min=1e-30) ** (1 / 2.4) - a)
    return torch.where(absr <= 0.0031308, 12.92 * rgbl, enc)


# ----------------------------------------------------------------------
# linear transforms

def _matmul_channels(mat, img: torch.Tensor) -> torch.Tensor:
    # written out as three weighted sums: a 3x3 colorimetric transform must
    # not go through a reduced-precision matrix unit
    m = torch.as_tensor(mat, dtype=img.dtype, device=img.device)
    return torch.stack([img[..., 0] * m[i, 0] + img[..., 1] * m[i, 1] + img[..., 2] * m[i, 2]
                        for i in range(3)], dim=-1)


def srgb_linear_to_xyz(rgbl) -> torch.Tensor:
    """Linear sRGB → XYZ (D65)."""
    return _matmul_channels(_M_RGB_TO_XYZ, as_tensor(rgbl))


def srgb_to_xyz(rgb) -> torch.Tensor:
    """sRGB → XYZ."""
    return srgb_linear_to_xyz(srgb_to_srgb_linear(rgb))


def _nanmax(t: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.nan_to_num(t, nan=-float("inf")))


def _to_srgb_linear_raw(xyz: torch.Tensor, normalize: bool) -> torch.Tensor:
    rgbl = _matmul_channels(_M_XYZ_TO_RGB, as_tensor(xyz))
    if normalize:
        nmax = _nanmax(rgbl)
        rgbl = torch.where(nmax > 0, rgbl / torch.where(nmax > 0, nmax, 1.0), rgbl)
    return rgbl


def outside_srgb_gamut(xyz) -> torch.Tensor:
    """Boolean mask of colors outside the sRGB gamut (tolerance -1e-6)."""
    rgbl = xyz_to_srgb_linear(xyz, normalize=True, rendering_intent="Ignore")
    return torch.any(rgbl < -1e-6, dim=-1)


# ----------------------------------------------------------------------
# gamut mapping

def _triangle_intersect(r, g, b, w, x, y):
    """Project chromaticities (x, y) towards whitepoint w onto the gamut
    triangle edge (r, g, b), branchless. Points inside the gamut are also
    projected — the caller selects which pixels to replace."""
    rx, ry = r
    gx, gy = g
    bx, by = b
    wx, wy = w

    phig = math.atan2(gy - wy, gx - wx)
    phir = math.atan2(ry - wy, rx - wx)
    phib = math.atan2(by - wy, bx - wx) + 2 * math.pi

    phi = torch.atan2(y - wy, x - wx)
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)

    aw = torch.tan(phi)
    abg = (gy - by) / (gx - bx)
    abr = (ry - by) / (rx - bx)
    agr = (ry - gy) / (rx - gx)

    def isect(a_edge, ex, ey):
        # intersection of the whitepoint line (slope aw through (x, y)) with
        # the edge line of slope a_edge through (ex, ey)
        xi = (y - x * aw + (ex * a_edge - ey)) / (a_edge - aw)
        yi = xi * a_edge + (ey - ex * a_edge)
        return xi, yi

    x_bg, y_bg = isect(abg, bx, by)
    x_gr, y_gr = isect(agr, gx, gy)
    x_br, y_br = isect(abr, bx, by)

    is_bg = (phi <= phib) & (phi > phig)
    is_gr = (phi <= phig) & (phi > phir)

    xo = torch.where(is_bg, x_bg, torch.where(is_gr, x_gr, x_br))
    yo = torch.where(is_bg, y_bg, torch.where(is_gr, y_gr, y_br))
    return xo, yo


def _get_chroma_scale_sq(luv: torch.Tensor):
    """Per-pixel squared chroma-scale factors to reach the gamut edge in
    u'v', plus a validity mask approximating the spectral locus polygon."""
    uvl = luv_to_u_v_l(luv)
    u_, v_ = uvl[..., 0], uvl[..., 1]

    # polygonal approximation of the horseshoe of real colors
    l1 = v_ > (0.5065 - 0.013) / (0.6235 - 0.255) * (u_ - 0.2555) + 0.01373
    l2 = v_ < (0.5065 - 0.6) / 0.6235 * u_ + 0.6
    l3 = u_ > 0
    l4 = v_ > (0.013 - 0.28) / 0.255 * u_ + 0.28
    l5 = v_ > (0.0 - 0.48) / 0.18 * u_ + 0.48
    in_gamut = l1 & l2 & l3 & l4 & l5

    un, vn = WP_D65_UV
    cr0_sq = (u_ - un) ** 2 + (v_ - vn) ** 2
    uc, vc = _triangle_intersect(SRGB_R_UV, SRGB_G_UV, SRGB_B_UV, WP_D65_UV, u_, v_)
    cr1_sq = (uc - un) ** 2 + (vc - vn) ** 2
    return in_gamut, cr1_sq / (cr0_sq + 1e-9)


def get_chroma_scale(luv, L_th: float = 0.0) -> torch.Tensor:
    """Global chroma scaling factor for the Perceptual rendering intent:
    the minimum per-pixel scale over valid pixels above the lightness
    threshold, clipped to [0.32, 1]."""
    luv = as_tensor(luv)
    in_gamut, cr_fact2 = _get_chroma_scale_sq(luv)
    L = luv[..., 0]
    mask = in_gamut & (L > L_th * torch.max(L))
    cr2 = torch.where(mask, cr_fact2, float("inf"))
    cr2_min = torch.min(cr2)
    cr = torch.where(torch.isfinite(cr2_min), torch.sqrt(cr2_min), 1.0)
    return torch.clamp(cr, 0.32, 1.0)


def xyz_to_srgb_linear(xyz, normalize: bool = True, rendering_intent: str = "Absolute",
                       L_th: float = 0.0, chroma_scale=None) -> torch.Tensor:
    """XYZ → linear sRGB with gamut mapping.

    Intents:
    - "Ignore": raw matrix transform, out-of-gamut values stay negative.
    - "Absolute": per-pixel chroma clip toward the whitepoint in xy,
      preserving hue and Y.
    - "Perceptual": global chroma scale in CIELUV (factor from
      :func:`get_chroma_scale` or the ``chroma_scale`` argument), residual
      out-of-gamut pixels chroma-clipped to the gamut edge.
    """
    xyz = as_tensor(xyz)
    rgbl = _to_srgb_linear_raw(xyz, normalize)
    if rendering_intent == "Ignore":
        return rgbl

    if rendering_intent == "Absolute":
        inv = torch.any(rgbl < 0, dim=-1)
        xyY = xyz_to_xyY(xyz)
        x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
        xc, yc = _triangle_intersect(SRGB_R_XY, SRGB_G_XY, SRGB_B_XY, WP_D65_XY, x, y)
        k = Y / torch.where(yc > 0, yc, float("inf"))
        xyz_c = torch.stack([k * xc, Y, k * (1.0 - xc - yc)], dim=-1)
        xyz_out = torch.where(inv[..., None], xyz_c, xyz)
        return _to_srgb_linear_raw(xyz_out, normalize)

    if rendering_intent == "Perceptual":
        xyz_p = torch.clamp(xyz, min=0.0)
        luv = xyz_to_luv(xyz_p, normalize=False)
        in_gamut, cr_fact2 = _get_chroma_scale_sq(luv)
        cr_fact = torch.sqrt(cr_fact2)
        if chroma_scale is None:
            chroma_scale = get_chroma_scale(luv, L_th)
        # chroma scaling for pixels within reach, chroma clipping otherwise
        cr = torch.clamp(cr_fact, max=chroma_scale)
        luv = torch.cat([luv[..., :1], luv[..., 1:] * cr[..., None]], dim=-1)
        xyz_out = luv_to_xyz(luv)
        return _to_srgb_linear_raw(xyz_out, normalize)

    raise ValueError(f"Unknown rendering intent '{rendering_intent}'.")


def xyz_to_srgb(xyz, normalize: bool = True, clip: bool = True,
                rendering_intent: str = "Absolute", L_th: float = 0.0,
                chroma_scale=None) -> torch.Tensor:
    """XYZ → sRGB (gamut mapping + optional clip + gamma)."""
    rgbl = xyz_to_srgb_linear(xyz, normalize=normalize, rendering_intent=rendering_intent,
                              L_th=L_th, chroma_scale=chroma_scale)
    if clip:
        rgbl = torch.clamp(rgbl, 0.0, 1.0)
    return srgb_linear_to_srgb(rgbl)


def log_srgb(img) -> torch.Tensor:
    """Logarithmic lightness rescale in CIELUV, chromaticity-preserving."""
    img = as_tensor(img)
    xyz = srgb_to_xyz(img)
    luv = xyz_to_luv(xyz)
    L = luv[..., 0]
    pos = L > 0
    if not bool(torch.any(pos)):
        return img
    lmax = torch.max(L[pos])
    lmin = torch.min(L[pos])
    if bool(lmin == lmax):
        return img

    L2 = 100.0 - 99.5 / torch.log(lmin / lmax) * torch.log(torch.where(pos, L, 1.0) / lmax)
    L2 = torch.where(pos, L2, 0.0)
    cs = torch.where(pos, L2 / torch.where(pos, L, 1.0), 1.0)
    luv2 = torch.stack([L2, luv[..., 1] * cs, luv[..., 2] * cs], dim=-1)
    return xyz_to_srgb(luv_to_xyz(luv2))


# ----------------------------------------------------------------------
# synthetic sRGB primary spectra

def _gauss(x, mu, sig):
    return 1.0 / (sig * math.sqrt(2 * math.pi)) * torch.exp(-0.5 * ((x - mu) / sig) ** 2)


def _in_visible(wl, val):
    m = (wl >= tools.WL_MIN0) & (wl <= tools.WL_MAX0)
    return torch.where(m, val, 0.0)


def srgb_r_primary(wl) -> torch.Tensor:
    """Synthetic spectrum with exactly the sRGB red primary xyY coordinates
    (Gaussian mixture with fitted constants)."""
    wl = as_tensor(wl)
    rs = 0.951190393
    r = 75.1660756583 * rs * (_gauss(wl, 639.854491, 30.0)
                              + 0.0500907584 * _gauss(wl, 418.905848, 80.6220465))
    return _in_visible(wl, r)


def srgb_g_primary(wl) -> torch.Tensor:
    """Synthetic sRGB green primary spectrum."""
    wl = as_tensor(wl)
    return _in_visible(wl, 83.4999222966 * _gauss(wl, 539.13108974, 33.31164968))


def srgb_b_primary(wl) -> torch.Tensor:
    """Synthetic sRGB blue primary spectrum."""
    wl = as_tensor(wl)
    bs = 1.16364585503
    b = 47.99521746361 * bs * (_gauss(wl, 454.833119, 20.1460206)
                               + 0.184484176 * _gauss(wl, 459.658190, 71.0927568))
    return _in_visible(wl, b)


def power_from_srgb_linear(rgbl) -> torch.Tensor:
    """Radiant-power measure of linear-sRGB pixels under the synthetic
    primaries."""
    rgbl = as_tensor(rgbl)
    f = SRGB_PRIMARY_POWER_FACTORS
    return rgbl[..., 0] * f[0] + rgbl[..., 1] * f[1] + rgbl[..., 2] * f[2]


@functools.lru_cache(maxsize=4)
def _primary_inverse_cdfs(wl_range: tuple):
    """Host tables (x grid, pdf) of the three primaries over ``wl_range``."""
    wl = tools.wavelengths(5000)
    return wl, tuple(f(wl).numpy() for f in (srgb_r_primary, srgb_g_primary, srgb_b_primary))


@functools.lru_cache(maxsize=8)
def _primary_lookups(wl_range: tuple, device, dtype, u_dtype):
    """The primaries' power factors (a ``dtype`` tensor on ``device``),
    their three inverse CDFs over ``wl_range`` for uniforms of ``u_dtype``,
    and the raw tables behind them: a (3, M) ``u_dtype`` tensor and the
    values (left, right) of a lookup outside [0, 1]. Made once for a
    device, so that a sampled batch copies nothing from the host."""
    from ..ops import sampling
    wl, pdfs = _primary_inverse_cdfs(wl_range)
    factors = torch.as_tensor(SRGB_PRIMARY_POWER_FACTORS, dtype=dtype, device=device)
    made = [sampling.inverse_cdf_table(wl, f, device, u_dtype) for f in pdfs]
    ends = made[0][1:]
    tables = torch.stack([t for t, _, _ in made])
    return factors, tuple(sampling.table_lookup(t, *ends) for t in tables), tables, ends


def check_wavelength_range() -> None:
    """Raise unless ``global_options.wavelength_range`` holds the visible
    band, over which the primaries are defined."""
    if tools.WL_MIN0 < global_options.wavelength_range[0] \
            or tools.WL_MAX0 > global_options.wavelength_range[1]:
        raise RuntimeError(f"Wavelength range {global_options.wavelength_range} does not "
                           f"include [{tools.WL_MIN0}, {tools.WL_MAX0}] needed here.")


def wavelengths_from_srgb(rgb, choice, u) -> torch.Tensor:
    """One wavelength per sRGB colour from two uniforms per colour in
    [0, 1): ``choice`` picks a primary with probability ∝ its linear
    channel power, ``u`` goes through that primary's inverse CDF.

    :param rgb: (N, 3) sRGB values, a tensor on the sampling device
    :param choice, u: (N,) tensors on the same device
    """
    check_wavelength_range()
    rgbl = srgb_to_srgb_linear(rgb)
    factors, lookups, _, _ = _primary_lookups(tuple(global_options.wavelength_range),
                                              rgbl.device, rgbl.dtype, u.dtype)
    r, g, b = (rgbl * factors).unbind(-1)
    # the running sums of the channel powers, each over the last where it is
    # positive (a scan of three values, written out: PyTorch's scan of an
    # innermost dimension of 3 is slow on the card)
    c1 = r + g
    c2 = c1 + b
    last = torch.where(c2 > 0, c2, 1.0)
    make_r = choice < r / last
    make_b = choice > c1 / last

    # the same uniform through all three inverse CDFs, selected per ray
    wl_r, wl_g, wl_b = (lookup(u) for lookup in lookups)
    return torch.where(make_r, wl_r, torch.where(make_b, wl_b, wl_g))


def random_wavelengths_from_srgb(gen: torch.Generator, rgb) -> torch.Tensor:
    """Sample one wavelength per sRGB colour on the generator's device:
    draws ``choice`` and ``u`` (stratified, in this order) and maps them
    through :func:`wavelengths_from_srgb`."""
    from ..ops import sampling
    rgb = as_tensor(rgb).to(gen.device)
    N = rgb.shape[0]
    choice = sampling.stratified_interval_sampling(gen, N, 0.0, 1.0)
    u = sampling.stratified_interval_sampling(gen, N, 0.0, 1.0)
    return wavelengths_from_srgb(rgb, choice, u)


# ----------------------------------------------------------------------
# spectral colormap

def spectral_colormap(wl) -> torch.Tensor:
    """sRGBA colormap for wavelengths: physically correct hue, pleasing
    lightness roll-off. Honors a user override via
    ``global_options.spectral_colormap``."""
    if global_options.spectral_colormap is not None:
        return as_tensor(global_options.spectral_colormap(wl))

    wl = as_tensor(wl)
    xyz = torch.stack([x_observer(wl), y_observer(wl), z_observer(wl)], dim=-1)

    def _norm_brightness(rgbl):
        mx = torch.amax(rgbl, dim=-1, keepdim=True)
        nz = torch.any(rgbl != 0, dim=-1, keepdim=True)
        return torch.where(nz, rgbl / torch.where(mx != 0, mx, 1.0), rgbl)

    rgb_a = _norm_brightness(xyz_to_srgb_linear(xyz, rendering_intent="Absolute"))
    rgb_p = _norm_brightness(xyz_to_srgb_linear(xyz, rendering_intent="Perceptual"))
    rgb = 0.5 * rgb_a + 0.5 * rgb_p

    fade = 0.25 * (1 - torch.tanh((wl - 650.0) / 50.0)) * (1 + torch.tanh((wl - 440.0) / 30.0))
    rgb = srgb_linear_to_srgb(rgb * fade[..., None])
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.cat([rgb, torch.ones_like(wl)[..., None]], dim=-1)
