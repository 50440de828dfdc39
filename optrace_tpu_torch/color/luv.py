"""CIELUV conversions (CIE 1976 L*u*v*) and u'v' chromaticity helpers.

Counterpart of ``optrace_tpu/color/luv.py`` with the "actual CIE standard"
constants k=903.3, e=0.008856 (Lindbloom). All functions are branchless
over (..., 3) torch tensors (host data is taken as a CPU tensor).
"""

import torch

from .xyz import WP_D65_XYZ, as_tensor

WP_D65_LUV = [100.0, 0.19783982, 0.4683363]
"""D65 whitepoint as (L, u', v'), computed from the XYZ whitepoint."""

WP_D65_UV = WP_D65_LUV[1:]

# sRGB primaries in u'v' (standard chromaticities transformed to CIE 1976 UCS)
SRGB_R_UV = [0.4507042254, 0.5228873239]
SRGB_G_UV = [0.125, 0.5625]
SRGB_B_UV = [0.1754385965, 0.1578947368]

_K = 903.3
_E = 0.008856


def _cbrt(t):
    """Cube root of a non-negative tensor."""
    return torch.pow(t, 1.0 / 3.0)


def xyz_to_luv(xyz, normalize: bool = True) -> torch.Tensor:
    """XYZ → CIELUV. ``normalize``: scale by the max Y in the input instead of
    the D65 whitepoint Y (Y=0 → (0,0,0))."""
    xyz = torch.clamp(as_tensor(xyz), min=0.0)
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    un, vn = WP_D65_UV

    if normalize:
        Ymax = torch.max(torch.nan_to_num(Y, nan=-float("inf")))
        Yn = torch.clamp(Ymax, min=1e-30)
    else:
        Yn = WP_D65_XYZ[1]

    t = Y / Yn
    L = torch.where(t > _E, 116.0 * _cbrt(t) - 16.0, _K * t)

    denom = X + 15.0 * Y + 3.0 * Z
    D = torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom, 1.0), 0.0)
    u = 4.0 * X * D
    v = 9.0 * Y * D

    valid = Y > 0
    L = torch.where(valid, L, 0.0)
    L13 = 13.0 * L
    uu = torch.where(valid, L13 * (u - un), 0.0)
    vv = torch.where(valid, L13 * (v - vn), 0.0)
    return torch.stack([L, uu, vv], dim=-1)


def luv_to_xyz(luv) -> torch.Tensor:
    """CIELUV → XYZ (inverse of the above)."""
    luv = as_tensor(luv)
    L, u, v = luv[..., 0], luv[..., 1], luv[..., 2]
    un, vn = WP_D65_UV

    valid = L > 0
    Y = torch.where(L > _K * _E, ((L + 16.0) / 116.0) ** 3, L / _K)
    L13 = 13.0 * L
    dv = v + L13 * vn
    dv = torch.where(dv != 0, dv, 1.0)
    X = 9.0 / 4.0 * Y * (u + L13 * un) / dv
    Z = 3.0 * Y * (L13 / dv - 5.0 / 3.0) - X / 3.0

    zero = torch.zeros_like(Y)
    return torch.stack([torch.where(valid, X, zero),
                        torch.where(valid, Y, zero),
                        torch.where(valid, Z, zero)], dim=-1)


def luv_to_u_v_l(luv) -> torch.Tensor:
    """CIELUV → (u', v', L). L=0 rows get whitepoint chromaticity."""
    luv = as_tensor(luv)
    L = luv[..., 0]
    un, vn = WP_D65_UV
    valid = L > 0
    Ls = torch.where(valid, L, 1.0)
    u_ = torch.where(valid, un + luv[..., 1] / (13.0 * Ls), un)
    v_ = torch.where(valid, vn + luv[..., 2] / (13.0 * Ls), vn)
    return torch.stack([u_, v_, L], dim=-1)


def luv_chroma(luv) -> torch.Tensor:
    """CIELUV chroma C* = √(u*² + v*²)."""
    luv = as_tensor(luv)
    return torch.sqrt(luv[..., 1] ** 2 + luv[..., 2] ** 2)


def luv_saturation(luv) -> torch.Tensor:
    """CIELUV saturation s = C*/L (0 where L=0)."""
    luv = as_tensor(luv)
    L = luv[..., 0]
    C = luv_chroma(luv)
    return torch.where(L > 0, C / torch.where(L > 0, L, 1.0), 0.0)


def luv_hue(luv) -> torch.Tensor:
    """CIELUV hue angle in degrees [0, 360)."""
    luv = as_tensor(luv)
    hue = torch.rad2deg(torch.atan2(luv[..., 2], luv[..., 1]))
    return torch.where(hue < 0, hue + 360.0, hue)
