"""XYZ / xyY conversions, spectrum integration, dominant wavelength.

Counterpart of ``optrace_tpu/color/xyz.py``: branchless functions over
(..., 3) torch tensors of any leading shape, device and float type. Host
data (numpy arrays, lists) is taken as a CPU tensor of its own type, so an
f64 image stays f64.
"""

import numpy as np
import torch

from .observers import x_observer, y_observer, z_observer
from .tools import wavelengths

WP_D65_XYZ = [0.95047, 1.00000, 1.08883]
"""D65 whitepoint in XYZ (standard value, see e.g. CIE / Lindbloom tables)."""

WP_D65_XY = [0.31272, 0.32903]
"""D65 whitepoint xy chromaticity (CIE Colorimetry 3rd ed., table 11.3)."""


def as_tensor(a) -> torch.Tensor:
    """A tensor as it is; host data as a CPU tensor of its own float type."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float64)
    return torch.as_tensor(a)


def xyz_to_xyY(xyz) -> torch.Tensor:
    """Convert (..., 3) XYZ to xyY. Black maps to whitepoint chromaticity, Y=0."""
    xyz = as_tensor(xyz)
    s = torch.sum(xyz, dim=-1, keepdim=True)
    safe = torch.where(s > 0, s, 1.0)
    wp = torch.as_tensor(WP_D65_XY, dtype=xyz.dtype, device=xyz.device)
    xy = torch.where(s > 0, xyz[..., :2] / safe, wp)
    return torch.cat([xy, xyz[..., 1:2]], dim=-1)


def xyY_to_xyz(xyy) -> torch.Tensor:
    """Convert (..., 3) xyY back to XYZ."""
    xyy = as_tensor(xyy)
    x, y, Y = xyy[..., 0], xyy[..., 1], xyy[..., 2]
    z = 1.0 - x - y
    fac = torch.where(y != 0, Y / torch.where(y != 0, y, 1.0), 1.0)
    return torch.stack([x * fac, torch.where(y != 0, Y, y), z * fac], dim=-1)


def xyz_from_spectrum(wl, spec, method: str = "sum") -> torch.Tensor:
    """Tristimulus integration of a spectrum against the observers.
    method: 'sum' or 'trapz'."""
    wl = as_tensor(wl)
    spec = as_tensor(spec).to(dtype=wl.dtype, device=wl.device)
    bands = torch.stack([spec * x_observer(wl), spec * y_observer(wl), spec * z_observer(wl)])
    if method == "sum":
        return torch.sum(bands, dim=-1)
    return torch.trapezoid(bands, wl, dim=-1)


# ----------------------------------------------------------------------
# dominant / complementary wavelength (host-side: used for labels/plots)

def _chrom_angle(XYZ_s, res: int = 10000):
    """Angle of a color around the D65 whitepoint in the xy diagram, plus the
    angles of the spectral locus and its wavelengths."""
    xw, yw = WP_D65_XY
    wl = np.asarray(wavelengths(res))
    X = np.asarray(x_observer(wl), dtype=np.float64)
    Y = np.asarray(y_observer(wl), dtype=np.float64)
    Z = np.asarray(z_observer(wl), dtype=np.float64)
    s = X + Y + Z
    x, y = X / s, Y / s
    phi = np.arctan2(y - yw, x - xw)
    phi = np.where(phi < -np.pi / 2, phi + 2 * np.pi, phi)

    XYZ_s = np.asarray(XYZ_s, dtype=np.float64).ravel()
    ss = XYZ_s.sum()
    if ss > 0:
        xs, ys = XYZ_s[0] / ss, XYZ_s[1] / ss
    else:
        xs, ys = xw, yw
    phi_s = np.arctan2(ys - yw, xs - xw)
    if phi_s < -np.pi / 2:
        phi_s += 2 * np.pi
    return phi_s, phi, wl


def _angle_to_wl(phi_q, phi, wl) -> float:
    order = np.argsort(phi)
    phi_o, wl_o = phi[order], wl[order]
    if phi_q < phi_o[0] or phi_q > phi_o[-1]:
        return float("nan")
    return float(np.interp(phi_q, phi_o, wl_o))


def dominant_wavelength(XYZ_s, res: int = 10000) -> float:
    """Dominant wavelength of a color w.r.t. D65; nan if on the purple line."""
    phi_s, phi, wl = _chrom_angle(XYZ_s, res)
    return _angle_to_wl(phi_s, phi, wl)


def complementary_wavelength(XYZ_s, res: int = 10000) -> float:
    """Complementary wavelength of a color w.r.t. D65."""
    phi_s, phi, wl = _chrom_angle(XYZ_s, res)
    phi_c = phi_s - np.pi
    if phi_c < -np.pi / 2:
        phi_c += 2 * np.pi
    return _angle_to_wl(phi_c, phi, wl)
