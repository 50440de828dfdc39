"""CIE chromaticity diagrams (counterpart of ``optrace_tpu/plots/chromaticity_plots.py``):
1931 xy and 1976 u'v' diagrams with spectral-locus shading and scatter of
image/spectrum chromaticities."""

import numpy as np
import matplotlib.pyplot as plt

from .misc_plots import _show_grid, _save_or_show
from .. import color
from ..image import RGBImage, RenderImage
from ..spectrum.light_spectrum import LightSpectrum

chromaticity_norms: list = ["Largest", "Sum", "Euclidean"]


def _points_from(img):
    """Extract (x, y, Y) chromaticity sample points from the input object."""
    if img is None:
        return np.zeros((0, 3)), []
    if isinstance(img, RenderImage):
        xyz = img.data[:, :, :3].reshape(-1, 3)
        sel = xyz[:, 1] > 0
        return xyz[sel][::max(1, sel.sum() // 2000)], []
    if isinstance(img, RGBImage):
        xyz = np.asarray(color.srgb_to_xyz(img.data)).reshape(-1, 3)
        return xyz[::max(1, xyz.shape[0] // 2000)], []
    specs = img if isinstance(img, list) else [img]
    pts, labels = [], []
    for s in specs:
        assert isinstance(s, LightSpectrum)
        pts.append(np.asarray(s.xyz()))
        labels.append(s.get_desc())
    return np.asarray(pts), labels


def _spectral_locus(uv: bool):
    wl = np.linspace(380, 780, 401)
    X = np.asarray(color.x_observer(wl), dtype=np.float64)
    Y = np.asarray(color.y_observer(wl), dtype=np.float64)
    Z = np.asarray(color.z_observer(wl), dtype=np.float64)
    s = X + Y + Z
    x, y = X / s, Y / s
    if not uv:
        return x, y
    d = -2 * x + 12 * y + 3
    return 4 * x / d, 9 * y / d


def _chromaticity_plot(img, uv: bool, title: str, norm: str, path, sargs):
    lx, ly = _spectral_locus(uv)
    pts, labels = _points_from(img)

    plt.figure()
    _show_grid()
    plt.plot(np.append(lx, lx[0]), np.append(ly, ly[0]), "k-", lw=1)

    # sRGB gamut triangle
    if not uv:
        tri = np.array([color.SRGB_R_XY, color.SRGB_G_XY, color.SRGB_B_XY, color.SRGB_R_XY])
    else:
        tri = np.array([color.SRGB_R_UV, color.SRGB_G_UV, color.SRGB_B_UV, color.SRGB_R_UV])
    plt.plot(tri[:, 0], tri[:, 1], "--", color="gray", lw=1, label="sRGB gamut")

    if pts.shape[0]:
        s = pts.sum(axis=-1)
        s = np.where(s > 0, s, 1.0)
        x = pts[:, 0] / s
        y = pts[:, 1] / s
        if uv:
            d = -2 * x + 12 * y + 3
            x, y = 4 * x / d, 9 * y / d
        plt.scatter(x, y, s=6, c="w" if plt.rcParams["figure.facecolor"] != "white" else "k",
                    marker="x")
        for xi, yi, lab in zip(x, y, labels):
            plt.annotate(lab, (xi, yi), fontsize=8)

    plt.xlabel("x" if not uv else "u'")
    plt.ylabel("y" if not uv else "v'")
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    _save_or_show(path, sargs)


def chromaticities_cie_1931(img=None, title: str = "CIE 1931 Chromaticity Diagram",
                            norm: str = "Sum", path: str = None, sargs: dict = None) -> None:
    """CIE 1931 xy chromaticity diagram with optional image/spectrum points."""
    _chromaticity_plot(img, False, title, norm, path, sargs)


def chromaticities_cie_1976(img=None, title: str = "CIE 1976 UCS Diagram",
                            norm: str = "Sum", path: str = None, sargs: dict = None) -> None:
    """CIE 1976 u'v' uniform chromaticity diagram."""
    _chromaticity_plot(img, True, title, norm, path, sargs)
