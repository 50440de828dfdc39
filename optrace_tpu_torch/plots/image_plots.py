"""Image display plots (counterpart of ``optrace_tpu/plots/image_plots.py``)."""

import numpy as np
import matplotlib
import matplotlib.pyplot as plt

from .misc_plots import _show_grid, _save_or_show
from .. import color
from ..image import RGBImage, ScalarImage, GrayscaleImage
from ..utils.property_checker import PropertyChecker as pc


def _labels(im, log: bool):
    if im.projection == "Equidistant":
        xlabel, ylabel = r"$\theta_x$ in °", r"$\theta_y$ in °"
    elif im.projection is not None:
        xlabel, ylabel = "projected x", "projected y"
    else:
        xlabel, ylabel = "x in mm", "y in mm"
    q = im.quantity or ""
    zlabel = {"Irradiance": "Irradiance in W/mm²",
              "Illuminance": "Illuminance in lm/mm²"}.get(q, q)
    if log and zlabel:
        zlabel = "log " + zlabel
    return xlabel, ylabel, zlabel


def image_plot(im, log: bool = False, flip: bool = False, title: str = None,
               path: str = None, sargs: dict = None) -> None:
    """Display a ScalarImage/GrayscaleImage/RGBImage."""
    pc.check_type("im", im, (RGBImage, ScalarImage, GrayscaleImage))
    pc.check_type("log", log, bool)
    pc.check_type("flip", flip, bool)

    if isinstance(im, RGBImage) and log:
        Imd = np.asarray(color.log_srgb(im.data))
    else:
        Imd = im.data

    xlabel, ylabel, zlabel = _labels(im, log)
    text = title if title is not None else im.get_desc()

    if log and (np.max(Imd) == np.min(Imd) or im.quantity == "Outside sRGB Gamut"):
        log = False

    extent = np.asarray(im.extent, dtype=np.float64)
    if im.projection == "Equidistant":
        extent = np.rad2deg(extent)
    if flip:
        Imd = np.fliplr(np.flipud(Imd))
        extent = extent[[1, 0, 3, 2]]

    cmap = matplotlib.colormaps["Greys_r"].copy()
    cmap.set_bad(color="black")
    norm = matplotlib.colors.LogNorm() if log and Imd.ndim == 2 else None

    vmin = vmax = None
    if np.max(Imd) == np.min(Imd) == 0:
        vmin, vmax = 0, 1e-16
    elif not log and not (im.quantity or "").startswith("sRGB"):
        vmin = 0

    fig = plt.figure()
    _show_grid()
    plt.grid(visible=False, which="major")
    plt.grid(visible=False, which="minor")
    plt.imshow(Imd, extent=extent, cmap=cmap, aspect="equal", norm=norm,
               vmin=vmin, vmax=vmax, origin="lower")
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)

    if im.projection not in ["Equidistant", "Orthographic", None]:
        fig.axes[0].set_xticklabels([])
        fig.axes[0].set_yticklabels([])

    if not isinstance(im, RGBImage) and im.quantity not in \
            ["Lightness (CIELUV)", "Outside sRGB Gamut", ""]:
        clb = plt.colorbar(orientation="horizontal", shrink=0.6)
        clb.ax.set_xlabel(zlabel)

    plt.title(text)
    plt.tight_layout()
    _save_or_show(path, sargs)


def image_profile_plot(im, log: bool = False, flip: bool = False, title: str = None,
                       x: float = None, y: float = None, path: str = None,
                       sargs: dict = None) -> None:
    """x/y profile cut plot."""
    pc.check_type("im", im, (RGBImage, ScalarImage, GrayscaleImage))
    if x is None and y is None:
        raise ValueError("Either x or y parameter must be provided.")

    bins, iml = im.profile(x=x, y=y)
    centers = (bins[:-1] + bins[1:]) / 2
    xlabel = ("y in mm" if x is not None else "x in mm")
    colors = ["r", "g", "b"] if len(iml) == 3 else [None]

    plt.figure()
    _show_grid()
    for prof, c in zip(iml, colors):
        if flip:
            prof = np.flip(prof)
        plt.plot(centers, prof, color=c)
    if log:
        plt.yscale("log")
    plt.xlabel(xlabel)
    plt.ylabel(im.quantity or "value")
    cut = f"x = {x:.5g} mm" if x is not None else f"y = {y:.5g} mm"
    plt.title(title if title is not None else f"{im.get_desc()} ({cut})")
    plt.tight_layout()
    _save_or_show(path, sargs)
