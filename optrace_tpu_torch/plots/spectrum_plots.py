"""Spectrum and refractive-index plots (counterpart of
``optrace_tpu/plots/spectrum_plots.py``)."""

import numpy as np
import matplotlib.pyplot as plt

from .misc_plots import _show_grid, _save_or_show
from .. import color
from ..spectrum.spectrum import Spectrum
from ..spectrum.refraction_index import RefractionIndex
from ..utils.property_checker import PropertyChecker as pc


def refraction_index_plot(ri, title: str = "Refraction Index", path: str = None,
                          sargs: dict = None, **kwargs) -> None:
    """Plot one or a list of refractive indices over wavelength."""
    _spectrum_plot(ri, "n", title, path=path, sargs=sargs, **kwargs)


def spectrum_plot(spectrum, title: str = None, path: str = None,
                  sargs: dict = None, **kwargs) -> None:
    """Plot one or a list of spectra over wavelength."""
    specs = spectrum if isinstance(spectrum, list) else [spectrum]
    quantity = specs[0].quantity if specs else ""
    unit = specs[0].unit if specs else ""
    ylabel = f"{quantity} in {unit}" if unit else (quantity or "value")
    title = title if title is not None else (specs[0].get_desc() if specs else "Spectrum")
    _spectrum_plot(spectrum, ylabel, title, path=path, sargs=sargs, **kwargs)


def _spectrum_plot(obj, ylabel: str, title: str, legend_off: bool = False,
                   labels_off: bool = False, color_=None, path: str = None,
                   sargs: dict = None) -> None:
    objs = obj if isinstance(obj, list) else [obj]
    pc.check_type("obj", objs, list)

    plt.figure()
    _show_grid()
    wl = np.asarray(color.tools.wavelengths(2000))

    for i, o in enumerate(objs):
        pc.check_type("spectrum", o, (Spectrum, RefractionIndex))
        label = o.get_desc() if not labels_off else None
        if not o.is_continuous():
            if o.spectrum_type == "Monochromatic":
                plt.axvline(o.wl, label=label)
            else:
                for line, lv in zip(np.atleast_1d(o.lines), np.atleast_1d(o.line_vals)):
                    plt.plot([line, line], [0, lv], label=label)
                    label = None
        else:
            vals = np.asarray(o(wl))
            plt.plot(wl, vals, label=label, color=color_)

    plt.xlabel("wavelength in nm")
    plt.ylabel(ylabel)
    if not legend_off and len(objs) and not labels_off:
        plt.legend()
    plt.title(title)
    plt.tight_layout()
    _save_or_show(path, sargs)
