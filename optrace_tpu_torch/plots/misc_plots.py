"""Misc plots: focus cost, Abbe diagram, surface profiles
(counterpart of ``optrace_tpu/plots/misc_plots.py``)."""

import numpy as np
import matplotlib.pyplot as plt
import scipy.optimize

from ..geometry.surface import Surface
from ..presets import spectral_lines
from ..utils.property_checker import PropertyChecker as pc


def _show_grid(what=plt) -> None:
    what.grid(visible=True, which='major')
    what.grid(visible=True, which='minor', color='gainsboro', linestyle='--')
    what.minorticks_on()


def _save_or_show(path: str = None, sargs: dict = None) -> None:
    if path is not None:
        plt.savefig(path, **(sargs or {}))
        plt.close()
    else:
        plt.show(block=False)
        plt.pause(0.01)


def block() -> None:
    """Block execution until all plot windows are closed."""
    plt.show(block=True)


def focus_search_cost_plot(res: scipy.optimize.OptimizeResult, fsdict: dict,
                           title: str = "Focus Search", path: str = None,
                           sargs: dict = None) -> None:
    """Plot the sampled focus-search cost curve and the found minimum."""
    pc.check_type("fsdict", fsdict, dict)
    r, vals = fsdict["z"], fsdict["cost"]
    if r is None or vals is None:
        raise RuntimeError("Provide the focus_search return values with return_cost=True.")
    plt.figure()
    _show_grid()
    plt.plot(r, vals)
    plt.axvline(res.x, ls="--", color="r", label="found focus")
    plt.xlabel("z in mm")
    plt.ylabel("cost")
    plt.legend()
    plt.title(title)
    plt.tight_layout()
    _save_or_show(path, sargs)


def abbe_plot(ri: list, title: str = "Abbe Diagram", lines: list = None,
              path: str = None, sargs: dict = None,
              silent: bool = None) -> None:
    """Abbe diagram: V vs n_d scatter of media."""
    pc.check_type("ri", ri, list)
    lines = lines if lines is not None else spectral_lines.FdC
    plt.figure()
    _show_grid()
    for rii in ri:
        nd = float(np.asarray(rii(np.array([lines[1]])))[0])
        Vd = rii.abbe_number(lines)
        if np.isfinite(Vd):
            plt.scatter(Vd, nd, marker="x")
            plt.annotate(rii.get_desc(), (Vd, nd), fontsize=8)
    plt.xlabel("Abbe number V")
    plt.ylabel(f"n ($\\lambda$ = {lines[1]:.1f} nm)")
    plt.gca().invert_xaxis()
    plt.title(title)
    plt.tight_layout()
    _save_or_show(path, sargs)


def surface_profile_plot(surface, x0: float = None, xe: float = None,
                         remove_offset: bool = False, title: str = "Surface Profile",
                         path: str = None, sargs: dict = None) -> None:
    """Radial profile plot of one or more surfaces."""
    surfaces = [surface] if isinstance(surface, Surface) else surface
    pc.check_type("surface", surfaces, list)
    plt.figure()
    _show_grid()
    for surf in surfaces:
        xs = x0 if x0 is not None else surf.extent[0]
        xen = xe if xe is not None else surf.extent[1]
        x = np.linspace(xs, xen, 2000)
        vals = surf.values(x, np.full_like(x, surf.pos[1]))
        mask = surf.mask(x, np.full_like(x, surf.pos[1]))
        vals = np.where(mask, vals, np.nan)
        if remove_offset:
            vals = vals - surf.pos[2]
        plt.plot(x, vals, label=surf.get_desc())
    plt.xlabel("x in mm")
    plt.ylabel("z in mm")
    plt.legend()
    plt.title(title)
    plt.tight_layout()
    _save_or_show(path, sargs)
