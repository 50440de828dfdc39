"""Matplotlib setup: headless backend fallback and dark-mode styling wired
to global_options (counterpart of ``optrace_tpu/plots/init.py``)."""

import os

import matplotlib

if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from ..utils.global_options import global_options  # noqa: E402


def _apply_dark_mode(val: bool = None) -> None:
    """Apply dark/light styling according to global_options.plot_dark_mode."""
    val = global_options.plot_dark_mode if val is None else val
    if val:
        plt.style.use("dark_background")
        matplotlib.rcParams.update({"figure.facecolor": "#131313",
                                    "axes.facecolor": "#1a1a1a"})
    else:
        plt.style.use("default")
