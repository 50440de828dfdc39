"""Matplotlib plotting frontend (counterpart of ``optrace_tpu/plots``): host
figures over this package's objects, turned into numpy at the boundary.
``import optrace_tpu_torch`` does not import this module; it needs
matplotlib, which a machine that only traces may lack."""

from .init import _apply_dark_mode  # noqa: F401
from .image_plots import image_plot, image_profile_plot  # noqa: F401
from .spectrum_plots import spectrum_plot, refraction_index_plot  # noqa: F401
from .chromaticity_plots import (chromaticity_norms, chromaticities_cie_1931,  # noqa: F401
                                 chromaticities_cie_1976)
from .misc_plots import (focus_search_cost_plot, abbe_plot,  # noqa: F401
                         surface_profile_plot, block)
