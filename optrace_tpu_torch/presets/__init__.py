"""Preset catalogs: spectral lines, spectra, refraction indices, geometries, images
(counterpart of ``optrace_tpu/presets``)."""

from . import spectral_lines  # noqa: F401
from . import light_spectrum  # noqa: F401
from . import refraction_index  # noqa: F401
from . import geometry  # noqa: F401
from . import image  # noqa: F401
