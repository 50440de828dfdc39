"""Spectra and dispersive media (counterpart of ``optrace_tpu/spectrum``;
``TransmissionSpectrum`` arrives with the filter step)."""

from .spectrum import Spectrum  # noqa: F401
from .light_spectrum import LightSpectrum  # noqa: F401
from .refraction_index import RefractionIndex  # noqa: F401
