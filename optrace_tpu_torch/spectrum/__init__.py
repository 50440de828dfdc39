"""Spectra and dispersive media (counterpart of ``optrace_tpu/spectrum``)."""

from .spectrum import Spectrum  # noqa: F401
from .light_spectrum import LightSpectrum  # noqa: F401
from .transmission_spectrum import TransmissionSpectrum  # noqa: F401
from .refraction_index import RefractionIndex  # noqa: F401
