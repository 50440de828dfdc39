"""Analysis tools (counterpart of ``optrace_tpu/analysis``): paraxial
matrix analysis, PSF convolution on ``torch.fft`` and the axial focus
search."""

from .tma import TMA  # noqa: F401
from .convolve import convolve  # noqa: F401
