"""Compute functions of the port: vector math, sampling, intersection,
binning, and the two hand-written CUDA kernels with their plain versions
(``cuda_run``, ``cuda_binning``)."""

from . import vector      # noqa: F401
from . import sampling    # noqa: F401
