"""Package metadata (counterpart of ``optrace_tpu/metadata.py``)."""

name = "optrace_tpu_torch"
version = "0.1.0"
__version__ = version
author = "optrace_tpu developers"
license = "MIT"
documentation = "README.md"
description = ("Sequential Monte-Carlo raytracing, spectral image rendering and optical "
               "analysis in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper GPUs")
