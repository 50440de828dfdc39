"""optrace_tpu_torch — the PyTorch/CUDA port of ``optrace_tpu``.

A sequential Monte-Carlo raytracer on torch tensors, for an NVIDIA Hopper
GPU: scene description, source sampling, the surface-by-surface trace
(Snell, Fresnel, polarization, ideal lenses, filters, HURB edge diffraction,
INFOS counters), the detector hit search and XYZW binning behind the fused
streaming render, the stored trace carried through to detector and source
images and spectra, and the batched renders ``Raytracer.iterative_render``
and ``render_huge`` with checkpointing. The hot loops are
hand-written CUDA kernels (``ops/cuda_run.py``, ``ops/cuda_binning.py``,
and the single-step probe ``ops/cuda_trace.py``) with a plain PyTorch
version beside each.

Every entry point takes ``device=None``, which means the CUDA device; the
CPU is used only when ``device="cpu"`` is passed.
"""

from .utils import global_options, OptraceWarning, warning, BaseClass  # noqa: F401
from .utils.device import resolve_device, make_generator  # noqa: F401
from . import color  # noqa: F401
from . import ops  # noqa: F401

from .spectrum import Spectrum, LightSpectrum, TransmissionSpectrum, RefractionIndex  # noqa: F401
from .geometry import (Surface, CircularSurface, RingSurface, ConicSurface,  # noqa: F401
                       SphericalSurface, RectangularSurface, AsphericSurface,
                       TiltedSurface, SlitSurface,
                       Point, Line, Element, Lens, IdealLens, Filter, Aperture,
                       Detector, RaySource, Group)
from .image import BaseImage, ScalarImage, GrayscaleImage, RGBImage, RenderImage  # noqa: F401
from .tracer import Raytracer, RayStorage  # noqa: F401
from .parallel import make_fused_render, make_fused_render_multi, RenderCheckpoint  # noqa: F401
from . import presets  # noqa: F401

__version__ = "0.1.0"
