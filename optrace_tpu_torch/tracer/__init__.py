"""Trace engine (counterpart of ``optrace_tpu/tracer``): scene compilation to
pure tensor step functions, the surface-sequential trace, ray storage, and
the Raytracer orchestrator."""

from .ray_storage import RayStorage  # noqa: F401
from .raytracer import Raytracer  # noqa: F401
