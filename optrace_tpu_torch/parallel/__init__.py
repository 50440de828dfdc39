"""Fused streaming render and its checkpointing (counterpart of
``optrace_tpu/parallel``; the sharded render arrives with its own slice)."""

from .render import make_fused_render, make_fused_render_multi  # noqa: F401
from .checkpoint import RenderCheckpoint  # noqa: F401
