"""Fused streaming render (counterpart of ``optrace_tpu/parallel``; the
sharded render and checkpointing arrive with their own slices)."""

from .render import make_fused_render, make_fused_render_multi  # noqa: F401
