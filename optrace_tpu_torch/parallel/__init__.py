"""Fused streaming render, its sharded form over ``torch.distributed`` and
its checkpointing (counterpart of ``optrace_tpu/parallel``)."""

from .render import (make_fused_render, make_fused_render_multi, make_sharded_render,  # noqa: F401
                     default_mesh)
from .checkpoint import RenderCheckpoint  # noqa: F401
