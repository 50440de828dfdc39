"""I/O: ZEMAX .agf glass catalogs and .zmx geometries (counterpart of
``optrace_tpu/io``)."""

from .load import load_agf, load_zmx  # noqa: F401
