"""Custom warning category with simplified formatting.

Parity with reference ``optrace/warnings.py:5-33``: a dedicated warning
category that is always shown (filter 'always') unless globally disabled.
"""

import warnings as _warnings

from .global_options import global_options


class OptraceWarning(UserWarning):
    """Warning category for all runtime warnings of this package."""


_warnings.simplefilter("always", OptraceWarning)


def warning(message: str) -> None:
    """Emit an :class:`OptraceWarning` unless warnings are globally disabled."""
    if global_options.show_warnings:
        _warnings.warn(message, OptraceWarning, stacklevel=2)
