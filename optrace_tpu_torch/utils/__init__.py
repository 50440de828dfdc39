"""Infrastructure utilities: options, warnings, validation, progress.

Counterpart of ``optrace_tpu/utils`` (host-only code, copied).
"""

from .global_options import global_options  # noqa: F401
from .warnings import OptraceWarning, warning  # noqa: F401
from .property_checker import PropertyChecker  # noqa: F401
from .progress_bar import ProgressBar  # noqa: F401
from .base_class import BaseClass  # noqa: F401
