"""GUI frontend (counterpart of ``optrace_tpu/gui``; reference optrace/gui/,
SURVEY.md §2.9).

The reference uses traits/Qt/pyvista; this rebuild renders the 3D scene
with matplotlib (headless-safe under Agg) and exposes the same automation
API (TraceGUI.control/debug/screenshot/set_camera/pick_ray/run_command and
the trait-style display properties). All actions run synchronously — there
is no separate Qt worker thread to marshal to — and on the raytracer's
device. ``import optrace_tpu_torch`` does not import this package: it needs
matplotlib, which the package itself does not.
"""

from .trace_gui import TraceGUI  # noqa: F401
from .scene_plotting import ScenePlotting  # noqa: F401
from .command_window import CommandWindow  # noqa: F401
from .property_browser import PropertyBrowser  # noqa: F401
