"""TraceGUI: interactive/automatable frontend around a Raytracer.

Behavioral parity with reference ``optrace/gui/trace_gui.py`` (SURVEY.md
§2.9): the same display properties (ray_count, rays_visible, opacity/width,
coloring/image modes, per-source/detector selections, ...), the same
automation API (control, debug, screenshot, set_camera, pick_ray,
run_command with smart replot, custom UI hooks) and the same actions
(retrace, detector/source image/profile/spectrum, focus search).

Architectural difference: the reference marshals work between a Qt event
loop and background threads; here everything runs synchronously on a
matplotlib 3D scene (headless-safe under Agg), which is also what makes the
GUI fully scriptable in tests and batch jobs.

Counterpart of ``optrace_tpu/gui/trace_gui.py``. Every action runs on the
raytracer's device (``RT.device``, the CUDA device unless the raytracer was
built with ``device="cpu"``): ``retrace`` is ``Raytracer.trace``, and the
detector and source images and spectra and the focus search read the
sections that the trace keeps on that device. The scene draws the rays it
shows, which alone are copied to the host (``RT.rays.rays_by_mask``).
"""

from contextlib import contextmanager
from typing import Any, Callable

import numpy as np
import matplotlib.pyplot as plt

from ..tracer.raytracer import Raytracer
from ..image.render_image import RenderImage
from ..geometry.surface import SphericalSurface
from ..utils.property_checker import PropertyChecker as pc
from ..utils.warnings import warning
from .. import plots
from .scene_plotting import ScenePlotting
from .command_window import CommandWindow
from .property_browser import PropertyBrowser


class TraceGUI:

    coloring_modes: list = ScenePlotting.coloring_modes
    image_modes: list = RenderImage.image_modes
    projection_methods: list = SphericalSurface.sphere_projection_methods
    focus_search_methods: list = Raytracer.focus_search_methods

    # properties that trigger automatic updates when assigned
    _RAY_PROPS = {"rays_visible", "ray_opacity", "ray_width", "coloring_mode"}
    _TRACE_PROPS = {"ray_count"}

    def __init__(self, raytracer: Raytracer, initial_camera: dict = None, **kwargs) -> None:
        pc.check_type("raytracer", raytracer, Raytracer)
        self.raytracer = raytracer

        # display properties (reference trait defaults, trace_gui.py:41-165)
        self.__dict__["ray_count"] = 200000
        self.rays_visible = 2000
        self.ray_opacity = 0.01
        self.ray_width = 1.0
        self.coloring_mode = "Plain"
        self.image_mode = "sRGB (Absolute RI)"
        self.image_pixels = 315
        self.log_image = False
        self.flip_detector_image = False
        self.projection_method = "Equidistant"
        self.focus_search_method = "RMS Spot Size"
        self.focus_search_single_source = False
        self.detector_image_single_source = False
        self.activate_filter = False
        self.minimalistic_view = False
        self.hide_labels = False
        self.vertical_labels = False
        self.high_contrast = False
        self.maximize_scene = False

        self.detector_selection = f"DET0" if raytracer.detectors else ""
        self.source_selection = f"RS0" if raytracer.ray_sources else ""

        self._custom_checkboxes = {}
        self._custom_buttons = {}
        self._custom_values = {}
        self._custom_selections = {}

        self._busy = False
        self._last_snapshot = None
        self._initialized = False

        self.scene = ScenePlotting(self, raytracer, initial_camera=initial_camera)
        self._command_window = None
        self._property_browser = None
        # interactive layer, built in init_scene (interactors.py)
        self.panel = None
        self.picker = None
        self.shortcuts = None

        for k, v in kwargs.items():
            setattr(self, k, v)

    # ------------------------------------------------------------------
    # property handling with automatic replot (trait-observer analog)

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("coloring_mode",):
            pc.check_if_element(key, val, self.coloring_modes)
        elif key == "image_mode":
            pc.check_if_element(key, val, self.image_modes)
        elif key == "projection_method":
            pc.check_if_element(key, val, self.projection_methods)
        elif key == "focus_search_method":
            pc.check_if_element(key, val, self.focus_search_methods)
        elif key == "ray_count":
            pc.check_type(key, val, int)
            pc.check_above(key, val, 0)
        object.__setattr__(self, key, val)

        if getattr(self, "_initialized", False):
            if key in self._TRACE_PROPS:
                self.retrace()
            elif key in self._RAY_PROPS:
                self.replot_rays()
        panel = getattr(self, "panel", None)
        if panel is not None:
            if key == "maximize_scene":
                panel.set_visible(not bool(val))
            else:
                panel.sync_builtin(key)

    # ------------------------------------------------------------------
    @property
    def detector_names(self) -> list:
        return [f"DET{i}" for i in range(len(self.raytracer.detectors))]

    @property
    def source_names(self) -> list:
        return [f"RS{i}" for i in range(len(self.raytracer.ray_sources))]

    @property
    def _detector_index(self) -> int:
        return int(self.detector_selection[3:]) if self.detector_selection else 0

    @property
    def _source_index(self) -> int:
        return int(self.source_selection[2:]) if self.source_selection else 0

    @property
    def busy(self) -> bool:
        return self._busy

    # ------------------------------------------------------------------
    # lifecycle

    def init_scene(self) -> None:
        self.scene.init_scene()
        # rendered widgets + mouse picking + keyboard shortcuts
        # (reference interactors.py:8-204, trace_gui.py:909-975)
        from .interactors import SidePanel, MousePicking, KeyboardShortcuts
        if self.panel is None:
            self.panel = SidePanel(self)
            self.picker = MousePicking(self)
            self.shortcuts = KeyboardShortcuts(self)
        self.retrace()
        self._initialized = True

    def run(self, _block: bool = None) -> None:
        """Build the scene, trace and show the window (no-op display under
        a headless backend)."""
        self.init_scene()
        if _block is None:
            _block = plt.get_backend().lower() != "agg"
        if _block:
            plt.show(block=True)

    def close(self, event=None) -> None:
        if self.scene.fig is not None:
            plt.close(self.scene.fig)
        self._initialized = False

    # ------------------------------------------------------------------
    # automation API

    def control(self, func: Callable, args: tuple = (), kwargs: dict = None) -> None:
        """Run an automation function after the scene is built (synchronous;
        the reference marshals it to the GUI thread, trace_gui.py:864-895).
        ``args``/``kwargs`` are passed verbatim — pass the GUI yourself if
        the function needs it, as the reference examples do."""
        pc.check_callable("func", func)
        pc.check_type("args", args, tuple)
        if not self._initialized:
            self.init_scene()
        func(*args, **(kwargs or {}))

    def debug(self, func: Callable, args: tuple = (), kwargs: dict = None) -> None:
        """Alias of control() in the synchronous GUI."""
        self.control(func, args, kwargs)

    def screenshot(self, path: str = None, **kwargs) -> np.ndarray:
        """Render the scene; save to path if given, return the RGB array."""
        if not self._initialized:
            self.init_scene()
        fig = self.scene.fig
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        if path is not None:
            fig.savefig(path, **kwargs)
        return buf

    def set_camera(self, center=None, height: float = None, direction=None,
                   roll: float = None) -> None:
        """Set the 3D view (center / zoom height / viewing direction)."""
        ax = self.scene.ax
        if ax is None:
            self.scene.init_scene()
            ax = self.scene.ax
        if direction is not None:
            d = np.asarray(direction, dtype=np.float64)
            d = d / np.linalg.norm(d)
            elev = float(np.degrees(np.arcsin(-d[1]))) if abs(d[1]) <= 1 else 0.0
            azim = float(np.degrees(np.arctan2(d[0], d[2])))
            ax.view_init(elev=elev, azim=azim)
        if roll is not None:
            try:
                ax.view_init(elev=ax.elev, azim=ax.azim, roll=roll)
            except TypeError:     # pragma: no cover - old matplotlib
                pass
        if center is not None:
            c = np.asarray(center, dtype=np.float64)
            h = height if height is not None else float(np.ptp(ax.get_xlim()))
            ax.set_xlim(c[0] - h / 2, c[0] + h / 2)
            ax.set_ylim(c[1] - h / 2, c[1] + h / 2)
            ax.set_zlim(c[2] - h / 2, c[2] + h / 2)
        elif height is not None:
            for get, set_ in [(ax.get_xlim, ax.set_xlim), (ax.get_ylim, ax.set_ylim),
                              (ax.get_zlim, ax.set_zlim)]:
                lo, hi = get()
                m = (lo + hi) / 2
                set_(m - height / 2, m + height / 2)

    def get_camera(self):
        ax = self.scene.ax
        center = np.array([np.mean(ax.get_xlim()), np.mean(ax.get_ylim()),
                           np.mean(ax.get_zlim())])
        height = float(np.ptp(ax.get_xlim()))
        elev, azim = np.radians(ax.elev), np.radians(ax.azim)
        direction = np.array([np.cos(elev) * np.sin(azim), -np.sin(elev),
                              np.cos(elev) * np.cos(azim)])
        return center, height, direction, getattr(ax, "roll", 0.0)

    # ------------------------------------------------------------------
    # picking

    def pick_ray(self, index: int) -> str:
        """Highlight a traced ray; returns its info text."""
        self._check_rays()
        pc.check_not_below("index", index, 0)
        pc.check_below("index", index, self.raytracer.rays.N)
        self.scene.highlight_ray(index)
        return self.scene.ray_info_text(index)

    def pick_ray_section(self, index: int, section: int, detailed: bool = False) -> str:
        """Highlight one ray section; returns its info text."""
        self._check_rays()
        pc.check_not_below("index", index, 0)
        pc.check_below("index", index, self.raytracer.rays.N)
        pc.check_not_below("section", section, 0)
        pc.check_below("section", section, self.raytracer.rays.Nt)
        self.scene.highlight_ray(index, section)
        return self.scene.ray_info_text(index, section)

    def pick_space(self, pos) -> str:
        """Place the crosshair at a 3D position and return its info text
        (reference space picking, _scene_plotting.py:1248-1364)."""
        pos = np.asarray(pos, dtype=np.float64)
        pc.check_type("pos", pos, np.ndarray)
        if self.scene.ax is None:
            self.scene.init_scene()
        self.scene.plot_crosshair(pos)
        return (f"Position: ({pos[0]:.5g} mm, {pos[1]:.5g} mm, "
                f"{pos[2]:.5g} mm)")

    def pick_nearest_ray_section(self, pos) -> str:
        """Pick the displayed ray section nearest to a 3D position — the
        programmatic form of the reference's click picking. Highlights the
        section and returns its info text."""
        self._check_rays()
        hit = self.scene.pick_nearest_section(pos)
        if hit is None:
            raise RuntimeError("No rays displayed to pick from.")
        index, section = hit
        return self.pick_ray_section(index, section)

    def reset_picking(self) -> None:
        self.scene.clear_picking()

    # ------------------------------------------------------------------
    # actions

    def _check_rays(self) -> None:
        if not self.raytracer.rays.N:
            raise RuntimeError("No rays traced.")

    def retrace(self, event=None) -> None:
        """Trace with the current ray_count and replot."""
        self._busy = True
        try:
            if self.raytracer.ray_sources:
                self.raytracer.trace(self.ray_count)
            self.replot()
        finally:
            self._busy = False

    def replot(self, change: dict = None) -> None:
        if self.scene.ax is None:
            self.scene.init_scene()
        self.scene.replot()
        self._last_snapshot = self.raytracer.property_snapshot()

    def replot_rays(self, event=None, mask: np.ndarray = None, max_show: int = None) -> None:
        if self.raytracer.rays.N:
            self.scene.plot_rays(mask=mask, max_show=max_show)

    def select_rays(self, mask: np.ndarray, max_show: int = None) -> None:
        """Display only the rays selected by the boolean mask."""
        pc.check_type("mask", mask, np.ndarray)
        self.replot_rays(mask=mask, max_show=max_show)

    @property
    def ray_selection(self) -> np.ndarray:
        """boolean mask of the currently displayed rays"""
        return self.scene._ray_selection

    @contextmanager
    def smart_replot(self, automatic_replot: bool = True):
        """Context manager: snapshot the raytracer properties before the
        block, compare after, and retrace/replot exactly what changed
        (reference trace_gui.py:571-589). Scene mutations belong INSIDE
        the ``with`` block::

            with GUI.smart_replot():
                RT.ray_sources[0].move_to([0, 1, -15])
        """
        snap = self.raytracer.property_snapshot() if automatic_replot else None
        try:
            yield
        finally:
            if automatic_replot:
                now = self.raytracer.property_snapshot()
                diff = self.raytracer.compare_property_snapshot(snap, now)
                if any(diff[k] for k in ("Lenses", "Filters", "Apertures",
                                         "RaySources", "Ambient")):
                    self.retrace()
                elif diff["Any"]:
                    self.replot()

    def process(self) -> None:
        """Flush pending display events so property changes become visible
        (reference trace_gui.py:591-604 processes the Qt event queue; the
        synchronous GUI only needs a canvas redraw)."""
        if self.scene.fig is not None:
            try:
                self.scene.fig.canvas.draw_idle()
                self.scene.fig.canvas.flush_events()
            except Exception:   # pragma: no cover - backend without events
                pass

    def run_command(self, cmd: str, automatic_replot: bool = True) -> None:
        """Execute a command string with the GUI/raytracer in scope, then
        smart-replot (reference command window, trace_gui.py:1748+).
        ``ot`` is this package, ``optrace_tpu_torch``."""
        import optrace_tpu_torch as ot
        env = dict(GUI=self, RT=self.raytracer, ot=ot, np=np)
        with self.smart_replot(automatic_replot):
            exec(cmd, env)

    @property
    def command_window(self) -> CommandWindow:
        """The command window (REPL with history), created on first access
        (reference opens it as a Qt dialog, command_window.py:12)."""
        if self._command_window is None:
            self._command_window = CommandWindow(self)
        return self._command_window

    @property
    def property_browser(self) -> PropertyBrowser:
        """The property browser (state dictionaries incl. TMA cardinal
        points), created on first access (reference property_browser.py:14)."""
        if self._property_browser is None:
            self._property_browser = PropertyBrowser(self)
        return self._property_browser

    def open_command_window(self) -> CommandWindow:
        """Reference menu action analog; returns the window object."""
        return self.command_window

    def open_property_browser(self) -> PropertyBrowser:
        """Reference menu action analog; updates and returns the browser."""
        pb = self.property_browser
        pb.update_dict()
        return pb

    # ---- image / spectrum / focus actions ----------------------------

    def detector_image(self, event=None, extent=None, **kwargs) -> RenderImage:
        self._check_rays()
        source_index = self._source_index if self.detector_image_single_source else None
        img = self.raytracer.detector_image(
            detector_index=self._detector_index, source_index=source_index,
            extent=extent, projection_method=self.projection_method, **kwargs)
        self.last_det_image = img
        plots.image_plot(img.get(self.image_mode, self.image_pixels),
                         log=self.log_image, flip=self.flip_detector_image)
        return img

    def detector_profile(self, event=None, extent=None, **kwargs) -> None:
        self._check_rays()
        img = self.raytracer.detector_image(detector_index=self._detector_index,
                                            extent=extent,
                                            projection_method=self.projection_method)
        plots.image_profile_plot(img.get(self.image_mode, self.image_pixels),
                                 x=0.0, **kwargs)

    def detector_spectrum(self, event=None, extent=None, **kwargs) -> None:
        self._check_rays()
        spec = self.raytracer.detector_spectrum(detector_index=self._detector_index,
                                                extent=extent, **kwargs)
        plots.spectrum_plot(spec)

    def source_image(self, event=None, **kwargs) -> RenderImage:
        self._check_rays()
        img = self.raytracer.source_image(source_index=self._source_index, **kwargs)
        plots.image_plot(img.get(self.image_mode, self.image_pixels))
        return img

    def source_profile(self, event=None, **kwargs) -> None:
        self._check_rays()
        img = self.raytracer.source_image(source_index=self._source_index)
        plots.image_profile_plot(img.get(self.image_mode, self.image_pixels), x=0.0)

    def source_spectrum(self, event=None, **kwargs) -> None:
        self._check_rays()
        spec = self.raytracer.source_spectrum(source_index=self._source_index)
        plots.spectrum_plot(spec)

    def move_to_focus(self, event=None, **kwargs) -> None:
        """Run focus search from the selected detector position and move the
        detector there."""
        self._check_rays()
        det = self.raytracer.detectors[self._detector_index]
        src = self._source_index if self.focus_search_single_source else None
        res, fsdict = self.raytracer.focus_search(self.focus_search_method,
                                                  z_start=det.pos[2],
                                                  source_index=src, **kwargs)
        det.move_to([det.pos[0], det.pos[1], res.x])
        self.last_focus_result = (res, fsdict)
        self.replot()

    # ------------------------------------------------------------------
    # custom UI hooks (reference trace_gui.py:909-975)

    def _panel_rebuild(self) -> None:
        """Re-render the side panel after a custom hook is registered on a
        live scene (hooks registered before init_scene are rendered by the
        initial build)."""
        if self.panel is not None:
            self.panel.build()

    def add_custom_checkbox(self, name: str, val: bool, function: Callable = None) -> None:
        pc.check_type("val", val, bool)
        self._custom_checkboxes[name] = (val, function)
        self._panel_rebuild()

    def add_custom_button(self, name: str, function: Callable) -> None:
        pc.check_callable("function", function)
        self._custom_buttons[name] = function
        self._panel_rebuild()

    def add_custom_value(self, name: str, val: float, function: Callable = None) -> None:
        pc.check_type("val", val, (int, float))
        self._custom_values[name] = (val, function)
        self._panel_rebuild()

    def add_custom_selection(self, name: str, list_: list, val: str,
                             function: Callable = None) -> None:
        pc.check_if_element("val", val, list_)
        self._custom_selections[name] = (val, list_, function)
        self._panel_rebuild()

    def set_custom_checkbox(self, name: str, val: bool) -> None:
        old, fn = self._custom_checkboxes[name]
        self._custom_checkboxes[name] = (val, fn)
        if self.panel is not None:
            self.panel.sync_custom("checkbox", name)
        if fn:
            with self.smart_replot():
                fn(val)

    def press_custom_button(self, name: str) -> None:
        with self.smart_replot():
            self._custom_buttons[name]()

    def set_custom_value(self, name: str, val: float) -> None:
        old, fn = self._custom_values[name]
        self._custom_values[name] = (val, fn)
        if self.panel is not None:
            self.panel.sync_custom("value", name)
        if fn:
            with self.smart_replot():
                fn(val)

    def set_custom_selection(self, name: str, val: str) -> None:
        old, lst, fn = self._custom_selections[name]
        pc.check_if_element("val", val, lst)
        self._custom_selections[name] = (val, lst, fn)
        if self.panel is not None:
            self.panel.sync_custom("selection", name)
        if fn:
            with self.smart_replot():
                fn(val)
