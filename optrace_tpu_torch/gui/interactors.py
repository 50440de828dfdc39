"""Interactive layer for the TraceGUI: rendered widgets, mouse picking and
keyboard shortcuts (counterpart of ``optrace_tpu/gui/interactors.py``;
reference ``optrace/gui/interactors.py:8-204`` and the custom-UI widget tab
``trace_gui.py:909-975``).

The reference builds its interaction layer on Qt/VTK: a ``Picker`` that
fires on click-without-drag, a ``KeyboardShortcuts`` observer on the VTK
interactor, and traitsui widgets for the custom checkbox/button/value/
selection hooks. Here the same capabilities are rendered with native
matplotlib machinery — ``CheckButtons``/``Button``/``Slider``/
``RadioButtons``/``TextBox`` widgets in a side panel of the scene figure,
``button_press/release_event`` picking with drag suppression, and a
``key_press_event`` table with the reference's bindings — which keeps the
whole layer headless-testable under Agg (events can be synthesized through
the canvas callback registry).
"""

import numpy as np
import matplotlib.pyplot as plt
from matplotlib.widgets import Button, CheckButtons, RadioButtons, Slider, TextBox
from mpl_toolkits.mplot3d import proj3d


class SidePanel:
    """Rendered widget panel on the right side of the scene figure.

    Holds the built-in display toggles plus one real widget per custom-UI
    hook registered through ``TraceGUI.add_custom_*``. Widget state and the
    GUI's hook dictionaries stay in sync in both directions: interacting
    with a widget routes through the same ``set_custom_*`` entry points as
    the automation API, and programmatic ``set_custom_*`` calls update the
    widget silently (reference custom tab, trace_gui.py:909-975).
    """

    PANEL_LEFT = 0.76          # scene occupies [0, PANEL_LEFT) of the figure
    _BUILTIN_CHECKS = ["minimalistic_view", "hide_labels", "high_contrast",
                       "log_image", "flip_detector_image"]

    def __init__(self, gui) -> None:
        self.gui = gui
        self.fig = gui.scene.fig
        self._axes = []            # all widget axes (for visibility toggling)
        self.widgets = {}          # name -> widget object
        self._syncing = False      # guard: widget callback vs programmatic set
        self.build()

    # -- layout helpers -------------------------------------------------
    def _next_ax(self, height: float):
        """Allocate the next widget axes slot from top to bottom."""
        pad = 0.012
        y = self._cursor - height
        ax = self.fig.add_axes([self.PANEL_LEFT + 0.02, y, 0.20, height])
        self._cursor = y - pad
        self._axes.append(ax)
        return ax

    def build(self) -> None:
        """(Re)create all widget axes from the current GUI state.

        The old widgets' canvas callbacks are disconnected before their axes
        go: a widget outlives its removed axes until the garbage collector
        finds it, and its draw callback would then fail on the next draw of
        the figure (the JAX package's panel leaves them connected)."""
        for w in self.widgets.values():
            w.disconnect_events()
        for ax in self._axes:
            try:
                ax.remove()
            except Exception:
                pass
        self._axes = []
        self.widgets = {}
        self._cursor = 0.98
        gui = self.gui

        # --- built-in display toggles ---------------------------------
        n = len(self._BUILTIN_CHECKS)
        ax = self._next_ax(0.028 * n)
        ax.set_title("View", fontsize=7)
        cb = CheckButtons(ax, self._BUILTIN_CHECKS,
                          [bool(getattr(gui, k)) for k in self._BUILTIN_CHECKS])
        cb.on_clicked(self._on_builtin_check)
        self.widgets["_builtin_checks"] = cb

        # --- rays visible / opacity sliders ---------------------------
        ax = self._next_ax(0.024)
        sl = Slider(ax, "rays", 1, 4, valinit=float(np.log10(max(gui.rays_visible, 1))))
        sl.valtext.set_text(str(gui.rays_visible))
        sl.on_changed(self._on_rays_visible)
        self.widgets["_rays_visible"] = sl

        ax = self._next_ax(0.024)
        sl = Slider(ax, "opacity", -5.0, 0.0,
                    valinit=float(np.log10(max(gui.ray_opacity, 1e-5))))
        sl.valtext.set_text(f"{gui.ray_opacity:.3g}")
        sl.on_changed(self._on_ray_opacity)
        self.widgets["_ray_opacity"] = sl

        # --- coloring mode --------------------------------------------
        modes = gui.coloring_modes
        ax = self._next_ax(0.021 * len(modes))
        ax.set_title("Coloring", fontsize=7)
        rb = RadioButtons(ax, modes, active=modes.index(gui.coloring_mode))
        rb.on_clicked(self._on_coloring)
        self.widgets["_coloring"] = rb

        # --- action buttons -------------------------------------------
        for name, cb_fn in [("Retrace", gui.retrace),
                            ("Detector image", gui.detector_image),
                            ("Source image", gui.source_image),
                            ("Focus", gui.move_to_focus)]:
            ax = self._next_ax(0.030)
            b = Button(ax, name)
            b.label.set_fontsize(7)
            b.on_clicked(self._wrap_action(cb_fn))
            self.widgets[f"_action:{name}"] = b

        # --- custom UI hooks (reference trace_gui.py:909-975) ---------
        if gui._custom_checkboxes:
            names = list(gui._custom_checkboxes)
            ax = self._next_ax(0.028 * len(names))
            ax.set_title("Custom", fontsize=7)
            cbx = CheckButtons(ax, names,
                               [gui._custom_checkboxes[k][0] for k in names])
            cbx.on_clicked(self._on_custom_check)
            self.widgets["_custom_checks"] = cbx

        for name in gui._custom_buttons:
            ax = self._next_ax(0.030)
            b = Button(ax, name)
            b.label.set_fontsize(7)
            b.on_clicked(self._wrap_custom_button(name))
            self.widgets[f"custom_button:{name}"] = b

        for name, (val, _) in gui._custom_values.items():
            ax = self._next_ax(0.028)
            tb = TextBox(ax, name, initial=repr(float(val)))
            tb.label.set_fontsize(7)
            tb.on_submit(self._wrap_custom_value(name))
            self.widgets[f"custom_value:{name}"] = tb

        for name, (val, lst, _) in gui._custom_selections.items():
            ax = self._next_ax(0.021 * len(lst))
            ax.set_title(name, fontsize=7)
            rb = RadioButtons(ax, lst, active=lst.index(val))
            rb.on_clicked(self._wrap_custom_selection(name))
            self.widgets[f"custom_selection:{name}"] = rb

        self.set_visible(not bool(gui.maximize_scene))

    # -- widget -> GUI callbacks ----------------------------------------
    def _on_builtin_check(self, label: str) -> None:
        if self._syncing:
            return
        status = dict(zip(self._BUILTIN_CHECKS,
                          self.widgets["_builtin_checks"].get_status()))
        self._syncing = True
        try:
            setattr(self.gui, label, bool(status[label]))
            if label in ("minimalistic_view", "hide_labels", "high_contrast"):
                self.gui.replot()
        finally:
            self._syncing = False

    def _on_rays_visible(self, val: float) -> None:
        if self._syncing:
            return
        n = int(round(10.0 ** float(val)))
        self.widgets["_rays_visible"].valtext.set_text(str(n))
        self._syncing = True
        try:
            self.gui.rays_visible = n          # triggers replot_rays
        finally:
            self._syncing = False

    def _on_ray_opacity(self, val: float) -> None:
        if self._syncing:
            return
        op = float(10.0 ** float(val))
        self.widgets["_ray_opacity"].valtext.set_text(f"{op:.3g}")
        self._syncing = True
        try:
            self.gui.ray_opacity = op
        finally:
            self._syncing = False

    def _on_coloring(self, label: str) -> None:
        if self._syncing:
            return
        self._syncing = True
        try:
            self.gui.coloring_mode = label
        finally:
            self._syncing = False

    def _wrap_action(self, fn):
        def cb(event):
            if not self._syncing:
                fn()
        return cb

    def _on_custom_check(self, label: str) -> None:
        if self._syncing:
            return
        names = list(self.gui._custom_checkboxes)
        status = dict(zip(names, self.widgets["_custom_checks"].get_status()))
        self._syncing = True
        try:
            self.gui.set_custom_checkbox(label, bool(status[label]))
        finally:
            self._syncing = False

    def _wrap_custom_button(self, name):
        def cb(event):
            if not self._syncing:
                self.gui.press_custom_button(name)
        return cb

    def _wrap_custom_value(self, name):
        def cb(text):
            if self._syncing:
                return
            try:
                val = float(text)
            except ValueError:
                return
            self._syncing = True
            try:
                self.gui.set_custom_value(name, val)
            finally:
                self._syncing = False
        return cb

    def _wrap_custom_selection(self, name):
        def cb(label):
            if not self._syncing:
                self._syncing = True
                try:
                    self.gui.set_custom_selection(name, label)
                finally:
                    self._syncing = False
        return cb

    # -- GUI -> widget silent sync ---------------------------------------
    def sync_custom(self, kind: str, name: str) -> None:
        """Reflect a programmatic set_custom_* call into the rendered
        widget without re-firing its callback."""
        if self._syncing:
            return
        self._syncing = True
        try:
            if kind == "checkbox" and "_custom_checks" in self.widgets:
                w = self.widgets["_custom_checks"]
                names = list(self.gui._custom_checkboxes)
                i = names.index(name)
                want = bool(self.gui._custom_checkboxes[name][0])
                if w.get_status()[i] != want:
                    w.eventson = False
                    try:
                        w.set_active(i)
                    finally:
                        w.eventson = True
            elif kind == "value" and f"custom_value:{name}" in self.widgets:
                w = self.widgets[f"custom_value:{name}"]
                w.eventson = False
                try:
                    w.set_val(repr(float(self.gui._custom_values[name][0])))
                finally:
                    w.eventson = True
            elif kind == "selection" and f"custom_selection:{name}" in self.widgets:
                w = self.widgets[f"custom_selection:{name}"]
                val, lst, _ = self.gui._custom_selections[name]
                w.eventson = False
                try:
                    w.set_active(lst.index(val))
                finally:
                    w.eventson = True
        finally:
            self._syncing = False

    def sync_builtin(self, key: str) -> None:
        """Reflect a programmatic display-property assignment into the
        built-in widgets."""
        if self._syncing or key not in self._BUILTIN_CHECKS:
            return
        w = self.widgets.get("_builtin_checks")
        if w is None:
            return
        i = self._BUILTIN_CHECKS.index(key)
        want = bool(getattr(self.gui, key))
        if w.get_status()[i] != want:
            self._syncing = True
            w.eventson = False
            try:
                w.set_active(i)
            finally:
                w.eventson = True
                self._syncing = False

    def set_visible(self, visible: bool) -> None:
        """Show/hide the panel ('h' shortcut / maximize_scene property)."""
        for ax in self._axes:
            ax.set_visible(visible)

    # -- test/automation helper ------------------------------------------
    def click_button(self, name: str) -> None:
        """Fire a rendered Button through a synthetic canvas event — the
        headless stand-in for a real mouse click on the widget."""
        from matplotlib.backend_bases import MouseEvent

        key = name if name in self.widgets else f"custom_button:{name}" \
            if f"custom_button:{name}" in self.widgets else f"_action:{name}"
        w = self.widgets[key]
        bbox = w.ax.get_window_extent()
        x, y = (bbox.x0 + bbox.x1) / 2, (bbox.y0 + bbox.y1) / 2
        canvas = self.fig.canvas
        canvas.callbacks.process(
            "button_press_event",
            MouseEvent("button_press_event", canvas, x, y, button=1))
        canvas.callbacks.process(
            "button_release_event",
            MouseEvent("button_release_event", canvas, x, y, button=1))


class MousePicking:
    """Click picking on the 3D scene with drag suppression (reference
    ``interactors.py:8-63``: pick only fires when the mouse has not moved
    between press and release).

    Left click: highlight the nearest displayed ray section (within a
    pixel tolerance) and show its info text; clicking empty space clears
    the pick. Right click: space pick — place the crosshair at the
    picked scene position (reference right-button picker,
    trace_gui.py space picking / _scene_plotting.py:1248-1364).
    """

    PICK_TOL_PX = 25.0

    def __init__(self, gui) -> None:
        self.gui = gui
        self._moved = False
        self._pressed_button = None
        canvas = gui.scene.fig.canvas
        self._cids = [
            canvas.mpl_connect("button_press_event", self._on_press),
            canvas.mpl_connect("motion_notify_event", self._on_move),
            canvas.mpl_connect("button_release_event", self._on_release),
        ]

    def _on_press(self, event) -> None:
        if event.inaxes is self.gui.scene.ax:
            self._moved = False
            self._pressed_button = event.button

    def _on_move(self, event) -> None:
        if self._pressed_button is not None:
            self._moved = True

    def _on_release(self, event) -> None:
        button, self._pressed_button = self._pressed_button, None
        if button is None or self._moved or event.inaxes is not self.gui.scene.ax:
            return
        hit = self.pick_display(event.x, event.y)
        scene = self.gui.scene
        if hit is None:
            self.gui.reset_picking()
            scene.set_pick_text("")
            return
        index, section, pos = hit
        if int(getattr(button, "value", button)) == 3:   # right: space pick
            txt = self.gui.pick_space(pos)
        else:                                            # left: ray pick
            txt = self.gui.pick_ray_section(index, section)
        scene.set_pick_text(txt)

    def pick_display(self, x: float, y: float):
        """Nearest displayed ray-section to display coords (x, y) within
        tolerance; returns (ray_index, section_index, pos3d) or None."""
        gui = self.gui
        rays = gui.raytracer.rays
        sel = gui.scene._ray_selection
        if not rays.N or not np.any(sel):
            return None
        idx = np.where(sel)[0]
        p = rays.rays_by_mask(sel, ret=[1, 0, 0, 0, 0, 0, 0])[0]          # (n, nt, 3)
        ax = gui.scene.ax
        flat = p.reshape(-1, 3)
        x2, y2, _ = proj3d.proj_transform(flat[:, 0], flat[:, 1], flat[:, 2],
                                          ax.get_proj())
        xy = ax.transData.transform(np.column_stack([x2, y2]))
        d2 = (xy[:, 0] - x) ** 2 + (xy[:, 1] - y) ** 2
        k = int(np.argmin(d2))
        if d2[k] > self.PICK_TOL_PX ** 2:
            return None
        nt = p.shape[1]
        return int(idx[k // nt]), int(k % nt), flat[k]

    def disconnect(self) -> None:
        canvas = self.gui.scene.fig.canvas
        for cid in self._cids:
            canvas.mpl_disconnect(cid)


class KeyboardShortcuts:
    """The reference's shortcut table on matplotlib key events
    (reference ``interactors.py:117-204``):

    i: reset view · h: hide/show side panel · v: minimalistic view ·
    c: high contrast · b: hide labels · d: render detector image ·
    0: close all pyplots · n: re-select and replot rays · +/-: zoom ·
    arrows: move camera · shift+arrows: rotate view
    """

    def __init__(self, gui) -> None:
        self.gui = gui
        canvas = gui.scene.fig.canvas
        self._cid = canvas.mpl_connect("key_press_event", self.on_key)

    def on_key(self, event) -> None:
        gui, ax = self.gui, self.gui.scene.ax
        key = event.key or ""
        if key == "i":
            if gui.scene._initial_camera:
                gui.set_camera(**gui.scene._initial_camera)
            else:
                ax.view_init()
                o = gui.raytracer.outline
                ax.set_xlim(o[0], o[1]); ax.set_ylim(o[2], o[3])
                ax.set_zlim(o[4], o[5])
        elif key == "h":
            gui.maximize_scene = not bool(gui.maximize_scene)
        elif key == "v":
            gui.minimalistic_view = not bool(gui.minimalistic_view)
            gui.replot()
        elif key == "c":
            gui.high_contrast = not bool(gui.high_contrast)
            gui.replot()
        elif key == "b":
            gui.hide_labels = not bool(gui.hide_labels)
            gui.replot()
        elif key == "d":
            if gui.raytracer.detectors and gui.raytracer.rays.N:
                gui.detector_image()
        elif key == "0":
            for num in plt.get_fignums():
                if plt.figure(num) is not gui.scene.fig:
                    plt.close(num)
        elif key == "n":
            gui.replot_rays()
        elif key in ("+", "-"):
            f = 1 / 1.1 if key == "+" else 1.1
            for get, set_ in [(ax.get_xlim, ax.set_xlim),
                              (ax.get_ylim, ax.set_ylim),
                              (ax.get_zlim, ax.set_zlim)]:
                lo, hi = get()
                m, h = (lo + hi) / 2, (hi - lo) * f
                set_(m - h / 2, m + h / 2)
        elif key in ("shift+up", "shift+down", "shift+left", "shift+right"):
            del_e = {"shift+up": 5, "shift+down": -5}.get(key, 0)
            del_a = {"shift+left": 5, "shift+right": -5}.get(key, 0)
            ax.view_init(elev=ax.elev + del_e, azim=ax.azim + del_a)
        elif key in ("up", "down", "left", "right"):
            h = float(np.ptp(ax.get_xlim()))
            step = h / 20 if key in ("up", "down") else h / 15
            dx = {"left": -step, "right": step}.get(key, 0.0)
            dz = {"up": step, "down": -step}.get(key, 0.0)
            for get, set_, d in [(ax.get_xlim, ax.set_xlim, dx),
                                 (ax.get_zlim, ax.set_zlim, dz)]:
                lo, hi = get()
                set_(lo + d, hi + d)
        if gui.scene.fig is not None:
            gui.scene.fig.canvas.draw_idle()

    def press(self, key: str) -> None:
        """Synthesize a key press (headless automation/test helper)."""
        from matplotlib.backend_bases import KeyEvent

        canvas = self.gui.scene.fig.canvas
        canvas.callbacks.process("key_press_event",
                                 KeyEvent("key_press_event", canvas, key))

    def disconnect(self) -> None:
        self.gui.scene.fig.canvas.mpl_disconnect(self._cid)
