"""The interactive layer of the port's GUI (``optrace_tpu_torch/gui/
interactors.py``) on the CPU, headless under Agg: the rendered widget panel,
mouse picking through synthetic canvas events with drag suppression, and the
keyboard shortcuts. These are the interactor cases of tests/test_gui.py on
the port; the parity of the shortcuts with the JAX package's GUI is in
tests/test_torch_gui.py.

Every test closes the figures that it opened, and no test leaves
``global_options`` or matplotlib's settings changed.
"""

import gc

import numpy as np
import pytest
import matplotlib.pyplot as plt
from matplotlib.backend_bases import MouseEvent
from mpl_toolkits.mplot3d import proj3d

import optrace_tpu_torch as otp
from optrace_tpu_torch.gui import TraceGUI

from test_torch_common import gui_scene, closing_new_figures, without_idle_draws

go = otp.global_options


@pytest.fixture()
def igui():
    log = []
    with closing_new_figures():
        g = TraceGUI(gui_scene(otp), ray_count=3000)
        g.scene.SURFACE_RES = 8         # coarse surface meshes keep each draw short
        g.log = log
        g.add_custom_checkbox("cbox", True, lambda v: log.append(("cb", v)))
        g.add_custom_button("act", lambda: log.append(("btn",)))
        g.add_custom_value("vfield", 1.5, lambda v: log.append(("val", v)))
        g.add_custom_selection("pick", ["a", "b", "c"], "b", lambda v: log.append(("sel", v)))
        with go.no_progress_bar(), go.no_warnings():
            g.init_scene()
        without_idle_draws(g)
        try:
            yield g
        finally:
            g.close()


def _screen_xy(g, index, section=1):
    """Display coordinates of a displayed ray's section after a draw."""
    g.scene.fig.canvas.draw()
    p = g.raytracer.rays.p_list[index, section]
    x2, y2, _ = proj3d.proj_transform(p[0], p[1], p[2], g.scene.ax.get_proj())
    return g.scene.ax.transData.transform((x2, y2))


def _click(g, X, Y, button=1, drag=0.0):
    canvas = g.scene.fig.canvas
    canvas.callbacks.process("button_press_event",
                             MouseEvent("button_press_event", canvas, X, Y, button=button))
    if drag:
        canvas.callbacks.process("motion_notify_event",
                                 MouseEvent("motion_notify_event", canvas, X + drag, Y,
                                            button=button))
    canvas.callbacks.process("button_release_event",
                             MouseEvent("button_release_event", canvas, X + drag, Y,
                                        button=button))


def test_widgets_are_rendered(igui):
    from matplotlib.widgets import Button, CheckButtons, RadioButtons, Slider, TextBox
    w = igui.panel.widgets
    assert isinstance(w["_builtin_checks"], CheckButtons)
    assert isinstance(w["_rays_visible"], Slider)
    assert isinstance(w["_coloring"], RadioButtons)
    assert isinstance(w["_custom_checks"], CheckButtons)
    assert isinstance(w["custom_button:act"], Button)
    assert isinstance(w["custom_value:vfield"], TextBox)
    assert isinstance(w["custom_selection:pick"], RadioButtons)


def test_checkbox_widget_to_dict(igui):
    igui.panel.widgets["_custom_checks"].set_active(0)   # toggle off
    assert igui._custom_checkboxes["cbox"][0] is False
    assert ("cb", False) in igui.log


def test_checkbox_dict_to_widget(igui):
    igui.set_custom_checkbox("cbox", False)
    assert igui.panel.widgets["_custom_checks"].get_status()[0] is False
    igui.set_custom_checkbox("cbox", True)
    assert igui.panel.widgets["_custom_checks"].get_status()[0] is True


def test_button_synthetic_click(igui):
    igui.scene.fig.canvas.draw()
    igui.panel.click_button("act")
    assert ("btn",) in igui.log


def test_action_button_retraces(igui):
    """The panel's Retrace button runs ``Raytracer.trace`` on the
    raytracer's device."""
    igui.scene.fig.canvas.draw()
    seed = igui.raytracer._seed_counter
    with go.no_progress_bar(), go.no_warnings():
        igui.panel.click_button("Retrace")
    assert igui.raytracer._seed_counter == seed + 1
    assert igui.raytracer.rays._dev["p"].device == igui.raytracer.device


def test_value_textbox(igui):
    igui.panel.widgets["custom_value:vfield"].set_val("2.75")
    assert igui._custom_values["vfield"][0] == 2.75
    assert ("val", 2.75) in igui.log
    # programmatic set reflects back into the textbox silently
    igui.log.clear()
    igui.set_custom_value("vfield", 4.0)
    assert igui.panel.widgets["custom_value:vfield"].text == "4.0"
    assert igui.log == [("val", 4.0)]   # hook fired once, not twice


def test_selection_radio(igui):
    igui.panel.widgets["custom_selection:pick"].set_active(2)
    assert igui._custom_selections["pick"][0] == "c"
    igui.set_custom_selection("pick", "a")
    assert igui.panel.widgets["custom_selection:pick"].value_selected == "a"


def test_builtin_check_sync(igui):
    i = igui.panel._BUILTIN_CHECKS.index("hide_labels")
    igui.hide_labels = True
    assert igui.panel.widgets["_builtin_checks"].get_status()[i] is True
    igui.hide_labels = False
    assert igui.panel.widgets["_builtin_checks"].get_status()[i] is False


def test_synthetic_click_picks_ray(igui):
    idx = int(np.where(igui.ray_selection)[0][0])
    _click(igui, *_screen_xy(igui, idx))
    assert igui.scene._pick_artist is not None
    txt = igui.scene._pick_text_artist.get_text()
    assert "Ray" in txt and "position" in txt


def test_click_empty_space_clears_pick(igui):
    igui.scene.fig.canvas.draw()
    bbox = igui.scene.ax.get_window_extent()
    _click(igui, bbox.x0 + 1, bbox.y1 - 1)
    assert igui.scene._pick_artist is None
    assert igui.scene._pick_text_artist.get_text() == ""


def test_right_click_space_pick(igui):
    idx = int(np.where(igui.ray_selection)[0][0])
    _click(igui, *_screen_xy(igui, idx), button=3)
    assert igui.scene._crosshair_pos is not None
    assert "Position" in igui.scene._pick_text_artist.get_text()


def test_drag_does_not_pick(igui):
    igui.reset_picking()
    igui.scene.set_pick_text("")
    idx = int(np.where(igui.ray_selection)[0][0])
    _click(igui, *_screen_xy(igui, idx), drag=30.0)
    assert igui.scene._pick_text_artist.get_text() == ""


def test_keyboard_shortcuts(igui):
    for key, prop in (("c", "high_contrast"), ("v", "minimalistic_view"), ("b", "hide_labels")):
        old = getattr(igui, prop)
        igui.shortcuts.press(key)
        assert getattr(igui, prop) is not old
        igui.shortcuts.press(key)
        assert getattr(igui, prop) is old


def test_maximize_scene_hides_panel(igui):
    igui.shortcuts.press("h")
    assert igui.maximize_scene is True
    assert not any(ax.get_visible() for ax in igui.panel._axes)
    igui.shortcuts.press("h")
    assert igui.maximize_scene is False
    assert all(ax.get_visible() for ax in igui.panel._axes)


def test_zoom_and_move_keys(igui):
    ax = igui.scene.ax
    w0 = float(np.ptp(ax.get_xlim()))
    igui.shortcuts.press("+")
    assert float(np.ptp(ax.get_xlim())) < w0
    igui.shortcuts.press("-")
    x0 = float(np.mean(ax.get_xlim()))
    igui.shortcuts.press("right")
    assert float(np.mean(ax.get_xlim())) > x0
    e0, a0 = ax.elev, ax.azim
    igui.shortcuts.press("shift+up")
    assert ax.elev == e0 + 5
    igui.shortcuts.press("shift+left")
    assert ax.azim == a0 + 5


def test_reset_view_key(igui):
    igui.shortcuts.press("+")
    igui.shortcuts.press("right")
    igui.shortcuts.press("i")
    assert np.allclose(igui.scene.ax.get_xlim(), igui.raytracer.outline[:2])


def test_replot_rays_key(igui):
    sel0 = igui.ray_selection.copy()
    igui.shortcuts.press("n")
    assert igui.ray_selection.shape == sel0.shape


def test_detector_image_key(igui):
    """'d' renders the detector image of the trace, equal to the
    raytracer's own, in a figure of its own."""
    n0 = len(plt.get_fignums())
    with go.no_warnings():
        igui.shortcuts.press("d")
        ref = igui.raytracer.detector_image(projection_method=igui.projection_method)
    assert len(plt.get_fignums()) == n0 + 1
    np.testing.assert_array_equal(igui.last_det_image.data, ref.data)


def test_panel_rebuild_leaves_no_stale_callback(igui):
    """Hooks added to a live scene rebuild the panel. With the garbage
    collector off the old widgets stay alive, but their canvas callbacks are
    gone, so the next draw of the figure runs (the JAX package's panel keeps
    them connected, and such a draw fails on a widget that lost its figure
    whenever the collector has not yet freed it)."""
    gc.disable()
    try:
        igui.add_custom_checkbox("late", False)
        igui.add_custom_button("late_button", lambda: None)
        igui.scene.fig.canvas.draw()
    finally:
        gc.enable()
    assert "custom_button:late_button" in igui.panel.widgets
    assert [w.ax.get_figure(root=True) for w in igui.panel.widgets.values()].count(None) == 0
