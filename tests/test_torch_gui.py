"""The port's GUI (``optrace_tpu_torch.gui``) on the CPU, headless under Agg.

- Parity: the scene of tests/test_gui.py is traced once by the JAX package,
  and its sections are injected into the port's ``RayStorage``. Both GUIs
  then show the same rays (``plot_rays`` draws its subset with the same
  ``default_rng(0)``), the same ``Line3DCollection`` segments (rtol 1e-6)
  and colours in every colouring mode, the same pick texts and nearest
  sections, the same property-browser dictionaries and command history, and
  each keyboard shortcut makes the same property and view changes.
- Actions: on the port's own trace, ``detector_image``, ``source_image``,
  ``move_to_focus`` and ``retrace`` equal the port's ``Raytracer`` called
  directly.
- The cases of tests/test_gui.py (TraceGUI, command window, property
  browser, scene depth) run on the port; its interactor cases are in
  tests/test_torch_gui_interactors.py.

Every test closes the figures that it opened, and no test leaves
``global_options`` or matplotlib's settings changed.
"""

import contextlib
import os

import numpy as np
import pytest

import optrace_tpu as ot
from optrace_tpu.gui import TraceGUI as JTraceGUI
import optrace_tpu_torch as otp
from optrace_tpu_torch.gui import TraceGUI

from test_torch_common import gui_scene, closing_new_figures, without_idle_draws

go = otp.global_options


@pytest.fixture(autouse=True)
def _close_new_figures():
    with closing_new_figures():
        yield


@pytest.fixture(scope="module")
def gui():
    g = TraceGUI(gui_scene(otp), ray_count=5000)
    g.scene.SURFACE_RES = 8             # coarse surface meshes keep each draw short
    with go.no_progress_bar(), go.no_warnings(), closing_new_figures():
        g.init_scene()
    without_idle_draws(g)
    yield g
    g.close()


def _quiet(pkg):
    """Progress bars and warnings of ``pkg`` off for the block."""
    stack = contextlib.ExitStack()
    stack.enter_context(pkg.global_options.no_progress_bar())
    stack.enter_context(pkg.global_options.no_warnings())
    return stack


@pytest.fixture(scope="module")
def pair():
    """A JAX GUI with its own trace, and a port GUI with the same sections
    injected into its ``RayStorage``."""
    gj = JTraceGUI(gui_scene(ot), ray_count=5000)
    gt = TraceGUI(gui_scene(otp), ray_count=500)
    with _quiet(ot), _quiet(otp), closing_new_figures():
        gj.init_scene()
        gt.init_scene()
        without_idle_draws(gj)
        without_idle_draws(gt)
        rj, rt = gj.raytracer.rays, gt.raytracer.rays
        rt.init(gt.raytracer.ray_sources, rj.N, rj.Nt, rj.no_pol)
        assert np.array_equal(rt.N_list, rj.N_list)
        rt.fill(rj.p_list, rj.w_list, rj.pol_list, rj.n_list, rj.wl_list, rj.s0_list)
        gt.__dict__["ray_count"] = 5000      # the count of the injected trace, without a retrace
        gj.replot()
        gt.replot()
    yield gj, gt
    gj.close()
    gt.close()


# ----------------------------------------------------------------------
# parity on injected sections

def test_plot_rays_selection_and_segments(pair):
    gj, gt = pair
    assert gt.raytracer.rays.N == 5000 and gt.ray_selection.sum() == gt.rays_visible == 2000
    np.testing.assert_array_equal(gt.ray_selection, gj.ray_selection)
    seg_j = np.asarray(gj.scene._ray_artist._segments3d)
    seg_t = np.asarray(gt.scene._ray_artist._segments3d)
    assert seg_t.shape == seg_j.shape == (2000, gj.raytracer.rays.Nt, 3)
    np.testing.assert_allclose(seg_t, seg_j, rtol=1e-6)


@pytest.mark.parametrize("mode", TraceGUI.coloring_modes)
def test_ray_colours(pair, mode):
    gj, gt = pair
    assert gt.coloring_modes == gj.coloring_modes
    with _quiet(ot), _quiet(otp):
        gj.coloring_mode = mode
        gt.coloring_mode = mode
    try:
        cj = gj.scene._ray_artist.get_colors()
        ct = gt.scene._ray_artist.get_colors()
        assert ct.shape == cj.shape == (2000, 4)
        # the spectral colormap is f32 in both packages, in another order of
        # operations: a few ulp of its XYZ, 1.4e-6 at most here. 1e-5 is a
        # 400th of an 8-bit level
        np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(gt.ray_selection, gj.ray_selection)
    finally:
        gj.coloring_mode = "Plain"
        gt.coloring_mode = "Plain"


@pytest.mark.parametrize("index", [0, 17, 2999, 4999])
def test_pick_texts(pair, index):
    gj, gt = pair
    assert gt.pick_ray(index) == gj.pick_ray(index)
    for section in (0, 3, gj.raytracer.rays.Nt - 1):
        assert gt.pick_ray_section(index, section) == gj.pick_ray_section(index, section)
    assert gt.pick_space([1.0, -2.5, 7.0]) == gj.pick_space([1.0, -2.5, 7.0])
    gt.reset_picking()
    gj.reset_picking()


def test_pick_nearest_ray_section(pair):
    gj, gt = pair
    rng = np.random.default_rng(3)
    for pos in rng.uniform([-3, -3, -10], [3, 3, 60], size=(6, 3)):
        assert gt.scene.pick_nearest_section(pos) == gj.scene.pick_nearest_section(pos)
        assert gt.pick_nearest_ray_section(pos) == gj.pick_nearest_ray_section(pos)
    gt.reset_picking()
    gj.reset_picking()


def _assert_tree_close(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_tree_close(u, v, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, float)) and not isinstance(a, bool):
        np.testing.assert_allclose(np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64),
                                   rtol=1e-6, atol=1e-9, err_msg=path)
    else:
        assert a == b, path


def test_property_browser_dictionaries(pair):
    gj, gt = pair
    pj, pt = gj.open_property_browser(), gt.open_property_browser()
    assert (pt.ray_legend, pt.tma_legend, pt.unit_label) == (pj.ray_legend, pj.tma_legend,
                                                             pj.unit_label)
    assert pt.trace_gui_dict == pj.trace_gui_dict
    _assert_tree_close(pj.ray_dict, pt.ray_dict)
    _assert_tree_close(pj.card_dict, pt.card_dict)
    # the preset catalogs hold objects of each package: the same names
    assert {k: sorted(v) for k, v in pt.preset_dict.items()} == \
        {k: sorted(v) for k, v in pj.preset_dict.items()}
    assert pt.scene_dict.keys() == pj.scene_dict.keys()
    # the public state of the raytracer; the port's holds its device besides
    public = sorted(k for k in pj.raytracer_dict if not k.startswith("_"))
    assert set(public) <= set(pt.raytracer_dict)
    for k in ("outline", "no_pol", "use_hurb"):
        _assert_tree_close(pj.raytracer_dict[k], pt.raytracer_dict[k], k)
    assert pt.raytracer_dict["device"] == "cpu"


def test_command_window_history(pair):
    gj, gt = pair
    cmds = ["RT.detectors[0].move_to([0, 0, 41])", "RT.detectors[0].move_to([0, 0, 41])",
            "x = 1", "RT.detectors[0].move_to([0, 0, 40])"]
    with _quiet(ot), _quiet(otp):
        for g in (gj, gt):
            for c in cmds:
                g.command_window.send_command(c)
    assert gt.command_window.history == gj.command_window.history == \
        ["RT.detectors[0].move_to([0, 0, 41])", "x = 1", "RT.detectors[0].move_to([0, 0, 40])"]
    assert gt.command_window.copy_history() == gj.command_window.copy_history()
    # moving a detector replots and keeps the injected rays
    np.testing.assert_array_equal(gt.ray_selection, gj.ray_selection)
    assert gt.raytracer.detectors[0].pos[2] == gj.raytracer.detectors[0].pos[2] == 40
    gj.command_window.clear_history()
    gt.command_window.clear_history()


def _view(g):
    ax = g.scene.ax
    return dict(props=g.property_browser._gui_props(), xlim=ax.get_xlim(), ylim=ax.get_ylim(),
                zlim=ax.get_zlim(), elev=ax.elev, azim=ax.azim,
                panel=[a.get_visible() for a in g.panel._axes])


@pytest.mark.parametrize("keys", [["c", "c"], ["v", "v"], ["b", "b"], ["h", "h"], ["+", "-"],
                                  ["up", "down", "left", "right"], ["shift+up", "shift+down"],
                                  ["shift+left", "shift+right"], ["+", "right", "i"], ["n"]])
def test_keyboard_shortcuts_change_the_same_properties(pair, keys):
    gj, gt = pair
    with _quiet(ot), _quiet(otp):
        for k in keys:
            before = _view(gt)
            gj.shortcuts.press(k)
            gt.shortcuts.press(k)
            vj, vt = _view(gj), _view(gt)
            assert vt["props"] == vj["props"], k
            for key in ("xlim", "ylim", "zlim", "elev", "azim"):
                np.testing.assert_allclose(vt[key], vj[key], rtol=1e-12, err_msg=k)
            assert vt["panel"] == vj["panel"], k
            if k not in ("n", "i"):
                assert vt != before, k            # the key changed something
    np.testing.assert_array_equal(gt.ray_selection, gj.ray_selection)


# ----------------------------------------------------------------------
# actions on the port's own trace against the raytracer called directly

def test_detector_image_action_equals_the_raytracer(gui):
    RT = gui.raytracer
    with _quiet(otp):
        img = gui.detector_image()
        ref = RT.detector_image(detector_index=0, source_index=None, extent=None,
                                projection_method="Equidistant")
    assert img is gui.last_det_image and img.power() > 0
    np.testing.assert_array_equal(img.data, ref.data)
    np.testing.assert_array_equal(img.extent, ref.extent)


def test_source_image_action_equals_the_raytracer(gui):
    with _quiet(otp):
        img = gui.source_image()
        ref = gui.raytracer.source_image(source_index=0)
    np.testing.assert_array_equal(img.data, ref.data)
    assert img.power() == pytest.approx(1.0, abs=1e-3)


def test_move_to_focus_equals_the_focus_search(gui):
    RT = gui.raytracer
    det = RT.detectors[0]
    z0 = det.pos[2]
    with _quiet(otp):
        res, _ = RT.focus_search("RMS Spot Size", z_start=z0)
        gui.move_to_focus()
    try:
        assert det.pos[2] == res.x != z0
        assert gui.last_focus_result[0].x == res.x
    finally:
        det.move_to([0, 0, z0])


def test_retrace_equals_trace(gui):
    RT = gui.raytracer
    seed = RT._seed_counter
    with _quiet(otp):
        gui.retrace()
        p_gui, w_gui = RT.rays.p_list.copy(), RT.rays.w_list.copy()
        RT._seed_counter = seed
        RT.trace(gui.ray_count)
    assert RT.rays.N == gui.ray_count == 5000
    np.testing.assert_array_equal(RT.rays.p_list, p_gui)
    np.testing.assert_array_equal(RT.rays.w_list, w_gui)
    assert RT.rays._dev["p"].device.type == RT.device.type == "cpu"


# ----------------------------------------------------------------------
# the cases of tests/test_gui.py

class TestTraceGUI:

    def test_scene_initialized(self, gui):
        assert gui.raytracer.rays.N == 5000
        assert gui.scene.fig is not None

    def test_screenshot(self, gui, tmp_path):
        p = str(tmp_path / "scene.png")
        arr = gui.screenshot(p)
        assert arr.ndim == 3 and arr.shape[2] == 3
        assert os.path.getsize(p) > 0

    def test_camera(self, gui):
        gui.set_camera(center=[0, 0, 20], height=30)
        center, height, direction, roll = gui.get_camera()
        np.testing.assert_allclose(center, [0, 0, 20], atol=1e-6)
        assert height == pytest.approx(30)

    def test_coloring_modes(self, gui):
        with go.no_warnings():
            for mode in gui.coloring_modes:
                gui.coloring_mode = mode
        gui.coloring_mode = "Plain"
        with pytest.raises(ValueError):
            gui.coloring_mode = "Bogus"

    def test_pick_ray(self, gui):
        txt = gui.pick_ray(10)
        assert "Ray 10" in txt and "wavelength" in txt
        txt = gui.pick_ray_section(10, 1)
        assert "Section 1" in txt
        gui.reset_picking()
        with pytest.raises(ValueError):
            gui.pick_ray(10 ** 9)

    def test_select_rays(self, gui):
        mask = np.zeros(gui.raytracer.rays.N, dtype=bool)
        mask[:100] = True
        gui.select_rays(mask)
        assert gui.ray_selection.sum() == 100

    def test_control(self, gui):
        result = []
        gui.control(lambda g, a: result.append((g, a)), args=(gui, 42))
        assert result[0][0] is gui and result[0][1] == 42

    def test_detector_actions(self, gui):
        with _quiet(otp):
            img = gui.detector_image()
            assert img.power() > 0
            gui.detector_selection = "DET1"
            gui.projection_method = "Stereographic"
            gui.detector_spectrum()
            gui.detector_selection = "DET0"
            gui.projection_method = "Equidistant"

    def test_source_actions(self, gui):
        with _quiet(otp):
            gui.source_selection = "RS1"
            img = gui.source_image()
            assert img.power() == pytest.approx(0.5, abs=1e-3)
            gui.source_spectrum()
            gui.source_selection = "RS0"

    def test_move_to_focus(self, gui):
        with _quiet(otp):
            z0 = gui.raytracer.detectors[0].pos[2]
            gui.move_to_focus()
            assert gui.raytracer.detectors[0].pos[2] != z0
            gui.raytracer.detectors[0].move_to([0, 0, z0])

    def test_run_command_smart_replot(self, gui):
        with _quiet(otp):
            gui.run_command("RT.ray_sources[0].power = 2.0")
            # power change triggers a retrace through smart_replot
            assert gui.raytracer.check_if_rays_are_current()
            gui.run_command("assert ot is __import__('optrace_tpu_torch')")
            gui.run_command("RT.ray_sources[0].power = 1.0")

    def test_custom_ui(self, gui):
        called = []
        gui.add_custom_checkbox("cb", True, lambda v: called.append(("cb", v)))
        gui.add_custom_button("btn", lambda: called.append(("btn",)))
        gui.add_custom_value("val", 1.5, lambda v: called.append(("val", v)))
        gui.add_custom_selection("sel", ["a", "b"], "a", lambda v: called.append(("sel", v)))
        with go.no_warnings():
            gui.set_custom_checkbox("cb", False)
            gui.press_custom_button("btn")
            gui.set_custom_value("val", 2.0)
            gui.set_custom_selection("sel", "b")
        assert [c[0] for c in called] == ["cb", "btn", "val", "sel"]

    def test_property_observer_replots_rays(self, gui):
        gui.rays_visible = 500
        assert gui.ray_selection.sum() <= 500
        gui.rays_visible = 2000


class TestCommandWindow:

    def test_send_command_and_history(self, gui):
        cw = gui.command_window
        assert cw is gui.command_window        # singleton per GUI
        with go.no_warnings():
            cw.send_command("RT.detectors[0].move_to([0, 0, 41])")
            cw.send_command("RT.detectors[0].move_to([0, 0, 41])")  # duplicate
            cw.send_command("RT.detectors[0].move_to([0, 0, 40])")
        assert cw.history == ["RT.detectors[0].move_to([0, 0, 41])",
                              "RT.detectors[0].move_to([0, 0, 40])"]
        assert gui.raytracer.detectors[0].pos[2] == 40

    def test_copy_and_clear_history(self, gui):
        cw = gui.command_window
        with go.no_warnings():
            cw.send_command("x = 1")
        text = cw.copy_history()
        assert "x = 1" in text and text.endswith("\n")
        cw.clear_history()
        assert cw.history == []

    def test_automatic_replot_off(self, gui):
        cw = gui.command_window
        cw.automatic_replot = False
        with _quiet(otp):
            cw.send_command("RT.ray_sources[0].power = 2.0")
            # no retrace happened: snapshot is stale now
            assert not gui.raytracer.check_if_rays_are_current()
            cw.automatic_replot = True
            cw.send_command("RT.ray_sources[0].power = 1.0")
            assert gui.raytracer.check_if_rays_are_current()


class TestPropertyBrowser:

    def test_update_dict_tabs(self, gui):
        pb = gui.open_property_browser()
        assert pb is gui.property_browser
        for tab in (pb.raytracer_dict, pb.ray_dict, pb.scene_dict,
                    pb.trace_gui_dict, pb.card_dict, pb.preset_dict):
            assert isinstance(tab, dict) and tab

    def test_ray_dict_keys(self, gui):
        pb = gui.open_property_browser()
        for key in ("p", "s", "s_un", "pol", "w", "wv", "snum", "index", "l", "ol"):
            assert key in pb.ray_dict, key
        n_shown = int(gui.ray_selection.sum())
        assert pb.ray_dict["p"].shape[0] == n_shown
        assert pb.ray_dict["l"].shape[0] == n_shown

    def test_cardinal_points_tab(self, gui):
        pb = gui.open_property_browser()
        cd = pb.card_dict
        assert "System" in cd and "Lens 0" in cd
        for name in ("System", "Lens 0"):
            assert len(cd[name]) == 3            # three Fraunhofer lines
            for wl_key, t in cd[name].items():
                assert "nm" in wl_key
                for prop in ("abcd", "efl", "bfl", "ffl", "focal_points",
                             "principal_points", "nodal_points", "powers"):
                    assert prop in t, prop
        efls = [t["efl"] for t in cd["Lens 0"].values()]
        assert all(e > 0 for e in efls)
        assert len(set(efls)) == 3

    def test_gen_dict_repr_limits(self, gui):
        import torch
        pb = gui.property_browser
        nested = {"a": [1, (2.0, None)], "b": np.array([3.0]),
                  "c": np.arange(10), "obj": object(), "t": torch.arange(4.0),
                  "big": torch.zeros(10 ** 5)}
        r = pb._gen_dict_repr(nested)
        assert r["a"] == [1, (2.0, None)]
        assert r["b"] == 3.0                     # single-element unpacked
        assert r["c"].dtype == np.float64
        assert isinstance(r["obj"], str)
        assert r["t"].dtype == np.float64 and r["t"].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert r["big"] is nested["big"]         # a large tensor stays where it is
        deep = cur = {}
        for _ in range(30):
            cur["x"] = {}
            cur = cur["x"]
        assert "Recursion larger" in str(pb._gen_dict_repr(deep))


class TestSceneDepth:

    def test_index_boxes_plotted(self):
        RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 40],
                           n0=otp.RefractionIndex("Constant", n=1.33), device="cpu")
        RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, -5],
                             spectrum=otp.presets.light_spectrum.d65))
        RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                        n=otp.presets.refraction_index.BK7,
                        n2=otp.RefractionIndex("Constant", n=1.1), pos=[0, 0, 5], d=1))
        RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
        g = TraceGUI(RT, ray_count=2000)
        try:
            with _quiet(otp):
                g.init_scene()
            n_lines_before = len(g.scene.ax.lines)
            g.scene.plot_index_boxes()
            assert len(g.scene.ax.lines) > n_lines_before
        finally:
            g.close()

    def test_high_contrast_switch(self, gui):
        gui.high_contrast = True
        gui.replot()
        assert gui.scene._foreground_color == (0.0, 0.0, 0.0)
        assert gui.scene._plain_ray_color == (0.0, 0.0, 0.0)
        gui.high_contrast = False
        gui.replot()
        assert gui.scene._foreground_color == (1.0, 1.0, 1.0)

    def test_crosshair_and_space_pick(self, gui):
        txt = gui.pick_space([1.0, 2.0, 3.0])
        assert "1 mm" in txt and "2 mm" in txt and "3 mm" in txt
        assert len(gui.scene._crosshair_artists) == 3
        gui.reset_picking()
        assert gui.scene._crosshair_artists == []

    def test_pick_nearest_ray_section(self, gui):
        rays = gui.raytracer.rays
        idx = np.where(gui.ray_selection)[0][0]
        pos = rays.p_list[idx, 1]
        txt = gui.pick_nearest_ray_section(pos)
        assert f"Ray {idx}" in txt and "Section" in txt

    def test_smart_replot_contextmanager(self, gui):
        """Geometry mutations inside the with-block trigger a retrace."""
        with _quiet(otp):
            with gui.smart_replot():
                gui.raytracer.ray_sources[0].move_to([0, 0.5, -10])
            assert gui.raytracer.check_if_rays_are_current()
            with gui.smart_replot():
                gui.raytracer.ray_sources[0].move_to([0, 0, -10])
            assert gui.raytracer.check_if_rays_are_current()
