"""The design and user-function examples of examples_torch/ on the CPU:
``lens_optimization.py`` (torch autograd through the parameterized render,
15 normalised-gradient steps on 4096 rays), ``keratoconus.py`` (a
``FunctionSurface2D`` cornea in torch operations, iterative renders at
20 000 rays, PSF convolution), ``gui_automation.py`` (the ``TraceGUI``
driven by its automation function and its custom button, under Agg) and
``microscope.py`` (which exits without its ZEMAX fixtures, as the JAX
example does).

Held against the JAX package: the spot loss of the lens optimisation and
its gradient with respect to both curvatures at the starting curvatures,
on one injected bundle of 4096 rays, with the tolerances of
tests/test_torch_diff.py (loss rtol 1e-5, gradient rtol 1e-4: f32 on both
sides, XLA may contract a*b+c where eager PyTorch does not); the sag of the
keratoconus cornea of case 7 on a grid, to 1e-6 relative."""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optrace_tpu as ot
from optrace_tpu.ops import binning as jbinning
from optrace_tpu.tracer.diff import spot_loss as jspot_loss
from optrace_tpu.tracer.trace_core import trace_bundle as jtrace_bundle
from optrace_tpu.tracer.detector import detector_hits as jdetector_hits, \
    build_segment_mask as jbuild_segment_mask
from optrace_tpu.tracer.scene_compile import compile_surface as jcompile_surface

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss

from examples_torch.common import check_results
from test_torch_common import (run_example, closing_new_figures, recording_example,
                               assert_kernels_as_the_smoke_expects)

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SAG_RTOL = 1e-6


@pytest.mark.parametrize("name,outputs", [
    ("lens_optimization", ["lens_optimization.png"]),
    ("keratoconus", ["keratoconus_case0.png", "keratoconus_case7.png", "keratoconus_object.png"]),
])
def test_example_writes_its_files_and_meets_its_invariants(tmp_path, name, outputs):
    results, written, calls = run_example(name, tmp_path)
    assert written == outputs
    assert_kernels_as_the_smoke_expects(name, calls)
    check_results(results)
    assert calls["rays"] == results["rays"]
    if name == "lens_optimization":
        # the loss falls at every step of the example's own run
        assert len(results["history"]) == 16 and np.all(np.diff(results["history"]) < 0)
        assert results["rays"] == 18 * 4096 and calls["traces"] == 18
    else:
        assert results["rays"] == 2 * 20000 and results["magnification"] < 0


def _singlet_rays(n=4096, seed=0):
    """Parallel rays over the source disc (r = 1.5 mm) at z = -5, 550 nm."""
    rng = np.random.default_rng(seed)
    r, th = 1.5 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    p = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, -5.0)], -1).astype(np.float32)
    s = np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))
    pols = np.full((n, 3), np.nan, np.float32)
    return p, s, pols, np.full(n, 1.0 / n, np.float32), np.full(n, 550.0, np.float32)


def _jax_singlet_loss(rays):
    """The JAX package's spot loss of the singlet of examples/lens_optimization.py
    as a function of both curvatures, on injected rays."""
    RT = ot.Raytracer(outline=[-6, 6, -6, 6, -10, 60], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550), pos=[0, 0, -5]))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=28.0), ot.SphericalSurface(r=3, R=-28.0),
                   n=ot.RefractionIndex("Constant", n=1.5), pos=[0, 0, 0], d=1.0))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 25]))
    from examples_torch.lens_optimization import EXT
    steps = RT._build_steps()
    dsurf = RT.detectors[0].surface
    sfns = jcompile_surface(dsurf)
    seg = jbuild_segment_mask(RT._section_z_bounds(), float(dsurf.z_min), float(dsurf.z_max))
    outline = tuple(float(v) for v in RT.outline)
    jrays = [jnp.asarray(a) for a in rays]

    def render(params, key):
        steps_p = [st._replace(sfns=st.sfns._replace(params=pp)) for st, pp in zip(steps, params)]
        out = jtrace_bundle(steps_p, RT.n0, outline, *jrays, True, False)
        ph, wsel, ish, _ = jdetector_hits(sfns, float(dsurf.z_min), out["p"], out["w"],
                                          segment_mask=seg)
        return jbinning.bin_xyzw_soft(ph[:, 0], ph[:, 1], jnp.where(ish, wsel, 0.0), out["wl"],
                                      63, 63, EXT)
    loss = jspot_loss(render)
    params0 = [dict(st.sfns.params) for st in steps]

    def loss_of_rhos(rhos):
        params = [dict(p) for p in params0]
        params[0] = dict(params[0], rho=rhos[0])
        params[1] = dict(params[1], rho=rhos[1])
        return loss(params, None, EXT)
    rhos0 = np.array([float(params0[0]["rho"]), float(params0[1]["rho"])], np.float32)
    return loss_of_rhos, rhos0


def test_lens_optimization_loss_and_gradient_equal_jax():
    from examples_torch import lens_optimization as ex
    rays = _singlet_rays()
    jloss, rhos0 = _jax_singlet_loss(rays)
    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(rhos0))

    render, params0 = make_parameterized_render(ex.scene("cpu"), ex.N_RAYS, extent=ex.EXT,
                                                Nx=63, Ny=63)
    trays = [torch.from_numpy(a) for a in rays]
    loss = spot_loss(lambda params, seed: render.trace_rays(params, *trays))
    rhos = torch.stack([params0[0]["rho"], params0[1]["rho"]]).detach()
    assert rhos.numpy().tolist() == rhos0.tolist()
    val_t, g_t = ex.value_and_grad(lambda r: loss(ex.with_rhos(params0, r), ex.SEED, ex.EXT), rhos)
    assert float(val_t) == pytest.approx(float(val_j), rel=LOSS_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=GRAD_RTOL)
    # the detuned biconvex lens: flattening the back surface shrinks the spot
    assert float(g_t[1]) != 0.0 and float(val_t) > 0.05


def _jax_cornea_ant_func(x, y, cornea_front, gauss_param, position):
    """The anterior cornea of examples/keratoconus.py (jnp)."""
    base = cornea_front._sag(x, y)
    h, sx, sy = gauss_param
    x0, y0 = position
    return base - h * jnp.exp(-(x - x0) ** 2 / 2 / sx ** 2 - (y - y0) ** 2 / 2 / sy ** 2)


def test_keratoconus_cornea_sag_equals_jax():
    from examples_torch import keratoconus as ex
    eye_t = otp.presets.geometry.arizona_eye(adaptation=ex.A, pupil=ex.P)
    eye_j = ot.presets.geometry.arizona_eye(adaptation=ex.A, pupil=ex.P)
    num = 7
    front_t = ex.deformed_front(eye_t.lenses[0].front, num)
    cf_j = eye_j.lenses[0].front
    front_j = ot.FunctionSurface2D(
        func=_jax_cornea_ant_func, r=cf_j.r,
        func_args=dict(cornea_front=cf_j, gauss_param=ex.gauss_param[num],
                       position=ex.positions[ex.position]))
    xy = np.linspace(-0.7 * cf_j.r, 0.7 * cf_j.r, 41)
    x, y = [a.ravel() for a in np.meshgrid(xy, xy)]
    vt = np.asarray(front_t.values(x, y), np.float64)
    vj = np.asarray(front_j.values(x, y), np.float64)
    np.testing.assert_allclose(vt, vj, rtol=SAG_RTOL, atol=SAG_RTOL * np.abs(vj).max())
    # the cone: case 7 lies below the healthy cornea (case 0) by up to h0 = 0.02 mm
    healthy = np.asarray(ex.deformed_front(eye_t.lenses[0].front, 0).values(x, y), np.float64)
    assert 0.015 < np.max(healthy - vt) <= 0.02 + 1e-9


def test_gui_automation_example(tmp_path, monkeypatch):
    """The automation runs in ``main``, and the custom button reruns it."""
    import matplotlib
    matplotlib.use("Agg")
    from examples_torch.gui_automation import main
    monkeypatch.chdir(tmp_path)
    with otp.global_options.no_progress_bar(), otp.global_options.no_warnings(), \
            closing_new_figures():
        with recording_example() as calls:
            results = main(device="cpu", rays=20000)
        sim = results["sim"]
        try:
            assert results["rays_traced"] == results["ray_count"] == 20000 and results["rays_current"]
            # every trace of the automation traces the GUI's ray count
            assert calls["traces"] > 1 and calls["rays"] == 20000 * calls["traces"]
            assert results["source_r"] == 5.0           # the last size of the sweep
            assert_kernels_as_the_smoke_expects("gui_automation", calls)
            sim.press_custom_button("Rerun")
            assert sim.raytracer.check_if_rays_are_current()
            assert float(sim.raytracer.ray_sources[0].surface.r) == 5.0
        finally:
            sim.close()
    assert os.listdir(tmp_path) == []


def test_microscope_exits_without_its_fixtures():
    """The fixtures are looked for inside the repository only, which does
    not ship them."""
    from examples_torch import microscope
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert pathlib.Path(microscope.RES).is_relative_to(repo)
    with pytest.raises(SystemExit, match="fixtures"):
        microscope.main(device="cpu", rays=20000)
