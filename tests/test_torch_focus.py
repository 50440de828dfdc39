"""The port's focus search against the JAX package and against analytic
foci.

The cost sweeps are held to the JAX package's on injected ray lines whose
values are multiples of 2⁻¹⁰ at planes that are multiples of 0.5: then
q0 + m·z is exact in f32 whatever the order of operations (XLA may fuse it
into one multiply-add where eager PyTorch rounds twice), both packages bin
every ray into the same pixel, and the costs agree to the order of their
sums (rtol 1e-5). ``focus_search`` is held to the JAX package's on the
same stored rays, and to the analytic focus of an ideal lens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.analysis import focus as jfocus

import optrace_tpu_torch as otp
from optrace_tpu_torch.analysis import focus as tfocus

MODES = ["RMS Spot Size", "Image Sharpness", "Image Center Sharpness", "Irradiance Variance"]


def _lines(n=5000, seed=1):
    """Ray lines converging near z = 20, on a grid of 2⁻¹⁰."""
    rng = np.random.default_rng(seed)
    q0 = np.round(rng.normal(0, 1, (n, 2)) * 1024) / 1024
    m = np.round((rng.normal(0, 0.05, (n, 2)) - q0 / 20.0) * 1024) / 1024
    w = rng.uniform(0.5, 1, n).astype(np.float32)
    return q0, m, w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_px", [101, 201])
def test_cost_sweep_equals_jax(mode, n_px):
    q0, m, w = _lines()
    z = np.arange(10, 30, 0.5)
    ref = np.asarray(jfocus.cost_sweep(jnp.asarray(z), jnp.asarray(q0), jnp.asarray(m),
                                       jnp.asarray(w), mode, n_px))
    tq0, tm, tw = (torch.tensor(a, dtype=torch.float32) for a in (q0, m, w))
    got = tfocus.cost_sweep(np.float32(z), tq0, tm, tw, mode, n_px).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    # a sweep in chunks of planes gives the same costs as one chunk
    old = tfocus.CHUNK_BYTES
    tfocus.CHUNK_BYTES = 8 * q0.shape[0] * 3
    try:
        chunked = tfocus.cost_sweep(np.float32(z), tq0, tm, tw, mode, n_px).numpy()
    finally:
        tfocus.CHUNK_BYTES = old
    assert tfocus.plane_chunk(q0.shape[0]) > 3
    np.testing.assert_allclose(chunked, got, rtol=1e-6)


def test_rms_focus_direct_and_histogram_side_equal_jax():
    q0, m, w = _lines(seed=2)
    q0 = q0 + np.random.default_rng(3).normal(0, 1e-3, q0.shape)
    for bounds in ([10.0, 30.0], [10.0, 15.0], [25.0, 30.0]):
        ref = jfocus.rms_focus_direct(q0, m, w, bounds)
        got = tfocus.rms_focus_direct(torch.tensor(q0), torch.tensor(m), torch.tensor(w), bounds)
        assert got == pytest.approx(ref, rel=1e-12, abs=1e-12)
    # parallel rays: no curvature, the middle of the bracket
    assert tfocus.rms_focus_direct(torch.tensor(q0), torch.zeros_like(torch.tensor(m)),
                                   torch.tensor(w), [2.0, 6.0]) == 4.0
    for n in (10, 1000, 10 ** 5, 10 ** 6, 4 * 10 ** 6):
        assert tfocus.histogram_side(n) == jfocus.histogram_side(n)
    with pytest.raises(ValueError, match="Invalid mode"):
        tfocus.cost_sweep([1.0], *(torch.tensor(a, dtype=torch.float32) for a in (q0, m, w)),
                          "Sharpest", 101)


def _ideal_lens_rt(pkg, source, outline=(-5, 5, -5, 5, -10, 60)):
    kw = dict(device="cpu") if pkg is otp else {}
    RT = pkg.Raytracer(outline=list(outline), **kw)
    RT.add(source(pkg))
    RT.add(pkg.IdealLens(r=3, D=50, pos=[0, 0, 0]))     # f = 20 mm
    return RT


def _parallel(pkg):
    return pkg.RaySource(pkg.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=pkg.LightSpectrum("Monochromatic", wl=550))


def _point_at_40(pkg):
    return pkg.RaySource(pkg.Point(), pos=[0, 0, -40], divergence="Isotropic", div_angle=2.0,
                         spectrum=pkg.LightSpectrum("Monochromatic", wl=550))


@pytest.mark.parametrize("method", ["RMS Spot Size", "Image Center Sharpness",
                                    "Irradiance Variance"])
def test_focus_search_ideal_lens_analytic(method):
    """The scene of tests/test_tracer.py:27-45: parallel light focuses at
    f = 20 mm (RMS: 1e-3 mm, as there; the image costs to 0.05 mm); a point
    at −40 mm images at +40 mm. ("Image Sharpness" has no minimum there:
    the ideal lens collapses the bundle to a point, the histogram's extent
    to 0, and its gradient energy to 0/0 in both packages; the method is
    held to the JAX package on the same rays below.)"""
    RT = _ideal_lens_rt(otp, _parallel)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(20000)
        res, fd = RT.focus_search(method, z_start=10, return_cost=True)
    assert fd["N"] == 20000 and fd["bounds"][1] == pytest.approx(60.0)
    assert abs(res.x - 20.0) < (1e-3 if method == "RMS Spot Size" else 0.05)
    assert fd["z"].shape == (tfocus.SWEEP_SAMPLES,) == fd["cost"].shape
    assert np.isfinite(fd["cost"]).all() and np.nanargmin(fd["cost"]) in range(100, 110)
    assert abs(fd["pos"][0]) < 1e-3 and abs(fd["pos"][1]) < 1e-3 and fd["pos"][2] == res.x
    if method == "RMS Spot Size":
        assert res.fun < 1e-5
    RT = _ideal_lens_rt(otp, _point_at_40, outline=(-5, 5, -5, 5, -45, 60))
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(20000)
        res, _ = RT.focus_search(method, z_start=10)
    assert abs(res.x - 40.0) < (0.05 if method == "RMS Spot Size" else 0.3)


def _spherical_lens_rt(pkg):
    """Parallel light through a biconvex lens (the lens of
    tests/test_tracer.py:test_real_lens_focal_length): its spherical
    aberration spreads the focus, so every cost has a clear minimum."""
    kw = dict(device="cpu") if pkg is otp else {}
    RT = pkg.Raytracer(outline=[-5, 5, -5, 5, -10, 100], **kw)
    RT.add(pkg.RaySource(pkg.CircularSurface(r=1.5), pos=[0, 0, -5], divergence="None",
                         spectrum=pkg.LightSpectrum("Monochromatic", wl=550)))
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                    n=pkg.RefractionIndex("Constant", n=1.5), pos=[0, 0, 0], d=1.0))
    return RT


@pytest.fixture(scope="module")
def same_rays():
    """The JAX package traces; the port's raytracer is handed the same
    stored rays."""
    RTj, RTt = _spherical_lens_rt(ot), _spherical_lens_rt(otp)
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RTj.trace(6000)
    r = RTj.rays
    RTt.rays.init(RTt.ray_sources, r.N, r.Nt, r.no_pol)
    RTt.rays.fill(r.p_list, r.w_list, r.pol_list, r.n_list, r.wl_list, r.s0_list)
    RTt._last_trace_snapshot = RTt.tracing_snapshot()
    return RTj, RTt


@pytest.mark.parametrize("method", MODES)
def test_focus_search_equals_jax_on_the_same_rays(same_rays, method):
    """On the same stored rays the ray lines, the bracket and the focus
    agree (RMS to rounding; the image methods to a tenth of the coarse
    sweep's step)."""
    RTj, RTt = same_rays
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        res_j, fd_j = RTj.focus_search(method, z_start=10)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        res_t, fd_t = RTt.focus_search(method, z_start=10)
    assert fd_t["N"] == fd_j["N"] and fd_t["bounds"] == fd_j["bounds"]
    bounds = fd_j["bounds"]
    q0, m, w = RTt._focus_ray_lines(bounds, None)
    q0_j, m_j, w_j = RTj._focus_ray_lines(bounds, None)
    np.testing.assert_allclose(q0.numpy(), q0_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(m.numpy(), m_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(w.numpy(), w_j)
    if method == "RMS Spot Size":
        assert res_t.x == pytest.approx(res_j.x, rel=1e-12)
        assert res_t.fun == pytest.approx(res_j.fun, rel=1e-5)
    else:
        assert abs(res_t.x - res_j.x) < 0.1 * (bounds[1] - bounds[0]) / tfocus.SWEEP_SAMPLES
    # the centroid at the focus: equal up to the shift of the focus itself
    np.testing.assert_allclose(fd_t["pos"][:2], fd_j["pos"][:2], rtol=0, atol=1e-8)
    assert fd_t["pos"][2] == res_t.x


def test_focus_search_checks_and_source_index():
    RT = _ideal_lens_rt(otp, _parallel)
    RT.add(otp.RaySource(otp.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550)))
    with pytest.raises(RuntimeError, match="No rays traced"):
        RT.focus_search("RMS Spot Size", z_start=10)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(8000)
        with pytest.raises(ValueError, match="outside raytracer"):
            RT.focus_search("RMS Spot Size", z_start=100)
        with pytest.raises(ValueError, match="Invalid method"):
            RT.focus_search("Sharpest", z_start=10)
        with pytest.raises(IndexError):
            RT.focus_search("RMS Spot Size", z_start=10, source_index=-1)
        res, fd = RT.focus_search("RMS Spot Size", z_start=10, source_index=1)
        assert fd["N"] == RT.rays.N_list[1] and abs(res.x - 20.0) < 1e-3
        # a source region before the lens: its bracket starts at the source
        assert RT._focus_bracket(-8.0)[0] == pytest.approx(-5.0 + RT.N_EPS)
        RT.lenses[0].move_to([0, 0, 1])
        with pytest.raises(RuntimeError, match="retrace"):
            RT.focus_search("RMS Spot Size", z_start=10)
