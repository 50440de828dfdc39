"""The public path of the port against the JAX package: ``Raytracer`` +
``double_gauss()`` + a point ``RaySource``, ``RT.trace(N)`` and
``make_fused_render``, on the CPU.

The two packages cannot sample stream for stream (threefry keys here, a
``torch.Generator`` there), so the comparison is statistical, as in
tests/test_sampling.py: power on the detector, spot centroid and RMS
radius, INFOS fractions — each within 4 σ of the Monte-Carlo error of the
difference of two independent runs at the same N (σ estimated from the
rays themselves; stratified sampling only makes the true error smaller).
"""

import numpy as np
import pytest
import jax
import torch

import optrace_tpu as ot
from optrace_tpu.parallel.render import make_fused_render as j_make_fused_render
from optrace_tpu.presets.geometry import double_gauss as j_double_gauss

import optrace_tpu_torch as otp
from optrace_tpu_torch.presets.geometry import double_gauss as t_double_gauss
from optrace_tpu_torch.tracer.detector import detector_hits, build_segment_mask
from optrace_tpu_torch.tracer.scene_compile import compile_surface

N = 20000
OUTLINE = [-150, 150, -150, 150, -50001, 180]
SRC = dict(divergence="Isotropic", orientation="Converging", conv_pos=[0, 0, 0],
           div_angle=0.03, pos=[0, 0, -50000])


def _scene(pkg, double_gauss, **kw):
    RT = pkg.Raytracer(outline=OUTLINE, no_pol=True, **kw)
    RT.add(pkg.RaySource(pkg.Point(), spectrum=pkg.LightSpectrum("Constant"), **SRC))
    RT.add(double_gauss())
    return RT


@pytest.fixture(scope="module")
def traced():
    """Both packages' stored traces of the same scene at the same N."""
    RTj = _scene(ot, j_double_gauss)
    RTt = _scene(otp, t_double_gauss, device="cpu")
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RTj.trace(N)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RTt.trace(N)
    return RTj, RTt


def _spot(ph, w):
    """(power, centroid xy, rms radius, their 1-σ Monte-Carlo errors)."""
    P = w.sum()
    c = (ph[:, :2] * w[:, None]).sum(axis=0) / P
    r2 = ((ph[:, :2] - c) ** 2).sum(axis=1)
    rms = np.sqrt((w * r2).sum() / P)
    n_all, n_hit = N, int((w > 0).sum())
    w_all = np.concatenate([w, np.zeros(n_all - w.shape[0])])
    sig_P = np.sqrt(n_all * w_all.var())
    sig_c = rms / np.sqrt(n_hit)
    sig_rms = np.sqrt(r2[w > 0].var() / n_hit) / (2 * rms)
    return P, c, rms, sig_P, sig_c, sig_rms


def test_stored_trace_layout_and_energy(traced):
    RTj, RTt = traced
    rj, rt = RTj.rays, RTt.rays
    assert rt.p_list.shape == rj.p_list.shape == (N, 17, 3)
    assert rt.w_list.shape == (N, 17) and rt.n_list.shape == (N, 17)
    assert rt.p_list.dtype == np.float64 and rt.w_list.dtype == np.float32
    w = rt.w_list
    assert (w[:, 1:] <= w[:, :-1] * (1 + 1e-6)).all()        # weights never grow
    assert w[:, 0].sum() == pytest.approx(1.0, rel=1e-5)     # source power
    assert (w[:, -1] == 0).all()                              # the end absorber takes all
    # every ray that died before the end absorber is counted once in INFOS
    assert RTt._msgs[:, :-1].sum() == (w[:, -2] <= 0).sum()
    assert RTt._msgs.shape == RTj._msgs.shape == (5, 17)
    np.testing.assert_allclose(np.linalg.norm(rt.s0_list, axis=1), 1.0, atol=1e-6)


def test_infos_fractions(traced):
    RTj, RTt = traced
    fj, ft = RTj._msgs / N, RTt._msgs / N
    bound = 4 * np.sqrt(2 * np.maximum(fj, ft) * (1 - np.minimum(fj, ft)) / N) + 1.0 / N
    assert (np.abs(fj - ft) <= bound).all(), (RTj._msgs, RTt._msgs)
    assert ft[0].sum() > 0.02           # the f/1.4 stop does cut the 0.03° cone


def test_spot_on_the_detector(traced):
    """Detector hits from the stored sections of both packages: power,
    centroid and RMS radius agree within 4 σ."""
    RTj, RTt = traced
    with ot.global_options.no_progress_bar():
        phj, wj, _, _, _, bar, _ = RTj._hit_detector("test", 0)
        bar.finish()
    dsurf = RTt.detectors[0].surface
    sfns = compile_surface(dsurf, "cpu", torch.float64)
    mask = build_segment_mask(RTt._section_z_bounds(), float(dsurf.z_min), float(dsurf.z_max))
    ph, w, hit, _ = detector_hits(sfns, float(dsurf.z_min), torch.from_numpy(RTt.rays.p_list),
                                  torch.from_numpy(RTt.rays.w_list.astype(np.float64)), mask)
    sel = (hit & (w > 0)).numpy()
    Pj, cj, rmsj, sPj, scj, srj = _spot(np.asarray(phj), np.asarray(wj, dtype=np.float64))
    Pt, ct, rmst, sPt, sct, srt = _spot(ph.numpy()[sel], w.numpy()[sel])
    assert 0.2 < Pt < 0.4
    assert abs(Pt - Pj) <= 4 * np.hypot(sPj, sPt), (Pt, Pj)
    assert np.abs(ct - cj).max() <= 4 * np.hypot(scj, sct), (ct, cj)
    assert abs(rmst - rmsj) <= 4 * np.hypot(srj, srt), (rmst, rmsj)
    assert rmst < 0.5       # a focused spot, in mm


def test_fused_render_against_jax_and_against_the_stored_trace(traced):
    RTj, RTt = traced
    ext, Nx = [-1.0, 1.0, -1.0, 1.0], 32
    render_j, _ = j_make_fused_render(RTj, N, extent=ext, Nx=Nx, Ny=Nx, projection_method=None)
    img_j = np.asarray(jax.jit(render_j)(jax.random.PRNGKey(7)))
    render_t, ext_t = otp.make_fused_render(RTt, N, extent=ext, Nx=Nx, Ny=Nx, device="cpu")
    img_t = render_t(otp.make_generator(7, "cpu")).numpy()
    assert img_t.shape == img_j.shape == (Nx, Nx, 4) and ext_t == tuple(ext)
    assert np.isfinite(img_t).all() and (img_t >= 0).all()
    Pj, Pt = img_j[..., 3].sum(), img_t[..., 3].sum()
    # per-ray weights are 0 (stopped) or about P/(0.93 N): binomial error
    sig = np.sqrt(2 * 0.07 * 0.93 / N) * Pt
    assert abs(Pt - Pj) <= 4 * sig + 1e-4 * Pt, (Pt, Pj)
    # colour: the ratio of the Y channel to the power is a property of the spectrum
    assert img_t[..., 1].sum() / Pt == pytest.approx(img_j[..., 1].sum() / Pj, rel=0.02)
    # image centroid in pixels
    ys, xs = np.mgrid[0:Nx, 0:Nx]
    for im_a, im_b in ((img_t, img_j),):
        ca = np.array([(xs * im_a[..., 3]).sum(), (ys * im_a[..., 3]).sum()]) / im_a[..., 3].sum()
        cb = np.array([(xs * im_b[..., 3]).sum(), (ys * im_b[..., 3]).sum()]) / im_b[..., 3].sum()
        assert np.abs(ca - cb).max() < 0.1
    # a second batch from another seed differs, the same seed repeats
    again = render_t(otp.make_generator(7, "cpu")).numpy()
    other = render_t(otp.make_generator(8, "cpu")).numpy()
    assert np.array_equal(again, img_t) and not np.array_equal(other, img_t)


def test_geometry_checks_and_messages():
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -5, 40], device="cpu")
    with otp.global_options.no_warnings():
        RT.trace(100)                       # no source
        assert RT.geometry_error
    n = otp.presets.refraction_index.BK7
    RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, 0], divergence="Lambertian",
                         div_angle=5, spectrum=otp.presets.light_spectrum.d65))
    L = otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20), n=n,
                 pos=[0, 0, 10], d=1.5)
    RT.add(L)
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(5000)
    assert not RT.geometry_error and RT.rays.N == 5000 and RT.rays.Nt == 4
    assert RT.check_if_rays_are_current()
    assert RT.rays.pol_list.shape == (5000, 4, 3)          # polarization on by default
    pol, s = RT.rays.pol_list[:, 1], RT.rays.direction_vectors()[:, 1]
    np.testing.assert_allclose(np.abs((pol * s).sum(axis=1)), 0.0, atol=1e-4)   # transverse
    L.move_to([0, 0, 12])
    assert not RT.check_if_rays_are_current()
    RT.remove(L)
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20), n=n,
                    pos=[0, 0, 39.5], d=1.5))       # sticks out of the outline
    with otp.global_options.no_warnings():
        RT.trace(100)
    assert RT.geometry_error
