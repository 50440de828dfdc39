"""The port form of tests/test_hurb_quantitative.py: the sampled trace of
the port, end to end, held to the same closed-form diffraction envelopes with
the same scenes, ray counts and thresholds, on the CPU
(``test_torch_common.cpu_default_device``: ``device=None`` is the CPU).
The JAX file's notes follow.

HURB is an approximation: simulated profiles don't match wave optics
exactly, but their *widths* land at known ratios of the analytic envelopes
when measured with the reference protocol: ``hurb_factor=1`` (the reference
pins its 0.95 / 1.11 ratios at a unity uncertainty factor, not the
default HURB_FACTOR=sqrt(2); see the reference package's tests/test_tracer_hurb.py:62-66,
107-113), a detector window of 18x the first Airy zero (dim_ext_fact=3 in
hurb_geometry.py:135), and RMS width measured about ZERO
(``np.average(r**2, weights=img)**0.5``), not about the profile mean.
"""

import numpy as np
import pytest
import scipy.ndimage
import scipy.special

from test_torch_common import cpu_as_default_device  # noqa: F401 (a fixture)

import optrace_tpu_torch as ot

pytestmark = pytest.mark.usefixtures("cpu_as_default_device")


def _rms_about_zero(x, w):
    """Reference width measure: sqrt(E[r^2]) with profile weights
    (reference test_tracer_hurb.py:64-65)."""
    w = np.maximum(w, 0)
    return np.sqrt(np.average(x ** 2, weights=w))


def _airy(r, wl_nm, n, radius_mm, z_mm):
    q = 2 * np.pi / (wl_nm * 1e-9) * n * radius_mm / z_mm * r * 1e-3
    q = np.where(q == 0, 1e-12, q)
    return (2 * scipy.special.j1(q) / q) ** 2


def _sinc2(x, wl_nm, n, d_mm, z_mm):
    return np.sinc(d_mm * 1e-3 * n / (wl_nm * 1e-9) * x / z_mm) ** 2


def _pinhole_profile(n, ri, wl, zd, N, N_px, use_hurb=True, hurb_factor=None,
                     dim_ext_fact=3):
    """Collimated beam through a pinhole, far-field profile at zd
    (reference hurb_geometry.hurb_pinhole:87-154)."""
    RT = ot.Raytracer(outline=[-15, 15, -15, 15, -6, zd + 10], use_hurb=use_hurb,
                      n0=ot.RefractionIndex("Constant", n=n))
    if hurb_factor is not None:
        RT.HURB_FACTOR = hurb_factor
    RT.add(ot.RaySource(ot.CircularSurface(r=ri), s=[0, 0, 1], pos=[0, 0, -5],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
    RT.add(ot.Aperture(ot.RingSurface(r=ri + 5, ri=ri), pos=[0, 0, 0]))
    # reference window: first-zero radius * 6 * dim_ext_fact (hurb_geometry.py:135)
    dim = 1.22 / (2 * np.pi / (wl * 1e-9) * n * ri / zd / np.pi) * 1e3 * 6 * dim_ext_fact
    RT.add(ot.Detector(ot.RectangularSurface(dim=[dim, dim]), pos=[0, 0, zd]))
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT.trace(N)
        img = RT.detector_image()
    imgi = img.get("Irradiance", N_px)
    bins, p1 = imgi.profile(x=0)
    _, p2 = imgi.profile(y=0)
    prof = 0.5 * (p1[0] + p2[0])
    prof = prof / prof.max()
    r = bins[:-1] + (bins[1] - bins[0]) / 2
    return r, prof, _airy(r, wl, n, ri, zd)


def _slit_profiles(n, d1, d2, wl, zd, N, N_px, use_hurb=True, hurb_factor=None,
                   dim_ext_fact=5):
    """Rect beam through a slit; profiles along both axes
    (reference hurb_geometry.hurb_slit:157-250, angle=0 case)."""
    dim = 5 / (min(d1, d2) * 1e-3 * n / (wl * 1e-9) / zd) * dim_ext_fact
    RT = ot.Raytracer(outline=[-dim, dim, -dim, dim, -6, zd + 10], use_hurb=use_hurb,
                      n0=ot.RefractionIndex("Constant", n=n))
    if hurb_factor is not None:
        RT.HURB_FACTOR = hurb_factor
    RT.add(ot.RaySource(ot.RectangularSurface(dim=[d1, d2]), s=[0, 0, 1], pos=[0, 0, -5],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
    RT.add(ot.Aperture(ot.SlitSurface(dim=[d1 + 2, d2 + 2], dimi=[d1, d2]), pos=[0, 0, 0]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[dim, dim]), pos=[0, 0, zd]))
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT.trace(N)
        img = RT.detector_image()
    imgi = img.get("Irradiance", N_px)
    bins, py = imgi.profile(x=0)   # profile ALONG y -> spread set by d2
    _, px = imgi.profile(y=0)      # profile along x -> spread set by d1
    r = bins[:-1] + (bins[1] - bins[0]) / 2
    p_x = px[0] / px[0].max()
    p_y = py[0] / py[0].max()
    return r, p_x, p_y, _sinc2(r, wl, n, d1, zd), _sinc2(r, wl, n, d2, zd)


def _edge_profile(n, wl, zd, N, N_px, dim_ext_fact=2.5, hurb_factor=1.0):
    """Straight-edge diffraction: beam past one edge of a huge slit
    (reference hurb_geometry.hurb_edge:253-340)."""
    de = 0.5 * 2 * dim_ext_fact
    RT = ot.Raytracer(outline=[-4 * de, 4 * de, -4 * de, 4 * de, -6, zd + 10],
                      use_hurb=True, n0=ot.RefractionIndex("Constant", n=n))
    RT.HURB_FACTOR = hurb_factor
    RT.add(ot.RaySource(ot.RectangularSurface(dim=[de / 2, de / 2]), s=[0, 0, 1],
                        pos=[0, de / 4, -1],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
    # one edge of a huge slit; offset so the edge lies at y=0
    RT.add(ot.Aperture(ot.SlitSurface(dim=[4 * de, 4 * de],
                                      dimi=[4 * de - 0.4, 4 * de - 0.4]),
                       pos=[0, (4 * de - 0.4) / 2, 0]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[de, de]), pos=[0, 0, zd]))
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT.trace(N)
        img = RT.detector_image()
    imgi = img.get("Irradiance", N_px)
    prof = np.mean(np.asarray(imgi.data), axis=1)
    prof = prof / np.mean(prof[4 * (prof.shape[0] // 5):])
    r = np.linspace(imgi.extent[2], imgi.extent[3], prof.shape[0])

    # Fresnel straight-edge curve (farside.ph.utexas.edu eqs 10.99/10.132)
    u = np.sqrt(2 * n / (wl * 1e-9) / (zd * 1e-3)) * r * 1e-3
    S, C = scipy.special.fresnel(u)
    theo = 0.5 * ((S + 0.5) ** 2 + (C + 0.5) ** 2)
    return r, prof, theo


class TestHurbQuantitative:

    def test_pinhole_airy_ratio(self):
        """sigma_sim/sigma_Airy ~ 0.95 +- 0.04 for circular apertures at
        hurb_factor=1 (reference test_tracer_hurb.py:53-66)."""
        for n, ri, wl, zd in [(1.0, 0.02, 550.0, 20.0),
                              (1.33, 0.012, 380.0, 30.0)]:
            r, sim, theo = _pinhole_profile(n, ri, wl, zd, N=2_000_000, N_px=315,
                                            hurb_factor=1.0)
            ratio = _rms_about_zero(r, sim) / _rms_about_zero(r, theo)
            assert ratio == pytest.approx(0.95, abs=0.05), (n, ri, wl, zd, ratio)

    def test_slit_sinc_ratio(self):
        """sigma_sim/sigma_sinc2 ~ 1.11 for slits, both axes independently, at
        hurb_factor=1 (reference test_tracer_hurb.py:96-113)."""
        n, d1, d2, wl, zd = 1.0, 0.02, 0.1, 550.0, 20.0
        r, p_x, p_y, t_x, t_y = _slit_profiles(n, d1, d2, wl, zd,
                                               N=2_000_000, N_px=315,
                                               hurb_factor=1.0)
        ratio_x = _rms_about_zero(r, p_x) / _rms_about_zero(r, t_x)
        ratio_y = _rms_about_zero(r, p_y) / _rms_about_zero(r, t_y)
        assert ratio_x == pytest.approx(1.11, abs=0.08), ratio_x
        assert ratio_y == pytest.approx(1.11, abs=0.12), ratio_y

    def test_edge_fresnel_profile(self):
        """Straight-edge diffraction: simulated flank and plateau match the
        (ring-free) Fresnel edge curve (reference test_tracer_hurb.py:69-94).
        Marked slow in the JAX file; the port's takes about 11 s on the CPU,
        so it runs with the others."""
        for n, wl, zd in [(1.0, 550.0, 20.0), (1.33, 380.0, 30.0)]:
            r, sim, theo = _edge_profile(n, wl, zd, N=3_000_000, N_px=945)
            ind = int(np.argmax(theo > 1.2))
            # plateau: smoothed theory (interference rings removed) vs sim
            theof = scipy.ndimage.gaussian_filter1d(theo, sigma=10)
            top_rmse = np.sqrt(np.mean((theof[ind:-2] - sim[ind:-2]) ** 2))
            assert top_rmse == pytest.approx(0.0, abs=0.02), (n, wl, zd, top_rmse)
            # shadow flank in sqrt space
            flank_rmse = np.sqrt(np.mean((theo[:ind] ** 0.5 - sim[:ind] ** 0.5) ** 2))
            assert flank_rmse == pytest.approx(0.0, abs=0.015), (n, wl, zd, flank_rmse)

    def test_hurb_factor_scales_width(self):
        """Doubling HURB_FACTOR doubles the diffraction spread
        (reference test_tracer_hurb.py:149-165)."""
        n, ri, wl, zd = 1.0, 0.03, 550.0, 100.0
        r1, sim1, _ = _pinhole_profile(n, ri, wl, zd, N=500_000, N_px=189,
                                       dim_ext_fact=6)
        r2, sim2, _ = _pinhole_profile(n, ri, wl, zd, N=500_000, N_px=189,
                                       hurb_factor=2 * np.sqrt(2.0), dim_ext_fact=6)
        s1 = _rms_about_zero(r1, sim1)
        s2 = _rms_about_zero(r2, sim2)
        assert s2 / s1 == pytest.approx(2.0, abs=0.3)

    def test_no_hurb_no_spread(self):
        """With use_hurb=False the collimated beam stays geometric: all
        power inside the aperture radius (reference :132-140)."""
        n, ri, wl, zd = 1.0, 0.03, 550.0, 100.0
        RT = ot.Raytracer(outline=[-15, 15, -15, 15, -6, zd + 10], use_hurb=False,
                          n0=ot.RefractionIndex("Constant", n=n))
        RT.add(ot.RaySource(ot.CircularSurface(r=ri), s=[0, 0, 1], pos=[0, 0, -5],
                            spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
        RT.add(ot.Aperture(ot.RingSurface(r=ri + 5, ri=ri), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[2, 2]), pos=[0, 0, zd]))
        with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
            RT.trace(100_000)
            img = RT.detector_image()
        ph_r = np.hypot(*np.meshgrid(
            np.linspace(img.extent[0], img.extent[1], img.shape[1]),
            np.linspace(img.extent[2], img.extent[3], img.shape[0])))
        w = img.data[:, :, 3]
        assert w[ph_r > ri * 1.05].sum() < 1e-9 * w.sum() + 1e-12
