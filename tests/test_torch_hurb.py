"""HURB edge diffraction of the port, by the statistical criteria of
tests/test_hurb_quantitative.py and tests/test_polarization_hurb.py.

The port draws its normals from its own ``torch.Generator``, so nothing is
compared ray by ray with the JAX package here (tests/test_torch_steps.py
does that for the pure half of ``_hurb``); what is held is what those tests
hold the JAX package to. The ratio tests run 10⁶ rays instead of 2·10⁶ on a
189-pixel profile instead of 315, with the original tolerances: four seeds
gave 0.946–0.963 for the pinholes, 1.108–1.118 and 1.119–1.154 for the
slit's axes and 1.75–1.84 for the doubled factor (3·10⁵ rays, 105 pixels).
"""

import numpy as np
import pytest
import scipy.special

import optrace_tpu_torch as ot

go = ot.global_options


def _rms_about_zero(x, w):
    w = np.maximum(w, 0)
    return np.sqrt(np.average(x ** 2, weights=w))


def _airy(r, wl_nm, n, radius_mm, z_mm):
    q = 2 * np.pi / (wl_nm * 1e-9) * n * radius_mm / z_mm * r * 1e-3
    q = np.where(q == 0, 1e-12, q)
    return (2 * scipy.special.j1(q) / q) ** 2


def _sinc2(x, wl_nm, n, d_mm, z_mm):
    return np.sinc(d_mm * 1e-3 * n / (wl_nm * 1e-9) * x / z_mm) ** 2


def _pinhole_profile(n, ri, wl, zd, N, N_px, hurb_factor=None, dim_ext_fact=3):
    """Collimated beam through a pinhole, far-field profile at zd; the
    detector window is 6 · dim_ext_fact first-zero radii wide."""
    RT = ot.Raytracer(outline=[-15, 15, -15, 15, -6, zd + 10], use_hurb=True,
                      n0=ot.RefractionIndex("Constant", n=n), device="cpu")
    if hurb_factor is not None:
        RT.HURB_FACTOR = hurb_factor
    RT.add(ot.RaySource(ot.CircularSurface(r=ri), s=[0, 0, 1], pos=[0, 0, -5],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
    RT.add(ot.Aperture(ot.RingSurface(r=ri + 5, ri=ri), pos=[0, 0, 0]))
    dim = 1.22 / (2 * np.pi / (wl * 1e-9) * n * ri / zd / np.pi) * 1e3 * 6 * dim_ext_fact
    RT.add(ot.Detector(ot.RectangularSurface(dim=[dim, dim]), pos=[0, 0, zd]))
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(N)
        img = RT.detector_image()
    imgi = img.get("Irradiance", N_px)
    bins, p1 = imgi.profile(x=0)
    _, p2 = imgi.profile(y=0)
    prof = 0.5 * (p1[0] + p2[0])
    prof = prof / prof.max()
    r = bins[:-1] + (bins[1] - bins[0]) / 2
    return r, prof, _airy(r, wl, n, ri, zd)


def _slit_profiles(n, d1, d2, wl, zd, N, N_px, hurb_factor=None, dim_ext_fact=5):
    """Rectangular beam through a slit; profiles along both axes."""
    dim = 5 / (min(d1, d2) * 1e-3 * n / (wl * 1e-9) / zd) * dim_ext_fact
    RT = ot.Raytracer(outline=[-dim, dim, -dim, dim, -6, zd + 10], use_hurb=True,
                      n0=ot.RefractionIndex("Constant", n=n), device="cpu")
    if hurb_factor is not None:
        RT.HURB_FACTOR = hurb_factor
    RT.add(ot.RaySource(ot.RectangularSurface(dim=[d1, d2]), s=[0, 0, 1], pos=[0, 0, -5],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
    RT.add(ot.Aperture(ot.SlitSurface(dim=[d1 + 2, d2 + 2], dimi=[d1, d2]), pos=[0, 0, 0]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[dim, dim]), pos=[0, 0, zd]))
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(N)
        img = RT.detector_image()
    imgi = img.get("Irradiance", N_px)
    bins, py = imgi.profile(x=0)   # profile ALONG y: spread set by d2
    _, px = imgi.profile(y=0)      # profile along x: spread set by d1
    r = bins[:-1] + (bins[1] - bins[0]) / 2
    return r, px[0] / px[0].max(), py[0] / py[0].max(), _sinc2(r, wl, n, d1, zd), _sinc2(r, wl, n, d2, zd)


class TestHurbQuantitative:

    @pytest.mark.parametrize("n,ri,wl,zd", [(1.0, 0.02, 550.0, 20.0), (1.33, 0.012, 380.0, 30.0)])
    def test_pinhole_airy_ratio(self, n, ri, wl, zd):
        """sigma_sim/sigma_Airy is 0.95 ± 0.05 for circular apertures at
        hurb_factor = 1, in air and in a medium."""
        r, sim, theo = _pinhole_profile(n, ri, wl, zd, N=1_000_000, N_px=189, hurb_factor=1.0)
        ratio = _rms_about_zero(r, sim) / _rms_about_zero(r, theo)
        assert ratio == pytest.approx(0.95, abs=0.05), ratio

    def test_slit_sinc_ratio(self):
        """sigma_sim/sigma_sinc² is about 1.11 for slits, both axes
        independently, at hurb_factor = 1."""
        r, p_x, p_y, t_x, t_y = _slit_profiles(1.0, 0.02, 0.1, 550.0, 20.0, N=1_000_000, N_px=189,
                                               hurb_factor=1.0)
        ratio_x = _rms_about_zero(r, p_x) / _rms_about_zero(r, t_x)
        ratio_y = _rms_about_zero(r, p_y) / _rms_about_zero(r, t_y)
        assert ratio_x == pytest.approx(1.11, abs=0.08), ratio_x
        assert ratio_y == pytest.approx(1.11, abs=0.12), ratio_y

    def test_hurb_factor_scales_width(self):
        """Doubling HURB_FACTOR doubles the diffraction spread (2.0 ± 0.3;
        the window cuts the wider profile's tails)."""
        n, ri, wl, zd = 1.0, 0.03, 550.0, 100.0
        r1, sim1, _ = _pinhole_profile(n, ri, wl, zd, N=300_000, N_px=105, dim_ext_fact=6)
        r2, sim2, _ = _pinhole_profile(n, ri, wl, zd, N=300_000, N_px=105,
                                       hurb_factor=2 * np.sqrt(2.0), dim_ext_fact=6)
        assert _rms_about_zero(r2, sim2) / _rms_about_zero(r1, sim1) == pytest.approx(2.0, abs=0.3)

    def test_no_hurb_no_spread(self):
        """With use_hurb=False the collimated beam stays geometric: all
        power inside the aperture radius."""
        n, ri, wl, zd = 1.0, 0.03, 550.0, 100.0
        RT = ot.Raytracer(outline=[-15, 15, -15, 15, -6, zd + 10], use_hurb=False,
                          n0=ot.RefractionIndex("Constant", n=n), device="cpu")
        RT.add(ot.RaySource(ot.CircularSurface(r=ri), s=[0, 0, 1], pos=[0, 0, -5],
                            spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
        RT.add(ot.Aperture(ot.RingSurface(r=ri + 5, ri=ri), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[2, 2]), pos=[0, 0, zd]))
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(100_000)
            img = RT.detector_image()
        ph_r = np.hypot(*np.meshgrid(np.linspace(img.extent[0], img.extent[1], img.shape[1]),
                                     np.linspace(img.extent[2], img.extent[3], img.shape[0])))
        w = img.data[:, :, 3]
        assert w[ph_r > ri * 1.05].sum() < 1e-9 * w.sum() + 1e-12 and w.sum() > 0.99


class TestHURB:

    def _slit_trace(self, slit_width_mm, wl=550.0, z_det=500.0, N=200000, use_hurb=True):
        """monochromatic plane wave through a slit; far field on the detector"""
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, z_det + 10], use_hurb=use_hurb,
                          no_pol=True, device="cpu")
        RT.add(ot.RaySource(ot.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="None",
                            spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
        RT.add(ot.Aperture(ot.SlitSurface(dim=[9, 9], dimi=[4.0, slit_width_mm]), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, z_det]))
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(N)
            ph, w, _, *_ = RT._hit_detector("t", 0)
        return ph.numpy(), w.numpy(), RT

    def test_slit_spreads_light(self):
        """A narrow slit diffracts: the median |y| sits near the
        central-ray half-width, orders of magnitude beyond the shadow."""
        ph, w, RT = self._slit_trace(0.005)       # 5 µm slit
        y_med = np.median(np.abs(ph[:, 1]))
        a = 0.005 / 2 * 1e-3
        k = 2 * np.pi / 550e-9
        sig_central = np.sqrt(2) / (2 * a * k) * 500.0
        assert sig_central * 0.4 < y_med < sig_central * 3.0
        assert y_med > 100 * 0.0025
        # a ray bent backwards is counted at the aperture and nowhere else
        neg = RT._msgs[RT.INFOS.HURB_NEG_DIR]
        assert neg.shape == (3,) and neg[0] == 0 and neg[2] == 0

    def test_wavelength_scaling(self):
        """diffraction spread scales linearly with wavelength"""
        ph1, _, _ = self._slit_trace(0.01, wl=450.0, N=100000)
        ph2, _, _ = self._slit_trace(0.01, wl=675.0, N=100000)
        s1, s2 = np.median(np.abs(ph1[:, 1])), np.median(np.abs(ph2[:, 1]))
        assert s2 / s1 == pytest.approx(675 / 450, rel=0.1)

    def test_wide_slit_no_spread(self):
        ph, w, _ = self._slit_trace(3.0, N=50000)
        y_std = np.sqrt(np.average(ph[:, 1] ** 2, weights=w))
        assert y_std < 1.2      # ±1.5 mm slit: std about 0.87 mm, mostly geometric

    def test_pinhole_hurb(self):
        """ring aperture bends rays near the inner edge"""
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, 510], use_hurb=True, no_pol=True,
                          device="cpu")
        RT.add(ot.RaySource(ot.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                            spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        RT.add(ot.Aperture(ot.RingSurface(r=4.0, ri=0.005), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, 500]))
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(50000)
            ph, w, _, *_ = RT._hit_detector("t", 0)
        r = np.hypot(ph[:, 0].numpy(), ph[:, 1].numpy())
        assert np.sqrt(np.average(r ** 2, weights=w.numpy())) > 1.0

    def test_hurb_off_no_spread(self):
        ph, w, _ = self._slit_trace(0.01, N=50000, use_hurb=False)
        assert np.abs(ph[w > 0, 1]).max() < 0.01   # pure geometric shadow

    def test_hurb_with_polarization_keeps_it_transverse(self):
        """The bend carries the polarization along: it stays a unit vector
        perpendicular to the new direction."""
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, 110], use_hurb=True, device="cpu")
        RT.add(ot.RaySource(ot.CircularSurface(r=0.05), pos=[0, 0, -5], divergence="None",
                            polarization="x", spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        RT.add(ot.Aperture(ot.RingSurface(r=4.0, ri=0.01), pos=[0, 0, 0]))
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(20000)
        p, pol, w = RT.rays.p_list, RT.rays.pol_list, RT.rays.w_list
        alive = w[:, 1] > 0
        s = p[alive, 2] - p[alive, 1]
        s /= np.linalg.norm(s, axis=1, keepdims=True)
        assert alive.sum() > 100 and np.abs(s[:, :2]).max() > 1e-3
        assert np.abs(np.sum(s * pol[alive, 1], axis=1)).max() < 1e-4
        np.testing.assert_allclose(np.linalg.norm(pol[alive, 1], axis=1), 1.0, atol=1e-4)

    @pytest.mark.parametrize("front,ok", [("circle", False), ("ring", True), ("slit", True)])
    def test_hurb_supported_surfaces(self, front, ok):
        """Under use_hurb an aperture must be a ring or a slit: anything
        else is a geometry error, as in the JAX package."""
        RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], use_hurb=True, device="cpu")
        RT.add(ot.RaySource(ot.CircularSurface(r=1), pos=[0, 0, -5],
                            spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        surf = {"circle": ot.CircularSurface(r=2), "ring": ot.RingSurface(r=3, ri=1),
                "slit": ot.SlitSurface(dim=[4, 4], dimi=[1, 1])}[front]
        RT.add(ot.Aperture(surf, pos=[0, 0, 5]))
        RT.add(ot.Aperture(ot.RingSurface(r=3, ri=1), pos=[0, 0, 10]))
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(1000)
        assert RT.geometry_error is (not ok)
        assert (RT.rays.N == 1000) is ok
