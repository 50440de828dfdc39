"""The port form of tests/test_polarization_hurb.py: the port's sampled
trace held to the analytic Fresnel, Brewster and transverse-polarization
laws and the HURB envelopes, with the same scenes, ray counts and
thresholds, on the CPU (``test_torch_common.cpu_default_device``:
``device=None`` is the CPU). The JAX file's notes follow.

Polarization transport and HURB edge-diffraction validation.

Models the reference's physics tests (SURVEY.md §4): Brewster-angle
transmission, s/p Fresnel split, and slit/pinhole diffraction envelopes
vs closed-form sinc²/Airy references (reference tests/test_tracer_hurb.py
and tests/hurb_geometry.py strategy).
"""

import numpy as np
import pytest

import optrace_tpu_torch as ot
from test_torch_common import cpu_as_default_device  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cpu_as_default_device")


def tilted_interface_rt(angle_deg, pol, n1=1.0, n2=1.5, N=20000):
    """rays hitting a tilted plane interface at the given incidence angle"""
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -40, 120], no_pol=False)
    RT.n0 = ot.RefractionIndex("Constant", n=n1)
    th = np.radians(angle_deg)
    RT.add(ot.RaySource(ot.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                        polarization=pol, pol_angle=0.0,
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
    # interface tilted around x-axis by the incidence angle
    normal = [0.0, float(np.sin(th)), float(np.cos(th))]
    n_glass = ot.RefractionIndex("Constant", n=n2)
    # r=10: at 70° incidence the plane's z-extent is r·tan(70°) ≈ 27 mm
    RT.add(ot.Lens(ot.TiltedSurface(r=10, normal=normal), ot.CircularSurface(r=40),
                   n=n_glass, n2=n_glass, pos=[0, 0, 10], d1=0.1, d2=45))
    return RT


def fresnel_T(theta_deg, n1, n2, pol):
    """analytic Fresnel power transmission for s or p polarization"""
    ti = np.radians(theta_deg)
    st = n1 / n2 * np.sin(ti)
    tt = np.arcsin(st)
    if pol == "s":
        rs = (n1 * np.cos(ti) - n2 * np.cos(tt)) / (n1 * np.cos(ti) + n2 * np.cos(tt))
        return 1 - rs ** 2
    rp = (n2 * np.cos(ti) - n1 * np.cos(tt)) / (n2 * np.cos(ti) + n1 * np.cos(tt))
    return 1 - rp ** 2


class TestPolarization:

    @pytest.mark.parametrize("angle", [20.0, 40.0, 56.3099, 70.0])
    def test_p_polarized_fresnel(self, angle):
        """pol='y' lies in the plane of incidence (p) for a y-tilted surface"""
        RT = tilted_interface_rt(angle, pol="y")
        with ot.global_options.no_warnings():
            RT.trace(20000)
        T = float(RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum())
        assert T == pytest.approx(fresnel_T(angle, 1.0, 1.5, "p"), abs=2e-3)

    @pytest.mark.parametrize("angle", [20.0, 40.0, 70.0])
    def test_s_polarized_fresnel(self, angle):
        """pol='x' is perpendicular to the plane of incidence (s)"""
        RT = tilted_interface_rt(angle, pol="x")
        with ot.global_options.no_warnings():
            RT.trace(20000)
        T = float(RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum())
        assert T == pytest.approx(fresnel_T(angle, 1.0, 1.5, "s"), abs=2e-3)

    def test_brewster_angle_full_transmission(self):
        """p-polarized light at Brewster's angle transmits completely"""
        brewster = np.degrees(np.arctan(1.5))   # 56.31°
        RT = tilted_interface_rt(brewster, pol="y")
        with ot.global_options.no_warnings():
            RT.trace(20000)
        T = float(RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum())
        assert T == pytest.approx(1.0, abs=1e-4)

    def test_unpolarized_is_sp_average(self):
        angle = 50.0
        RT = tilted_interface_rt(angle, pol="Uniform")
        with ot.global_options.no_warnings():
            RT.trace(50000)
        T = float(RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum())
        T_avg = (fresnel_T(angle, 1, 1.5, "s") + fresnel_T(angle, 1, 1.5, "p")) / 2
        assert T == pytest.approx(T_avg, abs=3e-3)

    def test_no_pol_equals_unpolarized(self):
        angle = 50.0
        RT = tilted_interface_rt(angle, pol="Uniform")
        RT.no_pol = True
        with ot.global_options.no_warnings():
            RT.trace(20000)
        T = float(RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum())
        T_avg = (fresnel_T(angle, 1, 1.5, "s") + fresnel_T(angle, 1, 1.5, "p")) / 2
        assert T == pytest.approx(T_avg, abs=3e-3)

    def test_pol_vectors_stay_transverse(self):
        RT = tilted_interface_rt(40.0, pol="Uniform")
        with ot.global_options.no_warnings():
            RT.trace(5000)
        p, s, pol, w, _, _, _ = RT.rays.rays_by_mask(
            ret=[1, 1, 1, 1, 0, 0, 0], normalize=True)
        # after the tilted surface (section 1) pol ⟂ direction
        dot = np.abs(np.sum(s[:, 1] * pol[:, 1], axis=-1))
        assert np.nanmax(dot[w[:, 1] > 0]) < 1e-3


class TestHURB:

    def _slit_trace(self, slit_width_mm, wl=550.0, z_det=500.0, N=200000):
        """monochromatic plane wave through a slit; far-field on detector"""
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, z_det + 10], use_hurb=True,
                          no_pol=True)
        RT.add(ot.RaySource(ot.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="None",
                            spectrum=ot.LightSpectrum("Monochromatic", wl=wl)))
        RT.add(ot.Aperture(ot.SlitSurface(dim=[9, 9], dimi=[4.0, slit_width_mm]),
                           pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, z_det]))
        with ot.global_options.no_warnings():
            RT.trace(N)
        ph, w, _, *_ = RT._hit_detector("t", 0)
        return ph, w, RT

    def test_slit_spreads_light(self):
        """a narrow slit diffracts: angular spread ≫ geometric shadow.

        HURB's per-ray σ ∝ 1/(edge distance) gives heavy tails, so the
        robust (median) spread is compared against the central-ray value.
        """
        ph, w, RT = self._slit_trace(0.005)       # 5 µm slit
        y = ph[:, 1]
        # geometric shadow would be ±0.0025mm; HURB spreads to mm scale
        y_med = np.median(np.abs(y))
        a = 0.005 / 2 * 1e-3
        k = 2 * np.pi / 550e-9
        sig_central = np.sqrt(2) / (2 * a * k) * 500.0
        # median |y| of the mixture sits near the central-ray half-width
        assert sig_central * 0.4 < y_med < sig_central * 3.0
        # and is orders of magnitude beyond the geometric shadow
        assert y_med > 100 * 0.0025

    def test_wavelength_scaling(self):
        """diffraction spread scales linearly with wavelength"""
        ph1, w1, _ = self._slit_trace(0.01, wl=450.0, N=100000)
        ph2, w2, _ = self._slit_trace(0.01, wl=675.0, N=100000)
        s1 = np.median(np.abs(ph1[:, 1]))
        s2 = np.median(np.abs(ph2[:, 1]))
        assert s2 / s1 == pytest.approx(675 / 450, rel=0.1)

    def test_wide_slit_no_spread(self):
        """a wide slit barely diffracts"""
        ph, w, _ = self._slit_trace(3.0, N=50000)
        y_std = np.sqrt(np.average(ph[:, 1] ** 2, weights=w))
        # mostly geometric: ±1.5mm slit -> std ≈ 1.5/sqrt(3) ≈ 0.87mm
        assert y_std < 1.2

    def test_pinhole_hurb(self):
        """ring aperture bends rays near the inner edge"""
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, 510], use_hurb=True, no_pol=True)
        RT.add(ot.RaySource(ot.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                            spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        RT.add(ot.Aperture(ot.RingSurface(r=4.0, ri=0.005), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, 500]))
        with ot.global_options.no_warnings():
            RT.trace(50000)
        ph, w, _, *_ = RT._hit_detector("t", 0)
        r = np.hypot(ph[:, 0], ph[:, 1])
        r_std = np.sqrt(np.average(r ** 2, weights=w))
        assert r_std > 1.0    # strong spreading through the 10µm pinhole

    def test_hurb_off_no_spread(self):
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, 510], use_hurb=False, no_pol=True)
        RT.add(ot.RaySource(ot.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="None",
                            spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        RT.add(ot.Aperture(ot.SlitSurface(dim=[9, 9], dimi=[4.0, 0.01]), pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, 500]))
        with ot.global_options.no_warnings():
            RT.trace(50000)
        ph, w, _, *_ = RT._hit_detector("t", 0)
        assert np.abs(ph[w > 0, 1]).max() < 0.01   # pure geometric shadow

    def test_hurb_unsupported_surface_errors(self):
        RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], use_hurb=True)
        RT.add(ot.RaySource(ot.CircularSurface(r=1), pos=[0, 0, -5],
                            spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
        RT.add(ot.Aperture(ot.CircularSurface(r=2), pos=[0, 0, 5]))
        RT.add(ot.Aperture(ot.RingSurface(r=3, ri=1), pos=[0, 0, 10]))
        with ot.global_options.no_warnings():
            RT.trace(1000)
        assert RT.geometry_error
