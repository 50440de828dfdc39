"""The example scripts of examples_torch/ that trace a lens scene and read
a detector image, a focus or a transmission from it, run on the CPU at
20 000 rays (``main(device="cpu", rays=20000)``, then ``plot``): each writes
the PNG files of its JAX counterpart in examples/ and meets its invariants
(``examples_torch/common.py:check_results``). The numbers that do not depend
on the random stream are held against the JAX package's own functions on
the same scene: the paraxial (TMA) quantities to rtol 1e-9 (both packages
compute them in f64 on the host), the Brewster angle and Abbe number to
1e-12, the sag of the cosine lens's function surfaces on a grid to 1e-6
relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optrace_tpu as ot

from examples_torch.common import check_results
from test_torch_common import assert_kernels_as_the_smoke_expects
from test_torch_common import ran_examples as ran  # noqa: F401 (a fixture)

TMA_RTOL = 1e-9
SAG_RTOL = 1e-6

OUTPUTS = {
    "achromat": ["achromat.png"],
    "arizona_eye_model": ["arizona_eye_psf.png"],
    "astigmatism": ["astigmatism_cost.png"],
    "brewster_polarizer": [],
    "cosine_surfaces": ["cosine_surfaces.png"],
    "double_gauss": ["double_gauss_psf_0deg.png", "double_gauss_psf_10deg.png",
                     "double_gauss_psf_5deg.png"],
    "hurb_apertures": ["hurb_pinhole.png", "hurb_slit.png"],
    "legrand_eye_model": ["legrand_eye_psf.png"],
    "prism": ["prism.png", "prism_spectrum.png"],
    "sphere_projections": ["sphere_projection_Equal-Area.png", "sphere_projection_Equidistant.png",
                           "sphere_projection_Orthographic.png",
                           "sphere_projection_Stereographic.png"],
    "spherical_aberration": ["spherical_aberration.png"],
}


@pytest.mark.parametrize("name", sorted(OUTPUTS))
def test_example_writes_its_files_and_meets_its_invariants(ran, name):
    results, written, calls = ran(name)
    assert written == OUTPUTS[name]
    assert_kernels_as_the_smoke_expects(name, calls)
    assert 0 < results["rays"] <= 3 * 20000 and calls["rays"] == results["rays"]
    check_results(results)


def _achromat_lenses():
    """The doublet of examples/achromat.py, in the JAX package."""
    bk7, sf10 = ot.presets.refraction_index.BK7, ot.presets.refraction_index.SF10
    L1 = ot.Lens(ot.SphericalSurface(r=3, R=33.55), ot.SphericalSurface(r=3, R=-27.05),
                 n=bk7, n2=sf10, pos=[0, 0, 0], d1=0, d2=2.8)
    L2 = ot.Lens(ot.SphericalSurface(r=3, R=-27.05), ot.SphericalSurface(r=3, R=-96.08),
                 n=sf10, pos=[0, 0, 2.8 + 1e-6], d1=0, d2=1.0)
    return [L1, L2]


def test_achromat_focal_points_equal_jax(ran):
    results, _, _ = ran("achromat")
    from examples_torch.achromat import LINES
    for wl, name in LINES:
        ref = ot.TMA(_achromat_lenses(), wl=wl).focal_points[1]
        assert results["focal_points"][name] == pytest.approx(ref, rel=TMA_RTOL)


def test_double_gauss_efl_equals_jax(ran):
    results, _, _ = ran("double_gauss")
    from optrace_tpu.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-2000, 2000, -22000, 2000, -50001, 180], no_pol=True)
    RT.add(double_gauss())
    assert results["efl"] == pytest.approx(RT.tma().efl, rel=TMA_RTOL)
    assert results["efl"] == pytest.approx(100.0, abs=1.0)      # the design's 100 mm


@pytest.mark.parametrize("name", ["arizona_eye_model", "legrand_eye_model"])
def test_eye_tma_equals_jax(ran, name):
    results, _, _ = ran(name)
    from optrace_tpu.presets.geometry import arizona_eye, legrand_eye
    if name == "arizona_eye_model":
        RT = ot.Raytracer(outline=[-8, 8, -8, 8, -40, 30])
        RT.add(arizona_eye(adaptation=0.0))
    else:
        RT = ot.Raytracer(outline=[-8, 8, -8, 8, -20, 30])
        RT.add(legrand_eye())
    tma = RT.tma()
    assert results["eye_power_dpt"] == pytest.approx(tma.powers_n[1], rel=TMA_RTOL)
    if name == "legrand_eye_model":
        assert results["efl"] == pytest.approx(tma.efl, rel=TMA_RTOL)
        np.testing.assert_allclose(results["focal_points"], tma.focal_points, rtol=TMA_RTOL)


def test_brewster_and_prism_numbers_equal_jax(ran):
    results, _, _ = ran("brewster_polarizer")
    n_d = float(np.asarray(ot.presets.refraction_index.BK7(np.array([587.56])))[0])
    assert results["brewster_deg"] == pytest.approx(np.degrees(np.arctan(n_d)), rel=1e-12)
    T = results["transmission"]
    # p-polarized light passes the Brewster surface without loss, s loses about 15 %
    assert T["p-polarized"] == pytest.approx(1.0, abs=1e-4)
    assert 0.80 < T["s-polarized"] < 0.88
    assert T["unpolarized"] == pytest.approx((T["p-polarized"] + T["s-polarized"]) / 2, abs=0.02)
    results, _, _ = ran("prism")
    assert results["abbe_number"] == pytest.approx(ot.presets.refraction_index.LAK8.abbe_number(),
                                                   rel=1e-12)


def test_cosine_surface_sag_equals_jax():
    """The torch functions of examples_torch/cosine_surfaces.py against the
    jnp functions of examples/cosine_surfaces.py, as surfaces of each
    package, on a grid over the surface."""
    from examples_torch.cosine_surfaces import lens_surfaces
    front, back = lens_surfaces()
    jfront = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * jnp.cos(4 * jnp.pi * x),
                                  z_min=-0.05, z_max=0.05)
    jback = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * jnp.cos(4 * jnp.pi * y),
                                 z_min=-0.05, z_max=0.05)
    xy = np.linspace(-2.1, 2.1, 41)
    x, y = [a.ravel() for a in np.meshgrid(xy, xy)]
    for t, j in ((front, jfront), (back, jback)):
        vt = np.asarray(t.values(x, y), dtype=np.float64)
        vj = np.asarray(j.values(x, y), dtype=np.float64)
        np.testing.assert_allclose(vt, vj, rtol=SAG_RTOL, atol=SAG_RTOL * np.abs(vj).max())
        assert np.ptp(vt) > 0.09           # the ripple's full height, 0.1 mm
    assert isinstance(front.func(torch.zeros(3), torch.zeros(3)), torch.Tensor)
