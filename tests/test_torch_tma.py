"""Paraxial matrix analysis (TMA) of the port against the JAX package: the
same f64 numpy code on the same prescriptions, so every cardinal quantity
agrees to 1e-9 (relative, or absolute where a value is 0).
"""

import numpy as np
import pytest

import optrace_tpu as ot
from optrace_tpu.presets import geometry as jgeo

import optrace_tpu_torch as otp
from optrace_tpu_torch.analysis import TMA
from optrace_tpu_torch.presets import geometry as tgeo

SCALARS = ("efl", "efl_n", "bfl", "ffl", "d", "n1", "n2", "optical_center", "wl")
PAIRS = ("principal_points", "nodal_points", "focal_points", "focal_lengths",
         "focal_lengths_n", "powers", "powers_n", "vertex_points")
GROUPS = {"double_gauss": (), "arizona_eye": (), "legrand_eye": (),
          "arizona_eye_accommodated": (), "ideal_camera": ([0, 0, 10], -200)}


def _groups(name):
    if name == "arizona_eye_accommodated":
        return jgeo.arizona_eye(adaptation=2.0), tgeo.arizona_eye(adaptation=2.0)
    return getattr(jgeo, name)(*GROUPS[name]), getattr(tgeo, name)(*GROUPS[name])


def _close(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("wl", [486.1327, 555.0, 656.272])
def test_cardinal_points_equal_jax(name, wl):
    gj, gt = _groups(name)
    tj, tt = gj.tma(wl=wl), gt.tma(wl=wl)
    for key in SCALARS + PAIRS:
        _close(getattr(tt, key), getattr(tj, key))
    _close(tt.abcd, tj.abcd)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_conjugates_and_pupils_equal_jax(name):
    gj, gt = _groups(name)
    tj, tt = gj.tma(), gt.tma()
    z0, z1 = tt.vertex_points
    for z in (z0 - 5e4, z0 - 300.0, z0 - 40.0):
        _close(tt.image_position(z), tj.image_position(z))
        _close(tt.image_magnification(z), tj.image_magnification(z))
    for z in (z1 + 30.0, z1 + 90.0):
        _close(tt.object_position(z), tj.object_position(z))
        _close(tt.object_magnification(z), tj.object_magnification(z))
    for zs in np.linspace(z0 - 2.0, z1 + 2.0, 7):
        _close(tt.pupil_position(zs), tj.pupil_position(zs))
        _close(tt.pupil_magnification(zs), tj.pupil_magnification(zs))
    if z1 > z0:
        with pytest.raises(ValueError, match="inside lens"):
            tt.image_position((z0 + z1) / 2)


def test_lens_tma_and_ambient_media():
    """``Lens.tma`` of each lens of the double Gauss, with and without an
    ambient medium, against the JAX package; the TMA of no lens."""
    gj, gt = _groups("double_gauss")
    n0 = dict(n=1.33, desc="water")
    for Lj, Lt in zip(gj.lenses, gt.lenses):
        for nj, nt in ((None, None), (ot.RefractionIndex("Constant", **n0),
                                      otp.RefractionIndex("Constant", **n0))):
            tj, tt = Lj.tma(wl=589.0, n0=nj), Lt.tma(wl=589.0, n0=nt)
            for key in SCALARS + PAIRS:
                _close(getattr(tt, key), getattr(tj, key))
    empty = TMA([])
    assert np.isnan(empty.efl) and np.isnan(empty.vertex_points[0])


def test_errors_equal_jax():
    """Off-axis lenses and overlapping lenses raise as they do in the JAX package."""
    for pkg in (ot, otp):
        n = pkg.RefractionIndex("Constant", n=1.5)
        L1 = pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                      n=n, pos=[0, 0, 0], d=1.0)
        L2 = pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                      n=n, pos=[0, 1, 5], d=1.0)
        L3 = pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                      n=n, pos=[0, 0, 0.5], d=1.0)
        with pytest.raises(RuntimeError, match="axis"):
            TMA([L1, L2]) if pkg is otp else ot.analysis.TMA([L1, L2])
        with pytest.raises(RuntimeError, match="Negative distance"):
            TMA([L1, L3]) if pkg is otp else ot.analysis.TMA([L1, L3])
    with pytest.raises(ValueError):
        TMA([], wl=100.0)
    tilted = otp.Lens(otp.TiltedSurface(r=3, normal=[0, 0.1, 1]), otp.SphericalSurface(r=3, R=-20),
                      n=otp.RefractionIndex("Constant", n=1.5), pos=[0, 0, 0], d=1.0)
    with pytest.raises(RuntimeError, match="rotational symmetry"):
        TMA([tilted])


def test_traced_focus_matches_tma():
    """The RMS focus of a trace of the Le Grand eye with a point source at
    infinity lies at the TMA's rear focal point: a beam of 1 mm diameter
    focuses 0.022 mm in front of it (spherical aberration, which grows with
    the square of the beam: 0.115 mm at 2.4 mm)."""
    eye = tgeo.legrand_eye(pupil=2.0)
    RT = otp.Raytracer(outline=[-12, 12, -12, 12, -10, 30], device="cpu", no_pol=True)
    RT.add(otp.RaySource(otp.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=555.0)))
    RT.add(eye)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(20000)
        res, _ = RT.focus_search("RMS Spot Size", z_start=20.0)
    assert res.x == pytest.approx(eye.tma(wl=555.0).focal_points[1], abs=0.05)
