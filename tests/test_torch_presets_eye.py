"""The eye and camera presets, the PSF presets, markers and volumes of the
port against the JAX package.

PSF presets are the same f64 numpy kernels, gamma-encoded (f64 in the port,
f32 in the JAX package): equal to 1e-6. The eyes are compared element by
element (surfaces, positions, media at three wavelengths to 1e-12), then
traced on an injected bundle through the steps compiled from the JAX
package's: sections within the tolerances of tests/test_torch_common.py.
Markers and volumes are drawn, never traced: they enter the property
snapshot and leave the trace alone.
"""

import numpy as np
import pytest

import optrace_tpu as ot
from optrace_tpu.presets import geometry as jgeo

import optrace_tpu_torch as otp
from optrace_tpu_torch.presets import geometry as tgeo

from optrace_tpu_torch.ops.cuda_run import conic_run
from optrace_tpu_torch.tracer import trace_core as ttc

from tests.test_torch_common import jax_trace, torch_trace, assert_sections_agree

PSFS = {"circle": dict(d=3.0), "gaussian": dict(sig=0.7), "airy": dict(r=1.5),
        "glare": dict(sig1=0.4, sig2=2.0, a=0.2), "halo": dict(sig1=0.4, sig2=0.3, r=3.0, a=0.4)}


@pytest.mark.parametrize("name", sorted(PSFS))
def test_psf_presets_equal_jax(name):
    pj = getattr(ot.presets.psf, name)(**PSFS[name])
    pt = getattr(otp.presets.psf, name)(**PSFS[name])
    assert type(pt).__name__ == "GrayscaleImage" and pt.shape == pj.shape
    np.testing.assert_allclose(pt.extent, pj.extent, rtol=0, atol=1e-15)
    np.testing.assert_allclose(pt.data, pj.data, rtol=0, atol=1e-6)
    assert pt.data.max() == pytest.approx(1.0, abs=1e-6)
    defaults_t = getattr(otp.presets.psf, name)()
    np.testing.assert_allclose(defaults_t.data, getattr(ot.presets.psf, name)().data, atol=1e-6)


def test_psf_presets_refuse_what_jax_refuses():
    for name, kw in [("circle", dict(d=0)), ("gaussian", dict(sig=-1)), ("airy", dict(r=0)),
                     ("glare", dict(sig1=2.0, sig2=1.0)), ("glare", dict(a=1.5)),
                     ("halo", dict(r=-1.0)), ("halo", dict(a=-0.1))]:
        with pytest.raises(ValueError):
            getattr(ot.presets.psf, name)(**kw)
        with pytest.raises(ValueError):
            getattr(otp.presets.psf, name)(**kw)


def _surface_state(s):
    return (type(s).__name__, tuple(np.round(np.asarray(s.pos, dtype=float), 12)),
            float(s.r), getattr(s, "R", None), getattr(s, "k", None), getattr(s, "ri", None))


EYES = {"arizona": lambda g: g.arizona_eye(), "arizona_A3": lambda g: g.arizona_eye(adaptation=3.0,
                                                                                   pupil=3.0),
        "legrand": lambda g: g.legrand_eye(pupil=4.0, r_det=7.0, pos=[0.5, 0, 2]),
        "camera": lambda g: g.ideal_camera([0, 0, 30], -100, b=12)}


@pytest.mark.parametrize("name", sorted(EYES))
def test_geometry_presets_equal_jax(name):
    gj, gt = EYES[name](jgeo), EYES[name](tgeo)
    assert gt.desc == gj.desc
    for key in ("lenses", "apertures", "detectors", "volumes", "markers", "filters"):
        lj, lt = getattr(gj, key), getattr(gt, key)
        assert [type(e).__name__ for e in lt] == [type(e).__name__ for e in lj], key
        for ej, et in zip(lj, lt):
            np.testing.assert_allclose(et.pos, ej.pos, rtol=0, atol=1e-12)
            assert et.desc == ej.desc
            assert _surface_state(et.front) == _surface_state(ej.front)
            if ej.has_back():
                assert _surface_state(et.back) == _surface_state(ej.back)
            for attr in ("n", "n2"):
                mj, mt = getattr(ej, attr, None), getattr(et, attr, None)
                assert (mj is None) == (mt is None)
                if mj is not None:
                    wl = np.array([450.0, 555.0, 650.0])
                    np.testing.assert_allclose(mt(wl), np.asarray(mj(wl)), rtol=1e-12)
            if key == "volumes":
                assert et.color == ej.color and et.opacity == ej.opacity
            if key == "lenses" and et.is_ideal:
                assert et.D == pytest.approx(ej.D, rel=1e-12)
    with pytest.raises(ValueError):
        tgeo.ideal_camera([0, 0, 0], 10)
    assert tgeo.eye_models == [tgeo.legrand_eye, tgeo.arizona_eye]
    assert tgeo.double_gauss in tgeo.geometries and tgeo.ideal_camera in tgeo.geometries


def _eye_and_bundle(eye, n):
    """The JAX package's raytracer of the eye, and a parallel bundle of
    ``n`` rays at 555 nm (one point at infinity) filling 5.2 mm."""
    RTj = ot.Raytracer(outline=[-12, 12, -12, 12, -12, 30], no_pol=True)
    RTj.add(EYES[eye](jgeo))
    rng = np.random.default_rng(11)
    r, th = 2.6 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    p = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, -10.0)], -1).astype(np.float32)
    s = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    return RTj, (p, s, np.full((n, 3), np.nan, np.float32), np.full(n, 1.0 / n, np.float32),
                 np.full(n, 555.0, np.float32))


@pytest.mark.parametrize("eye", ["arizona", "legrand"])
def test_eye_sections_on_an_injected_bundle(eye):
    """A parallel bundle at 555 nm (one point at infinity) through the eye's
    steps as the JAX package compiles them: the port's sections equal the
    JAX package's; the runs hold 2 refractions each, under MIN_RUN, so the
    whole eye is unrolled."""
    n = 20000
    RTj, bundle = _eye_and_bundle(eye, n)
    out_j, steps_j = jax_trace(RTj, bundle, True, kernel=False)
    out_t, steps_t = torch_trace(RTj, steps_j, bundle, True)
    assert all(k == "step" for k, _ in ttc._partition_runs(steps_t, []))
    assert_sections_agree(out_j, out_t, n)
    # most rays pass the eye; the Le Grand eye's pupil (4 mm, off axis by
    # 0.5 mm) stops part of the 5.2 mm bundle, the Arizona eye's (5.7 mm) none
    passed = out_j["w"][:, -2] > 0
    assert passed.sum() > 0.3 * n and (passed.sum() < n) == (eye == "legrand")


@pytest.mark.parametrize("eye", ["arizona", "legrand"])
def test_eye_short_runs_agree_with_the_unrolled_steps(eye, monkeypatch):
    """The runs of two refractions that the kernel takes on the card
    (``_shortest_run`` gives 1 there), traced here through the plain version
    that the kernel equals bit for bit (``conic_run`` on CPU tensors): two
    runs, whose sections agree with the unrolled steps of the JAX package
    and of the port."""
    n = 20000
    RTj, bundle = _eye_and_bundle(eye, n)
    out_j, steps_j = jax_trace(RTj, bundle, True, kernel=False)
    out_u, _ = torch_trace(RTj, steps_j, bundle, True)
    lengths = []

    def counted_run(p, s, w, n_tab, med_idx, steps, **kw):
        lengths.append(len(steps))
        return conic_run(p, s, w, n_tab, med_idx, steps, **kw)
    monkeypatch.setattr(ttc, "_shortest_run", lambda *state: 1)
    monkeypatch.setattr(ttc, "conic_run", counted_run)
    out_r, _ = torch_trace(RTj, steps_j, bundle, True)
    assert lengths == [2, 2]
    assert_sections_agree(out_j, out_r, n)
    unrolled = {k: out_u[k].numpy() for k in ("p", "w", "n", "infos")}
    assert_sections_agree(unrolled, out_r, n)


def test_markers_and_volumes_are_drawn_not_traced():
    RT = otp.Raytracer(outline=[-12, 12, -12, 12, -12, 30], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -10], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=555.0)))
    RT.add(tgeo.arizona_eye())
    steps_before = [(st.sfns.kind, st.action, st.pos_host) for st in RT._build_steps()]
    pm = otp.PointMarker("focus", [0, 0, 20])
    lm = otp.LineMarker(r=2, pos=[0, 0, 15], desc="line", angle=30)
    box = otp.BoxVolume(dim=[2, 2], length=3, pos=[0, 0, -5])
    sph = otp.SphereVolume(R=1.5, pos=[3, 0, 10], color=(1, 0, 0))
    cyl = otp.CylinderVolume(r=1, length=4, pos=[-3, 0, 0], opacity=0.5)
    RT.add([pm, lm, box, sph, cyl])
    assert RT.markers == [pm, lm] and RT.volumes[-3:] == [box, sph, cyl]
    assert len(RT.volumes) == 4        # the eye ball
    assert [(st.sfns.kind, st.action, st.pos_host) for st in RT._build_steps()] == steps_before
    snap = RT.property_snapshot()
    assert len(snap["Markers"]) == 2 and len(snap["Volumes"]) == 4
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(2000)
    assert RT.check_if_rays_are_current()
    pm.move_to([0, 0, 21])         # a marker is not traced: the rays stay current
    assert RT.check_if_rays_are_current()
    assert RT.property_snapshot()["Markers"] != snap["Markers"]
    assert sph.R == pytest.approx(1.5) and box.extent[5] - box.extent[4] == pytest.approx(3)
    assert RT.remove(sph) and sph not in RT.volumes and RT.remove([pm]) and RT.markers == [lm]
    with pytest.raises(ValueError):
        otp.BoxVolume(dim=[2, 2], length=3, pos=[0, 0, 0], opacity=1.5)
    with pytest.raises(TypeError):
        otp.PointMarker("x", [0, 0, 0], text_factor="big")
    RT.clear()
    assert not RT.markers and not RT.volumes
    # markers and volumes in the JAX package's lists too
    RTj = ot.Raytracer(outline=[-12, 12, -12, 12, -12, 30])
    RTj.add(jgeo.arizona_eye())
    assert sorted(RTj.property_snapshot()) == sorted(RT.property_snapshot())
