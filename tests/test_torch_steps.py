"""The step kinds outside the runs (ideal lens, filter, HURB bending) of the
port against the JAX package on the same inputs, made with numpy from a seed.

``_refract_ideal`` and the pure half of ``_hurb`` are called directly; HURB's
normals are drawn by ``jax.random.normal`` on the split keys that the JAX
``_hurb`` uses and injected into the port's function. A scene with two
lenses, a ``Filter``, a ring aperture and an ``IdealLens`` goes through both
``trace_bundle``s, stored and with a detector sink. Tolerances as in
tests/test_torch_common.py: positions rtol 5e-6 / atol 2e-5 mm, directions
and polarization atol 2e-6 / 2e-5, weights atol 1e-9, INFOS equal up to the
counted flips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import optrace_tpu as ot
from optrace_tpu.tracer import trace_core as jtc
from optrace_tpu.parallel import render as jrender
from optrace_tpu.tracer.detector import init_hit_carry as j_init_hit_carry

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc
from optrace_tpu_torch.parallel import render as trender
from optrace_tpu_torch.tracer.detector import init_hit_carry as t_init_hit_carry

from tests.test_torch_common import (make_bundle, jax_trace, torch_trace, torch_steps,
                                     assert_sections_agree, spec_from_jax_steps,
                                     FLIP_BUDGET_PER_20K, P_RTOL, P_ATOL_THROW, W_RTOL, W_ATOL,
                                     POL_ATOL)
from tests.test_torch_trace_bundle import _FakeRT

N = 20000
S_ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(seed, n=N):
    """Positions on a plane, directions within 20° of +z, transverse
    polarization, a tenth of the rays marked as not hitting."""
    p, s, pols, w, wl = make_bundle("build", n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    hit = rng.uniform(size=n) > 0.1
    p = p.copy()
    p[:, 2] = 0.0
    return p, s, pols, w, wl, hit


@pytest.mark.parametrize("no_pol", [True, False])
@pytest.mark.parametrize("D", [25.0, -40.0])
def test_refract_ideal(D, no_pol):
    p, s, pols, _, _, hit = _state(1)
    sj, pj = jtc._refract_ideal(jtc.TraceStep(None, "ideal", D=D), jnp.asarray(p), jnp.asarray(s),
                                jnp.asarray(pols), jnp.asarray(hit), no_pol)
    st, pt = ttc._refract_ideal(ttc.TraceStep(None, "ideal", D=D), _t(p), _t(s), _t(pols),
                                _t(hit), no_pol)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=S_ATOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POL_ATOL)
    # rays that do not hit keep their direction, the others point at the focus
    assert np.array_equal(st.numpy()[~hit], s[~hit])
    f = 1000.0 / D
    on_axis = np.abs(p[:, 0]) + np.abs(p[:, 1]) < 1e-3
    assert np.all(np.sign(st.numpy()[hit, 2]) == 1.0)
    focus = p[hit, :2] + st.numpy()[hit, :2] / st.numpy()[hit, 2:3] * f
    parallel_focus = s[hit, :2] / s[hit, 2:3] * f        # the focal-plane point of the direction
    np.testing.assert_allclose(focus, parallel_focus, atol=5e-4 * abs(f) / 25.0)
    assert not on_axis.all()


def _aperture_steps(kind):
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80])
    if kind == "ring":
        surf = ot.RingSurface(r=4.0, ri=2.0)
    else:
        surf = ot.SlitSurface(dim=[9, 9], dimi=[3.0, 1.5])
        surf.rotate(25)
    RT.add(ot.RaySource(ot.CircularSurface(r=1), pos=[0, 0, -5]))
    RT.add(ot.Aperture(surf, pos=[0, 0, 0]))
    jsteps = RT._build_steps()[:1]
    assert jsteps[0].hurb and jsteps[0].hurb_kind == kind
    tsteps = torch_steps(jsteps)
    assert tsteps[0].hurb and tsteps[0].hurb_kind == kind
    return jsteps[0], tsteps[0]


@pytest.mark.parametrize("no_pol", [True, False])
@pytest.mark.parametrize("kind", ["ring", "slit"])
def test_hurb_pure_half_with_injected_normals(kind, no_pol):
    jstep, tstep = _aperture_steps(kind)
    p, s, pols, w, wl, cand = _state(2)
    n_amb = np.full(N, 1.0003, dtype=np.float32)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    normals = (np.asarray(jax.random.normal(k1, (N,))), np.asarray(jax.random.normal(k2, (N,))))
    # a factor that bends by degrees, so that the bend is far above rounding
    # and some rays turn back (HURB_NEG_DIR)
    factor = 3.0e3
    sj, wj, pj, nj = jtc._hurb(jstep, key, jnp.asarray(p), jnp.asarray(s), jnp.asarray(w),
                               jnp.asarray(wl), jnp.asarray(n_amb), jnp.asarray(pols),
                               jnp.asarray(cand), no_pol, factor)
    st, wt, pt, nt = ttc._hurb(tstep, tuple(_t(a) for a in normals), _t(p), _t(s), _t(w), _t(wl),
                               _t(n_amb), _t(pols), _t(cand), no_pol, factor)
    sj, wj = np.asarray(sj), np.asarray(wj)
    flipped = (wj > 0) != (wt.numpy() > 0)
    assert flipped.sum() <= FLIP_BUDGET_PER_20K
    assert abs(int(nt) - int(nj)) <= flipped.sum() and int(nj) > 10
    keep = ~flipped
    np.testing.assert_allclose(st.numpy()[keep], sj[keep], atol=2e-5)
    np.testing.assert_allclose(wt.numpy()[keep], wj[keep], atol=W_ATOL)
    np.testing.assert_allclose(pt.numpy()[keep], np.asarray(pj)[keep], atol=2e-4)
    bent = np.any(st.numpy() != s, axis=1)
    assert 0.05 < bent.mean() < 0.9 and not bent[~cand].any()
    np.testing.assert_allclose(np.linalg.norm(st.numpy(), axis=1), 1.0, atol=1e-5)


def test_hurb_normals_come_from_the_generator_in_order():
    """One draw for ``a``, one for ``b``; the next HURB step draws on."""
    g = torch.Generator().manual_seed(5)
    a1, b1 = ttc._hurb_normals(g, 1000, torch.device("cpu"), torch.float32)
    a2, _ = ttc._hurb_normals(g, 1000, torch.device("cpu"), torch.float32)
    g2 = torch.Generator().manual_seed(5)
    ref = [torch.randn(1000, generator=g2) for _ in range(3)]
    assert torch.equal(a1, ref[0]) and torch.equal(b1, ref[1]) and torch.equal(a2, ref[2])
    assert abs(float(a1.mean())) < 0.15 and 0.85 < float(a1.std()) < 1.15


def steps_scene(m, no_pol=False, use_hurb=False, **kw):
    """Two lenses (a run of 4), a Gaussian filter, a ring aperture, an ideal
    lens and a third lens, with a detector behind."""
    RT = m.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=no_pol, use_hurb=use_hurb, **kw)
    RT.add(m.RaySource(m.CircularSurface(r=1.5), divergence="Lambertian", div_angle=8,
                       pos=[0, 0, -5], spectrum=m.presets.light_spectrum.d65))
    n1, n2 = m.presets.refraction_index.BK7, m.presets.refraction_index.F2
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25), n=n1,
                  pos=[0, 0, 0], d=1.0))
    RT.add(m.Lens(m.ConicSurface(r=3, R=30, k=-0.5), m.CircularSurface(r=3), n=n2,
                  pos=[0, 0, 5], d=0.8))
    RT.add(m.Filter(m.CircularSurface(r=2.0), pos=[0, 0, 8],
                    spectrum=m.TransmissionSpectrum("Gaussian", mu=560.0, sig=60.0, val=0.9)))
    RT.add(m.Aperture(m.RingSurface(r=4, ri=1.6), pos=[0, 0, 9]))
    RT.add(m.IdealLens(r=3, D=30.0, pos=[0, 0, 12], n2=m.RefractionIndex("Constant", n=1.1)))
    RT.add(m.Lens(m.SphericalSurface(r=3, R=15), m.SphericalSurface(r=3, R=-15), n=n1,
                  pos=[0, 0, 16], d=1.2, n2=m.RefractionIndex("Constant", n=1.0)))
    RT.add(m.Detector(m.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


@pytest.mark.parametrize("no_pol,kernel", [(True, True), (False, False)])
def test_scene_with_every_step_kind_stored(no_pol, kernel):
    RT = steps_scene(ot, no_pol)
    bundle = make_bundle("build", N, seed=7)
    out_j, jsteps = jax_trace(RT, bundle, no_pol, kernel)
    assert [s.action for s in jsteps] == ["refract"] * 4 + ["filter", "absorb", "ideal",
                                                          "refract", "refract", "absorb"]
    out_t, tsteps = torch_trace(RT, jsteps, bundle, no_pol)
    assert [s.action for s in tsteps] == [s.action for s in jsteps]
    assert tsteps[6].D == 30.0 and tsteps[4].spectrum_fn.mu == 560.0
    assert_sections_agree(out_j, out_t, N, no_pol)
    if not no_pol:
        keep = ~np.any((out_j["w"] > 0) != (out_t["w"].numpy() > 0), axis=1)
        np.testing.assert_allclose(out_t["pol"].numpy()[keep], out_j["pol"][keep], atol=POL_ATOL)
    w = out_t["w"].numpy()
    # the filter takes power from rays inside its disc and none outside;
    # the ring kills rays, the ideal lens changes no weight
    r5 = np.hypot(*out_t["p"].numpy()[:, 5, :2].T)
    alive4 = w[:, 4] > 0
    inside, outside = alive4 & (r5 < 1.999), alive4 & (r5 > 2.001)
    assert inside.sum() > 1000 and outside.sum() > 100
    assert np.all(w[inside, 5] <= 0.9 * w[inside, 4] * (1 + 1e-6))
    assert np.array_equal(w[outside, 5], w[outside, 4])
    assert ((w[:, 5] > 0) & (w[:, 6] == 0)).sum() > 100
    alive = w[:, 7] > 0
    assert np.array_equal(w[alive, 7], w[alive, 6]) and alive.mean() > 0.2
    # n along the ray: ambient behind the filter and the aperture, n2 of
    # the ideal lens behind it
    n = out_t["n"].numpy()
    assert np.allclose(n[:, 5], 1.0) and np.allclose(n[:, 6], 1.0) and np.allclose(n[:, 7], 1.1)


def test_scene_with_every_step_kind_through_a_sink():
    """``store_sections=False`` with a detector sink: the hit positions,
    weights and flags of both sinks agree ray by ray."""
    RT = steps_scene(ot, True)
    bundle = make_bundle("build", N, seed=8)
    extent = (-3.0, 3.0, -3.0, 3.0)
    jsink, _, _, jmask = jrender._detector_sink(RT, 0, None, extent, 32, 32)
    out_j, jsteps = jax_trace(RT, bundle, True, True, store_sections=False,
                              sinks=[(jsink, j_init_hit_carry(N), jmask)])
    det = otp.Detector(otp.RectangularSurface(dim=[8.0, 8.0]), pos=[0.0, 0.0, 40.0])
    tsink, _, _, tmask = trender._detector_sink(_FakeRT([det], RT._section_z_bounds()), 0, None,
                                                extent, 32, 32, "cpu")
    assert tmask == jmask
    out_t, _ = torch_trace(RT, jsteps, bundle, True, store_sections=False,
                           sinks=[(tsink, t_init_hit_carry(N, "cpu"), tmask)])
    cj, ct = out_j["sinks"][0], out_t["sinks"][0]
    hit_j, hit_t = cj[2] & cj[3], (ct[2] & ct[3]).numpy()
    assert (hit_j != hit_t).sum() <= FLIP_BUDGET_PER_20K
    both = hit_j & hit_t
    assert both.mean() > 0.2
    np.testing.assert_allclose(ct[0].numpy()[both], cj[0][both], rtol=P_RTOL, atol=P_ATOL_THROW)
    np.testing.assert_allclose(ct[1].numpy()[both], cj[1][both], rtol=W_RTOL, atol=W_ATOL)
    d_infos = np.abs(out_t["infos"].numpy().astype(int) - out_j["infos"].astype(int)).sum()
    assert d_infos <= 2 * FLIP_BUDGET_PER_20K


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("use_hurb", [False, True])
def test_partitions_agree(use_hurb, fuse):
    """Both packages cut the same runs for the scene, with HURB on and off
    and with the planar steps fused or not: ideal, filter and a bending
    aperture never enter a run."""
    RT = steps_scene(ot, True, use_hurb)
    jsteps = RT._build_steps()
    tsteps = torch_steps(jsteps)
    old_j, old_t = ot.global_options.pallas_fuse_planar, otp.global_options.cuda_fuse_planar
    ot.global_options.pallas_fuse_planar = fuse
    otp.global_options.cuda_fuse_planar = fuse
    try:
        runs_j = jtc._partition_runs(jsteps, [], allow_kernel_kinds=True, use_hurb=use_hurb)
        runs_t = ttc._partition_runs(tsteps, [], use_hurb)
    finally:
        ot.global_options.pallas_fuse_planar = old_j
        otp.global_options.cuda_fuse_planar = old_t
    assert [("run" if k == "scan" else k, i) for k, i in runs_j] == runs_t
    assert runs_t[0] == ("run", [0, 1, 2, 3])
    in_runs = {i for k, idxs in runs_t if k == "run" for i in idxs}
    assert not in_runs & {4, 6} and (5 not in in_runs)
    for st in (tsteps[4], tsteps[6]):
        assert not ttc._run_step(st, use_hurb)


def test_port_builds_the_same_steps_from_its_own_classes():
    """``Raytracer._build_steps`` of the port on the same scene gives the
    description that the JAX steps give."""
    sj = spec_from_jax_steps(steps_scene(ot, True)._build_steps())
    tsteps = steps_scene(otp, True, device="cpu")._build_steps()
    assert [d["action"] for d in sj] == [s.action for s in tsteps]
    assert [d["kind"] for d in sj] == [s.sfns.kind for s in tsteps]
    assert [d["D"] for d in sj] == [s.D for s in tsteps]
    for d, s in zip(sj, tsteps):
        assert tuple(d["pos_host"]) == s.pos_host
        assert (d["spectrum"] is None) == (s.spectrum_fn is None)
    names = steps_scene(otp, True, device="cpu")._surface_names()
    assert names == steps_scene(ot, True)._surface_names()
    assert "surface of Lens L2" in names and "surface of Filter F0" in names
