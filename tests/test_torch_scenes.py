"""Scenes with the step kinds beyond conics (even asphere, tilted plane,
fused aperture absorbers): the port's ``trace_bundle`` against the JAX
package's on the same rays, and the port's run partition.

The scenes are those of tests/test_pallas_run.py (asphere, tilted plate,
ring stop between lens groups), built once with each package's public
classes, so ``compile_surface`` of the new surface classes is part of what
is compared. The JAX side runs its Pallas run kernel in interpret mode, or
its unrolled/scan path where the test says so. Tolerances: positions rtol
5e-6 / atol 5e-5 mm (the tolerance tests/test_pallas_run.py uses for these
kinds: the asphere's bracketed solve ends within C_EPS/10 of the root on
either side), weights atol 1e-8, INFOS equal up to the flipped rays.
"""

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc

from tests.test_torch_common import (make_bundle, jax_trace, torch_n0, torch_steps,
                                     FLIP_BUDGET_PER_20K, W_RTOL, POL_ATOL)

P_RTOL_K, P_ATOL_K, W_ATOL_K = 5e-6, 5e-5, 1e-8
P_ATOL_THROW_K = 4e-4      # free flight of 30 to 70 mm behind the last lens


def _base(m, no_pol, **kw):
    RT = m.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=no_pol, **kw)
    RT.add(m.RaySource(m.CircularSurface(r=1.5), divergence="Lambertian", div_angle=8,
                       pos=[0, 0, -5], spectrum=m.presets.light_spectrum.d65))
    return RT


def _tail(m, RT, n=None):
    RT.add(m.Lens(m.SphericalSurface(r=3, R=15), m.SphericalSurface(r=3, R=-15),
                  n=n or m.presets.refraction_index.BK7, pos=[0, 0, 10], d=1.2))
    RT.add(m.Detector(m.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


def build_asphere(m, no_pol=True, **kw):
    RT = _base(m, no_pol, **kw)
    n1, n2 = m.presets.refraction_index.BK7, m.presets.refraction_index.F2
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25), n=n1,
                  pos=[0, 0, 0], d=1.0))
    RT.add(m.Lens(m.AsphericSurface(r=3, R=30, k=-0.5, coeff=[2e-4, -1e-6]),
                  m.CircularSurface(r=3), n=n2, pos=[0, 0, 5], d=0.8))
    return _tail(m, RT)


def build_tilted(m, no_pol=True, **kw):
    RT = _base(m, no_pol, **kw)
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25),
                  n=m.presets.refraction_index.BK7, pos=[0, 0, 0], d=1.0))
    th = np.radians(8.0)
    RT.add(m.Lens(m.TiltedSurface(r=3, normal=[0.0, float(np.sin(th)), float(np.cos(th))]),
                  m.TiltedSurface(r=3, normal=[0.0, 0.0, 1.0]),
                  n=m.presets.refraction_index.F2, pos=[0, 0, 5], d=1.5))
    return _tail(m, RT)


def build_stop(m, no_pol=True, stop="ring", **kw):
    RT = _base(m, no_pol, **kw)
    n1 = m.presets.refraction_index.BK7
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25), n=n1,
                  pos=[0, 0, 0], d=1.0, n2=n1))      # glass gap behind the lens
    surf = {"ring": lambda: m.RingSurface(r=3, ri=1.0),
            "slit": lambda: m.SlitSurface(dim=[5, 5], dimi=[2.0, 0.6]),
            "circle": lambda: m.CircularSurface(r=0.4)}[stop]()
    if stop == "slit":
        surf.rotate(20)
    RT.add(m.Aperture(surf, pos=[0, 0, 5]))
    return _tail(m, RT, n=m.presets.refraction_index.F2)


def build_asphere_tilted(m, no_pol=True, **kw):
    """An asphere AND a tilted plate: the asphere widens the run whatever
    the flag says; the tilted plate must not ride along."""
    RT = _base(m, no_pol, **kw)
    n1, n2 = m.presets.refraction_index.BK7, m.presets.refraction_index.F2
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25), n=n1,
                  pos=[0, 0, 0], d=1.0))
    RT.add(m.Lens(m.AsphericSurface(r=3, R=30, k=-0.5, coeff=[2e-4, -1e-6]),
                  m.SphericalSurface(r=3, R=-40), n=n2, pos=[0, 0, 3], d=0.8))
    th = np.radians(8.0)
    RT.add(m.Lens(m.TiltedSurface(r=3, normal=[0.0, float(np.sin(th)), float(np.cos(th))]),
                  m.TiltedSurface(r=3, normal=[0.0, 0.0, 1.0]),
                  n=n2, pos=[0, 0, 6.5], d=1.2))
    return _tail(m, RT)


def port_trace(RT_t, bundle, no_pol):
    steps = RT_t._build_steps()
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
    with torch.no_grad():
        out = ttc.trace_bundle(steps, RT_t.n0, tuple(float(v) for v in RT_t.outline),
                               p, s, pols, w, wl, no_pol)
    return out, steps


def run_lengths(steps, use_hurb=False):
    return [len(i) for k, i in ttc._partition_runs(steps, [], use_hurb) if k == "run"]


def assert_agree(out_j, out_t, N, no_pol):
    pj, wj = out_j["p"], out_j["w"]
    pt, wt = out_t["p"].numpy(), out_t["w"].numpy()
    assert pj.shape == pt.shape
    flipped = np.any((wj > 0) != (wt > 0), axis=1)
    n_flip = int(flipped.sum())
    assert n_flip <= int(np.ceil(FLIP_BUDGET_PER_20K * N / 20000)), n_flip
    keep = ~flipped
    np.testing.assert_allclose(pt[keep, :-2], pj[keep, :-2], rtol=P_RTOL_K, atol=P_ATOL_K)
    np.testing.assert_allclose(pt[keep, -2:], pj[keep, -2:], rtol=P_RTOL_K, atol=P_ATOL_THROW_K)
    np.testing.assert_allclose(wt[keep], wj[keep], rtol=W_RTOL, atol=W_ATOL_K)
    np.testing.assert_allclose(out_t["n"].numpy(), out_j["n"], rtol=1e-6)
    if not no_pol:
        np.testing.assert_allclose(out_t["pol"].numpy()[keep], out_j["pol"][keep], atol=2 * POL_ATOL)
    d_infos = np.abs(out_t["infos"].numpy().astype(int) - out_j["infos"].astype(int)).sum()
    assert d_infos <= 2 * n_flip, (d_infos, n_flip)


@pytest.fixture()
def fuse_planar():
    """Both packages fuse the planar steps into their runs."""
    ot.global_options.pallas_fuse_planar = True
    otp.global_options.cuda_fuse_planar = True
    yield
    ot.global_options.pallas_fuse_planar = False
    otp.global_options.cuda_fuse_planar = False


@pytest.mark.parametrize("no_pol", [True, False], ids=["nopol", "pol"])
def test_asphere_scene_parity(no_pol):
    """Asphere in one run of 6 with conics and a flat back, against the JAX
    kernel (interpret mode): sections, n, pol and INFOS."""
    N = 5000
    bundle = make_bundle("build", N, seed=21)
    out_j, _ = jax_trace(build_asphere(ot, no_pol), bundle, no_pol, kernel=True)
    RT_t = build_asphere(otp, no_pol, device="cpu")
    out_t, steps = port_trace(RT_t, bundle, no_pol)
    assert [st.sfns.kind for st in steps[:6]] == ["conic", "conic", "asphere", "circle",
                                                  "conic", "conic"]
    assert run_lengths(steps) == [6]
    assert_agree(out_j, out_t, N, no_pol)
    assert int(out_t["infos"][ttc.ABSORB_MISSING].sum()) > 0


def test_asphere_scene_parity_against_unrolled():
    """The same scene against the JAX package's default path (scan for the
    conic runs, unrolled ``geom.hit_newton`` for the asphere)."""
    N = 5000
    bundle = make_bundle("build", N, seed=22)
    out_j, _ = jax_trace(build_asphere(ot), bundle, True, kernel=False)
    out_t, _ = port_trace(build_asphere(otp, device="cpu"), bundle, True)
    assert_agree(out_j, out_t, N, True)


@pytest.mark.parametrize("no_pol", [True, False], ids=["nopol", "pol"])
def test_tilted_scene_parity(fuse_planar, no_pol):
    """Tilted plate between lenses, fused into one run of 6 on both sides."""
    N = 20000
    bundle = make_bundle("build", N, seed=23)
    out_j, _ = jax_trace(build_tilted(ot, no_pol), bundle, no_pol, kernel=True)
    RT_t = build_tilted(otp, no_pol, device="cpu")
    out_t, steps = port_trace(RT_t, bundle, no_pol)
    assert run_lengths(steps) == [6]
    assert_agree(out_j, out_t, N, no_pol)


def test_tilted_scene_against_jax_unrolled():
    """The port with ``cuda_fuse_planar=True`` set explicitly (tilted steps
    inside the run) against the JAX package's UNROLLED tilted steps: the
    JAX partition admits tilted refractions into a widened run whatever its
    flag says, so only its scan/unrolled path is a reference that does not
    depend on that."""
    N = 20000
    bundle = make_bundle("build", N, seed=24)
    out_j, _ = jax_trace(build_tilted(ot), bundle, True, kernel=False)
    otp.global_options.cuda_fuse_planar = True
    try:
        RT_t = build_tilted(otp, device="cpu")
        out_t, steps = port_trace(RT_t, bundle, True)
        assert run_lengths(steps) == [6]
    finally:
        otp.global_options.cuda_fuse_planar = False
    assert_agree(out_j, out_t, N, True)
    # and with the flag off the port unrolls the tilted plate: same sections
    out_u, steps_u = port_trace(build_tilted(otp, device="cpu"), bundle, True)
    assert run_lengths(steps_u) == []      # 2 + 2 refractions around the plate: below MIN_RUN
    assert_agree(out_j, out_u, N, True)


def test_asphere_and_tilted_flag_off_keeps_tilted_unrolled():
    """One predicate decides what a run holds: with an asphere in the scene
    and ``cuda_fuse_planar`` off, the tilted plate stays out of every run
    and is traced as a tilted plane (against the JAX unrolled path)."""
    assert otp.global_options.cuda_fuse_planar is False
    N = 5000
    bundle = make_bundle("build", N, seed=27)
    RT_t = build_asphere_tilted(otp, device="cpu")
    steps = RT_t._build_steps()
    kinds = [st.sfns.kind for st in steps]
    assert kinds[:8] == ["conic", "conic", "asphere", "conic", "tilted", "tilted", "conic", "conic"]
    part = ttc._partition_runs(steps, [])
    assert part[0] == ("run", [0, 1, 2, 3])
    assert all(k == "step" for k, _ in part[1:])
    assert not any(ttc._run_step(st) for st in steps if st.sfns.kind == "tilted")
    out_j, _ = jax_trace(build_asphere_tilted(ot), bundle, True, kernel=False)
    out_t, _ = port_trace(RT_t, bundle, True)
    assert_agree(out_j, out_t, N, True)
    # the plate deflects: the mean y-direction behind it is not the one in front
    p = out_t["p"].numpy()
    alive = out_t["w"].numpy()[:, 6] > 0
    dy = lambda a, b: np.mean((p[alive, b, 1] - p[alive, a, 1]) / (p[alive, b, 2] - p[alive, a, 2]))
    assert abs(dy(6, 7) - dy(4, 5)) > 0.02
    # flag on: one run of 8 through the same predicate
    otp.global_options.cuda_fuse_planar = True
    try:
        assert run_lengths(steps) == [8]
    finally:
        otp.global_options.cuda_fuse_planar = False


def test_steps_from_numpy_carries_the_new_kinds():
    """``spec_from_jax_steps`` → ``steps_from_numpy`` for asphere, tilted
    and slit steps: same kinds, same parameters, same trace."""
    N = 3000
    bundle = make_bundle("build", N, seed=28)
    for build, names in ((build_asphere_tilted, ("coeff", "normal")),
                         (lambda m, **kw: build_stop(m, stop="slit", **kw), ("hwi", "hhi", "angle"))):
        RT_j = build(ot)
        jsteps = RT_j._build_steps()
        tsteps = torch_steps(jsteps)
        RT_t = build(otp, device="cpu")
        own = RT_t._build_steps()
        assert [a.sfns.kind for a in tsteps] == [b.sfns.kind for b in own]
        seen = set()
        for a, b in zip(tsteps, own):
            assert a.hurb_kind == b.hurb_kind and a.action == b.action
            for key, v in b.sfns.params.items():
                np.testing.assert_allclose(a.sfns.params[key].numpy(), v.numpy(), rtol=1e-7)
                seen.add(key)
        assert set(names) <= seen
        p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
        with torch.no_grad():
            o1 = ttc.trace_bundle(tsteps, torch_n0(RT_j), tuple(RT_j.outline), p, s, pols, w, wl, True)
            o2 = ttc.trace_bundle(own, RT_t.n0, tuple(RT_t.outline), p, s, pols, w, wl, True)
        assert torch.equal(o1["w"] > 0, o2["w"] > 0)
        np.testing.assert_allclose(o1["p"].numpy(), o2["p"].numpy(), rtol=1e-6, atol=1e-6)


def test_gradient_through_asphere_scene():
    """A run that holds an asphere and must take the plain version (a
    gradient is wanted) keeps its partition and still traces right: the
    gradient with respect to an offset of every medium and with respect to
    the asphere's coefficients is finite and non-zero."""
    N = 400
    bundle = make_bundle("build", N, seed=29)
    RT_t = build_asphere(otp, device="cpu")
    steps = RT_t._build_steps()
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
    outline = tuple(float(v) for v in RT_t.outline)

    def loss(out):
        return (out["p"][:, -1, 0] ** 2 * out["w"][:, -2]).sum()

    dn = torch.zeros((), requires_grad=True)

    def wrap(f):
        return None if f is None else (lambda wl_: f(wl_) + dn)
    steps_m = [st._replace(n1_fn=wrap(st.n1_fn), n2_fn=wrap(st.n2_fn)) for st in steps]
    assert run_lengths(steps_m) == [6]
    out = ttc.trace_bundle(steps_m, RT_t.n0, outline, p, s, pols, w, wl, True)
    loss(out).backward()
    assert torch.isfinite(dn.grad) and float(dn.grad) != 0.0
    with torch.no_grad():
        ref = ttc.trace_bundle(steps, RT_t.n0, outline, p, s, pols, w, wl, True)
    assert torch.equal(out["w"].detach() > 0, ref["w"] > 0)
    np.testing.assert_allclose(out["p"].detach().numpy(), ref["p"].numpy(), atol=1e-6)

    coeff = steps[2].sfns.params["coeff"].requires_grad_()
    out = ttc.trace_bundle(steps, RT_t.n0, outline, p, s, pols, w, wl, True)
    loss(out).backward()
    assert torch.isfinite(coeff.grad).all() and bool((coeff.grad != 0).all())


PARAMS_BY_SCENE = {
    "asphere_tilted": (build_asphere_tilted, [(2, "coeff"), (2, "rho"), (2, "k"), (2, "pos"),
                                              (4, "normal"), (4, "r"), (0, "z_max_rel")]),
    "ring": (lambda m, **kw: build_stop(m, stop="ring", **kw), [(2, "ri"), (2, "r"), (2, "pos")]),
    "slit": (lambda m, **kw: build_stop(m, stop="slit", **kw),
             [(2, "hw"), (2, "hh"), (2, "hwi"), (2, "hhi"), (2, "angle")]),
}


@pytest.mark.parametrize("scene", sorted(PARAMS_BY_SCENE))
def test_run_needs_plain_sees_every_operand(fuse_planar, scene):
    """``requires_grad`` on any surface parameter of a run, or on any
    tensor operand, sends the run to the plain version, and the constant
    dict carries that parameter as a tensor."""
    build, params = PARAMS_BY_SCENE[scene]
    RT_t = build(otp, device="cpu")
    bundle = make_bundle("build", 64, seed=30)
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
    n_tab = torch.ones((2, 64))
    otp.global_options.cuda_trace = True
    for idx, name in params:
        steps = RT_t._build_steps()
        idxs = [i for k, ii in ttc._partition_runs(steps, []) if k == "run" for i in ii]
        assert idx in idxs
        assert not ttc._run_needs_plain(steps, idxs, p, s, w, pols, n_tab, True)
        steps[idx].sfns.params[name].requires_grad_()
        assert ttc._run_needs_plain(steps, idxs, p, s, w, pols, n_tab, True), name
        chain = ttc._frame_chain(steps, np.float32)
        consts = ttc._run_steps(steps, idxs, chain, np.asarray(RT_t.outline))
        consts = ttc._run_differentiable_steps(steps, idxs, chain, consts)
        c = consts[idxs.index(idx)]
        key = {"z_max_rel": "z_max", "normal": "tn", "pos": "dpos"}.get(name, name)
        leaves = c[key] if isinstance(c[key], tuple) else (c[key],)
        assert all(isinstance(v, torch.Tensor) and v.requires_grad for v in leaves), name
    steps = RT_t._build_steps()
    idxs = [i for k, ii in ttc._partition_runs(steps, []) if k == "run" for i in ii]
    for operand in range(5):
        ops = [p.clone(), s.clone(), w.clone(), pols.clone(), n_tab.clone()]
        ops[operand].requires_grad_()
        needs = ttc._run_needs_plain(steps, idxs, ops[0], ops[1], ops[2], ops[3], ops[4], False)
        assert needs, operand
