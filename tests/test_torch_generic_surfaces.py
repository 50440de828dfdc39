"""Function and data surfaces of the port against the JAX package's, and
against the analytic sphere (the cases of tests/test_data_surface.py).

Host API (``values``, ``normals``, ``mask``): the JAX package evaluates its
jnp sag in f32 (its default precision), the port in f64, so values agree to
2e-7 mm (f32 rounding of sags up to 0.5 mm) and unit normals to 5e-7; masks
are equal. Trace level (``compile_surface`` in f32, both packages): sag and
normals to 4 f32 ulp of their scale, the hit parameter of the bracketed
solve to rtol 5e-6 / atol 2e-5 mm (the trace tolerance), hit and
ill-conditioned flags equal.
"""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu.tracer.scene_compile import compile_surface as j_compile
from optrace_tpu_torch.tracer.scene_compile import compile_surface as t_compile

from test_torch_common import sphere_sag, data_sphere, P_RTOL, P_ATOL

R_AP = 3.0
R_SPHERE = 50.0
ULP = np.finfo(np.float32).eps
POS = [0.1, -0.2, 1.0]
NAMES = ["f2", "f2_deriv", "f1", "f1_deriv", "f2_mask", "d2", "d1",
         "f2_flip_rot", "f2_mask_flip_rot", "d2_flip_rot"]


def _make(pkg, lib, name):
    """One surface of ``pkg``; the user functions take ``lib`` arrays."""
    base = name.replace("_flip_rot", "")
    with pkg.global_options.no_warnings():
        if base == "f2":
            s = pkg.FunctionSurface2D(r=R_AP, func=lambda x, y: 0.02 * x ** 2 + 0.01 * y ** 2
                                      + 0.01 * lib.cos(2 * x) * y)
        elif base == "f2_deriv":
            s = pkg.FunctionSurface2D(r=R_AP, func=lambda x, y: 0.02 * x ** 2 + 0.01 * y ** 2,
                                      deriv_func=lambda x, y: (0.04 * x, 0.02 * y))
        elif base == "f1":
            s = pkg.FunctionSurface1D(r=R_AP, func=lambda r: r ** 2 / 40 + 1e-3 * r ** 4,
                                      parax_roc=20.0)
        elif base == "f1_deriv":
            s = pkg.FunctionSurface1D(r=R_AP, func=lambda r: r ** 2 / 40,
                                      deriv_func=lambda r: r / 20)
        elif base == "f2_mask":
            s = pkg.FunctionSurface2D(r=R_AP, func=lambda x, y: 0.02 * x ** 2 + 0.01 * y ** 2,
                                      mask_func=lambda x, y: x + 0.5 * y < 1.5)
        elif base == "d2":
            s = data_sphere(pkg, R_AP, R_SPHERE, n=220, astig=2e-3)
        else:
            s = pkg.DataSurface1D(r=R_AP, data=sphere_sag(np.linspace(0, R_AP, 250) ** 2, R_SPHERE))
    if name.endswith("_flip_rot"):
        s.flip()
        s.rotate(30)
    s.move_to(POS)
    return s


@pytest.fixture(scope="module")
def pairs():
    return {n: (_make(ot, jnp, n), _make(otp, torch, n)) for n in NAMES}


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1)
    q = rng.uniform(-R_AP, R_AP, (3000, 2)) + np.array(POS[:2])
    N = 3000
    p = np.column_stack([rng.uniform(-2.9, 2.9, (N, 2)), np.full(N, -4.0)])
    s = np.column_stack([rng.uniform(-0.1, 0.1, (N, 2)), np.ones(N)])
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return q, p.astype(np.float32), s.astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_host_api(pairs, rays, name):
    sj, st = pairs[name]
    q, _, _ = rays
    x, y = q[:, 0], q[:, 1]
    np.testing.assert_allclose(st.values(x, y), sj.values(x, y), rtol=0, atol=2e-7)
    np.testing.assert_allclose(st.normals(x, y), sj.normals(x, y), rtol=0, atol=5e-7)
    assert np.array_equal(st.mask(x, y), sj.mask(x, y))
    assert st.z_min == pytest.approx(sj.z_min, abs=1e-7)
    assert st.z_max == pytest.approx(sj.z_max, abs=1e-7)
    assert st.parax_roc == sj.parax_roc and st.is_flat() == sj.is_flat()


@pytest.mark.parametrize("name", NAMES)
def test_trace_level_f32(pairs, rays, name):
    """The compiled surface of each package in f32: sag, normals, mask and
    the bracketed hit solve. JAX's solve runs op by op here: under jit, XLA
    contracts products into FMAs, which moves the verdict on a few rays
    outside the aperture (the stored-trace tests count such flips)."""
    sj, st = pairs[name]
    _, p, s = rays
    fj, ft = j_compile(sj), t_compile(st, "cpu")
    assert fj.kind == ft.kind == "generic"
    o = p - np.asarray(POS, dtype=np.float32)
    oj, sj_ = jnp.asarray(o), jnp.asarray(s)
    ot_, st_ = torch.from_numpy(o), torch.from_numpy(s)

    t_j, v_j, ill_j = fj.hit_fn(fj.params, oj, sj_)
    t_t, v_t, ill_t = ft.hit_fn(ft.params, ot_, st_)
    assert np.array_equal(np.asarray(v_j), v_t.numpy())
    assert np.array_equal(np.asarray(ill_j), ill_t.numpy())
    # the solve's parameter where the hit lies on the surface's disc: beyond
    # it the sag is the spline's or the function's extrapolation, which may
    # cross a ray more than once, and the mask absorbs the ray anyway
    tj = np.asarray(t_j)
    ok = np.asarray(v_j) & (np.hypot(*(o[:, :2] + tj[:, None] * s[:, :2]).T) <= R_AP)
    np.testing.assert_allclose(t_t.numpy()[ok], tj[ok], rtol=P_RTOL, atol=P_ATOL)

    hit = o[ok] + tj[ok][:, None] * s[ok]
    hx, hy = hit[:, 0], hit[:, 1]
    zj = np.asarray(sj._sag(jnp.asarray(hx), jnp.asarray(hy)))
    zt = st._sag(torch.from_numpy(hx), torch.from_numpy(hy)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=4 * ULP * max(np.abs(zj).max(), 1e-3))
    nj = np.asarray(fj.normal_fn(fj.params, jnp.asarray(hx), jnp.asarray(hy)))
    nt = ft.normal_fn(ft.params, torch.from_numpy(hx), torch.from_numpy(hy)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=4 * ULP)
    mt = ft.mask_fn(ft.params, torch.from_numpy(hx), torch.from_numpy(hy)).numpy()
    if "mask_flip_rot" not in name:
        mj = np.asarray(fj.mask_fn(fj.params, jnp.asarray(hx), jnp.asarray(hy)))
        assert np.array_equal(mt, mj)
    # the trace's mask is the host API's (the JAX package's trace mask leaves out
    # the rotation and the mirror of a flipped surface: ROADMAP.md, faults)
    assert np.array_equal(mt, st.mask(hx + POS[0], hy + POS[1]))


def test_numeric_normals_equal_the_derivative_function():
    """Without ``deriv_func`` the normals come from torch.func.jvp: exact,
    equal to the analytic ones in f64, and differentiable in reverse mode."""
    f = _make(otp, torch, "f2_deriv")
    g = otp.FunctionSurface2D(r=R_AP, func=f.func)
    q = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, (500, 2)))
    n_d = f._normals_rel(q[:, 0], q[:, 1])
    n_n = g._normals_rel(q[:, 0], q[:, 1])
    torch.testing.assert_close(n_n, n_d, rtol=0, atol=1e-14)
    x = q[:, 0].clone().requires_grad_()
    g._normals_rel(x, q[:, 1])[:, 0].sum().backward()
    assert torch.isfinite(x.grad).all() and (x.grad != 0).all()


# ----------------------------------------------------------------------
# the cases of tests/test_data_surface.py, in the port

@pytest.fixture(scope="module")
def sphere_surfaces():
    d2 = data_sphere(otp, R_AP, R_SPHERE, n=300)
    with otp.global_options.no_warnings():
        d1 = otp.DataSurface1D(r=R_AP, data=sphere_sag(np.linspace(0, R_AP, 300) ** 2, R_SPHERE))
    return d2, d1, otp.SphericalSurface(r=R_AP, R=R_SPHERE)


def test_data_sphere_equivalence(sphere_surfaces):
    d2, d1, ana = sphere_surfaces
    rng = np.random.default_rng(5)
    q = rng.uniform(-0.7 * R_AP, 0.7 * R_AP, (5000, 2))
    za, na = ana.values(q[:, 0], q[:, 1]), ana.normals(q[:, 0], q[:, 1])
    N = 4000
    p = np.column_stack([rng.uniform(-2, 2, (N, 2)), np.full(N, -5.0)])
    s = np.column_stack([rng.uniform(-0.05, 0.05, (N, 2)), np.ones(N)])
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    pa, ha, _ = ana.find_hit(p, s)
    for surf in (d2, d1):
        assert np.abs(surf.values(q[:, 0], q[:, 1]) - za).max() < 1e-6
        assert np.abs(surf.normals(q[:, 0], q[:, 1]) - na).max() < 5e-6
        ph, h, _ = surf.find_hit(p, s)
        assert (h == ha).all()
        assert np.abs(ph - pa).max() < 1e-5
        # the trace's f32 solve: the sag residual at its hit stays at the f32 floor
        f = t_compile(surf, "cpu")
        o, sd = torch.tensor(p, dtype=torch.float32), torch.tensor(s, dtype=torch.float32)
        t, v, _ = f.hit_fn(f.params, o, sd)
        ph32 = (o + t[:, None] * sd).double()
        sag = surf._sag(ph32[:, 0], ph32[:, 1])
        assert (ph32[:, 2] - sag)[v].abs().max() < 2e-6


def test_data_flip_and_rotate():
    rng = np.random.default_rng(6)
    d = data_sphere(otp, R_AP, R_SPHERE, n=300)
    d.flip()
    q = rng.uniform(-0.7 * R_AP, 0.7 * R_AP, (2000, 2))
    ana = otp.SphericalSurface(r=R_AP, R=R_SPHERE)
    assert np.allclose(d.values(q[:, 0], q[:, 1]), -ana.values(q[:, 0], q[:, 1]), atol=1e-6)
    xy = np.linspace(-R_AP, R_AP, 220)
    X, Y = np.meshgrid(xy, xy)
    with otp.global_options.no_warnings():
        d = otp.DataSurface2D(r=R_AP, data=(0.01 * X ** 2 + 0.03 * Y ** 2).T)
    q = rng.uniform(-2, 2, (1000, 2))
    z0 = d.values(q[:, 0], q[:, 1])
    d.rotate(90)
    assert np.allclose(d.values(q[:, 0], q[:, 1]), 0.03 * q[:, 0] ** 2 + 0.01 * q[:, 1] ** 2, atol=1e-5)
    d.rotate(270)
    assert np.allclose(d.values(q[:, 0], q[:, 1]), z0, atol=1e-7)


def test_lens_maker_focus(sphere_surfaces):
    """A plano-convex lens with a data-sphere front focuses at the
    lens-maker focal length of the analytic lens (1 %: spherical
    aberration shifts the Monte-Carlo focus)."""
    d2, _, _ = sphere_surfaces
    n = otp.RefractionIndex("Constant", n=1.5)
    RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 200], device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=2.0), spectrum=otp.LightSpectrum("Monochromatic", wl=550.),
                         pos=[0, 0, -5], s=[0, 0, 1]))
    RT.add(otp.Lens(d2, otp.CircularSurface(r=R_AP), n=n, de=1.0, pos=[0, 0, 0]))
    with otp.global_options.no_progress_bar():
        RT.trace(20000)
    tma = otp.TMA([otp.Lens(otp.SphericalSurface(r=R_AP, R=R_SPHERE), otp.CircularSurface(r=R_AP),
                            n=n, de=1.0, pos=[0, 0, 0])])
    res, _ = RT.focus_search("RMS Spot Size", z_start=float(tma.efl))
    assert abs(res.x - tma.focal_points[1]) < 0.01 * tma.efl


# ----------------------------------------------------------------------
# refusals, bounds and the paraxial analysis

def test_detector_refuses_function_and_data_surfaces(pairs):
    for name in ("f2", "f1", "d2", "d1"):
        sj, st = pairs[name]
        with pytest.raises(RuntimeError, match="not supported as Detector"):
            ot.Detector(sj, pos=[0, 0, 0])
        with pytest.raises(RuntimeError, match="not supported as Detector"):
            otp.Detector(st, pos=[0, 0, 0])
    assert otp.Detector(otp.RectangularSurface(dim=[2, 2]), pos=[0, 0, 1]).pos[2] == 1.0


@pytest.mark.parametrize("bounds,warns", [((None, None), False), ((0.0, 0.225), False),
                                          ((-0.05, 0.3), True), ((0.0, None), True)])
def test_z_bounds_probe_and_warn(bounds, warns):
    """Bounds are probed; given ones are kept, with a warning where they
    deviate from the probe; one bound alone falls back to the probe."""
    out = []
    for pkg in (ot, otp):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            s = pkg.FunctionSurface1D(r=R_AP, func=lambda r: r ** 2 / 40, z_min=bounds[0],
                                      z_max=bounds[1])
        assert any(issubclass(w.category, pkg.OptraceWarning) for w in rec) == warns
        out.append((s.z_min, s.z_max))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-7)
    if bounds[1] is not None:
        assert out[1] == bounds


def test_tma_with_and_without_parax_roc(pairs):
    n = {ot: ot.presets.refraction_index.BK7, otp: otp.presets.refraction_index.BK7}
    res = []
    for i, pkg in enumerate((ot, otp)):
        f1 = pairs["f1"][i]
        L = pkg.Lens(_make(pkg, jnp if pkg is ot else torch, "f1"),
                     pkg.SphericalSurface(r=R_AP, R=-30), n=n[pkg], pos=[0, 0, 0], d=1.0)
        res.append((L.tma().efl, L.tma().focal_points[1]))
        assert f1.parax_roc == 20.0
        L2 = pkg.Lens(_make(pkg, jnp if pkg is ot else torch, "f2"),
                      pkg.SphericalSurface(r=R_AP, R=-30), n=n[pkg], pos=[0, 0, 0], d=1.0)
        with pytest.raises(RuntimeError, match="rotational symmetry"):
            L2.tma()
    np.testing.assert_allclose(res[1], res[0], rtol=1e-9)


def test_a_function_surface_without_sag_compiles_flat():
    """As in the JAX package, a function surface of zero extent is a flat
    disc: the kind that joins a trace run, with the disc's mask."""
    sj = ot.FunctionSurface2D(r=2.0, func=lambda x, y: 0.0 * x)
    st = otp.FunctionSurface2D(r=2.0, func=lambda x, y: 0.0 * x)
    fj, ft = j_compile(sj), t_compile(st, "cpu")
    assert fj.kind == ft.kind == "flat" and ft.is_flat
    assert ft.host["r"] == np.float32(2.0)
    from optrace_tpu_torch.tracer.trace_core import TraceStep, _run_step
    assert _run_step(TraceStep(ft, "refract"))
    x = torch.tensor([0.5, 1.9, 2.1])
    assert ft.mask_fn(ft.params, x, 0 * x).tolist() == [True, True, False]
