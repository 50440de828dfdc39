"""The asphere, tilted-plane and bracketed-solve functions of the port's
``ops/geom.py`` against ``optrace_tpu.ops.geom`` on the same numpy inputs
(rtol 1e-6 in f32, 1e-12 in f64), and the host API of the surface classes
that use them against the JAX package's classes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import optrace_tpu as ot
from optrace_tpu.ops import geom as jgeom
import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import geom as tgeom

RHO, K, COEFF = 1 / 30.0, -0.5, [2e-4, -1e-6, 3e-9]
TOL = {"f32": dict(rtol=1e-6, atol=1e-7), "f64": dict(rtol=1e-12, atol=1e-14)}


def _xy(n, dtype, seed=0, r=3.0):
    rng = np.random.default_rng(seed)
    rr = r * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    x, y = (rr * np.cos(th)).astype(dtype), (rr * np.sin(th)).astype(dtype)
    x[0] = y[0] = 0.0           # the vertex: r = 0 in the normal's division
    return x, y


def _rays(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x, y = _xy(n, dtype, seed, r=3.4)
    o = np.stack([x, y, np.full(n, -2.0, dtype)], -1)
    s = np.stack([rng.normal(0, 0.08, n), rng.normal(0, 0.08, n), np.ones(n)], -1)
    s = (s / np.linalg.norm(s, axis=-1, keepdims=True)).astype(dtype)
    return o, s


def _with_x64(dtype, fn):
    if dtype == np.float64:
        with jax.enable_x64():
            return fn()
    return fn()


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", ["sag_asphere", "dsag_conic_dr", "dsag_asphere_dr",
                                  "normal_from_radial_deriv", "normal_asphere"])
def test_asphere_functions(name, prec):
    dtype = np.float32 if prec == "f32" else np.float64
    x, y = _xy(3000, dtype)
    r = np.sqrt(x * x + y * y)
    args = {"sag_asphere": (x, y, RHO, K, COEFF), "dsag_conic_dr": (r, RHO, K),
            "dsag_asphere_dr": (r, RHO, K, COEFF),
            "normal_from_radial_deriv": (x, y, (0.05 * r).astype(dtype)),
            "normal_asphere": (x, y, RHO, K, COEFF)}[name]

    def conv(mod):
        return [mod(a) if isinstance(a, np.ndarray) else a for a in args]
    ref = _with_x64(dtype, lambda: np.asarray(getattr(jgeom, name)(*conv(jnp.asarray))))
    out = getattr(tgeom, name)(*conv(torch.from_numpy))
    assert out.dtype == (torch.float32 if prec == "f32" else torch.float64)
    np.testing.assert_allclose(out.numpy(), ref, **TOL[prec])
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_hit_tilted(prec):
    dtype = np.float32 if prec == "f32" else np.float64
    o, s = _rays(3000, dtype)
    s[:20] = np.array([1.0, 0.0, 0.0], dtype)       # parallel to the plane z = 0
    n = [0.0, 0.0, 1.0]
    ref = _with_x64(dtype, lambda: np.asarray(jgeom.hit_tilted(jnp.asarray(o), jnp.asarray(s), n)))
    out = tgeom.hit_tilted(torch.from_numpy(o), torch.from_numpy(s), n).numpy()
    assert np.isinf(out[:20]).all() and np.array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[20:], ref[20:], **TOL[prec])
    th = np.radians(8.0)
    n = [0.0, float(np.sin(th)), float(np.cos(th))]
    ref = _with_x64(dtype, lambda: np.asarray(jgeom.hit_tilted(jnp.asarray(o), jnp.asarray(s), n)))
    out = tgeom.hit_tilted(torch.from_numpy(o), torch.from_numpy(s), n).numpy()
    np.testing.assert_allclose(out, ref, **TOL[prec])


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_hit_newton(prec):
    """The bracketed solve on an asphere: same t, valid and ill. The bracket
    ends within C_EPS/10 of the root in both; t itself is compared to
    2e-6 (f32: a few ulp of the 2 mm flight) and 1e-10 (f64)."""
    dtype = np.float32 if prec == "f32" else np.float64
    o, s = _rays(3000, dtype)
    s[:10, 2] = 0.0             # unguarded divisions by sz
    z_max = float(np.asarray(jgeom.sag_asphere(np.float64(3.0), np.float64(0.0), RHO, K, COEFF)))

    def jrun():
        def sag(x, y):
            return jgeom.sag_asphere(x, y, RHO, K, COEFF)
        return [np.asarray(a) for a in jgeom.hit_newton(sag, jnp.asarray(o), jnp.asarray(s), 0.0, z_max)]
    tj, vj, ij = _with_x64(dtype, jrun)
    tt, vt, it = tgeom.hit_newton(lambda x, y: tgeom.sag_asphere(x, y, RHO, K, COEFF),
                                  torch.from_numpy(o), torch.from_numpy(s), 0.0, z_max)
    assert np.array_equal(vt.numpy(), vj) and np.array_equal(it.numpy(), ij)
    assert vj.sum() > 2000 and ij.sum() > 50 and not vj[:10].any()
    atol = 2e-6 if prec == "f32" else 1e-10
    np.testing.assert_allclose(tt.numpy()[vj], tj[vj], rtol=0, atol=atol)
    # the hit lies on the surface
    ph = o[vj].astype(np.float64) + tt.numpy()[vj, None].astype(np.float64) * s[vj]
    z = np.asarray(jgeom.sag_asphere(ph[:, 0], ph[:, 1], RHO, K, COEFF))
    np.testing.assert_allclose(ph[:, 2], z, atol=5e-6 if prec == "f32" else 2e-7)


def _surfaces(m):
    th = np.radians(8.0)
    slit = m.SlitSurface(dim=[5, 4], dimi=[2.0, 0.6])
    slit.rotate(20)
    return {"asphere": m.AsphericSurface(r=3, R=30, k=-0.5, coeff=[2e-4, -1e-6]),
            "tilted": m.TiltedSurface(r=3, normal=[0.0, float(np.sin(th)), float(np.cos(th))]),
            "tilted_sph": m.TiltedSurface(r=2, normal_sph=[10.0, 30.0]),
            "slit": slit}


@pytest.mark.parametrize("name", ["asphere", "tilted", "tilted_sph", "slit"])
def test_surface_classes_match(name):
    """Host API of the new surface classes: extent, values, mask, normals,
    find_hit, flip and move_to give what the JAX package's classes give."""
    sj, st = _surfaces(ot)[name], _surfaces(otp)[name]
    for surf in (sj, st):
        surf.move_to([0.3, -0.2, 5.0])
    np.testing.assert_allclose(st.extent, sj.extent, rtol=1e-9, atol=1e-9)
    assert st.parax_roc == sj.parax_roc or np.isclose(st.parax_roc, sj.parax_roc)
    x, y = _xy(500, np.float64, seed=3, r=3.3)
    x, y = x + 0.3, y - 0.2
    assert np.array_equal(st.mask(x, y), np.asarray(sj.mask(x, y)))
    np.testing.assert_allclose(st.values(x, y), np.asarray(sj.values(x, y)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st.normals(x, y), np.asarray(sj.normals(x, y)), rtol=1e-6, atol=1e-7)
    o, s = _rays(400, np.float64, seed=4)
    p = o + np.array([0.3, -0.2, 5.0])
    with ot.global_options.no_warnings(), otp.global_options.no_warnings():
        pj, hj, ij = sj.find_hit(p, s)
        pt, ht, it = st.find_hit(p, s)
    assert np.array_equal(ht, np.asarray(hj)) and np.array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=1e-6, atol=2e-6)
    for surf in (sj, st):
        surf.flip()
    np.testing.assert_allclose(st.extent, sj.extent, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(st.values(x, y), np.asarray(sj.values(x, y)), rtol=1e-6, atol=1e-7)
    assert type(st).__name__ == type(sj).__name__ and st.info.split(",")[0] == sj.info.split(",")[0]


def test_surface_classes_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError):
        otp.AsphericSurface(r=3, R=30, k=-0.5, coeff=[])
    with pytest.raises(ValueError):
        otp.AsphericSurface(r=40, R=30, k=0.0, coeff=[1e-4])
    with pytest.raises(RuntimeError):
        otp.TiltedSurface(r=3)
    with pytest.raises(ValueError):
        otp.TiltedSurface(r=3, normal=[0.0, 1.0, 0.0])
    with pytest.raises(ValueError):
        otp.SlitSurface(dim=[2, 2], dimi=[3, 1])
    a, b, vec, inside = otp.SlitSurface(dim=[4, 4], dimi=[2, 1]).hurb_props(np.array([0.0, 1.5]),
                                                                           np.array([0.0, 0.0]))
    aj, bj, vj, ij = ot.SlitSurface(dim=[4, 4], dimi=[2, 1]).hurb_props(np.array([0.0, 1.5]),
                                                                       np.array([0.0, 0.0]))
    assert np.allclose(a, aj) and np.allclose(b, bj) and np.array_equal(inside, ij) and np.allclose(vec, vj)
