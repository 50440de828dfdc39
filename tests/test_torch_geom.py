"""``optrace_tpu_torch.ops.geom`` against ``optrace_tpu.ops.geom``: hits,
clamps, standoff advance, normals and masks on random and edge rays
(grazing, sz = 0, no root, ray behind the surface), in f32 and f64.

Tolerances: f32 rtol 2e-6 / atol 2e-6 on ray parameters t of order 1–10
(a few ulp: XLA may contract to FMA where eager PyTorch does not), f64
rtol 1e-12; boolean outputs must be equal except where a comparison sits
within one rounding of its threshold (counted, at most 2 rays per case).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from optrace_tpu.ops import geom as jgeom
from optrace_tpu_torch.ops import geom as tgeom

DTYPES = {"f32": (np.float32, 2e-6, 2e-6), "f64": (np.float64, 1e-12, 1e-12)}


@pytest.fixture(params=["f32", "f64"])
def prec(request):
    npdt, rtol, atol = DTYPES[request.param]
    if request.param == "f64":
        with jax.enable_x64():
            yield npdt, rtol, atol
    else:
        yield npdt, rtol, atol


def _rays(npdt, n=4000, seed=0, z0=-1.0):
    """Random rays towards a vertex-frame surface plus edge rays: grazing,
    sz = 0, far off axis (no root), starting behind the surface."""
    rng = np.random.default_rng(seed)
    o = np.column_stack([rng.uniform(-3, 3, (n, 2)), np.full(n, z0)])
    s = np.column_stack([rng.normal(0, 0.15, (n, 2)), np.ones(n)])
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    edge_o = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, -1e-9], [0.5, 0.5, -1.0],
                       [30.0, 0.0, -1.0], [0.0, 0.0, 1.0], [2.0, -1.0, 5.0]])
    edge_s = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 1e-7], [1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.1, 0.0, 0.99]])
    edge_s /= np.linalg.norm(edge_s, axis=-1, keepdims=True)
    return (np.concatenate([o, edge_o]).astype(npdt), np.concatenate([s, edge_s]).astype(npdt))


def _bool_equal(a, b, budget=2):
    assert int(np.sum(np.asarray(a) != np.asarray(b))) <= budget


def _close(t, j, rtol, atol, keep=None):
    t, j = np.asarray(t), np.asarray(j)
    if keep is not None:
        t, j = t[keep], j[keep]
    fin = np.isfinite(j)
    assert np.array_equal(np.isfinite(t), fin)
    np.testing.assert_allclose(t[fin], j[fin], rtol=rtol, atol=atol)
    assert np.array_equal(t[~fin], j[~fin], equal_nan=True)


@pytest.mark.parametrize("rho,k,zmin,zmax", [
    (0.05, 0.0, 0.0, 0.25), (-0.04, 0.0, -0.2, 0.0), (1 / 30, -0.5, 0.0, 0.16),
    (0.05, -1.0, 0.0, 0.25), (0.02, 2.0, 0.0, 0.1)])
def test_hit_conic(prec, rho, k, zmin, zmax):
    npdt, rtol, atol = prec
    o, s = _rays(npdt)
    tj, vj = jgeom.hit_conic(jnp.asarray(o), jnp.asarray(s), rho, k, zmin, zmax)
    tt, vt = tgeom.hit_conic(torch.from_numpy(o), torch.from_numpy(s), rho, k, zmin, zmax)
    assert tt.dtype == torch.from_numpy(o).dtype
    _bool_equal(vt.numpy(), vj)
    same = vt.numpy() == np.asarray(vj)
    _close(tt.numpy(), tj, rtol, atol, keep=same & np.asarray(vj))
    assert np.asarray(vj).sum() > 1000 and (~np.asarray(vj)).sum() > 3


def test_hit_plane_and_clamp(prec):
    npdt, rtol, atol = prec
    o, s = _rays(npdt, seed=1)
    tj = jgeom.hit_plane(jnp.asarray(o), jnp.asarray(s))
    tt = tgeom.hit_plane(torch.from_numpy(o), torch.from_numpy(s))
    _close(tt.numpy(), tj, rtol, atol)
    assert np.isinf(tt.numpy()).any()          # the sz = 0 ray
    for zmax in (0.0, 0.3):
        valid = np.isfinite(np.asarray(tj)) & (np.asarray(tj) >= -jgeom.C_EPS)
        rj = jgeom.clamp_abnormal(jnp.asarray(o), jnp.asarray(s), tj, jnp.asarray(valid), zmax)
        rt = tgeom.clamp_abnormal(torch.from_numpy(o), torch.from_numpy(s), tt,
                                  torch.from_numpy(valid), zmax)
        _close(rt[0].numpy(), rj[0], rtol, atol)
        assert np.array_equal(rt[1].numpy(), np.asarray(rj[1]))
        assert np.array_equal(rt[2].numpy(), np.asarray(rj[2]))
        assert rt[2].numpy().any() and rt[1].numpy().any()


def test_advance_to_standoff(prec):
    npdt, rtol, atol = prec
    o, s = _rays(npdt, seed=2, z0=-500.0)
    active = np.random.default_rng(3).uniform(size=o.shape[0]) > 0.2
    pj = jgeom.advance_to_standoff(jnp.asarray(o), jnp.asarray(s), -0.1, jnp.asarray(active))
    pt = tgeom.advance_to_standoff(torch.from_numpy(o), torch.from_numpy(s), -0.1,
                                   torch.from_numpy(active))
    # t0 ≈ 500: one ulp of the product is 500·eps
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=rtol, atol=600 * atol)
    assert np.array_equal(pt.numpy()[~active], o[~active])


def test_normals_and_sag(prec):
    npdt, rtol, atol = prec
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-3, 3, (2, 3000)).astype(npdt)
    for rho, k in ((0.05, 0.0), (-0.04, -0.5), (0.02, 2.0)):
        nj = jgeom.normal_conic(jnp.asarray(x), jnp.asarray(y), rho, k)
        nt = tgeom.normal_conic(torch.from_numpy(x), torch.from_numpy(y), rho, k)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=rtol, atol=atol)
        zj = jgeom.sag_conic(jnp.asarray(x), jnp.asarray(y), rho, k)
        zt = tgeom.sag_conic(torch.from_numpy(x), torch.from_numpy(y), rho, k)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=rtol, atol=atol)
    nf = tgeom.normal_flat(torch.from_numpy(x), torch.from_numpy(y))
    assert np.array_equal(nf.numpy(), np.asarray(jgeom.normal_flat(jnp.asarray(x), jnp.asarray(y))))


def test_masks(prec):
    npdt, _, _ = prec
    rng = np.random.default_rng(5)
    x, y = rng.uniform(-3, 3, (2, 5000)).astype(npdt)
    x[:4], y[:4] = [2.0, 0.0, 1.0, -1.0], [0.0, 2.0, 0.5, -0.5]     # on the edges
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    _bool_equal(tgeom.mask_circle(xt, yt, 2.0).numpy(), jgeom.mask_circle(xj, yj, 2.0), 0)
    _bool_equal(tgeom.mask_ring(xt, yt, 0.8, 2.0).numpy(), jgeom.mask_ring(xj, yj, 0.8, 2.0), 0)
    for ang in (0.0, 0.3):
        _bool_equal(tgeom.mask_rect(xt, yt, 1.0, 0.5, ang).numpy(),
                    jgeom.mask_rect(xj, yj, 1.0, 0.5, ang))
        _bool_equal(tgeom.mask_slit(xt, yt, 2.0, 1.5, 1.0, 0.5, ang).numpy(),
                    jgeom.mask_slit(xj, yj, 2.0, 1.5, 1.0, 0.5, ang))
