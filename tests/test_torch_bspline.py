"""The port's B-spline kernels (ops/bspline.py) against the JAX package's:
``basis``, ``eval_1d``, ``eval_2d`` and the derivative splines of
``Spline1D``/``Spline2D``, at random points, at every knot and at and
beyond the edges (where both clamp to the boundary piece).

Both evaluate in f32 with the knots and coefficients rounded once to f32,
in the same operation order: the tolerance is f32 rounding, 2 ulp of the
largest value (4 ulp for the basis functions, whose sums are 1), and the
knot spans must be equal. An f64 query evaluates with the f64 tables and
matches scipy to 1e-12.
"""

import numpy as np
import pytest
import scipy.interpolate as si
import jax.numpy as jnp
import torch

from optrace_tpu.ops import bspline as jb
from optrace_tpu_torch.ops import bspline as tb

R = 3.0
ULP = np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def splines():
    xy = np.linspace(-R, R, 120)
    X, Y = np.meshgrid(xy, xy)
    Z = 0.02 * X ** 2 + 0.01 * Y ** 2 + 0.003 * np.sin(2 * X) * Y
    s2 = si.RectBivariateSpline(xy, xy, Z.T, kx=4, ky=4)
    s1 = si.InterpolatedUnivariateSpline(xy, 0.1 * np.sin(xy) + 0.01 * xy ** 2, k=4)
    return s1, s2


def _queries(knots, seed):
    rng = np.random.default_rng(seed)
    edge = [-R, R, -1.01 * R, 1.01 * R, -2 * R, 2 * R]
    x = np.concatenate([rng.uniform(-R, R, 3000), knots, edge]).astype(np.float32)
    return x, np.roll(x[::-1], 7)


def _close(a, b, scale):
    np.testing.assert_allclose(b, a, rtol=0, atol=2 * ULP * scale)


def test_basis_and_spans(splines):
    s1, s2 = splines
    kn = np.asarray(s2.tck[0], dtype=np.float32)
    x, _ = _queries(kn, 0)
    for k in (1, 2, 3, 4):
        span_j, N_j = jb.basis(jnp.asarray(kn), k, jnp.asarray(x))
        span_t, N_t = tb.basis(torch.from_numpy(kn), k, torch.from_numpy(x))
        assert np.array_equal(np.asarray(span_j), span_t.numpy())
        np.testing.assert_allclose(N_t.numpy(), np.asarray(N_j), rtol=0, atol=4 * ULP)


@pytest.mark.parametrize("which", ["__call__", "deriv_x", "deriv_y"])
def test_spline2d_and_partials(splines, which):
    _, s2 = splines
    x, y = _queries(np.asarray(s2.tck[0]), 1)
    a = np.asarray(getattr(jb.Spline2D(s2), which)(jnp.asarray(x), jnp.asarray(y)))
    b = getattr(tb.Spline2D(s2), which)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(a, b, np.abs(a).max())


@pytest.mark.parametrize("which", ["__call__", "deriv"])
def test_spline1d_and_derivative(splines, which):
    s1, _ = splines
    x, _ = _queries(np.asarray(s1._eval_args[0]), 2)
    a = np.asarray(getattr(jb.Spline1D(s1), which)(jnp.asarray(x)))
    b = getattr(tb.Spline1D(s1), which)(torch.from_numpy(x)).numpy()
    _close(a, b, np.abs(a).max())


def test_eval_functions_and_f64_tables(splines):
    """``eval_1d``/``eval_2d`` on explicit tck arrays, and the f64 path of
    the host API against scipy itself."""
    s1, s2 = splines
    x, y = _queries(np.asarray(s2.tck[0]), 3)
    tx, ty, c = (np.asarray(a) for a in s2.tck)
    c = c.reshape(tx.size - 5, ty.size - 5)
    a = np.asarray(jb.eval_2d(tx, ty, c, 4, 4, jnp.asarray(x), jnp.asarray(y)))
    b = tb.eval_2d(*(torch.as_tensor(v, dtype=torch.float32) for v in (tx, ty, c)), 4, 4,
                   torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(a, b, np.abs(a).max())
    t, c1, k = s1._eval_args
    c1 = np.asarray(c1)[:len(t) - k - 1]
    a = np.asarray(jb.eval_1d(np.asarray(t), c1, k, jnp.asarray(x)))
    b = tb.eval_1d(torch.as_tensor(t, dtype=torch.float32), torch.as_tensor(c1, dtype=torch.float32),
                   k, torch.from_numpy(x)).numpy()
    _close(a, b, np.abs(a).max())
    # f64 queries take the f64 tables: the scipy spline to evaluation precision
    inside = (np.abs(x) <= R) & (np.abs(y) <= R)
    x64, y64 = x[inside].astype(np.float64), y[inside].astype(np.float64)
    v = tb.Spline2D(s2)(torch.from_numpy(x64), torch.from_numpy(y64)).numpy()
    np.testing.assert_allclose(v, s2.ev(x64, y64), rtol=0, atol=1e-12)
    d = tb.Spline1D(s1).deriv(torch.from_numpy(x64)).numpy()
    np.testing.assert_allclose(d, s1.derivative()(x64), rtol=0, atol=1e-12)
