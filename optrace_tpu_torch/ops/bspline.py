"""Tensor-product B-spline evaluation on torch tensors.

Counterpart of ``optrace_tpu/ops/bspline.py``: the spline is fitted on the
host with scipy (f64 coefficients), then evaluated *exactly* on tensors
with a vectorized de Boor basis: no dense-grid resampling, C^(k−1)-smooth
sag and consistent normals.

The basis computation is the classic knot-span algorithm (The NURBS Book,
alg. A2.2) with the degree fixed in Python, so the inner loops unroll into
straight-line tensor code: one ``searchsorted`` per query axis plus (k+1)²
coefficient gathers for a 2D surface. Every operation is differentiable in
the query points (reverse and forward mode).

Knots and coefficients are rounded ONCE to the query's dtype and kept per
device (:class:`_Tables`): a knot held in f64 against an f32 query could
pick another span near a knot than the same spline evaluated in f32
throughout. f64 queries (the host API) evaluate with the f64 tables.
"""

import numpy as np
import torch


def basis(knots, k: int, x):
    """Nonzero B-spline basis functions at x.

    :param knots: (n_knots,) non-decreasing knot tensor, x's dtype and device
    :param k: spline degree (Python int)
    :param x: query points, any shape
    :return: (span, N) — span index tensor (same shape as x) and basis
        values of shape x.shape + (k+1,): N[..., j] is the value of basis
        function ``span − k + j`` at x.
    """
    n = knots.shape[0]
    # valid spans are [k, n-k-2]; clamping also clamps out-of-range queries
    # to the boundary polynomial piece (= spline extrapolation, like scipy)
    span = torch.clamp(torch.searchsorted(knots, x.detach().contiguous(), right=True) - 1,
                       k, n - k - 2)

    N = [torch.ones_like(x)]
    left = []    # left[j] = x − knots[span+1−(j+1)]
    right = []   # right[j] = knots[span+(j+1)] − x
    for d in range(1, k + 1):
        left.append(x - knots[span + 1 - d])
        right.append(knots[span + d] - x)
        saved = torch.zeros_like(x)
        N_new = []
        for j in range(d):
            den = right[j] + left[d - 1 - j]
            tmp = N[j] / torch.where(den != 0, den, 1.0)
            N_new.append(saved + right[j] * tmp)
            saved = left[d - 1 - j] * tmp
        N_new.append(saved)
        N = N_new
    return span, torch.stack(N, dim=-1)


def eval_1d(knots, coeffs, k: int, x):
    """Evaluate a 1D B-spline Σ c_i B_{i,k}(x)."""
    span, N = basis(knots, k, x)
    out = torch.zeros_like(N[..., 0])
    for j in range(k + 1):
        out = out + coeffs[span - k + j] * N[..., j]
    return out


def eval_2d(tx, ty, coeffs, kx: int, ky: int, x, y):
    """Evaluate a tensor-product spline Σ c_ij B_{i,kx}(x) B_{j,ky}(y).

    ``coeffs`` has shape (tx.size − kx − 1, ty.size − ky − 1), matching
    scipy.interpolate.RectBivariateSpline.tck.
    """
    sx, Nx = basis(tx, kx, x)
    sy, Ny = basis(ty, ky, y)
    out = torch.zeros_like(Nx[..., 0])
    for a in range(kx + 1):
        for b in range(ky + 1):
            out = out + coeffs[sx - kx + a, sy - ky + b] * Nx[..., a] * Ny[..., b]
    return out


class _Tables:
    """The host arrays of a spline and their tensors, rounded once to each
    (device, dtype) that evaluates them."""

    def __init__(self, *arrays):
        self.host = tuple(np.asarray(a, dtype=np.float64) for a in arrays)
        self._cache = {}

    def on(self, x):
        key = (x.device, x.dtype)
        if key not in self._cache:
            self._cache[key] = tuple(torch.as_tensor(a, dtype=x.dtype, device=x.device)
                                     for a in self.host)
        return self._cache[key]


class Spline1D:
    """Host-fitted 1D spline with tensor evaluation and exact derivative.

    Wraps scipy tck arrays (f64); ``__call__``/``deriv`` take tensors.
    """

    def __init__(self, scipy_spline):
        t, c, k = (np.asarray(scipy_spline._eval_args[0]),
                   np.asarray(scipy_spline._eval_args[1]),
                   int(scipy_spline._eval_args[2]))
        self.k = k
        self._tab = _Tables(t, c[:t.size - k - 1])
        d = scipy_spline.derivative()
        td, cd, kd = d._eval_args
        td = np.asarray(td)
        self.kd = int(kd)
        self._dtab = _Tables(td, np.asarray(cd)[:td.size - self.kd - 1])

    def __call__(self, x):
        t, c = self._tab.on(x)
        return eval_1d(t, c, self.k, x)

    def deriv(self, x):
        t, c = self._dtab.on(x)
        return eval_1d(t, c, self.kd, x)


def _tck2(spl):
    tx, ty, c = (np.asarray(a) for a in spl.tck)
    kx, ky = (int(v) for v in spl.degrees)
    return _Tables(tx, ty, c.reshape(tx.size - kx - 1, ty.size - ky - 1)), kx, ky


class Spline2D:
    """Host-fitted RectBivariateSpline with tensor evaluation and exact
    partial derivatives (each an exact lower-order spline, via scipy)."""

    def __init__(self, scipy_spline):
        self._tab, self.kx, self.ky = _tck2(scipy_spline)
        self._dx = _tck2(scipy_spline.partial_derivative(1, 0))
        self._dy = _tck2(scipy_spline.partial_derivative(0, 1))

    def __call__(self, x, y):
        tx, ty, c = self._tab.on(x)
        return eval_2d(tx, ty, c, self.kx, self.ky, x, y)

    @staticmethod
    def _eval(tck, x, y):
        tab, kx, ky = tck
        tx, ty, c = tab.on(x)
        return eval_2d(tx, ty, c, kx, ky, x, y)

    def deriv_x(self, x, y):
        return self._eval(self._dx, x, y)

    def deriv_y(self, x, y):
        return self._eval(self._dy, x, y)
