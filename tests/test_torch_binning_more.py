"""``bin_scalar``, ``histogram_1d`` and ``bin_xyzw_sorted`` of the port
against the JAX package's functions on the same inputs (made with numpy from
a seed), to 1e-6 of the result's maximum: both sum f32 values, in another
order. Edge rules: the upper edge is inclusive, rays outside go to index 0
with weight 0, an empty input gives a zero histogram.
"""

import numpy as np
import pytest
import torch

from optrace_tpu.ops import binning as jb
from optrace_tpu_torch.ops import binning as tb

EXT = (-1.0, 1.0, -0.5, 0.5)
NX, NY = 63, 35


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(-1.2, 1.2, n).astype(f32), rng.uniform(-0.6, 0.6, n).astype(f32),
            rng.uniform(0, 1, n).astype(f32), rng.uniform(380, 780, n).astype(f32))


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _close(a, b):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape)
    assert np.abs(a - b.numpy()).max() <= 1e-6 * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("n", [1, 1000, 20000])
def test_bin_scalar_parity(n):
    px, py, w, _ = _rays(n, seed=n)
    _close(jb.bin_scalar(px, py, w, NX, NY, EXT), tb.bin_scalar(*_t(px, py, w), NX, NY, EXT))


@pytest.mark.parametrize("n", [1, 1000, 20000])
def test_histogram_1d_parity(n):
    _, _, w, wl = _rays(n, seed=n + 1)
    for N, lo, hi in ((51, 380.0, 780.0), (7, 450.0, 600.0)):
        _close(jb.histogram_1d(wl, w, N, lo, hi), tb.histogram_1d(*_t(wl, w), N, lo, hi))


@pytest.mark.parametrize("n", [1000, 20000])
def test_bin_xyzw_sorted_parity(n):
    px, py, w, wl = _rays(n, seed=n + 2)
    a = jb.bin_xyzw_sorted(px, py, w, wl, NX, NY, EXT)
    b = tb.bin_xyzw_sorted(*_t(px, py, w, wl), NX, NY, EXT)
    # a pixel is the difference of two prefix sums over all rays: the error
    # is relative to the largest prefix sum, not to the pixel
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-6 * float(np.asarray(a).sum(axis=(0, 1)).max())
    assert b.shape == (NY, NX, 4)


def test_bin_xyzw_sorted_matches_scatter():
    """The case of tests/test_parallel.py:test_sorted_binning_matches_scatter
    on the port, and tighter: the two sums agree to f32 rounding."""
    rng = np.random.default_rng(1)
    N = 20000
    px, py = (torch.from_numpy(rng.uniform(-1.2, 1.2, N).astype(np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
    wl = torch.from_numpy(rng.uniform(400, 700, N).astype(np.float32))
    ext = (-1.0, 1.0, -1.0, 1.0)
    a = tb.bin_xyzw(px, py, w, wl, 95, 95, ext).numpy()
    b = tb.bin_xyzw_sorted(px, py, w, wl, 95, 95, ext).numpy()
    np.testing.assert_allclose(a, b, atol=1e-2)
    assert a.sum() == pytest.approx(b.sum(), rel=1e-6)
    assert np.abs(a - b).max() <= 2e-6 * a.sum(axis=(0, 1)).max()


def test_edges_inclusive_and_outside_rays():
    x = torch.tensor([-1.0, 1.0, 1.0000001, -1.0000001, 0.0, 0.999999])
    y = torch.tensor([-0.5, 0.5, 0.0, 0.0, 0.5000001, 0.0])
    w = torch.ones(6)
    img = tb.bin_scalar(x, y, w, 4, 2, EXT)
    assert img[0, 0] == 1 and img[1, 3] == 2 and float(img.sum()) == 3     # three rays lie outside
    xi, yi, wm = tb.binning_indices_2d(x, y, w, 4, 2, EXT)
    assert xi.tolist() == [0, 3, 0, 0, 0, 3] and yi.tolist() == [0, 1, 0, 0, 0, 1]
    assert wm.tolist() == [1, 1, 0, 0, 0, 1]
    h = tb.histogram_1d(torch.tensor([380.0, 780.0, 780.1, 379.9, 580.0]), torch.ones(5), 4, 380.0, 780.0)
    assert h.tolist() == [1, 0, 1, 1]
    hs = tb.bin_xyzw_sorted(x, y, w, torch.full((6,), 550.0), 4, 2, EXT)
    assert hs[..., 3].tolist() == img.tolist()
    # far outside: no wrap-around in the integer conversion
    far = torch.tensor([1e30, -1e30, float("inf")])
    assert float(tb.bin_scalar(far, far, torch.ones(3), 4, 2, EXT).sum()) == 0
    assert float(tb.histogram_1d(far, torch.ones(3), 4, 380.0, 780.0).sum()) == 0


def test_empty_input():
    e = torch.zeros(0)
    assert tb.bin_scalar(e, e, e, 4, 2, EXT).tolist() == [[0.0] * 4] * 2
    assert tb.histogram_1d(e, e, 5, 380.0, 780.0).tolist() == [0.0] * 5
    assert float(tb.bin_xyzw_sorted(e, e, e, e, 4, 2, EXT).abs().sum()) == 0
    assert tb.bin_xyzw_sorted(e, e, e, e, 4, 2, EXT).shape == (2, 4, 4)


def test_f64_inputs_keep_their_type():
    px, py, w, wl = (t.double() for t in _t(*_rays(500, seed=9)))
    assert tb.bin_scalar(px, py, w, NX, NY, EXT).dtype == torch.float64
    assert tb.histogram_1d(wl, w, 11, 380.0, 780.0).dtype == torch.float64
    h = tb.histogram_1d(wl, w, 11, 380.0, 780.0).numpy()
    ref, _ = np.histogram(wl.numpy(), bins=11, weights=w.numpy(), range=[380.0, 780.0])
    np.testing.assert_allclose(h, ref, rtol=1e-12)
