"""The port's plain ``bin_xyzw`` against the JAX package's scatter
(``optrace_tpu.ops.binning.bin_xyzw``) and against its Pallas binning kernel
in interpret mode, on the three cases of tests/test_pallas.py (atol 1e-5:
f32 summation order; the inclusive-edge case atol 1e-6).
"""

import numpy as np
import pytest
import torch

from optrace_tpu.ops.binning import bin_xyzw as j_bin_xyzw, binning_indices_2d as j_indices
from optrace_tpu.ops.pallas_binning import bin_xyzw_pallas

from optrace_tpu_torch.ops.binning import bin_xyzw, binning_indices_2d
from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda

EXT = (-1.0, 1.0, -1.0, 1.0)


def _data(N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(0, 1, N).astype(np.float32),
            rng.uniform(380, 780, N).astype(np.float32))


def _edge_data():
    return (np.array([1.0, -1.0, 0.0], dtype=np.float32), np.array([1.0, -1.0, 1.0], dtype=np.float32),
            np.ones(3, dtype=np.float32), np.full(3, 550.0, dtype=np.float32))


CASES = {"matches_scatter": (lambda: _data(5000), 63, 57, 1e-5),
         "non_multiple_sizes": (lambda: _data(777, seed=2), 31, 29, 1e-5),
         "edge_inclusive": (_edge_data, 63, 57, 1e-6)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("oracle", ["scatter", "pallas_interpret"])
def test_bin_xyzw(case, oracle):
    make, Nx, Ny, atol = CASES[case]
    data = make()
    if oracle == "scatter":
        ref = np.asarray(j_bin_xyzw(*data, Nx, Ny, EXT))
    else:
        ref = np.asarray(bin_xyzw_pallas(*data, Nx, Ny, EXT, interpret=True))
    img = bin_xyzw(*(torch.from_numpy(a) for a in data), Nx, Ny, EXT)
    assert img.shape == (Ny, Nx, 4) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, atol=atol)
    if case == "edge_inclusive":
        assert float(img[..., 3].sum()) == pytest.approx(3.0)


def test_binning_indices():
    px, py, w, _ = _data(4000, seed=4)
    px[:3], py[:3] = [1.0, -1.0, 1.0000001], [1.0, -1.0, 0.0]
    xj, yj, wj = (np.asarray(a) for a in j_indices(px, py, w, 63, 57, EXT))
    xt, yt, wt = (a.numpy() for a in binning_indices_2d(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(w), 63, 57, EXT))
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj) and np.array_equal(wt, wj)
    assert (wt == 0).sum() > 100


def test_accumulates_into_out_and_wrapper_on_cpu():
    """``out`` is accumulated into; the kernel wrapper handed CPU tensors
    takes the plain version."""
    data = [torch.from_numpy(a) for a in _data(2000, seed=6)]
    one = bin_xyzw(*data, 16, 16, EXT)
    acc = bin_xyzw(*data, 16, 16, EXT, out=one.clone())
    np.testing.assert_allclose(acc.numpy(), 2 * one.numpy(), rtol=1e-6)
    before = bin_xyzw_cuda.launches
    via_wrapper = bin_xyzw_cuda(*data, 16, 16, EXT)
    assert bin_xyzw_cuda.launches == before
    assert torch.equal(via_wrapper, one)
