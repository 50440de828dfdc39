"""The port's fixed-point binning (``ops/binning.py:bin_xyzw_fixed``, the
plain version of the CUDA binning kernel) against the JAX package's scatter
(``optrace_tpu.ops.binning.bin_xyzw``) and its sort + segment-sum form
(``bin_xyzw_sorted``), on the inputs of tests/test_torch_binning.py.

Tolerances against the JAX package, those of the port's binning tests: atol
1e-5 against the scatter (the JAX sums are f32 in another order; the fixed
point rounds each value once, to about 2⁻⁴⁶ of the largest at 5000 rays),
and 2e-6 of the largest channel total against the sorted form, whose pixel
is the difference of two f32 prefix sums over all rays
(tests/test_torch_binning_more.py). Within the port the checks are exact: a
permutation of the rays gives the same bits, which is what makes a resumed
render equal the uninterrupted one.
"""

import numpy as np
import pytest
import torch

from optrace_tpu.ops.binning import bin_xyzw as j_bin_xyzw, bin_xyzw_sorted as j_bin_xyzw_sorted

from optrace_tpu_torch.color.observers import observer_bound
from optrace_tpu_torch.ops.binning import (FIXED_BITS, bin_xyzw, bin_xyzw_fixed, exponent_for,
                                           fixed_point_exponent, pow2)

EXT = (-1.0, 1.0, -1.0, 1.0)


def _data(N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(0, 1, N).astype(np.float32),
            rng.uniform(380, 780, N).astype(np.float32))


def _t(data):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in data]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("oracle", ["scatter", "sorted"])
@pytest.mark.parametrize("N, Nx, Ny, seed", [(5000, 63, 57, 0), (777, 31, 29, 2), (20000, 64, 64, 5)])
def test_against_jax(oracle, N, Nx, Ny, seed):
    data = _data(N, seed)
    ref = np.asarray((j_bin_xyzw if oracle == "scatter" else j_bin_xyzw_sorted)(*data, Nx, Ny, EXT))
    img = bin_xyzw_fixed(*_t(data), Nx, Ny, EXT)
    assert img.shape == (Ny, Nx, 4) and img.dtype == torch.float32
    if oracle == "scatter":
        np.testing.assert_allclose(img.numpy(), ref, atol=1e-5)
    else:
        assert np.abs(img.numpy() - ref).max() <= 2e-6 * ref.sum(axis=(0, 1)).max()


def test_permutation_gives_the_same_bits():
    data = _t(_data(20000, seed=7))
    img = bin_xyzw_fixed(*data, 64, 64, EXT)
    for seed in range(3):
        perm = torch.randperm(20000, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(_bits(bin_xyzw_fixed(*(a[perm] for a in data), 64, 64, EXT)), _bits(img))
    # split in two calls whose sums meet in one integer image: the same
    # pixels, and within one rounding of each value of the whole
    a = bin_xyzw_fixed(*(t[:9000] for t in data), 64, 64, EXT)
    b = bin_xyzw_fixed(*(t[9000:] for t in data), 64, 64, EXT)
    np.testing.assert_allclose((a + b).numpy(), img.numpy(), atol=1e-6)


def test_f32_index_add_need_not_be_order_free():
    """The property above is the fixed point's: the f32 scatter of many rays
    into one pixel changes its bits with their order, while the fixed point
    keeps them and equals the sums taken in f64 to its resolution."""
    rng = np.random.default_rng(3)
    N = 20000
    data = (np.full(N, 0.01, np.float32), np.full(N, -0.01, np.float32),
            rng.uniform(0, 1, N).astype(np.float32), rng.uniform(380, 780, N).astype(np.float32))
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(0))
    f32 = [bin_xyzw(*(a[p] for a in _t(data)), 8, 8, EXT) for p in (torch.arange(N), perm)]
    fixed = [bin_xyzw_fixed(*(a[p] for a in _t(data)), 8, 8, EXT) for p in (torch.arange(N), perm)]
    assert torch.equal(_bits(fixed[0]), _bits(fixed[1]))
    assert not torch.equal(_bits(f32[0]), _bits(f32[1]))
    f64 = bin_xyzw(*(a.double() for a in _t(data)), 8, 8, EXT)
    np.testing.assert_allclose(fixed[0].numpy(), f64.numpy(), rtol=1e-7)


def test_edge_cases():
    px, py, w, wl = _t(_data(3000, seed=1))
    # every ray outside the extent
    outside = bin_xyzw_fixed(px + 5.0, py, w, wl, 16, 16, EXT)
    assert torch.equal(outside, torch.zeros((16, 16, 4)))
    # every weight zero: e is FIXED_BITS and the image is zero
    zero = torch.zeros_like(w)
    assert int(fixed_point_exponent(zero)) == FIXED_BITS
    assert torch.equal(bin_xyzw_fixed(px, py, zero, wl, 16, 16, EXT), torch.zeros((16, 16, 4)))
    # one ray: its four values, rounded once to the fixed point and back
    one = bin_xyzw_fixed(px[:1] * 0 + 0.3, py[:1] * 0 - 0.2, w[:1], wl[:1], 16, 16, EXT)
    ref = bin_xyzw(px[:1] * 0 + 0.3, py[:1] * 0 - 0.2, w[:1], wl[:1], 16, 16, EXT)
    assert torch.count_nonzero(one[..., 3]) == 1
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=2 ** -20)
    # out=: accumulated into in place; a channel whose sum is 0 is left as it is
    base = torch.full((16, 16, 4), -0.0)
    base[0, 0, 0] = 0.5
    acc = bin_xyzw_fixed(px, py, w, wl, 16, 16, EXT, out=base.clone())
    img = bin_xyzw_fixed(px, py, w, wl, 16, 16, EXT)
    nz = img != 0
    assert torch.equal(_bits(acc[~nz]), _bits(base[~nz]))
    assert torch.equal(acc[nz], (base + img)[nz])
    out = torch.zeros((16, 16, 4))
    assert bin_xyzw_fixed(px, py, w, wl, 16, 16, EXT, out=out) is out


@pytest.mark.parametrize("N", [1, 3, 2 ** 20, 10 ** 8, 2 ** 40, 2 ** 53 - 1])
@pytest.mark.parametrize("wmax", [1.0, 0.37, 3e-7, 2.5e4])
def test_exponent_is_the_largest_with_headroom(N, wmax):
    """N·max|w|·B·2^e < 2^62 ≤ N·max|w|·B·2^(e+1), in exact arithmetic, for
    ray counts up to the largest an f64 holds exactly."""
    from fractions import Fraction
    e = int(exponent_for(torch.tensor(np.float32(wmax)), N))
    if N <= 3:
        assert int(fixed_point_exponent(torch.full((N,), np.float32(wmax)))) == e
    bound = Fraction(N) * Fraction(float(np.float32(wmax))) * Fraction(observer_bound())
    assert bound * Fraction(2) ** e < Fraction(2) ** FIXED_BITS
    assert bound * Fraction(2) ** (e + 1) >= Fraction(2) ** FIXED_BITS
    assert float(pow2(torch.tensor(e))) == 2.0 ** e and float(pow2(torch.tensor(-e))) == 2.0 ** -e


def test_sums_near_the_headroom_do_not_overflow():
    """All rays at the wavelength of the largest observer value in one
    pixel with the largest weight: the Z̄ sum is the largest a call can make,
    and it equals the f64 sum to the fixed point's resolution."""
    from optrace_tpu_torch.color.observers import z_observer
    N = 20000
    lam = np.arange(380, 781, dtype=np.float32)
    peak = lam[int(np.argmax(z_observer(lam)))]
    px, py = torch.full((N,), 0.1), torch.full((N,), 0.1)
    w, wl = torch.ones(N), torch.full((N,), float(peak))
    e = int(fixed_point_exponent(w))
    img = bin_xyzw_fixed(px, py, w, wl, 4, 4, EXT)
    z = float(z_observer(wl[:1])[0])
    assert N * z * 2.0 ** e > 2.0 ** (FIXED_BITS - 1)       # within a factor 2 of the limit
    assert float(img[2, 2, 2]) == pytest.approx(N * z, rel=1e-6)
    assert float(img[2, 2, 3]) == pytest.approx(N, rel=1e-6)
