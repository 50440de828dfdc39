"""The sums that read a stored trace do not depend on the order of the rays.

``bin_scalar``, ``histogram_1d``, the focus sweep's histograms, its RMS
cost and closed form (``ops/binning.py:block_sums``) and the forward of
``bin_xyzw_soft`` add through ``ops/binning.py:scatter_sum``:
the same rays in another order give the same bits, in f32 (one int64 a
value, kernel 2's fixed point) and in f64 (three int64 limbs a value). The
old form, ``index_add_`` of floats, adds in the order of the rays on the
CPU and in the order of the threads on a CUDA device; ``_index_add_soft``
below is that form of ``bin_xyzw_soft``, whose gradient the new one keeps
bit for bit. The inputs are made with numpy from a seed, with weights over
six decades so that float sums in another order round otherwise. This
file imports no JAX: its ``cuda`` case runs on a card with
``python -m pytest --noconftest -m cuda tests/test_torch_binning_order.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from optrace_tpu_torch.analysis import focus
from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer
from optrace_tpu_torch.ops import binning

N = 20000
EXT = (-1.0, 1.0, -0.5, 0.5)
NX, NY = 7, 5                   # about 570 rays a pixel: long sums


def _rays(dtype, seed=0, n=N):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1.1, 1.1, n)
    py = rng.uniform(-0.55, 0.55, n)
    w = rng.uniform(0, 1, n) * 10.0 ** rng.uniform(-6, 0, n)
    wl = rng.uniform(380, 780, n)
    perm = rng.permutation(n)
    return tuple(torch.tensor(a, dtype=dtype) for a in (px, py, w, wl)), torch.from_numpy(perm)


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _index_add_soft(px, py, w, wl, Nx, Ny, extent):
    """``bin_xyzw_soft`` as it was: four ``index_add`` of f32 deposits."""
    x0, x1, y0, y1 = extent
    gx = (px - x0) / (x1 - x0) * Nx - 0.5
    gy = (py - y0) / (y1 - y0) * Ny - 0.5
    ix, iy = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - ix, gy - iy
    ix = torch.clamp(ix, -1.0, float(Nx)).to(torch.int64)
    iy = torch.clamp(iy, -1.0, float(Ny)).to(torch.int64)
    inside = (gx >= -0.5) & (gx <= Nx - 0.5) & (gy >= -0.5) & (gy <= Ny - 0.5)
    wm = torch.where(inside, w, 0.0)
    xyzw = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
    img = torch.zeros((Ny * Nx, 4), dtype=xyzw.dtype, device=xyzw.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi = torch.clamp(ix + dx, 0, Nx - 1)
            yi = torch.clamp(iy + dy, 0, Ny - 1)
            img = img.index_add(0, yi * Nx + xi, xyzw * (wx * wy)[:, None])
    return img.view(Ny, Nx, 4)


def _sums(px, py, w, wl):
    """Every repaired sum on one set of rays."""
    q0 = torch.stack([px, py], dim=-1)
    m = torch.stack([0.02 * py - px / 20, -py / 20], dim=-1)
    z = torch.tensor([10.0, 19.5, 20.0, 31.0], dtype=px.dtype, device=px.device)
    hist, _ = focus._spot_histograms(q0, m, w, z, 15)
    return dict(bin_scalar=binning.bin_scalar(px, py, w, NX, NY, EXT),
                histogram_1d=binning.histogram_1d(wl, w, 11, 380.0, 780.0),
                focus_histograms=hist,
                rms_cost=focus.cost_sweep(z, q0, m, w, "RMS Spot Size", 15),
                rms_focus_direct=torch.tensor(focus.rms_focus_direct(q0, m, w, [10.0, 30.0])),
                bin_xyzw_soft=binning.bin_xyzw_soft(px, py, w, wl, NX, NY, EXT))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_permuted_rays_give_equal_bits(dtype):
    """Fails with ``index_add_`` sums (the form before the order-free one):
    every sum below rounds otherwise for the permuted rays."""
    rays, perm = _rays(dtype)
    a = _sums(*rays)
    b = _sums(*(t[perm] for t in rays))
    for name in a:
        assert _same_bits(a[name], b[name]), name
    # the old form on the same inputs: the order shows
    old = _index_add_soft(*rays, NX, NY, EXT)
    old_p = _index_add_soft(*(t[perm] for t in rays), NX, NY, EXT)
    assert not _same_bits(old, old_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sums_are_exact_to_rounding(dtype):
    """f32: the exact sum of the values, rounded once (the values' own
    rounding to 2^-e is 2^-40 of the largest here); f64: within two ulp of
    the exact sum, where the JAX package's f64 scatter, in ray order, may
    be off by about √n ulp."""
    (px, py, w, wl), _ = _rays(dtype, seed=3)
    got = binning.histogram_1d(wl, w, 11, 380.0, 780.0).numpy()
    fi = np.floor(11 / 400.0 * (wl.numpy().astype(np.float64) - 380.0)).astype(int)
    fi = np.where(wl.numpy() == 780.0, 10, fi)
    wn = w.numpy().astype(np.float64)
    exact = np.array([math.fsum(wn[fi == k]) for k in range(11)])
    if dtype == torch.float32:
        assert np.all(np.abs(got.astype(np.float64) - exact) <= np.spacing(exact.astype(np.float32)))
    else:
        assert np.all(np.abs(got - exact) <= 2 * np.spacing(exact))


@pytest.mark.parametrize("mode", ["Irradiance Variance", "RMS Spot Size"])
def test_chunks_of_planes_give_equal_bits(mode):
    """The focus histograms' scale comes from the ray count and the largest
    weight, the RMS cost's from each plane's own values, not from the
    chunk: a sweep in chunks equals one sweep."""
    (px, py, w, _), _ = _rays(torch.float32, seed=4, n=4000)
    q0 = torch.stack([px, py], dim=-1)
    m = torch.stack([-px / 20, -py / 20], dim=-1)
    z = np.arange(10, 30, 0.5)
    whole = focus.cost_sweep(np.float32(z), q0, m, w, mode, 101)
    old = focus.CHUNK_BYTES
    focus.CHUNK_BYTES = 8 * q0.shape[0] * 3
    try:
        chunked = focus.cost_sweep(np.float32(z), q0, m, w, mode, 101)
    finally:
        focus.CHUNK_BYTES = old
    assert _same_bits(whole, chunked)


def test_soft_binning_gradient_equals_index_add():
    """The backward of a scatter is a gather: the gradients with respect to
    x, y and w are those of the four ``index_add`` bit for bit, and the
    image agrees to the f32 rounding of the old sums."""
    (px, py, w, wl), _ = _rays(torch.float32, seed=5, n=3000)
    v = torch.from_numpy(np.random.default_rng(6).normal(size=(NY, NX, 4)).astype(np.float32))
    grads, imgs = [], []
    for fn in (binning.bin_xyzw_soft, _index_add_soft):
        leaves = [t.clone().requires_grad_(True) for t in (px, py, w)]
        img = fn(*leaves, wl, NX, NY, EXT)
        (img * v).sum().backward()
        grads.append([t.grad for t in leaves])
        imgs.append(img.detach())
    for name, a, b in zip(("px", "py", "w"), *grads):
        assert _same_bits(a, b), name
    np.testing.assert_allclose(imgs[0].numpy(), imgs[1].numpy(), rtol=0, atol=1e-6 * float(imgs[1].abs().max()))


def test_soft_binning_forward_mode_tangent():
    """A forward-mode tangent through the order-free sum equals the old
    form's to f32 rounding (the design tests take per-pixel jvp images)."""
    (px, py, w, wl), _ = _rays(torch.float32, seed=7, n=3000)
    tx = torch.from_numpy(np.random.default_rng(8).normal(size=px.shape[0]).astype(np.float32))
    tangents = []
    for fn in (binning.bin_xyzw_soft, _index_add_soft):
        with fwAD.dual_level():
            img = fn(fwAD.make_dual(px, tx), py, w, wl, NX, NY, EXT)
            tangents.append(fwAD.unpack_dual(img).tangent)
    np.testing.assert_allclose(tangents[0].numpy(), tangents[1].numpy(), rtol=0,
                               atol=1e-5 * float(tangents[1].abs().max()))


def test_edge_cases():
    """An empty input, one value, values of one sign and of both, and a
    value that fills a limb's carry."""
    e = torch.zeros(0, dtype=torch.float64)
    assert binning.scatter_sum(3, e.long(), e).tolist() == [0.0] * 3
    one = torch.tensor([0.1], dtype=torch.float64)
    assert binning.scatter_sum(2, torch.tensor([1]), one).tolist() == [0.0, 0.1]
    vals = torch.tensor([1.0, -1.0, 1e-300, -0.25, 2.0 ** 60, -(2.0 ** 60)], dtype=torch.float64)
    idx = torch.tensor([0, 0, 1, 1, 2, 2])
    assert binning.scatter_sum(3, idx, vals).tolist() == [0.0, math.fsum([1e-300, -0.25]), 0.0]
    f = torch.tensor([3.0, -1.5, 0.5], dtype=torch.float32)
    assert binning.scatter_sum(1, torch.zeros(3, dtype=torch.int64), f).tolist() == [2.0]


@pytest.mark.cuda
def test_permuted_rays_give_equal_bits_on_the_card():
    """On a CUDA device ``index_add_`` adds in the order of the threads; the
    order-free sums give one answer for one set of rays, call after call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype in (torch.float32, torch.float64):
        rays, perm = _rays(dtype)
        card = [t.cuda() for t in rays]
        a = _sums(*card)
        again = _sums(*card)
        b = _sums(*(t[perm.cuda()] for t in card))
        for name in a:
            assert _same_bits(a[name].cpu(), again[name].cpu()), name
            assert _same_bits(a[name].cpu(), b[name].cpu()), name
