"""Detector binning: scatter-add of observer-weighted ray hits into XYZW
image tiles (plain PyTorch).

Counterpart of ``optrace_tpu/ops/binning.py``. :func:`bin_xyzw` adds the
f32 values with ``index_add_`` and is the CPU route of the binning kernel
(:mod:`.cuda_binning`); :func:`bin_xyzw_fixed` is the kernel's plain
version: the same values added as 64-bit integers, so that the image does
not depend on the order of the rays. :func:`bin_scalar`,
:func:`bin_xyzw_sorted`, :func:`bin_xyzw_soft` and :func:`histogram_1d` are
tensor functions on the device of their inputs; :func:`bin_xyzw_soft` is the
differentiable one. :func:`bin_scalar`, :func:`histogram_1d` and
:func:`bin_xyzw_soft` add through :func:`scatter_sum` (and the focus
search through :func:`block_sums`), whose sums are integers too: one input
gives one result, whatever the order of its rays and whatever the order in
which the device's threads add them.
"""

import math

import torch

from ..color.observers import x_observer, y_observer, z_observer, observer_bound

# the integers of one call sum to less than 2**FIXED_BITS in magnitude: one
# bit of headroom in an int64 for the rounding of each ray's values
FIXED_BITS = 62


def binning_indices_2d(x, y, w, Nx: int, Ny: int, extent):
    """Bin indices for a 2D histogram over ``extent`` = [x0, x1, y0, y1].

    Rays outside the extent get index (0, 0) and zero weight; the positive
    edges are inclusive.
    :return: (xi, yi, wm)
    """
    x0, x1, y0, y1 = extent[0], extent[1], extent[2], extent[3]
    sx = x1 - x0
    sy = y1 - y0

    # floor in the float domain, then convert: a position far outside the
    # extent must not wrap around in the integer conversion
    fx = torch.floor(Nx / sx * (x - x0))
    fy = torch.floor(Ny / sy * (y - y0))
    fx = torch.where(x == x1, float(Nx - 1), fx)
    fy = torch.where(y == y1, float(Ny - 1), fy)

    inside = (fx >= 0) & (fy >= 0) & (fy < Ny) & (fx < Nx)
    wm = torch.where(inside, w, 0.0)
    xi = torch.where(inside, fx, 0.0).to(torch.int64)
    yi = torch.where(inside, fy, 0.0).to(torch.int64)
    return xi, yi, wm


def bin_xyzw(px, py, w, wl, Nx: int, Ny: int, extent, out=None):
    """Accumulate rays into an (Ny, Nx, 4) image of X̄w, Ȳw, Z̄w, w.

    Observer weighting happens inline so wavelengths never need to be
    stored. ``out`` (Ny, Nx, 4), when given, is accumulated into in place.
    """
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    xyzw = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                        z_observer(wl) * wm, wm], dim=-1)
    flat = yi * Nx + xi
    if out is None:
        out = torch.zeros((Ny, Nx, 4), dtype=xyzw.dtype, device=xyzw.device)
    out.view(Ny * Nx, 4).index_add_(0, flat, xyzw)
    return out


def fixed_point_exponent(w):
    """The exponent ``e`` of the fixed point of :func:`bin_xyzw_fixed` for
    the weights ``w``: :func:`exponent_for` of max|w| and len(w), a 0-dim
    int64 tensor on the device of ``w`` (nothing is read back)."""
    wmax = torch.abs(w).amax() if w.numel() else torch.zeros((), dtype=w.dtype, device=w.device)
    return exponent_for(wmax, w.shape[0])


def exponent_for(wmax, N: int):
    """The largest ``e`` with N·wmax·B·2^e < 2^FIXED_BITS, where B is the
    largest observer value or 1 (:func:`observer_bound`), for a 0-dim f32
    tensor ``wmax``: taken from the exponent field of that bound in f64, so
    a bound of 0 gives ``FIXED_BITS``."""
    return _exponent(wmax.to(torch.float64) * float(N) * observer_bound())


def _exponent(bound):
    """The largest ``e`` with bound·2^e < 2^FIXED_BITS for a 0-dim f64
    tensor ``bound`` >= 0, from its exponent field; 0 gives FIXED_BITS."""
    biased = bound.view(torch.int64) >> 52        # bound >= 0: no sign bit
    return torch.where(biased == 0, FIXED_BITS, FIXED_BITS + 1022 - biased)


def pow2(e):
    """2^e as an f64 tensor, exactly, for an int64 tensor ``e`` in [-1022, 1023]."""
    return ((e + 1023) << 52).view(torch.float64)


def bin_xyzw_fixed(px, py, w, wl, Nx: int, Ny: int, extent, out=None):
    """:func:`bin_xyzw` in fixed point: each ray's four f32 values (X̄w, Ȳw,
    Z̄w, w) are rounded once, half to even, to integers at the scale 2^e of
    :func:`fixed_point_exponent`, summed as int64 and converted to f32 once a
    pixel. Integer sums do not depend on their order, so the image is a
    function of the set of rays. A channel whose sum is 0 leaves ``out``
    untouched; ``out`` (Ny, Nx, 4) f32, when given, is accumulated into in
    place, otherwise a zeroed image is made. The plain version of the CUDA
    binning kernel, bit for bit."""
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    xyzw = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                        z_observer(wl) * wm, wm], dim=-1)
    e = fixed_point_exponent(w)
    q = torch.round(xyzw.to(torch.float64) * pow2(e)).to(torch.int64)
    acc = torch.zeros((Ny * Nx, 4), dtype=torch.int64, device=q.device)
    acc.index_add_(0, yi * Nx + xi, q)
    acc = acc.view(Ny, Nx, 4)
    img = (acc.to(torch.float64) * pow2(-e)).to(torch.float32)
    if out is None:
        return img
    return out.copy_(torch.where(acc != 0, out + img, out))


def scatter_sum(size: int, index, src, n: int = None, vmax=None):
    """``zeros(size, ...).index_add_(0, index, src)`` as a function of the
    set of (index, value) pairs: the result does not depend on their order,
    on the CPU or on a CUDA device, where ``index_add_`` adds floats in the
    order in which the threads arrive.

    The values are rounded to integers at a scale 2^e and summed as int64,
    which is exact and so order-free (:func:`to_fixed`). ``e`` is the
    largest with n·vmax·2^e < 2^FIXED_BITS: ``n`` bounds the count of
    values that meet in one place (default: all of them) and ``vmax``
    |src| (a 0-dim tensor; default: reduced from ``src`` on its device,
    nothing is read back). Values must be finite. ``src`` is (M,) or
    (M, C); the result is (size,) or (size, C) in the type of ``src``.
    """
    out_shape = (size,) + tuple(src.shape[1:])
    if src.shape[0] == 0:
        return torch.zeros(out_shape, dtype=src.dtype, device=src.device)
    q, e, bits = to_fixed(src, n, vmax)
    acc = torch.zeros(out_shape + q.shape[src.dim():], dtype=torch.int64, device=src.device)
    return from_fixed(acc.index_add_(0, index, q), e, bits, src.dtype)


def block_sums(src, blocks: int = 1):
    """The sums over each of ``blocks`` equal runs of the rows of ``src``
    (blocks · n, ...), (blocks, ...): order-free as :func:`scatter_sum`, and
    without atomics (the integers are added by ``torch.sum``, exactly). Each
    block takes its own scale, from its own largest value, so a block's sum
    does not depend on the blocks beside it."""
    n = src.shape[0] // blocks
    if n == 0:
        return torch.zeros((blocks,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    src = src.reshape((blocks, n) + tuple(src.shape[1:]))
    vmax = src.abs().amax(dim=tuple(range(1, src.dim())), keepdim=True)
    q, e, bits = to_fixed(src, n, vmax)
    return from_fixed(q.sum(dim=1), e.squeeze(1), bits, src.dtype)


def to_fixed(src, n: int = None, vmax=None):
    """The integers of :func:`scatter_sum`: ``(q, e, bits)``, q int64.

    - f32 (and narrower): one integer a value, ``src`` · 2^e rounded half to
      even, as :func:`bin_xyzw_fixed` rounds; q has the shape of ``src``.
    - f64: three integers a value in a last axis, the whole part at 2^e and
      two limbs of ``bits`` <= 52 bits below it, so every bit of an f64
      within 2^-100 of vmax takes part in the exact sum.
    """
    n = src.shape[0] if n is None else int(n)
    if vmax is None:
        vmax = src.abs().amax()
    e = torch.clamp(_exponent(vmax.to(torch.float64) * float(max(n, 1))), max=1022)
    s = src.to(torch.float64) * pow2(e)
    if src.dtype != torch.float64:
        return s.round_().to(torch.int64), e, 0
    bits = _limb_bits(n)
    hi = torch.trunc(s)
    r = (s - hi) * 2.0 ** bits                      # exact: a power of two times a fraction
    mid = torch.trunc(r)
    lo = torch.round((r - mid) * 2.0 ** bits)
    return torch.stack([hi, mid, lo], dim=-1).to(torch.int64), e, bits


def from_fixed(acc, e, bits: int, dtype):
    """Sums of the integers of :func:`to_fixed` back to ``dtype``: f32 the
    sum rounded once, f64 within a few ulp of the exact sum (the three
    limbs carried into canonical limbs, then combined)."""
    if dtype != torch.float64:
        return (acc.to(torch.float64) * pow2(-e)).to(dtype)
    hi, mid, lo = acc.unbind(-1)
    # carry into limbs in [0, 2^bits): then mid and lo are exact in f64
    c = lo >> bits
    lo = lo - (c << bits)
    mid = mid + c
    c = mid >> bits
    mid = mid - (c << bits)
    hi = hi + c
    frac = (mid.to(torch.float64) + lo.to(torch.float64) * 2.0 ** -bits) * 2.0 ** -bits
    return (hi.to(torch.float64) + frac) * pow2(-e)


def _limb_bits(n: int) -> int:
    """Bits of a limb of :func:`to_fixed`'s f64 route: n of them sum to at
    most 2^FIXED_BITS, and a canonical limb is exact in f64."""
    return min(52, FIXED_BITS - math.ceil(math.log2(max(n, 1) + 1)))


class _ScatterSum(torch.autograd.Function):
    """:func:`scatter_sum` with the derivatives of ``index_add``: the
    backward gathers the gradient at the indices (as ``index_add``'s does,
    bit for bit), a forward-mode tangent is summed like the values."""

    @staticmethod
    def forward(size, index, src):
        return scatter_sum(size, index, src)

    @staticmethod
    def setup_context(ctx, inputs, output):
        size, index, _ = inputs
        ctx.size = size
        ctx.save_for_backward(index)
        ctx.save_for_forward(index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        return None, None, grad.index_select(0, index)

    @staticmethod
    def jvp(ctx, _size_t, _index_t, src_t):
        index, = ctx.saved_tensors
        return scatter_sum(ctx.size, index, src_t)


def bin_scalar(px, py, w, Nx: int, Ny: int, extent):
    """Accumulate plain weights into an (Ny, Nx) histogram (order-free,
    :func:`scatter_sum`)."""
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    return scatter_sum(Ny * Nx, yi * Nx + xi, wm).view(Ny, Nx)


def bin_xyzw_sorted(px, py, w, wl, Nx: int, Ny: int, extent):
    """XYZW binning via sort + prefix sum + boundary gather: the same image
    as :func:`bin_xyzw` up to the order of the sums, without a scatter."""
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    keys = yi * Nx + xi
    xyzw = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                        z_observer(wl) * wm, wm], dim=-1)

    order = torch.argsort(keys)
    ks = keys[order]
    csum = torch.cumsum(xyzw[order], dim=0)
    csum0 = torch.cat([torch.zeros((1, 4), dtype=csum.dtype, device=csum.device), csum], dim=0)
    edges = torch.searchsorted(ks, torch.arange(Ny * Nx + 1, device=ks.device))
    out = csum0[edges[1:]] - csum0[edges[:-1]]
    return out.view(Ny, Nx, 4)


def bin_xyzw_soft(px, py, w, wl, Nx: int, Ny: int, extent):
    """Differentiable XYZW binning by bilinear splatting.

    Each ray deposits into the 4 pixels around its continuous position with
    bilinear weights, so the image is a smooth function of the ray
    positions and autograd reaches ``px``, ``py`` and ``w`` (the hard
    histogram of :func:`bin_xyzw` is piecewise constant in position). Rays
    outside the extent deposit nothing; neighbours beyond the border are
    clamped onto it. The four deposits of every ray are summed in one
    order-free :func:`scatter_sum`; the gradient is that of ``index_add``.
    """
    x0, x1, y0, y1 = extent[0], extent[1], extent[2], extent[3]
    gx = (px - x0) / (x1 - x0) * Nx - 0.5
    gy = (py - y0) / (y1 - y0) * Ny - 0.5

    ix = torch.floor(gx)
    iy = torch.floor(gy)
    fx = gx - ix
    fy = gy - iy
    # clamp before the integer conversion: a far-off position must not wrap
    ix = torch.clamp(ix, -1.0, float(Nx)).to(torch.int64)
    iy = torch.clamp(iy, -1.0, float(Ny)).to(torch.int64)

    inside = (gx >= -0.5) & (gx <= Nx - 0.5) & (gy >= -0.5) & (gy <= Ny - 0.5)
    wm = torch.where(inside, w, 0.0)
    xyzw = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                        z_observer(wl) * wm, wm], dim=-1)

    index, deposits = [], []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi = torch.clamp(ix + dx, 0, Nx - 1)
            yi = torch.clamp(iy + dy, 0, Ny - 1)
            index.append(yi * Nx + xi)
            deposits.append(xyzw * (wx * wy)[:, None])
    return _ScatterSum.apply(Ny * Nx, torch.cat(index), torch.cat(deposits)).view(Ny, Nx, 4)


def histogram_1d(x, w, N: int, x0, x1):
    """Weighted 1D histogram with inclusive upper edge (spectrum render),
    order-free (:func:`scatter_sum`). Values outside [x0, x1] go to bin 0
    with weight 0."""
    fi = torch.floor(N / (x1 - x0) * (x - x0))
    fi = torch.where(x == x1, float(N - 1), fi)
    inside = (fi >= 0) & (fi < N)
    wm = torch.where(inside, w, 0.0)
    xi = torch.where(inside, fi, 0.0).to(torch.int64)
    return scatter_sum(N, xi, wm)
