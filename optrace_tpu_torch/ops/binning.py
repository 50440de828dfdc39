"""Detector binning: scatter-add of observer-weighted ray hits into XYZW
image tiles (plain PyTorch).

Counterpart of ``optrace_tpu/ops/binning.py``. :func:`bin_xyzw` is the plain
version that the CUDA kernel in :mod:`.cuda_binning` is held against;
:func:`bin_scalar`, :func:`bin_xyzw_sorted` and :func:`histogram_1d` are
tensor functions on the device of their inputs. The bilinear
``bin_xyzw_soft`` arrives with the differentiable-design slice.
"""

import torch

from ..color.observers import x_observer, y_observer, z_observer


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


def bin_scalar(px, py, w, Nx: int, Ny: int, extent):
    """Accumulate plain weights into an (Ny, Nx) histogram."""
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    img = torch.zeros((Ny * Nx,), dtype=wm.dtype, device=wm.device)
    img.index_add_(0, yi * Nx + xi, wm)
    return img.view(Ny, Nx)


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


def histogram_1d(x, w, N: int, x0, x1):
    """Weighted 1D histogram with inclusive upper edge (spectrum render).
    Values outside [x0, x1] go to bin 0 with weight 0."""
    fi = torch.floor(N / (x1 - x0) * (x - x0))
    fi = torch.where(x == x1, float(N - 1), fi)
    inside = (fi >= 0) & (fi < N)
    wm = torch.where(inside, w, 0.0)
    xi = torch.where(inside, fi, 0.0).to(torch.int64)
    return torch.zeros((N,), dtype=wm.dtype, device=wm.device).index_add_(0, xi, wm)
