"""Detector binning: scatter-add of observer-weighted ray hits into XYZW
image tiles (plain PyTorch).

Counterpart of ``optrace_tpu/ops/binning.py`` (``binning_indices_2d`` and
``bin_xyzw``). :func:`bin_xyzw` is the plain version that the CUDA kernel
in :mod:`.cuda_binning` is held against.
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
