"""Interpolation primitives for per-ray hot paths (torch tensors).

Every tabulated quantity in this package (observers, illuminants, Data
spectra/indices, resampled inverse CDFs) lives on a *uniform* grid, where
interpolation is pure index arithmetic instead of a per-ray binary search.
Counterpart of ``optrace_tpu/ops/interp.py``.
"""

import numpy as np
import torch


def uniform_interp(x, table, x0: float, dx: float, left=0.0, right=0.0):
    """Linear interpolation of ``table`` sampled at x0 + i·dx.

    Out-of-range queries return ``left``/``right``.
    """
    table = torch.as_tensor(table, dtype=x.dtype, device=x.device)
    n = table.shape[0]
    g = (x - x0) / dx
    idx = torch.clamp(torch.floor(g), 0, n - 2)
    # the fraction is taken from the clamped cell, so that a query exactly
    # on the last grid point gives the last table value
    frac = g - idx
    i0 = idx.to(torch.int64)
    v = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    v = torch.where(g < 0, left, v)
    v = torch.where(g > n - 1, right, v)
    return v


def invert_cdf_uniform(x: np.ndarray, cdf: np.ndarray, M: int = 4096) -> np.ndarray:
    """Resample an inverse CDF onto a uniform u-grid of M points (host
    side, numpy). Afterwards sampling is
    ``uniform_interp(u, table, 0, 1/(M-1))``."""
    return np.interp(np.linspace(0.0, 1.0, M), cdf, x)
