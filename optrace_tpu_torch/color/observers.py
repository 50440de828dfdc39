"""CIE 1931 2° standard observer colour-matching functions.

Data: CIE 2018 1 nm tables (DOI:10.25039/CIE.DS.xvudnb9b), stored in
``resources/cie_data.npz``. Linear interpolation, zero outside the
tabulated range. Counterpart of ``optrace_tpu/color/observers.py``.

A torch tensor is evaluated on its device in its dtype; anything else is
host data and is evaluated with numpy.
"""

import pathlib

import numpy as np
import torch

_RES = pathlib.Path(__file__).resolve().parent.parent / "resources" / "cie_data.npz"

with np.load(_RES, allow_pickle=False) as _d:
    _OBS_WL = np.asarray(_d["observer_wl"], dtype=np.float32)      # (n,)
    _OBS_XYZ = np.asarray(_d["observer_xyz"], dtype=np.float32)    # (3, n)


def observers():
    """Return (wl, xbar, ybar, zbar) raw 1 nm observer tables as numpy."""
    return _OBS_WL, _OBS_XYZ[0], _OBS_XYZ[1], _OBS_XYZ[2]


_WL0 = float(_OBS_WL[0])
_WL1 = float(_OBS_WL[-1])
# zero-padded table so index clamping also zeroes out-of-range wavelengths
_OBS_PAD = np.pad(_OBS_XYZ, ((0, 0), (1, 1)))
_TABLES = {}     # (device, dtype) -> (3, n+2) tensor


def observer_table(device, dtype=torch.float32):
    """The zero-padded (3, n+2) observer table on ``device`` together with
    the wavelength of its first unpadded entry and of its last one."""
    key = (torch.device(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(_OBS_PAD, dtype=dtype, device=key[0]).contiguous()
    return _TABLES[key], _WL0, _WL1


def observer_bound() -> float:
    """The largest value of the three observer functions, or 1 if that is
    larger: a bound of every channel of an XYZW value per unit weight."""
    return max(1.0, float(_OBS_PAD.max()))


def _interp(wl, row: int):
    """Uniform-grid linear interpolation (1 nm steps): direct index
    arithmetic instead of a binary search — the observer lookup sits on
    the per-ray hot path of detector binning."""
    n = _OBS_PAD.shape[1]
    if isinstance(wl, torch.Tensor):
        table = observer_table(wl.device, wl.dtype)[0][row]
        g = wl - _WL0
        idx = torch.floor(g)
        frac = g - idx
        # +1 accounts for the zero padding at the front
        i0 = torch.clamp(idx.to(torch.int64) + 1, 0, n - 2)
        inside = (g >= 0) & (wl <= _WL1)
        return torch.where(inside, table[i0] * (1.0 - frac) + table[i0 + 1] * frac, 0.0)
    wl = np.asarray(wl)
    g = wl - _WL0
    idx = np.floor(g)
    frac = g - idx
    i0 = np.clip(idx.astype(np.int32) + 1, 0, n - 2)
    table = _OBS_PAD[row]
    inside = (g >= 0) & (wl <= _WL1)
    return np.where(inside, table[i0] * (1.0 - frac) + table[i0 + 1] * frac, 0.0)


def x_observer(wl):
    """CIE 1931 x̄(λ), linearly interpolated; zero outside the table."""
    return _interp(wl, 0)


def y_observer(wl):
    """CIE 1931 ȳ(λ)."""
    return _interp(wl, 1)


def z_observer(wl):
    """CIE 1931 z̄(λ)."""
    return _interp(wl, 2)
