"""CIE standard illuminant spectral power distributions.

Data: CIE Colorimetry 3rd ed. (2004) tables plus the CIE LED illuminant set
(DOI:10.25039/CIE.DS.vgssnyfg), stored in ``resources/cie_data.npz``.
Linear interpolation of the 5 nm tables, zero outside each illuminant's
support. Counterpart of ``optrace_tpu/color/illuminants.py``.

A torch tensor is evaluated on its device in its dtype; anything else is
host data and is evaluated with numpy.
"""

import pathlib

import numpy as np
import torch

_RES = pathlib.Path(__file__).resolve().parent.parent / "resources" / "cie_data.npz"

with np.load(_RES, allow_pickle=False) as _d:
    _ILL_WL = np.asarray(_d["illuminant_wl"], dtype=np.float32)
    _ILL_NAMES = [str(n) for n in _d["illuminant_names"]]
    _ILL_SPDS = np.asarray(_d["illuminant_spds"], dtype=np.float32)

ILLUMINANT_NAMES = list(_ILL_NAMES)


def illuminant(name: str, wl):
    """Evaluate standard illuminant ``name`` at wavelengths ``wl`` (nm)."""
    is_t = isinstance(wl, torch.Tensor)
    if name == "E":
        return torch.full_like(wl, 100.0) if is_t \
            else np.full_like(np.asarray(wl, dtype=np.float32), 100.0)
    if name not in _ILL_NAMES:
        raise ValueError(f"Unknown illuminant '{name}'. Available: {ILLUMINANT_NAMES + ['E']}")
    spd = _ILL_SPDS[_ILL_NAMES.index(name)]
    valid = np.isfinite(spd)
    wls, vals = _ILL_WL[valid], spd[valid]
    if not is_t:
        return np.interp(np.asarray(wl), wls, vals, left=0.0, right=0.0)
    # the tables are uniform in wavelength: index-arithmetic interpolation
    from ..ops.interp import uniform_interp
    return uniform_interp(wl, vals, float(wls[0]), float(wls[1] - wls[0]))


def _make_named(name):
    def fn(wl):
        return illuminant(name, wl)
    fn.__name__ = f"{name.lower().replace('-', '_')}_illuminant"
    fn.__doc__ = f"Standard illuminant {name} SPD at wavelengths wl (nm)."
    return fn


# named convenience functions matching the reference color API
a_illuminant = _make_named("A")
c_illuminant = _make_named("C")
e_illuminant = _make_named("E")
d50_illuminant = _make_named("D50")
d55_illuminant = _make_named("D55")
d65_illuminant = _make_named("D65")
d75_illuminant = _make_named("D75")
f2_illuminant = _make_named("F2")
f7_illuminant = _make_named("F7")
f11_illuminant = _make_named("F11")
led_b1_illuminant = _make_named("LED-B1")
led_b2_illuminant = _make_named("LED-B2")
led_b3_illuminant = _make_named("LED-B3")
led_b4_illuminant = _make_named("LED-B4")
led_b5_illuminant = _make_named("LED-B5")
led_bh1_illuminant = _make_named("LED-BH1")
led_rgb1_illuminant = _make_named("LED-RGB1")
led_v1_illuminant = _make_named("LED-V1")
led_v2_illuminant = _make_named("LED-V2")
