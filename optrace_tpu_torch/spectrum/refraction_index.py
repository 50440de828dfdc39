"""Dispersive refractive index models.

Counterpart of ``optrace_tpu/spectrum/refraction_index.py``:
18 model types (Cauchy, Conrady, Constant, Data, Abbe estimate, Sellmeier
1-5, Herzberger, Schott, Extended/2/3, Handbook of Optics 1/2, Function),
n ≥ 1 enforcement, Abbe number utilities.

The evaluation core :func:`eval_dispersion` is a pure function of
(model, coefficients, wavelength): a torch tensor of wavelengths is
evaluated on its device in its dtype (coefficients may be tensors that need
a gradient), host inputs are evaluated with numpy in f64.
"""

from typing import Any

import numpy as np
import torch

from .spectrum import Spectrum
from .. import color
from ..utils.property_checker import PropertyChecker as pc

# default Abbe lines F, d, C (same values as presets.spectral_lines.FdC,
# duplicated here to avoid a circular import through the presets package)
_FdC_LINES = [486.1327, 587.5618, 656.272]


COEFF_COUNT = {"Cauchy": 4, "Conrady": 3, "Sellmeier1": 6, "Sellmeier2": 5, "Sellmeier3": 8,
               "Sellmeier4": 5, "Sellmeier5": 10, "Herzberger": 6, "Extended": 8, "Extended2": 8,
               "Handbook of Optics 1": 4, "Handbook of Optics 2": 4, "Schott": 6, "Extended3": 9}
"""number of coefficients per dispersion model"""


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def eval_dispersion(n_type: str, coeff, wl):
    """Evaluate a coefficient-based dispersion model at wavelengths wl (nm).

    Formula set of the standard optical-glass-catalog models.
    """
    c_list = [coeff[i] for i in range(COEFF_COUNT[n_type])] if not isinstance(coeff, (list, tuple)) else list(coeff)
    wl_ = wl if isinstance(wl, torch.Tensor) else np.asarray(wl)
    c = c_list
    l2 = (wl_ * 1e-3) ** 2    # λ² in µm²

    if n_type == "Conrady":
        l = wl_ * 1e-3
        return c[0] + c[1] / l + c[2] / l ** 3.5
    if n_type == "Cauchy":
        return c[0] + c[1] / l2 + c[2] / l2 ** 2 + c[3] / l2 ** 3
    if n_type == "Sellmeier1":
        return _sqrt(1 + c[0] * l2 / (l2 - c[1]) + c[2] * l2 / (l2 - c[3]) + c[4] * l2 / (l2 - c[5]))
    if n_type == "Sellmeier2":
        return _sqrt(1 + c[0] + c[1] * l2 / (l2 - c[2] ** 2) + c[3] / (l2 - c[4] ** 2))
    if n_type == "Sellmeier3":
        return _sqrt(1 + c[0] * l2 / (l2 - c[1]) + c[2] * l2 / (l2 - c[3])
                        + c[4] * l2 / (l2 - c[5]) + c[6] * l2 / (l2 - c[7]))
    if n_type == "Sellmeier4":
        return _sqrt(c[0] + c[1] * l2 / (l2 - c[2]) + c[3] * l2 / (l2 - c[4]))
    if n_type == "Sellmeier5":
        return _sqrt(1 + c[0] * l2 / (l2 - c[1]) + c[2] * l2 / (l2 - c[3]) + c[4] * l2 / (l2 - c[5])
                        + c[6] * l2 / (l2 - c[7]) + c[8] * l2 / (l2 - c[9]))
    if n_type == "Schott":
        return _sqrt(c[0] + c[1] * l2 + c[2] / l2 + c[3] / l2 ** 2 + c[4] / l2 ** 3 + c[5] / l2 ** 4)
    if n_type == "Herzberger":
        L = 1 / (l2 - 0.028)
        return c[0] + c[1] * L + c[2] * L ** 2 + c[3] * l2 + c[4] * l2 ** 2 + c[5] * l2 ** 3
    if n_type == "Handbook of Optics 1":
        return _sqrt(c[0] + c[1] / (l2 - c[2]) - c[3] * l2)
    if n_type == "Handbook of Optics 2":
        return _sqrt(c[0] + c[1] * l2 / (l2 - c[2]) - c[3] * l2)
    if n_type == "Extended":
        return _sqrt(c[0] + c[1] * l2 + c[2] / l2 + c[3] / l2 ** 2 + c[4] / l2 ** 3
                        + c[5] / l2 ** 4 + c[6] / l2 ** 5 + c[7] / l2 ** 6)
    if n_type == "Extended2":
        return _sqrt(c[0] + c[1] * l2 + c[2] / l2 + c[3] / l2 ** 2 + c[4] / l2 ** 3
                        + c[5] / l2 ** 4 + c[6] * l2 ** 2 + c[7] * l2 ** 3)
    if n_type == "Extended3":
        return _sqrt(c[0] + c[1] * l2 + c[2] * l2 ** 2 + c[3] / l2 + c[4] / l2 ** 2
                        + c[5] / l2 ** 3 + c[6] * l2 ** 4 + c[7] * l2 ** 5 + c[8] / l2 ** 6)
    raise ValueError(f"Unknown dispersion model '{n_type}'.")


def eval_abbe(n_center: float, V: float, lines, wl):
    """Estimated index curve from center index and Abbe number V: a
    two-term model n = A + B/(λ²−d), d between Cauchy (0) and Herzberger
    (0.028) ."""
    if isinstance(wl, torch.Tensor):
        # line wavelengths as 0-dim tensors of the working dtype: A and B
        # are then rounded exactly as the per-ray arithmetic is
        wl_ = wl
        l = 1e-3 * torch.as_tensor(np.asarray(lines), dtype=wl.dtype)
    else:
        wl_ = np.asarray(wl)
        l = 1e-3 * np.asarray(lines)
    d = 0.014
    l2 = (wl_ * 1e-3) ** 2
    B = (n_center - 1) / V / (1 / (l[0] ** 2 - d) - 1 / (l[2] ** 2 - d))
    A = n_center - B / (l[1] ** 2 - d)
    return A + B / (l2 - d)


class RefractionIndex(Spectrum):

    n_types: list = ["Abbe", "Cauchy", "Conrady", "Constant", "Data", "Extended", "Extended2",
                     "Extended3", "Function", "Handbook of Optics 1", "Handbook of Optics 2",
                     "Sellmeier1", "Sellmeier2", "Sellmeier3", "Sellmeier4",
                     "Sellmeier5", "Herzberger", "Schott"]
    spectrum_types: list = n_types
    coeff_count = COEFF_COUNT

    quantity: str = "Refraction Index n"
    unit: str = ""

    def __init__(self, n_type: str = "Constant", n: float = 1.0, coeff: list = None,
                 lines=None, V: float = None, **kwargs) -> None:
        self.spectrum_type = n_type
        self.coeff = coeff
        self.V = V
        lines = lines if lines is not None else _FdC_LINES
        super().__init__(n_type, val=n, lines=lines, **kwargs)
        self._new_lock = True

    # ------------------------------------------------------------------
    def __call__(self, wl):
        """Refractive index at wavelengths wl (nm): a tensor in, a tensor
        out; host data in, numpy f64 out."""
        is_t = isinstance(wl, torch.Tensor)
        wl_ = wl if is_t else np.asarray(wl)
        st = self.spectrum_type

        if st not in ("Constant", "Data", "Function", "Abbe") and self.coeff is None:
            raise TypeError(f"coefficient variable 'coeff' needs to be provided for n_type='{st}'.")

        if st == "Abbe":
            ns = eval_abbe(self.val, self.V, self.lines, wl_)
        elif st == "Constant":
            ns = torch.full_like(wl_, self.val) if is_t \
                else np.broadcast_to(np.asarray(self.val, wl_.dtype), wl_.shape)
        elif st == "Data":
            if wl_.numel() if is_t else wl_.size:
                wlmin, wlmax = float(wl_.min()), float(wl_.max())
                if wlmin < self._wls[0] or wlmax > self._wls[-1]:
                    raise RuntimeError(f"Wavelength range [{wlmin:.5g}, {wlmax:.5g}] larger than data "
                                       f"range [{self._wls[0]}, {self._wls[-1]}] for this material.")
            if is_t:
                # clamp instead of extrapolating (outside access already
                # rejected above); uniform wls grid → index-arithmetic interp
                from ..ops.interp import uniform_interp
                ns = uniform_interp(wl_, self._vals, float(self._wls[0]),
                                    float(self._wls[1] - self._wls[0]),
                                    left=float(self._vals[0]), right=float(self._vals[-1]))
            else:
                ns = np.interp(wl_, self._wls, self._vals)
        elif st == "Function":
            pc.check_callable("RefractionIndex.func", self.func)
            ns = self.func(wl_, **self.func_args)
            ns = ns if is_t else np.asarray(ns)
        else:
            ns = eval_dispersion(st, self.coeff, wl_)

        # n >= 1 is checked on host data only: on a device tensor the check
        # would force a synchronisation into every trace step
        if not is_t and np.size(ns):
            flat = np.asarray(ns).ravel()
            wlb = int(np.argmin(flat))
            if flat[wlb] < 1:
                raise RuntimeError(f"Refraction index below 1 with value {flat[wlb]:.4g} "
                                   f"at {np.asarray(wl_).ravel()[wlb % max(np.asarray(wl_).size, 1)]:.4g}nm.")
        return ns

    # ------------------------------------------------------------------
    def abbe_number(self, lines: list = None) -> float:
        """Abbe number V = (n_center − 1)/(n_short − n_long)."""
        lines = lines if lines is not None else self.lines
        n = np.asarray(self(np.asarray(lines, dtype=np.float64)))
        ns, nc, nl = float(n[0]), float(n[1]), float(n[2])
        return float((nc - 1) / (ns - nl)) if ns != nl else float(np.inf)

    def is_dispersive(self) -> bool:
        """Whether the index varies with wavelength (finite Abbe number)."""
        return bool(np.isfinite(self.abbe_number()))

    # ------------------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return False
        if self is other:
            return True
        if self.spectrum_type == "Data" and other.spectrum_type == "Data":
            return (np.array_equal(self._wls, other._wls) and np.array_equal(self._vals, other._vals)
                    and self.quantity == other.quantity and self.unit == other.unit)
        if self.spectrum_type != "Data":
            return self.crepr() == other.crepr()
        return False

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    def __setattr__(self, key, val) -> None:
        if key == "val":
            pc.check_type(key, val, (int, float))
            pc.check_finite(key, val)
            pc.check_not_below(key, val, 1)
        elif key == "coeff" and val is not None:
            pc.check_type(key, val, list)
            cnt = COEFF_COUNT[self.spectrum_type]
            if len(val) != cnt:
                raise ValueError(f"{key} needs exactly {cnt} coefficients for mode "
                                 f"{self.spectrum_type}, but got {len(val)}.")
            super().__setattr__(key, list(val))
            return
        elif key == "_vals" and val is not None:
            if np.min(val) < 1:
                raise ValueError("all vals values need to be at least 1.")
        elif key == "lines" and isinstance(val, (list, np.ndarray)):
            if len(val) != 3:
                raise ValueError("Property 'lines' for n_type='Abbe' needs exactly 3 elements")
            if not val[0] < val[1] < val[2]:
                raise ValueError("The values of property 'lines' need to be ascending.")
        elif key == "func" and callable(val):
            wls = np.asarray(color.wavelengths(1000))
            n = np.asarray(val(wls, **self.func_args))
            if n.min() < 1:
                raise ValueError("Function func needs to output values >= 1 over the whole visible range.")
        elif key == "V" and val is not None:
            pc.check_type(key, val, (float, int))
            pc.check_above(key, val, 0)
            pc.check_finite(key, val)
        super().__setattr__(key, val)
