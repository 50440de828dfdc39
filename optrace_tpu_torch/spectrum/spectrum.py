"""Base spectrum class.

Counterpart of ``optrace_tpu/spectrum/spectrum.py``: types
Monochromatic/Constant/Data/Lines/Rectangle/Gaussian/Function, host-side
validation at construction. ``__call__`` evaluates a torch tensor on its
device in its dtype (the trace), and any other input as host data in numpy.
"""

import copy as _copy
from typing import Callable

import numpy as np
import torch

from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc
from ..utils.global_options import global_options as go
from .. import color


class Spectrum(BaseClass):

    spectrum_types: list = ["Monochromatic", "Constant", "Data", "Lines",
                            "Rectangle", "Gaussian", "Function"]
    """possible spectrum types (subclasses override)"""

    unit: str = ""
    quantity: str = ""

    def __init__(self,
                 spectrum_type: str = "Gaussian",
                 val: float = 1.0,
                 lines=None,
                 line_vals=None,
                 wl: float = 550.0,
                 wl0: float = 400.0,
                 wl1: float = 600.0,
                 wls=None,
                 vals=None,
                 func: Callable = None,
                 mu: float = 550.0,
                 sig: float = 50.0,
                 unit: str = None,
                 quantity: str = None,
                 func_args: dict = None,
                 **kwargs) -> None:
        self.spectrum_type = spectrum_type
        self.lines = lines
        self.line_vals = line_vals
        self.func_args = func_args if func_args is not None else {}
        self.func = func

        self.wl, self.wl0, self.wl1 = wl, wl0, wl1
        self.val, self.mu, self.sig = val, mu, sig
        self._wls, self._vals = wls, vals

        self.unit = unit if unit is not None else type(self).unit
        self.quantity = quantity if quantity is not None else type(self).quantity

        super().__init__(**kwargs)
        self._new_lock = True

    # ------------------------------------------------------------------
    def is_continuous(self) -> bool:
        """Whether the spectrum is continuous (not Lines/Monochromatic)."""
        return self.spectrum_type not in ["Lines", "Monochromatic"]

    def __call__(self, wl):
        """Evaluate the spectrum at wavelengths ``wl`` (nm): a tensor in,
        a tensor out; host data in, numpy out."""
        if not self.is_continuous():
            raise RuntimeError(f"Can't call discontinuous spectrum_type '{self.spectrum_type}'")

        is_t = isinstance(wl, torch.Tensor)
        wl_ = wl if is_t else np.asarray(wl)
        st = self.spectrum_type

        if st == "Constant":
            if is_t:
                return torch.full_like(wl_, self.val)
            return np.broadcast_to(np.asarray(self.val, wl_.dtype), wl_.shape)

        if st == "Data":
            pc.check_type("Spectrum.wls", self._wls, (np.ndarray, list))
            pc.check_type("Spectrum.vals", self._vals, (np.ndarray, list))
            if not is_t:
                return np.interp(wl_, np.asarray(self._wls), np.asarray(self._vals),
                                 left=0.0, right=0.0)
            # wls validation enforces a uniform grid → index-arithmetic interp
            from ..ops.interp import uniform_interp
            return uniform_interp(wl_, self._vals,
                                  float(self._wls[0]), float(self._wls[1] - self._wls[0]),
                                  left=0.0, right=0.0)

        if st == "Rectangle":
            inside = (self.wl0 <= wl_) & (wl_ <= self.wl1)
            if is_t:
                return torch.where(inside, self.val, 0.0).to(wl_.dtype)
            return np.where(inside, self.val, 0.0)

        if st == "Gaussian":
            exp = torch.exp if is_t else np.exp
            return self.val * exp(-(wl_ - self.mu) ** 2 / (2 * self.sig ** 2))

        if st == "Function":
            pc.check_callable("Spectrum.func", self.func)
            out = self.func(wl_, **self.func_args)
            return out if is_t else np.asarray(out)

        raise RuntimeError(f"Unhandled spectrum_type '{st}'.")  # pragma: no cover

    def on_device(self, device, dtype=torch.float32):
        """``wl -> values`` for tensors of ``dtype`` on ``device``: the
        spectrum itself, or for tabulated data a function whose table is
        made on the device now, so that a call copies nothing from the host
        (what a trace step holds)."""
        if self.spectrum_type != "Data":
            return self
        from ..ops.interp import uniform_interp
        table = torch.as_tensor(np.asarray(self._vals), dtype=dtype, device=device)
        wl0, dwl = float(self._wls[0]), float(self._wls[1] - self._wls[0])
        return lambda wl: uniform_interp(wl, table, wl0, dwl, left=0.0, right=0.0)

    def get_desc(self, fallback: str = None) -> str:
        fallback = str(self.val) if self.spectrum_type == "Constant" else self.spectrum_type
        return super().get_desc(fallback=fallback)

    # ------------------------------------------------------------------
    def __setattr__(self, key, val) -> None:
        if key == "spectrum_type":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.spectrum_types)

        elif key in ("lines", "line_vals") and val is not None:
            pc.check_type(key, val, (list, np.ndarray))
            val2 = np.asarray(val, dtype=np.float32)
            pc.check_finite(key, val2)
            if val2.shape[0] == 0:
                raise ValueError(f"'{key}' can't be empty.")
            if key == "lines":
                if val2.min() < go.wavelength_range[0] or val2.max() > go.wavelength_range[1]:
                    raise ValueError(f"'lines' must be inside the visible range {go.wavelength_range}.")
                if len(np.unique(val2)) != len(val2):
                    raise ValueError("All elements inside of 'lines' must be unique.")
            if key == "line_vals" and val2.min() < 0:
                raise ValueError(f"line_vals must be all positive, but one value is {val2.min()}.")
            super().__setattr__(key, val2)
            return

        elif key == "func_args":
            pc.check_type(key, val, dict)
            super().__setattr__(key, _copy.deepcopy(val))
            return

        elif key in ("quantity", "unit"):
            pc.check_type(key, val, str)

        elif key == "func":
            pc.check_none_or_callable(key, val)
            if val is not None:
                wls = np.asarray(color.wavelengths(10000))
                T = np.asarray(val(wls, **self.func_args))
                if np.min(T) < 0 or np.max(T) <= 0:
                    raise RuntimeError("Function func needs to return positive values over the visible range.")

        elif key in ("_wls", "_vals") and val is not None:
            pc.check_type(key, val, (list, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if key == "_wls":
                pc.check_not_below("wls[0]", val2[0], go.wavelength_range[0])
                pc.check_not_above("wls[-1]", val2[-1], go.wavelength_range[1])
                d = np.diff(val2)
                if np.std(d) > 1e-4 or np.any(d <= 0) or (val2[1] - val2[0] < 1e-6):
                    raise ValueError("wls needs to be monotonically increasing with the same step size.")
            else:
                if val2.min() < 0:
                    raise ValueError(f"vals must be all positive, but one value is {val2.min()}")
            super().__setattr__(key, val2)
            return

        elif key in ("wl", "wl0", "wl1", "mu", "sig", "val"):
            pc.check_type(key, val, (int, float))
            val = float(val)
            if key in ("wl", "wl0", "wl1", "mu"):
                pc.check_not_below(key, val, go.wavelength_range[0])
                pc.check_not_above(key, val, go.wavelength_range[1])
            if key == "val":
                pc.check_above(key, val, 0)
            if key == "sig":
                pc.check_above(key, val, 0)

        super().__setattr__(key, val)
