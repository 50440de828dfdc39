"""User-defined surfaces from mathematical functions (counterpart of
``optrace_tpu/geometry/surface/function_surface.py``).

``func`` (and ``deriv_func``/``mask_func`` if given) take torch tensors and
return tensors, on the trace's device and in its dtype: the trace evaluates
them on the card, and the host API (``values``, ``normals``, ``mask``) calls
them with f64 tensors on the CPU. Write them with torch operations
(``torch.cos``, ``torch.exp``, arithmetic): a function that calls numpy or
``.item()`` cannot run on the card, and the numeric normals
(``geom.normal_numeric``, used when no ``deriv_func`` is given) cannot
differentiate it.
"""

from typing import Any, Callable

import copy as _copy
import numpy as np
import torch

from .surface import Surface
from ...ops import geom
from ...utils.property_checker import PropertyChecker as pc
from ...utils.warnings import warning


def _as_tensor(v, like):
    """A user function's result as a tensor of ``like``'s dtype and device
    (a number is filled on the device: no copy from the host)."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


class FunctionSurface2D(Surface):

    rotational_symmetry: bool = False
    _1D: bool = False

    def __init__(self, r: float,
                 func: Callable,
                 mask_func: Callable = None,
                 deriv_func: Callable = None,
                 func_args: dict = None,
                 mask_args: dict = None,
                 deriv_args: dict = None,
                 z_min: float = None,
                 z_max: float = None,
                 parax_roc: float = None,
                 **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)

        self._sign = 1.0
        self._angle = 0.0

        self.func = func
        self.mask_func = mask_func
        self.deriv_func = deriv_func
        self.func_args = _copy.deepcopy(func_args) if func_args else {}
        self.mask_args = _copy.deepcopy(mask_args) if mask_args else {}
        self.deriv_args = _copy.deepcopy(deriv_args) if deriv_args else {}
        self.parax_roc = parax_roc

        # offset so the surface center sits at z=0 relative coordinates
        self._offset = 0.0
        self._offset = float(self._values(np.array([0.]), np.array([0.]))[0])

        # z-bounds: probe unless provided
        z_min_p, z_max_p = self._find_bounds()
        if z_min is not None and z_max is not None:
            pc.check_type("z_min", z_min, (float, int))
            pc.check_type("z_max", z_max, (float, int))
            z_min, z_max = float(z_min), float(z_max)
            if abs(z_min - (self.pos[2] + z_min_p)) > 100 * self.N_EPS + 5 * (z_max_p - z_min_p) / 1000 \
                    or abs(z_max - (self.pos[2] + z_max_p)) > 100 * self.N_EPS + 5 * (z_max_p - z_min_p) / 1000:
                warning(f"Provided z-bounds [{z_min}, {z_max}] deviate from probed "
                        f"bounds [{self.pos[2] + z_min_p}, {self.pos[2] + z_max_p}].")
            self.z_min, self.z_max = z_min, z_max
        else:
            if z_min is not None or z_max is not None:
                warning("Provide both z_min and z_max, falling back to probed values.")
            self.z_min, self.z_max = self.pos[2] + z_min_p, self.pos[2] + z_max_p

        self.lock()

    # ------------------------------------------------------------------
    def _sag(self, x, y):
        if self._1D:
            vals = self.func(torch.sqrt(x * x + y * y), **self.func_args)
        else:
            xr, yr = self._rot_args(x, y)
            vals = self.func(xr, yr, **self.func_args)
        return self._sign * (_as_tensor(vals, x) - self._offset)

    def _rot_args(self, x, y):
        if self._angle:
            c, s = np.cos(-self._angle), np.sin(-self._angle)
            x, y = x * c - y * s, x * s + y * c
        if self._sign < 0:
            x = -x
        return x, y

    def _normals_rel(self, x, y, sag=None):
        """Normals from ``deriv_func``, or the exact normal of the sag
        (``sag``, ``_sag`` by default, as :meth:`Surface._normals_rel`)."""
        if self.deriv_func is not None:
            xr, yr = self._rot_args(x, y)
            if self._1D:
                r = torch.sqrt(x * x + y * y)
                m = _as_tensor(self.deriv_func(r, **self.deriv_args), x) * self._sign
                safe_r = torch.where(r > 0, r, 1.0)
                return geom.normal_from_radial_deriv(x, y, torch.where(r > 0, m / safe_r, 0.0))
            dx, dy = self.deriv_func(xr, yr, **self.deriv_args)
            dx = _as_tensor(dx, x) * self._sign
            dy = _as_tensor(dy, x) * self._sign
            if self._sign < 0:
                dx = -dx
            if self._angle:
                c, s = np.cos(self._angle), np.sin(self._angle)
                dx, dy = dx * c - dy * s, dx * s + dy * c
            n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-1)
            return n / torch.linalg.norm(n, dim=-1, keepdim=True)
        return geom.normal_numeric(sag or self._sag, x, y)

    def _mask_rel(self, x, y):
        """The user's ``mask_func`` at relative tensor coordinates (True
        where there is none); the trace and the host API both call it."""
        if self.mask_func is None:
            return torch.ones(x.shape, dtype=torch.bool, device=x.device)
        if self._1D:
            mf = self.mask_func(torch.sqrt(x * x + y * y), **self.mask_args)
        else:
            xr, yr = self._rot_args(x, y)
            mf = self.mask_func(xr, yr, **self.mask_args)
        return torch.as_tensor(mf, device=x.device).to(torch.bool)

    def mask(self, x, y) -> np.ndarray:
        m = super().mask(x, y)
        if self.mask_func is not None:
            xr = torch.as_tensor(np.asarray(x, dtype=np.float64) - self.pos[0])
            yr = torch.as_tensor(np.asarray(y, dtype=np.float64) - self.pos[1])
            m = m & self._mask_rel(xr, yr).numpy()
        return m

    def flip(self) -> None:
        self._lock = False
        self._sign *= -1.0
        if self.parax_roc is not None:
            self.parax_roc *= -1
        a = self.pos[2] - (self.z_max - self.pos[2])
        b = self.pos[2] + (self.pos[2] - self.z_min)
        self.z_min, self.z_max = a, b
        self.lock()

    def rotate(self, angle: float) -> None:
        self._lock = False
        self._angle += np.deg2rad(angle)
        self.lock()

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("mask_func", "deriv_func"):
            pc.check_none_or_callable(key, val)
        elif key == "func" and val is not None:
            pc.check_callable(key, val)
        super().__setattr__(key, val)


class FunctionSurface1D(FunctionSurface2D):
    """Radially symmetric function surface: func takes r = √(x²+y²)."""

    rotational_symmetry: bool = True
    _1D: bool = True
