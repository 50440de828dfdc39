"""Surfaces defined by measured/sampled height data (counterpart of
``optrace_tpu/geometry/surface/data_surface.py``).

An order-4 spline is fitted on the host with scipy (f64 coefficients) and
evaluated on tensors with the de Boor kernels of
:mod:`optrace_tpu_torch.ops.bspline`: the sag values of the scipy spline
(to evaluation precision), C³-smooth, with exact spline partial derivatives
for the normals. No dense-grid resampling.
"""

import numpy as np
import torch
import scipy.interpolate

from .surface import Surface
from ...ops import geom
from ...ops.bspline import Spline1D, Spline2D
from ...utils.property_checker import PropertyChecker as pc
from ...utils.warnings import warning


class DataSurface2D(Surface):

    rotational_symmetry: bool = False
    _1D: bool = False

    def __init__(self, r: float, data, parax_roc: float = None, **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)

        self._sign = 1.0
        self._angle = 0.0
        self.parax_roc = parax_roc

        pc.check_type("data", data, (np.ndarray, list))
        Z = np.asarray(data, dtype=np.float64).copy()
        pc.check_finite("data", Z)

        nx = Z.shape[0]
        if nx < 50:
            raise ValueError("For a good surface representation 'data' should have "
                             "at least 50 values per dimension")
        if nx < 200:
            warning(f"{type(self).__name__}: At least 200 values per dimension are advised "
                    f"for a 'data' matrix, but got {nx}.")

        if self._1D:
            if Z.ndim != 1:
                raise ValueError("data array needs to have exactly one dimension.")
            # remove the first-value offset; the center offset is removed below
            Z -= Z[0]
            r0 = np.linspace(0, r, nx)
            # mirror around r=0 so the fit is smooth and even at the center
            r2 = np.concatenate((-np.flip(r0[1:]), r0))
            z2 = np.concatenate((np.flip(Z[1:]), Z))
            self._spline = Spline1D(scipy.interpolate.InterpolatedUnivariateSpline(r2, z2, k=4))
            self._offset = float(self._spline(torch.zeros(1, dtype=torch.float64))[0])

            rn = np.linspace(0, r, 10000)
            zn = self._values(rn, np.zeros_like(rn))
            self.z_min, self.z_max = float(np.min(zn)), float(np.max(zn))
            z_range0 = float(np.ptp(Z))
        else:
            if Z.ndim != 2 or Z.shape[0] != Z.shape[1]:
                raise ValueError("data needs to be a square 2D matrix.")
            # remove the central data offset before fitting
            if nx % 2:
                Z -= Z[nx // 2, nx // 2]
            else:
                Z -= np.mean(Z[nx // 2 - 1:nx // 2 + 1, nx // 2 - 1:nx // 2 + 1])

            xy = np.linspace(-r, r, nx)
            self._spline = Spline2D(scipy.interpolate.RectBivariateSpline(xy, xy, Z, kx=4, ky=4))
            zero = torch.zeros(1, dtype=torch.float64)
            self._offset = float(self._spline(zero, zero)[0])

            self.z_min, self.z_max = self._find_bounds()
            X, Y = np.meshgrid(xy, xy)
            M = (X ** 2 + Y ** 2) <= r ** 2
            z_range0 = float(np.max(Z.T[M]) - np.min(Z.T[M]))

        # interpolation may overshoot the data z-range
        z_range1 = (self.z_max - self.z_min)
        if abs(z_range0 - z_range1) > geom.N_EPS and z_range0 > 0:
            z_change = (z_range1 - z_range0) / z_range0
            add = (" WARNING: Deviations this high can be due to noise or abrupt changes"
                   " in the data. DO NOT USE SUCH SURFACES HERE.") if z_change > 0.05 else ""
            warning(f"{type(self).__name__}: Due to spline interpolation the z_range of the "
                    f"surface has increased from {z_range0:.9g} to {z_range1:.9g}, "
                    f"a change of {z_change * 100:.5g}%.{add}")

        self.z_min += self.pos[2]
        self.z_max += self.pos[2]
        self.lock()

    # ------------------------------------------------------------------
    # tensor geometry contract

    def _sag(self, x, y):
        """Relative sag: rotate back, mirror y for flipped surfaces, negate z
        (z = sign·(spline(x, sign·y) − offset))."""
        if self._1D:
            rq = torch.sqrt(x * x + y * y)
            return self._sign * (self._spline(rq) - self._offset)
        if self._angle:
            c, s = np.cos(-self._angle), np.sin(-self._angle)
            x, y = x * c - y * s, x * s + y * c
        z = self._spline(x, self._sign * y)
        return self._sign * (z - self._offset)

    def _normals_rel(self, x, y, sag=None):
        """Exact spline-derivative normals (no evaluation of the sag, so
        ``sag`` is not used)."""
        if self._1D:
            rq = torch.sqrt(x * x + y * y)
            mr = self._sign * self._spline.deriv(rq)
            safe_r = torch.where(rq > geom.N_EPS, rq, 1.0)
            m_over_r = torch.where(rq > geom.N_EPS, mr / safe_r, 0.0)
            return geom.normal_from_radial_deriv(x, y, m_over_r)
        if self._angle:
            c, s = np.cos(-self._angle), np.sin(-self._angle)
            x, y = x * c - y * s, x * s + y * c
        ym = self._sign * y
        dx = self._spline.deriv_x(x, ym) * self._sign
        dy = self._spline.deriv_y(x, ym)
        if self._angle:
            c, s = np.cos(self._angle), np.sin(self._angle)
            dx, dy = dx * c - dy * s, dx * s + dy * c
        n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-1)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True)

    # ------------------------------------------------------------------
    def flip(self) -> None:
        """Flip around the x-axis."""
        self._lock = False
        self._sign *= -1.0
        if self.parax_roc is not None:
            self.parax_roc *= -1
        a = self.pos[2] - (self.z_max - self.pos[2])
        b = self.pos[2] - (self.z_min - self.pos[2])
        self.z_min, self.z_max = a, b
        self.lock()

    def rotate(self, angle: float) -> None:
        if not self.rotational_symmetry:
            self._lock = False
            self._angle += np.deg2rad(angle)
            self.lock()


class DataSurface1D(DataSurface2D):
    """Radial height profile over np.linspace(0, r, n), mirrored for an
    even, C³-smooth center."""

    rotational_symmetry: bool = True
    _1D: bool = True

    def __init__(self, r: float, data, parax_roc: float = None, **kwargs) -> None:
        prof = np.asarray(data, dtype=np.float64)
        if prof.ndim != 1:
            raise ValueError("data needs to be a 1D array for DataSurface1D.")
        super().__init__(r, prof, parax_roc=parax_roc, **kwargs)
