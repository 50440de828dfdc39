"""Surface base class — host-side scene description over the functional core.

Counterpart of ``optrace_tpu/geometry/surface/surface.py``: the same method
contract (``values``/``_values``/``mask``/``normals``/``find_hit``/``edge``/
``plotting_mesh``/``flip``/``rotate``/``move_to``), C_EPS/N_EPS semantics,
radial edge continuation, and "Broken sequentiality" bookkeeping.

All numerics delegate to the pure tensor functions in
:mod:`optrace_tpu_torch.ops.geom`; the *same* functions run in the trace, so
the user-facing API and the hot path cannot drift apart. The user API
accepts and returns numpy arrays and evaluates on the CPU in f64.
``find_hit`` here exists for API/tests parity — the trace engine never
calls it per-surface.
"""

from typing import Any

import numpy as np
import torch

from ...ops import geom
from ...utils.base_class import BaseClass
from ...utils.property_checker import PropertyChecker as pc
from ...utils.warnings import warning


def _t64(a):
    """Host data as a CPU f64 tensor (the host API's working type)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class Surface(BaseClass):

    C_EPS: float = geom.C_EPS
    N_EPS: float = geom.N_EPS

    rotational_symmetry: bool = False

    def __init__(self, r: float, **kwargs) -> None:
        self._lock = False
        self.pos = np.asarray([0., 0., 0.], dtype=np.float64)
        self.r = r
        self.parax_roc = None
        self.z_min, self.z_max = np.nan, np.nan
        super().__init__(**kwargs)

    # ------------------------------------------------------------------
    # state

    def is_flat(self) -> bool:
        """Whether the surface has no extent in z-direction."""
        return self.z_max == self.z_min

    @property
    def info(self) -> str:
        return (f"{type(self).__name__}, pos = [{self.pos[0]:.5g} mm, {self.pos[1]:.5g} mm, "
                f"{self.pos[2]:.5g} mm], r = {self.r:.5g} mm")

    @property
    def extent(self):
        """(x0, x1, y0, y1, z0, z1) bounding box."""
        return (*(self.r * np.array([-1, 1, -1, 1]) + self.pos[:2].repeat(2)),
                self.z_min, self.z_max)

    @property
    def ds(self) -> float:
        """z-extent of the surface."""
        return float(self.z_max - self.z_min)

    @property
    def dn(self) -> float:
        """thickness between center z-position and lowest surface point."""
        return float(self.pos[2] - self.z_min)

    @property
    def dp(self) -> float:
        """thickness between highest surface point and center z-position."""
        return float(self.z_max - self.pos[2])

    def move_to(self, pos) -> None:
        """Move the surface center to an absolute 3D position."""
        self._lock = False
        pos = np.asarray(pos, dtype=np.float64)
        pc.check_finite("pos", pos)
        self.z_min += pos[2] - self.pos[2]
        self.z_max += pos[2] - self.pos[2]
        self.pos = pos
        self.lock()

    # ------------------------------------------------------------------
    # geometry contract (subclasses override _sag / mask / normals / hits)

    def _sag(self, x, y):
        """Relative sag z(x, y) on tensors. Flat by default."""
        return torch.zeros_like(x)

    def _values(self, x, y) -> np.ndarray:
        """Relative, unmasked surface values (host numpy in and out)."""
        x = np.asarray(x, dtype=np.float64)
        return self._sag(_t64(x), _t64(y)).numpy().reshape(x.shape)

    def values(self, x, y) -> np.ndarray:
        """Absolute surface values with radial edge continuation outside the
        mask."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if self.is_flat():
            return np.broadcast_to(self.z_max, x.shape).copy()

        inside = self.mask(x, y)
        xr, yr = x - self.pos[0], y - self.pos[1]
        z = self.pos[2] + self._values(xr, yr)
        re = self.r - self.N_EPS
        if self.rotational_symmetry:
            z_edge = self.pos[2] + float(self._values(np.array([re]), np.array([0.]))[0])
            z_out = np.broadcast_to(z_edge, x.shape)
        else:
            phi = np.arctan2(yr, xr)
            z_out = self.pos[2] + self._values(re * np.cos(phi), re * np.sin(phi))
        return np.where(inside, z, z_out)

    def mask(self, x, y) -> np.ndarray:
        """Definition region (absolute coordinates)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        return geom.mask_circle(_t64(x - self.pos[0]), _t64(y - self.pos[1]), self.r).numpy()

    def normals(self, x, y) -> np.ndarray:
        """Unit surface normals at (x, y); [0,0,1] outside the mask
       ."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if self.is_flat():
            return np.broadcast_to([0., 0., 1.], (x.shape[0], 3)).copy()
        xr, yr = x - self.pos[0], y - self.pos[1]
        n = self._normals_rel(_t64(xr), _t64(yr)).numpy().copy()
        m = self.mask(x, y)
        n[~m] = [0., 0., 1.]
        return n

    def _normals_rel(self, x, y, sag=None):
        """Tensor normals in relative coords; default: the exact normal of
        the sag by forward-mode differentiation (``geom.normal_numeric``).
        ``sag`` is ``_sag`` as the caller evaluates it (the trace counts
        its evaluations), ``_sag`` itself by default."""
        return geom.normal_numeric(sag or self._sag, x, y)

    # ------------------------------------------------------------------
    # hit finding (host API; the trace engine uses the compiled kernels)

    def _hit_t(self, o, s):
        """Tensor hit solve in relative coordinates → (t, valid, ill).

        Default: flat-plane hit for flat surfaces, the bracketed numeric
        solve over the sag for curved ones; subclasses with a closed form
        bring their own.
        """
        if self.is_flat():
            t = geom.hit_plane(o, s)
            valid = torch.isfinite(t) & (t >= -geom.C_EPS)
            return t, valid, torch.zeros(t.shape, dtype=torch.bool)
        z0 = self.z_min - self.pos[2]
        z1 = self.z_max - self.pos[2]
        return geom.hit_newton(self._sag, o, s, z0, z1)

    def find_hit(self, p, s, where=None):
        """Ray-surface intersection (host numpy in and out, f64 on the CPU).

        :return: (p_hit (N,3), is_hit (N,), ill bool array)
        """
        p = np.asarray(p, dtype=np.float64)
        s = np.asarray(s, dtype=np.float64)
        o = _t64(p - self.pos)
        sj = _t64(s)

        t, valid, ill = self._hit_t(o, sj)
        z_max_rel = (self.z_max - self.pos[2]) if np.isfinite(self.z_max) else 0.0
        t2, ok, broken = geom.clamp_abnormal(o, sj, t, valid, z_max_rel)

        t2 = t2.numpy()
        p_hit = p + s * t2[:, None]
        is_hit = np.asarray(self.mask(p_hit[:, 0], p_hit[:, 1])) & ok.numpy()

        if (nbrok := int(torch.count_nonzero(broken))) > 0:
            warning(f"Broken sequentiality. {nbrok} rays start behind the current surface. "
                    "The simulation results for these rays are most likely wrong. Check the geometry.")

        where_ = where if where is not None else slice(None)
        return p_hit[where_], is_hit[where_], ill.numpy()[where_]

    # ------------------------------------------------------------------
    # sampling/plotting helpers

    def edge(self, nc: int):
        """(x, y, z) arrays tracing the outer edge."""
        if nc < 20:
            raise ValueError("Expected at least nc=20")
        theta = np.linspace(-3 / 4 * np.pi, 5 / 4 * np.pi, nc)
        xd = self.r * np.cos(theta)
        yd = self.r * np.sin(theta)
        zd = self._values(xd, yd)
        return xd + self.pos[0], yd + self.pos[1], zd + self.pos[2]

    def plotting_mesh(self, N: int):
        """2D plotting mesh (X, Y, Z), nan outside the mask
       ."""
        if N < 10:
            raise ValueError("Expected at least N=10.")

        if self.rotational_symmetry:
            R, Phi = np.mgrid[0:self.r:N * 1j, 0:2 * np.pi:N * 1j]
            R = np.sqrt(R / self.r) * self.r
            rs = R / self.r * 2 - 1
            R = (((1 - rs ** 6) * rs + rs ** 6 * np.tanh(4 * rs) / np.tanh(4)) + 1) / 2 * self.r
            X, Y = R * np.cos(Phi), R * np.sin(Phi)
            z = self._values(X.ravel(), Y.ravel()).copy()
        else:
            Y, X = np.mgrid[-self.r:self.r:N * 1j, -self.r:self.r:N * 1j]
            R = np.sqrt(X ** 2 + Y ** 2)
            Phi = np.arctan2(Y, X)
            outside = R >= self.r
            z = self._values(X.ravel(), Y.ravel())
            z[outside.ravel()] = self._values(self.r * np.cos(Phi[outside]), self.r * np.sin(Phi[outside]))
            X[outside] = self.r * np.cos(Phi[outside])
            Y[outside] = self.r * np.sin(Phi[outside])

        m = self.mask(X.ravel() + self.pos[0], Y.ravel() + self.pos[1])
        z = np.where(m, z, np.nan)
        return X + self.pos[0], Y + self.pos[1], z.reshape(X.shape) + self.pos[2]

    def _find_bounds(self):
        """Estimate (z_min, z_max) by sunflower + edge sampling
       ."""
        N = 50000
        ind = np.arange(N, dtype=np.float64)
        r = np.sqrt(ind / N) * self.r
        phi = 2 * np.pi * (1 + 5 ** 0.5) / 2 * ind
        rcos, rsin = r * np.cos(phi), r * np.sin(phi)
        vals = self._values(rcos, rsin).astype(np.float64)
        m = np.asarray(self.mask(rcos + self.pos[0], rsin + self.pos[1]))
        vals = np.where(m, vals, np.nan)

        xe, ye, ve = self.edge(3001)
        ve = ve - self.pos[2]
        me = np.asarray(self.mask(xe, ye))
        ve = np.where(me, ve, np.nan)

        z_min = np.nanmin([np.nanmin(vals), np.nanmin(ve)])
        z_max = np.nanmax([np.nanmax(vals), np.nanmax(ve)])
        return float(z_min), float(z_max)

    # ------------------------------------------------------------------
    def flip(self) -> None:
        """Flip the surface around the x-axis (default: only valid flat)."""
        assert self.is_flat()

    def rotate(self, angle: float) -> None:
        """Rotate the surface around the z-axis (angle in degrees)."""
        assert self.rotational_symmetry

    @staticmethod
    def _rotate_rc(x, y, alpha: float):
        if alpha:
            return x * np.cos(alpha) - y * np.sin(alpha), x * np.sin(alpha) + y * np.cos(alpha)
        return x, y

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if key == "r":
            pc.check_type(key, val, (float, int))
            val = float(val)
            pc.check_above(key, val, 0)
        elif key == "parax_roc" and val is not None:
            pc.check_type(key, val, (float, int))
            val = float(val)
        super().__setattr__(key, val)
