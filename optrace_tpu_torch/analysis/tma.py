"""Paraxial ray-transfer-matrix (ABCD) analysis.

Counterpart of ``optrace_tpu/analysis/tma.py``, the same f64 numpy code
(cardinal points, efl/bfl/ffl, powers + "_n" ophthalmic variants, optical
center, object/image conjugates, entrance/exit pupils around a stop), built
on a different engine: the optical system is flattened once into a *station
table* — an array of z-planes plus a stacked ``(S, 2, 2)`` matrix tensor —
and all queries (composite ABCD, front/rear groups for pupil analysis) are
answered from cumulative prefix products of that tensor.  This makes pupil
queries O(1) matrix work instead of re-multiplying sub-chains.

Matrix convention: column vector ``(x, theta)`` with true (non-reduced)
angles; a refraction at a surface with paraxial radius ``R`` between media
``na -> nb`` is ``[[1, 0], [-(nb-na)/(R*nb), na/nb]]``.

Pure 2x2 host-side linear algebra — never traced.
"""

import numpy as np

from ..spectrum.refraction_index import RefractionIndex
from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc
from ..utils.global_options import global_options as go


def _propagation(t: float) -> np.ndarray:
    """Free propagation over axial distance t."""
    return np.array([[1.0, t], [0.0, 1.0]])


def _interface(R: float, na: float, nb: float) -> np.ndarray:
    """Refraction at a spherical interface with paraxial radius R, na -> nb."""
    return np.array([[1.0, 0.0], [(na - nb) / (R * nb), na / nb]])


def _thin_ideal(D_dpt: float, na: float, nb: float) -> np.ndarray:
    """Ideal thin lens of optical power D (dpt) between media na -> nb."""
    return np.array([[1.0, 0.0], [-D_dpt / 1000.0, na / nb]])


def _system_stations(lenses: list, n_ambient, wl: float):
    """Flatten a z-sorted lens list into (z_planes, matrices).

    Returns two parallel lists: the absolute z plane associated with each
    station and the station's 2x2 matrix.  A thick lens contributes three
    stations (front interface, internal propagation, back interface); an
    ideal lens contributes one; inter-lens gaps contribute one propagation
    station whose plane is the *end* of the gap (the next front vertex),
    matching the grouping semantics needed for pupil analysis.
    """
    def idx_at(medium):
        return float(medium(np.array([wl]))[0]) if medium is not None else n_ambient

    planes: list[float] = []
    mats: list[np.ndarray] = []

    n_before = n_ambient
    for li, L in enumerate(lenses):
        if li and (not np.isclose(L.pos[0], lenses[li - 1].pos[0])
                   or not np.isclose(L.pos[1], lenses[li - 1].pos[1])):
            raise RuntimeError("Lenses don't share one axis.")

        if li:
            gap = L.front.pos[2] - lenses[li - 1].back.pos[2]
            if gap < 0:
                raise RuntimeError("Negative distance between lenses. "
                                   "Are there object collisions?")
            planes.append(L.front.pos[2])
            mats.append(_propagation(gap))

        n_after = idx_at(L.n2)
        if L.is_ideal:
            planes.append(L.front.pos[2])
            mats.append(_thin_ideal(L.D, n_before, n_after))
        else:
            if L.front.parax_roc is None or L.back.parax_roc is None:
                raise RuntimeError("Lens without rotational symmetry "
                                   "in transfer matrix analysis.")
            n_glass = idx_at(L.n)
            zf, zb = L.front.pos[2], L.back.pos[2]
            planes += [zf, zb, zb]
            mats += [_interface(L.front.parax_roc, n_before, n_glass),
                     _propagation(L.d),
                     _interface(L.back.parax_roc, n_glass, n_after)]
        n_before = n_after

    return planes, mats


def _conjugate(abcd: np.ndarray, d_obj: float) -> float:
    """Image-side distance conjugate to an object-side distance d_obj
    (both measured as the propagation lengths pre-/appended to abcd such
    that the total system images: B_total = 0)."""
    A, B, C, D = abcd.ravel()
    if np.isfinite(d_obj):
        den = D + C * d_obj
        return -(B + d_obj * A) / den if den else np.nan
    return -A / C if C else np.nan


class TMA(BaseClass):
    """Paraxial analysis of a lens list at one wavelength."""

    def __init__(self, lenses: list, wl: float = 555., n0: RefractionIndex = None,
                 **kwargs) -> None:
        pc.check_type("lenses", lenses, list)
        if n0 is not None:
            pc.check_type("n0", n0, RefractionIndex)
        pc.check_type("wl", wl, (float, int))
        pc.check_not_below("wl", wl, go.wavelength_range[0])
        pc.check_not_above("wl", wl, go.wavelength_range[1])

        self.wl = float(wl)
        self.n1 = float(n0(np.array([self.wl]))[0]) if n0 is not None else 1.0

        L = sorted(lenses, key=lambda el: el.front.pos[2])
        if L:
            self.vertex_points = (float(L[0].front.pos[2]), float(L[-1].back.pos[2]))
            self.n2 = float(L[-1].n2(np.array([self.wl]))[0]) \
                if L[-1].n2 is not None else self.n1
        else:
            self.vertex_points = (float("nan"), float("nan"))
            self.n2 = self.n1
        self._1, self._2 = self.vertex_points
        self.d = self._2 - self._1

        planes, mats = _system_stations(L, self.n1, self.wl)
        self._planes = np.asarray(planes, dtype=np.float64)
        # cumulative prefix products: _prefix[k] = M_{k-1} @ ... @ M_0
        self._prefix = np.empty((len(mats) + 1, 2, 2))
        self._prefix[0] = np.eye(2)
        for k, M in enumerate(mats):
            self._prefix[k + 1] = M @ self._prefix[k]
        self.abcd = self._prefix[-1].copy()

        self._derive_cardinals()

        super().__init__(**kwargs)
        self.lock()
        self._new_lock = True

    # ------------------------------------------------------------------
    def _derive_cardinals(self) -> None:
        """All cardinal quantities expressed through the rear focal length
        f2 = -1/C (true-angle ABCD convention with media n1 -> n2)."""
        A, B, C, D = (float(v) for v in self.abcd.ravel())
        nan = float("nan")
        n_ratio = self.n1 / self.n2

        if C:
            f2 = -1.0 / C
            f1 = -n_ratio * f2
            p1 = self._1 + f2 * (n_ratio - D)
            p2 = self._2 - f2 * (1.0 - A)
            self.principal_points = (p1, p2)
            self.nodal_points = (self._1 + f2 * (1.0 - D),
                                 self._2 - f2 * (n_ratio - A))
            self.focal_points = (p1 + f1, p2 + f2)
            self.focal_lengths = (f1, f2)
            self.ffl = self.focal_points[0] - self._1
            self.bfl = self.focal_points[1] - self._2
        else:
            f1 = f2 = nan
            self.principal_points = (nan, nan)
            self.nodal_points = (nan, nan)
            self.focal_points = (nan, nan)
            self.focal_lengths = (nan, nan)
            self.ffl = self.bfl = nan

        self.efl = f2
        self.efl_n = f2 / self.n2
        self.focal_lengths_n = (f1 / self.n1, f2 / self.n2)
        self.powers = (1000.0 / f1, 1000.0 / f2)
        self.powers_n = (1000.0 * self.n1 / f1, 1000.0 * self.n2 / f2)

        # optical center: axial point whose conjugate chief ray crosses
        # the axis with unit angular magnification
        denom = D - 1.0
        split = 1.0 - A + B * C / denom if denom else np.inf
        self.optical_center = self._1 + self.d / split \
            if C and split and np.isfinite(split) else nan

    # ------------------------------------------------------------------
    def matrix_at(self, z_g: float, z_b: float) -> np.ndarray:
        """ABCD matrix from an object plane at z_g to an image plane at z_b."""
        return _propagation(z_b - self._2) @ self.abcd @ _propagation(self._1 - z_g)

    def image_position(self, z_g) -> float:
        """Absolute image z-position conjugate to an object at z_g."""
        if self._1 < z_g < self._2:
            raise ValueError("Object inside lens with z-extent at optical axis "
                             f"of {self.vertex_points}")
        return float(self._2 + _conjugate(self.abcd, self._1 - z_g))

    def image_magnification(self, z_g) -> float:
        """Transverse magnification at the image plane for an object at z_g."""
        with np.errstate(invalid="ignore"):
            return float(self.matrix_at(z_g, self.image_position(z_g))[0, 0])

    def object_position(self, z_b) -> float:
        """Absolute object z-position conjugate to an image at z_b."""
        if self._1 < z_b < self._2:
            raise ValueError("Image inside lens with z-extent at optical axis "
                             f"of {self.vertex_points}")
        inv = np.linalg.inv(self.abcd)
        return float(self._1 + _conjugate(inv, self._2 - z_b))

    def object_magnification(self, z_b) -> float:
        """Magnification for a given image position."""
        with np.errstate(invalid="ignore"):
            return float(self.matrix_at(self.object_position(z_b), z_b)[0, 0])

    # ------------------------------------------------------------------
    def _split_index(self, zp: float) -> int:
        """Number of stations strictly in front of the plane zp."""
        return int(np.searchsorted(self._planes, zp, side="left")) \
            if self._planes.size else 0

    def _pupil_props(self, zp: float):
        """Entrance/exit pupil positions and magnifications for a stop at zp.

        The system splits at the stop into a front group (imaged backwards
        to give the entrance pupil) and a rear group (imaged forwards for
        the exit pupil); both group matrices come from the prefix-product
        table in O(1) multiplications.
        """
        S = len(self._prefix) - 1
        i = self._split_index(zp)
        # a propagation station whose end-plane coincides with the next
        # station belongs to neither group: the stop sits inside that gap
        # and the residual distances are handled explicitly below
        skip = 1 if i + 1 < S and self._planes[i] == self._planes[i + 1] else 0

        if i:
            # front group traversed right-to-left (towards the object side)
            back_to_front = np.linalg.inv(self._prefix[i])
            v_rear = self._planes[i - 1]          # rear vertex of front group
            ze1 = self._1 + _conjugate(back_to_front, v_rear - zp)
            m1 = (_propagation(ze1 - self._1) @ back_to_front
                  @ _propagation(v_rear - zp))[0, 0]
        else:
            ze1, m1 = zp, 1.0

        j = i + skip
        if j < S:
            rear = self._prefix[-1] @ np.linalg.inv(self._prefix[j])
            v_front = self._planes[j]             # front vertex of rear group
            ze2 = self._2 + _conjugate(rear, v_front - zp)
            m2 = (_propagation(ze2 - self._2) @ rear
                  @ _propagation(v_front - zp))[0, 0]
        else:
            ze2, m2 = zp, 1.0

        return float(ze1), float(ze2), float(m1), float(m2)

    def pupil_position(self, z_s: float):
        """(entrance, exit) pupil z-positions for a stop at z_s."""
        return self._pupil_props(z_s)[:2]

    def pupil_magnification(self, z_s: float):
        """(entrance, exit) pupil magnifications for a stop at z_s."""
        return self._pupil_props(z_s)[2:]
