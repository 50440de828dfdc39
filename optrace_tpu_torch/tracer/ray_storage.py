"""Ray storage: SoA arrays over N rays × nt sections.

Behavioral parity with reference ``optrace/tracer/ray_storage.py``
(SURVEY.md §2.6): same public arrays (p_list, s0_list, w_list, n_list,
pol_list, wl_list), source apportioning ∝ power, selective fetch with
direction reconstruction, section/optical length utilities.

A trace fills the storage with its f32 tensors on the device
(:meth:`RayStorage.fill`), and there they stay: the images, spectra and the
focus search read them where they lie (:meth:`RayStorage.sections`). A
public array is made on the host at its first read, in the types of the
JAX package's storage (positions and indices f64, the rest f32) and
read-only; the selective reads (:meth:`RayStorage.rays_by_mask`,
:meth:`RayStorage.source_sections` and what stands on them) select on the
device and copy only what they return. A storage that user code fills with
numpy arrays holds them as they are. Every fill is numbered, so that the
change detection (``crepr``) need not make or hash a gigabyte of sections
before every image.
"""

import itertools

import numpy as np
import torch

from ..utils.base_class import BaseClass
from ..utils.warnings import warning


def _normalize_rows(a):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return a / n


_fill_serial = itertools.count(1)     # one number a fill, over all storages of the process


def _read_only(a):
    """A read-only view: the storage's arrays cannot change in place, and
    the array that a caller handed in keeps its own flags."""
    a = a.view()
    a.flags.writeable = False
    return a


def _source_directions(p01: torch.Tensor) -> torch.Tensor:
    """The unit directions of the first section from the f32 positions of
    the first two, (n, 2, 3), as f64 (zero where the ray does not move), on
    their device: the f32 operations of numpy's ``np.linalg.norm`` and
    division, in its order (the squares summed left to right, the square
    root rounded once to f32), so that the bits are those of the host's
    f32 arithmetic."""
    s0 = p01[:, 1] - p01[:, 0]
    sq = s0 * s0
    norm = torch.sqrt((sq[:, 0:1] + sq[:, 1:2] + sq[:, 2:3]).double()).float()
    return torch.where(norm > 0, s0 / norm, s0).double()


class RayStorage(BaseClass):

    # public array -> (device tensor it is made from, host type)
    _ARRAYS = {"p_list": ("p", np.float64), "s0_list": ("p", np.float64),
               "n_list": ("n", np.float64), "pol_list": ("pol", np.float32),
               "w_list": ("w", np.float32), "wl_list": ("wl", np.float32)}

    def __init__(self, **kwargs) -> None:
        self._lock = False
        self._fill_id = 0
        self.drop_arrays()
        self.N_list = np.array([], dtype=int)
        self.B_list = np.array([], dtype=int)
        self.no_pol = False
        self.ray_source_list = []
        super().__init__(**kwargs)

    # ------------------------------------------------------------------
    def init(self, ray_source_list: list, N: int, nt: int, no_pol: bool,
             seed: int = 0) -> None:
        """Apportion N rays to the sources ∝ power (reference :35-90).
        Array allocation happens lazily in :meth:`fill`."""
        self._lock = False
        self.no_pol = no_pol
        assert N >= 0 and nt >= 0
        assert len(ray_source_list)

        P_list = np.array([RS.power for RS in ray_source_list])
        P_all = np.sum(P_list)
        self.N_list = (N * P_list / P_all).astype(int)
        dN = N - np.sum(self.N_list)
        if dN > 0:
            rng = np.random.default_rng(seed)
            index_add = rng.choice(self.N_list.shape[0], size=dN, p=P_list / P_all)
            np.add.at(self.N_list, index_add, 1)
        if np.any(self.N_list == 0):
            warning("There are RaySources that have no rays assigned. "
                    "Change the power ratio or raise the overall ray number")
        self.B_list = np.concatenate(([0], np.cumsum(self.N_list))).astype(int)
        self.ray_source_list = ray_source_list

    def drop_arrays(self) -> None:
        """Let go of the arrays of the last fill, as a storage holds none
        before its first: a trace drops them before it makes its own, so
        that they are freed where no one else holds them."""
        self._dev = None        # the trace's f32 tensors p, w, pol (None under no_pol), n, wl
        self._host = {name: np.array([]) for name in self._ARRAYS}   # arrays made or handed in

    def fill(self, p, w, pol, n, wl, s0=None) -> None:
        """Store a trace: its f32 tensors p (N, nt, 3), w (N, nt), pol
        (N, nt, 3, None under no_pol), n (N, nt) and wl (N,) on their
        device, which the storage keeps (the host arrays follow at their
        first read, ``s0`` from p); or host arrays p, w, pol, n, wl and s0,
        kept read-only in the types of the public arrays."""
        if isinstance(p, torch.Tensor):
            self._dev = dict(p=p, w=w, pol=None if self.no_pol or pol is None else pol, n=n, wl=wl)
            self._host = {}
        else:
            self._dev = None
            host = dict(p_list=p, w_list=w, n_list=n, wl_list=wl, s0_list=s0, pol_list=pol)
            self._host = {name: _read_only(np.asarray(host[name], dtype=dt))
                          for name, (_, dt) in self._ARRAYS.items()
                          if not (name == "pol_list" and self.no_pol)}
            if self.no_pol:
                self._host["pol_list"] = np.broadcast_to(np.nan, self._host["p_list"].shape)
        self._fill_id = next(_fill_serial)

    def _array(self, name):
        """The public array ``name``, made from the device tensors at its
        first read."""
        a = self._host.get(name)
        if a is None:
            a = self._host[name] = self._from_device(name, slice(None))
        return a

    def _from_device(self, name, rows, sec=None):
        """``self.<name>[rows]``, or ``[rows, sec]``, from the device
        tensors, copying only those values: ``rows`` a slice or a boolean
        mask over the rays, ``sec`` an index, a slice or an index array of
        sections (numpy's rules). Made on the host as the whole array is."""
        key, dtype = self._ARRAYS[name]
        t = self._dev[key]
        if t is None:           # no polarization traced: NaN, as the JAX package's storage holds
            nan = np.broadcast_to(np.nan, self._dev["p"].shape)
            return nan[rows] if sec is None else nan[rows, sec]
        # a slice of rows is numpy's basic indexing: a read-only result, as
        # a view of the whole array would be; a mask gives a new array
        basic = isinstance(rows, slice)
        if not basic:
            rows = torch.as_tensor(np.flatnonzero(rows), device=t.device)
        # widened on the device, so that each array crosses to the host once
        if name == "s0_list":
            a = _source_directions(t[rows, :2]).cpu().numpy()
            a = a if sec is None else a[:, sec]
        else:
            if sec is not None and not isinstance(sec, (int, np.integer, slice)):
                sec = torch.as_tensor(np.asarray(sec), device=t.device)
            v = t[rows] if sec is None else t[rows, sec]
            # in C order, whatever the order of the trace's sections (``to``
            # keeps the order where it changes no type)
            v = v.to(getattr(torch, np.dtype(dtype).name), memory_format=torch.contiguous_format)
            a = v.contiguous().cpu().numpy()
        return _read_only(a) if basic else a

    def _shape(self, name):
        if self._dev is None or name in self._host:
            return self._array(name).shape
        p = self._dev["p"].shape
        return {"s0_list": p[:1] + p[2:], "n_list": p[:2], "w_list": p[:2], "wl_list": p[:1]}.get(name, p)

    def crepr(self):
        """State for the change detection. An array of a fill (read-only,
        made or not) stands by its shape, its type and the number of the
        fill, which no other fill shares; an array that someone made
        writeable again, or handed in as such, is hashed by its content,
        like every other value. Nothing is made on the host here."""
        out = [type(self).__name__]
        for key in sorted(self.__dict__):
            if key in ("_lock", "_new_lock", "_dev", "_host"):
                continue
            out.append((key, self._crepr_value(self.__dict__[key])))
        for name, (_, dtype) in self._ARRAYS.items():
            val = self._host.get(name)
            if val is None:
                if name == "pol_list" and self._dev["pol"] is None:
                    dtype = np.float64
                out.append((name, (self._shape(name), str(np.dtype(dtype)), self._fill_id)))
            elif not val.flags.writeable:
                out.append((name, (val.shape, str(val.dtype), self._fill_id)))
            else:
                out.append((name, self._crepr_value(val)))
        return tuple(out)

    def sections(self, Ns: int, Ne: int, device):
        """Positions (n, nt, 3) and weights (n, nt) in f64 and wavelengths
        (n,) in f32 of the rays Ns … Ne on ``device``: from the kept
        tensors, or uploaded from the host arrays of a storage filled with
        them. Both give the same numbers: the host's f64 sections are exact
        images of the f32 values."""
        if self._dev is not None:
            p, w, wl = (self._dev[k][Ns:Ne].to(device) for k in ("p", "w", "wl"))
            return p.to(torch.float64), w.to(torch.float64), wl

        def up(a, dtype):
            return torch.as_tensor(np.array(a, dtype=dtype), device=device)
        return (up(self.p_list[Ns:Ne], np.float64), up(self.w_list[Ns:Ne], np.float64),
                up(self.wl_list[Ns:Ne], np.float32))

    # ------------------------------------------------------------------
    @staticmethod
    def storage_size(N: int, nt: int, no_pol: bool) -> int:
        """Approximate host RAM of a stored trace in bytes."""
        f32, f64 = 4, 8
        fpol = f32 * N * nt * 3 if not no_pol else f64
        return N * nt * 3 * f64 + N * 3 * f64 + fpol + N * nt * f32 + N * nt * f64 + N * f32

    @staticmethod
    def max_rays_for_size(size: int, nt: int, no_pol: bool) -> int:
        f32, f64 = 4, 8
        if no_pol:
            return (size - f64) // (nt * 3 * f64 + 3 * f64 + nt * f32 + nt * f64 + f32)
        return size // (nt * 3 * f64 + 3 * f64 + f32 * nt * 3 + nt * f32 + nt * f64 + f32)

    @property
    def N(self) -> int:
        shape = self._shape("p_list")
        return shape[0] if self.N_list.shape[0] and len(shape) == 3 else 0

    @property
    def Nt(self) -> int:
        return self._shape("p_list")[1] if self.N else 0

    # ------------------------------------------------------------------
    def source_sections(self, index: int = None):
        """Ray properties at the source section (p, s, pol, w, wl)."""
        assert self.N, "ray_source_list has no rays stored."
        assert index is None or 0 <= index < len(self.N_list)
        Ns, Ne = self.B_list[index:index + 2] if index is not None else (0, self.N)
        rows = slice(int(Ns), int(Ne))
        return (self._read("p_list", rows, 0), self._read("s0_list", rows),
                self._read("pol_list", rows, 0), self._read("w_list", rows, 0),
                self._read("wl_list", rows))

    def _read(self, name, rows, sec=None):
        """``self.<name>[rows]`` or ``[rows, sec]``: from the host array
        where it is made, else from the device, copying only these values."""
        if self._dev is None or name in self._host:
            a = self._array(name)
            return a[rows] if sec is None else a[rows, sec]
        return self._from_device(name, rows, sec)

    def source_numbers(self) -> np.ndarray:
        _, _, _, _, _, sn, _ = self.rays_by_mask(ret=[0, 0, 0, 0, 0, 1, 0])
        return sn

    def ray_lengths(self, ch=None, ch2=None) -> np.ndarray:
        """Euclidean section lengths."""
        _, s, _, _, _, _, _ = self.rays_by_mask(ch, ch2, ret=[0, 1, 0, 0, 0, 0, 0], normalize=False)
        return np.linalg.norm(s, axis=s.ndim - 1)

    def optical_lengths(self, ch=None, ch2=None) -> np.ndarray:
        """Optical path lengths l·n per section."""
        _, s, _, _, _, _, n = self.rays_by_mask(ch, ch2, ret=[0, 1, 0, 0, 0, 0, 1], normalize=False)
        l = np.linalg.norm(s, axis=s.ndim - 1)
        return l * n

    def direction_vectors(self, normalize: bool = True) -> np.ndarray:
        _, s, _, _, _, _, _ = self.rays_by_mask(ret=[0, 1, 0, 0, 0, 0, 0], normalize=normalize)
        return s

    def rays_by_mask(self, ch=None, ch2=None, ret=None, normalize: bool = True):
        """Selective fetch (reference :235-293): directions are
        reconstructed as p[i+1] − p[i].

        :return: (p, s, pol, w, wl, snum, n), None where not requested
        """
        assert self.N, "ray_source_list has no rays stored."
        ret = [1, 1, 1, 1, 1, 1, 1] if ret is None else ret
        ch = np.ones(self.N, dtype=bool) if ch is None else ch
        ch2 = slice(None) if ch2 is None else ch2
        assert ch.shape[0] == self.N

        snums = None
        if ret[5]:
            ind = np.nonzero(ch)[0]
            snums = np.zeros_like(ind, dtype=int)
            for i, _ in enumerate(self.N_list):
                Ns, Ne = self.B_list[i:i + 2]
                snums[(Ns <= ind) & (ind < Ne)] = i

        s = None
        if ret[1]:
            if not isinstance(ch2, slice):
                ch21 = np.where(ch2 < self.Nt - 1, ch2 + 1, ch2)
                s = self._read("p_list", ch, ch21) - self._read("p_list", ch, ch2)
                if normalize:
                    s = _normalize_rows(s)
            else:
                p = self._read("p_list", ch, slice(None))
                s = p[:, 1:] - p[:, :-1]
                s = np.concatenate((s, np.zeros((s.shape[0], 1, 3))), axis=1)
                if normalize:
                    s = _normalize_rows(s)

        return (self._read("p_list", ch, ch2) if ret[0] else None,
                s,
                self._read("pol_list", ch, ch2) if ret[2] else None,
                self._read("w_list", ch, ch2) if ret[3] else None,
                self._read("wl_list", ch) if ret[4] else None,
                snums,
                self._read("n_list", ch, ch2) if ret[6] else None)


def _public_array(name):
    def get(self):
        return self._array(name)

    def put(self, val):
        # an array set by hand: the others are made first, then the
        # storage holds host arrays only
        if self._dev is not None:
            for other in self._ARRAYS:
                self._array(other)
            self._dev = None
        self._host[name] = val
    return property(get, put, doc=f"``{name}``: a host array, made at its first read.")


for _name in RayStorage._ARRAYS:
    setattr(RayStorage, _name, _public_array(_name))
del _name
