"""Raytracer: scene orchestration around the trace core.

Counterpart of ``optrace_tpu/tracer/raytracer.py``: geometry checks with
sampled collision detection and the sequential trace with INFOS warning
counters. The trace runs eagerly on one device (``device=None`` is the CUDA
device; the CPU only on request), rays are generated on that device from a
``torch.Generator``, and the stored sections come back as host numpy arrays
in :class:`RayStorage`.

Not ported yet (see ROADMAP): ``detector_image``/``source_image`` and the
spectra, ``iterative_render``/``render_huge``, ``focus_search``.
"""

from enum import IntEnum
from typing import Any

import numpy as np
import torch

from .ray_storage import RayStorage
from .scene_compile import compile_surface
from .trace_core import TraceStep, trace_bundle
from ..geometry import (Group, Lens, Aperture, Surface, RingSurface,
                        RectangularSurface, Point, Line)
from ..spectrum.refraction_index import RefractionIndex
from ..utils.device import resolve_device
from ..utils.property_checker import PropertyChecker as pc
from ..utils.progress_bar import ProgressBar
from ..utils.warnings import warning


class Raytracer(Group):

    N_EPS: float = 1e-11
    HURB_FACTOR: float = 2 ** 0.5
    MAX_RAY_STORAGE_RAM: int = 6000000000
    ITER_RAYS_STEP: int = 1000000
    T_TH: float = 0.0

    class INFOS(IntEnum):
        ABSORB_MISSING = 0
        TIR = 1
        ILL_COND = 2
        OUTLINE_INTERSECTION = 3
        HURB_NEG_DIR = 4

    def __init__(self, outline, n0: RefractionIndex = None, no_pol: bool = False,
                 use_hurb: bool = False, device=None, **kwargs) -> None:
        """:param device: where the trace runs. ``None`` is the CUDA device
            and raises when there is none; pass ``"cpu"`` for the CPU."""
        self.device = resolve_device(device)
        self.outline = outline
        self.no_pol = no_pol
        self.use_hurb = use_hurb

        self.rays = RayStorage()
        self._msgs = np.array([])
        self._ignore_geometry_error = False
        self.geometry_error = False
        self._last_trace_snapshot = None
        self.fault_pos = np.array([])
        self._seed_counter = 0

        super().__init__(None, n0, **kwargs)
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "outline":
            pc.check_type(key, val, (list, np.ndarray))
            o = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, o)
            if o.shape[0] != 6 or o[0] >= o[1] or o[2] >= o[3] or o[4] >= o[5]:
                raise ValueError("Outline needs to be specified as [x1, x2, y1, y2, z1, z2] "
                                 "with x2 > x1, y2 > y1, z2 > z1.")
            super().__setattr__(key, o)
            return
        if key in ("no_pol", "use_hurb"):
            pc.check_type(key, val, bool)
        super().__setattr__(key, val)

    @property
    def extent(self):
        return tuple(self.outline)

    @property
    def pos(self):
        return np.mean(self.outline[:2]), np.mean(self.outline[2:4]), self.outline[4]

    def clear(self) -> None:
        super().clear()
        self.rays.__init__()

    # ------------------------------------------------------------------
    # snapshots / change detection

    def property_snapshot(self) -> dict:
        return self.tracing_snapshot() | dict(
            Detectors=[D.crepr() for D in self.detectors])

    def tracing_snapshot(self) -> dict:
        return dict(Rays=self.rays.crepr(),
                    Ambient=[tuple(self.outline), self.n0.crepr()],
                    TraceSettings=[self.no_pol, self.use_hurb, self.HURB_FACTOR],
                    Lenses=[D.crepr() for D in self.lenses],
                    Filters=[D.crepr() for D in self.filters],
                    Apertures=[D.crepr() for D in self.apertures],
                    RaySources=[D.crepr() for D in self.ray_sources])

    def compare_property_snapshot(self, h1: dict, h2: dict) -> dict:
        diff = {key: h1[key] != h2[key] for key in h1.keys()}
        diff["Ambient"] = diff["Ambient"] or diff["Lenses"]
        diff["Any"] = any(val for val in diff.values())
        return diff

    def check_if_rays_are_current(self) -> bool:
        if self._last_trace_snapshot is None:
            return False
        now = self.tracing_snapshot()
        return not self.compare_property_snapshot(self._last_trace_snapshot, now)["Any"]

    # ------------------------------------------------------------------
    # geometry checks

    def _tracing_elements(self) -> list:
        """z-sorted [Lens|Aperture] plus the implicit end absorber at the
        outline z-end."""
        o = self.outline
        end_filter = Aperture(RectangularSurface(dim=[o[1] - o[0], o[3] - o[2]]),
                              pos=[(o[1] + o[0]) / 2, (o[2] + o[3]) / 2, o[5]])
        elements = [el for el in self.elements if isinstance(el, (Lens, Aperture))]
        return elements + [end_filter]

    @staticmethod
    def check_collision(front, back, res: int = 100):
        """Sampled collision check between two surfaces/points/lines. Returns (collision?, x, y, z samples)."""
        if not (isinstance(front, Surface) or isinstance(back, Surface)):
            raise TypeError("At least one object needs to be a Surface for collision detection")

        if isinstance(front, Point) or isinstance(back, Point):
            rev, pt, surf = (False, front, back) if isinstance(front, Point) else (True, back, front)
            x, y = np.array([pt.pos[0]]), np.array([pt.pos[1]])
            z = surf.values(x, y)
            hit = (z < pt.pos[2]) if not rev else (z > pt.pos[2])
            hit = hit & surf.mask(x, y)
            where = np.where(hit)[0]
            return bool(np.any(hit)), x[where], y[where], z[where]

        if isinstance(front, Line) or isinstance(back, Line):
            rev, line, surf = (False, front, back) if isinstance(front, Line) else (True, back, front)
            t = np.linspace(-line.r, line.r, 10 * res)
            ang = np.deg2rad(line.angle)
            x = line.pos[0] + np.cos(ang) * t
            y = line.pos[1] + np.sin(ang) * t
            z = surf.values(x, y)
            hit = (z < line.pos[2]) if not rev else (z > line.pos[2])
            hit = hit & surf.mask(x, y)
            where = np.where(hit)[0]
            return bool(np.any(hit)), x[where], y[where], z[where]

        xsf, xef, ysf, yef, zsf, zef = front.extent
        xsb, xeb, ysb, yeb, zsb, zeb = back.extent
        if zef < zsb:
            return False, np.array([]), np.array([]), np.array([])

        xs, xe = max(xsf, xsb), min(xef, xeb)
        ys, ye = max(ysf, ysb), min(yef, yeb)
        if xs > xe or ys > ye:
            return False, np.array([]), np.array([]), np.array([])

        Y, X = np.mgrid[ys:ye:res * 1j, xs:xe:res * 1j]
        x2, y2 = X.flatten(), Y.flatten()
        valid = front.mask(x2, y2) & back.mask(x2, y2)
        x2v, y2v = x2[valid], y2[valid]
        zfv = front.values(x2v, y2v)
        zbv = back.values(x2v, y2v)
        coll = zfv > zbv
        where = np.where(coll)[0]
        return bool(np.any(coll)), x2v[where], y2v[where], zfv[where]

    def _geometry_checks(self) -> None:
        elements = self._tracing_elements()

        def is_inside(e) -> bool:
            o = self.outline + self.N_EPS * np.array([-1, 1, -1, 1, -1, 1])
            return o[0] <= e[0] and e[1] <= o[1] and o[2] <= e[2] and e[3] <= o[3] \
                and o[4] <= e[4] and e[5] <= o[5]

        if not self.ray_sources:
            warning("RaySource Missing.")
            self.geometry_error = True
            return

        coll = False
        xc = yc = zc = np.array([])
        for i, el in enumerate(elements):
            if not is_inside(el.extent):
                warning(f"Element{i} {el} with extent {el.extent} outside outline {self.outline}.")
                self.geometry_error = True
                return

            if i + 1 < len(elements):
                coll, xc, yc, zc = self.check_collision(el.front, elements[i + 1].front)
            if not coll and el.has_back():
                coll, xc, yc, zc = self.check_collision(el.front, el.back)
            if not coll and el.has_back():
                coll, xc, yc, zc = self.check_collision(el.back, elements[i + 1].front)

            if self.use_hurb and i < len(elements) - 1 and isinstance(el, Aperture):
                if not isinstance(el.front, RingSurface):
                    warning(f"Ray bending for surface type {type(el.front).__name__} not implemented.")
                    self.geometry_error = True
                    return
            if coll:
                break

        if not coll:
            for rs in self.ray_sources:
                if not is_inside(rs.extent):
                    warning(f"RaySource {rs} with extent {rs.extent} outside outline {self.outline}.")
                    self.geometry_error = True
                    return
                if isinstance(rs.surface, (Surface, Point, Line)) and rs.pos[2] >= elements[0].extent[4]:
                    coll, xc, yc, zc = self.check_collision(rs.surface, elements[0].front)
                if coll:
                    break

        if coll:
            warning(f"Detected collision between two Surfaces at {xc[0], yc[0], zc[0]}"
                    f" and at least {xc.shape[0]} other positions.")
            self.geometry_error = True
            self.fault_pos = np.column_stack((xc, yc, zc))
            return

        self.geometry_error = False

    def _pretrace_check(self, N: int) -> bool:
        pc.check_type("N", N, int)
        if N < 1:
            raise ValueError(f"Ray number N needs to be at least 1, but is {N}.")
        self._geometry_checks()
        if self.geometry_error and not self._ignore_geometry_error:
            warning("ABORTED TRACING")
            return True
        return False

    # ------------------------------------------------------------------
    # trace step construction

    def _build_steps(self, device=None, dtype=torch.float32) -> list:
        """Element list → TraceStep list on ``device`` (default: the
        raytracer's). ``dtype=torch.float64`` builds the accuracy-oracle
        variant of the same scene."""
        device = self.device if device is None else torch.device(device)
        steps = []
        n_before = self.n0

        def ph(surf):
            return tuple(float(v) for v in surf.pos)

        for el in self._tracing_elements():
            if isinstance(el, Lens):
                n2 = el.n2 if el.n2 is not None else self.n0
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "refract",
                                       n1_fn=n_before, n2_fn=el.n, pos_host=ph(el.front)))
                steps.append(TraceStep(compile_surface(el.back, device, dtype), "refract",
                                       n1_fn=el.n, n2_fn=n2, pos_host=ph(el.back)))
                n_before = n2
            elif isinstance(el, Aperture):
                kind = "ring" if isinstance(el.front, RingSurface) else ""
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "absorb",
                                       hurb=bool(kind), hurb_kind=kind,
                                       pos_host=ph(el.front)))
        return steps

    def _make_source_fn(self, N: int):
        """Ray generation for all sources with static per-source counts:
        ``gen -> (p, s, pols, w, wl)`` on the generator's device."""
        sources = self.ray_sources
        N_list = [int(n) for n in self.rays.N_list]
        no_pol = self.no_pol

        def source_fn(gen):
            parts = [src.create_rays(gen, Ni, no_pol=no_pol, power=src.power)
                     for src, Ni in zip(sources, N_list) if Ni]
            if len(parts) == 1:
                return parts[0]
            return tuple(torch.cat(xs, dim=0) for xs in zip(*parts))
        return source_fn

    # ------------------------------------------------------------------
    # tracing

    def trace(self, N: int) -> None:
        """Trace N rays through the geometry and store their sections."""
        N = int(N)
        if self._pretrace_check(N):
            return

        nt = len(self.tracing_surfaces) + 2
        if self.rays.storage_size(N, nt, self.no_pol) > self.MAX_RAY_STORAGE_RAM:
            raise RuntimeError(f"More than {self.MAX_RAY_STORAGE_RAM * 1e-9:.1f} GB RAM requested. "
                               "Either decrease the number of rays or surfaces, "
                               "or increase Raytracer.MAX_RAY_STORAGE_RAM.")

        bar = ProgressBar("Raytracing: ", 3)
        self.rays.init(self.ray_sources, N, nt, self.no_pol, seed=self._seed_counter)

        steps = self._build_steps()
        source_fn = self._make_source_fn(N)
        bar.update()

        self._seed_counter += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed_counter)
        with torch.no_grad():
            p, s, pols, w, wl = source_fn(gen)
            out = trace_bundle(steps, self.n0, tuple(float(v) for v in self.outline),
                               p, s, pols, w, wl, self.no_pol, self.use_hurb, gen=gen,
                               hurb_factor=float(self.HURB_FACTOR))
        out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in out.items() if k in ("p", "w", "pol", "n", "wl", "infos")}
        bar.update()

        s0 = out["p"][:, 1] - out["p"][:, 0]
        norm = np.linalg.norm(s0, axis=-1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            s0 = np.where(norm > 0, s0 / norm, s0)
        self.rays.fill(out["p"], out["w"], out["pol"], out["n"], out["wl"], s0)
        self.rays.lock()

        self._msgs = np.asarray(out["infos"], dtype=int)
        self._show_messages(N)
        bar.finish()

        self._last_trace_snapshot = self.tracing_snapshot()

    # ------------------------------------------------------------------
    # messages

    def _surface_names(self) -> list:
        names = dict()
        for type_, els in zip(["Lens", "Aperture", "Filter"],
                              [self.lenses, self.apertures, self.filters]):
            for i, el in enumerate(els):
                if not el.has_back():
                    names[f"surface of {type_} {el.abbr}{i}"] = el.pos[2]
                else:
                    names[f"front surface of {type_} {el.abbr}{i}"] = el.front.pos[2]
                    names[f"back surface of {type_} {el.abbr}{i}"] = el.back.pos[2]
        return ["RaySource"] + sorted(names, key=lambda k: names[k]) + ["Outline"]

    def _show_messages(self, N: int) -> None:
        surf_name = self._surface_names()
        msgs = self._msgs
        texts = {
            int(self.INFOS.TIR): "with total inner reflection at surface {s}, treating as absorbed.",
            int(self.INFOS.ABSORB_MISSING): "missing lens surface {s}, set to absorbed",
            int(self.INFOS.ILL_COND): "are ill-conditioned for numerical hit finding at surface {s}. "
                                      "Where and whether they intersect might be wrong.",
            int(self.INFOS.OUTLINE_INTERSECTION): "hitting outline after surface {s}, set to absorbed.",
            int(self.INFOS.HURB_NEG_DIR): "have negative z-direction after ray bending at surface {s},"
                                          " set to absorbed.",
        }
        for type_ in range(msgs.shape[0]):
            for surf in range(msgs.shape[1]):
                if (count := msgs[type_, surf]):
                    sname = surf_name[surf] if surf < len(surf_name) else f"{surf}"
                    warning(f"{count} rays ({100 * count / N:.3g}% of all rays) "
                            + texts[type_].format(s=f"{surf} ({sname})"))

    # ------------------------------------------------------------------
    # static section bounds (the detector hit search's segment mask)

    def _section_z_bounds(self) -> list:
        """Static (z_min, z_max) per stored ray section: sources, one per
        tracing surface, and the end absorber at the outline z-end."""
        src_z = [rs.extent[4:6] for rs in self.ray_sources]
        bounds = [(min(z[0] for z in src_z), max(z[1] for z in src_z))]
        for surf in self.tracing_surfaces:
            bounds.append((float(surf.z_min), float(surf.z_max)))
        bounds.append((float(self.outline[5]), float(self.outline[5])))
        return bounds
