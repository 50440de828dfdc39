"""Raytracer: scene orchestration around the trace core.

Counterpart of ``optrace_tpu/tracer/raytracer.py``: geometry checks with
sampled collision detection and the sequential trace with INFOS warning
counters. The trace runs eagerly on one device (``device=None`` is the CUDA
device; the CPU only on request), rays are generated on that device from a
``torch.Generator``, and the stored sections come back as host numpy arrays
in :class:`RayStorage`. The f32 tensors of the last trace also stay on the
device: ``detector_image``, ``detector_spectrum``, ``source_image`` and
``source_spectrum`` read them there, search the detector hits in f64 and bin
them on the same device, and return host objects. ``iterative_render`` and
``render_huge`` stream batch after batch through the fused render
(``parallel/render.py``) and store no sections.

Not ported yet (see ROADMAP.md): ``render_huge`` over several devices
(``mesh``), ``focus_search``.
"""

import warnings
from enum import IntEnum
from typing import Any

import numpy as np
import torch

from .detector import detector_hits, build_segment_mask, sphere_projection_xy
from .ray_storage import RayStorage
from .scene_compile import compile_surface
from .trace_core import TraceStep, trace_bundle, RunPlans, N_INFOS
from ..geometry import (Group, Lens, IdealLens, Filter, Aperture, Detector, RaySource,
                        Surface, RingSurface, SlitSurface, SphericalSurface,
                        RectangularSurface, Point, Line)
from ..image.render_image import RenderImage
from ..spectrum.refraction_index import RefractionIndex
from ..spectrum.light_spectrum import LightSpectrum
from ..utils.device import resolve_device
from ..utils.global_options import global_options
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
        self._compiled = None       # (elements, snapshot key, steps, RunPlans) of the last trace
        self._dev_sections = None   # (rays.p_list, p, w, wl): the last trace's f32 device tensors
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
        self._dev_sections = None

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
        current = self._last_trace_snapshot is not None and not self.compare_property_snapshot(
            self._last_trace_snapshot, self.tracing_snapshot())["Any"]
        if not current:
            self._dev_sections = None       # stale sections are of no use on the device either
        return current

    # ------------------------------------------------------------------
    # geometry checks

    def _tracing_elements(self) -> list:
        """z-sorted [Lens|Filter|Aperture] plus the implicit end absorber at
        the outline z-end."""
        o = self.outline
        end_filter = Aperture(RectangularSurface(dim=[o[1] - o[0], o[3] - o[2]]),
                              pos=[(o[1] + o[0]) / 2, (o[2] + o[3]) / 2, o[5]])
        elements = [el for el in self.elements if isinstance(el, (Lens, Filter, Aperture))]
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
                if not isinstance(el.front, (RingSurface, SlitSurface)):
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
            if isinstance(el, IdealLens):
                n2 = el.n2 if el.n2 is not None else self.n0
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "ideal",
                                       n1_fn=n_before, n2_fn=n2, D=el.D, pos_host=ph(el.front)))
                n_before = n2
            elif isinstance(el, Lens):
                n2 = el.n2 if el.n2 is not None else self.n0
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "refract",
                                       n1_fn=n_before, n2_fn=el.n, pos_host=ph(el.front)))
                steps.append(TraceStep(compile_surface(el.back, device, dtype), "refract",
                                       n1_fn=el.n, n2_fn=n2, pos_host=ph(el.back)))
                n_before = n2
            elif isinstance(el, Filter):
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "filter",
                                       spectrum_fn=el.spectrum, pos_host=ph(el.front)))
            elif isinstance(el, Aperture):
                kind = "ring" if isinstance(el.front, RingSurface) \
                    else ("slit" if isinstance(el.front, SlitSurface) else "")
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "absorb",
                                       hurb=bool(kind), hurb_kind=kind,
                                       pos_host=ph(el.front)))
        return steps

    def _trace_steps(self):
        """The step list of :meth:`trace` and the prepared runs that go
        with it (``trace_core.RunPlans``). Both are kept from one trace to
        the next and built anew as soon as the scene differs: another
        element object in the list, or another snapshot of the lenses,
        filters, apertures, outline, ambient medium or device (the change detector
        that ``check_if_rays_are_current`` trusts). The kept elements stay
        referenced, so no object that the snapshot names by identity can be
        freed and replaced unnoticed."""
        elements = self._tracing_elements()[:-1]    # the end absorber follows from the outline
        snap = self.tracing_snapshot()
        key = (snap["Lenses"], snap["Filters"], snap["Apertures"], snap["Ambient"],
               str(self.device))
        kept = self._compiled
        if (kept is None or kept[1] != key or len(kept[0]) != len(elements)
                or any(a is not b for a, b in zip(kept[0], elements))):
            steps = self._build_steps()
            kept = self._compiled = (elements, key, steps, RunPlans(steps))
        return kept[2], kept[3]

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
                               "Either decrease the number of rays, surfaces or do an iterative "
                               "render, or increase Raytracer.MAX_RAY_STORAGE_RAM.")

        bar = ProgressBar("Raytracing: ", 3)
        self._dev_sections = None
        self.rays.init(self.ray_sources, N, nt, self.no_pol, seed=self._seed_counter)

        steps, plans = self._trace_steps()
        source_fn = self._make_source_fn(N)
        bar.update()

        self._seed_counter += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed_counter)
        with torch.no_grad():
            p, s, pols, w, wl = source_fn(gen)
            out = trace_bundle(steps, self.n0, tuple(float(v) for v in self.outline),
                               p, s, pols, w, wl, self.no_pol, self.use_hurb, gen=gen,
                               hurb_factor=float(self.HURB_FACTOR), plans=plans)
        kept = (out["p"], out["w"], out["wl"])
        out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in out.items() if k in ("p", "w", "pol", "n", "wl", "infos")}
        bar.update()

        s0 = out["p"][:, 1] - out["p"][:, 0]
        norm = np.linalg.norm(s0, axis=-1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            s0 = np.where(norm > 0, s0 / norm, s0)
        self.rays.fill(out["p"], out["w"], out["pol"], out["n"], out["wl"], s0)
        self.rays.lock()
        # the device tensors belong to this very host array: a storage that
        # is filled anew by other means no longer matches them
        self._dev_sections = (self.rays.p_list, *kept)

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
                if not el.has_back() or isinstance(el, IdealLens):
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

    # ------------------------------------------------------------------
    # detector hit search over the stored sections

    def _hit_detector(self, info: str, detector_index: int = 0, source_index: int = None,
                      extent=None, projection_method: str = "Equidistant"):
        if not self.detectors:
            raise RuntimeError("Detector Missing")
        if not self.rays.N:
            raise RuntimeError("No rays traced.")
        if source_index is not None and (source_index > len(self.ray_sources) - 1 or source_index < 0):
            raise IndexError("Invalid source_index.")
        if detector_index > len(self.detectors) - 1 or detector_index < 0:
            raise IndexError("Invalid detector_index.")
        if not self.check_if_rays_are_current():
            raise RuntimeError("Tracing geometry/properties changed. Please retrace first.")

        bar = ProgressBar(f"{info}: ", 2)
        Ns, Ne = self.rays.B_list[source_index:source_index + 2] if source_index is not None \
            else (0, self.rays.N)

        dsurf = self.detectors[detector_index].surface
        det_zmin = float(dsurf.z_min)
        seg_mask = build_segment_mask(self._section_z_bounds(), det_zmin, float(dsurf.z_max))

        # the hit solve runs in f64 on the raytracer's device (a
        # once-per-image step; the fused streaming render never comes
        # through here and stays f32), and so does the selection of the
        # hits: only the extent and the ill-conditioned count reach the host
        with torch.no_grad():
            sfns = compile_surface(dsurf, self.device, dtype=torch.float64)
            p_all, w_all, wl = self._sections(Ns, Ne)
            ph, w, ish, n_ill = detector_hits(sfns, det_zmin, p_all, w_all, segment_mask=seg_mask)
            del p_all, w_all
            bar.update()

            hitw = ish & (w > 0)
            ph, w, wl = ph[hitw], w[hitw], wl[hitw]
            ill_count = int(n_ill)

            if isinstance(dsurf, SphericalSurface) and projection_method is not None:
                x, y = sphere_projection_xy(ph[:, 0], ph[:, 1], ph[:, 2],
                                            tuple(float(v) for v in dsurf.pos), float(dsurf.R),
                                            projection_method)
                ph = torch.stack([x, y, ph[:, 2]], dim=-1)
                projection = projection_method
            else:
                projection = None

            if isinstance(extent, (list, np.ndarray)):
                inside = (extent[0] <= ph[:, 0]) & (ph[:, 0] <= extent[1]) \
                    & (extent[2] <= ph[:, 1]) & (ph[:, 1] <= extent[3])
                extent_out = np.asarray(np.array(extent).copy(), dtype=np.float64)
                pc.check_finite("extent", extent_out)
                ph, w, wl = ph[inside], w[inside], wl[inside]
            elif extent is None:
                extent_out = self.detectors[detector_index].pos[:2].repeat(2)
                if ph.shape[0]:
                    mn, mx = ph[:, :2].amin(dim=0), ph[:, :2].amax(dim=0)
                    extent_out[:] = torch.stack([mn[0], mx[0], mn[1], mx[1]]).tolist()
            else:
                raise ValueError(f"Invalid extent '{extent}'.")

        return ph, w, wl, extent_out, projection, bar, ill_count

    def _sections(self, Ns: int, Ne: int):
        """Stored sections of the rays Ns … Ne on the raytracer's device:
        positions (n, nt, 3) and weights (n, nt) in f64, wavelengths (n,)
        in f32. They come from the tensors that :meth:`trace` kept; a
        storage that was filled by other means is uploaded. Both give the
        same numbers: the host's f64 sections are exact images of the f32
        values on the device."""
        kept = self._dev_sections
        if kept is not None and kept[0] is self.rays.p_list:
            p, w, wl = (t[Ns:Ne] for t in kept[1:])
            return p.to(torch.float64), w.to(torch.float64), wl
        self._dev_sections = None

        def up(a, dtype):
            with warnings.catch_warnings():     # the stored arrays are read-only, and only read here
                warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
                return torch.as_tensor(np.asarray(a, dtype=dtype), device=self.device)
        return (up(self.rays.p_list[Ns:Ne], np.float64), up(self.rays.w_list[Ns:Ne], np.float64),
                up(self.rays.wl_list[Ns:Ne], np.float32))

    # ------------------------------------------------------------------
    # image / spectrum rendering

    def detector_image(self, detector_index: int = 0, source_index: int = None,
                       extent=None, limit: float = None,
                       projection_method: str = "Equidistant", **kwargs) -> RenderImage:
        """Render the detector image from the stored trace. The hit search,
        the selection of the hits and the binning run on the raytracer's
        device."""
        if limit is not None and extent is not None and "_dont_filter" not in kwargs:
            warning("Using the limit parameter with a user defined extent will produce an "
                    "incorrect detector image, as rays outside the extent are not convolved.")

        p, w, wl, extent_out, projection, bar, ill_count = \
            self._hit_detector("Detector Image", detector_index, source_index, extent, projection_method)

        detector = self.detectors[detector_index]
        pname = f": {detector.desc}" if detector.desc != "" else ""
        desc = f"{Detector.abbr}{detector_index}{pname} at z = {detector.pos[2]:.5g} mm"
        if source_index is not None:
            desc = f"Rays from RS{source_index} at " + desc

        img = RenderImage(long_desc=desc, extent=extent_out, projection=projection)
        img.render(p, w, wl, limit=limit, device=self.device, **kwargs)
        bar.finish()

        if ill_count:
            warning(f"{ill_count} rays ({100 * ill_count / self.rays.N:.3g}% of all rays) were "
                    f"ill-conditioned for hit finding at detector {detector_index}.")
        return img

    def detector_spectrum(self, detector_index: int = 0, source_index: int = None,
                          extent=None, **kwargs) -> LightSpectrum:
        """Render the spectrum of the light on a detector from the stored trace."""
        p, w, wl, extent, _, bar, ill_count = \
            self._hit_detector("Detector Spectrum", detector_index, source_index, extent)
        detector = self.detectors[detector_index]
        pname = f": {detector.desc}" if detector.desc != "" else ""
        desc = f"{Detector.abbr}{detector_index}{pname} at z = {detector.pos[2]:.5g} mm"
        desc = (f"Spectrum of RS{source_index} at " if source_index is not None else "Spectrum at ") + desc
        spec = LightSpectrum.render(wl, w, long_desc=desc, **kwargs)
        bar.finish()
        return spec

    def _hit_source(self, info: str, source_index: int = 0):
        if not self.ray_sources:
            raise RuntimeError("Ray Sources Missing.")
        if not self.rays.N:
            raise RuntimeError("No rays traced.")
        if source_index > len(self.ray_sources) - 1 or source_index < 0:
            raise IndexError("Invalid source_index.")
        if not self.check_if_rays_are_current():
            raise RuntimeError("Tracing geometry/properties changed. Please retrace first.")

        bar = ProgressBar(f"{info}: ", 2)
        extent = self.ray_sources[source_index].extent[:4]
        Ns, Ne = self.rays.B_list[source_index:source_index + 2]
        p, w, wl = self._sections(Ns, Ne)
        bar.update()
        return p[:, 0], w[:, 0], wl, extent, bar

    def source_spectrum(self, source_index: int = 0, **kwargs) -> LightSpectrum:
        """Render the spectrum of one source from the stored trace."""
        p, w, wl, extent, bar = self._hit_source("Source Spectrum", source_index)
        rs = self.ray_sources[source_index]
        pname = f": {rs.desc}" if rs.desc != "" else ""
        desc = f"Spectrum of {RaySource.abbr}{source_index}{pname} at z = {rs.pos[2]:.5g} mm"
        spec = LightSpectrum.render(wl, w, long_desc=desc, **kwargs)
        bar.finish()
        return spec

    def source_image(self, source_index: int = 0, limit: float = None, **kwargs) -> RenderImage:
        """Render the image of one source from the stored trace; the
        binning runs on the raytracer's device."""
        p, w, wl, extent, bar = self._hit_source("Source Image", source_index)
        rs = self.ray_sources[source_index]
        pname = f": {rs.desc}" if rs.desc != "" else ""
        desc = f"{RaySource.abbr}{source_index}{pname} at z = {rs.pos[2]:.5g} mm"
        img = RenderImage(long_desc=desc, extent=extent, projection=None)
        img.render(p, w, wl, limit=limit, device=self.device, **kwargs)
        bar.finish()
        return img

    # ------------------------------------------------------------------
    # iterative (batched) rendering

    def iterative_render(self, N, detector_index=0, limit=None,
                         projection_method="Equidistant", pos=None, extent=None) -> list:
        """Accumulate detector images over ITER_RAYS_STEP-sized traces. The
        first batch is a stored trace, which fixes the automatic extents;
        the others go through the fused streaming render, are summed on the
        device and reach the host once, at the end."""
        if not self.ray_sources:
            raise RuntimeError("Ray Source(s) Missing.")
        if not self.detectors:
            raise RuntimeError("Detector(s) Missing.")
        if (N := int(N)) <= 0:
            raise ValueError(f"Ray number N_rays needs to be a positive int, but is {N}.")

        if pos is None:
            if isinstance(detector_index, list):
                raise ValueError("detector_index list needs to have the same length as pos list")
            pos = [self.detectors[detector_index].pos]
        elif isinstance(pos, list) and not isinstance(pos[0], (list, np.ndarray)):
            pos = [pos]

        if not isinstance(detector_index, list):
            detector_index = [detector_index] * len(pos)
        elif len(detector_index) != len(pos):
            raise ValueError("detector_index list needs to have the same length as pos list")
        if not isinstance(limit, list):
            limit = [limit] * len(pos)
        elif len(limit) != len(pos):
            raise ValueError("limit list needs to have the same length as pos list")
        if not isinstance(projection_method, list):
            projection_method = [projection_method] * len(pos)
        elif len(projection_method) != len(pos):
            raise ValueError("projection_method list needs to have the same length as pos list")
        if not isinstance(extent, list) or isinstance(extent[0], (int, float)):
            extent = [extent] * len(pos)
        elif len(extent) != len(pos):
            raise ValueError("extent list needs to have the same length as pos list")
        extentc = list(extent).copy()

        rays_step = self.ITER_RAYS_STEP
        iterations = max(1, int(N / rays_step))
        bar = ProgressBar("Rendering: ", iterations)

        DIm_res = []
        if self._pretrace_check(min(rays_step, N)):
            raise RuntimeError("Geometry checks failed. Tracing aborted. Check the warnings.")

        nt = len(self.tracing_surfaces) + 2
        msgs_cum = np.zeros((N_INFOS, nt), dtype=int)

        # batch 1 through the stored-section path: it determines the auto
        # extents and builds the RenderImage headers
        first_step = rays_step + (int(N - iterations * rays_step) if iterations == 1 else 0)
        with global_options.no_warnings(), global_options.no_progress_bar():
            self.trace(N=first_step)
            if self._msgs.shape == msgs_cum.shape:
                msgs_cum += self._msgs

        for j in range(len(pos)):
            self.detectors[detector_index[j]].move_to(pos[j])
            with global_options.no_progress_bar(), global_options.no_warnings():
                Imi = self.detector_image(detector_index=detector_index[j],
                                          extent=extentc[j], limit=limit[j], _dont_filter=True,
                                          projection_method=projection_method[j])
            Imi._data *= first_step / N
            DIm_res.append(Imi)
            extentc[j] = Imi._extent0
        bar.update()

        # the remaining batches run the fused streaming path: source → trace
        # → detector sink → bin for each batch, O(rays_step) memory, and no
        # host round trip but for the INFOS counters
        if iterations > 1:
            from ..parallel.render import make_fused_render_multi
            from ..parallel.checkpoint import batch_generator
            self._dev_sections = None       # the stored trace has served; free its device memory

            def build(nrays):
                # pos goes INTO the config so make_fused_render_multi moves
                # the detector before capturing each sink: one detector at
                # several positions must bind each position, not the last
                configs = [dict(detector_index=detector_index[j],
                                pos=pos[j],
                                extent=tuple(DIm_res[j].extent),
                                filter_extent=tuple(extentc[j]),
                                projection_method=projection_method[j],
                                Ny=DIm_res[j]._data.shape[0],
                                Nx=DIm_res[j]._data.shape[1])
                           for j in range(len(pos))]
                return make_fused_render_multi(self, nrays, configs, device=self.device)[0]

            step_fn = build(rays_step)
            base_seed = 0x17E7 + self._seed_counter
            acc = [torch.zeros(DIm._data.shape, dtype=torch.float64, device=self.device)
                   for DIm in DIm_res]
            infos_acc = torch.zeros((N_INFOS, nt), dtype=torch.int64, device=self.device)
            with torch.no_grad():
                for i in range(1, iterations):
                    ni = rays_step if i < iterations - 1 \
                        else rays_step + int(N - iterations * rays_step)
                    if ni != rays_step:
                        step_fn = build(ni)
                    imgs, infos = step_fn(batch_generator(base_seed, i, self.device))
                    for j in range(len(pos)):
                        acc[j] += imgs[j].to(torch.float64) * (ni / N)
                    if infos.shape == infos_acc.shape:
                        infos_acc += infos
                    bar.update()
            for j in range(len(pos)):
                DIm_res[j]._data += acc[j].cpu().numpy()
            msgs_cum += infos_acc.cpu().numpy()

        for i, DIm in enumerate(DIm_res):
            if limit[i] is not None:
                DIm._limit = limit[i]
                DIm._apply_rayleigh_filter()

        bar.finish()
        self._msgs = msgs_cum
        self._show_messages(N)
        return DIm_res

    # ------------------------------------------------------------------
    # huge renders: fused streaming batches, checkpointed

    def render_huge(self, N, detector_index: int = 0, extent=None,
                    limit: float = None, projection_method: str = "Equidistant",
                    batch_size: int = None, mesh=None,
                    checkpoint_path: str = None, checkpoint_every: int = 10) -> RenderImage:
        """Render a detector image from 10⁸ rays and more in O(batch) memory.

        Each batch is one source → trace → detector sink → bin pass of the
        fused render; no ray sections are ever stored. With
        ``checkpoint_path`` progress is saved every ``checkpoint_every``
        batches and a later call resumes with the same remaining batches
        (each batch has its own generator, see ``parallel/checkpoint.py``).

        :param extent: fixed image extent; defaults to the detector
            surface extent (an automatic extent would need a stored trace)
        :param mesh: rendering over several devices is not ported yet
        :return: accumulated RenderImage
        """
        if mesh is not None:
            raise NotImplementedError("render_huge over several devices (mesh) is not ported yet: "
                                      "see ROADMAP.md, the sharded render over torch.distributed")
        if not self.detectors:
            raise RuntimeError("Detector(s) Missing.")
        if (N := int(N)) <= 0:
            raise ValueError(f"Ray number N needs to be a positive int, but is {N}.")
        if self._pretrace_check(min(N, self.ITER_RAYS_STEP)):
            raise RuntimeError("Geometry checks failed. Tracing aborted. Check the warnings.")

        from ..parallel.render import make_fused_render_multi
        from ..parallel.checkpoint import RenderCheckpoint

        batch = int(batch_size) if batch_size else min(N, self.ITER_RAYS_STEP)
        n_batches = max(1, -(-N // batch))

        detector = self.detectors[detector_index]
        dsurf = detector.surface
        ext = tuple(dsurf.extent[:4]) if extent is None else tuple(extent)

        pname = f": {detector.desc}" if detector.desc != "" else ""
        desc = f"{Detector.abbr}{detector_index}{pname} at z = {detector.pos[2]:.5g} mm"
        img = RenderImage(long_desc=desc, extent=np.asarray(ext, dtype=np.float64),
                          projection=projection_method
                          if isinstance(dsurf, SphericalSurface) else None)
        img.render(limit=limit, _dont_filter=True)   # fix extent, alloc zeros
        Ny, Nx, _ = img._data.shape

        render, _ = make_fused_render_multi(
            self, batch, [dict(detector_index=detector_index,
                               extent=tuple(img.extent),
                               projection_method=projection_method,
                               Nx=Nx, Ny=Ny)], device=self.device)

        ck = RenderCheckpoint(checkpoint_path, n_batches)
        bar = ProgressBar("Rendering: ", n_batches - ck.done)
        with torch.no_grad():
            for i in ck.remaining():
                ck.add(render(ck.generator(i, self.device))[0][0])
                if checkpoint_path and (i % checkpoint_every == checkpoint_every - 1):
                    ck.save()
                bar.update()
        if checkpoint_path:
            ck.save()
        bar.finish()

        img._data += ck.image()
        if limit is not None:
            img._apply_rayleigh_filter()
        return img
