"""Raytracer: scene orchestration around the trace core.

Counterpart of ``optrace_tpu/tracer/raytracer.py``: geometry checks with
sampled collision detection and the sequential trace with INFOS warning
counters. The trace runs on one device (``device=None`` is the CUDA
device; the CPU only on request), rays are generated on that device from a
``torch.Generator``, and the stored sections stay there, in
:class:`RayStorage`, whose host arrays (``RT.rays.p_list`` …) are made at
their first read. What a trace needs besides the rays (its steps, their
prepared runs and the sources' samplers) is kept for each scene and ray
count, as the JAX package keeps a compiled trace (:meth:`Raytracer._trace_entry`);
on a CUDA device the trace of a key is captured into a CUDA graph at its
:data:`TRACE_CAPTURE_CALL`-th call and replayed after it, for at most
:data:`MAX_GRAPHED_TRACES` keys at a time.
``detector_image``, ``detector_spectrum``, ``source_image`` and
``source_spectrum`` read the sections on the device, search the detector
hits in f64 and bin them on the same device with sums that do not depend on
the order of the rays, and return host objects. ``iterative_render`` and
``render_huge`` stream batch after batch through the fused render
(``parallel/render.py``) and store no sections; ``render_huge(mesh=...)``
shards each batch over the ranks of a ``torch.distributed`` device mesh.
``focus_search`` reduces the kept sections to ray lines on the device and
sweeps the focus costs there (``analysis/focus.py``).
"""

from collections import OrderedDict, namedtuple
from enum import IntEnum
from typing import Any, Callable, NamedTuple

import numpy as np
import scipy.optimize
import torch

from .detector import detector_hits, build_segment_mask, sphere_projection_xy
from .ray_storage import RayStorage
from .scene_compile import compile_surface
from .trace_core import TraceStep, trace_bundle, RunPlans, N_INFOS
from ..geometry import (Group, Lens, IdealLens, Filter, Aperture, Detector, RaySource,
                        Surface, RingSurface, SlitSurface, SphericalSurface,
                        RectangularSurface, Point, Line)
from ..image.render_image import RenderImage
from ..ops.binning import block_sums
from ..parallel.graph import CapturedStep, capture
from ..spectrum.refraction_index import RefractionIndex
from ..spectrum.light_spectrum import LightSpectrum
from ..analysis import focus
from ..utils.device import resolve_device
from ..utils.global_options import global_options
from ..utils.property_checker import PropertyChecker as pc
from ..utils.progress_bar import ProgressBar
from ..utils.tracing import span
from ..utils.warnings import warning

TRACE_CACHE_SIZE = 32       # entries of the trace cache, as in the JAX package
# A trace entry's graph holds a private pool of about the eager trace's peak
# (its outputs and the trace's temporaries: on the H100 0.55 GB for the double
# Gauss at 10⁶ rays without polarization, 0.80 GB with it, 1.37 GB for the
# 57-surface stack; PERF.md §5), so only the entries of the last few keys
# traced keep one: the least recently used loses its graph first.
MAX_GRAPHED_TRACES = 2
# A key's trace is captured at its TRACE_CAPTURE_CALL-th call. On the H100 at
# 10⁶ rays a double-Gauss hit without polarization took 12.9–14.4 ms eager and
# 9.2–9.8 ms replayed, and the capture with its first replay 0.029 s (PERF.md
# §5; with polarization and on the 57-surface stack the replay saves 8 ms a
# hit and the capture costs as much). The capture costs about 16 ms more than
# an eager hit, which four replays win back (4 × 4.2 ms); capturing after as
# many eager hits as a capture costs keeps a key that is traced only a few
# times within twice its best cost: the miss, four eager hits, the capture.
TRACE_CAPTURE_CALL = 6


class _TraceEntry(namedtuple("_TraceEntry", "elements sources program run eager_reason")):
    """What a trace of one scene and ray count needs besides its rays: the
    tracing elements and sources it was built from (kept, so that no object
    the snapshot names by identity can be freed and replaced unnoticed), the
    compiled scene, and ``run(gen) -> (p, w, pol, n, wl, infos)``, the whole
    trace: eager, or on a CUDA device a :class:`CapturedStep` that is
    captured at the key's :data:`TRACE_CAPTURE_CALL`-th call and replayed
    after it. ``eager_reason`` says why a trace stays eager (None where it
    is graphed)."""

    @property
    def graphed(self) -> bool:
        """Whether the trace is captured at its key's
        :data:`TRACE_CAPTURE_CALL`-th call."""
        return isinstance(self.run, CapturedStep)

    def drop(self) -> None:
        """Let go of the graph and its pool, where there is one."""
        if self.graphed:
            self.run.drop()


def _eager_reason(steps: list, sources: list) -> str | None:
    """Why a trace of these steps and sources cannot be captured into a CUDA
    graph, or None: a user function that the trace calls (a function
    surface's, a "Function" medium's or spectrum's, a source's orientation
    function) may make a tensor from host data, which a capture cannot
    record, and a data surface's sag is the surface object's own code as
    well. Decided before any capture, from the scene alone."""
    for i, st in enumerate(steps):
        if st.sfns.kind == "generic":
            return f"step {i} is a function or data surface: its sag, normals and mask run the " \
                   "surface object's own Python code"
        for fn in (st.n1_fn, st.n2_fn, st.spectrum_fn):
            if getattr(fn, "spectrum_type", None) == "Function":
                return f"step {i} evaluates a user function ({type(fn).__name__} of type 'Function')"
    for i, src in enumerate(sources):
        if src.orientation == "Function":
            return f"ray source {i} has a user orientation function (orientation='Function')"
    return None


class TraceProgram(NamedTuple):
    """A scene compiled for :func:`~.trace_core.trace_bundle` by
    :meth:`Raytracer.trace_program`. The stored trace, the fused and sharded
    render and the design render each trace through one, and so through
    this module's ``trace_bundle``, the one name every path's trace takes."""
    steps: list
    plans: RunPlans
    sample: Callable            # gen -> the sources' rays (p, s, pols, w, wl)
    n0_fn: Callable             # the ambient medium, its table on the device
    outline: tuple
    no_pol: bool
    use_hurb: bool
    hurb_factor: float

    def trace(self, rays, gen, sinks=None, store_sections: bool = True, steps: list = None) -> dict:
        """The trace of ``rays`` (p, s, pols, w, wl); ``steps`` in place of
        the program's own (the design render's) take no prepared runs."""
        own = steps is None
        return trace_bundle(self.steps if own else steps, self.n0_fn, self.outline, *rays, self.no_pol,
                            self.use_hurb, gen=gen, sinks=sinks, store_sections=store_sections,
                            hurb_factor=self.hurb_factor, plans=self.plans if own else None)


# what the geometry checks of one scene found: the warnings they raised, in
# order, whether the scene has an error and where a collision lies (None:
# fault_pos stays as it was), with the objects the checks were made on
_GeometryOutcome = namedtuple("_GeometryOutcome", "elements sources messages error fault_pos")


class Raytracer(Group):

    N_EPS: float = 1e-11
    HURB_FACTOR: float = 2 ** 0.5
    MAX_RAY_STORAGE_RAM: int = 6000000000
    ITER_RAYS_STEP: int = 1000000
    T_TH: float = 0.0

    focus_search_methods: list = ['RMS Spot Size', 'Irradiance Variance',
                                  'Image Sharpness', 'Image Center Sharpness']

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
        self._trace_cache = OrderedDict()      # (scene snapshot, device, N) -> _TraceEntry, LRU
        self._geometry_cache = OrderedDict()   # scene snapshot -> _GeometryOutcome, LRU
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
        for entry in self._trace_cache.values():
            entry.drop()
        self._trace_cache.clear()
        self._geometry_cache.clear()

    # ------------------------------------------------------------------
    # snapshots / change detection

    def property_snapshot(self) -> dict:
        return self.tracing_snapshot() | dict(
            Markers=[D.crepr() for D in self.markers],
            Volumes=[D.crepr() for D in self.volumes],
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
        return self._last_trace_snapshot is not None and not self.compare_property_snapshot(
            self._last_trace_snapshot, self.tracing_snapshot())["Any"]

    @staticmethod
    def _scene_key(snap: dict) -> tuple:
        """The scene part of a tracing snapshot: lenses, filters, apertures,
        ray sources, ambient medium and outline, and the trace settings."""
        return tuple(tuple(snap[k]) for k in ("Lenses", "Filters", "Apertures", "RaySources",
                                               "Ambient", "TraceSettings"))

    def _cached(self, cache: OrderedDict, key, elements: list, sources: list, build, evict=None):
        """The entry of ``key`` in an LRU cache of :data:`TRACE_CACHE_SIZE`
        entries that evicts one oldest entry at a time; ``build()`` makes
        it where there is none, or where the entry was made from other
        element or source objects than those now in the scene.
        ``evict(entry)``, where given, is called for each entry that leaves."""
        entry = cache.get(key)
        if entry is not None and len(entry.elements) == len(elements) \
                and all(a is b for a, b in zip(entry.elements + entry.sources, elements + sources)):
            cache.move_to_end(key)
            return entry
        gone = [cache.pop(key)] if key in cache else []
        while len(cache) >= TRACE_CACHE_SIZE:
            gone.append(cache.popitem(last=False)[1])
        if evict is not None:
            for old in gone:
                evict(old)
        entry = cache[key] = build()
        return entry

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

    def _geometry_outcome(self, elements: list) -> tuple:
        """The geometry checks of the scene as it is now, with its tracing
        elements ``elements`` (the end absorber last): (warnings in order,
        error, collision positions or None)."""
        def is_inside(e) -> bool:
            o = self.outline + self.N_EPS * np.array([-1, 1, -1, 1, -1, 1])
            return o[0] <= e[0] and e[1] <= o[1] and o[2] <= e[2] and e[3] <= o[3] \
                and o[4] <= e[4] and e[5] <= o[5]

        if not self.ray_sources:
            return ["RaySource Missing."], True, None

        coll = False
        xc = yc = zc = np.array([])
        for i, el in enumerate(elements):
            if not is_inside(el.extent):
                return [f"Element{i} {el} with extent {el.extent} outside outline {self.outline}."], \
                    True, None

            if i + 1 < len(elements):
                coll, xc, yc, zc = self.check_collision(el.front, elements[i + 1].front)
            if not coll and el.has_back():
                coll, xc, yc, zc = self.check_collision(el.front, el.back)
            if not coll and el.has_back():
                coll, xc, yc, zc = self.check_collision(el.back, elements[i + 1].front)

            if self.use_hurb and i < len(elements) - 1 and isinstance(el, Aperture):
                if not isinstance(el.front, (RingSurface, SlitSurface)):
                    return [f"Ray bending for surface type {type(el.front).__name__} not implemented."], \
                        True, None
            if coll:
                break

        if not coll:
            for rs in self.ray_sources:
                if not is_inside(rs.extent):
                    return [f"RaySource {rs} with extent {rs.extent} outside outline {self.outline}."], \
                        True, None
                if isinstance(rs.surface, (Surface, Point, Line)) and rs.pos[2] >= elements[0].extent[4]:
                    coll, xc, yc, zc = self.check_collision(rs.surface, elements[0].front)
                if coll:
                    break

        if coll:
            return [f"Detected collision between two Surfaces at {xc[0], yc[0], zc[0]}"
                    f" and at least {xc.shape[0]} other positions."], True, np.column_stack((xc, yc, zc))
        return [], False, None

    def _geometry_checks(self, snap: dict = None) -> None:
        """Check the geometry before a trace: raise the warnings of what is
        wrong and set ``geometry_error`` and, for a collision, ``fault_pos``.
        The outcome is kept for each scene (``snap``, the tracing snapshot
        of the scene as it is now, taken here when not given) and replayed
        while the scene is the same: the same warnings in the same order and
        the same state as a fresh check. An outcome also holds the element
        and source objects it was found on, and is found anew when another
        object stands in their place; the cache is emptied by ``clear()``."""
        elements = self._tracing_elements()
        sources = list(self.ray_sources)
        snap = self.tracing_snapshot() if snap is None else snap
        out = self._cached(self._geometry_cache, self._scene_key(snap), elements[:-1], sources,
                           lambda: _GeometryOutcome(elements[:-1], sources,
                                                    *self._geometry_outcome(elements)))
        for message in out.messages:
            warning(message)
        self.geometry_error = out.error
        if out.fault_pos is not None:
            self.fault_pos = out.fault_pos.copy()

    def _pretrace_check(self, N: int, snap: dict = None) -> bool:
        pc.check_type("N", N, int)
        if N < 1:
            raise ValueError(f"Ray number N needs to be at least 1, but is {N}.")
        self._geometry_checks(snap)
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
        n_before = n0 = self.n0.on_device(device, dtype)

        def ph(surf):
            return tuple(float(v) for v in surf.pos)

        # media and spectra with their tables on the device (Spectrum.on_device)
        for el in self._tracing_elements():
            if isinstance(el, IdealLens):
                n2 = el.n2.on_device(device, dtype) if el.n2 is not None else n0
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "ideal",
                                       n1_fn=n_before, n2_fn=n2, D=el.D, pos_host=ph(el.front)))
                n_before = n2
            elif isinstance(el, Lens):
                n2 = el.n2.on_device(device, dtype) if el.n2 is not None else n0
                n = el.n.on_device(device, dtype)
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "refract",
                                       n1_fn=n_before, n2_fn=n, pos_host=ph(el.front)))
                steps.append(TraceStep(compile_surface(el.back, device, dtype), "refract",
                                       n1_fn=n, n2_fn=n2, pos_host=ph(el.back)))
                n_before = n2
            elif isinstance(el, Filter):
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "filter",
                                       spectrum_fn=el.spectrum.on_device(device, dtype),
                                       pos_host=ph(el.front)))
            elif isinstance(el, Aperture):
                kind = "ring" if isinstance(el.front, RingSurface) \
                    else ("slit" if isinstance(el.front, SlitSurface) else "")
                steps.append(TraceStep(compile_surface(el.front, device, dtype), "absorb",
                                       hurb=bool(kind), hurb_kind=kind,
                                       pos_host=ph(el.front)))
        return steps

    def trace_program_key(self, snap: dict = None) -> tuple:
        """What a compiled scene (:meth:`trace_program`) depends on besides
        N and its device: the scene part of the tracing snapshot (``snap``,
        taken here when not given) and the wavelength range, which the
        sources' samplers read when they are built. The stored trace keys
        its cache by it; a render step on the card compares it at every call."""
        snap = self.tracing_snapshot() if snap is None else snap
        return self._scene_key(snap) + (tuple(global_options.wavelength_range),)

    def trace_program(self, N: int, device=None, apportion: bool = True) -> TraceProgram:
        """The scene as it is now compiled for N rays on ``device`` (default:
        the raytracer's), its tables made there once. With ``apportion`` N is
        first split among the sources (``rays.init``, unseeded), as a render
        does; the stored trace splits it with its own seed beforehand."""
        device = self.device if device is None else torch.device(device)
        if apportion:
            self.rays.init(self.ray_sources, N, len(self.tracing_surfaces) + 2, self.no_pol)
        steps = self._build_steps(device)
        return TraceProgram(steps, RunPlans(steps), self._make_source_fn(N, device),
                            self.n0.on_device(device), tuple(float(v) for v in self.outline),
                            self.no_pol, self.use_hurb, float(self.HURB_FACTOR))

    def _trace_entry(self, N: int, snap: dict = None) -> _TraceEntry:
        """The compiled scene and the whole trace of N rays through the
        scene as it is now: the counterpart of the JAX package's
        ``_get_trace_fn``, whose ``jax.jit`` the trace's CUDA graph stands
        for. An entry is kept for each key, :meth:`trace_program_key` (of
        ``snap``, taken here when not given), the rays a source draws
        (``rays.N_list``, set by ``rays.init``), the device and N, in a
        least-recently-used cache of :data:`TRACE_CACHE_SIZE` entries
        (:meth:`_cached`; ``clear()`` empties it). An entry also holds the
        element and source objects it was built from, and is built anew
        when another object stands in their place. The entries hold tables
        (kB to MB), never rays, except that of a graphed trace: its
        graph's pool (:data:`MAX_GRAPHED_TRACES`). The JAX package's
        ``_get_trace_fn`` leaves the wavelength range out of its key and
        keeps drawing the old range."""
        elements = self._tracing_elements()[:-1]    # the end absorber follows from the outline
        sources = list(self.ray_sources)
        key = self.trace_program_key(snap) + (tuple(int(n) for n in self.rays.N_list), str(self.device),
                                              int(N))

        def build():
            program = self.trace_program(N, apportion=False)

            def trace_fn(gen):
                with torch.no_grad():
                    out = program.trace(program.sample(gen), gen)
                return out["p"], out["w"], out["pol"], out["n"], out["wl"], out["infos"]

            reason = _eager_reason(program.steps, sources)
            run = trace_fn if reason else capture(trace_fn, self.device, eager_calls=TRACE_CAPTURE_CALL - 1,
                                                  name="stored trace")
            if reason is None and run is trace_fn:
                reason = f"a trace on {self.device} runs eagerly (CUDA graphs are for CUDA devices)"
            return _TraceEntry(elements, sources, program, run, reason)
        return self._cached(self._trace_cache, key, elements, sources, build, _TraceEntry.drop)

    def _bound_graphs(self, entry: _TraceEntry) -> None:
        """Before ``entry`` captures its trace, drop the graphs of the least
        recently used other entries until :data:`MAX_GRAPHED_TRACES` graphs
        at most remain with the new one."""
        if not (entry.graphed and entry.run.captures_next):
            return
        held = [e for e in self._trace_cache.values()
                if e is not entry and e.graphed and e.run.graph is not None]     # oldest first
        for e in held[:max(0, len(held) - MAX_GRAPHED_TRACES + 1)]:
            e.drop()

    def _make_source_fn(self, N: int, device=None):
        """Ray generation for all sources with static per-source counts:
        ``gen -> (p, s, pols, w, wl)`` on ``device`` (default: the
        raytracer's), whose generator ``gen`` is. The sources' tables and
        constants are made on the device here, once."""
        device = self.device if device is None else torch.device(device)
        samplers = [src.ray_sampler(int(Ni), device, no_pol=self.no_pol, power=src.power)
                    for src, Ni in zip(self.ray_sources, self.rays.N_list) if int(Ni)]

        def source_fn(gen):
            with span("sampling"):
                parts = [sample(gen) for sample in samplers]
                if len(parts) == 1:
                    return parts[0]
                return tuple(torch.cat(xs, dim=0) for xs in zip(*parts))
        return source_fn

    # ------------------------------------------------------------------
    # tracing

    def trace(self, N: int) -> None:
        """Trace N rays through the geometry and store their sections."""
        with span("trace"):
            N = int(N)
            with span("trace.prepare"):
                snap = self.tracing_snapshot()      # the scene as it is traced: read once
                if self._pretrace_check(N, snap):
                    return

                nt = len(self.tracing_surfaces) + 2
                if self.rays.storage_size(N, nt, self.no_pol) > self.MAX_RAY_STORAGE_RAM:
                    raise RuntimeError(f"More than {self.MAX_RAY_STORAGE_RAM * 1e-9:.1f} GB RAM requested. "
                                       "Either decrease the number of rays, surfaces or do an iterative "
                                       "render, or increase Raytracer.MAX_RAY_STORAGE_RAM.")

                bar = ProgressBar("Raytracing: ", 3)
                self.rays.init(self.ray_sources, N, nt, self.no_pol, seed=self._seed_counter)
                entry = self._trace_entry(N, snap)
                bar.update()

                self._seed_counter += 1
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self._seed_counter)
                self._bound_graphs(entry)
                # the last trace's tensors go first, where no one else holds them
                self.rays.drop_arrays()
            # a replayed trace returns copies of its graph's outputs, which the
            # next replay overwrites
            with span("trace.run"):
                p, w, pol, n, wl, infos = entry.run(gen)
            # the sections stay on the device: the storage makes its host arrays
            # at their first read
            with span("trace.fill"):
                self.rays.fill(p, w, pol, n, wl)
                self.rays.lock()
            with span("trace.infos_wait"):
                self._msgs = infos.cpu().numpy().astype(int)      # the one copy: waits for the trace
            del p, w, pol, n, wl, infos
            bar.update()
            with span("trace.messages"):
                self._show_messages(N)
            bar.finish()

            # the scene did not change while it was traced, the rays did
            self._last_trace_snapshot = dict(snap, Rays=self.rays.crepr())

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

    def detector_target(self, detector_index: int = 0, device=None, dtype=torch.float32) -> tuple:
        """``(sfns, z_min, seg_mask)`` of a hit search on a detector: its
        surface compiled on ``device`` (default: the raytracer's) in
        ``dtype``, its z_min and the ray sections that can cross it."""
        dsurf = self.detectors[detector_index].surface
        device = self.device if device is None else torch.device(device)
        z_min = float(dsurf.z_min)
        return (compile_surface(dsurf, device, dtype), z_min,
                build_segment_mask(self._section_z_bounds(), z_min, float(dsurf.z_max)))

    def detector_extent(self, detector_index: int = 0, extent=None) -> tuple:
        """``extent`` as four floats; ``None`` is the detector surface's own,
        the extent of a render that has no stored trace to take one from."""
        ext = self.detectors[detector_index].surface.extent[:4] if extent is None else extent
        return tuple(float(v) for v in ext)

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

        # the hit solve runs in f64 on the raytracer's device (a
        # once-per-image step; the fused streaming render never comes
        # through here and stays f32), and so does the selection of the
        # hits: only the extent and the ill-conditioned count reach the host
        with torch.no_grad():
            sfns, det_zmin, seg_mask = self.detector_target(detector_index, dtype=torch.float64)
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
        in f32 (``RayStorage.sections``)."""
        return self.rays.sections(Ns, Ne, self.device)

    # ------------------------------------------------------------------
    # image / spectrum rendering

    def detector_image(self, detector_index: int = 0, source_index: int = None,
                       extent=None, limit: float = None,
                       projection_method: str = "Equidistant", **kwargs) -> RenderImage:
        """Render the detector image from the stored trace. The hit search,
        the selection of the hits and the binning run on the raytracer's
        device."""
        with span("detector_image"):
            if limit is not None and extent is not None and "_dont_filter" not in kwargs:
                warning("Using the limit parameter with a user defined extent will produce an "
                        "incorrect detector image, as rays outside the extent are not convolved.")

            with span("detector_image.hits"):
                p, w, wl, extent_out, projection, bar, ill_count = \
                    self._hit_detector("Detector Image", detector_index, source_index, extent,
                                       projection_method)

            detector = self.detectors[detector_index]
            pname = f": {detector.desc}" if detector.desc != "" else ""
            desc = f"{Detector.abbr}{detector_index}{pname} at z = {detector.pos[2]:.5g} mm"
            if source_index is not None:
                desc = f"Rays from RS{source_index} at " + desc

            img = RenderImage(long_desc=desc, extent=extent_out, projection=projection)
            with span("detector_image.bin"):
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

            def build(nrays, calls):
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
                return make_fused_render_multi(self, nrays, configs, device=self.device,
                                               _batches=calls)[0]

            # the fused batches that share one step: all but a ragged last
            step_fn = build(rays_step, iterations - 1 - int(N - iterations * rays_step != 0))
            base_seed = 0x17E7 + self._seed_counter
            acc = [torch.zeros(DIm._data.shape, dtype=torch.float64, device=self.device)
                   for DIm in DIm_res]
            infos_acc = torch.zeros((N_INFOS, nt), dtype=torch.int64, device=self.device)
            with torch.no_grad():
                for i in range(1, iterations):
                    ni = rays_step if i < iterations - 1 \
                        else rays_step + int(N - iterations * rays_step)
                    if ni != rays_step:
                        step_fn = build(ni, 1)
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
        fused render; no ray sections are ever stored. With ``mesh`` (a
        ``torch.distributed`` ``DeviceMesh``, see ``parallel.default_mesh``)
        every rank calls this with the same arguments, each batch is sharded
        over the mesh axis ``global_options.mesh_axis_name`` and the tiles
        are summed by an all-reduce, so every rank returns the image; the
        progress bar shows on rank 0 only. With ``checkpoint_path`` progress
        is saved every ``checkpoint_every`` batches (by rank 0 under a mesh)
        and a later call resumes with the same remaining batches (each batch,
        and each rank's share of it, has its own generator, see
        ``parallel/checkpoint.py``).

        :param extent: fixed image extent; defaults to the detector
            surface extent (an automatic extent would need a stored trace)
        :param batch_size: rays a batch; under a mesh a multiple of its size
        :return: accumulated RenderImage
        """
        with span("render_huge"):
            if not self.detectors:
                raise RuntimeError("Detector(s) Missing.")
            if (N := int(N)) <= 0:
                raise ValueError(f"Ray number N needs to be a positive int, but is {N}.")
            if self._pretrace_check(min(N, self.ITER_RAYS_STEP)):
                raise RuntimeError("Geometry checks failed. Tracing aborted. Check the warnings.")

            from ..parallel.render import make_fused_render_multi, make_sharded_render
            from ..parallel.checkpoint import RenderCheckpoint, batch_generator

            batch = int(batch_size) if batch_size else min(N, self.ITER_RAYS_STEP)
            n_batches = max(1, -(-N // batch))

            detector = self.detectors[detector_index]
            ext = self.detector_extent(detector_index, extent)

            pname = f": {detector.desc}" if detector.desc != "" else ""
            desc = f"{Detector.abbr}{detector_index}{pname} at z = {detector.pos[2]:.5g} mm"
            img = RenderImage(long_desc=desc, extent=np.asarray(ext, dtype=np.float64),
                              projection=projection_method
                              if isinstance(detector.surface, SphericalSurface) else None)
            img.render(limit=limit, _dont_filter=True, device=self.device)   # fix extent, alloc zeros
            Ny, Nx, _ = img._data.shape

            with span("render_huge.build"):
                if mesh is not None:
                    step, _ = make_sharded_render(self, batch, mesh=mesh, detector_index=detector_index,
                                                  extent=tuple(img.extent), Nx=Nx, Ny=Ny,
                                                  axis_name=global_options.mesh_axis_name,
                                                  projection_method=projection_method,
                                                  _batches=n_batches)
                    group, rank = step.group, step.rank
                else:
                    render, _ = make_fused_render_multi(
                        self, batch, [dict(detector_index=detector_index,
                                           extent=tuple(img.extent),
                                           projection_method=projection_method,
                                           Nx=Nx, Ny=Ny)], device=self.device, _batches=n_batches)
                    group, rank = None, 0

                    def step(batch_index, seed):
                        return render(batch_generator(seed, batch_index, self.device))[0][0]

            ck = RenderCheckpoint(checkpoint_path, n_batches, group=group)
            bar = ProgressBar("Rendering: ", n_batches - ck.done) if rank == 0 else None
            with torch.no_grad():
                for i in ck.remaining():
                    with span("render_huge.batch"):
                        tile = step(i, ck.seed)
                    with span("render_huge.accumulate"):
                        ck.add(tile)
                    del tile
                    if checkpoint_path and (i % checkpoint_every == checkpoint_every - 1):
                        ck.save()
                    if bar is not None:
                        bar.update()
            if checkpoint_path:
                ck.save()
            if bar is not None:
                bar.finish()

            with span("render_huge.finish"):
                img._data += ck.image()
                if limit is not None:
                    img._apply_rayleigh_filter()
            return img

    # ------------------------------------------------------------------
    # focus search: every candidate plane's cost from the kept sections,
    # swept on the device (analysis/focus.py)

    def _focus_bracket(self, z_start: float) -> list:
        """Search interval: the gap between neighboring tracing surfaces
        (or source/outline limits) that contains z_start."""
        tops = np.array([s.z_max for s in self.tracing_surfaces])
        beyond = tops > z_start
        k = int(np.argmax(beyond)) if beyond.any() else len(tops)
        lo = float(tops[k - 1]) if k \
            else self.N_EPS + max(rs.extent[5] for rs in self.ray_sources)
        hi = float(self.tracing_surfaces[k].z_min) if k < len(tops) \
            else self.outline[5] - self.N_EPS
        return [lo, hi]

    def _focus_ray_lines(self, bounds, source_index):
        """Reduce the stored sections to transverse lines q(z) = q0 + m*z,
        in f64 on the raytracer's device.

        Picks, per ray, the last stored section at or before the bracket
        start; rays that never reach it are dropped.
        """
        lo_i, hi_i = (0, self.rays.N) if source_index is None \
            else self.rays.B_list[source_index:source_index + 2]
        with torch.no_grad():
            p, w, _ = self._sections(int(lo_i), int(hi_i))
            # f32-aware probe: stored section z carries ~eps·|z| noise, so a
            # section sitting exactly on the bound must count as before it
            z_probe = bounds[0] + max(1e-4 * max(1.0, abs(bounds[0])), self.N_EPS)
            crossed = z_probe < p[:, :, 2]
            seg = torch.argmax(crossed.to(torch.uint8), dim=1) - 1     # all-False rows give -1
            rows = torch.nonzero(seg >= 0)[:, 0]
            seg = seg[rows]
            p0 = p[rows, seg]
            s = p[rows, torch.clamp(seg + 1, max=p.shape[1] - 1)] - p0
            s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
            m = s[:, :2] / s[:, 2:3]
            q0 = p0[:, :2] - m * p0[:, 2:3]
            return q0, m, w[rows, seg]

    def focus_search(self, method: str, z_start: float, source_index: int = None,
                     return_cost: bool = False):
        """Find the focus along z near z_start.

        :return: (scipy OptimizeResult, dict(pos, bounds, z, cost, N))
        """
        if not (self.outline[4] <= z_start <= self.outline[5]):
            raise ValueError(f"Starting position z_start={z_start} outside raytracer "
                             f"z-outline range {self.outline[4:]}.")
        if method not in self.focus_search_methods:
            raise ValueError(f"Invalid method '{method}', should be one of {self.focus_search_methods}.")
        if not self.rays.N:
            raise RuntimeError("No rays traced.")
        if source_index is not None and source_index < 0:
            raise IndexError(f"source_index needs to be >= 0, but is {source_index}")
        if (source_index is not None and source_index > len(self.rays.N_list)) or len(self.rays.N_list) == 0:
            raise IndexError(f"source_index={source_index} larger than number of simulated sources.")
        if not self.check_if_rays_are_current():
            raise RuntimeError("Tracing geometry/properties changed. Please retrace first.")

        bounds = self._focus_bracket(z_start)
        q0, m, w = self._focus_ray_lines(bounds, source_index)

        N_use = q0.shape[0]
        if N_use < 1000:
            warning(f"WARNING: Less than 1000 rays for focus_search ({N_use}).")
        if N_use <= 1:
            return scipy.optimize.OptimizeResult(), \
                dict(pos=[np.nan, np.nan, np.nan], bounds=bounds,
                     z=np.full(focus.SWEEP_SAMPLES, np.nan),
                     cost=np.full(focus.SWEEP_SAMPLES, np.nan), N=N_use)

        # the sweeps take the lines in f32, the closed form in f64
        q0f, mf, wf = q0.float(), m.float(), w.float()
        n_px = focus.histogram_side(N_use)
        with torch.no_grad():
            if method == "RMS Spot Size":
                z_best = focus.rms_focus_direct(q0, m, w, bounds)
            else:
                z_best = focus.minimize_on_interval(q0f, mf, wf, bounds, method, n_px)

            res = scipy.optimize.OptimizeResult()
            res.x = z_best
            res.fun = float(focus.cost_sweep([z_best], q0f, mf, wf, method, n_px)[0])

            margin = 10 * (bounds[1] - bounds[0]) / focus.SWEEP_SAMPLES
            if min(z_best - bounds[0], bounds[1] - z_best) < margin:
                warning("Found minimum near search bounds, "
                        "this can mean the focus is outside of the search range.")

            r = vals = None
            if return_cost:
                r = np.linspace(bounds[0], bounds[1], focus.SWEEP_SAMPLES)
                vals = focus.cost_sweep(np.float32(r), q0f, mf, wf, method, n_px).cpu().numpy()

            pos = block_sums((q0 + m * z_best) * w[:, None])[0] / block_sums(w[:, None])[0, 0]
        return res, dict(pos=tuple(pos.tolist()) + (z_best,), bounds=bounds, z=r, cost=vals,
                         N=N_use)
