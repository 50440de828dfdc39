"""Scene compilation: Surface objects → pure functional descriptors.

Counterpart of ``optrace_tpu/tracer/scene_compile.py``. The trace is a pure
function of tensors; this module extracts from each host-side Surface a
(params, hit_fn, normal_fn, mask_fn) quadruple where ``params`` is a dict of
0-dim/(3,) tensors on the trace's device and the fns are closures over
*static structure only*. Geometric quantities flow through the params dict,
which keeps the plain trace differentiable w.r.t. the optical design.
``host`` carries the same quantities as numpy values: the run kernel's
step table and the frame chain are built from them without a device round
trip. They are always read from ``params`` (:func:`with_params` for a new
parameter dict, :func:`host_values` for one that was swapped in by
``_replace``), so every route of the trace sees the same surfaces.

Surface kinds: the planar shapes (``rect``, ``slit``, ``ring``, ``circle``,
and ``flat`` for a function or data surface without sag), ``conic``
(spheres included), ``asphere`` (even asphere), ``tilted`` (tilted plane)
and ``generic`` (function and data surfaces: the bracketed numeric solve over
the surface object's own sag, normals and mask). The generic kind's closures
hold the surface object, so it has no plain description:
:func:`surface_fns` builds every kind but that one, and a generic step comes
from :func:`compile_surface` only. Its parameters carry the position, the
radius and the extent, which the frame chain and a design render move; the
user function or the spline stays in the closure. Its ``generic`` field
holds what the hand-written kernel of the step needs
(:class:`optrace_tpu_torch.ops.cuda_generic.GenericSurface`: the sag and the
user mask recorded as programs of elementwise operations).
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import cuda_generic, geom
from ..geometry.surface import (Surface, CircularSurface, RingSurface, ConicSurface,
                                AsphericSurface, TiltedSurface, FunctionSurface2D,
                                RectangularSurface, SlitSurface)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class SurfaceFns(NamedTuple):
    """Functional form of one surface. All fns take the params dict first.

    hit_fn(params, o, s) -> (t, valid, ill): o = p − pos local coords.
    normal_fn(params, x, y) -> (N, 3) unit normals (local coords).
    mask_fn(params, x, y) -> bool definition region (local coords).
    """
    params: dict
    hit_fn: Callable
    normal_fn: Callable
    mask_fn: Callable
    kind: str
    is_flat: bool
    host: dict = None     # params as numpy values (same rounding)
    host_of: dict = None  # the params dict that ``host`` was read from
    generic: "cuda_generic.GenericSurface" = None   # the generic kind's kernel programs


def _mask_circle_fn(params, x, y):
    return geom.mask_circle(x, y, params["r"])


def _mask_ring_fn(params, x, y):
    return geom.mask_ring(x, y, params["ri"], params["r"])


def _mask_rect_fn(params, x, y):
    return geom.mask_rect(x, y, params["hw"], params["hh"], params["angle"])


def _mask_slit_fn(params, x, y):
    return geom.mask_slit(x, y, params["hw"], params["hh"],
                          params["hwi"], params["hhi"], params["angle"])


def _flat_hit_fn(params, o, s):
    t = geom.hit_plane(o, s)
    valid = torch.isfinite(t) & (t >= -geom.C_EPS)
    return t, valid, torch.zeros(t.shape, dtype=torch.bool, device=t.device)


def _flat_normal_fn(params, x, y):
    return geom.normal_flat(x, y)


def _conic_hit_fn(params, o, s):
    t, valid = geom.hit_conic(o, s, params["rho"], params["k"],
                              params["z_min_rel"], params["z_max_rel"])
    return t, valid, torch.zeros(t.shape, dtype=torch.bool, device=t.device)


def _conic_normal_fn(params, x, y):
    return geom.normal_conic(x, y, params["rho"], params["k"])


def _asph_coeffs(params):
    return [params["coeff"][i] for i in range(params["coeff"].shape[0])]


def _asph_hit_fn(params, o, s):
    def sag(x, y):
        return geom.sag_asphere(x, y, params["rho"], params["k"], _asph_coeffs(params))
    return geom.hit_newton(sag, o, s, params["z_min_rel"], params["z_max_rel"])


def _asph_normal_fn(params, x, y):
    return geom.normal_asphere(x, y, params["rho"], params["k"], _asph_coeffs(params))


def _tilt_hit_fn(params, o, s):
    # unguarded division, unlike geom.hit_tilted: den = 0 flows into
    # valid = False as it does in the run kernel's tilted step
    n = params["normal"]
    num = -(o[..., 0] * n[0] + o[..., 1] * n[1] + o[..., 2] * n[2])
    den = s[..., 0] * n[0] + s[..., 1] * n[1] + s[..., 2] * n[2]
    t = num / den
    valid = torch.isfinite(t) & (den != 0)
    return t, valid, torch.zeros(t.shape, dtype=torch.bool, device=t.device)


def _tilt_normal_fn(params, x, y):
    return params["normal"].expand(*x.shape, 3)


_KIND_FNS = {
    "flat": (_flat_hit_fn, _flat_normal_fn, _mask_circle_fn, True),
    "slit": (_flat_hit_fn, _flat_normal_fn, _mask_slit_fn, True),
    "rect": (_flat_hit_fn, _flat_normal_fn, _mask_rect_fn, True),
    "ring": (_flat_hit_fn, _flat_normal_fn, _mask_ring_fn, True),
    "circle": (_flat_hit_fn, _flat_normal_fn, _mask_circle_fn, True),
    "conic": (_conic_hit_fn, _conic_normal_fn, _mask_circle_fn, False),
    "asphere": (_asph_hit_fn, _asph_normal_fn, _mask_circle_fn, False),
    "tilted": (_tilt_hit_fn, _tilt_normal_fn, _mask_circle_fn, False),
}


def surface_fns(kind: str, params_np: dict, device, dtype=torch.float32) -> SurfaceFns:
    """SurfaceFns of ``kind`` from a dict of host values. Every value is
    rounded once to ``dtype``; tensors and host copies hold the same
    numbers."""
    if kind not in _KIND_FNS:
        raise NotImplementedError(
            f"surface kind '{kind}' has no plain description: "
            + ("a generic surface comes from compile_surface" if kind == "generic"
               else "unknown kind"))
    hit_fn, normal_fn, mask_fn, is_flat = _KIND_FNS[kind]
    return _make_fns(params_np, device, dtype, hit_fn, normal_fn, mask_fn, kind, is_flat)


def _make_fns(params_np, device, dtype, hit_fn, normal_fn, mask_fn, kind, is_flat, generic=None):
    npdt = _NP_DTYPES[dtype]
    host = {k: np.asarray(v, dtype=npdt) for k, v in params_np.items()}
    params = {k: torch.tensor(v, device=device) for k, v in host.items()}
    return SurfaceFns(params, hit_fn, normal_fn, mask_fn, kind, is_flat, host, params, generic)


def _sag_normals(surf: Surface) -> bool:
    """Whether the surface's normals are the exact normals of its sag
    (``geom.normal_numeric``), which the generic kernel takes by forward
    mode through the recorded sag: no ``deriv_func``, no spline."""
    own = type(surf)._normals_rel
    return own is Surface._normals_rel or (own is FunctionSurface2D._normals_rel
                                           and getattr(surf, "deriv_func", None) is None)


def _generic_fns(surf: Surface, params_np: dict, device, dtype) -> SurfaceFns:
    """The ``generic`` kind of a function or data surface: the bracketed
    numeric solve (``geom.hit_newton``) over the object's tensor sag, its
    normals (a ``deriv_func``, the spline's derivatives or
    ``geom.normal_numeric``) and its mask with the user's ``mask_func``.
    The sag is evaluated through ``geom.generic_sag``, which counts its
    evaluations. The sag and the mask are also recorded for the kernel of
    the step (``generic``, :func:`cuda_generic.generic_surface`)."""
    user_mask = getattr(surf, "mask_func", None) is not None
    sag = geom.generic_sag(surf._sag)
    gen = cuda_generic.generic_surface(
        surf._sag, surf._mask_rel if user_mask else None,
        None if _sag_normals(surf) else (lambda x, y: surf._normals_rel(x, y, sag)), device, dtype)

    def gen_hit(params, o, s):
        return geom.hit_newton(sag, o, s, params["z_min_rel"], params["z_max_rel"])

    def gen_normal(params, x, y):
        return surf._normals_rel(x, y, sag)

    def gen_mask(params, x, y):
        m = geom.mask_circle(x, y, params["r"])
        return m & surf._mask_rel(x, y) if user_mask else m

    return _make_fns(params_np, device, dtype, gen_hit, gen_normal, gen_mask, "generic", False, gen)


def read_host(params: dict) -> dict:
    """The numpy values of a parameter dict, each in its tensor's own type
    (one device round trip per tensor)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def with_params(sfns: SurfaceFns, params: dict, host: dict = None) -> SurfaceFns:
    """``sfns`` with another parameter dict and the host values read from
    it; ``host`` gives values that the caller already read (all tensors of
    a design step come back in one copy). A parameter dict is replaced,
    never changed in place."""
    return sfns._replace(params=params, host=read_host(params) if host is None else host,
                         host_of=params)


def host_values(sfns: SurfaceFns) -> dict:
    """The host values of ``sfns.params``: the kept ones when they were read
    from this very dict, else read now."""
    if sfns.host is not None and sfns.host_of is sfns.params:
        return sfns.host
    return read_host(sfns.params)


def compile_surface(surf: Surface, device, dtype=torch.float32) -> SurfaceFns:
    """Build the functional descriptor for a host-side surface object.

    ``dtype`` selects the parameter precision: f32 is the trace's working
    type; f64 is the accuracy-oracle path.
    """
    base = {"pos": np.asarray(surf.pos, dtype=np.float64),
            "z_max_rel": surf.z_max - surf.pos[2],
            "z_min_rel": surf.z_min - surf.pos[2]}

    if isinstance(surf, SlitSurface):
        return surface_fns("slit", dict(base, hw=surf.dim[0] / 2, hh=surf.dim[1] / 2,
                                        hwi=surf.dimi[0] / 2, hhi=surf.dimi[1] / 2,
                                        angle=surf._angle), device, dtype)
    if isinstance(surf, RectangularSurface):
        return surface_fns("rect", dict(base, hw=surf.dim[0] / 2, hh=surf.dim[1] / 2,
                                        angle=surf._angle), device, dtype)
    if isinstance(surf, RingSurface):
        return surface_fns("ring", dict(base, r=surf.r, ri=surf.ri), device, dtype)
    if isinstance(surf, AsphericSurface):
        return surface_fns("asphere", dict(base, r=surf.r, rho=1.0 / surf.R, k=surf.k,
                                           coeff=surf.coeff), device, dtype)
    if isinstance(surf, ConicSurface):   # includes SphericalSurface
        return surface_fns("conic", dict(base, r=surf.r, rho=1.0 / surf.R, k=surf.k),
                           device, dtype)
    if isinstance(surf, TiltedSurface):
        return surface_fns("tilted", dict(base, r=surf.r, normal=surf.normal), device, dtype)
    if isinstance(surf, CircularSurface):
        return surface_fns("circle", dict(base, r=surf.r), device, dtype)
    if not isinstance(surf, Surface):
        raise TypeError(f"{type(surf).__name__} is not a surface")
    # function and data surfaces; without sag they are flat discs
    if surf.is_flat():
        return surface_fns("flat", dict(base, r=surf.r), device, dtype)
    return _generic_fns(surf, dict(base, r=surf.r), device, dtype)


def steps_from_numpy(spec: list, device, dtype=torch.float32) -> list:
    """Build a ``TraceStep`` list from a plain description.

    ``spec`` holds one dict per step: ``kind`` (surface kind), ``action``,
    ``pos_host`` (f64 vertex position), ``params`` (dict of numpy values:
    ``pos, rho, k, r, ri, hw, hh, hwi, hhi, angle, coeff, normal, z_min_rel,
    z_max_rel``, whichever the kind has) and, for
    refract and ideal steps, ``n1``/``n2`` as ``RefractionIndex`` constructor
    keyword dicts (``n_type`` plus ``coeff`` or ``n, V, lines``). An ideal
    step also gives ``D`` (optical power in dpt), a filter step ``spectrum``
    as ``TransmissionSpectrum`` constructor keywords (``spectrum_type``,
    ``inverse`` and the type's own values). Two steps that
    share a medium give the same dict object, or equal dicts: equal media
    become one ``RefractionIndex``, as a scene built from the public
    classes shares them.
    """
    from .trace_core import TraceStep
    from ..spectrum.refraction_index import RefractionIndex
    from ..spectrum.transmission_spectrum import TransmissionSpectrum

    media = {}

    def plain(v):
        return list(np.asarray(v).tolist()) if isinstance(v, (np.ndarray, list, tuple)) else v

    def medium(desc):
        if desc is None:
            return None
        key = repr(sorted((k, np.asarray(v).tolist()) for k, v in desc.items()))
        if key not in media:
            media[key] = RefractionIndex(**{k: plain(v) for k, v in desc.items()})
        return media[key]

    steps = []
    for d in spec:
        sfns = surface_fns(d["kind"], d["params"], device, dtype)
        pos_host = tuple(float(v) for v in d["pos_host"]) if d.get("pos_host") is not None else None
        hurb_kind = {"ring": "ring", "slit": "slit"}.get(d["kind"], "") \
            if d["action"] == "absorb" else ""
        spectrum = TransmissionSpectrum(**{k: plain(v) for k, v in d["spectrum"].items()}) \
            if d.get("spectrum") is not None else None
        steps.append(TraceStep(sfns, d["action"], n1_fn=medium(d.get("n1")),
                               n2_fn=medium(d.get("n2")), spectrum_fn=spectrum,
                               D=float(d.get("D", 0.0)), hurb=bool(hurb_kind),
                               hurb_kind=hurb_kind, pos_host=pos_host))
    return steps
