"""Fused render: source sampling → trace → detector binning, in one pass
with no stored sections.

Counterpart of ``optrace_tpu/parallel/render.py`` (``_detector_sink``,
``make_fused_render_multi``, ``make_fused_render``). Detector crossings are
consumed *while the trace runs* (a streaming sink in trace_bundle, see
tracer/detector.segment_update) and sections are never stored, so device
memory is O(N) per batch regardless of total ray count AND surface count.
A spherical detector's hits are projected on the device before they are
binned. The sharded render over several devices arrives with its own slice.
"""

import torch

from ..geometry import SphericalSurface
from ..tracer.scene_compile import compile_surface
from ..tracer.trace_core import trace_bundle, RunPlans
from ..tracer.detector import (build_segment_mask, init_hit_carry, segment_update,
                               sphere_projection_xy)
from ..ops import binning
from ..ops.cuda_binning import bin_xyzw_cuda
from ..utils.device import resolve_device
from ..utils.global_options import global_options


def _detector_sink(RT, detector_index: int, projection_method, extent,
                   Nx: int, Ny: int, device, filter_extent=None):
    """Build (sink_fn, finalize, extent, seg_mask) for one detector config.

    ``finalize(carry, wl)`` bins the accumulated hits into an (Ny, Nx, 4)
    XYZW tile, after the sphere projection where the detector surface is
    spherical. ``filter_extent`` optionally drops hits outside a tighter
    box than the binning extent (the iterative render discards rays outside
    its first batch's automatic extent even when a resolution limit widens
    the grid).
    """
    dsurf = RT.detectors[detector_index].surface
    sfns = compile_surface(dsurf, device)
    det_zmin = float(dsurf.z_min)
    seg_mask = build_segment_mask(RT._section_z_bounds(),
                                  det_zmin, float(dsurf.z_max))
    if extent is None:
        extent = dsurf.extent[:4]
    ext = tuple(float(v) for v in extent)

    spherical = isinstance(dsurf, SphericalSurface) and projection_method is not None
    pos = tuple(float(v) for v in dsurf.pos)
    R = float(dsurf.R) if spherical else 0.0

    def sink(j, p_prev, p_new, w_prev, carry):
        if not seg_mask[j]:
            return carry
        return segment_update(sfns, det_zmin, p_prev, p_new, w_prev, carry)

    def finalize(carry, wl):
        ph, wsel, is_hit, done, _ = carry
        wm = torch.where(is_hit & done, wsel, 0.0)
        x, y = ph[:, 0], ph[:, 1]
        if spherical:
            x, y = sphere_projection_xy(x, y, ph[:, 2], pos, R, projection_method)
        if filter_extent is not None:
            fx = filter_extent
            inside = (fx[0] <= x) & (x <= fx[1]) & (fx[2] <= y) & (y <= fx[3])
            wm = torch.where(inside, wm, 0.0)
        if global_options.cuda_binning:
            return bin_xyzw_cuda(x, y, wm, wl, Nx, Ny, ext)
        return binning.bin_xyzw(x, y, wm, wl, Nx, Ny, ext)

    return sink, finalize, ext, seg_mask


def make_fused_render_multi(RT, N_batch: int, configs: list, device=None):
    """Streaming fused render for several detector views of ONE trace.

    :param RT: Raytracer (geometry checked, detectors already positioned)
    :param N_batch: rays per call
    :param configs: list of dicts with keys detector_index, extent
        (4-tuple or None → detector surface extent), projection_method,
        Nx, Ny, and optionally pos (detector position; the detector is
        moved there BEFORE its sink is captured) and filter_extent
    :param device: ``None`` is the CUDA device (raises without one)
    :return: (render(gen) -> (list[(Ny,Nx,4) imgs], infos), list[extent]);
        ``gen`` is a ``torch.Generator`` on the render's device
    """
    device = resolve_device(device)
    RT.rays.init(RT.ray_sources, N_batch, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps(device)
    plans = RunPlans(steps)     # the runs' step tables: built by the first batch, kept for the rest
    source_fn = RT._make_source_fn(N_batch)
    outline = tuple(float(v) for v in RT.outline)
    n0_fn = RT.n0
    no_pol, use_hurb = RT.no_pol, RT.use_hurb
    hurb_factor = float(RT.HURB_FACTOR)

    sinks, finalizers, exts = [], [], []
    for cfg in configs:
        if cfg.get("pos") is not None:
            RT.detectors[cfg.get("detector_index", 0)].move_to(cfg["pos"])
        sink, fin, ext, seg_mask = _detector_sink(
            RT, cfg.get("detector_index", 0),
            cfg.get("projection_method", "Equidistant"),
            cfg.get("extent"), cfg.get("Nx", 945),
            cfg.get("Ny", 945), device, cfg.get("filter_extent"))
        # the seg_mask rides along so trace_bundle can put the steps whose
        # segments no sink consumes into runs
        sinks.append((sink, seg_mask))
        finalizers.append(fin)
        exts.append(ext)

    def render(gen):
        if gen.device != device:
            raise ValueError(f"the generator lies on {gen.device}, the render on {device}")
        p, s, pols, w, wl = source_fn(gen)
        out = trace_bundle(steps, n0_fn, outline, p, s, pols, w, wl,
                           no_pol, use_hurb, gen=gen,
                           sinks=[(fn, init_hit_carry(N_batch, device), m) for fn, m in sinks],
                           store_sections=False, hurb_factor=hurb_factor, plans=plans)
        imgs = [fin(carry, out["wl"]) for fin, carry in zip(finalizers, out["sinks"])]
        return imgs, out["infos"]

    return render, exts


def make_fused_render(RT, N_batch: int, detector_index: int = 0,
                      extent=None, Nx: int = 945, Ny: int = 945,
                      projection_method: str = "Equidistant", device=None):
    """Single-detector fused render step: generator → (Ny, Nx, 4) XYZW image.

    ``extent`` of None is the detector surface's own extent.
    """
    render, exts = make_fused_render_multi(
        RT, N_batch, [dict(detector_index=detector_index, extent=extent,
                           projection_method=projection_method,
                           Nx=Nx, Ny=Ny)], device=device)

    def render_one(gen):
        imgs, _ = render(gen)
        return imgs[0]

    return render_one, exts[0]
