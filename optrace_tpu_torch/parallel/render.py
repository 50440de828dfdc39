"""Fused render: source sampling → trace → detector binning, in one pass
with no stored sections, on one device or sharded over the ranks of a
``torch.distributed`` device mesh.

Counterpart of ``optrace_tpu/parallel/render.py``. Detector crossings are
consumed *while the trace runs* (a streaming sink in trace_bundle, see
tracer/detector.segment_update) and sections are never stored, so device
memory is O(N) per batch regardless of total ray count AND surface count.
A spherical detector's hits are projected on the device before they are
binned.

The sharded render follows PyTorch's idiom of one process per device
(``torchrun``): each rank renders its share of a batch from its own
generator, divides its tile by the number of ranks, and an ``all_reduce``
sums the tiles, so every rank holds the whole image. This is the JAX
package's shard_map with a ``psum``, in the same order (divide, then sum).

Where the JAX package jits the batch, a step here on a CUDA device is
captured into a CUDA graph on its second call and replayed after that
(:mod:`.graph`); on the CPU it stays eager. :func:`_eager_fused_render` builds
the eager step, which the captured one is held against.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..geometry import SphericalSurface
from ..tracer.scene_compile import compile_surface
from ..tracer.trace_core import trace_bundle, RunPlans
from ..tracer.detector import (build_segment_mask, init_hit_carry, segment_update,
                               sphere_projection_xy)
from ..ops import binning
from ..ops.cuda_binning import bin_xyzw_cuda
from ..utils.device import resolve_device
from ..utils.global_options import global_options
from ..utils.tracing import device_interval
from .checkpoint import batch_generator
from .graph import capture


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


def _scene_snapshot(RT):
    """What a render step built now depends on and reads anew at every eager
    call: the raytracer's snapshot without its stored rays, and the
    wavelength range that the sources sample."""
    snap = RT.tracing_snapshot()
    del snap["Rays"]
    snap["WavelengthRange"] = tuple(global_options.wavelength_range)
    return snap


def make_fused_render_multi(RT, N_batch: int, configs: list, device=None, _batches=None):
    """Streaming fused render for several detector views of ONE trace.

    :param RT: Raytracer (geometry checked, detectors already positioned)
    :param N_batch: rays per call
    :param configs: list of dicts with keys detector_index, extent
        (4-tuple or None → detector surface extent), projection_method,
        Nx, Ny, and optionally pos (detector position; the detector is
        moved there BEFORE its sink is captured) and filter_extent
    :param device: ``None`` is the CUDA device (raises without one)
    :return: (render(gen) -> (list[(Ny,Nx,4) imgs], infos), list[extent]);
        ``gen`` is a ``torch.Generator`` on the render's device. On a CUDA
        device the step is captured into a CUDA graph at its second call and
        replayed after that (:class:`.graph.CapturedStep`): the same images,
        INFOS and generator advance as the eager step, bit for bit; it
        refuses to run once the scene has changed. The images are the
        caller's own. A caller that knows how many batches it renders
        passes ``_batches``; too few to pay for a capture keep the step
        eager (:func:`.graph.capture`).
    """
    render, exts = _eager_fused_render(RT, N_batch, configs, device)
    return capture(render, resolve_device(device), lambda: _scene_snapshot(RT), _batches), exts


def _eager_fused_render(RT, N_batch: int, configs: list, device=None):
    """:func:`make_fused_render_multi`'s step as eager PyTorch on every
    device: the step that a captured one is compared with."""
    device = resolve_device(device)
    RT.rays.init(RT.ray_sources, N_batch, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps(device)
    plans = RunPlans(steps)
    # the runs' step tables, the sources' and media's tables: made here or by
    # the first batch and kept, so that a later batch copies nothing from
    # the host
    source_fn = RT._make_source_fn(N_batch, device)
    outline = tuple(float(v) for v in RT.outline)
    n0_fn = RT.n0.on_device(device)
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
        # while a profiler records, a capture keeps the interval's events as
        # nodes of the graph, and each replay times the sampling on the card
        with device_interval("render.sampling", device):
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

    ``extent`` of None is the detector surface's own extent. On a CUDA
    device the step is captured into a CUDA graph at its second call, as
    :func:`make_fused_render_multi`'s is.
    """
    render, exts = make_fused_render_multi(
        RT, N_batch, [dict(detector_index=detector_index, extent=extent,
                           projection_method=projection_method,
                           Nx=Nx, Ny=Ny)], device=device)

    def render_one(gen):
        imgs, _ = render(gen)
        return imgs[0]

    return render_one, exts[0]


def default_mesh(axis_name: str = "rays", device=None) -> DeviceMesh:
    """1-D device mesh named ``axis_name`` over every rank of the initialized
    default process group, on the device type of ``device`` (``None`` is the
    CUDA device and raises without one; ``"cpu"`` for a gloo group).

    Each process drives one device: start the processes with ``torchrun`` or
    call ``torch.distributed.init_process_group`` in each, and on a GPU call
    ``torch.cuda.set_device(local_rank)`` before building the raytracer.
    """
    device = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("default_mesh needs an initialized default process group: start the "
                           "processes with torchrun, or call torch.distributed.init_process_group "
                           "in each of them first")
    return DeviceMesh(device.type, torch.arange(dist.get_world_size()), mesh_dim_names=(axis_name,))


def make_sharded_render(RT, N_batch: int, mesh: DeviceMesh = None, detector_index: int = 0,
                        extent=None, Nx: int = 945, Ny: int = 945, axis_name: str = "rays",
                        projection_method: str = "Equidistant", _batches=None):
    """Fused render step sharded over the ``axis_name`` axis of a device mesh.

    Every rank of the axis calls this and then the step, with the same
    arguments; each traces ``N_batch / ranks`` rays on ``RT.device``.
    Returns ``(step, extent)``: ``step(batch_index, seed=0)`` renders batch
    ``batch_index`` of a render seeded by ``seed`` and returns the summed
    (Ny, Nx, 4) XYZW tile on every rank. A step takes the batch's index, not
    a ``torch.Generator``: each rank draws from its own generator of (seed,
    batch index, rank) (``checkpoint.shard_seed``), and rank 0 draws the
    stream of the unsharded batch, so on one rank the step equals the fused
    render of ``batch_generator(seed, batch_index)``. The step carries the
    mesh axis's process ``group`` and this process's ``rank`` in it. On a
    CUDA device the rank's render and its division by the number of ranks
    are captured into a CUDA graph at the second batch and replayed; the
    all-reduce runs after the replay. ``_batches`` as in
    :func:`make_fused_render_multi`.

    :param mesh: a ``DeviceMesh`` on the device type of ``RT.device``;
        ``None`` is :func:`default_mesh` on the CUDA device
    """
    if mesh is None:
        mesh = default_mesh(axis_name)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh, "
                        f"not {type(mesh).__name__}")
    if mesh.device_type != RT.device.type:
        raise ValueError(f"the mesh lies on {mesh.device_type} devices, the raytracer on "
                         f"{RT.device.type}")
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis_name!r} (its axes: {mesh.mesh_dim_names})")
    group = mesh.get_group(axis_name)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if N_batch % world:
        raise ValueError(f"N_batch={N_batch} must be divisible by the mesh size {world}.")

    render, exts = _eager_fused_render(
        RT, N_batch // world, [dict(detector_index=detector_index, extent=extent,
                                    projection_method=projection_method, Nx=Nx, Ny=Ny)],
        device=RT.device)

    def shard(gen):
        # each shard samples its rays at full source power; rescale so the
        # sum over the shards carries the true total power
        return render(gen)[0][0] / world

    # on a CUDA device the division is part of the captured graph; the
    # all-reduce stays outside it, an eager collective after the replay
    shard = capture(shard, RT.device, lambda: _scene_snapshot(RT), _batches)

    def step(batch_index: int, seed: int = 0):
        tile = shard(batch_generator(seed, batch_index, RT.device, rank))
        dist.all_reduce(tile, op=dist.ReduceOp.SUM, group=group)
        return tile

    step.group, step.rank = group, rank
    return step, exts[0]
