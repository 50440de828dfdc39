"""Differentiable design: detector images as functions of the scene's
surface parameters.

Counterpart of ``optrace_tpu/tracer/diff.py``. The per-surface parameter
dicts that ``scene_compile`` builds (``rho``, ``k``, ``coeff``, ``pos``,
...) are the inputs of the render; a parameter that requires a gradient
takes its runs through the plain loop (``ops/cuda_run.py:
conic_run_reference``, the run kernel has no backward), every other
evaluation traces its runs with the kernel. Either way the trace sees the
surfaces that the given parameters describe: each call builds its steps
from them (``scene_compile.with_params``), and so its own prepared runs.

The rays of a call come from a ``torch.Generator`` seeded with ``seed``:
equal seeds give equal rays, which is what a finite difference needs.
"""

import torch

from .detector import detector_hits, build_segment_mask
from .scene_compile import compile_surface, with_params
from .trace_core import trace_bundle
from ..ops import binning
from ..ops.cuda_binning import bin_xyzw_cuda
from ..utils.device import make_generator
from ..utils.global_options import global_options


def steps_with_params(steps: list, params_list: list) -> list:
    """The step list with each step's parameters replaced by the dict of
    ``params_list``. The host values of all parameters come back in one
    copy from the device."""
    flat = [(i, k, v) for i, pr in enumerate(params_list) for k, v in pr.items()]
    if not flat:
        return list(steps)
    buf = torch.cat([v.detach().reshape(-1).to(torch.float64) for _, _, v in flat]).cpu().numpy()
    hosts = [{} for _ in params_list]
    at = 0
    for i, k, v in flat:
        n = v.numel()
        hosts[i][k] = buf[at:at + n].reshape(tuple(v.shape)).astype(
            str(v.dtype).replace("torch.", ""))
        at += n
    return [st._replace(sfns=with_params(st.sfns, pr, h))
            for st, pr, h in zip(steps, params_list, hosts)]


def make_parameterized_render(RT, N: int, detector_index: int = 0,
                              extent=None, Nx: int = 189, Ny: int = 189,
                              soft_bin: bool = True):
    """Build ``render(params_list, seed) -> (Ny, Nx, 4) XYZW image`` on the
    raytracer's device, where ``params_list`` holds one parameter dict a
    trace step (differentiable).

    ``soft_bin``: bilinear splatting (:func:`ops.binning.bin_xyzw_soft`),
    which design gradients with respect to positions need; the hard
    histogram is piecewise constant in ray position.

    ``render.trace_rays(params_list, p, s, pols, w, wl, gen=None)`` is the
    same render of given source rays.

    :return: (render, params0) with params0 the current scene parameters
    """
    device = RT.device
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps()
    source_fn = RT._make_source_fn(N)
    outline = tuple(float(v) for v in RT.outline)
    n0_fn = RT.n0
    no_pol, use_hurb = RT.no_pol, RT.use_hurb
    hurb_factor = float(RT.HURB_FACTOR)

    dsurf = RT.detectors[detector_index].surface
    sfns = compile_surface(dsurf, device)
    det_zmin = float(dsurf.z_min)
    # only segments whose section z-ranges can hold the detector are tested
    seg_mask = build_segment_mask(RT._section_z_bounds(), det_zmin, float(dsurf.z_max))
    if extent is None:
        extent = dsurf.extent[:4]
    ext = tuple(float(v) for v in extent)

    params0 = [s.sfns.params for s in steps]

    def trace_rays(params_list, p, s, pols, w, wl, gen=None):
        steps_p = steps_with_params(steps, params_list)
        out = trace_bundle(steps_p, n0_fn, outline, p, s, pols, w, wl, no_pol, use_hurb,
                           gen=gen, hurb_factor=hurb_factor)
        ph, wsel, is_hit, _ = detector_hits(sfns, det_zmin, out["p"], out["w"],
                                            segment_mask=seg_mask)
        wm = torch.where(is_hit, wsel, 0.0)
        x, y = ph[:, 0], ph[:, 1]
        if soft_bin:
            return binning.bin_xyzw_soft(x, y, wm, out["wl"], Nx, Ny, ext)
        if global_options.cuda_binning and not (torch.is_grad_enabled() and wm.requires_grad):
            return bin_xyzw_cuda(x, y, wm, out["wl"], Nx, Ny, ext)
        return binning.bin_xyzw(x, y, wm, out["wl"], Nx, Ny, ext)

    def render(params_list, seed: int):
        gen = make_generator(seed, device)
        return trace_rays(params_list, *source_fn(gen), gen=gen)

    render.trace_rays = trace_rays
    return render, params0


def spot_loss(render, weight_mode: int = 3):
    """Power-weighted RMS spot radius of the rendered image: a common design
    objective, differentiable with respect to the scene parameters.

    :return: ``loss(params_list, seed, ext)``
    """
    def loss(params_list, seed, ext):
        return spot_radius(render(params_list, seed), ext, weight_mode)
    return loss


def spot_radius(img, ext, weight_mode: int = 3):
    """Power-weighted RMS radius of an (Ny, Nx, 4) image over ``ext``."""
    Ny, Nx = img.shape[:2]
    x = torch.linspace(float(ext[0]), float(ext[1]), Nx, dtype=img.dtype, device=img.device)
    y = torch.linspace(float(ext[2]), float(ext[3]), Ny, dtype=img.dtype, device=img.device)
    w = img[:, :, weight_mode]
    wsum = torch.clamp(w.sum(), min=1e-12)
    cx = torch.sum(w * x[None, :]) / wsum
    cy = torch.sum(w * y[:, None]) / wsum
    r2 = (x[None, :] - cx) ** 2 + (y[:, None] - cy) ** 2
    return torch.sqrt(torch.sum(w * r2) / wsum)


