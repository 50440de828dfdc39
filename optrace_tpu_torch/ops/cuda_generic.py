"""The generic step of a function surface on the card: wrapper around
``csrc/generic_hit.cu``.

A function surface's hit solve (``geom.hit_newton``, 40 Illinois steps over
the user's sag), the clamping of abnormal hits, the hit point, the mask
and, for a refraction, the normals, are one kernel launch a batch, where the
eager route (``tracer/trace_core.py:_surface_hit`` and the surface's
``normal_fn``) makes some 2 300. The sag reaches the kernel as the program
that :func:`optrace_tpu_torch.ops.sag_program.record` made of it when the
surface was compiled (:class:`GenericSurface`); the kernel's plain version
is :func:`generic_hit_reference`, which it equals bit for bit on the card
in the hit, the positions and every flag, and within a few units in the
last place of 1 in the normals (``NORMAL_ULPS``).

A generic step takes the kernel (:func:`takes_kernel`) where
``global_options.cuda_trace`` is on, its rays are f32 on a CUDA device, no
ray tensor or surface parameter carries a derivative and no forward-mode
level is active, and the sag recorded; every other step keeps the eager
closures, and on a CUDA device counts itself in ``generic_hit.eager_steps``.
A user mask or ``deriv_func`` that did not record runs eagerly after the
kernel's hit.
"""

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from . import geom, sag_program
from .sag_program import Program
from ..utils.device import tracks_grad
from ..utils.global_options import global_options
from ..utils.tracing import counted

ITERS = 40          # geom.hit_newton's steps, as the generic kind runs it
# the bracket's margin, C_EPS, N_EPS and the standoff as f32 numbers, as the
# eager route's 0-d and elementwise operations round them
_EPS = tuple(float(np.float32(v)) for v in (geom.C_EPS / 10.0, geom.C_EPS, geom.N_EPS, geom.ADVANCE_STANDOFF))
# the normals of the kernel against the eager route's (torch.func.jvp and
# linalg.norm), and against generic_hit_reference: units of 2⁻²³, the last
# place of 1 (CPU tests, chip_smoke.py)
NORMAL_ULPS = 4


class GenericSurface(NamedTuple):
    """What the kernel needs of a function or data surface, made when the
    surface is compiled (``tracer/scene_compile.py:_generic_fns``).

    ``sag``: the recorded sag (None: it did not record, the step stays
    eager); ``mask``: the recorded user mask (None: none, or one that did not
    record); ``mask_rel``: the user mask as the eager route calls it, where
    it did not record (run after the kernel's hit), else None;
    ``normals_rel``: the eager normals ``(x, y) -> (N, 3)`` where the kernel
    does not take them from the sag (a ``deriv_func``), else None;
    ``device``: the programs' words and constants on the surface's CUDA
    device ``(sag_code, sag_consts, mask_code, mask_consts)``, or None."""
    sag: Optional[Program]
    mask: Optional[Program]
    mask_rel: Optional[Callable]
    normals_rel: Optional[Callable]
    device: Optional[tuple]


def _on_device(prog: Optional[Program], device) -> tuple:
    if prog is None:
        return None, None
    code = torch.tensor(list(prog.code) or [0], dtype=torch.int32, device=device)
    consts = torch.tensor(list(prog.consts) or [0.0], dtype=torch.float32, device=device)
    return code, consts


def generic_surface(sag: Callable, mask_rel: Optional[Callable], normals_rel: Optional[Callable],
                    device, dtype) -> GenericSurface:
    """The :class:`GenericSurface` of a sag ``(x, y) -> z``, its user mask
    ``(x, y) -> bool`` (None: none) and its eager normals where they do not
    come from the sag (None: they do). Records the programs for f32 alone:
    an f64 step never takes the kernel."""
    if dtype != torch.float32:
        return GenericSurface(None, None, mask_rel, normals_rel, None)
    prog = sag_program.record(sag)
    mask = sag_program.record(mask_rel, "b") if mask_rel is not None and prog is not None else None
    dev = None
    if prog is not None and torch.device(device).type == "cuda":
        dev = _on_device(prog, device) + _on_device(mask, device)
    return GenericSurface(prog, mask, None if mask is not None else mask_rel, normals_rel, dev)


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def refusal(gen: Optional[GenericSurface], params: dict, p, s) -> Optional[str]:
    """Why a generic step keeps the eager route, or None where it takes the
    kernel: kernel 1's rule (f32 state on a CUDA device that needs no
    derivative, ``global_options.cuda_trace`` on), no forward-mode level
    active, and a sag that recorded. Decided from the input alone."""
    if p.dtype != torch.float32 or s.dtype != torch.float32:
        return "the rays are not f32"
    if gen is None or gen.sag is None:
        return "the sag did not record"
    if any(tracks_grad(t) for t in (p, s, *params.values())):
        return "a derivative flows through the step"
    if fwAD._current_level >= 0:
        return "a forward-mode level is active"
    if not global_options.cuda_trace:
        return "cuda_trace is off"
    if not _on_card(p) or gen.device is None:
        return "not on a CUDA device"
    return None


def takes_kernel(gen: Optional[GenericSurface], params: dict, p, s) -> bool:
    """Whether a generic step takes the kernel (:func:`refusal` finds no
    reason against it)."""
    return refusal(gen, params, p, s) is None


def sag_evals(normals: bool) -> int:
    """The sag evaluations a ray of the kernel: the bracket's two ends, one
    a step, and one for the normals (value and both partials at once)."""
    return 2 + ITERS + int(normals)


def generic_hit_reference(gen: GenericSurface, params: dict, p, s, hw, normals: bool = False) -> dict:
    """Plain PyTorch version of :func:`generic_hit`: the recorded calls of
    the sag in ``geom.hit_newton`` and the eager route's bookkeeping
    (``trace_core._surface_hit``), the normals from the program's op codes
    by forward mode (:func:`sag_program.normals`), on any device.

    :return: dict of ``p`` (N, 3), ``hit``, ``ill`` (N,) bool (of the rays
        alive), ``t`` and ``valid`` of the solve, ``broken`` (N,) bool and
        ``n_broken``, and ``normals`` (N, 3) where asked
    """
    sag = gen.sag.replay
    ps = geom.advance_to_standoff(p, s, params["z_min_rel"], hw)
    t, valid, ill = geom.hit_newton(sag, ps, s, params["z_min_rel"], params["z_max_rel"], ITERS)
    t2, ok, broken = geom.clamp_abnormal(ps, s, t, valid, params["z_max_rel"])
    p_hit = ps + t2[:, None] * s
    m = geom.mask_circle(p_hit[:, 0], p_hit[:, 1], params["r"])
    if gen.mask is not None:
        m = m & gen.mask.replay(p_hit[:, 0], p_hit[:, 1])
    p_new = torch.where(hw[:, None], p_hit, p)
    hit = m & ok & hw
    if gen.mask_rel is not None:
        hit = hit & gen.mask_rel(p_new[:, 0], p_new[:, 1])
    out = dict(p=p_new, hit=hit, ill=ill & hw, t=t, valid=valid, broken=broken & hw,
               n_broken=torch.count_nonzero(broken & hw))
    if normals:
        out["normals"] = gen.normals_rel(p_new[:, 0], p_new[:, 1]) if gen.normals_rel is not None \
            else sag_program.normals(gen.sag, p_new[:, 0], p_new[:, 1])
    return out


def _lib():
    from . import _build
    lib = _build.load("generic_hit")
    if not getattr(lib, "_ot_ready", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.generic_hit_launch.argtypes = [vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                                           vp, ci, vp, ci, ci, vp, ci, vp, ci, ci,
                                           ci, ci, cf, cf, cf, cf, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.generic_hit_launch.restype = ctypes.c_int
        lib._ot_ready = True
    return lib


def _slots(prog: Optional[Program]) -> int:
    """The registers a thread keeps of ``prog``: x, y and the temporaries
    (the kernel keeps the constants once a block)."""
    return 2 if prog is None else prog.n_regs - len(prog.consts)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def generic_hit(gen: GenericSurface, params: dict, p, s, hw, normals: bool = False, debug: bool = False):
    """The generic step of ``gen`` in one launch on the current stream (so
    that a CUDA graph's capture records it).

    :param gen: the surface's :class:`GenericSurface`, with a recorded sag
        on the rays' device
    :param params: the step's parameters: ``z_min_rel``, ``z_max_rel``,
        ``r`` as f32 0-d tensors on that device (read there: no copy)
    :param p, s: (N, 3) f32 ray positions in the surface's frame and
        directions
    :param hw: (N,) bool, the rays alive before the step
    :param normals: also the unit normals at the new positions (a
        refraction)
    :param debug: also the solve's ``t``, ``valid`` and ``broken``, as
        :func:`generic_hit_reference` gives them
    :return: ``(p_new, hit, ill, normals or None)``, with ``debug`` a dict
        of :func:`generic_hit_reference`'s keys
    """
    dev, N = p.device, p.shape[0]
    if not _on_card(p) or gen.device is None:
        raise ValueError(f"generic_hit runs on CUDA tensors of a surface compiled there, not on {dev}; "
                         "elsewhere the eager route is the one")
    for name, t, shape, dtype in (("p", p, (N, 3), torch.float32), ("s", s, (N, 3), torch.float32),
                                  ("hw", hw, (N,), torch.bool)):
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor of shape {shape} on {dev}")
    keys = ("z_min_rel", "z_max_rel", "r")
    for k in keys:
        v = params[k]
        if v.device != dev or v.dtype != torch.float32 or v.numel() != 1:
            raise ValueError(f"the parameter {k} must be an f32 number on {dev}")
    p, s, hw = p.contiguous(), s.contiguous(), hw.contiguous()
    zmin, zmax, r = (params[k].contiguous() for k in keys)
    sag_code, sag_consts, mask_code, mask_consts = gen.device
    sag, mask = gen.sag, gen.mask
    kernel_normals = normals and gen.normals_rel is None
    p_new = torch.empty_like(p)
    hit = torch.empty((N,), dtype=torch.bool, device=dev)
    ill = torch.empty((N,), dtype=torch.bool, device=dev)
    nrm = torch.empty((N, 3), dtype=torch.float32, device=dev) if kernel_normals else None
    t_dbg = torch.empty((N,), dtype=torch.float32, device=dev) if debug else None
    valid = torch.empty((N,), dtype=torch.bool, device=dev) if debug else None
    broken = torch.empty((N,), dtype=torch.bool, device=dev) if debug else None
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.generic_hit_launch(
            p.data_ptr(), s.data_ptr(), hw.data_ptr(), N, zmin.data_ptr(), zmax.data_ptr(), r.data_ptr(),
            sag_code.data_ptr(), len(sag.code), sag_consts.data_ptr(), len(sag.consts), sag.out,
            _ptr(mask_code), len(mask.code) if mask is not None else 0, _ptr(mask_consts),
            len(mask.consts) if mask is not None else 0, mask.out if mask is not None else 0,
            max(_slots(sag), _slots(mask)), ITERS, *_EPS,
            p_new.data_ptr(), hit.data_ptr(), ill.data_ptr(), _ptr(nrm), _ptr(t_dbg), _ptr(valid),
            _ptr(broken), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"generic_hit kernel launch failed with CUDA error {rc}")
    generic_hit.launches += 1
    geom.generic_sag.sag_evals += N * sag_evals(kernel_normals)
    if gen.mask_rel is not None:
        hit = hit & gen.mask_rel(p_new[:, 0], p_new[:, 1])
    if normals and not kernel_normals:
        nrm = gen.normals_rel(p_new[:, 0], p_new[:, 1])
    if debug:
        return dict(p=p_new, hit=hit, ill=ill, t=t_dbg, valid=valid, broken=broken,
                    n_broken=torch.count_nonzero(broken), **({"normals": nrm} if normals else {}))
    return p_new, hit, ill, nrm


generic_hit.launches = 0        # kernel launches since the last reset
generic_hit.eager_steps = 0     # generic steps on a CUDA device that took the eager route
counted(generic_hit, "launches", "eager_steps")
