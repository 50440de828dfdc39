"""Detector binning kernel: wrapper around ``csrc/bin_xyzw.cu``.

Counterpart of ``optrace_tpu/ops/pallas_binning.py`` (``bin_xyzw_pallas``):
the weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w) behind the fused render.
The kernel is one pass over the rays with f32 atomic adds (the source
carries the design note and the bound). Its plain PyTorch version is
:func:`optrace_tpu_torch.ops.binning.bin_xyzw` (``index_add_``), re-exported
here as :func:`bin_xyzw_reference`; the two differ by f32 summation order.
"""

import ctypes

import torch

from .binning import bin_xyzw as bin_xyzw_reference
from ..color.observers import observer_table


def _lib():
    from . import _build
    lib = _build.load("bin_xyzw")
    if not getattr(lib, "_ot_ready", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bin_xyzw_launch.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, ci, cf, cf,
                                        cf, cf, cf, cf, cf, cf, ci, ci, vp, vp]
        lib.bin_xyzw_launch.restype = ci
        lib._ot_ready = True
    return lib


def bin_xyzw_cuda(px, py, w, wl, Nx: int, Ny: int, extent, out=None):
    """Accumulate rays into an (Ny, Nx, 4) image of X̄w, Ȳw, Z̄w, w.

    On CUDA tensors this launches the kernel (or raises); tensors on the
    CPU take the plain version. ``out`` (Ny, Nx, 4) f32, when given, is
    accumulated into in place; otherwise a zeroed image is made.
    """
    if px.device.type == "cpu":
        return bin_xyzw_reference(px, py, w, wl, Nx, Ny, extent, out=out)
    if px.device.type != "cuda":
        raise ValueError(f"bin_xyzw_cuda runs on CUDA or CPU tensors, not on {px.device}")

    dev, N = px.device, px.shape[0]
    for name, t in (("px", px), ("py", py), ("w", w), ("wl", wl)):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the binning kernel, got {t.dtype}")
        if tuple(t.shape) != (N,):
            raise ValueError(f"{name} must have shape ({N},), got {tuple(t.shape)}")
    px, py, w, wl = px.contiguous(), py.contiguous(), w.contiguous(), wl.contiguous()
    if Nx * Ny >= 2 ** 29:
        raise ValueError("image too large for the binning kernel's 32-bit pixel index")
    if out is None:
        out = torch.zeros((Ny, Nx, 4), dtype=torch.float32, device=dev)
    elif (out.device != dev or out.dtype != torch.float32 or tuple(out.shape) != (Ny, Nx, 4)
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({Ny}, {Nx}, 4) tensor on {dev}")

    x0, x1, y0, y1 = (float(v) for v in extent[:4])
    obs, wl0, wl1 = observer_table(dev, torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        # the bin scale is evaluated in f64 and rounded once, as the plain
        # version's python-float expression Nx / (x1 - x0) is
        rc = lib.bin_xyzw_launch(
            px.data_ptr(), py.data_ptr(), w.data_ptr(), wl.data_ptr(), N,
            obs.data_ptr(), obs.shape[1], wl0, wl1,
            x0, x1, y0, y1, Nx / (x1 - x0), Ny / (y1 - y0), Nx, Ny,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bin_xyzw kernel launch failed with error {rc}")
    bin_xyzw_cuda.launches += 1
    return out


bin_xyzw_cuda.launches = 0          # kernel launches since the last reset


def reset_launch_counts() -> None:
    bin_xyzw_cuda.launches = 0
