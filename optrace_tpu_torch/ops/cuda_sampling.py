"""Wavelengths of an RGB image source on the card: wrapper around
``csrc/srgb_wavelengths.cu``.

The kernel maps each ray's flat pixel index ``P`` and its two uniforms
``choice`` and ``u`` to one wavelength: the pixel's sRGB triple, its linear
channel powers, the primary that ``choice`` picks and ``u`` through that
primary's inverse CDF. Its plain version is
:func:`srgb_wavelengths_reference`, which is
:func:`optrace_tpu_torch.color.wavelengths_from_srgb` on the gathered
pixels, and which it equals bit for bit on the card. It replaces no TPU
kernel (the source carries the design note and the bound).

An RGB image source's sampler on a CUDA device draws ``choice`` and ``u``
as the plain route does and calls :func:`srgb_wavelengths`; every other
source, and every source on the CPU, keeps the plain route.
"""

import ctypes

import torch

from ..color import srgb
from ..utils.global_options import global_options
from ..utils.tracing import counted


def primary_lut(device) -> tuple:
    """``(factors, tables, left, right)`` of the primaries on ``device``
    for the current ``global_options.wavelength_range``: the f32 power
    factors (3,), the three inverse CDFs (3, M) and the values of a lookup
    outside the tables. These are the tensors of the plain route (the same
    cache), made now, so that a kernel call copies nothing from the host.
    Raises if the range does not hold the visible band."""
    srgb.check_wavelength_range()
    factors, _, tables, (left, right) = srgb._primary_lookups(
        tuple(global_options.wavelength_range), torch.device(device), torch.float32,
        torch.float32)
    return factors, tables, left, right


def srgb_wavelengths_reference(P, choice, u, pix):
    """Plain PyTorch version of :func:`srgb_wavelengths` (without its
    ``lut``: the tables of the current wavelength range), on any device."""
    return srgb.wavelengths_from_srgb(pix[P], choice, u)


def _lib():
    from . import _build
    lib = _build.load("srgb_wavelengths")
    if not getattr(lib, "_ot_ready", False):
        vp, cf = ctypes.c_void_p, ctypes.c_float
        lib.srgb_wavelengths_launch.argtypes = [vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                                                ctypes.c_int, cf, cf, vp, vp]
        lib.srgb_wavelengths_launch.restype = ctypes.c_int
        lib._ot_ready = True
    return lib


def _check(name, t, dtype, shape, dev):
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"{name} must be a tensor on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the sRGB wavelength kernel, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def srgb_wavelengths(P, choice, u, pix, lut):
    """One f32 wavelength per ray of an RGB image source, launched on the
    current stream (so that a CUDA graph's capture records it).

    :param P: (N,) int64 flat pixel indices into ``pix``, each in range (the
        kernel reads ``pix`` at them unchecked)
    :param choice, u: (N,) f32 uniforms in [0, 1)
    :param pix: (pixels, 3) f32 sRGB values of the image, row-major
    :param lut: :func:`primary_lut` of the same device
    :return: (N,) f32 wavelengths in nm, equal to
        :func:`srgb_wavelengths_reference`'s on the card
    """
    if not isinstance(P, torch.Tensor) or P.ndim != 1:
        raise ValueError("P must be a (N,) tensor")
    factors, tables, left, right = lut
    dev, N = P.device, P.shape[0]
    _check("P", P, torch.int64, (N,), dev)
    _check("choice", choice, torch.float32, (N,), dev)
    _check("u", u, torch.float32, (N,), dev)
    if not isinstance(pix, torch.Tensor) or pix.ndim != 2:
        raise ValueError("pix must be a (pixels, 3) tensor")
    _check("pix", pix, torch.float32, (pix.shape[0], 3), dev)
    _check("factors", factors, torch.float32, (3,), dev)
    if not isinstance(tables, torch.Tensor) or tables.ndim != 2 or tables.shape[1] < 2:
        raise ValueError("tables must be a (3, M) tensor with M >= 2")
    _check("tables", tables, torch.float32, (3, tables.shape[1]), dev)
    if dev.type != "cuda":
        raise ValueError(f"srgb_wavelengths runs on CUDA tensors only, not on {dev}; "
                         "elsewhere color.wavelengths_from_srgb is the route")
    P, choice, u, pix, factors, tables = (t.contiguous()
                                          for t in (P, choice, u, pix, factors, tables))

    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((N,), dtype=torch.float32, device=dev)
        rc = lib.srgb_wavelengths_launch(
            P.data_ptr(), choice.data_ptr(), u.data_ptr(), N, pix.data_ptr(),
            factors.data_ptr(), tables.data_ptr(), tables.shape[1], left, right,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"srgb_wavelengths kernel launch failed with CUDA error {rc}")
    srgb_wavelengths.launches += 1
    return out


srgb_wavelengths.launches = 0       # kernel launches since the last reset
counted(srgb_wavelengths, "launches")
