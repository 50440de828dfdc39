"""Detector binning kernel: wrapper around ``csrc/bin_xyzw.cu``.

Counterpart of ``optrace_tpu/ops/pallas_binning.py`` (``bin_xyzw_pallas``):
the weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w) behind the fused render.
The kernel rounds each ray's four values to 64-bit integers at a power-of-two
scale, sorts the rays by image tile (a counting sort on the device), sums
each tile's integers in shared memory and converts each lit pixel to f32
once, so the image does not depend on the order of the rays (the source
carries the design note and the bound). Its plain version is
:func:`optrace_tpu_torch.ops.binning.bin_xyzw_fixed`, which it equals bit for
bit. Tensors on the CPU take :func:`optrace_tpu_torch.ops.binning.bin_xyzw`
(f32 ``index_add_``, the JAX package's sums), re-exported here as
:func:`bin_xyzw_reference`.
"""

import ctypes

import torch

from .binning import bin_xyzw as bin_xyzw_reference
from ..color.observers import observer_table, observer_bound
from ..utils.tracing import counted

# the kernel's compile-time constants (csrc/bin_xyzw.cu: BIN_TILE, BIN_CHUNK),
# checked against the library when it is loaded
TILE = 2048             # pixels a tile: consecutive keys, summed in shared memory
CHUNK = 4096            # rays a work item at most
MAX_RAYS = 2 ** 31 - 1  # the counting sort's 32-bit ray offsets
MAX_PIXELS = 2 ** 29 - 1    # the 32-bit pixel keys, with headroom for the key arithmetic


def _up16(b: int) -> int:
    return (b + 15) // 16 * 16


def scratch_layout(N: int, Nx: int, Ny: int, tile: int = TILE, chunk: int = CHUNK) -> dict:
    """Byte offsets of the kernel's scratch parts for N rays into an Ny × Nx
    image, as ``csrc/bin_xyzw.cu:layout`` computes them: a function of (N,
    Nx, Ny) and the kernel's constants alone, each part 16-byte aligned.

    ``head`` (max|w|, work items, split tiles) and ``count`` (rays a tile)
    are the first ``zeroed`` bytes, which a launch sets to 0; ``cursor``
    (each tile's place in the records), ``items`` (the work list: 16 B an
    item), ``arrive`` (a split tile's items still to come), ``records``
    (16 B a ray, the live ones sorted by tile) and ``split`` (a split tile's
    int64 sums, ``tile`` · 32 B) are written before they are read. ``total`` is the size. Raises for sizes
    beyond the kernel's 32-bit indices."""
    P = Nx * Ny
    if not 0 <= N <= MAX_RAYS:
        raise ValueError(f"the binning kernel takes at most {MAX_RAYS} rays, not {N}")
    if Nx < 1 or Ny < 1 or P > MAX_PIXELS:
        raise ValueError(f"image of {Ny} × {Nx} pixels outside the binning kernel's "
                         f"32-bit pixel index (1 to {MAX_PIXELS} pixels)")
    tiles = -(-P // tile)
    items = tiles + -(-N // chunk)
    splits = min(N // (chunk + 1), tiles)       # tiles of more than one work item
    lay = dict(tiles=tiles, items_max=items, splits_max=splits, head=0, count=16)
    lay["cursor"] = lay["count"] + _up16(4 * tiles)
    lay["zeroed"] = lay["cursor"]
    lay["items"] = lay["cursor"] + _up16(4 * tiles)
    lay["arrive"] = lay["items"] + 16 * items
    lay["records"] = lay["arrive"] + _up16(4 * splits)
    lay["split"] = lay["records"] + 16 * N
    lay["total"] = lay["split"] + splits * tile * 32
    return lay


def _lib():
    from . import _build
    lib = _build.load("bin_xyzw")
    if not getattr(lib, "_ot_ready", False):
        vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.bin_xyzw_tiles_launch.argtypes = [vp, vp, vp, vp, cll, vp, ci, cf, cf,
                                              cf, cf, cf, cf, cf, cf, ci, ci, ctypes.c_double,
                                              vp, cll, vp, vp]
        lib.bin_xyzw_tiles_launch.restype = ci
        lib.bin_xyzw_tiles_scratch_bytes.argtypes = [cll, cll]
        lib.bin_xyzw_tiles_scratch_bytes.restype = cll
        config = (cll * 4)()
        lib.bin_xyzw_tiles_config(config)
        if (config[0], config[1]) != (TILE, CHUNK):
            raise RuntimeError(f"csrc/bin_xyzw.cu has BIN_TILE, BIN_CHUNK = {config[0]}, {config[1]}; "
                               f"ops/cuda_binning.py expects {TILE}, {CHUNK}")
        lib._ot_ready = True
    return lib


def bin_xyzw_cuda(px, py, w, wl, Nx: int, Ny: int, extent, out=None):
    """Accumulate rays into an (Ny, Nx, 4) image of X̄w, Ȳw, Z̄w, w.

    On CUDA tensors this launches the kernel (or raises), whose image
    equals :func:`~optrace_tpu_torch.ops.binning.bin_xyzw_fixed`'s bit for
    bit; tensors on the CPU take :func:`bin_xyzw_reference`. ``out`` (Ny,
    Nx, 4) f32, when given, is accumulated into in place; otherwise a zeroed
    image is made.
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
    lay = scratch_layout(N, Nx, Ny)
    if out is None:
        out = torch.zeros((Ny, Nx, 4), dtype=torch.float32, device=dev)
    elif (out.device != dev or out.dtype != torch.float32 or tuple(out.shape) != (Ny, Nx, 4)
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({Ny}, {Nx}, 4) tensor on {dev}")

    x0, x1, y0, y1 = (float(v) for v in extent[:4])
    obs, wl0, wl1 = observer_table(dev, torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        # from the caller's stream, so under a CUDA graph's capture from the
        # graph's own pool; the launch zeroes what it needs zeroed
        scratch = torch.empty((lay["total"],), dtype=torch.uint8, device=dev)
        # the bin scale is evaluated in f64 and rounded once, as the plain
        # version's python-float expression Nx / (x1 - x0) is
        rc = lib.bin_xyzw_tiles_launch(
            px.data_ptr(), py.data_ptr(), w.data_ptr(), wl.data_ptr(), N,
            obs.data_ptr(), obs.shape[1], wl0, wl1,
            x0, x1, y0, y1, Nx / (x1 - x0), Ny / (y1 - y0), Nx, Ny, observer_bound(),
            scratch.data_ptr(), lay["total"], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bin_xyzw kernel launch failed with error {rc}")
    bin_xyzw_cuda.launches += 1
    return out


bin_xyzw_cuda.launches = 0          # kernel launches since the last reset
counted(bin_xyzw_cuda, "launches")
