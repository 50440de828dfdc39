"""Detector/source image accumulator with XYZW channels.

Counterpart of ``optrace_tpu/image/render_image.py``: renders at max
resolution 945×(945·ratio) into (Ny, Nx, 4) channels X, Y, Z, W(=power);
``get(mode, N)`` downscales by integer bin-joining and converts to display
modes; Airy-disc Rayleigh filter; .npz save/load.

The binning runs on a device: on a CUDA device through the hand-written
histogram kernel (``ops/cuda_binning.py``), whose f32 image is widened to
f64 there and copied once into the f64 image that this class holds on the
host. The class is additive, so batched renders just sum into ``_data``.
An image remembers the device it was rendered on (``device``), and ``get``
runs the block mean and the colour conversions there, in f64, as the JAX
package runs them on its default device; it returns host images.
"""

from typing import Any

import numpy as np
import torch
import scipy.constants
import scipy.special
import scipy.signal

from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc
from .rgb_image import RGBImage
from .scalar_image import ScalarImage
from .. import color
from ..ops import binning
from ..ops.cuda_binning import bin_xyzw_cuda
from ..utils.device import resolve_device
from ..utils.global_options import global_options
from ..utils.tracing import span


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a writeable host array: the CPU tensor's own memory, or
    one copy of a card's tensor into pinned host memory."""
    if t.device.type == "cpu":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def _sum_into_zeros(shape, t: torch.Tensor) -> np.ndarray:
    """0 + ``t`` in f64 on ``t``'s device, as a host array: the bits of
    ``t`` added into a new image of zeros."""
    acc = torch.zeros(shape, dtype=torch.float64, device=t.device)
    acc += t.detach()
    return _host_array(acc)


class RenderImage(BaseClass):

    EPS: float = 1e-9
    K: float = scipy.constants.physical_constants["luminous efficacy"][0]

    SIZES: list = [1, 3, 5, 7, 9, 15, 21, 27, 35, 45, 63, 105, 135, 189, 315, 945]
    MAX_IMAGE_SIDE: int = SIZES[-1]
    MAX_IMAGE_RATIO: int = SIZES[2]

    image_modes: list = ["sRGB (Absolute RI)", "sRGB (Perceptual RI)", "Outside sRGB Gamut",
                         "Irradiance", "Illuminance", "Lightness (CIELUV)", "Hue (CIELUV)",
                         "Chroma (CIELUV)", "Saturation (CIELUV)"]

    def __init__(self, extent, projection: str = None, **kwargs) -> None:
        self._new_lock = False
        self.extent = extent
        self._extent0 = self.extent.copy()
        self._data = None
        self._limit = None
        self._device = None         # where get() computes: set by render, _accumulate and load
        self.projection = projection
        super().__init__(**kwargs)
        self._new_lock = True

    # ------------------------------------------------------------------
    def has_image(self) -> bool:
        return self._data is not None

    def __check_for_image(self) -> None:
        if not self.has_image():
            raise RuntimeError("Image was not calculated/rendered yet.")

    @property
    def s(self):
        return [float(self.extent[1] - self.extent[0]), float(self.extent[3] - self.extent[2])]

    @property
    def shape(self):
        self.__check_for_image()
        return self._data.shape

    @property
    def data(self) -> np.ndarray:
        self.__check_for_image()
        return self._data.copy()

    @property
    def Apx(self) -> float:
        self.__check_for_image()
        return self.s[0] * self.s[1] / (self.shape[1] * self.shape[0])

    @property
    def limit(self):
        return self._limit

    @property
    def device(self) -> torch.device:
        """The device that the image was rendered on, where :meth:`get`
        computes; an image rendered or loaded without one takes the CUDA
        device (``utils.device.resolve_device``)."""
        return resolve_device(self._device)

    def power(self) -> float:
        self.__check_for_image()
        return float(np.sum(self._data[:, :, 3]))

    def luminous_power(self) -> float:
        self.__check_for_image()
        return float(self.K * np.sum(self._data[:, :, 1]))

    # ------------------------------------------------------------------
    @staticmethod
    def _block_mean(arr: torch.Tensor, f: int) -> torch.Tensor:
        """Downscale by exact f×f bin joining (all SIZES divide 945, so the
        reduction is lossless block averaging — no interpolation), on the
        tensor's device. On the CPU through numpy's mean, whose order of
        sums the host code of both packages has; on a card its own."""
        if f == 1:
            return arr.clone()
        ny, nx = arr.shape[0] // f, arr.shape[1] // f
        blocks = arr[:ny * f, :nx * f].reshape(ny, f, nx, f, -1)
        if arr.device.type == "cpu":
            return torch.from_numpy(blocks.numpy().mean(axis=(1, 3)))
        return blocks.mean(dim=(1, 3))

    def _scalar_channel(self, mode: str, stack: torch.Tensor) -> torch.Tensor:
        """Extract one physical/colorimetric quantity from a downsampled
        XYZW stack, on its device. Irradiance/illuminance divide by the
        *full-resolution* pixel area: block-averaged power per bin keeps
        that normalization."""
        if mode == "Irradiance":
            return stack[:, :, 3] / self.Apx
        if mode == "Illuminance":
            return self.K / self.Apx * stack[:, :, 1]

        xyz = stack[:, :, :3].contiguous()
        if mode == "Outside sRGB Gamut":
            return color.outside_srgb_gamut(xyz).to(torch.float64)

        luv = color.xyz_to_luv(xyz)
        per_luv = {"Lightness (CIELUV)": lambda: luv[:, :, 0],
                   "Hue (CIELUV)": lambda: color.luv_hue(luv),
                   "Chroma (CIELUV)": lambda: color.luv_chroma(luv),
                   "Saturation (CIELUV)": lambda: color.luv_saturation(luv)}
        return per_luv[mode]()

    def get(self, mode: str, N: int = 315, L_th: float = 0,
            chroma_scale: float = None):
        """Convert to a display image, on the image's device (:attr:`device`),
        in f64; the result is a host image.

        N: requested pixel count of the smaller side; snapped to the nearest
        entry of SIZES, then the stored 945-px stack is block-averaged down.
        """
        with span("get"):
            self.__check_for_image()
            if mode not in self.image_modes:
                raise ValueError(f"Invalid display_mode {mode}, should be one of {self.image_modes}.")
            N = int(N)
            if not 1 <= N <= self.MAX_IMAGE_SIDE:
                raise ValueError(f"N needs to be between 1 and {self.MAX_IMAGE_SIDE}")

            side = min(self.SIZES, key=lambda s: abs(s - N))
            data = torch.from_numpy(np.asarray(self._data, dtype=np.float64)).to(self.device)
            stack = self._block_mean(data, self.MAX_IMAGE_SIDE // side)

            meta = dict(extent=self.extent, projection=self.projection, desc=self.desc,
                        long_desc=self.long_desc, quantity=mode, limit=self.limit)

            if mode in ("sRGB (Absolute RI)", "sRGB (Perceptual RI)"):
                intent = "Absolute" if "Absolute" in mode else "Perceptual"
                rgb = color.xyz_to_srgb(stack[:, :, :3].contiguous(), rendering_intent=intent, L_th=L_th,
                                        chroma_scale=chroma_scale)
                # + 0.0 turns a -0.0 that clamp keeps into the +0.0 of np.clip
                return RGBImage(_host_array(torch.clamp(rgb, 0.0, 1.0) + 0.0), **meta)

            return ScalarImage(_host_array(self._scalar_channel(mode, stack)), **meta)

    # ------------------------------------------------------------------
    def __fix_extent(self) -> None:
        """Fix point/line images and extreme side ratios."""
        sx, sy = self.s
        MR = self.MAX_IMAGE_RATIO
        self.extent = self._extent0.copy()

        if sx < 2 * self.EPS and sy < 2 * self.EPS:
            self.extent = self.extent + self.EPS * np.array([-1, 1, -1, 1])
        elif not sx or sy / sx > MR:
            xm = (self._extent0[0] + self._extent0[1]) / 2
            self.extent = np.array([xm - sy / MR / 2, xm + sy / MR / 2,
                                    self.extent[2], self.extent[3]])
        elif not sy or sx / sy > MR:
            ym = (self._extent0[2] + self._extent0[3]) / 2
            self.extent = np.array([self.extent[0], self.extent[1],
                                    ym - sx / MR / 2, ym + sx / MR / 2])

        if self._limit is not None:
            self.extent = self.extent + np.array([-1., 1., -1., 1.]) * 2.7 * self._limit / 1000.0

    def _image_resolution(self):
        """(Nx, Ny) at max render resolution given the extent ratio."""
        Nrs = self.MAX_IMAGE_SIDE
        def nf(a):
            return min(self.MAX_IMAGE_RATIO, 1 + 2 * int(a / 2))
        Nx = Nrs if self.s[0] <= self.s[1] else Nrs * nf(self.s[0] / self.s[1])
        Ny = Nrs if self.s[0] > self.s[1] else Nrs * nf(self.s[1] / self.s[0])
        return Nx, Ny

    def render(self, p=None, w=None, wl=None, limit: float = None,
               _dont_filter: bool = False, device=None) -> None:
        """Accumulate rays into the XYZW image.

        :param p, w, wl: hit positions (N, 3), weights and wavelengths (N,),
            host arrays or tensors
        :param device: where the binning runs. ``None`` is the CUDA device
            (raises without one); pass ``"cpu"`` for the CPU. Positions,
            weights and wavelengths are binned in f32 there.
        """
        self._limit = limit
        self.__fix_extent()
        Nx, Ny = self._image_resolution()

        self._data = None
        self._device = None if device is None else torch.device(device)
        if p is not None and len(p):
            device = self.device

            def f32(a):     # host data or a tensor, as f32 on the binning's device
                if not isinstance(a, torch.Tensor):
                    a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                return a.to(device=device, dtype=torch.float32)
            px, py, w_d, wl_d = f32(p[:, 0]), f32(p[:, 1]), f32(w), f32(wl)
            ext = tuple(float(v) for v in self.extent)
            bin_fn = bin_xyzw_cuda if global_options.cuda_binning else binning.bin_xyzw
            self._data = _sum_into_zeros((Ny, Nx, 4), bin_fn(px, py, w_d, wl_d, Nx, Ny, ext))
        else:
            self._data = np.zeros((Ny, Nx, 4), dtype=np.float64)

        if not _dont_filter and self._limit is not None:
            self._apply_rayleigh_filter()

    def _accumulate(self, img_dev) -> None:
        """Add a device-rendered (Ny, Nx, 4) tile (batched render path). A
        tensor is widened to f64 on its device, which the image takes as
        its own, and copied to the host once."""
        if self._data is None:
            self._limit = None
            self.__fix_extent()
            Nx, Ny = self._image_resolution()
            if isinstance(img_dev, torch.Tensor):
                self._device = img_dev.device
                self._data = _sum_into_zeros((Ny, Nx, 4), img_dev)
                return
            self._data = np.zeros((Ny, Nx, 4), dtype=np.float64)
        if isinstance(img_dev, torch.Tensor):
            self._device = img_dev.device
            img_dev = _host_array(img_dev.detach().to(torch.float64))
        self._data += np.asarray(img_dev, dtype=np.float64)

    def _apply_rayleigh_filter(self) -> None:
        """Airy-disc PSF convolution approximating the resolution limit."""
        if self._limit is not None and self.projection is not None:
            raise RuntimeError("Resolution limit filter is not applicable for a projected image.")

        px = self._limit / 1000.0 / (self.s[0] / self._data.shape[1])
        py = self._limit / 1000.0 / (self.s[1] / self._data.shape[0])

        ps = int(np.ceil(2.7 * max(px, py)))
        ps = ps + 1 if ps % 2 else ps

        Y, X = np.mgrid[-ps:ps:(2 * ps + 1) * 1j, -ps:ps:(2 * ps + 1) * 1j]
        R = np.sqrt((X / px) ** 2 + (Y / py) ** 2) * 3.8317
        psf = np.ones((2 * ps + 1, 2 * ps + 1), dtype=np.float64)
        Rnz = R[R != 0]
        psf[R != 0] = (2 * scipy.special.j1(Rnz) / Rnz) ** 2
        psf[R > 10.1735] = 0     # truncate at the third Airy zero
        psf *= 1 / psf.sum()

        self._data = scipy.signal.fftconvolve(self._data, psf[:, :, np.newaxis],
                                              mode="same", axes=(0, 1))
        self._data[self._data < 0] = 0

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Save as compressed .npz archive."""
        limit = self._limit if self._limit is not None else np.nan
        sdict = dict(_data=self._data, extent=self.extent, limit=limit,
                     desc=self.desc, long_desc=self.long_desc, proj=str(self.projection))
        path_ = path if path[-4:] == ".npz" else path + ".npz"
        np.savez_compressed(path_, **sdict)

    @staticmethod
    def load(path: str, device=None) -> "RenderImage":
        """Load a saved RenderImage archive.

        :param device: where :meth:`get` computes; ``None`` is the CUDA
            device, pass ``"cpu"`` for the CPU
        """
        io = np.load(path)
        im = RenderImage(io["extent"], long_desc=io["long_desc"][()], desc=io["desc"][()],
                         projection=io["proj"][()])
        im._device = None if device is None else torch.device(device)
        im._limit = io["limit"][()] if not np.isnan(io["limit"]) else None
        im.projection = None if im.projection == "None" else im.projection
        im._data = io["_data"]
        return im

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if key == "extent":
            pc.check_type(key, val, (list, tuple, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if val2.shape[0] != 4:
                raise ValueError("Extent needs to have 4 elements.")
            if val2[0] > val2[1] or val2[2] > val2[3]:
                raise ValueError("Extent needs [x0, x1, y0, y1] with x0 < x1 and y0 < y1.")
            super().__setattr__(key, val2)
            return
        if key == "projection" and val is not None:
            pc.check_type(key, val, str)
        elif key == "_limit" and val is not None:
            pc.check_type(key, val, (float, int))
            pc.check_above(key, val, 0)
            val = float(val)
        super().__setattr__(key, val)
