"""PSF convolution of images in linear sRGB.

Counterpart of ``optrace_tpu/analysis/convolve.py``: four colour cases
(gray⊛gray→gray, gray⊛colour-PSF→RGB, RGB⊛gray→RGB, RGB⊛[R,G,B-PSF]→RGB),
magnification scaling and flipping, the PSF rescaled to the image's pixel
pitch with its power kept, custom padding modes, ``keep_size`` cropping and
the final linear-sRGB → XYZ → sRGB conversion with ``cargs`` overrides.

The colour conversions, the PSF rescale and the convolutions run on one
device in f64: the convolution as ``torch.fft.rfft2``/``irfft2`` over the
padded full size, the rescale as the area-weighted resize of OpenCV's
``INTER_AREA`` written as two small matrices (:func:`area_resize`).
Padding and the shape arithmetic stay on the host.
"""

import math

import numpy as np
import scipy.fft
import torch

from .. import color
from ..image import RGBImage, GrayscaleImage, RenderImage
from ..utils.device import resolve_device
from ..utils.property_checker import PropertyChecker as pc
from ..utils.progress_bar import ProgressBar
from ..utils.warnings import warning


def _f32(v: float) -> float:
    """A resize coefficient as OpenCV keeps it: rounded to float32."""
    return float(np.float32(v))


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's area decimation along one axis
    (``computeResizeAreaTab``): an output cell averages the input cells it
    covers, partial cells by their covered share."""
    scale = ssize / dsize
    W = np.zeros((dsize, ssize))
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            W[dx, sx1 - 1] += _f32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            W[dx, sx] += _f32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            W[dx, sx2] += _f32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return W


def _area_linear_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's ``INTER_AREA`` where an axis is
    magnified: linear interpolation whose fraction is the share of the
    output cell that lies beyond the next input cell edge."""
    scale, inv = ssize / dsize, dsize / ssize
    W = np.zeros((dsize, ssize))
    for dx in range(dsize):
        sx = math.floor(dx * scale)
        fx = _f32((dx + 1) - (sx + 1) * inv)
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= ssize - 1:
            sx, fx = ssize - 1, 0.0
        W[dx, sx] += _f32(1.0 - fx)
        if fx:
            W[dx, sx + 1] += _f32(fx)
    return W


def area_resize(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`` of
    an (H, W) or (H, W, C) tensor, as two matrix products on its device.
    Where both axes shrink (or keep their size) a pixel is the area-weighted
    mean of the pixels it covers; where one grows, both axes take OpenCV's
    linear form of the area rule."""
    H, W = img.shape[:2]
    if (W, H) == (width, height):
        return img.clone()
    if W / width >= 1 and H / height >= 1:
        wy, wx = _area_weights(H, height), _area_weights(W, width)
    else:
        wy, wx = _area_linear_weights(H, height), _area_linear_weights(W, width)
    wy = torch.as_tensor(wy, dtype=img.dtype, device=img.device)
    wx = torch.as_tensor(wx, dtype=img.dtype, device=img.device)
    if img.ndim == 2:
        return wy @ img @ wx.T
    return torch.einsum("ya,abc,xb->yxc", wy, img, wx)


def _fftconvolve_full(img: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """2D 'full' convolution by real FFTs over the padded full size; a
    trailing channel axis of either input is broadcast against the other."""
    two_d = img.ndim == 2 and psf.ndim == 2
    if img.ndim == 2:
        img = img[:, :, None]
    if psf.ndim == 2:
        psf = psf[:, :, None]
    H, W = img.shape[0] + psf.shape[0] - 1, img.shape[1] + psf.shape[1] - 1
    s = (scipy.fft.next_fast_len(H, real=True), scipy.fft.next_fast_len(W, real=True))
    fi = torch.fft.rfft2(img.permute(2, 0, 1), s=s)
    fp = torch.fft.rfft2(psf.permute(2, 0, 1), s=s)
    out = torch.fft.irfft2(fi * fp, s=s)[:, :H, :W].permute(1, 2, 0)
    return out[:, :, 0] if two_d else out


def convolve(img, psf, m: float = 1, keep_size: bool = False,
             padding_mode: str = "constant", padding_value=None,
             cargs: dict = None, device=None):
    """Convolve an image with a point spread function.

    ``m`` is the system magnification (scales the image, m < 0 flips it),
    padding modes are those of ``numpy.pad``, ``cargs`` overrides the
    parameters of the final colour conversion.

    :param device: where the conversions and the convolution run; ``None``
        is the CUDA device (raises without one)
    :return: GrayscaleImage (gray image and gray PSF) or RGBImage
    """
    dev = resolve_device(device)
    cargs = cargs if cargs is not None else {}
    pc.check_type("m", m, (int, float))
    pc.check_type("cargs", cargs, dict)
    pc.check_above("abs(m)", abs(m), 0)
    pc.check_type("keep_size", keep_size, bool)

    img_color = isinstance(img, RGBImage)
    three_psf = isinstance(psf, list) and len(psf) == 3
    psf_color = isinstance(psf, RenderImage) or three_psf
    make_linear = isinstance(psf, GrayscaleImage) and isinstance(img, GrayscaleImage)

    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=dev)

    bar = ProgressBar("Convolving: ", 5)

    # ---- load image -------------------------------------------------
    pc.check_type("img", img, (RGBImage, GrayscaleImage))
    if img_color:
        if padding_value is not None:
            pc.check_type("padding_value", padding_value, (list, np.ndarray))
        pval = np.asarray(padding_value, dtype=np.float64) if padding_value is not None \
            else np.array([0., 0., 0.])
        if pval.ndim != 1 or pval.shape[0] != 3:
            raise ValueError(f"padding_value must be a 3 element array/list, but has shape {pval.shape}")
        if np.any(pval < 0):
            raise ValueError("value in 'padding_value' needs to be non-negative.")
        pval_lin = color.srgb_to_srgb_linear(pval[None, None, :]).numpy()[0, 0]
        img_lin = color.srgb_to_srgb_linear(t64(img.data))
    else:
        if padding_value is not None:
            pc.check_type("padding_value", padding_value, (int, float))
        pv = float(padding_value) if padding_value is not None else 0.
        pc.check_not_below("padding_value", pv, 0)
        pval_lin = color.srgb_to_srgb_linear(np.array([pv, pv, pv])[None, None, :]).numpy()[0, 0]
        img_lin = color.srgb_to_srgb_linear(t64(img.data))
        if not make_linear:
            img_lin = img_lin[:, :, None].expand(*img_lin.shape[:2], 3)
        else:
            pval_lin = pval_lin[0]
    custom_padding = not (padding_mode == "constant" and np.sum(pval_lin) == 0)
    bar.update()

    # ---- load psf ---------------------------------------------------
    if psf_color:
        psfs = [psf] if not three_psf else psf
        for i, psfi in enumerate(psfs):
            pc.check_type(f"psf[{i}]", psfi, RenderImage)
        pextent = psfs[0].extent
        if img_color and not three_psf:
            raise TypeError("A list of R, G, B RenderImage PSFs is required for convolving "
                            "a colored image with a colored PSF.")
        if not img_color and three_psf:
            raise TypeError("A single colored RenderImage is sufficient for a grayscale image.")
        psf_lins = []
        for i, psfi in enumerate(psfs):
            if not np.all(pextent == psfi.extent):
                raise ValueError("All PSF sizes need to be the same. Render the detector image "
                                 "with the same manual extent option.")
            psf_lins.append(color.xyz_to_srgb_linear(t64(psfi.data[:, :, :3]),
                                                     rendering_intent="Ignore", normalize=False))
    else:
        pc.check_type("psf", psf, GrayscaleImage)
        psfs = [psf]
        psf_lin = color.srgb_to_srgb_linear(t64(psf.data))
        psf_lin = psf_lin / torch.where(psf_lin.sum() != 0, psf_lin.sum(), 1.0)
        psf_lins = [psf_lin] if make_linear \
            else [psf_lin[:, :, None].expand(*psf.shape[:2], 3)]

    # ---- shapes -----------------------------------------------------
    iN = np.array(np.flip(img.shape[:2]))
    pN = np.array(np.flip(psfs[0].shape[:2]))
    is_ = np.array(img.s) * abs(m)
    ps_ = np.array(psfs[0].s)
    ip = is_ / (iN - 1)
    pp = ps_ / (pN - 1)

    if ps_[0] > 2 * is_[0] or ps_[1] > 2 * is_[1]:
        raise ValueError(f"m-scaled image size [{is_[0]:.5g}, {is_[1]:.5g}] is more than two "
                         f"times smaller than PSF size [{ps_[0]:.5g}, {ps_[1]:.5g}].")
    if pN[0] * pN[1] > 4e6:
        raise ValueError("PSF needs to be smaller than 4MP")
    if iN[0] * iN[1] > 4e6:
        raise ValueError("Image needs to be smaller than 4MP")
    if pp[0] > ip[0] or pp[1] > ip[1]:
        warning(f"PSF pixel sizes [{pp[0]:.5g}, {pp[1]:.5g}] larger than image pixel sizes "
                f"[{ip[0]:.5g}, {ip[1]:.5g}], generally you want a PSF in a higher resolution")
    if pN[0] < 50 or pN[1] < 50:
        raise ValueError(f"PSF too small with shape {psfs[0].shape}, needs at least 50 values per dim.")
    if iN[0] < 50 or iN[1] < 50:
        raise ValueError(f"Image too small with shape {img.shape}, needs at least 50 values per dim.")
    if iN[0] * iN[1] < 2e4:
        warning("Low resolution image.")
    if pN[0] * pN[1] < 2e4:
        warning("Low resolution PSF.")
    if not (0.2 < pp[0] / pp[1] < 5):
        warning(f"Pixels of PSF are strongly non-square with side lengths [{pp[0]}mm, {pp[1]}mm]")
    if not (0.2 < ip[0] / ip[1] < 5):
        warning(f"Pixels of image are strongly non-square with side lengths [{ip[0]}mm, {ip[1]}mm]")

    sc = pp / ip
    ppad = np.array([4, 4], dtype=np.int32)
    p2N = np.where(pN * sc < 1, 1, np.round(pN * sc).astype(int))
    p3N = p2N + 2 * ppad
    ipad = p3N if custom_padding else np.array([0, 0], dtype=np.int32)
    i2N = iN + 2 * ipad
    i3N = i2N + p3N - 1
    i4N = iN if keep_size else iN + p3N - 1
    i4s = (i4N - 1) * ip
    extent = np.asarray(img.extent) + np.asarray(psfs[0].extent)
    xm = (extent[0] + extent[1]) / 2
    ym = (extent[2] + extent[3]) / 2
    i4e = [xm - i4s[0] / 2, xm + i4s[0] / 2, ym - i4s[1] / 2, ym + i4s[1] / 2]

    # ---- pad + flip image (host) ------------------------------------
    if custom_padding:
        img_np = img_lin.cpu().numpy()
        pad_size = ((ipad[1], ipad[1]), (ipad[0], ipad[0]), (0, 0))
        shape = pad_size[:2] if img_np.ndim == 2 else pad_size
        if padding_mode == "constant" and img_np.ndim == 3:
            imgp = np.tile(pval_lin, (iN[1] + 2 * ipad[1], iN[0] + 2 * ipad[0], 1))
            imgp[ipad[1]:-ipad[1], ipad[0]:-ipad[0]] = img_np
        else:
            kwargs = dict(constant_values=pval_lin) if padding_mode == "constant" else {}
            imgp = np.pad(img_np, shape, mode=padding_mode, **kwargs)
        imgp = t64(imgp)
    else:
        imgp = img_lin
    if m < 0:
        imgp = torch.flip(imgp, dims=(0, 1))
    bar.update()

    # ---- rescale + pad psf ------------------------------------------
    psf2s = []
    for psf_lin in psf_lins:
        psf2 = area_resize(psf_lin.contiguous(), int(p2N[0]), int(p2N[1])) \
            * (pN[0] * pN[1] / p2N[0] / p2N[1])
        # zero border of ppad pixels; F.pad lists the last axis first
        pad = (0, 0) * (psf2.ndim - 2) + (int(ppad[0]),) * 2 + (int(ppad[1]),) * 2
        psf2s.append(torch.nn.functional.pad(psf2, pad))
    bar.update()

    # ---- convolve ---------------------------------------------------
    if three_psf:
        img2 = torch.zeros((i3N[1], i3N[0], 3), dtype=torch.float64, device=dev)
        for i, psf_lin in enumerate(psf2s):
            img2 += _fftconvolve_full(imgp[:, :, i][:, :, None], psf_lin)
    else:
        img2 = _fftconvolve_full(imgp, psf2s[0])
        if make_linear and img2.ndim == 3:
            img2 = img2[:, :, 0]
    bar.update()

    # ---- slice + convert --------------------------------------------
    if custom_padding:
        img2 = img2[ipad[1]:-ipad[1], ipad[0]:-ipad[0]]
    if keep_size:
        i2sl = (i3N - i2N) // 2
        img2 = img2[i2sl[1]:i2sl[1] + iN[1], i2sl[0]:i2sl[0] + iN[0]]

    if make_linear:
        if "normalize" not in cargs or cargs["normalize"]:
            imax = img2.max()
            img2 = img2 / torch.where(imax != 0, imax, 1.0)
        img2 = torch.clamp(img2, 0, 1)
        out = torch.clamp(color.srgb_linear_to_srgb(img2), 0, 1).cpu().numpy()
        bar.finish()
        return GrayscaleImage(out, extent=i4e)

    xyz = color.srgb_linear_to_xyz(img2)
    cargs0 = dict(rendering_intent="Absolute", normalize=True, clip=True,
                  L_th=0, chroma_scale=None)
    out = torch.clamp(color.xyz_to_srgb(xyz, **(cargs0 | cargs)), 0, 1).cpu().numpy()
    bar.finish()
    return RGBImage(out, extent=i4e)
