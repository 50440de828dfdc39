"""Axial focus metrics over many planes at once.

Counterpart of ``optrace_tpu/analysis/focus.py``. Each surviving ray is
reduced to an affine line ``q(z) = q0 + m * z`` in the transverse plane
(``m`` = direction scaled to unit z-step). Costs:

- **RMS Spot Size**: weighted transverse standard deviation; its minimum
  also has a closed form (:func:`rms_focus_direct`, f64).
- **Image Sharpness**: negative gradient energy of a binned irradiance
  histogram over the bundle's extent in that plane.
- **Image Center Sharpness**: the same, after a raised-cosine radial window
  and renormalization.
- **Irradiance Variance**: ``-log`` of the variance of the non-empty
  histogram bins, normalized by pixel area.

Where the JAX package maps the cost over the planes with ``jax.vmap``, a
sweep here evaluates a chunk of planes with batched tensor operations: the
histograms of a chunk are one order-free sum (``ops/binning.py:scatter_sum``)
into ``planes × n_px²`` bins under the flat index ``plane · n_px² + pixel``,
at a scale set by the ray count and the largest weight, so a plane's
histogram does not depend on the order of the rays or on the chunk that
holds it. The RMS cost and its closed form sum over the rays in the same
order-free way (``ops/binning.py:block_sums``), each plane at the scale of
its own largest value, so neither does a plane's RMS cost. A chunk holds as
many planes as keep its ``q0 + m·z`` within :data:`CHUNK_BYTES`.
"""

import math

import numpy as np
import torch

from ..ops.binning import block_sums, scatter_sum

SWEEP_SAMPLES = 320          # planes per coarse sweep
REFINE_ROUNDS = 3            # zoom iterations after the coarse sweep
REFINE_SAMPLES = 33
# the (planes, N, 2) f32 positions of one chunk of a sweep; the chunk's
# order-free sums hold f64 and int64 copies of them besides, so a sweep's
# peak is several times this (chip_smoke.py's phase focus prints it)
CHUNK_BYTES = 256 * 2 ** 20

MODES = ("RMS Spot Size", "Image Sharpness", "Image Center Sharpness", "Irradiance Variance")


def histogram_side(n_rays: int) -> int:
    """Odd histogram resolution that grows with the ray count."""
    side = 100 * int(1 + np.sqrt(n_rays) / 1500)
    return side + (0 if side % 2 else 1)


def _planes(q0, m, z):
    """Positions (P, N, 2) of the rays in the planes ``z`` (P,)."""
    return q0[None] + m[None] * z[:, None, None]


def _rms_cost(q0, m, w, z):
    q = _planes(q0, m, z)
    P, N = q.shape[:2]
    wsum = block_sums(w[:, None])[0, 0]
    mean = block_sums((q * w[None, :, None]).reshape(P * N, 2), P)[:, None] / wsum
    var = block_sums((((q - mean) ** 2) * w[None, :, None]).reshape(P * N, 2), P) / wsum
    return torch.sqrt(var[:, 0] + var[:, 1])


def _spot_histograms(q0, m, w, z, n_px: int):
    """(P, n_px, n_px) power histograms spanning each plane's bundle extent
    (positive edges inclusive, as ``ops/binning.py:bin_scalar``), and the
    pixel area of each."""
    q = _planes(q0, m, z)
    x, y = q[..., 0], q[..., 1]
    x0, x1 = x.amin(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)
    y0, y1 = y.amin(dim=1, keepdim=True), y.amax(dim=1, keepdim=True)
    # a number over a tensor is a reciprocal times the number in PyTorch
    # (two roundings): divide a tensor, as the binning of ops/binning.py does
    n = x.new_tensor(float(n_px))
    fx = torch.floor(n / (x1 - x0) * (x - x0))
    fy = torch.floor(n / (y1 - y0) * (y - y0))
    fx = torch.where(x == x1, float(n_px - 1), fx)
    fy = torch.where(y == y1, float(n_px - 1), fy)
    inside = (fx >= 0) & (fy >= 0) & (fy < n_px) & (fx < n_px)
    wm = torch.where(inside, w[None], 0.0)
    pix = (torch.where(inside, fy, 0.0) * n_px + torch.where(inside, fx, 0.0)).to(torch.int64)
    P = z.shape[0]
    flat = pix + torch.arange(P, device=pix.device)[:, None] * (n_px * n_px)
    img = scatter_sum(P * n_px * n_px, flat.reshape(-1), wm.reshape(-1),
                      n=w.shape[0], vmax=w.abs().amax())
    apx = ((x1 - x0) * (y1 - y0))[:, 0] / n_px ** 2
    return img.view(P, n_px, n_px), apx


def _gradient_energy(img):
    return ((img[:, 1:] - img[:, :-1]) ** 2).sum(dim=(1, 2)) \
        + ((img[:, :, 1:] - img[:, :, :-1]) ** 2).sum(dim=(1, 2))


def _sharpness_cost(q0, m, w, z, n_px: int, windowed: bool):
    img, _ = _spot_histograms(q0, m, w, z, n_px)
    if windowed:
        ax = torch.linspace(-1.0, 1.0, n_px, dtype=img.dtype, device=img.device)
        rad = torch.sqrt(ax[None, :] ** 2 + ax[:, None] ** 2)
        img = img * torch.where(rad > 1, 0.0, 1.0 + torch.cos(rad * math.pi))
        total = img.sum(dim=(1, 2), keepdim=True)
        img = torch.where(total > 0, img / torch.where(total > 0, total, 1.0), img)
    return -_gradient_energy(img)


def _variance_cost(q0, m, w, z, n_px: int):
    img, apx = _spot_histograms(q0, m, w, z, n_px)
    filled = img > 0
    cnt = torch.clamp(filled.sum(dim=(1, 2)), min=1)
    mean = torch.where(filled, img, 0.0).sum(dim=(1, 2)) / cnt
    var = torch.where(filled, (img - mean[:, None, None]) ** 2, 0.0).sum(dim=(1, 2)) / cnt
    return -torch.log(var / apx ** 2)


def plane_chunk(n_rays: int) -> int:
    """Planes a chunk of a sweep holds."""
    return max(1, CHUNK_BYTES // (8 * max(1, n_rays)))


def cost_sweep(z_arr, q0, m, w, mode: str, n_px: int):
    """The focus cost at every plane of ``z_arr`` (P,), on the device and in
    the type of ``q0`` (N, 2), ``m`` (N, 2) and ``w`` (N,)."""
    if mode not in MODES:
        raise ValueError(f"Invalid mode '{mode}', should be one of {list(MODES)}.")
    z_arr = torch.as_tensor(z_arr, dtype=q0.dtype, device=q0.device).reshape(-1)
    step = plane_chunk(q0.shape[0])
    out = []
    for i in range(0, z_arr.shape[0], step):
        z = z_arr[i:i + step]
        if mode == "RMS Spot Size":
            out.append(_rms_cost(q0, m, w, z))
        elif mode == "Irradiance Variance":
            out.append(_variance_cost(q0, m, w, z, n_px))
        else:
            out.append(_sharpness_cost(q0, m, w, z, n_px, mode == "Image Center Sharpness"))
    return torch.cat(out)


def rms_focus_direct(q0, m, w, bounds) -> float:
    """Closed-form minimizer of the weighted RMS spot size, in f64 on the
    device of ``q0``, from order-free sums over the rays.

    var_x(z) + var_y(z) is quadratic in z with minimum
    z* = -(cov(x0, mx) + cov(y0, my)) / (var(mx) + var(my))
    over the w-weighted central moments of the line parameters.
    """
    q0, m, w = (torch.as_tensor(a).to(torch.float64) for a in (q0, m, w))
    wsum = block_sums(w[:, None])[0, 0]
    qc = q0 - block_sums(q0 * w[:, None])[0] / wsum
    mc = m - block_sums(m * w[:, None])[0] / wsum
    curv = float(block_sums((w * (mc[:, 0] ** 2 + mc[:, 1] ** 2))[:, None])[0, 0] / wsum)
    slope = float(block_sums((w * (qc[:, 0] * mc[:, 0] + qc[:, 1] * mc[:, 1]))[:, None])[0, 0] / wsum)
    z_opt = -slope / curv if curv else float(np.mean(bounds))
    return float(np.clip(z_opt, bounds[0], bounds[1]))


def _nanargmin(vals) -> int:
    """Index of the smallest value that is not NaN; -1 when all are NaN."""
    nan = torch.isnan(vals)
    if bool(nan.all()):
        return -1
    return int(torch.where(nan, torch.inf, vals).argmin())


def minimize_on_interval(q0, m, w, bounds, mode: str, n_px: int) -> float:
    """Coarse sweep and three shrinking windows around the best plane."""
    lo, hi = float(bounds[0]), float(bounds[1])
    dev, dt = q0.device, q0.dtype
    z = torch.linspace(lo, hi, SWEEP_SAMPLES, dtype=dt, device=dev)
    best = float(z[_nanargmin(cost_sweep(z, q0, m, w, mode, n_px))])

    half = (hi - lo) / SWEEP_SAMPLES
    for _ in range(REFINE_ROUNDS):
        z = torch.linspace(max(lo, best - half), min(hi, best + half), REFINE_SAMPLES,
                           dtype=dt, device=dev)
        best = float(z[_nanargmin(cost_sweep(z, q0, m, w, mode, n_px))])
        half /= 8.0
    return best
