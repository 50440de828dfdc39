"""Monte-Carlo samplers driven by an explicit ``torch.Generator``.

Counterpart of ``optrace_tpu/ops/sampling.py``. Every sampler takes the
generator ``gen`` whose device is the device the samples are made on, so a
trace is reproducible from the generator's seed. Successive draws from one
generator are independent streams.

Samplers:
- stratified interval / rectangle (jittered grids)
- stratified ring via the Shirley/Chiu concentric equal-area square→disc map
- inverse-transform sampling from tabulated pdfs (continuous) and discrete
  line spectra.
"""

import math

import numpy as np
import torch

from .interp import uniform_interp, invert_cdf_uniform


def _rand(gen: torch.Generator, N: int, dtype=torch.float32):
    return torch.rand((N,), generator=gen, device=gen.device, dtype=dtype)


def uniform(gen, N: int, a: float, b: float):
    """N uniform samples in [a, b]."""
    return a + (b - a) * _rand(gen, N)


def _shuffle_permutation(gen, N: int):
    """Pseudorandom permutation of [0, N) for decorrelating stratification
    order between sampling streams (wavelength vs position vs divergence).

    This MUST be a pseudorandom bijection, independent per stream: an
    affine-stride permutation (a·i + b mod N) composes one stream with the
    inverse of another into ANOTHER affine map, so the (wavelength-rank,
    angle-rank) pairs of every ray would lie on a lattice — a polychromatic
    trace then correlates colour with aim angle and skews every chromatic
    image. ``torch.randperm`` is such a bijection."""
    return torch.randperm(N, generator=gen, device=gen.device)


def stratified_interval_sampling(gen, N: int, a, b, shuffle: bool = True):
    """N stratified (jittered-grid) samples in [a, b].

    Each of N equal cells receives exactly one uniform sample; optional
    shuffling removes ordering correlation between successive rays.
    """
    jitter = _rand(gen, N)
    if shuffle:
        cells = _shuffle_permutation(gen, N).to(jitter.dtype)
    else:
        cells = torch.arange(N, dtype=jitter.dtype, device=jitter.device)
    pos = (cells + jitter) / N
    return a + (b - a) * pos


def stratified_rectangle_sampling(gen, N: int, x0, x1, y0, y1,
                                  shuffle: bool = True):
    """N stratified samples in the rectangle [x0,x1]×[y0,y1].

    A ⌊√N⌋² jittered grid covers most samples; the remainder is drawn
    uniformly. Cell ASSIGNMENTS are permuted instead of the samples: the
    jitter is iid per output slot, so giving slot i the grid cell perm(i)
    has the identical distribution with no gathers.
    Returns (x, y) tensors of length N.
    """
    n = int(math.isqrt(N))
    n2 = n * n
    if shuffle and N > 1:
        pi = _shuffle_permutation(gen, N)
    else:
        pi = torch.arange(N, device=gen.device)

    jx = _rand(gen, N)
    jy = _rand(gen, N)
    if n2 > 0:
        in_grid = pi < n2
        ix = torch.where(in_grid, pi % n, 0).to(jx.dtype)
        iy = torch.where(in_grid, pi // n, 0).to(jx.dtype)
        gx = torch.where(in_grid, (ix + jx) / n, jx)
        gy = torch.where(in_grid, (iy + jy) / n, jy)
    else:
        gx, gy = jx, jy

    return x0 + (x1 - x0) * gx, y0 + (y1 - y0) * gy


def _concentric_square_to_disc(u, v):
    """Shirley–Chiu concentric map: unit square → unit disc, equal-area,
    stratification-preserving. Returns (r, phi)."""
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    use_a = torch.abs(a) > torch.abs(b)
    # avoid 0/0 at the origin
    safe_a = torch.where(a == 0, 1.0, a)
    safe_b = torch.where(b == 0, 1.0, b)
    # signed radius keeps the formula 2-branch; fold the sign into the angle
    rs = torch.where(use_a, a, b)
    phi = torch.where(use_a,
                      (math.pi / 4.0) * (b / safe_a),
                      (math.pi / 2.0) - (math.pi / 4.0) * (a / safe_b))
    phi = torch.where(rs < 0, phi + math.pi, phi)
    phi = torch.where((a == 0) & (b == 0), 0.0, phi)
    return torch.abs(rs), phi


def stratified_ring_sampling(gen, N: int, ri: float, r: float,
                             polar: bool = False):
    """N equal-area stratified samples on the annulus ri ≤ ρ ≤ r.

    Stratified square samples are pushed through the concentric equal-area
    map to the unit disc, then the radius is remapped so the area density
    stays uniform on the annulus: ρ = √(ri² + t²·(r² − ri²)).
    """
    u, v = stratified_rectangle_sampling(gen, N, 0.0, 1.0, 0.0, 1.0)
    t, phi = _concentric_square_to_disc(u, v)
    rho = torch.sqrt(ri * ri + t * t * (r * r - ri * ri))
    if polar:
        return rho, phi
    return rho * torch.cos(phi), rho * torch.sin(phi)


# ----------------------------------------------------------------------
# inverse-transform sampling (tables are host numpy, samples are tensors)

def cdf_from_pdf(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Normalized CDF of a tabulated pdf via cumulative trapezoid rule."""
    x = np.asarray(x, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    seg = 0.5 * (f[1:] + f[:-1]) * (x[1:] - x[:-1])
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    return cdf / cdf[-1]


def inverse_cdf(x, f, device, dtype=torch.float32):
    """``u -> x``: the inverse CDF of the pdf ``f`` tabulated over ``x``
    (host data), for uniforms ``u`` in [0, 1] of ``dtype`` on ``device``.

    The inverse CDF is resampled once onto a uniform u-grid, so the per-ray
    lookup is index arithmetic instead of a binary search; the table is
    made on the device now, and a call copies nothing from the host.
    """
    x = np.asarray(x, dtype=np.float64)
    M = 4096
    table = torch.as_tensor(invert_cdf_uniform(x, cdf_from_pdf(x, f), M), dtype=dtype,
                            device=device)
    left, right = float(x[0]), float(x[-1])
    return lambda u: uniform_interp(u, table, 0.0, 1.0 / (M - 1), left=left, right=right)


def inverse_transform_from_u(u, x: np.ndarray, f: np.ndarray):
    """Map uniform samples u∈[0,1] (tensor) through the inverse CDF of the
    pdf f tabulated over x (host numpy): :func:`inverse_cdf` on u's device."""
    return inverse_cdf(x, f, u.device, u.dtype)(u)


def inverse_transform_sampler(x, f, device, kind: str = "continuous"):
    """``(gen, N) -> N samples`` of a tabulated distribution (tables: host
    data, moved to ``device`` now, so a call copies nothing from the host).

    kind="continuous": f is a pdf over grid x, sampled by linear inverse-CDF
    interpolation. kind="discrete": f are probabilities of the discrete
    values x. Uses stratified uniforms so spectral sampling noise drops ~1/N.
    """
    if kind == "continuous":
        lookup = inverse_cdf(x, f, device)
        return lambda gen, N: lookup(stratified_interval_sampling(gen, N, 0.0, 1.0, shuffle=True))
    if kind == "discrete":
        x = np.asarray(x, dtype=np.float64)
        f = np.asarray(f, dtype=np.float64)
        cdf = torch.as_tensor(np.cumsum(f / np.sum(f)), dtype=torch.float32, device=device)
        vals = torch.as_tensor(x, dtype=torch.float32, device=device)
        last = x.shape[0] - 1

        def sample(gen, N):
            u = stratified_interval_sampling(gen, N, 0.0, 1.0, shuffle=True)
            idx = torch.clamp(torch.searchsorted(cdf, u, right=False), 0, last)
            return vals[idx]
        return sample
    raise ValueError(f"Unknown sampling kind '{kind}'.")


def inverse_transform_sampling(gen, N: int, x, f, kind: str = "continuous"):
    """Sample N values from a tabulated distribution (tables: host numpy):
    :func:`inverse_transform_sampler` on the generator's device."""
    return inverse_transform_sampler(x, f, gen.device, kind)(gen, N)
