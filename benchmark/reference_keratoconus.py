"""The plain reference of ``configs/keratoconic_eye.json``: the Arizona eye
with a Gaussian cone on its anterior cornea (keratoconus), a point source
with the CIE D65 spectrum and a flat detector.

It adds to ``reference.py``, whose media, conic surfaces, outline, detector
hits, binning and colour it uses as they are, what that module does not
model. ``reference.Scene`` alone would read the cone's row as a healthy
conic, so this configuration is read through :class:`Scene` here:

- the cone surface: the sag of the conic (R, k) minus
  h0·exp(−(x−x0)²/2σx² − (y−y0)²/2σy²), less its value at x = y = 0
  (optrace puts a function surface's centre on its vertex). Its hit is
  Newton's iteration on the sag, started from the conic's exact hit and run
  to the precision of the rays' dtype; its normal is the sag's gradient
  written out;
- a point source with the D65 spectrum (``data/cie_d65.csv``, linear
  between the table's points).

Rays are drawn in f64; the trace and the hits take their dtype from their
inputs, as in ``reference.py``, so the same code computes the control in a
lower precision. It imports nothing of the program and nothing of JAX.
"""

import copy
import math

import numpy as np
import torch

from benchmark import reference

CONE = "conic_gauss_cone"
# Newton steps from the conic's hit: the cone moves a hit by at most its
# depth (0.05 mm in Tan et al.'s table), and the steps converge
# quadratically, so f64 converges in four or five
NEWTON_STEPS = 12
WL_GRID = 40001     # points of the fine grid the D65 table is drawn on


class Scene(reference.Scene):
    """``reference.Scene`` of the configuration, with the cone's parameters
    on its surface (``cone``: ``h0``, ``sigma_x``, ``sigma_y``, ``x0``,
    ``y0`` and ``offset``, the depth at the centre). The cone may only be
    the first surface: the surfaces behind it are traced by
    ``reference.trace``."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        for i, (surf, row) in enumerate(zip(self.surfaces, cfg["surfaces"])):
            if row["type"] == CONE:
                if i:
                    raise ValueError("the reference models a cone on the first surface only")
                cone = {k: float(row[k]) for k in ("h0", "sigma_x", "sigma_y", "x0", "y0")}
                cone["offset"] = cone["h0"] * math.exp(-0.5 * ((cone["x0"] / cone["sigma_x"]) ** 2
                                                               + (cone["y0"] / cone["sigma_y"]) ** 2))
                surf["cone"] = cone
            elif row["type"] not in ("conic", "stop"):
                raise ValueError(f"unknown surface type {row['type']}")


def sag(surf, x, y):
    """The cone surface's sag at (x, y) relative to its vertex, and its two
    partial derivatives."""
    c, k, cone = surf["c"], surf["k"], surf["cone"]
    r2 = x * x + y * y
    root = torch.sqrt(1 - (1 + k) * c * c * r2)
    u = (x - cone["x0"]) / cone["sigma_x"]
    v = (y - cone["y0"]) / cone["sigma_y"]
    g = cone["h0"] * torch.exp(-0.5 * (u * u + v * v))
    z = c * r2 / (1 + root) - g + cone["offset"]
    return z, c * x / root + g * u / cone["sigma_x"], c * y / root + g * v / cone["sigma_y"]


def cone_hit(surf, p, s):
    """Distance along s from p to the cone surface, and whether the ray
    meets it: Newton's iteration on oz + t·sz − sag(ox + t·sx, oy + t·sy)
    from the conic's own hit."""
    t, ok = reference._hit(surf, p, s)
    ox, oy, oz = p[:, 0], p[:, 1], p[:, 2] - surf["z"]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    t = torch.where(ok, t, torch.zeros_like(t))
    for _ in range(NEWTON_STEPS):
        z, zx, zy = sag(surf, ox + t * sx, oy + t * sy)
        t = t - (oz + t * sz - z) / (sz - zx * sx - zy * sy)
    return t, ok & torch.isfinite(t)


def cone_normal(surf, p):
    """Unit normal of the cone surface at p, its z-component positive."""
    _, zx, zy = sag(surf, p[:, 0], p[:, 1])
    n = torch.stack([-zx, -zy, torch.ones_like(zx)], dim=1)
    return n / torch.linalg.norm(n, dim=1, keepdim=True)


def _refract_cone(scene: Scene, p, s, w, wl):
    """The rays through the first surface, the cone: hit, aperture, Snell
    and the Fresnel transmission of unpolarized light, the outline."""
    surf = scene.surfaces[0]
    alive = w > 0
    t, met = cone_hit(surf, p, s)
    p_hit = p + t[:, None] * s
    on = met & (p_hit[:, 0] ** 2 + p_hit[:, 1] ** 2 <= surf["r"] ** 2)
    p_new = torch.where((alive & met)[:, None], p_hit, p)
    w = torch.where(alive & ~on, torch.zeros_like(w), w)
    hit = alive & on
    n = cone_normal(surf, p_new)
    n1, n2 = scene.index(surf["n1"], wl), scene.index(surf["n2"], wl)
    cos_a = (n * s).sum(1)
    Nq = n1 / n2
    W2 = 1 - Nq * Nq * (1 - cos_a * cos_a)
    tir = hit & (W2 < 0)
    cos_b = torch.sqrt(torch.clamp(W2, min=0))
    s2 = s * Nq[:, None] - n * (Nq * cos_a - cos_b)[:, None]
    s2 = s2 / torch.linalg.norm(s2, dim=1, keepdim=True)
    ts = 2 * n1 * cos_a / (n1 * cos_a + n2 * cos_b)
    tp = 2 * n1 * cos_a / (n2 * cos_a + n1 * cos_b)
    T = n2 * cos_b / (n1 * cos_a) * 0.5 * (ts * ts + tp * tp)
    w = torch.where(tir, torch.zeros_like(w), torch.where(hit, w * T, w))
    s = torch.where((hit & ~tir)[:, None], s2, s)
    p_new, gone = reference._outline(scene.outline, p, p_new, s, alive & (w > 0))
    return p_new, s, torch.where(gone, torch.zeros_like(w), w)


def trace(scene: Scene, p, s, w, wl) -> dict:
    """The rays through every surface and onto the outline's end, without
    polarization: ``last`` (p, w) before the end and ``end`` on it, as
    ``reference.trace`` returns them for ``reference.detector_hits``."""
    if "cone" in scene.surfaces[0]:
        p, s, w = _refract_cone(scene, p, s, w, wl)
        scene = copy.copy(scene)
        scene.surfaces = scene.surfaces[1:]
    return reference.trace(scene, p, s, None, w, wl, store=False)


_D65 = None


def d65_table():
    """(wavelengths, relative power) of the D65 table, f64."""
    global _D65
    if _D65 is None:
        _D65 = np.loadtxt(reference.HERE / "data" / "cie_d65.csv", delimiter=",", comments="#",
                          skiprows=2)
    return _D65[:, 0], _D65[:, 1]


def sample_rays(scene: Scene, N: int, gen: torch.Generator, seed: int):
    """N rays of the point source, drawn from ``gen`` (iid): (p, s, w, wl)
    in f64 on the generator's device. The point is ``reference.source_centre``;
    every ray's direction lies in the Lambertian cone around the direction
    to ``conv_pos``, its wavelength follows the D65 table."""
    src = scene.cfg["ray_source"]
    if (src["emitter"], src["spectrum"], src["divergence"], src["orientation"]) != \
            ("point", "D65", "Lambertian", "Converging"):
        raise ValueError("the reference draws a point with the D65 spectrum into a Lambertian, "
                         "converging cone only")
    dev = gen.device
    p = torch.as_tensor(reference.source_centre(scene.cfg, seed), dtype=torch.float64,
                        device=dev).expand(N, 3).clone()
    grid = np.linspace(scene.wl_range[0], scene.wl_range[1], WL_GRID)
    wl = reference._inverse_cdf(grid, np.interp(grid, *d65_table()), reference._uniform(gen, N, dev))
    axis = torch.as_tensor(src["conv_pos"], dtype=torch.float64, device=dev) - p
    axis = axis / torch.linalg.norm(axis, dim=1, keepdim=True)
    # the cosine law within the cone: sin θ = √u · sin Θ
    theta = torch.arcsin(torch.sqrt(reference._uniform(gen, N, dev))
                         * math.sin(math.radians(float(src["div_angle_deg"]))))
    alpha = 2 * math.pi * reference._uniform(gen, N, dev)
    e1, e2 = reference._frame(axis)
    s = (torch.cos(theta)[:, None] * axis + torch.sin(theta)[:, None]
         * (torch.cos(alpha)[:, None] * e1 + torch.sin(alpha)[:, None] * e2))
    w = torch.full((N,), float(src["power"]) / N, dtype=torch.float64, device=dev)
    return p, s, w, wl


def render(scene: Scene, N: int, batch: int, gen: torch.Generator, seed: int, Nx: int, Ny: int,
           extent, dtype=torch.float64, acc_dtype=torch.float64):
    """The XYZW image of N rays on the detector, as ``reference.render``
    makes it, and the number of rays that hit the detector."""
    img = None
    done = hits = 0
    while done < N:
        n = min(batch, N - done)
        p, s, w, wl = sample_rays(scene, n, gen, seed)
        w = w * (n / N)
        if dtype != torch.float64:
            p = reference.near_lens(scene, p, s)
        p, s, w, wl = (a.to(dtype) for a in (p, s, w, wl))
        tr = trace(scene, p, s, w, wl)
        x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        part = reference.bin_xyzw(x, y, wh, wl, Nx, Ny, extent, acc_dtype)
        img = part if img is None else img + part
        hits += int((wh > 0).sum())
        done += n
    return img, hits


def spot_extent(cfg: dict, seed: int, half: float, device, n: int = 20000) -> tuple:
    """A square of half width ``half`` around the power centroid of a short
    trace of ``n`` rays drawn from the seed (the seed draws the object
    point), as a user rendering a point spread function sets it."""
    scene = Scene(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 104729)
    with torch.no_grad():
        p, s, w, wl = sample_rays(scene, n, gen, seed)
        tr = trace(scene, p, s, w, wl)
        x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        cx, cy = float((x * wh).sum() / wh.sum()), float((y * wh).sum() / wh.sum())
    return (cx - half, cx + half, cy - half, cy + half)
