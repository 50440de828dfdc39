"""The plain reference of ``configs/iol_eye.json``: the Arizona eye with the
Alcon IQ intraocular lens in place of its natural lens, a 3 mm pupil that
bends the rays passing it by Heisenberg-uncertainty ray bending (HURB), a
D65 point source and a flat detector.

It adds to ``reference.py``, whose media, conic surfaces, outline, detector
hits, binning and colour it uses as they are, and to
``reference_keratoconus.py``, whose D65 point source it draws, what neither
models. ``reference.Scene`` alone would read the asphere's row as its conic
and let every ray pass the pupil unbent, so this configuration is read
through :class:`Scene` here:

- the even asphere: the sag of the conic (c, k) plus a1·r² + a2·r⁴ + a3·r⁶.
  Its hit is Newton's iteration on the sag, started from the conic's exact
  hit and run to the precision of the rays' dtype; its normal is the sag's
  gradient written out;
- HURB at a ring stop of inner radius R, from optrace's documented
  description (the raytracer's usage page, the HURB page of the physics
  notes): a ray that passes the opening at radius r has the largest
  ellipse inscribed in the opening through it, its minor half axis
  b = R − r along the radius and its major half axis a = √(b·R) along the
  tangent. With k = 2πn/λ in the medium at the stop, the tangents of the
  ray's bend on the two axes are drawn from normal distributions of
  standard deviations tan σ_a = F / (2·a·cos ψ_a·k) and
  tan σ_b = F / (2·b·cos ψ_b·k), F the HURB factor and cos ψ the cosine of
  the ray's inclination against each axis, √(1 − (s·axis)²). The new
  direction is s + s_a·tan θ_a + s_b·tan θ_b, renormalised, with s_a the
  unit vector normal to s and to the minor axis and s_b = s × s_a; a ray
  that then points backwards (negative z) is absorbed.

Departures from optrace: the order of the random draws (here each batch
draws its wavelengths, cone angles and azimuths, then the two normals of
the stop's bend); and nothing else, beyond what ``reference.py`` notes.

Rays are drawn in f64; the trace and the hits take their dtype from their
inputs, as in ``reference.py``, so the same code computes the control in a
lower precision. It imports nothing of the program and nothing of JAX.
"""

import math

import torch

from benchmark import reference, reference_keratoconus as rk

ASPHERE = "asphere"
# Newton steps from the conic's hit: the polynomial moves a hit by less than
# 1e-3 mm inside the pupil, and the steps converge quadratically
NEWTON_STEPS = 12


class Scene(reference.Scene):
    """``reference.Scene`` of the configuration, with an asphere's
    polynomial on its surface (``coeff``, on r², r⁴, ...) and HURB at the
    stops where the configuration turns it on (``hurb``, ``hurb_factor``)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.hurb = bool(cfg.get("use_hurb", False))
        self.hurb_factor = float(cfg.get("hurb_factor", math.sqrt(2.0)))
        for surf, row in zip(self.surfaces, cfg["surfaces"]):
            if row["type"] == ASPHERE:
                surf["coeff"] = tuple(float(c) for c in row["coeff"])
            elif row["type"] not in ("conic", "stop"):
                raise ValueError(f"unknown surface type {row['type']}")


def asphere_sag(surf, x, y):
    """The even asphere's sag at (x, y) relative to its vertex, and its two
    partial derivatives."""
    c, k, coeff = surf["c"], surf["k"], surf["coeff"]
    r2 = x * x + y * y
    root = torch.sqrt(1 - (1 + k) * c * c * r2)
    poly = torch.zeros_like(r2)
    dpoly = torch.zeros_like(r2)        # d(poly)/d(r²)
    for i, a in enumerate(coeff, start=1):
        poly = poly + a * r2 ** i
        dpoly = dpoly + i * a * r2 ** (i - 1)
    z = c * r2 / (1 + root) + poly
    slope = c / root + 2 * dpoly        # (dz/dx) / x
    return z, slope * x, slope * y


def asphere_hit(surf, p, s):
    """Distance along s from p to the even asphere, and whether the ray
    meets it: Newton's iteration on oz + t·sz − sag(ox + t·sx, oy + t·sy)
    from the conic's own hit."""
    t, ok = reference._hit(surf, p, s)
    ox, oy, oz = p[:, 0], p[:, 1], p[:, 2] - surf["z"]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    t = torch.where(ok, t, torch.zeros_like(t))
    for _ in range(NEWTON_STEPS):
        z, zx, zy = asphere_sag(surf, ox + t * sx, oy + t * sy)
        t = t - (oz + t * sz - z) / (sz - zx * sx - zy * sy)
    return t, ok & torch.isfinite(t)


def asphere_normal(surf, p):
    """Unit normal of the even asphere at p, its z-component positive."""
    _, zx, zy = asphere_sag(surf, p[:, 0], p[:, 1])
    n = torch.stack([-zx, -zy, torch.ones_like(zx)], dim=1)
    return n / torch.linalg.norm(n, dim=1, keepdim=True)


def hurb_bend(surf, normals, p, s, w, wl, n, factor, bend):
    """HURB at a ring stop (module note): the directions and weights of the
    rays after the stop. ``normals`` are the two standard normals of each
    ray (the a axis's, then the b axis's), ``n`` the index of the medium at
    the stop, ``bend`` the rays that pass the opening alive."""
    R = surf["ri"]
    x, y = p[:, 0], p[:, 1]
    r = torch.sqrt(x * x + y * y)
    bend = bend & (r < R)
    b = R - r
    a = torch.sqrt(torch.clamp(b * R, min=0))
    phi = torch.atan2(y, x)
    zero = torch.zeros_like(x)
    b_axis = torch.stack([torch.cos(phi), torch.sin(phi), zero], dim=1)     # the radius: minor
    a_axis = torch.stack([-torch.sin(phi), torch.cos(phi), zero], dim=1)    # the tangent: major
    cos_psi_a = torch.sqrt(1 - (s * a_axis).sum(1) ** 2)
    cos_psi_b = torch.sqrt(1 - (s * b_axis).sum(1) ** 2)
    k = 2 * math.pi * n / (wl * 1e-6)           # 1/mm
    one = torch.ones_like(x)
    tan_a = normals[0] * factor / (2 * torch.where(bend, a, one) * cos_psi_a * k)
    tan_b = normals[1] * factor / (2 * torch.where(bend, b, one) * cos_psi_b * k)
    s_a = torch.linalg.cross(b_axis, s)
    s_a = s_a / torch.linalg.norm(s_a, dim=1, keepdim=True)
    s_b = torch.linalg.cross(s, s_a)
    s2 = s + s_a * tan_a[:, None] + s_b * tan_b[:, None]
    s2 = s2 / torch.linalg.norm(s2, dim=1, keepdim=True)
    s = torch.where(bend[:, None], s2, s)
    backwards = bend & (s[:, 2] < 0)
    return s, torch.where(backwards, torch.zeros_like(w), w)


def hurb_normals(gen: torch.Generator, N: int, dtype):
    """The two standard normals of each ray's bend, drawn in f64 from
    ``gen``."""
    return tuple(torch.randn(N, generator=gen, dtype=torch.float64, device=gen.device).to(dtype)
                 for _ in range(2))


def trace(scene: Scene, p, s, w, wl, gen: torch.Generator) -> dict:
    """The rays through every surface and onto the outline's end, without
    polarization, the stops' HURB normals drawn from ``gen``: ``last`` (p, w)
    before the end and ``end`` on it, as ``reference.trace`` returns them
    for ``reference.detector_hits``."""
    n_now = scene.index(scene.ambient, wl)
    for surf in scene.surfaces:
        alive = w > 0
        asph = "coeff" in surf
        t, met = asphere_hit(surf, p, s) if asph else reference._hit(surf, p, s)
        p_hit = p + t[:, None] * s
        rho2 = p_hit[:, 0] ** 2 + p_hit[:, 1] ** 2
        on = met & (rho2 <= surf["r"] ** 2)
        p_new = torch.where((alive & met)[:, None], p_hit, p)
        if surf["kind"] == "stop":
            blocked = alive & on & (rho2 >= surf["ri"] ** 2)
            w = torch.where(blocked, torch.zeros_like(w), w)
            if scene.hurb:
                normals = hurb_normals(gen, p.shape[0], p.dtype)
                s, w = hurb_bend(surf, normals, p_new, s, w, wl, n_now, scene.hurb_factor,
                                 alive & met & ~blocked)
        else:
            w = torch.where(alive & ~on, torch.zeros_like(w), w)
            hit = alive & on
            nrm = asphere_normal(surf, p_new) if asph else reference._normal(surf, p_new)
            n1, n2 = scene.index(surf["n1"], wl), scene.index(surf["n2"], wl)
            cos_a = (nrm * s).sum(1)
            Nq = n1 / n2
            W2 = 1 - Nq * Nq * (1 - cos_a * cos_a)
            tir = hit & (W2 < 0)
            cos_b = torch.sqrt(torch.clamp(W2, min=0))
            s2 = s * Nq[:, None] - nrm * (Nq * cos_a - cos_b)[:, None]
            s2 = s2 / torch.linalg.norm(s2, dim=1, keepdim=True)
            # the Fresnel transmission of unpolarized light
            ts = 2 * n1 * cos_a / (n1 * cos_a + n2 * cos_b)
            tp = 2 * n1 * cos_a / (n2 * cos_a + n1 * cos_b)
            T = n2 * cos_b / (n1 * cos_a) * 0.5 * (ts * ts + tp * tp)
            w = torch.where(tir, torch.zeros_like(w), torch.where(hit, w * T, w))
            s = torch.where((hit & ~tir)[:, None], s2, s)
            n_now = n2
        p_new, gone = reference._outline(scene.outline, p, p_new, s, alive & (w > 0))
        w = torch.where(gone, torch.zeros_like(w), w)
        p = p_new
    alive = w > 0
    zend = scene.outline[5]
    t = (zend - p[:, 2]) / torch.where(s[:, 2] != 0, s[:, 2], torch.ones_like(s[:, 2]))
    p_end = torch.where((alive & (s[:, 2] > 0))[:, None], p + t[:, None] * s, p)
    p_end, _ = reference._outline(scene.outline[:5] + (math.inf,), p, p_end, s, alive)
    return dict(last=(p, w), end=p_end)


def render(scene: Scene, N: int, batch: int, gen: torch.Generator, seed: int, Nx: int, Ny: int,
           extent, dtype=torch.float64, acc_dtype=torch.float64):
    """The XYZW image of N rays on the detector, as ``reference.render``
    makes it, and the number of rays that hit the detector."""
    img = None
    done = hits = 0
    while done < N:
        n = min(batch, N - done)
        p, s, w, wl = rk.sample_rays(scene, n, gen, seed)
        w = w * (n / N)
        if dtype != torch.float64:
            p = reference.near_lens(scene, p, s)
        p, s, w, wl = (a.to(dtype) for a in (p, s, w, wl))
        tr = trace(scene, p, s, w, wl, gen)
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
        p, s, w, wl = rk.sample_rays(scene, n, gen, seed)
        tr = trace(scene, p, s, w, wl, gen)
        x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        cx, cy = float((x * wh).sum() / wh.sum()), float((y * wh).sum() / wh.sum())
    return (cx - half, cx + half, cy - half, cy + half)
