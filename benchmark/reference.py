"""The plain reference of the benchmark's scenes, in PyTorch or NumPy alone.

It reads a configuration file of ``configs/`` and does what the published
prescription says, written anew from the optics and not from the program:
it samples rays from the configuration's source, traces them surface by
surface (Snell's law and the Fresnel transmission, polarization carried in
the s/p decomposition), finds the detector hits, bins them into an XYZW
image with the CIE 1931 observer of ``data/`` and converts an image to sRGB
with the absolute rendering intent. Rays are drawn in f64; the trace, the
hits and the binning take their dtype from their inputs, so the same code
computes the f64 reference and, in a lower precision, the control that
the check must refuse (``near_lens`` carries the control's rays over the
long leg from a distant object in f64 first).

It imports nothing of the program and nothing of JAX.
"""

import math
import pathlib

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent

# rows of the per-section counters compared with the program's
ABSORB_MISSING, TIR, OUTLINE = 0, 1, 3
N_COUNTERS = 5

# IEC 61966-2-1 (sRGB, D65): XYZ to linear sRGB, the primaries and the white point
M_XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
                (-0.9692660, 1.8760108, 0.0415560),
                (0.0556434, -0.2040259, 1.0572252))
SRGB_PRIMARIES_XY = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
WHITE_D65_XY = (0.31272, 0.32903)


# ----------------------------------------------------------------------
# the scene as the configuration gives it

class Scene:
    """The surfaces of a configuration file in the order a ray meets them,
    with absolute vertex positions, the media between them and the
    detector.

    ``surfaces``: dicts with ``kind`` ("refract" or "stop"), ``z`` (vertex),
    ``c`` (curvature, 0 for a plane), ``k`` (conic constant), ``r`` (outer
    semi-diameter), ``ri`` (a stop's inner radius), ``n1``, ``n2`` (media
    before and after, as dicts of the configuration's ``media``), ``media``
    (their names)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.outline = tuple(float(v) for v in cfg["outline"])
        self.ambient = cfg["ambient"]
        self.lines = tuple(cfg.get("abbe_lines_nm", (486.1327, 587.5618, 656.272)))
        self.wl_range = tuple(cfg["wavelength_range_nm"])
        media = dict(cfg["media"], ambient=cfg["ambient"])
        z = float(cfg["first_vertex_z"])
        before = "ambient"
        self.surfaces = []
        for row in cfg["surfaces"]:
            if row["type"] == "stop":
                self.surfaces.append(dict(kind="stop", z=z, c=0.0, k=0.0, r=float(row["r"]),
                                          ri=float(row["ri"]), n1=media[before], n2=media[before],
                                          media=(before, before)))
            else:
                after = row["after"]
                R = float(row["R"])
                self.surfaces.append(dict(kind="refract", z=z, c=0.0 if math.isinf(R) else 1.0 / R,
                                          k=float(row.get("k", 0.0)), r=float(row["r"]), ri=0.0,
                                          n1=media[before], n2=media[after], media=(before, after)))
                before = after
            z += float(row["d"])
        det = dict(cfg["detector"])
        det["z"] = z
        self.detector = det

    def index(self, medium: dict, wl):
        """Refractive index of ``medium`` at the wavelengths ``wl`` (nm)."""
        if medium["model"] == "Constant":
            return torch.full_like(wl, float(medium["n"]))
        if medium["model"] != "Abbe":
            raise ValueError(f"unknown medium model {medium['model']}")
        # n = A + B / (λ² - d) through (n_d, V) at the F, d and C lines,
        # d = 0.014 µm², as optrace defines its "Abbe" medium
        lF, ld, lC = (1e-3 * v for v in self.lines)
        d = 0.014
        nd, V = float(medium["n"]), float(medium["V"])
        B = (nd - 1.0) / V / (1.0 / (lF * lF - d) - 1.0 / (lC * lC - d))
        A = nd - B / (ld * ld - d)
        l2 = (1e-3 * wl) ** 2
        return A + B / (l2 - d)


def source_position(cfg: dict, seed: int) -> tuple:
    """The object point of a point source: on the sphere of the source's
    distance around the first vertex, at a field angle drawn uniformly
    within ``field_angle_max_deg`` of the axis from ``seed``."""
    src = cfg["ray_source"]
    rng = np.random.default_rng(int(seed))
    a_max = math.radians(float(src.get("field_angle_max_deg", 0.0)))
    a = a_max * math.sqrt(rng.random())
    phi = 2 * math.pi * rng.random()
    dist = float(src["distance"])
    return (dist * math.sin(a) * math.cos(phi), dist * math.sin(a) * math.sin(phi),
            float(cfg["first_vertex_z"]) - dist * math.cos(a))


# ----------------------------------------------------------------------
# colour

_CIE = None


def observer_table():
    """(wavelengths, xbar, ybar, zbar) of the CIE 1931 2° observer, f64."""
    global _CIE
    if _CIE is None:
        _CIE = np.loadtxt(HERE / "data" / "cie1931_2deg.csv", delimiter=",", comments="#",
                          skiprows=2)
    return _CIE[:, 0], _CIE[:, 1], _CIE[:, 2], _CIE[:, 3]


def observers(wl):
    """(N, 3) xbar, ybar, zbar at ``wl``: linear interpolation of the 1 nm
    table, zero outside it."""
    twl, xb, yb, zb = observer_table()
    tab = torch.as_tensor(np.stack([xb, yb, zb], axis=1), dtype=wl.dtype, device=wl.device)
    g = wl - float(twl[0])
    i = torch.clamp(torch.floor(g), 0, len(twl) - 2)
    f = (g - i)[:, None]
    i = i.to(torch.int64)
    v = tab[i] * (1 - f) + tab[i + 1] * f
    inside = (wl >= float(twl[0])) & (wl <= float(twl[-1]))
    return torch.where(inside[:, None], v, torch.zeros_like(v))


def bin_xyzw(x, y, w, wl, Nx: int, Ny: int, extent, acc_dtype=torch.float64):
    """(Ny, Nx, 4) image of the hits: X, Y, Z weighted by the observer, and
    the power W. A hit on the upper edge falls into the last pixel; a hit
    outside the extent is dropped."""
    x0, x1, y0, y1 = (float(v) for v in extent)
    fx = torch.floor(Nx / (x1 - x0) * (x - x0))
    fy = torch.floor(Ny / (y1 - y0) * (y - y0))
    fx = torch.where(x == x1, torch.full_like(fx, Nx - 1), fx)
    fy = torch.where(y == y1, torch.full_like(fy, Ny - 1), fy)
    ok = (fx >= 0) & (fx < Nx) & (fy >= 0) & (fy < Ny) & (w > 0)
    vals = torch.cat([observers(wl) * w[:, None], w[:, None]], dim=1)[ok].to(acc_dtype)
    flat = (fy[ok] * Nx + fx[ok]).to(torch.int64)
    img = torch.zeros((Ny * Nx, 4), dtype=acc_dtype, device=x.device)
    img.index_add_(0, flat, vals)
    return img.view(Ny, Nx, 4)


def _edge_hit(xw, yw, dx, dy, a, b):
    """Parameter t >= 0 where the ray (xw, yw) + t (dx, dy) meets the
    segment a-b, or inf."""
    ex, ey = b[0] - a[0], b[1] - a[1]
    den = dx * ey - dy * ex
    safe = torch.where(den != 0, den, torch.ones_like(den))
    t = ((a[0] - xw) * ey - (a[1] - yw) * ex) / safe
    u = ((a[0] - xw) * dy - (a[1] - yw) * dx) / safe
    ok = (den != 0) & (t >= 0) & (u >= -1e-12) & (u <= 1 + 1e-12)
    return torch.where(ok, t, torch.full_like(t, math.inf))


def xyz_to_srgb_absolute(xyz):
    """sRGB (gamma encoded, in [0, 1]) of an (..., 3) XYZ image under the
    absolute rendering intent: linear sRGB scaled by the image's largest
    value; a pixel outside the gamut keeps its luminance Y and its hue,
    and its chromaticity moves towards the white point onto the gamut's
    edge."""
    M = torch.as_tensor(M_XYZ_TO_RGB, dtype=xyz.dtype, device=xyz.device)
    rgb = xyz @ M.T
    big = torch.max(rgb)
    if big > 0:
        rgb = rgb / big
    outside = torch.any(rgb < 0, dim=-1)
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    S = X + Y + Z
    xw, yw = WHITE_D65_XY
    sx = torch.where(S > 0, X / torch.where(S > 0, S, 1.0), torch.full_like(S, xw))
    sy = torch.where(S > 0, Y / torch.where(S > 0, S, 1.0), torch.full_like(S, yw))
    dx, dy = sx - xw, sy - yw
    pr, pg, pb = SRGB_PRIMARIES_XY
    t = torch.minimum(torch.minimum(_edge_hit(xw, yw, dx, dy, pr, pg),
                                    _edge_hit(xw, yw, dx, dy, pg, pb)),
                      _edge_hit(xw, yw, dx, dy, pb, pr))
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    xc, yc = xw + t * dx, yw + t * dy
    kY = Y / torch.where(yc > 0, yc, math.inf)
    clipped = torch.stack([kY * xc, Y, kY * (1 - xc - yc)], dim=-1)
    xyz2 = torch.where(outside[..., None], clipped, xyz)
    rgb = xyz2 @ M.T
    big = torch.max(rgb)
    if big > 0:
        rgb = rgb / big
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.where(rgb <= 0.0031308, 12.92 * rgb,
                       1.055 * torch.clamp(rgb, min=1e-30) ** (1 / 2.4) - 0.055)


def block_mean(img, f: int):
    """Mean over f × f blocks of an (Ny, Nx, C) image."""
    Ny, Nx, C = img.shape
    return img[:Ny // f * f, :Nx // f * f].reshape(Ny // f, f, Nx // f, f, C).mean(dim=(1, 3))


# optrace's synthetic sRGB primary spectra: Gaussian mixtures whose
# chromaticities are those of the sRGB primaries, zero outside 380-780 nm,
# and their relative radiant powers, in which an RGB image source emits
PRIMARY_POWER = (0.885651229244, 1.0, 0.775993481741)
PRIMARY_GAUSSIANS = (
    ((75.1660756583 * 0.951190393, 639.854491, 30.0),
     (75.1660756583 * 0.951190393 * 0.0500907584, 418.905848, 80.6220465)),
    ((83.4999222966, 539.13108974, 33.31164968),),
    ((47.99521746361 * 1.16364585503, 454.833119, 20.1460206),
     (47.99521746361 * 1.16364585503 * 0.184484176, 459.658190, 71.0927568)))
VISIBLE_NM = (380.0, 780.0)


def primary_spectra(wl: np.ndarray) -> np.ndarray:
    """(3, n) spectra of the red, green and blue primaries at ``wl``."""
    out = np.zeros((3, wl.shape[0]))
    for c, terms in enumerate(PRIMARY_GAUSSIANS):
        for a, mu, sig in terms:
            out[c] += a / (sig * math.sqrt(2 * math.pi)) * np.exp(-0.5 * ((wl - mu) / sig) ** 2)
    inside = (wl >= VISIBLE_NM[0]) & (wl <= VISIBLE_NM[1])
    return np.where(inside, out, 0.0)


def srgb_to_linear(v):
    """IEC 61966-2-1 decoding of sRGB values in [0, 1]."""
    return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def chart_pixels(cfg: dict, seed: int) -> np.ndarray:
    """The chart of an RGB image source as sRGB values in [0, 1], (Iy, Ix, 3),
    element [0, 0] the lower left corner: the patches of the chart's file in
    an order that the seed permutes, each ``patch_pixels`` square."""
    src = cfg["ray_source"]
    rows = np.loadtxt(HERE.parent / src["chart"], delimiter=",", comments="#", skiprows=2,
                      usecols=(1, 2, 3))
    nx, ny = src["chart_patches"]
    if rows.shape[0] != nx * ny:
        raise ValueError(f"the chart has {rows.shape[0]} patches, not {nx} x {ny}")
    patches = rows[np.random.default_rng(int(seed)).permutation(nx * ny)] / 255.0
    k = int(src["patch_pixels"])
    img = np.repeat(np.repeat(patches.reshape(ny, nx, 3), k, axis=0), k, axis=1)
    return np.ascontiguousarray(np.flipud(img))


def _inverse_cdf(pdf_x: np.ndarray, pdf: np.ndarray, u):
    """Samples of the tabulated pdf at the uniforms u (linear between the
    table's points)."""
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2 * np.diff(pdf_x))])
    cdf = torch.as_tensor(cdf / cdf[-1], dtype=torch.float64, device=u.device)
    x = torch.as_tensor(pdf_x, dtype=torch.float64, device=u.device)
    u = u.to(torch.float64)
    i = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, len(pdf_x) - 2)
    f = (u - cdf[i]) / (cdf[i + 1] - cdf[i]).clamp(min=1e-300)
    return x[i] + f.clamp(0, 1) * (x[i + 1] - x[i])


# ----------------------------------------------------------------------
# sampling

def _frame(s):
    """Two unit vectors that make a right-handed frame with each row of s."""
    a = torch.zeros_like(s)
    use_x = torch.abs(s[:, 0]) < 0.9
    a[:, 0] = torch.where(use_x, 1.0, 0.0)
    a[:, 1] = torch.where(use_x, 0.0, 1.0)
    e1 = torch.linalg.cross(s, a)
    e1 = e1 / torch.linalg.norm(e1, dim=1, keepdim=True)
    return e1, torch.linalg.cross(s, e1)


def _uniform(gen, N, device):
    return torch.rand(N, generator=gen, dtype=torch.float64, device=device)


def transverse_polarization(s, angle):
    """Unit polarization vectors perpendicular to s from angles in the
    x-y plane, carried onto each ray's transverse plane along the great
    circle from the axis."""
    pol0 = torch.stack([torch.cos(angle), torch.sin(angle), torch.zeros_like(angle)], dim=1)
    rxy = torch.hypot(s[:, 0], s[:, 1])
    axial = rxy < 1e-12
    safe = torch.where(axial, torch.ones_like(rxy), rxy)
    ps = torch.stack([s[:, 1] / safe, -s[:, 0] / safe, torch.zeros_like(rxy)], dim=1)
    pp = torch.linalg.cross(ps, s)
    a_s = (ps * pol0).sum(1)
    a_p = ps[:, 1] * pol0[:, 0] - ps[:, 0] * pol0[:, 1]
    pol = ps * a_s[:, None] + pp * a_p[:, None]
    return torch.where(axial[:, None], pol0, pol)


def source_centre(cfg: dict, seed: int) -> tuple:
    """Where the source lies: a point source's object point, an image
    source's centre on the axis."""
    src = cfg["ray_source"]
    if src["emitter"] == "point":
        return source_position(cfg, seed)
    return (0.0, 0.0, float(cfg["first_vertex_z"]) - float(src["distance"]))


def sample_rays(scene: Scene, N: int, gen: torch.Generator, seed: int, no_pol: bool = True):
    """N rays of the configuration's source, drawn from ``gen`` (iid, not
    stratified): (p, s, pol, w, wl) in f64 on the generator's device;
    ``pol`` is None with ``no_pol``."""
    cfg = scene.cfg
    src = cfg["ray_source"]
    dev = gen.device
    centre = torch.as_tensor(source_centre(cfg, seed), dtype=torch.float64, device=dev)
    if src["emitter"] == "point":
        p = centre.expand(N, 3).clone()
        wl0, wl1 = scene.wl_range
        if src["spectrum"] != "Constant":
            raise ValueError(f"unknown spectrum {src['spectrum']}")
        wl = wl0 + (wl1 - wl0) * _uniform(gen, N, dev)
    elif src["emitter"] == "rgb_image":
        lin = srgb_to_linear(chart_pixels(cfg, seed))
        Iy, Ix, _ = lin.shape
        chan = torch.as_tensor(lin.reshape(-1, 3) * np.asarray(PRIMARY_POWER), dtype=torch.float64,
                               device=dev)
        # a pixel in proportion to its radiant power, a point in it uniformly
        cdf = torch.cumsum(chan.sum(1), 0)
        pix = torch.searchsorted(cdf / cdf[-1], _uniform(gen, N, dev), right=True)
        pix = torch.clamp(pix, max=Ix * Iy - 1)
        w_mm, h_mm = (float(v) for v in src["size_mm"])
        px = centre[0] - w_mm / 2 + w_mm / Ix * ((pix % Ix) + _uniform(gen, N, dev))
        py = centre[1] - h_mm / 2 + h_mm / Iy * ((pix // Ix) + _uniform(gen, N, dev))
        p = torch.stack([px, py, torch.full_like(px, float(centre[2]))], dim=1)
        # a primary in proportion to its power in the pixel, a wavelength from its spectrum
        share = torch.cumsum(chan[pix], 1)
        pick = _uniform(gen, N, dev) * share[:, 2]
        c = (pick > share[:, 0]).long() + (pick > share[:, 1]).long()
        grid = np.linspace(scene.wl_range[0], scene.wl_range[1], 40001)
        spectra = primary_spectra(grid)
        u = _uniform(gen, N, dev)
        wl = torch.zeros(N, dtype=torch.float64, device=dev)
        for k in range(3):
            wl = torch.where(c == k, _inverse_cdf(grid, spectra[k], u), wl)
    else:
        raise ValueError(f"unknown emitter {src['emitter']}")
    if src["orientation"] != "Converging":
        raise ValueError(f"unknown orientation {src['orientation']}")
    axis = torch.as_tensor(src["conv_pos"], dtype=torch.float64, device=dev) - p
    axis = axis / torch.linalg.norm(axis, dim=1, keepdim=True)
    half = math.radians(float(src["div_angle_deg"]))
    u = _uniform(gen, N, dev)
    if src["divergence"] == "Isotropic":
        # uniform in solid angle over 1 - cos θ <= sin² Θ, optrace's isotropic
        # cone (its half angle is arccos(cos² Θ), about √2 Θ for a small Θ):
        # sin(θ/2) = √(u / 2) · sin Θ
        theta = 2 * torch.arcsin(torch.sqrt(u / 2) * math.sin(half))
    elif src["divergence"] == "Lambertian":
        # the cosine law within the cone: sin θ = √u · sin Θ
        theta = torch.arcsin(torch.sqrt(u) * math.sin(half))
    else:
        raise ValueError(f"unknown divergence {src['divergence']}")
    alpha = 2 * math.pi * _uniform(gen, N, dev)
    e1, e2 = _frame(axis)
    s = (torch.cos(theta)[:, None] * axis + torch.sin(theta)[:, None]
         * (torch.cos(alpha)[:, None] * e1 + torch.sin(alpha)[:, None] * e2))
    w = torch.full((N,), float(src["power"]) / N, dtype=torch.float64, device=dev)
    pol = None
    if not no_pol:
        pol = transverse_polarization(s, 2 * math.pi * _uniform(gen, N, dev))
    return p, s, pol, w, wl


def near_lens(scene: Scene, p, s, margin: float = 1.0):
    """The rays moved in f64 along their directions onto the plane
    ``margin`` mm ahead of the first vertex (those already past it stay):
    a control traced in a low precision from there meets the lens as a
    program in that precision with a local frame would, where the leg from
    an object 50 m away would move every ray off it."""
    z = scene.surfaces[0]["z"] - margin
    ahead = (p[:, 2] < z) & (s[:, 2] > 0)
    t = (z - p[:, 2]) / torch.where(ahead, s[:, 2], torch.ones_like(s[:, 2]))
    return torch.where(ahead[:, None], p + t[:, None] * s, p)


# ----------------------------------------------------------------------
# the trace

def _hit(surf, p, s):
    """Distance along s from p to the surface (vertex-side solution of the
    conic through its vertex), and whether the ray meets it."""
    c, k, z = surf["c"], surf["k"], surf["z"]
    px, py, pz = p[:, 0], p[:, 1], p[:, 2] - z
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    if c == 0.0:
        ok = sz != 0
        return -pz / torch.where(ok, sz, torch.ones_like(sz)), ok
    q = 1.0 + k
    A = c * (sx * sx + sy * sy + q * sz * sz)
    h = c * (px * sx + py * sy + q * pz * sz) - sz
    C = c * (px * px + py * py + q * pz * pz) - 2 * pz
    disc = h * h - A * C
    ok = disc >= 0
    den = torch.sqrt(torch.clamp(disc, min=0)) - h
    ok = ok & (den != 0)
    return C / torch.where(ok, den, torch.ones_like(den)), ok


def _normal(surf, p):
    """Unit normal of the surface at p, its z-component positive."""
    c, k = surf["c"], surf["k"]
    zr = p[:, 2] - surf["z"]
    n = torch.stack([-c * p[:, 0], -c * p[:, 1], 1 - c * (1 + k) * zr], dim=1)
    return n / torch.linalg.norm(n, dim=1, keepdim=True)


def _outline(box, p_prev, p_new, s, alive):
    """Rays that leave the box are absorbed where they cross it."""
    x0, x1, y0, y1, z0, z1 = box
    x, y, z = p_new[:, 0], p_new[:, 1], p_new[:, 2]
    inside = (x0 < x) & (x < x1) & (y0 < y) & (y < y1) & (z0 < z) & (z < z1)
    out = alive & ~inside
    t = torch.full_like(x, math.inf)
    for ax, (lo, hi) in enumerate(((x0, x1), (y0, y1), (z0, z1))):
        sc = s[:, ax]
        ok = sc != 0
        den = torch.where(ok, sc, torch.ones_like(sc))
        for b in (lo, hi):
            tb = (b - p_prev[:, ax]) / den
            t = torch.where(ok & (tb > 0) & (tb < t), tb, t)
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    return torch.where(out[:, None], p_prev + t[:, None] * s, p_new), out


def trace(scene: Scene, p, s, pol, w, wl, store: bool = True):
    """Trace rays through every surface and the outline's end.

    :return: dict with ``p`` (N, nt, 3), ``w`` (N, nt), ``n`` (N, nt) and
        ``pol`` (N, nt, 3) or None when ``store``; ``counters``
        (N_COUNTERS, nt) of rays absorbed for missing a lens, by total
        internal reflection and by the outline; ``last`` (p, w) before
        the end and ``end`` (p) on it, the segment that a detector behind
        the last surface takes its hits from.
    """
    N = p.shape[0]
    dev, dt = p.device, p.dtype
    nt = len(scene.surfaces) + 2
    cnt = torch.zeros((N_COUNTERS, nt), dtype=torch.int64, device=dev)
    out = {}
    if store:
        out["p"] = torch.empty((N, nt, 3), dtype=dt, device=dev)
        out["w"] = torch.empty((N, nt), dtype=dt, device=dev)
        out["n"] = torch.empty((N, nt), dtype=dt, device=dev)
        out["pol"] = None if pol is None else torch.empty((N, nt, 3), dtype=dt, device=dev)
    n_amb = scene.index(scene.ambient, wl)

    def put(j, p, w, pol, n):
        if store:
            out["p"][:, j], out["w"][:, j], out["n"][:, j] = p, w, n
            if pol is not None:
                out["pol"][:, j] = pol

    put(0, p, w, pol, n_amb)
    n_now = n_amb
    for j, surf in enumerate(scene.surfaces, start=1):
        alive = w > 0
        t, met = _hit(surf, p, s)
        p_hit = p + t[:, None] * s
        rho2 = p_hit[:, 0] ** 2 + p_hit[:, 1] ** 2
        on = met & (rho2 <= surf["r"] ** 2)
        p_new = torch.where(alive[:, None] & met[:, None], p_hit, p)
        if surf["kind"] == "stop":
            blocked = alive & on & (rho2 >= surf["ri"] ** 2)
            w = torch.where(blocked, torch.zeros_like(w), w)
        else:
            miss = alive & ~on
            cnt[ABSORB_MISSING, j] = miss.sum()
            w = torch.where(miss, torch.zeros_like(w), w)
            hit = alive & on
            n = _normal(surf, p_new)
            n1, n2 = scene.index(surf["n1"], wl), scene.index(surf["n2"], wl)
            cos_a = (n * s).sum(1)
            Nq = n1 / n2
            W2 = 1 - Nq * Nq * (1 - cos_a * cos_a)
            tir = hit & (W2 < 0)
            cnt[TIR, j] = tir.sum()
            cos_b = torch.sqrt(torch.clamp(W2, min=0))
            s2 = s * Nq[:, None] - n * (Nq * cos_a - cos_b)[:, None]
            s2 = s2 / torch.linalg.norm(s2, dim=1, keepdim=True)
            turn = hit & ~tir
            if pol is None:
                a_s = a_p = torch.full_like(w, math.sqrt(0.5))
            else:
                ps = torch.linalg.cross(s2, s)
                norm = torch.linalg.norm(ps, dim=1, keepdim=True)
                straight = norm[:, 0] == 0
                ps = ps / torch.where(norm > 0, norm, torch.ones_like(norm))
                a_s = torch.where(straight, math.sqrt(0.5), (ps * pol).sum(1))
                a_p = torch.where(straight, math.sqrt(0.5),
                                  (torch.linalg.cross(ps, s) * pol).sum(1))
                pol2 = ps * a_s[:, None] + torch.linalg.cross(ps, s2) * a_p[:, None]
                pol = torch.where((turn & ~straight)[:, None], pol2, pol)
            ts = 2 * n1 * cos_a / (n1 * cos_a + n2 * cos_b)
            tp = 2 * n1 * cos_a / (n2 * cos_a + n1 * cos_b)
            T = n2 * cos_b / (n1 * cos_a) * ((a_s * ts) ** 2 + (a_p * tp) ** 2)
            w = torch.where(tir, torch.zeros_like(w), torch.where(hit, w * T, w))
            s = torch.where(turn[:, None], s2, s)
            n_now = n2
        p_new, gone = _outline(scene.outline, p, p_new, s, alive & (w > 0))
        cnt[OUTLINE, j] = gone.sum()
        w = torch.where(gone, torch.zeros_like(w), w)
        p = p_new
        put(j, p, w, pol, n_now)
    # the end of the outline absorbs what is left
    out["last"] = (p, w)
    alive = w > 0
    zend = scene.outline[5]
    t = (zend - p[:, 2]) / torch.where(s[:, 2] != 0, s[:, 2], torch.ones_like(s[:, 2]))
    p_end = torch.where((alive & (s[:, 2] > 0))[:, None], p + t[:, None] * s, p)
    p_end, gone = _outline(scene.outline[:5] + (math.inf,), p, p_end, s, alive)
    cnt[OUTLINE, nt - 1] = gone.sum()
    out["end"] = p_end
    put(nt - 1, p_end, torch.zeros_like(w), pol, n_now)
    out["counters"] = cnt
    return out


def detector_hits(scene: Scene, p0, w0, p1):
    """Hits of the segments p0 → p1 (weights w0 at their start) on the
    detector: (x, y, w) with w = 0 for a segment that misses it; a spherical
    detector's hits in its projection's coordinates."""
    det = scene.detector
    seg = p1 - p0
    if det["shape"] == "rectangle":
        zd = det["z"]
        crosses = (p0[:, 2] <= zd) & (p1[:, 2] >= zd) & (seg[:, 2] > 0)
        t = (zd - p0[:, 2]) / torch.where(crosses, seg[:, 2], torch.ones_like(seg[:, 2]))
        x = p0[:, 0] + t * seg[:, 0]
        y = p0[:, 1] + t * seg[:, 1]
        hx, hy = det["dim"][0] / 2, det["dim"][1] / 2
        hit = crosses & (w0 > 0) & (torch.abs(x) <= hx) & (torch.abs(y) <= hy)
        return x, y, torch.where(hit, w0, torch.zeros_like(w0))
    if det["shape"] != "sphere":
        raise ValueError(f"unknown detector shape {det['shape']}")
    length = torch.linalg.norm(seg, dim=1)
    moving = length > 0
    d = seg / torch.where(moving, length, torch.ones_like(length))[:, None]
    R = float(det["R"])
    t, met = _hit(dict(c=1.0 / R, k=0.0, z=det["z"]), p0, d)
    q = p0 + t[:, None] * d
    hit = (met & moving & (w0 > 0) & (t >= 0) & (t <= length)
           & (q[:, 0] ** 2 + q[:, 1] ** 2 <= float(det["r"]) ** 2))
    if det.get("projection", "Equidistant") != "Equidistant":
        raise ValueError(f"unknown projection {det['projection']}")
    # the angle seen from the sphere's centre, along the hit's azimuth
    theta = -math.copysign(1.0, R) * torch.arctan(torch.hypot(q[:, 0], q[:, 1]) / (q[:, 2] - (det["z"] + R)))
    phi = torch.atan2(q[:, 1], q[:, 0])
    return theta * torch.cos(phi), theta * torch.sin(phi), torch.where(hit, w0, torch.zeros_like(w0))


def render(scene: Scene, N: int, batch: int, gen: torch.Generator, seed: int, Nx: int, Ny: int,
           extent, dtype=torch.float64, acc_dtype=torch.float64):
    """The XYZW image of N rays on the detector, traced in ``dtype`` in
    batches, summed in ``acc_dtype`` (the weights sum to the power that
    reaches the image), and the number of rays that hit the detector."""
    img = None
    done = hits = 0
    while done < N:
        n = min(batch, N - done)
        p, s, _, w, wl = sample_rays(scene, n, gen, seed, no_pol=True)
        w = w * (n / N)
        if dtype != torch.float64:
            p = near_lens(scene, p, s)
        p, s, w, wl = (a.to(dtype) for a in (p, s, w, wl))
        tr = trace(scene, p, s, None, w, wl, store=False)
        x, y, wh = detector_hits(scene, *tr["last"], tr["end"])
        part = bin_xyzw(x, y, wh, wl, Nx, Ny, extent, acc_dtype)
        img = part if img is None else img + part
        hits += int((wh > 0).sum())
        done += n
    return img, hits
