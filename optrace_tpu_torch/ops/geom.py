"""Ray-surface intersection functions (functional core) on torch tensors.

Counterpart of ``optrace_tpu/ops/geom.py``: the same branchless masked
arithmetic in the same operation order, so both packages make the same
hit/miss decisions on the same rays. Every function takes torch tensors of
one device and dtype (surface parameters may be python floats or 0-dim
tensors) and is autograd-safe: arguments of ``sqrt`` and denominators are
pushed away from their singular values before use.

- coordinates are *relative to the surface vertex* (o = p − pos), which is
  also the f32 accuracy trick: sag values and transverse coordinates stay
  O(aperture) instead of O(system length);
- no-hit / behind-surface cases are signalled via flags, the caller
  implements the "clamp to z_max plane" bookkeeping (:func:`clamp_abnormal`).

The even-asphere and numeric-normal functions (``hit_newton``,
``sag_asphere``, ``normal_asphere``, ``normal_numeric``) arrive with the
asphere slice of the port.
"""

import torch

C_EPS = 1e-6    #: hit precision in mm
N_EPS = 1e-10   #: numerical epsilon
INF = float("inf")


# ----------------------------------------------------------------------
# sag functions (relative coords, z measured from vertex)

def _safe_sqrt(x, valid=None):
    """sqrt that never produces nan/inf *gradients*: the argument is pushed
    away from ≤0 before the sqrt (the where-both-branches pitfall)."""
    if valid is None:
        valid = x > 0
    r = torch.sqrt(torch.where(valid, x, 1.0))
    return torch.where(valid, r, 0.0)


def sag_conic(x, y, rho, k):
    """Conic-section sag z(r) = ρr² / (1 + √(1−(k+1)ρ²r²))."""
    return sag_conic_radial(x * x + y * y, rho, k)


def sag_conic_radial(r2, rho, k):
    """Conic sag as function of r²."""
    root = _safe_sqrt(1.0 - (k + 1.0) * rho * rho * r2)
    return rho * r2 / (1.0 + root)


# ----------------------------------------------------------------------
# normals (unit vectors, +z oriented)

def normal_flat(x, y):
    z = torch.zeros_like(x)
    return torch.stack([z, z, torch.ones_like(x)], dim=-1)


def normal_conic(x, y, rho, k):
    """Analytic conic normal: n_r = −ρr/√(1−kρ²r²), n_z = √(1−n_r²)."""
    r2 = x * x + y * y
    arg = 1.0 - k * rho * rho * r2
    denom = torch.sqrt(torch.where(arg > N_EPS, arg, N_EPS))
    nx = -rho * x / denom
    ny = -rho * y / denom
    arg_z = 1.0 - (nx * nx + ny * ny)
    nz = torch.sqrt(torch.where(arg_z > N_EPS, arg_z, N_EPS))
    return torch.stack([nx, ny, nz], dim=-1)


# ----------------------------------------------------------------------
# aperture masks (relative transverse coords)

def mask_circle(x, y, r):
    return x * x + y * y <= (r + N_EPS) ** 2


def mask_ring(x, y, ri, r):
    r2 = x * x + y * y
    return (r2 <= (r + N_EPS) ** 2) & (r2 >= (ri - N_EPS) ** 2)


def _rotate2d(x, y, angle_rad):
    a = torch.as_tensor(angle_rad, dtype=x.dtype, device=x.device)
    c, s = torch.cos(a), torch.sin(a)
    return x * c + y * s, -x * s + y * c


def mask_rect(x, y, half_w, half_h, angle_rad=0.0):
    xr, yr = _rotate2d(x, y, angle_rad)
    return (torch.abs(xr) <= half_w + N_EPS) & (torch.abs(yr) <= half_h + N_EPS)


def mask_slit(x, y, half_w, half_h, half_wi, half_hi, angle_rad=0.0):
    xr, yr = _rotate2d(x, y, angle_rad)
    outer = (torch.abs(xr) <= half_w + N_EPS) & (torch.abs(yr) <= half_h + N_EPS)
    inner = (torch.abs(xr) < half_wi - N_EPS) & (torch.abs(yr) < half_hi - N_EPS)
    return outer & ~inner


# ----------------------------------------------------------------------
# hits (relative coords o = p − pos; t is the ray parameter)

def hit_plane(o, s):
    """Intersection with the plane z=0 (through the vertex). sz=0 rays
    (e.g. dead zero-length segments) give t=inf with a finite gradient."""
    sz = s[..., 2]
    ok = sz != 0
    t = -o[..., 2] / torch.where(ok, sz, 1.0)
    return torch.where(ok, t, INF)


def hit_conic(o, s, rho, k, z_min_rel, z_max_rel):
    """Closed-form conic intersection.

    Solves the quadratic A t² + 2B t + C = 0 of ray and conicoid and picks
    the forward root whose z lies inside [z_min_rel, z_max_rel]. Returns
    (t, valid): valid=False where no surface-function hit exists (caller
    clamps to the z_max plane and marks no-hit).
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]

    A = 1.0 + k * sz * sz
    B = sx * ox + sy * oy + sz * (oz * (k + 1.0) - 1.0 / rho)
    C = ox * ox + oy * oy + oz * (oz * (k + 1.0) - 2.0 / rho)

    disc = B * B - C * A
    has_root = disc >= 0.0
    D = _safe_sqrt(disc, has_root)

    # f32-stable root pairing: q = −(B + sign(B)·D) has no cancellation;
    # the partner root follows from Vieta t₁t₂ = C/A as C/q (Citardauq),
    # avoiding the (−B+D)/A cancellation that costs ~6 digits near B²≫CA
    sgnB = torch.where(B >= 0, 1.0, -1.0).to(B.dtype)
    q = -(B + sgnB * D)
    okA = torch.abs(A) > N_EPS
    okq = torch.abs(q) > N_EPS
    t1 = torch.where(okA, q / torch.where(okA, A, 1.0), INF)
    t2 = torch.where(okq, C / torch.where(okq, q, 1.0), INF)

    # linear case A≈0, B≠0: single root
    okB = torch.abs(B) > N_EPS
    t_lin = -C / (2.0 * torch.where(okB, B, 1.0))
    lin = ~okA & okB
    t1 = torch.where(lin, t_lin, t1)
    t2 = torch.where(lin, t_lin, t2)

    z1 = oz + sz * t1
    z2 = oz + sz * t2
    lo, hi = z_min_rel - N_EPS, z_max_rel + N_EPS
    # forward test with a C_EPS backward tolerance: rays restarting ON a
    # surface (cemented doublets are 1e-7 mm apart in lens files) carry
    # f32 jitter ~1e-8 mm that an exact z >= oz would misread as backward
    fw = oz - C_EPS
    ok1 = (lo <= z1) & (z1 <= hi) & (z1 >= fw) & torch.isfinite(t1)
    ok2 = (lo <= z2) & (z2 <= hi) & (z2 >= fw) & torch.isfinite(t2)

    # prefer the forward in-range root, smaller t when both qualify; accept
    # the CHOSEN root by its z-range
    use1 = ok1 & ~(ok2 & (t2 < t1))
    t = torch.where(use1, t1, t2)
    z_sel = torch.where(use1, z1, z2)
    in_range = (lo <= z_sel) & (z_sel <= hi) & torch.isfinite(t)
    valid = has_root & in_range & ~(lin & ~okB)

    # one Newton polish on Q(t)=At²+2Bt+C mops up the remaining f32
    # rounding of the root. Guard RELATIVELY: near-tangent rays have Q' at
    # the noise floor of its own terms — skip the polish there. The step
    # is clamped and re-validated against the z-range so a bad step can
    # never displace a valid hit.
    Qp = 2.0 * (A * t + B)
    Qv = (A * t + 2.0 * B) * t + C
    scale = torch.abs(A * t) + torch.abs(B)
    ok_p = valid & (torch.abs(Qp) > 1e-5 * scale + N_EPS) & torch.isfinite(t)
    step = torch.clamp(Qv / torch.where(ok_p, Qp, 1.0), -1e-3, 1e-3)
    t_pol = t - step
    z_pol = oz + sz * t_pol
    ok_p = ok_p & (lo <= z_pol) & (z_pol <= hi)
    t = torch.where(ok_p, t_pol, t)
    return t, valid


ADVANCE_STANDOFF = 1.0   # mm of free flight kept before the surface


def advance_to_standoff(p, s, z_min_rel, active):
    """Recondition distant ray origins before a hit solve: advance each ray
    along its own line to the plane ADVANCE_STANDOFF before the surface's
    z-extent. A pure reparameterization (the line is unchanged), but it
    removes the O(ulp(oz²)) cancellation that wrecks the f32 quadratic when
    the previous section is far away.
    """
    sz = s[..., 2]
    ok = active & (sz != 0)
    z_floor = z_min_rel - ADVANCE_STANDOFF
    t0 = (z_floor - p[..., 2]) / torch.where(ok, sz, 1.0)
    adv = ok & (t0 > 0)
    return torch.where(adv[..., None], p + t0[..., None] * s, p)


def clamp_abnormal(o, s, t, valid_surface, z_max_rel):
    """Post-hit bookkeeping shared by all surface kinds.

    - ray starts after the surface z-extent ("beh") → stays in place, no hit
    - no surface hit, backwards hit, or z-deviation → intersect the
      z = z_max plane, no hit

    Returns (t_out, is_hit_possible, broken) where is_hit_possible must
    still be AND-ed with the aperture mask at the hit point by the caller,
    and broken counts "Broken sequentiality" rays.
    """
    oz = o[..., 2]
    sz = s[..., 2]
    t_fin = torch.isfinite(t)
    t_safe = torch.where(t_fin, t, 0.0)
    z_hit = oz + t_safe * sz

    beh = oz > z_max_rel + N_EPS
    neg = z_hit < oz - C_EPS
    bad = ~valid_surface | neg | ~t_fin

    sz_ok = sz != 0
    t_zmax = (z_max_rel - oz) / torch.where(sz_ok, sz, 1.0)
    t_zmax = torch.where(sz_ok, t_zmax, 0.0)
    t_out = torch.where(bad & ~beh, t_zmax, t_safe)
    t_out = torch.where(beh, 0.0, t_out)

    ok = ~(bad | beh)
    return t_out, ok, (bad & ~beh) | beh
