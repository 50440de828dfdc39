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

``normal_numeric`` gives the exact normal of a user's sag function (the
function and data surfaces) by forward-mode differentiation.
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


def sag_asphere(x, y, rho, k, coeffs):
    """Even asphere: conic + Σ aᵢ·r^(2(i+1)) over the polynomial
    coefficients (the polynomial starts at r²)."""
    r2 = x * x + y * y
    z = sag_conic_radial(r2, rho, k)
    # Horner in r²: a0*r2 + a1*r2² + ...
    poly = torch.zeros_like(r2)
    for c in coeffs[::-1]:
        poly = poly * r2 + c
    return z + poly * r2


def dsag_conic_dr(r, rho, k):
    """Radial derivative m = dz/dr = ρr/√(1−(k+1)ρ²r²)."""
    root = torch.sqrt(torch.clamp(1.0 - (k + 1.0) * rho * rho * r * r, min=N_EPS))
    return rho * r / root


def dsag_asphere_dr(r, rho, k, coeffs):
    """Radial derivative of the even asphere."""
    r2 = r * r
    # d/dr Σ aᵢ r^(2(i+1)) = Σ 2(i+1) aᵢ r^(2i+1)
    dpoly = torch.zeros_like(r2)
    n = len(coeffs)
    for i in range(n - 1, -1, -1):
        dpoly = dpoly * r2 + 2.0 * (i + 1.0) * coeffs[i]
    return dsag_conic_dr(r, rho, k) + dpoly * r


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


def normal_from_radial_deriv(x, y, m_over_r):
    """Normal from radial slope divided by radius: for rotationally symmetric
    sag with m = dz/dr, n ∝ (−(m/r)x, −(m/r)y, 1)."""
    nx = -m_over_r * x
    ny = -m_over_r * y
    nz = torch.ones_like(x)
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + 1.0)
    return torch.stack([nx * inv, ny * inv, nz * inv], dim=-1)


def normal_asphere(x, y, rho, k, coeffs):
    r = torch.sqrt(torch.clamp(x * x + y * y, min=N_EPS * N_EPS))
    m = dsag_asphere_dr(r, rho, k, coeffs)
    return normal_from_radial_deriv(x, y, m / r)


def normal_numeric(sag_fn, x, y):
    """Exact surface normal of a sag function by forward-mode
    differentiation (``torch.func.jvp``): two jvp evaluations give the
    partials to machine precision at any dtype, where a central difference
    loses about three digits in f32. The result stays differentiable in
    reverse mode, so a design gradient flows through it. The name is kept
    from the reference ('numeric' = no user-provided derivative needed).

    ``sag_fn`` must be a function of tensors made of differentiable torch
    operations: a function that calls numpy or ``.item()`` has no
    derivative here. It must also be elementwise, the sag of each ray
    depending on that ray's (x, y) alone: the jvp with a tangent of ones,
    and the gradient of the summed sag below, give the partials only then.

    Inside an active forward-mode level
    (``torch.autograd.forward_ad.dual_level``) PyTorch refuses a nested
    ``torch.func.jvp``; there the partials are taken in reverse mode with
    ``create_graph=True`` (forward over reverse), which carries the outer
    tangent through the normals.
    """
    if torch.autograd.forward_ad._current_level >= 0:
        # the partials by the gradient of the summed sag at x + ex, y + ey
        # (ex = ey = 0): x and y keep their tangents and their graph. The
        # tangent flows through the backward pass either way; its graph is
        # kept only where reverse mode is on as well
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            ex = torch.zeros_like(x, requires_grad=True)
            ey = torch.zeros_like(y, requires_grad=True)
            dzdx, dzdy = torch.autograd.grad(sag_fn(x + ex, y + ey).sum(), (ex, ey),
                                             create_graph=create_graph)
    else:
        _, dzdx = torch.func.jvp(lambda xx: sag_fn(xx, y), (x,), (torch.ones_like(x),))
        _, dzdy = torch.func.jvp(lambda yy: sag_fn(x, yy), (y,), (torch.ones_like(y),))
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(x)], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


# ----------------------------------------------------------------------
# aperture masks (relative transverse coords)

def mask_circle(x, y, r):
    return x * x + y * y <= (r + N_EPS) ** 2


def mask_ring(x, y, ri, r):
    r2 = x * x + y * y
    return (r2 <= (r + N_EPS) ** 2) & (r2 >= (ri - N_EPS) ** 2)


def _rotate2d(x, y, angle_rad):
    a = torch.as_tensor(angle_rad, dtype=x.dtype, device=x.device) \
        if isinstance(angle_rad, torch.Tensor) \
        else torch.full((), angle_rad, dtype=x.dtype, device=x.device)   # no copy from the host
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


def hit_tilted(o, s, n):
    """Intersection with the plane through the vertex with unit normal n."""
    num = -(o[..., 0] * n[0] + o[..., 1] * n[1] + o[..., 2] * n[2])
    den = s[..., 0] * n[0] + s[..., 1] * n[1] + s[..., 2] * n[2]
    ok = den != 0
    t = num / torch.where(ok, den, 1.0)
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


def hit_newton(sag_fn, o, s, z_min_rel, z_max_rel, iters: int = 40):
    """Bracketed bisection/false-position hybrid for general sag surfaces.

    F(t) = oz + t·sz − sag(ox+t·sx, oy+t·sy), root bracketed in
    [t(z_min−ε), t(z_max+ε)]. Each of the fixed ``iters`` steps takes the
    Illinois false-position estimate, safeguarded by bisection when it
    leaves the bracket. 40 iterations shrink any mm-scale bracket below
    C_EPS. The divisions by sz are deliberately unguarded: inf/nan flow
    into ``valid = False``.

    Returns (t, valid, ill): ill flags brackets without a sign change.
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]

    def F(t):
        return oz + t * sz - sag_fn(ox + t * sx, oy + t * sy)

    eps = C_EPS / 10.0
    t1 = (z_min_rel - eps - oz) / sz
    t1 = torch.clamp(t1, min=-C_EPS)       # can't move backwards
    t2 = (z_max_rel + eps - oz) / sz

    f1 = F(t1)
    f2 = F(t2)
    ill = f1 * f2 > 0.0

    for _ in range(iters):
        # Illinois secant estimate, safeguarded into the bracket interior
        df = f2 - f1
        denom = torch.where(torch.abs(df) > N_EPS, df, 1.0)
        ts = t1 - f1 / denom * (t2 - t1)
        mid = 0.5 * (t1 + t2)
        inside = (ts > torch.minimum(t1, t2)) & (ts < torch.maximum(t1, t2))
        ts = torch.where(inside, ts, mid)
        fs = F(ts)
        # keep the sub-bracket containing the sign change; Illinois
        # contraction m=0.5 on the end that stays
        use_left = f1 * fs <= 0.0
        t1, f1, t2, f2 = (torch.where(use_left, t1, ts), torch.where(use_left, 0.5 * f1, fs),
                          torch.where(use_left, ts, t2), torch.where(use_left, fs, 0.5 * f2))

    t = 0.5 * (t1 + t2)
    valid = torch.isfinite(t) & ~ill
    return t, valid, ill


def generic_sag(sag_fn):
    """``sag_fn`` as the generic step of a function or data surface
    evaluates it: each call adds the rays it evaluates to
    ``generic_sag.sag_evals``. The counter counts like the kernel wrappers'
    launch counters: a replayed CUDA graph adds its capture's count
    (``parallel/graph.py``)."""
    def counted(x, y):
        generic_sag.sag_evals += x.numel()
        return sag_fn(x, y)
    return counted


generic_sag.sag_evals = 0


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
