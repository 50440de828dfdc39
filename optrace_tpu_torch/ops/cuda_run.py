"""Whole-run trace kernel: wrapper, step table and plain PyTorch version.

Counterpart of ``optrace_tpu/ops/pallas_run.py`` (``conic_run_pallas``): L
consecutive trace steps for every ray, with the ray state kept on chip for
the whole run. A step refracts on a flat disc, a sphere or conic, an even
asphere or a tilted plane, or absorbs at a fused aperture (circle, ring,
rectangle or slit). The kernel is CUDA C++ (``csrc/conic_run.cu`` around the
step function of ``csrc/trace_step.cuh``; the sources carry the design note
and the bound); :func:`conic_run_reference` is its plain PyTorch version: a
Python loop over a tensor-valued :func:`_one_step` in the same operation
order, so that both make the same hit/miss decisions. The plain version is
what a run uses on the CPU, in f64 and when a gradient is needed.

A step is a dict of python floats (the per-step constants, as
``tracer/trace_core.py:_run_steps`` builds them): ``kind`` (one of
:data:`RUN_KINDS`, or a planar aperture shape for an absorb step), ``rho, k,
r, z_min, z_max, is_flat, dx, dy, dz, ox, oy, oz, out`` (6 outline bounds
relative to the applied origin), and where they apply ``action`` ("refract"
by default, or "absorb"), ``mask`` ("circle", "ring", "rect", "slit") with
``ri, hw, hh, hwi, hhi, angle``, ``tn`` (unit normal of a tilted plane) and
``coeff`` (polynomial of an even asphere, any length >= 1). On the gradient
path a value may be a 0-dim tensor, and a moving vertex adds ``dpos`` (the
(3,) residual shift into the step's frame) and ``rpos`` (the residual of the
step's vertex, added to its stored section). A step of any other kind makes both
versions raise.
"""

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .geom import N_EPS, C_EPS, ADVANCE_STANDOFF
from ..utils.tracing import counted

INV_SQRT2 = float(np.sqrt(0.5))
INF = float("inf")
ASPH_ITERS = 40      # iterations of the asphere's bracketed solve (the plain version runs them
#                      all; the kernel leaves the loop when no later iteration can change t)

#: surface kinds a refract step of the run can hold (``scene_compile`` kind names)
RUN_KINDS = ("conic", "circle", "flat", "asphere", "tilted")
#: planar shapes an absorb step of the run can hold
ABSORB_KINDS = ("circle", "flat", "ring", "rect", "slit")
MASKS = ("circle", "ring", "rect", "slit")

STEP_WORDS = 44      # 32-bit words of one ``Step`` in csrc/trace_step.cuh
SMEM_BYTES = 48 * 1024   # the step table and its coefficient region must fit
#                          the shared memory a block gets without opting in to more
MAX_RUN = SMEM_BYTES // (4 * STEP_WORDS)     # steps per launch, with no asphere among them
_KIND_CODE = {"conic": 0, "flat": 1, "asphere": 2, "tilted": 3}
_INT_WORDS = [23, 24, 25, 26, 27, 41, 42]    # kind, n1_row, n2_row, action, mask, coeff_off, n_coeff


def _action(c) -> str:
    return c.get("action", "refract")


def _solve_kind(c) -> str:
    """Which hit solve a step takes: every planar shape is "flat"."""
    if c["is_flat"]:
        return "flat"
    kind = c.get("kind", "conic")
    return kind if kind in ("asphere", "tilted") else "conic"


def _check_kinds(steps) -> None:
    for c in steps:
        kind, action = c.get("kind", "conic"), _action(c)
        ok = (action == "refract" and kind in RUN_KINDS) or \
             (action == "absorb" and kind in ABSORB_KINDS and c.get("mask", "circle") in MASKS)
        if not ok:
            raise NotImplementedError(
                f"a step of kind '{kind}' with action '{action}' is not ported to the run "
                "kernel: it holds refractions on " + ", ".join(RUN_KINDS)
                + " and absorbers on " + ", ".join(ABSORB_KINDS))
        if kind == "asphere" and len(c.get("coeff", ())) < 1:
            raise ValueError("an asphere step needs at least one polynomial coefficient")


class SectionSlots(NamedTuple):
    """Where a run writes its sections: the trace's buffers of all ``nt``
    sections, positions ``p`` (N, nt, 3), weights ``w`` and media ``n``
    (N, nt) and polarizations ``pol`` (N, nt, 3, or None without
    polarization), and the run's first column ``col0``. Step j of the run
    fills column ``col0 + j`` of every buffer; no other column is touched.
    The buffers are stored section by section (:func:`section_buffer`), so
    that a run's columns are the (L, N, 3) / (L, N) rows that the kernel
    writes."""
    p: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    pol: Optional[torch.Tensor]
    col0: int

    @property
    def nt(self) -> int:
        return self.p.shape[1]


def section_buffer(N, nt, *tail, dtype, device):
    """An uninitialised (N, nt, *tail) buffer stored section by section: the
    transpose of a contiguous (nt, N, *tail) tensor, whose column k is one
    contiguous block."""
    return torch.empty((nt, N, *tail), dtype=dtype, device=device).transpose(0, 1)


def _check_out(out, p, L, with_pol, store) -> None:
    """Raise ValueError unless ``out`` can take the L stored sections of a
    run of the rays ``p``: buffers of ``p``'s dtype on its device that no
    gradient is recorded for, of shapes (N, nt, 3) and (N, nt), each stored
    section by section (:func:`section_buffer`), a polarization buffer
    exactly when the run carries polarization, and 0 ≤ col0 ≤ nt − L."""
    if not store:
        raise ValueError("out takes the stored sections of a run: it needs store=True")
    if not isinstance(out, SectionSlots):
        raise ValueError(f"out must be a SectionSlots, got {type(out).__name__}")
    N = p.shape[0]
    nt = out.p.shape[1] if isinstance(out.p, torch.Tensor) and out.p.dim() == 3 else -1
    bufs = [("p", out.p, (N, nt, 3)), ("w", out.w, (N, nt)), ("n", out.n, (N, nt))]
    if with_pol:
        bufs.append(("pol", out.pol, (N, nt, 3)))
    elif out.pol is not None:
        raise ValueError("out.pol must be None for a run without polarization")
    for name, t, shape in bufs:
        if not isinstance(t, torch.Tensor) or t.device != p.device or t.dtype != p.dtype:
            raise ValueError(f"out.{name} must be a {p.dtype} tensor on {p.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"out.{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.transpose(0, 1).is_contiguous():
            raise ValueError(f"out.{name} must be stored section by section: "
                             "the transpose of a contiguous (nt, N, ...) tensor")
        if t.requires_grad:
            raise ValueError(f"out.{name} requires grad: the run writes into it in place")
    if not (isinstance(out.col0, int) and 0 <= out.col0 and out.col0 + L <= nt):
        raise ValueError(f"a run of {L} steps from column {out.col0} does not fit {nt} columns")


# ----------------------------------------------------------------------
# plain version

def _asph_sag_F(t, px, py, pz, sx, sy, sz, rho, k, coeff):
    """F(t) = z(t) − sag_asphere(x(t), y(t)): the root function of the
    bracketed solve (component form of geom.hit_newton's closure over
    geom.sag_asphere, same guards)."""
    x = px + t * sx
    y = py + t * sy
    r2 = x * x + y * y
    arg = 1.0 - (k + 1.0) * rho * rho * r2
    ok = arg > 0
    root = torch.sqrt(torch.where(ok, arg, 1.0))
    root = torch.where(ok, root, 0.0)
    z = rho * r2 / (1.0 + root)
    poly = torch.zeros_like(r2)
    for cf in coeff[::-1]:
        poly = poly * r2 + cf
    return pz + t * sz - (z + poly * r2)


def _asph_settled(t1, t2):
    """The kernel's exit rule for one bracket: both ends finite and below
    1e38 in size, and equal or neighbouring floats. No later iteration can
    then change ½(t1 + t2) (``csrc/trace_step.cuh`` has the argument)."""
    close = (t1 == t2) | (torch.nextafter(t1, t2) == t2)
    return close & (torch.abs(t1) < 1e38) & (torch.abs(t2) < 1e38)


def _asph_solve(px, py, pz, sx, sy, sz, c, freeze=None):
    """The asphere's hit parameter by bracketed Illinois false position:
    the component form of geom.hit_newton, ASPH_ITERS fixed iterations;
    the deliberately unguarded divisions by sz carry inf/nan into the
    result. Returns (t, ill, iterations): ``ill`` says that the bracket
    has no sign change.

    ``freeze`` is for the study of the kernel's early exit and leaves the
    plain version's arithmetic alone when it is None. "lane" stops
    updating a lane's bracket as soon as it is settled
    (:func:`_asph_settled`); "warp" stops a lane when all 32 consecutive
    lanes of its group are settled, as the kernel's vote does.
    ``iterations`` then counts the updates each lane took (ASPH_ITERS for a
    lane that never settled), otherwise it is None."""
    where = torch.where
    rho, k, coeff = c["rho"], c["k"], c["coeff"]
    eps_b = C_EPS / 10.0
    t1 = torch.clamp((c["z_min"] - eps_b - pz) / sz, min=-C_EPS)
    t2 = (c["z_max"] + eps_b - pz) / sz
    f1 = _asph_sag_F(t1, px, py, pz, sx, sy, sz, rho, k, coeff)
    f2 = _asph_sag_F(t2, px, py, pz, sx, sy, sz, rho, k, coeff)
    ill = f1 * f2 > 0.0
    iters = None if freeze is None else torch.zeros(t1.shape, dtype=torch.int32, device=t1.device)
    done = None if freeze is None else torch.zeros_like(ill)
    for _ in range(ASPH_ITERS):
        df = f2 - f1
        denom = where(torch.abs(df) > N_EPS, df, 1.0)
        ts = t1 - f1 / denom * (t2 - t1)
        mid = 0.5 * (t1 + t2)
        inside = (ts > torch.minimum(t1, t2)) & (ts < torch.maximum(t1, t2))
        ts = where(inside, ts, mid)
        fs = _asph_sag_F(ts, px, py, pz, sx, sy, sz, rho, k, coeff)
        use_left = f1 * fs <= 0.0
        nt1, nf1, nt2, nf2 = (where(use_left, t1, ts), where(use_left, 0.5 * f1, fs),   # Illinois m=0.5
                              where(use_left, ts, t2), where(use_left, fs, 0.5 * f2))
        if freeze is None:
            t1, f1, t2, f2 = nt1, nf1, nt2, nf2
            continue
        t1, f1, t2, f2 = (where(done, t1, nt1), where(done, f1, nf1),
                          where(done, t2, nt2), where(done, f2, nf2))
        iters = iters + (~done).to(torch.int32)
        settled = _asph_settled(t1, t2)
        if freeze == "warp":
            n = settled.shape[0]
            pad = torch.ones((-n) % 32, dtype=torch.bool, device=settled.device)
            groups = torch.cat([settled, pad]).view(-1, 32).all(dim=1)
            settled = groups.repeat_interleave(32)[:n]
        done = done | settled
    return 0.5 * (t1 + t2), ill, iters


def _cos_sin(angle):
    if isinstance(angle, torch.Tensor):
        return torch.cos(angle), torch.sin(angle)
    return math.cos(angle), math.sin(angle)


def _one_step(px, py, pz, sx, sy, sz, w, n1, n2, c, pol=None):
    """One step on component tensors; ``c`` is the per-step constant dict;
    ``pol`` is None (no-pol) or a (qx, qy, qz) tuple. Returns new state, pol
    and the (miss, tir, outline, ill) masks.

    ``c["single"]`` selects the single-step form of ``ops/cuda_trace.py``:
    no frame shift, aperture test ``r² <= r·r`` without N_EPS, no miss kill
    and no outline box."""
    where = torch.where
    hw = w > 0
    single = bool(c.get("single", False))
    solve = _solve_kind(c)

    # --- frame shift into this surface's vertex frame ------------------
    if not single:
        px = px - c["dx"]
        py = py - c["dy"]
        pz = pz - c["dz"]
        if "dpos" in c:     # gradient path: residual shift of the position parameters
            px, py, pz = px - c["dpos"][0], py - c["dpos"][1], pz - c["dpos"][2]
    # previous section position: origin of the outline intersection (the
    # pol branch below must not reuse these names)
    ppx, ppy, ppz = px, py, pz

    # --- standoff advance (geom.advance_to_standoff) -------------------
    ok_adv = hw & (sz != 0)
    t0 = (c["z_min"] - ADVANCE_STANDOFF - pz) / where(ok_adv, sz, 1.0)
    adv = ok_adv & (t0 > 0)
    px = where(adv, px + t0 * sx, px)
    py = where(adv, py + t0 * sy, py)
    pz = where(adv, pz + t0 * sz, pz)

    ill = torch.zeros_like(hw)
    if solve == "flat":
        # plane z=0 hit (geom.hit_plane); clamp shared below
        sz_ok = sz != 0
        t = where(sz_ok, -pz / where(sz_ok, sz, 1.0), INF)
        valid = torch.isfinite(t) & (t >= -C_EPS)
    elif solve == "tilted":
        # tilted plane through the vertex with a constant unit normal; the
        # deliberately unguarded division carries den = 0 into valid = False
        tnx, tny, tnz = c["tn"]
        num = -(px * tnx + py * tny + pz * tnz)
        den = sx * tnx + sy * tny + sz * tnz
        t = num / den
        valid = torch.isfinite(t) & (den != 0)
    elif solve == "asphere":
        # even asphere: bracketed Illinois false position, the component
        # form of geom.hit_newton (ASPH_ITERS fixed iterations; the
        # deliberately unguarded divisions by sz carry inf/nan into
        # valid = False)
        t, ill_raw, _ = _asph_solve(px, py, pz, sx, sy, sz, c)
        ill = ill_raw & hw
        valid = torch.isfinite(t) & ~ill
    else:
        # --- conic root (geom.hit_conic: Citardauq + Newton polish) ----
        rho, k = c["rho"], c["k"]
        A = 1.0 + k * sz * sz
        B = sx * px + sy * py + sz * (pz * (k + 1.0) - 1.0 / rho)
        C = px * px + py * py + pz * (pz * (k + 1.0) - 2.0 / rho)
        disc = B * B - C * A
        has_root = disc >= 0.0
        D = torch.sqrt(where(has_root, disc, 1.0))
        D = where(has_root, D, 0.0)
        sgnB = where(B >= 0, 1.0, -1.0).to(B.dtype)
        q = -(B + sgnB * D)
        okA = torch.abs(A) > N_EPS
        okq = torch.abs(q) > N_EPS
        okB = torch.abs(B) > N_EPS
        t1 = where(okA, q / where(okA, A, 1.0), INF)
        t2 = where(okq, C / where(okq, q, 1.0), INF)
        t_lin = -C / (2.0 * where(okB, B, 1.0))
        lin = ~okA & okB
        t1 = where(lin, t_lin, t1)
        t2 = where(lin, t_lin, t2)

        z1 = pz + sz * t1
        z2 = pz + sz * t2
        lo, hi = c["z_min"] - N_EPS, c["z_max"] + N_EPS
        fw = pz - C_EPS
        ok1 = (lo <= z1) & (z1 <= hi) & (z1 >= fw) & torch.isfinite(t1)
        ok2 = (lo <= z2) & (z2 <= hi) & (z2 >= fw) & torch.isfinite(t2)
        use1 = ok1 & ~(ok2 & (t2 < t1))
        t = where(use1, t1, t2)
        z_sel = where(use1, z1, z2)
        in_range = (lo <= z_sel) & (z_sel <= hi) & torch.isfinite(t)
        valid = has_root & in_range & ~(lin & ~okB)

        At = A * t
        Qp = 2.0 * (At + B)
        Qv = (At + 2.0 * B) * t + C
        scale = torch.abs(At) + torch.abs(B)
        okp = valid & (torch.abs(Qp) > 1e-5 * scale + N_EPS) & torch.isfinite(t)
        stp = torch.clamp(Qv / where(okp, Qp, 1.0), -1e-3, 1e-3)
        t_pol = t - stp
        z_pol = pz + sz * t_pol
        okp = okp & (lo <= z_pol) & (z_pol <= hi)
        t = where(okp, t_pol, t)

    # --- clamp abnormal (geom.clamp_abnormal; flat steps have z_max = 0)
    t_fin = torch.isfinite(t)
    t_safe = where(t_fin, t, 0.0)
    z_hit = pz + t_safe * sz
    beh = pz > c["z_max"] + N_EPS
    neg = z_hit < pz - C_EPS
    bad = ~valid | neg | ~t_fin
    sz_ok = sz != 0
    t_zmax = where(sz_ok, (c["z_max"] - pz) / where(sz_ok, sz, 1.0), 0.0)
    t_safe = where(bad & ~beh, t_zmax, t_safe)
    t_safe = where(beh, 0.0, t_safe)
    ok = ~(bad | beh)

    hx = px + t_safe * sx
    hy = py + t_safe * sy
    hz = pz + t_safe * sz
    r_ap = c["r"]
    r2h = hx * hx + hy * hy     # reused by the conic/asphere normal below
    px = where(hw, hx, px)
    py = where(hw, hy, py)
    pz = where(hw, hz, pz)

    if _action(c) == "absorb":
        # fused aperture: rays HITTING the shape are absorbed, rays through
        # the opening go on untouched (no miss kill, no refraction; the
        # direction and the polarization stay as they are)
        mask = c.get("mask", "circle")
        if mask == "ring":
            hitm = (r2h <= (r_ap + N_EPS) ** 2) & (r2h >= (c["ri"] - N_EPS) ** 2)
        elif mask in ("rect", "slit"):
            ca, sa = _cos_sin(c["angle"])
            xr = hx * ca + hy * sa
            yr = -hx * sa + hy * ca
            hitm = (torch.abs(xr) <= c["hw"] + N_EPS) & (torch.abs(yr) <= c["hh"] + N_EPS)
            if mask == "slit":
                innm = (torch.abs(xr) < c["hwi"] - N_EPS) & (torch.abs(yr) < c["hhi"] - N_EPS)
                hitm = hitm & ~innm
        else:           # circle / full plane
            hitm = r2h <= (r_ap + N_EPS) ** 2
        hit = hitm & ok & hw
        w = where(hit, 0.0, w)
        miss = torch.zeros_like(hw)
        n_tir = torch.zeros_like(hw)
        return _outline_block(px, py, pz, sx, sy, sz, w, pol, ppx, ppy, ppz, c, miss, n_tir, ill)

    if single:
        hit = (r2h <= r_ap * r_ap) & ok & hw
        miss = torch.zeros_like(hw)
    else:
        hit = (r2h <= (r_ap + N_EPS) ** 2) & ok & hw
        miss = hw & ~hit
        w = where(miss, 0.0, w)

    # --- normal (geom.normal_conic / normal_asphere / tilted / flat) ---
    if solve == "flat":
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.ones_like(px)
    elif solve == "tilted":
        tnx, tny, tnz = c["tn"]
        nx = torch.zeros_like(px) + tnx
        ny = torch.zeros_like(px) + tny
        nz = torch.zeros_like(px) + tnz
    elif solve == "asphere":
        # geom.normal_asphere: radial slope m = dsag/dr, n ∝ (−m/r·x,
        # −m/r·y, 1) normalized. r² reuses the aperture-mask product: the
        # normal is only consumed under hit/upd masks, where p == (hx, hy)
        rho, k, coeff = c["rho"], c["k"], c["coeff"]
        r = torch.sqrt(torch.clamp(r2h, min=N_EPS * N_EPS))
        root = torch.sqrt(torch.clamp(1.0 - (k + 1.0) * rho * rho * r * r, min=N_EPS))
        m = rho * r / root
        dpoly = torch.zeros_like(r2h)
        for i in range(len(coeff) - 1, -1, -1):
            dpoly = dpoly * r2h + 2.0 * (i + 1.0) * coeff[i]
        m = m + dpoly * r
        mr = m / r
        nxu = -mr * px
        nyu = -mr * py
        inv = 1.0 / torch.sqrt(nxu * nxu + nyu * nyu + 1.0)
        nx = nxu * inv
        ny = nyu * inv
        nz = inv
    else:
        rho, k = c["rho"], c["k"]
        arg = 1.0 - k * rho * rho * r2h     # r2h == px²+py² wherever the normal is used
        den = torch.sqrt(where(arg > N_EPS, arg, N_EPS))
        nx = -rho * px / den
        ny = -rho * py / den
        argz = 1.0 - (nx * nx + ny * ny)
        nz = torch.sqrt(where(argz > N_EPS, argz, N_EPS))

    # --- Snell + Fresnel (trace_core._refract_core) --------------------
    ns = nx * sx + ny * sy + nz * sz
    graze = ns < 1e-6
    ns_safe = where(graze, 1.0, ns)
    Nq = n1 / n2
    W2 = 1.0 - Nq * Nq * (1.0 - ns * ns)
    tir = W2 < 0.0
    W = torch.sqrt(where(tir, 1.0, W2))
    W = where(tir, 0.0, W)
    f = Nq * ns - W
    sx_ = sx * Nq - nx * f
    sy_ = sy * Nq - ny * f
    sz_ = sz * Nq - nz * f

    upd = hit & ~tir
    if pol is None:
        A_ts2, A_tp2 = 0.5, 0.5
    else:
        # s/p decomposition across the direction change (component form
        # of trace_core._compute_polarization)
        qx, qy, qz = pol
        changed = (sx != sx_) | (sy != sy_) | (sz != sz_)
        cx = sy_ * sz - sz_ * sy
        cy = sz_ * sx - sx_ * sz
        cz = sx_ * sy - sy_ * sx
        cn2 = cx * cx + cy * cy + cz * cz
        cok = cn2 > 0
        cinv = 1.0 / torch.sqrt(where(cok, cn2, 1.0))
        psx = where(cok, cx * cinv, 0.0)
        psy = where(cok, cy * cinv, 0.0)
        psz = where(cok, cz * cinv, 0.0)
        # p-basis before (b) and after (b_) the refraction
        bx = psy * sz - psz * sy
        by = psz * sx - psx * sz
        bz = psx * sy - psy * sx
        A_ts = psx * qx + psy * qy + psz * qz
        A_tp = bx * qx + by * qy + bz * qz
        A_ts = where(changed, A_ts, INV_SQRT2)
        A_tp = where(changed, A_tp, INV_SQRT2)
        bx_ = psy * sz_ - psz * sy_
        by_ = psz * sx_ - psx * sz_
        bz_ = psx * sy_ - psy * sx_
        m = upd & changed
        qx = where(m, psx * A_ts + bx_ * A_tp, qx)
        qy = where(m, psy * A_ts + by_ * A_tp, qy)
        qz = where(m, psz * A_ts + bz_ * A_tp, qz)
        pol = (qx, qy, qz)
        A_ts2, A_tp2 = A_ts * A_ts, A_tp * A_tp
    n1ca = n1 * ns_safe
    n2cb = n2 * W
    ts = 2.0 * n1ca / (n1ca + n2cb)
    tp = 2.0 * n1ca / (n2 * ns_safe + n1 * W)
    T = n2cb / n1ca * (A_ts2 * ts * ts + A_tp2 * tp * tp)
    T = where(tir | graze, 0.0, T)

    w = where(hit, w * T, w)
    n_tir = tir & hit
    sx = where(upd, sx_, sx)
    sy = where(upd, sy_, sy)
    sz = where(upd, sz_, sz)

    if single:
        return (px, py, pz, sx, sy, sz, w), pol, (miss, n_tir, torch.zeros_like(hw), ill)
    return _outline_block(px, py, pz, sx, sy, sz, w, pol, ppx, ppy, ppz, c, miss, n_tir, ill)


def _outline_block(px, py, pz, sx, sy, sz, w, pol, ppx, ppy, ppz, c, miss, n_tir, ill):
    """Outline-box escape kill shared by the refract and the absorb step
    (trace_core._outline_intersection): rays outside the box are
    intersected with it FROM THE SAVED PREVIOUS POSITION ppx/ppy/ppz and
    absorbed; returns the step's full result tuple."""
    where = torch.where
    xs, xe, ys, ye, zs, ze = c["out"]
    inside = (xs < px) & (px < xe) & (ys < py) & (py < ye) & (zs < pz) & (pz < ze)
    outl = ~inside & (w > 0)
    tmin = torch.full_like(px, INF)
    for pc, sc, lo_b, hi_b in ((ppx, sx, xs, xe), (ppy, sy, ys, ye), (ppz, sz, zs, ze)):
        okd = sc != 0
        den = where(okd, sc, 1.0)
        for bound in (lo_b, hi_b):
            tb = (bound - pc) / den
            tmin = where(okd & (tb > 0) & (tb < tmin), tb, tmin)
    tmin = where(torch.isfinite(tmin), tmin, 0.0)
    px = where(outl, ppx + tmin * sx, px)
    py = where(outl, ppy + tmin * sy, py)
    pz = where(outl, ppz + tmin * sz, pz)
    w = where(outl, 0.0, w)

    return (px, py, pz, sx, sy, sz, w), pol, (miss, n_tir, outl, ill)


def conic_run_reference(p, s, w, n_tab, med_idx, steps, pol=None, store=True, out=None):
    """Plain PyTorch version of :func:`conic_run`: same arguments, same
    results, any device, f32 or f64, differentiable (but not into ``out``)."""
    _check_kinds(steps)
    if out is not None:
        _check_out(out, p, len(steps), pol is not None, store)
    st = (p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2], w)
    q = None if pol is None else (pol[:, 0], pol[:, 1], pol[:, 2])
    counts, ys_p, ys_w, ys_pol = [], [], [], []
    for j, (c, (r1, r2)) in enumerate(zip(steps, med_idx)):
        st, q, flags = _one_step(*st, n_tab[r1], n_tab[r2], c, pol=q)
        counts.append(torch.stack([torch.count_nonzero(f) for f in flags]))
        if store:
            sec = torch.stack([st[0] + c["ox"], st[1] + c["oy"], st[2] + c["oz"]], dim=-1)
            sec = sec + c["rpos"] if "rpos" in c else sec
            if out is not None:
                k = out.col0 + j
                out.p[:, k].copy_(sec)
                out.w[:, k].copy_(st[6])
                out.n[:, k].copy_(n_tab[r2])
                if q is not None:
                    out.pol[:, k].copy_(torch.stack(q, dim=-1))
                continue
            ys_p.append(sec)
            ys_w.append(st[6])
            if q is not None:
                ys_pol.append(torch.stack(q, dim=-1))
    p2 = torch.stack(st[0:3], dim=-1)
    s2 = torch.stack(st[3:6], dim=-1)
    pol2 = None if q is None else torch.stack(q, dim=-1)
    counts = torch.stack(counts).to(torch.int32)
    if not store or out is not None:
        return (p2, s2, st[6], pol2), (counts, None, None, None)
    return (p2, s2, st[6], pol2), (counts, torch.stack(ys_p), torch.stack(ys_w),
                                   torch.stack(ys_pol) if q is not None else None)


# ----------------------------------------------------------------------
# kernel

def _step_table(steps, med_idx) -> np.ndarray:
    """The (L, STEP_WORDS) table of ``Step`` structs. Derived constants are
    evaluated in f64, as the plain version evaluates them from the python
    floats, and rounded once to f32. The asphere coefficients lie behind
    the table, in :func:`_coeff_region`; a step names its own by offset
    and count."""
    rows, ints = [], []
    coeff_off = 0
    for c, (r1, r2) in zip(steps, med_idx):
        rho, k = float(c["rho"]), float(c["k"])
        z_min, z_max, r = c["z_min"], c["z_max"], c["r"]
        solve = _solve_kind(c)
        n_cf = len(c["coeff"]) if solve == "asphere" else 0
        rows.append((
            c["dx"], c["dy"], c["dz"], c["ox"], c["oy"], c["oz"],
            z_min - ADVANCE_STANDOFF, 1.0 / rho, 2.0 / rho, k, k + 1.0,
            z_min - N_EPS, z_max + N_EPS, z_max,
            r * r if c.get("single") else (r + N_EPS) ** 2,
            k * rho * rho, -rho, *c["out"],
            0.0, 0.0, 0.0, 0.0, 0.0,                        # 23-27: integer words, below
            (c.get("ri", 0.0) - N_EPS) ** 2,
            c.get("hw", 1.0) + N_EPS, c.get("hh", 1.0) + N_EPS,
            c.get("hwi", 0.0) - N_EPS, c.get("hhi", 0.0) - N_EPS,
            *_cos_sin(float(c.get("angle", 0.0))), *c.get("tn", (0.0, 0.0, 1.0)),
            (k + 1.0) * rho * rho, z_min - C_EPS / 10.0, z_max + C_EPS / 10.0,
            0.0, 0.0, 0.0))                                 # 41-43: integer words and padding
        ints.append((_KIND_CODE[solve], int(r1), int(r2), int(_action(c) == "absorb"),
                     MASKS.index(c.get("mask", "circle")), coeff_off, n_cf))
        coeff_off += 2 * n_cf
    # one rounding from f64 to f32 for every word, as an assignment of a
    # python float into an f32 array rounds
    tab = np.asarray(rows, dtype=np.float64).astype(np.float32).reshape(len(steps), STEP_WORDS)
    tab.view(np.int32)[:, _INT_WORDS] = np.asarray(ints, dtype=np.int32)
    return tab


def _coeff_region(steps) -> np.ndarray:
    """The coefficient region behind the step table: for each asphere step
    its n coefficients a_i, then the n factors 2(i+1)·a_i of the slope's
    polynomial, each evaluated in f64 and rounded once."""
    vals = []
    for c in steps:
        if _solve_kind(c) == "asphere":
            cf = [float(v) for v in c["coeff"]]
            vals += cf + [2.0 * (i + 1.0) * v for i, v in enumerate(cf)]
    return np.asarray(vals, dtype=np.float32)


def _table_bytes(steps, med_idx) -> bytes:
    """Step table and coefficient region as the kernel reads them."""
    raw = _step_table(steps, med_idx).tobytes() + _coeff_region(steps).tobytes()
    if len(raw) > SMEM_BYTES:
        raise ValueError(f"the step table of this run takes {len(raw)} B of shared memory, "
                         f"more than {SMEM_BYTES} B: split the run")
    return raw


class PreparedRun:
    """Everything of a run that does not depend on the rays: the checked
    step dicts and media row pairs, the step table as the kernel reads it
    (:func:`_table_bytes`), which instantiation of the kernel the run takes
    and the tags for the launch counters; and, copied at the first launch on
    a device, the table there.

    The constants of a run depend on the compiled steps, the frame chain
    and the outline, so a prepared run is good for as long as the step list
    it was made from is the scene: a compiled scene
    (``Raytracer.trace_program``) holds new steps and prepares anew
    (``tracer/trace_core.py:RunPlans``)."""

    def __init__(self, steps, med_idx):
        _check_kinds(steps)
        self.L = len(steps)
        if not 0 < self.L <= MAX_RUN:
            raise ValueError(f"a run holds 1 to {MAX_RUN} steps, got {self.L}")
        if len(med_idx) != self.L:
            raise ValueError("med_idx needs one (n1_row, n2_row) pair per step")
        self.steps = list(steps)
        self.med_idx = [(int(r1), int(r2)) for r1, r2 in med_idx]
        self.rows = (min(min(p) for p in self.med_idx), max(max(p) for p in self.med_idx))
        self.tags = frozenset(step_tag(c) for c in steps)
        self.refractions = sum(_action(c) == "refract" for c in steps)
        # a run of flat and conic refractions alone takes the instantiation
        # of the kernel that holds no other step kind (fewer registers)
        self.all_kinds = not self.tags <= {"conic", "flat"}
        self.raw = _table_bytes(self.steps, self.med_idx)
        self._tables = {}       # device -> the table there

    def table(self, dev) -> torch.Tensor:
        """The step table on ``dev``, copied there once."""
        tab = self._tables.get(dev)
        if tab is None:
            tab = self._tables[dev] = torch.frombuffer(bytearray(self.raw), dtype=torch.float32).to(dev)
        return tab


def _lib():
    from . import _build
    lib = _build.load("conic_run")
    if not getattr(lib, "_ot_ready", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.conic_run_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ctypes.c_longlong,
                                         vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.conic_run_launch.restype = ci
        lib.conic_run_step_bytes.restype = ci
        if lib.conic_run_step_bytes() != 4 * STEP_WORDS:
            raise RuntimeError("Step layout of csrc/trace_step.cuh and STEP_WORDS disagree")
        lib._ot_ready = True
    return lib


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the run kernel, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad: the run kernel has no backward, "
                         "use conic_run_reference")


def conic_run(p, s, w, n_tab, med_idx, steps, pol=None, store=True, plan=None, out=None):
    """Run L consecutive trace steps for every ray.

    On CUDA tensors this launches the kernel (or raises); tensors on the
    CPU take the plain version :func:`conic_run_reference`.

    :param p, s: (N, 3) positions (in the frame BEFORE the first step's
        delta shift) and directions
    :param w: (N,) weights
    :param n_tab: (M, N) refractive index of each unique medium per ray
    :param med_idx: L pairs (n1_row, n2_row) into ``n_tab``
    :param steps: L per-step constant dicts (see the module docstring)
    :param pol: optional (N, 3) polarization vectors — enables the s/p
        polarization transport
    :param store: also return per-step absolute positions and weights
        (and polarizations when ``pol`` is given)
    :param plan: the :class:`PreparedRun` of ``steps`` and ``med_idx``, for
        a caller that launches the same run again and again; without it the
        run is prepared at every call
    :param out: optional :class:`SectionSlots`: the stored sections go
        straight into their columns of the trace's buffers, with the medium
        n₂ of each step (``n_tab[med_idx[j][1]]``) in ``out.n``; the buffers
        are checked before the launch (ValueError)
    :return: (p', s', w', pol'|None), (counts (L, 4) int32 rows of
        [miss, tir, outline, ill], ys_p (L, N, 3)|None, ys_w (L, N)|None,
        ys_pol (L, N, 3)|None); the ys are None when the sections went
        into ``out``
    """
    if p.device.type == "cpu":
        return conic_run_reference(p, s, w, n_tab, med_idx, steps, pol=pol, store=store, out=out)
    if p.device.type != "cuda":
        raise ValueError(f"conic_run runs on CUDA or CPU tensors, not on {p.device}")

    if plan is None:
        plan = PreparedRun(steps, med_idx)
    L, N, dev = plan.L, p.shape[0], p.device
    if out is not None:
        _check_out(out, p, L, pol is not None, store)
    _check("p", p, (N, 3), dev)
    _check("s", s, (N, 3), dev)
    _check("w", w, (N,), dev)
    _check("n_tab", n_tab, (n_tab.shape[0], N), dev)
    if pol is not None:
        _check("pol", pol, (N, 3), dev)
    if not (0 <= plan.rows[0] and plan.rows[1] < n_tab.shape[0]):
        raise ValueError("med_idx row outside n_tab")
    p, s, w, n_tab = p.contiguous(), s.contiguous(), w.contiguous(), n_tab.contiguous()
    pol = pol.contiguous() if pol is not None else None

    lib = _lib()
    with torch.cuda.device(dev):
        table = plan.table(dev)
        p2, s2, w2 = torch.empty_like(p), torch.empty_like(s), torch.empty_like(w)
        pol2 = torch.empty_like(pol) if pol is not None else None
        counts = torch.zeros((L, 4), dtype=torch.int32, device=dev)
        ys_p = ys_w = ys_pol = ys_n = None
        if out is not None:
            # the run's columns: (L, N, ...) rows of the section-major buffers
            ys_p, ys_w, ys_n, ys_pol = (None if t is None else t.transpose(0, 1)[out.col0:out.col0 + L]
                                        for t in (out.p, out.w, out.n, out.pol))
        elif store:
            ys_p = torch.empty((L, N, 3), dtype=torch.float32, device=dev)
            ys_w = torch.empty((L, N), dtype=torch.float32, device=dev)
            if pol is not None:
                ys_pol = torch.empty((L, N, 3), dtype=torch.float32, device=dev)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        rc = lib.conic_run_launch(
            ptr(p), ptr(s), ptr(w), ptr(pol), ptr(n_tab), ptr(table), L, table.numel(), N,
            ptr(p2), ptr(s2), ptr(w2), ptr(pol2), ptr(counts),
            ptr(ys_p), ptr(ys_w), ptr(ys_pol), ptr(ys_n),
            int(pol is not None), int(store), int(plan.all_kinds),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conic_run kernel launch failed with CUDA error {rc}")
    conic_run.launches += 1
    conic_run.refractions += plan.refractions
    variant = (pol is not None, bool(store))
    conic_run.variant_launches[variant] = conic_run.variant_launches.get(variant, 0) + 1
    if out is not None:
        conic_run.slot_launches += 1
    for tag in plan.tags:
        conic_run.kind_launches[tag] = conic_run.kind_launches.get(tag, 0) + 1
    if out is not None:
        return (p2, s2, w2, pol2), (counts, None, None, None)
    return (p2, s2, w2, pol2), (counts, ys_p, ys_w, ys_pol)


def step_tag(c) -> str:
    """What a step makes the kernel do: the hit solve of a refract step
    ("conic", "flat", "asphere", "tilted") or "absorb:<mask>"."""
    if _action(c) == "absorb":
        return "absorb:" + c.get("mask", "circle")
    return _solve_kind(c)


conic_run.launches = 0              # kernel launches since the last reset
conic_run.variant_launches = {}     # the same, by (with_pol, store)
conic_run.slot_launches = 0         # the same, of those that wrote into SectionSlots
conic_run.kind_launches = {}        # launches that held a step of each step_tag
conic_run.refractions = 0           # the refraction steps of those launches
counted(conic_run, "launches", "variant_launches", "slot_launches", "kind_launches", "refractions")
