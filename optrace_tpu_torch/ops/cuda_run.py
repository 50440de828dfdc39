"""Whole-run trace kernel: wrapper, step table and plain PyTorch version.

Counterpart of ``optrace_tpu/ops/pallas_run.py`` (``conic_run_pallas``): L
consecutive refract steps on flat discs, spheres and conics for every ray,
with the ray state kept on chip for the whole run. The kernel is CUDA C++
(``csrc/conic_run.cu``, which also carries the design note and the bound);
:func:`conic_run_reference` is its plain PyTorch version: a Python loop
over a tensor-valued :func:`_one_step` in the same operation order, so that
both make the same hit/miss decisions. The plain version is what a run uses
on the CPU, in f64 and when a gradient is needed.

A step is a dict of python floats (the per-step constants, as
``tracer/trace_core.py:_run_steps`` builds them): ``rho, k, r, z_min,
z_max, is_flat, dx, dy, dz, ox, oy, oz, out`` (6 outline bounds relative
to the applied origin) and ``kind``. Only the kinds in :data:`RUN_KINDS`
exist in the kernel so far; any other kind makes both versions raise.
"""

import ctypes
import functools

import numpy as np
import torch

from .geom import N_EPS, C_EPS, ADVANCE_STANDOFF

INV_SQRT2 = float(np.sqrt(0.5))
INF = float("inf")

#: surface kinds the run can hold (``scene_compile`` kind names)
RUN_KINDS = ("conic", "circle", "flat")

STEP_WORDS = 27      # 32-bit words of one ``Step`` in csrc/conic_run.cu
MAX_RUN = 400        # steps per launch: the table must fit in 48 KB of shared memory


def _check_kinds(steps) -> None:
    for c in steps:
        if c.get("kind", "conic") not in RUN_KINDS:
            raise NotImplementedError(
                f"step kind '{c.get('kind')}' is not ported to the run kernel yet "
                "(ROADMAP: kernel 1's asphere, tilted and fused-absorber step kinds)")


# ----------------------------------------------------------------------
# plain version

def _one_step(px, py, pz, sx, sy, sz, w, n1, n2, c, pol=None):
    """One refract step on component tensors; ``c`` is the per-step
    constant dict; ``pol`` is None (no-pol) or a (qx, qy, qz) tuple.
    Returns new state, pol and the (miss, tir, outline, ill) masks."""
    where = torch.where
    hw = w > 0

    # --- frame shift into this surface's vertex frame ------------------
    px = px - c["dx"]
    py = py - c["dy"]
    pz = pz - c["dz"]
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
    if c["is_flat"]:
        # plane z=0 hit (geom.hit_plane); clamp shared below
        sz_ok = sz != 0
        t = where(sz_ok, -pz / where(sz_ok, sz, 1.0), INF)
        valid = torch.isfinite(t) & (t >= -C_EPS)
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
    r2h = hx * hx + hy * hy     # reused by the conic normal below
    px = where(hw, hx, px)
    py = where(hw, hy, py)
    pz = where(hw, hz, pz)

    hit = (r2h <= (c["r"] + N_EPS) ** 2) & ok & hw
    miss = hw & ~hit
    w = where(miss, 0.0, w)

    # --- normal (geom.normal_conic / flat) -----------------------------
    if c["is_flat"]:
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.ones_like(px)
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

    # --- outline-box kill, intersected FROM THE PREVIOUS POSITION ------
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


def conic_run_reference(p, s, w, n_tab, med_idx, steps, pol=None, store=True):
    """Plain PyTorch version of :func:`conic_run`: same arguments, same
    results, any device, f32 or f64, differentiable."""
    _check_kinds(steps)
    st = (p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2], w)
    q = None if pol is None else (pol[:, 0], pol[:, 1], pol[:, 2])
    counts, ys_p, ys_w, ys_pol = [], [], [], []
    for c, (r1, r2) in zip(steps, med_idx):
        st, q, flags = _one_step(*st, n_tab[r1], n_tab[r2], c, pol=q)
        counts.append(torch.stack([torch.count_nonzero(f) for f in flags]))
        if store:
            ys_p.append(torch.stack([st[0] + c["ox"], st[1] + c["oy"], st[2] + c["oz"]], dim=-1))
            ys_w.append(st[6])
            if q is not None:
                ys_pol.append(torch.stack(q, dim=-1))
    p2 = torch.stack(st[0:3], dim=-1)
    s2 = torch.stack(st[3:6], dim=-1)
    pol2 = None if q is None else torch.stack(q, dim=-1)
    counts = torch.stack(counts).to(torch.int32)
    if not store:
        return (p2, s2, st[6], pol2), (counts, None, None, None)
    return (p2, s2, st[6], pol2), (counts, torch.stack(ys_p), torch.stack(ys_w),
                                   torch.stack(ys_pol) if q is not None else None)


# ----------------------------------------------------------------------
# kernel

def _step_table(steps, med_idx) -> np.ndarray:
    """The (L, STEP_WORDS) table of ``Step`` structs. Derived constants are
    evaluated in f64, as the plain version evaluates them from the python
    floats, and rounded once to f32."""
    L = len(steps)
    tab = np.zeros((L, STEP_WORDS), dtype=np.float32)
    itab = tab.view(np.int32)
    for j, (c, (r1, r2)) in enumerate(zip(steps, med_idx)):
        rho, k = float(c["rho"]), float(c["k"])
        tab[j, 0:3] = (c["dx"], c["dy"], c["dz"])
        tab[j, 3:6] = (c["ox"], c["oy"], c["oz"])
        tab[j, 6] = c["z_min"] - ADVANCE_STANDOFF
        tab[j, 7] = 1.0 / rho
        tab[j, 8] = 2.0 / rho
        tab[j, 9] = k
        tab[j, 10] = k + 1.0
        tab[j, 11] = c["z_min"] - N_EPS
        tab[j, 12] = c["z_max"] + N_EPS
        tab[j, 13] = c["z_max"]
        tab[j, 14] = (c["r"] + N_EPS) ** 2
        tab[j, 15] = k * rho * rho
        tab[j, 16] = -rho
        tab[j, 17:23] = c["out"]
        itab[j, 23] = int(bool(c["is_flat"]))
        itab[j, 24] = int(r1)
        itab[j, 25] = int(r2)
    return tab


@functools.lru_cache(maxsize=64)
def _device_table(raw: bytes, device) -> torch.Tensor:
    """The step table on the device, copied once per distinct table: a
    render calls the same runs batch after batch, and the copy from
    pageable host memory would hold the host up at every launch."""
    return torch.frombuffer(bytearray(raw), dtype=torch.float32).to(device)


def _lib():
    from . import _build
    lib = _build.load("conic_run")
    if not getattr(lib, "_ot_ready", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.conic_run_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ctypes.c_longlong,
                                         vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp]
        lib.conic_run_launch.restype = ci
        lib.conic_run_step_bytes.restype = ci
        if lib.conic_run_step_bytes() != 4 * STEP_WORDS:
            raise RuntimeError("Step layout of csrc/conic_run.cu and STEP_WORDS disagree")
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


def conic_run(p, s, w, n_tab, med_idx, steps, pol=None, store=True):
    """Run L consecutive conic/flat refract steps for every ray.

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
    :return: (p', s', w', pol'|None), (counts (L, 4) int32 rows of
        [miss, tir, outline, ill], ys_p (L, N, 3)|None, ys_w (L, N)|None,
        ys_pol (L, N, 3)|None)
    """
    if p.device.type == "cpu":
        return conic_run_reference(p, s, w, n_tab, med_idx, steps, pol=pol, store=store)
    if p.device.type != "cuda":
        raise ValueError(f"conic_run runs on CUDA or CPU tensors, not on {p.device}")

    _check_kinds(steps)
    L, N, dev = len(steps), p.shape[0], p.device
    if not 0 < L <= MAX_RUN:
        raise ValueError(f"a run holds 1 to {MAX_RUN} steps, got {L}")
    if len(med_idx) != L:
        raise ValueError("med_idx needs one (n1_row, n2_row) pair per step")
    _check("p", p, (N, 3), dev)
    _check("s", s, (N, 3), dev)
    _check("w", w, (N,), dev)
    _check("n_tab", n_tab, (n_tab.shape[0], N), dev)
    if pol is not None:
        _check("pol", pol, (N, 3), dev)
    M = n_tab.shape[0]
    if any(not (0 <= r1 < M and 0 <= r2 < M) for r1, r2 in med_idx):
        raise ValueError("med_idx row outside n_tab")
    p, s, w, n_tab = p.contiguous(), s.contiguous(), w.contiguous(), n_tab.contiguous()
    pol = pol.contiguous() if pol is not None else None

    lib = _lib()
    with torch.cuda.device(dev):
        table = _device_table(_step_table(steps, med_idx).tobytes(), dev)
        p2, s2, w2 = torch.empty_like(p), torch.empty_like(s), torch.empty_like(w)
        pol2 = torch.empty_like(pol) if pol is not None else None
        counts = torch.zeros((L, 4), dtype=torch.int32, device=dev)
        ys_p = ys_w = ys_pol = None
        if store:
            ys_p = torch.empty((L, N, 3), dtype=torch.float32, device=dev)
            ys_w = torch.empty((L, N), dtype=torch.float32, device=dev)
            if pol is not None:
                ys_pol = torch.empty((L, N, 3), dtype=torch.float32, device=dev)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        rc = lib.conic_run_launch(
            ptr(p), ptr(s), ptr(w), ptr(pol), ptr(n_tab), ptr(table), L, N,
            ptr(p2), ptr(s2), ptr(w2), ptr(pol2), ptr(counts),
            ptr(ys_p), ptr(ys_w), ptr(ys_pol),
            int(pol is not None), int(store), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conic_run kernel launch failed with CUDA error {rc}")
    conic_run.launches += 1
    variant = (pol is not None, bool(store))
    conic_run.variant_launches[variant] = conic_run.variant_launches.get(variant, 0) + 1
    return (p2, s2, w2, pol2), (counts, ys_p, ys_w, ys_pol)


conic_run.launches = 0              # kernel launches since the last reset
conic_run.variant_launches = {}     # the same, by (with_pol, store)


def reset_launch_counts() -> None:
    conic_run.launches = 0
    conic_run.variant_launches = {}
