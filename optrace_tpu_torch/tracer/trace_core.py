"""The surface-sequential trace as a pure function of tensors.

Counterpart of ``optrace_tpu/tracer/trace_core.py``: the whole ray bundle
is one set of tensors on one device, the element loop is a Python loop over
the static scene structure, and all per-ray branching is masked arithmetic.

Physics per step:
- vectorial Snell + Fresnel transmission with polarization projection,
  TIR → absorbed + counted
- polarization transport in the s/p decomposition
- ideal-lens refraction
- filter transmission / aperture absorption with optional HURB
  edge-diffraction bending
- outline-box escape absorption
- "Broken sequentiality" / miss / ill-conditioned bookkeeping (INFOS)

Runs of consecutive steps go to
:func:`optrace_tpu_torch.ops.cuda_run.conic_run`: the hand-written CUDA
kernel on a CUDA device, its plain PyTorch version on the CPU, in f64 and
when a gradient is needed. A run holds refractions on flat discs, conics
and even aspheres, and with ``global_options.cuda_fuse_planar`` also
refractions on tilted planes and the aperture absorbers between them;
:func:`_run_step` is the one predicate that decides. The plain version runs
every kind that the kernel runs, so a run that must take the plain version
keeps its partition: nothing here re-partitions a run at dispatch. Ideal
lenses, filters and apertures that bend rays (HURB edge diffraction) are
single steps of eager tensor operations between the runs.
"""

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import geom
from ..ops.cuda_run import (conic_run, conic_run_reference, PreparedRun, SectionSlots, section_buffer,
                            ABSORB_KINDS)
from ..ops.vector import rdot, cross, normalize_safe
from ..utils.tracing import device_interval, span
from .scene_compile import SurfaceFns, host_values

INV_SQRT2 = 1.0 / np.sqrt(2.0)

# INFOS rows
ABSORB_MISSING, TIR, ILL_COND, OUTLINE_INTERSECTION, HURB_NEG_DIR = range(5)
N_INFOS = 5

HURB_FACTOR = np.sqrt(2.0)


class TraceStep(NamedTuple):
    """One light-interacting surface in the unrolled trace."""
    sfns: SurfaceFns
    action: str                      # "refract" | "ideal" | "filter" | "absorb"
    n1_fn: Optional[Callable] = None  # wl -> n before surface (refract)
    n2_fn: Optional[Callable] = None  # wl -> n after surface (refract/ideal)
    spectrum_fn: Optional[Callable] = None   # wl -> T (filter)
    D: float = 0.0                   # optical power in dpt (ideal)
    hurb: bool = False               # HURB bending at this aperture
    hurb_kind: str = ""              # "ring" | "slit"
    pos_host: Optional[tuple] = None  # static f64 vertex position; enables
    #   per-surface local-frame re-centering (the f32 accuracy anchor: ray
    #   state is kept relative to the CURRENT surface vertex, so position
    #   rounding is ~eps*(gap+aperture) instead of eps*|z_absolute| — at
    #   z=430 mm the difference is 5e-5 vs 1e-6 mm, and cemented doublet
    #   interfaces 1e-7 mm apart stop absorbing rays spuriously)


# ----------------------------------------------------------------------
# helpers

def _surface_hit(step: TraceStep, p, s, hw):
    """Hit solve + abnormal clamping + aperture mask for one surface.

    Dead rays (not hw) stay in place. Returns (p_new, hit, ill, n_broken).
    """
    params = step.sfns.params
    # p is already relative to the surface vertex (local frame); recondition
    # rays whose previous section is far away before solving
    ps = geom.advance_to_standoff(p, s, params["z_min_rel"], hw)
    t, valid, ill = step.sfns.hit_fn(params, ps, s)
    t2, ok, broken = geom.clamp_abnormal(ps, s, t, valid, params["z_max_rel"])
    p_hit = ps + t2[:, None] * s
    hit = step.sfns.mask_fn(params, p_hit[:, 0], p_hit[:, 1]) & ok
    p_new = torch.where(hw[:, None], p_hit, p)
    hit = hit & hw
    return p_new, hit, ill & hw, torch.count_nonzero(broken & hw)


def _compute_polarization(s, s_, pols, upd, no_pol):
    """s/p decomposition of polarization across a direction change.
    Returns (A_ts, A_tp, new_pols)."""
    if no_pol:
        return INV_SQRT2, INV_SQRT2, pols

    changed = torch.any(s != s_, dim=-1)
    ps = normalize_safe(cross(s_, s))
    pp = cross(ps, s)
    A_ts = rdot(ps, pols)
    A_tp = rdot(pp, pols)
    A_ts = torch.where(changed, A_ts, INV_SQRT2)
    A_tp = torch.where(changed, A_tp, INV_SQRT2)
    pp_ = cross(ps, s_)
    pol_new = ps * A_ts[:, None] + pp_ * A_tp[:, None]
    m = (upd & changed)[:, None]
    return A_ts, A_tp, torch.where(m, pol_new, pols)


def _outline_intersection(p_prev, p_new, s, w, outline):
    """Kill rays leaving the outline box; intersect them with the box.
    Returns (p_out, w_out, count)."""
    xs, xe, ys, ye, zs, ze = [outline[i] for i in range(6)]
    x, y, z = p_new[:, 0], p_new[:, 1], p_new[:, 2]
    inside = (xs < x) & (x < xe) & (ys < y) & (y < ye) & (zs < z) & (z < ze)
    out = ~inside & (w > 0)

    # smallest positive t to any of the 6 box planes, from the previous section
    t = torch.full_like(x, float("inf"))
    for axis, (lo, hi) in enumerate(((xs, xe), (ys, ye), (zs, ze))):
        pc, sc = p_prev[:, axis], s[:, axis]
        ok = sc != 0
        # guard with 1.0 (not a tiny eps): 1/eps² overflows f32 in the backward
        den = torch.where(ok, sc, 1.0)
        for bound in (lo, hi):
            tb = (bound - pc) / den
            t = torch.where(ok & (tb > 0) & (tb < t), tb, t)
    t = torch.where(torch.isfinite(t), t, 0.0)

    p_box = p_prev + t[:, None] * s
    p_out = torch.where(out[:, None], p_box, p_new)
    w_out = torch.where(out, 0.0, w)
    return p_out, w_out, torch.count_nonzero(out)


def _refract(step: TraceStep, p_new, s, w, wl, pols, hit, no_pol, n=None):
    """Snell + Fresnel at a refracting surface; ``n``, the normals at
    ``p_new``, where the caller has them already."""
    if n is None:
        n = step.sfns.normal_fn(step.sfns.params, p_new[:, 0], p_new[:, 1])
    with span("trace_bundle.media"):
        n1, n2 = step.n1_fn(wl), step.n2_fn(wl)
    return _refract_core(n, n1, n2, s, w, pols, hit, no_pol)


def _refract_core(n, n1, n2, s, w, pols, hit, no_pol):
    """Snell + Fresnel given per-ray normals and indices."""
    ns = rdot(n, s)                      # cos(alpha)
    # grazing incidence: T → 0 physically, but the f32 evaluation is 0/0
    # (every factor carries cos(alpha)); take the limit explicitly
    graze = ns < 1e-6
    ns_safe = torch.where(graze, 1.0, ns)
    Nq = n1 / n2
    W2 = 1.0 - Nq * Nq * (1.0 - ns * ns)
    tir = W2 < 0.0
    # grad-safe sqrt: push the argument away from 0 before the sqrt
    W = torch.sqrt(torch.where(tir, 1.0, W2))
    W = torch.where(tir, 0.0, W)           # cos(beta)
    s_ = s * Nq[:, None] - n * (Nq * ns - W)[:, None]

    upd = hit & ~tir
    A_ts, A_tp, pols_new = _compute_polarization(s, s_, pols, upd, no_pol)

    n1ca = n1 * ns_safe
    n2cb = n2 * W
    ts = 2.0 * n1ca / (n1ca + n2cb)
    tp = 2.0 * n1ca / (n2 * ns_safe + n1 * W)
    T = n2cb / n1ca * ((A_ts * ts) ** 2 + (A_tp * tp) ** 2)
    T = torch.where(tir | graze, 0.0, T)

    w_new = torch.where(hit, w * T, w)
    s_new = torch.where(upd[:, None], s_, s)
    return s_new, w_new, pols_new, torch.count_nonzero(tir & hit)


def _refract_ideal(step: TraceStep, p_new, s, pols, hit, no_pol):
    """Ideal-lens refraction: focuses to the paraxial image plane without
    aberrations. f in mm = 1000/D[dpt]; ``D`` may be a 0-dim tensor that
    needs a gradient."""
    f = 1000.0 / step.D
    fsz = f / s[:, 2]
    sx = s[:, 0] * fsz - p_new[:, 0]
    sy = s[:, 1] * fsz - p_new[:, 1]
    s_ = torch.stack([sx, sy, torch.zeros_like(sx) + f], dim=-1)
    sign = torch.sign(f) if isinstance(f, torch.Tensor) else math.copysign(1.0, f)
    s_ = normalize_safe(s_) * sign

    _, _, pols_new = _compute_polarization(s, s_, pols, hit, no_pol)
    s_new = torch.where(hit[:, None], s_, s)
    return s_new, pols_new


def _hurb_normals(gen, N: int, device, dtype):
    """The two standard normals a ray that a HURB step consumes: one draw
    for the tangent direction ``a``, then one for ``b``. The HURB steps of
    a trace draw one after the other in step order."""
    return (torch.randn(N, generator=gen, device=device, dtype=dtype),
            torch.randn(N, generator=gen, device=device, dtype=dtype))


def _hurb(step: TraceStep, normals, p_new, s, w, wl, n_amb, pols, bend_candidates, no_pol,
          factor: float = HURB_FACTOR):
    """Heisenberg-uncertainty ray bending at a Ring/Slit aperture opening:
    tangent-direction Gaussian perturbation with
    tanσ = HURB_FACTOR/(2·a·cosψ·k). A pure function of ``normals``, the
    pair of standard-normal tensors from :func:`_hurb_normals`."""
    params = step.sfns.params
    x, y = p_new[:, 0], p_new[:, 1]
    zero = torch.zeros_like(x)

    if step.hurb_kind == "ring":
        R = params["ri"]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(y, x)
        b_ = R - r
        a_ = torch.sqrt(torch.clamp(b_ * R, min=0.0))
        b_vec = torch.stack([torch.cos(theta), torch.sin(theta), zero], dim=-1)
        inside = r < R
    else:   # slit
        ang = params["angle"]
        c, sn = torch.cos(ang), torch.sin(ang)
        x_, y_ = x * c + y * sn, -x * sn + y * c
        a_ = params["hhi"] - torch.abs(y_)
        b_ = params["hwi"] - torch.abs(x_)
        inside = (a_ > 0) & (b_ > 0)
        b_vec = torch.stack([c * torch.ones_like(x), sn * torch.ones_like(x), zero], dim=-1)

    bend = bend_candidates & inside

    a_vec = torch.stack([-b_vec[:, 1], b_vec[:, 0], zero], dim=-1)
    cpa2 = 1.0 - rdot(s, a_vec) ** 2
    cpb2 = 1.0 - rdot(s, b_vec) ** 2
    cos_psi_a = torch.sqrt(torch.where(cpa2 > 1e-12, cpa2, 1e-12))
    cos_psi_b = torch.sqrt(torch.where(cpb2 > 1e-12, cpb2, 1e-12))

    k = 2.0 * math.pi * n_amb / (wl * 1e-9)
    safe_a = torch.where(a_ > 0, a_, 1.0)
    safe_b = torch.where(b_ > 0, b_, 1.0)
    tan_sig_a = factor / (2.0 * safe_a * cos_psi_a * 1e-3 * k)
    tan_sig_b = factor / (2.0 * safe_b * cos_psi_b * 1e-3 * k)

    tan_tha = normals[0] * torch.abs(tan_sig_a)
    tan_thb = normals[1] * torch.abs(tan_sig_b)

    sa_dir = normalize_safe(cross(b_vec, s))
    sb_dir = cross(s, sa_dir)
    sab = s + sa_dir * tan_tha[:, None] + sb_dir * tan_thb[:, None]
    s_new = torch.where(bend[:, None], normalize_safe(sab), s)

    neg = (s_new[:, 2] < 0) & bend
    w_new = torch.where(neg, 0.0, w)

    _, _, pols_new = _compute_polarization(s, s_new, pols, bend, no_pol)
    return s_new, w_new, pols_new, torch.count_nonzero(neg)


# ----------------------------------------------------------------------
# runs: consecutive steps that the run kernel holds collapse into ONE call
# of ops.cuda_run.conic_run (one kernel launch on a CUDA device). Steps of
# another kind (ideal lenses, filters, apertures with HURB), the cheap planar
# steps unless cuda_fuse_planar asks for them, and steps consumed by a
# streaming sink stay unrolled; real systems are dominated by conic runs.

MIN_RUN = 4     # shortest run worth a launch of its own


def _normalize_sinks(sinks):
    """Sink entries are (fn, init) or (fn, init, seg_mask); normalize to
    triples. ``seg_mask=None`` means the sink may consume ANY segment,
    which keeps every step unrolled."""
    if not sinks:
        return []
    return [(e[0], e[1], e[2] if len(e) > 2 else None) for e in sinks]


def _frame_chain(steps, dtype):
    """Host-side local-frame origin chain: per step (pos_h f64, applied
    delta in the trace dtype, applied origin f64). Shared by the unrolled
    steps and the runs so both apply bit-identical frame shifts.
    ``dtype`` is a numpy dtype. The vertex is the f64 ``pos_host`` while
    ``params["pos"]`` is its rounding, else the position that the
    parameters hold: a moved surface moves its frame on every route."""
    prev = np.zeros(3, dtype=np.float64)
    chain = []
    for step in steps:
        pos_p = host_values(step.sfns)["pos"]
        if step.pos_host is not None and np.array_equal(
                np.asarray(step.pos_host, dtype=pos_p.dtype), pos_p):
            pos_h = np.asarray(step.pos_host, dtype=np.float64)
        else:
            pos_h = np.asarray(pos_p, dtype=np.float64)
        delta = np.asarray(pos_h - prev, dtype=dtype)
        prev = prev + np.asarray(delta, dtype=np.float64)
        chain.append((pos_h, delta, prev.copy()))
    return chain


def _run_step(st: TraceStep, use_hurb: bool = False) -> bool:
    """THE predicate for what a run may hold; every decision about the
    partition goes through it. Refractions on flat discs, conics and even
    aspheres always join a run (the unrolled asphere step is 40 iterations
    of eager tensor operations). The cheap planar steps, refractions on
    tilted planes and aperture absorbers without HURB, join only when
    ``global_options.cuda_fuse_planar`` is set. Every other step stays
    unrolled."""
    from ..utils.global_options import global_options
    kind = st.sfns.kind
    if st.action == "refract":
        if kind in ("conic", "circle", "flat", "asphere"):
            return True
        return kind == "tilted" and global_options.cuda_fuse_planar
    if st.action == "absorb":
        return (global_options.cuda_fuse_planar and kind in ABSORB_KINDS
                and not (use_hurb and st.hurb))
    return False


def _partition_runs(steps, sink_masks, use_hurb: bool = False):
    """Split the step list into per-step segments and runs
    (("step", [i]) / ("run", [i..j]) entries). A step whose segment a sink
    consumes is never part of a run. Absorbers earn their place only
    INSIDE a run, where they join two groups of refractions into one
    launch; at the edges of a run they are trimmed back out."""
    def runnable(i):
        if not _run_step(steps[i], use_hurb):
            return False
        for m in sink_masks:
            if m is None or (i < len(m) and m[i]):
                return False
        return True

    runs, i = [], 0
    while i < len(steps):
        if runnable(i):
            j = i
            while j < len(steps) and runnable(j):
                j += 1
            idxs = list(range(i, j))
            while idxs and steps[idxs[0]].action == "absorb":
                runs.append(("step", [idxs.pop(0)]))
            tail = []
            while idxs and steps[idxs[-1]].action == "absorb":
                tail.append(("step", [idxs.pop()]))
            if len(idxs) >= MIN_RUN:
                runs.append(("run", idxs))
            else:
                runs.extend(("step", [k]) for k in idxs)
            runs.extend(reversed(tail))
            i = j
            continue
        runs.append(("step", [i]))
        i += 1
    return runs


def _ambient_chain(steps, n0_fn):
    """Per step, the ambient medium fn a ray is in when REACHING it (the
    n2 chain of the preceding refract steps; absorbers leave the ambient
    unchanged): the n that an absorber's stored section reports."""
    out, cur = [], n0_fn
    for st in steps:
        out.append(cur)
        if st.action in ("refract", "ideal"):
            cur = st.n2_fn
    return out


def _media_rows(steps, run_idxs, amb_fn_at=None):
    """Unique media (by object identity) across all steps of the runs.
    Returns (media_fns, pairs) with pairs[step_idx] = (n1_row, n2_row);
    an absorb step maps both rows to the ambient medium around it, which
    the kernel never reads and the stored ``n`` section reports."""
    media, rows, pairs = [], {}, {}

    def row(fn):
        k = id(fn)
        if k not in rows:
            rows[k] = len(media)
            media.append(fn)
        return rows[k]

    for i in run_idxs:
        if steps[i].action == "absorb":
            r = row(amb_fn_at[i])
            pairs[i] = (r, r)
        else:
            pairs[i] = (row(steps[i].n1_fn), row(steps[i].n2_fn))
    return media, pairs


def _tracks_grad(t) -> bool:
    """Whether a derivative flows through ``t``: autograd records it (it
    requires a gradient and grad mode is on) or it carries a forward-mode
    tangent."""
    return (t.requires_grad and torch.is_grad_enabled()) \
        or fwAD.unpack_dual(t).tangent is not None


def _run_needs_plain(steps, idxs, p, s, w, pols, n_tab, no_pol) -> bool:
    """Whether a run must take the plain PyTorch loop although its tensors
    may lie on a CUDA device: the kernel holds f32 state and has no
    derivative, so f64 state and every operand or surface parameter that
    a derivative flows through keep the plain loop (under
    ``torch.no_grad()`` autograd records nothing, and the kernel runs).
    ``cuda_trace=False`` selects the plain loop for comparison."""
    from ..utils.global_options import global_options
    if not global_options.cuda_trace or p.dtype != torch.float32:
        return True
    return _run_tracks_grad(steps, idxs, p, s, w, pols, n_tab, no_pol)


def _run_tracks_grad(steps, idxs, p, s, w, pols, n_tab, no_pol) -> bool:
    """Whether a derivative flows through a run: through an operand or a
    surface parameter of one of its steps."""
    operands = [p, s, w, n_tab] + ([] if no_pol else [pols])
    if any(t is not None and _tracks_grad(t) for t in operands):
        return True
    return any(_tracks_grad(v) for i in idxs for v in steps[i].sfns.params.values())


def _run_steps(steps, idxs, chain, outline64):
    """The per-step constant dicts of a run (python floats), from the
    values that the steps' parameters hold."""
    out = []
    for i in idxs:
        st = steps[i]
        h = host_values(st.sfns)
        kind = st.sfns.kind
        pos_h, delta, origin = chain[i]
        c = dict(
            kind=kind, is_flat=bool(st.sfns.is_flat), action=st.action,
            rho=float(h.get("rho", 1.0)), k=float(h.get("k", 0.0)),
            r=float(h.get("r", 1.0)),
            z_min=float(h.get("z_min_rel", 0.0)), z_max=float(h.get("z_max_rel", 0.0)),
            dx=float(delta[0]), dy=float(delta[1]), dz=float(delta[2]),
            ox=float(origin[0]), oy=float(origin[1]), oz=float(origin[2]),
            out=tuple(float(outline64[q] - origin[q // 2]) for q in range(6)))
        if kind == "asphere":
            c["coeff"] = tuple(float(v) for v in np.atleast_1d(h["coeff"]))
        elif kind == "tilted":
            c["tn"] = tuple(float(v) for v in h["normal"])
        if st.action == "absorb":
            # aperture-mask shape of a fused absorber ("circle" otherwise)
            c["mask"] = kind if kind in ("ring", "rect", "slit") else "circle"
            c.update({key: float(h[key]) for key in ("ri", "hw", "hh", "hwi", "hhi", "angle")
                      if key in h})
        out.append(c)
    return out


def _pos_residuals(steps, chain):
    """Per step, ``params["pos"]`` minus the static vertex of the frame
    chain where the position needs a gradient (0 in value; the frame shift
    itself is a constant), else None."""
    out = []
    for st, (pos_h, _, _) in zip(steps, chain):
        pp = st.sfns.params["pos"]
        out.append(pp - torch.as_tensor(pos_h, dtype=pp.dtype, device=pp.device)
                   if _tracks_grad(pp) else None)
    return out


def _frame_residual(res, i):
    """The residual shift that step ``i`` applies on top of its frame delta:
    its own position residual less the previous step's, so that the ray
    state stays relative to the vertex that the parameters describe (a lens
    whose two surfaces move together keeps its inner frame). None if both
    are."""
    r, r_prev = res[i], res[i - 1] if i else None
    if r is None and r_prev is None:
        return None
    return (r if r is not None else 0.0) - (r_prev if r_prev is not None else 0.0)


def _run_differentiable_steps(steps, idxs, chain, consts, residuals=None):
    """For the gradient path: put the surface parameters that a derivative
    flows through (:func:`_tracks_grad`) back into the constant dicts as
    tensors, so that the plain loop differentiates through them. A position
    enters as the residual shift of :func:`_frame_residual` (``dpos``), the
    residual of the step's own vertex for its stored section (``rpos``) and
    the outline box moved by it. ``residuals`` are those of
    :func:`_pos_residuals`."""
    res = _pos_residuals(steps, chain) if residuals is None else residuals
    for c, i in zip(consts, idxs):
        pr = steps[i].sfns.params
        for key, name in (("rho", "rho"), ("k", "k"), ("r", "r"),
                          ("z_min", "z_min_rel"), ("z_max", "z_max_rel"),
                          ("ri", "ri"), ("hw", "hw"), ("hh", "hh"), ("hwi", "hwi"),
                          ("hhi", "hhi"), ("angle", "angle")):
            if name in pr and _tracks_grad(pr[name]):
                c[key] = pr[name]
        if "coeff" in c and _tracks_grad(pr["coeff"]):
            c["coeff"] = tuple(pr["coeff"][q] for q in range(len(c["coeff"])))
        if "tn" in c and _tracks_grad(pr["normal"]):
            c["tn"] = tuple(pr["normal"][q] for q in range(3))
        shift = _frame_residual(res, i)
        if shift is not None:
            c["dpos"] = shift
        if res[i] is not None:
            c["rpos"] = res[i]
            c["out"] = tuple(c["out"][q] - res[i][q // 2] for q in range(6))
    return consts


class RunPlans:
    """The prepared runs (``ops/cuda_run.py:PreparedRun``) of ONE step list.

    The step table of a run depends on the compiled steps, the frame chain
    and the outline, not on the rays, so it is built once where the runs
    are partitioned and kept here for every later bundle. The rule that
    makes a prepared run stale: new steps. Whoever builds a step list
    (``Raytracer._build_steps``, ``make_fused_render``) makes a new
    ``RunPlans`` with it; :func:`trace_bundle` refuses one that was made
    for another list. The object holds its step list, so the identity that
    it checks cannot pass to another list while it lives. Within one list a
    plan is keyed by what else its constants depend on: the steps of the
    run (the partition changes with the sinks and with
    ``cuda_fuse_planar``), the media row pairs and the outline; the frame
    chain is always the f32 one, since f64 state takes the plain loop."""

    def __init__(self, steps):
        self.steps = steps
        self._plans = {}
        self._frames = {}

    def get(self, steps, idxs, chain, outline64, med_idx) -> PreparedRun:
        if steps is not self.steps:
            raise ValueError("these RunPlans were made for another step list: new steps need "
                             "new plans")
        key = (tuple(idxs), tuple(med_idx), tuple(float(v) for v in outline64))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = PreparedRun(_run_steps(steps, idxs, chain, outline64), med_idx)
        return plan

    def frame(self, idx, chain, dtype, device):
        """The frame shift (None where it is 0) and the applied origin of
        the unrolled step ``idx`` as ``dtype`` tensors on ``device``: made
        at the first bundle and kept, so that a later bundle copies nothing
        from the host (keyed by the chain's values as well)."""
        _, delta, origin = chain[idx]
        key = (idx, dtype, str(device), delta.tobytes(), origin.tobytes())
        got = self._frames.get(key)
        if got is None:
            got = self._frames[key] = (
                torch.as_tensor(delta, dtype=dtype, device=device) if np.any(delta) else None,
                torch.as_tensor(origin, dtype=dtype, device=device))
        return got

    def __len__(self):
        return len(self._plans)


class _Sections:
    """The stored sections of one bundle, section k at column k.

    They are written in place: the buffers p (N, nt, 3), w and n (N, nt)
    and pol (N, nt, 3; None under no_pol) are made once, stored section by
    section (``section_buffer``: column k is one contiguous block); section
    0 and every unrolled step's section are copied into their columns, and
    a run's sections go straight there from the run (:meth:`slots`). From
    the first section or run that a derivative flows through on, the
    sections are kept as tensors of their own and stacked at the end
    (:meth:`to_lists`; the columns written until then become the first of
    them), so that autograd and forward mode see the operations that they
    always saw."""

    def __init__(self, nt, p, w, pols, n, no_pol):
        """Section 0 is ``p, w, pols, n`` (the source's rays), whose dtypes
        the buffers take."""
        def buf(t, *tail):
            return section_buffer(t.shape[0], nt, *tail, dtype=t.dtype, device=t.device)
        self.no_pol, self.in_place, self.filled = no_pol, True, 0
        self.p, self.w, self.n = buf(p, 3), buf(w), buf(n)
        self.pol = None if no_pol else buf(pols, 3)
        self._written_p = None          # the column that absolute() wrote last
        self.put(0, p, w, pols, n)

    def to_lists(self):
        """Keep every later section as a tensor of its own: the columns
        written so far become the first entries of the lists."""
        if not self.in_place:
            return
        cols = range(self.filled)
        self.p, self.w, self.n = ([t[:, k] for k in cols] for t in (self.p, self.w, self.n))
        self.pol = [None] * self.filled if self.no_pol else [self.pol[:, k] for k in cols]
        self.in_place = False

    def absolute(self, k, p, off):
        """``p + off``, the absolute positions of section k, written into
        its column where the sections are written in place."""
        if self.in_place and not (_tracks_grad(p) or _tracks_grad(off)):
            self._written_p = torch.add(p, off, out=self.p[:, k])
            return self._written_p
        return p + off

    def put(self, k, p, w, pol, n):
        """Section k (its positions as :meth:`absolute` gave them)."""
        if self.in_place and any(t is not None and _tracks_grad(t) for t in (p, w, pol, n)):
            self.to_lists()
        if not self.in_place:
            self.p.append(p)
            self.w.append(w)
            self.pol.append(pol)
            self.n.append(n)
            return
        if p is not self._written_p:
            self.p[:, k].copy_(p)
        self.w[:, k].copy_(w)
        self.n[:, k].copy_(n)
        if not self.no_pol:
            self.pol[:, k].copy_(pol)
        self.filled = k + 1

    def slots(self, col0, L):
        """Where a run of ``L`` steps whose first section is column
        ``col0`` writes its sections, or None where they are stacked."""
        if not self.in_place:
            return None
        self.filled = col0 + L
        return SectionSlots(self.p, self.w, self.n, self.pol, col0)

    def extend(self, ys_p, ys_w, ys_pol, n_rows, pols):
        """A run's (L, N, ...) sections, where they are stacked."""
        L = ys_p.shape[0]
        self.p.extend(ys_p[i] for i in range(L))
        self.w.extend(ys_w[i] for i in range(L))
        # pol untouched under no_pol: reuse the source tensor
        self.pol.extend([pols] * L if self.no_pol else (ys_pol[i] for i in range(L)))
        self.n.extend(n_rows)

    def result(self) -> dict:
        if self.in_place:
            return dict(p=self.p, w=self.w, pol=self.pol, n=self.n)
        return {
            "p": torch.stack(self.p, dim=1),
            "w": torch.stack(self.w, dim=1),
            # under no_pol the polarization is never touched: skip the
            # (N, nt, 3) NaN stack entirely (RayStorage broadcasts host-side)
            "pol": None if self.no_pol else torch.stack(self.pol, dim=1),
            "n": torch.stack(self.n, dim=1),
        }


def _conic_run_dispatch(steps, idxs, chain, outline64, n_tab, pairs,
                        p, s, w, pols, no_pol, store_sections, plans, residuals, out=None):
    """Call one run (kernel or plain loop) with its per-step constants and
    media row pairs, and shape its outputs for :func:`trace_bundle`. The
    kernel's run comes prepared from ``plans``; the gradient and f64 path
    builds its constant dicts anew, since they may hold tensors. ``out``:
    the :class:`SectionSlots` that the run writes its sections into (its
    returned sections are then None)."""
    med_idx = [pairs[i] for i in idxs]
    pol_in = None if no_pol else pols
    if _run_needs_plain(steps, idxs, p, s, w, pols, n_tab, no_pol):
        consts = _run_steps(steps, idxs, chain, outline64)
        consts = _run_differentiable_steps(steps, idxs, chain, consts, residuals)
        (p2, s2, w2, pols2), (counts, ys_p, ys_w, ys_pol) = conic_run_reference(
            p, s, w, n_tab, med_idx, consts, pol=pol_in, store=store_sections, out=out)
    else:
        plan = plans.get(steps, idxs, chain, outline64, med_idx)
        (p2, s2, w2, pols2), (counts, ys_p, ys_w, ys_pol) = conic_run(
            p, s, w, n_tab, plan.med_idx, plan.steps, pol=pol_in, store=store_sections,
            plan=plan, out=out)
    if no_pol:
        pols2 = pols

    # per-step (N_INFOS,) rows from the run's (L, 4) counters
    run_infos = torch.zeros((len(idxs), N_INFOS), dtype=torch.int32, device=p.device)
    run_infos[:, ABSORB_MISSING] = counts[:, 0]
    run_infos[:, TIR] = counts[:, 1]
    run_infos[:, OUTLINE_INTERSECTION] = counts[:, 2]
    run_infos[:, ILL_COND] = counts[:, 3]
    return p2, s2, w2, pols2, run_infos, ys_p, ys_w, ys_pol


# ----------------------------------------------------------------------
# the trace

def trace_bundle(steps: list, n0_fn: Callable, outline,
                 p, s, pols, w, wl, no_pol: bool,
                 use_hurb: bool = False, gen=None,
                 sinks: list = None, store_sections: bool = True,
                 hurb_factor: float = HURB_FACTOR, plans: "RunPlans" = None):
    """Trace a ray bundle through the step list, on the device of ``p``.

    :param steps: list[TraceStep] including the implicit end absorber
    :param n0_fn: ambient index wl -> n
    :param outline: 6-element outline box
    :param p, s, pols, w, wl: initial ray state from the sources
    :param gen: ``torch.Generator`` on the device of ``p`` that the HURB
        steps draw their normals from (:func:`_hurb_normals`); without one,
        a generator seeded with 0 is made
    :param sinks: optional list of (update_fn, init_carry) or
        (update_fn, init_carry, seg_mask) streaming consumers. After each
        step, ``carry = update_fn(j, p_prev, p_new, w_prev, carry)`` is
        called with the segment index j (= step index) and the ray weight
        *at the segment start*. This is how the fused render observes
        detector crossings without section storage. ``seg_mask`` is the
        sink's static per-segment relevance list; steps whose segment no
        sink consumes are eligible for a run.
    :param store_sections: when False, per-section arrays are not
        accumulated — the returned dict carries only the final ray state,
        wl, INFOS and the sink carries, keeping device memory at O(N)
        regardless of surface count (the megabatch render path).
    :param plans: the :class:`RunPlans` of ``steps``, for a caller that
        traces bundle after bundle through the same steps; without them the
        runs are prepared anew at every call
    :return: dict with the per-section arrays p (N, nt, 3), w (N, nt),
             pol (N, nt, 3) or None, n (N, nt) (if store_sections) and the
             INFOS counter matrix (N_INFOS, nt) — nt = len(steps) + 1
             sections — plus "sinks": final sink carries. The sections
             are written in place into those arrays (a run's by the run
             itself) until a derivative flows, and stacked from there on
             (:class:`_Sections`).
    """
    for st in steps:
        if st.action not in ("refract", "ideal", "filter", "absorb"):
            raise RuntimeError(f"unknown action {st.action}")

    dev = p.device
    if gen is None and use_hurb and any(st.hurb for st in steps):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    np_dtype = np.float64 if p.dtype == torch.float64 else np.float32
    with span("trace_bundle.media"):
        n_amb_last = n0_fn(wl)
    sections = None
    if store_sections:
        sections = _Sections(len(steps) + 1, p, w, pols, n_amb_last, no_pol)
    infos = [torch.zeros((N_INFOS,), dtype=torch.int32, device=dev)]
    sink_list = _normalize_sinks(sinks)
    carries = [init for _, init, _ in sink_list]
    outline64 = np.asarray(outline, dtype=np.float64)
    # local-frame re-centering chain: shift the ray state into the frame
    # of each surface's vertex, tracking the APPLIED cumulative origin so
    # f32 position rounding stays O(eps·(gap+aperture)) instead of
    # O(eps·|z_absolute|) — see TraceStep.pos_host
    chain = _frame_chain(steps, np_dtype)
    runs = _partition_runs(steps, [m for _, _, m in sink_list], use_hurb)
    residuals = _pos_residuals(steps, chain)
    if plans is None:
        plans = RunPlans(steps)

    # shared media table for the runs: one (M, N) row per unique medium
    run_idxs_all = [i for kind, idxs in runs if kind == "run" for i in idxs]
    n_tab = None
    if run_idxs_all:
        media, pairs = _media_rows(steps, run_idxs_all, _ambient_chain(steps, n0_fn))
        with span("trace_bundle.media"):
            n_tab = torch.stack([m(wl) for m in media])

    for run_kind, run_idxs in runs:
        if run_kind == "run":
            # section k + 1 follows step k
            slots = None
            if store_sections:
                if _run_tracks_grad(steps, run_idxs, p, s, w, pols, n_tab, no_pol):
                    sections.to_lists()
                slots = sections.slots(run_idxs[0] + 1, len(run_idxs))
            with span("trace_bundle.run"):
                (p, s, w, pols, run_infos, run_p, run_w,
                 run_pol) = _conic_run_dispatch(
                    steps, run_idxs, chain, outline64, n_tab, pairs,
                    p, s, w, pols, no_pol, store_sections, plans, residuals, out=slots)
            L = len(run_idxs)
            infos.extend(run_infos[i] for i in range(L))
            if store_sections and slots is None:
                sections.extend(run_p, run_w, run_pol, [n_tab[pairs[i][1]] for i in run_idxs], pols)
            n_amb_last = n_tab[pairs[run_idxs[-1]][1]]
            continue

        idx = run_idxs[0]
        step = steps[idx]
        info = torch.zeros((N_INFOS,), dtype=torch.int32, device=dev)
        hw = w > 0.0

        _, _, origin = chain[idx]
        delta_t, origin_t = plans.frame(idx, chain, p.dtype, dev)
        if delta_t is not None:
            p = p - delta_t
        # residuals of the position parameters (exactly 0 in the forward
        # pass): keep d(image)/d(surface position) flowing although the
        # frame shift itself is a constant
        shift, res = _frame_residual(residuals, idx), residuals[idx]
        if shift is not None:
            p = p - shift
        out_rel = tuple(float(outline64[i] - origin[i // 2]) for i in range(6))
        if res is not None:
            out_rel = tuple(out_rel[i] - res[i // 2] for i in range(6))

        p_prev = p
        w_prev = w

        # a function or data surface's hit solve, mask and normals: the
        # generic step, timed on the device as one interval while a profiler
        # records (a capture keeps the interval's events as graph nodes)
        generic = step.sfns.kind == "generic"
        normals = None
        with span("trace_bundle.step"), (device_interval("trace_bundle.generic", dev) if generic
                                         else contextlib.nullcontext()):
            p, hit, ill, _ = _surface_hit(step, p, s, hw)
            if generic and step.action == "refract":
                normals = step.sfns.normal_fn(step.sfns.params, p[:, 0], p[:, 1])
        info[ILL_COND] += torch.count_nonzero(ill)

        if step.action == "refract":
            # rays missing the surface are absorbed; the clamped position
            # stays
            miss = hw & ~hit
            w = torch.where(miss, 0.0, w)
            info[ABSORB_MISSING] += torch.count_nonzero(miss)
            with span("trace_bundle.step"):
                s, w, pols, n_tir = _refract(step, p, s, w, wl, pols, hit, no_pol, normals)
            info[TIR] += n_tir
            with span("trace_bundle.media"):
                n_after = step.n2_fn(wl)
        elif step.action == "ideal":
            miss = hw & ~hit
            w = torch.where(miss, 0.0, w)
            info[ABSORB_MISSING] += torch.count_nonzero(miss)
            with span("trace_bundle.step"):
                s, pols = _refract_ideal(step, p, s, pols, hit, no_pol)
            with span("trace_bundle.media"):
                n_after = step.n2_fn(wl)
        elif step.action == "filter":
            w = torch.where(hit, w * step.spectrum_fn(wl), w)
            n_after = n_amb_last
        else:   # absorb
            w = torch.where(hit, 0.0, w)
            if use_hurb and step.hurb:
                normals = _hurb_normals(gen, p.shape[0], dev, p.dtype)
                with span("trace_bundle.step"):
                    s, w, pols, n_neg = _hurb(step, normals, p, s, w, wl, n_amb_last, pols, hw & ~hit,
                                              no_pol, hurb_factor)
                info[HURB_NEG_DIR] += n_neg
            n_after = n_amb_last

        with span("trace_bundle.step"):
            p, w, n_out = _outline_intersection(p_prev, p, s, w, out_rel)
        info[OUTLINE_INTERSECTION] += n_out

        if sink_list or store_sections:
            # sections and sinks see absolute coordinates (single rounding
            # at output, does not feed back into the trace state); rebase
            # from the APPLIED origin, the frame p actually lives in
            off = origin_t
            if res is not None:
                off = off + res
            p_abs = sections.absolute(idx + 1, p, off) if store_sections else p + off
            if sink_list:
                p_prev_abs = p_prev + off
                carries = [fn(idx, p_prev_abs, p_abs, w_prev, c)
                           for (fn, _, _), c in zip(sink_list, carries)]

        n_amb_last = n_after
        infos.append(info)
        if store_sections:
            sections.put(idx + 1, p_abs, w, pols, n_after)

    out = {
        "wl": wl,
        "infos": torch.stack(infos, dim=1),   # (N_INFOS, nt)
        "sinks": carries,
        "state": (p, s, pols, w),
    }
    if store_sections:
        out |= sections.result()
    return out
