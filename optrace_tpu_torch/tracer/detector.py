"""Detector intersection search over ray sections.

Counterpart of ``optrace_tpu/tracer/detector.py``: every ray tests each of
its nt−1 section segments against the detector surface; the first segment
whose hit lies before the next stored section wins.

Two entry points share the same per-segment function:

- :func:`detector_hits` walks *stored* sections (N, nt, 3);
- :func:`segment_update` is the streaming form used as a trace sink by
  the fused render (optrace_tpu_torch/parallel/render.py): the segment
  between consecutive trace states is tested while the trace is still
  running, so no (N, nt, 3) section tensor ever materializes.
"""

import math

import torch

from ..ops import geom
from .scene_compile import SurfaceFns


def build_segment_mask(section_z_bounds: list, det_zmin: float, det_zmax: float) -> list:
    """Static per-segment relevance: segment j (between stored sections j
    and j+1) can contain a detector hit only if the detector z-range
    overlaps [section_j.z_min, section_{j+1}.z_max]."""
    eps = 1e-3
    mask = []
    for j in range(len(section_z_bounds) - 1):
        lo = section_z_bounds[j][0] - eps
        hi = section_z_bounds[j + 1][1] + eps
        mask.append(det_zmin <= hi and det_zmax >= lo)
    if not any(mask):
        mask = [True] * (len(section_z_bounds) - 1)
    return mask


def init_hit_carry(Nr: int, device, dtype=torch.float32):
    """Fresh accumulator for the segment walk: (ph, wsel, is_hit, done, n_ill)."""
    return (torch.zeros((Nr, 3), dtype=dtype, device=device),
            torch.zeros((Nr,), dtype=dtype, device=device),
            torch.zeros((Nr,), dtype=torch.bool, device=device),
            torch.zeros((Nr,), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def segment_update(sfns: SurfaceFns, det_zmin: float, pj, pj1, wj, carry):
    """Test one ray segment (section j → j+1) against the detector.

    :param pj, pj1: segment start/end positions (N, 3)
    :param wj: ray weight at the segment start (N,)
    :param carry: accumulator from :func:`init_hit_carry`
    :return: updated carry
    """
    ph, wsel, is_hit, done, n_ill = carry

    seg = pj1 - pj
    l2 = torch.sum(seg * seg, dim=-1, keepdim=True)
    moving2 = l2 > 0
    slen = torch.sqrt(torch.where(moving2, l2, 1.0))
    sj = torch.where(moving2, seg / slen, 0.0)

    o = pj - sfns.params["pos"]
    t, valid, ill = sfns.hit_fn(sfns.params, o, sj)
    t2, ok, _ = geom.clamp_abnormal(o, sj, t, valid, sfns.params["z_max_rel"])
    cand = pj + t2[:, None] * sj
    rel = cand - sfns.params["pos"]
    mask_hit = sfns.mask_fn(sfns.params, rel[:, 0], rel[:, 1]) & ok

    reach = pj1[:, 2] >= det_zmin - geom.C_EPS
    before_next = cand[:, 2] <= pj1[:, 2] + geom.C_EPS
    accept = ~done & reach & before_next & moving2[:, 0] & torch.isfinite(t2)

    ph = torch.where(accept[:, None], cand, ph)
    wsel = torch.where(accept, wj, wsel)
    is_hit = torch.where(accept, mask_hit, is_hit)
    n_ill = n_ill + torch.count_nonzero(ill & accept).to(torch.int32)
    done = done | accept
    return ph, wsel, is_hit, done, n_ill


def detector_hits(sfns: SurfaceFns, det_zmin: float, p_all, w_all,
                  segment_mask: list = None):
    """Find detector intersections for all rays from stored sections.

    :param sfns: compiled detector surface
    :param det_zmin: detector z-extent minimum (first-reach criterion)
    :param p_all: stored positions (N, nt, 3)
    :param w_all: stored weights (N, nt)
    :param segment_mask: optional static per-segment booleans; segments
        whose section z-ranges cannot contain the detector are skipped
    :return: (ph (N,3), w_sel (N,), is_hit (N,), n_ill scalar)
    """
    nt = p_all.shape[1]
    carry = init_hit_carry(p_all.shape[0], p_all.device, p_all.dtype)
    for j in range(nt - 1):
        if segment_mask is None or segment_mask[j]:
            carry = segment_update(sfns, det_zmin, p_all[:, j], p_all[:, j + 1],
                                   w_all[:, j], carry)
    ph, wsel, is_hit, done, n_ill = carry
    return ph, wsel, is_hit & done, n_ill


def sphere_projection_xy(x, y, z, pos, R: float, method: str):
    """Tensor form of ``SphericalSurface.sphere_projection`` for binning on
    the device: hit coordinates on a sphere with vertex ``pos`` and
    curvature radius ``R`` to projected (x', y'), in the type of ``x``."""
    x0, y0, z0 = pos[0], pos[1], pos[2]
    zm = z0 + R
    sgn = math.copysign(1.0, R)
    if method is None or method == "Orthographic":
        return x, y
    if method == "Equidistant":
        r = torch.hypot(x - x0, y - y0)
        theta = -sgn * torch.arctan(r / (z - zm))
        phi = torch.atan2(y - y0, x - x0)
        return theta * torch.cos(phi), theta * torch.sin(phi)
    if method == "Stereographic":
        r = torch.hypot(x - x0, y - y0)
        theta = math.pi / 2 - torch.arctan(r / (z - zm))
        phi = torch.atan2(y - y0, x - x0)
        rp = -2.0 * sgn * torch.tan(math.pi / 4 - theta / 2)
        return rp * torch.cos(phi), rp * torch.sin(phi)
    if method == "Equal-Area":
        x_ = (x - x0) / abs(R)
        y_ = (y - y0) / abs(R)
        z_ = (z - zm) / R
        f = torch.sqrt(2.0 / (1.0 - z_))
        return f * x_, f * y_
    raise ValueError(f"Invalid projection_method {method}.")
