"""Entry ``trace_read``: the interactive round trip, one operation being
``Raytracer.trace(rays)``, then ``Raytracer.detector_image()`` and
``RenderImage.get(mode, side)`` of that image, as a GUI retraces and reads
an image after every change. The traffic file gives ``rays``, ``no_pol``,
``mode`` and ``side``.

Judged: the window's last operation, whole. The program draws its rays
inside ``trace``, so the reference starts where the program's stored trace
starts, from its rays' first section (position, direction, polarization,
weight and wavelength), and works out all the rest again: every stored
section and the counters of absorbed rays, the detector's hits, the image
and its sRGB. The start itself is checked apart: every ray leaves the
configuration's object point with the source's power share, a unit
polarization across its direction, a direction and a wavelength whose
distributions are those the source states.
"""

import math

import numpy as np
import torch

from benchmark import reference, scene as bscene

TRACE_KEYS = ("p_list", "w_list", "pol_list", "n_list", "wl_list")


def setup(run):
    import optrace_tpu_torch as ot
    t = run.traffic
    RT = bscene.build(ot, run.config, run.seed, no_pol=bool(t["no_pol"]), device=run.device)
    state = dict(RT=RT)
    for _ in range(int(t["warm_ops"])):
        operation(run, state)
    return state


def operation(run, state):
    t = run.traffic
    RT = state["RT"]
    with run.span("raytracer.trace"):
        RT.trace(int(t["rays"]))
    with run.span("image.read"):
        img = RT.detector_image()
        rgb = img.get(t["mode"], int(t["side"]))
    state["img"], state["rgb"] = img, rgb
    return dict(rays=int(t["rays"]), image_shape=img.shape[:2])


def finish(run, state):
    """The last operation's stored trace, counters, image and sRGB, on the
    host; the program's state is dropped."""
    RT, img = state["RT"], state["img"]
    out = {k: np.array(getattr(RT.rays, k)) for k in TRACE_KEYS}
    out["counters"] = np.array(RT._msgs)
    out["image"] = img.data
    out["extent"] = tuple(float(v) for v in img.extent)
    out["srgb"] = np.array(state["rgb"].data)
    state.clear()
    return out


def _worst(t) -> float:
    """The largest of t, or inf where there is nothing to compare."""
    return float(t.max()) if t.numel() else math.inf


def _ks_uniform(u):
    """Kolmogorov-Smirnov distance of samples u from the uniform law on [0, 1]."""
    u, _ = torch.sort(u.double())
    n = u.shape[0]
    i = torch.arange(1, n + 1, dtype=torch.float64, device=u.device)
    return float(torch.maximum((i / n - u).abs().max(), (u - (i - 1) / n).abs().max()))


def start_numbers(run, scene, p0, s0, pol0, w0, wl) -> dict:
    """The program's start against what the source states."""
    cfg, src = run.config, run.config["ray_source"]
    N = p0.shape[0]
    pos = torch.as_tensor(reference.source_position(cfg, run.seed), dtype=torch.float64, device=p0.device)
    gap = max(float((p0 - pos).abs().max()) / float(src["distance"]),
              float((w0 * N / float(src["power"]) - 1).abs().max()))
    if pol0 is not None:
        gap = max(gap, float(((pol0 * pol0).sum(1).sqrt() - 1).abs().max()),
                  float((pol0 * s0).sum(1).abs().max()))
    axis = torch.as_tensor(src["conv_pos"], dtype=torch.float64, device=p0.device) - pos
    axis = axis / torch.linalg.norm(axis)
    half = math.radians(float(src["div_angle_deg"]))
    # the angle from the cone's axis, uniform in solid angle over
    # 1 - cos θ <= sin² Θ: (1 - cos θ) / sin² Θ = 2 sin²(θ/2) / sin² Θ
    u_theta = 2 * ((s0 - axis).norm(dim=1) / 2) ** 2 / math.sin(half) ** 2
    e1, e2 = reference._frame(axis.expand(N, 3))
    u_alpha = (torch.atan2((s0 * e2).sum(1), (s0 * e1).sum(1)) / (2 * math.pi)) % 1.0
    wl0, wl1 = scene.wl_range
    ks = max(_ks_uniform(u_theta), _ks_uniform(u_alpha), _ks_uniform((wl - wl0) / (wl1 - wl0)))
    return dict(start_gap=gap, start_ks=ks)


def judge(run, out) -> dict:
    dev = run.device
    f64 = dict(dtype=torch.float64, device=dev)
    scene = reference.Scene(run.config)
    P = torch.as_tensor(out["p_list"], **f64)
    W = torch.as_tensor(out["w_list"], **f64)
    POL = None if run.traffic["no_pol"] else torch.as_tensor(out["pol_list"], **f64)
    NN = torch.as_tensor(out["n_list"], **f64)
    WL = torch.as_tensor(out["wl_list"], **f64)
    N = P.shape[0]
    p0 = P[:, 0]
    s0 = P[:, 1] - p0
    s0 = s0 / torch.linalg.norm(s0, dim=1, keepdim=True)
    pol0 = None if POL is None else POL[:, 0]
    res = start_numbers(run, scene, p0, s0, pol0, W[:, 0], WL)

    with torch.no_grad():
        tr = reference.trace(scene, p0, s0, pol0, W[:, 0], WL)
    both = (W[:, 1:] > 0) & (tr["w"][:, 1:] > 0)
    res["section_gap_mm"] = _worst(((P[:, 1:] - tr["p"][:, 1:]).norm(dim=2))[both])
    res["weight_gap"] = _worst(((W[:, 1:] - tr["w"][:, 1:]).abs() / tr["w"][:, 1:])[both])
    res["index_gap"] = _worst((NN[:, 1:] - tr["n"][:, 1:]).abs()[both])
    if POL is not None:
        res["pol_gap"] = _worst(((POL[:, 1:] - tr["pol"][:, 1:]).norm(dim=2))[both])
    res["flip_share"] = float(((W > 0) != (tr["w"] > 0)).any(dim=1).double().mean())
    rows = [reference.ABSORB_MISSING, reference.TIR, reference.OUTLINE]
    C = torch.as_tensor(out["counters"], dtype=torch.int64, device=dev)
    res["counter_gap"] = float((C[rows] - tr["counters"][rows]).abs().sum()) / N
    del P, W, POL, NN

    x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
    hit = wh > 0
    ext = torch.as_tensor(out["extent"], **f64)
    size = max(float(ext[1] - ext[0]), float(ext[3] - ext[2]))
    if hit.any():
        ref_ext = torch.stack([x[hit].min(), x[hit].max(), y[hit].min(), y[hit].max()])
        res["extent_gap"] = float((ext - ref_ext).abs().max()) / size
    else:
        res["extent_gap"] = math.inf
    img = torch.as_tensor(out["image"], **f64)
    Ny, Nx = img.shape[:2]
    ref_img = reference.bin_xyzw(x, y, wh, WL, Nx, Ny, out["extent"])
    res["image_gap"] = float((img - ref_img).abs().sum() / ref_img.abs().sum().clamp(min=1e-300))
    f = 945 // int(run.traffic["side"])
    ref_rgb = reference.xyz_to_srgb_absolute(reference.block_mean(ref_img, f)[..., :3])
    rgb = torch.as_tensor(out["srgb"], **f64)
    res["srgb_gap"] = float((rgb - ref_rgb).abs().mean())
    return res


def control(run, dtype=torch.bfloat16) -> dict:
    """The outputs of the reference put in the program's place, in
    ``dtype``, from a seed of its own: what the check must refuse. The rays
    cross the long leg from the object in f64 and are traced on from just
    ahead of the lens in ``dtype``; their first section is the object
    point, in ``dtype`` too."""
    t = run.traffic
    scene = reference.Scene(run.config)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 7919)
    N = int(t["rays"])
    with torch.no_grad():
        p0, s, pol, w, wl = reference.sample_rays(scene, N, gen, run.seed, no_pol=bool(t["no_pol"]))
        p = reference.near_lens(scene, p0, s)
        p, s, w, wl = (a.to(dtype) for a in (p, s, w, wl))
        pol = None if pol is None else pol.to(dtype)
        tr = reference.trace(scene, p, s, pol, w, wl)
        tr["p"][:, 0] = p0.to(dtype)
        x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        hit = wh > 0
        if hit.any():
            ext = [float(v) for v in (x[hit].min(), x[hit].max(), y[hit].min(), y[hit].max())]
        else:       # nothing reached the detector: an empty image over the detector
            hx, hy = (v / 2 for v in run.config["detector"]["dim"])
            ext = [-hx, hx, -hy, hy]
        img = reference.bin_xyzw(x, y, wh, wl, 945, 945, ext, acc_dtype=torch.float32)
        rgb = reference.xyz_to_srgb_absolute(
            reference.block_mean(img.to(dtype), 945 // int(t["side"]))[..., :3])

    def host(a):
        return None if a is None else a.double().cpu().numpy()
    return dict(p_list=host(tr["p"]), w_list=host(tr["w"]), pol_list=host(tr["pol"]), n_list=host(tr["n"]),
                wl_list=host(wl), counters=tr["counters"].cpu().numpy(), image=host(img), extent=ext,
                srgb=host(rgb))
