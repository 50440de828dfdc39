"""Entry ``render_huge``: a user's "give me a clean image", one call of
``Raytracer.render_huge(rays, batch_size=batch, extent=...)`` an operation,
on a mesh over every rank of a sharded cell. The traffic file gives
``rays``, ``batch``, ``no_pol`` and the image's extent: ``extent`` as it
stands, or ``spot_half_mm``, a square of that half width around the spot,
as a user rendering a point spread function sets it.

Judged: the binned XYZW image of a call against the plain reference's
render of ``reference_rays`` rays of its own, drawn from the seed, on the
same grid. The program draws its rays inside the call, so only what does
not depend on the draw is compared: the power that reaches the image, the
shape of the image (the L1 distance of the two images, each over its own
power, in blocks of ``compare_block`` pixels where the traffic gives it),
its colour (X, Y and Z over W, in all and block by block) and, with
``compare_noise``, its noise. The cell's limits file names the numbers
that are compared.
"""

import math

import torch

from benchmark import reference, scene as bscene

SIDE = 945          # the program's grid for a square extent (RenderImage's largest side)
SPOT_RAYS = 20000   # the reference's rays that find the spot's centre


def image_extent(run) -> tuple:
    """The extent of the cell's image: the traffic's own, or a square of
    ``spot_half_mm`` around the power centroid of a short reference trace
    drawn from the seed (the seed draws the object point)."""
    t = run.traffic
    if "extent" in t:
        return tuple(float(v) for v in t["extent"])
    scene = reference.Scene(run.config)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 104729)
    with torch.no_grad():
        p, s, _, w, wl = reference.sample_rays(scene, SPOT_RAYS, gen, run.seed)
        tr = reference.trace(scene, p, s, None, w, wl, store=False)
        x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        cx, cy = float((x * wh).sum() / wh.sum()), float((y * wh).sum() / wh.sum())
    h = float(t["spot_half_mm"])
    return (cx - h, cx + h, cy - h, cy + h)


def setup(run):
    import optrace_tpu_torch as ot
    t = run.traffic
    RT = bscene.build(ot, run.config, run.seed, no_pol=bool(t["no_pol"]), device=run.device)
    state = dict(RT=RT, mesh=ot.default_mesh(device=run.device.type) if run.world > 1 else None, img=None,
                 extent=image_extent(run))
    for _ in range(int(t["warm_calls"])):
        operation(run, state)
    return state


def operation(run, state):
    t = run.traffic
    img = state["RT"].render_huge(int(t["rays"]), batch_size=int(t["batch"]), mesh=state["mesh"],
                                  extent=state["extent"])
    state["img"] = img
    return dict(rays=int(t["rays"]), batches=math.ceil(int(t["rays"]) / int(t["batch"])),
                image_shape=img.shape[:2])


def finish(run, state):
    """The last call's image, on the host; the program's state is dropped."""
    img = state.pop("img")
    state.clear()
    return dict(image=img.data, extent=tuple(float(v) for v in img.extent))


def numbers(P, R, block: int = 1, hits: tuple = None) -> dict:
    """The gaps between the program's image P and the reference's R, their
    shapes compared in blocks of ``block`` × ``block`` pixels. With
    ``hits``, the rays that hit the image on either side, also
    ``noise_ratio``: the squared differences of the two images (each over
    its power) pixel by pixel, over what the sampling noise of that many
    hits gives them, about 1 for two sound images of independent rays. A
    program that traces fewer rays than it is asked to, and weights them
    the more, reads above it."""
    pw, rw = P[..., 3].sum(), R[..., 3].sum()
    Pb, Rb = (reference.block_mean(P, block), reference.block_mean(R, block)) if block > 1 else (P, R)
    gaps = dict(power_gap=abs(pw - rw) / rw,
                image_gap=(Pb[..., 3] / Pb[..., 3].sum() - Rb[..., 3] / Rb[..., 3].sum()).abs().sum())
    pc, rc = P[..., :3].sum(dim=(0, 1)) / pw, R[..., :3].sum(dim=(0, 1)) / rw
    gaps["color_gap"] = ((pc - rc).abs() / rc).max()
    # X, Y and Z block by block, each image over its power, against the
    # reference's mean colour: a colour that is wrong in one part of the
    # image, or everywhere
    gaps["channel_gap"] = ((Pb[..., :3] / Pb[..., 3].sum() - Rb[..., :3] / Rb[..., 3].sum()).abs()
                           .sum(dim=(0, 1)) / rc).max()
    if hits:
        d = P[..., 3] / pw - R[..., 3] / rw
        gaps["noise_ratio"] = (d * d).sum() / (1 / hits[0] + 1 / hits[1])
    return {k: float(v) for k, v in gaps.items()}


def reference_image(run, shape, extent, dtype=torch.float64):
    """The reference's image of ``reference_rays`` rays and its hits."""
    t = run.traffic
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed))
    with torch.no_grad():
        return reference.render(reference.Scene(run.config), int(t["reference_rays"]),
                                int(t["reference_batch"]), gen, run.seed, shape[1], shape[0],
                                extent, dtype=dtype, acc_dtype=torch.float64)


def judge(run, outputs) -> dict:
    t = run.traffic
    P = torch.as_tensor(outputs["image"], dtype=torch.float64, device=run.device)
    R, ref_hits = reference_image(run, P.shape, outputs["extent"])
    # the program's hits: its rays times the share of the reference's that hit
    hits = (int(t["rays"]) * ref_hits / int(t["reference_rays"]), ref_hits) if t.get("compare_noise") else None
    return numbers(P, R, int(t.get("compare_block", 1)), hits)


def control(run, dtype=torch.bfloat16) -> dict:
    """The outputs of the reference put in the program's place, traced in
    ``dtype`` from a seed of its own onto the cell's extent and grid: what
    the check must refuse."""
    t = run.traffic
    extent = image_extent(run)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 7919)
    with torch.no_grad():
        img, _ = reference.render(reference.Scene(run.config), int(t["rays"]), int(t["reference_batch"]),
                                  gen, run.seed, SIDE, SIDE, extent, dtype=dtype, acc_dtype=torch.float32)
    return dict(image=img.double().cpu().numpy(), extent=extent)
