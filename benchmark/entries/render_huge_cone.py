"""Entry ``render_huge_cone``: the entry ``render_huge`` for a configuration
whose anterior cornea carries a Gaussian cone (``configs/keratoconic_eye.json``).
One operation is one call of ``Raytracer.render_huge(rays, batch_size=batch,
extent=...)``, the extent a square of ``spot_half_mm`` around the spot. The
scene is built by ``scene_keratoconus.build``, the extent and the reference
render come from ``reference_keratoconus``: never from ``reference.Scene``,
which would read the cone's row as a healthy conic. The numbers compared, and
how, are the entry ``render_huge``'s (``numbers``).

Around every operation the entry also notes how far the program's count of
the generic step's sag evaluations (``geom.generic_sag.sag_evals``) moved, in
``run.sag_evals``: the metric ``generic.sag_evals_per_ray.render`` reads the
profiled stretch's part of it. A program without the counter notes nothing.
"""

import math

import torch

from benchmark import reference_keratoconus as rk, scene_keratoconus
from benchmark.entries import render_huge as base


def _sag_evals():
    """The program's count of the generic step's sag evaluations, or None."""
    from optrace_tpu_torch.ops import geom
    return getattr(getattr(geom, "generic_sag", None), "sag_evals", None)


def setup(run):
    import optrace_tpu_torch as ot
    t = run.traffic
    RT = scene_keratoconus.build(ot, run.config, run.seed, no_pol=bool(t["no_pol"]), device=run.device)
    state = dict(RT=RT, mesh=ot.default_mesh(device=run.device.type) if run.world > 1 else None, img=None,
                 extent=rk.spot_extent(run.config, run.seed, float(t["spot_half_mm"]), run.device))
    run.sag_evals = []
    for _ in range(int(t["warm_calls"])):
        operation(run, state)
    return state


def operation(run, state):
    t = run.traffic
    before = _sag_evals()
    img = state["RT"].render_huge(int(t["rays"]), batch_size=int(t["batch"]), mesh=state["mesh"],
                                  extent=state["extent"])
    if before is not None:
        run.sag_evals.append(_sag_evals() - before)
    state["img"] = img
    return dict(rays=int(t["rays"]), batches=math.ceil(int(t["rays"]) / int(t["batch"])),
                image_shape=img.shape[:2])


finish = base.finish


def reference_image(run, shape, extent, dtype=torch.float64):
    """The reference's image of ``reference_rays`` rays and its hits."""
    t = run.traffic
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed))
    with torch.no_grad():
        return rk.render(rk.Scene(run.config), int(t["reference_rays"]), int(t["reference_batch"]), gen,
                         run.seed, shape[1], shape[0], extent, dtype=dtype, acc_dtype=torch.float64)


def judge(run, outputs) -> dict:
    t = run.traffic
    P = torch.as_tensor(outputs["image"], dtype=torch.float64, device=run.device)
    R, ref_hits = reference_image(run, P.shape, outputs["extent"])
    # the program's hits: its rays times the share of the reference's that hit
    hits = (int(t["rays"]) * ref_hits / int(t["reference_rays"]), ref_hits) if t.get("compare_noise") else None
    return base.numbers(P, R, int(t.get("compare_block", 1)), hits)


def control(run, dtype=torch.bfloat16) -> dict:
    """The outputs of the reference put in the program's place, traced in
    ``dtype`` from a seed of its own onto the cell's extent and grid: what
    the check must refuse."""
    t = run.traffic
    extent = rk.spot_extent(run.config, run.seed, float(t["spot_half_mm"]), run.device)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 7919)
    with torch.no_grad():
        img, _ = rk.render(rk.Scene(run.config), int(t["rays"]), int(t["reference_batch"]), gen, run.seed,
                           base.SIDE, base.SIDE, extent, dtype=dtype, acc_dtype=torch.float32)
    return dict(image=img.double().cpu().numpy(), extent=extent)

