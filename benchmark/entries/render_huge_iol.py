"""Entry ``render_huge_iol``: the entry ``render_huge`` for the pseudophakic
eye (``configs/iol_eye.json``), whose pupil bends the rays passing it by
HURB and whose intraocular lens has an even-asphere back. One operation is
one call of ``Raytracer.render_huge(rays, batch_size=batch, extent=...)``,
the extent a square of ``spot_half_mm`` around the spot. The scene is built
by ``scene_iol.build``, the extent and the reference render come from
``reference_iol``: never from ``reference.Scene``, which would read the
asphere's row as its conic and let the pupil's rays pass unbent. The numbers
compared, and how, are the entry ``render_huge``'s (``numbers``).

Around every operation the entry also notes how far the program's count of
the rays that entered a HURB step (``trace_bundle.hurb_rays``) moved, in
``run.hurb_rays``: the metric ``hurb.rays_per_ray.render`` reads the profiled
stretch's part of it. A program without the counter notes nothing.
"""

import math

import torch

from benchmark import reference_iol as ri, scene_iol
from benchmark.entries import render_huge as base


def _hurb_rays():
    """The program's count of the rays that entered a HURB step, or None."""
    from optrace_tpu_torch.tracer import trace_core
    return getattr(getattr(trace_core, "trace_bundle", None), "hurb_rays", None)


def setup(run):
    import optrace_tpu_torch as ot
    t = run.traffic
    RT = scene_iol.build(ot, run.config, run.seed, no_pol=bool(t["no_pol"]), device=run.device)
    state = dict(RT=RT, mesh=ot.default_mesh(device=run.device.type) if run.world > 1 else None, img=None,
                 extent=ri.spot_extent(run.config, run.seed, float(t["spot_half_mm"]), run.device))
    run.hurb_rays = []
    for _ in range(int(t["warm_calls"])):
        operation(run, state)
    return state


def operation(run, state):
    t = run.traffic
    before = _hurb_rays()
    img = state["RT"].render_huge(int(t["rays"]), batch_size=int(t["batch"]), mesh=state["mesh"],
                                  extent=state["extent"])
    if before is not None:
        run.hurb_rays.append(_hurb_rays() - before)
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
        return ri.render(ri.Scene(run.config), int(t["reference_rays"]), int(t["reference_batch"]), gen,
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
    extent = ri.spot_extent(run.config, run.seed, float(t["spot_half_mm"]), run.device)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 7919)
    with torch.no_grad():
        img, _ = ri.render(ri.Scene(run.config), int(t["rays"]), int(t["reference_batch"]), gen, run.seed,
                           base.SIDE, base.SIDE, extent, dtype=dtype, acc_dtype=torch.float32)
    return dict(image=img.double().cpu().numpy(), extent=extent)
