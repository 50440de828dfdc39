"""hurb.rays_per_ray.render: the rays that entered a HURB step, a ray
rendered, in the profiled stretch: how far the program's counter
(``trace_bundle.hurb_rays``, which counts the rays of every HURB step,
replays included) moved over the stretch's operations, as the entry noted it
around each operation (``run.hurb_rays``), over the rays this card traced in
them; 1.0 for a scene of one HURB aperture. A program without the counter
reports nothing."""


def read(run, prof):
    deltas = getattr(run, "hurb_rays", None)
    n = prof["ops"]
    if not deltas or not n or len(deltas) < n or not prof["rays"]:
        return None
    return sum(deltas[-n:]) / (prof["rays"] / run.world)
