"""generic.sag_evals_per_ray.render: the generic step's sag evaluations a
ray, in the profiled stretch: how far the program's counter
(``geom.generic_sag.sag_evals``, which counts the rays of each evaluation,
replays included) moved over the stretch's operations, as the entry noted it
around each operation (``run.sag_evals``), over the rays this card traced in
them. A program without the counter reports nothing."""


def read(run, prof):
    deltas = getattr(run, "sag_evals", None)
    n = prof["ops"]
    if not deltas or not n or len(deltas) < n or not prof["rays"]:
        return None
    return sum(deltas[-n:]) / (prof["rays"] / run.world)
