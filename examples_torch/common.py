"""What the example scripts share: the ray cap of ``main(rays=...)`` and the
invariants of their results."""

import math


def capped(N, rays):
    """``N`` rays, or at most ``rays`` where a cap is given."""
    return int(N) if rays is None else min(int(N), int(rays))


def keep_batches(RT, N, n):
    """Scale ``RT.ITER_RAYS_STEP`` so that an iterative render of ``n`` rays
    (``N`` capped) runs as many batches as one of ``N`` rays would."""
    if n < N:
        RT.ITER_RAYS_STEP = max(1, int(RT.ITER_RAYS_STEP * n / N))


def _pairs(value, source):
    """(value, source value) of each number of ``value``, a number, list or
    dict, with ``source`` of the same structure or one number for all."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _pairs(v, source[k] if isinstance(source, dict) else source)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _pairs(v, source[i] if isinstance(source, (list, tuple)) else source)
    else:
        yield float(value), float(source)


def check_results(results):
    """The invariants of an example's results; raises AssertionError.

    Every detector power is finite, positive and no larger than the power
    of its sources; a transmission lies in (0, 1]; a focus lies inside the
    range that the search bracketed; an optimisation's loss fell."""
    for key, src in (("power", "source_power"), ("powers", "source_powers")):
        if key in results:
            source = results.get(src, results.get("source_power"))
            for p, s in _pairs(results[key], source):
                assert math.isfinite(p) and 0.0 < p <= s * (1 + 1e-6), (key, p, s)
    for _, T in _pairs(results.get("transmission", {}), 1.0):
        assert 0.0 < T <= 1.0 + 1e-6, T
    for key in ("focus", "paraxial_focus", "marginal_focus"):
        if key in results:
            lo, hi = results["focus_bounds"]
            assert lo < results[key] < hi, (key, results[key], lo, hi)
    if "history" in results:
        h = results["history"]
        assert all(math.isfinite(v) for v in h) and h[-1] < h[0], h
