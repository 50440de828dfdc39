"""raytracer.trace_ms: the mean time of ``Raytracer.trace`` in the profiled
stretch, in ms, from the benchmark's own span around the call (the card
synchronized at both ends)."""


def read(run, prof):
    spans = prof["spans"].get("raytracer.trace")
    return 1e3 * sum(spans) / len(spans) if spans else None
