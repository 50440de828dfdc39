"""image.read_ms: the mean time of the read path, ``Raytracer.detector_image``
and ``RenderImage.get``, in the profiled stretch, in ms, from the
benchmark's own span around the two calls (the card synchronized at both
ends)."""


def read(run, prof):
    spans = prof["spans"].get("image.read")
    return 1e3 * sum(spans) / len(spans) if spans else None
