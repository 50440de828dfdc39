"""image.hits_ms: the program's span ``detector_image.hits``: the f64
sections, the detector hit search, the selection, the projection and the
extent of ``Raytracer.detector_image``, in ms per operation of the profiled
stretch. Read from ``optrace_tpu_torch.utils.tracing``; a program without
the span reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("detector_image.hits")
    return 1e3 * s["total_s"] / prof["ops"] if s and prof["ops"] else None
