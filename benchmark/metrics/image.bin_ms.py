"""image.bin_ms: the program's span ``detector_image.bin``: the binning of the
hits (kernel 2), the f64 sum and the image's copy to the host in
``Raytracer.detector_image``, in ms per operation of the profiled stretch.
Read from ``optrace_tpu_torch.utils.tracing``; a program without the span
reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("detector_image.bin")
    return 1e3 * s["total_s"] / prof["ops"] if s and prof["ops"] else None
