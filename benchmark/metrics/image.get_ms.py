"""image.get_ms: the program's span ``get``, the whole of
``RenderImage.get`` (the image to the card, block mean, colour, the copy
back), in ms per operation of the profiled stretch. Read from
``optrace_tpu_torch.utils.tracing``; a program without the span reports
nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("get")
    return 1e3 * s["total_s"] / prof["ops"] if s and prof["ops"] else None
