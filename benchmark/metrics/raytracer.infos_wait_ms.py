"""raytracer.infos_wait_ms: the program's span ``trace.infos_wait``, the host
waiting in ``Raytracer.trace`` for the INFOS counters and so for the trace
on the card, in ms per operation of the profiled stretch. Read from
``optrace_tpu_torch.utils.tracing``; a program without the span reports
nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("trace.infos_wait")
    return 1e3 * s["total_s"] / prof["ops"] if s and prof["ops"] else None
