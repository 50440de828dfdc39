"""raytracer.trace_host_ms: the program's own span ``trace`` (``Raytracer.trace``)
less its ``trace.infos_wait`` (the host waiting for the trace on the card),
in ms per operation of the profiled stretch: the host's side of a trace.
Read from ``optrace_tpu_torch.utils.tracing``; a program without the spans
reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    if "trace" not in spans or not prof["ops"]:
        return None
    wait = spans.get("trace.infos_wait", {"total_s": 0.0})["total_s"]
    return 1e3 * (spans["trace"]["total_s"] - wait) / prof["ops"]
