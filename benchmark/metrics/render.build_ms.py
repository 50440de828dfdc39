"""render.build_ms: the program's span ``render_huge.build``, building a
call's render step (the steps, the sources' samplers, the sinks, the step
object), in ms per ``render_huge`` call of the profiled stretch. Read from
``optrace_tpu_torch.utils.tracing``; a program without the span reports
nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("render_huge.build")
    return 1e3 * s["total_s"] / prof["ops"] if s and prof["ops"] else None
