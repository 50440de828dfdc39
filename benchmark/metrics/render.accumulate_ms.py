"""render.accumulate_ms: the program's spans ``render_huge.accumulate`` (each
batch's tile added in f64) and ``render_huge.finish`` (the sum's copy to the
host, the Rayleigh filter), in ms per ``render_huge`` call of the profiled
stretch. Read from ``optrace_tpu_torch.utils.tracing``; a program without
the spans reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    parts = [spans[k]["total_s"] for k in ("render_huge.accumulate", "render_huge.finish") if k in spans]
    return 1e3 * sum(parts) / prof["ops"] if parts and prof["ops"] else None
