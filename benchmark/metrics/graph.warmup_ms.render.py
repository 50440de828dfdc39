"""graph.warmup_ms.render: the program's spans ``graph.eager`` and
``graph.capture`` (the capture with its first replay) inside a
``render_huge`` call: what a call's render step costs before it replays, in
ms per call of the profiled stretch. Read from
``optrace_tpu_torch.utils.tracing``; a program without the spans reports
nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.records()
    ns = sum(s.t1_ns - s.t0_ns for s in spans
             if s is not None and s.name in ("graph.eager", "graph.capture")
             and spans[s.root] is not None and spans[s.root].name == "render_huge")
    return 1e-6 * ns / prof["ops"] if ns and prof["ops"] else None
