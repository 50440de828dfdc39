"""kernel1.refraction_share.render: the share of the refractions of a run's
kinds (flat discs, conics, even aspheres) that kernel 1 took on the card: the
program's counter ``conic_run.refractions`` (the refraction steps of every
launch of kernel 1, ``optrace_tpu_torch/ops/cuda_run.py``) over it plus
``trace_bundle.unrolled_refractions`` (those refractions that a CUDA device
took as unrolled eager steps, ``optrace_tpu_torch/tracer/trace_core.py``),
replays included. The counters hold the whole run up to the reading (the warm
calls, the window and the profiled stretch), whose calls all render one scene
by one route. A program without the counters, or whose run refracted nothing
of these kinds on the card, reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.ops import cuda_run
        from optrace_tpu_torch.tracer import trace_core
    except ImportError:
        return None
    kernel = getattr(getattr(cuda_run, "conic_run", None), "refractions", None)
    unrolled = getattr(getattr(trace_core, "trace_bundle", None), "unrolled_refractions", None)
    if kernel is None or unrolled is None or kernel + unrolled == 0:
        return None
    return kernel / (kernel + unrolled)
