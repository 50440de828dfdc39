"""sampling.device_ms.render: the device time of a render batch's source
sampling, in ms, from the program's device interval ``render.sampling``: a
pair of CUDA events that the call's capture put into its graph, as the last
replay of the profiled stretch recorded them. Read from
``optrace_tpu_torch.utils.tracing``; a program without the interval reports
nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.device_ms("render.sampling")
