"""hurb.device_ms.render: the device time of a render batch's HURB step (the
two normal draws and the bend at an aperture), in ms, from the program's
device interval ``trace_bundle.hurb``: a pair of CUDA events that the call's
capture put into its graph, as the last replay of the profiled stretch
recorded them (in a scene of several HURB apertures, the last one's step).
Read from ``optrace_tpu_torch.utils.tracing``; a program without the
interval reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.device_ms("trace_bundle.hurb")
