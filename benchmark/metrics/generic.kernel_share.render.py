"""generic.kernel_share.render: the share of the generic steps (a function or
data surface's hit solve, mask and normals) that took the hand-written kernel
(``optrace_tpu_torch/ops/cuda_generic.py``): the kernel's launches over its
launches and the generic steps that took the eager route on the card, from the
program's counters ``generic_hit.launches`` and ``generic_hit.eager_steps``
(replays included). The counters hold the whole run up to the reading (the
warm calls, the window and the profiled stretch), whose calls all render one
scene by one route. A program without the counters, or whose run made no
generic step on the card, reports nothing."""


def read(run, prof):
    try:
        from optrace_tpu_torch.ops import cuda_generic
    except ImportError:
        return None
    counted = getattr(cuda_generic, "generic_hit", None)
    kernel, eager = getattr(counted, "launches", None), getattr(counted, "eager_steps", None)
    if kernel is None or eager is None or kernel + eager == 0:
        return None
    return kernel / (kernel + eager)
