"""graph.launches_per_op.trace: the kernels the profiler saw on the card
(copies and fills of memory left out) over the operations of the profiled
stretch."""


def read(run, prof):
    return prof["launches"] / prof["ops"] if prof["ops"] else None
