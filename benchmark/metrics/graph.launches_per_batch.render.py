"""graph.launches_per_batch.render: the kernels the profiler saw on the card
(copies and fills of memory left out) over the render batches of the
profiled stretch; on a sharded cell, rank 0's."""


def read(run, prof):
    return prof["launches"] / prof["batches"] if prof["batches"] else None
