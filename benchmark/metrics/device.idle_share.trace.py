"""The device's idle share in the profiled stretch: 1 less the union of the
intervals of its operations (kernels and copies) over the stretch."""


def read(run, prof):
    return 1.0 - prof["busy_s"] / prof["window_s"]
