"""kernel2_roofline.render: the binning kernel's share of its roofline in a
render cell, in %. The least time for binning each batch's hits on this
card (16 B a hit in) into the render's image (16 B a pixel out once), over
the device time of every launch of the binning kernel in the profile."""

from benchmark import profiling, roofline


def read(run, prof):
    n, sec = profiling.seconds_of(prof, "bin_xyzw")
    if not n:
        return None
    Ny, Nx = prof["image_shape"]
    hits = roofline.shares(run.config, run.seed, run.device)["hits"] * run.traffic["batch"] / run.world
    return 100.0 * roofline.least_seconds(*roofline.kernel2_work(hits, Nx, Ny)) * prof["batches"] / sec
