"""kernel2_roofline.trace: the binning kernel's share of its roofline in the
trace cell, in %. The least time for binning each operation's detector
hits (16 B a hit in) into its detector image (16 B a pixel out once), over
the device time of every launch of the binning kernel in the profile."""

from benchmark import profiling, roofline


def read(run, prof):
    n, sec = profiling.seconds_of(prof, "bin_xyzw")
    if not n:
        return None
    Ny, Nx = prof["image_shape"]
    hits = roofline.shares(run.config, run.seed, run.device)["hits"] * run.traffic["rays"]
    return 100.0 * roofline.least_seconds(*roofline.kernel2_work(hits, Nx, Ny)) * prof["ops"] / sec
