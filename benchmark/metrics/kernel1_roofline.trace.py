"""kernel1_roofline.trace: kernel 1's share of its roofline in the trace
cell, in %. The least time for the work of every operation's runs (the
scene's runs of four or more refractions, the operation's rays, with the
polarization and the sections that a stored trace keeps) over kernel 1's
device time in the profile."""

from benchmark import profiling, reference, roofline


def read(run, prof):
    scene = reference.Scene(run.config)
    n, sec = profiling.seconds_of(prof, "conic_run_kernel")
    if not roofline.runs(scene) or not n:
        return None
    t = run.traffic
    alive = roofline.shares(run.config, run.seed, run.device)["alive"]
    ops, nbytes = roofline.kernel1_work(scene, t["rays"], alive, pol=not t["no_pol"], store=True)
    return 100.0 * roofline.least_seconds(ops, nbytes) * prof["ops"] / sec
