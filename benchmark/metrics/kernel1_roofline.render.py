"""kernel1_roofline.render: kernel 1's share of its roofline in a render
cell, in %. The least time for the work of every batch's runs (the scene's
runs of four or more refractions, the batch's rays on this card, no
polarization, no stored sections) over kernel 1's device time in the
profile. A scene without such a run reports nothing."""

from benchmark import profiling, reference, roofline


def read(run, prof):
    scene = reference.Scene(run.config)
    n, sec = profiling.seconds_of(prof, "conic_run_kernel")
    if not roofline.runs(scene) or not n:
        return None
    t = run.traffic
    alive = roofline.shares(run.config, run.seed, run.device)["alive"]
    ops, nbytes = roofline.kernel1_work(scene, t["batch"] / run.world, alive,
                                        pol=not t["no_pol"], store=False)
    return 100.0 * roofline.least_seconds(ops, nbytes) * prof["batches"] / sec
