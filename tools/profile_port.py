#!/usr/bin/env python3
"""Where a batch of the port's fused render spends its time on the GPU.

    python3 tools/profile_port.py [--batches 4] [--rays 1000000] [--fuse-planar] [--out profile.json]
    python3 tools/profile_port.py --kernel-times [--root DIR] [--rays 1000000]

Renders the double Gauss (the scene of chip_smoke.py) under torch.profiler
and prints one JSON object: wall time per batch, the device's busy time and
idle share, the number of kernel launches per batch, and the kernels that
take the most device time, summed by name. ``--fuse-planar`` sets
``global_options.cuda_fuse_planar`` (the ring aperture joins the run).

``--kernel-times`` times the run kernel alone instead, on the calls that a
trace of the 28-lens stack (one run of 56) and of the double Gauss records:
its device time by torch.profiler (``ms_device``), and 20 launches between
one pair of CUDA events (``ms``; for a kernel shorter than the host's work
for one launch this reads the host). ``--root DIR`` takes the package and
``chip_smoke.py`` from another directory, such as an unpacked earlier
commit: to compare two trees on one card, run this mode for each in turn
(earlier, this, this, earlier) within one session on the machine.
Needs one CUDA device.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def kernel_times(args, smi):
    """ms a launch of the run kernel on recorded calls, by scene and variant."""
    import statistics
    import torch
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from optrace_tpu_torch.ops.cuda_run import conic_run

    def ms_per_launch(c, inner=20, reps=5):
        a = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
        kw = dict(pol=c["pol"], store=c["store"])
        conic_run(*a, **kw)
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                conic_run(*a, **kw)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times)

    def device_ms(c, calls=10):
        from torch.profiler import profile, ProfilerActivity
        from torch.autograd import DeviceType
        a = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                conic_run(*a, pol=c["pol"], store=c["store"])
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and "conic_run_kernel" in ev.key]
        return sum(ev.self_device_time_total for ev in evs) / 1e3 / sum(ev.count for ev in evs)

    rows = []
    for scene_name, scene in (("stack56", cs.synthetic_stack_scene), ("double_gauss", cs.double_gauss_scene)):
        for label, no_pol, store in (("nopol,nostore", True, False), ("nopol,store", True, True),
                                     ("pol,store", False, True)):
            calls = cs.capture_run_calls(scene(ot, no_pol), args.rays, store, seed=11)
            rows.append(dict(scene=scene_name, variant=label, steps=[len(c["steps"]) for c in calls],
                             ms=sum(ms_per_launch(c) for c in calls),
                             ms_device=sum(device_ms(c) for c in calls)))
            del calls
            torch.cuda.empty_cache()
    res = dict(gpu=smi, root=str(pathlib.Path(args.root).resolve()), rays=args.rays,
               launches_between_events=20, kernel_1=rows)
    print(json.dumps(res))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--rays", type=int, default=10 ** 6)
    ap.add_argument("--pixels", type=int, default=945)
    ap.add_argument("--fuse-planar", action="store_true",
                    help="trace with global_options.cuda_fuse_planar set")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time the run kernel alone, 20 launches between one pair of events")
    ap.add_argument("--root", default=str(REPO),
                    help="directory that holds optrace_tpu_torch/ and chip_smoke.py (default: this repository)")
    ap.add_argument("--out", default="", help="also write the JSON object to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    import optrace_tpu_torch as ot
    from chip_smoke import double_gauss_scene

    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False
    ot.global_options.cuda_fuse_planar = bool(args.fuse_planar)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.kernel_times:
        return kernel_times(args, smi)
    RT = double_gauss_scene(ot, no_pol=True)
    render, _ = ot.make_fused_render(RT, args.rays, Nx=args.pixels, Ny=args.pixels)
    with torch.no_grad():
        render(ot.make_generator(99))       # builds the kernels, warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(args.batches):
            render(ot.make_generator(b))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in range(args.batches):
                render(ot.make_generator(b))
            torch.cuda.synchronize()

    # kernels only: an operator's row repeats the time of the kernels it launched
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / args.batches, ev.count / args.batches))
    if not rows:
        print("profile_port: the profiler recorded no device time", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    res = dict(gpu=smi, scene="double_gauss", cuda_fuse_planar=bool(args.fuse_planar),
               rays=args.rays, pixels=args.pixels,
               batches=args.batches, wall_ms_per_batch=wall_ms,
               device_busy_ms_per_batch=busy_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms else None,
               launches_per_batch=sum(r[2] for r in rows),
               top=[dict(name=r[0][:100], ms_per_batch=r[1], launches_per_batch=r[2])
                    for r in rows[:25]])
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
