#!/usr/bin/env python3
"""Where a batch of the port's fused render spends its time on the GPU.

    python3 tools/profile_port.py [--batches 4] [--rays 1000000] [--out profile.json]

Renders the double Gauss (the scene of chip_smoke.py) under torch.profiler
and prints one JSON object: wall time per batch, the device's busy time and
idle share, the number of kernel launches per batch, and the kernels that
take the most device time, summed by name. Needs one CUDA device.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--rays", type=int, default=10 ** 6)
    ap.add_argument("--pixels", type=int, default=945)
    ap.add_argument("--out", default="", help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    import optrace_tpu_torch as ot
    from chip_smoke import double_gauss_scene

    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
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
    res = dict(gpu=smi, scene="double_gauss", rays=args.rays, pixels=args.pixels,
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
