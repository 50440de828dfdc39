#!/usr/bin/env python3
"""What the sharded render's collective costs at one rank on one GPU.

    python3 tools/allreduce_probe.py

Brings up an NCCL process group of one rank (this process, a ``file://``
rendezvous in a temporary directory) and, on a tile of the render's size
(945 × 945 × 4 f32, 14.3 MB), measures:

- the host time of one call of the step's division, of
  ``torch.distributed.all_reduce`` and of both, issued while the device is
  kept busy for about 0.1 s by ``torch.cuda._sleep``: a call that made the
  host wait for the device would take that long;
- the device time of one all-reduce, by CUDA events over 20 calls.

Prints one JSON line, the card's name and power limit as ``nvidia-smi``
gives them on the line before it. Needs one CUDA device.
"""

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

NX = NY = 945
SLEEP_CYCLES = 200_000_000          # about 0.1 s of device time on an H100
REPS = 3


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("allreduce_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.set_device(0)
    pg_dir = tempfile.mkdtemp(prefix="allreduce_probe_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(pg_dir, "rendezvous"),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    try:
        tile = torch.ones(NY * NX * 4, device="cuda")
        dist.all_reduce(tile)
        (tile / 1).sum()
        torch.cuda.synchronize()
        calls = {"division": lambda: tile / 1, "all_reduce": lambda: dist.all_reduce(tile),
                 "division_and_all_reduce": lambda: dist.all_reduce(tile / 1)}
        host_ms, until_idle_ms = {}, {}
        for name, fn in calls.items():
            host_ms[name], until_idle_ms[name] = [], []
            for _ in range(REPS):
                torch.cuda.synchronize()
                torch.cuda._sleep(SLEEP_CYCLES)
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host_ms[name].append((t1 - t0) * 1e3)
                until_idle_ms[name].append((time.perf_counter() - t0) * 1e3)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(20):
            dist.all_reduce(tile)
        b.record()
        torch.cuda.synchronize()
        device_ms = a.elapsed_time(b) / 20
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps(dict(tile_bytes=NY * NX * 4 * 4, host_call_ms_while_device_busy=host_ms,
                          ms_until_device_idle=until_idle_ms, all_reduce_device_ms=device_ms,
                          torch=torch.__version__, cuda=torch.version.cuda)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
