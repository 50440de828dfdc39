"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 4 5 6]
        [--seconds 0] [--dtype bfloat16]

For each of ``--seeds`` it drives the cell as a run does (``harness.drive``:
set-up, a window of ``--seconds``, at least one operation, the judge): the
program's readings. For each of ``--control-seeds`` it puts the plain
reference in the program's place, computed in ``--dtype`` by the entry's
``control``, and judges that as a run does: the control's readings, which
the limits must refuse. Prints one JSON line per reading, each number
beside its limit and whether the run would read ``correct``. The
benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time
import types

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None, help="a device in place of the card (the CPU tests)")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness
    cell = harness.find_cell(harness.load_spec(), args.workload)
    entry = harness.load_module("entries", cell["traffic_data"]["entry"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        run_args = types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        checks = harness.drive(cell, run_args, t0, device=args.device)["checks"]
        print(json.dumps(dict(kind="program", seed=seed, seconds=time.perf_counter() - t0,
                              correct=harness.is_correct(checks), checks=checks)), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, device=args.device)
        checks = harness.judge(run, entry, entry.control(run, getattr(torch, args.dtype)))
        print(json.dumps(dict(kind="control", dtype=args.dtype, seed=seed, seconds=time.perf_counter() - t0,
                              correct=harness.is_correct(checks), checks=checks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
