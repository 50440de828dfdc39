#!/usr/bin/env python3
"""How kernel 1's sections reach the trace's (N, nt, 3) / (N, nt) buffers.

    python3 tools/slot_store_probe.py [--rays 1000000] [--legs 4] [--out FILE]

Needs one CUDA device. Records the run kernel's calls of a stored trace of
the 28-lens stack (one run of 56) and of the double Gauss (runs of 6 and 8,
without and with polarization), and times on each, by torch.profiler (device
time; the median over ``--legs`` legs, each the sum over the scene's calls):

- ``step_major``: the kernel writing the run's sections into fresh (L, N, 3)
  / (L, N) tensors, the TPU kernel's layout, without the n rows;
- ``slots``: the kernel writing them, with each step's n₂, into the run's
  columns of the trace's buffers as the package stores them, section by
  section (``SectionSlots``): the same (L, N) rows at the run's first column;
- ``transpose_copy``: the other way to the same (N, nt, 3) shape, buffers
  laid out ray by ray (contiguous (N, nt, 3)) filled from the step-major
  result by one transposing ``copy_`` a buffer and run (the n rows
  gathered from ``n_tab``). That way costs ``step_major`` plus this.

The slots are held against ``conic_run_reference(out=...)`` bit for bit
first. Prints one JSON object, then the card's name and power limit.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rays", type=int, default=10 ** 6)
    ap.add_argument("--legs", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slot_store_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference
    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False

    rows = []
    for scene_name, scene, no_pol in (("stack56", cs.synthetic_stack_scene, True),
                                      ("double_gauss", cs.double_gauss_scene, True),
                                      ("double_gauss", cs.double_gauss_scene, False)):
        calls = cs.capture_run_calls(scene(ot, no_pol), args.rays, True, seed=11)
        row = dict(scene=scene_name, no_pol=no_pol, steps=[len(c["steps"]) for c in calls])
        per = {k: [[0.0] * args.legs for _ in calls] for k in ("step_major", "slots", "transpose_copy")}
        for ci, c in enumerate(calls):
            a = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
            kw = dict(pol=c["pol"], store=True, plan=c["plan"])
            L, col0 = len(c["steps"]), c["out"].col0
            slots, ref = cs._nan_slots(c["out"]), cs._nan_slots(c["out"])
            conic_run(*a, out=slots, **kw)
            conic_run_reference(*a, pol=c["pol"], out=ref)
            torch.cuda.synchronize()
            cs._slots_agree(slots, ref, L, scene_name)
            del ref
            _, (_, ys_p, ys_w, ys_pol) = conic_run(*a, **kw)
            ys_n = c["n_tab"].index_select(0, torch.tensor([r2 for _, r2 in c["med_idx"]], device=ys_p.device))
            ray_major = [(torch.empty(t.shape, dtype=t.dtype, device=t.device), ys)
                         for t, ys in zip((slots.p, slots.w, slots.n, slots.pol), (ys_p, ys_w, ys_n, ys_pol))
                         if t is not None]

            def transpose_copy():
                for buf, ys in ray_major:
                    buf[:, col0:col0 + L].copy_(ys.transpose(0, 1))

            for leg in range(args.legs):
                per["slots"][ci][leg] = cs.device_kernel_ms(lambda: conic_run(*a, out=slots, **kw),
                                                            "conic_run_kernel")
                per["step_major"][ci][leg] = cs.device_kernel_ms(lambda: conic_run(*a, **kw), "conic_run_kernel")
                per["transpose_copy"][ci][leg] = cs.device_busy(transpose_copy)[1]
            del slots, ray_major, ys_p, ys_w, ys_n, ys_pol
        for k, v in per.items():
            legs = [sum(call[i] for call in v) for i in range(args.legs)]
            row[k + "_ms"] = statistics.median(legs)
            row[k + "_ms_legs"] = legs
        row["step_major_then_transpose_copy_ms"] = row["step_major_ms"] + row["transpose_copy_ms"]
        rows.append(row)
        del calls
        torch.cuda.empty_cache()
    res = dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda, rays=args.rays, rows=rows)
    text = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
