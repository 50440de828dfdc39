#!/usr/bin/env python3
"""Times variants of the binning kernel's tuning constants on one GPU.

    python3 tools/tune_binning.py [--rays 1000000] [--out tune.json]

Compiles ``optrace_tpu_torch/csrc/bin_xyzw.cu`` once for every combination
of its compile-time constants (BIN_PEEL, BIN_WARP_SLOTS, BIN_BLOCKS_PER_SM; all nvcc processes started together, into the package's
build directory), runs each library on the five inputs of
``tools/profile_port.py:binning_inputs`` (spread rays, clustered rays, two
hot pixels on a spread background, the fused render's input,
``detector_image``'s hits), holds the image against
the same sums taken in f64 (chip_smoke.py's ``TOL_BIN``) and prints one
JSON line with the device time of every variant and input, by
torch.profiler, beside ``index_add_`` on precomputed keys and values. The
constants in the source are the ones this script found best. Needs one
CUDA device and nvcc.
"""

import argparse
import ctypes
import itertools
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

GRID = dict(BIN_PEEL=(1, 2, 3, 4), BIN_WARP_SLOTS=(1, 2, 4), BIN_BLOCKS_PER_SM=(2, 4, 8))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=10 ** 6)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("tune_binning: needs a CUDA device", file=sys.stderr)
        return 1
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from profile_port import binning_inputs
    from optrace_tpu_torch.ops import _build
    from optrace_tpu_torch.ops.binning import binning_indices_2d
    from optrace_tpu_torch.color.observers import observer_table, x_observer, y_observer, z_observer

    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = _build.find_nvcc()
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = [dict(zip(GRID, v)) for v in itertools.product(*GRID.values())]
    procs = []
    for v in variants:
        lib = out_dir / ("libbin_" + "_".join(str(x) for x in v.values()) + ".so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *[f"-D{k}={x}" for k, x in v.items()], "-o", str(lib),
               str(_build.CSRC / "bin_xyzw.cu")]
        procs.append((v, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                               text=True)))
    libs = []
    for v, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        cdll.bin_xyzw_launch.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, ci, cf, cf,
                                         cf, cf, cf, cf, cf, cf, ci, ci, vp, vp]
        cdll.bin_xyzw_launch.restype = ci
        libs.append((v, cdll))

    # the recorded inputs may be strided views; the wrapper makes them contiguous
    inputs = {name: (*(t.contiguous() for t in v[:4]), *v[4:])
              for name, v in binning_inputs(args.rays).items()}
    dev = ot.resolve_device()
    obs, wl0, wl1 = observer_table(dev, torch.float32)
    rows, yardstick = [], {}
    prepared = {}
    for name, (px, py, w, wl, Nx, Ny, ext) in inputs.items():
        xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, ext)
        keys = yi * Nx + xi
        vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
        img64 = torch.zeros((Ny * Nx, 4), dtype=torch.float64, device=dev)
        img64.index_add_(0, keys, vals.double())
        out32 = torch.zeros((Ny * Nx, 4), dtype=torch.float32, device=dev)
        yardstick[name] = cs.device_kernel_ms(lambda: out32.index_add_(0, keys, vals), "ndex", calls=20)
        prepared[name] = (img64.view(Ny, Nx, 4), float(vals.abs().max()))
        del keys, vals, out32

    for v, cdll in libs:
        row = dict(v)
        for name, (px, py, w, wl, Nx, Ny, ext) in inputs.items():
            x0, x1, y0, y1 = (float(e) for e in ext[:4])
            img = torch.zeros((Ny, Nx, 4), dtype=torch.float32, device=dev)

            def launch():
                rc = cdll.bin_xyzw_launch(
                    px.data_ptr(), py.data_ptr(), w.data_ptr(), wl.data_ptr(), px.shape[0],
                    obs.data_ptr(), obs.shape[1], wl0, wl1, x0, x1, y0, y1,
                    Nx / (x1 - x0), Ny / (y1 - y0), Nx, Ny, img.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                assert rc == 0, rc
            launch()
            torch.cuda.synchronize()
            img64, _ = prepared[name]
            err = float((img.double() - img64).abs().max())
            tol = cs.TOL_BIN * max(float(img64.abs().max()), 1.0)
            assert err <= tol, (v, name, err, tol)
            row[name] = cs.device_kernel_ms(launch, "bin_xyzw_kernel", calls=20)
        rows.append(row)
    res = dict(gpu=smi, rays=args.rays, index_add_ms_device=yardstick, variants=rows)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
