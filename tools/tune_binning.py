#!/usr/bin/env python3
"""Times variants of the binning kernel's tuning constants on one GPU.

    python3 tools/tune_binning.py [--rays 1000000] [--out tune.json]

Compiles ``optrace_tpu_torch/csrc/bin_xyzw.cu`` once for every combination
of its compile-time constants (BIN_TILE: pixels a tile, BIN_CHUNK: rays a
work item, BIN_BLOCKS_PER_SM: blocks an SM of the summing pass; all nvcc
processes started together, into the package's build directory), runs each
library through its launch symbol ``bin_xyzw_tiles_launch`` on the five
inputs of ``tools/profile_port.py:binning_inputs`` (spread rays, clustered
rays, two hot pixels on a spread background, the fused render's input,
``detector_image``'s hits), holds every image bit for bit against the
kernel's plain version ``ops/binning.py:bin_xyzw_fixed``, and prints one
JSON line: the device time of a whole call (every launch and the memset, by
torch.profiler) of every variant and input, beside ``index_add_`` of the
f32 values and of the fixed-point int64 integers on precomputed keys, and
the variant with the least summed time. The constants in the source are
the ones this script found best. Needs one CUDA device and nvcc.
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

GRID = dict(BIN_TILE=(1024, 2048), BIN_CHUNK=(2048, 4096), BIN_BLOCKS_PER_SM=(2, 3))
SMEM_PER_SM = 232448            # bytes of shared memory a block may use on an H100 (227 KB)


def fits(v):
    """Whether BIN_BLOCKS_PER_SM blocks of the summing pass fit an SM's shared
    memory: the tile's sums (32 bytes a pixel) and the observer table each."""
    return v["BIN_BLOCKS_PER_SM"] * (32 * v["BIN_TILE"] + 3 * 512 * 4 + 16) <= SMEM_PER_SM


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
    from optrace_tpu_torch.ops.binning import binning_indices_2d, bin_xyzw_fixed, fixed_point_exponent, pow2
    from optrace_tpu_torch.ops.cuda_binning import scratch_layout
    from optrace_tpu_torch.color.observers import (observer_table, observer_bound, x_observer, y_observer,
                                                   z_observer)

    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = _build.find_nvcc()
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = [v for v in (dict(zip(GRID, x)) for x in itertools.product(*GRID.values())) if fits(v)]
    procs = []
    for v in variants:
        lib = out_dir / ("libbin_" + "_".join(str(x) for x in v.values()) + ".so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *[f"-D{k}={x}" for k, x in v.items()], "-o", str(lib),
               str(_build.CSRC / "bin_xyzw.cu")]
        procs.append((v, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                               text=True)))
    libs = []
    vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for v, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.bin_xyzw_tiles_launch.argtypes = [vp, vp, vp, vp, cll, vp, ci, cf, cf, cf, cf, cf, cf, cf, cf,
                                               ci, ci, ctypes.c_double, vp, cll, vp, vp]
        cdll.bin_xyzw_tiles_launch.restype = ci
        config = (cll * 4)()
        cdll.bin_xyzw_tiles_config(config)
        assert (config[0], config[1], config[2]) == (v["BIN_TILE"], v["BIN_CHUNK"], v["BIN_BLOCKS_PER_SM"])
        libs.append((v, cdll))

    # the recorded inputs may be strided views; the wrapper makes them contiguous
    inputs = {name: (*(t.contiguous() for t in v[:4]), *v[4:])
              for name, v in binning_inputs(args.rays).items()}
    dev = ot.resolve_device()
    obs, wl0, wl1 = observer_table(dev, torch.float32)
    yardstick, refs = {}, {}
    for name, (px, py, w, wl, Nx, Ny, ext) in inputs.items():
        xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, ext)
        keys = yi * Nx + xi
        vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
        out32 = torch.zeros((Ny * Nx, 4), dtype=torch.float32, device=dev)
        q = torch.round(vals.double() * pow2(fixed_point_exponent(w))).to(torch.int64)
        out64 = torch.zeros((Ny * Nx, 4), dtype=torch.int64, device=dev)
        yardstick[name] = dict(
            index_add_ms=cs.device_kernel_ms(lambda: out32.index_add_(0, keys, vals), "ndex", calls=20),
            index_add_int64_ms=cs.device_kernel_ms(lambda: out64.index_add_(0, keys, q), "ndex", calls=20))
        refs[name] = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, ext).view(torch.int32)
        del keys, vals, out32, q, out64

    rows = []
    for v, cdll in libs:
        row = dict(v)
        for name, (px, py, w, wl, Nx, Ny, ext) in inputs.items():
            x0, x1, y0, y1 = (float(e) for e in ext[:4])
            total = scratch_layout(px.shape[0], Nx, Ny, v["BIN_TILE"], v["BIN_CHUNK"])["total"]
            scratch = torch.empty((total,), dtype=torch.uint8, device=dev)
            img = torch.zeros((Ny, Nx, 4), dtype=torch.float32, device=dev)

            def launch():
                rc = cdll.bin_xyzw_tiles_launch(
                    px.data_ptr(), py.data_ptr(), w.data_ptr(), wl.data_ptr(), px.shape[0],
                    obs.data_ptr(), obs.shape[1], wl0, wl1, x0, x1, y0, y1,
                    Nx / (x1 - x0), Ny / (y1 - y0), Nx, Ny, observer_bound(), scratch.data_ptr(), total,
                    img.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                assert rc == 0, rc
            for what in ("differs from bin_xyzw_fixed", "a repeat differs"):
                img.zero_()
                launch()
                torch.cuda.synchronize()
                assert torch.equal(img.view(torch.int32), refs[name]), (v, name, what)
            # timed accumulating into the image, so that no fill of it is timed
            row[name] = cs.device_kernel_ms(launch, ("bin_xyzw_", "Memset"), calls=20, per_call=True)
            del scratch, img
        row["sum_ms"] = sum(row[name] for name in inputs)
        rows.append(row)
    best = min(rows, key=lambda r: r["sum_ms"])
    res = dict(gpu=smi, rays=args.rays, bit_equal_to_bin_xyzw_fixed=True, index_add_ms_device=yardstick,
               variants=rows, best={k: best[k] for k in GRID})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
