#!/usr/bin/env python3
"""Where a batch of the port's fused render spends its time on the GPU.

    python3 tools/profile_port.py [--batches 4] [--rays 1000000] [--fuse-planar] [--out profile.json]
    python3 tools/profile_port.py --kernel-times [--root DIR] [--binning-only] [--rays 1000000]
    python3 tools/profile_port.py --iterative [--batches 4] [--rays 1000000]
    python3 tools/profile_port.py --design [--batches 4] [--rays 1000000]

Renders the double Gauss (the scene of chip_smoke.py) under torch.profiler
and prints one JSON object: wall time per batch, the device's busy time and
idle share, the number of kernel launches per batch, and the kernels that
take the most device time, summed by name. ``--fuse-planar`` sets
``global_options.cuda_fuse_planar`` (the ring aperture joins the run).

``--kernel-times`` times the kernels alone instead. The run kernel, on the
calls that a trace of the 28-lens stack (one run of 56), the double Gauss
(6 + 8, and 15 with the ring fused), the asphere stack (20) and the planar
stack (61) records: its device time by torch.profiler (``ms_device``), 20
launches between one pair of CUDA events (``ms``; for a kernel shorter than
the host's work for one launch this reads the host), and the host's own time
to enqueue one launch (``host_ms``). The single-step kernel on its probe.
The binning kernel on spread rays, clustered rays, two hot pixels among
spread rays, the render's input and ``detector_image``'s hits: the device
time of a whole call (all its launches and memsets, ``ms_device``) and of
each launch by name (``ms_by_launch``), beside two ``index_add_`` calls on
precomputed keys and values: f32 values (``index_add_ms_device``) and the
fixed-point int64 integers of the kernel's plain version, the same
order-free function (``index_add_int64_ms_device``). ``--binning-only``
times the binning kernel alone. ``--root DIR`` takes the package and
``chip_smoke.py`` from another directory, such as an unpacked earlier commit:
to compare two trees on one card, run this mode for each in turn (earlier,
this, this, earlier), one after the other on the same machine.

``--iterative`` profiles ``Raytracer.iterative_render`` of the double Gauss
with two detector positions over ``--batches`` batches of ``--rays`` rays:
wall ms of the whole call and a batch, the device's busy ms and idle share,
device launches and kernel 1 and 2 launches a batch, and the parts of the
first (stored) batch timed on their own: ``trace`` with its copy to the
host, ``detector_image`` from the sections kept on the card, and one fused
batch with two sinks.

``--design`` profiles the design render of chip_smoke.py's design phase
(``tracer/diff.py:make_parameterized_render`` of the double Gauss, 189²
soft-binned pixels over ±0.3 mm, ``spot_loss``): one ``value_and_grad`` step
with respect to the 14 curvatures (the runs take the plain loop) and one
evaluation of the loss alone (the runs take kernel 1), each ``--batches``
times: wall ms, the device's busy ms and idle share, device launches, and
the launches of kernel 1 and of the plain loop an evaluation.

``--sass`` builds the kernels and counts, for every kernel in the libraries,
the instructions of its disassembly (``cuobjdump -sass``) by opcode: loads
from shared memory (LDS), from the constant bank (LDC, ULDC), from and to
global memory, the special-function unit's reciprocals and square roots.
Needs one CUDA device.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def binning_inputs(rays):
    """The binning kernel's five inputs, as chip_smoke.py makes them:
    name -> (px, py, w, wl, Nx, Ny, extent). Rays spread over 1.2 x the
    extent; rays clustered on about 100 x 100 pixels and sorted by pixel; two
    hot pixels with a quarter of the rays each on a spread background; the
    fused render's input (the double Gauss at focus: most rays in one
    pixel); ``detector_image``'s hits of the asphere stack."""
    import torch
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from optrace_tpu_torch.parallel import render as render_mod
    from optrace_tpu_torch.image import render_image as render_image_mod

    dev = ot.resolve_device()
    NX = NY = cs.NX
    g = ot.make_generator(13)
    ext = (-43.265, 43.265, -43.265, 43.265)
    spread = [(torch.rand(rays, generator=g, device=dev) * 2 - 1) * 1.2 * ext[1] for _ in range(2)]
    spread += [torch.rand(rays, generator=g, device=dev),
               380.0 + 400.0 * torch.rand(rays, generator=g, device=dev)]
    clustered = [spread[0] * 0.09, spread[1] * 0.09, spread[2], spread[3]]
    order = torch.argsort(torch.floor(clustered[1] * (NY / (ext[3] - ext[2]))) * 4096
                          + torch.floor(clustered[0] * (NX / (ext[1] - ext[0]))))
    clustered = [t[order].contiguous() for t in clustered]
    inputs = {"spread": (*spread, NX, NY, ext), "clustered": (*clustered, NX, NY, ext)}
    g = ot.make_generator(19)
    xs, ys = ((torch.rand(rays + 1, generator=g, device=dev) * 2 - 1) * 1.1 * ext[1] for _ in range(2))
    pick = torch.rand(rays + 1, generator=g, device=dev)
    xs = torch.where(pick < 0.25, 3.2101, torch.where(pick < 0.5, -17.7303, xs))
    ys = torch.where(pick < 0.25, -8.4102, torch.where(pick < 0.5, 21.0304, ys))
    hot = [xs, ys, torch.rand(rays + 1, generator=g, device=dev),
           380.0 + 400.0 * torch.rand(rays + 1, generator=g, device=dev)]
    inputs["two_hot"] = (*(t[:rays].contiguous() for t in hot), NX, NY, ext)
    RT = cs.double_gauss_scene(ot, True)
    with cs.BinRecorder(render_mod) as rec, torch.no_grad():
        ot.make_fused_render(RT, rays, Nx=NX, Ny=NY)[0](ot.make_generator(14))
    inputs["render"] = rec.calls[0]
    RTa = cs.asphere_scene(ot, True)
    RTa.trace(rays)
    with cs.BinRecorder(render_image_mod) as rec:
        RTa.detector_image()
    inputs["detector_image"] = rec.calls[0]
    return inputs


def kernel_times(args, smi):
    """ms a launch of each kernel on recorded calls, by scene and variant."""
    import statistics
    import torch
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.ops.binning import binning_indices_2d, fixed_point_exponent, pow2
    from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer

    def run(c):
        kw = dict(pol=c["pol"], store=c["store"])
        if c.get("plan") is not None:       # a tree that prepares its runs
            kw["plan"] = c["plan"]
        return conic_run(c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"], **kw)

    def ms_per_launch(c, inner=20, reps=5):
        """(ms between events, host ms to enqueue) a launch, 20 in a row."""
        run(c)
        times, host = [], []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            t0 = time.perf_counter()
            for _ in range(inner):
                run(c)
            host.append((time.perf_counter() - t0) * 1e3 / inner)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times), statistics.median(host)

    rows = []
    go = ot.global_options
    scenes = (("stack56", cs.synthetic_stack_scene, False), ("double_gauss", cs.double_gauss_scene, False),
              ("asphere20", cs.asphere_scene, False), ("planar61", cs.planar_stack_scene, True),
              ("dg15", cs.double_gauss_scene, True))
    for scene_name, scene, fuse in ([] if args.binning_only else scenes):
        for label, no_pol, store in (("nopol,nostore", True, False), ("nopol,store", True, True),
                                     ("pol,store", False, True)):
            go.cuda_fuse_planar = fuse
            try:
                calls = cs.capture_run_calls(scene(ot, no_pol), args.rays, store, seed=11)
            finally:
                go.cuda_fuse_planar = False
            timed = [ms_per_launch(c) for c in calls]
            rows.append(dict(scene=scene_name, variant=label, steps=[len(c["steps"]) for c in calls],
                             ms=sum(t[0] for t in timed), host_ms=sum(t[1] for t in timed),
                             ms_device=sum(cs.device_kernel_ms(lambda: run(c), "conic_run_kernel")
                                           for c in calls)))
            del calls
            torch.cuda.empty_cache()

    kernel_3 = None
    if not args.binning_only:
        step = cs.check_conic_step()
        kernel_3 = dict(ms_device=step["ms"], ms=step["ms_between_events"], max_abs_err=step["max_abs_err"])

    inputs = binning_inputs(args.rays)
    kernel_2 = []
    for name, (px, py, w, wl, Nx, Ny, extent) in inputs.items():
        xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
        keys = yi * Nx + xi
        vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
        out = torch.zeros((Ny * Nx, 4), dtype=torch.float32, device=px.device)
        q = torch.round(vals.double() * pow2(fixed_point_exponent(w))).to(torch.int64)
        out64 = torch.zeros((Ny * Nx, 4), dtype=torch.int64, device=px.device)

        def call():
            return bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent)
        # the launches by name: those of this tree's kernel, whichever tree it is
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = sorted({ev.key for ev in prof.key_averages()
                        if ev.device_type == torch.autograd.DeviceType.CUDA
                        and ("bin_xyzw_" in ev.key or "Memset" in ev.key)})
        kernel_2.append(dict(
            input=name, N=int(px.shape[0]), rays_in_fullest_pixel=int(torch.bincount(keys[wm != 0]).max()),
            ms_device=cs.device_kernel_ms(call, ("bin_xyzw_", "Memset"), calls=20, per_call=True),
            ms_by_launch={k[:60]: cs.device_kernel_ms(call, k, calls=20) for k in names},
            index_add_ms_device=cs.device_kernel_ms(lambda: out.index_add_(0, keys, vals),
                                                    "ndex", calls=20),
            index_add_int64_ms_device=cs.device_kernel_ms(lambda: out64.index_add_(0, keys, q),
                                                          "ndex", calls=20),
            index_add_ms=cs.cuda_ms(lambda: out.index_add_(0, keys, vals))))
        del keys, vals, out, q, out64

    res = dict(gpu=smi, root=str(pathlib.Path(args.root).resolve()), rays=args.rays,
               launches_between_events=20, kernel_1=rows, kernel_2=kernel_2,
               kernel_3=kernel_3)
    print(json.dumps(res))
    return 0


def iterative_profile(args, smi):
    """``iterative_render`` under the profiler, and its parts by the host's clock."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    import optrace_tpu_torch as ot
    from chip_smoke import double_gauss_scene
    from optrace_tpu_torch.ops import cuda_run, cuda_binning

    def scene():
        RT = double_gauss_scene(ot, no_pol=True)
        RT.ITER_RAYS_STEP = args.rays
        z = float(RT.detectors[0].pos[2])
        return RT, [[0.0, 0.0, z], [0.0, 0.0, z - 2.0]]

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    N = args.batches * args.rays
    RT, pos = scene()
    RT.iterative_render(2 * args.rays, pos=pos)     # builds the kernels, warms up
    cuda_run.reset_launch_counts()
    cuda_binning.reset_launch_counts()
    wall_ms, _ = clock(lambda: RT.iterative_render(N, pos=pos))
    launches_1, launches_2 = cuda_run.conic_run.launches, cuda_binning.bin_xyzw_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        RT.iterative_render(N, pos=pos)
        torch.cuda.synchronize()
    busy_us = count = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            count += ev.count
    if not count:
        print("profile_port: the profiler recorded no device time", file=sys.stderr)
        return 1
    # the parts, each on its own
    RT2, pos2 = scene()
    RT2.trace(20000)
    trace_ms, _ = clock(lambda: RT2.trace(args.rays))
    image_ms, img = clock(lambda: RT2.detector_image(_dont_filter=True))
    cfgs = [dict(detector_index=0, pos=q, extent=tuple(img.extent), filter_extent=tuple(img._extent0),
                 Ny=img.shape[0], Nx=img.shape[1]) for q in pos2]
    render, _ = ot.make_fused_render_multi(RT2, args.rays, cfgs)
    with torch.no_grad():
        render(ot.make_generator(1))
        fused_ms = [clock(lambda: render(ot.make_generator(b)))[0] for b in range(4)]
    res = dict(gpu=smi, scene="double_gauss", entry="Raytracer.iterative_render", positions=2,
               rays=args.rays, batches=args.batches, wall_ms=wall_ms,
               wall_ms_per_batch=wall_ms / args.batches, rays_per_s=N / wall_ms * 1e3,
               device_busy_ms=busy_us / 1e3, device_busy_ms_per_batch=busy_us / 1e3 / args.batches,
               device_idle_share=max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
               device_launches_per_batch=count / args.batches,
               conic_run_launches_per_batch=launches_1 / args.batches,
               bin_xyzw_launches_per_batch=launches_2 / args.batches,
               parts_ms=dict(trace_with_host_copy=trace_ms, detector_image_from_kept_sections=image_ms,
                             fused_batch_two_sinks=fused_ms))
    print(json.dumps(res))
    return 0


def design_profile(args, smi):
    """One value_and_grad step and one loss-only evaluation of the design
    render under the profiler, and by the host's clock."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    import optrace_tpu_torch as ot
    import chip_smoke as cs
    from optrace_tpu_torch.ops import cuda_run
    from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss

    RT = cs.double_gauss_scene(ot, no_pol=True)
    render, params0 = make_parameterized_render(RT, args.rays, extent=list(cs.DESIGN_EXT),
                                                Nx=cs.DESIGN_PIXELS, Ny=cs.DESIGN_PIXELS)
    loss_fn = spot_loss(render)
    idx = [i for i, p in enumerate(params0) if "rho" in p]
    rhos0 = torch.stack([params0[i]["rho"] for i in idx])

    def evaluate(grad):
        r = rhos0.clone().requires_grad_(grad)
        params = [dict(p) for p in params0]
        for k, i in enumerate(idx):
            params[i]["rho"] = r[k]
        with torch.set_grad_enabled(grad):
            val = loss_fn(params, cs.DESIGN_SEED, cs.DESIGN_EXT)
            if grad:
                val.backward()
        return float(val.detach())

    out = {}
    for label, grad in (("value_and_grad", True), ("loss_only", False)):
        evaluate(grad)                       # builds the kernels, warms up
        torch.cuda.synchronize()
        cuda_run.reset_launch_counts()
        with cs.PlainRunCounter() as plain:
            t0 = time.perf_counter()
            for _ in range(args.batches):
                evaluate(grad)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches
        launches_1, launches_plain = cuda_run.conic_run.launches, plain.calls
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.batches):
                evaluate(grad)
            torch.cuda.synchronize()
        busy_us = count = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                busy_us += ev.self_device_time_total
                count += ev.count
        if not count:
            print("profile_port: the profiler recorded no device time", file=sys.stderr)
            return 1
        busy_ms = busy_us / 1e3 / args.batches
        out[label] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                          device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                          device_launches=count / args.batches,
                          conic_run_launches=launches_1 / args.batches,
                          plain_run_calls=launches_plain / args.batches)
    print(json.dumps(dict(gpu=smi, scene="double_gauss", entry="tracer/diff.py:make_parameterized_render",
                          rays=args.rays, image=[cs.DESIGN_PIXELS] * 2, extent=list(cs.DESIGN_EXT),
                          curvatures=len(idx), evaluations=args.batches, **out)))
    return 0


def sass_counts(smi):
    """Instructions by opcode in every kernel of the built libraries."""
    import collections
    import re
    from optrace_tpu_torch.ops import _build

    paths = _build.build_all()
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    watch = ("LDS", "LDC", "ULDC", "LDG", "STG", "LDL", "STL", "RED", "ATOMG", "ATOMS", "MUFU.RCP",
             "MUFU.RSQ", "MUFU.SQRT", "FFMA", "FMUL", "FADD", "SHFL", "VOTE", "REDUX", "MATCH", "BAR",
             "CALL")
    kernels = {}
    for name, lib in paths.items():
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        cur = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = kernels.setdefault(f"{name}:{m.group(1)}", collections.Counter())
                continue
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and cur is not None:
                op = m.group(1)
                cur["instructions"] += 1
                for wname in watch:
                    if op == wname or op.startswith(wname + "."):
                        cur[wname] += 1
    ptxas = [ln for ln in _build.build_info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print(json.dumps(dict(gpu=smi, sass={k: dict(v) for k, v in kernels.items()}, ptxas=ptxas)))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--rays", type=int, default=10 ** 6)
    ap.add_argument("--pixels", type=int, default=945)
    ap.add_argument("--fuse-planar", action="store_true",
                    help="trace with global_options.cuda_fuse_planar set")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time each kernel alone on recorded calls")
    ap.add_argument("--binning-only", action="store_true",
                    help="with --kernel-times: time the binning kernel alone")
    ap.add_argument("--iterative", action="store_true",
                    help="profile Raytracer.iterative_render over --batches batches of --rays rays")
    ap.add_argument("--design", action="store_true",
                    help="profile a value_and_grad step and a loss-only evaluation of the design render")
    ap.add_argument("--sass", action="store_true",
                    help="count the instructions of every kernel's disassembly by opcode")
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
    if args.sass:
        return sass_counts(smi)
    if args.kernel_times:
        return kernel_times(args, smi)
    if args.iterative:
        return iterative_profile(args, smi)
    if args.design:
        return design_profile(args, smi)
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
