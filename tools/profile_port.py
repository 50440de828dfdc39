#!/usr/bin/env python3
"""Where a batch of the port's fused render spends its time on the GPU.

    python3 tools/profile_port.py [--batches 4] [--rays 1000000] [--fuse-planar] [--out profile.json]
    python3 tools/profile_port.py --kernel-times [--root DIR] [--binning-only] [--rays 1000000]
    python3 tools/profile_port.py --iterative [--batches 4] [--rays 1000000] [--root DIR]
    python3 tools/profile_port.py --trace [--batches 4] [--rays 1000000] [--root DIR]
    python3 tools/profile_port.py --design [--batches 4] [--rays 1000000] [--root DIR]

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
first (stored) batch timed on their own: ``trace``, ``detector_image`` from
the sections kept on the card, and one fused batch with two sinks.

``--trace`` splits the stored trace's read path of the double Gauss at
``--rays`` rays without and with polarization, and of the 57-surface stack
(``trace`` only), stage by stage (``StageTimer``: the host seconds in named
functions, each less the wrapped calls it makes; the median of
``--batches`` runs): ``trace`` on a cache hit as it runs (geometry checks,
the tracing snapshots, the trace entry, the sampling and eager launches,
the fill, the wait for the INFOS counters); ``detector_image`` with the
card synchronized at every stage (the change check, the f64 sections, the
hit search, kernel 2, the f64 image and its copy to the host); ``get`` in
three modes at 945² and 315² the same way (block mean, colour, copies, the
image object); selected reads of the sections on the card
(``rays_by_mask_times``); the first full read of ``RT.rays`` taken apart
(``first_read_split``: copies, page faults, pinned memory, the f64
conversions, ``s0``); and the plain host clock of each call beside. With
``--root`` it splits an earlier tree the same way; a function that the
tree does not have is listed under ``missing``. For a replayed ``trace``
it also splits the device time by kind (``trace_device_split``: kernel 1,
source sampling, media, sections, INFOS counters, the rest and the replay's
copies of its outputs, each with its launches).

``--design`` profiles the design render of chip_smoke.py's design phase
(``tracer/diff.py:make_parameterized_render`` of the double Gauss, 189²
soft-binned pixels over ±0.3 mm, ``spot_loss``): one ``value_and_grad`` step
with respect to the 14 curvatures (the runs take the plain loop) and one
evaluation of the loss alone (the runs take kernel 1), each ``--batches``
times: wall ms, the device's busy ms and idle share, device launches, and
the launches of kernel 1 and of the plain loop an evaluation, and the peak
device memory of an evaluation above what was allocated before it.

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
    from optrace_tpu_torch.utils import tracing

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
    tracing.reset_counts()
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
               parts_ms=dict(trace=trace_ms, detector_image_from_kept_sections=image_ms,
                             fused_batch_two_sinks=fused_ms))
    print(json.dumps(res))
    return 0


class StageTimer:
    """Host seconds spent in named callables while the ``with`` block runs.

    ``targets`` are (owner, attribute, label): a module or class and the
    name of a function, static method, class or ``torch.Tensor`` method on
    it; labels may repeat, their times add. A call's time is its own, less
    that of the wrapped calls it makes, so the labels part the wall time and
    the rest is the code that no target covers. With ``sync`` every wrapped
    call synchronizes the card as it starts and as it ends, so a stage holds
    its own device work (and not the work queued before it). A target that
    a tree does not have is left out and named in ``missing``."""

    def __init__(self, targets, sync=False):
        import collections
        self.targets, self.sync = targets, sync
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.missing = []
        self._stack, self._saved = [], []

    def _wrap(self, fn, label):
        import functools
        import torch

        @functools.wraps(fn)
        def timed(*a, **kw):
            if self.sync:
                torch.cuda.synchronize()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.seconds[label] += dt - inner
                self.calls[label] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed

    def __enter__(self):
        for owner, name, label in self.targets:
            if not hasattr(owner, name):
                self.missing.append(f"{getattr(owner, '__name__', owner)}.{name}")
                continue
            raw = owner.__dict__.get(name) if isinstance(owner, type) else getattr(owner, name)
            self._saved.append((owner, name, raw))
            if isinstance(raw, staticmethod):
                setattr(owner, name, staticmethod(self._wrap(raw.__func__, label)))
            else:
                setattr(owner, name, self._wrap(getattr(owner, name), label))
        return self

    def __exit__(self, *exc):
        for owner, name, raw in reversed(self._saved):
            if raw is None:
                delattr(owner, name)        # a method inherited from a base class
            else:
                setattr(owner, name, raw)
        self._saved = []

    def split(self, wall_s):
        return dict(seconds=dict(self.seconds), calls=dict(self.calls),
                    not_covered=wall_s - sum(self.seconds.values()), missing=self.missing)


def _median_split(splits):
    """The split whose wall time is the median of the runs."""
    return sorted(splits, key=lambda s: s["wall_s"])[len(splits) // 2]


def first_read_split(rays, reps=2):
    """The first full read of ``RT.rays`` taken apart, on the tensors that
    the storage keeps: the copy of each to fresh host memory (``.cpu()``),
    into host memory touched before (the page faults are the difference),
    into pinned memory; the f32 → f64 conversion of the positions and
    indices into fresh and into touched memory; ``s0`` as the tree makes
    it from the first two sections; and the f64 conversion on the card before one copy into
    fresh and into pinned memory; the allocation of pinned memory. Seconds,
    the least of ``reps`` runs."""
    import numpy as np
    import torch

    def best(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return min(out)

    dev = {k: t for k, t in rays._dev.items() if t is not None}
    # pinned host memory: its first allocation of a size (the caching host
    # allocator rounds it up to a power of two), then the same again, from
    # the allocator's cache, for the f64 positions and for a 945² XYZW image
    pinned_alloc = {}
    for label, nbytes in (("p_f64", dev["p"].numel() * 8), ("image_945", 945 * 945 * 4 * 8)):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            times.append(time.perf_counter() - t0)
            del buf
        pinned_alloc[label] = dict(bytes=nbytes, first_s=times[0], cached_s=times[1])
    touched = {k: torch.zeros(t.shape, dtype=t.dtype) for k, t in dev.items()}
    pinned = {k: torch.zeros(t.shape, dtype=t.dtype, pin_memory=True) for k, t in dev.items()}
    host = {k: t.cpu().numpy() for k, t in dev.items()}
    wide = {k: np.zeros(host[k].shape) for k in ("p", "n")}
    pinned64 = {k: torch.zeros(dev[k].shape, dtype=torch.float64, pin_memory=True) for k in ("p", "n")}
    res = dict(
        bytes_on_card={k: t.numel() * t.element_size() for k, t in dev.items()},
        copy_fresh_s={k: best(lambda t=t: t.cpu()) for k, t in dev.items()},
        copy_touched_s={k: best(lambda k=k: touched[k].copy_(dev[k])) for k in dev},
        copy_pinned_s={k: best(lambda k=k: pinned[k].copy_(dev[k])) for k in dev},
        to_f64_fresh_s={k: best(lambda k=k: host[k].astype(np.float64)) for k in ("p", "n")},
        to_f64_touched_s={k: best(lambda k=k: np.copyto(wide[k], host[k])) for k in ("p", "n")},
        s0_as_the_tree_reads_it_s=best(lambda: rays._from_device("s0_list", slice(None))),
        f64_on_card_then_copy_fresh_s={k: best(lambda k=k: dev[k].to(torch.float64).cpu()) for k in ("p", "n")},
        f64_on_card_then_copy_pinned_s={k: best(lambda k=k: pinned64[k].copy_(dev[k].to(torch.float64)))
                                        for k in ("p", "n")})
    res["page_faults_s"] = {k: res["copy_fresh_s"][k] - res["copy_touched_s"][k] for k in dev}
    res["pinned_alloc"] = pinned_alloc
    thp = pathlib.Path("/sys/kernel/mm/transparent_hugepage/enabled")
    res["transparent_hugepages"] = thp.read_text().strip() if thp.exists() else "not readable"
    return res


def rays_by_mask_times(rays, reps):
    """Seconds of selected reads of a stored trace that still lies on the
    card, as the GUI and the analysis make them (``rays_by_mask``): every
    section of about 2000 rays spread over the bundle (the rays a GUI
    draws), and one section of every tenth ray. Host clock with the card
    synchronized, ``reps`` runs each."""
    import numpy as np
    import torch

    N, nt = rays.N, rays.Nt
    few, tenth = np.zeros(N, dtype=bool), np.zeros(N, dtype=bool)
    few[::max(N // 2000, 1)] = True
    tenth[::10] = True
    last = np.full(int(tenth.sum()), nt - 2)

    def timed(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out
    return dict(all_sections_of_2000_rays=timed(lambda: rays.rays_by_mask(few)),
                one_section_of_every_tenth_ray=timed(lambda: rays.rays_by_mask(tenth, last)))


def split_targets():
    """The stages of the stored trace's read path, as ``StageTimer``
    targets: ``trace`` (run as it is), ``detector_image`` and ``get`` (run
    with the card synchronized at every stage)."""
    import torch
    from optrace_tpu_torch import color as color_mod
    from optrace_tpu_torch.tracer import raytracer as rt_mod, ray_storage
    from optrace_tpu_torch.image import render_image as ri_mod
    from optrace_tpu_torch.parallel import graph as graph_mod

    Raytracer, RayStorage, RenderImage = rt_mod.Raytracer, ray_storage.RayStorage, ri_mod.RenderImage
    trace = [(Raytracer, "_geometry_checks", "geometry_checks"),
             (Raytracer, "tracing_snapshot", "tracing_snapshot"),
             (Raytracer, "_trace_entry", "trace_entry"),
             (rt_mod, "trace_bundle", "launches_trace"),
             (graph_mod.CapturedStep, "_replay", "replay"),
             (RayStorage, "fill", "fill"),
             (torch.Tensor, "cpu", "wait_for_infos"),
             (Raytracer, "_show_messages", "messages")]
    image = [(Raytracer, "check_if_rays_are_current", "check_if_rays_are_current"),
             (RayStorage, "sections", "f64_sections"),
             (rt_mod, "detector_hits", "hit_search"),
             (ri_mod, "bin_xyzw_cuda", "kernel_2"),
             (RenderImage, "_accumulate", "accumulate_f64"),
             (ri_mod, "_sum_into_zeros", "accumulate_f64"),
             (torch.Tensor, "cpu", "accumulate_copy"),
             (torch, "empty", "accumulate_copy"), (torch.Tensor, "copy_", "accumulate_copy")]
    colour = ("xyz_to_srgb", "outside_srgb_gamut", "xyz_to_luv", "luv_hue", "luv_chroma", "luv_saturation")
    get = ([(RenderImage, "_block_mean", "block_mean")]
           + [(color_mod, f, "colour") for f in colour]
           + [(ri_mod, "RGBImage", "image_object"), (ri_mod, "ScalarImage", "image_object")]
           + [(torch, "from_numpy", "copies"), (torch, "as_tensor", "copies"),
              (torch.Tensor, "cpu", "copies"), (torch.Tensor, "numpy", "copies"),
              (torch.Tensor, "to", "copies"), (torch, "empty", "copies"),
              (torch.Tensor, "copy_", "copies")])
    return dict(trace=trace, detector_image=image, get=get)


def split_call(fn, targets=(), sync=False):
    """(split, result) of one call of ``fn``: its wall seconds, the card
    synchronized before and after, and the seconds of each stage."""
    import torch
    torch.cuda.synchronize()
    with StageTimer(targets, sync=sync) as st:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(wall_s=wall, **st.split(wall)), out


TRACE_KINDS = ("kernel_1", "source_sampling", "media", "sections", "infos", "rest", "outputs")
MIN_MATCHED_SHARE = 0.98        # of the eager run's kernels, matched in a replay


def _kernel_name(name):
    """A kernel's name as an eager launch and a graph's node both report it."""
    return "memset" if "emset" in name else name


# the program's labels (``utils/tracing.py``) that name a kind of the trace's work
TRACE_LABELS = {"optrace:sampling": "source_sampling", "optrace:trace_bundle.media": "media",
                "optrace:trace_bundle.step": "step", "optrace:trace_bundle.run": "run"}


def trace_kind(op, prev_kind=None) -> str:
    """The kind of the trace's work (:data:`TRACE_KINDS`) that a profiled
    operator ``op`` of an eager trace does, from the nearest of the
    program's labels around it (:data:`TRACE_LABELS`) and the operators it
    is part of: the sources' sampling and the media (labelled), the INFOS
    counters (``count_nonzero``, the run's counters, the counters' zeros and
    sums in ``trace_bundle``), the steps outside the runs (labelled, "rest")
    and, directly in ``trace_bundle``, the sections (the absolute positions,
    the copies of section 0 and of the unrolled steps into their columns,
    where a tree stacks them the stacks of the per-section tensors, the
    INFOS stack among them) and the rest (frame shifts, absorption, HURB
    draws). Kernel 1, which writes its runs' sections, goes by its name
    ("kernel_1"), and a replay's copies of its outputs are "outputs"
    (:func:`trace_device_split`). ``prev_kind`` is the kind of the work
    launched before."""
    ops, label, e = set(), None, op
    while e is not None:
        if e.name.startswith("aten::"):
            ops.add(e.name)
        elif e.name in TRACE_LABELS and label is None:
            label = TRACE_LABELS[e.name]
        e = e.cpu_parent
    if label in ("source_sampling", "media"):
        return label
    if "aten::count_nonzero" in ops or label == "run":     # kernel 1 goes by its name
        return "infos"
    if label == "step":
        return "rest"
    if ops & {"aten::zeros", "aten::zero_", "aten::add_"}:
        return "infos"
    if ops & {"aten::stack", "aten::cat"}:
        return "media" if prev_kind == "media" else "sections"
    if ops & {"aten::add", "aten::copy_"}:                 # p_abs = p + off, the columns' copies
        return "sections"
    return "rest"


def trace_device_split(RT, n, reps=3):
    """Device ms and launches of a replayed ``trace`` of ``n`` rays, by kind
    (:data:`TRACE_KINDS`): kernel 1 by its name; every other kernel of the
    replay, in the order the card ran it, matched one for one to the
    kernels of an eager run of the trace entry's own function (the
    operations that its graph captured, in the same order, under the
    program's spans) in the order the card ran them (the longest matching
    blocks of their names), each of which the
    profiler ties to the operator that launched it (the runtime call with
    the kernel's correlation id, and the operator around that call;
    :func:`trace_kind`). The replay's device-to-device copies outside the
    graph (``CapturedStep`` returns copies of the graph's outputs) are
    "outputs" and take no part in the matching; copies to and from the host
    (the INFOS counters) are left out; a replay's kernel that matches none
    (the graph's generator state) counts as "rest". The eager run's own split
    stands beside it; where fewer than :data:`MIN_MATCHED_SHARE` of the
    eager kernels match, only the eager split is given. The median over
    ``reps`` replays of each kind's time."""
    import difflib
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    if not getattr(RT._trace_entry(n), "graphed", False):
        return dict(graphed=False)          # a tree without the trace's graph
    from optrace_tpu_torch.tracer.raytracer import TRACE_CAPTURE_CALL
    for _ in range(TRACE_CAPTURE_CALL):
        RT.trace(n)
    assert RT._trace_entry(n).run.graph is not None, "the trace was not captured"

    def device_events(prof):
        # kernels, memsets and device-to-device copies; not the copies to or
        # from the host, nor the labels' ranges on the device's timeline
        return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and (e.name.startswith("Memcpy DtoD")
                            or not e.name.startswith(("Memcpy", "optrace:")))),
                      key=lambda e: e.time_range.start)

    def runtime_calls(prof):
        # the host's runtime call that put each device event on the card, by correlation id
        return {e.id: e for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith("cu")}

    def split(rows):
        out = {k: dict(ms=0.0, launches=0) for k in TRACE_KINDS}
        for kind, us in rows:
            out[kind]["ms"] += us / 1e3
            out[kind]["launches"] += 1
        return out

    run = RT._trace_entry(n).run.fn         # the captured function, called eagerly
    gen = torch.Generator(device=RT.device)
    gen.manual_seed(1)
    run(gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(gen)
        torch.cuda.synchronize()
    launch = runtime_calls(prof)
    eager, kind = [], None
    for d in device_events(prof):
        op = launch[d.id].cpu_parent if d.id in launch else None
        kind = "kernel_1" if "conic_run_kernel" in d.name else trace_kind(op, kind) if op else "rest"
        eager.append((_kernel_name(d.name), kind, d.time_range.elapsed_us()))
    res = dict(eager_run=split([(kind, us) for _, kind, us in eager]), eager_kernels=len(eager),
               eager_kernels_without_operator=sum(d.id not in launch for d in device_events(prof)))
    replays = []
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            RT.trace(n)
            torch.cuda.synchronize()
        calls, dev, outputs = runtime_calls(prof), [], []
        for d in device_events(prof):
            copy = d.name.startswith("Memcpy DtoD") and d.id in calls and "GraphLaunch" not in calls[d.id].name
            (outputs if copy else dev).append(d)
        got, want = [_kernel_name(d.name) for d in dev], [name for name, _, _ in eager]
        kinds = ["rest"] * len(dev)         # a replay's kernel that no eager kernel matches
        blocks = difflib.SequenceMatcher(None, got, want, autojunk=False).get_matching_blocks()
        for b in blocks:
            for j in range(b.size):
                kinds[b.a + j] = eager[b.b + j][1]
        matched = sum(b.size for b in blocks)
        if matched < MIN_MATCHED_SHARE * len(want):
            res.update(replay_kernels=len(dev), replay_matched_to_eager=False, matched_kernels=matched)
            return res
        replays.append(split([(k, d.time_range.elapsed_us()) for k, d in zip(kinds, dev)]
                             + [("outputs", d.time_range.elapsed_us()) for d in outputs]))
    res.update(replay_matched_to_eager=True, replay_kernels=len(dev), matched_kernels=matched)
    res["replay"] = {k: dict(ms=statistics.median(r[k]["ms"] for r in replays),
                             launches=replays[0][k]["launches"]) for k in TRACE_KINDS}
    res["replay_busy_ms"] = sum(v["ms"] for v in res["replay"].values())
    return res


def trace_times(args, smi):
    """The stored trace's path split stage by stage, by the host's clock:
    ``trace`` on a cache hit, ``detector_image``, ``get`` and the first full
    read of ``RT.rays``."""
    import torch
    import optrace_tpu_torch as ot
    import chip_smoke as cs

    targets = split_targets()
    trace_targets, image_targets, get_targets = targets["trace"], targets["detector_image"], targets["get"]

    res = dict(gpu=smi, scene="double_gauss and stack57", rays=args.rays, runs=args.batches,
               package=str(pathlib.Path(ot.__file__).resolve().parent))
    for label, scene, no_pol in (("no_pol", cs.double_gauss_scene, True), ("pol", cs.double_gauss_scene, False),
                                 ("stack57", cs.synthetic_stack_scene, True)):
        RT = scene(ot, no_pol=no_pol)
        RT.trace(20000)
        RT.trace(args.rays)                 # builds the kernels, warms up; a miss
        # the device time of a replayed trace, by kind (its calls capture the
        # trace, so that the hits below are replays)
        row = dict(device_split=trace_device_split(RT, args.rays), trace_s=[], first_full_read_s=[])
        for _ in range(args.batches):       # the plain clock, no target wrapped
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            RT.trace(args.rays)
            t1 = time.perf_counter()
            for name in ("p_list", "s0_list", "n_list", "pol_list", "w_list", "wl_list"):
                getattr(RT.rays, name)
            row["trace_s"].append(t1 - t0)
            row["first_full_read_s"].append(time.perf_counter() - t1)
        # trace on a hit, as it runs (host stages; the INFOS copy waits for the card)
        row["trace_hit_split"] = _median_split([split_call(lambda: RT.trace(args.rays), trace_targets)[0]
                                                for _ in range(args.batches)])
        RT.trace(args.rays)
        row["rays_by_mask_s"] = rays_by_mask_times(RT.rays, args.batches)
        assert not RT.rays._host, "a selected read made a host array"
        row["first_read_split"] = first_read_split(RT.rays)
        if RT.detectors:
            RT.trace(args.rays)
            RT.detector_image()
            splits, img = [], None
            for _ in range(args.batches):
                s, img = split_call(RT.detector_image, image_targets, sync=True)
                splits.append(s)
            row["detector_image_split_synced"] = _median_split(splits)
            row["detector_image_s"] = [split_call(RT.detector_image)[0]["wall_s"] for _ in range(args.batches)]
            gets = {}
            for mode in ("sRGB (Absolute RI)", "sRGB (Perceptual RI)", "Lightness (CIELUV)"):
                for side in (945, 315):
                    img.get(mode, side)
                    key = f"{mode}@{side}"
                    gets[key] = dict(
                        wall_s=[split_call(lambda: img.get(mode, side))[0]["wall_s"] for _ in range(args.batches)],
                        split_synced=_median_split([split_call(lambda: img.get(mode, side), get_targets, sync=True)[0]
                                                    for _ in range(args.batches)]))
            row["get"] = gets
            row["image_device"] = str(getattr(img, "_device", "host (no device attribute)"))
        res[label] = row
        del RT
        torch.cuda.empty_cache()
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
    from optrace_tpu_torch.utils import tracing
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
        tracing.reset_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with cs.PlainRunCounter() as plain:
            t0 = time.perf_counter()
            for _ in range(args.batches):
                evaluate(grad)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
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
        out[label] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, peak_memory_GB=peak_gb,
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
    ap.add_argument("--trace", action="store_true",
                    help="time Raytracer.trace and the first full read of RT.rays")
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
    if args.trace:
        return trace_times(args, smi)
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
