#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from optrace_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, renders the double-Gauss
objective (Nikkor-Wakamiya 100 mm f/1.4) with the fused streaming render at
10⁶ rays a batch into a 945 × 945 × 4 image, holds that render's batch
captured as a CUDA graph against the eager batch bit for bit (image, INFOS,
generator advance, launches, a replay under the sync debug mode's "error",
a refusal after a scene change, ``render_huge`` of 4, 8 and 20 batches with
its step captured against the same batches eager), runs the stored trace of
the double Gauss and of the 57-surface stack (kernel 1 writes its runs'
sections straight into the trace's (N, nt, 3) buffers, held bit for bit
against its plain version writing into the same columns and against the
route that stacks every section; its sections stay on the card:
``trace`` with no host read, then the first full read of ``RT.rays``; device
busy ms and idle share; no host array made by the outputs; a cache hit
against a miss and against a fresh raytracer), carries a stored trace of the
double Gauss through ``detector_image`` to ``RenderImage.get`` in every mode
at 945² and 315² (phase ``read_path``: the colour on the card, against the
same image's ``get`` on the CPU; the path split stage by stage; a kept
geometry outcome that replays a collision's warnings), holds spectra, focus searches
and the design image bit for bit over two calls and over the same rays in a
permuted order (phase ``repeatable``), traces
an asphere stack and carries its stored trace through ``detector_image`` to
an sRGB image, bins two hot pixels on a spread background and a ragged ray
count through ``RenderImage.render``, holds the binning kernel on the edges
of its tile schedule (every ray in one pixel, no live ray, a 189² image, a
pixel count that is no multiple of the tile) and times it beside f32 and
int64 ``index_add_``, drives the planar step kinds (tilted
plate, ring, rectangle, slit) in one run, measures the render with
``cuda_fuse_planar`` off and on, probes the single-step kernel, reads a
stored trace's detector and source images and spectra from the sections kept
on the card, traces a scene with an image source, a filter, HURB bending and
an ideal lens, drives ``iterative_render`` and ``render_huge`` (interrupted and
resumed: bit for bit; spherical detector), differentiates a spot loss of the double Gauss
with respect to its 14 curvatures (autograd against finite differences,
kernel route against plain route, five design steps), searches its focus
with all four methods, convolves images with a PSF preset and with its
detector image, traces the Arizona eye, traces the double Gauss with a
data-surface front and the cosine-surface lens of examples/cosine_surfaces.py
(the generic step unrolled between runs; the card against the CPU on 10⁵
rays), loads a synthetic ZEMAX prescription and catalog and traces it,
drives ``render_huge(mesh=...)`` over an NCCL process group of one rank
(against the unsharded render and interrupted and resumed, both bit for
bit), drives the
``TraceGUI``'s actions on the double Gauss at 10⁶ rays (against the
raytracer called directly; matplotlib under Agg where it is installed, else
a stand-in that draws nothing), runs ``main()`` of every example script of
examples_torch/ at the example's own ray counts (phase ``examples``: seconds,
rays, launches and peak memory of each, its results held to its
invariants, kernel 1's calls and a fused batch of the many-rays render held
against their plain versions), and checks that every path went through its
kernels (launch counters). Every
phase prints one JSON line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure exits with a non-zero code. Without a CUDA device the script
fails at once: nothing here runs on the CPU.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_RAYS = 10 ** 6
NX = NY = 945
N_BATCHES = 2
N_BATCHES_FLAG = 4              # batches of each leg of the cuda_fuse_planar measurement
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM f32 peak outside the tensor cores
# f32 operations of one step for one ray that is alive when it reaches it, by
# what the step makes the kernel do (ops/cuda_run.py:step_tag). A flat, conic
# or tilted refraction: hit solve, clamp, normal, Snell and Fresnel, outline
# test. An asphere: the same around a bracketed solve of 42 evaluations of the
# sag (about 22 operations each with two coefficients) and 40 bracket updates
# (about 15 each). An absorber: advance, plane hit, clamp, mask, outline test.
RUN_OPS_PER_RAY_STEP = {"conic": 150, "flat": 150, "tilted": 150,
                        "asphere": 150 + 42 * 22 + 40 * 15,
                        "absorb:circle": 60, "absorb:ring": 60, "absorb:rect": 60,
                        "absorb:slit": 60}
STEP_OPS_PER_RAY = 150          # the single-step kernel: one conic refraction
BIN_OPS_PER_RAY = 30
# the binning kernel's launches in one call (csrc/bin_xyzw.cu), as the profiler names them
BIN_LAUNCHES = ("Memset", "bin_xyzw_count", "bin_xyzw_plan", "bin_xyzw_scatter", "bin_xyzw_sum")
# the run-to-run spread of the host-bound render (PERF.md §5: 8.8–19.6 ms a
# batch across calls); within one call the legs off/on/on/off show their own
FLAG_MIN_GAIN = 0.10            # a default changes only for a gain beyond this share
CPU_REFERENCE_MS_PER_SURFACE_MRAY = 85.0    # the NumPy reference package on a CPU (BASELINE.md)

# kernel against plain version on the card, same inputs. Without FMA
# contraction (-fmad=false) both perform the same IEEE f32 operations, so
# the expected difference is 0; the bounds are those of the CPU parity tests.
TOL_P, TOL_W_REL, TOL_POL = 2e-5, 2e-6, 2e-5
TOL_BIN = 1e-5                  # kernel against the same sums taken in f64
TOL_BIN_PER_RAY = 2e-9          # plain version (one f32 add per ray): per ray in the fullest pixel
FLIPS_PER_MRAY = 200            # rays whose hit/miss may differ (expected: 0)
N_ITERATIVE = 4 * N_RAYS        # rays of iterative_render and render_huge: four batches
FILTER_MAX_T = 0.9              # largest transmission of the steps scene's filter
# an image binned in f32 on the card against an f64 histogram of the same hits
# on the host: a hit within f32 rounding of a pixel edge may change its pixel
TOL_EDGE_SHARE = 1e-3           # summed absolute difference over the image's power


# design phase: the double Gauss's spot on its detector lies within 0.17 mm of
# the axis (2 × 10⁴ rays on the CPU); a soft-binned 189² image over ±0.3 mm
# holds every ray, so no ray crosses the extent's edge between the probes of a
# finite difference
DESIGN_EXT = (-0.3, 0.3, -0.3, 0.3)
DESIGN_PIXELS = 189
DESIGN_SEED = 7
FD_RTOL = 3e-2                  # autograd against central differences (the JAX tests' rtol)
FD_EPS_REL = 1e-4               # the step of a central difference, relative to the curvature
FD_GRAD_FLOOR = 10.0            # |d spot / d rho| (mm per mm⁻¹) above which a difference is held
DESIGN_LR = 2e-7                # normalised-gradient step on the curvatures (mm⁻¹): on 2 × 10⁴
#                                 rays the loss falls along the gradient up to about 1e-6
CEMENT_GAP = 1e-3               # mm: two vertices this close are a cemented interface
DESIGN_STEPS = 5
TOL_LOSS_REL = 1e-6             # the loss by the plain run against the kernel run
FOCUS_SUBSET, FOCUS_PLANES = 10 ** 5, 16    # card against CPU cost sweep
TOL_FOCUS_COST = 1e-4           # relative: the same f32 operations, sums in another order
TOL_CONVOLVE = 1e-6             # card against CPU, both f64, on the [0, 1] sRGB range
# generic and zmx phases: the card's sections against the same port code on the
# CPU for a subset of the rays, with the CPU parity tests' tolerances
# (tests/test_torch_common.py): positions rtol 5e-6 / atol 2e-5 mm (2e-4 mm at
# the end of the free flight to the outline), weights rtol 2e-6 / atol 1e-9,
# and at most 4 rays per 20 000 whose hit/miss history differs
GENERIC_SUBSET = 10 ** 5
GUI_COMMAND_RAYS = 200000       # the GUI's ray count set by its command window
GUI_IMAGE_PIXELS = 315          # TraceGUI.image_pixels: the side of the image the GUI shows
SEC_P_RTOL, SEC_P_ATOL, SEC_P_ATOL_THROW = 5e-6, 2e-5, 2e-4
SEC_W_RTOL, SEC_W_ATOL = 2e-6, 1e-9
SEC_FLIPS_PER_20K = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=5, warmup=1):
    """Median time of fn() in ms by CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# scenes, through the port's public classes

def double_gauss_scene(ot, no_pol):
    """Object point at −50 m imaged by the objective onto its detector."""
    from optrace_tpu_torch.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], no_pol=no_pol)
    RT.add(ot.RaySource(ot.Point(), divergence="Isotropic", orientation="Converging",
                        conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                        spectrum=ot.LightSpectrum("Constant")))
    RT.add(double_gauss())
    return RT


def _stack_source(ot, RT):
    RT.add(ot.RaySource(ot.CircularSurface(r=3), divergence="Lambertian", div_angle=3,
                        pos=[0, 0, 0], s=[0, 0, 1], spectrum=ot.presets.light_spectrum.d65))


def _stack_lenses(ot, RT, z, count, start=0):
    """``count`` lenses of the 28-lens spherical stack from z on; returns the next z."""
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    for i in range(start, start + count):
        front = ot.SphericalSurface(r=8, R=60.0 if i % 2 == 0 else 80.0)
        back = ot.SphericalSurface(r=8, R=-70.0 if i % 2 == 0 else -90.0)
        RT.add(ot.Lens(front, back, n=glasses[i % 2], de=0.5, pos=[0, 0, z]))
        z += 15.0
    return z


def synthetic_stack_scene(ot, no_pol):
    """28 spherical lenses (56 refracting surfaces in one run) and a ring
    aperture, with dispersive glasses."""
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 600], no_pol=no_pol)
    _stack_source(ot, RT)
    z = _stack_lenses(ot, RT, 10.0, 28)
    RT.add(ot.Aperture(ot.RingSurface(r=9, ri=6), pos=[0, 0, z]))
    return RT


def asphere_scene(ot, no_pol):
    """The asphere stack of bench.py:build_asphere_scene (10 lenses with
    even-asphere fronts, 20 refracting surfaces in one run) and a detector
    behind the last lens."""
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 320], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=4), divergence="Lambertian", pos=[0, 0, 0],
                        s=[0, 0, 1], div_angle=8, spectrum=ot.presets.light_spectrum.d65))
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    z = 10.0
    for i in range(10):
        front = ot.AsphericSurface(r=8, R=60.0 if i % 2 == 0 else 80.0, k=-0.8, coeff=[1e-5, -1e-8])
        back = ot.SphericalSurface(r=8, R=-70.0 if i % 2 == 0 else -90.0)
        RT.add(ot.Lens(front, back, n=glasses[i % 2], de=0.5, pos=[0, 0, z]))
        z += 15.0
    RT.add(ot.Detector(ot.RectangularSurface(dim=[30, 30]), pos=[0, 0, 200]))
    return RT


def planar_stack_scene(ot, no_pol):
    """The 28-lens stack in groups of 6, 6, 6, 5 and 5 lenses with a tilted
    plate (8°), a ring stop, a rectangular stop and a rotated slit between
    the groups, and a detector behind the last lens: with
    ``cuda_fuse_planar`` one run of 61 steps."""
    import numpy as np
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 600], no_pol=no_pol)
    _stack_source(ot, RT)
    th = np.radians(8.0)
    z = _stack_lenses(ot, RT, 10.0, 6)
    RT.add(ot.Lens(ot.TiltedSurface(r=8, normal=[0.0, float(np.sin(th)), float(np.cos(th))]),
                   ot.TiltedSurface(r=8, normal=[0.0, 0.0, 1.0]),
                   n=ot.presets.refraction_index.F2, pos=[0, 0, z], d=2.0))
    z = _stack_lenses(ot, RT, z + 15.0, 6, start=6)
    RT.add(ot.Aperture(ot.RingSurface(r=9, ri=2.5), pos=[0, 0, z - 5.0]))
    z = _stack_lenses(ot, RT, z + 5.0, 6, start=12)
    RT.add(ot.Aperture(ot.RectangularSurface(dim=[1.0, 1.0]), pos=[0.5, 1.0, z - 5.0]))
    z = _stack_lenses(ot, RT, z + 5.0, 5, start=18)
    slit = ot.SlitSurface(dim=[18, 18], dimi=[7.0, 5.0])
    slit.rotate(20)
    RT.add(ot.Aperture(slit, pos=[0, 0, z - 5.0]))
    z = _stack_lenses(ot, RT, z + 5.0, 5, start=23)
    RT.add(ot.Detector(ot.RectangularSurface(dim=[30, 30]), pos=[0, 0, z + 20.0]))
    return RT


def asphere_tilted_scene(ot, no_pol):
    """Two asphere lenses, a tilted plate and two more lenses: the aspheres
    join a run whatever ``cuda_fuse_planar`` says, the plate only with it."""
    import numpy as np
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 200], no_pol=no_pol)
    _stack_source(ot, RT)
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    z = 10.0
    for i in range(2):
        RT.add(ot.Lens(ot.AsphericSurface(r=8, R=60.0, k=-0.8, coeff=[1e-5, -1e-8]),
                       ot.SphericalSurface(r=8, R=-70.0), n=glasses[i], de=0.5, pos=[0, 0, z]))
        z += 15.0
    th = np.radians(8.0)
    RT.add(ot.Lens(ot.TiltedSurface(r=8, normal=[0.0, float(np.sin(th)), float(np.cos(th))]),
                   ot.TiltedSurface(r=8, normal=[0.0, 0.0, 1.0]),
                   n=glasses[1], pos=[0, 0, z], d=2.0))
    _stack_lenses(ot, RT, z + 15.0, 2)
    return RT


def steps_scene(ot, use_hurb, no_pol=False):
    """Every step kind outside the runs around the double Gauss: a colour
    chart 2 m in front of it as an RGB image source, a Gaussian filter, the
    objective (under ``use_hurb`` its ring aperture bends rays, so it is an
    eager step between the runs of 6 and 8), an ideal lens and a detector."""
    from optrace_tpu_torch.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-400, 400, -300, 300, -2001, 200], no_pol=no_pol, use_hurb=use_hurb)
    RT.add(ot.RaySource(ot.presets.image.color_checker([300, 200]), divergence="Isotropic",
                        orientation="Converging", conv_pos=[0, 0, 0], div_angle=1.0,
                        pos=[0, 0, -2000]))
    RT.add(ot.Filter(ot.CircularSurface(r=45), pos=[0, 0, -20],
                     spectrum=ot.TransmissionSpectrum("Gaussian", mu=550.0, sig=60.0,
                                                      val=FILTER_MAX_T)))
    G = double_gauss(with_detector=False)
    RT.add(G)
    z_last = max(L.back.pos[2] for L in G.lenses)
    RT.add(ot.IdealLens(r=35, D=2.0, pos=[0, 0, z_last + 3.0]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[90, 90]), pos=[0, 0, z_last + 70.0]))
    return RT


def double_gauss_spherical_scene(ot, no_pol=True):
    """The double Gauss with a spherical detector in place of its flat one."""
    from optrace_tpu_torch.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-2100, 2100, -2100, 2100, -50001, 180], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=2000.0), divergence="Isotropic", orientation="Converging",
                        conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                        spectrum=ot.presets.light_spectrum.d65))
    G = double_gauss(with_detector=True)
    flat = G.detectors[0]
    G.remove(flat)
    RT.add(G)
    RT.add(ot.Detector(ot.SphericalSurface(r=40, R=-120), pos=[0, 0, float(flat.pos[2])]))
    return RT


# ----------------------------------------------------------------------
# kernels against their plain versions

def capture_run_calls(RT, N, store, seed):
    """Trace one bundle of the scene and record the arguments of every
    call of the run kernel's wrapper: the shapes and inputs that the main
    path gives it."""
    import torch
    from optrace_tpu_torch.tracer import trace_core

    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps()
    gen = torch.Generator(device=RT.device)
    gen.manual_seed(seed)
    with RunRecorder() as rec, torch.no_grad():
        p, s, pols, w, wl = RT._make_source_fn(N)(gen)
        trace_core.trace_bundle(steps, RT.n0, tuple(float(v) for v in RT.outline),
                                p, s, pols, w, wl, RT.no_pol, store_sections=store)
    return rec.calls


def sections_agree(RT_a, RT_b, label):
    """Stored sections of two traces of the same rays: flipped rays within
    the budget, the others within TOL_P. Returns (flips, max abs)."""
    import numpy as np
    pa, pb, wa, wb = RT_a.rays.p_list, RT_b.rays.p_list, RT_a.rays.w_list, RT_b.rays.w_list
    assert pa.shape == pb.shape, label
    flipped = np.any((wa > 0) != (wb > 0), axis=1)
    n_flip = int(flipped.sum())
    assert n_flip <= FLIPS_PER_MRAY * pa.shape[0] / 1e6, f"{label}: {n_flip} flipped rays"
    d = float(np.abs(pa[~flipped] - pb[~flipped]).max())
    assert d <= TOL_P, f"{label}: sections differ by {d}"
    return n_flip, d


def reset_launch_counts():
    from optrace_tpu_torch.ops import cuda_run, cuda_binning, cuda_trace
    cuda_run.reset_launch_counts()
    cuda_binning.reset_launch_counts()
    cuda_trace.reset_launch_counts()


class PlainRunCounter:
    """Counts the runs that the trace sends to the plain loop
    (``trace_core.conic_run_reference``) while the ``with`` block runs."""

    def __enter__(self):
        from optrace_tpu_torch.tracer import trace_core
        self.module, self.calls = trace_core, 0
        self.real = trace_core.conic_run_reference

        def counter(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)
        trace_core.conic_run_reference = counter
        return self

    def __exit__(self, *exc):
        self.module.conic_run_reference = self.real


class RunRecorder:
    """Records the arguments of every call that the trace makes to the run
    kernel's wrapper while the ``with`` block runs."""

    def __enter__(self):
        from optrace_tpu_torch.tracer import trace_core
        self.module, self.calls = trace_core, []
        self.real = trace_core.conic_run

        def recorder(p, s, w, n_tab, med_idx, steps, pol=None, store=True, plan=None, out=None):
            self.calls.append(dict(p=p, s=s, w=w, n_tab=n_tab, med_idx=med_idx, steps=steps,
                                   pol=pol, store=store, plan=plan, out=out))
            return self.real(p, s, w, n_tab, med_idx, steps, pol=pol, store=store, plan=plan, out=out)
        trace_core.conic_run = recorder
        return self

    def __exit__(self, *exc):
        self.module.conic_run = self.real


def compare_run(c, label, poisoned=False):
    """Kernel and plain version on one recorded call: errors, flips and
    counts. Raises on disagreement. Returns the comparison and the plain
    version's stored weights (None for a call that stores nothing). A
    difference counts NaN against NaN and inf against the same inf as 0, and
    NaN or inf against anything else as inf; only a call with ``poisoned``
    rays may put out a value that is not finite."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference

    args = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
    kw = dict(pol=c["pol"], store=c["store"])
    (pk, sk, wk, qk), (ck, ypk, ywk, yqk) = conic_run(*args, plan=c["plan"], **kw)
    (pr, sr, wr, qr), (cr, ypr, ywr, yqr) = conic_run_reference(*args, **kw)
    torch.cuda.synchronize()

    flipped = (wk > 0) != (wr > 0)
    if c["store"]:
        flipped = flipped | torch.any((ywk > 0) != (ywr > 0), dim=0)
    keep = ~flipped

    def err(a, b):
        a, b = a[keep], b[keep]
        d = (a - b).abs()
        d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, torch.where(d.isnan(), float("inf"), d))
        return float(d.max()) if d.numel() else 0.0

    def rel_w(a, b, m):
        d = ((a - b).abs() / b.abs().clamp(min=1e-30))[m]
        return float(d.max()) if d.numel() else 0.0

    e_state = max(err(pk, pr), err(sk, sr))
    e_w = rel_w(wk, wr, keep & (wr > 0))
    e_pol = err(qk, qr) if qk is not None else 0.0
    e_sec = 0.0
    if c["store"]:
        e_sec = max(err(ypk.transpose(0, 1), ypr.transpose(0, 1)),
                    err(yqk.transpose(0, 1), yqr.transpose(0, 1)) if yqk is not None else 0.0)
        e_w = max(e_w, rel_w(ywk, ywr, (ywr > 0) & keep[None, :]))
    flips = int(flipped.sum())
    d_counts = int((ck - cr).abs().sum())
    assert d_counts <= 2 * flips, f"{label}: counts [miss, tir, outline, ill] differ by {d_counts}"
    assert max(e_state, e_sec) <= TOL_P, f"{label}: position/direction error {e_state} {e_sec}"
    assert e_w <= TOL_W_REL, f"{label}: weight error {e_w}"
    assert e_pol <= TOL_POL, f"{label}: polarization error {e_pol}"
    assert torch.isfinite(wk).all() and (poisoned or torch.isfinite(pk).all())
    return dict(flips=flips, e_state=e_state, e_w=e_w, e_pol=e_pol, e_sec=e_sec,
                counts_equal=d_counts == 0, counts=ck.sum(dim=0).tolist()), ywr


def check_run_calls(calls, label, plain_reps=3):
    """Kernel against plain version on the recorded calls: errors, counts,
    hit/miss flips, times and the bound, which is reckoned step by step
    from the kinds in the recorded step list and from the rays that are
    alive when they reach each step. ``ms`` is the kernel's device time by
    the profiler; ``ms_between_events`` times one launch between two CUDA
    events and holds the host's gap before the launch too. Raises on
    disagreement."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference, step_tag

    res = dict(name=label, N=int(calls[0]["p"].shape[0]), steps=[len(c["steps"]) for c in calls],
               step_kinds={}, media_rows_read=[], max_abs_err=0.0, max_abs_err_sections=0.0,
               max_rel_err_w=0.0, flips=0, counts_equal=True, counts=[0, 0, 0, 0],
               ms=0.0, ms_between_events=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0,
               ray_steps_alive=0, operations=0)
    bound_bytes_ms = bound_ops_ms = 0.0
    for c in calls:
        args = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
        kw = dict(pol=c["pol"], store=c["store"])
        cmp_, ywr = compare_run(c, label)
        N, L = c["p"].shape[0], len(c["steps"])
        tags = [step_tag(x) for x in c["steps"]]
        # media rows this call reads: an absorb step reads none
        M = len({r for pair, t in zip(c["med_idx"], tags) if not t.startswith("absorb") for r in pair})
        res["media_rows_read"].append(M)
        for t in tags:
            res["step_kinds"][t] = res["step_kinds"].get(t, 0) + 1
        res["flips"] += cmp_["flips"]
        res["max_abs_err"] = max(res["max_abs_err"], cmp_["e_state"], cmp_["e_pol"])
        res["max_abs_err_sections"] = max(res["max_abs_err_sections"], cmp_["e_sec"])
        res["max_rel_err_w"] = max(res["max_rel_err_w"], cmp_["e_w"])
        res["counts_equal"] = res["counts_equal"] and cmp_["counts_equal"]
        res["counts"] = [a + b for a, b in zip(res["counts"], cmp_["counts"])]

        res["ms"] += device_kernel_ms(lambda: conic_run(*args, plan=c["plan"], **kw), "conic_run_kernel")
        res["ms_between_events"] += cuda_ms(lambda: conic_run(*args, plan=c["plan"], **kw))
        res["plain_ms"] += cuda_ms(lambda: conic_run_reference(*args, **kw), reps=plain_reps,
                                   warmup=1 if plain_reps > 1 else 0)

        # bound: each input read once, each output written once; operations
        # by step kind for the rays alive when they reach the step
        with_pol = c["pol"] is not None
        state_b = 28 + (12 if with_pol else 0)
        nbytes = N * (2 * state_b + 4 * M) + L * 16
        if c["store"]:
            nbytes += N * L * (28 if with_pol else 16)
        if ywr is None:     # count with a stored plain run
            _, (_, _, ywr, _) = conic_run_reference(*args, pol=c["pol"], store=True)
        alive = [int((c["w"] > 0).sum())] + [int(v) for v in (ywr[:-1] > 0).sum(dim=1).tolist()]
        del ywr
        ops = sum(a * RUN_OPS_PER_RAY_STEP[t] for a, t in zip(alive, tags))
        res["bytes"] += nbytes
        res["ray_steps_alive"] += sum(alive)
        res["operations"] += ops
        bound_bytes_ms += nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms += ops / F32_OPS_PER_S * 1e3
    assert res["flips"] <= FLIPS_PER_MRAY * res["N"] / 1e6 * len(calls), f"{label}: {res['flips']} flips"
    res["bound_ms"] = max(bound_bytes_ms, bound_ops_ms)
    res["bound_by"] = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    res["bound_bytes_ms"], res["bound_ops_ms"] = bound_bytes_ms, bound_ops_ms
    res["library_ms"] = None
    return res


def _nan_slots(out):
    """Fresh buffers of the shapes of the SectionSlots ``out``, all NaN,
    with its first column."""
    import torch

    def nan(t):
        return None if t is None else torch.full_like(t, float("nan"))
    return type(out)(nan(out.p), nan(out.w), nan(out.n), nan(out.pol), out.col0)


def _slots_agree(a, b, L, label):
    """Assert every buffer of two SectionSlots bit for bit, the columns
    outside the run's L NaN and those of the run written."""
    import torch
    cols = torch.zeros(a.nt, dtype=torch.bool, device=a.p.device)
    cols[a.col0:a.col0 + L] = True
    for name in ("p", "w", "n", "pol"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, f"{label}: {name}"
            continue
        assert _same_bits(x, y), f"{label}: {name} differs in {_differing_bits(x, y)} values"
        assert bool(torch.isnan(x[:, ~cols]).all()), f"{label}: {name} written outside its columns"
        assert not bool(torch.isnan(x[:, cols]).any()), f"{label}: {name} left a run column unwritten"


def check_slot_calls(calls, label, plain_reps=3):
    """Kernel 1 writing its sections into the trace's buffers
    (``SectionSlots``: the run's columns of (N, nt, 3) and (N, nt)) against
    ``conic_run_reference(out=...)`` on the recorded calls, both into fresh
    NaN-filled buffers: every buffer, the final state and the counts bit
    for bit, the columns outside the run left NaN. A run with an absorb step
    is run again with the step's media pair moved to a row that the step
    before it did not read: the absorb step's n column is that (ambient)
    row, for live and dead rays. Device ms of the kernel, plain ms and the
    bound (as :func:`check_run_calls`, with 4 B more a ray-step for n)."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference, step_tag

    res = dict(name=label, N=int(calls[0]["p"].shape[0]), steps=[len(c["steps"]) for c in calls],
               columns=[[c["out"].col0, c["out"].col0 + len(c["steps"])] for c in calls],
               nt=calls[0]["out"].nt, max_abs_err=0.0, bit_equal=True, untouched_columns_nan=True,
               ambient_rows_checked=0, ms=0.0, plain_ms=0.0, bytes=0, operations=0, library_ms=None)
    bound_bytes_ms = bound_ops_ms = 0.0
    for c in calls:
        args = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
        kw = dict(pol=c["pol"], store=True)
        N, L = c["p"].shape[0], len(c["steps"])
        sk, sr = _nan_slots(c["out"]), _nan_slots(c["out"])
        state_k, (ck, *none_k) = conic_run(*args, plan=c["plan"], out=sk, **kw)
        state_r, (cr, *_) = conic_run_reference(*args, out=sr, **kw)
        torch.cuda.synchronize()
        assert none_k == [None, None, None]
        assert all(x is None or _same_bits(x, y) for x, y in zip(state_k, state_r)), f"{label}: state"
        assert torch.equal(ck, cr), f"{label}: counts"
        _slots_agree(sk, sr, L, label)          # so max_abs_err stays 0.0
        tags = [step_tag(x) for x in c["steps"]]
        absorbs = [j for j, t in enumerate(tags) if t.startswith("absorb")]
        M = c["n_tab"].shape[0]
        if absorbs and M > 1:
            med = list(c["med_idx"])
            for j in absorbs:
                prev = med[j - 1][1] if j else med[j][0]
                moved = (prev + 1) % M
                med[j] = (moved, moved)
            ak, ar = _nan_slots(c["out"]), _nan_slots(c["out"])
            conic_run(*args[:4], med, args[5], out=ak, **kw)
            conic_run_reference(*args[:4], med, args[5], out=ar, **kw)
            _slots_agree(ak, ar, L, label + ",ambient")
            for j in absorbs:
                assert _same_bits(ak.n[:, ak.col0 + j], c["n_tab"][med[j][1]]), f"{label}: ambient n"
            res["ambient_rows_checked"] += len(absorbs)
            del ak, ar
        res["ms"] += device_kernel_ms(lambda: conic_run(*args, plan=c["plan"], out=sk, **kw),
                                      "conic_run_kernel")
        res["plain_ms"] += cuda_ms(lambda: conic_run_reference(*args, out=sr, **kw), reps=plain_reps,
                                   warmup=1 if plain_reps > 1 else 0)
        with_pol = c["pol"] is not None
        state_b = 28 + (12 if with_pol else 0)
        M_read = len({r for pair, t in zip(c["med_idx"], tags) if not t.startswith("absorb") for r in pair})
        nbytes = N * (2 * state_b + 4 * M_read) + L * 16 + N * L * (20 + (12 if with_pol else 0))
        w_cols = sr.w[:, sr.col0:sr.col0 + L]
        alive = [int((c["w"] > 0).sum())] + [int(v) for v in (w_cols[:, :-1] > 0).sum(dim=0).tolist()]
        ops = sum(a * RUN_OPS_PER_RAY_STEP[t] for a, t in zip(alive, tags))
        res["bytes"] += nbytes
        res["operations"] += ops
        bound_bytes_ms += nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms += ops / F32_OPS_PER_S * 1e3
        del sk, sr
    res["bound_ms"] = max(bound_bytes_ms, bound_ops_ms)
    res["bound_by"] = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    res["bound_bytes_ms"], res["bound_ops_ms"] = bound_bytes_ms, bound_ops_ms
    return res


def stress_run_call(c, label, spread, tilt, seed, poison=False):
    """The recorded call with its rays spread out and tilted, so that rays
    miss apertures, leave z-ranges and give brackets without a sign change:
    kernel against plain version, all four counters. ``poison`` also gives
    three rays in every 1000 a direction with sz = 0, a NaN position and an
    infinite position: brackets that never settle, so their warps run the
    asphere solve to its last iteration."""
    import torch
    g = torch.Generator(device=c["p"].device)
    g.manual_seed(seed)
    p = c["p"].clone()
    p[:, :2] = p[:, :2] * spread
    s = c["s"].clone()
    s[:, :2] = s[:, :2] + tilt * (torch.rand(s[:, :2].shape, generator=g, device=s.device) * 2 - 1)
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    if poison:
        s[0::1000] = torch.tensor([1.0, 0.0, 0.0], device=s.device)
        p[1::1000, 2] = float("nan")
        p[2::1000, 0] = float("inf")
    cmp_, _ = compare_run(dict(c, p=p, s=s), label, poisoned=poison)
    return dict(name=label, flips=cmp_["flips"], counts_equal=cmp_["counts_equal"],
                poisoned_rays=3 * len(range(0, p.shape[0], 1000)) if poison else 0,
                counts_miss_tir_outline_ill=cmp_["counts"],
                max_abs_err=max(cmp_["e_state"], cmp_["e_sec"], cmp_["e_pol"]))


def check_binning(px, py, w, wl, extent, label, Nx=NX, Ny=NY):
    """Binning kernel against its plain version (``bin_xyzw_fixed``: the same
    fixed-point sums, bit for bit), twice on the same input (bit for bit),
    against the same sums taken in f64, and two library yardsticks on
    precomputed keys and values, which leave out the index, the mask and the
    observer lookup that the kernel does: one f32 index_add_ (``library_ms``;
    its sums depend on the order of the atomics) and one int64 index_add_ of
    the fixed-point integers (``library_int64_ms``: the same order-free
    function as the kernel). ``ms`` is the device time of all the kernel's
    launches and its memset in one call, ``ms_by_launch`` each of them, the
    yardsticks' by the profiler too."""
    import torch
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda, scratch_layout
    from optrace_tpu_torch.ops.binning import (binning_indices_2d, bin_xyzw_fixed, bin_xyzw,
                                               fixed_point_exponent, pow2)
    from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer

    img_k = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent)
    img_k2 = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent)
    img_r = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, extent)
    # accumulation into an image that holds a value already
    base = torch.full((Ny, Nx, 4), 0.25, dtype=torch.float32, device=px.device)
    acc_k = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent, out=base.clone())
    acc_r = bin_xyzw_fixed(px, py, w, wl, Nx, Ny, extent, out=base.clone())
    torch.cuda.synchronize()
    err = float((img_k - img_r).abs().max())
    assert _same_bits(img_k, img_r) and _same_bits(acc_k, acc_r), \
        f"{label}: binning kernel differs from bin_xyzw_fixed by {err}"
    assert _same_bits(img_k, img_k2), f"{label}: two calls of the binning kernel differ"
    scale = float(img_r.abs().max())
    # against the same sums taken in f64 (same f32 keys and values, so that
    # no ray changes its pixel); the f32 index_add_ version beside it
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    keys = yi * Nx + xi
    vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
    img_64 = torch.zeros((Ny * Nx, 4), dtype=torch.float64, device=px.device)
    img_64.index_add_(0, keys, vals.double())
    img_64 = img_64.view(Ny, Nx, 4)
    err_k64 = float((img_k.double() - img_64).abs().max())
    err_f32_64 = float((bin_xyzw(px, py, w, wl, Nx, Ny, extent).double() - img_64).abs().max())
    rays_in_a_pixel = int(torch.bincount(keys[wm != 0]).max()) if bool((wm != 0).any()) else 0
    tol = TOL_BIN * max(scale, 1.0)
    # the f32 index_add_ version: one f32 rounding a ray in the fullest pixel
    tol_plain = max(TOL_BIN, TOL_BIN_PER_RAY * rays_in_a_pixel) * max(scale, 1.0)
    assert torch.isfinite(img_k).all()
    assert err_k64 <= tol, f"{label}: binning error {err_k64} against f64 sums (limit {tol})"
    assert err_f32_64 <= tol_plain, f"{label}: f32 version {err_f32_64} off the f64 sums (limit {tol_plain})"
    # the kernel's four launches and the memset of its tile counts
    ms = device_kernel_ms(lambda: bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent),
                          ("bin_xyzw_", "Memset"), per_call=True)
    parts = {k: device_kernel_ms(lambda: bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent), k)
             for k in BIN_LAUNCHES}
    ms_events = cuda_ms(lambda: bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent))
    plain_ms = cuda_ms(lambda: bin_xyzw_fixed(px, py, w, wl, Nx, Ny, extent))

    # the yardsticks' own kernel times, as the kernel's: no launch gap in either
    out = torch.zeros((Ny * Nx, 4), dtype=torch.float32, device=px.device)
    library_ms = device_kernel_ms(lambda: out.index_add_(0, keys, vals), "ndex")
    library_ms_events = cuda_ms(lambda: out.index_add_(0, keys, vals))
    q = torch.round(vals.double() * pow2(fixed_point_exponent(w))).to(torch.int64)
    out64 = torch.zeros((Ny * Nx, 4), dtype=torch.int64, device=px.device)
    library_int64_ms = device_kernel_ms(lambda: out64.index_add_(0, keys, q), "ndex")
    del q, out64

    N = px.shape[0]
    # the function's own bytes: the rays in and the image out. The kernel's
    # scratch (the sorted records, the plan and the split tiles' sums) is its
    # working memory, not the function's, and is reported apart (scratch_bytes)
    nbytes = 16 * N + 16 * Nx * Ny
    scratch_bytes = scratch_layout(N, Nx, Ny)["total"]
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = N * BIN_OPS_PER_RAY / F32_OPS_PER_S * 1e3
    return dict(name=label, N=N, image=[Ny, Nx, 4], max_abs_err=err, bit_equal=True,
                repeat_bit_equal=True, image_max=scale, max_abs_err_vs_f64=err_k64,
                f32_index_add_max_abs_err_vs_f64=err_f32_64,
                rays_in_fullest_pixel=rays_in_a_pixel, tolerance_vs_f64=tol, tolerance_plain=tol_plain,
                rays_binned=int((wm != 0).sum()), ms=ms, ms_by_launch=parts,
                ms_between_events=ms_events, plain_ms=plain_ms, library_ms=library_ms,
                library_ms_between_events=library_ms_events, library_int64_ms=library_int64_ms,
                bytes=nbytes,
                scratch_bytes=scratch_bytes,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations")


class BinRecorder:
    """Records the inputs of every call that ``module`` makes to the binning
    kernel's wrapper while the ``with`` block runs."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.real = self.module.bin_xyzw_cuda

        def recorder(px, py, w, wl, Nx, Ny, extent, out=None):
            self.calls.append((px, py, w, wl, Nx, Ny, extent))
            return self.real(px, py, w, wl, Nx, Ny, extent, out=out)
        self.module.bin_xyzw_cuda = recorder
        return self

    def __exit__(self, *exc):
        self.module.bin_xyzw_cuda = self.real


class RayCounter:
    """Counts the rays traced while the ``with`` block runs (``rays``), and
    the traces that traced them (``traces``): the sections each stored trace
    hands to its storage (``RayStorage.fill``), each call of a fused render
    step with its batch (a graph's replay traces the batch it was captured
    for), and each call of a design render with its source rays
    (``diff.trace_bundle``)."""

    def __enter__(self):
        from optrace_tpu_torch.parallel import render
        from optrace_tpu_torch.tracer import diff
        from optrace_tpu_torch.tracer.ray_storage import RayStorage
        self.rays = self.traces = 0
        self.patched = [(RayStorage, "fill"), (render, "make_fused_render_multi"),
                        (diff, "trace_bundle")]
        self.reals = [getattr(owner, attr) for owner, attr in self.patched]
        fill, make_render, trace_bundle = self.reals

        def counted_fill(storage, p, *args, **kw):
            self.rays, self.traces = self.rays + int(p.shape[0]), self.traces + 1
            return fill(storage, p, *args, **kw)

        def counted_make_render(RT, N_batch, *args, **kw):
            step, exts = make_render(RT, N_batch, *args, **kw)

            def counted_step(gen):
                self.rays, self.traces = self.rays + int(N_batch), self.traces + 1
                return step(gen)
            return counted_step, exts

        def counted_trace_bundle(steps, n0_fn, outline, p, *args, **kw):
            self.rays, self.traces = self.rays + int(p.shape[0]), self.traces + 1
            return trace_bundle(steps, n0_fn, outline, p, *args, **kw)

        for (owner, attr), f in zip(self.patched, (counted_fill, counted_make_render,
                                                   counted_trace_bundle)):
            setattr(owner, attr, f)
        return self

    def __exit__(self, *exc):
        for (owner, attr), real in zip(self.patched, self.reals):
            setattr(owner, attr, real)


def check_conic_step():
    """The single-step kernel on the probe's inputs (bench.py:_bench_trace_step:
    N = 10⁶ rays from numpy's default_rng(0), rho = 1/20, k = −0.5, z-range
    0 … 0.3, aperture 3, n 1.0 → 1.52): 10 chained calls with the weights
    revived to 1e-3 between them, kernel against plain version after each."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_trace import conic_step, conic_step_reference

    N = N_RAYS
    rng = np.random.default_rng(0)
    p = np.column_stack([rng.uniform(-2, 2, (N, 2)), np.full(N, -5.0)]).astype(np.float32)
    s = rng.normal(0, 0.05, (N, 3)).astype(np.float32)
    s[:, 2] = 1.0
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1, N).astype(np.float32)
    p, s, w = (torch.from_numpy(a).cuda() for a in (p, s, w))
    n1 = torch.full((N,), 1.0, device="cuda")
    n2 = torch.full((N,), 1.52, device="cuda")
    kw = dict(rho=1 / 20.0, k=-0.5, z_min_rel=0.0, z_max_rel=0.3, r_ap=3.0)

    before = conic_step.launches
    err, flips, alive = 0.0, 0, 0
    sk, sr = (p, s, w), (p, s, w)
    for _ in range(10):
        alive += N          # every ray is revived before the call
        sk = conic_step(sk[0], sk[1], torch.clamp(sk[2], min=1e-3), n1, n2, **kw)
        sr = conic_step_reference(sr[0], sr[1], torch.clamp(sr[2], min=1e-3), n1, n2, **kw)
        torch.cuda.synchronize()
        # per ray, the largest difference of any component; a ray beyond the
        # tolerance hit in one version and missed in the other
        d = torch.cat([(sk[0] - sr[0]).abs(), (sk[1] - sr[1]).abs(),
                       (sk[2] - sr[2]).abs()[:, None]], dim=-1).amax(dim=-1)
        flipped = d > TOL_P
        flips += int(flipped.sum())
        err = max(err, float(d[~flipped].max()))
        assert all(bool(torch.isfinite(t).all()) for t in sk)
    assert conic_step.launches == before + 10
    assert flips <= FLIPS_PER_MRAY * N / 1e6, f"conic_step: {flips} flipped rays"
    # the weights after the first step: transmission of an air-glass surface
    w1 = conic_step(p, s, w, n1, n2, **kw)[2]
    ratio = float((w1 / w).mean())
    assert 0.90 < ratio < 0.97, ratio
    launches_probe = conic_step.launches - before - 1
    ms = device_kernel_ms(lambda: conic_step(p, s, w, n1, n2, **kw), "conic_step_kernel", calls=20)
    ms_events = cuda_ms(lambda: conic_step(p, s, w, n1, n2, **kw), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: conic_step_reference(p, s, w, n1, n2, **kw))
    nbytes = 64 * N
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = alive / 10 * STEP_OPS_PER_RAY / F32_OPS_PER_S * 1e3
    return dict(name="conic_step", N=N, calls=10, max_abs_err=err, flips=flips,
                mean_transmission=ratio, launches=launches_probe, ms=ms,
                ms_between_events=ms_events, plain_ms=plain_ms,
                bytes=nbytes, bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
                bound_bytes_ms=bound_bytes_ms, bound_ops_ms=bound_ops_ms, library_ms=None)


def device_kernel_ms(fn, name, calls=10, per_call=False):
    """Device time in ms of one launch of the kernels whose name holds
    ``name``, or one of the names of a tuple (with ``per_call``: of all of
    them in one call of fn()), by
    torch.profiler over ``calls`` calls of fn(): the kernels alone, without
    the host's gap before their launch."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):        # a trace now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and any(k in ev.key for k in names):
                us += ev.self_device_time_total
                n += ev.count
        # per call, a trace that lost some launches' events would read low
        if n > 0 and (not per_call or n % calls == 0):
            break
        time.sleep(1.0)
    if n == 0:
        # every trace lost the device events: time one call between CUDA
        # events instead (the host's gaps between launches included)
        print(f"chip_smoke: the profiler recorded no kernel named {name} in 5 traces; "
              "timed between CUDA events", file=sys.stderr)
        return cuda_ms(fn, reps=calls)
    return us / 1e3 / (calls if per_call else n)


def device_launches(fn):
    """Kernel launches on the device during fn(), counted by torch.profiler."""
    return device_busy(fn)[0]


def device_busy(fn):
    """(kernel launches, device-busy ms, wall ms) during fn(), by
    torch.profiler: the sum of the kernels' own device times, and the host
    clock's time of the same profiled call up to the device's end."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    n = sum(ev.count for ev in evs)
    assert n > 0, "the profiler recorded no kernel on the device"
    return int(n), sum(ev.self_device_time_total for ev in evs) / 1e3, wall_ms


def run_partition(ot, RT, sink_masks=()):
    from optrace_tpu_torch.tracer.trace_core import _partition_runs
    return [len(i) for k, i in _partition_runs(RT._build_steps(), list(sink_masks), RT.use_hurb)
            if k == "run"]


# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# the design and analysis layer: each phase drives its path with the
# counters set to 0 just before and returns its launches and its rows

def arizona_eye_scene(ot, no_pol=True):
    """The Arizona eye (``presets/geometry.py:arizona_eye``, relaxed, 5.7 mm
    pupil) looking at a point at infinity: a parallel bundle at 555 nm
    filling the pupil, the spherical retina as its detector."""
    from optrace_tpu_torch.presets.geometry import arizona_eye
    RT = ot.Raytracer(outline=[-15, 15, -15, 15, -12, 30], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=3.0), divergence="None", pos=[0, 0, -10],
                        spectrum=ot.LightSpectrum("Monochromatic", wl=555.0)))
    RT.add(arizona_eye())
    return RT


def design_phase(ot, smi, n=N_RAYS):
    """make_parameterized_render of the double Gauss, spot_loss and its
    gradient with respect to all 14 curvatures: autograd (plain loop) against
    central differences (kernel route), the plain route's loss against the
    kernel's, the repair (a render at a changed curvature without a gradient
    traces the changed surface on both routes), five normalised-gradient
    steps. Returns the kernel 1 launches of the evaluations without a
    gradient."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss, steps_with_params
    from optrace_tpu_torch.tracer.trace_core import trace_bundle
    go = ot.global_options

    RT = double_gauss_scene(ot, no_pol=True)
    render, params0 = make_parameterized_render(RT, n, extent=list(DESIGN_EXT), Nx=DESIGN_PIXELS,
                                                Ny=DESIGN_PIXELS, soft_bin=True)
    loss_fn = spot_loss(render)
    idx = [i for i, p in enumerate(params0) if "rho" in p]
    assert len(idx) == 14, idx
    rhos0 = torch.stack([params0[i]["rho"] for i in idx])
    # a cemented interface (L_3 back, L_4 front: 1e-6 mm apart) is one
    # design parameter: moved alone, one of its two surfaces crosses the
    # other within a change of 1e-8 in curvature and the rays between
    # them are lost. Its two gradients are summed for a design step, and
    # the finite differences are taken on the other curvatures.
    zs = [float(params0[i]["pos"][2]) for i in idx]
    cemented = [(k, k + 1) for k in range(len(idx) - 1) if abs(zs[k + 1] - zs[k]) < CEMENT_GAP]
    assert cemented == [(7, 8)], cemented
    free = [k for k in range(len(idx)) if not any(k in pair for pair in cemented)]

    def tied(g):
        g = g.clone()
        for a, b in cemented:
            g[a] = g[b] = g[a] + g[b]
        return g

    def params_at(rhos):
        params = [dict(p) for p in params0]
        for k, i in enumerate(idx):
            params[i]["rho"] = rhos[k]
        return params

    def value_and_grad(rhos):
        r = rhos.detach().clone().requires_grad_()
        val = loss_fn(params_at(r), DESIGN_SEED, DESIGN_EXT)
        val.backward()
        return float(val.detach()), r.grad

    def loss_only(rhos):
        with torch.no_grad():
            return float(loss_fn(params_at(rhos), DESIGN_SEED, DESIGN_EXT))

    value_and_grad(rhos0)                   # warm-up of both routes
    loss_only(rhos0)
    torch.cuda.synchronize()
    evals = dict(kernel=0, plain=0)         # evaluations by route, for the launch counts
    reset_launch_counts()
    with PlainRunCounter() as plain:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        L_grad, g0 = value_and_grad(rhos0)
        torch.cuda.synchronize()
        t_vg = time.perf_counter() - t0
        evals["plain"] += 1
        mem_vg = torch.cuda.max_memory_allocated()
        assert conic_run.launches == 0 and plain.calls == 2, (conic_run.launches, plain.calls)
        t0 = time.perf_counter()
        L_kernel = loss_only(rhos0)
        torch.cuda.synchronize()
        t_loss = time.perf_counter() - t0
        evals["kernel"] += 1
        assert conic_run.launches == 2 and plain.calls == 2, (conic_run.launches, plain.calls)
        go.cuda_trace = False
        try:
            L_plain = loss_only(rhos0)
        finally:
            go.cuda_trace = True
        evals["plain"] += 1
        assert conic_run.launches == 2 and plain.calls == 4, (conic_run.launches, plain.calls)
        assert np.isfinite(g0.cpu().numpy()).all() and 0 < L_kernel < DESIGN_EXT[1]
        d_plain = abs(L_plain - L_kernel) / L_kernel
        d_grad_route = abs(L_grad - L_kernel) / L_kernel
        assert d_plain <= TOL_LOSS_REL and d_grad_route <= TOL_LOSS_REL, (d_plain, d_grad_route)

        # central differences through the kernel route, on the curvatures
        # with the largest gradients
        fd = []
        order = [k for k in torch.argsort(g0.abs(), descending=True).tolist() if k in free]
        for k in order[:4]:
            g_auto = float(g0[k])
            if abs(g_auto) <= FD_GRAD_FLOOR:
                continue
            eps = FD_EPS_REL * abs(float(rhos0[k]))
            up, dn = rhos0.clone(), rhos0.clone()
            up[k] += eps
            dn[k] -= eps
            eps_true = (float(up[k]) - float(dn[k])) / 2        # the steps as f32 rounded them
            g_fd = (loss_only(up) - loss_only(dn)) / (2 * eps_true)
            evals["kernel"] += 2
            fd.append(dict(surface=idx[k], rho=float(rhos0[k]), eps=eps_true, autograd=g_auto,
                           central_difference=g_fd, rel_diff=abs(g_auto - g_fd) / abs(g_fd)))
            assert abs(g_auto - g_fd) <= FD_RTOL * abs(g_fd), fd[-1]
        assert len(fd) >= 3, fd

        # the repair: a changed curvature without a gradient traces the
        # changed surface, bit for bit the same on the kernel and plain routes
        k3 = idx.index(3)
        rhos_e = rhos0.clone()
        rhos_e[k3] += 1e-4
        steps_e = steps_with_params(RT._build_steps(), params_at(rhos_e))
        rays = RT._make_source_fn(n)(ot.make_generator(DESIGN_SEED))
        outline = tuple(float(v) for v in RT.outline)
        with torch.no_grad():
            sec_k = trace_bundle(steps_e, RT.n0, outline, *rays, True)["p"]
            go.cuda_trace = False
            try:
                sec_p = trace_bundle(steps_e, RT.n0, outline, *rays, True)["p"]
            finally:
                go.cuda_trace = True
            sec_0 = trace_bundle(RT._build_steps(), RT.n0, outline, *rays, True)["p"]
        evals["kernel"] += 2
        evals["plain"] += 1
        bit_equal = bool(torch.equal(sec_k, sec_p))
        moved = float((sec_k - sec_0).abs().max())
        assert bit_equal and moved > 1e-4, (bit_equal, moved)
        L_e_kernel = loss_only(rhos_e)
        L_e_grad, _ = value_and_grad(rhos_e)
        evals["kernel"] += 1
        evals["plain"] += 1
        d_changed = abs(L_e_kernel - L_e_grad) / L_e_grad
        assert d_changed <= TOL_LOSS_REL and abs(L_e_kernel - L_kernel) > 1e-6 * L_kernel, \
            (d_changed, L_e_kernel, L_kernel)
        del sec_k, sec_p, sec_0, rays

        # five normalised-gradient steps; the last image without a gradient
        rhos, history, t_steps = rhos0.clone(), [], []
        for _ in range(DESIGN_STEPS):
            t0 = time.perf_counter()
            val, g = value_and_grad(rhos)
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
            evals["plain"] += 1
            history.append(val)
            g = tied(g)
            rhos = rhos - DESIGN_LR * g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
        final = loss_only(rhos)
        evals["kernel"] += 1
        history.append(final)
        assert final < history[0], history
        n_kernel, n_plain = conic_run.launches, plain.calls
    assert n_kernel == 2 * evals["kernel"] and n_plain == 2 * evals["plain"], (n_kernel, n_plain, evals)
    assert conic_run.variant_launches == {(False, True): n_kernel}, conic_run.variant_launches
    emit(dict(phase="design", gpu=smi, scene="double_gauss", N=n, image=[DESIGN_PIXELS] * 2,
              extent=list(DESIGN_EXT), soft_bin=True, curvatures=len(idx),
              seconds_value_and_grad=t_vg, seconds_loss_only=t_loss,
              seconds_value_and_grad_steps=t_steps,
              max_memory_allocated_GB_value_and_grad=mem_vg / 1e9,
              loss=L_kernel, loss_plain_route=L_plain, loss_grad_route=L_grad,
              loss_rel_diff_plain_vs_kernel=d_plain, loss_rel_diff_grad_vs_kernel=d_grad_route,
              tolerance_loss_rel=TOL_LOSS_REL, gradient=g0.tolist(),
              finite_differences=fd, fd_rtol=FD_RTOL, fd_gradient_floor=FD_GRAD_FLOOR,
              changed_rho=dict(surface=3, drho=1e-4, kernel_vs_plain_sections_bit_equal=bit_equal,
                               sections_moved_max_mm=moved,
                               loss_rel_diff_kernel_vs_grad_route=d_changed),
              steps=dict(lr=DESIGN_LR, losses=history, cemented_pairs=[[idx[a], idx[b]] for a, b in cemented]),
              evaluations=evals,
              launches=dict(conic_run=n_kernel, plain_run=n_plain,
                            per_evaluation_without_gradient=2, per_evaluation_with_gradient=0)))
    return {"conic_run[nopol,store]@design": n_kernel}


def focus_phase(ot, smi, n=N_RAYS, subset=FOCUS_SUBSET):
    """A stored 10⁶-ray trace of the double Gauss, focus_search with all four
    methods from the sections kept on the card, the TMA's paraxial image
    beside the RMS focus, the card's cost sweep against the CPU's; then the
    trace's detector_image as the PSF of the convolve phase."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.analysis import focus
    from optrace_tpu_torch.image import render_image as render_image_mod

    RT = double_gauss_scene(ot, no_pol=True)
    RT.trace(20000)
    RT.focus_search("Irradiance Variance", z_start=float(RT.detectors[0].pos[2]))     # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    RT.trace(n)
    t_trace = time.perf_counter() - t0
    assert conic_run.launches == 2 and conic_run.variant_launches == {(False, True): 2}
    n_trace = conic_run.launches
    z_det = float(RT.detectors[0].pos[2])
    results = {}
    for method in RT.focus_search_methods:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, fd = RT.focus_search(method, z_start=z_det)
        torch.cuda.synchronize()
        results[method] = dict(z=res.x, cost=res.fun, seconds=time.perf_counter() - t0,
                               rays=fd["N"], bounds=fd["bounds"],
                               peak_device_bytes=int(torch.cuda.max_memory_allocated() - base))
    assert conic_run.launches == n_trace and bin_xyzw_cuda.launches == 0
    bounds = results["RMS Spot Size"]["bounds"]
    z_rms = results["RMS Spot Size"]["z"]
    z_tma = RT.tma().image_position(float(RT.ray_sources[0].pos[2]))
    for method, r in results.items():
        assert bounds[0] < r["z"] < bounds[1] and np.isfinite(r["cost"]), (method, r)
        assert abs(r["z"] - z_rms) < 0.5, (method, r["z"], z_rms)
    assert abs(z_rms - z_tma) < 1.0, (z_rms, z_tma)

    # the card's sweep against the CPU's on a subset of the ray lines
    q0, m, w = RT._focus_ray_lines(bounds, None)
    q0, m, w = q0[:subset].float(), m[:subset].float(), w[:subset].float()
    z = torch.linspace(z_rms - 1.0, z_rms + 1.0, FOCUS_PLANES, dtype=torch.float32)
    sweep = {}
    for method in RT.focus_search_methods:
        n_px = focus.histogram_side(q0.shape[0])
        card = focus.cost_sweep(z.to(q0.device), q0, m, w, method, n_px).cpu().numpy()
        cpu = focus.cost_sweep(z, q0.cpu(), m.cpu(), w.cpu(), method, n_px).numpy()
        d = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        assert d <= TOL_FOCUS_COST, (method, d)
        sweep[method] = d

    # the PSF that the convolve phase takes: detector_image of this trace
    reset_launch_counts()
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        psf = RT.detector_image()
        t_image = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1
    px, py, w_b, wl_b, Nx_p, Ny_p, ext_p = rec.calls[0]
    bin_psf = check_binning(px, py, w_b, wl_b, ext_p, "bin_xyzw@convolve_psf", Nx=Nx_p, Ny=Ny_p)
    emit(dict(phase="focus", gpu=smi, scene="double_gauss", N=n, trace_seconds=t_trace,
              methods=results, tma_image_position=z_tma, rms_focus_minus_tma=z_rms - z_tma,
              detector_z=z_det, cost_sweep_card_vs_cpu_max_rel=sweep,
              cost_sweep_subset=dict(rays=int(q0.shape[0]), planes=FOCUS_PLANES),
              tolerance_rel=TOL_FOCUS_COST, chunk_planes_at_N=focus.plane_chunk(fd["N"]),
              chunk_bytes=focus.CHUNK_BYTES,
              psf_detector_image_seconds=t_image, psf_shape=list(psf.shape), psf_extent=list(psf.extent),
              launches=dict(conic_run=n_trace, bin_xyzw_focus_search=0, bin_xyzw_psf=1)))
    return ({"conic_run[nopol,store]@focus": n_trace, "bin_xyzw@convolve_psf": 1},
            {"bin_xyzw@convolve_psf": bin_psf}, psf)


def convolve_phase(ot, smi, psf_render):
    """convolve on the card against the CPU: a colour chart with the halo
    PSF and m = -1 (examples/psf_imaging.py), and a gray chart with the
    double Gauss's detector image as a colour PSF."""
    import numpy as np
    import torch
    cases = {"color_checker*halo,m=-1": (ot.presets.image.color_checker([1.5, 1.0]),
                                         ot.presets.psf.halo(sig1=1.0, sig2=0.5, r=8.0, a=0.2),
                                         dict(m=-1)),
             "siemens_star*double_gauss_psf": (ot.presets.image.siemens_star([2.0, 2.0]), psf_render, {})}
    out = {}
    for label, (img, psf, kw) in cases.items():
        with ot.global_options.no_warnings():
            ot.convolve(img, psf, **kw)     # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = ot.convolve(img, psf, **kw)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = ot.convolve(img, psf, device="cpu", **kw)
            t_cpu = time.perf_counter() - t0
        d = float(np.abs(card.data - cpu.data).max())
        assert type(card) is type(cpu) and card.shape == cpu.shape and d <= TOL_CONVOLVE, (label, d)
        assert np.array_equal(card.extent, cpu.extent) and np.isfinite(card.data).all()
        assert card.data.max() > 0.1
        out[label] = dict(result=type(card).__name__, shape=list(card.shape), seconds=t_card,
                          seconds_cpu=t_cpu, max_abs_card_vs_cpu=d)
    emit(dict(phase="convolve", gpu=smi, cases=out, tolerance=TOL_CONVOLVE))


def eye_phase(ot, smi, n=N_RAYS):
    """The Arizona eye at 10⁶ rays from a point at infinity: the trace with
    cuda_fuse_planar off (cornea and lens are runs of 2, under MIN_RUN: no
    launch of kernel 1) and on (the pupil joins them: one run of 5), the RMS
    focus near the retina against the TMA, detector_image on the spherical
    retina."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.image import render_image as render_image_mod
    from optrace_tpu_torch.tracer.trace_core import MIN_RUN
    go = ot.global_options
    traced, runs = {}, {}
    for flag in (False, True):
        go.cuda_fuse_planar = flag
        try:
            RT = arizona_eye_scene(ot)
            runs[flag] = run_partition(ot, RT)
            RT.trace(20000)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            RT.trace(n)
            traced[flag] = (RT, time.perf_counter() - t0, conic_run.launches)
        finally:
            go.cuda_fuse_planar = False
    assert runs == {False: [], True: [5]}, runs
    assert traced[False][2] == 0 and traced[True][2] == 1, (traced[False][2], traced[True][2])
    flips, d_sec = sections_agree(traced[True][0], traced[False][0], "eye, run of 5 against unrolled steps")
    RT = traced[False][0]
    eye_g = ot.presets.geometry.arizona_eye()
    tma = eye_g.tma(wl=555.0)
    t0 = time.perf_counter()
    res, fd = RT.focus_search("RMS Spot Size", z_start=20.0)
    t_focus = time.perf_counter() - t0
    z_f = tma.focal_points[1]
    assert abs(res.x - z_f) < 0.5, (res.x, z_f)
    reset_launch_counts()
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        img = RT.detector_image(projection_method="Equidistant")
        t_image = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1
    assert img.projection == "Equidistant" and np.isfinite(img.data).all() and img.power() > 0
    px, py, w_b, wl_b, Nx_e, Ny_e, ext_e = rec.calls[0]
    bin_eye = check_binning(px, py, w_b, wl_b, ext_e, "bin_xyzw@eye", Nx=Nx_e, Ny=Ny_e)
    del px, py, w_b, wl_b, rec
    # kernel 1 on the eye's run of 5 (flag on) against its plain version
    go.cuda_fuse_planar = True
    try:
        calls = capture_run_calls(arizona_eye_scene(ot), n, True, seed=21)
    finally:
        go.cuda_fuse_planar = False
    assert [len(c["steps"]) for c in calls] == [5]
    row = check_run_calls(calls, "conic_run[nopol,store]@eye5")
    del calls
    emit(dict(phase="eye", gpu=smi, scene="arizona_eye, point at infinity, 555 nm", N=n,
              runs_flag_off=runs[False], runs_flag_on=runs[True], min_run=MIN_RUN,
              note="with cuda_fuse_planar off the eye's runs hold 2 refractions (cornea, lens), "
                   "under MIN_RUN = 4: kernel 1 is not launched; with it on the pupil joins "
                   "them into one run of 5",
              trace_seconds_flag_off=traced[False][1], trace_seconds_flag_on=traced[True][1],
              launches=dict(conic_run_flag_off=traced[False][2], conic_run_flag_on=traced[True][2],
                            bin_xyzw_retina=1),
              sections_flag_on_vs_off=dict(flips=flips, max_abs=d_sec),
              rms_focus=res.x, tma_rear_focal_point=z_f, focus_minus_tma=res.x - z_f,
              focus_seconds=t_focus, focus_rays=fd["N"], retina_image=list(img.shape),
              retina_extent_rad=list(img.extent), retina_power=img.power(),
              detector_image_seconds=t_image, kernel_eye5=row))
    return ({"conic_run[nopol,store]@eye5": traced[True][2], "bin_xyzw@eye": 1},
            {"conic_run[nopol,store]@eye5": row, "bin_xyzw@eye": bin_eye})


# ----------------------------------------------------------------------
# generic surfaces and the ZEMAX loader: each phase drives its paths with the
# counters set to 0 just before each and returns its launches and its rows

def data_double_gauss_scene(ot, no_pol=True):
    """The double Gauss with its first surface a DataSurface2D sampled on a
    201 × 201 grid from the same sphere (r = 38 mm, R = 78.36 mm): a generic
    step, unrolled, before runs of 5 and 8."""
    import numpy as np
    from optrace_tpu_torch.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], no_pol=no_pol)
    RT.add(ot.RaySource(ot.Point(), divergence="Isotropic", orientation="Converging",
                        conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                        spectrum=ot.LightSpectrum("Constant")))
    G = double_gauss()
    L0 = G.lenses[0]
    xy = np.linspace(-38.0, 38.0, 201)
    X, Y = np.meshgrid(xy, xy)
    rho, r2 = 1 / 78.36, X ** 2 + Y ** 2
    Z = rho * r2 / (1 + np.sqrt(np.clip(1 - rho * rho * r2, 0, None)))
    front = ot.DataSurface2D(r=38.0, data=Z.T)
    G.remove(L0)
    G.add(ot.Lens(front, ot.SphericalSurface(r=38.0, R=469.5), n=L0.n, pos=[0, 0, 0], d1=0,
                  d2=9.8837))
    RT.add(G)
    return RT


def cosine_lens_scene(ot, no_pol=True):
    """The lens of examples/cosine_surfaces.py: two FunctionSurface2D faces
    with crossed cosine modulation (the example's z bounds leave part of each
    face without a sign change in its bracket: ILL_COND counts them)."""
    import numpy as np
    import torch
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=2.5), divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550), pos=[0, 0, -5]))
    front = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * torch.cos(4 * np.pi * x),
                                 z_min=-0.05, z_max=0.05)
    back = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * torch.cos(4 * np.pi * y),
                                z_min=-0.05, z_max=0.05)
    RT.add(ot.Lens(front, back, n=ot.presets.refraction_index.PMMA, pos=[0, 0, 0], d=0.5))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


def card_vs_cpu(ot, RT, n, seed, subset=GENERIC_SUBSET):
    """The first ``subset`` rays of an n-ray bundle, traced on the card
    (kernel 1 on the runs, the unrolled steps in eager PyTorch) and by the
    same port code on the CPU: stored sections within the CPU parity tests'
    tolerances, at most SEC_FLIPS_PER_20K rays a 20 000 whose hit/miss
    history differs, INFOS apart by at most two a flipped ray."""
    import torch
    from optrace_tpu_torch.tracer.trace_core import trace_bundle
    RT.rays.init(RT.ray_sources, n, len(RT.tracing_surfaces) + 2, RT.no_pol)
    outline = tuple(float(v) for v in RT.outline)
    with torch.no_grad():
        bundle = [t[:subset] for t in RT._make_source_fn(n)(ot.make_generator(seed))]
        card = trace_bundle(RT._build_steps(), RT.n0, outline, *bundle, RT.no_pol)
        cpu = trace_bundle(RT._build_steps(device="cpu"), RT.n0, outline,
                           *(t.cpu() for t in bundle), RT.no_pol)
    pk, wk = card["p"].cpu(), card["w"].cpu()
    pc, wc = cpu["p"], cpu["w"]
    flipped = torch.any((wk > 0) != (wc > 0), dim=1)
    n_flip = int(flipped.sum())
    assert n_flip <= SEC_FLIPS_PER_20K * subset / 20000, f"{n_flip} rays flipped"
    keep = ~flipped
    d_p = (pk[keep] - pc[keep]).abs()
    lim = SEC_P_ATOL + SEC_P_RTOL * pc[keep].abs()
    lim[:, -1] = SEC_P_ATOL_THROW + SEC_P_RTOL * pc[keep][:, -1].abs()
    d_w = (wk[keep] - wc[keep]).abs()
    assert bool((d_p <= lim).all()), f"sections differ by {float(d_p.max())}"
    assert bool((d_w <= SEC_W_ATOL + SEC_W_RTOL * wc[keep].abs()).all()), float(d_w.max())
    d_infos = int((card["infos"].cpu() - cpu["infos"]).abs().sum())
    assert d_infos <= 2 * n_flip, f"INFOS differ by {d_infos} with {n_flip} flipped rays"
    return dict(rays=int(pc.shape[0]), flips=n_flip, max_abs_p=float(d_p.max()),
                max_abs_p_before_last=float(d_p[:, :-1].max()), max_abs_w=float(d_w.max()),
                infos=cpu["infos"].sum(dim=1).tolist(), infos_abs_diff=d_infos)


def _eager_entry(RT, n):
    """The trace entry of a scene with a function or data surface, which
    stays eager: its ``graphed`` attribute and the reason, for the phase's
    line."""
    entry = RT._trace_entry(n)
    assert not entry.graphed and "function or data surface" in entry.eager_reason, entry.eager_reason
    return dict(graphed=entry.graphed, reason=entry.eager_reason)


def generic_phase(ot, smi, n=N_RAYS):
    """Function and data surfaces on the card at 10⁶ rays. (i) The double
    Gauss with a data-surface front: Raytracer.trace (kernel 1 on the runs of
    5 and 8 around the unrolled generic step), detector_image (kernel 2), one
    fused-render batch; the generic step's launches and device time beside the
    whole trace's; the card's sections against the CPU's on 10⁵ rays. (ii)
    The cosine lens of examples/cosine_surfaces.py: trace, image, the same
    CPU check."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.image import render_image as render_image_mod
    from optrace_tpu_torch.parallel import render as render_mod
    from optrace_tpu_torch.tracer.trace_core import trace_bundle, ILL_COND
    launches, rows, out = {}, {}, {}

    # (i) the data-surface double Gauss
    RT = data_double_gauss_scene(ot)
    runs = run_partition(ot, RT)
    kinds = [st.sfns.kind for st in RT._build_steps()]
    assert runs == [5, 8] and kinds[0] == "generic" and kinds.count("generic") == 1, (runs, kinds)
    RT.trace(20000)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    RT.trace(n)
    t_trace = time.perf_counter() - t0
    assert conic_run.launches == 2 and conic_run.variant_launches == {(False, True): 2}, \
        conic_run.variant_launches
    launches["conic_run[nopol,store]@generic"] = conic_run.launches
    ill = RT._msgs[ILL_COND].tolist()
    graphed_dg = _eager_entry(RT, n)
    reset_launch_counts()
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        img = RT.detector_image()
        t_image = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1 and img.power() > 0
    launches["bin_xyzw@generic"] = 1
    px, py, w_b, wl_b, Nx_b, Ny_b, ext_b = rec.calls[0]
    rows["bin_xyzw@generic"] = check_binning(px, py, w_b, wl_b, ext_b, "bin_xyzw@generic", Nx=Nx_b, Ny=Ny_b)
    del px, py, w_b, wl_b, rec

    # the generic step alone and the whole trace, device launches and time
    steps = RT._build_steps()
    outline = tuple(float(v) for v in RT.outline)
    RT.rays.init(RT.ray_sources, n, len(RT.tracing_surfaces) + 2, RT.no_pol)
    with torch.no_grad():
        bundle = RT._make_source_fn(n)(ot.make_generator(5))

    def step_only():
        with torch.no_grad():
            return trace_bundle(steps[:1], RT.n0, outline, *bundle, True, store_sections=False)

    def whole():
        with torch.no_grad():
            return trace_bundle(steps, RT.n0, outline, *bundle, True)
    step_ms, whole_ms = cuda_ms(step_only, reps=3), cuda_ms(whole, reps=3)
    (step_launches, step_busy, _), (whole_launches, whole_busy, _) = device_busy(step_only), device_busy(whole)
    del bundle

    # one fused-render batch
    render, _ = ot.make_fused_render(RT, n, Nx=NX, Ny=NY)
    with torch.no_grad():
        render(ot.make_generator(100))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with BinRecorder(render_mod) as rec:
            tile = render(ot.make_generator(0))
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
    assert conic_run.launches == 2 and conic_run.variant_launches == {(False, False): 2}
    assert bin_xyzw_cuda.launches == 1 and bool(torch.isfinite(tile).all())
    launches["conic_run[nopol,nostore]@generic_render"] = 2
    launches["bin_xyzw@generic_render"] = 1
    px, py, w_b, wl_b, Nx_b, Ny_b, ext_b = rec.calls[0]
    rows["bin_xyzw@generic_render"] = check_binning(px, py, w_b, wl_b, ext_b, "bin_xyzw@generic_render",
                                                    Nx=Nx_b, Ny=Ny_b)
    del px, py, w_b, wl_b, rec, render
    power_render = float(tile[..., 3].sum())

    # kernel 1 on this path's own runs, against its plain version
    for label, store in (("conic_run[nopol,store]@generic", True),
                         ("conic_run[nopol,nostore]@generic_render", False)):
        calls = capture_run_calls(data_double_gauss_scene(ot), n, store, seed=23)
        assert [len(c["steps"]) for c in calls] == [5, 8]
        rows[label] = check_run_calls(calls, label)
        del calls
    torch.cuda.empty_cache()
    cmp_dg = card_vs_cpu(ot, RT, n, seed=24)
    out["data_double_gauss"] = dict(
        runs=runs, trace_seconds=t_trace, trace_entry=graphed_dg, detector_image_seconds=t_image,
        render_ms_per_batch=t_render * 1e3, render_power=power_render, image_power=img.power(),
        ill_conditioned_by_section=ill,
        generic_step=dict(device_launches=step_launches, ms=step_ms, device_busy_ms=step_busy),
        whole_trace=dict(device_launches=whole_launches, ms=whole_ms, device_busy_ms=whole_busy),
        card_vs_cpu=cmp_dg)
    del RT, img, tile

    # (ii) the cosine lens: two generic steps, no run
    RT = cosine_lens_scene(ot)
    assert run_partition(ot, RT) == []
    RT.trace(20000)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    RT.trace(n)
    t_trace = time.perf_counter() - t0
    assert conic_run.launches == 0
    ill = RT._msgs[ILL_COND].tolist()
    assert ill[1] > 0 and ill[2] > 0, ill
    graphed_cos = _eager_entry(RT, n)
    reset_launch_counts()
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        img = RT.detector_image()
        t_image = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1 and img.power() > 0
    launches["bin_xyzw@cosine"] = 1
    px, py, w_b, wl_b, Nx_b, Ny_b, ext_b = rec.calls[0]
    rows["bin_xyzw@cosine"] = check_binning(px, py, w_b, wl_b, ext_b, "bin_xyzw@cosine", Nx=Nx_b, Ny=Ny_b)
    del px, py, w_b, wl_b, rec
    steps = RT._build_steps()
    outline = tuple(float(v) for v in RT.outline)
    RT.rays.init(RT.ray_sources, n, len(RT.tracing_surfaces) + 2, RT.no_pol)
    with torch.no_grad():
        bundle = RT._make_source_fn(n)(ot.make_generator(6))

    def cos_step():
        with torch.no_grad():
            return trace_bundle(steps[:1], RT.n0, outline, *bundle, True, store_sections=False)
    cos_ms, (cos_launches, cos_busy, _) = cuda_ms(cos_step, reps=3), device_busy(cos_step)
    del bundle
    out["cosine_lens"] = dict(trace_seconds=t_trace, trace_entry=graphed_cos, detector_image_seconds=t_image,
                              image_power=img.power(), ill_conditioned_by_section=ill,
                              generic_step=dict(device_launches=cos_launches, ms=cos_ms,
                                                device_busy_ms=cos_busy),
                              card_vs_cpu=card_vs_cpu(ot, RT, n, seed=25))
    emit(dict(phase="generic", gpu=smi, N=n, scenes=out,
              tolerances=dict(p_rtol=SEC_P_RTOL, p_atol=SEC_P_ATOL, p_atol_throw=SEC_P_ATOL_THROW,
                              w_rtol=SEC_W_RTOL, w_atol=SEC_W_ATOL, flips_per_20k=SEC_FLIPS_PER_20K),
              launches=launches))
    return launches, rows


# a synthetic glass catalog (two Sellmeier glasses: BK7's and F2's coefficients)
# and a prescription with a cemented doublet (four refracting surfaces in a
# row: one run of kernel 1), a stop, an even asphere singlet and the image plane
ZMX_AGF = """NM CROWN 2 0 1.5168 64.17 0
CD 1.03961212 0.00600069867 0.231792344 0.0200179144 1.01046945 103.560653
LD 0.3 2.5
NM FLINT 2 0 1.62004 36.37 0
CD 1.34533359 0.00997743871 0.209073176 0.0470450767 0.937357162 111.886764
LD 0.32 2.5
"""
ZMX_TEXT = """MODE SEQ
NAME doublet stop asphere
UNIT MM X W X Y
SURF 0
  TYPE STANDARD
  CURV 0.0
  DISZ INFINITY
SURF 1
  TYPE STANDARD
  CURV 0.05
  DIAM 5
  GLAS CROWN 0 0 1.5168 64.17 0 0 0 0
  DISZ 3.0
SURF 2
  TYPE STANDARD
  CURV -0.06
  DIAM 5
  GLAS FLINT 0 0 1.62004 36.37 0 0 0 0
  DISZ 1.5
SURF 3
  TYPE STANDARD
  CURV -0.01
  DIAM 5
  DISZ 2.0
SURF 4
  TYPE STANDARD
  CURV 0.0
  DIAM 2
  STOP
  DISZ 2.0
SURF 5
  TYPE EVENASPH
  CURV 0.04
  DIAM 5
  PARM 1 0.0
  PARM 2 1e-5
  GLAS ___BLANK 0 0 1.5168 64.17 0 0 0 0
  DISZ 2.5
SURF 6
  TYPE STANDARD
  CURV -0.04
  CONI -1.0
  DIAM 5
  DISZ 20.0
SURF 7
  TYPE STANDARD
  CURV 0.0
  DIAM 6
  DISZ 0.0
"""


def zmx_scene(ot, G):
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 60], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="Lambertian",
                        div_angle=3, spectrum=ot.presets.light_spectrum.d65))
    RT.add(G)
    return RT


def zmx_by_hand(ot, cat):
    """The prescription of ZMX_TEXT built with the port's classes, as the
    loader assembles it: the cemented lenses share their interface, the
    second starts 1e-7 mm behind it, and the first keeps its own glass
    behind its back surface (the refraction into the second glass happens
    at the second lens's front); the stop is a ring out to the group's half
    span."""
    G = ot.Group()
    one = ot.RefractionIndex("Constant", n=1)
    G.add(ot.Lens(ot.SphericalSurface(r=5, R=1 / 0.05), ot.SphericalSurface(r=5, R=1 / -0.06),
                  n=cat["CROWN"], pos=[0, 0, 0], d1=0, d2=3.0, n2=cat["CROWN"]))
    z = 3.0 + 1e-7
    G.add(ot.Lens(ot.SphericalSurface(r=5, R=1 / -0.06), ot.SphericalSurface(r=5, R=1 / -0.01),
                  n=cat["FLINT"], pos=[0, 0, z], d1=0, d2=1.5, n2=one))
    z += 1.5 + 2.0
    G.add(ot.Aperture(ot.RingSurface(ri=2.0, r=5.0), pos=[0, 0, z]))
    z += 2.0
    G.add(ot.Lens(ot.AsphericSurface(r=5, R=1 / 0.04, k=0.0, coeff=[0.0, 1e-5] + [0.0] * 8),
                  ot.ConicSurface(r=5, R=1 / -0.04, k=-1.0), n=ot.RefractionIndex("Abbe", n=1.5168, V=64.17),
                  pos=[0, 0, z], d1=0, d2=2.5, n2=one))
    z += 2.5 + 20.0
    G.add(ot.Detector(ot.RectangularSurface(dim=[12, 12]), pos=[0, 0, z]))
    return G


def zmx_phase(ot, smi, n=N_RAYS):
    """load_agf + load_zmx of synthetic files, a trace of 10⁶ rays through
    the loaded group (kernel 1 on the doublet's run of 4), its sections
    against those of the same prescription built by hand on the same rays,
    and the card against the CPU on 10⁵ rays."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.tracer.trace_core import trace_bundle
    with tempfile.TemporaryDirectory() as tmp:
        agf, zmx = os.path.join(tmp, "cat.agf"), os.path.join(tmp, "lens.zmx")
        with open(agf, "w") as f:
            f.write(ZMX_AGF)
        with open(zmx, "w", encoding="utf-16") as f:
            f.write(ZMX_TEXT)
        t0 = time.perf_counter()
        cat = ot.load_agf(agf)
        G = ot.load_zmx(zmx, n_dict=cat)
        t_load = time.perf_counter() - t0
    assert sorted(cat) == ["CROWN", "FLINT"]
    assert len(G.lenses) == 3 and len(G.apertures) == 1 and len(G.detectors) == 1
    RT = zmx_scene(ot, G)
    runs = run_partition(ot, RT)
    assert runs == [4], runs
    RT.trace(20000)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    RT.trace(n)
    t_trace = time.perf_counter() - t0
    assert conic_run.launches == 1 and conic_run.variant_launches == {(False, True): 1}
    launches = {"conic_run[nopol,store]@zmx": conic_run.launches}
    power = float(RT.rays.w_list[:, -2].sum())
    assert power > 0.3 * sum(rs.power for rs in RT.ray_sources), power

    # the same prescription by hand, on the same rays: equal sections
    RTh = zmx_scene(ot, zmx_by_hand(ot, cat))
    outline = tuple(float(v) for v in RT.outline)
    secs = []
    for R_ in (RT, RTh):
        R_.rays.init(R_.ray_sources, n, len(R_.tracing_surfaces) + 2, R_.no_pol)
        with torch.no_grad():
            b = R_._make_source_fn(n)(ot.make_generator(31))
            secs.append(trace_bundle(R_._build_steps(), R_.n0, outline, *b, True))
    d_hand = max(float((secs[0]["p"] - secs[1]["p"]).abs().max()),
                 float((secs[0]["w"] - secs[1]["w"]).abs().max()))
    assert d_hand == 0.0, d_hand
    del secs, b
    calls = capture_run_calls(zmx_scene(ot, G), n, True, seed=32)
    assert [len(c["steps"]) for c in calls] == [4]
    rows = {"conic_run[nopol,store]@zmx": check_run_calls(calls, "conic_run[nopol,store]@zmx")}
    del calls
    cmp_ = card_vs_cpu(ot, RT, n, seed=33)
    emit(dict(phase="zmx", gpu=smi, N=n, runs=runs, load_seconds=t_load,
              trace_seconds=t_trace, power_before_detector=power,
              loaded_vs_by_hand_max_abs=d_hand, card_vs_cpu=cmp_, launches=launches))
    return launches, rows


GRAPH_BATCHES = (0, 1, 2, 3)    # batch indices held graphed against eager, the capture's first
GRAPH_TIMED = 5                 # batches of each leg of the graphed/eager timing
GRAPH_HUGE_BATCHES = (4, 8, 20)     # render_huge of 4, 8 and 20 batches, graphed against eager


def _same_bits(a, b) -> bool:
    """Equal shape, dtype and bits (NaN against the same NaN counts as equal)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def _differing_bits(a, b) -> int:
    """Count of the elements of two float tensors of one shape whose bits differ."""
    import torch
    view = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return int((a.contiguous().view(view) != b.contiguous().view(view)).sum())


def _launch_calls(prof) -> int:
    """Host calls that put work on the device in a profiler window: kernel
    and graph launches, memsets and copies, by the runtime's API events."""
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemsetAsync",
             "cudaMemcpyAsync", "cudaLaunchKernelExC")
    return int(sum(ev.count for ev in prof.key_averages() if ev.key in names))


def graph_phase(ot, smi, n=N_RAYS):
    """The fused render's step captured into a CUDA graph (the counterpart of
    the JAX package's ``jax.jit`` of a batch) against the eager step of the
    same scene (``parallel/render.py:_eager_fused_render``): image and INFOS
    bit for bit and the generator's advance for the batch indices of
    GRAPH_BATCHES (the first one the capture's own replay); launches a replay
    adds to the counters; ms a batch graphed against eager in legs graphed,
    eager, eager, graphed; the capture's cost; device-busy ms, idle share,
    device kernels and host launch calls a batch by torch.profiler; the
    graph pool's bytes against the eager batch's peak; one replay under
    ``torch.cuda.set_sync_debug_mode("error")``; a surface changed after
    the steps were built: the captured step refuses, and a step built after
    the change equals its eager step again; and ``render_huge`` of
    GRAPH_HUGE_BATCHES batches with its step captured against the same call
    with its step eager, bit for bit, both timed."""
    import numpy as np
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.parallel import render as render_mod
    from optrace_tpu_torch.parallel.checkpoint import batch_generator
    from optrace_tpu_torch.parallel import graph as graph_mod
    from optrace_tpu_torch.parallel.graph import CapturedStep

    cfg = [dict(Nx=NX, Ny=NY)]
    RT = double_gauss_scene(ot, True)
    step, _ = ot.make_fused_render_multi(RT, n, cfg)
    eager, _ = render_mod._eager_fused_render(RT, n, cfg)
    assert isinstance(step, CapturedStep)
    gen = lambda b: batch_generator(0, b, ot.resolve_device())     # noqa: E731
    rows = []
    with torch.no_grad():
        eager(gen(100))
        step(gen(100))                      # the warm-up: eager
        torch.cuda.synchronize()
        assert step.graph is None
        reset_launch_counts()
        counted = {"graphed": [0, 0], "eager": [0, 0]}

        def counting(label, fn, g):
            c0, b0 = conic_run.launches, bin_xyzw_cuda.launches
            out = fn(g)
            counted[label][0] += conic_run.launches - c0
            counted[label][1] += bin_xyzw_cuda.launches - b0
            return out

        t0 = time.perf_counter()
        for b in GRAPH_BATCHES:
            ga, ea = gen(b), gen(b)
            (img_g,), infos_g = counting("graphed", step, ga)   # the first: capture and replay
            if b == GRAPH_BATCHES[0]:
                torch.cuda.synchronize()
                t_capture = time.perf_counter() - t0
                assert step.graph is not None
            (img_e,), infos_e = counting("eager", eager, ea)
            torch.cuda.synchronize()
            same = _same_bits(img_g, img_e) and _same_bits(infos_g, infos_e)
            same_gen = bool(torch.equal(ga.get_state(), ea.get_state()))
            d = float((img_g - img_e).abs().max())
            rows.append(dict(batch=b, bit_equal=same, generator_advance_equal=same_gen,
                             max_abs_diff=d, power=float(img_g[..., 3].sum())))
            assert same and same_gen, rows[-1]
            assert bool(torch.isfinite(img_g).all()) and float(img_g[..., 3].sum()) > 0
        # the counters: a replay adds the launches of an eager batch
        k = len(GRAPH_BATCHES)
        assert counted["graphed"] == counted["eager"] == [2 * k, k], counted
        assert conic_run.variant_launches == {(False, False): 2 * 2 * k}
        # the returned tile is the caller's own: the next replay leaves it be
        keep = img_g.clone()
        step(gen(7))
        torch.cuda.synchronize()
        assert _same_bits(keep, img_g)

        def leg(fn, first):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(GRAPH_TIMED):
                fn(gen(first + i))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / GRAPH_TIMED * 1e3

        ms_g1, ms_e1, ms_e2, ms_g2 = leg(step, 200), leg(eager, 200), leg(eager, 300), leg(step, 300)

        def window(fn):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(GRAPH_TIMED):
                    fn(gen(400 + i))
                torch.cuda.synchronize()
            evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
            busy = sum(ev.self_device_time_total for ev in evs) / 1e3 / GRAPH_TIMED
            return dict(device_busy_ms=busy,
                        device_kernels=sum(ev.count for ev in evs) / GRAPH_TIMED,
                        host_launch_calls=_launch_calls(prof) / GRAPH_TIMED)

        prof_g, prof_e = window(step), window(eager)
        prof_g["wall_ms"], prof_e["wall_ms"] = (ms_g1 + ms_g2) / 2, (ms_e1 + ms_e2) / 2
        for pr in (prof_g, prof_e):
            pr["idle_share"] = max(0.0, 1.0 - pr["device_busy_ms"] / pr["wall_ms"])
        # device memory: the graph's pool against an eager batch's peak
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager(gen(500))
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - base
        # a replay that synchronises with the host raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(gen(501))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

        # stale constants: a surface moved after two steps were built
        RT2 = double_gauss_scene(ot, True)
        step2, _ = ot.make_fused_render_multi(RT2, n, cfg)
        eager2, _ = render_mod._eager_fused_render(RT2, n, cfg)
        step2(gen(600))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (before_g,), _ = step2(gen(601))    # captured
        torch.cuda.synchronize()
        t_capture2 = time.perf_counter() - t0
        lens = RT2.lenses[0]
        lens.move_to([lens.pos[0], lens.pos[1], lens.pos[2] + 0.05])
        try:
            step2(gen(601))
            raise AssertionError("a captured step ran on a changed scene")
        except RuntimeError as err:
            refusal = str(err)
        (old_e,), _ = eager2(gen(601))      # the eager step keeps the surfaces it compiled
        step3, _ = ot.make_fused_render_multi(RT2, n, cfg)
        eager3, _ = render_mod._eager_fused_render(RT2, n, cfg)
        step3(gen(600))
        (after_g,), _ = step3(gen(601))
        (after_e,), _ = eager3(gen(601))
        torch.cuda.synchronize()
        assert _same_bits(after_g, after_e) and _same_bits(before_g, old_e)
        moved_diff = float((after_g - before_g).abs().sum())
        assert moved_diff > 0.0, "moving a lens changed no pixel"
        # render_huge with its step captured against render_huge with its
        # step left eager, whatever its batch count (parallel/render.py:capture
        # replaced), in legs graphed, eager, eager, graphed, at each count of
        # GRAPH_HUGE_BATCHES; the route that render_huge takes by itself
        def huge(n_rays, graphed):
            real = render_mod.capture
            render_mod.capture = (lambda fn, device, scene=None, batches=None:
                                  real(fn, device, scene)) if graphed else \
                (lambda fn, device, scene=None, batches=None: fn)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = double_gauss_scene(ot, True).render_huge(n_rays, batch_size=n)
                torch.cuda.synchronize()
                return img, time.perf_counter() - t0
            finally:
                render_mod.capture = real

        huge_rows = {}
        for batches in GRAPH_HUGE_BATCHES:
            img_g, t_g1 = huge(batches * n, True)
            img_e, t_e1 = huge(batches * n, False)
            t_e2, t_g2 = huge(batches * n, False)[1], huge(batches * n, True)[1]
            assert np.array_equal(img_g.data, img_e.data), float(np.abs(img_g.data - img_e.data).max())
            huge_rows[f"{batches}x{n}"] = dict(
                route="graphed" if batches >= graph_mod.MIN_BATCHES else "eager",
                seconds_graphed_legs=[t_g1, t_g2], seconds_eager_legs=[t_e1, t_e2],
                rays_per_s_graphed=2 * batches * n / (t_g1 + t_g2),
                rays_per_s_eager=2 * batches * n / (t_e1 + t_e2), bit_equal=True)
            del img_g, img_e
    pool_bytes = step.pool_bytes
    del step, eager, step2, eager2, step3, eager3
    torch.cuda.empty_cache()
    emit(dict(phase="graph", gpu=smi, scene="double_gauss", N_batch=n, image=[NY, NX, 4],
              batches=rows, launches=dict(graphed=dict(zip(("conic_run", "bin_xyzw"), counted["graphed"])),
                                          eager=dict(zip(("conic_run", "bin_xyzw"), counted["eager"]))),
              seconds_warmup_done_capture_and_first_replay=t_capture,
              seconds_capture_and_first_replay_second_step=t_capture2,
              ms_per_batch_graphed_legs=[ms_g1, ms_g2], ms_per_batch_eager_legs=[ms_e1, ms_e2],
              graphed=prof_g, eager=prof_e, graph_pool_bytes=pool_bytes,
              eager_batch_peak_bytes=eager_peak, replay_under_sync_debug_error="ran",
              stale_scene=dict(refusal=refusal, moved_lens_sum_abs_diff=moved_diff,
                               rebuilt_step_bit_equal=True),
              render_huge=huge_rows))
    return {"conic_run[nopol,nostore]@graph": counted["graphed"][0],
            "bin_xyzw@graph": counted["graphed"][1]}




# ----------------------------------------------------------------------
# the sharded render and the GUI: each phase drives its path with the
# counters set to 0 just before and returns its launches (and rows)

class AllReduceCounter:
    """Counts the calls to ``torch.distributed.all_reduce`` while the
    ``with`` block runs."""

    def __enter__(self):
        import torch.distributed as dist
        self.module, self.calls, self.real = dist, 0, dist.all_reduce

        def counter(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)
        dist.all_reduce = counter
        return self

    def __exit__(self, *exc):
        self.module.all_reduce = self.real


def sharded_phase(ot, smi, n=N_ITERATIVE, batch=N_RAYS):
    """``render_huge(mesh=...)`` of the huge phase's scene and size over an
    NCCL process group of one rank (this process, a ``file://`` rendezvous
    in a temporary directory), against the unsharded ``render_huge`` of the
    same seeds (rank 0 draws the unsharded stream); then interrupted and
    resumed under the mesh. A process group that does not come up fails the
    phase: there is no fallback to gloo."""
    import datetime
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.parallel.checkpoint import RenderCheckpoint

    torch.cuda.set_device(0)
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(pg_dir, "rendezvous"),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = ot.default_mesh()
        axis = ot.global_options.mesh_axis_name
        assert mesh.device_type == ot.resolve_device().type and mesh.mesh_dim_names == (axis,)
        assert mesh.size() == 1
        warm = torch.ones(1, device=ot.resolve_device())
        dist.all_reduce(warm)               # NCCL builds its communicator at the first collective
        torch.cuda.synchronize()
        t_group = time.perf_counter() - t0
        n_b = n // batch

        def leg(mesh_or_none):
            """One render_huge of a fresh scene and its host-clock seconds."""
            t0 = time.perf_counter()
            img = double_gauss_scene(ot, True).render_huge(n, batch_size=batch, mesh=mesh_or_none)
            torch.cuda.synchronize()
            return img, time.perf_counter() - t0

        # legs sharded, unsharded, unsharded, sharded: the host's spread
        # between calls is as large as the difference sought
        reset_launch_counts()
        with AllReduceCounter() as ar:
            sharded, t_s1 = leg(mesh)
        assert conic_run.launches == 2 * n_b and conic_run.variant_launches == {(False, False): 2 * n_b}
        assert bin_xyzw_cuda.launches == n_b and ar.calls == n_b, (bin_xyzw_cuda.launches, ar.calls)
        launches = {"conic_run[nopol,nostore]@sharded": conic_run.launches,
                    "bin_xyzw@sharded": bin_xyzw_cuda.launches}
        plain, t_u1 = leg(None)
        t_u2 = leg(None)[1]
        t_s2 = leg(mesh)[1]
        t_sharded, t_plain = (t_s1 + t_s2) / 2, (t_u1 + t_u2) / 2
        d_plain = float(np.abs(sharded.data - plain.data).max())
        assert np.isfinite(sharded.data).all() and sharded.shape == plain.shape
        # one rank draws the unsharded stream and the binning's sums do not
        # depend on order: the same image, bit for bit
        assert np.array_equal(sharded.data, plain.data), (d_plain, plain.data.max())
        assert abs(sharded.power() - plain.power()) <= 1e-6 * plain.power()

        class Interrupted(Exception):
            pass

        ck_path = os.path.join(pg_dir, "sharded.ckpt.npz")
        kw = dict(batch_size=batch, mesh=mesh, checkpoint_path=ck_path, checkpoint_every=1)
        real_save = RenderCheckpoint.save

        def save_then_stop(self):
            real_save(self)
            if self.done == 2:
                raise Interrupted
        RenderCheckpoint.save = save_then_stop
        try:
            double_gauss_scene(ot, True).render_huge(n, **kw)
            raise AssertionError("render_huge(mesh=...) was not interrupted")
        except Interrupted:
            pass
        finally:
            RenderCheckpoint.save = real_save
        assert RenderCheckpoint(ck_path, n_b).done == 2
        reset_launch_counts()
        with AllReduceCounter() as ar_r:
            t0 = time.perf_counter()
            resumed = double_gauss_scene(ot, True).render_huge(n, **kw)
            torch.cuda.synchronize()
            t_resume = time.perf_counter() - t0
        assert conic_run.launches == 2 * (n_b - 2) and bin_xyzw_cuda.launches == n_b - 2
        assert ar_r.calls == n_b - 2 and RenderCheckpoint(ck_path, n_b).done == n_b
        d_resume = float(np.abs(resumed.data - sharded.data).max())
        assert np.array_equal(resumed.data, sharded.data), (d_resume, sharded.data.max())
        emit(dict(phase="sharded", gpu=smi, scene="double_gauss", backend="nccl", world_size=1,
                  mesh_axis=axis, N=n, batch=batch, seconds_group_and_first_collective=t_group,
                  legs="sharded, unsharded, unsharded, sharded",
                  seconds_sharded_legs=[t_s1, t_s2], seconds_unsharded_legs=[t_u1, t_u2],
                  seconds_sharded=t_sharded, rays_per_s_sharded=n / t_sharded,
                  seconds_unsharded=t_plain, rays_per_s_unsharded=n / t_plain,
                  seconds_resumed_two_batches_with_saves=t_resume,
                  launches=dict(conic_run=2 * n_b, bin_xyzw=n_b, all_reduce=n_b),
                  sharded_vs_unsharded_max_abs=d_plain, resumed_vs_uninterrupted_max_abs=d_resume,
                  image_max=float(plain.data.max()), tolerance="bit for bit",
                  power=sharded.power()))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    return launches


class _Inert:
    """Answers every attribute, call, index, iteration and arithmetic
    operation with itself: a drawing call that draws nothing."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self

    def __call__(self, *args, **kwargs):
        return self

    def __getitem__(self, key):
        return self

    def __iter__(self):             # ``line, = ax.plot(...)``
        return iter((self,))

    def _same(self, *args):
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _same
    __truediv__ = __rtruediv__ = __neg__ = _same


def drawing_backend():
    """The GUI draws with matplotlib. Where matplotlib is installed it runs
    under Agg. Where it is not (the H100 machine that this script was
    written for has none), the modules ``matplotlib*`` and ``mpl_toolkits*``
    are a stand-in whose every drawing call does nothing, so that the GUI's
    own code and its device work run and are timed without the
    rasterization. Returns (a description, a function that removes the
    stand-in)."""
    import importlib.abc
    import importlib.machinery
    import importlib.util
    import types
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib
        matplotlib.use("Agg")
        return f"matplotlib {matplotlib.__version__} (Agg)", lambda: None

    class InertModule(types.ModuleType):
        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            return _Inert()

    class InertFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("matplotlib", "mpl_toolkits"):
                return importlib.machinery.ModuleSpec(name, self, is_package=True)
            return None

        def create_module(self, spec):
            mod = InertModule(spec.name)
            mod.__path__ = []
            return mod

        def exec_module(self, module):
            pass

    finder = InertFinder()
    sys.meta_path.insert(0, finder)

    def undo():
        sys.meta_path.remove(finder)
        for name in list(sys.modules):
            if name.split(".")[0] in ("matplotlib", "mpl_toolkits") \
                    or name.startswith(("optrace_tpu_torch.gui", "optrace_tpu_torch.plots")):
                del sys.modules[name]
    return "stand-in: matplotlib is not installed on this machine; nothing is drawn", undo


def gui_phase(ot, smi, n=N_RAYS, n_command=GUI_COMMAND_RAYS):
    """``TraceGUI`` on the double Gauss (with polarization, as the GUI traces
    by default) at 10⁶ rays on the card: each action timed by the host clock
    after a synchronize, the launches of the GUI's own actions counted, its
    detector image held against ``Raytracer.detector_image`` on the same
    trace and its focus against ``Raytracer.focus_search`` called directly."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.image import render_image as render_image_mod

    drawing, undo = drawing_backend()
    try:
        from optrace_tpu_torch.gui import TraceGUI
        RT = double_gauss_scene(ot, no_pol=False)
        RT.trace(20000)                         # warm-up at a small size
        gui = TraceGUI(RT, ray_count=n)
        assert gui.image_pixels == GUI_IMAGE_PIXELS and gui.focus_search_method == "RMS Spot Size"
        seconds, own = {}, {"conic_run": 0, "bin_xyzw": 0}

        def action(name, fn):
            """One action of the GUI: its host-clock seconds, and the kernel
            launches it made added to the GUI's own."""
            torch.cuda.synchronize()
            c0, b0 = conic_run.launches, bin_xyzw_cuda.launches
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            own["conic_run"] += conic_run.launches - c0
            own["bin_xyzw"] += bin_xyzw_cuda.launches - b0
            return out

        reset_launch_counts()
        action("init_scene", gui.init_scene)
        assert conic_run.launches == 2 and conic_run.variant_launches == {(True, True): 2}
        assert RT.rays.N == n and gui.ray_selection.sum() == gui.rays_visible
        if drawing.startswith("matplotlib"):
            shot = action("screenshot", gui.screenshot)
            assert shot.ndim == 3 and shot.shape[2] == 3
        with BinRecorder(render_image_mod) as rec:
            img = action("detector_image", gui.detector_image)
        assert own["bin_xyzw"] == 1 and len(rec.calls) == 1
        ref = RT.detector_image(projection_method=gui.projection_method)     # the same trace
        d_img = float(np.abs(img.data - ref.data).max())
        assert img.shape == ref.shape and np.array_equal(img.extent, ref.extent)
        assert d_img <= TOL_BIN * ref.data.max(), (d_img, ref.data.max())
        assert min(img.get(gui.image_mode, gui.image_pixels).shape[:2]) == GUI_IMAGE_PIXELS
        src = action("source_image", gui.source_image)
        assert own["bin_xyzw"] == 2 and src.power() > 0
        det = RT.detectors[0]
        z0 = float(det.pos[2])
        res_direct, _ = RT.focus_search("RMS Spot Size", z_start=z0)
        action("move_to_focus", gui.move_to_focus)
        z_focus = float(det.pos[2])
        assert z_focus == res_direct.x != z0, (z_focus, res_direct.x, z0)
        txt = action("pick_ray", lambda: gui.pick_ray(n // 2))
        assert f"Ray {n // 2}" in txt
        action("run_command_ray_count", lambda: gui.run_command(f"GUI.ray_count = {n_command}"))
        assert RT.rays.N == n_command and RT.check_if_rays_are_current()
        assert own["conic_run"] == 4 and own["bin_xyzw"] == 2, own
        px, py, w, wl, Nx_g, Ny_g, ext_g = rec.calls[0]
        bin_gui = check_binning(px, py, w, wl, ext_g, "bin_xyzw@gui", Nx=Nx_g, Ny=Ny_g)
        del px, py, w, wl, rec
        emit(dict(phase="gui", gpu=smi, scene="double_gauss (polarization)", drawing=drawing,
                  N=n, N_after_command=n_command, image_pixels=GUI_IMAGE_PIXELS,
                  seconds_host_clock=seconds,
                  screenshot="measured" if "screenshot" in seconds else "not measured: nothing is drawn",
                  launches=own, detector_image_vs_raytracer_max_abs=d_img,
                  image_max=float(ref.data.max()), tolerance=TOL_BIN * float(ref.data.max()),
                  focus=dict(z_start=z0, gui=z_focus, focus_search=res_direct.x),
                  power_detector_image=img.power(), power_source_image=src.power()))
        gui.close()
    finally:
        undo()
    return ({"conic_run[pol,store]@gui": own["conic_run"], "bin_xyzw@gui": own["bin_xyzw"]},
            {"bin_xyzw@gui": bin_gui})


# ----------------------------------------------------------------------
# the example scripts of examples_torch/, each at its own ray counts

# the examples whose scenes hold a run of at least four refractions (kernel
# 1), and those that make no detector image (no kernel 2); the CPU tests
# hold both lists against the calls of the kernels' wrappers
EXAMPLES_KERNEL_1 = ("achromat", "double_gauss")
EXAMPLES_WITHOUT_KERNEL_2 = ("astigmatism", "brewster_polarizer", "gui_automation",
                             "lens_optimization", "psf_imaging", "refraction_index_presets",
                             "spectrum_presets")
EXAMPLES_BIN_ROW = "image_render_many_rays"     # kernel 2's row: its last fused batch


def example_names():
    """The scripts of examples_torch/, by name."""
    here = os.path.dirname(os.path.abspath(__file__))
    return sorted(f[:-3] for f in os.listdir(os.path.join(here, "examples_torch"))
                  if f.endswith(".py") and f not in ("__init__.py", "common.py"))


def json_numbers(value):
    """The numbers, strings and flags of an example's results, in their
    lists and dicts; images, arrays and objects are left out (None)."""
    import numpy as np
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        return float(value)
    if isinstance(value, dict):
        kept = {str(k): json_numbers(v) for k, v in value.items()}
        return {k: v for k, v in kept.items() if v is not None} or None
    if isinstance(value, (list, tuple)):
        kept = [json_numbers(v) for v in value]
        return kept if kept and all(v is not None for v in kept) else None
    return None


def examples_phase(ot, smi):
    """``main()`` of every script of examples_torch/ on the card at the
    example's own ray counts, in a temporary directory: host-clock seconds
    after a synchronize, rays, the launches of kernels 1 and 2, the peak of
    allocated memory and the numbers ``main`` returned, held to the
    example's invariants (``examples_torch/common.py:check_results``).
    ``plot`` is not called: it needs matplotlib. The rays are those the
    run traced (:class:`RayCounter`), held against those the example says it
    traces. ``gui_automation`` runs through the stand-in of phase ``gui``;
    ``microscope`` needs fixtures that the repository does not ship
    (``examples_torch/resources``) and is reported as not run. Kernel 1's
    calls and the last fused batch of ``image_render_many_rays`` are held
    against their plain versions afterwards."""
    import importlib
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.parallel import render as render_mod
    from examples_torch.common import check_results

    names = example_names()
    assert len(names) == 22, names
    cwd = os.getcwd()
    launches, run_calls, bin_call, seconds = {}, [], None, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as where:
        os.chdir(where)
        try:
            for name in names:
                mod = importlib.import_module(f"examples_torch.{name}")
                if name == "microscope" and not os.path.isdir(mod.RES):
                    emit(dict(phase="examples", example=name, gpu=smi, run=False,
                              why="its ZEMAX and AGF fixtures are not in the repository "
                                  "(examples_torch/resources)"))
                    continue
                undo = None
                if name == "gui_automation":
                    drawing, undo = drawing_backend()
                try:
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()    # what the earlier phases still hold
                    torch.cuda.reset_peak_memory_stats()
                    reset_launch_counts()
                    with RunRecorder() as rec_run, BinRecorder(render_mod) as rec_bin, \
                            RayCounter() as counter:
                        t0 = time.perf_counter()
                        results = mod.main()
                        torch.cuda.synchronize()
                        seconds[name] = time.perf_counter() - t0
                    n_run, n_bin = conic_run.launches, bin_xyzw_cuda.launches
                    variants = {f"{'pol' if p else 'nopol'},{'store' if s else 'nostore'}": k
                                for (p, s), k in conic_run.variant_launches.items()}
                    if conic_run.slot_launches:     # a stored trace writes its runs into its buffers
                        assert len(variants) == 1, variants
                        variants[f"{next(iter(variants))},slots"] = conic_run.slot_launches
                    peak = torch.cuda.max_memory_allocated()
                    if "sim" in results:
                        results["sim"].close()
                finally:
                    if undo is not None:
                        undo()
                check_results(results)
                assert "rays" not in results or counter.rays == results["rays"], \
                    (name, counter.rays, results["rays"])
                assert "batches" not in results or counter.traces == results["batches"], \
                    (name, counter.traces, results["batches"])
                assert (n_run > 0) == (name in EXAMPLES_KERNEL_1), (name, n_run)
                assert (n_bin > 0) == (name not in EXAMPLES_WITHOUT_KERNEL_2), (name, n_bin)
                assert len(rec_run.calls) == n_run, (name, len(rec_run.calls), n_run)
                run_calls += rec_run.calls
                if name == EXAMPLES_BIN_ROW:
                    assert rec_bin.calls, name
                    bin_call = rec_bin.calls[-1]
                for v, k in variants.items():
                    launches[f"conic_run[{v}]@examples"] = launches.get(f"conic_run[{v}]@examples", 0) + k
                launches["bin_xyzw@examples"] = launches.get("bin_xyzw@examples", 0) + n_bin
                line = dict(phase="examples", example=name, gpu=smi, run=True,
                            seconds_host_clock=seconds[name], rays=counter.rays, traces=counter.traces,
                            launches=dict(conic_run=n_run, conic_run_by_variant=variants,
                                          bin_xyzw=n_bin),
                            peak_allocated_bytes=peak, peak_above_start_bytes=peak - base,
                            results=json_numbers(results))
                if name == "gui_automation":
                    line["drawing"] = drawing
                emit(line)
                del results, rec_run, rec_bin, counter
                torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    t_phase = time.perf_counter() - t_phase

    # the kernels on the inputs the examples gave them
    def variant(c):
        return f"{'pol' if c['pol'] is not None else 'nopol'},{'store' if c['store'] else 'nostore'}"
    rows = {}
    for v in sorted({variant(c) for c in run_calls}):
        calls = [c for c in run_calls if variant(c) == v]
        rows[f"conic_run[{v}]@examples"] = check_run_calls(calls, f"conic_run[{v}]@examples")
        slotted = [c for c in calls if c["out"] is not None]
        if slotted:
            rows[f"conic_run[{v},slots]@examples"] = check_slot_calls(slotted, f"conic_run[{v},slots]@examples")
        del calls, slotted
    del run_calls
    px, py, w, wl, Nx_b, Ny_b, ext_b = bin_call
    rows["bin_xyzw@examples"] = check_binning(px, py, w, wl, ext_b, "bin_xyzw@examples",
                                              Nx=Nx_b, Ny=Ny_b)
    del px, py, w, wl, bin_call
    assert set(rows) == set(launches), (sorted(rows), sorted(launches))
    emit(dict(phase="examples_total", gpu=smi, examples=len(seconds),
              seconds_host_clock=sum(seconds.values()), seconds_with_checks=t_phase,
              launches=launches, kernel_rows={k: dict(max_abs_err=r["max_abs_err"], ms=r["ms"])
                                              for k, r in rows.items()}))
    return launches, rows


# ----------------------------------------------------------------------
# the stored trace: kept on the card, read on the host only when asked; the
# trace cache; sums that do not depend on the order of the rays

TRACE_SCENES = (("double_gauss", False), ("double_gauss", True), ("stack57", True))
SOFT_PIXELS = 189                       # the design image's side (tracer/diff.py's default)


def eager_host_arrays(rays):
    """The host arrays as the trace made them before its sections stayed on
    the card: ``.cpu()`` of the device tensors, the positions and indices
    in f64, ``s0`` in f32 arithmetic on the host from the f32 positions."""
    import numpy as np
    d = rays._dev
    p = d["p"].cpu().numpy()
    s0 = p[:, 1] - p[:, 0]
    norm = np.linalg.norm(s0, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        s0 = np.where(norm > 0, s0 / norm, s0)
    pol = np.broadcast_to(np.nan, p.shape) if d["pol"] is None else d["pol"].cpu().numpy()
    return dict(p_list=p.astype(np.float64), s0_list=s0.astype(np.float64),
                n_list=d["n"].cpu().numpy().astype(np.float64), pol_list=pol,
                w_list=d["w"].cpu().numpy(), wl_list=d["wl"].cpu().numpy())


TRACE_REPLAYS = 6                       # timed replays of a graphed trace


def _held_graphs(RT):
    """The trace entries of ``RT`` that hold a CUDA graph now, oldest first."""
    return [e for e in RT._trace_cache.values() if e.graphed and e.run.graph is not None]


def _timed_trace(RT, n):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RT.trace(n)
    return time.perf_counter() - t0


def _same_trace(ot, scene, RT, n, seed, **kw):
    """Assert that the stored trace of ``RT`` equals bit for bit, in its
    sections and INFOS, the eager trace of a fresh raytracer of ``scene``
    at the seed counter ``seed``."""
    import numpy as np
    fresh = scene(ot, **kw)
    fresh._seed_counter = seed
    fresh.trace(n)
    assert fresh._trace_entry(n).run.graph is None
    for k, t in RT.rays._dev.items():
        assert (t is None) == (fresh.rays._dev[k] is None), k
        assert t is None or _same_bits(t, fresh.rays._dev[k]), k
    assert np.array_equal(RT._msgs, fresh._msgs)


def trace_phase(ot, smi, dg_runs, n=N_RAYS):
    """``Raytracer.trace`` at 10⁶ rays of the double Gauss (polarization
    and none) and of the 57-surface stack (bench.py's stored-trace scene
    when its fixtures are absent, ``build_synthetic``): the seconds of
    ``trace`` with no host read (a cache miss, the eager hits before the
    key's capture, the capture with its first replay, the replays), then of
    the first full read of ``RT.rays``; device ms of source + trace,
    device-busy ms and idle share of a replayed trace, the graph's pool and
    the peak device memory of the eager, capturing and replayed traces; the
    replayed trace against a fresh raytracer's eager trace at the same seed
    counter, bit for bit, and kernel 1 counted in the replay as in the
    eager trace (every run writing into the trace's buffers); the sections
    written in place against the stacked route (kernel 1 in the (L, N)
    layout and every section stacked at the end, as a derivative's route
    still runs), bit for bit, with the device ms of both. The stack with
    polarization, traced once. On the double Gauss: no host array made through trace →
    detector_image → detector_spectrum → source_image → focus_search; scene
    A, scene B, scene A (a replayed hit) beside the miss; the arrays made at
    the first read against an eager ``.cpu()`` conversion of the same
    tensors; more graphed keys than ``MAX_GRAPHED_TRACES``, and the memory
    after the oldest graph was dropped. The ``steps`` scene with HURB
    replayed against its eager trace."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.tracer import trace_core
    from optrace_tpu_torch.tracer.raytracer import MAX_GRAPHED_TRACES, TRACE_CAPTURE_CALL
    from optrace_tpu_torch.tracer.trace_core import trace_bundle
    launches, out = {}, []
    scenes = {"double_gauss": double_gauss_scene, "stack57": synthetic_stack_scene}
    for name, no_pol in TRACE_SCENES:
        scene = scenes[name]
        RTt = scene(ot, no_pol=no_pol)
        n_surf = len(RTt.tracing_surfaces)
        RTt.trace(20000)                        # warm-up at a small size (its own cache entry)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        RTt.trace(n)                            # a miss: steps, runs and samplers of N are built
        t_miss = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        stored_runs = run_partition(ot, RTt)
        if name == "double_gauss":
            assert stored_runs == dg_runs, stored_runs
        assert conic_run.variant_launches == {(not no_pol, True): len(stored_runs)}, conic_run.variant_launches
        assert conic_run.slot_launches == len(stored_runs), "a run of the trace wrote no slots"
        label = ("conic_run[nopol,store]" if no_pol else "conic_run[pol,store]") \
            + ("" if name == "double_gauss" else "@stack56")
        launches[label] = conic_run.launches
        launches[label.replace("]", ",slots]")] = conic_run.slot_launches
        rays = RTt.rays
        assert rays._host == {} and rays.N == n and rays.Nt == n_surf + 2
        kept_bytes = sum(t.numel() * t.element_size() for t in rays._dev.values() if t is not None)
        entry = RTt._trace_entry(n)
        step = entry.run
        assert entry.graphed and entry.eager_reason is None and step.graph is None, entry.eager_reason
        # the eager hits before the key's capture, the capture with its
        # first replay, then the replays
        t_eager = [_timed_trace(RTt, n) for _ in range(TRACE_CAPTURE_CALL - 2)]
        assert step.graph is None and step.captures_next
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t_capture = _timed_trace(RTt, n)
        capture_peak = torch.cuda.max_memory_allocated() - base
        assert step.graph is not None
        captured = step.captured_launches
        assert captured[(conic_run, "launches")] == len(stored_runs), captured
        assert captured[(conic_run, "variant_launches")] == {(not no_pol, True): len(stored_runs)}, captured
        torch.cuda.reset_peak_memory_stats()
        t_replay = [_timed_trace(RTt, n) for _ in range(TRACE_REPLAYS)]
        replay_peak = torch.cuda.max_memory_allocated() - base
        reset_launch_counts()
        seed = RTt._seed_counter
        RTt.trace(n)                            # a replay, counted
        assert conic_run.variant_launches == {(not no_pol, True): len(stored_runs)}, conic_run.variant_launches
        launches[("conic_run[nopol,store]" if no_pol else "conic_run[pol,store]")
                 + ("@trace_replay" if name == "double_gauss" else "@stack56_replay")] = conic_run.launches
        _same_trace(ot, scene, RTt, n, seed, no_pol=no_pol)
        n_kernels, busy_ms, busy_wall_ms = device_busy(lambda: RTt.trace(n))
        steps = RTt._build_steps()
        src = RTt._make_source_fn(n)
        outl = tuple(float(v) for v in RTt.outline)

        def dev_trace():
            with torch.no_grad():
                return trace_bundle(steps, RTt.n0, outl, *src(ot.make_generator(5)), no_pol)

        class StackedSections(trace_core._Sections):
            # the route that a derivative takes: kernel 1 in the (L, N) layout
            # and every section stacked at the end, as the trace ran before
            def __init__(self, *args):
                super().__init__(*args)
                self.to_lists()

        def stacked_trace():
            real = trace_core._Sections
            trace_core._Sections = StackedSections
            try:
                return dev_trace()
            finally:
                trace_core._Sections = real
        a, b = dev_trace(), stacked_trace()
        for k in ("p", "w", "pol", "n", "infos"):
            assert (a[k] is None) == (b[k] is None) and (a[k] is None or _same_bits(a[k], b[k])), k
        del a, b
        dev_ms = cuda_ms(dev_trace, reps=3, warmup=1)
        dev_ms_stacked = cuda_ms(stacked_trace, reps=3, warmup=1)
        del steps, src
        row = dict(scene=name, no_pol=no_pol, N=n, surfaces=n_surf, sections=[n, n_surf + 2, 3],
                   trace_seconds_miss=t_miss, trace_seconds_eager_hits=t_eager,
                   trace_seconds_capture=t_capture, trace_seconds_replays=t_replay,
                   trace_capture_call=TRACE_CAPTURE_CALL, device_ms=dev_ms,
                   device_ms_stacked_route=dev_ms_stacked, in_place_vs_stacked_route="bit for bit",
                   ms_per_surface_per_mray=dev_ms / n_surf / (n / 1e6),
                   replay_device_busy_ms=busy_ms, replay_device_kernels=n_kernels,
                   replay_device_busy_wall_ms=busy_wall_ms, replay_idle_share=1.0 - busy_ms / busy_wall_ms,
                   graph=dict(pool_bytes=step.pool_bytes, reserved_growth_bytes=int(
                       torch.cuda.memory_reserved() - reserved0),
                              captured_kernel1_launches=captured[(conic_run, "launches")]),
                   peak_device_bytes=dict(eager_miss=int(peak), capture=int(capture_peak),
                                          replays=int(replay_peak)),
                   kept_section_bytes=int(kept_bytes), replay_vs_fresh_raytracer="bit for bit")
        if name == "double_gauss":
            # the outputs of a stored trace read the card: no host array
            z_det = float(RTt.detectors[0].pos[2])
            t0 = time.perf_counter()
            RTt.detector_image()
            RTt.detector_spectrum()
            RTt.source_image()
            RTt.focus_search("RMS Spot Size", z_start=z_det)
            RTt.focus_search("Image Sharpness", z_start=z_det)
            torch.cuda.synchronize()
            row["outputs_seconds"] = time.perf_counter() - t0
            row["host_arrays_made_by_outputs"] = len(rays._host)
            assert len(rays._host) == 0, sorted(rays._host)
            assert RTt.check_if_rays_are_current()
        # the first full read, then against an eager conversion
        t0 = time.perf_counter()
        arrays = {a: getattr(rays, a) for a in rays._ARRAYS}
        row["first_full_read_seconds"] = time.perf_counter() - t0
        row["host_arrays_made_by_first_read"] = len(rays._host)
        eager = eager_host_arrays(rays)
        for a, v in arrays.items():
            assert v.dtype == eager[a].dtype and np.array_equal(v, eager[a], equal_nan=True), a
            assert not v.flags.writeable, a
        assert RTt.check_if_rays_are_current()
        wl_ = arrays["w_list"]
        assert bool((wl_[:, 1:] <= wl_[:, :-1] * (1 + 1e-6)).all()), "a weight grew"
        dead = int((wl_[:, -2] <= 0).sum())      # dead before the end absorber
        assert int(RTt._msgs[:, :-1].sum()) == dead, (int(RTt._msgs[:, :-1].sum()), dead)
        row.update(dead_before_end=dead, infos_rows=RTt._msgs.sum(axis=1).tolist())
        del arrays, eager, wl_
        if name == "double_gauss" and no_pol:
            # scene A, scene B (another source power), scene A: a replayed hit
            rs = RTt.ray_sources[0]
            power = rs.power
            rs.power = 2 * power
            t0 = time.perf_counter()
            RTt.trace(n)
            t_b = time.perf_counter() - t0
            rs.power = power
            seed = RTt._seed_counter
            entries = len(RTt._trace_cache)
            t0 = time.perf_counter()
            RTt.trace(n)
            t_a = time.perf_counter() - t0
            assert len(RTt._trace_cache) == entries == 3, entries       # 20000, N, N at 2× power
            assert step.graph is not None
            _same_trace(ot, scene, RTt, n, seed, no_pol=no_pol)
            row["cache"] = dict(seconds_miss_a=t_miss, seconds_miss_b=t_b, seconds_hit_a=t_a,
                                entries=entries, hit_vs_fresh_raytracer="bit for bit")
            # more graphed keys than the bound: N - 1, then N - 2 drops the
            # graph of N, the least recently used
            bound = dict(max_graphed_traces=MAX_GRAPHED_TRACES)
            for m in (n - 1, n - 2):
                for _ in range(TRACE_CAPTURE_CALL - 1):
                    RTt.trace(m)
                torch.cuda.synchronize()
                before = dict(allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved(),
                              graphs=len(_held_graphs(RTt)))
                RTt.trace(m)                        # the capture
                torch.cuda.synchronize()
                bound[f"N={m}"] = dict(before_capture=before, after_capture=dict(
                    allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved(),
                    graphs=len(_held_graphs(RTt))), pool_bytes=RTt._trace_entry(m).run.pool_bytes)
            held = _held_graphs(RTt)
            assert len(held) == MAX_GRAPHED_TRACES and step.graph is None, len(held)
            torch.cuda.empty_cache()
            bound["after_empty_cache"] = dict(allocated=torch.cuda.memory_allocated(),
                                              reserved=torch.cuda.memory_reserved())
            bound["graphs_held"] = len(held)
            row["graph_bound"] = bound
            del held
        out.append(row)
        del RTt, rays, entry, step
        torch.cuda.empty_cache()

    # the stack with polarization: one trace, its run of 56 writing the
    # polarization's columns as well
    RTp = synthetic_stack_scene(ot, no_pol=False)
    RTp.trace(20000)
    torch.cuda.synchronize()
    reset_launch_counts()
    RTp.trace(n)
    assert conic_run.variant_launches == {(True, True): 1} and conic_run.slot_launches == 1
    launches["conic_run[pol,store,slots]@stack56"] = conic_run.slot_launches
    assert tuple(RTp.rays._dev["pol"].shape) == (n, len(RTp.tracing_surfaces) + 2, 3)
    del RTp
    torch.cuda.empty_cache()

    # the steps scene: image source, filter, HURB at the ring aperture and an
    # ideal lens, replayed against its eager trace
    RTs = steps_scene(ot, use_hurb=True)
    for _ in range(TRACE_CAPTURE_CALL + 1):
        seed = RTs._seed_counter
        RTs.trace(n)
    entry = RTs._trace_entry(n)
    assert entry.graphed and entry.run.graph is not None
    _same_trace(ot, steps_scene, RTs, n, seed, use_hurb=True)
    hurb_rows = int(RTs._msgs[4].sum())
    out.append(dict(scene="steps_hurb", N=n, replay_vs_fresh_raytracer="bit for bit",
                    pool_bytes=entry.run.pool_bytes, hurb_neg_dir_rays=hurb_rows))
    del RTs, entry
    torch.cuda.empty_cache()
    emit(dict(phase="trace", gpu=smi, cuda_fuse_planar=ot.global_options.cuda_fuse_planar, traces=out,
              cpu_reference_ms_per_surface_per_mray=CPU_REFERENCE_MS_PER_SURFACE_MRAY))
    return launches


# the read path: RenderImage.get on the card against the same image's get on
# the CPU. At 945² the block mean is a copy and the colour differs by the two
# devices' f64 transcendental functions (a few ulp); at 315² also by the
# order of the block mean's sums
GET_SIDES = (945, 315)
TOL_GET_REL = 1e-12             # of each mode's largest value on the CPU
TOL_GAMUT_EDGE = 1e-12          # a pixel may change its gamut mask only this close to its edge
HUE_CHROMA_SHARE = 1e-6         # hue is compared where chroma is above this share of its largest


def _profile_port():
    """``tools/profile_port.py`` of this checkout, whose ``StageTimer``
    splits a call stage by stage."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "profile_port.py")
    spec = importlib.util.spec_from_file_location("profile_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ColourDevices:
    """The device type of every tensor that ``RenderImage.get`` hands to the
    colour conversions while the ``with`` block runs."""

    NAMES = ("xyz_to_srgb", "outside_srgb_gamut", "xyz_to_luv", "luv_hue", "luv_chroma", "luv_saturation")

    def __enter__(self):
        from optrace_tpu_torch import color
        self.mod, self.real, self.devices = color, {k: getattr(color, k) for k in self.NAMES}, []
        for k, fn in self.real.items():
            def spy(x, *a, _fn=fn, **kw):
                self.devices.append(x.device.type)
                return _fn(x, *a, **kw)
            setattr(color, k, spy)
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.mod, k, fn)


def get_card_vs_cpu(img, gets):
    """Each (mode, side) of ``gets`` (host images computed on the card)
    against the same image's ``get`` on the CPU: the largest difference
    relative to the mode's largest value, and the pixels outside the
    tolerances (the gamut mask's only where a pixel lies farther than
    TOL_GAMUT_EDGE from the edge; hue as an angle, where chroma is above
    HUE_CHROMA_SHARE of its largest)."""
    import numpy as np
    import torch
    from optrace_tpu_torch import color
    cpu = img.copy()
    cpu._device = torch.device("cpu")
    rows = {}
    for (mode, side), card in gets.items():
        a, b = card.data, cpu.get(mode, side).data
        scale = float(np.abs(b).max()) or 1.0
        d = np.abs(a - b)
        if mode == "Hue (CIELUV)":
            chroma = cpu.get("Chroma (CIELUV)", side).data
            d = np.where(chroma > HUE_CHROMA_SHARE * chroma.max(), np.minimum(d, 360.0 - d), 0.0)
            scale = 360.0
        row = dict(max_abs=float(d.max()), max_rel_to_largest=float(d.max()) / scale, largest=scale,
                   beyond=int((d > TOL_GET_REL * scale).sum()))
        if mode == "Outside sRGB Gamut":
            stack = torch.from_numpy(cpu._data)
            f = cpu.MAX_IMAGE_SIDE // side
            stack = cpu._block_mean(stack, f)[:, :, :3].contiguous()
            rgbl = color.xyz_to_srgb_linear(stack, normalize=True, rendering_intent="Ignore").numpy()
            edge = np.abs(rgbl.min(axis=-1) + 1e-6)
            row.update(flipped=int((a != b).sum()), beyond=int(((a != b) & (edge > TOL_GAMUT_EDGE)).sum()),
                       lit=int(b.sum()))
        rows[f"{mode}@{side}"] = row
    return rows


def geometry_replay(ot):
    """A scene whose second lens overlaps the first, traced twice on the
    card: the second check is a hit of the kept outcome and raises the same
    warnings, sets the same state and makes no fresh check."""
    import warnings
    import numpy as np
    from optrace_tpu_torch.tracer.raytracer import Raytracer
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -5, 40])
    RT.add(ot.RaySource(ot.CircularSurface(r=1), pos=[0, 0, 0], divergence="Lambertian", div_angle=5))
    for z in (10.0, 10.6):
        RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20), ot.SphericalSurface(r=3, R=-20),
                       n=ot.presets.refraction_index.BK7, pos=[0, 0, z], d=1.5))
    fresh, real = [], Raytracer._geometry_outcome

    def counted(self, elements):
        fresh.append(1)
        return real(self, elements)
    Raytracer._geometry_outcome = counted
    go = ot.global_options
    shown, go.show_warnings = go.show_warnings, True
    runs = []
    try:
        for _ in range(2):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                RT.trace(N_RAYS)
                t = time.perf_counter() - t0
            runs.append(([str(w.message) for w in rec], RT.geometry_error, np.array(RT.fault_pos), t))
    finally:
        Raytracer._geometry_outcome = real
        go.show_warnings = shown
    (m0, e0, f0, t0_), (m1, e1, f1, t1_) = runs
    assert len(fresh) == 1 and m0 == m1 and e0 and e1 and np.array_equal(f0, f1), (fresh, m0, m1)
    assert m0[0].startswith("Detected collision") and m0[-1] == "ABORTED TRACING" and f0.shape[1] == 3
    return dict(warnings=m0, fault_positions=len(f0), fresh_checks=len(fresh),
                seconds_fresh=t0_, seconds_hit=t1_)


def read_path_phase(ot, smi, dg_runs, n=N_RAYS):
    """The stored trace's read path of the double Gauss at 10⁶ rays, counters
    set to 0 just before and read just after: ``trace`` (a cache hit) →
    ``detector_image`` → ``get`` in every mode at 945² and 315², the colour
    on the card (``ColourDevices``), each image against the same image's
    ``get`` on the CPU; then the path split stage by stage
    (``tools/profile_port.py:split_targets``) and a kept geometry outcome
    that replays a collision's warnings."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.image import render_image as render_image_mod
    RT = double_gauss_scene(ot, no_pol=True)
    RT.trace(n)
    RT.detector_image().get("sRGB (Absolute RI)", 945)      # warm-up
    modes = ot.RenderImage.image_modes
    torch.cuda.synchronize()
    reset_launch_counts()
    with BinRecorder(render_image_mod) as rec, ColourDevices() as colour:
        t0 = time.perf_counter()
        RT.trace(n)
        t_trace = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = RT.detector_image()
        t_image = time.perf_counter() - t0
        gets, get_s = {}, {}
        for mode in modes:
            for side in GET_SIDES:
                t0 = time.perf_counter()
                gets[(mode, side)] = img.get(mode, side)
                get_s[f"{mode}@{side}"] = time.perf_counter() - t0
    run_launches, bin_launches = conic_run.launches, bin_xyzw_cuda.launches
    assert run_launches == len(dg_runs) and bin_launches == 1 and len(rec.calls) == 1, (run_launches, bin_launches)
    colour_calls = sum(m not in ("Irradiance", "Illuminance") for m in modes) * len(GET_SIDES)
    assert img.device.type == "cuda" and set(colour.devices) == {"cuda"}, colour.devices
    assert len(colour.devices) >= colour_calls, (len(colour.devices), colour_calls)
    for (mode, side), out in gets.items():
        assert out.data.shape[:2] == (side, side) and np.isfinite(out.data).all(), (mode, side)
    rgb = gets[("sRGB (Absolute RI)", 945)].data
    assert 0.0 <= rgb.min() and rgb.max() > 0.5
    vs_cpu = get_card_vs_cpu(img, gets)
    # the split, stage by stage: a trace hit as it runs, detector_image and
    # the get of sRGB at 945² with the card synchronized at every stage
    pp = _profile_port()
    targets = pp.split_targets()
    split = dict(trace=pp.split_call(lambda: RT.trace(n), targets["trace"])[0],
                 detector_image=pp.split_call(RT.detector_image, targets["detector_image"], sync=True)[0],
                 get_srgb_945=pp.split_call(lambda: img.get("sRGB (Absolute RI)", 945), targets["get"],
                                            sync=True)[0])
    replay = geometry_replay(ot)
    bin_row = check_binning(*rec.calls[0][:4], rec.calls[0][6], "bin_xyzw@read_path",
                            Nx=rec.calls[0][4], Ny=rec.calls[0][5])
    emit(dict(phase="read_path", gpu=smi, scene="double_gauss", N=n, no_pol=True,
              entry="Raytracer.trace -> detector_image -> RenderImage.get (every mode at 945 and 315)",
              launches=dict(conic_run=run_launches, bin_xyzw=bin_launches),
              image_device=str(img.device), colour_devices=sorted(set(colour.devices)),
              colour_calls=len(colour.devices), trace_seconds=t_trace, detector_image_seconds=t_image,
              get_seconds=get_s, get_card_vs_cpu=vs_cpu,
              tolerances=dict(rel_to_largest=TOL_GET_REL, gamut_edge=TOL_GAMUT_EDGE,
                              hue_where_chroma_above_share=HUE_CHROMA_SHARE),
              split=split, geometry_replay=replay))
    bad = {k: r for k, r in vs_cpu.items() if r["beyond"]}
    assert not bad, f"RenderImage.get on the card differs from the CPU's: {bad}"
    del RT, img, gets, rec
    return ({"conic_run[nopol,store]@read_path": run_launches, "bin_xyzw@read_path": bin_launches},
            {"bin_xyzw@read_path": bin_row})


class OldSums:
    """While the ``with`` block runs, the order-free sums take the form they
    had before, for the record: the histograms (``ops/binning.py:scatter_sum``)
    float ``index_add_`` in the threads' order, the focus search's sums over
    the rays (``block_sums``) ``torch.sum``."""

    def __enter__(self):
        import torch
        from optrace_tpu_torch.ops import binning
        from optrace_tpu_torch.analysis import focus
        from optrace_tpu_torch.tracer import raytracer
        self.mods = (binning, focus, raytracer)

        def index_add_sum(size, index, src, n=None, vmax=None):
            return torch.zeros((size,) + tuple(src.shape[1:]), dtype=src.dtype,
                               device=src.device).index_add_(0, index, src)

        def torch_sums(v, blocks=1):
            return v.view(blocks, -1, *v.shape[1:]).sum(dim=1)
        self.real = [{k: getattr(m, k) for k in ("scatter_sum", "block_sums") if hasattr(m, k)}
                     for m in self.mods]
        for mod, names in zip(self.mods, self.real):
            for k in names:
                setattr(mod, k, index_add_sum if k == "scatter_sum" else torch_sums)
        return self

    def __exit__(self, *exc):
        for mod, names in zip(self.mods, self.real):
            for k, fn in names.items():
                setattr(mod, k, fn)


def repeatable_phase(ot, smi, n=N_RAYS):
    """On one stored trace of the double Gauss (10⁶ rays): two calls of
    detector_spectrum, source_spectrum, focus_search with every method and
    the design image (``bin_xyzw_soft`` of the detector hits) give equal
    bits, and so do the same rays in a permuted order; the old form of the
    sums (``OldSums``) on the same calls and on the permuted rays, its
    differing values counted for the record."""
    import numpy as np
    import torch
    from optrace_tpu_torch.ops import binning

    RT = double_gauss_scene(ot, no_pol=True)
    RT.trace(n)
    z_det = float(RT.detectors[0].pos[2])

    def outputs():
        res = dict(detector_spectrum=torch.from_numpy(RT.detector_spectrum()._vals),
                   source_spectrum=torch.from_numpy(RT.source_spectrum()._vals))
        for method in RT.focus_search_methods:
            r, fd = RT.focus_search(method, z_start=z_det, return_cost=True)
            res[method] = torch.from_numpy(np.concatenate([[r.x, r.fun], fd["pos"], fd["cost"]]))
        ph, w, wl = RT._hit_detector("design image", extent=list(DESIGN_EXT))[:3]
        res["bin_xyzw_soft"] = binning.bin_xyzw_soft(ph[:, 0].float(), ph[:, 1].float(), w.float(), wl,
                                                     SOFT_PIXELS, SOFT_PIXELS, DESIGN_EXT)
        torch.cuda.synchronize()
        return {k: v.cpu() for k, v in res.items()}

    t0 = time.perf_counter()
    first = outputs()
    t_outputs = time.perf_counter() - t0
    second = outputs()
    with OldSums():
        old = [outputs(), outputs()]
    # the same rays in another order
    r = RT.rays
    perm = torch.randperm(n, generator=ot.make_generator(41), device=r._dev["p"].device)
    d = r._dev
    r._lock = False
    r.fill(d["p"][perm], d["w"][perm], None, d["n"][perm], d["wl"][perm])
    r.lock()
    RT._last_trace_snapshot = RT.tracing_snapshot()
    permuted = outputs()
    with OldSums():
        old_permuted = outputs()
    rows = {}
    for k in first:
        assert _same_bits(first[k], second[k]), ("two calls", k)
        assert _same_bits(first[k], permuted[k]), ("permuted rays", k)
        rows[k] = dict(values=int(first[k].numel()),
                       old_form_values_differing_between_two_calls=_differing_bits(old[0][k], old[1][k]),
                       old_form_values_differing_for_permuted_rays=_differing_bits(old[0][k], old_permuted[k]),
                       old_form_max_abs_diff=float(np.nanmax(np.abs((old[0][k] - old[1][k]).numpy()))),
                       old_form_max_abs_diff_permuted=float(np.nanmax(np.abs((old[0][k] - old_permuted[k]).numpy()))))
    assert float(first["bin_xyzw_soft"][..., 3].sum()) > 0
    emit(dict(phase="repeatable", gpu=smi, scene="double_gauss", N=n, design_image=[SOFT_PIXELS] * 2,
              outputs_seconds=t_outputs, two_calls="bit for bit", permuted_rays="bit for bit",
              outputs=rows))
    del RT


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one CUDA device",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    import numpy as np
    import optrace_tpu_torch as ot
    from optrace_tpu_torch.ops import _build
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.ops.cuda_trace import conic_step
    from optrace_tpu_torch.parallel import render as render_mod
    from optrace_tpu_torch.image import render_image as render_image_mod
    from optrace_tpu_torch.tracer.trace_core import trace_bundle, _partition_runs
    go = ot.global_options
    go.show_progress_bar = False
    go.show_warnings = False
    dev = ot.resolve_device()
    fuse_default = go.cuda_fuse_planar      # the default that this script measures below

    def drive_trace(scene, no_pol, n=N_RAYS):
        """``Raytracer.trace`` of a fresh scene, counters set to 0 just before."""
        RTd = scene(ot, no_pol)
        RTd.trace(20000)                        # warm-up at a small size
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        RTd.trace(n)
        return RTd, time.perf_counter() - t0

    def drive_render(scene):
        """One batch of ``make_fused_render`` of a fresh scene, counters set to 0 just before."""
        RTd = scene(ot, True)
        render_d, _ = ot.make_fused_render(RTd, N_RAYS, Nx=NX, Ny=NY)
        with torch.no_grad():
            render_d(ot.make_generator(100))
            torch.cuda.synchronize()
            reset_launch_counts()
            img_d = render_d(ot.make_generator(0))
            torch.cuda.synchronize()
        assert bool(torch.isfinite(img_d).all())
        return RTd, float(img_d[..., 3].sum())

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-2:]
    ptxas = [ln for ln in _build.build_info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0, nvcc=nvcc, gpu=smi,
              torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas))

    # ---- 2. kernels against their plain versions -----------------------
    # label -> (no_pol, store_sections)
    variants = {"conic_run[nopol,nostore]": (True, False),
                "conic_run[nopol,store]": (True, True),
                "conic_run[pol,store]": (False, True)}

    def run_variants(scene, expect_steps, suffix, seed, slots=False, **kw):
        """Kernel against plain version for the three variants on the calls
        that a trace of the scene records, in the (L, N) layout of the TPU
        kernel; with ``slots`` also the stored variants writing into the
        trace's (N, nt) buffers, as the trace calls them (labels
        ``[...,slots]``). Returns the results by label and the recorded
        calls of the [nopol,store] variant."""
        out, kept = {}, None
        for label, (no_pol, store) in variants.items():
            calls = capture_run_calls(scene(ot, no_pol), N_RAYS, store, seed=seed)
            assert [len(c["steps"]) for c in calls] == expect_steps, [len(c["steps"]) for c in calls]
            assert all((c["out"] is not None) == store for c in calls), "the trace wrote no slots"
            out[label] = check_run_calls(calls, label + suffix, **kw)
            if slots and store:
                slot_label = label.replace("]", ",slots]")
                out[slot_label] = check_slot_calls(calls, slot_label + suffix, **kw)
            if label == "conic_run[nopol,store]":
                kept = calls
            del calls
            torch.cuda.empty_cache()
        return out, kept

    # (a) one 56-step run of the 28-lens spherical stack
    stack, _ = run_variants(synthetic_stack_scene, [56], "@stack56", seed=11, slots=True)
    # (b) the main path's own shapes: the runs of the double Gauss under the
    # default of cuda_fuse_planar
    dg_runs = [15] if fuse_default else [6, 8]
    main_shapes, _ = run_variants(double_gauss_scene, dg_runs, "", seed=12, slots=True)
    # binning: rays spread over 1.2 × the extent, and the render's own input
    g = ot.make_generator(13)
    ext = (-43.265, 43.265, -43.265, 43.265)
    spread = [(torch.rand(N_RAYS, generator=g, device=dev) * 2 - 1) * 1.2 * ext[1] for _ in range(2)]
    spread += [torch.rand(N_RAYS, generator=g, device=dev),
               380.0 + 400.0 * torch.rand(N_RAYS, generator=g, device=dev)]
    bin_spread = check_binning(*spread, ext, "bin_xyzw@spread")
    # rays clustered on a patch of about 100 × 100 pixels and ordered by
    # pixel row: about 100 rays a pixel, and warps whose rays share pixels,
    # so the warp sum is held to the f64 sums at a count where TOL_BIN is tight
    clustered = [spread[0] * 0.09, spread[1] * 0.09, spread[2], spread[3]]
    order = torch.argsort(torch.floor(clustered[1] * (NY / (ext[3] - ext[2]))) * 4096
                          + torch.floor(clustered[0] * (NX / (ext[1] - ext[0]))))
    clustered = [t[order].contiguous() for t in clustered]
    bin_clustered = check_binning(*clustered, ext, "bin_xyzw@clustered")
    assert 20 <= bin_clustered["rays_in_fullest_pixel"] <= 1000, bin_clustered["rays_in_fullest_pixel"]
    del spread, clustered, order
    RT = double_gauss_scene(ot, True)
    with BinRecorder(render_mod) as rec, torch.no_grad():
        ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)[0](ot.make_generator(14))
    px, py, w, wl, _, _, ext_dg = rec.calls[0]
    main_shapes["bin_xyzw"] = check_binning(px, py, w, wl, ext_dg, "bin_xyzw")
    del px, py, w, wl, rec
    emit(dict(phase="kernels", gpu=smi, stack56=list(stack.values()), bin_spread=bin_spread,
              bin_clustered=bin_clustered, main_path_shapes=list(main_shapes.values()),
              tolerances=dict(p=TOL_P, w_rel=TOL_W_REL, pol=TOL_POL, bin=TOL_BIN,
                              bin_per_ray_in_fullest_pixel=TOL_BIN_PER_RAY,
                              flips_per_mray=FLIPS_PER_MRAY),
              ops_per_ray_step=RUN_OPS_PER_RAY_STEP))
    stack_store = stack["conic_run[nopol,store]"]      # the stored trace of the stack: phase trace
    stack_slots = {k: v for k, v in stack.items() if "slots" in k}
    del stack

    # ---- the paths: before each drive the counters are set to 0, right ----
    # ---- after it they are read ----------------------------------------
    launches = {}       # kernel label -> launches on its path

    # ---- 2b. binning inputs that take the kernel's other ways, through -----
    # ---- RenderImage.render --------------------------------------------
    # two hot pixels on a spread background (a warp's votes are never "one
    # pixel": the partner search and the accumulators carry the hot pixels),
    # and a ray count that is no multiple of a vote's 32 rays, of a warp's 128
    # or of a block, on inputs that start 4 bytes off a 16-byte boundary
    g = ot.make_generator(19)
    ext_b = [-43.265, 43.265, -43.265, 43.265]
    n_tail = N_RAYS - 17
    xs, ys = ((torch.rand(N_RAYS + 1, generator=g, device=dev) * 2 - 1) * 1.1 * ext_b[1] for _ in range(2))
    pick = torch.rand(N_RAYS + 1, generator=g, device=dev)
    xs = torch.where(pick < 0.25, 3.2101, torch.where(pick < 0.5, -17.7303, xs))
    ys = torch.where(pick < 0.25, -8.4102, torch.where(pick < 0.5, 21.0304, ys))
    ws = torch.rand(N_RAYS + 1, generator=g, device=dev)
    wls = 380.0 + 400.0 * torch.rand(N_RAYS + 1, generator=g, device=dev)
    bin_paths = {}
    for label, sl in (("bin_xyzw@two_hot", slice(0, N_RAYS)), ("bin_xyzw@tail", slice(1, 1 + n_tail))):
        hits = torch.stack([xs[sl], ys[sl], torch.zeros_like(xs[sl])], dim=-1)
        rimg_b = ot.RenderImage(extent=ext_b)
        reset_launch_counts()
        with BinRecorder(render_image_mod) as rec:
            rimg_b.render(hits, ws[sl], wls[sl])
        assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1
        launches[label] = bin_xyzw_cuda.launches
        _, _, _, _, Nx_b, Ny_b, ext_r = rec.calls[0]
        # the kernel itself on the sliced inputs (the tail's lie off a 16-byte boundary)
        assert (xs[sl].data_ptr() % 16 == 0) == (label == "bin_xyzw@two_hot")
        bin_paths[label] = check_binning(xs[sl], ys[sl], ws[sl], wls[sl], ext_r, label, Nx=Nx_b, Ny=Ny_b)
        # what the entry point holds is the kernel's image
        power_b = float(ws[sl][(xs[sl].abs() <= ext_b[1]) & (ys[sl].abs() <= ext_b[1])].double().sum())
        assert abs(rimg_b.power() - power_b) <= 1e-5 * power_b, (rimg_b.power(), power_b)
        del hits, rimg_b, rec
    assert bin_paths["bin_xyzw@two_hot"]["rays_in_fullest_pixel"] > N_RAYS // 5
    assert bin_paths["bin_xyzw@tail"]["N"] == n_tail and n_tail % 32 and n_tail % 128
    del xs, ys, ws, wls, pick
    # edges of the kernel's tile schedule at full width, the kernel itself
    # against its plain version: every ray in one pixel (one tile of
    # ⌈N / CHUNK⌉ work items), no live ray (beyond the extent or of weight
    # 0), a 189² image (18 tiles, about 23 rays a pixel), and 1000 × 999
    # pixels, no multiple of the tile, with rays on the extent's inclusive
    # edges and so on the last pixel
    from optrace_tpu_torch.ops.cuda_binning import TILE
    g = ot.make_generator(23)
    u0, u1, u2, u3 = (torch.rand(N_RAYS, generator=g, device=dev) for _ in range(4))
    wl_e = 380.0 + 400.0 * u3
    sx, sy = (u0 * 2 - 1) * 1.1 * ext_b[1], (u1 * 2 - 1) * 1.1 * ext_b[3]
    spot = torch.full((N_RAYS,), 3.2101, device=dev)
    beyond = u0 < 0.5
    ex, ey = sx.clone(), sy.clone()
    ex[:2000], ey[1000:3000] = ext_b[1], ext_b[3]
    edge_inputs = {
        "bin_xyzw@one_pixel": (spot, -2.5 * spot, u2, wl_e, NX, NY),
        "bin_xyzw@no_live": (torch.where(beyond, 1.01 * ext_b[1] + u1, sx), sy,
                             torch.where(beyond, u2, 0.0), wl_e, NX, NY),
        "bin_xyzw@189": (sx, sy, u2, wl_e, 189, 189),
        "bin_xyzw@ragged": (ex, ey, u2, wl_e, 1000, 999)}
    edge = {label: check_binning(*a[:4], ext_b, label, Nx=a[4], Ny=a[5]) for label, a in edge_inputs.items()}
    assert edge["bin_xyzw@one_pixel"]["rays_in_fullest_pixel"] == N_RAYS
    assert edge["bin_xyzw@no_live"]["rays_binned"] == 0 and edge["bin_xyzw@no_live"]["image_max"] == 0.0
    assert 1000 * 999 % TILE != 0 and edge["bin_xyzw@ragged"]["rays_binned"] > N_RAYS // 2
    emit(dict(phase="binning_inputs", gpu=smi, entry="RenderImage.render",
              inputs=list(bin_paths.values()), tile_schedule_edges=list(edge.values())))
    del u0, u1, u2, u3, wl_e, sx, sy, spot, beyond, ex, ey, edge_inputs

    # ---- 3. fused render ------------------------------------------------
    RT = double_gauss_scene(ot, no_pol=True)
    render, extent = ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)     # default device
    sink_mask = render_mod._detector_sink(RT, 0, "Equidistant", None, NX, NY, dev)[3]
    runs = run_partition(ot, RT, [sink_mask])
    assert runs == dg_runs, runs
    img = torch.zeros((NY, NX, 4), dtype=torch.float32, device=dev)
    with torch.no_grad():
        # warm-up batches, not accumulated: the eager first call and the
        # capture of the step into a CUDA graph
        render(ot.make_generator(100))
        render(ot.make_generator(101))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        for b in range(N_BATCHES):
            batch = render(ot.make_generator(b))
            img_k = batch if b == 0 else img_k
            img += batch
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
    n_run_render, n_bin_render = conic_run.launches, bin_xyzw_cuda.launches
    assert n_run_render == len(runs) * N_BATCHES, (n_run_render, runs)
    assert n_bin_render == N_BATCHES, n_bin_render
    assert conic_run.variant_launches == {(False, False): len(runs) * N_BATCHES}
    launches["conic_run[nopol,nostore]"] = n_run_render
    launches["bin_xyzw"] = n_bin_render
    assert img.shape == (NY, NX, 4) and bool(torch.isfinite(img).all())
    power = float(img[..., 3].sum())
    source_power = N_BATCHES * sum(rs.power for rs in RT.ray_sources)
    assert 0.0 < power <= source_power, (power, source_power)
    # the same batch through the plain versions, on the card
    with torch.no_grad():
        before = (conic_run.launches, bin_xyzw_cuda.launches)
        go.cuda_trace = False
        go.cuda_binning = False
        try:
            img_p = render(ot.make_generator(0))
        finally:
            go.cuda_trace = True
            go.cuda_binning = True
        assert (conic_run.launches, bin_xyzw_cuda.launches) == before
    p1 = float(img_p[..., 3].sum())
    d_img = float((img_k - img_p).abs().max())
    d_sum = float((img_k - img_p).abs().sum())
    # the traces are identical; the two binnings add 10⁶ f32 weights in
    # different orders, and the image of a point is a few pixels, each the sum
    # of up to 10⁶ terms: sqrt(N)·2⁻²⁴ ≈ 6e-5 relative is the expected
    # difference, 5e-4 the limit
    assert abs(float(img_k[..., 3].sum()) - p1) <= 5e-4 * p1, (float(img_k[..., 3].sum()), p1)
    assert d_sum <= 5e-4 * float(img_p.abs().sum()), (d_img, d_sum)
    emit(dict(phase="render", gpu=smi, scene="double_gauss", N_batch=N_RAYS, batches=N_BATCHES,
              cuda_fuse_planar=fuse_default, image=[NY, NX, 4], extent=list(extent), runs=runs,
              launches=dict(conic_run=n_run_render, bin_xyzw=n_bin_render),
              power_on_detector=power, source_power=source_power,
              ms_per_batch=t_render / N_BATCHES * 1e3,
              rays_per_s=N_BATCHES * N_RAYS / t_render,
              kernel_vs_plain=dict(max_abs=d_img, sum_abs=d_sum, power_plain=p1)))
    del img, img_k, img_p, batch, render
    torch.cuda.empty_cache()

    # ---- 3b. the render batch as a CUDA graph against the eager batch ------
    launches.update(graph_phase(ot, smi))
    torch.cuda.empty_cache()

    # ---- 4. stored trace: on the card until it is read; the trace cache ----
    launches.update(trace_phase(ot, smi, dg_runs))
    torch.cuda.empty_cache()
    read_launches, read_rows = read_path_phase(ot, smi, dg_runs)
    launches.update(read_launches)
    torch.cuda.empty_cache()
    repeatable_phase(ot, smi)
    torch.cuda.empty_cache()

    # ---- 5. asphere stack: kernel, then trace → detector_image → sRGB -----
    # the plain version of an asphere run is about 11 000 eager launches: timed once
    asph, asph_calls = run_variants(asphere_scene, [20], "@asphere20", seed=15, plain_reps=1)
    stress = stress_run_call(asph_calls[0], "conic_run[nopol,store]@asphere20,stress",
                             spread=2.6, tilt=0.25, seed=16)
    assert stress["counts_miss_tir_outline_ill"][0] > 1000 and stress["counts_miss_tir_outline_ill"][3] > 0, stress
    # the same with rays whose bracket never settles (sz = 0, NaN, inf)
    stress_nan = stress_run_call(asph_calls[0], "conic_run[nopol,store]@asphere20,stress+nan",
                                 spread=2.6, tilt=0.25, seed=16, poison=True)
    assert stress_nan["poisoned_rays"] >= 3 * (N_RAYS // 1000) and stress_nan["max_abs_err"] == 0.0, stress_nan
    del asph_calls
    torch.cuda.empty_cache()

    RTa = asphere_scene(ot, no_pol=True)
    assert run_partition(ot, RTa) == [20]
    RTa.trace(20000)                            # warm-up at a small size
    RTa.detector_image()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    RTa.trace(N_RAYS)
    t_trace = time.perf_counter() - t0
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        rimg = RTa.detector_image()
        t_image = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb = rimg.get("sRGB (Absolute RI)", 945)
    t_get = time.perf_counter() - t0
    assert conic_run.launches == 1 and conic_run.kind_launches.get("asphere") == 1, conic_run.kind_launches
    assert conic_run.variant_launches == {(False, True): 1}
    assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1
    launches["conic_run[nopol,store]@asphere20"] = conic_run.launches
    launches["bin_xyzw@detector_image"] = bin_xyzw_cuda.launches
    source_power_a = sum(rs.power for rs in RTa.ray_sources)
    data = rimg.data
    # 20 uncoated surfaces leave about 0.95²⁰ = 0.36 of the power
    assert data.shape[2] == 4 and np.isfinite(data).all()
    assert 0.2 * source_power_a < rimg.power() <= source_power_a, (rimg.power(), source_power_a)
    assert rgb.shape == (945, 945, 3) and np.isfinite(rgb.data).all()
    assert 0.0 <= rgb.data.min() and rgb.data.max() <= 1.0 and rgb.data.max() > 0.5
    px, py, w, wl, Nx_a, Ny_a, ext_a = rec.calls[0]
    bin_image = check_binning(px, py, w, wl, ext_a, "bin_xyzw@detector_image", Nx=Nx_a, Ny=Ny_a)
    del px, py, w, wl, rec
    # the same trace and image through the plain versions, on the card: the
    # raytracer seeds its generator by the count of its traces, so a fresh
    # scene traced as often draws the same rays
    RTp = asphere_scene(ot, no_pol=True)
    before = (conic_run.launches, bin_xyzw_cuda.launches)
    go.cuda_trace = False
    go.cuda_binning = False
    try:
        RTp.trace(20000)
        RTp.trace(N_RAYS)
        rimg_p = RTp.detector_image()
    finally:
        go.cuda_trace = True
        go.cuda_binning = True
    assert (conic_run.launches, bin_xyzw_cuda.launches) == before
    flips_a, d_sections = sections_agree(RTa, RTp, "asphere stack, kernel against plain trace")
    assert int(np.abs(RTp._msgs - RTa._msgs).sum()) <= 2 * flips_a
    d_image = float(np.abs(rimg_p.data - data).max())
    if flips_a == 0:        # same hits: the images differ by the binning's order of sums alone
        assert np.array_equal(rimg_p.extent, rimg.extent)
        assert d_image <= bin_image["tolerance_plain"], (d_image, bin_image["tolerance_plain"])
    assert abs(rimg_p.power() - rimg.power()) <= 5e-4 * rimg.power()
    # the other two variants through their entry points
    RTd, t_trace_pol = drive_trace(asphere_scene, no_pol=False)
    assert conic_run.variant_launches == {(True, True): 1} and conic_run.kind_launches.get("asphere") == 1
    launches["conic_run[pol,store]@asphere20"] = conic_run.launches
    assert np.isfinite(RTd.rays.pol_list[:, -2]).all() and float(RTd.rays.w_list[:, -2].sum()) > 0
    RTd, power_render_a = drive_render(asphere_scene)
    assert conic_run.variant_launches == {(False, False): 1} and conic_run.kind_launches.get("asphere") == 1
    assert bin_xyzw_cuda.launches == 1 and 0 < power_render_a <= source_power_a
    launches["conic_run[nopol,nostore]@asphere20"] = conic_run.launches
    del RTd
    emit(dict(phase="asphere", gpu=smi, scene="asphere_stack", N=N_RAYS, runs=[20],
              kernels=list(asph.values()), stress=stress, stress_never_settling=stress_nan,
              bin_detector_image=bin_image,
              path=dict(entry="Raytracer.trace -> detector_image -> get('sRGB (Absolute RI)')",
                        launches=dict(conic_run=launches["conic_run[nopol,store]@asphere20"],
                                      bin_xyzw=launches["bin_xyzw@detector_image"]),
                        trace_seconds=t_trace, detector_image_seconds=t_image,
                        get_srgb_seconds=t_get, image=list(data.shape), extent=list(rimg.extent),
                        power_on_detector=rimg.power(), source_power=source_power_a,
                        infos_rows=RTa._msgs.sum(axis=1).tolist(),
                        image_vs_plain_max_abs=d_image, sections_vs_plain_max_abs=d_sections,
                        flipped_rays_vs_plain=flips_a,
                        pol_trace_seconds=t_trace_pol,
                        fused_render_power_on_detector=power_render_a)))
    del RTp, rimg_p, rgb

    # ---- 5b. the sections kept on the card: images and spectra of that trace --
    from optrace_tpu_torch import color as color_mod
    assert RTa.rays._dev["p"].is_cuda
    kept_MB = sum(t.numel() * t.element_size() for t in RTa.rays._dev.values() if t is not None) / 1e6
    # the storage filled with its own host arrays, as user code may: the
    # sections are then uploaded from the host
    r = RTa.rays
    r._lock = False
    r.fill(r.p_list, r.w_list, r.pol_list, r.n_list, r.wl_list, r.s0_list)
    r.lock()
    RTa._last_trace_snapshot = RTa.tracing_snapshot()
    assert r._dev is None
    reset_launch_counts()
    t0 = time.perf_counter()
    rimg_h = RTa.detector_image()
    t_image_host = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1
    # same hits either way: the images differ by the order of the binning's atomic sums
    assert np.array_equal(rimg_h.extent, rimg.extent)
    d_host = float(np.abs(rimg_h.data - data).max())
    assert d_host <= TOL_BIN * data.max(), (d_host, data.max())
    RTa.trace(N_RAYS)                           # a trace of its own: the tensors are back
    reset_launch_counts()
    t0 = time.perf_counter()
    rimg2 = RTa.detector_image()
    t_image2 = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1
    ph_d, w_d, wl_d, ext_d, _, _, _ = RTa._hit_detector("check")
    assert ph_d.is_cuda and ph_d.dtype == torch.float64
    ph_h, w_h, wl_h = ph_d.cpu().numpy(), w_d.cpu().numpy(), wl_d.double().cpu().numpy()

    def image_against_f64(img_r, x, y, w, wl, label):
        """An image of the port against f64 numpy histograms of the same hits:
        power and the Y channel; hits on a pixel edge may change their pixel."""
        Ny_, Nx_, _ = img_r.shape
        e = img_r.extent
        rng = [[e[2], e[3]], [e[0], e[1]]]
        ref_w, _, _ = np.histogram2d(y, x, bins=[Ny_, Nx_], range=rng, weights=w)
        ref_y, _, _ = np.histogram2d(y, x, bins=[Ny_, Nx_], range=rng,
                                     weights=w * np.asarray(color_mod.y_observer(wl), dtype=np.float64))
        got = img_r.data
        total = float(ref_w.sum())
        assert abs(float(got[..., 3].sum()) - total) <= 1e-5 * total, (label, float(got[..., 3].sum()), total)
        d_w = float(np.abs(got[..., 3] - ref_w).sum()) / total
        d_y = float(np.abs(got[..., 1] - ref_y).sum()) / float(ref_y.sum())
        assert d_w <= TOL_EDGE_SHARE and d_y <= TOL_EDGE_SHARE, (label, d_w, d_y)
        return dict(power=total, sum_abs_diff_over_power=d_w, y_sum_abs_diff_over_y=d_y)

    def spectrum_against_f64(spec, w, wl, label):
        """A rendered spectrum against numpy's f64 histogram over its own bins."""
        ref, _ = np.histogram(wl, bins=len(spec._vals), weights=w, range=[spec._wls[0], spec._wls[-1]])
        ref = ref / (spec._wls[1] - spec._wls[0])
        d = float(np.abs(spec._vals - ref).max())
        # a wavelength on a bin edge may fall on either side: two rays' weight
        assert d <= 2 * float(w.max()) / (spec._wls[1] - spec._wls[0]) + 1e-9 * ref.max(), (label, d)
        assert abs(spec.power() - float(w.sum())) <= 1e-9 * float(w.sum()), label
        return dict(bins=len(spec._vals), max_abs_diff=d, power=spec.power())

    sections_out = dict(detector_image=image_against_f64(rimg2, ph_h[:, 0], ph_h[:, 1], w_h, wl_h,
                                                          "detector_image"))
    reset_launch_counts()
    t0 = time.perf_counter()
    dspec = RTa.detector_spectrum()
    t_dspec = time.perf_counter() - t0
    sspec = RTa.source_spectrum()
    assert bin_xyzw_cuda.launches == 0
    with BinRecorder(render_image_mod) as rec:
        t0 = time.perf_counter()
        simg = RTa.source_image()
        t_simg = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1 and len(rec.calls) == 1     # kernel 2: one launch an image
    launches["bin_xyzw@source_image"] = bin_xyzw_cuda.launches
    px, py, w, wl, Nx_s, Ny_s, ext_s = rec.calls[0]
    bin_source = check_binning(px, py, w, wl, ext_s, "bin_xyzw@source_image", Nx=Nx_s, Ny=Ny_s)
    del px, py, w, wl, rec
    src_p, src_w = RTa.rays.p_list[:, 0], RTa.rays.w_list[:, 0].astype(np.float64)
    src_wl = RTa.rays.wl_list.astype(np.float64)
    sections_out["source_image"] = image_against_f64(simg, src_p[:, 0], src_p[:, 1], src_w, src_wl,
                                                     "source_image")
    sections_out["detector_spectrum"] = spectrum_against_f64(dspec, w_h, wl_h, "detector_spectrum")
    sections_out["source_spectrum"] = spectrum_against_f64(sspec, src_w, src_wl, "source_spectrum")
    assert abs(simg.power() - source_power_a) <= 1e-5 * source_power_a
    emit(dict(phase="device_sections", gpu=smi, scene="asphere_stack", N=N_RAYS,
              detector_image_seconds=t_image, detector_image_seconds_second_trace=t_image2,
              detector_image_seconds_from_host_storage=t_image_host,
              detector_image_seconds_before_sections_stayed=1.88,
              image_vs_host_storage_path_max_abs=d_host, image_max=float(data.max()),
              tolerance=TOL_BIN * float(data.max()),
              detector_spectrum_seconds=t_dspec, source_image_seconds=t_simg,
              kept_tensors_MB=kept_MB,
              bin_source_image=bin_source, against_f64_histograms=sections_out,
              launches=dict(bin_xyzw_per_image=1, bin_xyzw_per_spectrum=0)))
    del RTa, rimg, rimg_h, rimg2, data, simg, ph_d, w_d, wl_d, ph_h, w_h, wl_h, src_p, src_w, src_wl
    torch.cuda.empty_cache()

    # ---- 6. planar kinds: tilted plate, ring, rectangle and slit in a run --
    go.cuda_fuse_planar = True
    try:
        planar, planar_calls = run_variants(planar_stack_scene, [61], "@planar61", seed=17, slots=True)
        stress_p = stress_run_call(planar_calls[0], "conic_run[nopol,store]@planar61,stress",
                                   spread=2.0, tilt=0.1, seed=18)
        del planar_calls
        kinds_p = planar["conic_run[nopol,store]"]["step_kinds"]
        assert kinds_p == {"conic": 56, "tilted": 2, "absorb:ring": 1, "absorb:rect": 1,
                           "absorb:slit": 1}, kinds_p
        # through the entry points: one launch that holds every planar kind
        for label, (no_pol, store) in variants.items():
            RTs, _ = drive_trace(planar_stack_scene, no_pol) if store else drive_render(planar_stack_scene)
            assert conic_run.launches == 1 and conic_run.variant_launches == {(not no_pol, store): 1}
            for tag in ("tilted", "absorb:ring", "absorb:rect", "absorb:slit"):
                assert conic_run.kind_launches.get(tag) == 1, conic_run.kind_launches
            launches[label + "@planar61"] = conic_run.launches
            if store:
                assert conic_run.slot_launches == 1, conic_run.slot_launches
                launches[label.replace("]", ",slots]") + "@planar61"] = conic_run.slot_launches
            if label != "conic_run[nopol,store]":
                del RTs
        RTs, _ = drive_trace(planar_stack_scene, True)
        wl_ = RTs.rays.w_list
        n_stops = [int(((wl_[:, j - 1] > 0) & (wl_[:, j] <= 0)).sum()) - int(RTs._msgs[:, j].sum())
                   for j, st in enumerate(RTs._build_steps(), start=1) if st.action == "absorb"]
        assert all(n > 0 for n in n_stops[:3]), n_stops
        del RTs, wl_
        # the double Gauss with the ring inside its run
        dg_fused, _ = run_variants(double_gauss_scene, [15], "@dg15", seed=12)
        assert dg_fused["conic_run[nopol,store]"]["step_kinds"] == {"conic": 14, "absorb:ring": 1}
        for label, (no_pol, store) in variants.items():
            RTd, _ = drive_trace(double_gauss_scene, no_pol) if store else drive_render(double_gauss_scene)
            assert conic_run.launches == 1 and conic_run.variant_launches == {(not no_pol, store): 1}
            assert conic_run.kind_launches.get("absorb:ring") == 1, conic_run.kind_launches
            launches[label + "@dg15"] = conic_run.launches
            del RTd
    finally:
        go.cuda_fuse_planar = fuse_default
    # flag off: an asphere widens the run, a tilted plate stays out of it and
    # is traced as a tilted plane by the unrolled step
    go.cuda_fuse_planar = False
    try:
        RTat = asphere_tilted_scene(ot, no_pol=True)
        kinds = [st.sfns.kind for st in RTat._build_steps()]
        assert kinds[:10] == ["asphere", "conic", "asphere", "conic", "tilted", "tilted",
                              "conic", "conic", "conic", "conic"], kinds
        assert run_partition(ot, RTat) == [4, 4]
        RTat.trace(20000)
        reset_launch_counts()
        RTat.trace(N_RAYS // 4)
        assert conic_run.launches == 2 and conic_run.kind_launches.get("asphere") == 1 \
            and "tilted" not in conic_run.kind_launches, conic_run.kind_launches
        pl = RTat.rays.p_list
        alive = RTat.rays.w_list[:, 7] > 0

        def slope_y(a, b):
            return float(np.mean((pl[alive, b, 1] - pl[alive, a, 1]) / (pl[alive, b, 2] - pl[alive, a, 2])))
        deflection = slope_y(6, 7) - slope_y(4, 5)
        assert abs(deflection) > 0.03, deflection       # (n − 1)·8° is about 0.085 rad
        go.cuda_trace = False
        try:
            RTpl = asphere_tilted_scene(ot, no_pol=True)
            RTpl.trace(20000)
            RTpl.trace(N_RAYS // 4)
        finally:
            go.cuda_trace = True
        _, d_plain = sections_agree(RTat, RTpl, "asphere + tilted, kernel against plain trace")
        # flag on: the same scene is one run of 10 and gives the same sections
        go.cuda_fuse_planar = True
        RTon = asphere_tilted_scene(ot, no_pol=True)
        assert run_partition(ot, RTon) == [10]
        RTon.trace(20000)
        RTon.trace(N_RAYS // 4)
        _, d_on = sections_agree(RTat, RTon, "asphere + tilted, flag on against flag off")
        del RTat, RTpl, RTon, pl
    finally:
        go.cuda_fuse_planar = fuse_default
    emit(dict(phase="planar", gpu=smi, N=N_RAYS, planar_stack=list(planar.values()), stress=stress_p,
              absorbed_at_ring_rect_slit=n_stops[:3], double_gauss_fused=list(dg_fused.values()),
              asphere_and_tilted_flag_off=dict(runs=[4, 4], tilted_unrolled=True,
                                               deflection_rad=deflection,
                                               sections_vs_plain_max_abs=d_plain,
                                               flag_on_runs=[10], flag_on_max_abs_diff=d_on)))

    # ---- 7. the default of cuda_fuse_planar, measured ---------------------
    # fused render and stored trace of the double Gauss, flag off, on, on,
    # off, twice over, within this one call; same seeds in every leg, every
    # batch timed on the host's clock up to its synchronize
    legs = []
    images, device_launch_count = {}, {}
    RT = double_gauss_scene(ot, no_pol=True)
    RTt = double_gauss_scene(ot, no_pol=True)
    steps_t = RTt._build_steps()
    RTt.rays.init(RTt.ray_sources, N_RAYS, len(RTt.tracing_surfaces) + 2, True)
    src_t = RTt._make_source_fn(N_RAYS)
    outl_t = tuple(float(v) for v in RTt.outline)
    try:
        for flag in (False, True, True, False) * 2:
            go.cuda_fuse_planar = flag
            render, _ = ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)
            with torch.no_grad():
                render(ot.make_generator(100))
                torch.cuda.synchronize()
                reset_launch_counts()
                acc = torch.zeros((NY, NX, 4), dtype=torch.float32, device=dev)
                batch_ms = []
                for b in range(N_BATCHES_FLAG):
                    t0 = time.perf_counter()
                    acc += render(ot.make_generator(b))
                    torch.cuda.synchronize()
                    batch_ms.append((time.perf_counter() - t0) * 1e3)
                run_launches = conic_run.launches / N_BATCHES_FLAG
                if flag not in device_launch_count:
                    device_launch_count[flag] = device_launches(lambda: render(ot.make_generator(0)))

                def dev_trace():
                    return trace_bundle(steps_t, RTt.n0, outl_t, *src_t(ot.make_generator(5)), True)
                trace_ms = cuda_ms(dev_trace, reps=3, warmup=1)
            images.setdefault(flag, acc)
            legs.append(dict(cuda_fuse_planar=flag, runs=run_partition(ot, RT, [sink_mask]),
                             ms_per_batch_median=statistics.median(batch_ms), ms_per_batch=batch_ms,
                             conic_run_launches_per_batch=run_launches,
                             stored_trace_device_ms=trace_ms))
            del acc, render
    finally:
        go.cuda_fuse_planar = fuse_default
    assert [leg["runs"] for leg in legs] == [[6, 8], [15], [15], [6, 8]] * 2, legs

    def over(flag, key):
        return [leg[key] for leg in legs if leg["cuda_fuse_planar"] == flag]
    ms_off = statistics.median(over(False, "ms_per_batch_median"))
    ms_on = statistics.median(over(True, "ms_per_batch_median"))
    spread_same = max(max(v) - min(v) for v in (over(False, "ms_per_batch_median"),
                                                over(True, "ms_per_batch_median")))
    # on is the faster setting only beyond the spread of equal legs and
    # beyond FLAG_MIN_GAIN of the batch; a tie keeps off
    on_wins = (ms_off - ms_on) > max(spread_same, FLAG_MIN_GAIN * ms_off)
    d_flag = float((images[True] - images[False]).abs().sum())
    p_off = float(images[False][..., 3].sum())
    assert abs(float(images[True][..., 3].sum()) - p_off) <= 5e-4 * p_off
    assert d_flag <= 5e-4 * float(images[False].abs().sum()), d_flag
    emit(dict(phase="fuse_planar", gpu=smi, scene="double_gauss", N_batch=N_RAYS,
              batches_per_leg=N_BATCHES_FLAG, legs=legs, ms_per_batch_off=ms_off, ms_per_batch_on=ms_on,
              stored_trace_device_ms_off=statistics.median(over(False, "stored_trace_device_ms")),
              stored_trace_device_ms_on=statistics.median(over(True, "stored_trace_device_ms")),
              device_launches_per_batch_off=device_launch_count[False],
              device_launches_per_batch_on=device_launch_count[True],
              spread_between_equal_legs_ms=spread_same, min_gain=FLAG_MIN_GAIN,
              faster_setting="on" if on_wins else "tie: off", default_in_the_package=fuse_default,
              default_matches_this_run=bool(fuse_default == on_wins),
              images_sum_abs_diff=d_flag, image_power_off=p_off))
    del images, RT, RTt

    # ---- 8. the single-step kernel's probe --------------------------------
    reset_launch_counts()
    step_res = check_conic_step()
    launches["conic_step"] = step_res["launches"]
    emit(dict(phase="conic_step_probe", gpu=smi, **step_res))

    # ---- 9. every step kind outside the runs: image source, filter, HURB, ----
    # ---- ideal lens, through Raytracer.trace ------------------------------
    RTs = steps_scene(ot, use_hurb=True)
    kinds_s = [(k, len(i)) for k, i in _partition_runs(RTs._build_steps(), [], True)]
    assert kinds_s == [("step", 1), ("run", 6), ("step", 1), ("run", 8), ("step", 1), ("step", 1)], kinds_s
    assert [st.action for st in RTs._build_steps()] == \
        ["filter"] + ["refract"] * 6 + ["absorb"] + ["refract"] * 8 + ["ideal", "absorb"]
    RTs.trace(20000)                            # warm-up at a small size
    torch.cuda.synchronize()
    reset_launch_counts()
    with RunRecorder() as rec_s:
        t0 = time.perf_counter()
        RTs.trace(N_RAYS)
        t_steps = time.perf_counter() - t0
    assert conic_run.launches == 2 and conic_run.variant_launches == {(True, True): 2}, conic_run.variant_launches
    launches["conic_run[pol,store]@steps"] = conic_run.launches
    steps_kernel = check_run_calls(rec_s.calls, "conic_run[pol,store]@steps")
    del rec_s
    n_launch_steps = device_launches(lambda: RTs.trace(N_RAYS))
    RTs._seed_counter = 1
    RTs.trace(N_RAYS)                           # the trace that is compared draws seed 2, as a fresh scene's second
    simg_s = RTs.detector_image()
    # the same seed through the plain runs: same eager stream, same generator
    RTq = steps_scene(ot, use_hurb=True)
    before = conic_run.launches
    go.cuda_trace = False
    try:
        RTq.trace(20000)
        RTq.trace(N_RAYS)
    finally:
        go.cuda_trace = True
    assert conic_run.launches == before
    ra, rb = RTs.rays, RTq.rays
    sections_equal = bool(np.array_equal(ra.p_list, rb.p_list) and np.array_equal(ra.w_list, rb.w_list)
                          and np.array_equal(ra.pol_list, rb.pol_list, equal_nan=True)
                          and np.array_equal(ra.wl_list, rb.wl_list))
    assert sections_equal, "steps scene: kernel and plain runs give other sections"
    assert np.array_equal(RTs._msgs, RTq._msgs), (RTs._msgs.sum(axis=1), RTq._msgs.sum(axis=1))
    del RTq, rb
    source_power_s = sum(rs.power for rs in RTs.ray_sources)
    w_src, w_filt = float(ra.w_list[:, 0].sum()), float(ra.w_list[:, 1].sum())
    assert w_filt <= FILTER_MAX_T * w_src * (1 + 1e-6), (w_filt, w_src)
    assert 0.0 < simg_s.power() <= FILTER_MAX_T * source_power_s, (simg_s.power(), source_power_s)
    assert np.isfinite(ra.pol_list[ra.w_list[:, -2] > 0, -2]).all()
    # the same rays without HURB: equal up to the ring, and from there every
    # ray keeps its geometric path: the spot of a ray about that path has
    # width 0 without HURB and more with it
    RTo = steps_scene(ot, use_hurb=False)
    RTo.trace(20000)
    RTo.trace(N_RAYS)
    ro = RTo.rays
    j_ring = 8                                  # section of the ring aperture (source 0, filter 1, 6 refractions)
    assert np.array_equal(ro.p_list[:, :j_ring + 1], ra.p_list[:, :j_ring + 1])
    both = (ro.w_list[:, -2] > 0) & (ra.w_list[:, -2] > 0)
    shift = np.linalg.norm(ra.p_list[both, -2, :2] - ro.p_list[both, -2, :2], axis=1)
    rms_shift_um = float(np.sqrt(np.mean(shift ** 2))) * 1e3
    assert rms_shift_um > 0.01 and float(np.mean(shift > 0)) > 0.5, rms_shift_um
    assert int(RTo._msgs[4].sum()) == 0
    emit(dict(phase="steps", gpu=smi, scene="image source, filter, double Gauss with HURB, ideal lens",
              N=N_RAYS, actions=[st.action for st in RTs._build_steps()], partition=kinds_s,
              launches=dict(conic_run_per_trace=2, device_launches_per_trace=n_launch_steps),
              trace_seconds=t_steps, kernel=steps_kernel,
              sections_bit_equal_to_plain_runs=sections_equal,
              infos_rows=RTs._msgs.sum(axis=1).tolist(), hurb_neg_dir=int(RTs._msgs[4].sum()),
              source_power=source_power_s, power_behind_filter=w_filt,
              power_on_detector=simg_s.power(), filter_max_transmission=FILTER_MAX_T,
              hurb_rms_shift_on_detector_um=rms_shift_um, without_hurb_rms_shift_um=0.0))
    del RTs, RTo, ra, ro, simg_s, shift, both
    torch.cuda.empty_cache()

    # ---- 10. iterative_render: a stored batch, then fused batches ---------
    from optrace_tpu_torch.parallel.checkpoint import batch_generator, batch_seed, RenderCheckpoint
    RTi = double_gauss_scene(ot, no_pol=True)
    z_det = float(RTi.detectors[0].pos[2])
    positions = [[0.0, 0.0, z_det], [0.0, 0.0, z_det - 2.0]]
    assert RTi.ITER_RAYS_STEP == N_RAYS
    RTi.trace(20000)                            # warm-up; the render's first batch draws seed 2
    torch.cuda.synchronize()
    reset_launch_counts()
    with BinRecorder(render_mod) as rec_i:
        t0 = time.perf_counter()
        imgs_i = RTi.iterative_render(N_ITERATIVE, pos=positions)
        torch.cuda.synchronize()
        t_iter = time.perf_counter() - t0
    n_fused = N_ITERATIVE // N_RAYS - 1
    assert conic_run.launches == 2 + 2 * n_fused, conic_run.launches
    assert conic_run.variant_launches == {(False, True): 2, (False, False): 2 * n_fused}
    assert bin_xyzw_cuda.launches == len(positions) * (1 + n_fused), bin_xyzw_cuda.launches
    launches["conic_run[nopol,store]@iterative"] = conic_run.variant_launches[(False, True)]
    launches["conic_run[nopol,nostore]@iterative"] = conic_run.variant_launches[(False, False)]
    launches["bin_xyzw@iterative"] = bin_xyzw_cuda.launches
    px, py, w, wl, Nx_i, Ny_i, ext_i = rec_i.calls[0]
    bin_iter = check_binning(px, py, w, wl, ext_i, "bin_xyzw@iterative", Nx=Nx_i, Ny=Ny_i)
    del px, py, w, wl, rec_i
    # the same render by hand through the plain versions: the stored batch
    # (same seed), then the fused batches with the generators of their index
    RTh = double_gauss_scene(ot, no_pol=True)
    before = (conic_run.launches, bin_xyzw_cuda.launches)
    go.cuda_trace = False
    go.cuda_binning = False
    try:
        RTh.trace(20000)
        RTh.trace(N_RAYS)
        hand = []
        for j, pos_j in enumerate(positions):
            RTh.detectors[0].move_to(pos_j)
            im = RTh.detector_image(_dont_filter=True)
            im._data *= N_RAYS / N_ITERATIVE
            hand.append(im)
        cfgs = [dict(detector_index=0, pos=positions[j], extent=tuple(hand[j].extent),
                     filter_extent=tuple(hand[j]._extent0), Ny=hand[j].shape[0], Nx=hand[j].shape[1])
                for j in range(len(positions))]
        render_h, _ = ot.make_fused_render_multi(RTh, N_RAYS, cfgs)
        with torch.no_grad():
            for i in range(1, n_fused + 1):
                tiles, _ = render_h(batch_generator(0x17E7 + RTh._seed_counter, i, dev))
                for j in range(len(positions)):
                    hand[j]._data += tiles[j].double().cpu().numpy() * (N_RAYS / N_ITERATIVE)
    finally:
        go.cuda_trace = True
        go.cuda_binning = True
    assert (conic_run.launches, bin_xyzw_cuda.launches) == before
    iter_out = []
    source_power_i = sum(rs.power for rs in RTi.ray_sources)
    for j in range(len(positions)):
        a, b = imgs_i[j], hand[j]
        assert np.array_equal(a.extent, b.extent) and a.shape == b.shape
        # the hit share of the source power, from the same rays through the plain versions
        assert abs(a.power() - b.power()) <= 1e-3 * b.power(), (a.power(), b.power())
        assert 0.0 < a.power() <= source_power_i and np.isfinite(a.data).all()
        d_sum = float(np.abs(a.data - b.data).sum())
        assert d_sum <= 5e-4 * float(np.abs(b.data).sum()), d_sum
        iter_out.append(dict(pos=positions[j], extent=list(a.extent), power=a.power(),
                             power_by_plain_versions=b.power(), sum_abs_diff=d_sum))
    emit(dict(phase="iterative", gpu=smi, scene="double_gauss", N=N_ITERATIVE, batch=N_RAYS,
              positions=len(positions), seconds=t_iter, rays_per_s=N_ITERATIVE / t_iter,
              launches=dict(conic_run=2 + 2 * n_fused, bin_xyzw=len(positions) * (1 + n_fused),
                            stored_batches=1, fused_batches=n_fused),
              images=iter_out, source_power=source_power_i, bin_first_fused_batch=bin_iter,
              infos_rows=RTi._msgs.sum(axis=1).tolist()))
    del RTi, RTh, imgs_i, hand, tiles
    torch.cuda.empty_cache()

    # ---- 11. render_huge: interrupted, resumed; a spherical detector -------
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck_path = os.path.join(ck_dir, "huge.ckpt.npz")
    kw_h = dict(batch_size=N_RAYS, checkpoint_every=1)
    reset_launch_counts()
    t0 = time.perf_counter()
    full = double_gauss_scene(ot, True).render_huge(N_ITERATIVE, **kw_h)
    torch.cuda.synchronize()
    t_huge = time.perf_counter() - t0
    n_b = N_ITERATIVE // N_RAYS
    assert conic_run.launches == 2 * n_b and conic_run.variant_launches == {(False, False): 2 * n_b}
    assert bin_xyzw_cuda.launches == n_b
    launches["conic_run[nopol,nostore]@huge"] = conic_run.launches
    launches["bin_xyzw@huge"] = bin_xyzw_cuda.launches

    class Interrupted(Exception):
        pass

    real_save = RenderCheckpoint.save

    def save_then_stop(self):
        real_save(self)
        if self.done == 2:
            raise Interrupted
    RenderCheckpoint.save = save_then_stop
    try:
        double_gauss_scene(ot, True).render_huge(N_ITERATIVE, checkpoint_path=ck_path, **kw_h)
        raise AssertionError("render_huge was not interrupted")
    except Interrupted:
        pass
    finally:
        RenderCheckpoint.save = real_save
    on_disk = RenderCheckpoint(ck_path, n_b)
    assert on_disk.done == 2 and list(on_disk.remaining()) == [2, 3]
    reset_launch_counts()
    t0 = time.perf_counter()
    resumed = double_gauss_scene(ot, True).render_huge(N_ITERATIVE, checkpoint_path=ck_path, **kw_h)
    t_resume = time.perf_counter() - t0
    assert conic_run.launches == 2 * 2 and bin_xyzw_cuda.launches == 2      # the two batches left
    d_resume = float(np.abs(resumed.data - full.data).max())
    # each batch is a function of its generator, its graph replay included,
    # and the binning's sums do not depend on order: bit for bit
    assert np.array_equal(resumed.data, full.data), (d_resume, full.data.max())
    assert abs(resumed.power() - full.power()) <= 1e-6 * full.power()
    assert RenderCheckpoint(ck_path, n_b).done == n_b
    for f in os.listdir(ck_dir):
        os.remove(os.path.join(ck_dir, f))
    os.rmdir(ck_dir)
    # spherical detector: one fused batch against detector_image of a stored
    # trace of the same rays (the generator of batch 0 seeds the trace)
    ext_sph = [-0.05, 0.05, -0.05, 0.05]
    reset_launch_counts()
    sph = double_gauss_spherical_scene(ot).render_huge(N_RAYS, batch_size=N_RAYS, extent=ext_sph,
                                                      projection_method="Equidistant")
    assert conic_run.launches == 2 and bin_xyzw_cuda.launches == 1
    RTsp = double_gauss_spherical_scene(ot)
    RTsp._seed_counter = batch_seed(0, 0) - 1
    RTsp.trace(N_RAYS)
    sph_stored = RTsp.detector_image(extent=ext_sph, projection_method="Equidistant")
    assert sph.projection == "Equidistant" == sph_stored.projection and sph.shape == sph_stored.shape
    p_sph = sph_stored.power()
    assert p_sph > 0.1 and abs(sph.power() - p_sph) <= 1e-4 * p_sph, (sph.power(), p_sph)
    d_sph = float(np.abs(sph.data[..., 3] - sph_stored.data[..., 3]).sum())
    assert d_sph <= 2e-3 * p_sph, (d_sph, p_sph)      # hits on a pixel edge: the sink's frame differs
    lit = float(np.mean(sph_stored.data[..., 3] > 0))
    assert lit > 0.002, lit
    emit(dict(phase="huge", gpu=smi, scene="double_gauss", N=N_ITERATIVE, batch=N_RAYS,
              seconds_uninterrupted_no_checkpoint=t_huge, rays_per_s=N_ITERATIVE / t_huge,
              seconds_resumed_two_batches_with_saves=t_resume,
              launches=dict(conic_run=2 * n_b, bin_xyzw=n_b),
              resumed_vs_uninterrupted_max_abs=d_resume, image_max=float(full.data.max()),
              tolerance="bit for bit", power=full.power(),
              spherical=dict(projection="Equidistant", extent=ext_sph, power_fused=sph.power(),
                             power_stored=p_sph, sum_abs_diff_power=d_sph, lit_pixel_share=lit)))
    del full, resumed, sph, sph_stored, RTsp

    # ---- 12-15. the design and analysis layer ------------------------------
    launches.update(design_phase(ot, smi))
    torch.cuda.empty_cache()
    focus_launches, focus_rows, psf_render = focus_phase(ot, smi)
    launches.update(focus_launches)
    torch.cuda.empty_cache()
    convolve_phase(ot, smi, psf_render)
    del psf_render
    eye_launches, eye_rows = eye_phase(ot, smi)
    launches.update(eye_launches)
    torch.cuda.empty_cache()

    # ---- 16-17. generic surfaces and the ZEMAX loader -----------------------
    generic_launches, generic_rows = generic_phase(ot, smi)
    launches.update(generic_launches)
    torch.cuda.empty_cache()
    zmx_launches, zmx_rows = zmx_phase(ot, smi)
    launches.update(zmx_launches)
    torch.cuda.empty_cache()

    # ---- 18-19. the sharded render and the GUI ------------------------------
    launches.update(sharded_phase(ot, smi))
    torch.cuda.empty_cache()
    gui_launches, gui_rows = gui_phase(ot, smi)
    launches.update(gui_launches)
    torch.cuda.empty_cache()

    # ---- 20. the example scripts of examples_torch/ ---------------------------
    example_launches, example_rows = examples_phase(ot, smi)
    launches.update(example_launches)
    torch.cuda.empty_cache()

    # ---- the kernels of every path --------------------------------------
    rows = dict(main_shapes)
    rows.update({k + "@asphere20": v for k, v in asph.items()})
    rows.update({k + "@planar61": v for k, v in planar.items()})
    rows.update({k + "@dg15": v for k, v in dg_fused.items()})
    rows["bin_xyzw@detector_image"] = bin_image
    rows.update(bin_paths)
    rows["conic_step"] = step_res
    # the paths of the image and spectrum outputs and of the batched renders:
    # a row measured on that path's own inputs where they differ from the
    # main path's, else the main path's row (same shapes) with this path's launches
    rows["bin_xyzw@source_image"] = bin_source
    rows["conic_run[pol,store]@steps"] = steps_kernel
    rows["conic_run[nopol,store]@iterative"] = main_shapes["conic_run[nopol,store]"]
    rows["conic_run[nopol,nostore]@iterative"] = main_shapes["conic_run[nopol,nostore]"]
    rows["bin_xyzw@iterative"] = bin_iter
    rows["conic_run[nopol,nostore]@huge"] = main_shapes["conic_run[nopol,nostore]"]
    rows["bin_xyzw@huge"] = main_shapes["bin_xyzw"]
    rows["conic_run[nopol,store]@design"] = main_shapes["conic_run[nopol,store]"]
    rows["conic_run[nopol,store]@focus"] = main_shapes["conic_run[nopol,store]"]
    rows.update(focus_rows)
    rows.update(eye_rows)
    rows.update(generic_rows)
    rows.update(zmx_rows)
    rows["conic_run[nopol,nostore]@graph"] = main_shapes["conic_run[nopol,nostore]"]
    rows["bin_xyzw@graph"] = main_shapes["bin_xyzw"]
    rows["conic_run[nopol,nostore]@sharded"] = main_shapes["conic_run[nopol,nostore]"]
    rows["bin_xyzw@sharded"] = main_shapes["bin_xyzw"]
    rows["conic_run[pol,store]@gui"] = main_shapes["conic_run[pol,store]"]
    rows["conic_run[nopol,store]@stack56"] = stack_store
    rows["conic_run[nopol,store]@trace_replay"] = main_shapes["conic_run[nopol,store]"]
    rows["conic_run[pol,store]@trace_replay"] = main_shapes["conic_run[pol,store]"]
    rows["conic_run[nopol,store]@stack56_replay"] = stack_store
    rows.update({k + "@stack56": v for k, v in stack_slots.items()})
    rows.update(gui_rows)
    rows["conic_run[nopol,store]@read_path"] = main_shapes["conic_run[nopol,store]"]
    rows.update(read_rows)
    rows.update(example_rows)
    sources = {"bin_xyzw": ("bin_xyzw.cu", "optrace_tpu/ops/pallas_binning.py:83"),
               "conic_run": ("conic_run.cu", "optrace_tpu/ops/pallas_run.py:431"),
               "conic_step": ("conic_step.cu", "optrace_tpu/ops/pallas_trace.py:152")}
    kernels = []
    for label, r in rows.items():
        n_launch = launches.get(label, 0)
        assert n_launch > 0, f"{label} was not launched on any path"
        src_file, replaces = sources[label.split("[")[0].split("@")[0]]
        kernels.append(dict(
            name=label, route="cuda", source=f"optrace_tpu_torch/csrc/{src_file}", replaces=replaces,
            launches=n_launch, max_abs_err=max(r["max_abs_err"], r.get("max_abs_err_sections", 0.0)),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
        for key in ("library_int64_ms", "scratch_bytes", "ms_by_launch"):
            if key in r:
                kernels[-1][key] = r[key]
    emit(dict(kernels=kernels))
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
