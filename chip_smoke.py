#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from optrace_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, renders the double-Gauss
objective (Nikkor-Wakamiya 100 mm f/1.4) with the fused streaming render at
10⁶ rays a batch into a 945 × 945 × 4 image, runs the stored trace, traces
an asphere stack and carries its stored trace through ``detector_image`` to
an sRGB image, bins two hot pixels on a spread background and a ragged ray
count through ``RenderImage.render``, drives the planar step kinds (tilted
plate, ring, rectangle, slit) in one run, measures the render with
``cuda_fuse_planar`` off and on, probes the single-step kernel, reads a
stored trace's detector and source images and spectra from the sections kept
on the card, traces a scene with an image source, a filter, HURB bending and
an ideal lens, drives ``iterative_render`` and ``render_huge`` (interrupted,
resumed, spherical detector), and checks that every path went through its
kernels (launch counters). Every phase prints one JSON line; the last line is
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


class RunRecorder:
    """Records the arguments of every call that the trace makes to the run
    kernel's wrapper while the ``with`` block runs."""

    def __enter__(self):
        from optrace_tpu_torch.tracer import trace_core
        self.module, self.calls = trace_core, []
        self.real = trace_core.conic_run

        def recorder(p, s, w, n_tab, med_idx, steps, pol=None, store=True, plan=None):
            self.calls.append(dict(p=p, s=s, w=w, n_tab=n_tab, med_idx=med_idx, steps=steps,
                                   pol=pol, store=store, plan=plan))
            return self.real(p, s, w, n_tab, med_idx, steps, pol=pol, store=store, plan=plan)
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
    """Binning kernel against its plain version and the library yardstick
    (one index_add_ on precomputed keys and values, which leaves out the
    index, the mask and the observer lookup that the kernel does). ``ms`` and
    ``library_ms`` are device times of the kernels alone, by the profiler."""
    import torch
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda, bin_xyzw_reference
    from optrace_tpu_torch.ops.binning import binning_indices_2d
    from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer

    img_k = bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent)
    img_r = bin_xyzw_reference(px, py, w, wl, Nx, Ny, extent)
    torch.cuda.synchronize()
    err = float((img_k - img_r).abs().max())
    scale = float(img_r.abs().max())
    # both against the same sums taken in f64: a pixel that takes n rays
    # carries an f32 accumulation error that grows with n (the image of a
    # point puts 10⁵–10⁶ rays into one pixel), in the plain version too
    # (same f32 keys and values, so that no ray changes its pixel)
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    keys = yi * Nx + xi
    vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
    img_64 = torch.zeros((Ny * Nx, 4), dtype=torch.float64, device=px.device)
    img_64.index_add_(0, keys, vals.double())
    img_64 = img_64.view(Ny, Nx, 4)
    err_k64 = float((img_k.double() - img_64).abs().max())
    err_r64 = float((img_r.double() - img_64).abs().max())
    rays_in_a_pixel = int(torch.bincount(keys[wm != 0]).max())
    # the kernel is held to the f64 sums; the allowance per ray is for the
    # plain version alone, and so for the kernel against it
    tol = TOL_BIN * max(scale, 1.0)
    tol_plain = max(TOL_BIN, TOL_BIN_PER_RAY * rays_in_a_pixel) * max(scale, 1.0)
    assert torch.isfinite(img_k).all()
    assert err_k64 <= tol, f"{label}: binning error {err_k64} against f64 sums (limit {tol})"
    assert err_r64 <= tol_plain, f"{label}: plain version {err_r64} off the f64 sums (limit {tol_plain})"
    assert err <= tol_plain, f"{label}: binning error {err} against the plain version (limit {tol_plain})"
    ms = device_kernel_ms(lambda: bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent), "bin_xyzw_kernel")
    ms_events = cuda_ms(lambda: bin_xyzw_cuda(px, py, w, wl, Nx, Ny, extent))
    plain_ms = cuda_ms(lambda: bin_xyzw_reference(px, py, w, wl, Nx, Ny, extent))

    # the yardstick's own kernel time, as the kernel's: no launch gap in either
    out = torch.zeros((Ny * Nx, 4), dtype=torch.float32, device=px.device)
    library_ms = device_kernel_ms(lambda: out.index_add_(0, keys, vals), "ndex")
    library_ms_events = cuda_ms(lambda: out.index_add_(0, keys, vals))

    N = px.shape[0]
    nbytes = 16 * N + 16 * Nx * Ny
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = N * BIN_OPS_PER_RAY / F32_OPS_PER_S * 1e3
    return dict(name=label, N=N, image=[Ny, Nx, 4], max_abs_err=err, image_max=scale,
                max_abs_err_vs_f64=err_k64, plain_max_abs_err_vs_f64=err_r64,
                rays_in_fullest_pixel=rays_in_a_pixel, tolerance=tol, tolerance_plain=tol_plain,
                rays_binned=int((wm != 0).sum()), ms=ms, ms_between_events=ms_events,
                plain_ms=plain_ms, library_ms=library_ms,
                library_ms_between_events=library_ms_events, bytes=nbytes, bound_ms=max(bound_bytes_ms, bound_ops_ms),
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


def device_kernel_ms(fn, name, calls=10):
    """Device time in ms of one launch of the kernels whose name holds
    ``name``, by torch.profiler over ``calls`` calls of fn(): the kernel
    alone, without the host's gap before its launch."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):        # a trace now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and name in ev.key:
                us += ev.self_device_time_total
                n += ev.count
        if n > 0:
            break
    assert n > 0, f"the profiler recorded no kernel named {name}"
    return us / 1e3 / n


def device_launches(fn):
    """Kernel launches on the device during fn(), counted by torch.profiler."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
    assert n > 0, "the profiler recorded no kernel on the device"
    return int(n)


def run_partition(ot, RT, sink_masks=()):
    from optrace_tpu_torch.tracer.trace_core import _partition_runs
    return [len(i) for k, i in _partition_runs(RT._build_steps(), list(sink_masks), RT.use_hurb)
            if k == "run"]


# ----------------------------------------------------------------------

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
    from optrace_tpu_torch.ops import _build, cuda_run, cuda_binning, cuda_trace
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

    def reset_counts():
        cuda_run.reset_launch_counts()
        cuda_binning.reset_launch_counts()
        cuda_trace.reset_launch_counts()

    def drive_trace(scene, no_pol, n=N_RAYS):
        """``Raytracer.trace`` of a fresh scene, counters set to 0 just before."""
        RTd = scene(ot, no_pol)
        RTd.trace(20000)                        # warm-up at a small size
        torch.cuda.synchronize()
        reset_counts()
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
            reset_counts()
            img_d = render_d(ot.make_generator(0))
            torch.cuda.synchronize()
        assert bool(torch.isfinite(img_d).all())
        return RTd, float(img_d[..., 3].sum())

    def sections_agree(RT_a, RT_b, label):
        """Stored sections of two traces of the same rays: flipped rays
        within the budget, the others within TOL_P. Returns (flips, max abs)."""
        pa, pb, wa, wb = RT_a.rays.p_list, RT_b.rays.p_list, RT_a.rays.w_list, RT_b.rays.w_list
        assert pa.shape == pb.shape, label
        flipped = np.any((wa > 0) != (wb > 0), axis=1)
        n_flip = int(flipped.sum())
        assert n_flip <= FLIPS_PER_MRAY * pa.shape[0] / 1e6, f"{label}: {n_flip} flipped rays"
        d = float(np.abs(pa[~flipped] - pb[~flipped]).max())
        assert d <= TOL_P, f"{label}: sections differ by {d}"
        return n_flip, d

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

    def run_variants(scene, expect_steps, suffix, seed, **kw):
        """Kernel against plain version for the three variants on the calls
        that a trace of the scene records. Returns the results by label
        and the recorded calls of the [nopol,store] variant."""
        out, kept = {}, None
        for label, (no_pol, store) in variants.items():
            calls = capture_run_calls(scene(ot, no_pol), N_RAYS, store, seed=seed)
            assert [len(c["steps"]) for c in calls] == expect_steps, [len(c["steps"]) for c in calls]
            out[label] = check_run_calls(calls, label + suffix, **kw)
            if label == "conic_run[nopol,store]":
                kept = calls
            del calls
            torch.cuda.empty_cache()
        return out, kept

    # (a) one 56-step run of the 28-lens spherical stack
    stack, _ = run_variants(synthetic_stack_scene, [56], "@stack56", seed=11)
    # (b) the main path's own shapes: the runs of the double Gauss under the
    # default of cuda_fuse_planar
    dg_runs = [15] if fuse_default else [6, 8]
    main_shapes, _ = run_variants(double_gauss_scene, dg_runs, "", seed=12)
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
        reset_counts()
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
    emit(dict(phase="binning_inputs", gpu=smi, entry="RenderImage.render",
              inputs=list(bin_paths.values())))
    del xs, ys, ws, wls, pick

    # ---- 3. fused render ------------------------------------------------
    RT = double_gauss_scene(ot, no_pol=True)
    render, extent = ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)     # default device
    sink_mask = render_mod._detector_sink(RT, 0, "Equidistant", None, NX, NY, dev)[3]
    runs = run_partition(ot, RT, [sink_mask])
    assert runs == dg_runs, runs
    img = torch.zeros((NY, NX, 4), dtype=torch.float32, device=dev)
    with torch.no_grad():
        render(ot.make_generator(100))        # warm-up batch, not accumulated
        torch.cuda.synchronize()
        reset_counts()
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

    # ---- 4. stored trace -------------------------------------------------
    trace_out = []
    for no_pol in (False, True):
        RTt = double_gauss_scene(ot, no_pol=no_pol)
        n_surf = len(RTt.tracing_surfaces)
        RTt.trace(20000)                        # warm-up at a small size
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        RTt.trace(N_RAYS)
        t_total = time.perf_counter() - t0
        # one launch for each run, all of the stored variant of this mode
        stored_runs = run_partition(ot, RTt)
        assert stored_runs == dg_runs, stored_runs
        assert conic_run.variant_launches == {(not no_pol, True): len(stored_runs)}, conic_run.variant_launches
        launches["conic_run[nopol,store]" if no_pol else "conic_run[pol,store]"] = conic_run.launches
        rays = RTt.rays
        assert rays.p_list.shape == (N_RAYS, n_surf + 2, 3), rays.p_list.shape
        assert rays.w_list.shape == (N_RAYS, n_surf + 2)
        wl_ = rays.w_list
        assert bool((wl_[:, 1:] <= wl_[:, :-1] * (1 + 1e-6)).all()), "a weight grew"
        dead = int((wl_[:, -2] <= 0).sum())      # dead before the end absorber
        counted = int(RTt._msgs[:, :-1].sum())
        assert counted == dead, (counted, dead)
        if not no_pol:
            assert rays.pol_list.shape == (N_RAYS, n_surf + 2, 3)
        # device time of source + trace alone (no copy to the host)
        steps = RTt._build_steps()
        src = RTt._make_source_fn(N_RAYS)
        outl = tuple(float(v) for v in RTt.outline)

        def dev_trace():
            with torch.no_grad():
                b = src(ot.make_generator(5))
                return trace_bundle(steps, RTt.n0, outl, *b, no_pol)
        dev_ms = cuda_ms(dev_trace, reps=3, warmup=1)
        trace_out.append(dict(no_pol=no_pol, N=N_RAYS, surfaces=n_surf,
                              sections=list(rays.p_list.shape),
                              seconds_with_host_copy=t_total, device_ms=dev_ms,
                              ms_per_surface_per_mray=dev_ms / n_surf / (N_RAYS / 1e6),
                              dead_before_end=dead,
                              infos_rows=RTt._msgs.sum(axis=1).tolist()))
        del RTt, rays, wl_, steps, src
    emit(dict(phase="trace", gpu=smi, scene="double_gauss", cuda_fuse_planar=fuse_default,
              traces=trace_out,
              cpu_reference_ms_per_surface_per_mray=CPU_REFERENCE_MS_PER_SURFACE_MRAY))

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
    reset_counts()
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
                        trace_seconds_with_host_copy=t_trace, detector_image_seconds=t_image,
                        get_srgb_seconds=t_get, image=list(data.shape), extent=list(rimg.extent),
                        power_on_detector=rimg.power(), source_power=source_power_a,
                        infos_rows=RTa._msgs.sum(axis=1).tolist(),
                        image_vs_plain_max_abs=d_image, sections_vs_plain_max_abs=d_sections,
                        flipped_rays_vs_plain=flips_a,
                        pol_trace_seconds_with_host_copy=t_trace_pol,
                        fused_render_power_on_detector=power_render_a)))
    del RTp, rimg_p, rgb

    # ---- 5b. the sections kept on the card: images and spectra of that trace --
    from optrace_tpu_torch import color as color_mod
    assert RTa._dev_sections is not None and RTa._dev_sections[1].is_cuda
    reset_counts()
    t0 = time.perf_counter()
    RTa._dev_sections = None                    # drop the tensors: the host storage is uploaded
    rimg_h = RTa.detector_image()
    t_image_host = time.perf_counter() - t0
    assert bin_xyzw_cuda.launches == 1
    # same hits either way: the images differ by the order of the binning's atomic sums
    assert np.array_equal(rimg_h.extent, rimg.extent)
    d_host = float(np.abs(rimg_h.data - data).max())
    assert d_host <= TOL_BIN * data.max(), (d_host, data.max())
    RTa.trace(N_RAYS)                           # a trace of its own: the tensors are back
    reset_counts()
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
    reset_counts()
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
              kept_tensors_MB=sum(t.numel() * t.element_size() for t in RTa._dev_sections[1:]) / 1e6,
              bin_source_image=bin_source, against_f64_histograms=sections_out,
              launches=dict(bin_xyzw_per_image=1, bin_xyzw_per_spectrum=0)))
    del RTa, rimg, rimg_h, rimg2, data, simg, ph_d, w_d, wl_d, ph_h, w_h, wl_h, src_p, src_w, src_wl
    torch.cuda.empty_cache()

    # ---- 6. planar kinds: tilted plate, ring, rectangle and slit in a run --
    go.cuda_fuse_planar = True
    try:
        planar, planar_calls = run_variants(planar_stack_scene, [61], "@planar61", seed=17)
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
        reset_counts()
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
                reset_counts()
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
    reset_counts()
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
    reset_counts()
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
              trace_seconds_with_host_copy=t_steps, kernel=steps_kernel,
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
    reset_counts()
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
    reset_counts()
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
    reset_counts()
    t0 = time.perf_counter()
    resumed = double_gauss_scene(ot, True).render_huge(N_ITERATIVE, checkpoint_path=ck_path, **kw_h)
    t_resume = time.perf_counter() - t0
    assert conic_run.launches == 2 * 2 and bin_xyzw_cuda.launches == 2      # the two batches left
    d_resume = float(np.abs(resumed.data - full.data).max())
    assert d_resume <= TOL_BIN * full.data.max(), (d_resume, full.data.max())
    assert abs(resumed.power() - full.power()) <= 1e-6 * full.power()
    assert RenderCheckpoint(ck_path, n_b).done == n_b
    for f in os.listdir(ck_dir):
        os.remove(os.path.join(ck_dir, f))
    os.rmdir(ck_dir)
    # spherical detector: one fused batch against detector_image of a stored
    # trace of the same rays (the generator of batch 0 seeds the trace)
    ext_sph = [-0.05, 0.05, -0.05, 0.05]
    reset_counts()
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
              tolerance=TOL_BIN * float(full.data.max()), power=full.power(),
              spherical=dict(projection="Equidistant", extent=ext_sph, power_fused=sph.power(),
                             power_stored=p_sph, sum_abs_diff_power=d_sph, lit_pixel_share=lit)))
    del full, resumed, sph, sph_stored, RTsp

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
    emit(dict(kernels=kernels))
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
