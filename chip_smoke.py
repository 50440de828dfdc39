#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from optrace_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card, renders the double-Gauss
objective (Nikkor-Wakamiya 100 mm f/1.4) with the fused streaming render at
10⁶ rays a batch into a 945 × 945 × 4 image, runs the stored trace, and
checks that both went through the kernels (launch counters). Every phase
prints one JSON line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure exits with a non-zero code. Without a CUDA device the script
fails at once: nothing here runs on the CPU.
"""

import json
import statistics
import subprocess
import sys
import time

N_RAYS = 10 ** 6
NX = NY = 945
N_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM f32 peak outside the tensor cores
RUN_OPS_PER_RAY_STEP = 150      # f32 operations of one refract step
BIN_OPS_PER_RAY = 30
CPU_REFERENCE_MS_PER_SURFACE_MRAY = 85.0    # the NumPy reference package on a CPU (BASELINE.md)

# kernel against plain version on the card, same inputs. Without FMA
# contraction (-fmad=false) both perform the same IEEE f32 operations, so
# the expected difference is 0; the bounds are those of the CPU parity tests.
TOL_P, TOL_W_REL, TOL_POL = 2e-5, 2e-6, 2e-5
TOL_BIN = 1e-5                  # kernel against the same sums taken in f64
TOL_BIN_PER_RAY = 2e-9          # plain version (one f32 add per ray): per ray in the fullest pixel
FLIPS_PER_MRAY = 200            # rays whose hit/miss may differ (expected: 0)


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


def synthetic_stack_scene(ot, no_pol):
    """28 spherical lenses (56 refracting surfaces in one run) and a ring
    aperture, with dispersive glasses."""
    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 600], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=3), divergence="Lambertian", div_angle=3,
                        pos=[0, 0, 0], s=[0, 0, 1], spectrum=ot.presets.light_spectrum.d65))
    z = 10.0
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    for i in range(28):
        front = ot.SphericalSurface(r=8, R=60.0 if i % 2 == 0 else 80.0)
        back = ot.SphericalSurface(r=8, R=-70.0 if i % 2 == 0 else -90.0)
        RT.add(ot.Lens(front, back, n=glasses[i % 2], de=0.5, pos=[0, 0, z]))
        z += 15.0
    RT.add(ot.Aperture(ot.RingSurface(r=9, ri=6), pos=[0, 0, z]))
    return RT


# ----------------------------------------------------------------------
# kernels against their plain versions

def capture_run_calls(RT, N, store, seed):
    """Trace one bundle of the scene and record the arguments of every
    call of the run kernel's wrapper: the shapes and inputs that the main
    path gives it."""
    import torch
    from optrace_tpu_torch.tracer import trace_core

    calls = []
    real = trace_core.conic_run

    def recorder(p, s, w, n_tab, med_idx, steps, pol=None, store=True):
        calls.append(dict(p=p, s=s, w=w, n_tab=n_tab, med_idx=med_idx, steps=steps,
                          pol=pol, store=store))
        return real(p, s, w, n_tab, med_idx, steps, pol=pol, store=store)

    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps()
    gen = torch.Generator(device=RT.device)
    gen.manual_seed(seed)
    trace_core.conic_run = recorder
    try:
        with torch.no_grad():
            p, s, pols, w, wl = RT._make_source_fn(N)(gen)
            trace_core.trace_bundle(steps, RT.n0, tuple(float(v) for v in RT.outline),
                                    p, s, pols, w, wl, RT.no_pol, store_sections=store)
    finally:
        trace_core.conic_run = real
    return calls


def check_run_calls(calls, label):
    """Kernel against plain version on the recorded calls: errors, counts,
    hit/miss flips, times and the bound. Raises on disagreement."""
    import torch
    from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference

    res = dict(name=label, N=int(calls[0]["p"].shape[0]), steps=[len(c["steps"]) for c in calls],
               media_rows_read=[len({r for pair in c["med_idx"] for r in pair}) for c in calls],
               max_abs_err=0.0, max_abs_err_sections=0.0, max_rel_err_w=0.0, flips=0,
               counts_equal=True, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ray_steps_alive=0)
    bound_bytes_ms = bound_ops_ms = 0.0
    for c in calls:
        args = (c["p"], c["s"], c["w"], c["n_tab"], c["med_idx"], c["steps"])
        kw = dict(pol=c["pol"], store=c["store"])
        (pk, sk, wk, qk), (ck, ypk, ywk, yqk) = conic_run(*args, **kw)
        (pr, sr, wr, qr), (cr, ypr, ywr, yqr) = conic_run_reference(*args, **kw)
        torch.cuda.synchronize()
        N, L = pk.shape[0], len(c["steps"])
        M = len({r for pair in c["med_idx"] for r in pair})     # media rows this call reads

        flipped = (wk > 0) != (wr > 0)
        if c["store"]:
            flipped = flipped | torch.any((ywk > 0) != (ywr > 0), dim=0)
        keep = ~flipped
        res["flips"] += int(flipped.sum())

        def err(a, b):
            d = (a[keep] - b[keep]).abs()
            return float(d.max()) if d.numel() else 0.0

        e_state = max(err(pk, pr), err(sk, sr))
        e_w = float(((wk - wr).abs() / wr.abs().clamp(min=1e-30))[keep & (wr > 0)].max())
        e_pol = err(qk, qr) if qk is not None else 0.0
        e_sec = 0.0
        if c["store"]:
            e_sec = max(err(ypk.transpose(0, 1), ypr.transpose(0, 1)),
                        err(yqk.transpose(0, 1), yqr.transpose(0, 1)) if yqk is not None else 0.0)
            e_w = max(e_w, float(((ywk - ywr).abs() / ywr.abs().clamp(min=1e-30))
                                 [(ywr > 0) & keep[None, :]].max()))
        res["max_abs_err"] = max(res["max_abs_err"], e_state, e_pol)
        res["max_abs_err_sections"] = max(res["max_abs_err_sections"], e_sec)
        res["max_rel_err_w"] = max(res["max_rel_err_w"], e_w)
        d_counts = int((ck - cr).abs().sum())
        res["counts_equal"] = res["counts_equal"] and d_counts == 0
        assert d_counts <= 2 * int(flipped.sum()), f"{label}: counts differ by {d_counts}"
        assert max(e_state, e_sec) <= TOL_P, f"{label}: position/direction error {e_state} {e_sec}"
        assert e_w <= TOL_W_REL, f"{label}: weight error {e_w}"
        assert e_pol <= TOL_POL, f"{label}: polarization error {e_pol}"
        assert torch.isfinite(pk).all() and torch.isfinite(wk).all()

        res["ms"] += cuda_ms(lambda: conic_run(*args, **kw))
        res["plain_ms"] += cuda_ms(lambda: conic_run_reference(*args, **kw), reps=5, warmup=1)

        # bound: each input read once, each output written once; operations
        # for the ray-steps that were alive in this run's data
        with_pol = c["pol"] is not None
        state_b = 28 + (12 if with_pol else 0)
        nbytes = N * (2 * state_b + 4 * M) + L * 16
        if c["store"]:
            nbytes += N * L * (28 if with_pol else 16)
        alive = int((ywr > 0).sum()) + N if c["store"] else None
        if alive is None:   # count with a stored plain run
            _, (_, _, yw_tmp, _) = conic_run_reference(*args, pol=c["pol"], store=True)
            alive = int((yw_tmp > 0).sum()) + N
            del yw_tmp
        res["bytes"] += nbytes
        res["ray_steps_alive"] += alive
        bound_bytes_ms += nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms += alive * RUN_OPS_PER_RAY_STEP / F32_OPS_PER_S * 1e3
    assert res["flips"] <= FLIPS_PER_MRAY * res["N"] / 1e6 * len(calls), f"{label}: {res['flips']} flips"
    res["bound_ms"] = max(bound_bytes_ms, bound_ops_ms)
    res["bound_by"] = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    res["bound_bytes_ms"], res["bound_ops_ms"] = bound_bytes_ms, bound_ops_ms
    res["library_ms"] = None
    return res


def check_binning(px, py, w, wl, extent, label):
    """Binning kernel against its plain version and the library yardstick
    (one index_add_ on precomputed keys and values)."""
    import torch
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda, bin_xyzw_reference
    from optrace_tpu_torch.ops.binning import binning_indices_2d
    from optrace_tpu_torch.color.observers import x_observer, y_observer, z_observer

    img_k = bin_xyzw_cuda(px, py, w, wl, NX, NY, extent)
    img_r = bin_xyzw_reference(px, py, w, wl, NX, NY, extent)
    torch.cuda.synchronize()
    err = float((img_k - img_r).abs().max())
    scale = float(img_r.abs().max())
    # both against the same sums taken in f64: a pixel that takes n rays
    # carries an f32 accumulation error that grows with n (the image of a
    # point puts 10⁵–10⁶ rays into one pixel), in the plain version too
    # (same f32 keys and values, so that no ray changes its pixel)
    xi, yi, wm = binning_indices_2d(px, py, w, NX, NY, extent)
    keys = yi * NX + xi
    vals = torch.stack([x_observer(wl) * wm, y_observer(wl) * wm, z_observer(wl) * wm, wm], dim=-1)
    img_64 = torch.zeros((NY * NX, 4), dtype=torch.float64, device=px.device)
    img_64.index_add_(0, keys, vals.double())
    img_64 = img_64.view(NY, NX, 4)
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
    ms = cuda_ms(lambda: bin_xyzw_cuda(px, py, w, wl, NX, NY, extent))
    plain_ms = cuda_ms(lambda: bin_xyzw_reference(px, py, w, wl, NX, NY, extent))

    out = torch.zeros((NY * NX, 4), dtype=torch.float32, device=px.device)
    library_ms = cuda_ms(lambda: out.index_add_(0, keys, vals))

    N = px.shape[0]
    nbytes = 16 * N + 16 * NX * NY
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = N * BIN_OPS_PER_RAY / F32_OPS_PER_S * 1e3
    return dict(name=label, N=N, image=[NY, NX, 4], max_abs_err=err, image_max=scale,
                max_abs_err_vs_f64=err_k64, plain_max_abs_err_vs_f64=err_r64,
                rays_in_fullest_pixel=rays_in_a_pixel, tolerance=tol, tolerance_plain=tol_plain,
                rays_binned=int((wm != 0).sum()), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations")


def capture_bin_call(ot, RT, seed):
    """The inputs that one batch of the fused render hands to the binning."""
    import torch
    from optrace_tpu_torch.parallel import render as render_mod

    calls = []
    real = render_mod.bin_xyzw_cuda

    def recorder(px, py, w, wl, Nx, Ny, extent, out=None):
        calls.append((px, py, w, wl, extent))
        return real(px, py, w, wl, Nx, Ny, extent, out=out)

    render_mod.bin_xyzw_cuda = recorder
    try:
        render, _ = ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)
        with torch.no_grad():
            render(ot.make_generator(seed))
    finally:
        render_mod.bin_xyzw_cuda = real
    return calls[0]


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

    import optrace_tpu_torch as ot
    from optrace_tpu_torch.ops import _build, cuda_run, cuda_binning
    from optrace_tpu_torch.ops.cuda_run import conic_run
    from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
    from optrace_tpu_torch.tracer.trace_core import _partition_runs
    ot.global_options.show_progress_bar = False
    ot.global_options.show_warnings = False
    dev = ot.resolve_device()

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
    # (a) one 56-step run of the 28-lens spherical stack
    stack = []
    for label, (no_pol, store) in variants.items():
        calls = capture_run_calls(synthetic_stack_scene(ot, no_pol), N_RAYS, store, seed=11)
        assert [len(c["steps"]) for c in calls] == [56], [len(c["steps"]) for c in calls]
        stack.append(check_run_calls(calls, label + "@stack56"))
        del calls
        torch.cuda.empty_cache()
    # (b) the main path's own shapes: the two runs of the double Gauss
    main_shapes = {}
    for label, (no_pol, store) in variants.items():
        calls = capture_run_calls(double_gauss_scene(ot, no_pol), N_RAYS, store, seed=12)
        assert [len(c["steps"]) for c in calls] == [6, 8], [len(c["steps"]) for c in calls]
        main_shapes[label] = check_run_calls(calls, label)
        del calls
        torch.cuda.empty_cache()
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
    px, py, w, wl, ext_dg = capture_bin_call(ot, double_gauss_scene(ot, True), seed=14)
    main_shapes["bin_xyzw"] = check_binning(px, py, w, wl, ext_dg, "bin_xyzw")
    emit(dict(phase="kernels", gpu=smi, stack56=stack, bin_spread=bin_spread, bin_clustered=bin_clustered,
              main_path_shapes=list(main_shapes.values()),
              tolerances=dict(p=TOL_P, w_rel=TOL_W_REL, pol=TOL_POL, bin=TOL_BIN,
                              bin_per_ray_in_fullest_pixel=TOL_BIN_PER_RAY,
                              flips_per_mray=FLIPS_PER_MRAY)))

    # ---- the main path: before each drive the counters are set to 0, ----
    # ---- right after it they are read ---------------------------------
    launches = {}       # kernel label -> launches on the main path

    # ---- 3. fused render ------------------------------------------------
    RT = double_gauss_scene(ot, no_pol=True)
    render, extent = ot.make_fused_render(RT, N_RAYS, Nx=NX, Ny=NY)     # default device
    runs = [len(i) for k, i in _partition_runs(
        RT._build_steps(), [ot.parallel.render._detector_sink(RT, 0, "Equidistant", None, NX, NY,
                                                              dev)[3]]) if k == "run"]
    assert runs == [6, 8], runs
    img = torch.zeros((NY, NX, 4), dtype=torch.float32, device=dev)
    with torch.no_grad():
        render(ot.make_generator(100))        # warm-up batch, not accumulated
        torch.cuda.synchronize()
        cuda_run.reset_launch_counts()
        cuda_binning.reset_launch_counts()
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
        ot.global_options.cuda_trace = False
        ot.global_options.cuda_binning = False
        try:
            img_p = render(ot.make_generator(0))
        finally:
            ot.global_options.cuda_trace = True
            ot.global_options.cuda_binning = True
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
              image=[NY, NX, 4], extent=list(extent), runs=runs,
              launches=dict(conic_run=n_run_render, bin_xyzw=n_bin_render),
              power_on_detector=power, source_power=source_power,
              ms_per_batch=t_render / N_BATCHES * 1e3,
              rays_per_s=N_BATCHES * N_RAYS / t_render,
              kernel_vs_plain=dict(max_abs=d_img, sum_abs=d_sum, power_plain=p1)))

    # ---- 4. stored trace -------------------------------------------------
    trace_out = []
    for no_pol in (False, True):
        RTt = double_gauss_scene(ot, no_pol=no_pol)
        n_surf = len(RTt.tracing_surfaces)
        RTt.trace(20000)                        # warm-up at a small size
        torch.cuda.synchronize()
        cuda_run.reset_launch_counts()
        t0 = time.perf_counter()
        RTt.trace(N_RAYS)
        t_total = time.perf_counter() - t0
        # one launch for each run, all of the stored variant of this mode
        assert conic_run.variant_launches == {(not no_pol, True): len(runs)}, conic_run.variant_launches
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
                from optrace_tpu_torch.tracer.trace_core import trace_bundle
                b = src(ot.make_generator(5))
                return trace_bundle(steps, RTt.n0, outl, *b, no_pol)
        dev_ms = cuda_ms(dev_trace, reps=5, warmup=1)
        trace_out.append(dict(no_pol=no_pol, N=N_RAYS, surfaces=n_surf,
                              sections=list(rays.p_list.shape),
                              seconds_with_host_copy=t_total, device_ms=dev_ms,
                              ms_per_surface_per_mray=dev_ms / n_surf / (N_RAYS / 1e6),
                              dead_before_end=dead, infos_rows=RTt._msgs.sum(axis=1).tolist()))
        del RTt, rays, wl_
    emit(dict(phase="trace", gpu=smi, scene="double_gauss", traces=trace_out,
              cpu_reference_ms_per_surface_per_mray=CPU_REFERENCE_MS_PER_SURFACE_MRAY))

    # ---- the kernels of the main path ----------------------------------
    kernels = []
    for label, r in main_shapes.items():
        assert launches.get(label, 0) > 0, f"{label} was not launched on the main path"
        src_file = "bin_xyzw.cu" if label == "bin_xyzw" else "conic_run.cu"
        kernels.append(dict(
            name=label, route="cuda", source=f"optrace_tpu_torch/csrc/{src_file}",
            replaces=("optrace_tpu/ops/pallas_binning.py:83" if label == "bin_xyzw"
                      else "optrace_tpu/ops/pallas_run.py:431"),
            launches=launches[label], max_abs_err=max(r["max_abs_err"], r.get("max_abs_err_sections", 0.0)),
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
