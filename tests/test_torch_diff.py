"""The port's differentiable design against the JAX package on identical
inputs: the bilinear binning and its gradients, the parameterized render
and d(spot loss)/d(rho) on injected rays, and the rule that a render traces
the surfaces its parameters describe on every route (kernel, plain run,
unrolled step), with or without a gradient.

Both packages trace the same scene, built with each package's public
classes, and the same rays made with numpy from a seed. Tolerances: images
1e-6 of their maximum and gradients rtol 1e-4 (f32 on both sides; XLA may
contract a*b+c where eager PyTorch does not), the binning's gradients
rtol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.ops import binning as jbinning
from optrace_tpu.tracer.trace_core import trace_bundle as jtrace_bundle
from optrace_tpu.tracer.detector import detector_hits as jdetector_hits, \
    build_segment_mask as jbuild_segment_mask
from optrace_tpu.tracer.scene_compile import compile_surface as jcompile_surface

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import binning as tbinning
from optrace_tpu_torch.tracer import raytracer as rt_mod, trace_core as ttc
from optrace_tpu_torch.tracer.diff import (make_parameterized_render, spot_loss, spot_radius,
                                           steps_with_params)
from optrace_tpu_torch.tracer.scene_compile import host_values, with_params

EXT = (-2.0, 2.0, -2.0, 2.0)
N = 4096
NX = 63


def _scene(pkg, R=20.0):
    """The lens of tests/test_autodiff.py and a weak meniscus behind it:
    four refracting surfaces, one run of the run kernel, which is where
    the constants of the parameters at the start once stayed."""
    kw = dict(device="cpu") if pkg is otp else {}
    RT = pkg.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, **kw)
    RT.add(pkg.RaySource(pkg.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=pkg.LightSpectrum("Monochromatic", wl=550)))
    n = pkg.RefractionIndex("Constant", n=1.5)
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=R), pkg.SphericalSurface(r=3, R=-R),
                    n=n, pos=[0, 0, 0], d=1.0))
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=60), pkg.SphericalSurface(r=3, R=80),
                    n=n, pos=[0, 0, 4], d=1.0))
    RT.add(pkg.Detector(pkg.RectangularSurface(dim=[4, 4]), pos=[0, 0, 19]))
    return RT


def _rays(n=N, seed=0):
    """Parallel rays over the unit disc at z = -5, 550 nm, as numpy f32."""
    rng = np.random.default_rng(seed)
    r, th = np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    p = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, -5.0)], -1).astype(np.float32)
    s = np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))
    pols = np.full((n, 3), np.nan, np.float32)
    return p, s, pols, np.full(n, 1.0 / n, np.float32), np.full(n, 550.0, np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's render of injected rays at a given rho of the front
    surface, built as tests/test_autodiff_matrix.py builds its harness."""
    RT = _scene(ot)
    steps = RT._build_steps()
    dsurf = RT.detectors[0].surface
    sfns = jcompile_surface(dsurf)
    seg = jbuild_segment_mask(RT._section_z_bounds(), float(dsurf.z_min), float(dsurf.z_max))
    rays = [jnp.asarray(a) for a in _rays()]
    outline = tuple(float(v) for v in RT.outline)

    def hits(rho):
        params = [dict(st.sfns.params) for st in steps]
        params[0] = dict(params[0], rho=rho)
        steps_p = [st._replace(sfns=st.sfns._replace(params=pp)) for st, pp in zip(steps, params)]
        out = jtrace_bundle(steps_p, RT.n0, outline, *rays, True, False)
        ph, wsel, ish, _ = jdetector_hits(sfns, float(dsurf.z_min), out["p"], out["w"],
                                          segment_mask=seg)
        return ph[:, 0], ph[:, 1], jnp.where(ish, wsel, 0.0), out["wl"]

    def render(rho):
        return jbinning.bin_xyzw_soft(*hits(rho), NX, NX, EXT)
    render.hits = hits

    def loss(rho):
        img = render(rho)
        x, y = jnp.linspace(EXT[0], EXT[1], NX), jnp.linspace(EXT[2], EXT[3], NX)
        w = img[:, :, 3]
        ws = jnp.maximum(w.sum(), 1e-12)
        cx, cy = jnp.sum(w * x[None]) / ws, jnp.sum(w * y[:, None]) / ws
        return jnp.sqrt(jnp.sum(w * ((x[None] - cx) ** 2 + (y[:, None] - cy) ** 2)) / ws)

    rho0 = float(np.asarray(steps[0].sfns.params["rho"]))
    return render, loss, rho0


@pytest.fixture(scope="module")
def port_side():
    render, params0 = make_parameterized_render(_scene(otp), N, extent=list(EXT), Nx=NX, Ny=NX)
    rays = [torch.from_numpy(a) for a in _rays()]
    return render, params0, rays


def _with_rho(params0, rho, i=0):
    params = [dict(p) for p in params0]
    params[i] = dict(params[i], rho=rho)
    return params


# ----------------------------------------------------------------------
# bin_xyzw_soft

def test_bin_xyzw_soft_image_and_gradients_equal_jax():
    rng = np.random.default_rng(3)
    n, Nx, Ny, ext = 3000, 17, 13, (-1.0, 1.5, -0.5, 1.0)
    # a tenth of the rays lies outside the extent, some exactly on its edges
    px = rng.uniform(-1.2, 1.7, n).astype(np.float32)
    py = rng.uniform(-0.7, 1.2, n).astype(np.float32)
    px[:5], py[5:10] = np.float32(ext[1]), np.float32(ext[2])
    w = rng.uniform(0, 1, n).astype(np.float32)
    wl = rng.uniform(380, 780, n).astype(np.float32)
    v = rng.normal(size=(Ny, Nx, 4)).astype(np.float32)

    def jf(px, py, w):
        return jnp.sum(jbinning.bin_xyzw_soft(px, py, w, jnp.asarray(wl), Nx, Ny, ext) * v)
    j_img = np.asarray(jbinning.bin_xyzw_soft(*map(jnp.asarray, (px, py, w, wl)), Nx, Ny, ext))
    j_grads = [np.asarray(g) for g in jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (px, py, w)))]

    tp, tq, tw = (torch.tensor(a, requires_grad=True) for a in (px, py, w))
    img = tbinning.bin_xyzw_soft(tp, tq, tw, torch.from_numpy(wl), Nx, Ny, ext)
    np.testing.assert_allclose(img.detach().numpy(), j_img, rtol=1e-5, atol=1e-6 * np.abs(j_img).max())
    (img * torch.from_numpy(v)).sum().backward()
    for name, g_t, g_j in zip(("px", "py", "w"), (tp.grad, tq.grad, tw.grad), j_grads):
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-5 * np.abs(g_j).max(),
                                   err_msg=name)
    # the rays outside carry no weight and no gradient
    out = (px < ext[0]) | (px > ext[1]) | (py < ext[2]) | (py > ext[3])
    assert out.sum() > 100 and np.all(tw.grad.numpy()[out] == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bin_xyzw_soft_focused_spot_equals_jax_in_f64(dtype):
    """A focused spot: 20 000 rays on a few pixels of 189², as the design
    render bins them, against the JAX package's own ``bin_xyzw_soft`` in
    f64 on the same values. The port's sums do not depend on the order of
    the rays: in f32 within 1e-6 of the peak (its deposits are rounded to
    f32; the JAX package's f32 scatter, which adds in ray order, is the
    reason its f64 form is the reference), in f64 within 1e-12 of it."""
    rng = np.random.default_rng(11)
    n, Nx, ext = 20000, 189, (-0.3, 0.3, -0.3, 0.3)
    px, py = (rng.normal(0.01, 0.004, n).astype(dtype) for _ in range(2))
    w = rng.uniform(0.5, 1.0, n).astype(dtype)
    wl = rng.uniform(400, 700, n).astype(dtype)
    with jax.enable_x64(True):
        ref = np.asarray(jbinning.bin_xyzw_soft(*(jnp.asarray(a, jnp.float64) for a in (px, py, w, wl)),
                                                Nx, Nx, ext))
    assert ref.dtype == np.float64
    img = tbinning.bin_xyzw_soft(*(torch.from_numpy(a) for a in (px, py, w, wl)), Nx, Nx, ext).numpy()
    peak = np.abs(ref).max()
    lit = (ref[..., 3] > 1e-3 * ref[..., 3].max()).sum()
    assert 4 <= lit <= 400 and img.dtype == dtype
    np.testing.assert_allclose(img, ref, rtol=0, atol=(1e-6 if dtype == np.float32 else 1e-12) * peak)


# ----------------------------------------------------------------------
# the parameterized render on injected rays

@pytest.mark.parametrize("drho", [0.0, 2e-3, -3e-3])
def test_render_at_changed_rho_equals_jax(jax_side, port_side, drho):
    """A render at a changed curvature without a gradient traces the new
    surface (before the repair the runs kept the constants of params0),
    and equals the JAX package's render at the same curvature: its trace
    and detector hits, binned by its own soft binning in f64. The port's
    sum is order-free and exact to f32 rounding; the JAX package's f32
    scatter, in ray order, is off by up to 2.6e-6 of the spot's peak here,
    beyond this test's 1e-6, so its f64 scatter is the reference."""
    jrender, _, rho0 = jax_side
    render, params0, rays = port_side
    assert [k for k, _ in ttc._partition_runs(_scene(otp)._build_steps(), [])][0] == "run"
    rho = np.float32(rho0 + drho)
    jhits = [np.asarray(a, np.float64) for a in jrender.hits(jnp.float32(rho))]
    with jax.enable_x64(True):
        img_j = np.asarray(jbinning.bin_xyzw_soft(*map(jnp.asarray, jhits), NX, NX, EXT))
    assert img_j.dtype == np.float64
    with torch.no_grad():
        img_t = render.trace_rays(_with_rho(params0, torch.tensor(rho)), *rays).numpy()
        img_0 = render.trace_rays(params0, *rays).numpy()
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-6 * np.abs(img_j).max())
    if drho:
        assert np.abs(img_t - img_0).max() > 1e-2 * np.abs(img_0).max()


def test_spot_loss_gradient_equals_jax(jax_side, port_side):
    _, jloss, rho0 = jax_side
    render, params0, rays = port_side
    g_j = float(jax.grad(jloss)(jnp.float32(rho0)))
    rho = torch.tensor(np.float32(rho0), requires_grad=True)
    loss = spot_radius(render.trace_rays(_with_rho(params0, rho), *rays), EXT)
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss(jnp.float32(rho0))), rel=1e-5)
    assert float(rho.grad) == pytest.approx(g_j, rel=1e-4)


def test_render_draws_its_rays_from_the_seed(port_side):
    render, params0, _ = port_side
    with torch.no_grad():
        a, b, c = render(params0, 7), render(params0, 7), render(params0, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    loss = spot_loss(render)
    assert float(loss(params0, 7, EXT)) == float(spot_radius(a, EXT))


def test_changed_params_on_every_route():
    """The trace of a step list whose params were swapped in by ``_replace``
    (as the JAX package's design interface does) follows the new values on
    the kernel route, on the plain route and with a gradient. A changed
    curvature equals the JAX package's trace with the same swap; a moved
    surface moves its frame and equals the JAX package's trace of the scene
    built with that surface moved (the JAX package's swap keeps the old
    frame, and its sections lie off by the shift: ROADMAP.md §3)."""
    RT_t = _scene(otp)
    steps_t = RT_t._build_steps()
    bundle = _rays(2048, seed=5)
    jrays, trays = [jnp.asarray(a) for a in bundle], [torch.from_numpy(a) for a in bundle]
    outline = tuple(float(v) for v in RT_t.outline)
    dz = np.array([0.0, 0.0, 0.25], np.float32)

    def jax_ref(name):
        RT_j = _scene(ot)
        if name == "pos":
            front = RT_j.lenses[0].front
            front.move_to(front.pos + dz)
        steps_j = RT_j._build_steps()
        if name == "rho":
            pj = [dict(st.sfns.params) for st in steps_j]
            pj[0] = dict(pj[0], rho=jnp.float32(0.052))
            steps_j = [st._replace(sfns=st.sfns._replace(params=q)) for st, q in zip(steps_j, pj)]
        return np.asarray(jtrace_bundle(steps_j, RT_j.n0, outline, *jrays, True, False)["p"])

    for name in ("rho", "pos"):
        ref = jax_ref(name)
        for route in ("kernel", "plain", "grad"):
            pt = [dict(st.sfns.params) for st in steps_t]
            val = torch.tensor(np.float32(0.052)) if name == "rho" else pt[0]["pos"] + torch.from_numpy(dz)
            pt[0] = dict(pt[0], **{name: val.requires_grad_(route == "grad")})
            st = [s._replace(sfns=s.sfns._replace(params=q)) for s, q in zip(steps_t, pt)]
            otp.global_options.cuda_trace = route != "plain"
            try:
                with torch.set_grad_enabled(route == "grad"):
                    out = ttc.trace_bundle(st, RT_t.n0, outline, *trays, True, False)
            finally:
                otp.global_options.cuda_trace = True
            np.testing.assert_allclose(out["p"].detach().numpy(), ref, rtol=5e-6, atol=2e-5,
                                       err_msg=f"{name} {route}")


def test_run_follows_changed_params_with_and_without_plans():
    """A run of kernel 1 (here its plain version on the CPU) takes its step
    table from the parameters that the steps hold, also when the plans
    were made before: new steps need new plans, and the table of a new
    parameter dict is read from it."""
    RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None"))
    for z in (0, 5, 10):
        RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-25),
                        n=otp.presets.refraction_index.BK7, pos=[0, 0, z], d=1.0))
    steps = RT._build_steps()
    assert [k for k, _ in ttc._partition_runs(steps, [])][0] == "run"
    rays = [torch.from_numpy(a) for a in _rays(1000, seed=2)]
    outline = tuple(float(v) for v in RT.outline)
    params = [dict(st.sfns.params) for st in steps]
    params[2] = dict(params[2], rho=torch.tensor(0.08), pos=params[2]["pos"] + torch.tensor([0, 0, 0.3]))
    new = steps_with_params(steps, params)
    assert host_values(new[2].sfns)["rho"] == np.float32(0.08)
    with torch.no_grad():
        run = ttc.trace_bundle(new, RT.n0, outline, *rays, True, False, plans=ttc.RunPlans(new))["p"]
        otp.global_options.cuda_trace = False
        try:
            plain = ttc.trace_bundle(new, RT.n0, outline, *rays, True, False)["p"]
        finally:
            otp.global_options.cuda_trace = True
        old = ttc.trace_bundle(steps, RT.n0, outline, *rays, True, False)["p"]
    assert torch.equal(run, plain)
    assert not torch.allclose(run, old)
    with pytest.raises(ValueError, match="another step list"):
        ttc.trace_bundle(new, RT.n0, outline, *rays, True, False, plans=ttc.RunPlans(steps))
    # a dict swapped in without its host values is read when it is traced
    swapped = steps[2].sfns._replace(params=params[2])
    assert host_values(swapped)["rho"] == np.float32(0.08)
    assert with_params(steps[2].sfns, params[2]).host_of is params[2]


def test_forward_mode_through_a_run_takes_the_plain_loop():
    """A forward-mode tangent on a run's surface parameter sends the run to
    the plain loop, and its jvp equals the reverse-mode gradient."""
    RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None"))
    for z in (0, 5):
        RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-25),
                        n=otp.presets.refraction_index.BK7, pos=[0, 0, z], d=1.0))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[8, 8]), pos=[0, 0, 30]))
    render, params0 = make_parameterized_render(RT, 2000, extent=[-3, 3, -3, 3], Nx=32, Ny=32)
    assert [k for k, _ in ttc._partition_runs(RT._build_steps(), [])][0] == "run"
    rho0 = params0[1]["rho"]
    with fwAD.dual_level():
        jvp = fwAD.unpack_dual(spot_loss(render)(
            _with_rho(params0, fwAD.make_dual(rho0, torch.tensor(1.0)), 1), 4, [-3, 3, -3, 3])).tangent
    rho = rho0.clone().requires_grad_()
    spot_loss(render)(_with_rho(params0, rho, 1), 4, [-3, 3, -3, 3]).backward()
    assert float(jvp) == pytest.approx(float(rho.grad), rel=1e-4)
    # under no_grad a parameter that requires a gradient does not keep the kernel away
    steps = [s._replace(sfns=with_params(s.sfns, {k: v.clone().requires_grad_() for k, v in
                                                   s.sfns.params.items()})) for s in RT._build_steps()]
    idxs = [i for k, ii in ttc._partition_runs(steps, []) if k == "run" for i in ii]
    p, s, w = torch.zeros((4, 3)), torch.zeros((4, 3)), torch.ones(4)
    assert ttc._run_needs_plain(steps, idxs, p, s, w, None, torch.ones((2, 4)), True)
    with torch.no_grad():
        assert not ttc._run_needs_plain(steps, idxs, p, s, w, None, torch.ones((2, 4)), True)


def test_design_render_traces_the_compiled_scene_bit_for_bit(monkeypatch):
    """The design render traces through the raytracer's compiled scene
    (``Raytracer.trace_program``), whose ambient medium is the index's
    ``on_device`` form: with a tabulated (Data) ambient index every trace of
    the render equals, bit for bit, the same trace with the index itself."""
    RT = _scene(otp)
    RT.n0 = otp.RefractionIndex("Data", wls=np.linspace(380.0, 780.0, 41),
                                vals=np.linspace(1.0005, 1.0002, 41))
    real, same = rt_mod.trace_bundle, []

    def both(steps, n0_fn, *args, **kw):
        out = real(steps, n0_fn, *args, **kw)
        ref = real(steps, RT.n0, *args, **kw)
        same.append(n0_fn is not RT.n0 and all(
            torch.equal(out[k].view(torch.int32), ref[k].view(torch.int32)) for k in ("p", "w", "n"))
            and torch.equal(out["infos"], ref["infos"]))
        return out

    monkeypatch.setattr(rt_mod, "trace_bundle", both)
    render, params0 = make_parameterized_render(RT, 2048, extent=EXT, Nx=NX, Ny=NX, soft_bin=False)
    with torch.no_grad():
        img = render(params0, 4)
    assert same == [True] and float(img[..., 3].sum()) > 0
