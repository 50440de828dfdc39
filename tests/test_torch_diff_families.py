"""Gradient families of the port's differentiable design, each checked by
central finite differences in the port: the families that the JAX package
pins in tests/test_autodiff.py and tests/test_autodiff_matrix.py.

Common random numbers throughout: every evaluation of a family traces the
same source rays (equal seeds give equal rays), so the Monte-Carlo noise
cancels in the difference. The tolerances are those of the JAX tests
(rtol 3e-2; 2e-2 for the detector plane), on the CPU in f32.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import optrace_tpu_torch as ot
from optrace_tpu_torch.tracer.trace_core import trace_bundle
from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss, steps_with_params
from optrace_tpu_torch.spectrum.refraction_index import eval_dispersion

BK7 = [1.03961212, 0.00600069867, 0.231792344, 0.0200179144, 1.01046945, 103.560653]
EXT = (-2.0, 2.0, -2.0, 2.0)


def _fd_check(loss, x0, eps, rtol, min_g=1e-7):
    """Autograd of ``loss`` at the scalar x0 against the central difference."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    loss(x).backward()
    g_auto = float(x.grad)
    with torch.no_grad():
        f_p = float(loss(torch.tensor(x0 + eps, dtype=torch.float32)))
        f_m = float(loss(torch.tensor(x0 - eps, dtype=torch.float32)))
    g_fd = (f_p - f_m) / (2.0 * eps)
    assert np.isfinite(g_auto), "autograd gradient not finite"
    assert abs(g_fd) > min_g, f"FD gradient degenerate ({g_fd})"
    assert g_auto == pytest.approx(g_fd, rel=rtol), f"auto {g_auto} vs FD {g_fd}"
    return g_auto


def _lens_rt(front, R=20.0):
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, device="cpu")
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
    RT.add(ot.Lens(front, ot.SphericalSurface(r=3, R=-R), n=ot.RefractionIndex("Constant", n=1.5),
                   pos=[0, 0, 0], d=1.0))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 21]))
    return RT


def _with(params0, i, **kw):
    params = [dict(p) for p in params0]
    params[i] = dict(params[i], **kw)
    return params


# ----------------------------------------------------------------------
# surface-parameter families through make_parameterized_render

@pytest.mark.parametrize("family", ["rho", "k", "coeff0"])
def test_surface_parameter_gradient_matches_fd(family):
    front = {"rho": ot.SphericalSurface(r=3, R=20),
             "k": ot.ConicSurface(r=3, R=20, k=-0.5),
             "coeff0": ot.AsphericSurface(r=3, R=20, k=-0.5, coeff=[2e-4, -1e-6])}[family]
    render, params0 = make_parameterized_render(_lens_rt(front), 4096, extent=list(EXT),
                                                Nx=63, Ny=63)
    loss = spot_loss(render)
    if family == "coeff0":
        c0 = params0[0]["coeff"]

        def loss_of(a0):
            return loss(_with(params0, 0, coeff=torch.cat([a0.reshape(1), c0[1:]])), 4, EXT)
        _fd_check(loss_of, float(c0[0]), 2e-5, 3e-2)
    else:
        def loss_of(v):
            return loss(_with(params0, 0, **{family: v}), 3, EXT)
        _fd_check(loss_of, float(params0[0][family]), 1e-4 if family == "rho" else 1e-3, 3e-2)


def test_lens_position_gradient_matches_fd():
    """d(spot)/d(z of the lens) through both surfaces' positions: the frame
    of the second surface moves with the first."""
    render, params0 = make_parameterized_render(_lens_rt(ot.SphericalSurface(r=3, R=20)), 2048,
                                                extent=list(EXT), Nx=63, Ny=63)
    loss = spot_loss(render)

    def loss_of(dz):
        shift = torch.stack([0 * dz, 0 * dz, dz])
        params = _with(params0, 0, pos=params0[0]["pos"] + shift)
        params[1] = dict(params[1], pos=params0[1]["pos"] + shift)
        return loss(params, 1, EXT)
    _fd_check(loss_of, 0.0, 2e-3, 3e-2, min_g=1e-5)


def test_pixel_gradients_jvp_vs_fd_image():
    """Per-pixel d(img)/d(rho): a forward-mode jvp image against the
    central-difference image, allclose over all pixels (the JAX test's
    eps and its 2 % of the scale)."""
    render, params0 = make_parameterized_render(_lens_rt(ot.ConicSurface(r=3, R=20, k=-0.5)),
                                                8192, extent=list(EXT), Nx=16, Ny=16)
    rho0 = float(params0[0]["rho"])

    def img_of(rho):
        return render(_with(params0, 0, rho=rho), 5)[:, :, 3]

    with fwAD.dual_level():
        dimg = fwAD.unpack_dual(img_of(fwAD.make_dual(torch.tensor(rho0), torch.tensor(1.0)))).tangent
    eps = 2e-3
    with torch.no_grad():
        fd = (img_of(torch.tensor(rho0 + eps)) - img_of(torch.tensor(rho0 - eps))) / (2 * eps)
    dimg, fd = dimg.numpy(), fd.numpy()
    assert np.isfinite(dimg).all()
    scale = np.abs(dimg).max()
    assert scale > 1e-3, "image insensitive to curvature?"
    np.testing.assert_allclose(dimg, fd, atol=0.02 * scale)


def test_gradient_descent_improves_focus():
    """Normalised gradient steps on the curvature of both surfaces lower the
    spot size, as examples/lens_optimization.py does."""
    render, params0 = make_parameterized_render(_lens_rt(ot.SphericalSurface(r=3, R=24), R=24),
                                                4096, extent=list(EXT), Nx=63, Ny=63)
    loss = spot_loss(render)
    rho = params0[0]["rho"].clone()

    def value_and_grad(r):
        r = r.detach().requires_grad_()
        val = loss(_with(_with(params0, 0, rho=r), 1, rho=-r), 2, EXT)
        val.backward()
        return float(val), r.grad

    l0, _ = value_and_grad(rho)
    for _ in range(6):
        _, g = value_and_grad(rho)
        rho = rho - 2e-4 * torch.sign(g) * torch.clamp(torch.abs(g) * 1e-2, max=1.0)
    assert value_and_grad(rho)[0] < l0


# ----------------------------------------------------------------------
# operand families through trace_bundle: a Sellmeier coefficient of the
# glass, the ideal lens's power, the detector plane, a source shift

@pytest.fixture(scope="module")
def harness():
    """Conic lens of Sellmeier glass and an ideal lens; fixed source rays."""
    RT = ot.Raytracer(outline=[-6, 6, -6, 6, -10, 80], no_pol=True, device="cpu")
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="Lambertian",
                        div_angle=2, spectrum=ot.presets.light_spectrum.d65))
    RT.add(ot.Lens(ot.ConicSurface(r=3, R=25, k=-1.0), ot.SphericalSurface(r=3, R=-25),
                   n=ot.RefractionIndex("Sellmeier1", coeff=BK7), pos=[0, 0, 0], d=1.0))
    RT.add(ot.IdealLens(r=3, D=20.0, pos=[0, 0, 8]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[6, 6]), pos=[0, 0, 40]))
    N = 4096
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, True)
    steps = RT._build_steps()
    p, s, pols, w, wl = RT._make_source_fn(N)(ot.make_generator(6, "cpu"))
    outline = tuple(float(v) for v in RT.outline)

    def run(steps_p, p_src=None):
        return trace_bundle(steps_p, RT.n0, outline, p if p_src is None else p_src,
                            s, pols, w, wl, True, False)
    return steps, run, p


def _last_segment_at(out, z_d):
    """Positions on the plane z = z_d from the last live segment and the
    power that reaches it (the end absorber zeroes the last weights)."""
    P, W = out["p"], out["w"]
    p0, p1 = P[:, -2], P[:, -1]
    seg = p1 - p0
    den = torch.where(torch.abs(seg[:, 2]) > 1e-9, seg[:, 2], 1.0)
    t = (z_d - p0[:, 2]) / den
    return p0[:, 0] + t * seg[:, 0], p0[:, 1] + t * seg[:, 1], W[:, -2]


def _spot_at(out, z_d):
    x, y, wg = _last_segment_at(out, z_d)
    ws = torch.clamp(wg.sum(), min=1e-12)
    cx, cy = (wg * x).sum() / ws, (wg * y).sum() / ws
    return torch.sqrt((wg * ((x - cx) ** 2 + (y - cy) ** 2)).sum() / ws)


@pytest.mark.parametrize("family", ["sellmeier_b1", "ideal_power", "detector_z", "source_shift"])
def test_operand_gradient_matches_fd(harness, family):
    steps, run, p = harness
    if family == "sellmeier_b1":
        glass_id = id(next(st.n2_fn for st in steps if st.action == "refract"))

        def loss(b1):
            def glass(wl_):
                return eval_dispersion("Sellmeier1", [b1] + BK7[1:], wl_)

            def sub(f):
                return glass if f is not None and id(f) == glass_id else f
            return _spot_at(run([st._replace(n1_fn=sub(st.n1_fn), n2_fn=sub(st.n2_fn))
                                 for st in steps]), 40.0)
        _fd_check(loss, BK7[0], 2e-2, 3e-2)
    elif family == "ideal_power":
        i_ideal = next(i for i, st in enumerate(steps) if st.action == "ideal")

        def loss(D):
            steps_p = list(steps)
            steps_p[i_ideal] = steps[i_ideal]._replace(D=D)
            return _spot_at(run(steps_p), 40.0)
        _fd_check(loss, 20.0, 1e-3, 3e-2)
    elif family == "detector_z":
        with torch.no_grad():
            out = run(steps)
        _fd_check(lambda z_d: _spot_at(out, z_d), 40.0, 1e-3, 2e-2)
    else:
        def loss(dx):
            x, _, wg = _last_segment_at(run(steps, p_src=p + torch.stack([dx, 0 * dx, 0 * dx])),
                                        35.0)
            return (wg * x).sum() / torch.clamp(wg.sum(), min=1e-12)
        _fd_check(loss, 0.0, 1e-2, 3e-2)


@pytest.mark.cuda
def test_kernel_route_at_changed_rho_is_bit_equal_to_plain():
    """On the card: the kernel route at rho + eps with no gradient traces
    the same sections as the plain route at rho + eps, bit for bit
    (``python3 chip_smoke.py``, phase design, holds it at 10⁶ rays); the
    route with a gradient reads the parameter tensors and agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from optrace_tpu_torch.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], no_pol=True)
    RT.add(ot.RaySource(ot.Point(), divergence="Isotropic", orientation="Converging",
                        conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                        spectrum=ot.LightSpectrum("Constant")))
    RT.add(double_gauss())
    n = 100000
    RT.rays.init(RT.ray_sources, n, len(RT.tracing_surfaces) + 2, True)
    steps = RT._build_steps()
    params = _with([st.sfns.params for st in steps], 3, rho=steps[3].sfns.params["rho"] + 1e-4)
    steps = steps_with_params(steps, params)
    rays = RT._make_source_fn(n)(ot.make_generator(1))
    outline = tuple(float(v) for v in RT.outline)
    with torch.no_grad():
        a = trace_bundle(steps, RT.n0, outline, *rays, True, False)["p"]
        ot.global_options.cuda_trace = False
        try:
            b = trace_bundle(steps, RT.n0, outline, *rays, True, False)["p"]
        finally:
            ot.global_options.cuda_trace = True
        before = trace_bundle(RT._build_steps(), RT.n0, outline, *rays, True, False)["p"]
    assert torch.equal(a, b)
    assert not torch.equal(a, before)
    # the route with a gradient reads the parameter tensors themselves
    params[3] = dict(params[3], rho=params[3]["rho"].clone().requires_grad_())
    c = trace_bundle(steps_with_params(RT._build_steps(), params), RT.n0, outline, *rays,
                     True, False)["p"]
    assert torch.allclose(a, c.detach(), rtol=0, atol=2e-5)
