"""The design render (tracer/diff.py) over scenes that the fused render
also traces: a lens with a data-surface front, and an aperture that bends
rays by HURB with a changed ``Raytracer.HURB_FACTOR``.

- Loss: with hard binning, the design render of a seed draws the same rays
  as the fused render of a generator with that seed, so both images and
  their spot radii agree to 1e-6 of the image's maximum (the two detector
  searches round differently).
- Gradient: d(spot radius)/d(z position of the generic front surface) by
  autograd through the bracketed hit solve and the normals (the spline's
  derivatives of a data surface, ``torch.func.jvp`` of a function surface),
  against a central difference, within 3e-2 (``FD_RTOL`` of
  chip_smoke.py). The position is the generic surface's design parameter,
  as in the JAX package; its spline or function stays in the closure.
- HURB: the design render passes the raytracer's factor, as the fused
  render and ``trace`` do (the JAX design render does not: ROADMAP.md), so
  it is not the oracle here.
"""

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss, spot_radius

from test_torch_common import generic_scene

FD_RTOL = 3e-2
N = 4000
EXT = (-4.0, 4.0, -4.0, 4.0)
NX = 48


def _hurb_scene(factor):
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, use_hurb=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550)))
    RT.add(otp.Aperture(otp.RingSurface(r=3, ri=0.05), pos=[0, 0, 0]))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 20]))
    RT.HURB_FACTOR = factor
    return RT


def _design_and_fused(RT, ext, nx, seed=3):
    render, params0 = make_parameterized_render(RT, N, extent=list(ext), Nx=nx, Ny=nx,
                                                soft_bin=False)
    fused, _ = otp.make_fused_render(RT, N, extent=list(ext), Nx=nx, Ny=nx, device="cpu")
    with torch.no_grad():
        return render(params0, seed), fused(otp.make_generator(seed, "cpu"))


def test_design_loss_equals_the_fused_render_on_a_data_surface():
    RT = generic_scene("data_lens", otp, torch)
    img_d, img_f = _design_and_fused(RT, EXT, NX)
    assert float(img_f[..., 3].sum()) > 0.5
    tol = 1e-6 * float(img_f.abs().max())
    assert float((img_d - img_f).abs().max()) <= tol
    assert float(spot_radius(img_d, EXT)) == pytest.approx(float(spot_radius(img_f, EXT)), rel=1e-6)


@pytest.mark.parametrize("scene", ["data_lens", "function_lens"])
def test_design_gradient_wrt_the_generic_surface_position(scene):
    """Through the spline's derivative normals (data surface) and through
    the jvp normals (function surface without ``deriv_func``)."""
    RT = generic_scene(scene, otp, torch)
    render, params0 = make_parameterized_render(RT, N, extent=list(EXT), Nx=NX, Ny=NX)
    loss = spot_loss(render)
    pos0 = params0[0]["pos"].detach().clone()

    def at(dz, grad=False):
        pos = (pos0 + torch.tensor([0.0, 0.0, dz])).requires_grad_(grad)
        params = [dict(p) for p in params0]
        params[0] = dict(params[0], pos=pos)
        return loss(params, 5, EXT), pos

    val, pos = at(0.0, grad=True)
    val.backward()
    g = float(pos.grad[2])
    h = 0.02
    with torch.no_grad():
        fd = (float(at(h)[0]) - float(at(-h)[0])) / (2 * h)
    assert abs(fd) > 1e-3, fd
    assert g == pytest.approx(fd, rel=FD_RTOL), (g, fd)


def test_design_render_passes_the_hurb_factor():
    """Under use_hurb with a changed HURB_FACTOR the design render equals
    the fused render on the same rays, and differs from the design render
    at the default factor."""
    ext = (-2.0, 2.0, -2.0, 2.0)
    RT = _hurb_scene(4.0)
    img_d, img_f = _design_and_fused(RT, ext, 32)
    assert float((img_d - img_f).abs().max()) <= 1e-6 * float(img_f.abs().max())
    img_default, _ = _design_and_fused(_hurb_scene(float(np.sqrt(2.0))), ext, 32)
    assert float((img_d - img_default).abs().max()) > 1e-3 * float(img_f.abs().max())


def test_pixel_jvp_image_through_a_function_surface():
    """A per-pixel forward-mode jvp image (``fwAD.dual_level``) of the design
    render, d(img)/d(z of the function-surface front without ``deriv_func``):
    the numeric normals take their partials in reverse mode inside the
    forward level. The image equals the central-difference image within 2 %
    of its scale (tests/test_torch_diff_families.py), and its sum equals the
    reverse-mode gradient of the summed image."""
    import torch.autograd.forward_ad as fwAD

    RT = generic_scene("function_lens", otp, torch)
    render, params0 = make_parameterized_render(RT, N, extent=list(EXT), Nx=16, Ny=16)
    pos0 = params0[0]["pos"].detach().clone()

    def img_of(dz):
        params = [dict(p) for p in params0]
        params[0] = dict(params[0], pos=pos0 + torch.stack([0 * dz, 0 * dz, dz]))
        return render(params, 5)[:, :, 3]

    with fwAD.dual_level():
        dimg = fwAD.unpack_dual(img_of(fwAD.make_dual(torch.tensor(0.0), torch.tensor(1.0)))).tangent
    h = 0.02
    with torch.no_grad():
        fd = (img_of(torch.tensor(h)) - img_of(torch.tensor(-h))) / (2 * h)
        img_max = float(img_of(torch.tensor(0.0)).max())
    dz = torch.tensor(0.0, requires_grad=True)
    img_of(dz).sum().backward()
    dimg, fd = dimg.detach().numpy(), fd.numpy()
    assert np.isfinite(dimg).all()
    scale = np.abs(dimg).max()
    assert scale > 1e-3 * img_max, "image insensitive to the surface position?"
    np.testing.assert_allclose(dimg, fd, atol=0.02 * scale)
    assert float(dimg.sum()) == pytest.approx(float(dz.grad), rel=1e-4, abs=1e-4 * scale)
