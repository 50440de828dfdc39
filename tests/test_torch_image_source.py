"""Image sources of the port: the pixel choice, the positions inside the
pixels and the wavelengths drawn from the pixel colours, against the JAX
package on injected uniforms; the image presets; a traced colour chart.

The JAX package's ``create_rays`` draws its uniforms inside: the test makes
the same uniforms with the JAX package's samplers on the same split keys and
injects them into the port's pure functions. Positions agree to 1e-6 of the
image's side (f32), wavelengths to rtol 1e-5.
"""

import numpy as np
import jax
import pytest
import torch

import optrace_tpu as ot
from optrace_tpu.ops import sampling as jsampling
from optrace_tpu import color as jcolor

import optrace_tpu_torch as otp
from optrace_tpu_torch import color as tcolor

N = 20000
PRESETS = ["cell", "documents", "fruits", "group_photo", "hong_kong", "interior", "landscape",
           "eye_test_vintage", "color_checker", "ETDRS_chart", "ETDRS_chart_inverted", "grid",
           "siemens_star", "tv_testcard1", "tv_testcard2"]


def _image(seed=0, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 1.0, shape + (3,)) ** 2
    data[3:9, 4:20] = 0.0           # a black block: pixels that must never emit
    return data


def _sources(data, s=(5.3, 3.7), **kw):
    kw = dict(dict(divergence="Lambertian", div_angle=5, pos=[0.5, -0.25, 2.0]), **kw)
    if data.ndim == 3:
        return (ot.RaySource(ot.RGBImage(data.copy(), list(s)), **kw),
                otp.RaySource(otp.RGBImage(data.copy(), list(s)), **kw))
    return (ot.RaySource(ot.GrayscaleImage(data.copy(), list(s)), **kw),
            otp.RaySource(otp.GrayscaleImage(data.copy(), list(s)), **kw))


@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_pixel_choice_and_positions_from_injected_uniforms(kind):
    data = _image(1) if kind == "rgb" else _image(2)[..., 0]
    sj, st = _sources(data)
    key = jax.random.PRNGKey(3)
    k_pos, k_wl, _, _, _, k_px = jax.random.split(key, 6)
    u = np.array(jsampling.stratified_interval_sampling(k_px, N, 0.0, 1.0))
    rx, ry = (np.array(a) for a in jsampling.stratified_rectangle_sampling(k_pos, N, 0.0, 1.0, 0.0, 1.0))
    pj = np.asarray(sj.create_rays(key, N)[0])

    P = st.image_pixels(torch.from_numpy(u))
    # the documented lower bound in the f32 cumulative power
    cdf = np.cumsum(st._pIf)
    cdf = (cdf / cdf[-1]).astype(np.float32)
    ref = np.clip(np.searchsorted(cdf, u, side="left"), 0, cdf.shape[0] - 1)
    assert np.array_equal(P.numpy(), ref) and P.dtype == torch.int64
    np.testing.assert_allclose(st._pIf, sj._pIf, rtol=1e-6, atol=1e-12)

    pt = st.image_positions(P, torch.from_numpy(rx), torch.from_numpy(ry)).numpy()
    np.testing.assert_allclose(pt, pj, atol=5.3e-6)
    # inside their pixel, and never in a black one
    Iy, Ix = data.shape[:2]
    xs, xe, ys, ye = st.surface.extent[:4]
    gx, gy = (pt[:, 0] - xs) / (xe - xs) * Ix, (pt[:, 1] - ys) / (ye - ys) * Iy
    PY, PX = np.divmod(P.numpy(), Ix)
    assert np.all((gx >= PX - 1e-4) & (gx <= PX + 1 + 1e-4) & (gy >= PY - 1e-4) & (gy <= PY + 1 + 1e-4))
    assert not np.any((PY >= 3) & (PY < 9) & (PX >= 4) & (PX < 20))
    assert np.all(pt[:, 2] == np.float32(2.0))
    # the choice follows the pixel power: counts against expectation
    counts = np.bincount(P.numpy(), minlength=Iy * Ix)
    assert np.abs(counts - N * st._pIf).max() <= 2.0 + 1e-2     # stratified: a cell at either end


def test_wavelengths_from_injected_choice_and_u():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    rgb[:50] = 0.0
    rgb[50:100] = [1.0, 0.0, 0.0]
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    choice = np.array(jsampling.stratified_interval_sampling(k1, N, 0.0, 1.0))
    u = np.array(jsampling.stratified_interval_sampling(k2, N, 0.0, 1.0))
    wl_j = np.asarray(jcolor.random_wavelengths_from_srgb(key, rgb))
    wl_t = tcolor.wavelengths_from_srgb(*(torch.from_numpy(a) for a in (rgb, choice, u)))
    assert wl_t.dtype == torch.float32
    # rtol 1e-5 where the inverse CDFs are not steep; in their last 0.2 % at
    # either end a primary's tail spreads 0.002 of u over tens of nm, and the
    # JAX package sums its CDF tables in f32, the port in f64: 0.1 nm there.
    # A choice within f32 rounding of a channel boundary may pick the other
    # primary (at most 2 rays).
    body = (u > 0.002) & (u < 0.998)
    close = np.where(body, np.isclose(wl_t.numpy(), wl_j, rtol=1e-5),
                     np.isclose(wl_t.numpy(), wl_j, atol=0.1))
    assert (~close).sum() <= 2, (~close).sum()
    assert wl_t.numpy().min() >= 380.0 and wl_t.numpy().max() <= 780.0
    assert np.median(wl_t.numpy()[50:100]) > 600.0     # pure red: the red primary alone


def test_random_wavelengths_from_srgb_draws_choice_then_u():
    rgb = torch.tensor([[0.2, 0.7, 0.4]]).repeat(1000, 1)
    from optrace_tpu_torch.ops import sampling as tsampling
    g = torch.Generator().manual_seed(1)
    wl = tcolor.random_wavelengths_from_srgb(g, rgb)
    g = torch.Generator().manual_seed(1)
    choice = tsampling.stratified_interval_sampling(g, 1000, 0.0, 1.0)
    u = tsampling.stratified_interval_sampling(g, 1000, 0.0, 1.0)
    assert torch.equal(wl, tcolor.wavelengths_from_srgb(rgb, choice, u))
    old = otp.global_options.wavelength_range
    # a wider wavelength range gives tables of its own; the primaries stay
    # inside the visible band
    otp.global_options.wavelength_range = [350.0, 900.0]
    try:
        wide = tcolor.wavelengths_from_srgb(rgb, choice, u)
    finally:
        otp.global_options.wavelength_range = old
    assert 380.0 <= float(wide.min()) and float(wide.max()) <= 780.0
    assert float((wide - wl).abs().max()) < 0.5


@pytest.mark.parametrize("name", PRESETS)
def test_image_presets_equal(name):
    a = getattr(ot.presets.image, name)([3.0, 2.0])
    b = getattr(otp.presets.image, name)([3.0, 2.0])
    assert type(a).__name__ == type(b).__name__ and a.desc == b.desc
    assert np.array_equal(np.asarray(a.data), b.data)
    assert np.array_equal(np.asarray(a.extent), b.extent)


def test_presets_are_all_there():
    names = [n for n in dir(ot.presets.image) if not n.startswith("_")
             and callable(getattr(ot.presets.image, n)) and n not in ("RGBImage", "GrayscaleImage")]
    assert sorted(names) == sorted(PRESETS)
    assert all(hasattr(otp.presets.image, n) for n in names)


def test_one_pixel_image_limits_and_colour():
    one = np.full((1, 1, 3), 0.5)
    sj, st = _sources(one, s=(2.0, 1.0))
    p = st.create_rays(torch.Generator().manual_seed(0), 2000)[0].numpy()
    assert np.all(np.abs(p[:, 0] - 0.5) <= 1.0) and np.all(np.abs(p[:, 1] + 0.25) <= 0.5)
    assert p[:, 0].std() == pytest.approx(2.0 / np.sqrt(12), rel=0.05)
    np.testing.assert_allclose(st.color(), sj.color(), atol=1e-6)
    np.testing.assert_allclose(st.color(), (0.5, 0.5, 0.5), atol=1e-6)
    gj, gt = _sources(_image(5)[..., 0])
    assert gt.color() == pytest.approx(gj.color(), abs=1e-4)       # the spectrum's colour
    cj, ct = _sources(_image(6))
    np.testing.assert_allclose(ct.color(), cj.color(), atol=1e-6)
    old = otp.RaySource._max_image_px
    otp.RaySource._max_image_px = 100
    try:
        with pytest.raises(RuntimeError, match="pixels"):
            _sources(_image(7))
    finally:
        otp.RaySource._max_image_px = old
    with pytest.raises(TypeError):
        otp.RaySource(object())


def test_create_rays_of_an_image_source():
    """The whole of ``create_rays``: shapes, types, weights, a grayscale
    image takes its wavelengths from the spectrum."""
    _, st = _sources(_image(8), power=2.0)
    p, s, pols, w, wl = st.create_rays(torch.Generator().manual_seed(2), N)
    assert p.shape == s.shape == pols.shape == (N, 3) and w.shape == wl.shape == (N,)
    assert all(t.dtype == torch.float32 for t in (p, s, pols, w, wl))
    assert float(w.sum()) == pytest.approx(2.0, rel=1e-5)
    assert 380.0 <= float(wl.min()) and float(wl.max()) <= 780.0
    gt = otp.RaySource(otp.GrayscaleImage(_image(8)[..., 0], [5.3, 3.7]), pos=[0, 0, 0],
                       spectrum=otp.LightSpectrum("Monochromatic", wl=600.0))
    assert torch.all(gt.create_rays(torch.Generator().manual_seed(2), 100)[4] == 600.0)


def test_source_image_reproduces_a_colour_chart():
    """A 4 × 6 colour checker as a source: the rendered source image gives
    every patch its linear sRGB colour back. Of 20 000 rays the white
    patch gets about 2000, some 700 a primary: one standard deviation of
    that count is 0.034 of its value 0.9, so 0.1 is three of them; over all
    72 channel values the correlation is above 0.99."""
    chart = otp.presets.image.color_checker([6.0, 4.0]).data
    H, W = chart.shape[:2]
    small = chart[H // 8::H // 4, W // 12::W // 6][:4, :6].copy()
    assert small.shape == (4, 6, 3) and len(np.unique(small.reshape(-1, 3), axis=0)) == 24
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -1, 10], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.RGBImage(small, [6.0, 4.0]), divergence="None", pos=[0, 0, 0]))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[8, 6]), pos=[0, 0, 5]))
    with otp.global_options.no_progress_bar(), otp.global_options.no_warnings():
        RT.trace(N)
        img = RT.source_image()
    assert img.power() == pytest.approx(1.0, rel=1e-5)
    assert np.allclose(img.extent, [-3.0, 3.0, -2.0, 2.0]) and img.shape == (945, 945, 4)
    xyz = img.data[:, :, :3]
    ny, nx = xyz.shape[0] // 4, xyz.shape[1] // 6
    patches = xyz[:4 * ny, :6 * nx].reshape(4, ny, 6, nx, 3).sum(axis=(1, 3))
    lin = tcolor.xyz_to_srgb_linear(torch.from_numpy(patches), rendering_intent="Ignore").numpy()
    want = tcolor.srgb_to_srgb_linear(small).numpy()
    scale = (want * lin).sum() / (lin * lin).sum()
    assert np.abs(lin * scale - want).max() < 0.1, np.abs(lin * scale - want).max()
    assert np.corrcoef(lin.ravel(), want.ravel())[0, 1] > 0.99
    # the detector sees the same chart: no optics between
    det = RT.detector_image(extent=[-3.0, 3.0, -2.0, 2.0])
    assert np.abs(det.data - img.data).max() <= 1e-6 * img.data.max()
