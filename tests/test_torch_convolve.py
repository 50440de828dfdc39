"""PSF convolution of the port against the JAX package on identical images
and PSFs: the four colour cases, the padding modes, m < 0, keep_size and
the error cases; and the port's area resize against OpenCV's INTER_AREA.

The JAX package converts colours and convolves in f32 (its FFT is XLA's),
the port in f64, so outputs agree to 2e-5 of the [0, 1] sRGB range; the
extents are the same f64 arithmetic and agree to 1e-12 mm.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import optrace_tpu as ot
from optrace_tpu.analysis import convolve as jconvolve

import optrace_tpu_torch as otp
from optrace_tpu_torch.analysis.convolve import convolve as tconvolve, area_resize

TOL = 2e-5


def _pair(make):
    return make(ot), make(otp)


def _gray(pkg, n=64, s=(2, 2), seed=None):
    if seed is None:
        a = np.zeros((n, n))
        a[n // 2 - 4:n // 2 + 4, n // 2 - 4:n // 2 + 4] = 1.0
    else:
        a = np.random.default_rng(seed).uniform(0, 1, (n, n))
    return pkg.GrayscaleImage(a, s=list(s))


def _rgb(pkg, shape=(64, 80), s=(2, 2.5), seed=3):
    return pkg.RGBImage(np.random.default_rng(seed).uniform(0, 1, (*shape, 3)), s=list(s))


def _color_psf(pkg, seed=1, extent=0.01, n=5000):
    ri = pkg.RenderImage(extent=[-extent, extent, -extent, extent])
    rng = np.random.default_rng(seed)
    p = np.column_stack([rng.normal(0, extent / 5, (n, 2)), np.zeros(n)])
    wl = rng.uniform(450, 650, n).astype(np.float32)
    w = np.full(n, 1e-3, dtype=np.float32)
    ri.render(p, w, wl, **(dict(device="cpu") if pkg is otp else {}))
    return ri


def _both(img_make, psf_make, **kw):
    img_j, img_t = _pair(img_make)
    psf_j, psf_t = _pair(psf_make)
    with ot.global_options.no_warnings(), otp.global_options.no_warnings(), \
            ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        out_j = jconvolve(img_j, psf_j, **kw)
        out_t = tconvolve(img_t, psf_t, device="cpu", **kw)
    return out_j, out_t


def _equal(out_j, out_t):
    assert type(out_t).__name__ == type(out_j).__name__
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.extent, out_j.extent, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out_t.data, out_j.data, rtol=0, atol=TOL)


CASES = {
    "gray_gray": (_gray, lambda pkg: pkg.presets.psf.gaussian(sig=2.0)),
    "gray_gray_noise": (lambda pkg: _gray(pkg, n=101, seed=4), lambda pkg: pkg.presets.psf.airy(r=2.0)),
    "gray_colorpsf": (lambda pkg: _gray(pkg, n=101), _color_psf),
    "rgb_gray": (_rgb, lambda pkg: pkg.presets.psf.halo()),
    "rgb_three_psfs": (_rgb, lambda pkg: [_color_psf(pkg, 1), _color_psf(pkg, 2), _color_psf(pkg, 3)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kw", [dict(), dict(m=-1), dict(m=1.5, keep_size=True)],
                         ids=["m1", "flip", "m1.5_keep"])
def test_four_colour_cases_equal_jax(case, kw):
    _equal(*_both(*CASES[case], **kw))


@pytest.mark.parametrize("mode,value", [("constant", 0.6), ("edge", None), ("reflect", None),
                                        ("symmetric", None), ("wrap", None)])
@pytest.mark.parametrize("colour", ["gray", "rgb"])
def test_padding_modes_equal_jax(mode, value, colour):
    if colour == "rgb":
        value = [value, 0.1, 0.3] if value is not None else None
        img = _rgb
    else:
        img = _gray
    _equal(*_both(img, lambda pkg: pkg.presets.psf.gaussian(sig=40.0), keep_size=True,
                  padding_mode=mode, padding_value=value))


def test_cargs_and_zero_inputs_equal_jax():
    _equal(*_both(lambda pkg: _gray(pkg, seed=5), lambda pkg: pkg.presets.psf.glare(),
                  cargs={"normalize": False}))
    # the perceptual intent's chroma scale with a lightness threshold: the
    # FFT leaves 1e-16 in black pixels (f64) where the JAX package's leaves
    # other noise (f32), and the hue of noise must not choose the scale
    _equal(*_both(_rgb, lambda pkg: pkg.presets.psf.circle(d=30.0),
                  cargs={"rendering_intent": "Perceptual", "L_th": 0.1}))
    _equal(*_both(lambda pkg: pkg.GrayscaleImage(np.zeros((64, 64)), s=[2, 2]),
                  lambda pkg: pkg.presets.psf.gaussian(sig=0.5)))
    out_j, out_t = _both(_gray, lambda pkg: pkg.GrayscaleImage(np.zeros((64, 64)), s=[0.2, 0.2]))
    _equal(out_j, out_t)
    assert out_t.data.max() == 0


def test_errors_equal_jax():
    """Every refusal of the JAX package is a refusal of the port, with the
    same exception type."""
    cases = [
        (lambda pkg: (_gray(pkg), pkg.presets.psf.gaussian(0.5)), dict(m=0)),
        (lambda pkg: (_gray(pkg), pkg.presets.psf.gaussian(sig=2000.0)), {}),
        (lambda pkg: (_gray(pkg), [1, 2, 3]), {}),
        (lambda pkg: (_gray(pkg), [_color_psf(pkg)] * 3), {}),
        (lambda pkg: (_rgb(pkg), _color_psf(pkg)), {}),
        (lambda pkg: (_rgb(pkg), [_color_psf(pkg, 1), _color_psf(pkg, 2, extent=0.02),
                                  _color_psf(pkg, 3)]), {}),
        (lambda pkg: (_rgb(pkg), pkg.presets.psf.gaussian(0.5)), dict(padding_value=2)),
        (lambda pkg: (_gray(pkg), pkg.presets.psf.gaussian(0.5)), dict(padding_value=[1, 2])),
        (lambda pkg: (_rgb(pkg), pkg.presets.psf.gaussian(0.5)), dict(padding_value=[0, 0])),
        (lambda pkg: (_rgb(pkg), pkg.presets.psf.gaussian(0.5)), dict(padding_value=[0, 0, -1])),
        (lambda pkg: (_gray(pkg), pkg.presets.psf.gaussian(0.5)), dict(padding_value=-2)),
        (lambda pkg: (_gray(pkg), pkg.GrayscaleImage(np.ones((30, 30)), s=[0.1, 0.1])), {}),
        (lambda pkg: (pkg.GrayscaleImage(np.ones((30, 30)), s=[2, 2]),
                      pkg.presets.psf.gaussian(0.5)), {}),
        (lambda pkg: (_gray(pkg), pkg.presets.psf.gaussian(0.5)), dict(keep_size=1)),
    ]
    for make, kw in cases:
        with ot.global_options.no_warnings(), otp.global_options.no_warnings(), \
                ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
            with pytest.raises(Exception) as e_j:
                jconvolve(*make(ot), **kw)
            with pytest.raises(type(e_j.value)):
                tconvolve(*make(otp), device="cpu", **kw)


@pytest.mark.parametrize("src,dst", [((101, 87), (40, 33)), ((64, 64), (32, 32)),
                                     ((401, 401), (37, 37)), ((50, 60), (80, 100)),
                                     ((50, 60), (40, 90)), ((77, 77), (77, 77)),
                                     ((801, 801), (13, 801))])
@pytest.mark.parametrize("channels", [0, 3])
def test_area_resize_equals_cv2(src, dst, channels):
    """The area-weighted resize against cv2.resize(INTER_AREA) in f64:
    shrinking by integer and fractional factors, growing, and one axis of
    each; equal to 1e-13 (OpenCV keeps its weights in f32, as the port
    does)."""
    shape = src if not channels else (*src, channels)
    a = np.random.default_rng(sum(src) + channels).uniform(0, 1, shape)
    ref = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = area_resize(torch.from_numpy(a), dst[1], dst[0]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
