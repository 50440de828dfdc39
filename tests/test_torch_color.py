"""The port's colour conversions (``color/xyz.py``, ``luv.py``, ``srgb.py``)
against the JAX package's on the same numpy inputs, f32, rtol 1e-5 (two
implementations of pow, cbrt, atan2 and tan; absolute floors where a value
passes through 0), and ``LightSpectrum``'s colour metrics.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import optrace_tpu as ot
from optrace_tpu import color as jc
import optrace_tpu_torch as otp
from optrace_tpu_torch import color as tc

RTOL = 1e-5


def _xyz(shape=(40, 50), seed=0, black=True):
    """XYZ of random linear-sRGB colours, of saturated spectral colours
    (outside the sRGB gamut) and of a few black pixels."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, shape + (3,))
    m = np.array([[0.4124564, 0.3575761, 0.1804375], [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    xyz = rgb @ m.T
    wl = rng.uniform(400, 700, shape[1])
    spec = np.stack([np.asarray(f(wl), dtype=np.float64) for f in
                     (otp.color.x_observer, otp.color.y_observer, otp.color.z_observer)], -1)
    xyz[::4] = 0.7 * xyz[::4] + 0.5 * spec[None]
    if black:
        xyz[3, :5] = 0.0
    return xyz.astype(np.float32)


def _cmp(out, ref, atol=1e-6, rtol=RTOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape, out.dtype, ref.dtype)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["xyz_to_xyY", "xyY_to_xyz", "xyz_to_luv", "luv_roundtrip", "luv_to_u_v_l",
                                "luv_chroma", "luv_saturation", "luv_hue", "srgb_to_srgb_linear",
                                "srgb_linear_to_srgb", "srgb_linear_to_xyz", "srgb_to_xyz",
                                "outside_srgb_gamut", "power_from_srgb_linear", "log_srgb"])
def test_conversions(fn):
    xyz = _xyz()
    rgb = np.random.default_rng(1).uniform(-0.2, 1.0, (30, 20, 3)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    if fn == "xyY_to_xyz":
        _cmp(tc.xyY_to_xyz(tc.xyz_to_xyY(t(xyz))), jc.xyY_to_xyz(jc.xyz_to_xyY(j(xyz))))
    elif fn == "luv_roundtrip":
        luv_t, luv_j = tc.xyz_to_luv(t(xyz), normalize=False), jc.xyz_to_luv(j(xyz), normalize=False)
        _cmp(tc.luv_to_xyz(luv_t), jc.luv_to_xyz(luv_j), atol=2e-6)
        _cmp(tc.luv_to_xyz(luv_t), xyz, atol=5e-6)
    elif fn.startswith("luv_"):
        luv_t, luv_j = tc.xyz_to_luv(t(xyz)), jc.xyz_to_luv(j(xyz))
        if fn == "luv_hue":
            # a hue is an angle of (u*, v*): near grey its two arguments are
            # differences of nearly equal numbers, compare where chroma > 1
            sel = np.asarray(jc.luv_chroma(luv_j)) > 1.0
            d = np.abs(tc.luv_hue(luv_t).numpy() - np.asarray(jc.luv_hue(luv_j)))[sel]
            assert sel.sum() > 1000 and np.minimum(d, 360 - d).max() < 2e-2
        else:
            _cmp(getattr(tc, fn)(luv_t), getattr(jc, fn)(luv_j), atol=2e-4, rtol=5e-5)
    elif fn == "xyz_to_luv":
        for norm in (True, False):
            _cmp(tc.xyz_to_luv(t(xyz), normalize=norm), jc.xyz_to_luv(j(xyz), normalize=norm),
                 atol=2e-4, rtol=5e-5)       # u*, v* are 13·L·(u − un): up to 200 with f32 u
    elif fn in ("srgb_to_srgb_linear", "srgb_linear_to_srgb", "srgb_linear_to_xyz", "srgb_to_xyz",
                "power_from_srgb_linear"):
        _cmp(getattr(tc, fn)(t(rgb)), getattr(jc, fn)(j(rgb)))
    elif fn == "log_srgb":
        img = np.clip(rgb, 0, 1)
        _cmp(tc.log_srgb(t(img)), jc.log_srgb(j(img)), atol=5e-5)
        flat = np.full((4, 4, 3), 0.5, np.float32)
        assert torch.equal(tc.log_srgb(t(flat)), t(flat))
    else:
        _cmp(getattr(tc, fn)(t(xyz)), getattr(jc, fn)(j(xyz)))


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("intent", ["Ignore", "Absolute", "Perceptual"])
def test_xyz_to_srgb(intent, normalize):
    xyz = _xyz(seed=2)
    kw = dict(normalize=normalize, rendering_intent=intent)
    _cmp(tc.xyz_to_srgb_linear(torch.from_numpy(xyz), **kw), jc.xyz_to_srgb_linear(jnp.asarray(xyz), **kw),
         atol=5e-6)
    _cmp(tc.xyz_to_srgb(torch.from_numpy(xyz), **kw), jc.xyz_to_srgb(jnp.asarray(xyz), **kw), atol=5e-5)
    out = tc.xyz_to_srgb(torch.from_numpy(xyz), **kw)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    if intent == "Perceptual":
        luv_t = tc.xyz_to_luv(torch.from_numpy(xyz), normalize=False)
        luv_j = jc.xyz_to_luv(jnp.asarray(xyz), normalize=False)
        for L_th in (0.0, 0.3):
            cs_t, cs_j = float(tc.get_chroma_scale(luv_t, L_th)), float(jc.get_chroma_scale(luv_j, L_th))
            assert 0.32 <= cs_t <= 1.0 and cs_t == pytest.approx(cs_j, rel=1e-4)
        _cmp(tc.xyz_to_srgb(torch.from_numpy(xyz), chroma_scale=0.5, L_th=0.1, **kw),
             jc.xyz_to_srgb(jnp.asarray(xyz), chroma_scale=0.5, L_th=0.1, **kw), atol=5e-5)
    with pytest.raises(ValueError):
        tc.xyz_to_srgb(torch.from_numpy(xyz), rendering_intent="Nothing")


def test_f64_host_input_stays_f64():
    xyz = _xyz().astype(np.float64)
    out = tc.xyz_to_srgb(xyz)
    assert out.dtype == torch.float64
    _cmp(out.float(), jc.xyz_to_srgb(jnp.asarray(xyz.astype(np.float32))), atol=5e-5)


@pytest.mark.parametrize("name", ["srgb_r_primary", "srgb_g_primary", "srgb_b_primary",
                                  "spectral_colormap"])
def test_primaries_and_colormap(name):
    wl = np.linspace(370.0, 790.0, 843).astype(np.float32)
    _cmp(getattr(tc, name)(torch.from_numpy(wl)), getattr(jc, name)(jnp.asarray(wl)), atol=2e-5)
    if name != "spectral_colormap":
        # the primary integrates to its sRGB chromaticity
        wl64 = tc.wavelengths(4000)
        xyz = tc.xyz_from_spectrum(wl64, getattr(tc, name)(wl64).numpy())
        xy = (xyz[:2] / xyz.sum()).numpy()
        expect = {"srgb_r_primary": tc.SRGB_R_XY, "srgb_g_primary": tc.SRGB_G_XY,
                  "srgb_b_primary": tc.SRGB_B_XY}[name]
        np.testing.assert_allclose(xy, expect, atol=2e-4)


@pytest.mark.parametrize("method", ["sum", "trapz"])
def test_xyz_from_spectrum_and_wavelengths(method):
    wl = np.linspace(380.0, 780.0, 2001).astype(np.float32)
    spec = np.exp(-0.5 * ((wl - 560.0) / 40.0) ** 2).astype(np.float32)
    ref = np.asarray(jc.xyz_from_spectrum(jnp.asarray(wl), jnp.asarray(spec), method=method))
    out = tc.xyz_from_spectrum(torch.from_numpy(wl), torch.from_numpy(spec), method=method)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5)
    assert tc.dominant_wavelength(ref) == pytest.approx(jc.dominant_wavelength(ref), abs=1e-6)
    assert tc.complementary_wavelength(ref) == pytest.approx(jc.complementary_wavelength(ref), abs=1e-6,
                                                             nan_ok=True)
    assert np.isnan(tc.dominant_wavelength([0.3, 0.1, 0.6])) == np.isnan(jc.dominant_wavelength([0.3, 0.1, 0.6]))
    assert tc.WP_D65_XY == jc.WP_D65_XY and tc.WP_D65_LUV == jc.WP_D65_LUV and tc.SRGB_G_UV == jc.SRGB_G_UV


@pytest.mark.parametrize("spec", ["d65", "led", "mono", "lines", "rect", "srgb_r", "srgb_w"])
def test_light_spectrum_colour_metrics(spec):
    def make(m):
        return {"d65": lambda: m.presets.light_spectrum.d65,
                "led": lambda: m.presets.light_spectrum.led_b1,
                "srgb_r": lambda: m.presets.light_spectrum.srgb_r,
                "srgb_w": lambda: m.presets.light_spectrum.srgb_w,
                "mono": lambda: m.LightSpectrum("Monochromatic", wl=532.0),
                "lines": lambda: m.LightSpectrum("Lines", lines=[450.0, 550.0, 650.0], line_vals=[1.0, 2.0, 0.5]),
                "rect": lambda: m.LightSpectrum("Rectangle", wl0=500.0, wl1=620.0)}[spec]()
    sj, st = make(ot), make(otp)
    np.testing.assert_allclose(st.xyz(), np.asarray(sj.xyz()), rtol=2e-5)
    for intent in ("Ignore", "Absolute"):
        np.testing.assert_allclose(st.color(rendering_intent=intent, clip=True),
                                   sj.color(rendering_intent=intent, clip=True), atol=2e-4)
    assert st.dominant_wavelength() == pytest.approx(sj.dominant_wavelength(), abs=0.05, nan_ok=True)
    assert st.complementary_wavelength() == pytest.approx(sj.complementary_wavelength(), abs=0.05, nan_ok=True)
