"""``TransmissionSpectrum`` and ``LightSpectrum.render`` of the port against
the JAX package on the same inputs.

Values at wavelengths made with numpy from a seed agree to rtol 1e-6 (f32 on
both sides for tensors, f64 on the host); ``xyz`` and ``color`` to 1e-4 (the
JAX package integrates in f32). The rendered histogram is held to the JAX
package's ``np.histogram`` to 1e-9 of its maximum on f64 inputs: the same
f64 sums over the same f64 edges. On f32 inputs ``np.histogram`` rounds its
edges to f32, the port keeps f64 edges: the edges then agree to 1e-6 and a
ray within that of an edge may change its bin (at most 3 rays a bin here).
"""

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp

WL = np.random.default_rng(3).uniform(380.0, 780.0, 2000)
_wls = np.linspace(400.0, 700.0, 31)
_vals = 0.5 + 0.4 * np.sin(_wls / 40.0)
CASES = {
    "Constant": dict(val=0.7),
    "Data": dict(wls=_wls, vals=_vals),
    "Rectangle": dict(wl0=450.0, wl1=600.0, val=0.8),
    "Gaussian": dict(mu=550.0, sig=40.0, val=0.9),
    "Function": dict(func=lambda wl: 0.5 + 0.0005 * (wl - 380.0)),
}


def _pair(st, **kw):
    args = dict(CASES[st], **kw)
    if st == "Function":    # each package calls the function with its own array type
        args_j = dict(args, func=lambda wl: 0.5 + 0.0005 * (np.asarray(wl) - 380.0))
        return ot.TransmissionSpectrum(st, **args_j), otp.TransmissionSpectrum(st, **args)
    return ot.TransmissionSpectrum(st, **args), otp.TransmissionSpectrum(st, **args)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("st", sorted(CASES))
def test_values_host_and_tensor(st, inverse):
    sj, st_ = _pair(st, inverse=inverse)
    ref = np.asarray(sj(WL), dtype=np.float64)
    host = st_(WL)
    assert isinstance(host, np.ndarray)
    np.testing.assert_allclose(host, ref, rtol=1e-6, atol=1e-7)
    ten = st_(torch.from_numpy(WL.astype(np.float32)))
    assert isinstance(ten, torch.Tensor) and ten.dtype == torch.float32 and ten.device.type == "cpu"
    np.testing.assert_allclose(ten.numpy(), np.asarray(sj(WL.astype(np.float32))), rtol=2e-6, atol=2e-7)
    assert float(ten.min()) >= 0.0 and float(ten.max()) <= 1.0
    assert st_.inverse is inverse and st_.quantity == "Transmission T" == sj.quantity and st_.unit == ""


@pytest.mark.parametrize("st", sorted(CASES))
def test_xyz_and_color(st):
    sj, st_ = _pair(st)
    np.testing.assert_allclose(st_.xyz(), np.asarray(sj.xyz()), rtol=1e-4)
    cj, ct = sj.color(), st_.color()
    assert len(ct) == 4 and all(isinstance(v, float) for v in ct)
    np.testing.assert_allclose(ct, cj, atol=1e-4)
    np.testing.assert_allclose(st_.color("Perceptual", clip=False, L_th=0.1, chroma_scale=0.8),
                               sj.color("Perceptual", clip=False, L_th=0.1, chroma_scale=0.8), atol=1e-4)


def test_filter_element_passes_through():
    sj, st_ = _pair("Gaussian")
    fj = ot.Filter(ot.CircularSurface(r=2), pos=[0, 0, 1], spectrum=sj)
    ft = otp.Filter(otp.CircularSurface(r=2), pos=[0, 0, 1], spectrum=st_)
    np.testing.assert_allclose(ft(WL), np.asarray(fj(WL)), rtol=1e-6)
    np.testing.assert_allclose(ft.color(), fj.color(), atol=1e-4)
    assert ft.abbr == "F" == fj.abbr and not ft.has_back()
    with pytest.raises(TypeError):
        otp.Filter(otp.CircularSurface(r=2), pos=[0, 0, 1], spectrum=otp.LightSpectrum("Constant"))
    with pytest.raises(TypeError):
        ft.spectrum = 0.5


@pytest.mark.parametrize("case", ["type", "val_above", "vals_above", "inverse_type", "func_above",
                                  "val_negative", "lines_type"])
def test_validation_errors(case):
    """Every check of ``TransmissionSpectrum.__setattr__`` and the type
    restriction, with the JAX package raising the same exception."""
    calls = {
        "type": (ValueError, lambda m: m.TransmissionSpectrum("Monochromatic")),
        "val_above": (ValueError, lambda m: m.TransmissionSpectrum("Constant", val=1.2)),
        "vals_above": (ValueError, lambda m: m.TransmissionSpectrum("Data", wls=_wls, vals=_vals + 1.0)),
        "inverse_type": (TypeError, lambda m: m.TransmissionSpectrum("Constant", inverse=1)),
        "func_above": (RuntimeError, lambda m: m.TransmissionSpectrum(
            "Function", func=lambda wl: 0.9 + 0.001 * (np.asarray(wl) - 380.0))),
        "val_negative": (ValueError, lambda m: m.TransmissionSpectrum("Constant", val=-0.1)),
        "lines_type": (ValueError, lambda m: m.TransmissionSpectrum("Lines", lines=[500.0], line_vals=[1.0])),
    }
    exc, call = calls[case]
    for m in (ot, otp):
        with pytest.raises(exc):
            call(m)


def _render_pair(wl, w, **kw):
    return ot.LightSpectrum.render(wl, w, **kw), otp.LightSpectrum.render(wl, w, **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [300, 20000])
def test_light_spectrum_render_parity(n, dtype):
    rng = np.random.default_rng(n)
    wl = rng.uniform(420.0, 700.0, n).astype(np.float32).astype(dtype)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32).astype(dtype)
    w[::7] = 0.0
    f64 = dtype == np.float64
    sj, st_ = _render_pair(wl, w, long_desc="abc")
    assert st_.spectrum_type == "Histogram" and st_.long_desc == "abc"
    assert st_._wls.dtype == np.float64 and st_._vals.dtype == np.float64
    assert st_._vals.shape == np.asarray(sj._vals).shape and len(st_._vals) % 2 == 1
    np.testing.assert_allclose(st_._wls, np.asarray(sj._wls), rtol=1e-12 if f64 else 1e-6)
    dw = st_._wls[1] - st_._wls[0]
    tol = 1e-9 * np.asarray(sj._vals).max() if f64 else 3 * float(w.max()) / dw
    assert np.abs(st_._vals - np.asarray(sj._vals)).max() <= tol
    assert st_.power() == pytest.approx(float(w.astype(np.float64).sum()), rel=1e-9)
    assert st_.power() == pytest.approx(sj.power(), rel=1e-6)
    # tensors in: the same spectrum
    s2 = otp.LightSpectrum.render(torch.from_numpy(wl), torch.from_numpy(w))
    assert np.array_equal(s2._vals, st_._vals) and np.array_equal(s2._wls, st_._wls)
    # and it evaluates like the JAX one
    q = np.linspace(430.0, 690.0, 50)
    if f64:     # the JAX package holds the histogram's values in f32 when it evaluates
        np.testing.assert_allclose(st_(q), np.asarray(sj(q)), rtol=1e-6, atol=1e-12)


def test_light_spectrum_render_one_wavelength_and_empty():
    wl = np.full(100, 550.0, dtype=np.float32)
    w = np.full(100, 0.01, dtype=np.float32)
    sj, st_ = _render_pair(wl, w)
    np.testing.assert_allclose(st_._wls, np.asarray(sj._wls), rtol=1e-6)
    assert st_._wls[0] == 549.0 and st_._wls[-1] == 551.0 and len(st_._vals) == 51
    # the JAX package divides by a bin width taken from f32 edges: 2/51 nm
    # at 550 nm carries an f32 rounding of 6e-5 nm, 1.5e-3 of the width
    np.testing.assert_allclose(st_._vals, np.asarray(sj._vals), rtol=2e-3)
    assert st_.power() == pytest.approx(1.0, rel=1e-6)
    # at the edge of the visible range the widened interval is clipped
    lo = otp.global_options.wavelength_range[0]
    s_edge = otp.LightSpectrum.render(np.full(10, lo, dtype=np.float32), w[:10])
    assert s_edge._wls[0] == lo and s_edge._wls[-1] == lo + 1
    ej, et = _render_pair(np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.float32))
    assert np.array_equal(et._vals, np.asarray(ej._vals)) and not et._vals.any()
    np.testing.assert_allclose(et._wls, np.asarray(ej._wls))
    assert len(et._wls) == len(et._vals) + 1 == 52
