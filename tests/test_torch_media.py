"""Media, spectra, observers and illuminants of the port against the JAX
package on a wavelength grid: every ``RefractionIndex`` model, the CIE
observers and the standard illuminants. f32 device evaluation on both sides,
rtol 1e-6 (a few ulp: the power and division roundings differ); the host
(numpy f64) paths must agree to rtol 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp

WL = np.linspace(380.0, 780.0, 801).astype(np.float32)

# one set of coefficients per dispersion model, shaped like a real glass
MODELS = {
    "Cauchy": [1.5, 0.004, 1e-5, 1e-7],
    "Conrady": [1.5, 0.01, 0.001],
    "Sellmeier1": [1.03961212, 0.00600069867, 0.231792344, 0.0200179144, 1.01046945, 103.560653],
    "Sellmeier2": [1.2, 0.5, 0.1, 0.01, 0.12],
    "Sellmeier3": [1.0, 0.006, 0.2, 0.02, 1.0, 100.0, 0.05, 0.01],
    "Sellmeier4": [2.2, 0.6, 0.02, 1.0, 100.0],
    "Sellmeier5": [1.0, 0.006, 0.2, 0.02, 1.0, 100.0, 0.05, 0.01, 0.01, 0.03],
    "Herzberger": [1.5, 0.004, 1e-4, -1e-3, 1e-5, -1e-6],
    "Schott": [2.25, -0.01, 0.012, 3e-4, -1e-5, 1e-6],
    "Extended": [2.25, -0.01, 0.012, 3e-4, -1e-5, 1e-6, 1e-8, 1e-9],
    "Extended2": [2.25, -0.01, 0.012, 3e-4, -1e-5, 1e-6, 1e-4, 1e-5],
    "Extended3": [2.25, -0.01, 1e-4, 0.012, 3e-4, -1e-5, 1e-5, 1e-6, 1e-8],
    "Handbook of Optics 1": [2.2, 0.01, 0.02, 0.01],
    "Handbook of Optics 2": [2.2, 0.5, 0.02, 0.01],
}


def _both(make_j, make_t):
    nj = np.asarray(make_j(jnp.asarray(WL)))
    out = make_t(torch.from_numpy(WL))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    return out.numpy(), nj


@pytest.mark.parametrize("model", sorted(MODELS))
def test_dispersion_models(model):
    rj = ot.RefractionIndex(model, coeff=MODELS[model])
    rt = otp.RefractionIndex(model, coeff=MODELS[model])
    nt, nj = _both(rj, rt)
    assert nj.min() >= 1.0 and np.ptp(nj) > 1e-4
    np.testing.assert_allclose(nt, nj, rtol=1e-6)
    wl64 = WL.astype(np.float64)
    np.testing.assert_allclose(rt(wl64), rj(wl64), rtol=1e-12)
    assert rt.abbe_number() == pytest.approx(rj.abbe_number(), rel=1e-9)


@pytest.mark.parametrize("kind", ["Abbe", "Constant", "Data", "Function"])
def test_other_index_types(kind):
    kw = {"Abbe": dict(n=1.797, V=45.3), "Constant": dict(n=1.33),
          "Data": dict(wls=np.linspace(380, 780, 41), vals=1.5 + 0.02 * np.cos(np.linspace(0, 2, 41))),
          "Function": dict(func=lambda wl: 1.4 + 30.0 / wl)}[kind]
    rj, rt = ot.RefractionIndex(kind, **kw), otp.RefractionIndex(kind, **kw)
    nt, nj = _both(rj, rt)
    if kind == "Data":
        # exactly on the last grid point the JAX package's uniform_interp
        # returns the value of the point before (its fraction comes from the
        # unclamped cell index); the port returns the last table value
        assert nt[-1] == np.float32(kw["vals"][-1]) and nj[-1] != nt[-1]
        nt, nj = nt[:-1], nj[:-1]
    np.testing.assert_allclose(nt, nj, rtol=1e-6)
    wl64 = WL.astype(np.float64)
    # the JAX package rounds a user function's host values to f32, the port keeps f64
    np.testing.assert_allclose(np.asarray(rt(wl64)), np.asarray(rj(wl64)),
                               rtol=1e-7 if kind == "Function" else 1e-12)


def test_preset_glasses_and_equality():
    for name in ("BK7", "F2", "SF10", "air", "vacuum"):
        gj = getattr(ot.presets.refraction_index, name)
        gt = getattr(otp.presets.refraction_index, name)
        nt, nj = _both(gj, gt)
        np.testing.assert_allclose(nt, nj, rtol=1e-6)
    a = otp.RefractionIndex("Abbe", n=1.6, V=40.0)
    assert a == otp.RefractionIndex("Abbe", n=1.6, V=40.0) and a != otp.RefractionIndex("Constant", n=1.6)
    with pytest.raises(RuntimeError):
        otp.RefractionIndex("Cauchy", coeff=[0.9, 0.0, 0.0, 0.0])(np.array([500.0]))


@pytest.mark.parametrize("name", ["x_observer", "y_observer", "z_observer"])
def test_observers(name):
    wl = np.concatenate([WL, np.float32([300.0, 359.9, 360.0, 830.0, 830.1, 900.0])])
    vj = np.asarray(getattr(ot.color, name)(jnp.asarray(wl)))
    vt = getattr(otp.color, name)(torch.from_numpy(wl)).numpy()
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-9)
    assert vt[-1] == 0.0 and vt[-6] == 0.0 and vt.max() > 0.9
    np.testing.assert_allclose(getattr(otp.color, name)(wl.astype(np.float64)),
                               getattr(ot.color, name)(wl.astype(np.float64)), rtol=1e-12)


@pytest.mark.parametrize("name", ot.color.ILLUMINANT_NAMES + ["E"])
def test_illuminants(name):
    vj = np.asarray(ot.color.illuminant(name, jnp.asarray(WL)))
    vt = otp.color.illuminant(name, torch.from_numpy(WL)).numpy()
    # jnp.interp uses the slope form, the port the weighted form of the same
    # linear interpolation: a few f32 ulp of values up to 250
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)
    wl64 = WL.astype(np.float64)
    np.testing.assert_allclose(otp.color.illuminant(name, wl64), ot.color.illuminant(name, wl64),
                               rtol=1e-12)


@pytest.mark.parametrize("kind,kw", [
    ("Constant", {}), ("Rectangle", dict(wl0=450.0, wl1=600.0)), ("Gaussian", dict(mu=550.0, sig=30.0)),
    ("Blackbody", dict(T=5000.0)), ("Data", dict(wls=np.linspace(400, 700, 31),
                                                 vals=np.linspace(0.1, 1.0, 31))),
    ("Function", dict(func=lambda wl: 1.0 + 0.001 * wl)),
])
def test_light_spectrum_values(kind, kw):
    sj, st = ot.LightSpectrum(kind, **kw), otp.LightSpectrum(kind, **kw)
    vt, vj = _both(sj, st)
    if kind == "Data":      # the last grid point: see test_other_index_types
        inner = WL < kw["wls"][-1]
        assert vt[~inner][0] == np.float32(kw["vals"][-1])
        vt, vj = vt[inner], vj[inner]
    np.testing.assert_allclose(vt, vj, rtol=2e-6, atol=1e-7)
    assert st.power() == pytest.approx(sj.power(), rel=1e-6)
    # the JAX package evaluates the Planck curve in f32 even on host data: its
    # argmax over a flat peak moves by a few grid steps of 0.004 nm
    assert st.peak_wavelength() == pytest.approx(sj.peak_wavelength(), abs=0.05)


def test_d65_preset_and_lines():
    np.testing.assert_allclose(otp.presets.light_spectrum.d65(WL.astype(np.float64)),
                               ot.presets.light_spectrum.d65(WL.astype(np.float64)), rtol=1e-12)
    assert otp.presets.light_spectrum.FdC.lines.tolist() == ot.presets.light_spectrum.FdC.lines.tolist()
    assert otp.presets.spectral_lines.FdC == ot.presets.spectral_lines.FdC
