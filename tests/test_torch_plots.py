"""The port's plots (optrace_tpu_torch.plots) render every figure of
tests/test_plots.py to a file headlessly, and hand matplotlib the same
arrays as the JAX package's plots on the same inputs: every call of
``plot``, ``scatter``, ``imshow``, ``axvline`` and ``annotate`` is recorded
in both, and the recorded arrays are compared (rtol 1e-5, atol 5e-6: the
JAX package's colour conversions run in f32, the port's in f64, on values
in [0, 1]), not the pixels. ``surface_profile_plot`` also draws function
and data surfaces, ``focus_search_cost_plot`` the port's own focus search.
"""

import os

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest
import scipy.optimize
import jax.numpy as jnp
import torch

import optrace_tpu as ot
from optrace_tpu import plots as jplots
import optrace_tpu_torch as otp
from optrace_tpu_torch import plots as tplots

from test_torch_common import data_sphere

RECORDED = ("plot", "scatter", "imshow", "axvline", "annotate", "title", "xlabel", "ylabel")


@pytest.fixture
def record(monkeypatch):
    """Record the arguments of the drawing calls made through pyplot."""
    calls = []
    for name in RECORDED:
        real = getattr(plt, name)

        def wrapper(*args, _name=name, _real=real, **kw):
            calls.append((_name, args, {k: v for k, v in kw.items()
                                        if k in ("extent", "vmin", "vmax", "label", "origin")}))
            return _real(*args, **kw)
        monkeypatch.setattr(plt, name, wrapper)
    return calls


def _same(a, b, what):
    if isinstance(a, (str, type(None), bool)):
        assert a == b, what
    elif isinstance(a, (tuple, list)) and a and isinstance(a[0], str):
        assert list(a) == list(b), what
    else:
        a64, b64 = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        assert a64.shape == b64.shape, what
        np.testing.assert_allclose(b64, a64, rtol=1e-5, atol=5e-6, equal_nan=True, err_msg=what)


def _draw_both(record, tmp_path, draw):
    """Run ``draw(plots, pkg, lib, path)`` with each package; compare the
    recorded calls and check that the port wrote its file."""
    out = []
    for plots, pkg, lib in ((jplots, ot, jnp), (tplots, otp, torch)):
        record.clear()
        path = str(tmp_path / f"{pkg.__name__}.png")
        draw(plots, pkg, lib, path)
        out.append(list(record))
        assert os.path.getsize(path) > 0
    assert [c[0] for c in out[0]] == [c[0] for c in out[1]]
    for (name, aj, kj), (_, at, kt) in zip(*out):
        assert len(aj) == len(at) and kj.keys() == kt.keys(), name
        for i, (x, y) in enumerate(zip(aj, at)):
            _same(x, y, f"{name} arg {i}")
        for k in kj:
            _same(kj[k], kt[k], f"{name} {k}")
    return out[1]


RNG_DATA = np.random.default_rng(0).uniform(0, 1, (32, 32, 3))


CASES = {
    "image_rgb": lambda p, k, lib, f: p.image_plot(k.RGBImage(RNG_DATA, s=[2, 2]), path=f),
    "image_log_flip": lambda p, k, lib, f: p.image_plot(
        k.ScalarImage(RNG_DATA[..., 0], s=[2, 2], quantity="Irradiance"), log=True, flip=True, path=f),
    "image_rgb_log": lambda p, k, lib, f: p.image_plot(k.RGBImage(RNG_DATA, s=[2, 2]), log=True, path=f),
    "image_profile": lambda p, k, lib, f: p.image_profile_plot(k.RGBImage(RNG_DATA, s=[2, 2]), x=0.0, path=f),
    "spectrum": lambda p, k, lib, f: p.spectrum_plot(k.presets.light_spectrum.d65, path=f),
    "spectrum_list_lines": lambda p, k, lib, f: p.spectrum_plot(
        [k.presets.light_spectrum.d65, k.presets.light_spectrum.FDC], path=f),
    "refraction_index": lambda p, k, lib, f: p.refraction_index_plot(k.presets.refraction_index.BK7, path=f),
    "abbe": lambda p, k, lib, f: p.abbe_plot([k.presets.refraction_index.BK7,
                                             k.presets.refraction_index.SF10], path=f),
    "surface_profile": lambda p, k, lib, f: p.surface_profile_plot(
        [k.SphericalSurface(r=3, R=10),
         k.FunctionSurface1D(r=3, func=lambda r: r ** 2 / 40 + 1e-3 * lib.cos(r), desc="function"),
         data_sphere(k, 3.0, 20.0, n=120, astig=2e-3)], remove_offset=True, path=f),
    "cie_1931": lambda p, k, lib, f: p.chromaticities_cie_1931(k.presets.light_spectrum.d65, path=f),
    "cie_1976": lambda p, k, lib, f: p.chromaticities_cie_1976([k.presets.light_spectrum.d65], path=f),
    "cie_1931_rgb": lambda p, k, lib, f: p.chromaticities_cie_1931(k.RGBImage(RNG_DATA, s=[2, 2]), path=f),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_hands_matplotlib_the_same_arrays(record, tmp_path, case):
    calls = _draw_both(record, tmp_path, CASES[case])
    assert any(c[0] in ("plot", "scatter", "imshow", "axvline") for c in calls)
    plt.close("all")


def test_profile_plot_needs_a_cut():
    with pytest.raises(ValueError):
        tplots.image_profile_plot(otp.RGBImage(RNG_DATA, s=[2, 2]))


def test_focus_search_cost_plot_of_the_ports_focus(record, tmp_path):
    """The cost curve of the port's own focus search, drawn by both
    packages' plot functions from the same result."""
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550)))
    RT.add(otp.IdealLens(r=3, D=50, pos=[0, 0, 0]))
    with otp.global_options.no_progress_bar():
        RT.trace(2000)
    res, fsdict = RT.focus_search("RMS Spot Size", z_start=15.0, return_cost=True)
    assert isinstance(res, scipy.optimize.OptimizeResult) and abs(res.x - 20.0) < 0.1
    calls = _draw_both(record, tmp_path, lambda p, k, lib, f: p.focus_search_cost_plot(res, fsdict, path=f))
    np.testing.assert_array_equal(calls[0][1][0], fsdict["z"])
    with pytest.raises(RuntimeError):
        tplots.focus_search_cost_plot(res, dict(z=None, cost=None))
    plt.close("all")


def test_dark_mode():
    with matplotlib.rc_context():       # the worker's style is left as it was
        tplots._apply_dark_mode(True)
        assert matplotlib.rcParams["figure.facecolor"] == "#131313"
        tplots._apply_dark_mode(False)
        assert matplotlib.rcParams["figure.facecolor"] == "white"
    assert tplots.chromaticity_norms == ["Largest", "Sum", "Euclidean"]
