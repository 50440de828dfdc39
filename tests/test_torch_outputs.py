"""``detector_spectrum``, ``source_spectrum`` and ``source_image`` of the
port against the JAX package's methods on the same stored sections.

The JAX package traces a scene with two sources; its stored sections are
copied into the port's ``RayStorage`` (``tests/test_torch_image.py:
_copy_trace``), so that the port reads them through its upload path on the
CPU. Spectra: the bin edges agree to 1e-6 (the JAX package's
``np.histogram`` keeps f32 edges on f32 wavelengths), the values to the
weight of 3 rays a bin, the power to 1e-6. Images: 1e-5 of the maximum.
"""

import numpy as np
import pytest

import optrace_tpu as ot
import optrace_tpu_torch as otp

from tests.test_torch_image import _copy_trace

N = 20000


def build(m, **kw):
    RT = m.Raytracer(outline=[-10, 10, -10, 10, -10, 60], no_pol=True, **kw)
    RT.add(m.RaySource(m.CircularSurface(r=1.5), divergence="Lambertian", div_angle=6,
                       pos=[0, 0, -5], spectrum=m.presets.light_spectrum.d65, power=2.0,
                       desc="day"))
    RT.add(m.RaySource(m.RectangularSurface(dim=[2.0, 1.0]), divergence="None", pos=[0.5, 0, -4],
                       spectrum=m.LightSpectrum("Gaussian", mu=620.0, sig=15.0), power=1.0))
    RT.add(m.Lens(m.SphericalSurface(r=3, R=20), m.SphericalSurface(r=3, R=-25),
                  n=m.presets.refraction_index.BK7, pos=[0, 0, 0], d=1.0))
    RT.add(m.Detector(m.RectangularSurface(dim=[8, 8]), pos=[0, 0, 30], desc="screen"))
    return RT


@pytest.fixture(scope="module")
def traced():
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT_j = build(ot)
        RT_j.trace(N)
    RT_t = build(otp, device="cpu")
    _copy_trace(RT_j, RT_t)
    assert RT_t.rays._dev is None           # the upload path
    return RT_j, RT_t


def _spectra_agree(sj, st, w_max):
    assert st.spectrum_type == "Histogram" and st.long_desc == sj.long_desc
    assert st._vals.shape == np.asarray(sj._vals).shape
    np.testing.assert_allclose(st._wls, np.asarray(sj._wls), rtol=1e-6)
    dw = st._wls[1] - st._wls[0]
    assert np.abs(st._vals - np.asarray(sj._vals)).max() <= 3 * w_max / dw
    assert st.power() == pytest.approx(sj.power(), rel=1e-6) and st.power() > 0


@pytest.mark.parametrize("source_index", [None, 0, 1])
def test_detector_spectrum(traced, source_index):
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        sj = RT_j.detector_spectrum(source_index=source_index)
        st = RT_t.detector_spectrum(source_index=source_index)
        _spectra_agree(sj, st, float(RT_j.rays.w_list.max()))
        ej = RT_j.detector_spectrum(source_index=source_index, extent=[-0.5, 0.5, -0.5, 0.5])
        et = RT_t.detector_spectrum(source_index=source_index, extent=[-0.5, 0.5, -0.5, 0.5])
        _spectra_agree(ej, et, float(RT_j.rays.w_list.max()))
    assert et.power() < st.power()
    assert "screen" in st.long_desc and ("RS" in st.long_desc) == (source_index is not None)


@pytest.mark.parametrize("source_index", [0, 1])
def test_source_spectrum(traced, source_index):
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        sj = RT_j.source_spectrum(source_index=source_index)
        st = RT_t.source_spectrum(source_index=source_index)
    _spectra_agree(sj, st, float(RT_j.rays.w_list.max()))
    assert st.power() == pytest.approx([2.0, 1.0][source_index], rel=1e-4)
    if source_index == 1:
        assert abs(st.peak_wavelength() - 620.0) < 8.0
    assert st.long_desc.startswith(f"Spectrum of RS{source_index}")


@pytest.mark.parametrize("source_index", [0, 1])
def test_source_image(traced, source_index):
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        ij = RT_j.source_image(source_index=source_index)
        it = RT_t.source_image(source_index=source_index)
    a, b = np.asarray(ij.data), it.data
    assert a.shape == b.shape and b.dtype == np.float64
    assert np.abs(a - b).max() <= 1e-5 * a.max()
    assert np.allclose(it.extent, np.asarray(ij.extent)) and it.long_desc == ij.long_desc
    assert it.power() == pytest.approx(ij.power(), rel=1e-6)
    assert it.power() == pytest.approx([2.0, 1.0][source_index], rel=1e-4)
    assert it.projection is None
    if source_index == 1:       # a 2:1 source: three times 945 columns
        assert it.shape == (945, 945 * 3, 4)


def test_source_image_with_limit(traced):
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        ij = RT_j.source_image(limit=30.0)
        it = RT_t.source_image(limit=30.0)
    assert it.limit == 30.0 and np.allclose(it.extent, np.asarray(ij.extent))
    assert np.abs(np.asarray(ij.data) - it.data).max() <= 1e-5 * it.data.max()


@pytest.mark.parametrize("method", ["source_spectrum", "source_image", "detector_spectrum"])
def test_error_paths(method, traced):
    """The checks of ``_hit_source`` and ``_hit_detector``, with the JAX
    class's messages."""
    _, RT_t = traced
    go = otp.global_options
    empty = otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1], device="cpu")
    missing = "Detector Missing" if method == "detector_spectrum" else "Ray Sources Missing."
    with pytest.raises(RuntimeError, match=missing):
        getattr(empty, method)()
    fresh = build(otp, device="cpu")
    with pytest.raises(RuntimeError, match="No rays traced."):
        getattr(fresh, method)()
    with pytest.raises(IndexError, match="Invalid source_index."):
        getattr(RT_t, method)(source_index=2)
    with pytest.raises(IndexError, match="Invalid source_index."):
        getattr(RT_t, method)(source_index=-1)
    if method == "detector_spectrum":
        with pytest.raises(IndexError, match="Invalid detector_index."):
            RT_t.detector_spectrum(detector_index=1)
        with pytest.raises(ValueError, match="Invalid extent"):
            RT_t.detector_spectrum(extent="all")
    moved = build(otp, device="cpu")
    with go.no_progress_bar(), go.no_warnings():
        moved.trace(500)
        getattr(moved, method)()
        moved.ray_sources[0].power = 3.0
        with pytest.raises(RuntimeError, match="Please retrace first"):
            getattr(moved, method)()
