"""The example scripts of examples_torch/ that render images from image
sources, iterative renders and PSF convolutions, and the two preset
galleries, run on the CPU at 20 000 rays (``main(device="cpu",
rays=20000)``, then ``plot``): each writes the PNG files of its JAX
counterpart in examples/ and meets its invariants
(``examples_torch/common.py:check_results``); an iterative render keeps its
number of batches at the smaller batch. The galleries' numbers are held
against the JAX package's presets: refractive indices and Abbe numbers to
1e-12 relative (both f64 on the host), CIE 1931 chromaticities to 1e-6
absolute (the JAX package sums the tristimulus values in f32)."""

import numpy as np
import pytest

import optrace_tpu as ot

from examples_torch.common import check_results
from test_torch_common import assert_kernels_as_the_smoke_expects
from test_torch_common import ran_examples as ran  # noqa: F401 (a fixture)

N_RTOL = 1e-12
XY_ATOL = 1e-6

OUTPUTS = {
    "IOL_pinhole_imaging": ["IOL_pinhole_0.01D.png", "IOL_pinhole_0.75D.png",
                            "IOL_pinhole_1.50D.png"],
    "IOL_target_imaging": ["IOL_target_0.01D.png", "IOL_target_0.75D.png",
                           "IOL_target_1.50D.png"],
    "image_render": ["image_render.png"],
    "image_render_many_rays": ["image_render_many_rays.png"],
    "psf_imaging": ["psf_imaging.png"],
    "refraction_index_presets": ["abbe_diagram.png", "glass_dispersion.png"],
    "spectrum_presets": ["chromaticities.png", "spectra_f.png", "spectra_natural.png",
                         "spectra_srgb.png"],
}


@pytest.mark.parametrize("name", sorted(OUTPUTS))
def test_example_writes_its_files_and_meets_its_invariants(ran, name):
    results, written, calls = ran(name)
    assert written == OUTPUTS[name]
    assert_kernels_as_the_smoke_expects(name, calls)
    assert 0 <= results["rays"] <= 3 * 20000 and calls["rays"] == results["rays"]
    check_results(results)


def test_iterative_renders_keep_their_batches(ran):
    """2·10⁷ rays are 20 batches of 10⁶; capped at 20 000 they are 20 of 1000."""
    results, _, calls = ran("image_render_many_rays")
    assert results["rays"] == calls["rays"] == 20000
    assert results["batches"] == calls["traces"] == 20


def test_psf_imaging_keeps_the_image_size(ran):
    results, _, _ = ran("psf_imaging")
    assert results["rays"] == 0 and results["shape"][0] == results["shape"][1] > 0
    assert 0.0 < results["mean"] < 1.0


def test_glass_indices_and_abbe_numbers_equal_jax(ran):
    results, _, _ = ran("refraction_index_presets")
    wl = np.linspace(380.0, 780.0, 41)
    jglasses = ot.presets.refraction_index.glasses[:8]
    assert list(results["abbe_numbers"]) == [n.get_desc() for n in jglasses]
    for t, j in zip(results["glasses"], jglasses):
        np.testing.assert_allclose(np.asarray(t(wl), np.float64), np.asarray(j(wl), np.float64),
                                   rtol=N_RTOL)
        assert results["abbe_numbers"][j.get_desc()] == pytest.approx(j.abbe_number(), rel=N_RTOL)
    assert len(results["abbe_glasses"]) == 12


def test_chromaticities_equal_jax(ran):
    results, _, _ = ran("spectrum_presets")
    specs = ot.presets.light_spectrum.standard_natural
    assert list(results["chromaticities_xy"]) == [s.get_desc() for s in specs]
    for s in specs:
        xyz = np.asarray(s.xyz(), np.float64)
        np.testing.assert_allclose(results["chromaticities_xy"][s.get_desc()],
                                   xyz[:2] / xyz.sum(), rtol=0, atol=XY_ATOL)
    # D65's white point (CIE 15): x = 0.3127, y = 0.3290
    np.testing.assert_allclose(results["chromaticities_xy"]["D65"], [0.3127, 0.3290], atol=1e-4)
