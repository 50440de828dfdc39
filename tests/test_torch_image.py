"""``RenderImage`` and ``Raytracer.detector_image`` of the port against the
JAX package on the same stored sections.

The JAX package traces; its stored sections are copied into the port's
``RayStorage``; both then search the detector hits in f64 and bin them.
The rendered XYZW image is compared to 1e-5 of its maximum (f32 binning,
sums taken in another order), with extents that f32 represents exactly, so
that both packages round the same bin scale and no ray changes its pixel.
``get`` is compared mode by mode: the port converts colours in f64, the JAX
package in f32.
"""

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda

from tests.test_torch_scenes import build_asphere

EXT = [-3.0, 3.0, -3.0, 3.0]
N = 20000


def _copy_trace(RT_j, RT_t):
    """The JAX raytracer's stored trace as the port's."""
    rj = RT_j.rays
    nt = np.asarray(rj.p_list).shape[1]
    RT_t.rays.init(RT_t.ray_sources, rj.N, nt, RT_t.no_pol)
    p = np.asarray(rj.p_list)
    s0 = p[:, 1] - p[:, 0]
    s0 /= np.linalg.norm(s0, axis=-1, keepdims=True)
    RT_t.rays.fill(p, np.asarray(rj.w_list), None if RT_t.no_pol else np.asarray(rj.pol_list),
                   np.asarray(rj.n_list), np.asarray(rj.wl_list), s0)
    RT_t.rays.lock()
    RT_t._last_trace_snapshot = RT_t.tracing_snapshot()


@pytest.fixture(scope="module")
def traced():
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT_j = build_asphere(ot)
        RT_j.trace(N)
    RT_t = build_asphere(otp, device="cpu")
    _copy_trace(RT_j, RT_t)
    return RT_j, RT_t


@pytest.fixture(scope="module")
def images(traced):
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        return RT_j.detector_image(extent=EXT), RT_t.detector_image(extent=EXT)


def test_detector_image_parity(images):
    img_j, img_t = images
    a, b = np.asarray(img_j.data), img_t.data
    assert a.shape == b.shape == (945, 945, 4) and b.dtype == np.float64
    assert np.abs(a - b).max() <= 1e-5 * a.max()
    assert img_t.power() == pytest.approx(img_j.power(), rel=1e-6)
    assert img_t.luminous_power() == pytest.approx(img_j.luminous_power(), rel=1e-5)
    assert np.array_equal(img_t.extent, np.asarray(img_j.extent))
    assert img_t.long_desc == img_j.long_desc and img_t.projection is None
    assert img_t.Apx == pytest.approx(img_j.Apx) and 0.2 < img_t.power() < 1.0


MODE_TOL = {"sRGB (Absolute RI)": 2e-4, "sRGB (Perceptual RI)": 2e-4, "Outside sRGB Gamut": 0.0,
            "Irradiance": None, "Illuminance": None, "Lightness (CIELUV)": 2e-3,
            "Hue (CIELUV)": None, "Chroma (CIELUV)": 2e-2, "Saturation (CIELUV)": 2e-3}


@pytest.mark.parametrize("size", [189, 10])
@pytest.mark.parametrize("mode", sorted(MODE_TOL))
def test_get_modes(images, mode, size):
    """Every display mode at two sizes (10 snaps to 9). Irradiance and
    illuminance are linear in the image: 1e-5 of the maximum. The colour
    modes carry the f32 colour arithmetic of the JAX side: L to 2e-3 of 100,
    chroma to 2e-2 of up to 200, sRGB to 2e-4, hue (an angle of two small
    differences) to 0.5° where chroma > 5, the gamut mask equal but for
    pixels within f32 rounding of the gamut's edge."""
    img_j, img_t = images
    gj, gt = img_j.get(mode, size), img_t.get(mode, size)
    a, b = np.asarray(gj.data), gt.data
    side = 189 if size == 189 else 9
    assert a.shape == b.shape and b.shape[:2] == (side, side)
    assert type(gt).__name__ == type(gj).__name__ and gt.quantity == mode == gj.quantity
    assert np.array_equal(gt.extent, np.asarray(gj.extent))
    if mode in ("Irradiance", "Illuminance"):
        assert np.abs(a - b).max() <= 1e-5 * a.max() and a.max() > 0
    elif mode == "Hue (CIELUV)":
        chroma = img_t.get("Chroma (CIELUV)", size).data
        sel = chroma > 5.0
        d = np.abs(a - b)[sel]
        assert sel.sum() > 5 and np.minimum(d, 360.0 - d).max() < 0.5
    elif mode == "Outside sRGB Gamut":
        assert np.mean(a != b) < 2e-3
    else:
        assert np.abs(a - b).max() <= MODE_TOL[mode], np.abs(a - b).max()
    assert np.isfinite(b).all()


def test_get_arguments_and_errors(images):
    _, img_t = images
    with pytest.raises(ValueError):
        img_t.get("Irradiance", 0)
    with pytest.raises(ValueError):
        img_t.get("No such mode")
    lo = img_t.get("sRGB (Perceptual RI)", 63, L_th=0.2, chroma_scale=0.6)
    assert lo.shape == (63, 63, 3) and lo.data.max() <= 1.0
    assert otp.RenderImage(EXT).has_image() is False
    with pytest.raises(RuntimeError):
        otp.RenderImage(EXT).power()
    bins, prof = img_t.get("Irradiance", 63).profile(x=0.0)
    assert len(bins) == 64 and prof[0].shape == (63,)
    gray = img_t.get("sRGB (Absolute RI)", 63).to_grayscale_image()
    assert isinstance(gray, otp.GrayscaleImage) and gray.data.max() <= 1.0
    assert gray.to_rgb_image().shape == (63, 63, 3)


def test_rayleigh_filter_and_extent_fix(traced):
    """The resolution limit's Airy filter (host, scipy) and the extent that
    it widens; a line-shaped extent is widened to the maximum side ratio."""
    RT_j, RT_t = traced
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar(), \
            ot.global_options.no_warnings(), otp.global_options.no_warnings():
        ij = RT_j.detector_image(extent=EXT, limit=40.0)
        it = RT_t.detector_image(extent=EXT, limit=40.0)
    assert it.limit == 40.0 and np.allclose(it.extent, np.asarray(ij.extent))
    a, b = np.asarray(ij.data), it.data
    assert np.abs(a - b).max() <= 1e-5 * a.max() and b.min() >= 0
    assert it.power() == pytest.approx(ij.power(), rel=1e-5)
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        lj = RT_j.detector_image(extent=[-3.0, 3.0, -0.25, 0.25])
        lt = RT_t.detector_image(extent=[-3.0, 3.0, -0.25, 0.25])
    assert lt.shape == np.asarray(lj.data).shape == (945, 945 * 5, 4)
    assert np.allclose(lt.extent, np.asarray(lj.extent))
    assert lt.power() == pytest.approx(lj.power(), rel=1e-5)


def test_render_image_direct_and_accumulate():
    """``RenderImage.render`` on given hits against the JAX class; the
    binning goes through the kernel's wrapper (plain version on the CPU);
    ``_accumulate`` adds tiles; save and load bring the image back."""
    rng = np.random.default_rng(5)
    n = 5000
    p = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.6, 0.6, n), np.zeros(n)], -1)
    w = rng.uniform(0, 1, n)
    wl = rng.uniform(380, 780, n)
    ext = [-1.0, 1.0, -0.5, 0.5]
    ij = ot.RenderImage(ext)
    ij.render(p, w, wl)
    before = bin_xyzw_cuda.launches
    it = otp.RenderImage(ext)
    it.render(p, w, wl, device="cpu")
    assert bin_xyzw_cuda.launches == before
    assert it.shape == np.asarray(ij.data).shape == (945, 945 * 3, 4)     # side ratio 2 snaps to 3
    assert np.abs(np.asarray(ij.data) - it.data).max() <= 1e-5 * it.data.max()
    # a tensor tile and a numpy tile accumulate alike
    tile = torch.full((945, 945 * 3, 4), 0.5)
    p0 = it.power()
    it._accumulate(tile)
    it._accumulate(tile.numpy())
    assert it.power() == pytest.approx(p0 + 3 * 945 * 945)
    empty = otp.RenderImage(ext)
    empty._accumulate(tile)
    assert empty.power() == pytest.approx(1.5 * 945 * 945)
    none = otp.RenderImage(ext)
    none.render(device="cpu")
    assert none.power() == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            otp.RenderImage(ext).render(p, w, wl)


def test_save_and_load(tmp_path, images):
    _, img_t = images
    path = str(tmp_path / "img")
    img_t.save(path)
    back = otp.RenderImage.load(path + ".npz")
    assert np.array_equal(back.data, img_t.data) and np.array_equal(back.extent, img_t.extent)
    assert back.limit is None and back.projection is None and back.long_desc == img_t.long_desc


def test_detector_image_on_the_ports_own_trace_and_errors():
    """The port's own trace carried through to the image: power on the
    image is the power of the rays that reach the 8 mm detector (all but
    the widest percent of the bundle); a source
    index selects; stale rays, a missing detector and bad indices raise."""
    RT = build_asphere(otp, device="cpu")
    with otp.global_options.no_progress_bar(), otp.global_options.no_warnings():
        with pytest.raises(RuntimeError, match="No rays"):
            RT.detector_image()
        RT.trace(N)
        img = RT.detector_image()
        assert img.shape == (945, 945, 4)
        w_end = RT.rays.w_list[:, -2]
        assert 0.98 * float(w_end.sum()) < img.power() <= float(w_end.sum()) * (1 + 1e-6)
        rgb = img.get("sRGB (Absolute RI)", 189)
        assert rgb.shape == (189, 189, 3) and 0.5 < rgb.data.max() <= 1.0
        assert RT.detector_image(source_index=0).power() == pytest.approx(img.power(), rel=1e-6)
        with pytest.raises(IndexError):
            RT.detector_image(detector_index=3)
        with pytest.raises(IndexError):
            RT.detector_image(source_index=2)
        with pytest.raises(ValueError):
            RT.detector_image(extent="all")
        RT.lenses[0].move_to([0, 0, 0.1])
        with pytest.raises(RuntimeError, match="retrace"):
            RT.detector_image()
    RT2 = otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1], device="cpu")
    with pytest.raises(RuntimeError, match="Detector"):
        RT2.detector_image()


def test_curved_detector_sphere_projection(traced):
    """A spherical detector with a sphere projection, as the JAX package
    renders it."""
    def with_curved(m, **kw):
        RT = build_asphere(m, **kw)
        RT.remove(RT.detectors[0])
        RT.add(m.Detector(m.SphericalSurface(r=4, R=-12), pos=[0, 0, 40]))
        return RT
    RT_j, _ = traced
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        RT_cj = with_curved(ot)
        RT_cj.trace(N)
    RT_ct = with_curved(otp, device="cpu")
    _copy_trace(RT_cj, RT_ct)
    ext = [-0.25, 0.25, -0.25, 0.25]
    with ot.global_options.no_progress_bar(), otp.global_options.no_progress_bar():
        ij = RT_cj.detector_image(extent=ext, projection_method="Equal-Area")
        it = RT_ct.detector_image(extent=ext, projection_method="Equal-Area")
    assert it.projection == "Equal-Area" == ij.projection
    assert it.power() == pytest.approx(ij.power(), rel=1e-5) and it.power() > 0
    assert np.abs(np.asarray(ij.data) - it.data).max() <= 1e-5 * it.data.max()
