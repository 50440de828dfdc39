"""The stored trace's read path of the port on the CPU.

A ``RenderImage`` carries the device it was rendered on, and ``get``
computes the block mean and the colour there in f64; on the CPU it gives
the bits of the host computation that it replaced (kept below as
``host_get``). The geometry checks before a trace keep their outcome for
each scene: a check of an unchanged scene replays the same warnings, in
order, and sets the same ``geometry_error`` and ``fault_pos`` as a fresh
check and as the JAX package's own checks.
"""

import re
import warnings

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch import color
from optrace_tpu_torch.tracer.raytracer import Raytracer

N = 20000
MODES = otp.RenderImage.image_modes


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(a.shape + (-1,))


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def host_get(img, mode, N, L_th=0, chroma_scale=None) -> np.ndarray:
    """What ``RenderImage.get`` computed before it ran on the image's
    device: numpy's block mean, the colour of a contiguous host copy, and
    ``np.clip``."""
    side = min(img.SIZES, key=lambda s: abs(s - N))
    f = img.MAX_IMAGE_SIDE // side
    arr = img._data
    if f == 1:
        stack = arr.copy()
    else:
        ny, nx = arr.shape[0] // f, arr.shape[1] // f
        stack = arr[:ny * f, :nx * f].reshape(ny, f, nx, f, -1).mean(axis=(1, 3))
    xyz = torch.from_numpy(np.ascontiguousarray(stack[:, :, :3]))
    if mode in ("sRGB (Absolute RI)", "sRGB (Perceptual RI)"):
        intent = "Absolute" if "Absolute" in mode else "Perceptual"
        rgb = color.xyz_to_srgb(xyz, rendering_intent=intent, L_th=L_th, chroma_scale=chroma_scale).numpy()
        return np.clip(rgb, 0, 1)
    if mode == "Irradiance":
        return stack[:, :, 3] / img.Apx
    if mode == "Illuminance":
        return img.K / img.Apx * stack[:, :, 1]
    if mode == "Outside sRGB Gamut":
        return color.outside_srgb_gamut(xyz).numpy().astype(np.float64)
    luv = color.xyz_to_luv(xyz)
    return {"Lightness (CIELUV)": lambda: luv[:, :, 0], "Hue (CIELUV)": lambda: color.luv_hue(luv),
            "Chroma (CIELUV)": lambda: color.luv_chroma(luv),
            "Saturation (CIELUV)": lambda: color.luv_saturation(luv)}[mode]().numpy()


def lens_scene(pkg, **kw):
    RT = pkg.Raytracer(outline=[-5, 5, -5, 5, -5, 40], **kw)
    RT.add(pkg.RaySource(pkg.CircularSurface(r=1), pos=[0, 0, 0], divergence="Lambertian",
                         div_angle=5, spectrum=pkg.presets.light_spectrum.d65))
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                    n=pkg.presets.refraction_index.BK7, pos=[0, 0, 10], d=1.5))
    RT.add(pkg.Detector(pkg.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    return RT


def quiet():
    return otp.global_options.no_progress_bar()


@pytest.fixture(scope="module")
def image():
    """A detector image with out-of-gamut colours: a narrow-band source
    beside a white one."""
    RT = lens_scene(otp, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=0.5), pos=[0.8, 0, 0], divergence="Lambertian",
                         div_angle=3, spectrum=otp.LightSpectrum("Gaussian", mu=480.0, sig=6.0)))
    with quiet(), otp.global_options.no_warnings():
        RT.trace(N)
        return RT.detector_image(extent=[-0.6, 0.6, -0.6, 0.6])


# ----------------------------------------------------------------------
# a RenderImage carries its device

def test_an_image_carries_its_device(image, tmp_path):
    assert image.device == torch.device("cpu") and image._data.dtype == np.float64
    img = otp.RenderImage([-1.0, 1.0, -1.0, 1.0])
    assert img._device is None
    img._accumulate(torch.ones((945, 945, 4)))
    assert img.device == torch.device("cpu") and img.power() == pytest.approx(945 * 945)
    path = str(tmp_path / "img.npz")
    image.save(path)
    back = otp.RenderImage.load(path, device="cpu")
    assert back.device == torch.device("cpu") and same_bits(back._data, image._data)
    assert same_bits(back.get("sRGB (Absolute RI)", 315).data, image.get("sRGB (Absolute RI)", 315).data)
    none = otp.RenderImage.load(path)
    assert none._device is None
    if not torch.cuda.is_available():       # an image without a device computes on the card
        with pytest.raises(RuntimeError, match="CUDA"):
            none.get("Irradiance", 63)


def test_renders_of_a_raytracer_carry_its_device():
    RT = lens_scene(otp, device="cpu")
    RT.ITER_RAYS_STEP = 4000
    with quiet(), otp.global_options.no_warnings():
        images = RT.iterative_render(8000)
        huge = RT.render_huge(8000, batch_size=4000)
        RT.trace(4000)
        src = RT.source_image()
    for img in images + [huge, src]:
        assert img.device == torch.device("cpu")
        assert img.get("sRGB (Perceptual RI)", 63).shape == (63, 63, 3)


@pytest.mark.parametrize("mode", MODES)
def test_get_gives_the_host_bits_on_the_cpu(image, mode):
    """Every mode at two sizes, and the perceptual intent with a lightness
    threshold and a given chroma scale: the bits of the host computation."""
    for size in (945, 315):
        out = image.get(mode, size)
        assert type(out).__name__ == ("RGBImage" if mode.startswith("sRGB") else "ScalarImage")
        assert same_bits(out.data, host_get(image, mode, size)), (mode, size)
    if mode == "sRGB (Perceptual RI)":
        for kw in (dict(L_th=0.2), dict(chroma_scale=0.6)):
            assert same_bits(image.get(mode, 63, **kw).data, host_get(image, mode, 63, **kw))
    if mode == "Outside sRGB Gamut":
        assert 0 < image.get(mode, 315).data.sum()


def test_get_takes_the_image_to_its_device_once(image, monkeypatch):
    """The stack goes to the device once; the colour receives tensors on
    that device; the result is a host image."""
    seen = []
    real = color.xyz_to_srgb

    def spy(xyz, **kw):
        seen.append((xyz.device, xyz.dtype, xyz.is_contiguous()))
        return real(xyz, **kw)
    monkeypatch.setattr(color, "xyz_to_srgb", spy)
    rgb = image.get("sRGB (Absolute RI)", 189)
    assert seen == [(torch.device("cpu"), torch.float64, True)]
    assert isinstance(rgb.data, np.ndarray) and rgb.data.dtype == np.float64


# ----------------------------------------------------------------------
# the geometry outcome, kept per scene

def colliding(pkg, **kw):
    """Two lenses that overlap: the second's front lies inside the first."""
    RT = lens_scene(pkg, **kw)
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                    n=pkg.presets.refraction_index.BK7, pos=[0, 0, 10.6], d=1.5))
    return RT


def outside_outline(pkg, **kw):
    """A lens that sticks out of the outline's z end."""
    RT = lens_scene(pkg, **kw)
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                    n=pkg.presets.refraction_index.BK7, pos=[0, 0, 39.5], d=1.5))
    return RT


def no_source(pkg, **kw):
    RT = pkg.Raytracer(outline=[-5, 5, -5, 5, -5, 40], **kw)
    RT.add(pkg.Lens(pkg.SphericalSurface(r=3, R=20), pkg.SphericalSurface(r=3, R=-20),
                    n=pkg.presets.refraction_index.BK7, pos=[0, 0, 10], d=1.5))
    return RT


def checked(RT):
    """(warnings in order, geometry_error, fault_pos) of one geometry check;
    the objects' addresses are left out of the messages."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        RT._geometry_checks()
    msgs = [re.sub(r" at 0x[0-9a-f]+", "", str(w.message)) for w in rec]
    return msgs, bool(RT.geometry_error), np.array(RT.fault_pos)


def _same_outcome(a, b):
    return a[0] == b[0] and a[1] == b[1] and a[2].shape == b[2].shape and np.array_equal(a[2], b[2])


@pytest.mark.parametrize("scene", [colliding, outside_outline, no_source, lens_scene])
def test_kept_outcome_equals_a_fresh_check_and_jax(scene):
    RT = scene(otp, device="cpu")
    fresh = checked(RT)
    hit = checked(RT)
    assert len(RT._geometry_cache) == 1
    assert _same_outcome(fresh, hit)
    assert _same_outcome(fresh, checked(scene(otp, device="cpu")))
    jax_side = checked(scene(ot))
    assert _same_outcome(fresh, jax_side), (fresh, jax_side)
    assert fresh[1] == (scene is not lens_scene) and len(fresh[0]) == int(fresh[1])
    if scene is colliding:
        assert fresh[2].shape[1] == 3 and len(fresh[2]) > 10
        # a hit sets fault_pos again, as a fresh check does, and hands out a copy
        RT.fault_pos = np.array([])
        assert np.array_equal(checked(RT)[2], fresh[2])
        RT.fault_pos[0, 0] = 1e9
        assert np.array_equal(checked(RT)[2], fresh[2])


def test_a_failing_trace_replays_its_warnings():
    RT = colliding(otp, device="cpu")
    runs = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec, quiet():
            warnings.simplefilter("always")
            RT.trace(1000)
        runs.append([str(w.message) for w in rec])
    assert runs[0] == runs[1] and runs[0][-1] == "ABORTED TRACING" and len(runs[0]) == 2
    assert RT.geometry_error and RT.rays.N == 0
    RT._ignore_geometry_error = True
    with warnings.catch_warnings(record=True) as rec, quiet():
        warnings.simplefilter("always")
        RT.trace(1000)
    assert [str(w.message) for w in rec][:1] == runs[0][:1] and RT.rays.N == 1000


@pytest.fixture
def counted(monkeypatch):
    """The fresh geometry checks made while a test runs."""
    calls = []
    real = Raytracer._geometry_outcome

    def spy(self, elements):
        calls.append(len(elements))
        return real(self, elements)
    monkeypatch.setattr(Raytracer, "_geometry_outcome", spy)
    return calls


def test_a_changed_scene_is_checked_anew(counted):
    """Moving a lens, swapping in another equal object and ``clear()`` each
    force a fresh check; a scene seen before is a hit."""
    RT = lens_scene(otp, device="cpu")
    L = RT.lenses[0]
    RT._geometry_checks()
    RT._geometry_checks()
    assert len(counted) == 1
    L.move_to([0, 0, 12])
    RT._geometry_checks()
    assert len(counted) == 2
    L.move_to([0, 0, 10])
    RT._geometry_checks()
    assert len(counted) == 2 and len(RT._geometry_cache) == 2
    RT.remove(L)
    twin = L.copy()
    RT.add(twin)
    assert twin.crepr() == L.crepr()
    RT._geometry_checks()
    assert len(counted) == 3 and len(RT._geometry_cache) == 2
    RT.ray_sources[0].move_to([0, 0, 1])
    RT._geometry_checks()
    assert len(counted) == 4
    RT.clear()
    assert len(RT._geometry_cache) == 0
    with otp.global_options.no_warnings():
        RT._geometry_checks()
    assert len(counted) == 5 and RT.geometry_error       # cleared: no source left


def test_trace_iterative_and_huge_take_the_kept_outcome(counted):
    RT = lens_scene(otp, device="cpu")
    RT.ITER_RAYS_STEP = 4000
    with quiet(), otp.global_options.no_warnings():
        RT.trace(4000)
        assert len(counted) == 1
        RT.trace(4000)
        RT.iterative_render(8000)
        RT.render_huge(8000, batch_size=4000)
    assert len(counted) == 1
    # the snapshot that the trace keeps is the scene as it stands after it
    assert RT._last_trace_snapshot == RT.tracing_snapshot() and RT.check_if_rays_are_current()
    RT.lenses[0].move_to([0, 0, 11])
    with quiet(), otp.global_options.no_warnings():
        RT.render_huge(4000, batch_size=4000)
    assert len(counted) == 2


def test_a_failing_scene_stops_iterative_and_huge_renders_with_its_warnings():
    RT = colliding(otp, device="cpu")
    for call in (lambda: RT.iterative_render(2000), lambda: RT.render_huge(2000)):
        for _ in range(2):
            with warnings.catch_warnings(record=True) as rec, pytest.raises(RuntimeError, match="Geometry"):
                warnings.simplefilter("always")
                call()
            msgs = [str(w.message) for w in rec]
            assert msgs[0].startswith("Detected collision") and msgs[-1] == "ABORTED TRACING"
