"""Wavelengths of an RGB image source: the plain route
(``color.wavelengths_from_srgb``) and the kernel that an image source's
sampler calls on the card (``ops/cuda_sampling.py``,
``csrc/srgb_wavelengths.cu``).

- On the CPU: the plain route's running sums of the channel powers, written
  out, give the wavelengths of the scan they replace bit for bit (random
  sRGB, black pixels, pure primaries, values outside [0, 1], the gamma's
  threshold, uniforms at 0 and just below 1, two wavelength ranges); an
  image source's sampler on the CPU draws the same rays as with the scan;
  the inverse CDFs' tables are those of the lookups; the kernel's wrapper
  is among the counted wrappers of a captured step and refuses tensors off
  the card and mismatched shapes.
- On the card (skipped without one): the kernel against the plain route on
  the same cases, on the Arizona eye's ColorChecker chart and with every
  ``choice`` on or next to a boundary between the primaries, bit for bit;
  the sums against the scan there too; a render batch of an image source
  captured into a CUDA graph against its eager batch, with one launch of
  the kernel a batch, replays included.

This file imports no JAX.
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.color import srgb
from optrace_tpu_torch.ops import sampling
from optrace_tpu_torch.ops.cuda_sampling import (primary_lut, srgb_wavelengths,
                                                 srgb_wavelengths_reference)
from optrace_tpu_torch.ops.interp import invert_cdf_uniform, uniform_interp
from optrace_tpu_torch.parallel import graph as graph_mod
from optrace_tpu_torch.utils import tracing

go = otp.global_options
ROOT = pathlib.Path(__file__).resolve().parent.parent
RANGES = {"visible": [380.0, 780.0], "wide": [350.0, 900.0]}
N = 6000
BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def scan_route(rgb, choice, u):
    """The plain route as it was with PyTorch's scan over the three
    channels: the yardstick of the written-out sums."""
    rgbl = srgb.srgb_to_srgb_linear(rgb)
    factors, lookups, _, _ = srgb._primary_lookups(tuple(go.wavelength_range), rgbl.device,
                                                   rgbl.dtype, u.dtype)
    csum = torch.cumsum(rgbl * factors, dim=-1)
    last = csum[:, -1:]
    csum = csum / torch.where(last > 0, last, 1.0)
    make_r = choice < csum[:, 0]
    make_b = choice > csum[:, 1]
    wl_r, wl_g, wl_b = (lookup(u) for lookup in lookups)
    return torch.where(make_r, wl_r, torch.where(make_b, wl_b, wl_g))


def _pixels(case: str) -> np.ndarray:
    rng = np.random.default_rng(sorted(CASES).index(case) + 31)
    if case == "random":
        return rng.uniform(0.0, 1.0, (N, 3))
    if case == "black":
        rgb = rng.uniform(0.0, 1.0, (N, 3))
        rgb[::2] = 0.0
        rgb[1::4] = [-0.0, 0.0, -0.0]
        return rgb
    if case == "primaries":
        base = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1], [1, 1, 0], [0, 1, 1],
                         [1, 0, 1], [0.5, 0, 0], [0, 0, 0.2]], dtype=np.float64)
        return np.tile(base, (N // len(base) + 1, 1))[:N]
    if case == "outside":       # the gamma's odd extension, and sums at or below 0
        return rng.uniform(-0.6, 1.6, (N, 3))
    if case == "threshold":     # either side of the gamma's 0.04045 in f32
        t = np.float32(0.04045)
        vals = np.array([np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1)),
                         -t, 0.0, 1.0, 0.5], dtype=np.float32)
        return rng.choice(vals, (N, 3))
    raise KeyError(case)


CASES = ("random", "black", "primaries", "outside", "threshold")


def case_inputs(case: str, device="cpu"):
    """(rgb (N, 3), choice, u) f32 for a case, the uniforms stratified with
    a few set to 0 and just below 1 in every pairing."""
    rgb = torch.as_tensor(_pixels(case), dtype=torch.float32)
    g = torch.Generator().manual_seed(sorted(CASES).index(case))
    choice = sampling.stratified_interval_sampling(g, N, 0.0, 1.0)
    u = sampling.stratified_interval_sampling(g, N, 0.0, 1.0)
    ends = torch.tensor([0.0, BELOW_ONE])
    choice[:4], u[:4] = ends.repeat_interleave(2), ends.repeat(2)
    return tuple(t.to(device) for t in (rgb, choice, u))


@contextlib.contextmanager
def wavelength_range(rng):
    before = list(go.wavelength_range)
    go.wavelength_range = rng
    try:
        yield
    finally:
        go.wavelength_range = before


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                                     b.view(torch.int32))


# ---- on the CPU ---------------------------------------------------------

@pytest.mark.parametrize("rng", sorted(RANGES))
@pytest.mark.parametrize("case", CASES)
def test_written_out_sums_equal_the_scan(case, rng):
    rgb, choice, u = case_inputs(case)
    with wavelength_range(RANGES[rng]):
        wl = srgb.wavelengths_from_srgb(rgb, choice, u)
        assert same_bits(wl, scan_route(rgb, choice, u))
    lo, hi = RANGES[rng]
    assert bool(torch.isfinite(wl).all()) and lo <= float(wl.min()) <= float(wl.max()) <= hi


def test_inverse_cdf_tables_are_those_of_the_lookups():
    """``inverse_cdf`` is ``uniform_interp`` through the table of
    ``inverse_cdf_table``, as it was; the primaries' (3, M) tables are the
    tables of the plain route's three lookups."""
    x = np.linspace(380.0, 780.0, 401)
    f = np.exp(-0.5 * ((x - 550.0) / 40.0) ** 2)
    u = torch.rand(5000, generator=torch.Generator().manual_seed(3))
    u[:3] = torch.tensor([0.0, BELOW_ONE, 1.0])
    table = torch.as_tensor(invert_cdf_uniform(x, sampling.cdf_from_pdf(x, f), 4096),
                            dtype=torch.float32)
    before = uniform_interp(u, table, 0.0, 1.0 / 4095, left=380.0, right=780.0)
    assert same_bits(sampling.inverse_cdf(x, f, "cpu")(u), before)
    factors, lookups, tables, (left, right) = srgb._primary_lookups(
        tuple(go.wavelength_range), torch.device("cpu"), torch.float32, torch.float32)
    assert tables.shape == (3, 4096) and (left, right) == tuple(go.wavelength_range)
    for lookup, t in zip(lookups, tables):
        assert same_bits(lookup(u), uniform_interp(u, t, 0.0, 1.0 / 4095, left=left, right=right))
    lut = primary_lut("cpu")
    assert lut[0] is factors and lut[1] is tables and lut[2:] == (left, right)


def test_primary_lut_refuses_a_range_without_the_visible_band(monkeypatch):
    """The plain route's check, made when a sampler is built (the option's
    setter refuses such a range already: set past it)."""
    monkeypatch.setattr(go, "_wavelength_range", [400.0, 700.0])
    with pytest.raises(RuntimeError, match="Wavelength range"):
        primary_lut("cpu")


def image_source(**kw):
    rng = np.random.default_rng(5)
    img = otp.RGBImage(rng.uniform(0.0, 1.0, (12, 18, 3)), s=[3.0, 2.0])
    return otp.RaySource(img, pos=[0, 0, 0], divergence="Lambertian", div_angle=2, **kw)


def test_cpu_sampler_of_an_image_source_draws_the_rays_of_the_scan(monkeypatch):
    """An RGB image source's sampler on the CPU keeps the plain route: with
    a fixed generator it draws the rays the scan drew, every stream after
    the wavelengths included, and launches nothing."""
    src = image_source()
    before = srgb_wavelengths.launches
    new = src.create_rays(torch.Generator().manual_seed(11), 5000)
    gen = torch.Generator().manual_seed(11)
    monkeypatch.setattr(srgb, "wavelengths_from_srgb", scan_route)
    old = src.create_rays(gen, 5000)
    assert srgb_wavelengths.launches == before
    for a, b in zip(new, old):
        assert same_bits(a, b)
    # the generator advanced as far in both
    g2 = torch.Generator().manual_seed(11)
    src.create_rays(g2, 5000)
    assert torch.equal(g2.get_state(), gen.get_state())


def test_the_kernel_wrapper_is_counted_by_captured_steps():
    assert (srgb_wavelengths, "launches") in tracing.counts()
    srgb_wavelengths.launches += 3
    tracing.reset_counts()
    assert srgb_wavelengths.launches == 0


def _wrapper_args(device="cpu", **change):
    n = 64
    args = dict(P=torch.zeros(n, dtype=torch.int64), choice=torch.zeros(n), u=torch.zeros(n),
                pix=torch.zeros((5, 3)))
    args.update(change)
    lut = primary_lut(device)
    return [t.to(device) for t in args.values()] + [lut]


BAD = {"choice_short": (dict(choice=torch.zeros(63)), ValueError, "choice"),
       "u_2d": (dict(u=torch.zeros((64, 1))), ValueError, "u must have shape"),
       "P_int32": (dict(P=torch.zeros(64, dtype=torch.int32)), TypeError, "P must be torch.int64"),
       "P_2d": (dict(P=torch.zeros((64, 1), dtype=torch.int64)), ValueError, "P must be"),
       "u_f64": (dict(u=torch.zeros(64, dtype=torch.float64)), TypeError, "u must be torch.float32"),
       "pix_rgba": (dict(pix=torch.zeros((5, 4))), ValueError, "pix must have shape"),
       "pix_flat": (dict(pix=torch.zeros(15)), ValueError, "pix must be"),
       "on_the_cpu": (dict(), ValueError, "CUDA tensors only")}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    change, err, match = BAD[bad]
    before = srgb_wavelengths.launches
    with pytest.raises(err, match=match):
        srgb_wavelengths(*_wrapper_args(**change))
    assert srgb_wavelengths.launches == before


def test_the_wrapper_refuses_bad_tables():
    P, choice, u, pix, (factors, tables, left, right) = _wrapper_args()
    with pytest.raises(ValueError, match="tables must be"):
        srgb_wavelengths(P, choice, u, pix, (factors, tables[:, :1], left, right))
    with pytest.raises(ValueError, match="factors must have shape"):
        srgb_wavelengths(P, choice, u, pix, (factors[:2], tables, left, right))


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sRGB wavelength kernel has no CPU route)")
    return torch.device("cuda", torch.cuda.current_device())    # as a generator names it


def eye_chart() -> np.ndarray:
    """The Arizona eye cell's ColorChecker chart: 24 patches of 16² pixels,
    (64 · 96, 3) sRGB in [0, 1]."""
    rows = np.loadtxt(ROOT / "benchmark" / "data" / "colorchecker_srgb.csv", delimiter=",",
                      comments="#", skiprows=2, usecols=(1, 2, 3)) / 255.0
    img = np.repeat(np.repeat(rows.reshape(4, 6, 3), 16, axis=0), 16, axis=1)
    return img.reshape(-1, 3)


def boundary_choices(rgb):
    """``choice`` on the plain route's own boundaries between the primaries
    (c0 / c2 or c1 / c2, as the plain route computes them on the card) or
    one f32 step either side, so that a bit of difference in the gamma, the
    factors or the sums picks another primary."""
    rgbl = srgb.srgb_to_srgb_linear(rgb)
    r, g, b = (rgbl * primary_lut(rgb.device)[0]).unbind(-1)
    c1 = r + g
    last = torch.where(c1 + b > 0, c1 + b, 1.0)
    q = torch.stack([r / last, c1 / last], dim=-1)
    gen = torch.Generator().manual_seed(8)
    q = q[torch.arange(rgb.shape[0]), torch.randint(0, 2, (rgb.shape[0],), generator=gen).to(rgb.device)]
    step = torch.randint(-1, 2, (rgb.shape[0],), generator=gen).to(rgb.device)
    q = torch.where(step == 0, q, torch.nextafter(q, q + step))
    return torch.clamp(q, 0.0, BELOW_ONE)


def card_inputs(case, card):
    """(P, choice, u, pix) on the card: the case's colours as a table
    gathered at a shuffled index, or the chart at the sampler's own
    pixels."""
    if case == "chart":
        src = otp.RaySource(otp.RGBImage(eye_chart().reshape(64, 96, 3), s=[46.8, 31.2]))
        g = torch.Generator(device=card).manual_seed(2024)
        P = src.image_pixels(sampling.stratified_interval_sampling(g, 10 ** 6, 0.0, 1.0))
        choice = sampling.stratified_interval_sampling(g, 10 ** 6, 0.0, 1.0)
        u = sampling.stratified_interval_sampling(g, 10 ** 6, 0.0, 1.0)
        pix = torch.as_tensor(eye_chart(), dtype=torch.float32, device=card)
        return P, choice, u, pix
    if case == "boundary":
        rgb, _, u = case_inputs("outside", card)
        rgb[:N // 4] = case_inputs("threshold", card)[0][:N // 4]
        choice = boundary_choices(rgb)
    else:
        rgb, choice, u = case_inputs(case, card)
    P = torch.randperm(N, generator=torch.Generator().manual_seed(9)).to(card)
    pix = torch.empty_like(rgb)
    pix[P] = rgb            # the gather at P gives the case's colours in their order
    return P, choice, u, pix


@pytest.mark.cuda
@pytest.mark.parametrize("rng", sorted(RANGES))
@pytest.mark.parametrize("case", CASES + ("chart", "boundary"))
def test_kernel_equals_the_plain_route_on_the_card(card, case, rng):
    P, choice, u, pix = card_inputs(case, card)
    with wavelength_range(RANGES[rng]):
        before = srgb_wavelengths.launches
        wl = srgb_wavelengths(P, choice, u, pix, primary_lut(card))
        assert srgb_wavelengths.launches == before + 1
        ref = srgb_wavelengths_reference(P, choice, u, pix)
        torch.cuda.synchronize()
    assert same_bits(wl, ref), int((wl != ref).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ("chart", "boundary"))
def test_written_out_sums_equal_the_scan_on_the_card(card, case):
    P, choice, u, pix = card_inputs(case, card)
    assert same_bits(srgb.wavelengths_from_srgb(pix[P], choice, u), scan_route(pix[P], choice, u))


def image_scene(device):
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -5, 40], no_pol=True, device=device)
    RT.add(otp.RaySource(otp.RGBImage(eye_chart().reshape(64, 96, 3), s=[1.5, 1.0]),
                         pos=[0, 0, 0], divergence="Lambertian", div_angle=3))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                    n=otp.RefractionIndex("Constant", n=1.5), pos=[0, 0, 10], d=1.5))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    return RT


@pytest.mark.cuda
def test_captured_render_batch_of_an_image_source_equals_its_eager_batch(card):
    """Calls 1 (eager), 2 (capture and replay) and 3 to 5 (replays) of the
    render step against the eager step on the same generators: the images
    and the generators' advance bit for bit, one launch of the kernel a
    batch."""
    from optrace_tpu_torch.parallel.render import _eager_fused_render, make_fused_render_multi
    n, cfg = 2 ** 16, [dict(extent=[-2.0, 2.0, -2.0, 2.0], Nx=63, Ny=63)]
    with go.no_warnings(), go.no_progress_bar(), torch.no_grad():
        step, _ = make_fused_render_multi(image_scene(card), n, cfg, device=card)
        eager, _ = _eager_fused_render(image_scene(card), n, cfg, device=card)
        assert isinstance(step, graph_mod.CapturedStep)
        for call in range(5):
            g1 = torch.Generator(device=card).manual_seed(100 + call)
            g2 = torch.Generator(device=card).manual_seed(100 + call)
            before = srgb_wavelengths.launches
            (img, ), infos = step(g1)
            torch.cuda.synchronize()
            assert srgb_wavelengths.launches == before + 1, call
            (img_e, ), infos_e = eager(g2)
            assert same_bits(img, img_e) and torch.equal(infos, infos_e), call
            assert torch.equal(g1.get_state(), g2.get_state())
            assert float(img[..., 3].sum()) > 0
        assert step.graph is not None
        assert step.captured_launches[(srgb_wavelengths, "launches")] == 1
