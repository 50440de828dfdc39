"""The stored trace on the device and the trace cache.

``Raytracer.trace`` leaves its sections on the device in ``RayStorage``,
which makes each public array on the host at its first read, bit for bit
what the eager fill (a ``.cpu()`` copy of the same tensors, ``s0`` from the
f32 positions on the host) made, and whose selective reads copy only what
they return. The change detection and the outputs of a stored trace make no
host array. The trace keeps its steps, prepared runs and sources' samplers
in a cache of 32 entries per (scene, N), whose hits trace bit for bit what
a fresh raytracer traces at the same seed counter. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer.ray_storage import RayStorage
from optrace_tpu_torch.tracer.raytracer import TRACE_CACHE_SIZE

N = 4000
go = otp.global_options


def build(no_pol=False, lens=None):
    RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 60], no_pol=no_pol, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.5), divergence="Lambertian", div_angle=6,
                         pos=[0, 0, -5], spectrum=otp.presets.light_spectrum.d65, power=2.0))
    RT.add(otp.RaySource(otp.RectangularSurface(dim=[2.0, 1.0]), divergence="None", pos=[0.5, 0, -4],
                         spectrum=otp.LightSpectrum("Gaussian", mu=620.0, sig=15.0), power=1.0))
    RT.add(lens if lens is not None else _lens())
    RT.add(otp.Aperture(otp.RingSurface(r=3, ri=0.9), pos=[0, 0, 5]))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[8, 8]), pos=[0, 0, 30]))
    return RT


def _lens(R2=-25.0):
    return otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=R2),
                    n=otp.presets.refraction_index.BK7, pos=[0, 0, 0], d=1.0)


def _trace(RT, n=N):
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(n)
    return RT


def eager_storage(RT):
    """The storage as the trace filled it before its sections stayed on
    the device: host copies of the same tensors, ``s0`` made on the host
    from the f32 positions."""
    r, d = RT.rays, RT.rays._dev
    p = d["p"].cpu().numpy()
    s0 = p[:, 1] - p[:, 0]
    norm = np.linalg.norm(s0, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        s0 = np.where(norm > 0, s0 / norm, s0)
    e = RayStorage()
    e.init(r.ray_source_list, r.N, r.Nt, r.no_pol)
    pol = None if d["pol"] is None else d["pol"].cpu().numpy()
    e.fill(p, d["w"].cpu().numpy(), pol, d["n"].cpu().numpy(), d["wl"].cpu().numpy(), s0)
    assert np.array_equal(e.N_list, r.N_list)
    return e


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module", params=[False, True], ids=["pol", "no_pol"])
def traced(request):
    return _trace(build(no_pol=request.param))


def test_arrays_made_at_first_read_equal_the_eager_fill(traced):
    RT = traced
    eager = eager_storage(RT)
    lazy = RT.rays
    assert lazy._host == {} and lazy.N == N and lazy.Nt == eager.Nt
    for name in RayStorage._ARRAYS:
        a, b = getattr(lazy, name), getattr(eager, name)
        assert _same(a, b), name
        assert not a.flags.writeable, name
        assert getattr(lazy, name) is a         # made once
    # an eager .cpu() conversion of the same tensors
    assert np.array_equal(lazy.p_list, lazy._dev["p"].cpu().double().numpy())


@pytest.mark.parametrize("ch2", [None, 3, -1, slice(1, 4), "per_ray", [2]], ids=str)
@pytest.mark.parametrize("normalize", [True, False])
def test_selected_reads_equal_the_eager_fill(ch2, normalize):
    """``rays_by_mask`` (every return), ``ray_lengths``, ``optical_lengths``
    on a fresh trace, whose host arrays are never made."""
    RT = _trace(build(no_pol=False), 2000)
    eager = eager_storage(RT)
    rng = np.random.default_rng(1)
    ch = rng.uniform(size=RT.rays.N) < 0.3
    if ch2 == "per_ray":
        ch2 = rng.integers(0, RT.rays.Nt, int(ch.sum()))
    elif isinstance(ch2, list):
        ch2 = np.array(ch2)
    for a, b in zip(RT.rays.rays_by_mask(ch, ch2, normalize=normalize),
                    eager.rays_by_mask(ch, ch2, normalize=normalize)):
        assert _same(a, b)
    assert _same(RT.rays.ray_lengths(ch, ch2), eager.ray_lengths(ch, ch2))
    if not isinstance(ch2, slice):      # a part of the sections: lengths of all, indices of some
        assert _same(RT.rays.optical_lengths(ch, ch2), eager.optical_lengths(ch, ch2))
    assert RT.rays._host == {}


def test_source_sections_and_whole_reads_equal_the_eager_fill(traced):
    RT = _trace(build(no_pol=traced.no_pol), 2000)
    eager = eager_storage(RT)
    for index in (None, 0, 1):
        for a, b in zip(RT.rays.source_sections(index), eager.source_sections(index)):
            assert _same(a, b)
            assert not a.flags.writeable
    assert _same(RT.rays.source_numbers(), eager.source_numbers())
    assert _same(RT.rays.direction_vectors(), eager.direction_vectors())
    for a, b in zip(RT.rays.rays_by_mask(ret=[1, 0, 1, 1, 1, 1, 1]), eager.rays_by_mask(ret=[1, 0, 1, 1, 1, 1, 1])):
        assert _same(a, b)
    assert RT.rays._host == {}


def test_outputs_and_change_detection_make_no_host_array():
    """trace → detector_image → detector_spectrum → source_image →
    source_spectrum → focus_search and the snapshots read the device; a
    first read later leaves the rays current."""
    RT = _trace(build(no_pol=True))
    with go.no_warnings(), go.no_progress_bar():
        snap = RT.rays.crepr()
        RT.detector_image()
        RT.detector_spectrum()
        RT.source_image()
        RT.source_spectrum(source_index=1)
        RT.focus_search("RMS Spot Size", z_start=25.0)
        RT.focus_search("Image Sharpness", z_start=25.0)
    assert RT.rays._host == {} and RT.check_if_rays_are_current()
    p = RT.rays.p_list
    assert set(RT.rays._host) == {"p_list"}
    assert RT.rays.crepr() == snap and RT.check_if_rays_are_current()
    entries = [v for k, v in snap[1:] if k in RayStorage._ARRAYS]
    assert len(entries) == 6 and all(v[2] == RT.rays._fill_id for v in entries)
    assert dict(snap[1:])["p_list"][:2] == (p.shape, "float64")
    assert dict(snap[1:])["pol_list"][:2] == (p.shape, "float64")        # NaN under no_pol


def test_a_locked_storage_refuses_writes(traced):
    r = traced.rays
    with pytest.raises(RuntimeError, match="read-only"):
        r.p_list = np.zeros((2, 2, 3))
    with pytest.raises(RuntimeError, match="read-only"):
        r.w_list = np.zeros((2, 2))
    with pytest.raises(ValueError):
        r.w_list[0, 0] = 1.0
    assert r._dev is not None


def test_an_array_set_by_hand_ends_the_device_copy():
    """Unlocked, an array set by hand: the other arrays are made first and
    the sections are then read from the host arrays."""
    RT = _trace(build(no_pol=True), 1000)
    r = RT.rays
    w = np.array(r.w_list)
    r._lock = False
    r.w_list = w
    assert r._dev is None and set(r._host) == set(RayStorage._ARRAYS) and r.w_list is w
    assert np.array_equal(RT._sections(0, r.N)[1].numpy(), w.astype(np.float64))


def test_rays_after_iterative_render_are_the_first_batch():
    RT = build(no_pol=True)
    RT.ITER_RAYS_STEP = 2000
    RT2 = build(no_pol=True)
    RT2._seed_counter = RT._seed_counter
    with go.no_warnings(), go.no_progress_bar():
        RT.iterative_render(6000)
    _trace(RT2, 2000)
    for name in RayStorage._ARRAYS:
        assert _same(getattr(RT.rays, name), getattr(RT2.rays, name)), name


def _sections(RT):
    return {name: getattr(RT.rays, name) for name in ("p_list", "w_list", "pol_list", "wl_list", "n_list")}


def test_a_cache_hit_traces_what_a_fresh_raytracer_traces():
    """Scene A, scene B (another lens object), scene A again: a hit of A's
    entry; its trace equals a fresh raytracer's at the same seed counter."""
    lens_a, lens_b = _lens(), _lens(R2=-30.0)
    RT = build(lens=lens_a)
    _trace(RT, 1500)
    entry_a = RT._trace_entry(1500)
    RT.remove(lens_a)
    RT.add(lens_b)
    _trace(RT, 1500)
    assert RT._trace_entry(1500) is not entry_a and len(RT._trace_cache) == 2
    RT.remove(lens_b)
    RT.add(lens_a)
    seed = RT._seed_counter
    _trace(RT, 1500)
    assert RT._trace_entry(1500) is entry_a and len(RT._trace_cache) == 2
    fresh = build(lens=_lens())
    fresh._seed_counter = seed
    _trace(fresh, 1500)
    a, b = _sections(RT), _sections(fresh)
    for name in a:
        assert _same(a[name], b[name]), name
    assert np.array_equal(RT._msgs, fresh._msgs)


def test_a_changed_lens_or_source_misses_and_clear_empties():
    RT = _trace(build(no_pol=True), 1000)
    first = RT._trace_entry(1000)
    RT.lenses[0].move_to([0, 0, 0.5])
    moved = RT._trace_entry(1000)
    assert moved is not first and moved.program.steps is not first.program.steps
    RT.ray_sources[1].power = 1.5          # another share of the rays, and another source
    RT.rays.init(RT.ray_sources, 1000, RT.rays.Nt, True)
    other = RT._trace_entry(1000)
    assert other is not moved and other.program.sample is not moved.program.sample
    assert len(RT._trace_cache) == 3
    # the same snapshot with another lens object in its place: the entry is rebuilt
    RT.remove(RT.lenses[0])
    RT.add(_lens())
    RT.lenses[0].move_to([0, 0, 0.5])
    rebuilt = RT._trace_entry(1000)
    assert rebuilt is not other and rebuilt.elements[0] is RT.lenses[0] and len(RT._trace_cache) == 3
    RT.clear()
    assert len(RT._trace_cache) == 0


def test_the_33rd_key_evicts_only_the_oldest():
    RT = build(no_pol=True)
    nt = len(RT.tracing_surfaces) + 2
    keys = []
    for n in range(100, 100 + TRACE_CACHE_SIZE):
        RT.rays.init(RT.ray_sources, n, nt, True)
        RT._trace_entry(n)
        keys.append(list(RT._trace_cache)[-1])
    assert TRACE_CACHE_SIZE == 32 and list(RT._trace_cache) == keys
    # a hit refreshes its entry: the second oldest goes next
    RT.rays.init(RT.ray_sources, 100, nt, True)
    RT._trace_entry(100)
    RT.rays.init(RT.ray_sources, 500, nt, True)
    RT._trace_entry(500)
    assert len(RT._trace_cache) == 32
    assert list(RT._trace_cache) == keys[2:] + [keys[0], list(RT._trace_cache)[-1]]
