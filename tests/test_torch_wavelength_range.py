"""The trace cache and ``global_options.wavelength_range``.

The sources' samplers read the wavelength range when they are built: a
``"Constant"`` spectrum draws over it. The trace entry of a raytracer is
therefore keyed on the range too (``Raytracer._trace_entry``): after the
range changes, the same raytracer's next trace equals a fresh raytracer's
trace at the same seed counter, bit for bit, and going back to the old
range is a cache hit. The JAX package keys its trace on the scene alone and
keeps drawing the old range, so the reference here is a fresh raytracer of
the port, not the JAX package. This file imports no JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer.raytracer import MAX_GRAPHED_TRACES, TRACE_CAPTURE_CALL

from test_torch_trace_graph import graphed  # noqa: F401 (a fixture)

N = 4000
go = otp.global_options
OLD, NEW = [380.0, 780.0], [300.0, 900.0]


def build():
    RT = otp.Raytracer(outline=[-10, 10, -10, 10, -10, 60], device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), divergence="Lambertian", div_angle=4,
                         pos=[0, 0, -5], spectrum=otp.LightSpectrum("Constant")))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-25),
                    n=otp.presets.refraction_index.BK7, pos=[0, 0, 0], d=1.0))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[12, 12]), pos=[0, 0, 30]))
    return RT


@contextlib.contextmanager
def wavelength_range(rng):
    """``global_options.wavelength_range`` set to ``rng`` and restored after."""
    before = list(go.wavelength_range)
    go.wavelength_range = rng
    try:
        yield
    finally:
        go.wavelength_range = before


def trace(RT, seed=None):
    """``RT.trace(N)`` at the seed counter ``seed`` (the raytracer's own
    where not given); returns the seed counter it traced at."""
    if seed is not None:
        RT._seed_counter = seed
    seed = RT._seed_counter
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(N)
    return seed


def sections(RT):
    return {k: None if t is None else t.clone() for k, t in RT.rays._dev.items()}, RT._msgs.copy()


def assert_same_bits(a, b):
    (da, ma), (db, mb) = a, b
    assert da.keys() == db.keys()
    for k in da:
        assert (da[k] is None) == (db[k] is None), k
        if da[k] is not None:
            assert da[k].dtype == db[k].dtype and torch.equal(da[k], db[k]), k
    assert np.array_equal(ma, mb)


def fresh_trace(seed):
    RT = build()
    trace(RT, seed)
    return sections(RT)


def test_a_changed_range_misses_and_the_old_range_hits_again():
    RT = build()
    s_old = trace(RT)
    first = sections(RT)
    entry_old = RT._trace_entry(N)
    wl = first[0]["wl"]
    assert OLD[0] <= float(wl.min()) and float(wl.max()) <= OLD[1]
    with wavelength_range(NEW):
        s_new = trace(RT)
        assert RT._trace_entry(N) is not entry_old and len(RT._trace_cache) == 2
        after = sections(RT)
        assert_same_bits(after, fresh_trace(s_new))
        wl = after[0]["wl"]
        # 4000 stratified draws over 600 nm: the ends lie within a stratum's 0.15 nm
        assert NEW[0] <= float(wl.min()) < NEW[0] + 1 and NEW[1] - 1 < float(wl.max()) <= NEW[1]
    # back to the old range: the first entry, and the first trace's bits at its seed
    trace(RT, s_old)
    assert RT._trace_entry(N) is entry_old and len(RT._trace_cache) == 2
    assert_same_bits(sections(RT), first)


def test_render_and_trace_use_the_range_set_now():
    """After the change, a fused render built now draws the rays the stored
    trace draws at the same seed: the image's XYZW totals equal those of
    ``detector_image`` of the trace (every ray lands inside the detector;
    the render bins in f32, the trace's hits are found in f64), and both
    equal a fresh raytracer's. The totals at the old range differ by far
    more than the tolerance, since 200 of the 600 nm draw no colour."""
    RT = build()
    trace(RT)
    old_totals = RT.detector_image().data.reshape(-1, 4).sum(axis=0)
    with wavelength_range(NEW):
        seed = trace(RT)
        img = RT.detector_image()
        totals = img.data.reshape(-1, 4).sum(axis=0)
        render, _ = otp.make_fused_render(RT, N, Nx=img.shape[1], Ny=img.shape[0], device="cpu")
        tile = render(otp.make_generator(seed + 1, "cpu"))     # trace seeds with the counter + 1
        np.testing.assert_allclose(tile.reshape(-1, 4).sum(dim=0).numpy(), totals, rtol=1e-5)
        RT2 = build()
        render2, _ = otp.make_fused_render(RT2, N, Nx=img.shape[1], Ny=img.shape[0], device="cpu")
        assert torch.equal(render2(otp.make_generator(seed + 1, "cpu")), tile)
        assert_same_bits(sections(RT), fresh_trace(seed))
    assert abs(totals[1] / totals[3] - old_totals[1] / old_totals[3]) > 0.1 * old_totals[1] / old_totals[3]
    assert list(go.wavelength_range) == OLD



def test_a_graphed_key_does_not_replay_across_a_change(graphed):
    """With traces captured as on a CUDA device (the stand-in graph of
    ``tests/test_torch_trace_graph.py``): seven traces at the old range
    (five eager, the capture, a replay); at the new range a new entry that
    traces eagerly what a fresh raytracer traces, and captures at its own
    sixth call; back at the old range the old graph replays. Both graphs
    are held (``MAX_GRAPHED_TRACES`` = 2)."""
    RT = build()
    for _ in range(TRACE_CAPTURE_CALL + 1):
        trace(RT)
    old = RT._trace_entry(N)
    assert old.graphed and old.run.graph is not None
    with wavelength_range(NEW):
        seed = trace(RT)
        new = RT._trace_entry(N)
        assert new is not old and new.run.graph is None and old.run.graph is not None
        assert_same_bits(sections(RT), fresh_trace(seed))
        for _ in range(TRACE_CAPTURE_CALL - 1):
            seed = trace(RT)
        assert new.run.graph is not None
        assert_same_bits(sections(RT), fresh_trace(seed))
    seed = trace(RT)
    assert RT._trace_entry(N) is old and old.run.graph is not None and new.run.graph is not None
    assert_same_bits(sections(RT), fresh_trace(seed))
    assert TRACE_CAPTURE_CALL == 6 and MAX_GRAPHED_TRACES == 2
