"""The stored sections that ``Raytracer.trace`` keeps on its device.

``_hit_detector`` and ``_hit_source`` read the f32 tensors that the ray
storage keeps and cast them to f64; a storage filled with host arrays holds
exact f64 images of the same f32 values, so both ways give the same hits bit
for bit. The tensors go with ``clear()``, with the next trace and when the
storage is filled by other means; after a scene change (which still raises
"Please retrace first") they stay, the storage's copy of the old trace.
"""

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp

from tests.test_torch_scenes import build_asphere
from tests.test_torch_steps import steps_scene

N = 5000


@pytest.fixture()
def traced():
    RT = build_asphere(otp, device="cpu")
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(N)
    return RT


def _host_storage(RT):
    """Fill the storage with its own host arrays, as user code may: the
    sections are then uploaded from the host."""
    r = RT.rays
    r._lock = False
    r.fill(r.p_list, r.w_list, r.pol_list, r.n_list, r.wl_list, r.s0_list)
    r.lock()
    RT._last_trace_snapshot = RT.tracing_snapshot()
    assert r._dev is None


def _hits(RT, **kw):
    with otp.global_options.no_progress_bar():
        ph, w, wl, extent, proj, _, ill = RT._hit_detector("t", **kw)
    return ph, w, wl, extent, proj, ill


def test_kept_tensors_are_the_trace(traced):
    RT = traced
    p, w, wl = (RT.rays._dev[k] for k in ("p", "w", "wl"))
    assert RT.rays._host == {}          # nothing made on the host yet
    assert p.dtype == w.dtype == wl.dtype == torch.float32 and p.device == RT.device
    assert p.shape == (N, RT.rays.Nt, 3) and w.shape == (N, RT.rays.Nt) and wl.shape == (N,)
    assert np.array_equal(p.double().numpy(), RT.rays.p_list)
    assert np.array_equal(w.numpy(), RT.rays.w_list) and np.array_equal(wl.numpy(), RT.rays.wl_list)


@pytest.mark.parametrize("kw", [dict(), dict(extent=[-1.0, 1.0, -0.5, 0.5]), dict(source_index=0)])
def test_hits_from_kept_tensors_equal_the_host_path(traced, kw):
    RT = traced
    a = _hits(RT, **kw)
    assert RT.rays._dev is not None
    _host_storage(RT)               # now the sections are uploaded from the host storage
    b = _hits(RT, **kw)
    assert RT.rays._dev is None
    for x, y in zip(a[:3], b[:3]):
        assert isinstance(x, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
    assert a[0].dtype == torch.float64 and a[2].dtype == torch.float32 and len(a[0]) > 100
    assert np.array_equal(a[3], b[3]) and a[4] == b[4] and a[5] == b[5]


def test_images_and_spectra_equal_both_ways(traced):
    RT = traced
    with otp.global_options.no_progress_bar():
        a = (RT.detector_image(), RT.source_image(), RT.detector_spectrum(), RT.source_spectrum())
        _host_storage(RT)
        b = (RT.detector_image(), RT.source_image(), RT.detector_spectrum(), RT.source_spectrum())
    assert np.array_equal(a[0].data, b[0].data) and np.array_equal(a[0].extent, b[0].extent)
    assert np.array_equal(a[1].data, b[1].data)
    for sa, sb in zip(a[2:], b[2:]):
        assert np.array_equal(sa._vals, sb._vals) and np.array_equal(sa._wls, sb._wls)


def test_automatic_extent_is_the_hits_bounding_box(traced):
    ph, _, _, extent, _, _ = _hits(traced)
    ph = ph.numpy()
    assert extent.dtype == np.float64
    assert extent.tolist() == [ph[:, 0].min(), ph[:, 0].max(), ph[:, 1].min(), ph[:, 1].max()]


@pytest.mark.parametrize("how", ["clear", "retrace", "scene_change", "refill"])
def test_tensors_are_dropped(traced, how):
    RT = traced
    go = otp.global_options
    old = RT.rays._dev
    if how == "clear":
        RT.clear()
        assert RT.rays._dev is None and RT.rays.N == 0
    elif how == "retrace":
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(N // 2)
        assert RT.rays._dev["p"] is not old["p"] and RT.rays._dev["p"].shape[0] == N // 2
        assert RT.rays._host == {}
    elif how == "scene_change":
        RT.lenses[0].move_to([0, 0, 0.1])
        with pytest.raises(RuntimeError, match="Please retrace first"), go.no_progress_bar():
            RT.detector_image()
        # the storage's only copy of the old trace: still read through RT.rays
        assert RT.rays._dev is old and RT.rays.p_list.shape[0] == N
        with pytest.raises(RuntimeError, match="Please retrace first"), go.no_progress_bar():
            RT.source_image()
    else:
        # the host storage filled by other means: the kept tensors are of
        # another array and are not read
        before = _hits(RT)[0]
        r = RT.rays
        p2 = r.p_list.copy()
        p2[:, -1, 0] += 0.25
        r._lock = False
        r.fill(p2, r.w_list, None, r.n_list, r.wl_list, r.s0_list)
        r.lock()
        RT._last_trace_snapshot = RT.tracing_snapshot()
        ph = _hits(RT)[0]
        assert RT.rays._dev is None
        # the detector lies on the last segment, whose end moved: the hits moved with it
        assert float(ph[:, 0].mean() - before[:, 0].mean()) > 0.05
        assert abs(float(ph[:, 1].mean() - before[:, 1].mean())) < 0.01


def test_a_changed_filter_rebuilds_the_steps():
    """The kept step list is keyed by the filters too: another spectrum
    gives new steps and new plans, and the trace shows it."""
    RT = steps_scene(otp, no_pol=True, device="cpu")
    go = otp.global_options
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(2000)
        steps, plans = RT._trace_entry(2000).program[:2]
        assert RT._trace_entry(2000).program.steps is steps
        p_before = RT.detector_image().power()
        RT.filters[0].spectrum = otp.TransmissionSpectrum("Constant", val=0.25)
        with pytest.raises(RuntimeError, match="Please retrace first"):
            RT.detector_image()
        steps2, plans2 = RT._trace_entry(2000).program[:2]
        assert steps2 is not steps and plans2 is not plans
        assert steps2[4].spectrum_fn is RT.filters[0].spectrum
        RT.trace(2000)
        p_after = RT.detector_image().power()
        assert p_after < 0.85 * p_before, (p_after, p_before)


def test_change_detection_does_not_hash_the_sections(traced):
    """The stored arrays are read-only and stand in the snapshot by the
    number of their fill: a refill is another state, an array made writeable
    again is hashed by its content, and the snapshot of 5000 rays × 8
    sections is made without a copy of them (``tobytes``)."""
    RT = traced
    r = RT.rays
    for name in r._ARRAYS:
        assert not getattr(r, name).flags.writeable, name
    with pytest.raises(ValueError):
        r.p_list[0, 0, 0] = 1.0
    a = r.crepr()
    assert a == r.crepr() and RT.check_if_rays_are_current()
    fill_entries = [v for k, v in a[1:] if k in r._ARRAYS]
    assert all(v[2] == r._fill_id for v in fill_entries) and len(fill_entries) == 6
    # a refill with equal content is another fill
    r._lock = False
    r.fill(r.p_list, r.w_list, None, r.n_list, r.wl_list, r.s0_list)
    r.lock()
    assert r.crepr() != a and not RT.check_if_rays_are_current()
    # a writeable array is hashed by content again
    b = r.crepr()
    w2 = np.array(r.w_list)
    object.__setattr__(r, "w_list", w2)
    c = r.crepr()
    w2[0, 0] += 1.0
    assert c != b and r.crepr() != c
    # another storage never shares a fill number
    RT2 = build_asphere(otp, device="cpu")
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT2.trace(100)
    assert RT2.rays._fill_id > r._fill_id
