"""The program's spans (``optrace_tpu_torch/utils/tracing.py``) on the CPU.

- Off, with no profiler recording: ``span`` and ``device_interval`` return
  the one shared no-op, and a trace, its read path and a render record
  nothing.
- On, under ``torch.profiler`` with the CPU activity: ``trace`` →
  ``detector_image`` → ``get`` of the double Gauss and a ``render_huge`` of
  two batches through one lens record each span of their layers, under the
  right parents, with one root a call, self times that part each span's
  duration, and the same names as ``optrace:`` labels in the profile.
- The spans change nothing that the program returns, bit for bit.
- A ``CapturedStep`` (with the stand-in graph of ``test_torch_graph_step.py``)
  records its eager call, its capture and each replay.
- The record stops at its cap and counts what it drops.
- A device interval on the CPU records nothing.
"""

import numpy as np
import pytest
import torch
from torch.profiler import profile, ProfilerActivity

import optrace_tpu_torch as otp
from optrace_tpu_torch.parallel import render as render_mod
from optrace_tpu_torch.parallel.checkpoint import batch_generator
from optrace_tpu_torch.parallel.graph import CapturedStep
from optrace_tpu_torch.presets.geometry import double_gauss
from optrace_tpu_torch.utils import tracing

from test_torch_graph_step import lens_rt, stand_in  # noqa: F401  (a fixture)

RAYS = 10000
SECTIONS = ("p_list", "w_list", "pol_list", "n_list", "wl_list")
TRACE_STAGES = ("trace.prepare", "trace.run", "trace.fill", "trace.infos_wait", "trace.messages")
RENDER_STAGES = ("render_huge.build", "render_huge.batch", "render_huge.accumulate", "render_huge.finish")


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.reset()
    yield
    tracing.reset()


def _raytracer():
    RT = otp.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], device="cpu")
    RT.add(otp.RaySource(otp.Point(), divergence="Isotropic", orientation="Converging",
                         conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                         spectrum=otp.LightSpectrum("Constant")))
    RT.add(double_gauss())
    return RT


def _round_trip(RT):
    """A GUI's round trip: the trace, its detector image and the image's sRGB."""
    with otp.global_options.no_progress_bar(), otp.global_options.no_warnings():
        RT.trace(RAYS)
        img = RT.detector_image()
        return img, img.get("sRGB (Absolute RI)", 315)


def _render(RT):
    """``render_huge`` of two batches: ``RT`` is the one-lens scene, whose few
    operations keep the profile short."""
    with otp.global_options.no_progress_bar(), otp.global_options.no_warnings():
        return RT.render_huge(2 * RAYS, batch_size=RAYS, extent=[-2.0, 2.0, -2.0, 2.0])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(spans, name):
    return [(i, s) for i, s in enumerate(spans) if s is not None and s.name == name]


def test_off_records_nothing():
    assert tracing.span("trace") is tracing.span("get") is tracing.device_interval("x", "cpu")
    _round_trip(_raytracer())
    _render(lens_rt())
    assert tracing.records() == [] and tracing.summary() == {} and tracing.dropped() == 0


def test_on_records_each_span_under_its_parent():
    RT = _raytracer()
    with _cpu_profile() as prof:
        _round_trip(RT)
    spans = tracing.records()
    assert None not in spans
    [(t, trace)] = _named(spans, "trace")
    assert trace.parent is None and trace.root == t
    for name in TRACE_STAGES:
        [(_, s)] = _named(spans, name)
        assert s.parent == t
    [(run, _)] = _named(spans, "trace.run")
    [(_, sampling)] = _named(spans, "sampling")
    assert sampling.parent == run
    for name in ("trace_bundle.run", "trace_bundle.step", "trace_bundle.media"):
        assert _named(spans, name) and all(s.parent == run for _, s in _named(spans, name))
    [(d, image)] = _named(spans, "detector_image")
    assert image.parent is None and image.root == d
    for name in ("detector_image.hits", "detector_image.bin"):
        [(_, s)] = _named(spans, name)
        assert s.parent == d
    [(g, get)] = _named(spans, "get")
    assert get.parent is None and get.root == g
    # one root a call
    assert {s.root for s in spans} == {t, d, g}
    assert all(spans[s.root].parent is None for s in spans)

    # self time: a span's duration less its children's
    children = [s for s in spans if s.parent == t]
    own = (trace.t1_ns - trace.t0_ns) - sum(s.t1_ns - s.t0_ns for s in children)
    summary = tracing.summary()
    assert summary["trace"]["self_s"] == pytest.approx(own * 1e-9, abs=1e-12)
    assert all(v["self_s"] >= 0 and v["total_s"] >= v["self_s"] for v in summary.values())
    assert summary["trace"]["count"] == summary["get"]["count"] == 1

    labels = {e.name for e in prof.events()}
    assert {"optrace:" + name for name in summary} <= labels


def test_on_records_the_render_and_its_captured_step(stand_in, monkeypatch):  # noqa: F811
    """``render_huge`` of two batches, its step a ``CapturedStep`` on the
    stand-in graph: the first batch eager, the second captured."""
    def captured(fn, device, scene=None, batches=None, eager_calls=1, name="render step"):
        return stand_in(fn, scene)
    monkeypatch.setattr(render_mod, "capture", captured)
    with _cpu_profile() as prof:
        _render(lens_rt())
    spans = tracing.records()
    [(r, render)] = _named(spans, "render_huge")
    assert render.parent is None and all(s.root == r for s in spans)
    for name in ("render_huge.build", "render_huge.finish"):
        [(_, s)] = _named(spans, name)
        assert s.parent == r
    batches = _named(spans, "render_huge.batch")
    assert len(batches) == 2 == len(_named(spans, "render_huge.accumulate"))
    [(_, eager)], [(_, capture)] = _named(spans, "graph.eager"), _named(spans, "graph.capture")
    assert (eager.parent, capture.parent) == (batches[0][0], batches[1][0])
    assert _named(spans, "sampling") and not _named(spans, "graph.replay")
    labels = {e.name for e in prof.events()}
    assert {"optrace:" + n for n in RENDER_STAGES + ("graph.eager", "graph.capture", "sampling")} <= labels


def test_spans_change_no_output():
    outs = []
    for on in (False, True):
        RT = _raytracer()
        if on:
            with _cpu_profile():
                img, rgb = _round_trip(RT)
                render = _render(lens_rt())
            assert tracing.records()
        else:
            img, rgb = _round_trip(RT)
            render = _render(lens_rt())
        sections = [np.array(getattr(RT.rays, k)) for k in SECTIONS]
        outs.append(sections + [np.array(RT._msgs), img.data, np.array(rgb.data), render.data])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_captured_step_records_eager_capture_and_replays(stand_in):  # noqa: F811
    step = stand_in(lambda gen: ([torch.rand(3, generator=gen)], torch.zeros(2)))
    with _cpu_profile():
        for b in range(4):
            step(batch_generator(0, b, "cpu"))
    assert isinstance(step, CapturedStep) and step.graph is not None
    names = [s.name for s in tracing.records()]
    assert names == ["graph.eager", "graph.capture", "graph.replay", "graph.replay"]


def test_the_record_stops_at_its_cap(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 5)
    with _cpu_profile() as prof:
        with tracing.span("outer"):
            for _ in range(7):
                with tracing.span("inner"):
                    pass
    spans = tracing.records()
    assert len(spans) == 5 and tracing.dropped() == 3
    assert all(s.parent == 0 for s in spans[1:])
    # the dropped spans are labels in the profile all the same
    assert sum(e.name == "optrace:inner" for e in prof.events()) == 7
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_device_interval_on_the_cpu_records_nothing():
    with _cpu_profile():
        with tracing.device_interval("render.sampling", "cpu"):
            torch.ones(4).sum()
    assert tracing.device_ms("render.sampling") is None and tracing.records() == []
