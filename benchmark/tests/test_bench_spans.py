"""The readers of the program's spans (``benchmark/metrics/``, ``"source":
"program_span"`` in ``BENCHMARK.json``) on spans planted through
``optrace_tpu_torch.utils.tracing`` itself, under the profiler and with a
clock of the test's own: each gives the value the planted spans make, and
nothing from an empty record or from a program without the module."""

import sys
import types

import pytest
from torch.profiler import profile, ProfilerActivity

import bench_common  # noqa: F401  (puts the repository on the path)
from benchmark import harness
from optrace_tpu_torch import utils
from optrace_tpu_torch.utils import tracing

SPAN_METRICS = ("raytracer.trace_host_ms", "raytracer.infos_wait_ms", "image.hits_ms", "image.bin_ms",
                "image.get_ms", "render.build_ms", "graph.warmup_ms.render", "render.accumulate_ms",
                "sampling.device_ms.render")

# one trace cell's operation: (name, ms, children)
TRACE_OP = [("trace", 7.0, [("trace.prepare", 1.0, []), ("trace.run", 2.0, [("graph.replay", 1.5, [])]),
                            ("trace.fill", 0.5, []), ("trace.infos_wait", 3.0, []),
                            ("trace.messages", 0.1, [])]),
            ("detector_image", 5.0, [("detector_image.hits", 2.0, []), ("detector_image.bin", 2.5, [])]),
            ("get", 4.0, [])]
# one render call of two batches, and a trace beside it whose eager step is
# no render's
RENDER_CALL = [("render_huge", 100.0, [
                   ("render_huge.build", 5.0, []),
                   ("render_huge.batch", 20.0, [("graph.eager", 12.0, [("sampling", 1.0, [])])]),
                   ("render_huge.accumulate", 1.0, []),
                   ("render_huge.batch", 30.0, [("graph.capture", 25.0, [])]),
                   ("render_huge.accumulate", 1.0, []),
                   ("render_huge.finish", 10.0, [])]),
               ("trace", 60.0, [("trace.run", 55.0, [("graph.eager", 50.0, [])])])]


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.reset()
    yield
    tracing.reset()


def _plant(spans, clock):
    for name, ms, children in spans:
        with tracing.span(name):
            t0 = clock[0]
            _plant(children, clock)
            clock[0] = t0 + round(ms * 1e6)


def planted(monkeypatch, spans, times=1):
    """Record ``spans`` ``times`` over through ``tracing.span``, each of the
    duration it names on a clock of the test's own."""
    clock = [0]
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=lambda: clock[0]))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(times):
            _plant(spans, clock)
    assert tracing.records() and None not in tracing.records()


def read(name, **prof):
    return harness.load_module("metrics", name).read(None, dict(dict(ops=0, batches=0), **prof))


def test_the_trace_cell_readers(monkeypatch):
    planted(monkeypatch, TRACE_OP, times=2)
    got = {name: read(name, ops=2) for name in SPAN_METRICS}
    assert got["raytracer.trace_host_ms"] == pytest.approx(4.0)
    assert got["raytracer.infos_wait_ms"] == pytest.approx(3.0)
    assert got["image.hits_ms"] == pytest.approx(2.0)
    assert got["image.bin_ms"] == pytest.approx(2.5)
    assert got["image.get_ms"] == pytest.approx(4.0)
    # the render's spans are not there
    assert [got[n] for n in ("render.build_ms", "graph.warmup_ms.render", "render.accumulate_ms",
                             "sampling.device_ms.render")] == [None] * 4


def test_the_render_cell_readers(monkeypatch):
    planted(monkeypatch, RENDER_CALL, times=2)
    prof = dict(ops=2, batches=4)
    assert read("render.build_ms", **prof) == pytest.approx(5.0)
    # the eager step of the trace beside the render is left out
    assert read("graph.warmup_ms.render", **prof) == pytest.approx(37.0)
    assert read("render.accumulate_ms", **prof) == pytest.approx(12.0)
    monkeypatch.setattr(tracing, "device_ms", lambda name: 6.5 if name == "render.sampling" else None)
    assert read("sampling.device_ms.render", **prof) == 6.5


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_an_empty_record_reads_nothing(name):
    assert tracing.records() == []
    assert read(name, ops=3, batches=3) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    """A checkout whose program has no ``utils/tracing.py`` (an earlier
    commit): the reader returns nothing and does not raise."""
    planted(monkeypatch, TRACE_OP + RENDER_CALL)
    monkeypatch.setattr(tracing, "device_ms", lambda name: 6.5)
    assert read(name, ops=3, batches=3) is not None
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "optrace_tpu_torch.utils.tracing", None)
    assert read(name, ops=3, batches=3) is None
