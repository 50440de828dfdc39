"""The reader of ``kernel1.refraction_share.render`` on planted counters, and
on a program without them."""

import sys
import types

from benchmark import harness


def read():
    return harness.load_module("metrics", "kernel1.refraction_share.render").read(
        types.SimpleNamespace(world=1), dict(ops=1, batches=20, rays=2e7))


def test_the_share_of_refractions_in_kernel_1(monkeypatch):
    from optrace_tpu_torch.ops import cuda_run
    from optrace_tpu_torch.tracer import trace_core
    monkeypatch.setattr(cuda_run.conic_run, "refractions", 80)
    monkeypatch.setattr(trace_core.trace_bundle, "unrolled_refractions", 0)
    assert read() == 1.0
    monkeypatch.setattr(trace_core.trace_bundle, "unrolled_refractions", 20)
    assert read() == 0.8


def test_nothing_to_read_reads_nothing(monkeypatch):
    """No refraction of a run's kinds on the card, or a program without the
    counters or the modules: the reader returns None."""
    from optrace_tpu_torch.ops import cuda_run
    from optrace_tpu_torch.tracer import trace_core
    monkeypatch.setattr(cuda_run.conic_run, "refractions", 0)
    monkeypatch.setattr(trace_core.trace_bundle, "unrolled_refractions", 0)
    assert read() is None
    monkeypatch.setattr(cuda_run.conic_run, "refractions", 5)
    monkeypatch.delattr(trace_core.trace_bundle, "unrolled_refractions")
    assert read() is None
    monkeypatch.setitem(sys.modules, "optrace_tpu_torch.ops.cuda_run", None)
    assert read() is None


def test_the_metric_lists_the_eye_cells():
    spec = harness.load_spec()
    m = next(m for m in spec["per_layer"] if m["name"] == "kernel1.refraction_share.render")
    assert m["workloads"] == ["eye-render", "keratoconus-psf"] and m["moves"] == "rays_per_s"
    assert m["layer"] == "kernel 1" and m["source"] == "program_counter" and m["unit"] == "share"
