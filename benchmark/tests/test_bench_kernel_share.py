"""The reader of ``generic.kernel_share.render`` on planted counters, and on a
program without them."""

import sys
import types

from benchmark import harness


def read(**prof):
    return harness.load_module("metrics", "generic.kernel_share.render").read(
        types.SimpleNamespace(world=1), dict(dict(ops=1, batches=50, rays=5e7), **prof))


def test_the_share_of_kernel_steps(monkeypatch):
    from optrace_tpu_torch.ops import cuda_generic
    monkeypatch.setattr(cuda_generic.generic_hit, "launches", 150)
    monkeypatch.setattr(cuda_generic.generic_hit, "eager_steps", 0)
    assert read() == 1.0
    monkeypatch.setattr(cuda_generic.generic_hit, "eager_steps", 50)
    assert read() == 0.75


def test_nothing_to_read_reads_nothing(monkeypatch):
    """No generic step on the card, or a program without the counters or
    the module: the reader returns None."""
    from optrace_tpu_torch.ops import cuda_generic
    monkeypatch.setattr(cuda_generic.generic_hit, "launches", 0)
    monkeypatch.setattr(cuda_generic.generic_hit, "eager_steps", 0)
    assert read() is None
    monkeypatch.delattr(cuda_generic.generic_hit, "eager_steps")
    assert read() is None
    monkeypatch.setitem(sys.modules, "optrace_tpu_torch.ops.cuda_generic", None)
    assert read() is None


def test_the_metric_lists_the_cell():
    spec = harness.load_spec()
    m = next(m for m in spec["per_layer"] if m["name"] == "generic.kernel_share.render")
    assert m["workloads"] == ["keratoconus-psf"] and m["moves"] == "rays_per_s"
    assert m["layer"] == "generic surfaces" and m["source"] == "program_counter"
