"""The cell ``iol-hurb-psf`` on the CPU at a small size (its entry
``render_huge_iol``, the reference ``reference_iol``): the result line, the
faults that the check must refuse (``bench_common.FAULTS``, and the program
with HURB off under the timed path), the bf16 control, the readers of the
HURB step's interval and counter, and where ``BENCHMARK.json`` lists the
cell."""

import importlib
import json
import sys
import types

import pytest
import torch

import bench_common
from bench_common import FAULTS, SEED, fault_patches, run_main, small_cell
from benchmark import harness
from optrace_tpu_torch import utils
from optrace_tpu_torch.tracer import trace_core
from optrace_tpu_torch.utils import tracing
from test_bench_harness import _refused

CELL = "iol-hurb-psf"
SMALL = dict(rays=40000, batch=20000, reference_rays=200000, reference_batch=100000, warm_calls=1)
READERS = ("hurb.device_ms.render", "hurb.rays_per_ray.render")
HURB_OFF = "HURB off under the timed path"


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """Two threads, and the cell's entry cut to the size of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setitem(bench_common.SMALL, "render_huge_iol", SMALL)
    yield
    torch.set_num_threads(n)


def hurb_off(real):
    """The trace that the raytracer calls, with HURB off whatever the scene
    asks for: every ray passes the pupil unbent."""
    def trace_bundle(steps, n0_fn, outline, p, s, pols, w, wl, no_pol, use_hurb=False, *a, **k):
        return real(steps, n0_fn, outline, p, s, pols, w, wl, no_pol, False, *a, **k)
    return trace_bundle


def plant(monkeypatch, fault: str) -> None:
    if fault == HURB_OFF:
        mod = importlib.import_module("optrace_tpu_torch.tracer.raytracer")
        monkeypatch.setattr(mod, "trace_bundle", hurb_off(mod.trace_bundle))
        return
    for mod, attr, factory in fault_patches(fault):
        mod = importlib.import_module(mod)
        monkeypatch.setattr(mod, attr, getattr(bench_common, factory.split(":")[1])(getattr(mod, attr)))


_SOUND = {}


def _sound(monkeypatch):
    if not _SOUND:
        rc, line, err = run_main(monkeypatch, CELL)
        assert rc == 0, err
        _SOUND.update(line["checks"])
    return _SOUND


def test_result_line(monkeypatch):
    """The harness finds the cell, its configuration, traffic, entry and
    limits, and prints a sound run's line."""
    rc, line, err = run_main(monkeypatch, CELL)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_built", "checks"]
    spec = harness.load_spec()
    assert set(line["metrics"]) == {"setup_s", "rays_per_s"} == \
        {m["name"] for m in harness.end_to_end_for(spec, CELL)}
    assert line["device"]["count"] == 1 and line["attempted"] >= 1
    assert set(line["checks"]) == set(small_cell(CELL)["limits"])
    assert line["checks"]["noise_ratio"]["value"] < line["checks"]["noise_ratio"]["limit"], line["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS) + [HURB_OFF])
def test_a_fault_is_refused(monkeypatch, fault):
    sound = _sound(monkeypatch)
    monkeypatch.undo()
    monkeypatch.setitem(bench_common.SMALL, "render_huge_iol", SMALL)
    plant(monkeypatch, fault)
    rc, line, err = run_main(monkeypatch, CELL)
    assert rc == 0, err
    assert not line["correct"], line["checks"]
    assert _refused(line["checks"], sound), (line["checks"], sound)


def test_calibrate_refuses_the_control(monkeypatch, capsys):
    """The reference in bfloat16 in the program's place fails a number that
    the program holds or reads three times less, and gives every number."""
    from benchmark import calibrate
    monkeypatch.setattr(harness, "find_cell", lambda sp, n: small_cell(n))
    assert calibrate.main(["--workload", CELL, "--seeds", str(SEED), "--control-seeds", str(SEED + 1),
                           "--device", "cpu"]) == 0
    program, control = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines())
    assert not control["correct"], control["checks"]
    assert _refused(control["checks"], program["checks"]), (control["checks"], program["checks"])
    assert all(c["value"] < harness.NOT_A_NUMBER for c in control["checks"].values()), control["checks"]


def test_the_entry_notes_the_hurb_rays():
    """Each call's count of the rays that entered the pupil's HURB step, as
    the entry notes it: every ray of every batch, once."""
    cell = small_cell(CELL)
    run = harness.Run(cell, SEED, 0.0, False, device="cpu")
    entry = harness.load_module("entries", cell["traffic_data"]["entry"])
    state = entry.setup(run)
    done = entry.operation(run, state)
    assert run.hurb_rays == [SMALL["rays"]] * 2
    prof = dict(ops=1, rays=done["rays"], batches=done["batches"])
    assert harness.load_module("metrics", "hurb.rays_per_ray.render").read(run, prof) == 1.0


# ----------------------------------------------------------------------
# the readers, and the lists of BENCHMARK.json

def read(name, run=None, **prof):
    run = run or types.SimpleNamespace(world=1)
    return harness.load_module("metrics", name).read(run, dict(dict(ops=0, batches=0, rays=0), **prof))


def test_the_readers_read_planted_records(monkeypatch):
    monkeypatch.setattr(tracing, "device_ms", lambda name: 0.5 if name == "trace_bundle.hurb" else None)
    assert read("hurb.device_ms.render", ops=1, batches=50, rays=5e7) == 0.5
    # the stretch's one call after two warm calls and the window's three
    run = types.SimpleNamespace(world=1, hurb_rays=[1, 2, 3, 4, 5, 50_000_000])
    assert read("hurb.rays_per_ray.render", run, ops=1, batches=50, rays=5e7) == 1.0


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_nothing(name, monkeypatch):
    """No interval recorded, no counter noted (a program without them), or a
    program without its tracing module: the reader returns None."""
    tracing.reset()
    assert read(name, types.SimpleNamespace(world=1, hurb_rays=[]), ops=1, batches=50, rays=5e7) is None
    assert read(name, types.SimpleNamespace(world=1), ops=1, batches=50, rays=5e7) is None
    monkeypatch.setattr(tracing, "device_ms", lambda name: 0.5)
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "optrace_tpu_torch.utils.tracing", None)
    assert read(name, types.SimpleNamespace(world=1), ops=1, batches=50, rays=5e7) is None


def test_the_entry_notes_nothing_without_the_counter(monkeypatch):
    """A program whose trace has no HURB counter (one older than the
    counter): the entry notes nothing, and the counter's reader reports
    nothing."""
    cell = small_cell(CELL)
    run = harness.Run(cell, SEED, 0.0, False, device="cpu")
    entry = harness.load_module("entries", cell["traffic_data"]["entry"])
    with monkeypatch.context() as m:
        m.delattr(trace_core.trace_bundle, "hurb_rays")
        assert entry._hurb_rays() is None
    entry._hurb_rays = lambda: None
    done = entry.operation(run, entry.setup(run))
    assert run.hurb_rays == []
    prof = dict(ops=1, rays=done["rays"], batches=done["batches"])
    assert harness.load_module("metrics", "hurb.rays_per_ray.render").read(run, prof) is None


def test_where_the_cell_is_listed():
    """In ``rays_per_s``'s list and the render metrics', in no roofline
    reader's list: ``roofline.py`` counts kernel 1's runs of four or more
    and builds ``reference.Scene``, which reads the asphere as its conic."""
    spec = harness.load_spec()
    rate = next(m for m in spec["end_to_end"] if m["name"] == "rays_per_s")
    assert CELL in rate["workloads"]
    listed = {m["name"] for m in harness.per_layer_for(spec, CELL)}
    assert listed == {"graph.launches_per_batch.render", "device.idle_share.render", "render.build_ms",
                      "graph.warmup_ms.render", "render.accumulate_ms", "sampling.device_ms.render",
                      "kernel1.refraction_share.render", *READERS}
    assert not [m for m in listed if "roofline" in m]
