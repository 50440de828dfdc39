"""The cell ``keratoconus-psf`` on the CPU at a small size (its entry
``render_huge_cone``, the reference ``reference_keratoconus``): the result
line, the faults that the check must refuse (``bench_common.FAULTS``, and
the program rendering the healthy cornea in the cone's place), the bf16
control, and the readers of the generic step's interval and counter."""

import importlib
import json
import sys
import types

import pytest
import torch

import bench_common
from bench_common import FAULTS, SEED, fault_patches, run_main, small_cell
from benchmark import harness, scene_keratoconus
from optrace_tpu_torch import utils
from optrace_tpu_torch.utils import tracing
from test_bench_harness import _refused

CELL = "keratoconus-psf"
SMALL = dict(rays=40000, batch=20000, reference_rays=200000, reference_batch=100000, warm_calls=1)
READERS = ("generic.device_ms.render", "generic.sag_evals_per_ray.render")


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """Two threads, and the cell's entry cut to the size of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setitem(bench_common.SMALL, "render_huge_cone", SMALL)
    yield
    torch.set_num_threads(n)


def healthy_cornea(build):
    """The program given the healthy cornea (h0 = 0) in the cone's place."""
    def building(ot, cfg, *a, **k):
        cfg = json.loads(json.dumps(cfg))
        cfg["surfaces"][0]["h0"] = 0.0
        return build(ot, cfg, *a, **k)
    return building


_SOUND = {}


def _sound(monkeypatch):
    if not _SOUND:
        rc, line, err = run_main(monkeypatch, CELL)
        assert rc == 0, err
        _SOUND.update(line["checks"])
    return _SOUND


def test_result_line(monkeypatch):
    rc, line, err = run_main(monkeypatch, CELL)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_built", "checks"]
    spec = harness.load_spec()
    assert set(line["metrics"]) == {"setup_s", "rays_per_s"} == \
        {m["name"] for m in harness.end_to_end_for(spec, CELL)}
    assert line["device"]["count"] == 1 and line["attempted"] >= 1
    assert set(line["checks"]) == set(small_cell(CELL)["limits"])
    # a sound program at this size: the noise of its images is that of its rays
    assert line["checks"]["noise_ratio"]["value"] < line["checks"]["noise_ratio"]["limit"], line["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["the healthy cornea in the cone's place"])
def test_a_fault_is_refused(monkeypatch, fault):
    sound = _sound(monkeypatch)
    monkeypatch.undo()
    monkeypatch.setitem(bench_common.SMALL, "render_huge_cone", SMALL)
    if fault in FAULTS:
        for mod, attr, factory in fault_patches(fault):
            mod = importlib.import_module(mod)
            monkeypatch.setattr(mod, attr, getattr(bench_common, factory.split(":")[1])(getattr(mod, attr)))
    else:
        monkeypatch.setattr(scene_keratoconus, "build", healthy_cornea(scene_keratoconus.build))
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


def test_the_entry_notes_the_sag_evaluations():
    """Each call's count of sag evaluations, as the entry notes it: 44 a ray
    (42 by the hit solve, two by the normals) of every batch."""
    cell = small_cell(CELL)
    run = harness.Run(cell, SEED, 0.0, False, device="cpu")
    entry = harness.load_module("entries", cell["traffic_data"]["entry"])
    state = entry.setup(run)
    done = entry.operation(run, state)
    assert run.sag_evals == [44 * SMALL["rays"]] * 2
    prof = dict(ops=1, rays=done["rays"], batches=done["batches"])
    assert harness.load_module("metrics", "generic.sag_evals_per_ray.render").read(run, prof) == 44.0


# ----------------------------------------------------------------------
# the readers on planted records

def read(name, run=None, **prof):
    run = run or types.SimpleNamespace(world=1)
    return harness.load_module("metrics", name).read(run, dict(dict(ops=0, batches=0, rays=0), **prof))


def test_the_readers_read_planted_records(monkeypatch):
    monkeypatch.setattr(tracing, "device_ms", lambda name: 4.25 if name == "trace_bundle.generic" else None)
    assert read("generic.device_ms.render", ops=1, batches=50, rays=5e7) == 4.25
    # the stretch's one call after two warm calls and the window's three
    run = types.SimpleNamespace(world=1, sag_evals=[1, 2, 3, 4, 5, 44 * 50_000_000])
    assert read("generic.sag_evals_per_ray.render", run, ops=1, batches=50, rays=5e7) == 44.0
    # a sharded cell: the counter is the rank's, its rays a share of the call's
    run = types.SimpleNamespace(world=4, sag_evals=[44 * 1_000_000, 44 * 1_000_000])
    assert read("generic.sag_evals_per_ray.render", run, ops=2, batches=2, rays=8e6) == 44.0


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_nothing(name, monkeypatch):
    """No interval recorded, no counter noted (a program without them), or a
    program without its tracing module: the reader returns None."""
    tracing.reset()
    assert read(name, types.SimpleNamespace(world=1, sag_evals=[]), ops=1, batches=50, rays=5e7) is None
    assert read(name, types.SimpleNamespace(world=1), ops=1, batches=50, rays=5e7) is None
    monkeypatch.setattr(tracing, "device_ms", lambda name: 4.25)
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "optrace_tpu_torch.utils.tracing", None)
    assert read(name, types.SimpleNamespace(world=1), ops=1, batches=50, rays=5e7) is None
