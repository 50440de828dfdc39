"""The harness on the CPU: the result line, the faults that the check must
refuse, and how cells, traffic, entries and metrics are found by name."""

import importlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

import bench_common
from bench_common import (FAULTS, ROOT, SHARDED, SHARDED_FAULTS, fault_patches, run_main, small_cell,
                          spec)
from benchmark import harness

CELLS = ("dgauss-render", "dgauss-trace", "eye-render")      # the cells on one card


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS + (SHARDED,))
def test_result_line(monkeypatch, name):
    rc, line, err = run_main(monkeypatch, name)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_built", "checks"]
    assert isinstance(line["setup_built"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    spec = harness.load_spec()
    assert set(line["metrics"]) == {m["name"] for m in harness.end_to_end_for(spec, name)}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == harness.find_cell(spec, name)["chips"]
    assert set(line["checks"]) == set(small_cell(name)["limits"])
    # the numbers compared close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_the_trace_cell_is_correct_at_a_small_size(monkeypatch):
    """The trace cell's numbers compare the program with the reference ray
    by ray, so a sound run holds its limits at any size."""
    rc, line, err = run_main(monkeypatch, "dgauss-trace")
    assert rc == 0, err
    assert line["correct"], line["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = type("A", (), dict(workload="dgauss-render", seed=1, seconds=1.0, trace=0))()
    assert harness.main(args, 0.0, 0.0) != 0
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------------------
# faults planted under the timed path

_SOUND = {}


def _refused(fault: dict, sound: dict) -> bool:
    """Some number of the faulty run fails its limit, where the sound run
    at the same size holds it or reads three times less."""
    return any(c["value"] > c["limit"] and (sound[k]["value"] <= sound[k]["limit"]
                                            or c["value"] > 3 * sound[k]["value"])
               for k, c in fault.items())


def _sound(monkeypatch, name):
    if name not in _SOUND:
        rc, line, err = run_main(monkeypatch, name)
        assert rc == 0, err
        _SOUND[name] = line["checks"]
    return _SOUND[name]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in sorted(FAULTS)])
def test_a_fault_is_refused(monkeypatch, name, fault):
    sound = _sound(monkeypatch, name)
    monkeypatch.undo()
    for mod, attr, factory in fault_patches(fault):
        mod = importlib.import_module(mod)
        monkeypatch.setattr(mod, attr, getattr(bench_common, factory.split(":")[1])(getattr(mod, attr)))
    rc, line, err = run_main(monkeypatch, name)
    assert rc == 0, err
    assert not line["correct"], line["checks"]
    assert _refused(line["checks"], sound), (line["checks"], sound)


@pytest.mark.parametrize("fault", sorted(SHARDED_FAULTS))
def test_a_fault_is_refused_on_the_sharded_cell(monkeypatch, fault):
    """The faults planted in every rank of the sharded cell, with those that
    only a sharded render can have: the all-reduce of the tiles left out,
    and every rank drawing the same rays."""
    sound = _sound(monkeypatch, SHARDED)
    monkeypatch.undo()
    rc, line, err = run_main(monkeypatch, SHARDED, patches=fault_patches(fault))
    assert rc == 0, err
    assert not line["correct"], line["checks"]
    assert _refused(line["checks"], sound), (line["checks"], sound)


def test_a_rank_that_loads_jax_after_the_window_gives_no_result(monkeypatch):
    """The judge of a spawned rank loads a module named ``jax`` once the
    window has closed: the run exits with an error and prints no result."""
    rc, line, err = run_main(monkeypatch, SHARDED,
                             patches=[("benchmark.harness", "judge", "bench_common:loads_jax")])
    assert rc == 4 and line is None
    assert "jax" in err


# ----------------------------------------------------------------------
# found by name

def test_a_new_cell_is_only_new_files(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a per-layer metric and a cell added as
    new files and new entries of BENCHMARK.json are found by their names,
    with no file of the harness edited."""
    tree = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/double_gauss.json").read_text())
    cfg["ray_source"]["field_angle_max_deg"] = 0.5
    (tree / "benchmark/configs/dummy.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/trace-read-1e6.json").read_text())
    traffic["rays"] = 1000
    (tree / "benchmark/traffic/dummy-mix.json").write_text(json.dumps(traffic))
    (tree / "benchmark/limits/dummy-cell.json").write_text(
        (ROOT / "benchmark/limits/dgauss-trace.json").read_text())
    (tree / "benchmark/metrics/dummy.ops.py").write_text("def read(run, prof):\n    return prof['ops']\n")
    spec["configs"].append(dict(spec["configs"][0], name="dummy", file="benchmark/configs/dummy.json"))
    spec["workloads"].append(dict(name="dummy-cell", config="dummy", traffic="dummy-mix", chips=1, why="x"))
    spec["per_layer"].append(dict(name="dummy.ops", unit="ops", better="higher", source="device_trace",
                                  layer="x", moves="op_ms", workloads=["dummy-cell"]))
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))

    monkeypatch.setattr(harness, "ROOT", tree)
    monkeypatch.setattr(harness, "HERE", tree / "benchmark")
    spec2 = harness.load_spec(tree)
    cell = harness.find_cell(spec2, "dummy-cell")
    assert cell["config_data"]["ray_source"]["field_angle_max_deg"] == 0.5
    assert cell["traffic_data"]["rays"] == 1000
    assert [m["name"] for m in harness.per_layer_for(spec2, "dummy-cell")] == ["dummy.ops"]
    assert {m["name"] for m in harness.end_to_end_for(spec2, "dummy-cell")} == {"setup_s"}
    assert harness.load_module("metrics", "dummy.ops").read(None, {"ops": 3}) == 3
    assert harness.load_module("entries", cell["traffic_data"]["entry"]).__file__.startswith(str(tree))


def test_every_cell_has_its_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        harness.load_module("entries", cell["traffic_data"]["entry"])
        assert set(cell["limits"]) > set()
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    command exits with an error and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dgauss-trace", "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


# ----------------------------------------------------------------------
# the readings the limits are set from

@pytest.mark.parametrize("name", CELLS)
def test_calibrate_reads_the_program_and_refuses_the_control(monkeypatch, capsys, name):
    """``calibrate.py`` drives the cell as a run does for a seed of the
    program and judges the reference in bfloat16 put in its place through
    the harness's own comparison: the control is not correct, and fails a
    number that the program holds or reads three times less (the render
    cells' limits are set for their own size, the trace cell's hold at any)."""
    from benchmark import calibrate
    monkeypatch.setattr(harness, "find_cell", lambda sp, n: small_cell(n))
    assert calibrate.main(["--workload", name, "--seeds", str(bench_common.SEED), "--control-seeds",
                           str(bench_common.SEED + 1), "--device", "cpu"]) == 0
    program, control = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines())
    assert program["kind"] == "program" and control["kind"] == "control"
    assert program["correct"] or name != "dgauss-trace", program["checks"]
    assert not control["correct"], control["checks"]
    assert _refused(control["checks"], program["checks"]), (control["checks"], program["checks"])
    # the control gives a number, and not a stand-in for none, for every gap
    assert all(c["value"] < harness.NOT_A_NUMBER for c in control["checks"].values()), control["checks"]
