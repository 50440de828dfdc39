"""What ``BENCHMARK.json`` lists against what its cells can report, read from
the declaration and the traffic and configuration files alone:

- a cell listed under ``graph.warmup_ms.render`` renders at least
  ``parallel.graph.MIN_BATCHES`` batches a call: below that ``render_huge``
  keeps its step eager, no capture runs, and the reader (the spans
  ``graph.eager`` and ``graph.capture``) finds nothing, so a traced run's
  line would lack the metric;
- no cell whose configuration holds a surface type that
  ``benchmark/reference.py:Scene`` does not model (it reads every row that
  is not a stop as a conic) is listed under a ``kernel1_roofline.*`` or
  ``kernel2_roofline.*`` reader, which counts the work from that class.
"""

import json
import math
import pathlib

import pytest

from optrace_tpu_torch.parallel.graph import MIN_BATCHES

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in SPEC["workloads"]}
MODELLED = {"conic", "stop"}    # the row types that reference.Scene reads as they are


def listed(metric: str) -> list:
    return next(m for m in SPEC["per_layer"] if m["name"] == metric).get("workloads", [])


def traffic(cell: str) -> dict:
    return json.loads((ROOT / "benchmark" / "traffic" / f"{CELLS[cell]['traffic']}.json").read_text())


def config(cell: str) -> dict:
    entry = next(c for c in SPEC["configs"] if c["name"] == CELLS[cell]["config"])
    return json.loads((ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("cell", listed("graph.warmup_ms.render"))
def test_a_warm_up_reader_cell_captures_its_batch(cell):
    t = traffic(cell)
    assert math.ceil(int(t["rays"]) / int(t["batch"])) >= MIN_BATCHES, t


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]
                                    if m["name"].startswith(("kernel1_roofline.", "kernel2_roofline."))])
def test_a_roofline_cell_is_one_the_reference_models(metric):
    for cell in listed(metric):
        kinds = {row["type"] for row in config(cell)["surfaces"]}
        assert kinds <= MODELLED, (metric, cell, kinds - MODELLED)


def test_the_guards_see_the_cells_they_guard():
    """Both rules have cells to hold: the render cells under the warm-up
    reader, and a configuration with a row the reference's ``Scene`` does
    not model, kept off the rooflines."""
    assert {"dgauss-render", "eye-render", "keratoconus-psf"} <= set(listed("graph.warmup_ms.render"))
    unmodelled = {c for c in CELLS if {r["type"] for r in config(c)["surfaces"]} - MODELLED}
    assert "keratoconus-psf" in unmodelled
    assert not unmodelled & set(listed("kernel2_roofline.render"))
