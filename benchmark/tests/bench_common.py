"""What the benchmark's CPU tests share: a cell cut to a size the CPU holds,
and a run of the harness on the CPU in place of the card."""

import contextlib
import importlib
import io
import json
import pathlib
import sys
import time
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# a size the CPU holds: the trace cell's rays, the render's rays and batch,
# and the reference's rays beside them
SMALL = {"render_huge": dict(rays=40000, batch=20000, reference_rays=200000, reference_batch=100000,
                             warm_calls=1),
         "trace_read": dict(rays=20000, warm_ops=1)}
SEED = 4294967311           # above 2**32


# a cell that BENCHMARK.json does not hold yet: dgauss-render's
# configuration, traffic and limits on four ranks, for the harness's
# sharded path
SHARDED = "dgauss-render-4gpu"
SHARDED_FROM = "dgauss-render"

_FIND_CELL, _LOAD_SPEC = harness.find_cell, harness.load_spec


def spec(root=None) -> dict:
    """BENCHMARK.json with the sharded cell added."""
    sp = _LOAD_SPEC(root)
    base = next(w for w in sp["workloads"] if w["name"] == SHARDED_FROM)
    sp["workloads"].append(dict(base, name=SHARDED, chips=4))
    for m in sp["end_to_end"] + sp["per_layer"]:
        if SHARDED_FROM in m.get("workloads", ()):
            m["workloads"].append(SHARDED)
    return sp


def small_cell(name: str) -> dict:
    cell = _FIND_CELL(_LOAD_SPEC(), SHARDED_FROM if name == SHARDED else name)
    if name == SHARDED:
        cell.update(name=SHARDED, chips=4)
    cell["traffic_data"].update(SMALL[cell["traffic_data"]["entry"]])
    return cell


@contextlib.contextmanager
def cpu_in_place_of_card(monkeypatch, patches=()):
    """The harness's look for a card passes, and every rank runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "CPU in place of the card")
    real, real_ranks = harness.drive, harness.drive_ranks
    monkeypatch.setattr(harness, "drive", lambda *a, **k: real(*a, **dict(k, device="cpu")))
    monkeypatch.setattr(harness, "drive_ranks",
                        lambda *a, **k: real_ranks(*a, **dict(k, device="cpu", patches=patches)))
    yield


# ----------------------------------------------------------------------
# faults planted under the timed path: each a factory that, given the
# program's function, returns the faulty one; named, so that the spawned
# ranks of a sharded cell can plant them too

def unchanged(real):
    """The trace returns its state as it came in: no ray moves, none hits."""
    def trace_bundle(steps, n0_fn, outline, p, s, pols, w, wl, *a, **k):
        out = real(steps, n0_fn, outline, p, s, pols, w, wl, *a, **k)
        if "p" in out:
            out["p"][:] = p[:, None]
        out["sinks"] = [(c[0], c[1], torch.zeros_like(c[2])) + tuple(c[3:]) for c in out["sinks"]]
        return out
    return trace_bundle


def _half(real, mean_over_rest: bool):
    def trace_bundle(steps, n0_fn, outline, p, s, pols, w, wl, *a, **k):
        w = w.clone()
        w[w.shape[0] // 2:] = 0
        if mean_over_rest:
            w[:w.shape[0] // 2] *= 2
        return real(steps, n0_fn, outline, p, s, pols, w, wl, *a, **k)
    return trace_bundle


def half_left_out(real):
    """Half of each batch's rays carry no power."""
    return _half(real, False)


def half_left_out_doubled(real):
    """Half of each batch's rays carry no power, the other half twice
    theirs: the mean over the rest, an unbiased image with more noise."""
    return _half(real, True)


def altered_image(real):
    """The binning's image comes out a twentieth of its width off."""
    def bin_xyzw_cuda(*a, **k):
        img = real(*a, **k)
        return torch.roll(img, shifts=max(1, img.shape[1] // 20), dims=1)
    return bin_xyzw_cuda


def no_exchange(all_reduce):
    """A rank's all-reduce that exchanges nothing: each rank keeps its own
    tile."""
    return lambda tensor, *a, **k: None


def same_stream(batch_generator):
    """Every rank draws rank 0's rays: the tiles summed are one rank's."""
    return lambda seed, batch_index, device, rank=0: batch_generator(seed, batch_index, device, 0)


def loads_jax(judge):
    """The judge of a rank that loads a module named ``jax`` on its way."""
    def judging(*a, **k):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return judge(*a, **k)
    return judging


PORT = ("optrace_tpu_torch.parallel.render", "optrace_tpu_torch.tracer.raytracer",
        "optrace_tpu_torch.image.render_image")
# name: (the program's function, the factory in this module)
FAULTS = {
    "state unchanged": ("trace_bundle", "unchanged"),
    "half of the batch left out": ("trace_bundle", "half_left_out"),
    "half of the batch left out, the mean over the rest": ("trace_bundle", "half_left_out_doubled"),
    "an answer altered where it is produced": ("bin_xyzw_cuda", "altered_image"),
}
SHARDED_FAULTS = dict(FAULTS, **{
    "the exchange between chips left out": ("all_reduce", "no_exchange"),
    "every rank the same stream": ("batch_generator", "same_stream"),
})


def fault_patches(fault: str) -> list:
    """(module, attribute, "bench_common:factory") for every module of the
    program that holds the fault's function (``torch.distributed`` for the
    all-reduce)."""
    attr, factory = SHARDED_FAULTS[fault]
    mods = ("torch.distributed",) if attr == "all_reduce" else PORT
    return [(m, attr, f"bench_common:{factory}") for m in mods
            if hasattr(importlib.import_module(m), attr)]


def run_main(monkeypatch, name: str, seconds: float = 0.5, patches=()) -> tuple:
    """harness.main on the CPU for the cell cut to size: (exit code, the
    last line of standard output as a dict, standard error). ``patches``
    go to the ranks of a sharded cell (``harness.drive_ranks``)."""
    monkeypatch.setattr(harness, "find_cell", lambda sp, n: small_cell(n))
    monkeypatch.setattr(harness, "load_spec", spec)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # for the spawned ranks of a sharded cell
    args = types.SimpleNamespace(workload=name, seed=SEED, seconds=seconds, trace=0)
    out, err = io.StringIO(), io.StringIO()
    with cpu_in_place_of_card(monkeypatch, patches), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = harness.main(args, time.perf_counter(), time.time())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), err.getvalue()
