"""One run of one cell: find its configuration, traffic, entry and metrics
by the names in ``BENCHMARK.json``, set up, drive a closed loop for the
run's seconds, profile a further stretch when traced, judge the window's
results against the plain reference and print the result line.

What belongs to one configuration, traffic mix, entry or per-layer metric
lives in a file of its own that this module finds by name:
``configs/<file>``, ``traffic/<traffic>.json``, ``entries/<entry>.py``,
``metrics/<metric>.py`` and ``limits/<cell>.json``.
"""

import contextlib
import importlib.util
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of a run may hold (whole names:
# the program's package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optrace_tpu")
NOT_A_NUMBER = 1e300


# ----------------------------------------------------------------------
# finding things by name

def load_spec(root=None) -> dict:
    with open(pathlib.Path(root or ROOT) / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark's folder as a module; a name may
    hold dots, so it is loaded from its file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str) -> dict:
    """The cell ``name`` with its configuration entry, the configuration's
    file, its traffic file and its limits file, all read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = dict(cells[name])
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cell["config_entry"] = cfg_entry
    cell["config_data"] = load_json(ROOT / cfg_entry["file"])
    cell["traffic_data"] = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    cell["limits"] = load_json(HERE / "limits" / f"{name}.json")
    return cell


def end_to_end_for(spec: dict, name: str) -> list:
    """The end-to-end metrics that the cell reports."""
    return [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def per_layer_for(spec: dict, name: str) -> list:
    """The per-layer metrics that the cell reports: those that list it, and
    those without a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(spec, name)}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# the build caches of a run, inside the checkout: the program's CUDA
# libraries and the compile caches that run.py fixes
BUILD_DIRS = ("optrace_tpu_torch/_build", ".bench_cache")


def build_state() -> dict:
    """Every file of the build caches with its size and time: a run whose
    state differs at its end from its start built or compiled something."""
    state = {}
    for d in BUILD_DIRS:
        for f in (ROOT / d).rglob("*"):
            with contextlib.suppress(OSError):
                st = f.stat()
                if f.is_file():
                    state[str(f.relative_to(ROOT))] = (st.st_size, st.st_mtime_ns)
    return state


# ----------------------------------------------------------------------
# the run

class Run:
    """What an entry and a metric reader see of one run: the cell, its
    configuration and traffic, the seed, the device, the rank, and the
    benchmark's own spans (taken only in a traced run)."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, rank: int = 0,
                 world: int = 1, device=None):
        import torch
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.limits = cell["limits"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.rank, self.world = rank, world
        self.device = torch.device("cuda", rank) if device is None else torch.device(device)
        self.spans = {}

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark around a call into one layer of the
        program: only in a traced run, with the card synchronized at both
        ends and a profiler label, so that an untraced run pays nothing."""
        if not self.trace:
            yield
            return
        import torch
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench:{name}"):
            yield
        self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def window(run: Run, entry, state, seconds: float, stop=None) -> dict:
    """The closed loop: one operation after the other until ``seconds``
    have passed since the first began. ``stop(over)`` decides on every
    rank together (a sharded cell); by default the clock decides."""
    lat, work, batches, ops = [], 0, 0, 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        done = entry.operation(run, state)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        work += done.get("rays", 0)
        batches += done.get("batches", 0)
        ops += 1
        over = t1 - t_start >= seconds
        if (stop(over) if stop else over):
            break
    return dict(seconds=t1 - t_start, latencies=lat, work=work, batches=batches, ops=ops)


def end_to_end(name: str, setup_s: float, win: dict) -> float:
    """The end-to-end metrics, taken by the benchmark itself on the host's
    clock: a rate over all the work and all the time of the window, a time
    per operation over all of it, a tail over every operation."""
    if name == "setup_s":
        return setup_s
    if name == "rays_per_s":
        return win["work"] / win["seconds"]
    if name == "op_ms":
        return win["seconds"] / win["ops"] * 1e3
    if name == "op_p95_ms":
        return statistics.quantiles(win["latencies"], n=20, method="inclusive")[18] * 1e3
    raise KeyError(f"no end-to-end metric named {name!r}")


def profiled_stretch(run: Run, entry, state) -> dict:
    """``profile_ops`` more operations under ``torch.profiler``: the
    device's kernels, the host's labels and the benchmark's spans."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from . import profiling
    n = int(run.traffic["profile_ops"])
    run.spans = {}
    run.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench:stretch"):
            done = [entry.operation(run, state) for _ in range(n)]
        run.sync()
    tr = profiling.read(prof, "bench:stretch")
    tr["ops"] = n
    tr["batches"] = sum(d.get("batches", 0) for d in done)
    tr["rays"] = sum(d.get("rays", 0) for d in done)
    tr["image_shape"] = tuple(done[-1].get("image_shape", ()))
    tr["spans"] = run.spans
    return tr


def smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def judge(run: Run, entry, outputs) -> dict:
    """The numbers compared with the reference, each beside its limit: those
    of the entry's numbers that the cell's limits file names."""
    numbers = entry.judge(run, outputs)
    checks = {}
    for key, value in numbers.items():
        if key not in run.limits:
            continue
        # a gap that is not a number (nothing to compare) prints as a
        # huge one: the result line stays JSON, and the check fails
        value = float(value) if math.isfinite(value) else NOT_A_NUMBER
        checks[key] = {"value": value, "limit": float(run.limits[key])}
    missing = set(run.limits) - set(checks)
    if missing:
        raise KeyError(f"limits without a number: {sorted(missing)}")
    return checks


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# ----------------------------------------------------------------------
# one rank's part

def drive(cell: dict, args, start: float, rank: int = 0, world: int = 1, rdzv: str = None,
          device=None) -> dict:
    """Set up, measure, profile and judge on one card; rank 0 of a sharded
    cell also judges, and the other ranks only take part. Returns what the
    result line needs from this rank. ``device`` stands in for the card in
    the CPU tests."""
    import torch
    run = Run(cell, args.seed, args.seconds, args.trace, rank, world, device)
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(run.device)
    if world > 1:
        import torch.distributed as dist
        from datetime import timedelta
        kw = dict(device_id=run.device) if on_card else {}
        dist.init_process_group("nccl" if on_card else "gloo", init_method=rdzv, rank=rank,
                                world_size=world, timeout=timedelta(seconds=300), **kw)
    entry = load_module("entries", run.traffic["entry"])
    state = entry.setup(run)
    run.sync()

    stop = None
    if world > 1:
        import torch.distributed as dist
        flag = torch.zeros(1, dtype=torch.int32, device=run.device)

        def stop(over):
            flag.fill_(int(over))
            dist.broadcast(flag, src=0)
            return bool(flag.item())
        dist.barrier()
    t_first = time.perf_counter()
    setup_s = t_first - start
    win = window(run, entry, state, run.seconds, stop)
    prof = profiled_stretch(run, entry, state) if run.trace else None
    memory_peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    outputs = entry.finish(run, state)
    del state
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    out = dict(rank=rank, setup_s=setup_s, window=win, memory_peak=memory_peak, profile=prof)
    if rank == 0:
        out["checks"] = judge(run, entry, outputs)
        out["metrics_per_layer"] = {}
        if prof is not None:
            for m in per_layer_for(load_spec(), cell["name"]):
                v = load_module("metrics", m["name"]).read(run, prof)
                if v is not None:
                    out["metrics_per_layer"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    # last: what the judge and the metric readers loaded counts too
    out["forbidden"] = forbidden_modules()
    return out


def _patch(patches) -> None:
    """Put (module, attribute, "module:factory") in place: the factory,
    given the attribute, returns its stand-in. For the tests, which plant
    faults in the ranks' own processes."""
    for mod_name, attr, factory in patches:
        mod = importlib.import_module(mod_name)
        f_mod, f_name = factory.split(":")
        setattr(mod, attr, getattr(importlib.import_module(f_mod), f_name)(getattr(mod, attr)))


def _rank_main(cell, args, start_wall, rank, world, rdzv, conn, device, patches):
    """A spawned rank of a sharded cell: its set-up is timed from the
    parent's start, by the wall clock both share."""
    try:
        _patch(patches)
        start = time.perf_counter() - (time.time() - start_wall)
        res = drive(cell, args, start, rank, world, rdzv, device)
        conn.send(("ok", res))
    except BaseException:
        conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        conn.close()


def drive_ranks(cell: dict, args, start_wall: float, device=None, patches=()) -> list:
    """One process a card, started here with the ``spawn`` method, each
    answering through a pipe of its own (no shared-memory queue); their
    rendezvous file lies in this run's temporary directory. ``device``
    stands in for the cards, and ``patches`` plant faults, in the CPU
    tests."""
    import multiprocessing as mp
    from multiprocessing.connection import wait
    world = int(cell["chips"])
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    with tempfile.TemporaryDirectory(prefix="bench_rdzv_") as tmp:
        rdzv = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(cell, args, start_wall, r, world, rdzv, pipes[r][1], device, patches))
                 for r in range(world)]
        for p in procs:
            p.start()
        for _, send in pipes:
            send.close()
        results, errors = [], []
        pending = [recv for recv, _ in pipes]
        deadline = time.monotonic() + 340
        try:
            while pending:
                ready = wait(pending, timeout=max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise TimeoutError(f"{len(pending)} rank(s) gave no result within 340 s")
                for conn in ready:
                    pending.remove(conn)
                    try:
                        kind, res = conn.recv()
                    except EOFError:
                        errors.append("a rank ended without a result")
                        continue
                    (results if kind == "ok" else errors).append(res)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return sorted(results, key=lambda r: r["rank"])


# ----------------------------------------------------------------------

def main(args, start: float, start_wall: float) -> int:
    spec = load_spec()
    cell = find_cell(spec, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {cell['name']} needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    built_before = build_state()
    try:
        import optrace_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 3

    if chips == 1:
        ranks = [drive(cell, args, start)]
    else:
        ranks = drive_ranks(cell, args, start_wall)
    lead = ranks[0]

    found = forbidden_modules() + [m for r in ranks for m in r["forbidden"]]
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {sorted(set(found))}", file=sys.stderr)
        return 4

    built = sorted(k for k, v in build_state().items() if built_before.get(k) != v)
    win = lead["window"]
    metrics = {}
    if not args.trace:
        for m in end_to_end_for(spec, cell["name"]):
            metrics[m["name"]] = {"value": end_to_end(m["name"], lead["setup_s"], win), "unit": m["unit"]}
    else:
        metrics = lead["metrics_per_layer"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(max(r["memory_peak"] for r in ranks))}
    result = {"correct": is_correct(lead["checks"]), "attempted": win["ops"], "failed": 0,
              "metrics": metrics, "device": device}
    if args.trace:
        # each card's busy time within its own profiled stretch, both averaged
        device["busy_s"] = statistics.fmean(r["profile"]["busy_s"] for r in ranks)
        device["window_s"] = statistics.fmean(r["profile"]["window_s"] for r in ranks)
        result["breakdown"] = lead["profile"]["breakdown"]
    # whether this run built or compiled into its caches (a checkout's first
    # run does, and its set-up is then no warm one)
    result["setup_built"] = bool(built)
    result["checks"] = lead["checks"]

    info = dict(smi=smi(), setup_s=lead["setup_s"], built=built[:20], ops=win["ops"], window_s=win["seconds"],
                work=win["work"], batches=win["batches"],
                latencies_ms=[round(x * 1e3, 4) for x in win["latencies"]][:2000])
    if args.trace:
        info["profile"] = lead["profile"]
    print("benchmark info: " + json.dumps(info), flush=True)
    for key, c in lead["checks"].items():
        print(f"check {key} = {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
