"""The stored trace captured into a CUDA graph (``Raytracer._trace_entry``,
``parallel/graph.py:CapturedStep``), on the CPU against the stand-in for
``torch.cuda.CUDAGraph`` of ``tests/test_torch_graph_step.py``, whose replay
runs the captured function again on the generator registered with it.

- Calls 1 (eager), ``TRACE_CAPTURE_CALL`` (capture and replay) and the one
  after it (replay) store the sections and INFOS of a fresh raytracer's
  eager trace at the same seed counter, bit for bit: the double Gauss
  without and with polarization, and the ``steps`` scene (image source,
  filter, HURB at the ring aperture, ideal lens); kernel 1 is counted as
  often as the eager trace launches it.
- A storage that a caller still holds does not change when a later trace
  replays.
- A trace after the first makes no tensor from host data, for sources,
  media and filters of every kind that holds a table and a ``"Data"``
  ambient medium.
- At most ``MAX_GRAPHED_TRACES`` keys keep a graph; a dropped or evicted
  graph is freed.
- A changed kernel switch starts over with eager calls; a scene with a user
  function or a data surface stays eager and says why; a failed capture
  raises with the launch counters as they were.

This file imports no JAX.
"""

import contextlib
import copy
import weakref

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import cuda_run
from optrace_tpu_torch.parallel import graph as graph_mod
from optrace_tpu_torch.utils import tracing
from optrace_tpu_torch.parallel.graph import CapturedStep
from optrace_tpu_torch.presets.geometry import double_gauss
from optrace_tpu_torch.tracer import raytracer as rt_mod, trace_core
from optrace_tpu_torch.tracer.raytracer import MAX_GRAPHED_TRACES, TRACE_CAPTURE_CALL

from test_torch_graph_step import (_HostDataRecorder, _StandInGraph, _StandInStream, _source_scene,
                                   lens_rt)

K = TRACE_CAPTURE_CALL
N = 3000
go = otp.global_options


class _Graph(_StandInGraph):
    """The stand-in graph, told which step replays by the wrapper of
    ``CapturedStep.__call__`` below; its capture fails on request."""

    capturing = replaying = fail = False

    def capture_begin(self, **kw):
        _Graph.capturing = True

    def capture_end(self):
        _Graph.capturing = False

    def replay(self):
        _Graph.replaying = True
        try:
            super().replay()
        finally:
            _Graph.replaying = False


@pytest.fixture
def graphed(monkeypatch):
    """A raytracer on the CPU captures its traces as it would on a CUDA
    device, into ``_Graph``; kernel 1's wrapper counts the runs of the
    plain version as it counts its launches (a replay adds the captured
    ones)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(rt_mod, "capture", lambda fn, device, **kw: CapturedStep(fn, device, **kw))
    real_call, real_run = CapturedStep.__call__, trace_core.conic_run

    def call(self, gen):
        _Graph.step = self
        try:
            return real_call(self, gen)
        finally:
            _Graph.step = None

    def counted(p, s, w, n_tab, med_idx, steps, pol=None, store=True, plan=None, out=None):
        if not _Graph.replaying:
            f = cuda_run.conic_run
            f.launches += 1
            v = (pol is not None, bool(store))
            f.variant_launches[v] = f.variant_launches.get(v, 0) + 1
            if _Graph.capturing and _Graph.fail:
                raise RuntimeError("operation not permitted when stream is capturing")
        return real_run(p, s, w, n_tab, med_idx, steps, pol=pol, store=store, plan=plan, out=out)

    monkeypatch.setattr(CapturedStep, "__call__", call)
    monkeypatch.setattr(trace_core, "conic_run", counted)
    tracing.reset_counts()
    yield
    _Graph.fail = False
    tracing.reset_counts()


def dg_scene(no_pol):
    """The double Gauss of ``presets/geometry.py`` (runs of 6 and 8) with a
    small converging source."""
    RT = otp.Raytracer(outline=[-150, 150, -150, 150, -60, 180], no_pol=no_pol, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=10), divergence="Isotropic", orientation="Converging",
                         conv_pos=[0, 0, 200], div_angle=1.0, pos=[0, 0, -50],
                         spectrum=otp.presets.light_spectrum.d65))
    RT.add(double_gauss())
    return RT


def steps_scene(no_pol=False):
    """An image source, a filter, the double Gauss with HURB at its ring
    aperture and an ideal lens."""
    RT = otp.Raytracer(outline=[-150, 150, -150, 150, -60, 250], no_pol=no_pol, use_hurb=True,
                       device="cpu")
    RT.add(otp.RaySource(otp.presets.image.color_checker([30, 20]), divergence="Isotropic",
                         orientation="Converging", conv_pos=[0, 0, 0], div_angle=1.0, pos=[0, 0, -50]))
    RT.add(otp.Filter(otp.CircularSurface(r=45), pos=[0, 0, -20],
                      spectrum=otp.TransmissionSpectrum("Gaussian", mu=550.0, sig=60.0, val=0.9)))
    G = double_gauss(with_detector=False)
    RT.add(G)
    z_last = max(L.back.pos[2] for L in G.lenses)
    RT.add(otp.IdealLens(r=35, D=2.0, pos=[0, 0, z_last + 3.0]))
    return RT


SCENES = {"no_pol": lambda: dg_scene(True), "pol": lambda: dg_scene(False), "steps_hurb": steps_scene}


def trace(RT, n=N):
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(n)
    return RT


def _bits(t):
    return t.view(torch.int32) if t is not None and t.dtype == torch.float32 else t


def assert_same_trace(a, b):
    for k, t in a.rays._dev.items():
        u = b.rays._dev[k]
        assert (t is None) == (u is None), k
        assert t is None or torch.equal(_bits(t), _bits(u)), k
    assert np.array_equal(a._msgs, b._msgs)


def fresh_trace(scene, seed, n=N):
    fresh = scene()
    fresh._seed_counter = seed
    trace(fresh, n)
    assert getattr(fresh._trace_entry(n).run, "graph", None) is None
    return fresh


@pytest.mark.parametrize("name", list(SCENES))
def test_replayed_traces_equal_a_fresh_raytracers_eager_trace(graphed, name):
    scene = SCENES[name]
    RT = scene()
    runs = len([k for k, _ in trace_core._partition_runs(RT._build_steps(), [], RT.use_hurb) if k == "run"])
    assert runs == 2
    for call in range(1, K + 2):
        seed = RT._seed_counter
        tracing.reset_counts()
        trace(RT)
        # kernel 1 counted as often as the eager trace launches it
        assert cuda_run.conic_run.variant_launches == {(not RT.no_pol, True): runs}
        entry = RT._trace_entry(N)
        assert entry.graphed and entry.eager_reason is None
        assert (entry.run.graph is not None) == (call >= K)
        if call in (1, K, K + 1):
            assert_same_trace(RT, fresh_trace(scene, seed))
            assert RT.check_if_rays_are_current()
    assert float(RT.rays._dev["w"][:, -2].sum()) > 0


def test_a_held_storage_does_not_change_when_a_later_trace_replays(graphed):
    RT = dg_scene(True)
    for _ in range(K):
        trace(RT)
    step = RT._trace_entry(N).run
    assert step.graph is not None
    held = copy.copy(RT.rays)
    kept = {k: t.clone() for k, t in held._dev.items() if t is not None}
    for _ in range(2):
        trace(RT)
        assert step.graph is not None
    for k, t in kept.items():
        assert torch.equal(_bits(held._dev[k]), _bits(t)), k
    assert np.array_equal(held.p_list, kept["p"].double().numpy())
    assert not torch.equal(RT.rays._dev["p"], kept["p"])
    statics = {t.data_ptr() for t in graph_mod._tensors(step._static)}
    assert not statics & {t.data_ptr() for t in RT.rays._dev.values() if t is not None}


def _data_ambient_scene():
    wls = np.linspace(380.0, 780.0, 41)
    RT = lens_rt()
    RT.n0 = otp.RefractionIndex("Data", wls=wls, vals=np.linspace(1.0005, 1.0002, 41))
    return RT


@pytest.mark.parametrize("kind", ["lens", "image", "lines", "data", "data_ambient"])
def test_a_trace_after_the_first_makes_nothing_from_host_data(kind):
    """What a trace needs besides its rays is made with its entry or at its
    first call, so a later call, which a CUDA graph replays, makes no
    tensor from host data; the ambient medium included."""
    RT = {"lens": lens_rt, "data_ambient": _data_ambient_scene}.get(kind, lambda: _source_scene(kind))()
    trace(RT)
    first = RT.rays._dev["p"]
    rec = _HostDataRecorder()
    with rec:
        trace(RT)
    assert rec.made == []
    assert float(RT.rays._dev["w"][:, -2].sum()) > 0 and not torch.equal(RT.rays._dev["p"], first)


def test_at_most_max_graphed_traces_keep_a_graph_and_evicted_graphs_are_freed(graphed, monkeypatch):
    RT = dg_scene(True)
    graphs = []
    for i, n in enumerate(range(500, 500 + MAX_GRAPHED_TRACES + 2)):
        for _ in range(K):
            trace(RT, n)
        graphs.append(weakref.ref(RT._trace_entry(n).run.graph))
        held = [e for e in RT._trace_cache.values() if e.run.graph is not None]
        assert len(held) == min(i + 1, MAX_GRAPHED_TRACES) and held[-1] is RT._trace_entry(n)
    # the least recently used lost their graphs, which are freed
    assert [g() is None for g in graphs] == [True, True] + [False] * MAX_GRAPHED_TRACES
    # a dropped entry traces eagerly, and captures again at its K-th call
    trace(RT, 500)
    step = RT._trace_entry(500).run
    assert step.graph is None and graphs[0]() is None
    for call in range(2, K + 1):
        trace(RT, 500)
        assert (step.graph is not None) == (call == K)
    # an entry evicted from the trace cache takes its graph with it
    monkeypatch.setattr(rt_mod, "TRACE_CACHE_SIZE", 3)
    kept = weakref.ref(step.graph)
    for n in (700, 701, 702):
        trace(RT, n)
    assert kept() is None and len(RT._trace_cache) == 3


def test_a_changed_kernel_switch_starts_over_eagerly(graphed):
    RT = dg_scene(True)
    for _ in range(K):
        trace(RT)
    step = RT._trace_entry(N).run
    assert step.graph is not None
    fuse = go.cuda_fuse_planar
    try:
        go.cuda_fuse_planar = not fuse
        for call in range(1, K + 1):
            seed = RT._seed_counter
            trace(RT)
            assert (step.graph is not None) == (call == K)
        assert_same_trace(RT, fresh_trace(lambda: dg_scene(True), seed))
    finally:
        go.cuda_fuse_planar = fuse
    trace(RT)
    assert step.graph is None


def _function_surface_scene():
    RT = lens_rt()
    RT.remove(RT.lenses[0])
    RT.add(otp.Lens(otp.FunctionSurface2D(r=3, func=lambda x, y: 0.02 * torch.cos(2 * x)),
                    otp.SphericalSurface(r=3, R=-20), n=otp.RefractionIndex("Constant", n=1.5),
                    pos=[0, 0, 10], d=1.5))
    return RT


def _function_index_scene():
    RT = lens_rt()
    RT.lenses[0].n = otp.RefractionIndex("Function", func=lambda wl: 1.5 + 0 * wl)
    return RT


@pytest.mark.parametrize("scene, reason", [(_function_surface_scene, "function or data surface"),
                                           (_function_index_scene, "user function")])
def test_a_scene_with_user_code_stays_eager_and_says_why(graphed, scene, reason):
    """Decided from the scene before any capture: the entry's trace is the
    eager function, whatever the number of calls."""
    RT = trace(scene(), 500)
    entry = RT._trace_entry(500)
    assert not entry.graphed and reason in entry.eager_reason
    seed = RT._seed_counter
    trace(RT, 500)
    assert RT._trace_entry(500).run is entry.run
    assert_same_trace(RT, fresh_trace(scene, seed, 500))


def test_the_cpu_traces_eagerly():
    RT = trace(lens_rt())
    entry = RT._trace_entry(N)
    assert not entry.graphed and "runs eagerly" in entry.eager_reason


def test_a_failed_capture_raises_with_the_counters_as_they_were(graphed):
    RT = dg_scene(True)
    for _ in range(K - 1):
        trace(RT)
    step = RT._trace_entry(N).run
    assert step.captures_next
    before = tracing.counts()
    _Graph.fail = True
    with pytest.raises(RuntimeError, match="capture of the stored trace"):
        trace(RT)
    assert tracing.counts() == before and step.graph is None
