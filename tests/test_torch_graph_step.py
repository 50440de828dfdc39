"""The render step of the port on the CPU (``parallel/render.py``,
``parallel/graph.py``): the step that ``make_fused_render_multi`` builds,
and the capture-and-replay logic of ``CapturedStep`` run against a stand-in
for ``torch.cuda.CUDAGraph``.

- On the CPU ``make_fused_render_multi`` returns the eager step: the same
  generator state in gives the same image and INFOS out, bit for bit, and
  the same advance of the generator.
- ``CapturedStep`` with a stand-in graph whose replay runs the captured
  function again on the generator registered with it, as a CUDA graph's
  replay draws from it: calls 1 (eager), 2 (capture and replay) and 3
  (replay) equal the eager step's, the generator advances as far, a replay
  adds the captured launches to the counters, the returned tiles are the
  caller's own, a changed scene is refused, a changed kernel switch starts
  over with an eager call, a derivative keeps the step eager, and a failed
  capture raises with the counters as they were.
- A batch after the first makes no tensor from host data, for sources,
  media and filters of every kind that holds a table.
- Fewer batches than pay for a capture keep a step eager.
- The sharded step divides by the world size before the all-reduce sums
  (gloo, world 2).
- ``render_huge`` interrupted and resumed equals the uninterrupted render
  bit for bit.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import cuda_binning, cuda_run
from optrace_tpu_torch.parallel import graph as graph_mod
from optrace_tpu_torch.parallel import render as render_mod
from optrace_tpu_torch.parallel.checkpoint import RenderCheckpoint, batch_generator
from optrace_tpu_torch.parallel.graph import CapturedStep
from optrace_tpu_torch.utils import tracing

from torch_sharded_ranks import _init, spawn_ranks

go = otp.global_options
N, NX = 2048, 31
EXT = [-2.0, 2.0, -2.0, 2.0]


def lens_rt():
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -5, 40], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, 0], divergence="Lambertian",
                         div_angle=5, spectrum=otp.presets.light_spectrum.d65))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                    n=otp.RefractionIndex("Constant", n=1.5), pos=[0, 0, 10], d=1.5))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    return RT


CFG = [dict(extent=EXT, Nx=NX, Ny=NX)]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    (ia,), fa = a
    (ib,), fb = b
    return torch.equal(_bits(ia), _bits(ib)) and torch.equal(fa, fb)


def test_cpu_step_is_eager_and_keeps_the_generator_contract():
    RT = lens_rt()
    step, _ = otp.make_fused_render_multi(RT, N, CFG, device="cpu")
    eager, _ = render_mod._eager_fused_render(RT, N, CFG, device="cpu")
    assert not isinstance(step, CapturedStep)
    for b in range(3):
        ga, gb = batch_generator(5, b, "cpu"), batch_generator(5, b, "cpu")
        out_a, out_b = step(ga), eager(gb)
        assert _same(out_a, out_b)
        assert torch.equal(ga.get_state(), gb.get_state())
        assert not torch.equal(ga.get_state(), batch_generator(5, b, "cpu").get_state())
        assert float(out_a[0][0][..., 3].sum()) > 0


class _StandInGraph:
    """Capture records nothing; replay runs the step's function again on the
    generator registered with it and writes the result into the outputs of
    the capture, as a CUDA graph's replay refills its own buffers."""

    step = None
    replays = 0

    def register_generator_state(self, gen):
        self.gen = gen

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        type(self).replays += 1
        out = type(self).step.fn(self.gen)
        for dst, src in zip(graph_mod._tensors(type(self).step._static), graph_mod._tensors(out)):
            dst.copy_(src)


class _StandInStream:
    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """torch.cuda's graph API replaced by _StandInGraph, and a step maker
    that wires the stand-in to its step."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    _StandInGraph.replays = 0

    def make(fn, scene=None):
        step = CapturedStep(fn, "cpu", scene)
        _StandInGraph.step = step
        return step
    return make


def test_captured_step_replays_the_eager_batches(stand_in):
    RT = lens_rt()
    eager, _ = render_mod._eager_fused_render(RT, N, CFG, device="cpu")
    step = stand_in(eager, RT.trace_program_key)
    outs = []
    for b in range(4):
        ga, gb = batch_generator(9, b, "cpu"), batch_generator(9, b, "cpu")
        outs.append(step(ga))
        assert _same(outs[-1], eager(gb))
        assert torch.equal(ga.get_state(), gb.get_state())
        assert (step.graph is None) == (b == 0)
    assert _StandInGraph.replays == 3
    # the tiles are the caller's own: later replays leave them as they were
    kept = outs[1][0][0].clone()
    step(batch_generator(9, 7, "cpu"))
    assert torch.equal(outs[1][0][0], kept)
    assert outs[2][0][0].data_ptr() != step._static[0][0].data_ptr()


def test_replays_count_the_captured_launches(stand_in):
    def fn(gen):
        cuda_run.conic_run.launches += 2
        cuda_run.conic_run.variant_launches[(False, False)] = \
            cuda_run.conic_run.variant_launches.get((False, False), 0) + 2
        cuda_binning.bin_xyzw_cuda.launches += 1
        return [torch.rand(3, generator=gen)], torch.zeros(2)

    step = stand_in(fn)
    tracing.reset_counts()
    try:
        for b in range(4):
            step(batch_generator(0, b, "cpu"))
        # the stand-in's replay runs fn, which counts by itself: take those off
        replayed = _StandInGraph.replays
        assert cuda_run.conic_run.launches - 2 * replayed == 2 * 4
        assert cuda_binning.bin_xyzw_cuda.launches - replayed == 4
        assert cuda_run.conic_run.variant_launches[(False, False)] - 2 * replayed == 2 * 4
        assert step.captured_launches[(cuda_binning.bin_xyzw_cuda, "launches")] == 1
    finally:
        tracing.reset_counts()


def test_a_registered_counter_is_counted_at_every_replay(stand_in):
    """A wrapper that registers its counters with ``utils/tracing.py`` is
    counted by a captured step that names no wrapper: every replay adds what
    its capture counted, an int and a dict alike, and ``reset_counts``
    zeroes both."""
    def wrapper():
        wrapper.launches += 1
        wrapper.by_kind["a"] = wrapper.by_kind.get("a", 0) + 1

    wrapper.launches, wrapper.by_kind = 0, {}
    tracing.counted(wrapper, "launches", "by_kind")

    def fn(gen):
        wrapper()
        return [torch.rand(3, generator=gen)], torch.zeros(2)

    step = stand_in(fn)
    try:
        for b in range(4):
            step(batch_generator(0, b, "cpu"))
        # the stand-in's replay runs fn, which counts by itself: take those off
        replayed = _StandInGraph.replays
        assert replayed == 3
        assert wrapper.launches - replayed == 4 and wrapper.by_kind == {"a": 4 + replayed}
        assert step.captured_launches[(wrapper, "launches")] == 1
        assert step.captured_launches[(wrapper, "by_kind")] == {"a": 1}
        tracing.reset_counts()
        assert wrapper.launches == 0 and wrapper.by_kind == {}
    finally:
        tracing._counters[:] = [c for c in tracing._counters if c[0] is not wrapper]


def test_changed_scene_is_refused_and_switches_start_over(stand_in):
    RT = lens_rt()
    eager, _ = render_mod._eager_fused_render(RT, N, CFG, device="cpu")
    step = stand_in(eager, RT.trace_program_key)
    step(batch_generator(0, 0, "cpu"))
    step(batch_generator(0, 1, "cpu"))
    assert step.graph is not None
    fuse = go.cuda_fuse_planar
    try:
        go.cuda_fuse_planar = not fuse
        step(batch_generator(0, 2, "cpu"))      # eager again under the new switches
        assert step.graph is None
        step(batch_generator(0, 3, "cpu"))
        assert step.graph is not None
    finally:
        go.cuda_fuse_planar = fuse
    lens = RT.lenses[0]
    lens.move_to([0, 0, 10.5])
    with pytest.raises(RuntimeError, match="scene changed"):
        step(batch_generator(0, 4, "cpu"))
    wl = go.wavelength_range
    lens.move_to([0, 0, 10])
    step(batch_generator(0, 4, "cpu"))
    try:
        go.wavelength_range = [370.0, 790.0]
        with pytest.raises(RuntimeError, match="scene changed"):
            step(batch_generator(0, 5, "cpu"))
    finally:
        go.wavelength_range = wl


def test_derivative_keeps_the_step_eager_and_failed_capture_raises(stand_in):
    x = torch.ones(3, requires_grad=True)
    step = stand_in(lambda gen: ([x * torch.rand(3, generator=gen)], torch.zeros(1)))
    for b in range(3):
        out = step(batch_generator(0, b, "cpu"))
        assert out[0][0].requires_grad and step.graph is None

    calls = []

    def fails_under_capture(gen):
        calls.append(1)
        cuda_binning.bin_xyzw_cuda.launches += 1
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return [torch.rand(3, generator=gen)], torch.zeros(1)

    step = stand_in(fails_under_capture)
    step(batch_generator(0, 0, "cpu"))
    before = cuda_binning.bin_xyzw_cuda.launches
    with pytest.raises(RuntimeError, match="capture of the render step"):
        step(batch_generator(0, 1, "cpu"))
    assert cuda_binning.bin_xyzw_cuda.launches == before


def test_too_few_batches_keep_the_step_eager():
    """A caller that renders fewer batches than pay for a capture gets the
    eager step on a CUDA device too; the CPU's step is always eager."""
    def fn(gen):
        return gen
    assert graph_mod.capture(fn, "cpu", batches=100) is fn
    assert graph_mod.capture(fn, "cuda", batches=graph_mod.MIN_BATCHES - 1) is fn
    assert isinstance(graph_mod.capture(fn, "cuda", batches=graph_mod.MIN_BATCHES), CapturedStep)
    assert isinstance(graph_mod.capture(fn, "cuda"), CapturedStep)


class _HostDataRecorder(TorchFunctionMode):
    """Records every tensor made from host data (not from a tensor): what
    a capture on the card cannot record."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.as_tensor, torch.tensor, torch.from_numpy, torch.Tensor.new_tensor)
                and args and not isinstance(args[-1 if func is torch.Tensor.new_tensor else 0],
                                            torch.Tensor)):
            self.made.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _source_scene(kind):
    """The lens scene with a source, medium or filter that holds host tables."""
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -5, 40], no_pol=kind != "lines", device="cpu")
    if kind == "image":
        img = otp.presets.image.color_checker([2, 2])
        RT.add(otp.RaySource(img, pos=[0, 0, 0], divergence="Isotropic", div_angle=4))
    elif kind == "lines":
        RT.add(otp.RaySource(otp.Point(), pos=[0, 0, 0], divergence="Function",
                             div_func=lambda a: np.cos(a), div_angle=5, div_2d=True,
                             polarization="List", pol_angles=[0, 45, 90], pol_probs=[1, 2, 1],
                             spectrum=otp.LightSpectrum("Lines", lines=[486.1, 587.6, 656.3],
                                                        line_vals=[1, 2, 1])))
    else:
        wls = np.linspace(380.0, 780.0, 41)
        RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, 0], orientation="Converging",
                             conv_pos=[0, 0, 20], divergence="Lambertian", div_angle=3,
                             spectrum=otp.LightSpectrum("Data", wls=wls, vals=1 + wls / 400)))
        RT.add(otp.Filter(otp.CircularSurface(r=3), pos=[0, 0, 5],
                          spectrum=otp.TransmissionSpectrum("Data", wls=wls, vals=0.5 + wls / 2000,
                                                            inverse=True)))
    n = otp.RefractionIndex("Data", wls=np.linspace(380.0, 780.0, 41),
                            vals=np.linspace(1.53, 1.51, 41)) if kind == "data" \
        else otp.RefractionIndex("Constant", n=1.5)
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                    n=n, pos=[0, 0, 10], d=1.5))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    return RT


@pytest.mark.parametrize("kind", ["lens", "image", "lines", "data"])
def test_a_batch_after_the_first_makes_nothing_from_host_data(kind):
    """The sources' samplers, the media's and filters' tables and the frame
    offsets are made when the step is built or by its first batch; a later
    batch makes no tensor from host data, which a CUDA graph's capture
    could not record. Sources, media and filters of every kind that holds a
    table are covered."""
    RT = lens_rt() if kind == "lens" else _source_scene(kind)
    step, _ = render_mod._eager_fused_render(RT, N, CFG, device="cpu")
    first = step(batch_generator(1, 0, "cpu"))
    rec = _HostDataRecorder()
    with rec:
        out = step(batch_generator(1, 1, "cpu"))
    assert rec.made == []
    assert float(out[0][0][..., 3].sum()) > 0 and not torch.equal(out[0][0], first[0][0])


def divided_before_the_sum(rank, world, workdir, n, batch_index, seed):
    """A rank of the test below (spawned: this module imports no JAX): the
    tile that the sharded step hands to the all-reduce, the summed tile, and
    the rank's shard rendered by the fused render of its generator."""
    _init(rank, world, workdir)
    real, sent = dist.all_reduce, []

    def recording(t, *args, **kw):
        sent.append(t.clone())
        return real(t, *args, **kw)
    dist.all_reduce = recording
    try:
        mesh = otp.default_mesh(device="cpu")
        step, _ = otp.make_sharded_render(lens_rt(), n, mesh=mesh, extent=EXT, Nx=NX, Ny=NX)
        summed = step(batch_index, seed)
        render, _ = otp.make_fused_render(lens_rt(), n // world, extent=EXT, Nx=NX, Ny=NX,
                                          device="cpu")
        shard = render(batch_generator(seed, batch_index, "cpu", rank))
        np.savez(os.path.join(workdir, f"divided{rank}.npz"), summed=summed.numpy(),
                 sent=sent[0].numpy(), shard=shard.numpy())
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


def test_sharded_step_divides_before_the_sum(tmp_path):
    """World 2 over gloo: each rank hands the all-reduce its shard's image
    divided by 2, and the sum is the two halves'."""
    spawn_ranks(divided_before_the_sum, 2, tmp_path, N, 3, 11)
    tiles = []
    for r in range(2):
        with np.load(tmp_path / f"divided{r}.npz") as d:
            tiles.append({k: d[k] for k in d.files})
    for t in tiles:
        assert np.array_equal(t["summed"], tiles[0]["summed"]) and t["shard"].sum() > 0
        assert np.array_equal(t["sent"], t["shard"] / np.float32(2))
    assert not np.array_equal(tiles[0]["shard"], tiles[1]["shard"])
    assert np.array_equal(tiles[0]["summed"], tiles[0]["sent"] + tiles[1]["sent"])


def test_resumed_render_huge_is_bit_equal(tmp_path):
    class Interrupted(Exception):
        pass

    path = str(tmp_path / "h.ckpt.npz")
    kw = dict(batch_size=N, extent=EXT, checkpoint_every=1)
    full = lens_rt().render_huge(4 * N, **kw)
    real_save = RenderCheckpoint.save

    def save_then_stop(self):
        real_save(self)
        if self.done == 2:
            raise Interrupted
    RenderCheckpoint.save = save_then_stop
    try:
        with pytest.raises(Interrupted):
            lens_rt().render_huge(4 * N, checkpoint_path=path, **kw)
    finally:
        RenderCheckpoint.save = real_save
    resumed = lens_rt().render_huge(4 * N, checkpoint_path=path, **kw)
    assert np.array_equal(resumed.data, full.data) and full.power() > 0
