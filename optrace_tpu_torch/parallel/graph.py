"""A render step or a stored trace captured once into a CUDA graph and
replayed: the port's counterpart of the ``jax.jit`` that the JAX package
puts around each batch of its fused render (``optrace_tpu/tracer/raytracer.py``:
``iterative_render`` and ``render_huge``; ``optrace_tpu/parallel/render.py``:
the sharded step) and around the stored trace of one scene and N
(``optrace_tpu/tracer/raytracer.py:_get_trace_fn``; the port's
``Raytracer._trace_entry``).

A batch of the fused render is some 650 small eager launches around the
two kernels, a stored trace some 550 to 630; replayed as one graph, the
host launches it once. A step on a CUDA device (:class:`CapturedStep`) runs
its first calls eagerly (one for a render step), which is the warm-up: the
runs' step tables and frame offsets are prepared and the kernels'
libraries are loaded. The next call captures the
step on a side stream (``CUDAGraph.capture_begin``/``capture_end``), and
every later call replays it on the caller's stream. A replay keeps the
eager contract: with the generator of a batch it returns the image and
INFOS of the eager step bit for bit, and advances the generator as far.
On the CPU a step stays eager, and so does a step whose caller renders
fewer batches than pay for the capture (:func:`capture`, :data:`MIN_BATCHES`).

What a graph freezes, and how the step answers for it:

- *Random numbers.* A graph draws from one generator registered with it.
  The caller's generator state is copied into it before a replay and back
  after it.
- *Constants made from host data* (a table, a position, a direction) are
  host-to-device copies, which a capture cannot record. The step makes
  them when it is built (the sources' samplers, the media's and filters'
  tables) or at its first batch (the runs' step tables, the frame offsets)
  and keeps them: a batch after the first copies nothing from the host. A
  copy that a batch still makes (a user function's table) stops the
  capture, and the call raises with the operation's message.
- *The scene.* A step compiles its surfaces, the sources' samplers and the
  media's tables when it is built, while an eager call still reads some of
  the sources' attributes; a graph freezes all of it. A step on the card
  therefore refuses to run once the raytracer's snapshot (lenses, filters, apertures,
  sources, outline, ambient medium, trace settings) differs from the one it
  was built with.
- *The kernel switches* (``global_options.cuda_trace``, ``cuda_binning``,
  ``cuda_fuse_planar``), which an eager step reads at every call: when they
  change, the graph is dropped and the next calls warm up and capture
  anew.
- *The launch counters* of the kernel wrappers, and the generic step's
  count of sag evaluations (``geom.generic_sag.sag_evals``), are Python
  counters. The capture's increments are taken back and every replay adds
  them, so a counter counts the launches and evaluations that ran.
- *The outputs* of a graph are its own buffers, which the next replay
  overwrites: a replay returns copies.
- *Memory.* A graph keeps a private pool of device memory for its outputs
  and temporaries (``pool_bytes``) as long as it lives; :meth:`CapturedStep.drop`
  lets go of the graph and the pool with it, and the step warms up anew.

A step that carries a derivative (an output that autograd records or that
holds a forward-mode tangent) stays eager: a graph cannot replay autograd.
If the capture fails on the card, the call raises; nothing runs the eager
step in its place.
"""

import contextlib

import torch
import torch.autograd.forward_ad as fwAD

from ..ops import cuda_binning, cuda_run, cuda_sampling, cuda_trace, geom
from ..utils.global_options import global_options
from ..utils.tracing import span

_COUNTED = ("launches", "variant_launches", "slot_launches", "kind_launches", "sag_evals")


def _wrappers():
    """The kernel wrappers whose attributes count launches, and the generic
    step's sag, whose attribute counts evaluations."""
    return (cuda_run.conic_run, cuda_binning.bin_xyzw_cuda, cuda_trace.conic_step,
            cuda_sampling.srgb_wavelengths, geom.generic_sag)


def launch_counts() -> dict:
    """A copy of every launch counter: {(wrapper, attribute): int or dict}."""
    return {(f, a): (dict(getattr(f, a)) if isinstance(getattr(f, a), dict) else getattr(f, a))
            for f in _wrappers() for a in _COUNTED if hasattr(f, a)}


def _set_counts(counts: dict) -> None:
    for (f, a), v in counts.items():
        setattr(f, a, dict(v) if isinstance(v, dict) else v)


def _count_delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k, {} if isinstance(v, dict) else 0)
        out[k] = {q: n - b.get(q, 0) for q, n in v.items()} if isinstance(v, dict) else v - b
    return out


def _add_counts(delta: dict) -> None:
    for (f, a), v in delta.items():
        if isinstance(v, dict):
            cur = getattr(f, a)
            for q, n in v.items():
                if n:
                    cur[q] = cur.get(q, 0) + n
        else:
            setattr(f, a, getattr(f, a) + v)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(t) for t in tree)
    return tree


def _switches() -> tuple:
    """The kernel switches that a graph freezes."""
    return (global_options.cuda_trace, global_options.cuda_binning, global_options.cuda_fuse_planar)


def _carries_derivative(tree) -> bool:
    return any((t.requires_grad and torch.is_grad_enabled())
               or fwAD.unpack_dual(t).tangent is not None for t in _tensors(tree))


class CapturedStep:
    """A step ``fn(gen) -> outputs`` on a CUDA device: the first
    ``eager_calls`` calls eager, the next captured into a
    ``torch.cuda.CUDAGraph``, every later call a replay (see the module's
    note).

    :param fn: the eager step; it draws every random number from ``gen``
    :param device: the step's CUDA device
    :param scene: a function returning the scene's snapshot, taken when the
        step is built and compared before every call; ``None`` checks nothing
    :param eager_calls: the eager calls before the capture (at least 1)
    :param name: what the step is, for the error of a failed capture
    """

    def __init__(self, fn, device, scene=None, eager_calls=1, name="render step"):
        self.fn, self.device = fn, torch.device(device)
        self.eager_calls, self.name = max(1, int(eager_calls)), name
        self._scene = scene
        self._built = scene() if scene is not None else None
        self._switches = None
        self._reset()

    @property
    def captures_next(self) -> bool:
        """Whether the next call captures (under the kernel switches as
        they are now)."""
        return (self.graph is None and not self._eager_only and self._switches == _switches()
                and self._calls >= self.eager_calls)

    def drop(self):
        """Let go of the graph and its pool: the next calls warm up and
        capture anew."""
        self._reset()

    def _reset(self):
        self.graph = None           # the captured graph, once there is one
        self.pool_bytes = None      # device memory the capture reserved for its pool
        self.captured_launches = None   # the kernel launches of one replay, by counter
        self._gen = self._static = None
        self._calls = 0
        self._eager_only = False

    def __call__(self, gen):
        if self._scene is not None and self._scene() != self._built:
            raise RuntimeError("the scene changed after this render step was built (a lens, "
                               "filter, aperture, source, the outline, the ambient medium or a "
                               "trace setting): build a new step")
        switches = _switches()
        if switches != self._switches:
            self._reset()
            self._switches = switches
        if self.graph is not None:
            with span("graph.replay"):
                return self._replay(gen)
        if self._calls >= self.eager_calls and not self._eager_only:
            with span("graph.capture"):     # with its first replay
                return self._capture(gen)
        self._calls += 1
        with span("graph.eager"):
            out = self.fn(gen)
        self._eager_only = self._eager_only or _carries_derivative(out)
        return out

    def _capture(self, gen):
        if self.device.type == "cuda" and self.device.index is None:    # as a generator names it
            self.device = torch.device("cuda", torch.cuda.current_device())
        if gen.device != self.device:
            raise ValueError(f"the generator lies on {gen.device}, the render on {self.device}")
        graph = torch.cuda.CUDAGraph()
        own = torch.Generator(device=self.device)
        graph.register_generator_state(own)
        before = launch_counts()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            # captured on a side stream by the graph's own capture_begin and
            # capture_end: torch.cuda.graph would also synchronise the device,
            # empty the allocator's cache and may run the garbage collector at
            # every capture. thread_local: a communicator's watchdog thread may
            # query its events while this thread captures
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static = self.fn(own)
                except Exception:
                    with contextlib.suppress(Exception):    # it reports the invalidated capture
                        graph.capture_end()
                    raise
                graph.capture_end()
        except Exception as err:
            _set_counts(before)
            raise RuntimeError(f"the capture of the {self.name} into a CUDA graph failed "
                               f"({type(err).__name__}: {err}); on a CUDA device it "
                               "does not run eagerly instead") from err
        cur.wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.captured_launches = _count_delta(launch_counts(), before)
        _set_counts(before)
        self.graph, self._gen, self._static = graph, own, static
        return self._replay(gen)

    def _replay(self, gen):
        if gen.device != self.device:
            raise ValueError(f"the generator lies on {gen.device}, the render on {self.device}")
        self._gen.set_state(gen.get_state())
        self.graph.replay()
        gen.set_state(self._gen.get_state())
        _add_counts(self.captured_launches)
        return _clone(self._static)


# A capture pays once a call runs enough batches through its step: on the
# H100 an eager double-Gauss batch of 10⁶ rays took 12–16 ms, a replay
# 3.3 ms and the capture with its first replay 0.043 s (PERF.md §5), so one
# eager batch, the capture and n − 2 replays cost less than n eager batches
# from about n = 5 on.
MIN_BATCHES = 6


def capture(fn, device, scene=None, batches=None, eager_calls=1, name="render step"):
    """``fn`` as a :class:`CapturedStep` on a CUDA device; elsewhere ``fn``
    itself, which stays eager. ``batches``, where the caller knows it, is
    the number of calls it makes: below :data:`MIN_BATCHES` the step stays
    eager, since its capture would cost more than it saves."""
    if torch.device(device).type != "cuda" or (batches is not None and batches < MIN_BATCHES):
        return fn
    return CapturedStep(fn, device, scene, eager_calls, name)
