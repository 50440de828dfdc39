"""Spans and device intervals of the program, recorded only while a
``torch.profiler`` session records.

- :func:`span` marks a stretch of host work at a layer boundary
  (``"trace.run"``, ``"render_huge.batch"``). While the profiler records, a
  span opens ``torch.profiler.record_function("optrace:" + name)``, so it
  sits on the profile's timeline beside the kernels, and appends a record
  ``(name, t0_ns, t1_ns, parent, root)`` to an in-memory list: the times
  from ``time.perf_counter_ns()``, ``parent`` the index of the enclosing
  span of the same thread (``None`` for an outermost one) and ``root`` the
  index of the outermost one, so that the spans of one call share it.
- :func:`device_interval` times a stretch of device work with a pair of CUDA
  events. Recorded while a CUDA graph is captured, the pair becomes two event
  nodes of the graph, and every replay times the stretch on the device.

Otherwise both return one shared object that does nothing: the cost is one
``torch.autograd._profiler_enabled()`` call. Neither ever synchronizes the
card; a host wait that belongs to the program shows in the span around the
call that waits. The records stay in memory until :func:`reset`; past
:data:`MAX_RECORDS` spans are counted as dropped and not kept. Readers:
:func:`records`, :func:`summary`, :func:`device_ms`, :func:`dropped`.
"""

import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

MAX_RECORDS = 100_000
PREFIX = "optrace:"


class Span(NamedTuple):
    """One finished span: perf_counter nanoseconds at its start and end,
    the index of its parent span and of its outermost one."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    root: int


class _Off:
    """The shared context manager of a span or interval that records nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """The spans of the process, the events of each device interval, and
    the thread-local stack of the open spans."""

    def __init__(self):
        self.spans = []             # Span, or None for a span still open
        self.dropped = 0
        self.generation = 0         # counts resets: a span open across one is not kept
        self.local = threading.local()
        self.events = {}            # (name, device index) -> (start, end): created once, kept
        self.last = {}              # name -> the pair recorded last under it

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def reset(self):
        self.spans, self.dropped, self.last = [], 0, {}
        self.generation += 1


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "label", "index", "t0", "generation", "parent", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.label = torch.profiler.record_function(PREFIX + self.name)
        self.label.__enter__()
        stack = _rec.stack()
        self.generation = _rec.generation
        # the enclosing span that is kept, if any (none that opened before a reset)
        outer = stack[-1] if stack and stack[-1][2] == self.generation else (None, None)
        self.parent, self.root = outer[0], outer[1]
        if len(_rec.spans) < MAX_RECORDS:
            self.index = len(_rec.spans)
            _rec.spans.append(None)
        else:
            self.index = None
            _rec.dropped += 1
        if self.root is None:
            self.root = self.index
        stack.append((self.index if self.index is not None else self.parent, self.root, self.generation))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _rec.stack().pop()
        if self.index is not None and self.generation == _rec.generation:
            _rec.spans[self.index] = Span(self.name, self.t0, t1, self.parent, self.root)
        self.label.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around host work named ``name``: recorded while a
    profiler records, otherwise the shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


class _Interval:
    __slots__ = ("name", "device", "pair")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        key = (self.name, self.device.index if self.device.index is not None else torch.cuda.current_device())
        pair = _rec.events.get(key)
        if pair is None:
            # external: recorded during a capture, the pair becomes event
            # nodes of the graph. The pair of a name is made once and kept,
            # so that no graph outlives the events it records
            pair = _rec.events[key] = tuple(torch.cuda.Event(enable_timing=True, external=True)
                                            for _ in range(2))
        self.pair = pair
        pair[0].record(torch.cuda.current_stream(self.device))
        return None

    def __exit__(self, *exc):
        self.pair[1].record(torch.cuda.current_stream(self.device))
        _rec.last[self.name] = self.pair
        return False


def device_interval(name: str, device):
    """A context manager that times the device work its block enqueues on
    the current CUDA stream of ``device`` (:func:`device_ms`): only while a
    profiler records and on a CUDA device, otherwise the shared no-op."""
    if not _profiler_enabled():
        return _OFF
    device = torch.device(device)
    if device.type != "cuda":
        return _OFF
    return _Interval(name, device)


# ----------------------------------------------------------------------
# readers

def records() -> list:
    """The spans in the order they opened (:class:`Span`), None for one
    still open: a span's ``parent`` and ``root`` are indices into it."""
    return list(_rec.spans)


def dropped() -> int:
    """The spans not kept since the last :func:`reset`, the list being full."""
    return _rec.dropped


def summary() -> dict:
    """``{name: {"count", "total_s", "self_s"}}`` over the finished spans;
    a span's self time is its duration less that of its child spans."""
    spans = _rec.spans
    child_ns = [0] * len(spans)
    for s in spans:
        if s is not None and s.parent is not None:
            child_ns[s.parent] += s.t1_ns - s.t0_ns
    out = {}
    for i, s in enumerate(spans):
        if s is None:
            continue
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        d["count"] += 1
        d["total_s"] += (s.t1_ns - s.t0_ns) * 1e-9
        d["self_s"] += (s.t1_ns - s.t0_ns - child_ns[i]) * 1e-9
    return out


def device_ms(name: str) -> Optional[float]:
    """The device milliseconds between the last pair of events recorded
    under ``name`` (by an eager call or a graph's replay), or None where
    there is none since the last :func:`reset`. Waits for the pair's end."""
    pair = _rec.last.get(name)
    if pair is None:
        return None
    pair[1].synchronize()
    return pair[0].elapsed_time(pair[1])


def reset() -> None:
    """Forget the spans, the count of dropped ones and the last interval of
    each name."""
    _rec.reset()
