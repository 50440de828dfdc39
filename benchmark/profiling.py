"""Reading a ``torch.profiler`` trace of a stretch of operations: the device's
busy time as the union of its operations' intervals inside the stretch, the
kernels by name, and the idle gaps named by what the host was doing."""

from torch.autograd import DeviceType

NAME_CHARS = 120        # kernel names are long template signatures


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def is_kernel(name: str) -> bool:
    """A kernel launch, not a copy or a fill of memory."""
    return not name.startswith(("Memcpy", "Memset"))


def read(prof, label: str) -> dict:
    """The device's side of the stretch that the host label ``label``
    covers: ``window_s``, ``busy_s`` (union of every device operation's
    interval, copies included, inside the stretch), ``launches`` (kernels),
    ``by_name`` {kernel: [count, seconds]} and the ``breakdown`` (the ten
    device operations that took most time; the idle time summed by the
    innermost host operation running at each gap's start, ten largest)."""
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    marks = [e for e in host if e.name == label]
    if not marks:
        raise RuntimeError(f"the profile holds no host label {label!r}")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    # a host label shows on the device's timeline too, as an annotation
    # that spans the kernels it covers: it is no device operation
    labels = {e.name for e in host}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in labels
           and e.time_range.end > lo and e.time_range.start < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation in the stretch")
    iv = [(max(e.time_range.start, lo), e.time_range.end) for e in dev]
    by_name = {}
    for e, (a, b) in zip(dev, iv):
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-6
    # device operations end after the host's label when the host is ahead:
    # the stretch ends with the last of either
    hi_dev = max(hi, max(e.time_range.end for e in dev))
    window_us = hi_dev - lo
    busy_us = _union(iv)

    # idle gaps, named by the innermost host operation that covers their start
    hosts = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                    if e.time_range.end > lo and e.time_range.start < hi_dev), key=lambda t: t[0])
    idle, stack, i = {}, [], 0
    for a, b in _gaps(iv, lo, hi_dev):
        # host operations nest: a stack of the open ones, innermost on top
        while i < len(hosts) and hosts[i][0] <= a:
            while stack and stack[-1][1] <= hosts[i][0]:
                stack.pop()
            stack.append(hosts[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        name = stack[-1][2] if stack else "(host outside any operation)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=window_us * 1e-6, busy_s=busy_us * 1e-6,
                launches=sum(c for n, (c, _) in by_name.items() if is_kernel(n)),
                by_name=by_name,
                breakdown={"device_ops": [[n[:NAME_CHARS], s] for n, (_, s) in top_dev],
                           "idle_gaps": [[n[:NAME_CHARS], s] for n, s in top_idle]})


def seconds_of(prof_read: dict, *needles) -> tuple:
    """(launches, device seconds) of the kernels whose name holds any of
    ``needles``."""
    n, s = 0, 0.0
    for name, (c, sec) in prof_read["by_name"].items():
        if any(k in name for k in needles):
            n += c
            s += sec
    return n, s
