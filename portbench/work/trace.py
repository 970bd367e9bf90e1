"""Arithmetic over a ``torch.profiler`` trace of the traced stretch.

``marked_window`` finds the stretch between two marker kernels,
``gpu_events`` takes every device operation (kernel, memcpy, memset) inside
it, ``union_us`` the time in which at least one ran (a frozen copy
of the profile scripts' busy-interval union), ``idle_gaps`` the intervals
between them, each named by what the host's main thread was running in its
middle, and ``top_ops`` the device time by operation name.
"""

import collections

from torch.autograd import DeviceType


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_of(events, label):
    """``(start_us, end_us, thread)`` of the host span ``label`` (a
    ``record_function``) among the trace's ``events``."""
    for ev in events:
        if ev.name == label and ev.device_type == DeviceType.CPU:
            return ev.time_range.start, ev.time_range.end, ev.thread
    raise RuntimeError(f"the trace holds no span {label!r}")


def marked_window(events, mark):
    """``(start_us, end_us)`` from the end of the first device operation
    whose name holds ``mark`` to the start of the last."""
    marks = sorted(
        (ev.time_range.start, ev.time_range.end)
        for ev in events
        if ev.device_type == DeviceType.CUDA and mark in ev.name
    )
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels {mark!r}, not 2")
    return marks[0][1], marks[-1][0]


def gpu_events(events, window, labels=()):
    """``(name, start_us, end_us)`` of every device operation, clipped to
    ``window``; the device-side ranges the profiler draws for the host spans
    ``labels`` are not operations."""
    out = []
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.name in labels:
            continue
        if getattr(ev, "is_user_annotation", False):
            continue
        s = max(ev.time_range.start, window[0])
        e = min(ev.time_range.end, window[1])
        if e > s:
            out.append((ev.name, s, e))
    return out


def host_events(events, window, thread):
    """``(name, start_us, end_us)`` of the host operations of ``thread``
    that overlap ``window``."""
    return [
        (ev.name, ev.time_range.start, ev.time_range.end)
        for ev in events
        if ev.device_type == DeviceType.CPU
        and ev.thread == thread
        and ev.time_range.end > window[0]
        and ev.time_range.start < window[1]
    ]


def idle_gaps(gpu, window, host, skip=(), top=10):
    """The ``top`` longest intervals of ``window`` in which no device
    operation ran, longest first, as ``(name, seconds)``. ``name`` is the
    innermost host operation running at the gap's middle (the shortest one
    covering it), other than the spans named in ``skip``; where none ran,
    the host was in Python, and the name says which device operation it
    issued next."""
    gaps, end = [], window[0]
    for name, s, e in sorted(gpu, key=lambda g: g[1]):
        if s > end:
            gaps.append((end, s, name))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1], "the end of the stretch"))
    out = []
    for s, e, nxt in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[1] <= mid <= h[2] and h[0] not in skip]
        if cover:
            name = min(cover, key=lambda h: h[2] - h[1])[0]
        else:
            name = f"host: python, then {nxt}"
        out.append((name, 1e-6 * (e - s)))
    return out


def top_ops(gpu):
    """Device seconds by operation name, largest first: ``[(name, s)]``."""
    by_name = collections.defaultdict(float)
    for name, s, e in gpu:
        by_name[name] += e - s
    return [(n, 1e-6 * us) for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])]
