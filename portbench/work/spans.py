"""Arithmetic over the port's program trace: the records that
``shallowspeed_tpu_torch.observability.spans.recording`` collects, as plain
tuples ``(name, span_id, parent_id, start_ns, end_ns, thread)``, read
beside a device trace. Nothing here imports the port.

``self_ns`` gives each span's self time (its duration less the union of its
children's), ``to_timeline`` moves spans onto a ``torch.profiler`` trace's
timeline in microseconds, and ``charge_idle`` charges each idle moment of a
stretch, where no device operation runs, to the layer of the innermost span
open on one thread at that moment (``LAYERS``, by name prefix), or to
``OUTSIDE`` where none of them is open.
"""

from portbench.work.trace import union_us  # unit-free, whatever its name says

# each layer of PERF.md's list and the span names it owns, by prefix
LAYERS = (
    ("Session", ("train_steps", "session.")),
    ("Trainer", ("trainer.", "optimizer.")),
    ("Executor", ("executor.",)),
)
OUTSIDE = "outside"

NAME, SID, PARENT, START, END, THREAD = range(6)


def layer_of(name):
    """The layer that owns span ``name``, or None."""
    for layer, prefixes in LAYERS:
        if name.startswith(prefixes):
            return layer
    return None


def self_ns(records):
    """``{span_id: self time}``: each span's duration less the union of its
    children's intervals, clipped to it."""
    children = {}
    for r in records:
        children.setdefault(r[PARENT], []).append(r)
    out = {}
    for r in records:
        kids = [(max(k[START], r[START]), min(k[END], r[END])) for k in children.get(r[SID], ())]
        out[r[SID]] = (r[END] - r[START]) - union_us([iv for iv in kids if iv[1] > iv[0]])
    return out


def to_timeline(records, trace_start_ns):
    """The records with start and end in microseconds from a profiler
    trace's start (``kineto_results.trace_start_ns()``), the unit and origin
    of its events' ``time_range``."""
    return [
        r[:START] + ((r[START] - trace_start_ns) / 1e3, (r[END] - trace_start_ns) / 1e3) + r[THREAD:]
        for r in records
    ]


def idle_intervals(busy, window):
    """The parts of ``window`` that no ``(start, end)`` of ``busy`` covers,
    in order."""
    out, end = [], window[0]
    for s, e in sorted(busy):
        if s > end:
            out.append((end, min(s, window[1])))
        end = max(end, e)
        if end >= window[1]:
            break
    if end < window[1]:
        out.append((end, window[1]))
    return [(s, e) for s, e in out if e > s]


def _layer_segments(records, window):
    """``[(start, end, layer)]`` covering ``window``: the layer of the
    innermost open span with a layer (or of the nearest enclosing one that
    has one), ``OUTSIDE`` where none is open. The records are one thread's,
    so they nest; at one instant ends come before starts, a child's end
    before its parent's, a parent's start before its child's."""
    events = []
    for r in records:
        events.append((r[START], 1, r[SID], r))
        events.append((r[END], 0, -r[SID], r))
    events.sort(key=lambda ev: ev[:3])
    segments, stack, t = [], [], window[0]

    def current():
        return stack[-1][1] if stack else OUTSIDE

    for at, is_start, _, r in events:
        at = min(max(at, window[0]), window[1])
        if at > t:
            segments.append((t, at, current()))
            t = at
        if is_start:
            stack.append((r[SID], layer_of(r[NAME]) or current()))
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == r[SID]:
                    del stack[i]
                    break
    if window[1] > t:
        segments.append((t, window[1], current()))
    return segments


def charge_idle(records, busy, window):
    """``{layer: idle time}`` for every layer of ``LAYERS`` and ``OUTSIDE``:
    each idle moment of ``window`` (no interval of ``busy`` running) charged
    to the layer of the innermost open span of ``records`` (one thread's,
    on the same timeline as ``busy`` and ``window``). The charges add up to
    the window's idle time."""
    charges = dict.fromkeys([layer for layer, _ in LAYERS] + [OUTSIDE], 0.0)
    idle = idle_intervals(busy, window)
    segments = _layer_segments(records, window)
    i = j = 0
    while i < len(idle) and j < len(segments):
        s = max(idle[i][0], segments[j][0])
        e = min(idle[i][1], segments[j][1])
        if e > s:
            charges[segments[j][2]] += e - s
        if idle[i][1] <= segments[j][1]:
            i += 1
        else:
            j += 1
    return charges


def call_leads(calls, ops):
    """The clock check of a stretch of ``len(calls)`` calls that issue
    ``len(ops) / len(calls)`` device operations each, every call waiting on
    the device before it returns: ``(first, last)``, the smallest over the
    calls of (its first operation's start less the start of ``calls[i][0]``,
    the span that issues it) and of (the end of ``calls[i][1]``, the span
    that waits for it, less its last operation's end), in the unit of the
    timeline. On one clock both are at least 0; None when the operations
    do not split evenly."""
    if not calls or len(ops) % len(calls):
        return None
    n = len(ops) // len(calls)
    ops = sorted(ops)
    first = min(ops[i * n][0] - issuer[START] for i, (issuer, _) in enumerate(calls))
    last = min(waiter[END] - max(e for _, e in ops[i * n : (i + 1) * n])
               for i, (_, waiter) in enumerate(calls))
    return first, last
