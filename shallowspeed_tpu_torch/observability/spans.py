"""Profiling spans: wall-clock + torch profiler range context managers —
the port's counterpart of ``shallowspeed_tpu/observability/spans.py``.

A span marks a named phase of host-side work — schedule lowering, device
put, an epoch's execution — in BOTH observability planes at once:

- wall-clock: the duration lands in the bound metrics recorder as a
  ``span`` record carrying the span's nesting path (``"train_run/epoch"``)
  and depth, so phase timings are queryable from the JSONL stream;
- profiler traces: the span body runs under
  ``torch.profiler.record_function(name)`` (the JAX module's
  ``TraceAnnotation``), so inside a ``capture(logdir)`` the phase is a
  labeled range on the host timeline of the Kineto trace that
  ``observability.trace_stats`` analyzes; when this process holds a CUDA
  context it also runs under a ``torch.cuda.nvtx`` range, which Nsight
  tools read.

Nesting is tracked per-thread: entering a span pushes its name on a
thread-local stack, so concurrently-profiled threads never corrupt each
other's paths.

The program trace (``recording``, ``program_span``, ``spanned``, ``add``) is the
port's own in-memory trace, for timing the program from inside without a
profiler. It is off unless a ``recording()`` block is open; then every
span site of the program (``program_span(name)``, and ``NullMetrics.span``
and every recorder-bound ``Span``) closes one record into the block's
``Trace``, and ``add(name, value)`` sums a counter there. The switch is
the module variable ``TRACE`` (that Trace, or None): off, a site costs one
test of it and returns one shared no-op context manager: no clock read, no
stack push, no record. A record is ``(name, span_id, parent_id, start_ns,
end_ns, thread)``: ids count from 1 in this process (parent 0: none open
on the thread), ``thread`` the ``threading.get_ident()`` of the thread
that ran it. Start and end are ``time.time_ns()``, the clock
``torch.profiler`` stamps its events with, so ``start_ns -
prof.profiler.kineto_results.trace_start_ns()`` places a span on a
profiler trace's timeline (``time_range`` is microseconds from there). The
device's events reach that clock through CUPTI's conversion, which on an
H100 has sat up to ~1.3 ms off it in a stretch: check a stretch's
alignment before charging device time to spans.
A ``Trace`` keeps ``cap`` spans (and one more for each other thread that
closes a span at that moment); later ones are counted in ``dropped``.

``capture(logdir, metrics)`` wraps ``torch.profiler.profile`` (CPU and, on
a CUDA session, CUDA activities) and exports the trace into ``logdir`` as
``<host>_<pid>.<ns>.pt.trace.json.gz``. On a CUDA session a capture that
recorded no device event raises instead of writing a host-only trace: a
trace without its device timeline would read as an idle card.
"""

import contextlib
import functools
import gzip
import itertools
import json
import os
import shutil
import socket
import threading
import time

import torch

from shallowspeed_tpu_torch.observability.trace_stats import device_events

_tls = threading.local()


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _cuda_session():
    """True when this process holds a CUDA context (it has used the card)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


# -- the program trace --------------------------------------------------------

CAP = 1 << 20  # spans a Trace keeps by default

# the switch: the Trace that fills while a recording() block is open, else
# None; only recording() sets it, and every site tests it (read it once)
TRACE = None
_lock = threading.Lock()  # guards the switch and a Trace's dropped count
_ids = itertools.count(1)


class _Null:
    """The shared no-op context manager every site returns while off (and
    ``NullMetrics.timer``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()


class Trace:
    """What one ``recording()`` block collected: ``spans``, the closed
    records in closing order; ``counters``, name -> sum of ``add``;
    ``dropped``, the spans closed after ``cap`` were kept.

    The hot path takes no lock: a span is appended while the list is
    shorter than ``cap`` (so threads closing spans at once may each add one
    past it), and each thread sums its counters in a dict of its own."""

    __slots__ = ("spans", "dropped", "cap", "_counts")

    def __init__(self, cap=CAP):
        if cap < 0:
            raise ValueError(f"cap must be >= 0, got {cap}")
        self.spans = []
        self.dropped = 0
        self.cap = cap
        self._counts = {}  # thread id -> {name: sum}, each written by its thread alone

    @property
    def counters(self):
        out = {}
        for counts in list(self._counts.values()):
            for name, value in list(counts.items()):
                out[name] = out.get(name, 0) + value
        return out

    def snapshot(self):
        """A copy as plain data: ``{"spans": [record, ...], "counters":
        {name: sum}, "dropped": n}``."""
        return {"spans": list(self.spans), "counters": self.counters, "dropped": self.dropped}


def _id_stack():
    ids = getattr(_tls, "ids", None)
    if ids is None:
        ids = _tls.ids = []
    return ids


class _Open:
    """One span of the program trace: its id and parent are taken on entry,
    its record is written once, on exit, into the Trace it was opened in."""

    __slots__ = ("name", "trace", "sid", "parent", "t0")

    def __init__(self, name, trace):
        self.name = name
        self.trace = trace

    def __enter__(self):
        ids = _id_stack()
        self.parent = ids[-1] if ids else 0
        self.sid = next(_ids)
        ids.append(self.sid)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.time_ns()
        ids = _id_stack()
        if ids and ids[-1] == self.sid:
            ids.pop()
        tr = self.trace
        if len(tr.spans) < tr.cap:
            tr.spans.append(
                (self.name, self.sid, self.parent, self.t0, t1, threading.get_ident())
            )
        else:
            with _lock:
                tr.dropped += 1
        return False


def program_span(name):
    """A span of the program trace: ``with program_span("trainer.step"):``.
    While the trace is off, the shared no-op."""
    tr = TRACE  # read once: another thread may switch the trace off meanwhile
    if tr is None:
        return _NULL
    return _Open(name, tr)


def spanned(name):
    """Decorator: each call of the function runs inside ``program_span(name)``
    (while the trace is off, the call goes straight through)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            tr = TRACE
            if tr is None:
                return fn(*args, **kwargs)
            with _Open(name, tr):
                return fn(*args, **kwargs)

        return run

    return wrap


def add(name, value=1):
    """Add ``value`` to the program trace's counter ``name``; nothing while
    the trace is off."""
    tr = TRACE
    if tr is not None:
        me = threading.get_ident()
        counts = tr._counts.get(me)
        if counts is None:
            counts = tr._counts.setdefault(me, {})
        counts[name] = counts.get(name, 0) + value


@contextlib.contextmanager
def recording(cap=CAP):
    """Switch the program trace on for the block; yields the ``Trace`` that
    fills, whole once the block has closed. One block at a time per
    process."""
    global TRACE
    tr = Trace(cap)
    with _lock:
        if TRACE is not None:
            raise RuntimeError("the program trace is already recording")
        TRACE = tr
    try:
        yield tr
    finally:
        with _lock:
            TRACE = None


class Span:
    """Context manager timing one named phase (optionally into a recorder).

    Usable standalone (``with span("lower"): ...`` then ``.seconds``) or
    bound to a ``MetricsRecorder`` via ``metrics.span(name)``, which records
    a ``span`` record on exit. Re-entrant use of one instance is not
    supported — create one per ``with``.
    """

    __slots__ = (
        "name", "metrics", "path", "depth", "seconds", "_t0", "_ann", "_nvtx", "_prog",
    )

    def __init__(self, name, metrics=None):
        self.name = name
        self.metrics = metrics
        self.path = None
        self.depth = None
        self.seconds = None

    def __enter__(self):
        stack = _stack()
        self.depth = len(stack)
        self.path = "/".join(stack + [self.name])
        # enter the range BEFORE pushing: if it raises, __exit__ never
        # runs, and a pushed-but-never-popped name would corrupt every later
        # span's path in this thread for the rest of the process
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self._nvtx = _cuda_session()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        stack.append(self.name)
        # while the program trace records, the span lands there too
        self._prog = program_span(self.name)
        self._prog.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        self._prog.__exit__(exc_type, exc, tb)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._ann.__exit__(exc_type, exc, tb)
        stack = _stack()
        # tolerate a corrupted stack (an unexited inner span after an
        # exception mid-body) rather than raising during unwinding
        if stack and stack[-1] == self.name:
            stack.pop()
        if self.metrics is not None:
            self.metrics._record_span(self)
        return False


def span(name, metrics=None):
    """Free-function spelling: ``with span("device_put"): ...``."""
    return Span(name, metrics=metrics)


def capture(logdir, metrics=None, cuda=None):
    """A ``torch.profiler`` capture into ``logdir`` (None = no-op, so call
    sites need no conditional). ``cuda``: record the CUDA activity and
    require device events (default: when this process holds a CUDA
    context). When a recorder is given, a ``profiler_capture`` event (with
    the logdir, the trace file and the capture's wall seconds) is recorded
    on exit — the metrics stream then names the trace artifact that
    ``observability.trace_stats`` can analyze."""
    if not logdir:
        return contextlib.nullcontext()
    return _Capture(str(logdir), metrics, _cuda_session() if cuda is None else bool(cuda))


class _Capture:
    __slots__ = ("logdir", "metrics", "cuda", "path", "_prof", "_t0")

    def __init__(self, logdir, metrics, cuda):
        self.logdir = logdir
        self.metrics = metrics
        self.cuda = cuda
        self.path = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        self._prof.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        os.makedirs(self.logdir, exist_ok=True)
        stem = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        raw = os.path.join(self.logdir, stem)
        self._prof.export_chrome_trace(raw)
        try:
            with open(raw, encoding="utf-8") as f:
                n_dev = len(device_events(json.load(f)))
            if self.cuda and n_dev == 0:
                raise RuntimeError(
                    "torch.profiler recorded no device event (kernel, memcpy "
                    "or memset) on a CUDA session: CUPTI tracing is missing "
                    "or dropped every event — refusing to write a host-only "
                    "trace, which would read as an idle card"
                )
            self.path = raw + ".gz"
            with open(raw, "rb") as src, gzip.open(self.path, "wb") as dst:
                shutil.copyfileobj(src, dst)
        finally:
            os.remove(raw)
        if self.metrics is not None:
            self.metrics.event(
                "profiler_capture", logdir=self.logdir, trace=self.path,
                seconds=seconds, device_events=n_dev,
            )
        return False
