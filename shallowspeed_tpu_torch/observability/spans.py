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

``capture(logdir, metrics)`` wraps ``torch.profiler.profile`` (CPU and, on
a CUDA session, CUDA activities) and exports the trace into ``logdir`` as
``<host>_<pid>.<ns>.pt.trace.json.gz``. On a CUDA session a capture that
recorded no device event raises instead of writing a host-only trace: a
trace without its device timeline would read as an idle card.
"""

import contextlib
import gzip
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


class Span:
    """Context manager timing one named phase (optionally into a recorder).

    Usable standalone (``with span("lower"): ...`` then ``.seconds``) or
    bound to a ``MetricsRecorder`` via ``metrics.span(name)``, which records
    a ``span`` record on exit. Re-entrant use of one instance is not
    supported — create one per ``with``.
    """

    __slots__ = ("name", "metrics", "path", "depth", "seconds", "_t0", "_ann", "_nvtx")

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
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
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
