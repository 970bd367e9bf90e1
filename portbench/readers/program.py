"""Per-layer metrics from the port's own program trace
(``shallowspeed_tpu_torch.observability.spans``), one reader for every
metric file that names it; the file's ``quantity`` says which number:

- ``self_ms_per_call``: the self time of the file's ``spans`` (their
  duration less their children's: the device wait and the trainer's or
  executor's step spans) summed over stretch C, per call;
- ``ms_per_step``: the summed duration of the file's ``spans`` over
  stretch C, per trained step;
- ``us_per_launch``: the counters ``cuda_ops.launch_ns`` over
  ``cuda_ops.launches`` in stretch C;
- ``idle_charged_pct``: the idle time of stretch D charged to the file's
  ``layer`` (``work/spans.py``), as a share of stretch D's wall.

On first use the reader runs, on the cell's live session, after the
stretches the other readers read: stretch C, ``trace_chunks`` calls with
the program trace on and no profiler, so the host's numbers carry no
profiler cost; then stretch D, as many with the trace on and
``torch.profiler`` tracing the device alone between two marker kernels,
each issued and waited for inside a span of its own, so the spans land on
the trace's timeline beside the device's operations. Stretch D counts only
where that timeline agrees with the spans' clock (``clock``): each marker
kernel runs inside its span, and each call's device operations run inside
the call, between the start of the span that issues them and the end of
the span that waits for them, each within ``SLACK_US``. A stretch D that
fails this, or lost a marker, is run again, ``ATTEMPTS`` in all; if none
agrees, the idle charges are None, so that a misplaced timeline cannot
move them. What it collects is kept in ``ctx["program"]`` for the other
files. The session is the run's, ``ctx["session"]``. A program without
the trace (no ``spans.recording``), or a ``ctx`` without a session, gives
None for every file, and so does a number whose spans did not run; a
number whose spans ran over no step, call or launch raises.
"""

import gc
import statistics
import sys
import threading
import time

from portbench.work import spans as W
from portbench.work import trace

MARK = "spin_kernel"
MARK_CYCLES = 1000
MARK_SPAN = "portbench.mark"
ISSUER = "session.dispatch"  # the span that issues a call's device work
WAITER = "session.loss_wait"  # the span that waits for it
SLACK_US = 50.0  # how far the device's timeline may sit off the spans' clock
ATTEMPTS = 5  # stretch D's runs before the idle charges are given up


def read(ctx, spec):
    if "program" not in ctx:
        ctx["program"] = collect(ctx)
    prog = ctx["program"]
    if prog is None:
        return None
    return QUANTITIES[spec["quantity"]](prog, spec)


def collect(ctx, log=sys.stderr):
    """Run stretches C and D on the run's session; None when the program
    has no trace or ``ctx`` holds no session."""
    try:
        from shallowspeed_tpu_torch.observability import spans
    except ImportError:
        return None
    if not hasattr(spans, "recording"):
        return None
    session = ctx.get("session")
    if session is None:
        return None
    gc.collect()  # the traced stretches' garbage goes before stretch C, not during it

    chunk, n = ctx["traffic"]["chunk_steps"], ctx["cell"]["trace_chunks"]
    me = threading.get_ident()
    session.train_steps(chunk)
    walls, steps = [], 0
    with spans.recording() as c:
        for _ in range(n):
            t0 = time.perf_counter()
            steps += session.train_steps(chunk)[0]
            walls.append(time.perf_counter() - t0)
    prog = {"c": c.snapshot(), "c_steps": steps, "c_calls": n, "c_walls": walls, "d": None}
    prog["c"]["spans"] = [r for r in prog["c"]["spans"] if r[W.THREAD] == me]
    if session.device.type == "cuda":
        prog["d"] = aligned(lambda: _stretch_d(spans, session, chunk, n, me), log)
    _log(prog, ctx, log)
    return prog


def aligned(run, log=sys.stderr, attempts=ATTEMPTS):
    """The first stretch D of ``run()`` whose timeline agrees with the
    spans' clock (``misaligned`` finds nothing), with its ``clock`` and the
    ``attempts`` it took; None when none of ``attempts`` runs agrees. A run
    that raises ``RuntimeError`` (a marker kernel missing) counts as one
    that disagrees."""
    for k in range(1, attempts + 1):
        try:
            d = run()
        except RuntimeError as e:
            log.write(f"portbench: stretch D, attempt {k}: {e}\n")
            continue
        d["clock"] = clock(d)
        off = misaligned(d["clock"])
        if not off:
            d["attempts"] = k
            return d
        log.write(f"portbench: stretch D, attempt {k}: the clocks disagree: {off}\n")
    log.write(f"portbench: stretch D: no attempt of {attempts} agrees; no idle charges\n")
    return None


def _stretch_d(spans, session, chunk, n, me):
    """Stretch D: ``n`` calls with the trace on, ``torch.profiler`` tracing
    the device alone between two marker kernels, each launched and waited
    for inside a span ``MARK_SPAN``. Returns the window, the spans of
    thread ``me`` and the device's operations on the trace's timeline, and
    the markers' ``(start, end)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with spans.recording() as d:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            session.train_steps(chunk)
            _mark(spans, torch)
            for _ in range(n):
                session.train_steps(chunk)
            _mark(spans, torch)
    events = prof.events()
    window = trace.marked_window(events, MARK)
    records = W.to_timeline(
        [r for r in d.snapshot()["spans"] if r[W.THREAD] == me],
        prof.profiler.kineto_results.trace_start_ns(),
    )
    ops = [(s, e) for name, s, e in trace.gpu_events(events, window) if MARK not in name]
    marks = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in events
        if ev.device_type == trace.DeviceType.CUDA and MARK in ev.name
    )
    return {"window": window, "records": records, "ops": ops, "marks": marks}


def _mark(spans, torch):
    with spans.program_span(MARK_SPAN):
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()


def clock(d):
    """The leads of stretch D's device timeline against its spans, in us
    (on one clock none is below 0): ``marks``, each marker kernel's start
    less its span's start and its span's end less its end; ``calls``,
    ``W.call_leads`` of the calls inside the window (None where their
    operations do not split evenly over them)."""
    recs = d["records"]
    issuers = [r for r in recs if r[W.NAME] == ISSUER]
    waiters = [r for r in recs if r[W.NAME] == WAITER]
    s, e = d["window"]
    inside = [(i, w) for i, w in zip(issuers, waiters) if i[W.START] >= s and w[W.END] <= e]
    spans_m = [r for r in recs if r[W.NAME] == MARK_SPAN]
    return {
        "calls": W.call_leads(inside, d["ops"]),
        "marks": [(a - r[W.START], r[W.END] - b) for (a, b), r in zip(d["marks"], spans_m)],
        "n_marks": (len(d["marks"]), len(spans_m)),
    }


def misaligned(leads, slack=SLACK_US):
    """What of ``clock``'s leads says the timelines disagree: a lead below
    ``-slack``, calls whose operations do not split evenly, or a marker
    kernel without its span; [] where they agree."""
    off = []
    if leads["calls"] is None:
        off.append("the device's operations do not split evenly over the calls")
    else:
        off += [f"call {k} lead {v!r}" for k, v in zip(("first", "last"), leads["calls"])
                if v < -slack]
    if leads["n_marks"] != (2, 2):
        off.append(f"marker kernels and spans {leads['n_marks']}, not (2, 2)")
    for i, pair in enumerate(leads["marks"]):
        off += [f"marker {i} {k} lead {v!r}" for k, v in zip(("start", "end"), pair)
                if v < -slack]
    return off


def _log(prog, ctx, log):
    """The readings no metric carries: the switch's cost, stretch D's idle
    and its charges with ``outside``, the clock check."""
    w = ctx["window"]
    c_per_step = sum(prog["c_walls"]) / prog["c_steps"] if prog["c_steps"] else None
    on_cost = None
    if c_per_step and w["steps"]:
        on_cost = c_per_step / (w["seconds"] / w["steps"]) - 1.0
    line = {
        "c_wall_s_per_call": statistics.median(prog["c_walls"]),
        "c_on_cost": on_cost,
        "dropped": prog["c"]["dropped"],
    }
    d = prog["d"]
    if d is not None:
        s, e = d["window"]
        line["d_idle"] = 1.0 - trace.union_us(d["ops"]) / (e - s)
        line["d_charged"] = {k: v / (e - s) for k, v in _charges(d).items()}
        line["clock"] = d["clock"]
        line["d_attempts"] = d["attempts"]
    log.write(f"portbench: program trace {line!r}\n")


def _charges(d):
    return W.charge_idle(d["records"], d["ops"], d["window"])


def _named(records, names):
    return [r for r in records if r[W.NAME] in names]


def _self_ms_per_call(prog, spec):
    records = prog["c"]["spans"]
    found = _named(records, spec["spans"])
    if not found:
        return None
    if not prog["c_calls"]:
        raise ValueError(f"{spec['spans']} ran, but the stretch counts no call")
    own = W.self_ns(records)
    return sum(own[r[W.SID]] for r in found) / 1e6 / prog["c_calls"]


def _ms_per_step(prog, spec):
    found = _named(prog["c"]["spans"], spec["spans"])
    if not found:
        return None
    if not prog["c_steps"]:
        raise ValueError(f"{spec['spans']} ran, but the stretch counts no step")
    return sum(r[W.END] - r[W.START] for r in found) / 1e6 / prog["c_steps"]


def _us_per_launch(prog, spec):
    ns_name, n_name = spec["counters"]
    counters = prog["c"]["counters"]
    if ns_name not in counters:
        return None
    if not counters.get(n_name):
        raise ValueError(f"{ns_name} counted, but {n_name} counts no launch")
    return counters[ns_name] / 1e3 / counters[n_name]


def _idle_charged_pct(prog, spec):
    d = prog["d"]
    if d is None or not d["records"]:
        return None
    s, e = d["window"]
    if e <= s:
        raise ValueError("the program's spans ran, but stretch D has no length")
    return 100.0 * _charges(d)[spec["layer"]] / (e - s)


QUANTITIES = {
    "self_ms_per_call": _self_ms_per_call,
    "ms_per_step": _ms_per_step,
    "us_per_launch": _us_per_launch,
    "idle_charged_pct": _idle_charged_pct,
}
