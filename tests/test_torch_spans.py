"""The port's program trace (``observability/spans.py``: ``recording``,
``program_span``, ``spanned``, ``add``) and its sites in the session, the
trainer, the executor and the kernel wrappers, on the CPU.

Off, every site is the one shared no-op and nothing is recorded. On, spans
nest by parent id per thread, close on an exception, stop at the cap with
a count of those dropped, and sit on ``torch.profiler``'s timeline. A
session's tree in the benchmark's three layouts (the 4-microbatch loop,
the fused epoch kernel, PP=4 GPipe on the flag kernels) has the expected
names, counts and parents per step, and the weights it trains are bitwise
those of the same steps with the trace off."""

import collections
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from shallowspeed_tpu_torch import cuda_ops
from shallowspeed_tpu_torch.api import TrainingSession
from shallowspeed_tpu_torch.observability import JsonlMetrics, read_jsonl, spans
from shallowspeed_tpu_torch.observability.metrics import NullMetrics

NB = 4  # batches of the split
STEPS = 2  # steps a traced call trains

# the benchmark's three layouts, at widths the CPU trains in milliseconds
LAYOUTS = {
    "4-microbatch": dict(sizes=(784, 32, 32, 10)),
    "epoch-kernel": dict(sizes=(784, 32, 32, 10), fuse_mubatches=True, epoch_kernel=True),
    "pp4-gpipe-pallas": dict(
        sizes=(784,) + (32,) * 6 + (10,), pp=4, schedule="gpipe", kernel_backend="pallas"
    ),
}
# spans a step opens in each layout (the epoch kernel's one span covers the call)
PER_STEP = {
    "4-microbatch": {"trainer.step": 1},
    "epoch-kernel": {},
    "pp4-gpipe-pallas": {"executor.step": 1},
}
PER_CALL = {"train_steps": 1, "session.dispatch": 1, "session.loss_wait": 1}
PARENT = {
    "session.dispatch": "train_steps",
    "session.loss_wait": "train_steps",
    "trainer.step": "session.dispatch",
    "trainer.epoch_kernel": "session.dispatch",
    "executor.step": "session.dispatch",
}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("split")
    rng = np.random.RandomState(0)
    centers = rng.normal(0, 1.0, (10, 784)).astype(np.float32)
    for suffix, n in (("train", NB * 128), ("val", 64)):
        labels = rng.randint(0, 10, n)
        x = centers[labels] + rng.normal(0, 2.0, (n, 784)).astype(np.float32)
        np.save(path / f"x_{suffix}.npy", np.clip((x + 8.0) / 16.0, 0.0, 1.0).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[labels])
    return path


def _session(split, layout, **kw):
    return TrainingSession(data_dir=str(split), device="cpu", **LAYOUTS[layout], **kw)


def _names(trace):
    return collections.Counter(rec[0] for rec in trace.spans)


class _Refused:
    def __init__(self, *args):
        raise AssertionError("a span was opened while the program trace is off")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_off_every_site_is_the_shared_noop(layout, split, monkeypatch):
    """Off: no site opens a span (building one would raise), the free
    functions hand back the one no-op, and a counter adds nowhere."""
    assert spans.TRACE is None
    assert spans.program_span("trainer.step") is spans._NULL
    assert spans.program_span("executor.step") is spans._NULL
    assert NullMetrics().span("train_steps") is spans._NULL
    monkeypatch.setattr(spans, "_Open", _Refused)
    s = _session(split, layout)
    s.train_steps(STEPS)
    spans.add("cuda_ops.launches")
    with spans.recording() as tr:
        pass
    assert tr.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_on_nesting_exceptions_cap_counters_and_switch():
    with spans.recording() as tr:
        with spans.program_span("a"):
            with spans.program_span("b"):
                pass
            with pytest.raises(ValueError):
                with spans.program_span("c"):
                    raise ValueError("closed all the same")
        with spans.program_span("d"):
            pass
        spans.add("n")
        spans.add("n", 4)
        spans.add("ns", 10)
        with pytest.raises(RuntimeError, match="already recording"):
            with spans.recording():
                pass
        assert spans.TRACE is tr
    assert spans.TRACE is None
    spans.add("n", 100)  # off: nowhere
    by = {rec[0]: rec for rec in tr.spans}
    assert [rec[0] for rec in tr.spans] == ["b", "c", "a", "d"]  # closing order
    assert by["a"][2] == 0 and by["d"][2] == 0
    assert by["b"][2] == by["c"][2] == by["a"][1]
    for name, sid, parent, t0, t1, thread in tr.spans:
        assert t0 <= t1 and thread == threading.get_ident()
    assert by["a"][3] <= by["b"][3] and by["b"][4] <= by["a"][4]
    assert tr.counters == {"n": 5, "ns": 10} and tr.dropped == 0

    with spans.recording(cap=3) as capped:
        for i in range(5):
            with spans.program_span(f"s{i}"):
                pass
    assert [rec[0] for rec in capped.spans] == ["s0", "s1", "s2"] and capped.dropped == 2


def test_on_each_thread_nests_on_its_own_stack():
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with spans.program_span(f"outer.{tag}"):
                barrier.wait()  # both outer spans open at once
                with spans.program_span(f"inner.{tag}"):
                    barrier.wait()
        except threading.BrokenBarrierError as e:
            errors.append(e)

    with spans.recording() as tr:
        threads = [threading.Thread(target=work, args=(k,)) for k in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    by = {rec[0]: rec for rec in tr.spans}
    for tag in "xy":
        outer, inner = by[f"outer.{tag}"], by[f"inner.{tag}"]
        assert outer[2] == 0 and inner[2] == outer[1] and inner[5] == outer[5]
    assert by["outer.x"][5] != by["outer.y"][5]


def test_recorder_span_lands_in_the_trace_and_keeps_its_record(tmp_path):
    """A recorder-bound span writes its JSONL record as before, its path
    untouched by the program spans around it, and lands in the trace."""
    rec = JsonlMetrics(tmp_path / "m.jsonl")
    with spans.recording() as tr:
        with spans.program_span("session.dispatch"):
            with rec.span("train_steps"):
                pass
    rec.close()
    (span_rec,) = [r for r in read_jsonl(tmp_path / "m.jsonl") if r["kind"] == "span"]
    assert (span_rec["name"], span_rec["path"], span_rec["depth"]) == ("train_steps", "train_steps", 0)
    by = {r[0]: r for r in tr.spans}
    assert by["train_steps"][2] == by["session.dispatch"][1]


def test_spans_sit_on_the_profilers_timeline():
    """A span around a ``record_function`` maps onto the CPU profiler's
    range, ``start_ns - trace_start_ns`` against ``time_range`` in us,
    within 1 ms at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with spans.recording() as tr:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with spans.program_span("outer"):
                    with record_function("portrange"):
                        torch.ones(1000).sum()
    t_start = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events() if ev.name == "portrange"
    )
    mine = sorted(((r[3] - t_start) / 1e3, (r[4] - t_start) / 1e3) for r in tr.spans)
    assert len(ranges) == len(mine) == 3
    for (ps, pe), (ss, se) in zip(ranges, mine):
        assert abs(ps - ss) < 1000 and abs(pe - se) < 1000
        assert ss <= ps + 1000 and pe <= se + 1000


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_session_span_tree_per_step(layout, split):
    """Set-up and a call of ``STEPS`` steps: each name its count, each span
    under its parent, and the trace's launch counter equal to
    ``LAUNCHES``' delta."""
    with spans.recording() as setup:
        s = _session(split, layout)
    names = _names(setup)
    assert names["session.init"] == 1 and names["session.load_data"] == 1
    assert names["session.init_params"] == 1 and names["device_put"] >= 2
    assert names["schedule_lower"] == (1 if "pp4" in layout else 0)
    init = next(r for r in setup.spans if r[0] == "session.init")
    assert all(r[3] >= init[3] and r[4] <= init[4] for r in setup.spans)

    before = dict(cuda_ops.LAUNCHES)
    with spans.recording() as tr:
        assert s.train_steps(STEPS) == (STEPS, None)
    delta = sum(cuda_ops.LAUNCHES[k] - before[k] for k in before)
    assert tr.counters.get("cuda_ops.launches", 0) == delta

    names = _names(tr)
    want = {k: v * STEPS for k, v in PER_STEP[layout].items()}
    want.update(PER_CALL)
    if layout == "epoch-kernel":
        want["trainer.epoch_kernel"] = 1
    assert dict(names) == want
    by_id = {r[1]: r for r in tr.spans}
    for name, sid, parent, *_ in tr.spans:
        assert by_id[parent][0] == PARENT[name] if name in PARENT else parent == 0
    assert tr.dropped == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_weights_bitwise_with_the_trace_on_and_off(layout, split):
    out = {}
    for on in (False, True):
        s = _session(split, layout)
        with spans.recording() if on else contextlib.nullcontext():
            s.train_steps(STEPS)
            s.train_steps(NB - STEPS)
        out[on] = [np.array(a) for stage in s.params() for layer in stage for a in layer.values()]
    assert len(out[True]) == len(out[False]) > 0
    for a, b in zip(out[False], out[True]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_launch_counters_time_the_wrapper_to_the_call(monkeypatch):
    """``_launch`` with a stand-in C entry point: on, the launch lands in
    ``cuda_ops.launches`` and its host ns from the wrapper's entry in
    ``cuda_ops.launch_ns``; off, only ``LAUNCHES`` counts."""
    calls = []
    monkeypatch.setattr(cuda_ops, "_fn", lambda kernel: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})()
    )
    monkeypatch.setitem(cuda_ops.LAUNCHES, "linear_act_fwd", 0)
    x = torch.zeros(2)
    cuda_ops._launch("linear_act_fwd", 0, x, 1)
    with spans.recording() as tr:
        t0 = time.perf_counter_ns() if spans.TRACE is not None else 0
        cuda_ops._launch("linear_act_fwd", t0, x, 1)
        cuda_ops._launch("linear_act_fwd", t0, x, 1)
    assert cuda_ops.LAUNCHES["linear_act_fwd"] == 3 and len(calls) == 3
    assert tr.counters["cuda_ops.launches"] == 2 and tr.counters["cuda_ops.launch_ns"] > 0
