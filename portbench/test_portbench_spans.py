"""The program trace's arithmetic (``work/spans.py``) on synthetic spans and
device intervals, its reader (``readers/program.py``) on synthetic
collections, on skewed stretches and on a session of each cell on the CPU,
and, on the card, the weights of each cell with the trace on and off:

    python -m pytest portbench/test_portbench_spans.py -q
"""

import contextlib
import importlib
import io
import math
import random

import pytest

from portbench import harness
from portbench.work import spans as W
from portbench.work import trace

ROOT = harness.ROOT
CELLS = ("mnist-mlp.epoch-kernel", "mlp-deep.seq-b1024", "mlp-deep.pp4-gpipe-b1024")
NEW = (
    "session.host_ms_per_call", "trainer.issue_ms_per_step",
    "executor.issue_ms_per_step", "cuda_ops.host_us_per_launch",
    "session.idle_charged_pct", "trainer.idle_charged_pct", "executor.idle_charged_pct",
)


def rec(name, sid, parent, start, end):
    return (name, sid, parent, start, end, 1)


def test_self_time_is_the_duration_less_the_union_of_children():
    records = [
        rec("train_steps", 1, 0, 0, 100),
        rec("session.dispatch", 2, 1, 10, 60),
        rec("trainer.step", 3, 2, 20, 40),
        rec("trainer.step", 4, 2, 30, 50),  # overlaps its sibling: the union counts once
        rec("session.loss_wait", 5, 1, 60, 95),
    ]
    own = W.self_ns(records)
    assert own == {1: 100 - 50 - 35, 2: 50 - 30, 3: 20, 4: 20, 5: 35}


def test_idle_goes_to_the_innermost_span_split_where_spans_start_and_end():
    # one gap of the device, [10, 90), crossed by three nested spans and
    # an unnamed span that inherits its parent's layer
    records = [
        rec("train_steps", 1, 0, 5, 95),
        rec("session.dispatch", 2, 1, 20, 80),
        rec("executor.step", 3, 2, 30, 70),
        rec("executor.step", 4, 3, 40, 50),
        rec("x.other", 5, 3, 55, 60),
    ]
    busy = [(0, 10), (90, 100)]
    charges = W.charge_idle(records, busy, (0, 110))
    assert charges == {
        "Session": (20 - 10) + (30 - 20) + (80 - 70) + (90 - 80),
        "Trainer": 0.0,
        "Executor": 70 - 30,
        "outside": 110 - 100 + (95 - 95),
    }
    # the layer of an idle moment is the innermost span's: a trainer span
    # inside the session's takes its gap, and a gap outside every span is
    # outside
    records = [rec("train_steps", 1, 0, 0, 50), rec("trainer.step", 2, 1, 10, 20)]
    assert W.charge_idle(records, [(12, 14)], (0, 60)) == {
        "Session": 40.0, "Trainer": 8.0, "Executor": 0.0, "outside": 10.0,
    }


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_charges_add_up_to_the_stretchs_idle(seed):
    rng = random.Random(seed)
    records, sid, t = [], 0, 0.0
    names = ["train_steps", "session.dispatch", "trainer.step", "executor.step", "x.other"]
    for _ in range(40):
        sid += 1
        start = t + rng.uniform(0, 3)
        end = start + rng.uniform(5, 20)
        records.append(rec("train_steps", sid, 0, start, end))
        inner_t, parent = start, sid
        for name in names[1:]:
            sid += 1
            a = inner_t + rng.uniform(0, 1)
            b = min(end, a + rng.uniform(0.5, 4))
            records.append(rec(name, sid, parent, a, b))
            parent, inner_t = sid, a
        t = end
    busy = []
    x = 0.0
    while x < t:
        a = x + rng.uniform(0, 2)
        busy.append((a, a + rng.uniform(0, 3)))
        x = busy[-1][1]
    window = (1.0, t - 1.0)
    charges = W.charge_idle(records, busy, window)
    idle = (window[1] - window[0]) - trace.union_us(
        [(max(s, window[0]), min(e, window[1])) for s, e in busy if min(e, window[1]) > max(s, window[0])]
    )
    assert abs(sum(charges.values()) - idle) < 1e-9 * max(1.0, idle)
    assert all(v >= 0 for v in charges.values())


def test_the_clock_check_reads_the_leads_of_each_call():
    calls = [(rec("session.dispatch", 1, 0, 0, 5), rec("session.loss_wait", 2, 0, 5, 30)),
             (rec("session.dispatch", 3, 0, 40, 45), rec("session.loss_wait", 4, 0, 45, 70))]
    ops = [(2, 10), (10, 28), (42, 50), (50, 69)]
    assert W.call_leads(calls, ops) == (2, 1)
    assert W.call_leads(calls, ops[:3]) is None  # not an equal count a call
    skewed = [(s - 5, e - 5) for s, e in ops]  # a device clock 5 early
    assert W.call_leads(calls, skewed)[0] < 0


def _reader():
    return importlib.import_module("portbench.readers.program")


def _prog(c_spans, counters=None, steps=2, calls=2, d=None):
    return {
        "c": {"spans": c_spans, "counters": counters or {}, "dropped": 0},
        "c_steps": steps, "c_calls": calls, "c_walls": [0.1] * calls, "d": d,
    }


def _spec(name):
    return harness.Bench(ROOT).metric_file(name)


def test_each_reader_is_none_without_its_spans_and_raises_on_zero_steps():
    reader = _reader()
    assert all(reader.read({"program": None}, _spec(m)) is None for m in NEW)
    empty = _prog([], d={"window": (0, 10), "records": [], "ops": [], "marks": []})
    for m in NEW:
        assert reader.read({"program": empty}, _spec(m)) is None, m
    call = [
        rec("train_steps", 1, 0, 0, 10_000_000),
        rec("session.dispatch", 2, 1, 1_000_000, 6_000_000),
        rec("trainer.step", 3, 2, 2_000_000, 5_000_000),
        rec("executor.step", 4, 2, 2_000_000, 5_000_000),
        rec("session.loss_wait", 5, 1, 6_000_000, 9_000_000),
    ]
    counters = {"cuda_ops.launch_ns": 30_000, "cuda_ops.launches": 3}
    d = {"window": (0.0, 10.0), "records": call, "ops": [(0.0, 1.0)], "marks": []}
    good = _prog(call, counters, steps=1, calls=1, d=d)
    values = {m: reader.read({"program": good}, _spec(m)) for m in NEW}
    assert values["session.host_ms_per_call"] == pytest.approx(2 + 2)
    assert values["trainer.issue_ms_per_step"] == values["executor.issue_ms_per_step"] == 3
    assert values["cuda_ops.host_us_per_launch"] == 10
    assert all(math.isfinite(v) and v >= 0 for v in values.values())
    zero = _prog(call, {"cuda_ops.launch_ns": 5, "cuda_ops.launches": 0}, steps=0, calls=0,
                 d=dict(d, window=(5.0, 5.0)))
    for m in NEW:
        with pytest.raises(ValueError):
            reader.read({"program": zero}, _spec(m))


def test_the_benchmark_validates_with_the_program_metrics():
    bench = harness.Bench(ROOT)
    assert bench.validate() == []
    assert set(NEW) <= set(bench.per_layer)
    for name in NEW:
        assert bench.metric_file(name)["reader"] == "program"
        assert bench.per_layer[name]["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reader_on_a_cells_session_on_the_cpu(tiny_root, cell, tmp_path, monkeypatch):
    """Stretch C on the CPU (stretch D needs the card):
    every number finite and non-negative where it reads, the device's
    numbers absent; and nothing where the program has no trace."""
    bench = harness.Bench(tiny_root)
    c, session, _, _, _ = harness.prepare(bench, cell, 2**31 + 9, "cpu", tmp_path)
    ctx = {"config": c["config"], "traffic": c["traffic"], "cell": c["cell"],
           "session": session, "window": {"seconds": 1.0, "steps": 10}}
    reader = _reader()
    got = {}
    for m in bench.per_layer_of(cell):
        if m["name"] in NEW:
            got[m["name"]] = reader.read(ctx, bench.metric_file(m["name"]))
    assert ctx["program"]["c"]["dropped"] == 0
    for name, value in got.items():
        if name.endswith("idle_charged_pct") or name == "cuda_ops.host_us_per_launch":
            assert value is None, name  # device numbers: no card, no launch
        else:
            assert value is not None and math.isfinite(value) and value >= 0, (name, value)
    from shallowspeed_tpu_torch.observability import spans

    monkeypatch.delattr(spans, "recording")
    assert reader.collect(ctx) is None
    del session


def _stretch_d(skew=0.0, marks=True):
    """A synthetic stretch D of two calls on the trace's timeline (us), its
    device operations and marker kernels ``skew`` us later than the spans
    (early where negative)."""
    records = [
        rec("portbench.mark", 1, 0, 0, 12),
        rec("train_steps", 2, 0, 100, 400),
        rec("session.dispatch", 3, 2, 100, 200),
        rec("trainer.step", 4, 3, 110, 190),
        rec("session.loss_wait", 5, 2, 200, 400),
        rec("train_steps", 6, 0, 500, 800),
        rec("session.dispatch", 7, 6, 500, 600),
        rec("trainer.step", 8, 7, 510, 590),
        rec("session.loss_wait", 9, 6, 600, 800),
        rec("portbench.mark", 10, 0, 900, 912),
    ]
    ops = [(s + skew, e + skew) for s, e in ((150, 250), (260, 380), (550, 650), (660, 780))]
    found = [(s + skew, e + skew) for s, e in ((5, 8), (905, 908))] if marks else []
    window = (found[0][1], found[-1][0]) if marks else (0, 1000)
    return {"window": window, "records": records, "ops": ops, "marks": found}


@pytest.mark.parametrize("skew", [0.0, 30.0, -30.0, -200.0, 200.0, -1300.0])
def test_the_clock_check_holds_a_skewed_stretch_to_the_slack(skew):
    """Every lead of an aligned stretch is at least 0; a timeline skewed
    either way by more than the slack fails the check, within it passes."""
    reader = _reader()
    leads = reader.clock(_stretch_d(skew))
    off = reader.misaligned(leads)
    assert (off == []) == (abs(skew) <= reader.SLACK_US), (skew, leads, off)
    if skew == 0.0:
        assert leads["calls"] == (50, 20) and leads["marks"] == [(5, 4), (5, 4)]


def test_a_misaligned_stretch_is_run_again_and_then_given_up():
    """``aligned`` runs stretch D again while it disagrees or lost a marker,
    keeps the first that agrees, and gives None (no idle charges) when none
    of its attempts does: a skewed stretch never reaches the charges."""
    reader = _reader()

    def runs(*kinds):
        it = iter(kinds)

        def run():
            kind = next(it)
            if kind == "lost":
                raise RuntimeError("the trace holds 1 marker kernels")
            return _stretch_d(skew=-400.0 if kind == "skewed" else 0.0)

        return run

    log = io.StringIO()
    d = reader.aligned(runs("skewed", "lost", "good"), log, attempts=3)
    assert d["attempts"] == 3 and reader.misaligned(d["clock"]) == []
    assert "disagree" in log.getvalue() and "marker" in log.getvalue()
    assert reader.aligned(runs("skewed", "skewed"), io.StringIO(), attempts=2) is None
    prog = _prog([], d=None)
    assert reader.read({"program": prog}, _spec("trainer.idle_charged_pct")) is None
    # a lone marker or operations that do not split over the calls disagree
    assert reader.misaligned(reader.clock(dict(_stretch_d(), marks=[(5, 8)])))
    assert reader.misaligned(reader.clock(dict(_stretch_d(), ops=[(150, 250)] * 3)))


def _weights(session):
    return [a.tobytes() for stage in session.params() for layer in stage for a in layer.values()]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_weights_are_bitwise_with_the_trace_on_and_off(card, cell, tmp_path):
    """Two sessions of the cell from one seed, as the benchmark sets them
    up, train ``trace_chunks`` calls of its chunk, the first with the trace
    off and the second with it on: their weights are bitwise equal."""
    from shallowspeed_tpu_torch.observability import spans

    bench = harness.Bench(ROOT)
    out = {}
    for on in (False, True):
        tmp = tmp_path / f"on-{on}"
        tmp.mkdir()
        c, session, _, _, _ = harness.prepare(bench, cell, 2**31 + 21, str(card), tmp)
        with spans.recording() if on else contextlib.nullcontext():
            for _ in range(c["cell"]["trace_chunks"]):
                session.train_steps(c["traffic"]["chunk_steps"])
        out[on] = _weights(session)
        del session
        harness.free(card)
    assert len(out[True]) == len(out[False]) > 0 and out[True] == out[False]
