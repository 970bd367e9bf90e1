"""The port's ``observability/tracing.py`` against the JAX package's, and the
port engine's span chains against the JAX engine's.

The copy is held to the JAX module on the same synthetic records (the cases
of the JAX package's ``tests/test_tracing.py``: the tracer, the disabled
tracer, worker-clock alignment, missing alignment, orphan and unclosed
chains, attribution): equal chains, problems, phases, attribution and
waterfall lines. Then both engines serve the same requests under the same
injected clock, and their ``trace`` records must be equal (every field but
the wall-clock ``ts``): every terminal verdict and retry exhaustion leave
the same span names, parent links and timestamps. The report's Tracing
section renders the same text in both packages, on either package's
stream.
"""

import contextlib
import io
import itertools

import numpy as np
import pytest

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import metrics as jmetrics
from shallowspeed_tpu.observability import report as jreport
from shallowspeed_tpu.observability import tracing as jtracing
from shallowspeed_tpu.serving import engine as jengine
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.observability import metrics as tmetrics
from shallowspeed_tpu_torch.observability import report as treport
from shallowspeed_tpu_torch.observability import tracing as ttracing
from shallowspeed_tpu_torch.serving import engine as tengine

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 64
V = tmetrics.SCHEMA_VERSION


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The JAX session loads a training split at construction."""
    path = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 64)):
        x = rng.randn(n, SIZES[0]).astype(np.float32)
        y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)]
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", y)
    return path


@pytest.fixture(scope="module")
def sessions(data_dir):
    """(JAX, port) serving sessions with the same deterministic init."""
    kw = dict(sizes=SIZES, global_batch_size=GBS, predict_slot_ladder=(1, 2))
    return JaxSession(data_dir=data_dir, **kw), TorchSession(device="cpu", **kw)


# ---------------------------------------------------------------------------
# synthetic records (the JAX tracing tests' shapes)
# ---------------------------------------------------------------------------


def _span(name, trace_id, span_id, t0, t1, parent=None, clock="parent",
          replica_id=None, terminal=False, **fields):
    return {
        "v": V, "ts": 0.0, "kind": "trace", "name": name,
        "trace_id": trace_id, "span_id": span_id, "parent_id": parent,
        "t0": t0, "t1": t1, "clock": clock, "replica_id": replica_id,
        "terminal": terminal, **fields,
    }


def _offset(replica_id, offset_s, uncertainty_s=0.0001):
    return {
        "v": V, "ts": 0.0, "kind": "trace", "name": "clock_offset",
        "trace_id": None, "span_id": None, "parent_id": None, "t0": None,
        "t1": None, "clock": "parent", "replica_id": replica_id,
        "terminal": False, "offset_s": offset_s, "rtt_s": 2 * uncertainty_s,
        "uncertainty_s": uncertainty_s,
    }


def _request(trace_id, verdict="ok"):
    return {"v": V, "ts": 0.0, "kind": "request", "name": verdict, "id": 0,
            "trace_id": trace_id}


def _aligned():
    off = 5.0  # the worker clock runs 5 s ahead of the parent's
    return [
        _offset(0, off),
        _span("fleet.queue", "f-0", "f.1", 10.00, 10.01),
        _span("route", "f-0", "f.2", 10.01, 10.012, parent="f.1"),
        _span("worker.queue", "f-0", "r0.1", 10.02 + off, 10.05 + off,
              parent="f.2", clock="worker", replica_id=0),
        _span("dispatch", "f-0", "r0.2", 10.05 + off, 10.09 + off,
              parent="r0.1", clock="worker", replica_id=0),
        _span("ack", "f-0", "f.3", 10.10, 10.10, parent="r0.2",
              terminal=True, verdict="ok"),
        _request("f-0"),
    ]


def _missing_alignment():
    return [
        _span("fleet.queue", "f-1", "f.1", 0.0, 0.1),
        _span("worker.queue", "f-1", "r3.1", 100.0, 100.2, parent="f.1",
              clock="worker", replica_id=3),
        _span("ack", "f-1", "f.2", 0.3, 0.3, parent="r3.1", terminal=True,
              verdict="ok"),
        _request("f-1"),
    ]


def _incomplete():
    return [
        _span("route", "t-a", "f.1", 0.0, 0.1, parent="f.99"),  # orphan
        _span("ack", "t-a", "f.2", 0.2, 0.2, parent="f.1", terminal=True),
        _request("t-a"),
        _span("dispatch", "t-b", "f.3", 0.0, None),  # unclosed
        _span("ack", "t-b", "f.4", 0.2, 0.2, parent="f.3", terminal=True),
        _request("t-b"),
        _span("fleet.queue", "t-c", "f.5", 0.0, 0.1),  # no terminal span
        _request("t-c"),
        _request("t-d"),  # no chain at all
        _span("ack", "t-e", "f.6", 0.0, 0.0, terminal=True, verdict="ok"),
        _request("t-e"),
    ]


def _attribution():
    """Fifty fast queue-dominated chains and one slow dispatch-dominated
    outlier: the mean and the p99-conditional attribution disagree."""
    recs = []
    for i in range(50):
        t0 = float(i)
        recs += [
            _span("worker.queue", f"e-{i}", f"e.{3 * i + 1}", t0, t0 + 0.008),
            _span("dispatch", f"e-{i}", f"e.{3 * i + 2}", t0 + 0.008,
                  t0 + 0.010, parent=f"e.{3 * i + 1}"),
            _span("ack", f"e-{i}", f"e.{3 * i + 3}", t0 + 0.010, t0 + 0.010,
                  parent=f"e.{3 * i + 2}", terminal=True, verdict="ok",
                  deadline_ms=100.0),
            _request(f"e-{i}"),
        ]
    recs += [
        _span("worker.queue", "e-x", "e.900", 90.0, 90.01),
        _span("dispatch", "e-x", "e.901", 90.01, 91.01, parent="e.900"),
        _span("ack", "e-x", "e.902", 91.01, 91.01, parent="e.901",
              terminal=True, verdict="ok", deadline_ms=100.0),
        _request("e-x"),
    ]
    return recs


def _chain_view(chain):
    return (
        chain.trace_id, chain.alignment, chain.uncertainty_s, chain.verdict,
        chain.t0, chain.t_end, chain.latency_s, chain.replicas,
        chain.problems(), chain.spans,
    )


def _attribution_view(att):
    if att is None:
        return None
    out = dict(att)
    out["worst"] = [c.trace_id for c in att["worst"]]
    return out


def _analyse(mod, recs):
    """Everything the reader half of ``tracing`` computes on ``recs``."""
    chains = mod.assemble_chains(recs)
    return {
        "offsets": mod.clock_offsets(recs),
        "chains": {tid: _chain_view(c) for tid, c in chains.items()},
        "terminal": mod.traced_terminal_requests(recs),
        "problems": mod.verify_terminal_chains(recs, chains),
        "causal": {
            tid: [s["span_id"] for s in mod.causal_order(c)]
            for tid, c in chains.items()
        },
        "phases": {tid: mod.chain_phases(c) for tid, c in chains.items()},
        "attribution": _attribution_view(mod.attribution(chains, slo_ms=50.0, worst_k=2)),
        "waterfalls": {tid: mod.waterfall(c) for tid, c in chains.items()
                       if c.latency_s},
    }


CASES = {
    "aligned": _aligned,
    "missing-alignment": _missing_alignment,
    "incomplete": _incomplete,
    "attribution": _attribution,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_jax(case):
    """assemble_chains, clock_offsets, the completeness gate, causal order,
    phases, attribution and waterfalls: the copy's output is the JAX
    module's on the same records."""
    recs = CASES[case]()
    got, want = _analyse(ttracing, recs), _analyse(jtracing, recs)
    assert got == want
    # and what the JAX tests pin, on the copy
    if case == "aligned":
        (chain,) = ttracing.assemble_chains(recs).values()
        phases = ttracing.chain_phases(chain)
        assert chain.alignment == "aligned" and got["problems"] == []
        assert phases["route"] == pytest.approx(0.010)
        assert phases["ack"] == pytest.approx(0.01)
        assert sum(phases.values()) == pytest.approx(chain.latency_s)
    elif case == "missing-alignment":
        assert got["chains"]["f-1"][1] == "missing" and got["problems"] == []
    elif case == "incomplete":
        text = "\n".join(got["problems"])
        for tid, word in (("t-a", "orphan"), ("t-b", "unclosed"),
                          ("t-c", "no terminal"), ("t-d", "no span chain")):
            assert tid in text and word in text
        assert "t-e" not in text
        with pytest.raises(ttracing.TraceError, match="t-a"):
            ttracing.verify_terminal_chains(recs, strict=True)
    else:
        att = got["attribution"]
        assert att["p99_dominant_phase"] == "dispatch"
        assert att["phases_mean"]["worker.queue"] < 0.5
        assert att["worst"][0] == "e-x" and att["slo_chains"] == 51
    assert ttracing.SPAN_NAMES == jtracing.SPAN_NAMES
    assert ttracing.GAP_CHARGE == jtracing.GAP_CHARGE


def _jsonl(path):
    out = []
    for r in jmetrics.read_jsonl(path):
        r.pop("ts", None)
        r.pop("created", None)
        out.append(r)
    return out


def test_tracer_and_disabled_tracer_equal_jax(tmp_path):
    """The emitter: linked closed spans and clock-offset records, the same
    lines in both packages; a disabled tracer emits nothing."""
    lines = []
    for pkg, mod, mmod in (("j", jtracing, jmetrics), ("t", ttracing, tmetrics)):
        path = tmp_path / f"{pkg}.jsonl"
        with mmod.JsonlMetrics(path) as m:
            tr = mod.Tracer(m, process="f")
            tid = tr.new_trace(7)
            root = tr.span("fleet.queue", tid, 1.0, 1.2)
            route = tr.span("route", tid, 1.2, 1.21, parent=root, to_replica=0)
            tr.span("ack", tid, 1.5, 1.5, parent=route, terminal=True, verdict="ok")
            tr.clock_offset(0, 0.5, 0.002, 0.001)
        lines.append(_jsonl(path))
    assert lines[1] == lines[0]
    spans = [r for r in lines[1]
             if r["kind"] == "trace" and r["name"] != "clock_offset"]
    assert [s["span_id"] for s in spans] == ["f.1", "f.2", "f.3"]
    assert spans[1]["parent_id"] == "f.1" and spans[2]["terminal"] is True
    off = ttracing.Tracer(tmetrics.NullMetrics(), process="e")
    assert off.enabled is False
    assert off.span("dispatch", "e-1", 0.0, 1.0) is None
    off.clock_offset(0, 1.0, 0.001, 0.0005)  # no-op, no raise


# ---------------------------------------------------------------------------
# the engines' chains, under one injected clock
# ---------------------------------------------------------------------------


def _counter_clock(step=1e-4):
    c = itertools.count()
    return lambda: next(c) * step


def _serve(eng_mod, session, path, mmod, fail_predict=False):
    """Every terminal verdict through one engine: ok, dropped (max_queue),
    expired (shed at pack time) — or, with ``fail_predict``, retry
    exhaustion. Returns the requests."""
    m = mmod.JsonlMetrics(path)
    eng = eng_mod.ServingEngine(
        session, metrics=m, slo_ms=5000, max_queue=4, retry=2,
        clock=_counter_clock(),
    )
    eng._latency_floor = 0.0  # the two cost models differ by design
    rng = np.random.RandomState(1)
    reqs = []
    if fail_predict:
        real = session.predict
        session.predict = lambda x: (_ for _ in ()).throw(RuntimeError("down"))
        try:
            reqs.append(eng.submit(rng.randn(1, SIZES[0]).astype(np.float32)))
            eng.drain()
        finally:
            session.predict = real
    else:
        for _ in range(5):  # the fifth is over max_queue: dropped at submit
            reqs.append(eng.submit(rng.randn(2, SIZES[0]).astype(np.float32)))
        eng.drain()
        # a deadline that has passed by the next dispatch: shed at pack time
        reqs.append(eng.submit(rng.randn(1, SIZES[0]).astype(np.float32),
                               deadline_ms=0.0001))
        eng.drain()
    m.close()
    return reqs


def _section(text, head="## Tracing"):
    lines = text.splitlines()
    i = lines.index(head)
    j = next((k for k in range(i + 1, len(lines)) if lines[k].startswith("## ")),
             len(lines))
    return lines[i:j]


def _render(mod, path, fmt):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main([str(path), "--format", fmt, "--slo-ms", "5000"]) in (0, None)
    return buf.getvalue()


@pytest.mark.parametrize("leg", ["verdicts", "exhaustion"])
def test_engine_chains_equal_jax(leg, sessions, tmp_path):
    """Both engines serve the same requests under the same injected clock:
    the trace records are equal field for field (but ``ts``), every chain
    is complete, its phases sum to its latency, and every terminal request
    record carries its chain's join key. The report's Tracing section is
    the same text from either package, on either stream."""
    js, ts = sessions
    fail = leg == "exhaustion"
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jreqs = _serve(jengine, js, jpath, jmetrics, fail)
    treqs = _serve(tengine, ts, tpath, tmetrics, fail)
    assert [(r.id, r.verdict) for r in treqs] == [(r.id, r.verdict) for r in jreqs]
    jrecs, trecs = _jsonl(jpath), _jsonl(tpath)
    jtrace = [r for r in jrecs if r["kind"] == "trace"]
    ttrace = [r for r in trecs if r["kind"] == "trace"]
    assert ttrace and ttrace == jtrace
    chains = ttracing.assemble_chains(trecs)
    assert ttracing.verify_terminal_chains(trecs, chains, strict=True) == []
    if fail:
        (chain,) = chains.values()
        assert chain.verdict == "error"
        assert [s["name"] for s in chain.spans] == ["worker.queue", "ack"]
    else:
        assert {c.verdict for c in chains.values()} == {"ok", "dropped", "expired"}
    for c in chains.values():
        assert sum(ttracing.chain_phases(c).values()) == pytest.approx(c.latency_s)
    reqs = [r for r in trecs if r["kind"] == "request"]
    assert reqs and all(r.get("trace_id") in chains for r in reqs)
    # the Tracing section: one text from both reports on both streams
    for path in (tpath, jpath):
        for fmt in ("md", "text"):
            head = "## Tracing" if fmt == "md" else "tracing:"
            got = _section(_render(treport, path, fmt), head)
            assert got == _section(_render(jreport, path, fmt), head)
    text = _render(treport, tpath, "md")
    assert "all terminal requests traced end to end" in text
    assert "phase attribution (mean)" in text and "slowest requests:" in text
    assert "not rendered" not in text
