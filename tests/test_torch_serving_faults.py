"""The port engine's fault tolerance against the JAX engine's: dispatch
recovery and the retry budget, the depth clock, deadline shedding, the
health gate and the breaker, hot weight reload (breaker-triggered, the
watcher, the single verified read), the chaos faults at their anchors, the
graceful drain and the serve CLI's exit codes — the counterparts of the JAX
package's ``tests/test_serving_faults.py``.

Where the JAX test has an engine scenario, both engines run it on sessions
with the same deterministic init and the same injected clock (a counter
that advances a fixed step a call, so every timestamp is the same in both)
and must agree on every verdict, the request order, ``attempts``,
``dispatch_seq``, the ``stats()``/``status()`` counters and every record
(all fields but the wall-clock ``ts``; the analytical latency floor is the
card's cost model in the port and a TPU's in the JAX package, so the
``serving`` record's ``latency_bound_*`` fields and the floor the shedding
tests set are excluded or pinned). Responses agree within ``PROB_ATOL``;
every port ``"ok"`` response is bitwise a direct ``predict()`` under the
weights active at its dispatch.
"""

import contextlib
import io
import itertools
import time

import numpy as np
import pytest

from shallowspeed_tpu import checkpoint as jckpt
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import metrics as jmetrics
from shallowspeed_tpu.serving import engine as jengine
from shallowspeed_tpu.serving import loadgen as jloadgen
from shallowspeed_tpu_torch import checkpoint as tckpt
from shallowspeed_tpu_torch import faults as tfaults
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.observability import metrics as tmetrics
from shallowspeed_tpu_torch.observability import tracing as ttracing
from shallowspeed_tpu_torch.serving import engine as tengine
from shallowspeed_tpu_torch.serving import loadgen as tloadgen

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 64
LADDER = (1, 2, 4)
PROB_ATOL = 1e-6  # softmax probabilities across the packages (measured 3e-8)

PKGS = {
    "jax": (jengine, jloadgen, jmetrics.MetricsRecorder),
    "torch": (tengine, tloadgen, tmetrics.MetricsRecorder),
}
# fields the two packages compute differently by design: the wall-clock
# stamp, the cost model's floor, and the port-only exception text
NOT_COMPARED = {"ts", "latency_bound_s", "latency_bound_ticks",
                "latency_bound_source", "last_error"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 64)):
        x = rng.randn(n, SIZES[0]).astype(np.float32)
        y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)]
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", y)
    return path


def _session(pkg, data_dir, **kw):
    kw = dict(sizes=SIZES, global_batch_size=GBS, predict_slot_ladder=LADDER, **kw)
    if pkg == "jax":
        return JaxSession(data_dir=data_dir, **kw)
    return TorchSession(device="cpu", **kw)


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    """A step-checkpoint directory: step 0 holds the deterministic init,
    step 8 weights away from it (so a reload is observable)."""
    path = tmp_path_factory.mktemp("ck")
    spec = tmodel.make_model_spec(SIZES, 1, GBS)
    init = tmodel.init_model(spec)
    rng = np.random.RandomState(11)
    moved = [
        [
            {"W": (l["W"] + 0.05 * rng.randn(*l["W"].shape)).astype(np.float32),
             "b": (0.05 * rng.randn(*l["b"].shape)).astype(np.float32)}
            for l in stage
        ]
        for stage in init
    ]
    for step, params in ((0, init), (8, moved)):
        tckpt.save_checkpoint(
            tckpt.step_checkpoint_path(path, step), params, spec, 0,
            step_in_epoch=step, global_step=step,
        )
    return path


class _Capture:
    """A recorder mixin that keeps every record (minus the fields the
    packages compute differently) in emission order."""

    def __init__(self):
        super().__init__()
        self.records = []

    def _emit(self, record):
        self.records.append(
            {k: v for k, v in record.items() if k not in NOT_COMPARED}
        )


def _recorder(pkg):
    return type("Capture", (_Capture, PKGS[pkg][2]), {})()


def _counter_clock(step=1e-4):
    c = itertools.count()
    return lambda: next(c) * step


def _payloads(n, seed=5, rows=(1, 2, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randn(rng.choice(rows), SIZES[0]).astype(np.float32) for _ in range(n)]


def _counters(eng):
    return {k: v for k, v in eng.stats().items() if k not in NOT_COMPARED}


def _view(eng, reqs, m):
    """What the two engines must agree on."""
    return {
        "verdicts": [(r.id, r.verdict, r.attempts) for r in reqs],
        "queue": [r.id for r in eng._queue],
        "dispatch_seq": eng.dispatch_seq,
        "stats": _counters(eng),
        "status": eng.status(),
        "records": m.records,
    }


def _run_both(data_dir, scenario, **session_kw):
    """Run ``scenario(pkg, session, metrics)`` -> (engine, requests, extra)
    in both packages; assert their views equal and their ok responses
    within PROB_ATOL; return the port's (session, engine, requests, extra,
    records)."""
    out = {}
    for pkg in ("jax", "torch"):
        session = _session(pkg, data_dir, **session_kw)
        m = _recorder(pkg)
        eng, reqs, extra = scenario(pkg, session, m)
        out[pkg] = (session, eng, reqs, extra, _view(eng, reqs, m))
    vj, vt = out["jax"][4], out["torch"][4]
    for key in vj:
        assert vt[key] == vj[key], key
    assert out["torch"][3] == out["jax"][3]
    for rj, rt in zip(out["jax"][2], out["torch"][2]):
        if rt.verdict == "ok":
            np.testing.assert_allclose(rt.result, rj.result, rtol=0, atol=PROB_ATOL)
    session, eng, reqs, extra, view = out["torch"]
    return session, eng, reqs, extra, view["records"]


def _kind(records, kind, name=None):
    return [r for r in records if r["kind"] == kind and name in (None, r["name"])]


# ---------------------------------------------------------------------------
# dispatch recovery, the depth clock, shedding
# ---------------------------------------------------------------------------


def test_failed_dispatch_requeues_at_head_nothing_lost(data_dir):
    """A raising dispatch re-queues the batch at the HEAD in order; the
    retry serves bitwise-identical responses."""
    payloads = _payloads(3)

    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(
            session, retry=3, breaker_threshold=99, metrics=m, clock=_counter_clock()
        )
        reqs = [eng.submit(p) for p in payloads]
        real, calls = session.predict, []

        def flaky(x):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("transient backend failure")
            return real(x)

        session.predict = flaky
        first = eng.step()
        mid = ([r.id for r in eng._queue], [r.verdict for r in reqs], _counters(eng))
        done = eng.drain()
        session.predict = real
        return eng, reqs, (first, mid, [r.id for r in done])

    session, eng, reqs, (first, mid, order), _ = _run_both(data_dir, scenario)
    assert first == [] and mid[0] == [0, 1, 2] and set(mid[1]) == {"queued"}
    assert mid[2]["failed_dispatches"] == 1 and mid[2]["retries"] == 3
    assert order == [0, 1, 2] and all(r.attempts == 1 for r in reqs)
    for r in reqs:
        assert r.verdict == "ok" and np.array_equal(r.result, session.predict(payloads[r.id]))


def test_exhausted_retry_budget_completes_as_error(data_dir):
    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(
            session, retry=2, breaker_threshold=99, metrics=m, clock=_counter_clock()
        )
        reqs = [eng.submit(p) for p in _payloads(2)]
        real = session.predict
        session.predict = lambda x: (_ for _ in ()).throw(RuntimeError("hard down"))
        eng.drain()
        session.predict = real
        return eng, reqs, None

    _, eng, reqs, _, recs = _run_both(data_dir, scenario)
    assert [r.verdict for r in reqs] == ["error", "error"]
    assert all(r.attempts == 2 and r.result is None for r in reqs)
    st = eng.stats()
    assert st["errors"] == 2 and st["failed_dispatches"] == 2 and st["availability"] == 0.0
    errs = _kind(recs, "request", "error")
    assert len(errs) == 2 and all("RuntimeError" in r["reason"] for r in errs)
    health = _kind(recs, "serving_health")
    assert [r["name"] for r in health] == ["dispatch_error", "dispatch_error"]
    assert health[0]["requeued"] == 2 and health[1]["exhausted"] == 2


def test_record_depth_uses_request_timeline_clock(data_dir):
    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(session, max_queue=1, metrics=m, clock=lambda: 100.0)
        x = _payloads(1)[0]
        reqs = [eng.submit(x, arrival_t=50.0), eng.submit(x, arrival_t=51.0)]
        return eng, reqs, list(eng._depths)

    _, _, reqs, depths, recs = _run_both(data_dir, scenario)
    assert depths == [(50.0, 1)] and reqs[1].verdict == "dropped"
    drop = _kind(recs, "request")[-1]
    assert drop["name"] == "dropped" and drop["enqueue_ts"] == 51.0
    assert drop["reason"] == "queue_full"


def test_pack_time_shedding_before_costing_a_slot(data_dir):
    def scenario(pkg, session, m):
        t = {"now": 0.0}
        eng = PKGS[pkg][0].ServingEngine(session, metrics=m, clock=lambda: t["now"])
        eng._latency_floor = 0.0  # the already-passed-deadline leg alone
        p = _payloads(2)
        reqs = [eng.submit(p[0], deadline_ms=100.0), eng.submit(p[1])]
        t["now"] = 0.5
        done = eng.step()
        return eng, reqs, [r.id for r in done]

    _, eng, reqs, order, _ = _run_both(data_dir, scenario)
    assert order == [0, 1] and [r.verdict for r in reqs] == ["expired", "ok"]
    assert reqs[0].complete_t == 0.5 and reqs[0].result is None
    assert eng.stats()["slots_dispatched"] == reqs[1].slots


def test_provable_floor_shedding_and_admission_backpressure(data_dir):
    """The same floor on both sides (the cost models differ by design): a
    deadline the floor provably cannot meet is shed at pack time, and —
    under ``shed_on_submit`` — refused at admission."""
    def scenario(pkg, session, m):
        mod = PKGS[pkg][0]
        eng = mod.ServingEngine(session, metrics=m, clock=lambda: 0.0)
        eng._latency_floor = 10.0
        reqs = [eng.submit(_payloads(1)[0], deadline_ms=5000.0)]
        eng.step()
        eng2 = mod.ServingEngine(session, clock=lambda: 0.0, shed_on_submit=True)
        eng2._latency_floor = 10.0
        r2 = [eng2.submit(_payloads(1)[0], deadline_ms=d) for d in (5000.0, 60_000.0)]
        return eng, reqs, ([r.verdict for r in r2], eng2.queue_depth, _counters(eng2))

    _, eng, reqs, (verdicts2, depth2, _), _ = _run_both(data_dir, scenario)
    assert reqs[0].verdict == "expired" and eng.stats()["slots_dispatched"] == 0
    assert verdicts2 == ["expired", "queued"] and depth2 == 1


# ---------------------------------------------------------------------------
# health gate, breaker, hot reload
# ---------------------------------------------------------------------------


def test_health_gate_breaker_and_degraded_admission(data_dir):
    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(
            session, breaker_threshold=2, metrics=m, clock=_counter_clock()
        )
        p = _payloads(6)
        session.poison_weights()  # every dispatch from here is non-finite
        reqs = [eng.submit(x) for x in p[:3]]
        eng.step()
        states = [eng.degraded]
        reqs.append(eng.submit(p[3]))
        eng.step()
        states.append(eng.degraded)
        reqs.append(eng.submit(p[4]))  # refused: the breaker is open
        eng.close_breaker()
        reqs.append(eng.submit(p[5]))
        return eng, reqs, states

    _, eng, reqs, states, recs = _run_both(data_dir, scenario)
    assert states == [False, True]
    assert [r.verdict for r in reqs] == ["unhealthy"] * 4 + ["dropped", "queued"]
    st = eng.stats()
    assert st["unhealthy"] == 4 and st["breaker_trips"] == 1 and st["availability"] == 0.0
    assert [r["name"] for r in _kind(recs, "serving_health")] == [
        "unhealthy_dispatch", "unhealthy_dispatch", "breaker_open", "breaker_closed",
    ]
    assert _kind(recs, "request", "dropped")[0]["reason"] == "degraded"
    # the breaker_open event rule fired and resolved
    assert [r["state"] for r in _kind(recs, "alert", "breaker_open")] == ["firing", "resolved"]


def test_find_newer_good_equals_jax(ck, tmp_path):
    """The watcher's discovery, the port's against the JAX function on the
    same directory, then with a corrupt newest candidate."""
    for than in (None, 0, 8):
        got, want = tckpt.find_newer_good(ck, than_step=than), jckpt.find_newer_good(ck, than_step=than)
        assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
        assert got[2] == want[2]
    bad = tmp_path / "ck"
    bad.mkdir()
    for step in (0, 8):
        src = tckpt.step_checkpoint_path(ck, step)
        tckpt.step_checkpoint_path(bad, step).write_bytes(src.read_bytes())
    tfaults.corrupt_checkpoint_bytes(tckpt.step_checkpoint_path(bad, 8), seed=3)
    step, path, meta, skipped = tckpt.find_newer_good(bad, than_step=0)
    assert step is None and len(skipped) == 1
    assert skipped == jckpt.find_newer_good(bad, than_step=0)[3]


def test_breaker_triggered_reload_recovers(data_dir, ck):
    """nan-poisoned weights trip the breaker; its reload restores the
    newest good snapshot and closes it; the next response is bitwise a
    fresh session that loaded the same checkpoint."""
    p = _payloads(3)

    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(
            session, reload_dir=ck, loaded_step=0, breaker_threshold=1, retry=1,
            faults="nan@dispatch=1", metrics=m, clock=_counter_clock(),
        )
        reqs = []
        for x in p:
            reqs.append(eng.submit(x))
            eng.step()
        return eng, reqs, eng.degraded

    session, eng, reqs, degraded, recs = _run_both(data_dir, scenario)
    assert [r.verdict for r in reqs] == ["ok", "unhealthy", "ok"] and not degraded
    fresh = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS,
                         resume=tckpt.step_checkpoint_path(ck, 8))
    assert np.array_equal(reqs[2].result, fresh.predict(p[2]))
    assert session.model_hash() == fresh.model_hash()
    st = eng.stats()
    assert st["breaker_trips"] == 1 and st["reloads"] == 1 and st["recovery_s"] >= 0
    (rel,) = _kind(recs, "reload")
    assert rel["name"] == "ok" and rel["reason"] == "breaker" and rel["step"] == 8


def test_reload_failure_paths(data_dir, tmp_path):
    s = _session("torch", data_dir)
    eng = tengine.ServingEngine(s)
    with pytest.raises(ValueError, match="reload_dir"):
        eng.reload()
    with pytest.raises(ValueError, match="reload_dir"):
        eng.watch_reload()
    empty = tmp_path / "empty_ck"
    empty.mkdir()
    with pytest.raises(tckpt.CheckpointError, match="no snapshot verifies"):
        tengine.ServingEngine(s, reload_dir=empty).reload()
    # the breaker's reload records the failure and stays degraded
    m = _recorder("torch")
    eng = tengine.ServingEngine(s, reload_dir=empty, breaker_threshold=1, metrics=m,
                                faults="nan@dispatch=0")
    eng.submit(_payloads(1)[0])
    eng.step()
    assert eng.degraded
    assert [r["name"] for r in _kind(m.records, "reload")] == ["failed"]


@pytest.mark.parametrize("what", ["sizes", "activation"])
def test_load_weights_refusals_in_jax_words(what, data_dir, tmp_path):
    """A checkpoint that would change a cached program's shapes or
    structure is refused before any state changes, in the JAX session's
    words."""
    if what == "sizes":
        spec = tmodel.make_model_spec((SIZES[0], 12, 10), 1, GBS)
    else:
        spec = tmodel.make_model_spec(SIZES, 1, GBS, act="gelu")
    path = tmp_path / "other.npz"
    tckpt.save_checkpoint(path, tmodel.init_model(spec), spec, 0)
    errors = []
    for pkg in ("jax", "torch"):
        s = _session(pkg, data_dir)
        before = s.model_hash()
        with pytest.raises(ValueError, match="hot reload must preserve") as e:
            s.load_weights(path)
        assert s.model_hash() == before
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_reload_reads_the_snapshot_once_and_records_verify_s(data_dir, ck, tmp_path, monkeypatch):
    """Both reload legs assemble the weights discovery already verified:
    the restored file is read once (deleting it between discovery and the
    swap changes nothing), and the ``reload`` record carries verify_s."""
    work = tmp_path / "ck"
    work.mkdir()
    for step in (0, 8):
        tckpt.step_checkpoint_path(work, step).write_bytes(
            tckpt.step_checkpoint_path(ck, step).read_bytes()
        )
    reads = []
    real = tckpt._read_arrays
    monkeypatch.setattr(tckpt, "_read_arrays", lambda p: (reads.append(str(p)), real(p))[1])
    s = _session("torch", data_dir)
    m = _recorder("torch")
    eng = tengine.ServingEngine(s, reload_dir=work, loaded_step=0, metrics=m)
    orig = eng.reload

    def delete_then_reload(path=None, **kw):
        tckpt.step_checkpoint_path(work, 8).unlink()
        return orig(path=path, **kw)

    monkeypatch.setattr(eng, "reload", delete_then_reload)
    assert eng.watch_reload() == 8
    assert reads.count(str(tckpt.step_checkpoint_path(work, 8))) == 1
    fresh = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS,
                         resume=tckpt.step_checkpoint_path(ck, 8))
    assert s.model_hash() == fresh.model_hash()
    monkeypatch.setattr(eng, "reload", orig)
    reads.clear()
    eng.reload(reason="manual")  # newest good is now step 0
    assert reads == [str(tckpt.step_checkpoint_path(work, 0))]
    # a find_latest_good(with_arrays=True) pair assembles with no read
    path, meta, arrays, _ = tckpt.find_latest_good(work, with_arrays=True)
    reads.clear()
    s.load_weights(path, verified=(meta, arrays))
    assert reads == []
    rel = _kind(m.records, "reload")
    assert [r["name"] for r in rel] == ["ok", "ok"]
    assert all(r["verify_s"] >= 0 and r["wall_s"] >= r["verify_s"] for r in rel)


@pytest.mark.parametrize(
    "layout",
    [dict(dp=2, pp=2), dict(pp=2, tp=2), dict(dp=2, zero=3)],
    ids=["dp2-pp2", "pp2-tp2", "dp2-zero3"],
)
def test_mesh_reload_is_bitwise_a_fresh_session_and_keeps_its_programs(layout, ck):
    """On the mesh the rung programs take the params at call time: after a
    reload the same program objects serve bitwise what a fresh session
    that loaded the checkpoint serves."""
    kw = dict(sizes=SIZES, global_batch_size=GBS, predict_slot_ladder=(1, 2),
              device="cpu", **layout)
    s = TorchSession(**kw)
    x = np.random.RandomState(3).randn(13, SIZES[0]).astype(np.float32)
    before = s.predict(x)
    programs = dict(s._predict_cache)
    eng = tengine.ServingEngine(s, reload_dir=ck, loaded_step=0)
    assert eng.watch_reload() == 8
    fresh = TorchSession(resume=tckpt.step_checkpoint_path(ck, 8), **kw)
    after = s.predict(x)
    assert np.array_equal(after, fresh.predict(x)) and not np.array_equal(after, before)
    assert s._predict_cache == programs


# ---------------------------------------------------------------------------
# chaos injections in the dispatch loop
# ---------------------------------------------------------------------------


def test_die_fault_raises_before_pop_queue_intact(data_dir):
    p = _payloads(2)

    def scenario(pkg, session, m):
        eng_mod, lg, _ = PKGS[pkg]
        eng = eng_mod.ServingEngine(session, faults="die@dispatch=0", metrics=m,
                                    clock=_counter_clock())
        reqs = [eng.submit(x) for x in p]
        with pytest.raises(Exception, match="die@dispatch=0") as e:
            eng.step()
        depth = eng.queue_depth
        eng.drain()
        # the loadgen drive loops are the operator loop: they absorb the death
        done2 = lg.run_open_loop(eng_mod.ServingEngine(session, faults="die@dispatch=0"),
                                 p, arrivals=[0.0, 0.0])
        done3 = lg.run_closed_loop(eng_mod.ServingEngine(session, faults="die@dispatch=0"),
                                   p, concurrency=2)
        return eng, reqs, (type(e.value).__name__, depth,
                           [r.verdict for r in done2], [r.verdict for r in done3])

    session, _, reqs, (exc, depth, v2, v3), recs = _run_both(data_dir, scenario)
    assert exc == "InjectedFault" and depth == 2 and v2 == v3 == ["ok", "ok"]
    for r in reqs:
        assert r.verdict == "ok" and np.array_equal(r.result, session.predict(p[r.id]))
    assert _kind(recs, "serving_health")[0]["name"] == "fault_injected"


def test_error_and_slow_faults_inside_dispatch(data_dir):
    def scenario(pkg, session, m):
        eng = PKGS[pkg][0].ServingEngine(
            session, retry=2, breaker_threshold=99, metrics=m, clock=_counter_clock(),
            faults="error@dispatch=0,slow@dispatch=1:ms=30",
        )
        reqs = [eng.submit(_payloads(1)[0])]
        first = eng.step()
        attempts = reqs[0].attempts
        eng.step()
        return eng, reqs, (first, attempts)

    _, _, reqs, (first, attempts), recs = _run_both(data_dir, scenario)
    assert first == [] and attempts == 1 and reqs[0].verdict == "ok"
    injected = _kind(recs, "serving_health", "fault_injected")
    assert [r["fault"] for r in injected] == ["error@dispatch=0", "slow@dispatch=1:ms=30"]
    # slow sleeps for real inside the dispatch
    eng = tengine.ServingEngine(_session("torch", data_dir), faults="slow@dispatch=0:ms=30")
    eng.submit(_payloads(1)[0])
    t0 = time.perf_counter()
    eng.step()
    assert time.perf_counter() - t0 >= 0.03


CHAOS_PLAN = "error@dispatch=1,slow@dispatch=2:ms=1,die@dispatch=3,nan@dispatch=6,nan@dispatch=7"
CHAOS_PAYLOADS = tloadgen.request_payloads(30, SIZES[0], seed=2, rows_choices=(1, 2, 3, 5))
CHAOS_ARRIVALS = tloadgen.poisson_arrivals(2000.0, 30, seed=2)


def _chaos_drive(pkg, session, m, ck):
    """Seeded open-loop load under every fault kind and both reload legs,
    on the injected clock: ``error``, ``slow``, a ``die`` the drive loop
    absorbs, a watcher reload at dispatch 2 and two ``nan`` dispatches
    that trip a breaker of 2, whose reload recovers."""
    eng_mod, lg, _ = PKGS[pkg]
    eng = eng_mod.ServingEngine(
        session, metrics=m, clock=_counter_clock(), faults=CHAOS_PLAN, retry=2,
        breaker_threshold=2, reload_dir=ck, loaded_step=0, max_slots=2,
        slo_ms=50.0, telemetry_window_s=0.002,
    )
    watched = []

    def on_tick(elapsed):
        if not watched and eng.dispatch_seq >= 2:
            watched.append(eng.watch_reload())

    done = lg.run_open_loop(eng, CHAOS_PAYLOADS, CHAOS_ARRIVALS, sleep=lambda s: None,
                            on_tick=on_tick)
    by_id = {r.id: r for r in done}
    reqs = [by_id[i] for i in sorted(by_id)]
    rec = eng.record_summary(offered_rps=2000.0, name="chaos")
    return eng, reqs, ([r.id for r in done], watched,
                       {k: v for k, v in rec.items() if k not in NOT_COMPARED})


def test_chaos_plan_under_load_matches_jax(data_dir, ck):
    """Every fault kind and both reload legs under seeded open-loop load
    (``_chaos_drive``). Both engines agree on every verdict, attempt,
    counter, record and span chain; every id is terminal; every port "ok"
    response is bitwise a direct predict() under the weights active at its
    dispatch (the init before the watcher's reload, step 8 after)."""
    payloads = CHAOS_PAYLOADS

    def scenario(pkg, session, m):
        return _chaos_drive(pkg, session, m, ck)

    session, eng, reqs, (order, watched, _), recs = _run_both(data_dir, scenario)
    assert watched == [8] and len(reqs) == 30 and len(order) == 30
    verdicts = {r.verdict for r in reqs}
    assert verdicts <= set(tengine.TERMINAL_VERDICTS) and {"ok", "unhealthy"} <= verdicts
    st = eng.stats()
    assert st["failed_dispatches"] == 1 and st["breaker_trips"] == 1 and st["reloads"] == 2
    assert st["recovery_s"] is not None and not st["degraded"]
    assert not eng._faults.pending_dispatch
    # the oracle per weights era: init, then step 8 from the watcher on
    init = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS)
    moved = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS,
                         resume=tckpt.step_checkpoint_path(ck, 8))
    eras = []
    for r in reqs:
        if r.verdict != "ok":
            continue
        x = payloads[r.id]
        if np.array_equal(r.result, init.predict(x)):
            eras.append(0)
        else:
            assert np.array_equal(r.result, moved.predict(x)), r.id
            eras.append(1)
    assert eras == sorted(eras) and 0 in eras and 1 in eras
    assert np.array_equal(session.predict(payloads[0]), moved.predict(payloads[0]))
    # records: every kind the engine writes, and complete span chains
    kinds = {r["kind"] for r in recs}
    assert {"request", "serving", "serving_health", "reload", "trace", "rollup",
            "alert", "gauge"} <= kinds
    chains = ttracing.assemble_chains(recs)
    assert ttracing.verify_terminal_chains(recs, chains, strict=True) == []
    assert len(chains) == 30


def _cli_text(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().replace("shallowspeed_tpu_torch.", "shallowspeed_tpu.")


def test_chaos_stream_renders_alike_in_both_packages(data_dir, ck, tmp_path):
    """The JSONL stream is a durable format: each engine's stream of the
    chaos drive is the other's line for line (but ``ts``), and the report
    (Serving, Degradation, Alerts, Tracing) and ``watch --once`` render
    either stream to the same text in both packages."""
    from shallowspeed_tpu.observability import report as jreport
    from shallowspeed_tpu.observability import watch as jwatch
    from shallowspeed_tpu_torch.observability import report as treport
    from shallowspeed_tpu_torch.observability import watch as twatch

    paths = {}
    for pkg, mmod in (("jax", jmetrics), ("torch", tmetrics)):
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        m = mmod.JsonlMetrics(paths[pkg])
        _chaos_drive(pkg, _session(pkg, data_dir), m, ck)
        m.close()
    lines = {
        pkg: [{k: v for k, v in r.items() if k not in NOT_COMPARED | {"created"}}
              for r in jmetrics.read_jsonl(path)]
        for pkg, path in paths.items()
    }
    assert lines["torch"] == lines["jax"]
    for path in paths.values():
        for fmt in ("md", "text"):
            argv = [str(path), "--format", fmt, "--slo-ms", "50"]
            text = _cli_text(treport.main, argv)
            assert text == _cli_text(jreport.main, argv)
        assert "### Degradation" in text or "degradation" in text.lower()
        for fmt in ("text", "json"):
            argv = [str(path), "--once", "--format", fmt]
            assert _cli_text(twatch.main, argv) == _cli_text(jwatch.main, argv)


# ---------------------------------------------------------------------------
# graceful drain and the serve CLI's exit codes
# ---------------------------------------------------------------------------


def test_loadgen_additions_equal_jax(data_dir):
    """``payload_in_dim`` and ``request_payloads(data=...)``: the JAX
    package's values; ``_step_reentrant`` absorbs only an injected death."""
    for d in (data_dir, None, data_dir / "missing"):
        assert tloadgen.payload_in_dim(d) == jloadgen.payload_in_dim(d)
    pool = np.load(data_dir / "x_val.npy")
    got = tloadgen.request_payloads(9, SIZES[0], seed=4, data=pool)
    want = jloadgen.request_payloads(9, SIZES[0], seed=4, data=pool)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))

    class Dies:
        def step(self):
            raise tfaults.InjectedFault("die")

    class Breaks:
        def step(self):
            raise RuntimeError("not a chaos fault")

    assert tloadgen._step_reentrant(Dies()) == []
    with pytest.raises(RuntimeError):
        tloadgen._step_reentrant(Breaks())


def test_drive_loops_stop_admission_and_drain(data_dir):
    s = _session("torch", data_dir)
    eng = tengine.ServingEngine(s)
    payloads = _payloads(10)
    arrivals = [0.0] * 3 + [60.0] * 7

    def should_stop():
        return eng.stats()["dispatches"] >= 1

    done = tloadgen.run_open_loop(eng, payloads, arrivals, should_stop=should_stop)
    assert 1 <= len(done) <= 3 and eng.queue_depth == 0
    assert all(r.verdict == "ok" for r in done)
    eng2 = tengine.ServingEngine(s)
    assert tloadgen.run_closed_loop(eng2, payloads, concurrency=2, should_stop=lambda: True) == []


def test_serve_cli_sigterm_graceful_drain(tmp_path, capsys, monkeypatch):
    """SIGTERM after the first dispatch: admission stops, the queue drains,
    the metrics flush, exit 0; the handlers are restored even so."""
    import signal as signal_mod

    from shallowspeed_tpu_torch.serving.__main__ import main as serve_main

    handlers, restored = {}, []
    orig_signal = signal_mod.signal

    def capture_signal(sig, h):
        if sig in handlers:
            restored.append(sig)
        handlers[sig] = h
        return signal_mod.SIG_DFL

    monkeypatch.setattr(signal_mod, "signal", capture_signal)
    orig_step = tengine.ServingEngine.step

    def step_then_sigterm(self):
        out = orig_step(self)
        h = handlers.get(signal_mod.SIGTERM)
        if h is not None and self.stats()["dispatches"] >= 1:
            h(signal_mod.SIGTERM, None)
        return out

    monkeypatch.setattr(tengine.ServingEngine, "step", step_then_sigterm)
    out = tmp_path / "drain.jsonl"
    rc = serve_main(["--device", "cpu", "--requests", "50", "--rate", "30",
                     "--slot-ladder", "1,2,4", "--metrics-out", str(out)])
    monkeypatch.setattr(signal_mod, "signal", orig_signal)
    assert rc == 0
    assert "SIGTERM received: admission stopped, queue drained" in capsys.readouterr().out
    assert out.exists() and sorted(restored) == sorted([signal_mod.SIGTERM, signal_mod.SIGINT])


def test_serve_cli_degraded_exit_code(capsys):
    """nan-poisoned weights and no reload dir: the breaker stays open, exit
    3 — the JAX CLI's code."""
    from shallowspeed_tpu_torch.serving.__main__ import main as serve_main

    rc = serve_main(["--device", "cpu", "--requests", "12", "--rate", "3000",
                     "--slot-ladder", "1,2,4", "--faults", "nan@dispatch=0",
                     "--breaker", "1"])
    assert rc == 3
    assert "DEGRADED" in capsys.readouterr().err
