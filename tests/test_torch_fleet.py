"""The port's serving fleet on CPU replica workers, held to the JAX
package: a checkpoint the JAX package wrote, served by a port fleet with
worker-side ``verify``, answers within 1e-6 of the JAX session's
``predict``; SIGKILL failover leaves every admitted id terminal;
``scale_up``/``scale_down``; the loadgen ``should_stop`` drain; the serve
CLI's exit 3 with the quorum down; workers sharing an ``aot_cache_dir``
(the first stores, a scale-up replacement loads); the
``fleet``/``fleet_health`` records with the JAX fleet's key
sets; and the skewed-clock alignment with zero orphan span chains.

Every test spawns real worker processes (2 replicas, a two-rung ladder,
a small MLP) and carries the ``fleet`` marker; like the JAX package's
fleet tests they skip with a reason where the platform cannot spawn.
"""

import ast
import contextlib
import io
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
from shallowspeed_tpu.observability.metrics import read_jsonl as jax_read_jsonl
from shallowspeed_tpu.serving.fleet import ServingFleet as JaxFleet
from shallowspeed_tpu_torch.observability import JsonlMetrics, read_jsonl, tracing
from shallowspeed_tpu_torch.observability.report import build_report, render
from shallowspeed_tpu_torch.serving import __main__ as tcli
from shallowspeed_tpu_torch.serving import fleet as fleet_mod
from shallowspeed_tpu_torch.serving import loadgen, router
from shallowspeed_tpu_torch.serving.fleet import ServingFleet

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 64
ROOT = Path(__file__).resolve().parent.parent
SKEW = 3.0

pytestmark = pytest.mark.fleet


def _require_workers():
    if not fleet_mod.fleet_workers_supported():
        pytest.skip(
            "this platform cannot spawn fleet worker processes "
            "(multiprocessing spawn context unavailable or broken)"
        )


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX package trained one epoch and saved; the
    JAX session stays as the oracle."""
    base = tmp_path_factory.mktemp("fleet_ck")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 256), ("val", 96)):
        x = rng.randn(n, SIZES[0]).astype(np.float32)
        y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)]
        np.save(base / f"x_{suffix}.npy", x)
        np.save(base / f"y_{suffix}.npy", y)
    session = JaxSession(sizes=SIZES, global_batch_size=GBS, lr=0.01, data_dir=base)
    session.train_epoch()
    ck = base / "serve.npz"
    session.save(ck)
    return base, ck, session


def _worker_config(ck=None, **extra):
    cfg = {
        "session": dict(
            sizes=SIZES,
            global_batch_size=GBS,
            resume=None if ck is None else os.fspath(ck),
            # a two-rung ladder keeps each worker's warm-up small
            predict_slot_ladder=(1, 2),
            device="cpu",
        ),
        "engine": dict(retry=2, breaker_threshold=3),
        "verify": True,
    }
    cfg.update(extra)
    return cfg


def _drive(fleet, n, rate=300.0, kill_after=None, seed=0, replace=False):
    """Seeded open-loop drive; optionally SIGKILL the busiest ready replica
    once ``kill_after`` requests completed (and scale up a replacement
    off-path). Returns (submitted, done, killed replica id)."""
    payloads = loadgen.request_payloads(n, SIZES[0], seed=seed)
    arrivals = loadgen.poisson_arrivals(rate, n, seed=seed)
    t0 = fleet.clock()
    i, killed, scaled = 0, None, False
    submitted, done = [], []
    while i < n or fleet.queue_depth:
        now = fleet.clock() - t0
        while i < n and arrivals[i] <= now:
            submitted.append(fleet.submit(payloads[i], arrival_t=t0 + arrivals[i]))
            i += 1
        done.extend(fleet.step())
        if kill_after is not None and killed is None and len(done) >= kill_after:
            ready = [r for r in fleet.replicas.values() if r.state == "ready"]
            victim = max(ready, key=lambda r: (r.inflight, -r.replica_id))
            fleet.sigkill_replica(victim.replica_id)
            killed = victim.replica_id
        if replace and killed is not None and not scaled and any(
            r.state == "dead" for r in fleet.replicas.values()
        ):
            fleet.scale_up(wait_ready=False)
            scaled = True
        if not fleet.queue_depth and i < n:
            time.sleep(max(0.0, arrivals[i] - (fleet.clock() - t0)))
    return submitted, done, killed


@pytest.fixture(scope="module")
def served(jax_checkpoint, tmp_path_factory):
    """One verified port fleet lifetime serving the JAX checkpoint, with a
    JSONL recorder and a +3 s clock skew injected in every worker."""
    _require_workers()
    _, ck, _ = jax_checkpoint
    path = tmp_path_factory.mktemp("served") / "fleet.jsonl"
    m = JsonlMetrics(path)
    with ServingFleet(_worker_config(ck, clock_offset_s=SKEW), n_replicas=2,
                      slo_ms=5000, retry=2, metrics=m, seed=0) as fleet:
        fleet.start()
        submitted, done, _ = _drive(fleet, 24)
        stats = fleet.record_summary(offered_rps=300.0)
    m.close()
    return submitted, done, stats, path


def test_jax_checkpoint_served_within_1e6_of_jax_predict(served, jax_checkpoint):
    submitted, done, stats, _ = served
    _, _, jax_session = jax_checkpoint
    assert len(submitted) == 24 and all(r.verdict == "ok" for r in submitted)
    assert stats["parity_mismatches"] == 0 and stats["replicas_ready"] == 2
    assert all(r.parity_ok is True for r in done)
    assert {r.replica_id for r in done} == {0, 1}
    for r in done:
        np.testing.assert_allclose(r.result, np.asarray(jax_session.predict(r.x)),
                                   rtol=0, atol=1e-6)


def _fleet_health_call_keys(path):
    """``{event name: keyword names}`` of every ``fleet_health("<name>",
    ...)`` call in a fleet module's source."""
    out = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "fleet_health"
                and isinstance(node.args[0], ast.Constant)):
            keys = frozenset(k.arg for k in node.keywords)
            assert out.setdefault(node.args[0].value, keys) == keys
    return out


def _envelope(jsonl, path):
    """The keys a recorder adds to every record (a record with no fields)."""
    m = jsonl(path)
    m.fleet_health("probe")
    m.close()
    return set(read_jsonl(path)[-1])


def test_fleet_records_have_the_jax_fleets_key_sets(served, tmp_path):
    """Every ``fleet_health`` event the port's fleet can emit carries the
    JAX fleet's keys (both sources), the records this run wrote carry
    exactly those, and the ``fleet``/``serving`` summaries carry the JAX
    fleet's summary keys."""
    _, _, _, path = served
    jax_keys = _fleet_health_call_keys(ROOT / "shallowspeed_tpu/serving/fleet.py")
    port_keys = _fleet_health_call_keys(ROOT / "shallowspeed_tpu_torch/serving/fleet.py")
    assert port_keys == jax_keys and len(jax_keys) >= 14
    envelope = _envelope(JsonlMetrics, tmp_path / "env.jsonl")
    recs = read_jsonl(path)
    seen = set()
    for r in recs:
        if r["kind"] == "fleet_health":
            assert set(r) - envelope == set(jax_keys[r["name"]]), r
            seen.add(r["name"])
    assert {"replica_spawned", "replica_ready"} <= seen
    # the JAX fleet's summaries, from a JAX fleet that never started
    jpath = tmp_path / "jax.jsonl"
    jm = JaxJsonl(jpath)
    JaxFleet({}, n_replicas=1, metrics=jm).record_summary(offered_rps=300.0)
    jm.close()
    jrecs = jax_read_jsonl(jpath)
    for kind, name in (("fleet", "summary"), ("serving", "fleet")):
        (want,) = [set(r) for r in jrecs if (r["kind"], r.get("name")) == (kind, name)]
        (got,) = [set(r) for r in recs if (r["kind"], r.get("name")) == (kind, name)]
        assert got == want, (kind, got ^ want)


def test_skewed_worker_clock_alignment_zero_orphan_chains(served):
    """A +3 s worker clock skew: the handshake recovers it within its own
    uncertainty, worker spans land inside their request's parent-side
    window, phases sum to the parent-measured latency, and no terminal
    request is left with an orphan chain; without the offsets the join
    degrades loudly."""
    _, _, _, path = served
    recs = read_jsonl(f"{path}*")
    offsets = tracing.clock_offsets(recs)
    assert set(offsets) == {0, 1}
    for rid, off in offsets.items():
        assert abs(off["offset_s"] - SKEW) <= off["uncertainty_s"], (rid, off)
        assert off["uncertainty_s"] < 0.05
    chains = tracing.assemble_chains(recs)
    assert len(chains) == 24
    assert tracing.verify_terminal_chains(recs, chains) == []
    for c in chains.values():
        assert c.alignment == "aligned"
        slack = c.uncertainty_s + 1e-4
        for s in c.spans:
            if s.get("clock") == "worker":
                assert s["t0_aligned"] >= c.t0 - slack
                assert s["t1_aligned"] <= c.t_end + slack
        assert sum(tracing.chain_phases(c).values()) == pytest.approx(
            c.latency_s, abs=4 * c.uncertainty_s + 1e-6)
        assert any(s["name"] == "verify" for s in c.spans)
    stripped = [r for r in recs
                if not (r.get("kind") == "trace" and r.get("name") == "clock_offset")]
    assert all(c.alignment == "missing" for c in tracing.assemble_chains(stripped).values())
    report = build_report(stripped, source="stripped")
    assert report["tracing"]["alignment_missing_replicas"] == [0, 1]
    assert "ALIGNMENT DEGRADED" in render(report, "md")


def test_sigkill_failover_every_admitted_id_terminal(jax_checkpoint, tmp_path):
    """A replica SIGKILLed mid-stream: its un-acked requests fail over at
    the fleet queue's head, every admitted id reaches a terminal verdict,
    the failover span links the dead replica's partial chain to the
    completion, and a replacement restores the quorum without raising
    the target."""
    _require_workers()
    _, ck, _ = jax_checkpoint
    path = tmp_path / "kill.jsonl"
    m = JsonlMetrics(path)
    with ServingFleet(_worker_config(ck), n_replicas=2, slo_ms=5000, retry=3,
                      metrics=m, seed=0) as fleet:
        fleet.start()
        submitted, _, killed = _drive(fleet, 40, rate=400.0, kill_after=5, replace=True)
        fleet.wait_ready()
        stats = fleet.record_summary()
        assert not fleet.degraded
    m.close()
    assert killed is not None
    assert all(r.verdict in ("ok", "dropped", "error") for r in submitted)
    assert all(r.verdict != "queued" for r in submitted if r.admitted)
    assert stats["replicas_dead"] == 1 and stats["scale_ups"] == 1
    assert stats["replicas_target"] == 2 and stats["scale_up_s"] is not None
    assert stats["parity_mismatches"] == 0 and stats["recovery_s"] is not None
    recs = read_jsonl(f"{path}*")
    chains = tracing.assemble_chains(recs)
    assert tracing.verify_terminal_chains(recs, chains) == []
    names = {r["name"] for r in recs if r["kind"] == "fleet_health"}
    assert {"replica_sigkill", "replica_dead", "fleet_degraded", "scale_up"} <= names
    if stats["failover_requeued"]:
        for c in chains.values():
            fo = [s for s in c.spans if s["name"] == "failover.requeue"]
            if fo:
                assert fo[0]["from_replica"] == killed
                assert c.verdict in ("ok", "error")


def test_scale_up_and_scale_down(jax_checkpoint, tmp_path):
    """Growth raises the target once the replica is ready; a scale-down
    drains the newest routable replica, whose drained stats carry its
    process's launch counts (none on the CPU) outside the JSONL record."""
    _require_workers()
    _, ck, jax_session = jax_checkpoint
    path = tmp_path / "scale.jsonl"
    m = JsonlMetrics(path)
    with ServingFleet(_worker_config(ck), n_replicas=2, slo_ms=5000, metrics=m,
                      seed=0) as fleet:
        fleet.start()
        rid = fleet.scale_up()
        assert fleet.n_ready == 3 and fleet.target_replicas == 3 and rid == 2
        submitted, _, _ = _drive(fleet, 12, seed=2)
        assert all(r.verdict == "ok" for r in submitted)
        retired = fleet.scale_down()
        assert retired == 2 and fleet.target_replicas == 2
        deadline = time.time() + 60
        while fleet.replicas[retired].state != "retired" and time.time() < deadline:
            fleet.step()
        assert fleet.replicas[retired].state == "retired"
        more, _, _ = _drive(fleet, 8, seed=3)
        assert {r.replica_id for r in more} <= {0, 1}
        stats = fleet.stats()
    m.close()
    assert stats["scale_ups"] == 1 and stats["scale_downs"] == 1
    assert stats["replicas_retired"] == 1 and stats["availability"] == 1.0
    st = fleet.retired_stats()
    assert list(st) == [2]
    assert st[2]["launches"] == dict.fromkeys(st[2]["launches"], 0)
    assert st[2]["completed"] == sum(1 for r in submitted if r.replica_id == 2)
    (rec,) = [r for r in read_jsonl(path)
              if r["kind"] == "fleet_health" and r["name"] == "replica_retired"]
    assert "launches" not in rec["stats"] and rec["stats"]["completed"] == st[2]["completed"]
    for r in submitted + more:
        np.testing.assert_allclose(r.result, np.asarray(jax_session.predict(r.x)),
                                   rtol=0, atol=1e-6)


def test_loadgen_open_loop_should_stop_drains_fleet(jax_checkpoint):
    """The loadgen drive loops run unchanged over the router: a seeded
    stream stopped mid-flight stops ADMISSION, drains everything admitted
    to a terminal verdict, and keeps the coordinated-omission backdating
    across the fleet hop."""
    _require_workers()
    _, ck, _ = jax_checkpoint
    with ServingFleet(_worker_config(ck), n_replicas=2, slo_ms=5000, seed=0) as fleet:
        fleet.start()
        payloads = loadgen.request_payloads(24, SIZES[0], seed=1)
        arrivals = loadgen.poisson_arrivals(300.0, 24, seed=1)
        seen = []
        orig_submit = fleet.submit

        def tracking_submit(x, deadline_ms=None, arrival_t=None):
            req = orig_submit(x, deadline_ms=deadline_ms, arrival_t=arrival_t)
            seen.append((req, arrival_t))
            return req

        fleet.submit = tracking_submit
        done = loadgen.run_open_loop(fleet, payloads, arrivals, deadline_ms=None,
                                     should_stop=lambda: len(seen) >= 10)
        assert 10 <= len(seen) < 24
        assert fleet.queue_depth == 0
        assert all(req.verdict != "queued" for req, _ in seen)
        assert done and {r.verdict for r in done} == {"ok"}
        for req, arrival_t in seen:
            assert req.enqueue_t == pytest.approx(arrival_t)


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_exit_3_when_quorum_down():
    """A 1-replica fleet whose only replica SIGKILLs itself at its second
    dispatch (the engine's chaos grammar, inherited by the worker) is
    quorum-down at exit: exit 3, every admitted request terminal first."""
    _require_workers()
    rc, out, err = _cli(["--device", "cpu", "--fleet", "1", "--slot-ladder", "1,2",
                         "--faults", "die@dispatch=1:mode=sigkill",
                         "--requests", "12", "--rate", "300", "--seed", "0"])
    assert rc == 3, out + err
    assert "DEGRADED at exit (quorum of replicas down)" in err
    assert out.startswith("fleet: 1 replicas x (DP=1 x PP=1 x TP=1, gpipe)")
    assert "failover: 1 replica death(s)" in out and "completed" in out


def test_aot_cache_dir_refused_by_the_worker(jax_checkpoint, tmp_path):
    """Workers take ``aot_cache_dir`` (refused, with a ``fatal``, until the
    AOT cache was ported): the first replica's warm-up misses and stores
    the slot program, a scale-up replacement loads it (a hit, no miss, no
    store), and every response stays within 1e-6 of the JAX predict."""
    _require_workers()
    _, ck, jax_session = jax_checkpoint
    cfg = _worker_config(ck)
    cfg["session"]["aot_cache_dir"] = str(tmp_path / "cache")
    with ServingFleet(cfg, n_replicas=1, slo_ms=5000, seed=0) as fleet:
        fleet.start()
        rid = fleet.scale_up()
        submitted, _, _ = _drive(fleet, 8, seed=4)
        for r in (rid, 0):
            fleet.scale_down(r)
            deadline = time.time() + 60
            while fleet.replicas[r].state != "retired" and time.time() < deadline:
                fleet.step()
        stats = fleet.stats()
    assert all(r.verdict == "ok" and r.parity_ok is True for r in submitted)
    for r in submitted:
        np.testing.assert_allclose(r.result, np.asarray(jax_session.predict(r.x)),
                                   rtol=0, atol=1e-6)
    st = fleet.retired_stats()
    cold, warm = st[0]["aot"], st[rid]["aot"]
    assert (cold["miss"], cold["store"], cold["hit"]) == (1, 1, 0)
    assert (warm["hit"], warm["miss"], warm["store"]) == (1, 0, 0)
    assert stats["scale_ups"] == 1 and stats["scale_up_s"] is not None
    assert len(list((tmp_path / "cache").glob("*.aotx"))) == 1


def test_cuda_fleet_raises_without_a_gpu():
    """The device is resolved in the parent: a fleet asked for the card on
    a host without one raises before any worker starts."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingFleet({"session": {"sizes": SIZES}}, n_replicas=1)


def test_worker_threads_staged_for_cpu_workers_only(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    assert fleet_mod._child_env("cpu") == {
        "OMP_NUM_THREADS": str(fleet_mod.CPU_WORKER_THREADS)}
    assert fleet_mod._child_env("cuda") == {}
    monkeypatch.setenv("OMP_NUM_THREADS", "5")
    assert fleet_mod._child_env("cpu") == {}


def test_fleet_rejects_bad_config():
    with pytest.raises(ValueError, match="n_replicas"):
        ServingFleet({}, n_replicas=0)
    with pytest.raises(ValueError, match="inflight_window"):
        ServingFleet({}, n_replicas=1, inflight_window=0)
    with pytest.raises(ValueError, match="policy"):
        router.Router(policy="round_robin")


@pytest.mark.slow  # the JAX package marks its counterpart slow
def test_fleet_serves_failover_and_scales(jax_checkpoint):
    """The JAX package's end-to-end fleet test on the port: 3 replicas
    serve a seeded stream, one is SIGKILLed, a replacement scales up
    without raising the quorum bar, every request is "ok" and bitwise its
    replica's predict, and a scale-down retires cleanly."""
    _require_workers()
    _, ck, jax_session = jax_checkpoint
    with ServingFleet(_worker_config(ck), n_replicas=3, slo_ms=5000, retry=2,
                      seed=0) as fleet:
        fleet.start()
        assert fleet.n_ready == 3 and not fleet.degraded
        submitted, done, killed = _drive(fleet, 40, rate=400.0, kill_after=5, replace=True)
        assert killed is not None
        assert all(r.verdict == "ok" for r in submitted)
        assert fleet.parity_mismatches == 0
        sample = next(r for r in done if r.verdict == "ok")
        np.testing.assert_allclose(sample.result, np.asarray(jax_session.predict(sample.x)),
                                   rtol=0, atol=1e-6)
        fleet.wait_ready()
        stats = fleet.stats()
        assert stats["replicas_dead"] == 1 and stats["scale_ups"] == 1
        assert stats["replicas_target"] == 3 and stats["availability"] == 1.0
        retired = fleet.scale_down()
        deadline = time.time() + 60
        while fleet.replicas[retired].state != "retired" and time.time() < deadline:
            fleet.step()
        assert fleet.replicas[retired].state == "retired"
        assert fleet.target_replicas == 2
