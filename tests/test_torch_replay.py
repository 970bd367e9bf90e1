"""The capacity scoreboard's pure half against the JAX package's: the
diurnal trace bitwise (several seeds and spike shapes), every scoring
function of ``bench_replay`` equal on the same inputs, and
``AutoscalePolicy`` fed the same alert edges and ``status()`` snapshots
from one fake fleet under one injected clock, giving the same decisions
and ``autoscale`` records (every field but ``ts``). Then one CPU run of
``bench_replay``'s three legs over a tiny day on the port's fleet.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
from shallowspeed_tpu.observability.metrics import json_safe as jax_json_safe
from shallowspeed_tpu.observability.metrics import read_jsonl as jax_read_jsonl
from shallowspeed_tpu.serving import autoscaler as jauto
from shallowspeed_tpu.serving import bench_replay as jbr
from shallowspeed_tpu.serving import replay as jrep
from shallowspeed_tpu_torch.observability import JsonlMetrics as TorchJsonl
from shallowspeed_tpu_torch.observability.metrics import json_safe
from shallowspeed_tpu_torch.observability.metrics import read_jsonl
from shallowspeed_tpu_torch.serving import autoscaler as tauto
from shallowspeed_tpu_torch.serving import bench_replay as tbr
from shallowspeed_tpu_torch.serving import replay as trep

# (day_s, base_rps, peak_rps, n_spikes, spike_mult, spike_duration_s, bucket_s)
SHAPES = {
    "plain": (30.0, 5.0, 20.0, 0, 3.0, None, 5.0),
    "one-spike": (60.0, 4.0, 16.0, 1, 3.0, None, 5.0),
    "two-short": (40.0, 10.0, 40.0, 2, 2.0, 1.5, 2.0),
    "flat-x4": (20.0, 30.0, 30.0, 3, 4.0, 2.0, 4.0),
}


def _trace(mod, shape, seed):
    day, base, peak, n_spikes, mult, dur, bucket = SHAPES[shape]
    return mod.diurnal_trace(day_s=day, base_rps=base, peak_rps=peak, seed=seed,
                             n_spikes=n_spikes, spike_mult=mult,
                             spike_duration_s=dur, bucket_s=bucket)


@pytest.mark.parametrize("seed", [0, 3, 7, 2026])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_diurnal_trace_bitwise_jax(shape, seed):
    got, want = _trace(trep, shape, seed), _trace(jrep, shape, seed)
    assert got["arrivals"].dtype == want["arrivals"].dtype == np.float64
    assert got["arrivals"].tobytes() == want["arrivals"].tobytes()
    assert json.dumps(got["buckets"]) == json.dumps(want["buckets"])
    assert got["config"] == want["config"] and got["version"] == want["version"]
    assert sum(b["arrivals"] for b in got["buckets"]) == got["config"]["n_arrivals"]


def test_diurnal_rate_equals_jax():
    spikes = [{"start": 3.0, "duration": 2.0, "mult": 2.5}]
    for t in np.linspace(0.0, 12.0, 97):
        assert trep.diurnal_rate(t, 12.0, 3.0, 9.0, spikes) == jrep.diurnal_rate(
            t, 12.0, 3.0, 9.0, spikes)
    assert trep.REAL_DAY_S == jrep.REAL_DAY_S and trep.TRACE_VERSION == jrep.TRACE_VERSION


@pytest.mark.parametrize(
    "kw", [dict(day_s=0.0), dict(base_rps=0.0), dict(base_rps=5.0, peak_rps=1.0),
           dict(bucket_s=0.0)], ids=lambda kw: ",".join(kw))
def test_diurnal_trace_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jrep.diurnal_trace(**kw)
    with pytest.raises(ValueError) as terr:
        trep.diurnal_trace(**kw)
    assert str(terr.value) == str(jerr.value)


# -- the scoring functions -----------------------------------------------------


def _samples(trace, seed):
    """Seeded terminal samples over a trace's arrivals: mostly ok with a
    latency, some shed."""
    rng = np.random.RandomState(seed)
    out = []
    for t in trace["arrivals"]:
        verdict = ("ok", "ok", "ok", "dropped", "expired")[rng.randint(5)]
        out.append({"arrival": float(t), "verdict": verdict,
                    "latency_s": float(rng.exponential(0.03)) if verdict == "ok" else None})
    return out


def _decisions(seed, day):
    rng = np.random.RandomState(seed)
    n, out = 1, []
    for t in sorted(rng.uniform(0, day, size=6)):
        kind = ("scale_out", "scale_in", "replace", "backpressure_on")[rng.randint(4)]
        n = max(1, n + (kind == "scale_out") - (kind == "scale_in"))
        out.append({"decision": kind, "t": float(t), "replicas_after": n})
    return out


def _dump(mod_json_safe, obj):
    return json.dumps(mod_json_safe(obj), sort_keys=True, allow_nan=False)


@pytest.mark.parametrize("max_replicas", [2, 3])
@pytest.mark.parametrize("knee", [6.0, 15.0])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scoring_functions_equal_jax(shape, knee, max_replicas):
    trace = _trace(trep, shape, seed=5)
    buckets = trace["buckets"]
    comp = trace["config"]["compression"]
    out = {}
    for name, mod, safe in (("jax", jbr, jax_json_safe), ("torch", tbr, json_safe)):
        oracle = mod.oracle_schedule(buckets, knee, min_replicas=1, max_replicas=max_replicas)
        timeline = mod.replica_timeline(1, _decisions(9, trace["config"]["day_s"]))
        t_end = buckets[-1]["t1"]
        legs = {
            leg: {**mod.score_leg(_samples(trace, s), buckets, 50.0, tl, oracle,
                                  compression=comp), "flaps": s % 2}
            for leg, s, tl in (("static", 1, [(0.0, max_replicas)]),
                               ("autoscaled", 2, timeline), ("chaos", 3, timeline))
        }
        rec = mod.scoreboard_record(trace, knee, 50.0, legs, oracle,
                                    config={"seed": 5}, caveats=["injected"])
        out[name] = _dump(safe, dict(
            oracle=oracle, timeline=timeline,
            replica_s=mod.replica_seconds(timeline, t_end),
            wasted=mod.wasted_replica_seconds(timeline, oracle),
            samples=mod.score_samples(_samples(trace, 4), buckets, 50.0),
            oracle_score=mod.oracle_score(oracle, compression=comp),
            record=rec,
        ))
    assert out["torch"] == out["jax"]


def test_oracle_refuses_without_a_knee_like_jax():
    for knee in (None, 0.0):
        with pytest.raises(ValueError) as jerr:
            jbr.oracle_schedule([], knee)
        with pytest.raises(ValueError) as terr:
            tbr.oracle_schedule([], knee)
        assert str(terr.value) == str(jerr.value)
    assert (tbr.SCOREBOARD_VERSION, tbr.SCOREBOARD_RECORD) == (
        jbr.SCOREBOARD_VERSION, jbr.SCOREBOARD_RECORD)


# -- the policy on one fake fleet, one injected clock --------------------------


class FakeFleet:
    """``status()``/``scale_up``/``scale_down`` shaped like ``ServingFleet``,
    synchronous and clockless: the policy's decisions follow the ``now``
    values the test passes to ``tick()``."""

    def __init__(self, n_ready=1):
        self._next = 0
        self.states = {}
        for _ in range(n_ready):
            self._add("ready")
        self.queue = 0
        self.dead = 0
        self.admitted = None
        self.window_end = None
        self.alerts_active = {}
        self.degraded = False
        self.scale_ups = []
        self.scale_downs = []
        self.gate = None

    def _add(self, state):
        rid = self._next
        self._next += 1
        self.states[rid] = state
        return rid

    def set_admission_gate(self, fn):
        self.gate = fn

    def scale_up(self, checkpoint=None, wait_ready=True):
        self.scale_ups.append(wait_ready)
        return self._add("starting")

    def scale_down(self, replica_id=None):
        rid = max(r for r, s in self.states.items() if s == "ready")
        self.states[rid] = "draining"
        self.scale_downs.append(rid)
        return rid

    def ready_all(self):
        for rid, s in self.states.items():
            if s == "starting":
                self.states[rid] = "ready"

    def kill_one(self):
        ready = [r for r, s in self.states.items() if s == "ready"]
        if ready:
            self.states[max(ready)] = "dead"
            self.dead += 1

    def status(self):
        ready = sum(1 for s in self.states.values() if s == "ready")
        last = None
        if self.admitted is not None:
            last = {"window_end": self.window_end,
                    "rates": {"admitted": {"rate": self.admitted}}}
        return {
            "queue_depth": self.queue,
            "inflight": 0,
            "degraded": self.degraded,
            "replicas_target": ready,
            "replicas_ready": ready,
            "replicas_dead": self.dead,
            "gate_dropped": 0,
            "per_replica": {
                rid: {"state": s, "queue_depth": 0, "degraded": False, "inflight": 0,
                      "last_health": None}
                for rid, s in self.states.items()
            },
            "alerts_active": dict(self.alerts_active),
            "telemetry": {"rollup": {"last_window": last}, "alerts": {}},
        }


def _knee_edge(p, f):
    p.alert({"name": "knee_proximity", "state": "firing", "value": 9.3,
             "threshold": 9.0, "reason": "admitted near knee"})
    p.tick(1.0)
    f.admitted = 9.5
    p.tick(50.0)
    f.states[max(f.states)] = "ready"
    p.tick(60.0)


def _edges_resolved_and_burn(p, f):
    p.alert({"name": "knee_proximity", "state": "resolved"})
    p.alert({"name": "error_burn", "state": "firing"})
    p.tick(1.0)
    f.queue = 3
    p.alert({"name": "error_burn", "state": "firing", "value": 8.0,
             "threshold": 6.0, "reason": "burn 8x"})
    p.tick(2.0)


def _hysteresis_and_flap(p, f):
    f.admitted = 3.0
    for t in (0.0, 0.5, 1.2):
        p.tick(t)
    f.admitted = 9.5
    p.tick(3.5)


def _slack_interrupted(p, f):
    f.admitted = 3.0
    p.tick(0.0)
    f.queue = 2
    p.tick(0.6)
    f.queue = 0
    p.tick(1.4)
    p.tick(2.5)


def _replacement(p, f):
    f.kill_one()
    p.tick(1.0)
    p.tick(2.0)


def _backpressure(p, f):
    f.scale_up(wait_ready=False)
    f.queue = 9
    p.tick(1.0)
    f.queue = 2
    p.tick(2.0)


def _random_walk(p, f):
    """200 ticks of seeded load, backlog, alert edges, deaths and warm-ups."""
    rng = np.random.RandomState(13)
    rate = 5.0
    for i in range(200):
        t = 0.25 * i
        rate = max(0.0, rate + rng.normal(0, 2.0))
        f.admitted, f.window_end = rate, t
        f.queue = int(rng.poisson(2)) if rng.rand() < 0.3 else 0
        f.alerts_active = {"error_burn": "page"} if rng.rand() < 0.1 else {}
        r = rng.rand()
        if r < 0.04:
            f.kill_one()
        elif r < 0.3:
            f.ready_all()
        if rng.rand() < 0.15:
            p.alert({"name": ("knee_proximity", "error_burn")[rng.randint(2)],
                     "state": ("firing", "resolved")[rng.randint(2)],
                     "value": rate, "threshold": 9.0, "reason": f"edge {i}"})
        p.tick(t)


SCENARIOS = {
    "knee-edge": (_knee_edge, 1, {}),
    "resolved-and-burn": (_edges_resolved_and_burn, 1, {}),
    "hysteresis-flap": (_hysteresis_and_flap, 2, dict(
        min_replicas=1, slack_hold_s=1.0, in_cooldown_s=2.0, out_cooldown_s=0.5,
        flap_window_s=30.0)),
    "slack-interrupted": (_slack_interrupted, 2, dict(min_replicas=1, slack_hold_s=1.0)),
    "replacement": (_replacement, 2, {}),
    "backpressure": (_backpressure, 1, dict(warm_queue_budget=5)),
    "random-walk": (_random_walk, 1, dict(
        max_replicas=4, slack_hold_s=2.0, in_cooldown_s=4.0, out_cooldown_s=1.0,
        flap_window_s=6.0, slo_ms=50.0, floor_s=0.002)),
    "random-walk-budget": (_random_walk, 2, dict(
        max_replicas=3, slack_hold_s=1.0, in_cooldown_s=2.0, warm_queue_budget=3)),
}


def _run_policy(mod, jsonl, path, scenario):
    drive, n_ready, kw = SCENARIOS[scenario]
    fleet = FakeFleet(n_ready=n_ready)
    metrics = jsonl(path)
    kw = {"knee_rps": 10.0, "max_replicas": 3, **kw}
    policy = mod.AutoscalePolicy(metrics=metrics, tags={"leg": "fake"}, **kw)
    policy.attach(fleet)
    drive(policy, fleet)
    metrics.close()
    return policy, fleet


def _strip_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_autoscale_policy_equals_jax(scenario, tmp_path):
    jp, jf = _run_policy(jauto, JaxJsonl, tmp_path / "jax.jsonl", scenario)
    tp, tf = _run_policy(tauto, TorchJsonl, tmp_path / "torch.jsonl", scenario)
    assert _dump(json_safe, tp.decisions) == _dump(jax_json_safe, jp.decisions)
    assert tp.flaps == jp.flaps
    assert (tf.scale_ups, tf.scale_downs, tf.states) == (jf.scale_ups, jf.scale_downs, jf.states)
    assert tf.gate(tf) == jf.gate(jf)
    want = [r for r in jax_read_jsonl(tmp_path / "jax.jsonl") if r["kind"] == "autoscale"]
    got = [r for r in read_jsonl(tmp_path / "torch.jsonl") if r["kind"] == "autoscale"]
    assert _strip_ts(got) == _strip_ts(want)
    assert len(got) == len(tp.decisions)
    if scenario.startswith("random-walk"):
        assert {d["decision"] for d in tp.decisions} >= {"scale_out", "replace"}


def test_autoscale_policy_refusals_equal_jax():
    for kw in (dict(knee_rps=None), dict(knee_rps=10.0, min_replicas=0),
               dict(knee_rps=10.0, min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError) as jerr:
            jauto.AutoscalePolicy(**kw)
        with pytest.raises(ValueError) as terr:
            tauto.AutoscalePolicy(**kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(RuntimeError, match="attach"):
        tauto.AutoscalePolicy(knee_rps=10.0).tick(0.0)
    assert tauto.AUTOSCALER_VERSION == jauto.AUTOSCALER_VERSION


# -- the driven legs on the CPU ------------------------------------------------


@pytest.mark.fleet
def test_bench_replay_cli_tiny_day(tmp_path):
    """``bench_replay``'s three legs (static, autoscaled, chaos) over a
    3 s day on CPU replicas: the record has the JAX record's layout, every
    leg accounts every request it admitted, the exit code follows the
    verdicts, and the scoreboard re-assembled by the JAX module from the
    port's scored legs is the port's."""
    out, stream = tmp_path / "board.json", tmp_path / "replay.jsonl"
    buf, err = io.StringIO(), io.StringIO()
    argv = ["--device", "cpu", "--knee-rps", "60", "--slo-ms", "500", "--day-s", "3",
            "--min-replicas", "1", "--max-replicas", "2", "--static-replicas", "2",
            "--out", str(out), "--metrics-out", str(stream)]
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = tbr.main(argv)
    rec = json.loads(out.read_text())
    assert rc == (0 if all(rec["verdicts"].values()) else 1), err.getvalue()
    assert rec["bench"] == "autoscale_scoreboard" and list(rec["legs"]) == [
        "static", "autoscaled", "chaos"]
    assert set(rec["verdicts"]) == {"autoscaled_beats_static_violation_minutes",
                                    "autoscaled_beats_static_wasted_replica_hours",
                                    "chaos_zero_flaps"}
    n = rec["config"]["trace"]["n_arrivals"]
    assert n == _trace_count(rec)
    for leg, L in rec["legs"].items():
        stats = L["stats_summary"]
        terminal = sum(stats[k] for k in ("completed", "dropped", "expired", "errors",
                                          "unhealthy"))
        assert terminal == n, (leg, stats)
        assert sum(L["verdicts"].values()) <= n and L["verdicts"].get("ok") == stats["completed"]
    assert rec["legs"]["chaos"]["killed_replica"] is not None
    assert any(d["decision"] == "replace" for d in rec["legs"]["chaos"]["decisions"])
    assert any(c.startswith("--device cpu") for c in rec["caveats"])
    trace = trep.diurnal_trace(day_s=3.0, base_rps=0.35 * 60, peak_rps=1.4 * 60, seed=0,
                               n_spikes=1, spike_mult=2.0, bucket_s=0.1)
    assert trace["config"] == {**rec["config"]["trace"]}
    jrec = jbr.scoreboard_record(trace, 60.0, 500.0, rec["legs"],
                                 rec["oracle"]["buckets"], config={
                                     k: v for k, v in rec["config"].items()
                                     if k not in ("knee_rps", "slo_ms", "trace")},
                                 caveats=rec["caveats"])
    assert _dump(jax_json_safe, jrec) == _dump(json_safe, rec)
    kinds = {r["kind"] for r in read_jsonl(f"{stream}*")}
    assert {"autoscale", "fleet_health", "event"} <= kinds
    assert "capacity scoreboard written" in buf.getvalue()



def _trace_count(rec):
    return sum(b["arrivals"] for b in rec["trace_buckets"])
