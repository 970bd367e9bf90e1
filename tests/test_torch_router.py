"""The port's ``serving/router.py`` against the JAX package's: placement
sequences of both policies over seeded replica states (the p2c draws from
the same seeded stream), the quorum rule, the bounded fleet queue with
requeue-at-head, ``routing_skew`` and ``FleetRequest`` accounting.
"""

import numpy as np
import pytest

from shallowspeed_tpu.serving import router as jr
from shallowspeed_tpu_torch.serving import router as tr

STATES = ("starting", "ready", "ready", "ready", "draining", "retired", "dead")


def _replicas(mod, rng, n):
    """``n`` seeded replica states (the same draws for both modules)."""
    out = []
    for rid in range(n):
        info = mod.ReplicaInfo(rid, spawn_t=float(rid))
        info.state = STATES[rng.randint(len(STATES))]
        info.queue_depth = int(rng.randint(0, 6))
        info.inflight = int(rng.randint(0, 4))
        info.degraded = bool(rng.rand() < 0.2)
        out.append(info)
    return out


def _placements(mod, policy, seed, n_replicas, steps=60):
    """A placement sequence: each step draws fresh replica states from a
    seeded stream, places, and charges the chosen replica one request."""
    r = mod.Router(policy=policy, seed=seed)
    rng = np.random.RandomState(1000 + seed)
    seq = []
    replicas = _replicas(mod, rng, n_replicas)
    for step in range(steps):
        if step % 7 == 0:
            replicas = _replicas(mod, rng, n_replicas)
        chosen = r.place(replicas)
        seq.append(None if chosen is None else chosen.replica_id)
        if chosen is not None:
            chosen.inflight += 1
            chosen.routed += 1
    return seq


@pytest.mark.parametrize("n_replicas", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("policy", ["least_queue", "p2c"])
def test_placement_sequence_equals_jax(policy, seed, n_replicas):
    want = _placements(jr, policy, seed, n_replicas)
    got = _placements(tr, policy, seed, n_replicas)
    assert got == want
    assert any(p is not None for p in got) or n_replicas < 3


@pytest.mark.parametrize("policy", ["least_queue", "p2c"])
def test_equal_load_ties_spread_like_jax(policy):
    """Ties draw from the seeded stream: the same spread in both."""
    def run(mod):
        r = mod.Router(policy=policy, seed=3)
        replicas = []
        for i in range(4):
            info = mod.ReplicaInfo(i)
            info.state = "ready"
            replicas.append(info)
        return [r.place(replicas).replica_id for _ in range(80)]

    assert run(tr) == run(jr)
    assert set(run(tr)) == {0, 1, 2, 3}


def test_quorum_equals_jax():
    assert [tr.quorum(n) for n in range(1, 12)] == [jr.quorum(n) for n in range(1, 12)]
    assert tr.REPLICA_STATES == jr.REPLICA_STATES
    assert tr.ROUTING_POLICIES == jr.ROUTING_POLICIES


def _queue_ops(mod):
    r = mod.Router(max_queue=3, seed=0)
    reqs = [mod.FleetRequest(i, np.zeros((1, 4), np.float32), None, float(i))
            for i in range(7)]
    admitted = [r.admit(q) for q in reqs[:5]]
    r.queue.popleft()
    r.requeue_head([reqs[5], reqs[6]])
    admitted.append(r.admit(reqs[4]))
    return admitted, [q.id for q in r.queue], len(r)


def test_bounded_queue_and_requeue_at_head_equal_jax():
    got = _queue_ops(tr)
    assert got == _queue_ops(jr)
    # the bound refused 3 and 4; the failover pair went to the head in
    # submit order
    assert got == ([True, True, True, False, False, False], [5, 6, 1, 2], 4)


@pytest.mark.parametrize("seed", range(6))
def test_routing_skew_equals_jax(seed):
    rng = np.random.RandomState(seed)
    counts = [int(c) for c in rng.randint(0, 40, size=rng.randint(0, 6))]
    assert tr.routing_skew(counts) == jr.routing_skew(counts)


def test_routing_skew_edges():
    for counts in ([], [0, 0], [10, 10], [30, 10, 20]):
        assert tr.routing_skew(counts) == jr.routing_skew(counts)
    assert tr.routing_skew([30, 10, 20]) == pytest.approx(1.5)


def _accounting(mod):
    req = mod.FleetRequest(0, np.zeros((3, 4), np.float32), 100.0, 10.0)
    out = [req.rows, req.verdict, req.latency_s, req.queue_s, req.slo_ok(),
           req.remaining_deadline_ms(10.04)]
    req.route_t = 10.05
    req.complete_t = 10.08
    out += [req.queue_s, req.latency_s, req.slo_ok(), req.slo_ok(slo_ms=1.0)]
    untagged = mod.FleetRequest(1, np.zeros((1, 4), np.float32), None, 0.0)
    untagged.complete_t = 2.0
    out += [untagged.remaining_deadline_ms(1.0), untagged.slo_ok(slo_ms=1000.0),
            untagged.slo_ok(), untagged.admitted, untagged.attempts]
    return out


def test_fleet_request_accounting_equals_jax():
    got = _accounting(tr)
    assert got == _accounting(jr)
    assert got[5] == pytest.approx(60.0) and got[8] is True and got[-4] is False


def _info_views(mod):
    rng = np.random.RandomState(5)
    views = []
    for info in _replicas(mod, rng, 12):
        info.ready_t = 2.5 if info.state == "ready" else None
        for v in ("ok", "error", "ok", "dropped"):
            info.note_verdict(v)
        views.append((info.alive, info.routable(), info.load(), info.snapshot()))
    return views


def test_replica_info_views_equal_jax():
    assert _info_views(tr) == _info_views(jr)


def test_unknown_policy_refused_in_jax_words():
    with pytest.raises(ValueError) as jerr:
        jr.Router(policy="round_robin")
    with pytest.raises(ValueError) as terr:
        tr.Router(policy="round_robin")
    assert str(terr.value) == str(jerr.value)
