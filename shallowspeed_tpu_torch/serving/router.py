"""Fleet routing: replica health state, placement policies, bounded queue.

Copied from ``shallowspeed_tpu/serving/router.py`` (pure logic, numpy
only): the same placements for the same heartbeat states, the p2c draws
from the same seeded ``np.random.RandomState`` stream, so a request stream
places identically in both packages (``tests/test_torch_router.py``).

The fleet layer (``serving/fleet.py``) splits cleanly into process
plumbing (spawn pipes, detect deaths) and ROUTING — which replica gets
the next request, when the fleet refuses admission, what "quorum down"
means. This module is the routing half, kept free of processes so every
placement and failover decision is unit-testable with plain
``ReplicaInfo`` values (the same separation the schedule lowerer keeps
from the executor: policy as data, plumbing elsewhere).

Pieces:

- ``ReplicaInfo``   the parent-side view of one replica, fed by worker
                    heartbeats (queue depth, breaker state, last health
                    event) and by the parent's own bookkeeping (un-acked
                    in-flight count, lifecycle state). ``routable()`` is
                    the single definition of "may take traffic": ready,
                    breaker closed, not draining;
- ``FleetRequest``  one fleet-level request and its accounting — the
                    fleet mirror of ``engine.Request``, with routing
                    fields (which replica, how many placements) instead
                    of slot fields. Same terminal-verdict alphabet, same
                    coordinated-omission ``arrival_t`` backdating;
- ``Router``        the bounded fleet queue plus placement:
                    ``least_queue`` (min outstanding load, replica id as
                    the deterministic tie-break) or ``p2c``
                    (power-of-two-choices: two seeded random candidates,
                    the less-loaded wins — the classic
                    Azar/Mitzenmacher result that two choices already
                    collapse the max-load gap, at O(1) instead of a full
                    scan);
- ``quorum``        the degraded-fleet threshold: the fleet refuses
                    admission (and the serve CLI exits 3) when fewer
                    than a majority of its TARGET replicas are healthy —
                    a dead minority degrades capacity, a dead majority
                    degrades the fleet.

Load scoring counts BOTH sides of the pipe: the replica's last
heartbeated queue depth (work it has admitted) plus the parent's
un-acked in-flight count (work on the wire the heartbeat cannot see
yet). In-flight alone would let a burst overfill one replica between
heartbeats; heartbeat depth alone is stale by one round trip.
"""

from collections import deque

import numpy as np

# replica lifecycle (parent-side): spawned -> warming (compiling its
# ladder) -> ready -> [draining ->] retired, with "dead" reachable from
# anywhere (SIGKILL respects no state machine)
REPLICA_STATES = ("starting", "ready", "draining", "retired", "dead")

ROUTING_POLICIES = ("least_queue", "p2c")


def quorum(target_replicas):
    """Healthy replicas required for the fleet to accept traffic: a
    strict majority of the TARGET size (1 -> 1, 2 -> 2, 3 -> 2, 4 -> 3).
    Below it the fleet is degraded — admission refused, serve CLI exit
    3 — while already-admitted work still drains through whatever
    replicas survive."""
    return int(target_replicas) // 2 + 1


class ReplicaInfo:
    """Parent-side replica state: lifecycle + the last heartbeat."""

    __slots__ = (
        "replica_id",
        "state",
        "queue_depth",
        "degraded",
        "consecutive_failures",
        "inflight",
        "routed",
        "served",
        "verdicts",
        "last_heartbeat_t",
        "last_health",
        "spawn_t",
        "ready_t",
        "loaded_step",
    )

    def __init__(self, replica_id, spawn_t=None):
        self.replica_id = int(replica_id)
        self.state = "starting"
        self.queue_depth = 0  # worker-side, from the last heartbeat
        self.degraded = False  # worker breaker state, from heartbeats
        self.consecutive_failures = 0
        self.inflight = 0  # parent-side: routed, no response yet
        self.routed = 0  # total requests ever placed here
        self.served = 0  # "ok" responses received from here
        self.verdicts = {}  # terminal verdict -> count, from responses
        self.last_heartbeat_t = None
        self.last_health = None  # last serving_health event name heard
        self.spawn_t = spawn_t
        self.ready_t = None
        self.loaded_step = None

    @property
    def alive(self):
        return self.state in ("starting", "ready", "draining")

    def routable(self):
        """May this replica take NEW traffic? Ready (ladder warmed),
        breaker closed, not draining toward retirement."""
        return self.state == "ready" and not self.degraded

    def load(self):
        """Placement score: heartbeated queue depth + un-acked in-flight
        (module docstring — each alone is blind to half the pipeline)."""
        return self.queue_depth + self.inflight

    def note_verdict(self, verdict):
        self.verdicts[verdict] = self.verdicts.get(verdict, 0) + 1
        if verdict == "ok":
            self.served += 1

    def snapshot(self):
        """JSON-able per-replica stats row (the fleet summary embeds one
        per replica — the report's per-replica verdict table)."""
        return {
            "state": self.state,
            "degraded": self.degraded,
            "routed": self.routed,
            "served": self.served,
            "verdicts": dict(self.verdicts),
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "loaded_step": self.loaded_step,
            # spawn -> ready wall (None until ready): the per-replica
            # cold-start cost (process start, CUDA context, kernel load,
            # warm-up)
            "ready_wall_s": (
                self.ready_t - self.spawn_t
                if self.ready_t is not None and self.spawn_t is not None
                else None
            ),
        }


class FleetRequest:
    """One fleet-level request: payload + routing + terminal accounting.

    The verdict alphabet is the engine's (``TERMINAL_VERDICTS`` — every
    admitted request ends on exactly one, never silence), lifted one
    level: a worker-terminal ``error``/``dropped``/``unhealthy`` verdict
    is not necessarily FLEET-terminal — the router may re-place the
    request on another replica while its routing budget lasts.
    ``attempts`` counts placements (the budget ``retry.RetryPolicy``
    bounds); ``replicas_tried`` records where it went, in order."""

    __slots__ = (
        "id",
        "x",
        "rows",
        "deadline_ms",
        "enqueue_t",
        "route_t",
        "complete_t",
        "result",
        "verdict",
        "reason",
        "replica_id",
        "attempts",
        "replicas_tried",
        "parity_ok",
        "worker_latency_s",
        "admitted",
        "trace_id",
        "trace_root",
        "trace_tail",
    )

    def __init__(self, req_id, x, deadline_ms, enqueue_t):
        self.id = req_id
        self.x = x
        self.rows = int(x.shape[0])
        self.deadline_ms = deadline_ms
        self.enqueue_t = enqueue_t
        self.route_t = None  # last placement time
        self.complete_t = None
        self.result = None  # (rows, out_dim) probabilities; only "ok"
        self.verdict = "queued"
        self.reason = None
        self.replica_id = None  # where it is (or last was) placed
        self.attempts = 0  # placements consumed so far
        self.replicas_tried = []
        self.parity_ok = None  # worker-side bitwise parity vs predict()
        self.worker_latency_s = None  # engine-side latency of the final try
        self.admitted = False  # entered the fleet queue (vs refused at submit)
        # distributed-tracing context (schema v10): the chain id minted at
        # fleet submit, the root fleet.queue span (emitted at first
        # placement), and the span the NEXT hop parents to — a route span
        # after placement, the worker's last span after a response, a
        # failover.requeue span after a replica death
        self.trace_id = None
        self.trace_root = None
        self.trace_tail = None

    @property
    def latency_s(self):
        """Fleet enqueue -> complete wall seconds (None until terminal).
        Measured on the PARENT clock end to end, so fleet queueing, the
        pipe hop and any failover re-placements are all inside it."""
        if self.complete_t is None:
            return None
        return self.complete_t - self.enqueue_t

    @property
    def queue_s(self):
        """Fleet enqueue -> last placement (None until routed)."""
        if self.route_t is None:
            return None
        return self.route_t - self.enqueue_t

    def slo_ok(self, slo_ms=None):
        """Deadline (its own tag, else the fleet SLO) verdict — None when
        neither threshold exists or the request never completed."""
        bound = self.deadline_ms if self.deadline_ms is not None else slo_ms
        if bound is None or self.latency_s is None:
            return None
        return self.latency_s <= bound / 1000.0

    def remaining_deadline_ms(self, now):
        """Deadline budget left at ``now`` (None when untagged) — what the
        worker is told, so its pack-time shedding scores the time the
        request ALREADY burned in the fleet queue, not a fresh clock."""
        if self.deadline_ms is None:
            return None
        return self.deadline_ms - (now - self.enqueue_t) * 1000.0


class Router:
    """Bounded fleet queue + placement policy (pure logic, no I/O)."""

    def __init__(self, policy="least_queue", max_queue=None, seed=0):
        if policy not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r} (have {ROUTING_POLICIES})"
            )
        self.policy = policy
        self.max_queue = max_queue
        self.queue = deque()
        # p2c candidate draws are seeded: the same request stream against
        # the same heartbeat history places identically — every decision
        # in this repo that can replay must replay
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.queue)

    def admit(self, req):
        """Append ``req`` to the fleet queue; False when the bound is hit
        (the caller completes it as "dropped"/queue_full — admission
        refusal is a terminal verdict, never silence)."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return False
        self.queue.append(req)
        return True

    def requeue_head(self, reqs):
        """Failover re-admission: push ``reqs`` (original submit order)
        back at the queue HEAD — the engine's requeue-at-head contract
        lifted one level, so re-routed requests keep their place ahead of
        later arrivals and ordering stays deterministic."""
        for r in reversed(list(reqs)):
            self.queue.appendleft(r)

    def place(self, replicas):
        """Pick the routable replica for the queue's head request, or
        None when nothing can take traffic. ``replicas``: an iterable of
        ``ReplicaInfo``. Ties break by a draw from the SEEDED stream —
        a fixed tie-break (e.g. lowest id) would pin every low-load
        request to replica 0 and read as pathological routing skew;
        a seeded draw spreads ties while staying replayable given the
        same request/heartbeat history."""
        candidates = [r for r in replicas if r.routable()]
        if not candidates:
            return None
        if self.policy == "p2c" and len(candidates) > 2:
            i, j = self._rng.choice(len(candidates), size=2, replace=False)
            candidates = [candidates[int(i)], candidates[int(j)]]
        lo = min(r.load() for r in candidates)
        best = [r for r in candidates if r.load() == lo]
        if len(best) == 1:
            return best[0]
        return best[int(self._rng.randint(len(best)))]


def routing_skew(routed_counts):
    """Imbalance of the placement policy: max routed / mean routed over
    the replicas that were ever routed to (1.0 = perfectly even; None
    when nothing was routed). The report's Fleet section renders it so a
    policy regression shows up as a number, not an anecdote."""
    counts = [c for c in routed_counts if c > 0]
    if not counts:
        return None
    return max(counts) / (sum(counts) / len(counts))
