"""Serving fleet: N engine replicas in worker processes behind a router.

The port of ``shallowspeed_tpu/serving/fleet.py``. ``ServingFleet``
spawns N replica WORKER PROCESSES (``multiprocessing`` spawn context:
each builds the port's ``TrainingSession`` on the fleet's device from a
checkpoint, wraps it in a ``ServingEngine`` and runs one dispatch of every
ladder rung with ``warm_ladder()`` before announcing ready) and fronts
them with the ``router.Router``: a bounded fleet queue and
least-queue-depth or power-of-two-choices placement driven by replica
HEARTBEATS (worker queue depth, breaker state, last ``serving_health``
event). On a card every replica is a process of its own sharing the one
GPU, each with its own CUDA context and its own load of the forward
kernel; the card time-slices their kernels. On the CPU each replica is a
CPU process.

The device: the worker session's ``device`` (None = ``"cuda"``) is
resolved in the parent (``resolve_device``: no GPU is an error, never a
fallback) and handed to every worker explicitly. For a CUDA fleet the
parent builds, or loads, the forward kernel's library before it spawns
the first worker, so N workers on a fresh checkout do not each run
``nvcc``. A worker that finds no GPU, or cannot build or launch the
kernel, sends ``fatal`` and the parent raises ``FleetError``. Nothing on a
pipe is a CUDA tensor: requests, responses and stats are host numpy and
Python values. Only ``spawn`` is used (a forked child of a parent holding
a CUDA context is undefined), and importing this module touches no CUDA.

The per-request contract is the engine's, lifted fleet-wide:

- **terminal verdicts, never silence**: every request the fleet admits
  reaches exactly one of ok/dropped/expired/error/unhealthy — across
  replica deaths, breaker trips, drains and scale events. The chaos soak
  (``bench_serving.fleet_chaos_soak``) SIGKILLs a replica mid-soak and
  machine-checks that no admitted id is still ``"queued"`` at the end;
- **failover = requeue-at-head, one level up**: a replica that dies (pipe
  EOF / process exit) has its un-acked in-flight requests re-queued at
  the FLEET queue head in original submit order, under the shared
  bounded ``retry.RetryPolicy`` placement budget — exhausted requests
  complete as ``"error"``, exactly the engine's dispatch-recovery shape.
  A replica that trips its breaker (heartbeat ``degraded``) stops
  receiving traffic, and worker-terminal ``error``/``dropped``/
  ``"unhealthy"`` responses are re-placed on healthy replicas while the
  budget lasts;
- **bitwise parity, machine-checked per response**: with
  ``verify=True`` in the worker config, every ``"ok"`` response is
  re-computed IN THE WORKER with a direct ``session.predict()`` of the
  same rows and compared bitwise before it crosses the pipe;
- **elasticity rides what exists**: ``scale_up()`` spawns a replica from
  the newest ``checkpoint.find_latest_good`` snapshot (its ladder warmed
  before it takes traffic), ``scale_down()`` drains-and-retires,
  ``watch_reload()`` broadcasts the per-replica hot-reload poll. With an
  ``aot_cache_dir`` in the worker's session kwargs (``aot_cache.py``) the
  warm-up resolves the rung ladder through the AOT program cache: a
  replacement loads the lowered tables and the kernel library the first
  replicas stored instead of lowering and building them (every program
  audited before it serves; per-replica ``ready_wall_s`` in the summary);
- **quorum**: the fleet refuses admission (verdict ``"dropped"``, reason
  ``"fleet_degraded"``) while fewer than a majority of its target
  replicas are healthy (``router.quorum``); the serve CLI exits 3 when
  still degraded at exit.

Observability: the PARENT emits the schema-v7 ``fleet``/``fleet_health``
records (every one tagged ``replica_id``) plus a fleet-wide ``serving``
summary; each WORKER writes its engine's ``request``/``serving_health``/
``reload`` records to its own ``<path>.r{replica_id}`` JSONL shard
(``metrics.replica_shard_path``), with ``replica_id`` as the join key.
Timing is measured on the parent clock end to end: ``recovery_s`` is
replica-loss to the next served response, ``scale_up_s`` is spawn to
ready (ladder warmed), and each replica's spawn-to-ready wall is its
``ready_wall_s`` in the summary.

Counting launches across processes: ``cuda_ops.LAUNCHES`` is per process,
so the parent sees none of the workers' launches. A worker ships its
``LAUNCHES`` in the ``drained`` message's ``stats`` (key ``launches``, a
port-only key that goes in no JSONL record, as ``builds``, its ``nvcc``
builds, and ``aot``, its AOT cache's stats, do); ``retired_stats()``
returns them per retired replica. A SIGKILLed replica sends no ``drained``
message, so its count is not known.

Clock-domain contract: every ``FleetRequest`` timestamp and every
parent-side span is a PARENT-process ``perf_counter`` value; each
WORKER's engine records its own clock's values into its shard. The
heartbeat handshake round-trips ``clock_probe`` messages per worker and
records the best offset estimate WITH its uncertainty (a ``clock_offset``
trace record: ``offset = tw - (t0 + t1)/2``, uncertainty = half the round
trip), which lets ``observability.tracing`` place every shard on the
parent timeline when joining a request's cross-process span chain
(parent-side ``fleet.queue``/``route``/``failover.requeue``/``ack`` spans,
worker-side ``worker.queue``/``pack``/``dispatch``/``verify`` spans,
linked by the trace context shipped with each request and the
``last_span_id`` each response carries back).

Live telemetry: the parent owns a fleet-level ``slo.LiveTelemetry``
sensor — every fleet-terminal verdict, router queue-depth sample and
``fleet_degraded``/``fleet_recovered`` edge feeds tumbling ``rollup``
windows and the SLO rule set, whose transitions emit ``alert`` records
and call any attached ``AlertSink`` (the autoscaler's hook). Each WORKER
engine runs its own sensor tagged with its ``replica_id`` into its shard.
``status()`` is the live snapshot surface the watch CLI and the
autoscaler poll.
"""

import multiprocessing
import os
import signal
import time

import numpy as np

from shallowspeed_tpu_torch import _build, resolve_device
from shallowspeed_tpu_torch import retry as R
from shallowspeed_tpu_torch.observability import NullMetrics
from shallowspeed_tpu_torch.observability.metrics import replica_shard_path
from shallowspeed_tpu_torch.observability.slo import LiveTelemetry
from shallowspeed_tpu_torch.observability.stats import ThroughputWindow, percentile
from shallowspeed_tpu_torch.observability.tracing import Tracer
from shallowspeed_tpu_torch.serving.router import (
    FleetRequest,
    ReplicaInfo,
    Router,
    quorum,
    routing_skew,
)


class FleetError(RuntimeError):
    """A fleet-level operational failure: a replica failed to start
    (its ``fatal`` message is embedded), or the platform cannot spawn
    worker processes at all."""


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------


class _HealthTap:
    """Delegating metrics proxy that remembers the last ``serving_health``
    event name — what the worker's heartbeat reports as its health
    verdict (the breaker flag says "degraded", this says WHY)."""

    def __init__(self, inner):
        self._inner = inner
        self.last_health = None

    def serving_health(self, name, **fields):
        self.last_health = name
        self._inner.serving_health(name, **fields)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# intra-op threads of a CPU replica worker: N workers (and, under the
# tests, several pytest workers each running a fleet) share the host's
# cores, and torch's default of one thread per core would oversubscribe it
CPU_WORKER_THREADS = 2


def _child_env(device):
    """The environment overrides a replica worker must see: a CPU worker
    gets a bounded ``OMP_NUM_THREADS`` unless the caller set one (their
    value stays). Staged in the PARENT around ``proc.start()``: the spawn
    child imports torch while it unpickles its target, before any worker
    code could set it. Returns ``{var: value}``."""
    if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        return {"OMP_NUM_THREADS": str(CPU_WORKER_THREADS)}
    return {}


def _response_msg(req, fleet_id, engine, parity_ok):
    """One engine-terminal request, serialized for the pipe. The engine's
    breaker state and queue depth piggyback on every response — a
    response is a fresher heartbeat than the heartbeat. ``last_span_id``
    carries the worker's newest span back so the parent's terminal ``ack``
    links into the worker-side chain."""
    return {
        "kind": "response",
        "id": fleet_id,
        "verdict": req.verdict,
        "result": np.asarray(req.result) if req.verdict == "ok" else None,
        "latency_s": req.latency_s,
        "queue_s": req.queue_s,
        "attempts": req.attempts,
        "parity_ok": parity_ok,
        "degraded": engine.degraded,
        "queue_depth": engine.queue_depth,
        "last_span_id": req.last_span_id,
    }


def _heartbeat_msg(engine, tap):
    return {
        "kind": "heartbeat",
        "queue_depth": engine.queue_depth,
        "degraded": engine.degraded,
        "dispatch_seq": engine.dispatch_seq,
        "last_health": tap.last_health,
    }


def _worker_main(conn, config):
    """The replica worker: session + engine + warm ladder, then a serve
    loop multiplexing pipe messages with engine steps. Spawned (never
    forked — a forked child of a process holding a CUDA context is
    undefined) with ``config``:

    - ``replica_id``; ``session``: ``TrainingSession`` kwargs (checkpoint
      via ``resume=``, the parent's resolved ``device``); ``engine``:
      ``ServingEngine`` kwargs;
    - ``verify``: re-compute every "ok" response with a direct
      ``session.predict()`` and ship the bitwise verdict (``parity_ok``);
    - ``metrics_path``: this replica's own ``.r{id}`` JSONL shard;
    - ``heartbeat_s``: heartbeat cadence;
    - ``clock_offset_s``: TEST HOOK — shift this worker's engine clock by
      a constant, so the clock-alignment handshake can be proven to
      reconstruct correct cross-process span durations against an
      artificially skewed clock domain (tests/test_torch_fleet.py).

    The worker answers parent ``clock_probe`` messages immediately with
    its engine clock — the round-trip half of the alignment handshake.

    Exit paths: a ``stop``/``drain`` control message, parent death (pipe
    EOF — a fleet worker never outlives its fleet), or a fatal setup
    error (reported as a ``fatal`` message, so the parent can raise it
    with the real cause instead of a bare dead replica): no GPU for a
    ``"cuda"`` worker, a kernel that does not build or launch during the
    warm-up. A ``drained`` worker's stats carry its process's
    ``cuda_ops.LAUNCHES`` under ``launches`` and its ``nvcc`` builds
    (``_build.BUILDS``) under ``builds``."""
    config = dict(config)
    session_kwargs = dict(config.get("session") or {})
    engine_kwargs = dict(config.get("engine") or {})
    rid = int(config.get("replica_id", 0))
    inner = None
    try:
        from shallowspeed_tpu_torch import cuda_ops
        from shallowspeed_tpu_torch import faults as F
        from shallowspeed_tpu_torch.api import TrainingSession
        from shallowspeed_tpu_torch.observability import JsonlMetrics
        from shallowspeed_tpu_torch.serving.engine import ServingEngine

        inner = (
            JsonlMetrics(config["metrics_path"])
            if config.get("metrics_path")
            else NullMetrics()
        )
        tap = _HealthTap(inner)
        session = TrainingSession(metrics=inner, **session_kwargs)
        # the worker's clock domain: engine timestamps, trace spans and
        # clock-probe replies all read the SAME clock, so the handshake
        # offset maps every one of them onto the parent timeline (the
        # test hook skews it to prove the alignment recovers it)
        skew = float(config.get("clock_offset_s") or 0.0)
        if skew:
            clock = lambda: time.perf_counter() + skew  # noqa: E731
        else:
            clock = time.perf_counter
        tracer = Tracer(
            inner, process=f"r{rid}", replica_id=rid,
            clock_domain="worker", terminal_ack=False,
        )
        # the worker's sensor tags every rollup/alert record with this
        # replica's id — the join key the shard merge aligns windows by
        engine_kwargs.setdefault("replica_id", rid)
        engine = ServingEngine(
            session, metrics=tap, clock=clock, tracer=tracer,
            **engine_kwargs,
        )
        # one dispatch of every rung BEFORE announcing ready: a replica that
        # would pay the kernel load, the first launches or a mesh rung's
        # build inside its first requests' latency must not take traffic
        # yet (the scale_up contract)
        engine.warm_ladder()
        conn.send(
            {
                "kind": "ready",
                "replica_id": rid,
                "slot_rows": session.slot_rows,
                "ladder": list(session.slot_ladder),
                "max_slots": engine._max_slots,
                "loaded_step": engine_kwargs.get("loaded_step"),
            }
        )
    except Exception as e:  # noqa: BLE001 — ship the real cause, then die
        try:
            conn.send(
                {
                    "kind": "fatal",
                    "replica_id": rid,
                    "error": f"{type(e).__name__}: {e}"[:500],
                }
            )
        except Exception:  # noqa: BLE001 — the pipe to the parent is already dead; the fatal report is best-effort
            pass
        if inner is not None:
            inner.close()
        return

    verify = bool(config.get("verify"))
    hb_s = float(config.get("heartbeat_s", 0.25))
    draining = False
    fleet_ids = {}  # engine request id -> fleet request id

    def send(msg):
        try:
            conn.send(msg)
            return True
        except (BrokenPipeError, OSError):
            return False  # parent gone — nothing left to serve for

    try:
        last_hb = time.perf_counter()
        while True:
            timeout = 0.0 if engine.queue_depth else 0.005
            try:
                has_msg = conn.poll(timeout)
            except OSError:
                return
            while has_msg:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                kind = msg.get("kind")
                if kind == "request":
                    fid = msg["id"]
                    if draining:
                        # the parent stops routing before it drains; a
                        # straggler still gets a verdict, never silence
                        send(
                            {
                                "kind": "response",
                                "id": fid,
                                "verdict": "dropped",
                                "result": None,
                                "latency_s": None,
                                "queue_s": None,
                                "attempts": 0,
                                "parity_ok": None,
                                "degraded": engine.degraded,
                                "queue_depth": engine.queue_depth,
                                "last_span_id": None,
                            }
                        )
                    else:
                        req = engine.submit(
                            msg["x"], deadline_ms=msg.get("deadline_ms"),
                            trace=msg.get("trace"),
                        )
                        if req.verdict == "queued":
                            fleet_ids[req.id] = fid
                        else:  # refused at admission (degraded / shed)
                            if not send(_response_msg(req, fid, engine, None)):
                                return
                elif kind == "clock_probe":
                    # the alignment handshake's worker half: answer NOW
                    # with the engine clock — every poll-loop microsecond
                    # before this reply widens the parent's uncertainty
                    # bound, never skews the estimate past it
                    send(
                        {
                            "kind": "clock_probe_reply",
                            "t0": msg["t0"],
                            "tw": engine.clock(),
                        }
                    )
                elif kind == "reload":
                    try:
                        engine.watch_reload()
                    except ValueError:
                        pass  # no reload_dir configured — a no-op poll
                elif kind == "drain":
                    draining = True
                elif kind == "stop":
                    return
                has_msg = conn.poll(0)
            if engine.queue_depth:
                try:
                    done = engine.step()
                except F.InjectedFault:
                    # injected dispatch-loop death: the queue is intact by
                    # the engine's contract — the worker loop IS the
                    # operator loop, so it simply re-enters
                    done = []
                for r in done:
                    fid = fleet_ids.pop(r.id, None)
                    if fid is None:
                        continue
                    parity = None
                    if verify and r.verdict == "ok":
                        tv0 = engine.clock()
                        parity = bool(
                            np.array_equal(r.result, session.predict(r.x))
                        )
                        # the parity re-predict is the expensive half of
                        # verification — its own span, chained after the
                        # engine's finiteness-gate verify
                        sid = tracer.span(
                            "verify", r.trace_id, tv0, engine.clock(),
                            parent=r.last_span_id, parity=parity,
                        )
                        if sid is not None:
                            r.last_span_id = sid
                    if not send(_response_msg(r, fid, engine, parity)):
                        return
                if not send(_heartbeat_msg(engine, tap)):
                    return
                last_hb = time.perf_counter()
            now = time.perf_counter()
            if now - last_hb >= hb_s:
                if not send(_heartbeat_msg(engine, tap)):
                    return
                last_hb = now
            if draining and not engine.queue_depth and not fleet_ids:
                stats = engine.stats()
                stats["launches"] = dict(cuda_ops.LAUNCHES)
                stats["builds"] = dict(_build.BUILDS)
                if session._aot is not None:
                    stats["aot"] = session._aot.stats()
                send({"kind": "drained", "stats": stats})
                return
    finally:
        inner.close()


def _probe_main(conn):
    """Spawn-capability probe body (must be module-level for spawn)."""
    conn.send("ok")
    conn.close()


_SPAWN_SUPPORTED = None


def fleet_workers_supported(timeout_s=30.0):
    """Can this platform spawn fleet worker processes? (multiprocessing
    spawn context + a live pipe round trip.) Cached; the fleet tests
    skip-with-reason when False — mirroring the multihost collectives
    skip — so tier-1 stays green on constrained runners."""
    global _SPAWN_SUPPORTED
    if _SPAWN_SUPPORTED is None:
        try:
            ctx = multiprocessing.get_context("spawn")
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_probe_main, args=(child,), daemon=True)
            proc.start()
            child.close()
            ok = parent.poll(timeout_s) and parent.recv() == "ok"
            proc.join(5)
            parent.close()
            _SPAWN_SUPPORTED = bool(ok)
        except Exception:  # noqa: BLE001 — any failure means "cannot spawn"
            _SPAWN_SUPPORTED = False
    return _SPAWN_SUPPORTED


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


class ReplicaHandle:
    """Process + pipe + state for one replica, parent-side."""

    def __init__(self, info, proc, conn):
        self.info = info
        self.proc = proc
        self.conn = conn
        self.inflight = {}  # fleet request id -> FleetRequest (un-acked)
        self.dead = False
        self.fatal_error = None
        self.retired_stats = None  # the drained worker's engine stats
        # clock-alignment handshake state: the best (lowest-uncertainty)
        # round-trip offset estimate so far, when we last probed, and how
        # many probes this replica has answered (bounds the refinement)
        self.clock_offset = None  # {"offset_s", "rtt_s", "uncertainty_s"}
        self.last_probe_t = None
        self.probes_answered = 0

    def send(self, msg):
        if self.dead:
            return False
        try:
            self.conn.send(msg)
            return True
        except (BrokenPipeError, OSError):
            return False

    def poll(self):
        """Drain every buffered message; returns ``(messages, died)``.
        Death shows as pipe EOF (a SIGKILLed worker's buffered messages
        are still delivered first — nothing acked is lost) or as an
        exited process with an empty pipe."""
        msgs = []
        died = False
        try:
            while self.conn.poll(0):
                msgs.append(self.conn.recv())
        except (EOFError, OSError):
            died = True
        if not died and not self.proc.is_alive():
            died = True
        return msgs, died

    def close(self):
        try:
            self.conn.close()
        except OSError:
            pass


class ServingFleet:
    """N replica worker processes behind the router (module docstring).

    ``worker_config``: the per-replica recipe — ``{"session": {...
    TrainingSession kwargs, checkpoint via "resume"}, "engine": {...
    ServingEngine kwargs}, "verify": bool}``; everything must be
    picklable (the spawn context ships it to each worker). The session
    kwargs' ``device`` (None = ``"cuda"``) is resolved here, so a fleet
    asked for the card on a host without one raises at once; the
    resolved device goes to every worker. A ``metrics_path`` base may be
    given explicitly, else it is derived from a ``JsonlMetrics`` parent
    recorder's path — each replica writes ``<base>.r{replica_id}``.

    ``retry`` is the fleet-level PLACEMENT budget per request (int or
    ``retry.RetryPolicy`` — the same shared policy the engine's dispatch
    recovery uses): every placement on a replica consumes one attempt,
    and a request whose replica died (or answered with a re-routable
    ``error``/``dropped``/``unhealthy`` verdict) is re-queued at the
    fleet-queue head while the budget lasts. ``inflight_window`` bounds
    un-acked requests per replica — both the failover blast radius and
    the staleness the placement score can accumulate between heartbeats.

    ``route_stall_timeout_s`` bounds the no-routable-replica wait: with
    every replica degraded (but alive) for that long, queued requests
    complete as ``"error"``/``no_routable_replica`` — ``drain()`` is
    bounded by construction, like the engine's. A fleet with NO live
    replica fails its queue immediately (``fleet_down``).

    ``telemetry_window_s`` / ``knee_rps`` / ``alert_rules`` /
    ``alert_sinks`` configure the fleet-level live-telemetry sensor
    (module docstring). ``alert_rules=None`` builds the default serving
    set (``slo.default_serving_rules`` — its ``fleet_degraded`` event
    rule is the deterministic alerting gate at this level), ``[]``
    disables alerting while keeping the rollup windows; ``knee_rps``
    must come from a measured ``bench_serving`` sweep record.
    """

    def __init__(
        self,
        worker_config,
        n_replicas=2,
        policy="least_queue",
        max_queue=None,
        slo_ms=None,
        retry=2,
        inflight_window=8,
        metrics=None,
        heartbeat_s=0.25,
        route_stall_timeout_s=30.0,
        spawn_timeout_s=300.0,
        seed=0,
        clock=time.perf_counter,
        telemetry_window_s=1.0,
        knee_rps=None,
        alert_rules=None,
        alert_sinks=(),
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._worker_config = dict(worker_config or {})
        self._metrics = metrics if metrics is not None else NullMetrics()
        if "metrics_path" not in self._worker_config:
            base = getattr(self._metrics, "path", None)
            if base is not None:
                self._worker_config["metrics_path"] = os.fspath(base)
        self._worker_config.setdefault("heartbeat_s", heartbeat_s)
        self._n_initial = int(n_replicas)
        self._router = Router(policy=policy, max_queue=max_queue, seed=seed)
        self._slo_ms = slo_ms
        if isinstance(retry, R.RetryPolicy):
            self._retry = retry
        else:
            self._retry = R.RetryPolicy(attempts=int(retry), base=0.0, jitter=0)
        if inflight_window < 1:
            raise ValueError("inflight_window must be >= 1")
        self._window = int(inflight_window)
        session = dict(self._worker_config.get("session") or {})
        session["device"] = str(resolve_device(session.get("device")))
        self._worker_config["session"] = session
        self._heartbeat_s = heartbeat_s
        self._stall_timeout = route_stall_timeout_s
        self._spawn_timeout = spawn_timeout_s
        self.clock = clock
        self._ctx = multiprocessing.get_context("spawn")
        self._replicas = {}  # replica_id -> ReplicaHandle
        self._target = 0  # intended fleet size (deaths do NOT reduce it)
        self._next_replica_id = 0
        self._next_request_id = 0
        self._slot_rows = None
        self._max_slots = None
        self._degraded = False
        self._stall_t = None
        self._impair_t = None  # replica lost / quorum lost, awaiting an ok
        # request tracing (schema v10): the parent mints every trace id,
        # emits the parent-side spans (fleet.queue/route/failover.requeue/
        # terminal ack) and records each worker's clock-offset estimate
        self._tracer = Tracer(self._metrics, process="f")
        self._probe_every_s = 2.0  # re-probe cadence piggybacking heartbeats
        # live telemetry (module docstring): the fleet-level sensor.
        # Windows close on parent-clock timestamps; worker engines run
        # their own replica-tagged sensors into the .r* shards. No
        # replica_id here — the parent's records are the fleet-wide view.
        self._telemetry = LiveTelemetry(
            "fleet",
            metrics=self._metrics,
            window_s=telemetry_window_s,
            rules=alert_rules,
            sinks=alert_sinks,
            slo_ms=slo_ms,
            knee_rps=knee_rps,
        )
        # completions collected OUTSIDE step() (wait_ready pumps the
        # pipes too) are stashed and returned by the next step() — a
        # completed request must always reach a caller's hands
        self._stash_done = []
        # growth replicas spawned without blocking join the quorum
        # denominator only when READY: growing a healthy fleet must not
        # degrade it for the length of a warm-up
        self._deferred_target = set()
        # accounting (the engine's scalar-samples discipline: latencies
        # only, payloads stay with the caller); the serving window folds
        # through the same shared helper the engine uses
        self._samples = []  # (latency_s, queue_s, deadline_ms)
        self._serve_window = ThroughputWindow()
        self._dropped = 0
        self._expired = 0
        self._errors = 0
        self._unhealthy = 0
        self._reroutes = 0
        self._failovers = 0
        self._failover_requeued = 0
        self._failover_exhausted = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._replaced = 0  # deaths answered by a replacement scale-up
        self._replicas_dead = 0
        self._replicas_retired = 0
        self._last_scale_up_s = None
        self._recovery_s = None
        self._depth_max = 0
        self._depth_sum = 0.0
        self._depth_n = 0
        self._parity_mismatches = 0
        # admission gate (serving/autoscaler.py backpressure): consulted
        # per submit AFTER the degraded check; a reason string sheds the
        # request as dropped with that reason
        self._admission_gate = None
        self._gate_dropped = 0

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def start(self, wait_ready=True):
        """Spawn the initial replicas; with ``wait_ready`` (default),
        block until every one has warmed its ladder and announced ready
        (or raise ``FleetError`` with the first fatal cause)."""
        for _ in range(self._n_initial):
            self._spawn_replica()
        if wait_ready:
            self.wait_ready()
        return self

    def _spawn_replica(self, checkpoint=None, count_target=True):
        rid = self._next_replica_id
        self._next_replica_id += 1
        if count_target:
            self._target += 1
        config = dict(self._worker_config)
        config["replica_id"] = rid
        config["session"] = dict(config.get("session") or {})
        config["engine"] = dict(config.get("engine") or {})
        if checkpoint is not None:
            config["session"]["resume"] = os.fspath(checkpoint)
        # a replica restored from a step snapshot seeds its watcher's
        # freshness floor, so a watch_reload() broadcast picks up only
        # STRICTLY newer weights — not the snapshot it already serves
        resume = config["session"].get("resume")
        if resume and config["engine"].get("loaded_step") is None:
            from shallowspeed_tpu_torch.checkpoint import STEP_CHECKPOINT_RE

            m = STEP_CHECKPOINT_RE.match(os.path.basename(os.fspath(resume)))
            if m:
                config["engine"]["loaded_step"] = int(m.group(1))
        if config.get("metrics_path"):
            config["metrics_path"] = replica_shard_path(
                self._worker_config["metrics_path"], rid
            )
        device = config["session"]["device"]
        if device.startswith("cuda"):
            # build the forward kernel's library here, before the worker
            # starts (a no-op once built): N workers on a fresh checkout
            # would each run nvcc
            _build.build_all(["linear_act_fwd"])
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main, args=(child_conn, config), daemon=True
        )
        # stage the child's environment around start(): the spawn child
        # inherits the parent env at exec, and imports torch (via the
        # package root) while unpickling the target — before any worker
        # code could set these itself (_child_env docstring)
        overrides = _child_env(device)
        saved = {k: os.environ.get(k) for k in overrides}
        try:
            for k, v in overrides.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # the parent MUST close its copy of the child end, or a dead
        # worker's pipe never reads as EOF and failover never triggers
        child_conn.close()
        info = ReplicaInfo(rid, spawn_t=self.clock())
        self._replicas[rid] = ReplicaHandle(info, proc, parent_conn)
        self._metrics.fleet_health(
            "replica_spawned",
            replica_id=rid,
            checkpoint=None if checkpoint is None else str(checkpoint),
        )
        return rid

    def wait_ready(self, timeout_s=None):
        """Pump until no replica is still starting; raise ``FleetError``
        on a fatal start or on timeout."""
        deadline = self.clock() + (
            timeout_s if timeout_s is not None else self._spawn_timeout
        )
        while any(
            h.info.state == "starting" and not h.dead
            for h in self._replicas.values()
        ):
            # responses arriving during the wait are stashed for the next
            # step() — waiting on a warm-up must not swallow completions
            self._pump_messages(self._stash_done)
            starting_dead = [
                h
                for h in self._replicas.values()
                if h.dead and h.info.state == "dead" and h.info.ready_t is None
            ]
            if starting_dead:
                h = starting_dead[0]
                raise FleetError(
                    f"replica {h.info.replica_id} failed to start: "
                    f"{h.fatal_error or 'process died before ready'}"
                )
            if self.clock() > deadline:
                raise FleetError(
                    f"fleet start timed out after {self._spawn_timeout:g}s "
                    f"({self.n_ready}/{self._target} replicas ready)"
                )
            time.sleep(0.01)
        self._update_degraded()

    def stop(self):
        """Terminate every worker (best effort: polite stop, then
        terminate, then kill) and close the pipes. Queued/in-flight
        requests are NOT completed — callers drain first; stop() is the
        shutdown path, not the graceful one."""
        for h in self._replicas.values():
            if h.proc.is_alive():
                h.send({"kind": "stop"})
        for h in self._replicas.values():
            if h.proc.is_alive():
                h.proc.join(timeout=5)
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(timeout=5)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(timeout=5)
            h.close()

    # -- introspection -------------------------------------------------------

    @property
    def replicas(self):
        """Read-only view: replica_id -> ReplicaInfo."""
        return {rid: h.info for rid, h in self._replicas.items()}

    @property
    def n_ready(self):
        return sum(1 for h in self._replicas.values() if h.info.routable())

    @property
    def n_alive(self):
        return sum(1 for h in self._replicas.values() if h.info.alive)

    @property
    def target_replicas(self):
        return self._target

    @property
    def degraded(self):
        """True while fewer than a quorum of the target replicas are
        healthy — admission refused (already-admitted work still
        drains)."""
        return self._degraded

    @property
    def inflight(self):
        return sum(len(h.inflight) for h in self._replicas.values())

    @property
    def queue_depth(self):
        """Requests the fleet still owes a verdict: fleet-queued plus
        un-acked in-flight. (The loadgen drivers' loop condition — a
        fleet with responses still on the wire has not drained.)"""
        return len(self._router.queue) + self.inflight

    @property
    def parity_mismatches(self):
        """Worker-reported bitwise-parity failures among "ok" responses
        (0 is the contract; needs ``verify`` in the worker config)."""
        return self._parity_mismatches

    def pid(self, replica_id):
        return self._replicas[replica_id].proc.pid

    def retired_stats(self):
        """``{replica_id: stats}`` of every replica that drained and
        retired: its engine's ``stats()`` plus ``launches``, its process's
        ``cuda_ops.LAUNCHES`` at exit (warm-up, dispatches and verify
        re-predicts all counted), ``builds``, its ``_build.BUILDS``, and
        with an AOT cache ``aot``, the cache's ``stats()``. A SIGKILLed
        replica is absent."""
        return {
            rid: h.retired_stats
            for rid, h in self._replicas.items()
            if h.retired_stats is not None
        }

    def sigkill_replica(self, replica_id):
        """Chaos harness leg: SIGKILL one replica's process — the honest
        preemption (nothing flushes, no atexit). The fleet finds out the
        way it would in production: the pipe goes EOF and failover runs.
        Recorded so the soak's record shows the kill was injected, not
        organic."""
        h = self._replicas[replica_id]
        self._metrics.fleet_health(
            "replica_sigkill", replica_id=replica_id, pid=h.proc.pid
        )
        os.kill(h.proc.pid, signal.SIGKILL)

    # -- admission -----------------------------------------------------------

    def set_admission_gate(self, gate):
        """Install (or clear, with ``None``) the admission gate: a
        ``gate(fleet) -> reason|None`` callable consulted on every
        ``submit`` after the degraded check. A truthy reason sheds the
        request immediately — ``dropped`` with that reason — which is the
        autoscaler's warm-up backpressure hook (``serving/autoscaler.py``):
        while replacement replicas warm, an unbounded backlog would burn
        every queued deadline past the analytical latency floor, so the
        policy sheds at admission instead and the refusals are scored
        honestly as violations by the capacity scoreboard."""
        self._admission_gate = gate

    @property
    def gate_dropped(self):
        """Requests shed by the admission gate (backpressure refusals)."""
        return self._gate_dropped

    def submit(self, x, deadline_ms=None, arrival_t=None):
        """Admit one request of ``(rows, in_dim)`` inputs; returns its
        ``FleetRequest`` (terminal immediately when refused).
        ``arrival_t`` backdates the enqueue timestamp — the open-loop
        coordinated-omission correction, same contract as the engine's
        ``submit``."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] < 1:
            raise ValueError(f"request must be (rows >= 1, in_dim), got {x.shape}")
        if (
            self._slot_rows is not None
            and self._max_slots is not None
            and -(-x.shape[0] // self._slot_rows) > self._max_slots
        ):
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds one replica dispatch "
                f"({self._max_slots} slots x {self._slot_rows} rows); split it"
            )
        t = self.clock() if arrival_t is None else float(arrival_t)
        req = FleetRequest(self._next_request_id, x, deadline_ms, t)
        self._next_request_id += 1
        if self._tracer.enabled:
            req.trace_id = self._tracer.new_trace(req.id)
        self._serve_window.note_enqueue(t)
        if self._degraded:
            self._complete(req, "dropped", reason="fleet_degraded")
            return req
        if self._admission_gate is not None:
            reason = self._admission_gate(self)
            if reason:
                self._gate_dropped += 1
                self._complete(req, "dropped", reason=str(reason))
                return req
        if not self._router.admit(req):
            self._complete(req, "dropped", reason="fleet_queue_full")
            return req
        req.admitted = True
        self._telemetry.note_admit(t)
        self._record_depth(t)
        return req

    # -- the pump ------------------------------------------------------------

    def step(self):
        """One fleet pump: collect replica messages (responses,
        heartbeats, deaths -> failover), refresh the quorum verdict,
        route the queue's head onto the least-loaded routable replicas,
        and bound the stall paths. Returns the fleet requests that
        reached a terminal verdict during this pump (plus any stashed by
        an intervening ``wait_ready``)."""
        done = self._stash_done
        self._stash_done = []
        progressed = self._pump_messages(done)
        self._update_degraded()
        progressed = self._route(done) or progressed
        self._reap_stalls(done)
        if done:
            progressed = True
        if not progressed and self.queue_depth:
            time.sleep(0.002)  # idle tick: don't hot-spin the pipe polls
        return done

    def drain(self):
        """Pump until every admitted request has its terminal verdict.
        Bounded: failover budgets, the fleet-down sweep and the
        route-stall timeout guarantee progress even with every replica
        dead or degraded."""
        done = []
        while self.queue_depth or self._stash_done:
            done.extend(self.step())
        return done

    def _pump_messages(self, done):
        progressed = False
        for h in list(self._replicas.values()):
            if h.dead:
                continue
            msgs, died = h.poll()
            for msg in msgs:
                progressed = True
                self._handle_message(h, msg, done)
            if died and not h.dead:
                self._on_replica_dead(h, done)
                progressed = True
        return progressed

    def _handle_message(self, h, msg, done):
        info = h.info
        kind = msg.get("kind")
        if kind == "ready":
            info.state = "ready" if info.state == "starting" else info.state
            if info.replica_id in self._deferred_target:
                # a non-blocking GROWTH replica joins the quorum
                # denominator now that it can actually serve
                self._deferred_target.discard(info.replica_id)
                self._target += 1
            info.ready_t = self.clock()
            info.loaded_step = msg.get("loaded_step")
            if self._slot_rows is None:
                self._slot_rows = int(msg["slot_rows"])
                self._max_slots = int(msg["max_slots"])
            wall = (
                info.ready_t - info.spawn_t if info.spawn_t is not None else None
            )
            if self._scale_ups and self._last_scale_up_s is None:
                self._last_scale_up_s = wall
            self._metrics.fleet_health(
                "replica_ready",
                replica_id=info.replica_id,
                wall_s=wall,
                loaded_step=info.loaded_step,
            )
            # the alignment handshake: a burst of probes right at ready
            # (the worker sits in its message loop, so all three answer
            # back to back with tight round trips — the min-uncertainty
            # fold keeps the best)
            self._probe_clock(h, burst=3)
        elif kind == "clock_probe_reply":
            self._note_clock_reply(h, msg)
        elif kind == "heartbeat":
            was_degraded = info.degraded
            info.queue_depth = int(msg.get("queue_depth", 0))
            info.degraded = bool(msg.get("degraded"))
            info.last_health = msg.get("last_health")
            info.last_heartbeat_t = self.clock()
            if info.degraded and not was_degraded:
                if self._impair_t is None:
                    self._impair_t = self.clock()
                self._metrics.fleet_health(
                    "replica_degraded",
                    replica_id=info.replica_id,
                    last_health=info.last_health,
                )
                self._telemetry.note_health(
                    self.clock(), "replica_degraded",
                    replica_id=info.replica_id,
                )
            elif was_degraded and not info.degraded:
                self._metrics.fleet_health(
                    "replica_recovered", replica_id=info.replica_id
                )
                self._telemetry.note_health(
                    self.clock(), "replica_recovered",
                    replica_id=info.replica_id,
                )
            # keep the clock estimate fresh: one probe per heartbeat
            # window, piggybacking the traffic that already flows
            if self._tracer.enabled and (
                h.last_probe_t is None
                or self.clock() - h.last_probe_t >= self._probe_every_s
            ):
                self._probe_clock(h)
        elif kind == "response":
            req = h.inflight.pop(msg["id"], None)
            if req is None:
                return
            info.inflight = len(h.inflight)
            info.degraded = bool(msg.get("degraded", info.degraded))
            info.queue_depth = int(msg.get("queue_depth", info.queue_depth))
            verdict = msg["verdict"]
            info.note_verdict(verdict)
            req.worker_latency_s = msg.get("latency_s")
            if msg.get("last_span_id") is not None:
                # the worker's chain tail: the terminal ack (or, on a
                # re-route, the NEXT route span) parents to it, so the
                # failed attempt's spans stay linked into the chain
                req.trace_tail = msg["last_span_id"]
            if verdict == "ok":
                req.result = msg.get("result")
                req.parity_ok = msg.get("parity_ok")
                if req.parity_ok is False:
                    self._parity_mismatches += 1
                self._complete(req, "ok")
                done.append(req)
            elif verdict == "expired":
                # a missed deadline is missed everywhere — never re-routed
                self._complete(req, "expired", reason="replica_shed")
                done.append(req)
            else:  # error / dropped / unhealthy — re-routable failures
                if self._retry.exhausted(req.attempts):
                    self._complete(req, verdict, reason="retry_exhausted")
                    done.append(req)
                else:
                    req.replica_id = None
                    self._router.requeue_head([req])
                    self._reroutes += 1
                    self._metrics.fleet_health(
                        "reroute",
                        replica_id=info.replica_id,
                        request_id=req.id,
                        worker_verdict=verdict,
                        attempts=req.attempts,
                    )
        elif kind == "drained":
            info.state = "retired"
            self._replicas_retired += 1
            h.proc.join(timeout=10)
            h.close()
            h.dead = True
            h.retired_stats = msg.get("stats")
            # the worker's launch and build counts and cache stats are the
            # port's own: kept on the handle (retired_stats), out of the
            # JSONL record
            stats = dict(h.retired_stats or {})
            for k in ("launches", "builds", "aot"):
                stats.pop(k, None)
            self._metrics.fleet_health(
                "replica_retired",
                replica_id=info.replica_id,
                stats=stats or None,
            )
        elif kind == "fatal":
            h.fatal_error = msg.get("error")

    def _probe_clock(self, h, burst=1):
        """Send ``burst`` clock probes to one worker (module docstring:
        the round-trip offset handshake). Replies fold through
        ``_note_clock_reply``; probes on a broken pipe are dropped — the
        death path owns that replica now. A metrics-disabled fleet sends
        none: an estimate that can never be recorded is wasted IPC."""
        if not self._tracer.enabled:
            return
        for _ in range(burst):
            if not h.send({"kind": "clock_probe", "t0": self.clock()}):
                return
        h.last_probe_t = self.clock()

    # refinement bounds: chase a sub-millisecond estimate with immediate
    # follow-up probes (the worker answers from inside its message loop
    # and the parent stamps t1 in the very pump that reads the reply, so
    # chained round trips tighten fast), but never more than a fixed
    # probe budget per replica — alignment must stay background noise
    _PROBE_TARGET_UNCERTAINTY_S = 0.0005
    _PROBE_BUDGET = 24

    def _note_clock_reply(self, h, msg):
        """One probe's round trip: offset = tw - (t0 + t1)/2, uncertainty
        = rtt/2 (the true offset provably lies inside the bound — the
        reply can sit anywhere between the two parent timestamps). Keep
        and record only IMPROVED estimates, so the reader's last-wins
        fold always holds the best, and the JSONL stays bounded; while
        the bound is still loose (parent pump lag dominates the first
        round trips), chase it with an immediate follow-up probe."""
        t1 = self.clock()
        t0 = float(msg["t0"])
        rtt = t1 - t0
        est = {
            "offset_s": float(msg["tw"]) - 0.5 * (t0 + t1),
            "rtt_s": rtt,
            "uncertainty_s": 0.5 * rtt,
        }
        h.probes_answered += 1
        best = h.clock_offset
        if best is None or est["uncertainty_s"] < best["uncertainty_s"]:
            h.clock_offset = est
            self._tracer.clock_offset(
                replica_id=h.info.replica_id,
                offset_s=est["offset_s"],
                rtt_s=est["rtt_s"],
                uncertainty_s=est["uncertainty_s"],
            )
        if (
            h.clock_offset["uncertainty_s"] > self._PROBE_TARGET_UNCERTAINTY_S
            and h.probes_answered < self._PROBE_BUDGET
        ):
            self._probe_clock(h)

    def _on_replica_dead(self, h, done):
        """Death -> failover: the dead replica's un-acked in-flight
        requests re-enter the fleet queue HEAD in original submit order
        under the placement budget; exhausted ones complete as "error".
        Nothing it acked is affected (acked = a response we already
        processed), and nothing vanishes as "queued"."""
        info = h.info
        h.dead = True
        was_working = info.state in ("ready", "draining")
        # a growth replica that died before ready never joined the
        # quorum denominator — nothing to count it against
        self._deferred_target.discard(info.replica_id)
        info.state = "dead"
        self._replicas_dead += 1
        h.proc.join(timeout=5)
        h.close()
        inflight = sorted(h.inflight.values(), key=lambda r: r.id)
        h.inflight.clear()
        info.inflight = 0
        self._metrics.fleet_health(
            "replica_dead",
            replica_id=info.replica_id,
            inflight=len(inflight),
            error=h.fatal_error,
        )
        self._telemetry.note_health(
            self.clock(), "replica_dead", replica_id=info.replica_id
        )
        if was_working and self._impair_t is None:
            self._impair_t = self.clock()
        if not inflight:
            return
        self._failovers += 1
        requeue = []
        t_detect = self.clock()
        for req in inflight:
            req.replica_id = None
            if req.trace_id is not None:
                # the failover.requeue span links the dead replica's
                # partial chain (its tail is this request's last route
                # span — or the worker's last shipped span) to whatever
                # serves the request next
                req.trace_tail = self._tracer.span(
                    "failover.requeue", req.trace_id, t_detect, t_detect,
                    parent=req.trace_tail,
                    from_replica=info.replica_id,
                    requeued=not self._retry.exhausted(req.attempts),
                ) or req.trace_tail
            if self._retry.exhausted(req.attempts):
                self._failover_exhausted += 1
                self._complete(req, "error", reason="replica_died")
                done.append(req)
            else:
                requeue.append(req)
        self._router.requeue_head(requeue)
        self._failover_requeued += len(requeue)
        self._metrics.fleet_health(
            "failover",
            replica_id=info.replica_id,
            requeued=len(requeue),
            exhausted=len(inflight) - len(requeue),
        )
        self._metrics.flush()

    def _update_degraded(self):
        healthy = self.n_ready
        degraded_now = healthy < quorum(self._target)
        if degraded_now and not self._degraded:
            self._degraded = True
            if self._impair_t is None:
                self._impair_t = self.clock()
            self._metrics.fleet_health(
                "fleet_degraded",
                replica_id=None,
                healthy=healthy,
                target=self._target,
                quorum=quorum(self._target),
            )
            self._telemetry.note_health(
                self.clock(), "fleet_degraded",
                healthy=healthy, target=self._target,
            )
            self._metrics.flush()
        elif not degraded_now and self._degraded:
            self._degraded = False
            self._metrics.fleet_health(
                "fleet_recovered",
                replica_id=None,
                healthy=healthy,
                target=self._target,
            )
            self._telemetry.note_health(
                self.clock(), "fleet_recovered",
                healthy=healthy, target=self._target,
            )

    def _route(self, done):
        routed_any = False
        while self._router.queue:
            req = self._router.queue[0]
            now = self.clock()
            remaining = req.remaining_deadline_ms(now)
            if remaining is not None and remaining <= 0:
                # fleet-level deadline shed: the queue wait already spent
                # the budget — don't burn a pipe hop on a hopeless request
                self._router.queue.popleft()
                self._complete(req, "expired", reason="fleet_deadline")
                done.append(req)
                continue
            candidates = [
                h.info
                for h in self._replicas.values()
                if not h.dead and h.info.inflight < self._window
            ]
            target = self._router.place(candidates)
            if target is None:
                break
            self._router.queue.popleft()
            h = self._replicas[target.replica_id]
            req.attempts += 1
            req.route_t = now
            req.replica_id = target.replica_id
            req.replicas_tried.append(target.replica_id)
            trace_ctx = None
            if req.trace_id is not None:
                if req.trace_root is None:
                    # the chain root: fleet admission -> first placement
                    req.trace_root = self._tracer.span(
                        "fleet.queue", req.trace_id, req.enqueue_t, now,
                        parent=None,
                    )
                    req.trace_tail = req.trace_root
                # the route span closes BEFORE the pipe write; the
                # transit to the worker's admission lands in the gap the
                # reader charges to this phase
                route_span = self._tracer.span(
                    "route", req.trace_id, now, self.clock(),
                    parent=req.trace_tail,
                    to_replica=target.replica_id, attempt=req.attempts,
                )
                if route_span is not None:
                    req.trace_tail = route_span
                    trace_ctx = {"trace_id": req.trace_id,
                                 "parent": route_span}
            if not h.send(
                {
                    "kind": "request",
                    "id": req.id,
                    "x": req.x,
                    "deadline_ms": remaining,
                    "trace": trace_ctx,
                }
            ):
                # pipe broke mid-send: put it back (the attempt was spent
                # honestly — the budget bounds placements, not successes)
                # and let the next pump run the death path
                self._router.requeue_head([req])
                break
            h.inflight[req.id] = req
            target.inflight = len(h.inflight)
            target.routed += 1
            routed_any = True
        if routed_any:
            self._record_depth(self.clock())
        return routed_any

    def _reap_stalls(self, done):
        """The bounded-drain guarantees: a fleet with no live replica
        fails its queue NOW (``fleet_down``); a fleet whose replicas are
        all alive-but-unroutable (degraded, draining) for longer than the
        stall timeout fails it then (``no_routable_replica``). Either
        way every admitted request still terminates."""
        if not self._router.queue:
            self._stall_t = None
            return
        if self.n_alive == 0:
            while self._router.queue:
                req = self._router.queue.popleft()
                self._complete(req, "error", reason="fleet_down")
                done.append(req)
            self._stall_t = None
            return
        can_route = any(
            h.info.routable() or h.info.state == "starting"
            for h in self._replicas.values()
        )
        if can_route:
            self._stall_t = None
            return
        now = self.clock()
        if self._stall_t is None:
            self._stall_t = now
        elif now - self._stall_t > self._stall_timeout:
            while self._router.queue:
                req = self._router.queue.popleft()
                self._complete(req, "error", reason="no_routable_replica")
                done.append(req)
            self._stall_t = None

    # -- elasticity ----------------------------------------------------------

    def scale_up(self, checkpoint=None, wait_ready=True):
        """Add one replica. Weights: ``checkpoint`` if given, else the
        newest verifying snapshot in the worker config's ``reload_dir``
        (``checkpoint.find_latest_good`` — the same discovery the hot
        reload uses), else the base config's own checkpoint. The replica
        warms its full ladder before announcing ready, and takes traffic
        only then — ``wait_ready=False`` keeps serving while it warms
        (the chaos soak's recovery path).

        A scale-up while dead replicas are unreplaced is a REPLACEMENT:
        the fleet target (the quorum denominator) stays put — a
        replacement must never raise the healthy-replica bar while it
        warms, it exists to get back UNDER it. With no deaths
        outstanding it is growth: target += 1 — counted at READY when
        ``wait_ready=False``, so growing a healthy fleet cannot flip it
        degraded for the length of the warm-up either."""
        replacement = self._replicas_dead > self._replaced
        if checkpoint is None:
            reload_dir = (self._worker_config.get("engine") or {}).get(
                "reload_dir"
            )
            if reload_dir is not None:
                from shallowspeed_tpu_torch.checkpoint import find_latest_good

                found, _meta, _skipped = find_latest_good(reload_dir)
                if found is not None:
                    checkpoint = found
        rid = self._spawn_replica(
            checkpoint=checkpoint,
            count_target=not replacement and wait_ready,
        )
        if replacement:
            self._replaced += 1
        elif not wait_ready:
            self._deferred_target.add(rid)
        self._scale_ups += 1
        self._last_scale_up_s = None  # measured when this replica readies
        self._metrics.fleet_health(
            "scale_up",
            replica_id=rid,
            checkpoint=None if checkpoint is None else str(checkpoint),
            replacement=replacement,
            target=self._target,
        )
        if wait_ready:
            self.wait_ready()
        return rid

    def scale_down(self, replica_id=None):
        """Drain-and-retire one replica (default: the newest routable
        one). It stops receiving traffic immediately, serves out its
        internal queue, reports its engine stats in the ``drained``
        message, and exits; the fleet's target shrinks with it."""
        if replica_id is None:
            ready = [
                h.info.replica_id
                for h in self._replicas.values()
                if h.info.routable()
            ]
            if not ready:
                raise FleetError("no routable replica to scale down")
            replica_id = max(ready)
        h = self._replicas[replica_id]
        if not h.info.alive:
            raise FleetError(f"replica {replica_id} is not alive")
        h.info.state = "draining"
        self._target -= 1
        self._scale_downs += 1
        h.send({"kind": "drain"})
        self._metrics.fleet_health(
            "scale_down", replica_id=replica_id, target=self._target
        )
        return replica_id

    def watch_reload(self):
        """Broadcast the checkpoint-dir watcher poll to every live
        replica — the zero-downtime deploy path, one level up: each
        replica hot-swaps between its own dispatches, traffic keeps
        flowing through the others meanwhile."""
        polled = []
        for h in self._replicas.values():
            if h.info.alive and h.send({"kind": "reload"}):
                polled.append(h.info.replica_id)
        self._metrics.fleet_health("reload_broadcast", replica_id=None,
                                   replicas=polled)
        return polled

    # -- accounting ----------------------------------------------------------

    def _complete(self, req, verdict, reason=None):
        t = self.clock()
        req.verdict = verdict
        req.complete_t = t
        req.reason = reason
        self._trace_ack(req, t, reason)
        # one telemetry sample per fleet-terminal verdict — every path
        # (ok, shed, drop, failover-exhausted) crosses this choke point
        self._telemetry.note_request(
            t, verdict, latency_s=req.latency_s, queue_s=req.queue_s
        )
        if verdict == "ok":
            self._samples.append((req.latency_s, req.queue_s, req.deadline_ms))
            self._serve_window.note_complete(t)
            if self._impair_t is not None:
                # recovery: replica lost (or quorum lost) -> next served
                # response — the fleet mirror of the engine's
                # breaker-open -> first-ok measurement
                self._recovery_s = t - self._impair_t
                self._impair_t = None
        elif verdict == "dropped":
            self._dropped += 1
        elif verdict == "expired":
            self._expired += 1
        elif verdict == "error":
            self._errors += 1
        elif verdict == "unhealthy":
            self._unhealthy += 1
        if verdict != "ok":
            # fleet-terminal failures never reached a worker's recorder
            # (or were decided here, one level above it) — record them so
            # the merged stream holds every fleet-level verdict exactly
            # once; "ok" and worker-terminal verdicts live in the .r
            # shards
            self._metrics.request(
                verdict,
                id=req.id,
                rows=req.rows,
                replica_id=req.replica_id,
                enqueue_ts=req.enqueue_t,
                complete_ts=req.complete_t,
                latency_s=req.latency_s,
                deadline_ms=req.deadline_ms,
                attempts=req.attempts,
                reason=reason,
                trace_id=req.trace_id,
            )

    def _trace_ack(self, req, t, reason=None):
        """The one terminal span per fleet request. A request that was
        admitted but never routed (fleet_down, no_routable_replica,
        fleet-deadline shed) still gets its fleet.queue root here, so its
        chain tells the full story: it waited, then the fleet decided."""
        if req.trace_id is None:
            return
        if req.trace_root is None and req.admitted:
            req.trace_root = self._tracer.span(
                "fleet.queue", req.trace_id, req.enqueue_t, t, parent=None,
            )
            req.trace_tail = req.trace_root
        self._tracer.span(
            "ack", req.trace_id, t, t,
            parent=req.trace_tail or req.trace_root,
            terminal=True, verdict=req.verdict,
            deadline_ms=req.deadline_ms, reason=reason,
            replica_id_served=req.replica_id,
        )

    def _record_depth(self, t):
        depth = len(self._router.queue)
        self._depth_max = max(self._depth_max, depth)
        self._depth_sum += depth
        self._depth_n += 1
        self._metrics.gauge("fleet.queue_depth", depth)
        self._telemetry.note_queue_depth(t, depth)

    def status(self):
        """The LIVE snapshot surface (module docstring): operational
        state + per-replica heartbeat view + the current/last rollup
        window + active alerts — cheap, JSON-able, callable
        mid-traffic (everything here is parent-process state; no pipe
        round trips). The fleet mirror of ``ServingEngine.status()``:
        what ``observability.watch`` renders and what ROADMAP item 4's
        autoscaler polls between ``AlertSink`` edges."""
        infos = [h.info for h in self._replicas.values()]
        return {
            "queue_depth": len(self._router.queue),
            "inflight": self.inflight,
            "degraded": self._degraded,
            "replicas_target": self._target,
            "replicas_ready": self.n_ready,
            "replicas_dead": self._replicas_dead,
            "gate_dropped": self._gate_dropped,
            "per_replica": {
                i.replica_id: {
                    "state": i.state,
                    "queue_depth": i.queue_depth,
                    "degraded": i.degraded,
                    "inflight": i.inflight,
                    "last_health": i.last_health,
                }
                for i in infos
            },
            "alerts_active": self._telemetry.evaluator.active(),
            "telemetry": self._telemetry.snapshot(),
        }

    def stats(self):
        """Fleet-wide aggregate: the engine's summary fields measured on
        the parent clock, plus the fleet story — routing counts + skew,
        failover/reroute/scale accounting, per-replica snapshots."""
        lats = [lat for lat, _, _ in self._samples]
        queues = [q for _, q, _ in self._samples if q is not None]
        slo_flags = []
        for lat, _, dl in self._samples:
            bound = dl if dl is not None else self._slo_ms
            slo_flags.append(
                None if bound is None or lat is None else lat <= bound / 1000.0
            )
        met = sum(1 for ok in slo_flags if ok)
        ok_n = len(self._samples)
        terminal = (
            ok_n + self._dropped + self._expired + self._errors
            + self._unhealthy
        )
        window = self._serve_window.window_s if self._samples else None
        infos = [h.info for h in self._replicas.values()]
        routing = {i.replica_id: i.routed for i in infos}
        return {
            "completed": ok_n,
            "dropped": self._dropped,
            "expired": self._expired,
            "errors": self._errors,
            "unhealthy": self._unhealthy,
            "availability": (ok_n / terminal) if terminal else None,
            "parity_mismatches": self._parity_mismatches,
            "reroutes": self._reroutes,
            "failovers": self._failovers,
            "failover_requeued": self._failover_requeued,
            "failover_exhausted": self._failover_exhausted,
            "replicas_target": self._target,
            "replicas_started": self._next_replica_id,
            "replicas_ready": self.n_ready,
            "replicas_dead": self._replicas_dead,
            "replicas_retired": self._replicas_retired,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "scale_up_s": self._last_scale_up_s,
            "degraded": self._degraded,
            "recovery_s": self._recovery_s,
            "routing": routing,
            "routing_skew": routing_skew(routing.values()),
            "per_replica": {i.replica_id: i.snapshot() for i in infos},
            "p50_latency_s": percentile(lats, 50),
            "p99_latency_s": percentile(lats, 99),
            "max_latency_s": max(lats) if lats else None,
            "mean_queue_s": (sum(queues) / len(queues)) if queues else None,
            "window_s": window,
            "achieved_rps": (ok_n / window) if window else None,
            "goodput_rps": (
                met / window
                if window and any(ok is not None for ok in slo_flags)
                else None
            ),
            "slo_ms": self._slo_ms,
            "slo_met": met if any(ok is not None for ok in slo_flags) else None,
            "queue_depth_max": self._depth_max,
            "queue_depth_mean": (
                self._depth_sum / self._depth_n if self._depth_n else 0.0
            ),
        }

    def record_summary(self, offered_rps=None):
        """Emit (and return) the fleet's evidence pair: the schema-v7
        ``fleet`` summary (per-replica detail, routing skew, failover +
        scale accounting) plus a fleet-wide ``serving`` summary so the
        report's Serving section reads the fleet like one big engine.
        The live-telemetry window still open at summary time is flushed
        first, so the trailing partial ``rollup`` record lands before
        the summary it feeds."""
        self._telemetry.flush()
        rec = self.stats()
        rec["offered_rps"] = offered_rps
        self._metrics.fleet("summary", **rec)
        serving_fields = {
            k: rec.get(k)
            for k in (
                "completed", "dropped", "expired", "errors", "unhealthy",
                "availability", "p50_latency_s", "p99_latency_s",
                "max_latency_s", "mean_queue_s", "window_s", "achieved_rps",
                "goodput_rps", "slo_ms", "slo_met", "queue_depth_max",
                "queue_depth_mean", "offered_rps", "degraded", "recovery_s",
            )
        }
        self._metrics.serving("fleet", **serving_fields)
        return rec
