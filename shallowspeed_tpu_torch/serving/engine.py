"""Inference serving engine: request queue + continuous batching into slots.

The port's ``ServingEngine``, the counterpart of
``shallowspeed_tpu/serving/engine.py`` on the port's ``TrainingSession``:

- **queue**: deadline-tagged requests of variable row counts, FIFO
  (packing is order-preserving, so responses complete in arrival order —
  the determinism the bitwise-parity contract needs; deadlines tag
  accounting, they do not reorder);
- **continuous batching**: each ``step()`` packs the queue's head into the
  next dispatch — whole ``slot_rows``-row slots per request (requests never
  share a slot), up to ``max_slots`` slots, the slot count then rounded up
  the session's ladder on a mesh layout;
- **bitwise parity**: every slot runs the same fixed-shape forward (on the
  sequential layout the CUDA kernel B1/B2 sums each output in one fixed
  order; on the mesh every rung program runs the same per-slot compute), so
  each response is bitwise-equal to a direct ``session.predict()`` of the
  same rows;
- **steady-state weights**: every dispatch reads the tensors the session
  holds on its device; nothing is re-transferred per request, and the
  mesh's rung programs take the params at call time, so a hot reload
  serves the new weights through the same cached programs;
- **accounting**: per-request enqueue -> dispatch -> complete timestamps,
  queue wait, padding waste and a bounded queue-depth ring, emitted as
  ``request`` records plus a ``serving`` summary and a
  ``serving.queue_depth`` gauge when a metrics recorder is attached (the
  JAX engine's schema, so either package's report renders the stream). The
  engine keeps only SCALAR samples between ``reset_stats()`` calls;
  completed ``Request`` objects go back to the caller.

Graceful degradation — every submitted request reaches exactly one
TERMINAL verdict (``TERMINAL_VERDICTS``), never silence:

- **dispatch recovery**: a raised dispatch re-queues the popped batch at
  the queue HEAD in its original order under a bounded per-request
  ``retry.RetryPolicy`` budget (exhausted: ``"error"``);
- **deadline shedding**: at pack time a head request whose deadline has
  passed — or provably cannot be met even dispatching NOW (the analytical
  latency floor exceeds the time remaining) — completes as ``"expired"``
  before costing a slot; ``shed_on_submit=True`` applies the same
  estimate at admission;
- **health-gated responses**: every dispatch's predictions are
  finiteness-checked per request (non-finite: ``"unhealthy"``, no result);
- **breaker**: ``breaker_threshold`` CONSECUTIVE failed dispatches open
  the breaker, which refuses admission (``"dropped"``, reason
  ``"degraded"``), emits a ``serving_health`` record and — with a
  ``reload_dir`` — triggers a hot weight reload;
- **hot weight reload**: ``reload()`` swaps verified checkpoint weights
  between dispatches without touching the queue
  (``TrainingSession.load_weights``: same shapes, every cached rung
  program survives); ``watch_reload()`` polls the directory for snapshots
  newer than the one served (``checkpoint.find_newer_good``). A
  successful reload closes the breaker;
- **chaos**: a ``faults=`` plan (``@dispatch=N`` anchors) injects
  ``die``/``slow``/``nan``/``error`` faults into the dispatch loop
  deterministically — ``bench_serving``'s chaos soak drives it;
- **dispatch floor**: ``dispatch_floor_ms`` pads every successful
  dispatch up to a fixed service-time floor (the worker sleeps out the
  remainder), the JAX engine's knob for measuring a knee that transfers
  to a fleet.

Clock domain: every timestamp this engine records is a value of
``engine.clock`` (``time.perf_counter`` unless injected). On a CUDA
session ``predict`` returns host numpy, which waits for the device, so
the dispatch span's end is after the kernels finished.

Tracing (schema v10): with a metrics recorder attached, every request
leaves a span chain — ``worker.queue`` (admission -> dispatch pop),
``pack``, ``dispatch``, ``verify`` and the terminal ``ack`` — keyed by a
``trace_id`` minted at submit (or carried in with a ``trace=`` context).
Spans are emitted CLOSED, at the request's completion.

Live telemetry (schema v11): the engine owns a ``slo.LiveTelemetry``
sensor fed by every terminal verdict, queue-depth sample and health event
(tumbling ``rollup`` windows on ENGINE-CLOCK timestamps and the SLO rule
set's ``alert`` transitions). ``status()`` is the live snapshot the watch
CLI renders.
"""

import time
from collections import deque

import numpy as np

from shallowspeed_tpu_torch import faults as F
from shallowspeed_tpu_torch import retry as R
from shallowspeed_tpu_torch.checkpoint import (
    CheckpointError,
    find_latest_good,
    find_newer_good,
)
from shallowspeed_tpu_torch.observability import NullMetrics
from shallowspeed_tpu_torch.observability.slo import LiveTelemetry
from shallowspeed_tpu_torch.observability.stats import ThroughputWindow, percentile
from shallowspeed_tpu_torch.observability.tracing import Tracer
from shallowspeed_tpu_torch.serving import slots as serving_slots

# terminal request verdicts — every submitted request ends on exactly one
TERMINAL_VERDICTS = ("ok", "dropped", "expired", "error", "unhealthy")


class Request:
    """One queued inference request and its accounting."""

    __slots__ = (
        "id",
        "x",
        "rows",
        "slots",
        "deadline_ms",
        "enqueue_t",
        "dispatch_t",
        "complete_t",
        "result",
        "verdict",
        "attempts",
        "trace_id",
        "trace_parent",
        "last_span_id",
    )

    def __init__(self, req_id, x, slots, deadline_ms, enqueue_t):
        self.id = req_id
        self.x = x
        self.rows = int(x.shape[0])
        self.slots = int(slots)
        self.deadline_ms = deadline_ms
        self.enqueue_t = enqueue_t
        self.dispatch_t = None
        self.complete_t = None
        self.result = None  # (rows, out_dim) softmax probabilities; only "ok"
        self.verdict = "queued"  # -> one of TERMINAL_VERDICTS
        self.attempts = 0  # failed dispatch attempts consumed so far
        # tracing context: the chain id minted at submit (or carried in),
        # the incoming parent span id, and the last span this engine emitted
        self.trace_id = None
        self.trace_parent = None
        self.last_span_id = None

    @property
    def latency_s(self):
        """enqueue -> complete wall seconds (None until completed)."""
        if self.complete_t is None:
            return None
        return self.complete_t - self.enqueue_t

    @property
    def queue_s(self):
        """enqueue -> dispatch wall seconds (None until dispatched)."""
        if self.dispatch_t is None:
            return None
        return self.dispatch_t - self.enqueue_t

    def slo_ok(self, slo_ms=None):
        """Did this request meet its deadline (its own tag, else the
        engine-level SLO)? None when neither exists or it never completed."""
        bound = self.deadline_ms if self.deadline_ms is not None else slo_ms
        if bound is None or self.latency_s is None:
            return None
        return self.latency_s <= bound / 1000.0


class ServingEngine:
    """Continuous-batching serving loop over a session's slot forwards.

    ``session``: a port ``TrainingSession`` on any layout (its
    ``slot_rows`` / ``slot_ladder`` fix the dispatch geometry).
    ``max_slots``: packing capacity per dispatch (default: the ladder's top
    rung). ``slo_ms``: the latency objective for requests without a
    deadline of their own. ``max_queue``: admission bound — submissions
    beyond it are DROPPED (recorded, verdict "dropped"); None = unbounded.
    ``metrics``: a recorder (None = ``NullMetrics``). ``clock`` is
    injectable for tests; ``depth_ring`` bounds the queue-depth ring.

    Fault tolerance (module docstring): ``retry`` is the per-request
    dispatch budget — an int (total attempts, no backoff) or a
    ``retry.RetryPolicy``; ``breaker_threshold`` consecutive failed
    dispatches open the breaker; ``reload_dir`` names the step-checkpoint
    directory ``reload()``/``watch_reload()`` restore verified weights from
    (``loaded_step`` seeds the watcher's freshness floor);
    ``shed_on_submit`` turns the analytical-wait deadline estimate into
    admission backpressure; ``faults`` is a chaos plan (spec string /
    ``FaultPlan``; only ``@dispatch=`` anchors are consulted here; None =
    the ``SHALLOWSPEED_FAULTS`` environment plan, like the session);
    ``dispatch_floor_ms`` the per-dispatch service-time floor; ``tracer``
    a ``tracing.Tracer`` (default: one on ``metrics``, process ``"e"``).

    Live telemetry: ``telemetry_window_s`` sets the tumbling rollup width;
    ``knee_rps`` (a MEASURED ``bench_serving`` sweep result) arms the
    knee-proximity alert rule; ``alert_rules`` overrides the default rule
    set (``[]`` disables alerting); ``alert_sinks`` is the
    ``slo.AlertSink`` consumer list; ``replica_id`` tags this engine's
    rollup/alert records.
    """

    def __init__(
        self,
        session,
        max_slots=None,
        slo_ms=None,
        max_queue=None,
        metrics=None,
        clock=time.perf_counter,
        depth_ring=4096,
        retry=2,
        breaker_threshold=3,
        reload_dir=None,
        loaded_step=None,
        shed_on_submit=False,
        faults=None,
        dispatch_floor_ms=0.0,
        tracer=None,
        telemetry_window_s=1.0,
        knee_rps=None,
        alert_rules=None,
        alert_sinks=(),
        replica_id=None,
    ):
        self._session = session
        self._slot_rows = session.slot_rows
        self._ladder = session.slot_ladder
        self._max_slots = (
            int(max_slots) if max_slots is not None else self._ladder[-1]
        )
        if self._max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self._max_slots > self._ladder[-1]:
            raise ValueError(
                f"max_slots {self._max_slots} exceeds the slot ladder's top "
                f"rung {self._ladder[-1]} — extend the ladder instead"
            )
        self._slo_ms = slo_ms
        self._max_queue = max_queue
        self._metrics = metrics if metrics is not None else NullMetrics()
        self.clock = clock
        if isinstance(retry, R.RetryPolicy):
            self._retry = retry
        else:
            self._retry = R.RetryPolicy(attempts=int(retry), base=0.0, jitter=0)
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self._breaker_threshold = int(breaker_threshold)
        self._reload_dir = reload_dir
        self._loaded_step = loaded_step  # watcher freshness floor
        self._shed_on_submit = bool(shed_on_submit)
        if dispatch_floor_ms < 0:
            raise ValueError("dispatch_floor_ms must be >= 0")
        self._dispatch_floor_s = float(dispatch_floor_ms) / 1000.0
        self._faults = F.make_plan(faults)
        self._tracer = (
            tracer if tracer is not None else Tracer(self._metrics, process="e")
        )
        self._telemetry = LiveTelemetry(
            "serving",
            metrics=self._metrics,
            window_s=telemetry_window_s,
            rules=alert_rules,
            sinks=alert_sinks,
            replica_id=replica_id,
            slo_ms=slo_ms,
            knee_rps=knee_rps,
        )
        self._latency_floor = None  # lazy: inference_latency_bound seconds
        # sequential sessions dispatch only the OCCUPIED slots; mesh
        # dispatches pay the rung program's full slot count
        self._sequential = bool(getattr(session, "sequential", False))
        self._queue = deque()
        self._next_id = 0
        # attempted-dispatch sequence (failures included): the counter the
        # chaos plan's @dispatch= anchors key off
        self._dispatch_seq = 0
        # breaker state (operational — survives reset_stats)
        self._consecutive_failures = 0
        self._degraded = False
        self._breaker_opened_t = None
        self._depths = deque(maxlen=int(depth_ring))  # (t, queue depth)
        self._samples = []  # (latency_s, queue_s, deadline_ms) per "ok"
        self._window = ThroughputWindow()
        self._dropped = 0
        self._expired = 0
        self._errors = 0
        self._unhealthy = 0
        self._retries = 0
        self._failed_dispatches = 0
        self._last_error = None  # the last dispatch exception, as text
        self._breaker_trips = 0
        self._reloads = 0
        self._last_recovery_s = None
        self._dispatches = 0
        self._slots_dispatched = 0  # dispatched slots (rung-rounded on mesh)
        self._useful_rows = 0

    def warm_ladder(self, rungs=None):
        """Run one dispatch of every ladder rung before traffic arrives, so
        the first requests do not pay one-time costs (the kernel build and
        load, CUDA context and allocator warm-up, a mesh rung's program
        build) inside their latency."""
        S_rows = self._slot_rows
        in_dim = self._session.spec.sizes[0]
        for rung in rungs if rungs is not None else self._ladder:
            self._session.predict(np.zeros((rung * S_rows, in_dim), np.float32))

    # -- queue --------------------------------------------------------------

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def degraded(self):
        """True while the breaker is open: admission refused until a
        successful reload (or explicit ``close_breaker()``)."""
        return self._degraded

    @property
    def dispatch_seq(self):
        """Attempted-dispatch count so far (failures included) — the
        sequence chaos ``@dispatch=N`` anchors and drive loops key off."""
        return self._dispatch_seq

    def _record_depth(self, t):
        self._depths.append((t, len(self._queue)))
        self._metrics.gauge("serving.queue_depth", len(self._queue))
        self._telemetry.note_queue_depth(t, len(self._queue))

    def _floor_s(self):
        """The analytical per-dispatch latency floor (one
        ``inference_latency_bound`` call per engine), 0.0 while the session
        reports none (a lower bound of 0 sheds only passed deadlines)."""
        if self._latency_floor is None:
            seconds = self._session.inference_latency_bound()["seconds"]
            self._latency_floor = float(seconds) if seconds is not None else 0.0
        return self._latency_floor

    def submit(self, x, deadline_ms=None, arrival_t=None, trace=None):
        """Enqueue one request of ``(rows, in_dim)`` inputs; returns its
        ``Request``. ``arrival_t`` backdates the enqueue timestamp to the
        scheduled arrival (the coordinated-omission correction). A request
        larger than one dispatch is refused; beyond ``max_queue`` — or
        while the breaker is open — it is returned with verdict "dropped";
        under ``shed_on_submit`` a deadline the analytical wait estimate
        provably cannot meet is refused with verdict "expired".

        ``trace``: incoming trace context ``{"trace_id": ..., "parent":
        <span id>}``; without it a tracing-enabled engine mints its own
        trace id here. The queue-depth ring samples at the request's own
        timeline (the backdated ``arrival_t`` when given)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] < 1:
            raise ValueError(f"request must be (rows >= 1, in_dim), got {x.shape}")
        n_slots = serving_slots.slots_needed(x.shape[0], self._slot_rows)
        if n_slots > self._max_slots:
            raise ValueError(
                f"request of {x.shape[0]} rows needs {n_slots} slots — more "
                f"than one dispatch ({self._max_slots} slots); split it"
            )
        t = self.clock() if arrival_t is None else float(arrival_t)
        req = Request(self._next_id, x, n_slots, deadline_ms, t)
        self._next_id += 1
        if trace is not None:
            req.trace_id = trace.get("trace_id")
            req.trace_parent = trace.get("parent")
        elif self._tracer.enabled and self._tracer.terminal_ack:
            # only the request's owner mints ids (a tracer without the
            # terminal ack traces solely under shipped context)
            req.trace_id = self._tracer.new_trace(req.id)
        if self._degraded:
            req.verdict = "dropped"
            self._dropped += 1
            self._record_request(req, reason="degraded")
            self._trace_ack(req, reason="degraded")
            return req
        if self._max_queue is not None and len(self._queue) >= self._max_queue:
            req.verdict = "dropped"
            self._dropped += 1
            self._record_request(req, reason="queue_full")
            self._trace_ack(req, reason="queue_full")
            return req
        if (
            self._shed_on_submit
            and deadline_ms is not None
            and self._admission_hopeless(req, t)
        ):
            req.verdict = "expired"
            req.complete_t = self.clock()
            self._expired += 1
            self._record_request(req, reason="admission_estimate")
            self._trace_ack(req, reason="admission_estimate")
            return req
        self._queue.append(req)
        self._telemetry.note_admit(t)
        self._record_depth(t)
        return req

    def _admission_hopeless(self, req, t):
        """Provable-at-admission deadline miss: queued slots ahead need at
        least ``slots_ahead // max_slots`` whole dispatches before this
        request's own, each no faster than the analytical latency floor —
        a LOWER bound, so a True here is a certainty, not a heuristic."""
        deadline = t + req.deadline_ms / 1000.0
        slots_ahead = sum(r.slots for r in self._queue)
        floor = self._floor_s()
        min_complete = (
            self.clock() + (slots_ahead // self._max_slots) * floor + floor
        )
        return min_complete > deadline

    def _deadline_hopeless(self, req, now):
        """Pack-time shed test: the deadline already passed, or even a
        dispatch starting NOW cannot beat the analytical floor to it."""
        if req.deadline_ms is None:
            return False
        deadline = req.enqueue_t + req.deadline_ms / 1000.0
        return now >= deadline or now + self._floor_s() > deadline

    # -- continuous batching ------------------------------------------------

    def step(self):
        """Pack the queue's head into the next dispatch and run it; returns
        the completed requests ([] when the queue is empty).

        Packing is FIFO and slot-granular: requests join until the next one
        would overflow ``max_slots``, and every request's rows land in its
        OWN slots — why each response is bitwise-equal to a direct
        ``predict()`` of the same rows.

        Failure semantics: expired head requests are shed before costing a
        slot; a dispatch exception re-queues the popped batch at the HEAD
        in original order under the retry budget (exhausted: "error");
        non-finite predictions complete as "unhealthy". A chaos ``die``
        fault (mode=exc) raises ``InjectedFault`` BEFORE any request is
        popped — the queue is intact when the operator loop catches it and
        re-enters; ``slow`` and ``nan`` fire inside the dispatch, and
        ``error`` raises inside the dispatch wrapper."""
        if not self._queue:
            return []
        t_d = self.clock()
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        # chaos faults anchored at (or before — a same-dispatch die may have
        # consumed an anchor) this attempted dispatch, in spec order
        pending_faults = self._faults.due_at_dispatch(seq)
        for f in pending_faults:
            if f.kind == "die":
                self._record_health("fault_injected", dispatch=seq, fault=repr(f))
                self._metrics.flush()
                self._faults.fire_die(f)  # sigkill never returns; exc raises
        done = []
        batch, used = [], 0
        while self._queue:
            head = self._queue[0]
            if self._deadline_hopeless(head, t_d):
                self._queue.popleft()
                self._complete_terminal(head, "expired", t_d, reason="deadline")
                self._trace_queue_only(head, t_d, reason="deadline")
                done.append(head)
                continue
            if batch and used + head.slots > self._max_slots:
                break
            self._queue.popleft()
            head.dispatch_t = t_d
            batch.append(head)
            used += head.slots
        if not batch:  # everything at the head was shed
            self._record_depth(t_d)
            return done
        rung = serving_slots.rung_for(used, self._ladder)
        S_rows = self._slot_rows
        flat = np.concatenate(
            [
                np.pad(r.x, ((0, r.slots * S_rows - r.rows), (0, 0)))
                for r in batch
            ],
            axis=0,
        )
        t_pack = self.clock()  # pack span boundary: slots packed + padded
        try:
            for f in pending_faults:
                if f.fired:
                    continue
                f.fired = True
                self._record_health("fault_injected", dispatch=seq, fault=repr(f))
                if f.kind == "slow":
                    time.sleep(f.ms / 1000.0)
                elif f.kind == "nan":
                    self._session.poison_weights()
                elif f.kind == "error":
                    raise F.InjectedFault(f"injected fault: {f!r}")
            # the session pads the tail up to the rung and dispatches — the
            # same call path predict() takes; host numpy out, so the device
            # work is done when it returns
            preds = self._session.predict(flat)
        except Exception as e:  # noqa: BLE001 — ANY dispatch failure recovers
            self._last_error = f"{type(e).__name__}: {e}"[:200]
            done.extend(self._recover_failed_dispatch(batch, seq, e))
            self._record_depth(self.clock())
            return done
        if self._dispatch_floor_s:
            spent = self.clock() - t_d
            if spent < self._dispatch_floor_s:
                time.sleep(self._dispatch_floor_s - spent)
        t_preds = self.clock()  # dispatch span boundary: forward done
        t_c = self.clock()
        off = 0
        any_unhealthy = False
        for r in batch:
            result = preds[off : off + r.rows]
            off += r.slots * S_rows
            # health gate: a non-finite slice must never be served as "ok"
            if not np.isfinite(result).all():
                any_unhealthy = True
                self._complete_terminal(r, "unhealthy", t_c)
                self._trace_dispatch_chain(r, t_d, t_pack, t_preds, rung)
                done.append(r)
                continue
            r.result = result
            r.complete_t = t_c
            r.verdict = "ok"
            self._record_request(r)
            self._trace_dispatch_chain(r, t_d, t_pack, t_preds, rung)
            done.append(r)
            self._samples.append((r.latency_s, r.queue_s, r.deadline_ms))
            self._window.note_enqueue(r.enqueue_t)
            self._window.note_complete(t_c)
            self._useful_rows += r.rows
            # recovery time: breaker opened, then a response served again
            if self._breaker_opened_t is not None and not self._degraded:
                self._last_recovery_s = t_c - self._breaker_opened_t
                self._breaker_opened_t = None
        self._dispatches += 1
        self._slots_dispatched += used if self._sequential else rung
        if any_unhealthy:
            self._record_health(
                "unhealthy_dispatch",
                dispatch=seq,
                consecutive_failures=self._consecutive_failures + 1,
            )
            self._note_failure(seq)
        else:
            self._consecutive_failures = 0
        self._record_depth(t_c)
        return done

    def _recover_failed_dispatch(self, batch, seq, exc):
        """Re-queue the popped batch at the queue HEAD in its original order
        (the retried dispatch serves bitwise-identical responses) under the
        per-request retry budget; exhausted requests complete as "error".
        Nothing ever vanishes with verdict "queued"."""
        self._failed_dispatches += 1
        t = self.clock()
        terminal, keep = [], []
        for r in batch:
            r.dispatch_t = None
            r.attempts += 1
            if self._retry.exhausted(r.attempts):
                self._complete_terminal(
                    r, "error", t, reason=f"{type(exc).__name__}: {exc}"[:200]
                )
                self._trace_queue_only(r, t, reason=f"{type(exc).__name__}"[:80])
                terminal.append(r)
            else:
                keep.append(r)
        for r in reversed(keep):  # head insertion preserves original order
            self._queue.appendleft(r)
        self._retries += len(keep)
        self._record_health(
            "dispatch_error",
            dispatch=seq,
            error=f"{type(exc).__name__}: {exc}"[:200],
            requeued=len(keep),
            exhausted=len(terminal),
            consecutive_failures=self._consecutive_failures + 1,
        )
        self._note_failure(seq)
        if keep and self._retry.base:
            # the shared backoff schedule, opt-in (base > 0)
            time.sleep(self._retry.delay(min(r.attempts for r in keep) - 1))
        return terminal

    def _note_failure(self, seq):
        """One failed dispatch toward the breaker; at the threshold the
        engine degrades (refuses admission) and — with a reload directory
        configured — attempts the hot weight reload recovery needs."""
        self._consecutive_failures += 1
        if (
            not self._degraded
            and self._consecutive_failures >= self._breaker_threshold
        ):
            self._degraded = True
            self._breaker_trips += 1
            self._breaker_opened_t = self.clock()
            self._record_health(
                "breaker_open",
                dispatch=seq,
                consecutive_failures=self._consecutive_failures,
            )
            self._metrics.flush()
            if self._reload_dir is not None:
                self._try_reload(reason="breaker")

    # -- hot weight reload ---------------------------------------------------

    def reload(self, path=None, reason="manual", verified=None, verify_s=None):
        """Hot-swap the served weights from ``path`` (default: the newest
        VERIFYING snapshot in ``reload_dir`` via ``find_latest_good`` —
        including the one already loaded, whose in-memory copy may be
        poisoned). The queue is untouched; every response dispatched after
        the swap is bitwise-equal to a direct ``predict()`` under the new
        weights, and the cached rung programs survive (same shapes). A
        successful reload closes the breaker. Raises
        ``CheckpointError``/``ValueError`` when the swap is impossible (no
        snapshot verifies, sizes differ); returns the checkpoint's metadata.

        Single verified read: discovery reads each candidate WITH its
        arrays and the swap assembles exactly those bytes, so the snapshot
        is read and checksummed once; the discovery's time is recorded as
        ``verify_s`` in the ``reload`` record. ``verified``/``verify_s``: a
        caller (``watch_reload``) that already ran a verified discovery
        passes its result through — ``wall_s`` stays end-to-end either
        way."""
        t0 = self.clock()
        pre_verified_s = verify_s or 0.0  # discovery ran before t0
        step = None
        if path is None:
            if self._reload_dir is None:
                raise ValueError(
                    "reload() needs a path, or a reload_dir on the engine"
                )
            tv = self.clock()
            found, meta, arrays, skipped = find_latest_good(
                self._reload_dir, with_arrays=True
            )
            verify_s = self.clock() - tv
            pre_verified_s = 0.0  # this discovery is inside t0's window
            if found is None:
                raise CheckpointError(
                    self._reload_dir,
                    "no snapshot verifies for hot reload: "
                    + ("; ".join(f"{p.name}: {c}" for p, c in skipped) or "empty"),
                )
            path = found
            step = meta.get("global_step")
            verified = (meta, arrays)
        if verified is not None:
            # the verified arrays are in memory: the swap is pure assembly
            meta = self._session.load_weights(path, verified=verified)
        else:
            # explicit-path reload: ONE read+verify through the loader;
            # transient read errors retry, corruption surfaces
            meta = R.retry_call(
                lambda: self._session.load_weights(path),
                attempts=2,
                retry_on=(OSError,),
            )
        wall = self.clock() - t0 + pre_verified_s
        if step is None:
            step = meta.get("global_step")
        if step is not None:
            self._loaded_step = int(step)
        self._reloads += 1
        self._metrics.reload(
            "ok",
            path=str(path),
            step=step,
            reason=reason,
            wall_s=wall,
            verify_s=verify_s,
            programs_cached=len(getattr(self._session, "_predict_cache", ())),
        )
        self.close_breaker()
        return meta

    def _try_reload(self, reason):
        """Best-effort internal reload (breaker trigger): a failure is
        recorded — the engine stays degraded — never raised into the
        serving loop."""
        try:
            self.reload(reason=reason)
        except (CheckpointError, ValueError, OSError) as e:
            self._metrics.reload(
                "failed", path=str(self._reload_dir), reason=reason,
                error=str(e)[:200],
            )
            self._metrics.flush()

    def watch_reload(self):
        """The checkpoint-dir watcher leg: pick up a snapshot STRICTLY
        newer than the one served (``find_newer_good``) and hot-swap it.
        Returns the new global step, or None when nothing newer verifies
        (newer-but-corrupt candidates are recorded). A failed swap is
        recorded and the engine keeps serving the weights it has."""
        if self._reload_dir is None:
            raise ValueError("watch_reload() needs a reload_dir on the engine")
        tv = self.clock()
        step, path, meta, arrays, skipped = find_newer_good(
            self._reload_dir, than_step=self._loaded_step, with_arrays=True
        )
        verify_s = self.clock() - tv
        if path is None:
            if skipped:
                self._metrics.reload(
                    "none_newer",
                    path=str(self._reload_dir),
                    reason="watch",
                    verify_s=verify_s,
                    skipped=[{"path": str(p), "cause": c} for p, c in skipped],
                )
            return None
        try:
            self.reload(
                path=path, reason="watch", verified=(meta, arrays),
                verify_s=verify_s,
            )
        except (CheckpointError, ValueError, OSError) as e:
            self._metrics.reload(
                "failed", path=str(path), reason="watch", error=str(e)[:200],
            )
            self._metrics.flush()
            return None
        self._loaded_step = int(step)
        return int(step)

    def close_breaker(self):
        """Re-admit traffic after recovery (``reload()`` calls this on
        success; an operator may close it after an external fix). The
        open-timestamp survives until the next served response, so
        ``recovery_s`` measures breaker-open -> first "ok"."""
        self._consecutive_failures = 0
        if self._degraded:
            self._degraded = False
            self._record_health(
                "breaker_closed", dispatch=self._dispatch_seq,
                consecutive_failures=0,
            )

    def drain(self):
        """Serve until the queue is empty; returns everything completed.
        Bounded: every queued request completes or exhausts its finite
        retry budget."""
        done = []
        while self._queue:
            done.extend(self.step())
        return done

    def _complete_terminal(self, req, verdict, t, reason=None):
        """Complete ``req`` with a non-"ok" terminal verdict + accounting."""
        req.verdict = verdict
        req.complete_t = t
        if verdict == "expired":
            self._expired += 1
        elif verdict == "error":
            self._errors += 1
        elif verdict == "unhealthy":
            self._unhealthy += 1
        self._record_request(req, reason=reason)

    def _record_request(self, req, reason=None):
        fields = dict(
            id=req.id,
            rows=req.rows,
            slots=req.slots,
            enqueue_ts=req.enqueue_t,
            dispatch_ts=req.dispatch_t,
            complete_ts=req.complete_t,
            latency_s=req.latency_s,
            queue_s=req.queue_s,
            deadline_ms=req.deadline_ms,
            slo_ok=req.slo_ok(self._slo_ms),
            attempts=req.attempts,
        )
        if req.trace_id is not None:
            fields["trace_id"] = req.trace_id  # the join key to its chain
        if reason is not None:
            fields["reason"] = reason
        self._metrics.request(req.verdict, **fields)
        # one telemetry sample per terminal verdict — the choke point every
        # terminal path crosses
        t = req.complete_t if req.complete_t is not None else req.enqueue_t
        self._telemetry.note_request(
            t, req.verdict, latency_s=req.latency_s, queue_s=req.queue_s
        )

    # -- tracing (schema v10; module docstring span taxonomy) ---------------

    def _trace_dispatch_chain(self, req, t_d, t_pack, t_preds, rung):
        """The dispatched request's chain: worker.queue -> pack -> dispatch
        -> verify (the finiteness gate), then the terminal ack."""
        if req.trace_id is None:
            return
        tr = self._tracer
        wq = tr.span(
            "worker.queue", req.trace_id, req.enqueue_t, t_d,
            parent=req.trace_parent,
        )
        pk = tr.span("pack", req.trace_id, t_d, t_pack, parent=wq)
        dp = tr.span(
            "dispatch", req.trace_id, t_pack, t_preds, parent=pk,
            rung=rung, slots=req.slots,
        )
        req.last_span_id = tr.span(
            "verify", req.trace_id, t_preds, req.complete_t, parent=dp,
            healthy=req.verdict != "unhealthy",
        )
        self._trace_ack(req)

    def _trace_queue_only(self, req, t, reason=None):
        """A request that terminated without a dispatch of its own (shed at
        pack time, retry budget exhausted): its chain is the queue wait
        plus the terminal ack."""
        if req.trace_id is None:
            return
        req.last_span_id = self._tracer.span(
            "worker.queue", req.trace_id, req.enqueue_t, t,
            parent=req.trace_parent, reason=reason,
        )
        self._trace_ack(req)

    def _trace_ack(self, req, reason=None):
        """The terminal span (engines whose tracer owns the terminal ack)."""
        if req.trace_id is None or not self._tracer.terminal_ack:
            return
        t = req.complete_t if req.complete_t is not None else self.clock()
        self._tracer.span(
            "ack", req.trace_id, t, t,
            parent=req.last_span_id or req.trace_parent,
            terminal=True, verdict=req.verdict,
            deadline_ms=req.deadline_ms, reason=reason,
        )

    def _record_health(self, name, **fields):
        self._metrics.serving_health(name, **fields)
        self._telemetry.note_health(self.clock(), name, **fields)

    # -- accounting ---------------------------------------------------------

    def status(self):
        """The LIVE snapshot: operational state + the current/last rollup
        window + active alerts — cheap, JSON-able, callable mid-traffic."""
        return {
            "queue_depth": len(self._queue),
            "degraded": self._degraded,
            "dispatch_seq": self._dispatch_seq,
            "dispatches": self._dispatches,
            "consecutive_failures": self._consecutive_failures,
            "breaker_trips": self._breaker_trips,
            "reloads": self._reloads,
            "loaded_step": self._loaded_step,
            "alerts_active": self._telemetry.evaluator.active(),
            "telemetry": self._telemetry.snapshot(),
        }

    def stats(self):
        """Aggregate accounting over everything served since the last
        ``reset_stats()``: the field set of the ``serving`` summary record
        (plain scalars), plus ``last_error``, the last dispatch exception's
        text. Percentiles and the window cover "ok" completions;
        ``availability`` = ok / all-terminal."""
        lats = [lat for lat, _, _ in self._samples]
        queues = [q for _, q, _ in self._samples]
        # per-request deadline tag wins over the engine SLO; with neither,
        # the verdict is None — Request.slo_ok's semantics
        slo_flags = []
        for lat, _, dl in self._samples:
            bound = dl if dl is not None else self._slo_ms
            slo_flags.append(
                None if bound is None or lat is None else lat <= bound / 1000.0
            )
        window = self._window.window_s
        padded_rows = self._slots_dispatched * self._slot_rows
        depths = [d for _, d in self._depths]
        met = sum(1 for ok in slo_flags if ok)
        scored = any(ok is not None for ok in slo_flags)
        ok_n = len(self._samples)
        terminal = (
            ok_n + self._dropped + self._expired + self._errors
            + self._unhealthy
        )
        return {
            "completed": ok_n,
            "dropped": self._dropped,
            "expired": self._expired,
            "errors": self._errors,
            "unhealthy": self._unhealthy,
            "retries": self._retries,
            "failed_dispatches": self._failed_dispatches,
            "last_error": self._last_error,
            "breaker_trips": self._breaker_trips,
            "reloads": self._reloads,
            "degraded": self._degraded,
            "recovery_s": self._last_recovery_s,
            "availability": (ok_n / terminal) if terminal else None,
            "dispatches": self._dispatches,
            "slots_dispatched": self._slots_dispatched,
            "useful_rows": self._useful_rows,
            "padding_waste": (
                1.0 - self._useful_rows / padded_rows if padded_rows else None
            ),
            "p50_latency_s": percentile(lats, 50),
            "p99_latency_s": percentile(lats, 99),
            "max_latency_s": max(lats) if lats else None,
            "mean_queue_s": (sum(queues) / len(queues)) if queues else None,
            "window_s": window,
            "achieved_rps": (len(self._samples) / window if window else None),
            # goodput: completions that met their deadline/SLO per second of
            # the window (None when no threshold exists — an unmeasured
            # goodput must not read as a perfect one)
            "goodput_rps": (met / window if window and scored else None),
            "slo_ms": self._slo_ms,
            "slo_met": met if scored else None,
            "queue_depth_max": max(depths) if depths else 0,
            "queue_depth_mean": (sum(depths) / len(depths) if depths else 0.0),
        }

    def record_summary(self, offered_rps=None, name="summary"):
        """Emit (and return) the ``serving`` summary record: ``stats()``
        (without ``last_error``, as the JAX engine's record) plus the
        offered load and the analytical latency floor
        (``costmodel.serving_latency_bound``; ``None`` seconds where no
        peak is known). The live-telemetry window still open is flushed
        first, so the trailing ``rollup`` record lands before the summary."""
        self._telemetry.flush()
        rec = self.stats()
        del rec["last_error"]
        rec["offered_rps"] = offered_rps
        rec["slot_rows"] = self._slot_rows
        rec["max_slots"] = self._max_slots
        bound = self._session.inference_latency_bound()
        rec["latency_bound_s"] = bound["seconds"]
        rec["latency_bound_ticks"] = bound["ticks"]
        rec["latency_bound_source"] = bound["peak_source"]
        self._metrics.serving(name, **rec)
        return rec

    def reset_stats(self):
        """Clear the accounting (the bench sweep's per-rate boundary);
        queued requests and the OPERATIONAL breaker/watcher state (degraded
        flag, consecutive failures, loaded step, dispatch sequence) are
        unaffected."""
        self._samples = []
        self._window.reset()
        self._depths.clear()
        self._dropped = 0
        self._expired = 0
        self._errors = 0
        self._unhealthy = 0
        self._retries = 0
        self._failed_dispatches = 0
        self._last_error = None
        self._breaker_trips = 0
        self._reloads = 0
        self._last_recovery_s = None
        self._dispatches = 0
        self._slots_dispatched = 0
        self._useful_rows = 0
