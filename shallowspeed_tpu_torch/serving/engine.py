"""Inference serving engine: request queue + continuous batching into slots.

The core of ``shallowspeed_tpu/serving/engine.py``'s ``ServingEngine``, on
the port's ``TrainingSession``:

- **queue**: deadline-tagged requests of variable row counts, FIFO
  (packing is order-preserving, so responses complete in arrival order);
- **continuous batching**: each ``step()`` packs the queue's head into the
  next dispatch — whole ``slot_rows``-row slots per request (requests never
  share a slot), up to ``max_slots`` slots;
- **bitwise parity**: every slot runs the same fixed-shape forward, and the
  CUDA kernel sums each output in one fixed order, so each response is
  bitwise-equal to a direct ``session.predict()`` of the same rows;
- **graceful degradation**: every submitted request reaches exactly one
  terminal verdict (``TERMINAL_VERDICTS``). A raised dispatch re-queues
  the popped batch at the queue HEAD in its original order under a bounded
  per-request ``RetryPolicy`` budget (exhausted: ``"error"``); a head
  request whose deadline has passed is shed as ``"expired"`` before costing
  a slot; every dispatch's predictions are finiteness-checked per request
  (non-finite: ``"unhealthy"``, no result); ``breaker_threshold``
  consecutive failed dispatches open the breaker, which refuses admission
  (``"dropped"``) until ``close_breaker()``.

Metrics/JSONL records, tracing, live telemetry, hot reload and chaos
faults of the JAX engine are not ported yet. The engine keeps only scalar
samples between dispatches; completed ``Request`` objects go back to the
caller.
"""

import time
from collections import deque

import numpy as np

from shallowspeed_tpu_torch import retry as R
from shallowspeed_tpu_torch.observability.stats import ThroughputWindow, percentile
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

    ``session``: a port ``TrainingSession`` (its ``slot_rows`` /
    ``slot_ladder`` fix the dispatch geometry). ``max_slots``: packing
    capacity per dispatch (default: the ladder's top rung). ``slo_ms``: the
    latency objective for requests without a deadline of their own.
    ``retry``: an int (total attempts, no backoff) or a ``RetryPolicy``.
    ``breaker_threshold``: consecutive failed dispatches that open the
    breaker. ``clock`` is injectable for tests."""

    def __init__(
        self,
        session,
        max_slots=None,
        slo_ms=None,
        clock=time.perf_counter,
        retry=2,
        breaker_threshold=3,
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
        self.clock = clock
        if isinstance(retry, R.RetryPolicy):
            self._retry = retry
        else:
            self._retry = R.RetryPolicy(attempts=int(retry), base=0.0, jitter=0)
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self._breaker_threshold = int(breaker_threshold)
        self._latency_floor = None  # lazy: inference_latency_bound seconds
        self._queue = deque()
        self._next_id = 0
        self._consecutive_failures = 0
        self._degraded = False
        self._breaker_opened_t = None
        self._depths = deque(maxlen=4096)  # (t, queue depth), a bounded ring
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
        self._last_recovery_s = None
        self._dispatches = 0
        self._slots_dispatched = 0
        self._useful_rows = 0

    def warm_ladder(self, rungs=None):
        """Run one dispatch of every ladder rung before traffic arrives, so
        the first requests do not pay one-time costs (the kernel build and
        load, CUDA context and allocator warm-up) inside their latency."""
        S_rows = self._slot_rows
        in_dim = self._session.spec.sizes[0]
        for rung in rungs if rungs is not None else self._ladder:
            self._session.predict(np.zeros((rung * S_rows, in_dim), np.float32))

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def degraded(self):
        """True while the breaker is open (admission refused)."""
        return self._degraded

    def _record_depth(self, t):
        self._depths.append((t, len(self._queue)))

    def _floor_s(self):
        """The analytical per-dispatch latency floor, 0.0 while the session
        reports none (a lower bound of 0 sheds only passed deadlines)."""
        if self._latency_floor is None:
            seconds = self._session.inference_latency_bound()["seconds"]
            self._latency_floor = float(seconds) if seconds is not None else 0.0
        return self._latency_floor

    def submit(self, x, deadline_ms=None, arrival_t=None):
        """Enqueue one request of ``(rows, in_dim)`` inputs; returns its
        ``Request``. ``arrival_t`` backdates the enqueue timestamp to the
        scheduled arrival (the coordinated-omission correction). A request
        larger than one dispatch is refused; while the breaker is open it
        is returned with verdict "dropped"."""
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
        if self._degraded:
            req.verdict = "dropped"
            self._dropped += 1
            return req
        self._queue.append(req)
        self._record_depth(t)
        return req

    def _deadline_hopeless(self, req, now):
        """Pack-time shed test: the deadline already passed, or even a
        dispatch starting NOW cannot beat the analytical floor to it."""
        if req.deadline_ms is None:
            return False
        deadline = req.enqueue_t + req.deadline_ms / 1000.0
        return now >= deadline or now + self._floor_s() > deadline

    def step(self):
        """Pack the queue's head into the next dispatch and run it; returns
        the completed requests ([] when the queue is empty).

        Packing is FIFO and slot-granular: requests join until the next one
        would overflow ``max_slots``, and every request's rows land in its
        OWN slots — why each response is bitwise-equal to a direct
        ``predict()`` of the same rows."""
        if not self._queue:
            return []
        t_d = self.clock()
        done = []
        batch, used = [], 0
        while self._queue:
            head = self._queue[0]
            if self._deadline_hopeless(head, t_d):
                self._queue.popleft()
                self._complete_terminal(head, "expired", t_d)
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
        S_rows = self._slot_rows
        flat = np.concatenate(
            [
                np.pad(r.x, ((0, r.slots * S_rows - r.rows), (0, 0)))
                for r in batch
            ],
            axis=0,
        )
        try:
            preds = self._session.predict(flat)
        except Exception as e:  # noqa: BLE001 — ANY dispatch failure recovers
            self._last_error = f"{type(e).__name__}: {e}"[:200]
            done.extend(self._recover_failed_dispatch(batch))
            self._record_depth(self.clock())
            return done
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
                done.append(r)
                continue
            r.result = result
            r.complete_t = t_c
            r.verdict = "ok"
            done.append(r)
            self._samples.append((r.latency_s, r.queue_s, r.deadline_ms))
            self._window.note_enqueue(r.enqueue_t)
            self._window.note_complete(t_c)
            self._useful_rows += r.rows
            if self._breaker_opened_t is not None and not self._degraded:
                self._last_recovery_s = t_c - self._breaker_opened_t
                self._breaker_opened_t = None
        self._dispatches += 1
        # the sequential session runs exactly the occupied slots
        self._slots_dispatched += used
        if any_unhealthy:
            self._note_failure()
        else:
            self._consecutive_failures = 0
        self._record_depth(t_c)
        return done

    def _recover_failed_dispatch(self, batch):
        """Re-queue the popped batch at the queue HEAD in its original order
        under the per-request retry budget; exhausted requests complete as
        "error". Nothing ever vanishes with verdict "queued"."""
        self._failed_dispatches += 1
        t = self.clock()
        terminal, keep = [], []
        for r in batch:
            r.dispatch_t = None
            r.attempts += 1
            if self._retry.exhausted(r.attempts):
                self._complete_terminal(r, "error", t)
                terminal.append(r)
            else:
                keep.append(r)
        for r in reversed(keep):  # head insertion preserves original order
            self._queue.appendleft(r)
        self._retries += len(keep)
        self._note_failure()
        if keep and self._retry.base:
            time.sleep(self._retry.delay(min(r.attempts for r in keep) - 1))
        return terminal

    def _note_failure(self):
        """One failed dispatch toward the breaker; at the threshold the
        engine degrades and refuses admission."""
        self._consecutive_failures += 1
        if (
            not self._degraded
            and self._consecutive_failures >= self._breaker_threshold
        ):
            self._degraded = True
            self._breaker_trips += 1
            self._breaker_opened_t = self.clock()

    def close_breaker(self):
        """Re-admit traffic after an external fix. The open-timestamp
        survives until the next served response, so ``recovery_s`` measures
        breaker-open -> first "ok"."""
        self._consecutive_failures = 0
        self._degraded = False

    def drain(self):
        """Serve until the queue is empty; returns everything completed.
        Bounded: every queued request completes or exhausts its finite
        retry budget."""
        done = []
        while self._queue:
            done.extend(self.step())
        return done

    def _complete_terminal(self, req, verdict, t):
        """Complete ``req`` with a non-"ok" terminal verdict + accounting."""
        req.verdict = verdict
        req.complete_t = t
        if verdict == "expired":
            self._expired += 1
        elif verdict == "error":
            self._errors += 1
        elif verdict == "unhealthy":
            self._unhealthy += 1

    def stats(self):
        """Aggregate accounting over everything served: the field set of the
        JAX engine's ``serving`` summary (plain scalars). Percentiles and the
        window cover "ok" completions; ``availability`` = ok / all-terminal."""
        lats = [lat for lat, _, _ in self._samples]
        queues = [q for _, q, _ in self._samples]
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
            # the window (None when no threshold exists)
            "goodput_rps": (met / window if window and scored else None),
            "slo_ms": self._slo_ms,
            "slo_met": met if scored else None,
            "queue_depth_max": max(depths) if depths else 0,
            "queue_depth_mean": (sum(depths) / len(depths) if depths else 0.0),
        }

    def record_summary(self, offered_rps=None):
        """Return the summary record: ``stats()`` plus the offered load and
        the session's analytical latency floor (``None`` / ``"unmeasured"``
        until the port has an H100 cost model)."""
        rec = self.stats()
        rec["offered_rps"] = offered_rps
        rec["slot_rows"] = self._slot_rows
        rec["max_slots"] = self._max_slots
        bound = self._session.inference_latency_bound()
        rec["latency_bound_s"] = bound["seconds"]
        rec["latency_bound_ticks"] = bound["ticks"]
        rec["latency_bound_source"] = bound["peak_source"]
        return rec
