"""Structured metrics recording: counters, gauges, timers, histograms, JSONL.

Copied from ``shallowspeed_tpu/observability/metrics.py``: the same schema
(v13, schema name ``shallowspeed_tpu.metrics``) and record shapes, so the
JAX package's report, watch and divergence CLIs read the port's files and
the port's CLIs read the JAX package's. The one jax-adjacent line differs:
the multi-process shard suffix asks ``torch.distributed``, not
``jax.process_count()`` (``_shard_path``).

Three recorders share one surface:

- ``NullMetrics``     the default everywhere a ``metrics=`` hook exists.
                      Every method is a no-op and the hot-path methods
                      (``counter``/``gauge``/``observe``/``timer``/``span``)
                      allocate nothing — recording disabled must cost nothing
                      measurable inside a training loop (tested:
                      tests/test_observability.py asserts zero net
                      allocations over thousands of calls).
- ``MetricsRecorder`` in-memory aggregation (counter sums, last-value
                      gauges, per-name histogram samples) with a
                      ``summary()`` snapshot — the base class; also directly
                      useful in tests and benchmarks.
- ``JsonlMetrics``    MetricsRecorder + a versioned JSONL sink: one
                      self-describing JSON object per line, schema pinned by
                      ``SCHEMA_VERSION`` and stamped both in the header
                      record and in every record's ``"v"`` field, so a
                      consumer can hard-fail on records it doesn't
                      understand instead of misreading them (the BENCH_r0x
                      lesson: unlabeled records cost more than no records).

Record shapes (all lines share ``v``/``ts``/``kind``/``name``):

    {"v": 2, "ts": ..., "kind": "meta",      "name": "metrics",
     "schema": "shallowspeed_tpu.metrics", "created": "..."}
    {"v": 2, "ts": ..., "kind": "counter",   "name": ..., "value": total,
     "inc": delta}
    {"v": 2, "ts": ..., "kind": "gauge",     "name": ..., "value": ...}
    {"v": 2, "ts": ..., "kind": "histogram", "name": ..., "value": sample}
    {"v": 2, "ts": ..., "kind": "timer",     "name": ..., "seconds": ...}
    {"v": 2, "ts": ..., "kind": "span",      "name": ..., "path": "a/b",
     "depth": n, "seconds": ...}
    {"v": 2, "ts": ..., "kind": "event",     "name": ..., **fields}
    {"v": 2, "ts": ..., "kind": "step",      "name": ..., "step": i,
     "epoch": e, "loss": ..., "grad_norm": ..., "param_norm": ...}   [v2+]
    {"v": 2, "ts": ..., "kind": "health",    "name": <check>, "epoch": e,
     "step": i|null, "action": "record"|"warn"|"halt", **finding}    [v2+]
    {"v": 3, "ts": ..., "kind": "xla_audit", "name": <program>,
     "census": {...}, "memory": {...}, "expected": {...},
     "census_ok": bool|null, **audit}                                [v3+]
    {"v": 4, "ts": ..., "kind": "checkpoint", "name": <reason>,
     "path": ..., "epoch": e, "step_in_epoch": s, "global_step": g,
     "bytes": n, "wall_s": ..., "async": bool [v8], "queue_depth": n
     [v8], "verify_s": ... [v8], "write_s": ... [v8], "queued_s": ...
     [v8]}                                                           [v4+]
    {"v": 4, "ts": ..., "kind": "recovery",  "name": <verdict>,
     "resumed_from": path|null, "epoch": e, "step_in_epoch": s,
     "global_step": g, "skipped": [...], **fields}                   [v4+]
    {"v": 5, "ts": ..., "kind": "request",   "name": <verdict: "ok"|
     "dropped"; v6 adds "expired"|"error"|"unhealthy">, "id": i,
     "rows": n, "slots": k, "enqueue_ts": ..., "dispatch_ts": ...,
     "complete_ts": ..., "latency_s": ..., "queue_s": ...,
     "deadline_ms": ..., "slo_ok": bool|null, "attempts": k [v6],
     "reason": ... [v6]}                                             [v5+]
    {"v": 5, "ts": ..., "kind": "serving",   "name": "summary",
     "completed": n, "dropped": n, "offered_rps": ..., "p50_latency_s":
     ..., "p99_latency_s": ..., "goodput_rps": ..., "padding_waste":
     ..., "queue_depth_max": ..., **fields}                          [v5+]
    {"v": 6, "ts": ..., "kind": "serving_health", "name": <event:
     "breaker_open"|"breaker_closed"|"unhealthy_dispatch"|
     "dispatch_error"|"fault_injected">, "dispatch": n,
     "consecutive_failures": k, **fields}                            [v6+]
    {"v": 6, "ts": ..., "kind": "reload",    "name": <verdict: "ok"|
     "failed"|"none_newer">, "path": ..., "step": ..., "reason":
     "breaker"|"watch"|"manual", "wall_s": ..., "programs_cached": n,
     **fields}                                                       [v6+]
    {"v": 7, "ts": ..., "kind": "fleet",     "name": "summary",
     "completed": n, "dropped": n, "failovers": n, "reroutes": n,
     "routing_skew": ..., "routing": {replica_id: routed},
     "per_replica": {replica_id: {...}}, **fields}                   [v7+]
    {"v": 7, "ts": ..., "kind": "fleet_health", "name": <event:
     "replica_spawned"|"replica_ready"|"replica_dead"|"failover"|
     "replica_degraded"|"replica_recovered"|"replica_draining"|
     "replica_retired"|"scale_up"|"scale_down"|"fleet_degraded"|
     "fleet_recovered"|"reload_broadcast">, "replica_id": r,
     **fields}                                                       [v7+]
    {"v": 8, "ts": ..., "kind": "aot_cache", "name": <event: "hit"|
     "miss"|"store"|"stale"|"corrupt"|"audit_mismatch"|"fallback"|
     "disabled">, "program": ..., "key": ..., "wall_s": ...,
     "reason": ..., **fields}                                        [v8+]
    {"v": 9, "ts": ..., "kind": "static_analysis", "name": <program |
     "lint">, "passes": [...], "findings": n, **verdict}             [v9+]
    {"v": 10, "ts": ..., "kind": "trace",    "name": <span:
     "fleet.queue"|"route"|"worker.queue"|"pack"|"dispatch"|"verify"|
     "failover.requeue"|"ack" — or "clock_offset">, "trace_id": ...,
     "span_id": ..., "parent_id": ...|null, "t0": ..., "t1": ...,
     "clock": "parent"|"worker", "replica_id": r|null,
     "terminal": bool, **fields}                                    [v10+]
    {"v": 11, "ts": ..., "kind": "rollup",   "name": <source:
     "serving"|"fleet"|"train"|...>, "window_start": ...,
     "window_end": ..., "window_s": ..., "seq": i, "counters":
     {metric: total}, "rates": {metric: {"rate": ..., "ewma": ...}},
     "gauges": {metric: last}, "quantiles": {metric: {"count": n,
     "sum": ..., "min": ..., "max": ..., "p50": ..., "p90": ...,
     "p99": ...}}, "sketches": {metric: <QuantileSketch.to_dict()>},
     "late": n, "replica_id": r|null}                               [v11+]
    {"v": 11, "ts": ..., "kind": "alert",    "name": <rule>,
     "state": "firing"|"resolved", "severity": "page"|"ticket",
     "t": ..., "value": ..., "threshold": ..., "burn_fast": ...,
     "burn_slow": ..., "reason": ..., "replica_id": r|null}         [v11+]
    {"v": 12, "ts": ..., "kind": "digest",   "name": <source: "train">,
     "step": <global step>, "epoch": ..., "layers": n,
     "crc_w": [uint32 ...], "crc_b": [...], "pnorm_w": [float ...],
     "pnorm_b": [...], "gnorm_w": [...], "gnorm_b": [...]}          [v12+]
    {"v": 13, "ts": ..., "kind": "autoscale", "name": <decision:
     "scale_out"|"scale_in"|"replace"|"backpressure_on"|
     "backpressure_off">, "direction": "out"|"in"|"hold", "rule":
     <triggering rule|poll>, "t": ..., "replicas_before": n,
     "replicas_after": n, "reason": ..., "window_end": ...|null,
     "queue_depth": n, "value": ...|null, "threshold": ...|null,
     "flap": bool, **evidence}                                      [v13+]

Schema compatibility rules (SCHEMA_VERSION history):

- v1  initial schema: meta/counter/gauge/histogram/timer/span/event.
- v2  ADDITIVE: the ``step`` (flight-recorder per-step sample) and
  ``health`` (numerics-monitor finding) kinds. No v1 kind or field
  changed meaning, so a v2 READER accepts v1 files unchanged (and the
  ``read_jsonl`` strict check is one-directional: it refuses records
  NEWER than the reader, never older). A v1 reader fed a v2 file will
  refuse it loudly — that is the point of the stamp.
- v3  ADDITIVE: the ``xla_audit`` kind (compiled-program collective
  census + memory analysis + comms-contract verdict, emitted at jit
  time — observability/program_audit.py). Again no existing kind or
  field changed meaning, so the v3 reader accepts v1 AND v2 files
  unchanged and the strict refusal stays one-directional.
- v4  ADDITIVE: the ``checkpoint`` (one step/epoch/halt snapshot write,
  named by its reason, carrying the step cursor + bytes + wall clock)
  and ``recovery`` (one resume decision, named by its verdict —
  ``resumed``/``fresh_start`` — carrying what was restored and every
  corrupt snapshot skipped on the way) kinds, the evidence stream behind
  the report CLI's Reliability section. No existing kind or field
  changed meaning; the v4 reader accepts v1–v3 files unchanged.
- v5  ADDITIVE: the ``request`` (one served request's accounting —
  enqueue/dispatch/complete timestamps, rows vs padded slots, latency
  and queue wait, SLO verdict; named by its outcome) and ``serving``
  (one load run's aggregate — completion counts, latency percentiles,
  goodput, padding waste, queue-depth stats) kinds, the evidence
  stream behind the report CLI's Serving section
  (shallowspeed_tpu/serving/, docs/serving.md). No existing kind or
  field changed meaning; the v5 reader accepts v1–v4 files unchanged
  and the strict refusal stays one-directional (a v6 file is refused).
- v6  ADDITIVE: the ``serving_health`` (one serving degradation event —
  a failed or non-finite dispatch, a breaker trip or recovery, an
  injected chaos fault — named by the event) and ``reload`` (one hot
  weight-reload decision, named by its verdict, carrying the snapshot
  path/step, the trigger reason and the surviving compiled-program
  count) kinds — the evidence stream behind the report CLI's
  Degradation subsection (docs/robustness.md "Serving faults"). The
  ``request`` kind additionally gains the terminal verdicts
  ``expired``/``error``/``unhealthy`` as record NAMES plus the additive
  ``attempts``/``reason`` fields (new names/fields on an existing kind
  — lawful under the ignore-unknown-fields rule; no existing
  name/field changed meaning). The v6 reader accepts v1–v5 files
  unchanged; a v7 file is refused.
- v7  ADDITIVE: the ``fleet`` (one fleet run's aggregate — per-replica
  verdict counts, routing assignments + skew, failover/reroute counts,
  availability, the measured recovery and scale-up times) and
  ``fleet_health`` (one fleet lifecycle event — a replica spawned/ready/
  dead/degraded/retired, a failover requeue, a scale decision, a
  fleet-level quorum transition — every one tagged ``replica_id``) kinds,
  the evidence stream behind the report CLI's Fleet section
  (shallowspeed_tpu/serving/fleet.py, docs/serving.md "Fleet"). No
  existing kind or field changed meaning; the v7 reader accepts v1–v6
  files unchanged and the strict refusal stays one-directional (a v8
  file is refused).

- v8  ADDITIVE: the ``aot_cache`` kind (one ahead-of-time executable
  cache decision, named by the event — ``hit``/``miss``/``store``/
  ``stale``/``corrupt``/``audit_mismatch``/``fallback``/``disabled`` —
  carrying the program label, cache key, wall time and the recorded
  reason; shallowspeed_tpu/aot_cache.py), plus additive fields on the
  EXISTING ``checkpoint`` kind for the async writer (``async``,
  ``queue_depth`` at enqueue, off-path ``verify_s``/``write_s``/
  ``queued_s`` — for async saves ``wall_s`` is the ON-PATH cost only:
  snapshot + enqueue) and ``verify_s`` on the ``reload`` kind (the
  discovery-verification time of the single-verified-read reload).
  Lawful under the ignore-unknown-fields rule; no existing name/field
  changed meaning. The v8 reader accepts v1-v7 files unchanged and the
  strict refusal stays one-directional (a v9 file is refused).

- v9  ADDITIVE: the ``static_analysis`` kind (one static-analysis
  verdict, named by the program it covers for the compile-time passes —
  send/recv match, MPMD deadlock-freedom, stash lifetime over the
  lowered tick tables, plus the HLO dispatch-safety pass — or ``lint``
  for a house-rule lint run; carries the pass list, per-pass stats and
  the finding count; shallowspeed_tpu/analysis/,
  docs/static-analysis.md), plus the ``SCHEMA_KINDS`` registry below —
  the machine-readable half of this docstring, which the house-rule
  linter enforces: a record kind not registered here cannot be emitted.
  No existing kind or field changed meaning; the v9 reader accepts
  v1-v8 files unchanged and the strict refusal stays one-directional
  (a v10 file is refused).

- v10 ADDITIVE: the ``trace`` kind (distributed request tracing,
  observability/tracing.py, docs/observability.md § Tracing): one CLOSED
  span per record — named by the span type (``fleet.queue``/``route``/
  ``worker.queue``/``pack``/``dispatch``/``verify``/``failover.requeue``/
  ``ack``), carrying the ``trace_id`` every record of one request shares
  across processes, a process-unique ``span_id``, the ``parent_id``
  linkage (carried over the worker pipe alongside the request, so chains
  stay connected across the process hop), raw ``t0``/``t1`` perf_counter
  endpoints in the emitting process's clock domain (``clock``:
  ``parent`` or ``worker``), the emitting ``replica_id``, and
  ``terminal`` marking the one span that ends the request. The special
  name ``clock_offset`` records the fleet handshake's per-replica
  round-trip clock estimate (``offset_s``/``rtt_s``/``uncertainty_s``) —
  what lets a reader place every shard on the parent timeline. The
  EXISTING ``request`` kind additionally gains the ``trace_id`` field
  (the join key from a request's terminal verdict to its span chain —
  additive field on a known kind, lawful under the ignore-unknown-fields
  rule). No existing kind or field changed meaning; the v10 reader
  accepts v1–v9 files unchanged and the strict refusal stays
  one-directional (a v11 file is refused).

- v11 ADDITIVE: the ``rollup`` (one CLOSED tumbling telemetry window,
  observability/rollup.py, docs/observability.md § Live telemetry:
  named by the emitting source — ``serving``/``fleet``/``train`` —
  carrying the window bounds in the emitter's record-timestamp domain,
  per-metric counter totals, per-window + EWMA rates, last-value
  gauges, quantile summaries AND the full mergeable ``QuantileSketch``
  state so shard rollups can be re-merged exactly, the late-sample
  count, and the emitting ``replica_id`` — the existing shard join
  key) and ``alert`` (one SLO alert lifecycle TRANSITION,
  observability/slo.py: named by the rule, carrying ``state``
  ``firing``/``resolved``, severity, the observed value vs threshold,
  the fast/slow burn rates for burn-rate rules, and the human
  ``reason``) kinds — the sensor-and-alarm evidence stream behind
  ``observability.watch``, the report CLI's Alerts section and the
  autoscaler (serving/autoscaler.py, since v13). No existing kind or
  field changed
  meaning; the v11 reader accepts v1–v10 files unchanged and the
  strict refusal stays one-directional (a v12 file is refused).

- v12 ADDITIVE: the ``digest`` kind (one per optimizer step, named by
  the emitting source — ``train`` — carrying ``step`` (the 0-based
  GLOBAL step index), ``epoch``, ``layers`` and parallel
  per-global-layer lists: ``crc_w``/``crc_b`` — the uint32 wrap-around
  sums of each logical (W, b) block's POST-update float32 bytes
  reinterpreted as uint32 words, computed in-program as fused scan aux
  and psum'd over the mesh so the value is layout-independent — plus
  ``pnorm_w``/``pnorm_b`` (post-update per-block L2 norms) and
  ``gnorm_w``/``gnorm_b`` (post-sync, PRE-clip per-block gradient L2
  norms)) — the numerics-provenance stream behind
  ``observability.divergence`` (first-divergence attribution and
  checkpoint-bisect replay) and the report CLI's Divergence section.
  No existing kind or field changed meaning; the v12 reader accepts
  v1–v11 files unchanged and the strict refusal stays one-directional
  (a v13 file is refused).

- v13 ADDITIVE: the ``autoscale`` kind (one closed-loop capacity
  decision, serving/autoscaler.py, docs/serving.md § Autoscaling:
  named by the decision — ``scale_out``/``scale_in``/``replace``/
  ``backpressure_on``/``backpressure_off`` — carrying ``direction``
  (``out``/``in``/``hold``), the triggering ``rule`` (an alert rule
  name, or ``poll`` for a between-edges status decision), the decision
  time ``t``, the fleet size ``replicas_before``/``replicas_after``,
  the evidence it acted on (``value``/``threshold`` from the alert or
  rollup window, ``window_end`` of the rollup window consulted,
  ``queue_depth`` at decision time), a human ``reason``, and ``flap``
  — True when this decision reverses the previous direction inside
  the policy's flap window, the scoreboard's zero-flap gate) — the
  evidence stream behind the capacity scoreboard
  (serving/bench_replay.py, AUTOSCALE_r01.json) and the report CLI's
  Capacity section. No existing kind or field changed meaning; the
  v13 reader accepts v1–v12 files unchanged and the strict refusal
  stays one-directional (a v14 file is refused).

The contract for future bumps: additive kinds/fields bump the version and
must keep old records readable; any change to an EXISTING kind's meaning
requires a new kind name instead. Consumers must ignore unknown fields on
known kinds.

Multihost: a ``JsonlMetrics`` constructed under an initialized
``torch.distributed`` process group of more than one rank appends a ``.p{process_index}`` suffix to its path — concurrent hosts
each own one shard and can never interleave writes into one file.
Fleet workers reuse the same convention with an ``.r{replica_id}``
suffix (``replica_shard_path``): every serving replica process owns its
shard, the parent fleet process owns the bare path, and ``replica_id``
is the join key between the parent's ``fleet``/``fleet_health`` records
and each shard's ``request``/``serving_health`` stream
(docs/observability.md). ``read_jsonl`` accepts a glob
(``run.jsonl.p*``, ``fleet.jsonl*``) and, given a bare path that does
not exist, falls back to its ``.p*`` (multihost) or ``.r*`` (fleet)
shards automatically.

The span taxonomy and the metric names the framework itself emits are
documented in docs/observability.md.
"""

import glob as _glob
import json
import math
import os
import threading
import time

from shallowspeed_tpu_torch.observability.spans import _NULL, Span, program_span

SCHEMA_VERSION = 13
SCHEMA_NAME = "shallowspeed_tpu.metrics"

# The schema table: every record kind this schema version can write,
# mapped to the SCHEMA_VERSION that introduced it (the machine-readable
# half of the docstring above). This is a REGISTRY, not documentation:
# the house-rule linter (shallowspeed_tpu/analysis/rules.py, rule
# SSP005) parses it by AST and refuses any ``_emit`` whose "kind"
# literal is absent — so adding a kind forces the schema-version
# discipline (additive bump + history entry) instead of quietly leaking
# an undocumented record shape into published JSONL. Keep it a pure
# literal: the linter reads it with ast.literal_eval, without importing
# (or depending on) this module's jax-adjacent imports.
SCHEMA_KINDS = {
    "meta": 1,
    "counter": 1,
    "gauge": 1,
    "histogram": 1,
    "timer": 1,
    "span": 1,
    "event": 1,
    "step": 2,
    "health": 2,
    "xla_audit": 3,
    "checkpoint": 4,
    "recovery": 4,
    "request": 5,
    "serving": 5,
    "serving_health": 6,
    "reload": 6,
    "fleet": 7,
    "fleet_health": 7,
    "aot_cache": 8,
    "static_analysis": 9,
    "trace": 10,
    "rollup": 11,
    "alert": 11,
    "digest": 12,
    "autoscale": 13,
}


class NullMetrics:
    """The no-op backend: the hot-path methods take fixed positional
    arguments (no ``**kwargs`` — an empty kwargs dict is still a dict
    allocation per call) and return module-level singletons."""

    __slots__ = ()
    enabled = False

    def counter(self, name, value=1.0):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def timer(self, name):
        return _NULL

    def span(self, name):
        # a span of the program trace alone (the shared no-op while it is off)
        return program_span(name)

    def event(self, name, **fields):
        pass

    def step(self, name, **fields):
        pass

    def health(self, name, **fields):
        pass

    def audit(self, name, **fields):
        pass

    def checkpoint(self, name, **fields):
        pass

    def recovery(self, name, **fields):
        pass

    def request(self, name, **fields):
        pass

    def serving(self, name, **fields):
        pass

    def serving_health(self, name, **fields):
        pass

    def reload(self, name, **fields):
        pass

    def fleet(self, name, **fields):
        pass

    def fleet_health(self, name, **fields):
        pass

    def aot_cache(self, name, **fields):
        pass

    def static_analysis(self, name, **fields):
        pass

    def trace(self, name, **fields):
        pass

    def rollup(self, name, **fields):
        pass

    def alert(self, name, **fields):
        pass

    def digest(self, name, **fields):
        pass

    def autoscale(self, name, **fields):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class MetricsRecorder:
    """In-memory aggregating recorder (and the sink-backed recorders' base).

    Aggregation semantics:
    - ``counter``  monotonic per-name sum of increments;
    - ``gauge``    last value wins;
    - ``observe``  per-name sample list (a per-step histogram — the summary
                   reports count/min/max/mean);
    - ``timer``    a context manager whose wall-clock duration is observed
                   into the ``<name>.seconds`` histogram (+ a timer record);
    - ``span``     ``spans.Span`` bound to this recorder: wall-clock + a
                   ``torch.profiler.record_function`` range labeling
                   profiler captures; emits a span record with its nesting path;
    - ``event``    a free-form named record (arbitrary JSON-able fields) —
                   the shape the per-epoch training telemetry uses;
    - ``step``     one flight-recorder per-step sample (schema v2): free
                   fields like ``event`` under its own kind so step-level
                   streams are filterable without name conventions;
    - ``health``   one numerics-monitor finding (schema v2), named by the
                   check that fired (``non_finite``/``loss_divergence``/
                   ``grad_spike``);
    - ``audit``    one compiled-program audit (schema v3, kind
                   ``xla_audit``), named by the program it describes
                   (``epoch_program``/``run_program``): collective census,
                   memory analysis, comms-contract verdict
                   (observability/program_audit.py).
    """

    enabled = True

    def __init__(self):
        self.counters = {}
        self.gauges = {}
        self.histograms = {}
        self.spans = []  # (path, seconds) in completion order

    # -- recording surface --------------------------------------------------

    def counter(self, name, value=1.0):
        total = self.counters.get(name, 0.0) + value
        self.counters[name] = total
        self._emit({"kind": "counter", "name": name, "value": total, "inc": value})

    def gauge(self, name, value):
        self.gauges[name] = value
        self._emit({"kind": "gauge", "name": name, "value": value})

    def observe(self, name, value):
        self.histograms.setdefault(name, []).append(value)
        self._emit({"kind": "histogram", "name": name, "value": value})

    def timer(self, name):
        return _Timer(self, name)

    def span(self, name):
        return Span(name, metrics=self)

    def event(self, name, **fields):
        self._emit({"kind": "event", "name": name, **fields})

    def step(self, name, **fields):
        self._emit({"kind": "step", "name": name, **fields})

    def health(self, name, **fields):
        self._emit({"kind": "health", "name": name, **fields})

    def audit(self, name, **fields):
        self._emit({"kind": "xla_audit", "name": name, **fields})

    def checkpoint(self, name, **fields):
        self._emit({"kind": "checkpoint", "name": name, **fields})

    def recovery(self, name, **fields):
        self._emit({"kind": "recovery", "name": name, **fields})

    def request(self, name, **fields):
        self._emit({"kind": "request", "name": name, **fields})

    def serving(self, name, **fields):
        self._emit({"kind": "serving", "name": name, **fields})

    def serving_health(self, name, **fields):
        self._emit({"kind": "serving_health", "name": name, **fields})

    def reload(self, name, **fields):
        self._emit({"kind": "reload", "name": name, **fields})

    def fleet(self, name, **fields):
        self._emit({"kind": "fleet", "name": name, **fields})

    def fleet_health(self, name, **fields):
        self._emit({"kind": "fleet_health", "name": name, **fields})

    def aot_cache(self, name, **fields):
        self._emit({"kind": "aot_cache", "name": name, **fields})

    def static_analysis(self, name, **fields):
        self._emit({"kind": "static_analysis", "name": name, **fields})

    def trace(self, name, **fields):
        self._emit({"kind": "trace", "name": name, **fields})

    def rollup(self, name, **fields):
        self._emit({"kind": "rollup", "name": name, **fields})

    def alert(self, name, **fields):
        self._emit({"kind": "alert", "name": name, **fields})

    def digest(self, name, **fields):
        self._emit({"kind": "digest", "name": name, **fields})

    def autoscale(self, name, **fields):
        self._emit({"kind": "autoscale", "name": name, **fields})

    # -- recorder-internal hooks --------------------------------------------

    def _record_span(self, span):
        """Completion hook called by spans.Span.__exit__."""
        self.spans.append((span.path, span.seconds))
        self._emit(
            {
                "kind": "span",
                "name": span.name,
                "path": span.path,
                "depth": span.depth,
                "seconds": span.seconds,
            }
        )

    def _record_timer(self, name, seconds):
        self.histograms.setdefault(name + ".seconds", []).append(seconds)
        self._emit({"kind": "timer", "name": name, "seconds": seconds})

    def _emit(self, record):
        """Sink hook: the in-memory base discards (aggregation above already
        happened); JsonlMetrics overrides this with the JSONL write."""

    # -- inspection ---------------------------------------------------------

    def summary(self):
        """JSON-able aggregate snapshot of everything recorded so far."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                name: {
                    "count": len(vs),
                    "min": min(vs),
                    "max": max(vs),
                    "mean": sum(vs) / len(vs),
                }
                for name, vs in self.histograms.items()
                if vs
            },
            "spans": [{"path": p, "seconds": s} for p, s in self.spans],
        }

    def flush(self):
        pass

    def close(self):
        pass


class _Timer:
    """Context manager recording one wall-clock duration into a recorder."""

    __slots__ = ("_metrics", "_name", "_t0", "seconds")

    def __init__(self, metrics, name):
        self._metrics = metrics
        self._name = name
        self.seconds = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        self._metrics._record_timer(self._name, self.seconds)
        return False


def _json_safe(value):
    """Strict-JSON sanitizer: non-finite floats become the strings "NaN" /
    "Infinity" / "-Infinity" (recursively through dicts/lists). The step and
    health records exist precisely to carry blow-up evidence, and bare NaN
    tokens from ``json.dumps``'s default ``allow_nan=True`` would make
    exactly those lines unparseable to any strict-JSON consumer (jq on the
    live ``tail -f`` dashboard, non-Python ingests) — the one-JSON-object-
    per-line contract must hold hardest on the records that matter most.
    Consumers treat the strings as non-finite (the report does)."""
    if isinstance(value, float) and not math.isfinite(value):
        if math.isnan(value):
            return "NaN"
        return "Infinity" if value > 0 else "-Infinity"
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return value


# public alias: every OTHER writer of record-shaped JSON (the report CLI's
# --format json, trace_stats' per-op lines, the bench records) shares the
# same sanitizer, so `json.dumps(..., allow_nan=False)` — which the
# house-rule linter now demands on metrics paths (rule SSP002) — can never
# crash on legitimately non-finite evidence values
json_safe = _json_safe


class JsonlMetrics(MetricsRecorder):
    """MetricsRecorder with a versioned append-only JSONL sink.

    Every record is one line, written (and by default flushed) immediately —
    a killed run keeps everything recorded up to the kill, and ``tail -f``
    on the file is a live dashboard. The first line is a ``meta`` header
    naming the schema; each record also carries ``"v": SCHEMA_VERSION`` so
    lines stay self-describing when files are concatenated.

    ``flush_every``: flush the OS buffer every N records (1 = every record;
    per-epoch recording volumes make this free either way).

    Multihost: under a ``torch.distributed`` world of more than one rank
    the path gains a
    ``.p{process_index}`` suffix — every host owns its shard, so
    concurrent processes can never interleave half-lines into one file
    (``self.path`` reports the EFFECTIVE path; ``read_jsonl`` reads the
    shard set back via glob or the automatic ``.p*`` fallback).
    """

    def __init__(self, path, mode="w", flush_every=1):
        super().__init__()
        self.path = _shard_path(path)
        self._flush_every = max(1, int(flush_every))
        self._since_flush = 0
        # one writer lock: the async checkpoint writer emits its completion
        # records from the background thread, and two half-interleaved
        # lines would break the one-JSON-object-per-line contract exactly
        # on the crash-evidence records that matter most
        self._write_lock = threading.Lock()
        self._f = open(self.path, mode, encoding="utf-8")
        self._emit(
            {
                "kind": "meta",
                "name": "metrics",
                "schema": SCHEMA_NAME,
                "created": time.strftime("%Y-%m-%d %H:%M:%S"),
            }
        )

    def _emit(self, record):
        line = json.dumps(
            _json_safe({"v": SCHEMA_VERSION, "ts": time.time(), **record}),
            allow_nan=False,  # enforced: every line is STRICT JSON
        )
        with self._write_lock:
            if self._f is None:
                raise ValueError(f"JsonlMetrics({self.path!r}) is closed")
            self._f.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._f.flush()
                self._since_flush = 0

    def flush(self):
        with self._write_lock:
            if self._f is not None:
                self._f.flush()
                self._since_flush = 0

    def close(self):
        with self._write_lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def _shard_path(path):
    """The process-local JSONL path: ``path.p{rank}`` when an initialized
    ``torch.distributed`` process group has more than one rank (processes
    must never share one append target), the path unchanged otherwise —
    including when ``torch.distributed`` is unavailable or not initialized
    (the port runs one process until its multi-process runtime lands).
    Construct the sink after ``init_process_group``: a sink constructed
    before it cannot see the process set and will not shard."""
    path = os.fspath(path)
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return f"{path}.p{dist.get_rank()}"
    except Exception:  # noqa: BLE001 — best-effort probe, never a crash
        pass
    return path


def replica_shard_path(path, replica_id):
    """The fleet worker's JSONL path: ``path.r{replica_id}`` — the
    multihost ``.p{process_index}`` convention reused for serving
    replicas, so N engine worker processes can never interleave writes
    into one file. The parent fleet process owns the bare ``path``;
    ``replica_id`` is the join key between its ``fleet``/``fleet_health``
    records and each shard's per-request stream."""
    return f"{os.fspath(path)}.r{int(replica_id)}"


def _expand_shards(path):
    """``read_jsonl`` path resolution: an existing file is read as-is
    (even when its name contains glob metacharacters); otherwise an
    explicit glob expands to its sorted matches, and a bare path falls
    back to its multihost ``.p*`` shards (what ``JsonlMetrics`` wrote
    under ``process_count() > 1``) or its fleet ``.r*`` shards (what the
    fleet workers wrote via ``replica_shard_path``)."""
    s = os.fspath(path)
    if os.path.exists(s):
        return [s]
    if any(c in s for c in "*?["):
        shards = sorted(_glob.glob(s))
        if not shards:
            raise FileNotFoundError(f"no metrics files match glob {s!r}")
        return shards
    # only writer-shaped shards (".p"/".r" + digits) — a neighbor like
    # "run.jsonl.partial" must never be silently merged as a shard
    shards = sorted(
        _glob.glob(_glob.escape(s) + ".p[0-9]*")
        + _glob.glob(_glob.escape(s) + ".r[0-9]*")
    )
    if shards:
        return shards
    return [s]


def read_jsonl(path, strict=True):
    """Load a metrics JSONL file back into a list of record dicts.

    ``path`` may be a single file, a glob (``run.jsonl.p*`` — multihost
    shards are read in sorted order and concatenated), or a bare path whose
    ``.p*`` shards exist (the multihost auto-fallback).

    ``strict=True`` (default) raises on records whose schema version is
    newer than this reader understands — refusing loudly beats silently
    misreading a future schema (the honesty rule every published record in
    this repo follows). Blank lines are skipped; malformed lines raise.
    """
    records = []
    for shard in _expand_shards(path):
        with open(shard, encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if strict and rec.get("v", 0) > SCHEMA_VERSION:
                    raise ValueError(
                        f"{shard}:{i + 1}: record schema v{rec.get('v')} is "
                        f"newer than this reader (v{SCHEMA_VERSION})"
                    )
                records.append(rec)
    return records
