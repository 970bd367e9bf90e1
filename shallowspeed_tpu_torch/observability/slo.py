"""SLO alerting: multi-window multi-burn-rate rules, an alert
firing→resolved lifecycle emitted as schema-v11 ``alert`` records, and
the ``AlertSink`` hook the autoscaler (``serving/autoscaler.py``)
consumes.

Copied from ``shallowspeed_tpu/observability/slo.py`` (pure Python);
``tests/test_torch_observability.py`` holds the copy's output to the
JAX module's on the same inputs.

BURN-RATE MATH (docs/observability.md § Live telemetry & alerting). An
SLO target of ``slo_target`` (say 99% of requests good) leaves an error
BUDGET of ``1 - slo_target``. The burn rate over a window is the
observed bad fraction divided by the budget: burn 1.0 spends the budget
exactly at the sustainable pace; burn 14.4 exhausts a 30-day budget in
~2 days. A single window is either too twitchy (short) or too slow to
resolve (long), so :class:`BurnRateRule` is the standard multi-window
form: it FIRES only when both a LONG window (sustained damage) and a
SHORT window (still happening right now) exceed the burn threshold,
and RESOLVES as soon as the short window drops back under — fast
resolution without flapping.

RULE LIFECYCLE. Every rule is a tiny state machine (``ok`` ⇄
``firing``). A transition — and only a transition — emits one ``alert``
record (kind ``alert``, named by the rule, ``state`` ``firing`` or
``resolved``) through the attached metrics recorder and calls every
attached :class:`AlertSink`. Steady state emits nothing: the alert
stream is an event log of edges, not a sampled signal.

THE ``AlertSink`` CONTRACT (the autoscaler hook): one method,
``alert(record: dict)``, called synchronously on every transition with
the same JSON-able dict the ``alert`` record carries (``name``/
``rule``/``state``/``severity``/``t``/``value``/``threshold``/
``burn_fast``/``burn_slow``/``reason``/``replica_id``). Sinks must not
raise (a broken consumer must not take down serving) and must not
block — hand off to a queue if reaction is slow. A sink sees edges
only; consumers needing current state call
:meth:`SloEvaluator.active`.

Rule families over the evidence stream:

- :class:`EventRule`        edge-triggered on named health events —
  ``breaker_open`` fires, ``breaker_closed`` resolves. Deterministic
  (no clock windows), which is why ``make alerts-smoke`` gates on it.
- :class:`BurnRateRule`     multi-window burn over a good/bad request
  stream (error/unhealthy verdict fraction vs the SLO budget).
- :class:`ThresholdRule`    fires when a value extracted from each
  CLOSED rollup window breaches a threshold for ``for_windows``
  consecutive windows, resolves after ``clear_windows`` clean ones —
  p99-vs-SLO, admitted-rate-vs-knee, checkpoint overhead fraction.

:func:`default_serving_rules` / :func:`default_training_rules` build
the standard set; :class:`LiveTelemetry` is the one-object glue a
telemetry source (engine / fleet / training session) owns: a
:class:`~shallowspeed_tpu_torch.observability.rollup.RollupBuilder` whose
closed windows feed a :class:`SloEvaluator`, with ``note_*`` feed
methods and a ``snapshot()`` the ``status()`` surfaces return.
"""

from collections import deque

from shallowspeed_tpu_torch.observability.rollup import (
    DEFAULT_WINDOW_S,
    RollupBuilder,
)

# verdicts that spend error budget (terminal but not the service's fault
# — "dropped"/"expired" under overload are capacity, not correctness;
# the knee/queue rules cover those)
BAD_VERDICTS = ("error", "unhealthy")

# the achieved-rate slack the ONE breach definition below tolerates
# before calling a window saturated (the historic find_knee default)
SLO_ACHIEVED_FRACTION = 0.9


def slo_breach(
    p99_latency_s,
    offered_rps,
    achieved_rps,
    slo_ms,
    achieved_fraction=SLO_ACHIEVED_FRACTION,
):
    """THE SLO-breach predicate — the single definition shared by
    ``bench_serving.find_knee`` (so ``knee_rps`` is "the first offered
    rate that breaches") and the capacity scoreboard's violation-minute
    scorer (``serving/bench_replay.py``), so the knee and the scoreboard
    can never disagree about what a violation is.

    A window/row breaches when its p99 latency exceeds the SLO, or its
    achieved rate falls below ``achieved_fraction`` x the offered rate
    (saturation: the service is silently shedding the difference into
    the backlog). Returns the breach reason (``"p99_above_slo"`` /
    ``"achieved_below_offered"``) or ``None`` — callers needing a bool
    truth-test the return. ``None`` inputs abstain rather than guess:
    a missing p99 (no completions) only breaches through the achieved
    test, and with no evidence at all the verdict is "no breach"."""
    if slo_ms is not None and p99_latency_s is not None:
        if p99_latency_s > slo_ms / 1000.0:
            return "p99_above_slo"
    if achieved_rps is not None and offered_rps:
        if achieved_rps < achieved_fraction * offered_rps:
            return "achieved_below_offered"
    return None


class AlertSink:
    """The alert-consumer contract (module docstring): override
    ``alert``. The base class is a no-op, so a consumer can subclass
    and override only what it needs."""

    def alert(self, record):
        """Called synchronously on every firing→resolved edge with the
        JSON-able alert dict. Must not raise, must not block."""


class AlertRule:
    """Base rule: a named ``ok`` ⇄ ``firing`` state machine. Subclasses
    implement the ``on_*`` hooks they consume and return either ``None``
    (no opinion) or a decision dict ``{"state": "ok"|"firing", "value":
    ..., "threshold": ..., "reason": ...}``; the evaluator turns state
    CHANGES into alert records."""

    def __init__(self, name, severity="ticket"):
        self.name = name
        self.severity = severity
        self.state = "ok"

    def on_request(self, t, verdict):
        return None

    def on_event(self, t, name, fields):
        return None

    def on_window(self, summary):
        return None


class EventRule(AlertRule):
    """Edge-triggered rule over named health events: any event in
    ``fire_on`` fires, any in ``resolve_on`` resolves."""

    def __init__(self, name, fire_on, resolve_on, severity="page"):
        super().__init__(name, severity=severity)
        self.fire_on = tuple(fire_on)
        self.resolve_on = tuple(resolve_on)

    def on_event(self, t, name, fields):
        if name in self.fire_on:
            return {
                "state": "firing",
                "value": name,
                "threshold": None,
                "reason": f"health event {name!r}",
            }
        if name in self.resolve_on:
            return {
                "state": "ok",
                "value": name,
                "threshold": None,
                "reason": f"health event {name!r}",
            }
        return None


class BurnRateRule(AlertRule):
    """Multi-window multi-burn-rate rule (module docstring): fires when
    the bad-request fraction burns the error budget faster than
    ``burn`` over BOTH the long and the short window; resolves when the
    short window recovers."""

    def __init__(
        self,
        name,
        budget=0.01,
        long_s=300.0,
        short_s=60.0,
        burn=6.0,
        bad_verdicts=BAD_VERDICTS,
        min_samples=10,
        severity="page",
    ):
        super().__init__(name, severity=severity)
        if budget <= 0:
            raise ValueError(f"error budget must be positive, got {budget!r}")
        if short_s >= long_s:
            raise ValueError(
                f"short window ({short_s}s) must be shorter than long "
                f"({long_s}s)"
            )
        self.budget = float(budget)
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.burn = float(burn)
        self.bad_verdicts = tuple(bad_verdicts)
        self.min_samples = int(min_samples)
        self._samples = deque()  # (t, is_bad) — pruned past long_s

    def _burn_over(self, t, horizon):
        bad = total = 0
        for st, is_bad in self._samples:
            if st > t - horizon:
                total += 1
                bad += is_bad
        if total < self.min_samples:
            return None, total
        return (bad / total) / self.budget, total

    def on_request(self, t, verdict):
        self._samples.append((t, 1 if verdict in self.bad_verdicts else 0))
        while self._samples and self._samples[0][0] <= t - self.long_s:
            self._samples.popleft()
        burn_long, n_long = self._burn_over(t, self.long_s)
        burn_short, _ = self._burn_over(t, self.short_s)
        if burn_long is None or burn_short is None:
            return None  # not enough evidence to change state either way
        fired = burn_long >= self.burn and burn_short >= self.burn
        if self.state == "firing":
            fired = burn_short >= self.burn  # short-window recovery resolves
        return {
            "state": "firing" if fired else "ok",
            "value": burn_long,
            "threshold": self.burn,
            "burn_fast": burn_short,
            "burn_slow": burn_long,
            "reason": (
                f"bad-verdict burn rate {burn_long:.2f}x budget over "
                f"{self.long_s:g}s ({burn_short:.2f}x over {self.short_s:g}s, "
                f"{n_long} samples, budget {self.budget:g})"
            ),
        }


class ThresholdRule(AlertRule):
    """Consecutive-window threshold rule over CLOSED rollup windows:
    ``value_fn(summary)`` breaching ``threshold`` for ``for_windows``
    windows in a row fires; ``clear_windows`` clean ones resolve.
    ``value_fn`` returning ``None`` (metric absent from the window)
    leaves the streak — and the state — untouched."""

    def __init__(
        self,
        name,
        value_fn,
        threshold,
        for_windows=2,
        clear_windows=2,
        comparison="gt",
        reason=None,
        severity="ticket",
    ):
        super().__init__(name, severity=severity)
        self.value_fn = value_fn
        self.threshold = float(threshold)
        self.for_windows = int(for_windows)
        self.clear_windows = int(clear_windows)
        self.comparison = comparison
        self.reason = reason or name
        self._bad_streak = 0
        self._good_streak = 0

    def _breached(self, value):
        if self.comparison == "gt":
            return value > self.threshold
        if self.comparison == "lt":
            return value < self.threshold
        raise ValueError(f"unknown comparison {self.comparison!r}")

    def on_window(self, summary):
        value = self.value_fn(summary)
        if value is None:
            return None
        if self._breached(value):
            self._bad_streak += 1
            self._good_streak = 0
        else:
            self._good_streak += 1
            self._bad_streak = 0
        state = self.state
        if self.state == "ok" and self._bad_streak >= self.for_windows:
            state = "firing"
        elif self.state == "firing" and self._good_streak >= self.clear_windows:
            state = "ok"
        return {
            "state": state,
            "value": value,
            "threshold": self.threshold,
            "reason": (
                f"{self.reason}: {value:.6g} "
                f"{'>' if self.comparison == 'gt' else '<'} "
                f"{self.threshold:.6g} "
                f"({self._bad_streak} breaching window(s))"
            ),
        }


class SloEvaluator:
    """Drives a rule set over the evidence stream and owns the alert
    lifecycle: state transitions become ``alert`` records + sink calls;
    everything else is silence."""

    def __init__(self, rules, metrics=None, sinks=(), replica_id=None):
        self.rules = list(rules)
        self.metrics = metrics
        self.sinks = list(sinks)
        self.replica_id = replica_id
        self.history = []  # every transition record, in order
        self.fired = 0
        self.resolved = 0

    # -- feeds --------------------------------------------------------------

    def note_request(self, t, verdict):
        for rule in self.rules:
            self._apply(rule, t, rule.on_request(t, verdict))

    def note_event(self, t, name, **fields):
        for rule in self.rules:
            self._apply(rule, t, rule.on_event(t, name, fields))

    def note_window(self, summary):
        t = summary.get("window_end")
        for rule in self.rules:
            self._apply(rule, t, rule.on_window(summary))

    # -- lifecycle ----------------------------------------------------------

    def _apply(self, rule, t, decision):
        if decision is None:
            return
        new_state = decision.pop("state")
        if new_state == rule.state:
            return
        rule.state = new_state
        edge = "firing" if new_state == "firing" else "resolved"
        record = {
            "rule": rule.name,
            "state": edge,
            "severity": rule.severity,
            "t": t,
            "burn_fast": decision.get("burn_fast"),
            "burn_slow": decision.get("burn_slow"),
            "replica_id": self.replica_id,
            **decision,
        }
        if edge == "firing":
            self.fired += 1
        else:
            self.resolved += 1
        self.history.append({"name": rule.name, **record})
        if self.metrics is not None:
            self.metrics.alert(rule.name, **record)
        for sink in self.sinks:
            try:
                sink.alert({"name": rule.name, **record})
            except Exception:  # noqa: BLE001 — a broken alert consumer must never take down serving (the sink contract)
                pass

    # -- inspection ---------------------------------------------------------

    def active(self):
        """Currently-firing rules: ``{rule_name: severity}``."""
        return {r.name: r.severity for r in self.rules if r.state == "firing"}

    def snapshot(self):
        return {
            "rules": [
                {"name": r.name, "state": r.state, "severity": r.severity}
                for r in self.rules
            ],
            "active": self.active(),
            "fired": self.fired,
            "resolved": self.resolved,
        }


# -- default rule sets -------------------------------------------------------


def _quantile(summary, metric, q):
    qs = (summary.get("quantiles") or {}).get(metric) or {}
    return qs.get(q)


def default_serving_rules(
    slo_ms=None,
    knee_rps=None,
    slo_target=0.99,
    long_s=30.0,
    short_s=5.0,
    burn=6.0,
):
    """The standard serving rule set. ``slo_ms``-dependent and
    ``knee_rps``-dependent rules are only built when the evidence
    exists — an alert against a hand-guessed constant is worse than no
    alert (the knee threshold comes from ``bench_serving``'s measured
    sweep record, satellite of the same PR)."""
    rules = [
        EventRule(
            "breaker_open",
            fire_on=("breaker_open",),
            resolve_on=("breaker_closed",),
            severity="page",
        ),
        EventRule(
            "fleet_degraded",
            fire_on=("fleet_degraded",),
            resolve_on=("fleet_recovered",),
            severity="page",
        ),
        BurnRateRule(
            "error_burn",
            budget=1.0 - slo_target,
            long_s=long_s,
            short_s=short_s,
            burn=burn,
        ),
    ]
    if slo_ms is not None:
        rules.append(
            ThresholdRule(
                "p99_slo",
                value_fn=lambda s: _quantile(s, "latency_s", "p99"),
                threshold=slo_ms / 1000.0,
                reason="window p99 latency above SLO",
            )
        )
    if knee_rps is not None:
        rules.append(
            ThresholdRule(
                "knee_proximity",
                value_fn=lambda s: (s.get("rates") or {})
                .get("admitted", {})
                .get("rate"),
                threshold=0.9 * knee_rps,
                reason=(
                    f"admitted rate within 10% of the measured saturation "
                    f"knee ({knee_rps:g} rps)"
                ),
            )
        )
    return rules


def default_training_rules(ckpt_overhead_max=0.25):
    """The trainer rule set: health events (non-finite loss halts the
    run anyway — the alert is for the fleet surface watching many runs)
    and the checkpoint overhead fraction vs the reliability budget."""

    def ckpt_fraction(summary):
        counters = summary.get("counters") or {}
        ckpt = counters.get("checkpoint_wall_s")
        train = counters.get("train_wall_s")
        if not ckpt or not train:
            return None
        return ckpt / (ckpt + train)

    return [
        EventRule(
            "training_health",
            fire_on=("non_finite", "loss_divergence", "grad_spike"),
            resolve_on=(),
            severity="page",
        ),
        ThresholdRule(
            "checkpoint_overhead",
            value_fn=ckpt_fraction,
            threshold=ckpt_overhead_max,
            for_windows=1,
            clear_windows=1,
            reason="checkpoint wall fraction of train wall above budget",
        ),
    ]


class LiveTelemetry:
    """The one-object sensor a telemetry source owns (module docstring):
    rollup builder + SLO evaluator, wired so every closed window feeds
    the threshold rules, with ``note_*`` feeds shaped for the engine,
    fleet and training session call sites."""

    def __init__(
        self,
        source,
        metrics=None,
        window_s=DEFAULT_WINDOW_S,
        rules=None,
        sinks=(),
        replica_id=None,
        slo_ms=None,
        knee_rps=None,
    ):
        if rules is None:
            rules = default_serving_rules(slo_ms=slo_ms, knee_rps=knee_rps)
        self.evaluator = SloEvaluator(
            rules, metrics=metrics, sinks=sinks, replica_id=replica_id
        )
        self.rollup = RollupBuilder(
            source,
            window_s=window_s,
            metrics=metrics,
            replica_id=replica_id,
            on_close=self.evaluator.note_window,
        )

    # -- serving feeds ------------------------------------------------------

    def note_admit(self, t):
        self.rollup.count(t, "admitted")

    def note_request(self, t, verdict, latency_s=None, queue_s=None):
        self.rollup.count(t, verdict)
        self.rollup.count(t, "terminal")
        if latency_s is not None:
            self.rollup.observe(t, "latency_s", latency_s)
        if queue_s is not None:
            self.rollup.observe(t, "queue_s", queue_s)
        self.evaluator.note_request(t, verdict)

    def note_queue_depth(self, t, depth):
        self.rollup.gauge(t, "queue_depth", depth)

    def note_health(self, t, name, **fields):
        self.rollup.count(t, "health_events")
        self.evaluator.note_event(t, name, **fields)

    # -- trainer feeds ------------------------------------------------------

    def note_step(
        self, t, loss=None, step_s=None, throughput=None, mfu=None
    ):
        self.rollup.count(t, "steps")
        if step_s is not None:
            self.rollup.observe(t, "step_s", step_s)
            self.rollup.count(t, "train_wall_s", step_s)
        if loss is not None:
            self.rollup.gauge(t, "loss", loss)
        if throughput is not None:
            self.rollup.gauge(t, "throughput", throughput)
        if mfu is not None:
            self.rollup.gauge(t, "mfu", mfu)

    def note_checkpoint(self, t, wall_s):
        self.rollup.count(t, "checkpoints")
        if wall_s is not None:
            self.rollup.count(t, "checkpoint_wall_s", wall_s)

    # -- lifecycle ----------------------------------------------------------

    def flush(self):
        self.rollup.flush()

    def snapshot(self):
        return {
            "rollup": self.rollup.snapshot(),
            "alerts": self.evaluator.snapshot(),
        }
