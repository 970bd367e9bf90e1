"""Closed-loop autoscaling policy: the mechanism the capacity
scoreboard judges.

Copied from ``shallowspeed_tpu/serving/autoscaler.py`` over the port's
``observability.slo.AlertSink``: the same decisions and the same schema-v13
``autoscale`` records for the same alert edges and ``status()`` snapshots
(``tests/test_torch_replay.py``).

Every input is something the repo already measures — nothing here is a
guess. The knee comes from ``bench_serving``'s swept ``knee_rps``; SLO
burn and knee proximity arrive as ``SloEvaluator`` edges through the
:class:`~shallowspeed_tpu_torch.observability.slo.AlertSink` contract; queue
depth, replica readiness and the rolling admitted rate come from
``ServingFleet.status()`` polled between edges. Decisions flow the other
way as schema-v13 ``autoscale`` records, each carrying its evidence
(rule, rollup window, fleet size before/after), so the report CLI's
Capacity section can replay WHY the loop acted, not just when.

RE-ENTRANCY: ``alert()`` is called synchronously from inside the
fleet's telemetry choke points (mid ``submit``/``step``), so the sink
only QUEUES the edge; all scaling actions happen in :meth:`tick`, which
the open-loop driver calls from its own iteration (``run_open_loop``'s
``on_tick`` hook) — the policy never mutates the fleet from inside the
fleet.

POLICY (docs/serving.md § Autoscaling & capacity scoreboard):

- **scale out** when a ``knee_proximity`` edge fires (admitted rate
  within 10% of the measured knee), when ``error_burn`` fires with the
  p99 burn concentrated in the fleet queue (backlog, not worker
  pathology), or when the polled admitted rate exceeds ``headroom`` x
  knee x ready replicas — growth is cheap to reverse, so the out path
  is eager (cooldown ``out_cooldown_s``).
- **scale in** only on SUSTAINED slack — no active alerts, an empty
  fleet queue, and an admitted rate the remaining replicas could carry
  at under ``slack_fraction`` of their aggregate knee, all holding
  continuously for ``slack_hold_s`` — and only after the longer
  ``in_cooldown_s`` since the last scaling action. The asymmetry IS the
  hysteresis: the scoreboard's flap count (a direction reversal within
  ``flap_window_s``) must stay zero through the kill-injected chaos
  leg.
- **replace** a dead replica immediately (``wait_ready=False`` — the
  fleet keeps serving on the survivors while the replacement warms).
  Replacement restores the intended size; it is NOT a direction change
  and can never flap.
- **admission backpressure** while replacements warm: with fewer ready
  replicas than intended and a backlog deeper than the analytical
  drain budget (queue that the ready replicas can clear inside the SLO
  at the measured per-request floor), the gate sheds new arrivals at
  admission — refusals the scoreboard charges honestly as violations —
  instead of letting an unbounded backlog burn every queued deadline.
"""

import math

from shallowspeed_tpu_torch.observability.metrics import NullMetrics
from shallowspeed_tpu_torch.observability.slo import AlertSink

AUTOSCALER_VERSION = 1

# the scale-out alert edges the sink reacts to (module docstring);
# fleet_degraded routes to the replacement path, not growth
_OUT_EDGE_RULES = ("knee_proximity", "error_burn")


class AutoscalePolicy(AlertSink):
    """The closed-loop policy. Construct, pass as an ``alert_sinks``
    entry to ``ServingFleet``, then :meth:`attach` the started fleet and
    call :meth:`tick` from the drive loop (``run_open_loop(...,
    on_tick=policy.tick)``). ``decisions`` accumulates every JSON-able
    decision record (the same dict emitted as a v13 ``autoscale``
    metrics record); ``flaps`` counts direction reversals inside
    ``flap_window_s``."""

    def __init__(
        self,
        knee_rps,
        min_replicas=1,
        max_replicas=4,
        metrics=None,
        slo_ms=None,
        floor_s=None,
        headroom=0.8,
        slack_fraction=0.5,
        slack_hold_s=6.0,
        out_cooldown_s=2.0,
        in_cooldown_s=12.0,
        flap_window_s=30.0,
        warm_queue_budget=32,
        tags=None,
    ):
        if knee_rps is None or knee_rps <= 0:
            raise ValueError(
                "AutoscalePolicy needs the measured knee_rps — run the "
                "bench_serving sweep first (measurement before mechanism)"
            )
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.knee_rps = float(knee_rps)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_ms = slo_ms
        self.floor_s = floor_s
        self.headroom = float(headroom)
        self.slack_fraction = float(slack_fraction)
        self.slack_hold_s = float(slack_hold_s)
        self.out_cooldown_s = float(out_cooldown_s)
        self.in_cooldown_s = float(in_cooldown_s)
        self.flap_window_s = float(flap_window_s)
        self.warm_queue_budget = int(warm_queue_budget)
        # constant evidence merged into every decision record — the
        # bench tags each leg (leg="autoscaled"/"chaos") so one JSONL
        # stream can carry all three replays
        self.tags = dict(tags or {})
        self._metrics = metrics if metrics is not None else NullMetrics()
        self._fleet = None
        self._pending_edges = []  # queued by alert(), drained by tick()
        self._deaths_handled = 0
        self._slack_since = None
        self._last_scale_t = None
        self._last_direction = None  # "out" | "in" — replacements excluded
        self._backpressure = False
        self.decisions = []
        self.flaps = 0

    # -- wiring --------------------------------------------------------------

    def attach(self, fleet):
        """Bind the policy to a (started) fleet: installs the admission
        gate and baselines the death counter so pre-attach history is
        not re-replaced."""
        self._fleet = fleet
        self._deaths_handled = fleet.status()["replicas_dead"]
        fleet.set_admission_gate(self._gate)
        return self

    def _gate(self, _fleet):
        # consulted per submit — a flag read, nothing else (the heavy
        # reasoning happened in tick, on the driver thread)
        return "backpressure_warming" if self._backpressure else None

    # -- the AlertSink half (edges) ------------------------------------------

    def alert(self, record):
        """Queue the edge for the next tick (sink contract: called from
        inside fleet telemetry — never scale from here)."""
        self._pending_edges.append(dict(record))

    # -- the polling half (decisions) ----------------------------------------

    def tick(self, now):
        """One decision pass at ``now`` (seconds on the drive/trace
        timeline — ``run_open_loop`` passes elapsed time). Order
        matters: replacement first (restores intended capacity),
        backpressure next (bounds the backlog while warming), then
        scale-out edges/poll, then the slack scale-in."""
        if self._fleet is None:
            raise RuntimeError("attach(fleet) before tick()")
        status = self._fleet.status()
        edges = self._pending_edges
        self._pending_edges = []
        if self._check_replace(now, status):
            # the respawn changed the live count — re-read before the
            # sizing rules, or scale-out would price the dead replica's
            # slot twice and overshoot max_replicas
            status = self._fleet.status()
        self._check_backpressure(now, status)
        self._check_scale_out(now, status, edges)
        self._check_scale_in(now, status)

    # -- decision paths ------------------------------------------------------

    @staticmethod
    def _live(status):
        """Replicas the fleet is paying for and intends to keep:
        ``starting`` (spawned, warming its ladder) + ``ready``. NOT
        ``replicas_target`` — a non-blocking growth replica joins the
        quorum target only at READY (the fleet's deferred-target rule),
        so counting the target would let the policy re-fire scale-out
        every cooldown while the first new replica is still warming."""
        return sum(
            1
            for pr in status["per_replica"].values()
            if pr["state"] in ("starting", "ready")
        )

    def _check_replace(self, now, status):
        """Respawn for a newly observed death; returns True when a
        replacement was spawned (the caller re-reads fleet status)."""
        dead = status["replicas_dead"]
        if dead <= self._deaths_handled:
            return False
        self._deaths_handled = dead
        self._fleet.scale_up(wait_ready=False)
        after = self._fleet.status()
        self._record(
            now,
            "replace",
            direction="hold",
            rule="poll",
            status=status,
            replicas_after=self._live(after),
            value=dead,
            threshold=None,
            reason=(
                f"replica death #{dead}: respawn while survivors serve "
                f"(wait_ready=False; target unchanged — replacement, not "
                f"growth)"
            ),
        )
        return True

    def _warm_budget(self, status):
        ready = max(1, status["replicas_ready"])
        if self.slo_ms is not None and self.floor_s:
            # the analytical drain budget: backlog the ready replicas
            # can clear inside the SLO at the measured service floor
            return max(1, int(math.floor(
                (self.slo_ms / 1000.0) / self.floor_s * ready
            )))
        return self.warm_queue_budget

    def _check_backpressure(self, now, status):
        live = self._live(status)
        warming = status["replicas_ready"] < live
        budget = self._warm_budget(status)
        if self._backpressure:
            # release hysteresis: once shedding, hold the gate until the
            # backlog drains to half the engage budget — a queue hovering
            # at the budget must not toggle the gate every tick
            want = warming and status["queue_depth"] > max(1, budget // 2)
        else:
            want = warming and status["queue_depth"] > budget
        if want == self._backpressure:
            return
        self._backpressure = want
        self._record(
            now,
            "backpressure_on" if want else "backpressure_off",
            direction="hold",
            rule="poll",
            status=status,
            replicas_after=live,
            value=status["queue_depth"],
            threshold=budget,
            reason=(
                f"backlog {status['queue_depth']} vs drain budget {budget} "
                f"with {status['replicas_ready']}/{live} replicas ready"
                if want
                else "backlog drained under budget or fleet fully ready"
            ),
        )

    def _admitted_rate(self, status):
        last = (status.get("telemetry") or {}).get("rollup", {}).get(
            "last_window"
        )
        if not last:
            return None, None
        rate = (last.get("rates") or {}).get("admitted", {}).get("rate")
        return rate, last.get("window_end")

    def _can_grow(self, now, status):
        if self._live(status) >= self.max_replicas:
            return False
        return (
            self._last_scale_t is None
            or now - self._last_scale_t >= self.out_cooldown_s
        )

    def _check_scale_out(self, now, status, edges):
        trigger = None
        for edge in edges:
            if edge.get("state") != "firing":
                continue
            rule = edge.get("name")
            if rule == "knee_proximity":
                # the rule's threshold is calibrated against ONE
                # replica's measured knee (the engine semantics the
                # evaluator was armed with), so the edge is trusted
                # verbatim only while one replica carries the fleet;
                # past that, fleet-wide admitted rate crossing a
                # single-replica knee says nothing about aggregate
                # headroom — require the capacity-scaled poll criterion
                # to corroborate before buying
                if self._live(status) > 1:
                    rate, _ = self._admitted_rate(status)
                    cap = (self.headroom * self.knee_rps
                           * max(1, self._live(status)))
                    if rate is None or rate <= cap:
                        continue
                trigger = (rule, edge.get("value"), edge.get("threshold"),
                           edge.get("reason"))
                break
            if rule == "error_burn" and status["queue_depth"] > 0:
                trigger = (rule, edge.get("value"), edge.get("threshold"),
                           f"{edge.get('reason')} with p99 burn concentrated "
                           f"in fleet.queue (depth {status['queue_depth']})")
                break
        window_end = None
        if trigger is None:
            rate, window_end = self._admitted_rate(status)
            # size by LIVE replicas (starting + ready): a replica still
            # warming is capacity already bought, and pricing it at zero
            # would re-buy for the same demand every poll until it is
            # READY
            live = max(1, self._live(status))
            cap = self.headroom * self.knee_rps * live
            if rate is not None and rate > cap:
                trigger = (
                    "poll",
                    rate,
                    cap,
                    f"admitted rate {rate:.1f} rps above {self.headroom:g} x "
                    f"knee x {live} live replicas ({cap:.1f} rps)",
                )
        if trigger is None or not self._can_grow(now, status):
            return
        rule, value, threshold, reason = trigger
        self._fleet.scale_up(wait_ready=False)
        after = self._fleet.status()
        self._slack_since = None
        self._record(
            now,
            "scale_out",
            direction="out",
            rule=rule,
            status=status,
            replicas_after=self._live(after),
            value=value,
            threshold=threshold,
            reason=reason,
            window_end=window_end,
        )

    def _check_scale_in(self, now, status):
        rate, window_end = self._admitted_rate(status)
        live = self._live(status)
        remaining = status["replicas_ready"] - 1
        # active alerts veto the drain — EXCEPT knee_proximity, whose
        # threshold is one replica's knee (see _check_scale_out): a
        # multi-replica fleet holds it active whenever fleet-wide rate
        # exceeds one replica's capacity, which is normal operation, not
        # distress; the slack threshold below already prices remaining
        # capacity
        blocking_alerts = {
            name: sev
            for name, sev in status["alerts_active"].items()
            if name != "knee_proximity"
        }
        slack = (
            not blocking_alerts
            and not status["degraded"]
            and status["queue_depth"] == 0
            and status["replicas_ready"] == live  # nothing still warming
            and live > self.min_replicas
            and rate is not None
            and remaining >= 1
            and rate < self.slack_fraction * self.knee_rps * remaining
        )
        if not slack:
            self._slack_since = None
            return
        if self._slack_since is None:
            self._slack_since = now
        if now - self._slack_since < self.slack_hold_s:
            return
        if (
            self._last_scale_t is not None
            and now - self._last_scale_t < self.in_cooldown_s
        ):
            return
        retired = self._fleet.scale_down()
        after = self._fleet.status()
        self._slack_since = None
        self._record(
            now,
            "scale_in",
            direction="in",
            rule="poll",
            status=status,
            replicas_after=self._live(after),
            value=rate,
            threshold=self.slack_fraction * self.knee_rps * remaining,
            reason=(
                f"sustained slack >= {self.slack_hold_s:g}s: admitted "
                f"{rate:.1f} rps under {self.slack_fraction:g} x knee x "
                f"{remaining} remaining replicas; drained replica {retired}"
            ),
            window_end=window_end,
        )

    # -- the evidence trail --------------------------------------------------

    def _record(
        self,
        now,
        decision,
        direction,
        rule,
        status,
        replicas_after,
        value,
        threshold,
        reason,
        window_end=None,
    ):
        flap = False
        if direction in ("out", "in"):
            if (
                self._last_direction is not None
                and self._last_direction != direction
                and self._last_scale_t is not None
                and now - self._last_scale_t < self.flap_window_s
            ):
                flap = True
                self.flaps += 1
            self._last_direction = direction
            self._last_scale_t = now
        if window_end is None:
            _rate, window_end = self._admitted_rate(status)
        record = {
            "direction": direction,
            "rule": rule,
            "t": now,
            "replicas_before": self._live(status),
            "replicas_after": replicas_after,
            "replicas_ready": status["replicas_ready"],
            "queue_depth": status["queue_depth"],
            "window_end": window_end,
            "value": value,
            "threshold": threshold,
            "flap": flap,
            "reason": reason,
            **self.tags,
        }
        self.decisions.append({"decision": decision, **record})
        self._metrics.autoscale(decision, **record)
