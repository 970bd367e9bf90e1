"""The capacity scoreboard: one seeded diurnal trace replayed three
ways, scored against the offline oracle.

    python -m shallowspeed_tpu_torch.serving.bench_replay [--device cuda|cpu] \\
        --checkpoint ckpt.npz --knee-from sweep.json --out scoreboard.json

The port of ``shallowspeed_tpu/serving/bench_replay.py``: the scoring
functions (``oracle_schedule`` .. ``scoreboard_record``) are copies, held
to the JAX module by ``tests/test_torch_replay.py``; the driven legs run
the port's ``ServingFleet`` on ``--device`` (the card unless ``cpu`` is
asked for). ``--aot-cache`` reaches every worker: the replicas share the
AOT program cache (``aot_cache.py``), so a scale-out replica loads the
rung programs the first ones stored.

The three replays of the SAME ``serving/replay.py`` arrival schedule:

- **static**: a fixed fleet sized for the day's peak (the classic
  no-autoscaler provisioning — it pays for the peak all night and
  still drowns in the flash crowd),
- **autoscaled**: ``serving/autoscaler.py`` closing the loop, starting
  from ``min_replicas``,
- **chaos**: the autoscaled leg again with a replica SIGKILLed at the
  peak — the leg whose flap count must be ZERO (a kill answered by a
  replacement is recovery; a kill answered by scale-in/out churn is a
  policy bug).

The OFFLINE ORACLE is computed, not driven: from the recorded rate
trace and the measured knee, the per-bucket minimum feasible fleet
``clamp(ceil(rate / knee), min, max)`` — hindsight with zero reaction
lag. Buckets whose demand exceeds even ``max_replicas`` are marked
infeasible: violation minutes NO policy could have avoided.

SCORING (the two axes of the scoreboard, both vs the oracle):

- **SLO-violation minutes**: per trace bucket, the requests that
  ARRIVED in the bucket are folded into p99 latency + achieved-ok
  rate and judged by ``observability.slo.slo_breach`` — the SAME
  predicate ``bench_serving.find_knee`` uses, so the knee that sized
  the oracle and the scorer that judges the legs can never disagree.
  A breached bucket charges its full width. Backpressure refusals and
  deadline expiries lower the achieved rate, so shed load is charged
  honestly, never hidden.
- **wasted replica-hours**: the integral of ``max(0, fleet(t) -
  oracle(t))`` — capacity paid for that perfect hindsight would not
  have run. Under-provisioning is never credited here; it shows up as
  violations instead.

Both are reported in compressed wall units AND modeled-day units
(compressed x the trace's ``compression``), so "violation minutes" read
on the day the trace stands for.

Determinism (pinned by ``tests/test_torch_replay.py``): every scoring
function in this module is pure — trace + samples + timeline in, the
same record out, byte for byte. Wall-clock enters only through the
driven legs, so a record is a machine-specific artifact whose CAVEATS
name the device, while its verdicts (autoscaled beats static on both
axes, zero chaos flaps) are the machine-checked gate.
"""

import argparse
import json
import math
import sys

from shallowspeed_tpu_torch.observability import slo
from shallowspeed_tpu_torch.observability.metrics import json_safe
from shallowspeed_tpu_torch.observability.stats import percentile
from shallowspeed_tpu_torch.serving.autoscaler import AutoscalePolicy
from shallowspeed_tpu_torch.serving.fleet import ServingFleet
from shallowspeed_tpu_torch.serving.loadgen import (
    payload_in_dim,
    request_payloads,
    run_open_loop,
)
from shallowspeed_tpu_torch.serving.replay import diurnal_trace

SCOREBOARD_VERSION = 1
SCOREBOARD_RECORD = "autoscale_scoreboard"


# -- the offline oracle ------------------------------------------------------


def oracle_schedule(buckets, knee_rps, min_replicas=1, max_replicas=4):
    """The hindsight-optimal replica schedule: per trace bucket, the
    minimum feasible fleet ``ceil(rate / knee)`` clamped to the same
    ``[min, max]`` the policy is allowed — the oracle must not be
    credited with fleets the mechanism could never run. ``infeasible``
    marks buckets whose demand exceeds ``max_replicas`` x knee: their
    width is violation time no schedule could avoid."""
    if knee_rps is None or knee_rps <= 0:
        raise ValueError("oracle needs the measured knee_rps")
    out = []
    for b in buckets:
        required = max(1, int(math.ceil(b["rate_rps"] / knee_rps)))
        out.append(
            {
                "t0": b["t0"],
                "t1": b["t1"],
                "rate_rps": b["rate_rps"],
                "required": required,
                "replicas": min(max(required, min_replicas), max_replicas),
                "infeasible": required > max_replicas,
            }
        )
    return out


def replica_timeline(n0, decisions):
    """The fleet-size step function ``[(t, n), ...]`` a leg ran:
    starting size plus every ``scale_out``/``scale_in`` decision's
    ``replicas_after`` at its decision time. Replacements and
    backpressure toggles don't change the paid-for size (a replacement
    swaps a dead process for a warming one), so they don't appear."""
    timeline = [(0.0, int(n0))]
    for d in decisions:
        if d.get("decision") in ("scale_out", "scale_in"):
            timeline.append((float(d["t"]), int(d["replicas_after"])))
    return timeline


def _segments(timeline, t_end):
    """The step function as closed segments ``[(t0, t1, n), ...]``
    covering ``[0, t_end]``."""
    segs = []
    for i, (t, n) in enumerate(timeline):
        t1 = timeline[i + 1][0] if i + 1 < len(timeline) else t_end
        if t1 > t:
            segs.append((t, min(t1, t_end), n))
    return segs


def replica_seconds(timeline, t_end):
    """Total replica-seconds a leg paid for over ``[0, t_end]``."""
    return sum((t1 - t0) * n for t0, t1, n in _segments(timeline, t_end))


def wasted_replica_seconds(timeline, oracle):
    """Replica-seconds above the oracle: ``integral max(0, fleet(t) -
    oracle(t)) dt``, exact over the piecewise-constant pair (breakpoints
    = oracle bucket edges x timeline steps)."""
    t_end = oracle[-1]["t1"] if oracle else 0.0
    wasted = 0.0
    for t0, t1, n in _segments(timeline, t_end):
        for b in oracle:
            lo, hi = max(t0, b["t0"]), min(t1, b["t1"])
            if hi > lo:
                wasted += max(0, n - b["replicas"]) * (hi - lo)
    return wasted


# -- the violation-minute scorer ---------------------------------------------


def score_samples(
    samples,
    buckets,
    slo_ms,
    achieved_fraction=slo.SLO_ACHIEVED_FRACTION,
):
    """Fold one leg's terminal request samples into per-bucket breach
    verdicts via the SHARED ``slo.slo_breach`` predicate.

    ``samples``: dicts with ``arrival`` (scheduled arrival, trace
    seconds), ``verdict``, ``latency_s`` (None unless ok). Requests are
    charged to the bucket they ARRIVED in — the offered load they were
    part of — with coordinated-omission-corrected latencies, so a
    backlog that drains late still breaches the buckets that caused it.
    Returns the per-bucket rows plus total violation seconds and the
    verdict tallies."""
    rows = []
    violation_s = 0.0
    verdicts = {}
    for s in samples:
        verdicts[s["verdict"]] = verdicts.get(s["verdict"], 0) + 1
    for b in buckets:
        width = b["t1"] - b["t0"]
        inb = [s for s in samples if b["t0"] <= s["arrival"] < b["t1"]]
        lats = [
            s["latency_s"]
            for s in inb
            if s["verdict"] == "ok" and s["latency_s"] is not None
        ]
        n_ok = sum(1 for s in inb if s["verdict"] == "ok")
        p99 = percentile(lats, 99)
        achieved = (n_ok / width) if width > 0 else 0.0
        breach = slo.slo_breach(
            p99,
            b["offered_rps"],
            achieved,
            slo_ms,
            achieved_fraction=achieved_fraction,
        )
        if breach:
            violation_s += width
        rows.append(
            {
                "t0": b["t0"],
                "t1": b["t1"],
                "offered_rps": b["offered_rps"],
                "arrived": len(inb),
                "ok": n_ok,
                "achieved_rps": achieved,
                "p99_latency_s": p99,
                "breach": breach,
            }
        )
    return {"buckets": rows, "violation_s": violation_s, "verdicts": verdicts}


def score_leg(samples, buckets, slo_ms, timeline, oracle, compression=1.0):
    """The full per-leg score: violation minutes (compressed and
    modeled-day) + replica-hours paid and wasted vs the oracle."""
    scored = score_samples(samples, buckets, slo_ms)
    t_end = buckets[-1]["t1"] if buckets else 0.0
    paid_s = replica_seconds(timeline, t_end)
    wasted_s = wasted_replica_seconds(timeline, oracle)
    return {
        **scored,
        "timeline": [{"t": t, "replicas": n} for t, n in timeline],
        "violation_minutes": scored["violation_s"] / 60.0,
        "violation_minutes_modeled": scored["violation_s"] * compression / 60.0,
        "replica_s": paid_s,
        "replica_hours_modeled": paid_s * compression / 3600.0,
        "wasted_replica_s": wasted_s,
        "wasted_replica_hours_modeled": wasted_s * compression / 3600.0,
    }


def oracle_score(oracle, compression=1.0):
    """The oracle's own row on the scoreboard: its replica-hours (the
    spend floor) and the infeasible violation time no policy avoids."""
    violation_s = sum(
        b["t1"] - b["t0"] for b in oracle if b["infeasible"]
    )
    paid_s = sum((b["t1"] - b["t0"]) * b["replicas"] for b in oracle)
    return {
        "buckets": oracle,
        "violation_s": violation_s,
        "violation_minutes": violation_s / 60.0,
        "violation_minutes_modeled": violation_s * compression / 60.0,
        "replica_s": paid_s,
        "replica_hours_modeled": paid_s * compression / 3600.0,
        "wasted_replica_s": 0.0,
        "wasted_replica_hours_modeled": 0.0,
    }


def scoreboard_record(trace, knee_rps, slo_ms, legs, oracle, config=None,
                      caveats=()):
    """Assemble the versioned scoreboard record — pure and
    deterministic: the same inputs produce the same record byte for
    byte (no wall clocks in here; ``tests/test_torch_replay.py`` pins it).
    ``legs`` maps leg name -> ``score_leg`` output (plus any extras the
    runner attached); verdicts compare autoscaled vs static on both
    axes and check the chaos leg's flap count."""
    compression = trace["config"]["compression"]
    verdicts = {}
    if "static" in legs and "autoscaled" in legs:
        verdicts["autoscaled_beats_static_violation_minutes"] = (
            legs["autoscaled"]["violation_s"] < legs["static"]["violation_s"]
        )
        verdicts["autoscaled_beats_static_wasted_replica_hours"] = (
            legs["autoscaled"]["wasted_replica_s"]
            < legs["static"]["wasted_replica_s"]
        )
    if "chaos" in legs:
        verdicts["chaos_zero_flaps"] = legs["chaos"].get("flaps", 0) == 0
    return {
        "bench": SCOREBOARD_RECORD,
        "bench_version": SCOREBOARD_VERSION,
        "config": {
            "knee_rps": knee_rps,
            "slo_ms": slo_ms,
            "trace": trace["config"],
            **(config or {}),
        },
        "trace_buckets": trace["buckets"],
        "compression": compression,
        "oracle": oracle_score(oracle, compression=compression),
        "legs": legs,
        "verdicts": verdicts,
        "caveats": list(caveats),
    }


# -- the driven legs ---------------------------------------------------------


def run_replay_leg(
    worker_config,
    in_dim,
    trace,
    n_replicas,
    slo_ms,
    deadline_ms=None,
    knee_rps=None,
    metrics=None,
    policy_kwargs=None,
    autoscale=False,
    kill_at=None,
    leg="static",
    seed=0,
    rows_choices=(1, 2, 3, 4, 8),
    fleet_retry=2,
):
    """Drive the trace through one fleet configuration; returns
    ``(samples, extras)`` where ``samples`` feed ``score_leg`` and
    ``extras`` carry the leg's fleet stats, decisions, flaps and kill
    evidence. The kill (``kill_at``, trace seconds) SIGKILLs the
    busiest ready replica once — the chaos leg's injected death."""
    arrivals = trace["arrivals"]
    payloads = request_payloads(
        len(arrivals), in_dim, seed=seed, rows_choices=rows_choices
    )
    policy = None
    if autoscale:
        policy = AutoscalePolicy(
            knee_rps=knee_rps,
            metrics=metrics,
            slo_ms=slo_ms,
            tags={"leg": leg},
            **(policy_kwargs or {}),
        )
    fleet = ServingFleet(
        worker_config,
        n_replicas=n_replicas,
        slo_ms=slo_ms,
        retry=fleet_retry,
        metrics=metrics,
        seed=seed,
        knee_rps=knee_rps if autoscale else None,
        alert_sinks=(policy,) if policy is not None else (),
    )
    kill = {"t": None, "replica": None}
    try:
        fleet.start()
        if policy is not None:
            policy.attach(fleet)

        def on_tick(now):
            if kill_at is not None and kill["t"] is None and now >= kill_at:
                ready = [
                    info
                    for info in fleet.replicas.values()
                    if info.state == "ready"
                ]
                if ready:
                    victim = max(
                        ready, key=lambda r: (r.inflight, -r.replica_id)
                    )
                    kill["t"] = now
                    kill["replica"] = victim.replica_id
                    fleet.sigkill_replica(victim.replica_id)
            if policy is not None:
                policy.tick(now)

        t0 = fleet.clock()
        done = run_open_loop(
            fleet,
            payloads,
            arrivals,
            deadline_ms=deadline_ms,
            on_tick=on_tick if (policy is not None or kill_at is not None)
            else None,
        )
        stats = fleet.stats()
    finally:
        fleet.stop()
    samples = [
        {
            "arrival": r.enqueue_t - t0,
            "t": None if r.complete_t is None else r.complete_t - t0,
            "verdict": r.verdict,
            "latency_s": r.latency_s,
        }
        for r in done
    ]
    extras = {
        "leg": leg,
        "n_replicas_start": n_replicas,
        "stats_summary": {
            k: stats.get(k)
            for k in (
                "completed", "dropped", "expired", "errors", "unhealthy",
                "availability", "p50_latency_s", "p99_latency_s",
                "failovers", "failover_requeued", "scale_ups", "scale_downs",
                "replicas_dead", "replicas_retired", "degraded",
            )
        },
        "gate_dropped": stats.get("gate_dropped"),
        "decisions": list(policy.decisions) if policy is not None else [],
        "flaps": policy.flaps if policy is not None else 0,
        "backpressure_events": (
            sum(
                1
                for d in (policy.decisions if policy is not None else [])
                if d["decision"] == "backpressure_on"
            )
        ),
        "kill_t": kill["t"],
        "killed_replica": kill["replica"],
    }
    return samples, extras


# -- CLI ---------------------------------------------------------------------


def _knee_from_sweep(path):
    with open(path, encoding="utf-8") as f:
        record = json.load(f)
    knee = record.get("knee_rps")
    if knee is None:
        raise SystemExit(
            f"{path}: sweep record has no knee (knee_rps null) — sweep "
            f"higher rates; the scoreboard needs a measured knee"
        )
    slo_ms = record.get("slo_ms")
    if slo_ms is None:
        slo_ms = (record.get("config") or {}).get("slo_ms")
    return float(knee), slo_ms


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.serving.bench_replay",
        description="capacity scoreboard: diurnal replay x "
        "{static, autoscaled, chaos} vs the offline oracle"
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument(
        "--schedule",
        choices=["naive", "gpipe", "pipedream", "interleaved"],
        default="gpipe",
    )
    ap.add_argument("--global-batch-size", type=int, default=8)
    ap.add_argument("--mubatches", type=int, default=1)
    ap.add_argument("--aot-cache", default=None, metavar="DIR")
    ap.add_argument("--max-slots", type=int, default=None)
    ap.add_argument(
        "--dispatch-floor-ms",
        type=float,
        default=0.0,
        help="per-dispatch service-time floor for every replica worker "
        "(engine.py 'dispatch floor'): on a CPU testbed it makes a "
        "replica's capacity slot-concurrency-bound so fleet capacity "
        "scales with replica count; pass the SAME value the knee sweep "
        "was measured with",
    )
    ap.add_argument("--reload-dir", default=None)
    ap.add_argument(
        "--knee-from",
        default=None,
        metavar="SWEEP_JSON",
        help="read the measured knee_rps (and slo_ms default) from a "
        "bench_serving sweep record — the measurement-before-mechanism "
        "path",
    )
    ap.add_argument(
        "--knee-rps",
        type=float,
        default=None,
        help="explicit knee override (recorded as a caveat: the "
        "scoreboard prefers the measured sweep)",
    )
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", default="1,2,3,4,8")
    ap.add_argument(
        "--day-s",
        type=float,
        default=90.0,
        help="compressed day length in wall seconds (the trace records "
        "the compression factor vs a real 24h day)",
    )
    ap.add_argument(
        "--base-frac",
        type=float,
        default=0.35,
        help="trough demand as a fraction of the measured knee",
    )
    ap.add_argument(
        "--peak-frac",
        type=float,
        default=1.4,
        help="diurnal peak demand as a fraction of the knee",
    )
    ap.add_argument("--spike-mult", type=float, default=2.0)
    ap.add_argument("--n-spikes", type=int, default=1)
    ap.add_argument("--bucket-s", type=float, default=None,
                    help="rate-trace bucket width (default day_s/30)")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=3)
    ap.add_argument(
        "--static-replicas",
        type=int,
        default=None,
        help="static leg size (default: peak-sized — "
        "clamp(ceil(peak demand / knee)))",
    )
    ap.add_argument(
        "--kill-at-frac",
        type=float,
        default=0.55,
        help="chaos leg: SIGKILL the busiest replica at this fraction "
        "of the day",
    )
    ap.add_argument(
        "--skip-chaos", action="store_true",
        help="score static vs autoscaled only (no kill leg)",
    )
    ap.add_argument("--out", default=None,
                    help="write the scoreboard record here")
    ap.add_argument(
        "--metrics-out",
        default=None,
        help="JSONL sink: autoscale decisions + request/rollup/alert "
        "streams for all legs (the report CLI's Capacity evidence)",
    )
    args = ap.parse_args(argv)

    from shallowspeed_tpu_torch.observability import JsonlMetrics

    caveats = []
    if args.knee_from:
        knee_rps, sweep_slo = _knee_from_sweep(args.knee_from)
        if args.slo_ms is None:
            args.slo_ms = sweep_slo
    elif args.knee_rps:
        knee_rps = args.knee_rps
        caveats.append(
            "knee_rps passed by hand (--knee-rps), not measured by a "
            "bench_serving sweep on this machine"
        )
    else:
        raise SystemExit("need --knee-from SWEEP_JSON or --knee-rps")
    if args.slo_ms is None:
        raise SystemExit("need --slo-ms (or a sweep record that carries it)")
    if args.device == "cpu":
        caveats.append(
            "--device cpu: replica workers run the plain PyTorch path on "
            "the host's CPU — absolute rates/latencies are "
            "machine-specific; the scoreboard's comparisons (static vs "
            "autoscaled vs oracle) replay the identical seeded trace, "
            "which is what the verdicts gate on"
        )
    if args.dispatch_floor_ms:
        caveats.append(
            f"dispatch_floor_ms={args.dispatch_floor_ms:g}: replica "
            "service time is padded to a fixed floor (engine.py "
            "'dispatch floor') so per-replica capacity is "
            "slot-concurrency-bound and fleet capacity scales with "
            "replica count even on a single-core host; on accelerators "
            "the model forward provides this floor natively"
        )

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    rows_choices = tuple(int(r) for r in args.rows.split(",") if r.strip())
    trace = diurnal_trace(
        day_s=args.day_s,
        base_rps=args.base_frac * knee_rps,
        peak_rps=args.peak_frac * knee_rps,
        seed=args.seed,
        n_spikes=args.n_spikes,
        spike_mult=args.spike_mult,
        bucket_s=args.bucket_s if args.bucket_s else args.day_s / 30.0,
    )
    oracle = oracle_schedule(
        trace["buckets"], knee_rps,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
    )
    static_n = args.static_replicas
    if static_n is None:
        static_n = min(
            max(int(math.ceil(args.peak_frac)), args.min_replicas),
            args.max_replicas,
        )
    if metrics is not None:
        metrics.event(
            "replay_trace",
            seed=args.seed,
            day_s=args.day_s,
            knee_rps=knee_rps,
            n_arrivals=trace["config"]["n_arrivals"],
            compression=trace["config"]["compression"],
            buckets=[
                {"t0": b["t0"], "t1": b["t1"], "rate_rps": b["rate_rps"],
                 "offered_rps": b["offered_rps"]}
                for b in trace["buckets"]
            ],
            spikes=trace["config"]["spikes"],
        )

    worker_config = {
        "session": dict(
            dp=args.dp,
            pp=args.pp,
            tp=args.tp,
            schedule=args.schedule,
            global_batch_size=args.global_batch_size,
            mubatches=args.mubatches,
            data_dir=args.data_dir,
            resume=args.checkpoint,
            aot_cache_dir=args.aot_cache,
            device=args.device,
        ),
        "engine": dict(
            max_slots=args.max_slots,
            slo_ms=args.slo_ms,
            reload_dir=args.reload_dir,
            dispatch_floor_ms=args.dispatch_floor_ms,
        ),
    }
    in_dim = payload_in_dim(args.data_dir)
    # policy cadences scaled to the compressed day: eager out, slow in
    # (the hysteresis), flap window under the scale-in cooldown so a
    # cooldown-respecting reversal is legitimate, not a flap
    policy_kwargs = dict(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        out_cooldown_s=args.day_s / 45.0,
        in_cooldown_s=args.day_s / 10.0,
        slack_hold_s=args.day_s / 20.0,
        slack_fraction=0.6,
        flap_window_s=args.day_s / 12.0,
        floor_s=(
            args.dispatch_floor_ms / 1000.0
            if args.dispatch_floor_ms
            else None
        ),
    )
    compression = trace["config"]["compression"]

    leg_specs = [
        ("static", dict(n_replicas=static_n, autoscale=False)),
        (
            "autoscaled",
            dict(n_replicas=args.min_replicas, autoscale=True,
                 policy_kwargs=policy_kwargs),
        ),
    ]
    if not args.skip_chaos:
        leg_specs.append(
            (
                "chaos",
                dict(
                    n_replicas=args.min_replicas,
                    autoscale=True,
                    policy_kwargs=policy_kwargs,
                    kill_at=args.kill_at_frac * args.day_s,
                ),
            )
        )
    legs = {}
    for leg, kw in leg_specs:
        print(f"replaying leg {leg!r} ({trace['config']['n_arrivals']} "
              f"arrivals over {args.day_s:g}s)...")
        samples, extras = run_replay_leg(
            worker_config,
            in_dim,
            trace,
            slo_ms=args.slo_ms,
            deadline_ms=args.deadline_ms,
            knee_rps=knee_rps,
            metrics=metrics,
            seed=args.seed,
            rows_choices=rows_choices,
            leg=leg,
            **kw,
        )
        timeline = replica_timeline(
            kw["n_replicas"], extras["decisions"]
        )
        legs[leg] = {
            **score_leg(
                samples, trace["buckets"], args.slo_ms, timeline, oracle,
                compression=compression,
            ),
            **extras,
        }
        if metrics is not None:
            metrics.event(
                "replay_score",
                leg=leg,
                violation_s=legs[leg]["violation_s"],
                violation_minutes_modeled=legs[leg][
                    "violation_minutes_modeled"
                ],
                wasted_replica_s=legs[leg]["wasted_replica_s"],
                wasted_replica_hours_modeled=legs[leg][
                    "wasted_replica_hours_modeled"
                ],
                flaps=legs[leg]["flaps"],
            )

    record = scoreboard_record(
        trace,
        knee_rps,
        args.slo_ms,
        legs,
        oracle,
        config={
            "knee_source": args.knee_from or "--knee-rps",
            "seed": args.seed,
            "deadline_ms": args.deadline_ms,
            "dispatch_floor_ms": args.dispatch_floor_ms,
            "max_slots": args.max_slots,
            "min_replicas": args.min_replicas,
            "max_replicas": args.max_replicas,
            "static_replicas": static_n,
            "policy": policy_kwargs,
            "kill_at_s": (
                None if args.skip_chaos else args.kill_at_frac * args.day_s
            ),
        },
        caveats=caveats,
    )
    # the driven legs' sample rows stay out of the committed artifact
    # (they are per-machine noise); the per-bucket verdicts remain
    text = json.dumps(json_safe(record), indent=2, allow_nan=False)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"capacity scoreboard written: {args.out}")
    else:
        print(text)
    for leg in legs:
        print(
            f"  {leg}: {legs[leg]['violation_minutes_modeled']:.0f} modeled "
            f"violation-min, {legs[leg]['wasted_replica_hours_modeled']:.1f} "
            f"wasted replica-h, {legs[leg]['flaps']} flap(s), "
            f"{len(legs[leg]['decisions'])} decision(s)"
        )
    print(
        f"  oracle: "
        f"{record['oracle']['violation_minutes_modeled']:.0f} modeled "
        f"violation-min (infeasible demand), "
        f"{record['oracle']['replica_hours_modeled']:.1f} replica-h floor"
    )
    if metrics is not None:
        metrics.close()
        print(f"telemetry written: {metrics.path} (+ .r* replica shards)")
    failures = [
        name for name, ok in record["verdicts"].items() if not ok
    ]
    if failures:
        print("capacity scoreboard FAILED: " + ", ".join(failures),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
