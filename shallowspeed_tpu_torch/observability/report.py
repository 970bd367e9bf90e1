"""Run report generator: render a metrics JSONL into a human/CI report.

Copied from ``shallowspeed_tpu/observability/report.py``: the same text
for the same file, so a port run and a JAX run render alike. Two lines
differ. ``format_bytes`` is a local copy (``program_audit`` is not
ported), and the Tracing section needs ``observability.tracing``, which
comes with the rest of serving: a stream holding ``trace`` records (the
JAX package's serving fleet writes them) renders without that section
and says so.

    python -m shallowspeed_tpu_torch.observability.report run.jsonl \
        [--baseline other.jsonl|BENCH.json] [--format md|text|json] \
        [--threshold 0.10]

Reads a schema-v1 or -v2 metrics stream (``read_jsonl`` — a v2 reader
accepts v1 files; see metrics.py's compatibility rules) and reports what a
human or a bench gate actually asks of a run:

- steady-state training throughput (epoch records flagged
  ``includes_compile`` are excluded — their wall clock is compile, not
  training; if ONLY such records exist the report says so rather than
  silently quoting a compile-polluted number);
- the compiled-program audit (schema-v3 ``xla_audit`` records,
  ``train.py --audit``): a MEMORY section (peak HBM vs per-chip capacity
  -> headroom, or an OOM forecast when the program exceeds it) and a
  COMMS section (collective census vs the layout contract, analytical
  bytes/step per device, bandwidth-bound lower-bound step time vs the
  compute lower bound -> comms- vs compute-bound verdict, the serial
  ``comm + compute`` vs overlapped ``max(comm, compute)`` step bounds,
  and the gradient-sync mode — anchor or N byte-buckets);
- an OVERLAP EFFICIENCY row — the hidden-comm share
  ``1 - exposed_comm / total_comm``: measured from a profiler trace's
  comm/compute split when ``--trace`` points at one
  (``observability.trace_stats``), else the comms model's
  perfect-overlap bound from the audit record;
- MFU + achieved FLOP/s and the cost-model cross-check (analytical vs
  XLA-reported FLOPs), with the peak's provenance so a nominal-CPU MFU
  cannot pass for a datasheet one;
- the span breakdown (where the host-side wall time went);
- the pipeline program's bubble fraction (mesh layouts) — equal-weight AND
  FLOP-weighted (the weighted row is what moves under ``--backward-split``:
  deferred B-weights pack into bubble ticks, see docs/lowering.md);
- a step-loss sparkline from the flight-recorder ``step`` records;
- the numerics health verdict (ok / N findings / halted-at-step);
- a RELIABILITY section (schema-v4 ``checkpoint``/``recovery`` records):
  checkpoint count + cadence + the overhead fraction (checkpoint wall
  over checkpoint + train-dispatch wall), and the recovery verdict —
  what was restored, every corrupt snapshot skipped, and the steps lost
  to replay when the stream holds the killed run's step records (feed
  the killed run's JSONL and the resumed run's concatenated, as
  ``make recovery-smoke`` does, and the loss is measured, not guessed);
- a SERVING section (schema-v5 ``request``/``serving`` records, the
  serving engine's evidence stream): completions + drops, p50/p99
  latency next to the analytical latency floor (inference ticks x
  per-tick cost), offered vs achieved vs goodput rates, queue depth,
  padding waste, and the SLO verdict against ``--slo-ms`` (or the
  summary record's own threshold) — plus a DEGRADATION subsection
  (schema-v6 ``serving_health``/``reload`` records and the terminal
  failure verdicts): shed/error/unhealthy counts, injected faults,
  breaker trips + hot reloads, the measured recovery time, and the
  availability verdict. Clean runs and pre-v6 files render unchanged;
- a FLEET section (schema-v7 ``fleet``/``fleet_health`` records, the
  serving fleet's evidence stream): replica lifecycle (started / died /
  retired, SIGKILLs injected by the chaos soak), failover count + the
  in-flight requests re-queued, verdict reroutes, elasticity (scale-ups
  with the measured ready time), per-replica routing counts + the
  routing skew, per-replica verdict rows (join the ``.r{replica_id}``
  JSONL shards on ``replica_id`` for each replica's own request
  stream — pass a glob like ``fleet.jsonl*`` to merge them), and the
  fleet availability verdict. Single-engine runs and pre-v7 files
  render unchanged;
- a TRACING section (schema-v10 ``trace`` records joined by
  ``observability.tracing``, docs/observability.md § Tracing): span
  chains assembled across the parent + ``.r*`` shards with the
  handshake-recorded per-replica clock offsets (shown with their
  uncertainty), the chain-completeness verdict (orphan/unclosed chains
  for terminal requests are NAMED, never glossed), aggregate phase
  attribution — mean and p99-CONDITIONAL (which phase dominates the
  slowest 1%, the makespan-quantization scoreboard) — SLO burn per
  phase, and per-request text waterfalls for the worst-k requests.
  Trace-free files render unchanged. A ``dispatch_overhead`` event (the
  ``train.py --dispatch-probe`` measured op-issue roofline) renders as
  its own summary row, flagged ``WINDOW INVALID`` when the probe's
  machine-checked validity guard refused the window (saturated trace
  buffer / no op events — the share must not be quoted clean);
- an ALERTS section (schema-v11 ``rollup``/``alert`` records,
  docs/observability.md § Live telemetry & alerting): the SLO alert
  firing→resolved timeline with peak burn rates and the still-firing
  set at end of stream, a FALSE-ALERT verdict (every fired rule is
  checked against the fault evidence that would justify it — chaos runs
  must alert, clean runs must not, and an unbacked firing is named),
  and rollup-backed trend sparklines (per-window throughput, p99
  latency, training loss). Pre-v11 files render unchanged.

``--baseline`` compares throughput against another run's JSONL or a
bench-style JSON record (``{"value": ..., "unit": "samples/s"}``, or a
tpu_capture artifact's ``headline_best_sps``). A regression beyond
``--threshold`` (default 10%) exits **2** — the CI/bench gate contract;
malformed inputs exit 1; a clean report exits 0.
"""

import argparse
import json
import math
import sys
from pathlib import Path

from shallowspeed_tpu_torch.observability.metrics import json_safe, read_jsonl
from shallowspeed_tpu_torch.observability.stats import percentile



def format_bytes(n):
    """Human-readable byte count (``program_audit.format_bytes``)."""
    if n is None or not isinstance(n, (int, float)) or not math.isfinite(n):
        return "n/a"
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(n) >= div:
            return f"{n / div:,.2f} {unit}"
    return f"{n:,.0f} B"


BLOCKS = "▁▂▃▄▅▆▇█"  # ▁▂▃▄▅▆▇█


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


def _median(vals):
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return None
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def sparkline(values, width=60):
    """Unicode sparkline, mean-pooled down to ``width`` buckets; non-finite
    samples render as ``x`` (a blown-up step must be visible, not blank)."""
    values = list(values)
    if not values:
        return ""
    if len(values) > width:
        # mean-pool each bucket; a bucket with any non-finite sample is x
        buckets = []
        for b in range(width):
            lo = b * len(values) // width
            hi = max(lo + 1, (b + 1) * len(values) // width)
            chunk = values[lo:hi]
            buckets.append(
                sum(chunk) / len(chunk) if all(_finite(v) for v in chunk)
                else float("nan")
            )
        values = buckets
    finite = [v for v in values if _finite(v)]
    if not finite:
        return "x" * len(values)
    vmin, vmax = min(finite), max(finite)
    span = vmax - vmin
    out = []
    for v in values:
        if not _finite(v):
            out.append("x")
        elif span <= 0:
            out.append(BLOCKS[3])
        else:
            out.append(BLOCKS[int((v - vmin) / span * (len(BLOCKS) - 1))])
    return "".join(out)


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


def build_report(records, source="", trace=None, slo_ms=None):
    """Fold a record stream into the JSON-able report dict every renderer
    (and the baseline comparison) consumes. ``trace``: an optional
    ``trace_stats.summarize`` dict — its measured comm/compute split
    upgrades the overlap-efficiency row from the model bound to a
    measurement. ``slo_ms``: the CLI's latency objective — overrides the
    serving summary's own threshold for the Serving section's SLO
    verdict."""
    epochs = [
        r for r in records if r.get("kind") == "event" and r.get("name") == "epoch"
    ]
    steady = [r for r in epochs if not r.get("includes_compile")]
    pool = steady or epochs
    sps = [r["samples_per_sec"] for r in pool if _finite(r.get("samples_per_sec"))]
    throughput = _median(sps)

    gauges = {}
    for r in records:
        if r.get("kind") == "gauge":
            gauges[r.get("name")] = r.get("value")  # last value wins

    spans = {}
    for r in records:
        if r.get("kind") == "span" and _finite(r.get("seconds")):
            agg = spans.setdefault(r.get("name"), {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += r["seconds"]
    span_rows = sorted(
        (
            {"name": n, "count": a["count"], "total_s": round(a["total_s"], 4)}
            for n, a in spans.items()
        ),
        key=lambda row: -row["total_s"],
    )

    steps = [r for r in records if r.get("kind") == "step"]
    step_losses = [r.get("loss") for r in steps]
    finite_losses = [v for v in step_losses if _finite(v)]

    cost = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "cost_model":
            cost = {
                k: v for k, v in r.items() if k not in ("v", "ts", "kind", "name")
            }

    audit = None
    audit_is_epoch = False
    for r in records:
        if r.get("kind") == "xla_audit":
            # last record wins, but prefer the epoch program over the fused
            # run (its census is the canonical per-step story): i.e. the
            # LAST epoch_program record, else the last audit of any name
            is_epoch = r.get("name") == "epoch_program"
            if is_epoch or not audit_is_epoch:
                audit = {k: v for k, v in r.items() if k not in ("v", "ts", "kind")}
                audit_is_epoch = audit_is_epoch or is_epoch

    prog = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "pipeline_program":
            prog = r
    bubble = (
        prog.get("bubble_fraction") if prog else gauges.get("pipeline.bubble_fraction")
    )
    # the FLOP-weighted bubble: the number that can see the
    # split-backward win — a combined backward tick costs 2x a forward's
    # work, so equal-weight cells under-state heavy-tick bubbles
    weighted_bubble = prog.get("weighted_bubble_fraction") if prog else None
    backward_split = bool(prog.get("backward_split")) if prog else False
    # the per-model activation-stash story: program_stats derives
    # the peak from the real spec's padded slot shapes and the actual tick
    # tables; a recompute run also carries its stashed twin's peak so the
    # Memory section can render the saving side by side from ONE stream
    stash_memory = None
    if prog and prog.get("stash_bytes_peak") is not None:
        stash_memory = {
            "model": prog.get("model"),
            "recompute": bool(prog.get("recompute")),
            "stash_slots": prog.get("stash_slots"),
            "xin_slots": prog.get("xin_slots"),
            "grad_stash_slots": prog.get("grad_stash_slots"),
            "stash_bytes_per_slot": prog.get("stash_bytes_per_slot"),
            "xin_bytes_per_slot": prog.get("xin_bytes_per_slot"),
            "stash_bytes_peak": prog.get("stash_bytes_peak"),
            "stash_bytes_peak_stashed_twin": prog.get(
                "stash_bytes_peak_stashed_twin"
            ),
            "stash_slots_stashed_twin": prog.get("stash_slots_stashed_twin"),
        }

    findings = [r for r in records if r.get("kind") == "health"]
    halted = [f for f in findings if f.get("action") == "halt"]
    by_check = {}
    for f in findings:
        by_check[f.get("name")] = by_check.get(f.get("name"), 0) + 1
    if halted:
        f = halted[0]
        where = f"epoch {f.get('epoch')}"
        if f.get("step") is not None:
            where += f", step {f.get('step')}"
        verdict = f"HALTED: {f.get('name')} at {where}"
    elif findings:
        verdict = f"{len(findings)} finding(s): " + ", ".join(
            f"{k} x{v}" for k, v in sorted(by_check.items())
        )
    else:
        verdict = "ok"

    # MFU: prefer the last steady epoch record's own field (per-epoch
    # truth), fall back to the last gauge; when only compile-polluted
    # records exist the MFU inherits their caveat (rendered alongside)
    mfu = None
    for r in pool:
        if _finite(r.get("mfu")):
            mfu = r["mfu"]
    if mfu is None and _finite(gauges.get("mfu")):
        mfu = gauges["mfu"]
    mfu_includes_compile = mfu is not None and bool(epochs) and not steady

    last_epoch = epochs[-1] if epochs else {}
    accuracy = last_epoch.get("accuracy")
    if accuracy is None:
        accuracy = gauges.get("val_accuracy")

    overlap = _overlap_info(audit, trace)
    reliability = _reliability_info(records, spans)
    serving = _serving_info(records, slo_ms)
    fleet = _fleet_info(records)
    static_analysis = _static_analysis_info(records)
    tracing_info = _tracing_info(records, slo_ms)
    alerts = _alerts_info(records)
    rollups = _rollups_info(records)
    divergence = _divergence_info(records)
    capacity = _capacity_info(records)

    dispatch_overhead = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "dispatch_overhead":
            dispatch_overhead = {
                k: v for k, v in r.items() if k not in ("v", "ts", "kind", "name")
            }

    return {
        "source": source,
        "schema_versions": sorted({r.get("v", 0) for r in records}),
        "epochs": len(epochs),
        "steady_epochs": len(steady),
        "throughput_samples_per_sec": throughput,
        "throughput_includes_compile": bool(epochs) and not steady,
        "final_loss": last_epoch.get("loss"),
        "final_accuracy": accuracy,
        "mfu": mfu,
        "mfu_includes_compile": mfu_includes_compile,
        "achieved_flops_per_sec": gauges.get("achieved_flops_per_sec"),
        "cost_model": cost,
        "xla_audit": audit,
        "overlap": overlap,
        "bubble_fraction": bubble,
        "weighted_bubble_fraction": weighted_bubble,
        "backward_split": backward_split,
        "stash_memory": stash_memory,
        "spans": span_rows,
        "steps": len(steps),
        "step_loss_sparkline": sparkline(step_losses) if steps else None,
        "step_loss": (
            {
                "first": step_losses[0],
                "last": step_losses[-1],
                "min": min(finite_losses) if finite_losses else None,
                "max": max(finite_losses) if finite_losses else None,
                "non_finite": len(step_losses) - len(finite_losses),
            }
            if steps
            else None
        ),
        "health": {
            "verdict": verdict,
            "findings": len(findings),
            "by_check": by_check,
            "halted": bool(halted),
        },
        "reliability": reliability,
        "serving": serving,
        "fleet": fleet,
        "static_analysis": static_analysis,
        "tracing": tracing_info,
        "alerts": alerts,
        "rollups": rollups,
        "divergence": divergence,
        "capacity": capacity,
        "dispatch_overhead": dispatch_overhead,
    }


# the fault evidence that JUSTIFIES each alert rule's firing: an alert
# with none of its evidence kinds anywhere in the stream is a FALSE
# alert (the alerts-smoke clean-twin contract — chaos runs must alert,
# clean runs must not, and a firing nobody can trace to a fault is
# named, never glossed). predicate(record) -> the record is evidence.
_ALERT_EVIDENCE = {
    "breaker_open": lambda r: (
        r.get("kind") == "serving_health" and r.get("name") == "breaker_open"
    ),
    "fleet_degraded": lambda r: (
        r.get("kind") == "fleet_health" and r.get("name") == "fleet_degraded"
    ),
    "error_burn": lambda r: (
        r.get("kind") == "request" and r.get("name") in ("error", "unhealthy")
    ),
    "p99_slo": lambda r: r.get("kind") == "request",
    "knee_proximity": lambda r: r.get("kind") == "request",
    "training_health": lambda r: r.get("kind") == "health",
    "checkpoint_overhead": lambda r: r.get("kind") == "checkpoint",
}


def _alerts_info(records):
    """Fold the schema-v11 ``alert`` records into the Alerts story; None
    when the run recorded none (pre-v11 files render exactly as
    before). The firing→resolved timeline, the still-firing set at end
    of stream (per rule + replica), the peak burn rates seen at any
    transition, and the false-alert verdict: every fired rule is checked
    against the fault evidence that would justify it."""
    alerts = [r for r in records if r.get("kind") == "alert"]
    if not alerts:
        return None
    timeline = []
    active = {}  # (rule, replica_id) -> last transition record
    fired = resolved = 0
    peak_fast = peak_slow = None
    for r in alerts:
        state = r.get("state")
        if state == "firing":
            fired += 1
        elif state == "resolved":
            resolved += 1
        for key, peak in (("burn_fast", "fast"), ("burn_slow", "slow")):
            v = r.get(key)
            if _finite(v):
                if peak == "fast":
                    peak_fast = v if peak_fast is None else max(peak_fast, v)
                else:
                    peak_slow = v if peak_slow is None else max(peak_slow, v)
        entry = {
            "rule": r.get("name"),
            "state": state,
            "severity": r.get("severity"),
            "t": r.get("t"),
            "value": r.get("value"),
            "threshold": r.get("threshold"),
            "reason": r.get("reason"),
            "replica_id": r.get("replica_id"),
        }
        timeline.append(entry)
        k = (entry["rule"], entry["replica_id"])
        if state == "firing":
            active[k] = entry
        else:
            active.pop(k, None)
    false_alerts = []
    for rule in sorted({e["rule"] for e in timeline if e["state"] == "firing"}):
        evidence = _ALERT_EVIDENCE.get(rule)
        if evidence is not None and not any(evidence(r) for r in records):
            false_alerts.append(rule)
    return {
        "transitions": len(timeline),
        "fired": fired,
        "resolved": resolved,
        "timeline": timeline,
        "still_firing": sorted(
            f"{rule}" + (f" (r{rid})" if rid is not None else "")
            for rule, rid in active
        ),
        "peak_burn_fast": peak_fast,
        "peak_burn_slow": peak_slow,
        "false_alerts": false_alerts,
    }


def _rollups_info(records):
    """Fold the schema-v11 ``rollup`` records into per-source trend
    series; None when the run recorded none. Sources are keyed
    ``name`` or ``name (rN)`` for replica-tagged shards; each carries
    the per-window terminal/step rate and p99 latency — the evidence
    behind the trend sparklines."""
    rollups = [r for r in records if r.get("kind") == "rollup"]
    if not rollups:
        return None
    by_source = {}
    for r in rollups:
        rid = r.get("replica_id")
        key = r.get("name", "?") + (f" (r{rid})" if rid is not None else "")
        by_source.setdefault(key, []).append(r)
    sources = {}
    for key, recs in sorted(by_source.items()):
        recs = sorted(
            recs, key=lambda r: (r.get("window_start") or 0, r.get("seq") or 0)
        )
        rates = []
        p99s = []
        losses = []
        for r in recs:
            rr = r.get("rates") or {}
            rate = (rr.get("terminal") or {}).get("rate")
            if rate is None:
                rate = (rr.get("steps") or {}).get("rate")
            rates.append(rate if _finite(rate) else 0.0)
            p99 = ((r.get("quantiles") or {}).get("latency_s") or {}).get(
                "p99"
            )
            if _finite(p99):
                p99s.append(p99)
            loss = ((r.get("gauges") or {}).get("loss") or {}).get("last")
            if _finite(loss):
                losses.append(loss)
        sources[key] = {
            "windows": len(recs),
            "window_s": recs[-1].get("window_s"),
            "late": sum(int(r.get("late") or 0) for r in recs),
            "rate_trend": rates,
            "p99_latency_s": (max(p99s) if p99s else None),
            "p99_trend": p99s or None,
            "loss_trend": losses or None,
        }
    return {"windows": len(rollups), "sources": sources}


def _tracing_info(records, slo_ms=None):
    """The schema-v10 ``trace`` records' count; None when the run recorded
    none. The JAX report assembles them into chains with
    ``observability.tracing``, which the port has not ported yet (it comes
    with the rest of serving), so the port names what it cannot render
    instead of rendering half a story."""
    spans = sum(
        1
        for r in records
        if r.get("kind") == "trace" and r.get("name") != "clock_offset"
    )
    if not any(r.get("kind") == "trace" for r in records):
        return None
    return {"unrendered": True, "spans": spans}


def _static_analysis_info(records):
    """Fold the schema-v9 ``static_analysis`` records into the one-line
    Static checks verdict; None when the run recorded none (pre-v9 files
    render exactly as before). One verdict per distinct program name —
    last record wins, so a refused-then-fixed rerun reads fixed."""
    by_program = {}
    for r in records:
        if r.get("kind") == "static_analysis":
            by_program[r.get("name")] = r
    if not by_program:
        return None
    passes = set()
    total = 0
    texts = []
    for name, r in sorted(by_program.items()):
        passes.update(r.get("passes") or ())
        n = int(r.get("findings") or 0)
        total += n
        if not n:
            continue
        # compile-time passes carry ONE refusal text ("finding"); a lint
        # run carries the per-finding lines ("finding_lines") — render
        # whichever evidence the record holds, never an unnamed count
        lines = r.get("finding_lines") or (
            [r["finding"]] if r.get("finding") else []
        )
        if lines:
            texts.extend(f"{name}: {line}" for line in lines)
        else:
            texts.append(f"{name}: {n} finding(s)")
    return {
        "programs": sorted(by_program),
        "passes": sorted(passes),
        "findings": total,
        "finding_text": texts,
    }


def _reliability_info(records, spans):
    """Fold the schema-v4 ``checkpoint``/``recovery`` records into the
    Reliability story; None when the run recorded neither (the section is
    then omitted — pre-v4 files render exactly as before).

    ``steps lost to replay`` is measured from EVIDENCE, never guessed: it
    needs the killed run's ``step`` records in the same stream before the
    recovery record (concatenate killed + resumed JSONL), and is the gap
    between the last step the dead run trained and the step the restore
    landed on. Without that evidence the field stays None (rendered as
    unknown)."""
    ckpts = [r for r in records if r.get("kind") == "checkpoint"]
    aot = _aot_cache_info(records)
    recoveries = []
    max_step_before = None
    last_step = None
    for r in records:
        if r.get("kind") == "step" and isinstance(r.get("step"), (int, float)):
            last_step = max(last_step or 0, int(r["step"]))
        elif r.get("kind") == "recovery":
            recoveries.append(r)
            max_step_before = last_step
    if not ckpts and not recoveries and aot is None:
        return None
    # for async saves (schema v8) wall_s is the ON-PATH cost only — the
    # snapshot + bounded-queue enqueue — so the overhead fraction below
    # automatically becomes the async scoreboard: same formula, the
    # off-path verify/write walls accounted separately
    ckpt_wall = sum(r["wall_s"] for r in ckpts if _finite(r.get("wall_s")))
    async_ckpts = [r for r in ckpts if r.get("async")]
    off_path_s = sum(
        (r.get("verify_s") or 0.0) + (r.get("write_s") or 0.0)
        for r in async_ckpts
        if _finite(r.get("verify_s")) or _finite(r.get("write_s"))
    )
    train_wall = sum(
        a["total_s"]
        for n, a in spans.items()
        if n in ("train_epoch", "train_steps", "train_run")
    )
    overhead = (
        ckpt_wall / (ckpt_wall + train_wall)
        if (ckpt_wall + train_wall) > 0
        else None
    )
    gsteps = sorted(
        int(r["global_step"]) for r in ckpts
        if isinstance(r.get("global_step"), (int, float))
    )
    cadence = None
    if len(gsteps) >= 2:
        deltas = [b - a for a, b in zip(gsteps, gsteps[1:])]
        cadence = _median(deltas)
    recovery = None
    if recoveries:
        rec = recoveries[-1]  # the decision that produced THIS run's state
        steps_lost = None
        resumed_at = rec.get("global_step")
        if isinstance(resumed_at, (int, float)) and max_step_before is not None:
            # the killed run's evidence IS in this stream — a kill that
            # landed exactly on a checkpointed step is a measured 0, not
            # unknown (clamped: a snapshot ahead of the step evidence can
            # never make the loss negative)
            steps_lost = max(0, int(max_step_before + 1 - resumed_at))
        recovery = {
            "verdict": rec.get("name"),
            "resumed_from": rec.get("resumed_from"),
            "epoch": rec.get("epoch"),
            "step_in_epoch": rec.get("step_in_epoch"),
            "global_step": resumed_at,
            "skipped": rec.get("skipped") or [],
            "steps_lost_to_replay": steps_lost,
        }
    return {
        "checkpoints": len(ckpts),
        "checkpoint_wall_s": round(ckpt_wall, 4),
        "checkpoint_overhead_fraction": overhead,
        "checkpoint_cadence_steps": cadence,
        "last_checkpoint_bytes": ckpts[-1].get("bytes") if ckpts else None,
        "checkpoints_async": len(async_ckpts),
        "checkpoint_off_path_s": round(off_path_s, 4),
        "aot_cache": aot,
        "recovery": recovery,
    }


def _aot_cache_info(records):
    """Fold the schema-v8 ``aot_cache`` records into the hit/miss story;
    None when the run recorded none (pre-v8 files render unchanged)."""
    recs = [r for r in records if r.get("kind") == "aot_cache"]
    if not recs:
        return None
    counts = {}
    for r in recs:
        counts[r.get("name")] = counts.get(r.get("name"), 0) + 1
    lookups = counts.get("hit", 0) + counts.get("miss", 0)
    hit_walls = [
        r["wall_s"] for r in recs
        if r.get("name") == "hit" and _finite(r.get("wall_s"))
    ]
    disabled = [r.get("reason") for r in recs if r.get("name") == "disabled"]
    return {
        "hits": counts.get("hit", 0),
        "misses": counts.get("miss", 0),
        "stores": counts.get("store", 0),
        "stale": counts.get("stale", 0),
        "corrupt": counts.get("corrupt", 0),
        "audit_mismatches": counts.get("audit_mismatch", 0),
        "fallbacks": counts.get("fallback", 0),
        "hit_rate": (counts.get("hit", 0) / lookups) if lookups else None,
        "hit_wall_s": sum(hit_walls) if hit_walls else None,
        "disabled_reason": disabled[0] if disabled else None,
    }


def _serving_info(records, slo_ms=None):
    """Fold the schema-v5 ``request``/``serving`` records into the Serving
    story; None when the run recorded neither (the section is then omitted
    — pre-v5 files render exactly as before).

    The LAST ``serving`` summary wins (the engine emits one per load run);
    percentiles are recomputed from the raw ``request`` records when no
    summary exists (a killed run keeps its per-request evidence). The SLO
    verdict scores p99 against ``slo_ms`` (the report CLI's ``--slo-ms``),
    falling back to the summary's own threshold; with neither, the verdict
    says "no SLO threshold" instead of guessing."""
    requests = [r for r in records if r.get("kind") == "request"]
    summary = None
    for r in records:
        if r.get("kind") == "serving":
            summary = {
                k: v for k, v in r.items() if k not in ("v", "ts", "kind", "name")
            }
    if summary is None and not requests:
        return None
    ok = [r for r in requests if r.get("name") == "ok"]
    dropped = [r for r in requests if r.get("name") == "dropped"]
    info = dict(summary) if summary else {}
    info.setdefault("completed", len(ok))
    info.setdefault("dropped", len(dropped))
    # the v6 terminal verdicts: prefer the summary's own counters, fall
    # back to counting raw request records (a killed run's evidence)
    for verdict in ("expired", "errors", "unhealthy"):
        name = verdict.rstrip("s") if verdict == "errors" else verdict
        if info.get(verdict) is None:
            n = sum(1 for r in requests if r.get("name") == name)
            info[verdict] = n
    info["degradation"] = _degradation_info(records, info)
    lats = [r["latency_s"] for r in ok if _finite(r.get("latency_s"))]
    if lats and info.get("p50_latency_s") is None:
        # the ONE shared percentile definition (observability.stats —
        # np.percentile, linear interpolation), so this killed-run
        # fallback can never disagree with the engine or fleet summary
        # on identical data; a rank index like int(0.99*n) would pick
        # the MAXIMUM for any n <= 100 and let one outlier flip the SLO
        # verdict
        info["p50_latency_s"] = percentile(lats, 50)
        info["p99_latency_s"] = percentile(lats, 99)
    eff_slo = slo_ms if slo_ms is not None else info.get("slo_ms")
    p99 = info.get("p99_latency_s")
    if eff_slo is None:
        verdict = "no SLO threshold (pass --slo-ms)"
    elif not _finite(p99):
        verdict = f"SLO {eff_slo:g} ms: no completed-request latencies"
    elif p99 <= eff_slo / 1000.0:
        verdict = f"SLO MET: p99 {p99 * 1e3:.2f} ms <= {eff_slo:g} ms"
    else:
        verdict = f"SLO VIOLATED: p99 {p99 * 1e3:.2f} ms > {eff_slo:g} ms"
    info["slo_effective_ms"] = eff_slo
    info["slo_verdict"] = verdict
    return info


def _degradation_info(records, srv):
    """Fold the schema-v6 ``serving_health``/``reload`` records plus the
    terminal failure verdicts into the Serving section's Degradation
    story; None when the run shows no degradation evidence at all (clean
    runs — and every pre-v6 file — render exactly as before).

    ``availability`` is ok / every-terminal-verdict; the recovery time
    prefers the engine's own measurement (breaker-open -> first served
    response, in the summary) and falls back to the record timestamps
    (first ``breaker_open`` -> first subsequent successful ``reload``)."""
    health = [r for r in records if r.get("kind") == "serving_health"]
    reloads = [r for r in records if r.get("kind") == "reload"]
    shed = srv.get("expired") or 0
    errors = srv.get("errors") or 0
    unhealthy = srv.get("unhealthy") or 0
    trips = srv.get("breaker_trips")
    if trips is None:
        trips = sum(1 for r in health if r.get("name") == "breaker_open")
    n_reloads = srv.get("reloads")
    if n_reloads is None:
        n_reloads = sum(1 for r in reloads if r.get("name") == "ok")
    if not (health or reloads or shed or errors or unhealthy):
        return None
    recovery_s = srv.get("recovery_s")
    opens = [r.get("ts") for r in health if r.get("name") == "breaker_open"]
    if recovery_s is None and opens and _finite(opens[0]):
        after = [
            r.get("ts")
            for r in reloads
            if r.get("name") == "ok"
            and _finite(r.get("ts"))
            and r["ts"] >= opens[0]
        ]
        if after:
            recovery_s = after[0] - opens[0]
    closed = [r for r in health if r.get("name") == "breaker_closed"]
    degraded = srv.get("degraded")
    if degraded is None:
        # record-order fallback: an open with no close after it
        last_open = max(
            (i for i, r in enumerate(health) if r.get("name") == "breaker_open"),
            default=None,
        )
        last_close = max(
            (i for i, r in enumerate(health) if r.get("name") == "breaker_closed"),
            default=None,
        )
        degraded = last_open is not None and (
            last_close is None or last_close < last_open
        )
    injected = sum(1 for r in health if r.get("name") == "fault_injected")
    avail = srv.get("availability")
    if avail is None:
        # killed-run fallback: fold availability from the raw verdict
        # counts when no serving summary landed
        ok_n = srv.get("completed") or 0
        terminal = ok_n + (srv.get("dropped") or 0) + shed + errors + unhealthy
        avail = ok_n / terminal if terminal else None
    if degraded:
        verdict = "DEGRADED at exit: breaker open, admission refused"
    elif trips:
        verdict = "recovered: breaker closed" + (
            f" ({_fmt_time_s(recovery_s)} to first served response)"
            if recovery_s is not None
            else ""
        )
    else:
        verdict = "no breaker trips"
    return {
        "shed_expired": shed,
        "errors": errors,
        "unhealthy": unhealthy,
        "retries": srv.get("retries"),
        "failed_dispatches": srv.get("failed_dispatches"),
        "faults_injected": injected,
        "breaker_trips": trips,
        "breaker_closed_events": len(closed),
        "reloads": n_reloads,
        # what the recovery wall actually spent verifying snapshots
        # (schema-v8 reload.verify_s — the single-verified-read path's
        # discovery cost, previously invisible inside wall_s)
        "reload_verify_s": (
            sum(
                r["verify_s"] for r in reloads
                if r.get("name") == "ok" and _finite(r.get("verify_s"))
            )
            if any(
                r.get("name") == "ok" and _finite(r.get("verify_s"))
                for r in reloads
            )
            else None
        ),
        "recovery_s": recovery_s,
        "availability": avail,
        "degraded_at_exit": bool(degraded),
        "verdict": verdict,
    }


def _fleet_info(records):
    """Fold the schema-v7 ``fleet``/``fleet_health`` records into the
    Fleet story; None when the run recorded neither (single-engine runs
    and every pre-v7 file render exactly as before).

    The LAST ``fleet`` summary wins (the fleet emits one per load run);
    the lifecycle counters fall back to counting ``fleet_health`` events
    when no summary landed (a killed PARENT keeps its per-event
    evidence, the same discipline as the Serving fallback). The
    ``replica_id`` on every event is the join key into the per-replica
    ``.r{id}`` JSONL shards."""
    health = [r for r in records if r.get("kind") == "fleet_health"]
    summary = None
    for r in records:
        if r.get("kind") == "fleet":
            summary = {
                k: v for k, v in r.items() if k not in ("v", "ts", "kind", "name")
            }
    if summary is None and not health:
        return None
    info = dict(summary) if summary else {}

    def count(name):
        return sum(1 for r in health if r.get("name") == name)

    if info.get("replicas_started") is None:
        info["replicas_started"] = count("replica_spawned")
    if info.get("replicas_dead") is None:
        info["replicas_dead"] = count("replica_dead")
    if info.get("replicas_retired") is None:
        info["replicas_retired"] = count("replica_retired")
    if info.get("failovers") is None:
        info["failovers"] = count("failover")
    if info.get("failover_requeued") is None:
        info["failover_requeued"] = sum(
            r.get("requeued") or 0 for r in health if r.get("name") == "failover"
        )
    if info.get("reroutes") is None:
        info["reroutes"] = count("reroute")
    if info.get("scale_ups") is None:
        info["scale_ups"] = count("scale_up")
    if info.get("scale_downs") is None:
        info["scale_downs"] = count("scale_down")
    info["sigkills_injected"] = count("replica_sigkill")
    degraded = info.get("degraded")
    if degraded is None:
        # record-order fallback: a fleet_degraded with no recovery after
        last_deg = max(
            (i for i, r in enumerate(health) if r.get("name") == "fleet_degraded"),
            default=None,
        )
        last_rec = max(
            (i for i, r in enumerate(health) if r.get("name") == "fleet_recovered"),
            default=None,
        )
        degraded = last_deg is not None and (
            last_rec is None or last_rec < last_deg
        )
    info["degraded_at_exit"] = bool(degraded)
    if info["degraded_at_exit"]:
        verdict = "FLEET DEGRADED at exit: quorum down, admission refused"
    elif info["replicas_dead"] or info["failovers"]:
        verdict = (
            f"recovered from {info['replicas_dead']} replica death(s): "
            f"{info['failovers']} failover(s)"
            + (
                f", {_fmt_time_s(info.get('recovery_s'))} to next served "
                "response"
                if info.get("recovery_s") is not None
                else ""
            )
        )
    else:
        verdict = "healthy: no replica deaths"
    info["verdict"] = verdict
    return info


def _overlap_info(audit, trace):
    """The overlap-efficiency story: hidden-comm share ``1 -
    exposed_comm / total_comm``. A measured trace split (trace_stats)
    wins; else the comms model's perfect-overlap bound from the audit's
    ``expected`` contract; None when neither source knows anything."""
    exp = (audit or {}).get("expected") or {}
    info = None
    if _finite(exp.get("model_hidden_comm_share")):
        axis = (exp.get("axes") or {}).get("dp") or {}
        info = {
            "source": "model",
            "hidden_comm_share": exp["model_hidden_comm_share"],
            "serial_bound_s": exp.get("serial_bound_s"),
            "overlapped_bound_s": exp.get("overlapped_bound_s"),
            "sync_mode": axis.get("mode"),
            "num_buckets": axis.get("num_buckets"),
        }
    if trace and _finite(trace.get("overlap_efficiency")):
        info = dict(info or {})
        info.update(
            source="measured",
            hidden_comm_share=trace["overlap_efficiency"],
            comm_ms=trace.get("comm_ms"),
            exposed_comm_ms=trace.get("exposed_comm_ms"),
            comm_fraction=trace.get("comm_fraction"),
        )
    return info


def baseline_throughput(path):
    """-> ``(samples_per_sec, label)`` from a baseline file, or ``(None,
    reason)``. ``.jsonl`` is another metrics stream (same steady-state
    rules; multihost shard names/globs like ``run.jsonl.p*`` count too);
    ``.json`` accepts a bench record (``value`` + samples/s unit)
    or a tpu_capture artifact (``headline_best_sps``)."""
    p = Path(path)
    if p.suffix == ".jsonl" or ".jsonl." in p.name:
        base = build_report(read_jsonl(p), source=str(p))
        tp = base["throughput_samples_per_sec"]
        if tp is None:
            return None, f"{p}: no epoch throughput records"
        if base["throughput_includes_compile"]:
            # refusing beats silently trusting an understated baseline: a
            # compile-polluted baseline would let real regressions pass
            return None, (
                f"{p}: only compile-polluted throughput records (no "
                "steady-state epoch) — not usable as a regression baseline"
            )
        return tp, f"{p} (median steady-state)"
    data = json.loads(p.read_text())
    if isinstance(data, dict):
        if _finite(data.get("value")) and data.get("unit") == "samples/s":
            return float(data["value"]), f"{p} ({data.get('metric', 'value')})"
        if _finite(data.get("headline_best_sps")):
            return float(data["headline_best_sps"]), f"{p} (headline_best_sps)"
        if _finite(data.get("samples_per_sec")):
            return float(data["samples_per_sec"]), f"{p} (samples_per_sec)"
    return None, f"{p}: no recognizable throughput field"


def compare(report, base_tp, base_label, threshold):
    """Throughput-vs-baseline verdict; ``regression`` drives the exit
    code. Positive ``delta_fraction`` = faster than baseline. A run whose
    only throughput records include compile time (a 1-epoch job) is NOT
    gated — compile wall clock vs a steady-state baseline would flag a
    spurious regression on every short run; the comparison is still
    rendered, marked ``compile_polluted``."""
    cur = report["throughput_samples_per_sec"]
    delta = (cur - base_tp) / base_tp if base_tp else None
    polluted = bool(report["throughput_includes_compile"])
    return {
        "baseline": base_label,
        "baseline_samples_per_sec": base_tp,
        "delta_fraction": delta,
        "threshold": threshold,
        "compile_polluted": polluted,
        "regression": not polluted and delta is not None and delta < -threshold,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_num(v, unit="", pct=False):
    if v is None:
        return "n/a"
    if not isinstance(v, (int, float)) or not math.isfinite(v):
        return str(v)  # the sink's sanitized non-finite markers ("NaN", ...)
    if pct:
        return f"{v * 100:.2f}%"
    if abs(v) >= 1e9:
        return f"{v / 1e9:,.2f} G{unit}"
    if abs(v) >= 1e6:
        return f"{v / 1e6:,.2f} M{unit}"
    return f"{v:,.2f} {unit}".rstrip()


def _rows(report):
    tp = report["throughput_samples_per_sec"]
    rows = [
        ("epochs recorded", str(report["epochs"])),
        (
            "throughput",
            _fmt_num(tp, "samples/s")
            + (
                "  (includes compile — no steady-state epoch recorded)"
                if report["throughput_includes_compile"]
                else ""
            ),
        ),
        (
            "MFU",
            _fmt_num(report["mfu"], pct=True)
            + (
                "  (includes compile)"
                if report.get("mfu_includes_compile")
                else ""
            ),
        ),
        ("achieved FLOP/s", _fmt_num(report["achieved_flops_per_sec"], "FLOP/s")),
        ("final loss", _fmt_num(report["final_loss"])),
    ]
    if report["final_accuracy"] is not None:
        rows.append(("final accuracy", _fmt_num(report["final_accuracy"], pct=True)))
    if report["bubble_fraction"] is not None:
        rows.append(("pipeline bubble", _fmt_num(report["bubble_fraction"], pct=True)))
    if report.get("weighted_bubble_fraction") is not None:
        rows.append(
            (
                "weighted bubble",
                _fmt_num(report["weighted_bubble_fraction"], pct=True)
                + (
                    "  (split backward: B-weights packed into bubbles)"
                    if report.get("backward_split")
                    else "  (FLOP-weighted ticks)"
                ),
            )
        )
    ov = report.get("overlap")
    if ov is not None:
        share = _fmt_num(ov.get("hidden_comm_share"), pct=True)
        if ov["source"] == "measured":
            detail = (
                f"{share} of comm hidden (measured: "
                f"{_fmt_num(ov.get('exposed_comm_ms'))} ms exposed of "
                f"{_fmt_num(ov.get('comm_ms'))} ms comm)"
            )
        else:
            mode = ov.get("sync_mode")
            sync = (
                f"{ov.get('num_buckets')} buckets" if mode == "bucketed"
                else "anchor sync"
            )
            detail = f"{share} of comm hideable (model bound; {sync})"
        rows.append(("overlap efficiency", detail))
    do = report.get("dispatch_overhead")
    if do is not None:
        share = do.get("dispatch_overhead")
        if share is None:
            detail = "unmeasurable — " + str(do.get("reason", "no op events"))
        else:
            detail = (
                f">= {_fmt_num(share, pct=True)} of {do.get('program')} "
                f"wall is host-side op issue (op busy "
                f"{_fmt_time_s(do.get('device_busy_s'))} of "
                f"{_fmt_time_s(do.get('host_wall_s'))} uninstrumented "
                f"wall; measured lower bound, {do.get('op_source')})"
            )
        if do.get("window_valid") is False:
            # the machine-checked probe-validity guard (api.py): an
            # invalid window's share is flagged, never quoted clean
            detail += "  [WINDOW INVALID: " + str(
                do.get("window_invalid_reason") or "unknown"
            ) + "]"
        rows.append(("dispatch overhead", detail))
    sa = report.get("static_analysis")
    if sa is not None:
        if sa["findings"]:
            detail = (
                f"{sa['findings']} finding(s) — " + "; ".join(sa["finding_text"])
            )
        else:
            detail = (
                f"{len(sa['programs'])} program(s) clean "
                f"({', '.join(sa['passes'])})"
            )
        rows.append(("static checks", detail))
    rows.append(("health", report["health"]["verdict"]))
    return rows


def _cost_lines(cost):
    if not cost:
        return ["cost model: not recorded"]
    lines = [
        f"cost model: {_fmt_num(cost.get('flops_per_sample'), 'FLOP')}/sample "
        f"analytical; peak {_fmt_num(cost.get('peak_flops_per_chip'), 'FLOP/s')}"
        f"/chip x {cost.get('n_devices')} ({cost.get('peak_source')})"
    ]
    ratio = cost.get("flops_ratio")
    if ratio is not None:
        lines.append(
            f"  XLA cross-check: {_fmt_num(cost.get('xla_flops_per_epoch'), 'FLOP')}"
            f"/epoch compiled = {ratio:.3g}x analytical (scan bodies counted "
            "once by XLA's analysis — watch for MOVES, not 1.0)"
        )
    if cost.get("padded_ratio") is not None:
        lines.append(f"  padding tax: {cost['padded_ratio']:.2f}x logical FLOPs")
    return lines


def _fmt_time_s(t):
    if t is None or not isinstance(t, (int, float)) or not math.isfinite(t):
        return "n/a"
    if t >= 1.0:
        return f"{t:.3f} s"
    if t >= 1e-3:
        return f"{t * 1e3:.2f} ms"
    return f"{t * 1e6:.1f} µs"


def _memory_lines(audit, md, stash=None):
    """The memory section: compiled-program peak HBM vs per-chip capacity
    -> headroom, or an OOM forecast when the program does not fit — plus
    the per-model activation-stash peak: a recompute run renders
    its peak NEXT TO its stashed twin's (both from real tick tables), and
    the OOM forecast says what the twin's extra stash would do to the
    compiled peak."""
    mem = (audit or {}).get("memory")
    if not mem and not stash:
        return []
    lines = ["## Memory (compiled program)" if md else "memory (compiled program):"]
    peak = (mem or {}).get("peak_hbm_bytes")
    if mem:
        cap = audit.get("hbm_per_chip")
        head = audit.get("hbm_headroom_fraction")
        # memory_analysis sizes are per device (the addressable shard), so
        # the peak compares against one chip's capacity directly
        line = f"peak HBM: {format_bytes(peak)} (per device)"
        if cap and head is not None:
            if head < 0:
                line += (
                    f" — OOM FORECAST: exceeds the {format_bytes(cap)}/chip "
                    f"capacity ({audit.get('hbm_source')}) by "
                    f"{format_bytes(-head * cap)}"
                )
            else:
                line += (
                    f" of {format_bytes(cap)}/chip ({audit.get('hbm_source')}) "
                    f"— {head * 100:.1f}% headroom"
                )
        lines.append(line)
        lines.append(
            "  args {a} + output {o} + temp {t} (aliased {al})".format(
                a=format_bytes(mem.get("argument_size_in_bytes")),
                o=format_bytes(mem.get("output_size_in_bytes")),
                t=format_bytes(mem.get("temp_size_in_bytes")),
                al=format_bytes(mem.get("alias_size_in_bytes")),
            )
        )
        # the per-stage ZeRO OOM forecast (program_audit.zero_peak_forecast):
        # the params+grads+state ÷ dp residency claim, scored against the
        # chip capacity next to the MEASURED compiled peak above
        exp = audit.get("expected") or {}
        zf = exp.get("zero_forecast")
        if zf and not exp.get("inference"):
            stage = str(exp.get("zero", 0))
            stages = zf.get("stages") or {}
            cur = stages.get(stage)
            if cur:
                line = (
                    f"ZeRO forecast [stage {stage}]: "
                    f"{format_bytes(cur['total_bytes'])}/device model state "
                    f"(params {format_bytes(cur['params_bytes'])} + grads "
                    f"{format_bytes(cur['grads_bytes'])} + opt state "
                    f"{format_bytes(cur['state_bytes'])}"
                )
                if cur.get("transient_bytes"):
                    line += (
                        f" + {format_bytes(cur['transient_bytes'])} "
                        "gathered-chunk transient"
                    )
                line += ")"
                cap = audit.get("hbm_per_chip")
                if cap:
                    frac = cur["total_bytes"] / cap
                    if frac > 1:
                        line += (
                            f" — OOM FORECAST: model state alone exceeds "
                            f"{format_bytes(cap)}/chip"
                        )
                    else:
                        line += (
                            f" — {(1 - frac) * 100:.1f}% headroom of "
                            f"{format_bytes(cap)}/chip"
                        )
                lines.append(line)
                lines.append(
                    "  stage ladder (model state/device): "
                    + " -> ".join(
                        f"z{k} {format_bytes(v['total_bytes'])}"
                        for k, v in sorted(stages.items())
                    )
                )
    if stash:
        model = stash.get("model") or "mnist-mlp"
        speak = stash.get("stash_bytes_peak")
        if stash.get("recompute"):
            twin = stash.get("stash_bytes_peak_stashed_twin")
            line = (
                f"activation stash [{model}]: peak {format_bytes(speak)}"
                f"/device under recompute ({stash.get('stash_slots')} "
                f"residual + {stash.get('xin_slots')} input slot(s)) vs "
                f"{format_bytes(twin)} stashed twin "
                f"({stash.get('stash_slots_stashed_twin')} slot(s))"
            )
            if twin and speak is not None and twin > 0:
                line += f" — {(1 - speak / twin) * 100:.0f}% smaller"
            lines.append(line)
            cap = (audit or {}).get("hbm_per_chip")
            if (
                twin
                and speak is not None
                and _finite(peak)
                and cap
            ):
                # what the stashed twin would cost THIS model on THIS
                # chip: the compiled peak plus the stash delta, scored
                # against capacity — the per-model OOM forecast
                would = peak + (twin - speak)
                frac = would / cap
                lines.append(
                    f"  stashed-twin forecast: peak HBM would be "
                    f"{format_bytes(would)} ({frac * 100:.1f}% of "
                    f"{format_bytes(cap)}/chip"
                    + (" — OOM FORECAST)" if frac > 1 else ")")
                )
        else:
            lines.append(
                f"activation stash [{model}]: peak {format_bytes(speak)}"
                f"/device ({stash.get('stash_slots')} slot(s), stashed — "
                "rerun with --recompute to trade FLOPs for this footprint)"
            )
    lines.append("")
    return lines


def _comms_lines(audit, md):
    """The comms section: the compiled program's collective census vs the
    layout contract, the analytical bytes/step, and the bandwidth-bound
    lower-bound verdict next to the compute bound."""
    if not audit:
        return []
    census = audit.get("census") or {}
    exp = audit.get("expected") or {}
    lines = ["## Comms (XLA program audit)" if md else "comms (XLA program audit):"]
    if census:
        kinds = ", ".join(
            f"{k} x{v['count']} ({format_bytes(v['bytes'])})"
            for k, v in sorted(census.items())
        )
    elif audit.get("hlo_available") is False:
        kinds = "unavailable (backend exposed no HLO text)"
    elif exp.get("sequential"):
        kinds = "none (sequential program)"
    else:
        kinds = "none"
    ok = audit.get("census_ok")
    if ok is True:
        verdict = "matches the layout contract"
    elif ok is False:
        verdict = "CONTRACT MISMATCH: " + "; ".join(audit.get("mismatches", ()))
    else:
        verdict = "contract not checked"
    lines.append(f"census [{audit.get('name', 'program')}]: {kinds} — {verdict}")
    if exp:
        parts = []
        for axis, a in sorted((exp.get("axes") or {}).items()):
            parts.append(
                f"{axis} {a.get('kind')} {format_bytes(a.get('bytes_per_step_per_device'))}"
            )
        total = exp.get("bytes_per_step_per_device")
        line = f"model: {format_bytes(total)}/step/device"
        if parts:
            line += " (" + " + ".join(parts) + ")"
        lines.append(line)
        dp_axis = (exp.get("axes") or {}).get("dp") or {}
        stage = dp_axis.get("zero") or 0
        if stage:
            # the per-stage dp-traffic shape: the sharded stages replace
            # the anchor all-reduce with gradient reduce-scatter (sharded
            # result) + a deferred all-gather of the updated-param chunk;
            # anchor zero-2 and zero-3 scatter PER TICK (one contribution
            # per microbatch into the persistent shard), and stage 3 adds
            # the JIT parameter-gather schedule on top
            rs = dp_axis.get(
                "reduce_scatter_bytes_per_step_per_device",
                (dp_axis.get("bytes_per_step_per_device") or 0) / 2,
            )
            line = (
                f"ZeRO stage {stage}: gradient reduce-scatter "
                f"{format_bytes(rs)}/step/device"
            )
            sched = dp_axis.get("scatter_schedule")
            if sched:
                line += (
                    f" ({sched} x {dp_axis.get('scatter_mubatches')} "
                    "microbatches into the persistent 1/dp shard)"
                )
            else:
                line += " (tail scatter; result is the 1/dp shard)"
            gather = dp_axis.get("gather")
            if gather:
                line += (
                    f" + JIT param gather {format_bytes(gather.get('bytes_per_step_per_device'))}"
                    f"/step/device ({gather.get('schedule')}: "
                    f"{gather.get('passes')} passes x "
                    f"{gather.get('mubatches')} microbatches)"
                )
            else:
                line += " + post-update param all-gather of the updated chunk"
            lines.append(line)
        if dp_axis.get("mode") == "bucketed":
            # "budget", not "<=": a single leaf larger than the budget
            # gets its own oversized bucket (the planner never splits one)
            sizes = dp_axis.get("bucket_grad_bytes") or []
            lines.append(
                f"gradient sync: bucketed — {dp_axis.get('num_buckets')} "
                f"collectives, budget "
                f"{format_bytes(dp_axis.get('grad_bucket_bytes'))}/bucket "
                f"(largest bucket "
                f"{format_bytes(max(sizes) if sizes else None)}); "
                "total bytes unchanged vs the anchor"
            )
        ct, xt = exp.get("comms_time_per_step_s"), exp.get("compute_time_per_step_s")
        if ct is not None or xt is not None:
            bound = exp.get("bound")
            lines.append(
                f"lower bounds: comms {_fmt_time_s(ct)} @ "
                f"{_fmt_num(exp.get('bandwidth_bytes_per_sec'), 'B/s')} "
                f"({exp.get('bandwidth_source')}) vs compute {_fmt_time_s(xt)}"
                + (f" — {bound}-bound" if bound else "")
            )
            st, ot = exp.get("serial_bound_s"), exp.get("overlapped_bound_s")
            if st is not None and ot is not None:
                lines.append(
                    f"step-time bounds: serial (anchor) {_fmt_time_s(st)} "
                    f"= comm + compute; overlapped (bucketed, perfect) "
                    f"{_fmt_time_s(ot)} = max(comm, compute)"
                )
    lines.append("")
    return lines


def _reliability_lines(rel, md):
    """The Reliability section: checkpoint overhead, cadence, and the
    recovery verdict with its evidence (skipped snapshots, replay loss)."""
    if not rel:
        return []
    lines = ["## Reliability" if md else "reliability:"]
    if rel["checkpoints"]:
        line = (
            f"checkpoints: {rel['checkpoints']} written "
            f"({_fmt_time_s(rel['checkpoint_wall_s'])} total"
        )
        if rel.get("checkpoint_overhead_fraction") is not None:
            line += (
                f" — {rel['checkpoint_overhead_fraction'] * 100:.1f}% "
                f"overhead vs train dispatch"
            )
        line += ")"
        if rel.get("checkpoint_cadence_steps") is not None:
            line += f", every ~{rel['checkpoint_cadence_steps']:.0f} steps"
        if rel.get("last_checkpoint_bytes") is not None:
            line += f", {format_bytes(rel['last_checkpoint_bytes'])} each"
        lines.append(line)
        if rel.get("checkpoints_async"):
            lines.append(
                f"async checkpointing: {rel['checkpoints_async']} of "
                f"{rel['checkpoints']} saves off-path (on-path wall is the "
                f"overhead above; verify+write "
                f"{_fmt_time_s(rel.get('checkpoint_off_path_s'))} ran in "
                "the background writer)"
            )
    aot = rel.get("aot_cache")
    if aot is not None:
        if aot.get("hit_rate") is not None:
            line = (
                f"aot executable cache: {aot['hits']} hit(s) / "
                f"{aot['misses']} miss(es) "
                f"(hit rate {aot['hit_rate'] * 100:.0f}%"
                + (
                    f", deserialize {_fmt_time_s(aot['hit_wall_s'])} vs "
                    "a cold recompile"
                    if aot.get("hit_wall_s") is not None
                    else ""
                )
                + ")"
            )
        else:
            line = "aot executable cache: no lookups"
        if aot.get("stores"):
            line += f", {aot['stores']} entr(ies) written"
        lines.append(line)
        bad = []
        if aot.get("stale"):
            bad.append(f"{aot['stale']} stale")
        if aot.get("corrupt"):
            bad.append(f"{aot['corrupt']} corrupt")
        if aot.get("audit_mismatches"):
            bad.append(f"{aot['audit_mismatches']} audit-mismatched")
        if bad:
            lines.append(
                "  " + ", ".join(bad)
                + " entr(ies) fell back to a clean recompile"
            )
        if aot.get("disabled_reason"):
            lines.append(
                f"  cache disabled on this backend: {aot['disabled_reason']}"
            )
    rec = rel.get("recovery")
    if rec is not None:
        if rec["verdict"] == "resumed":
            where = f"epoch {rec.get('epoch')}, step {rec.get('step_in_epoch')}"
            line = (
                f"recovery: resumed from {rec.get('resumed_from')} at {where} "
                f"(global step {rec.get('global_step')})"
            )
        else:
            line = "recovery: fresh start (no resumable snapshot found)"
        if rec["skipped"]:
            line += f"; {len(rec['skipped'])} corrupt snapshot(s) skipped"
        lines.append(line)
        for s in rec["skipped"]:
            lines.append(f"  skipped {s.get('path')}: {s.get('cause')}")
        lost = rec.get("steps_lost_to_replay")
        lines.append(
            f"steps lost to replay: "
            + (
                f"{lost} (re-trained after restore — bit-identical by contract)"
                if lost is not None
                else "unknown (killed run's step records not in this stream)"
            )
        )
    lines.append("")
    return lines


def _serving_lines(srv, md):
    """The Serving section: completions, latency percentiles vs the model
    floor, goodput vs offered load, queue depth, padding waste, and the
    SLO verdict (docs/serving.md)."""
    if not srv:
        return []
    lines = ["## Serving" if md else "serving:"]
    line = f"requests: {srv.get('completed')} completed"
    if srv.get("dropped"):
        line += f", {srv['dropped']} DROPPED"
    if srv.get("expired"):
        line += f", {srv['expired']} expired"
    if srv.get("errors"):
        line += f", {srv['errors']} ERRORED"
    if srv.get("unhealthy"):
        line += f", {srv['unhealthy']} UNHEALTHY"
    if srv.get("dispatches") is not None:
        line += (
            f" over {srv['dispatches']} dispatches "
            f"({srv.get('slots_dispatched')} slots)"
        )
    lines.append(line)
    lat = (
        f"latency: p50 {_fmt_time_s(srv.get('p50_latency_s'))}, "
        f"p99 {_fmt_time_s(srv.get('p99_latency_s'))}"
    )
    if srv.get("latency_bound_s") is not None:
        lat += (
            f" — model floor {_fmt_time_s(srv['latency_bound_s'])}"
            + (
                f" ({srv['latency_bound_ticks']} ticks, "
                f"{srv.get('latency_bound_source')})"
                if srv.get("latency_bound_ticks") is not None
                else f" ({srv.get('latency_bound_source')})"
            )
        )
    lines.append(lat)
    tp = []
    if _finite(srv.get("offered_rps")):
        tp.append(f"offered {srv['offered_rps']:g} rps")
    if _finite(srv.get("achieved_rps")):
        tp.append(f"achieved {srv['achieved_rps']:.1f} rps")
    if _finite(srv.get("goodput_rps")):
        tp.append(f"goodput {srv['goodput_rps']:.1f} rps (within SLO)")
    if tp:
        lines.append("throughput: " + ", ".join(tp))
    extras = []
    if _finite(srv.get("padding_waste")):
        extras.append(f"padding waste {srv['padding_waste'] * 100:.1f}%")
    if srv.get("queue_depth_max") is not None:
        extras.append(
            f"queue depth max {srv['queue_depth_max']}"
            + (
                f" (mean {srv['queue_depth_mean']:.1f})"
                if _finite(srv.get("queue_depth_mean"))
                else ""
            )
        )
    if extras:
        lines.append(", ".join(extras))
    lines.append(srv.get("slo_verdict", ""))
    deg = srv.get("degradation")
    if deg:
        lines.append("")
        lines.append("### Degradation" if md else "degradation:")
        counts = (
            f"shed (expired) {deg['shed_expired']}, errors {deg['errors']}, "
            f"unhealthy {deg['unhealthy']}"
        )
        if deg.get("retries"):
            counts += f", {deg['retries']} retried dispatch slot(s)"
        if deg.get("faults_injected"):
            counts += f", {deg['faults_injected']} fault(s) injected"
        lines.append(counts)
        breaker = (
            f"breaker: {deg['breaker_trips']} trip(s), "
            f"{deg['reloads']} hot reload(s)"
        )
        if deg.get("recovery_s") is not None:
            breaker += f", recovery {_fmt_time_s(deg['recovery_s'])}"
        if deg.get("reload_verify_s") is not None:
            breaker += (
                f" (snapshot verify {_fmt_time_s(deg['reload_verify_s'])}, "
                "single-read)"
            )
        lines.append(breaker)
        avail = deg.get("availability")
        lines.append(
            (
                f"availability {avail * 100:.1f}% — {deg['verdict']}"
                if _finite(avail)
                else deg["verdict"]
            )
        )
    lines.append("")
    return lines


def _fleet_lines(fl, md):
    """The Fleet section: replica lifecycle, routing skew, failover +
    elasticity accounting, per-replica verdict rows, and the fleet
    verdict (docs/serving.md "Fleet")."""
    if not fl:
        return []
    lines = ["## Fleet" if md else "fleet:"]
    line = (
        f"replicas: {fl.get('replicas_started')} started"
        + (
            f" (target {fl['replicas_target']}, {fl.get('replicas_ready')} "
            "ready at exit)"
            if fl.get("replicas_target") is not None
            else ""
        )
    )
    if fl.get("replicas_dead"):
        line += f", {fl['replicas_dead']} DIED"
        if fl.get("sigkills_injected"):
            line += f" ({fl['sigkills_injected']} SIGKILL injected)"
    if fl.get("replicas_retired"):
        line += f", {fl['replicas_retired']} retired"
    lines.append(line)
    fo = (
        f"failover: {fl.get('failovers', 0)} event(s), "
        f"{fl.get('failover_requeued', 0)} in-flight request(s) re-queued"
    )
    if fl.get("failover_exhausted"):
        fo += f", {fl['failover_exhausted']} budget-exhausted"
    if fl.get("reroutes"):
        fo += f"; {fl['reroutes']} verdict reroute(s)"
    lines.append(fo)
    if fl.get("scale_ups") or fl.get("scale_downs"):
        sc = (
            f"elasticity: {fl.get('scale_ups', 0)} scale-up(s), "
            f"{fl.get('scale_downs', 0)} scale-down(s)"
        )
        if fl.get("scale_up_s") is not None:
            sc += f", last replica ready in {_fmt_time_s(fl['scale_up_s'])}"
        lines.append(sc)
    routing = fl.get("routing") or {}
    if routing:
        parts = ", ".join(
            f"r{rid}: {n}" for rid, n in sorted(routing.items(), key=lambda kv: str(kv[0]))
        )
        skew = fl.get("routing_skew")
        lines.append(
            f"routing: {parts}"
            + (f" — skew {skew:.2f}x (max/mean)" if _finite(skew) else "")
        )
    per = fl.get("per_replica") or {}
    for rid in sorted(per, key=str):
        row = per[rid] or {}
        verdicts = row.get("verdicts") or {}
        vs = ", ".join(f"{k} {v}" for k, v in sorted(verdicts.items()))
        lines.append(
            f"  replica {rid} [{row.get('state')}]: routed "
            f"{row.get('routed')}, verdicts {{{vs}}}"
        )
    avail = fl.get("availability")
    lines.append(
        (
            f"availability {avail * 100:.1f}% — {fl['verdict']}"
            if _finite(avail)
            else fl["verdict"]
        )
    )
    lines.append("")
    return lines


def _tracing_lines(tr, md):
    """The Tracing section: chain completeness, clock alignment (offset ±
    uncertainty per replica), aggregate + p99-conditional phase
    attribution, SLO burn, and the worst-k request waterfalls
    (docs/observability.md § Tracing)."""
    if not tr:
        return []
    lines = ["## Tracing" if md else "tracing:"]
    if tr.get("unrendered"):
        lines.append(
            f"{tr['spans']} trace spans not rendered: the port's report has "
            "no observability.tracing yet (render with the JAX package's "
            "report)"
        )
        lines.append("")
        return lines
    line = f"span chains: {tr['chains']} ({tr['spans']} spans)"
    if tr["problems"]:
        line += f" — {len(tr['problems'])} INCOMPLETE:"
        lines.append(line)
        for p in tr["problems"][:10]:
            lines.append(f"  {p}")
    else:
        line += " — all terminal requests traced end to end"
        lines.append(line)
    if tr["alignment"]:
        parts = []
        for rid, off in tr["alignment"].items():
            if not _finite(off.get("offset_s")):
                parts.append(f"r{rid} unestimated")
                continue
            parts.append(
                f"r{rid} {off['offset_s'] * 1e3:+.3f} ms "
                f"(±{off['uncertainty_s'] * 1e3:.3f} ms)"
            )
        lines.append("clock alignment: " + ", ".join(parts))
    if tr["alignment_missing_replicas"]:
        lines.append(
            "ALIGNMENT DEGRADED: no clock offset recorded for replica(s) "
            + ", ".join(str(r) for r in tr["alignment_missing_replicas"])
            + " — their worker spans are unmapped"
        )
    att = tr.get("attribution")
    if att:

        def fmt_phases(ph):
            return ", ".join(
                f"{name} {share * 100:.1f}%"
                for name, share in sorted(
                    ph.items(), key=lambda kv: -kv[1]
                )
            )

        lines.append(
            "phase attribution (mean): " + fmt_phases(att["phases_mean"])
        )
        lines.append(
            f"phase attribution (p99-conditional, slowest "
            f"{att['p99_chains']} >= {_fmt_time_s(att['p99_latency_s'])}): "
            + fmt_phases(att["phases_p99"])
            + (
                f" — tail dominated by {att['p99_dominant_phase']}"
                if att.get("p99_dominant_phase")
                else ""
            )
        )
        if att.get("slo_burn"):
            lines.append(
                f"SLO burn per phase (mean share of the deadline budget, "
                f"{att['slo_chains']} tagged request(s)): "
                + ", ".join(
                    f"{name} {b * 100:.1f}%"
                    for name, b in sorted(
                        att["slo_burn"].items(), key=lambda kv: -kv[1]
                    )
                )
            )
    if tr["worst"]:
        lines.append("slowest requests:")
        for w in tr["worst"]:
            for wl in w["lines"]:
                lines.append("  " + wl)
    lines.append("")
    return lines


def _alerts_lines(alerts, rollups, md):
    """Render the Alerts section (schema v11): the firing→resolved
    timeline, peak burn rates, the false-alert verdict, and the
    rollup-backed trend sparklines. Runs with neither alerts nor
    rollups render nothing — pre-v11 files are untouched."""
    if alerts is None and rollups is None:
        return []
    lines = ["## Alerts" if md else "alerts:"]
    if alerts is None:
        lines.append("no alert transitions recorded")
    else:
        lines.append(
            f"{alerts['fired']} fired / {alerts['resolved']} resolved "
            f"({alerts['transitions']} transition(s))"
            + (
                "; STILL FIRING at end of stream: "
                + ", ".join(alerts["still_firing"])
                if alerts["still_firing"]
                else "; all resolved"
            )
        )
        for e in alerts["timeline"]:
            where = f" (r{e['replica_id']})" if e["replica_id"] is not None else ""
            t = f"t={e['t']:.3f}s " if _finite(e.get("t")) else ""
            lines.append(
                f"- {t}{e['rule']}{where} {e['state'].upper()} "
                f"[{e['severity']}]: {e.get('reason') or ''}"
            )
        if alerts["peak_burn_slow"] is not None:
            lines.append(
                f"peak burn rate: {alerts['peak_burn_slow']:.2f}x budget "
                f"(long window), {alerts['peak_burn_fast']:.2f}x (short) "
                "at the recorded transitions"
            )
        if alerts["false_alerts"]:
            lines.append(
                "FALSE ALERT(S): "
                + ", ".join(alerts["false_alerts"])
                + " fired with no supporting fault evidence in the stream"
            )
        else:
            lines.append(
                "false-alert check: every fired rule is backed by fault "
                "evidence in the stream"
            )
    if rollups is not None:
        lines.append(
            f"rollups: {rollups['windows']} window(s) across "
            f"{len(rollups['sources'])} source(s)"
        )
        for key, src in rollups["sources"].items():
            detail = (
                f"- {key}: {src['windows']} x {src['window_s']:g}s windows"
            )
            if src["late"]:
                detail += f", {src['late']} late sample(s)"
            lines.append(detail)
            if any(v for v in src["rate_trend"]):
                lines.append(
                    f"    rate     {sparkline(src['rate_trend'])}"
                )
            if src.get("p99_trend"):
                lines.append(
                    f"    p99      {sparkline(src['p99_trend'])}  "
                    f"(max {_fmt_time_s(src['p99_latency_s'])})"
                )
            if src.get("loss_trend"):
                lines.append(
                    f"    loss     {sparkline(src['loss_trend'])}"
                )
    lines.append("")
    return lines


def _divergence_info(records):
    """Fold the schema-v12 ``digest`` stream (numerics provenance,
    observability/divergence.py): how many per-step per-layer digest rows
    this run recorded and over which step window — the evidence that a
    first-divergence comparison against a twin run is possible. None when
    the run recorded no digests (section omitted)."""
    digs = [r for r in records if r.get("kind") == "digest"]
    if not digs:
        return None
    steps = sorted(int(r.get("step", 0)) for r in digs)
    flips = [
        r for r in records
        if r.get("kind") == "event" and r.get("name") == "digest_config"
        and r.get("faults")
    ]
    return {
        "records": len(digs),
        "layers": max(int(r.get("layers", 0)) for r in digs),
        "first_step": steps[0],
        "last_step": steps[-1],
        "faults": flips[0]["faults"] if flips else None,
    }


def _divergence_lines(info, md):
    if not info:
        return []
    lines = ["## Divergence" if md else "divergence:"]
    lines.append(
        f"- digest rows: {info['records']} steps "
        f"({info['first_step']}..{info['last_step']}) x "
        f"{info['layers']} layers (per-layer crc + param/grad norms)"
    )
    if info.get("faults"):
        lines.append(f"- fault plan recorded for replay: {info['faults']}")
    lines.append(
        "- compare twin runs: python -m "
        "shallowspeed_tpu_torch.observability.divergence A.jsonl B.jsonl"
    )
    lines.append("")
    return lines


def _capacity_info(records):
    """Fold the schema-v13 capacity evidence (serving/autoscaler.py +
    bench_replay.py): every ``autoscale`` decision with its rule and
    fleet sizes, the replayed trace's offered-load curve
    (``replay_trace`` event), and the per-leg scoreboard rows
    (``replay_score`` events). None when the stream has no capacity
    records (section omitted)."""
    decisions = [r for r in records if r.get("kind") == "autoscale"]
    trace = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "replay_trace":
            trace = r  # last wins
    scores = [
        r
        for r in records
        if r.get("kind") == "event" and r.get("name") == "replay_score"
    ]
    if not decisions and trace is None and not scores:
        return None
    by_leg = {}
    for d in decisions:
        by_leg.setdefault(d.get("leg") or "-", []).append(
            {
                k: d.get(k)
                for k in (
                    "name", "direction", "rule", "t", "replicas_before",
                    "replicas_after", "queue_depth", "value", "threshold",
                    "flap", "window_end", "reason",
                )
            }
        )
    for decs in by_leg.values():
        decs.sort(key=lambda d: (d.get("t") is None, d.get("t")))
    return {
        "decisions": len(decisions),
        "flaps": sum(1 for d in decisions if d.get("flap")),
        "by_leg": dict(sorted(by_leg.items())),
        "trace": (
            {
                "day_s": trace.get("day_s"),
                "knee_rps": trace.get("knee_rps"),
                "n_arrivals": trace.get("n_arrivals"),
                "compression": trace.get("compression"),
                "buckets": trace.get("buckets") or [],
                "spikes": trace.get("spikes") or [],
            }
            if trace is not None
            else None
        ),
        "scores": [
            {
                k: s.get(k)
                for k in (
                    "leg", "violation_s", "violation_minutes_modeled",
                    "wasted_replica_s", "wasted_replica_hours_modeled",
                    "flaps",
                )
            }
            for s in scores
        ],
    }


def _capacity_lines(info, md):
    if not info:
        return []
    lines = ["## Capacity" if md else "capacity:"]
    trace = info.get("trace")
    if trace and trace["buckets"]:
        lines.append(
            f"- replayed trace: {trace['n_arrivals']} arrivals over "
            f"{_fmt_num(trace['day_s'], 's')} "
            f"(1s here = {_fmt_num(trace['compression'])}s modeled), "
            f"knee {_fmt_num(trace['knee_rps'], 'rps')}, "
            f"{len(trace['spikes'])} flash-crowd spike(s)"
        )
        lines.append(
            "- offered load: "
            + sparkline([b.get("rate_rps") for b in trace["buckets"]])
        )
    for leg, decs in (info.get("by_leg") or {}).items():
        # the scale timeline against the curve above: each decision at
        # its trace time, with the rule that justified it
        sizes = " ".join(
            f"{_fmt_num(d['t'], 's')}:"
            f"{d['replicas_before']}→{d['replicas_after']}"
            for d in decs
            if d["name"] in ("scale_out", "scale_in")
        )
        lines.append(
            f"- {leg}: {len(decs)} decision(s)"
            + (f" | timeline {sizes}" if sizes else "")
        )
        # every sizing decision renders in full; the admission gate's
        # on/off toggles (direction hold, high-frequency while replicas
        # warm) collapse past the first few to keep the section readable
        bp_shown, bp_total = 0, sum(
            1 for d in decs if d["name"].startswith("backpressure")
        )
        for d in decs:
            is_bp = d["name"].startswith("backpressure")
            if is_bp and not d.get("flap"):
                bp_shown += 1
                if bp_shown > 3:
                    continue
            flap = " FLAP" if d.get("flap") else ""
            lines.append(
                f"  - [{_fmt_num(d['t'], 's')}] {d['name']} "
                f"(rule {d['rule']}, "
                f"{d['replicas_before']}→{d['replicas_after']}, queue "
                f"{d['queue_depth']}){flap} — {d.get('reason')}"
            )
        if bp_total > 3:
            lines.append(
                f"  - … {bp_total - 3} more backpressure toggle(s) "
                "while replacements warmed (admission gate, "
                "replica count unchanged)"
            )
    flaps = info.get("flaps", 0)
    lines.append(
        f"- flap count: {flaps}"
        + ("" if flaps == 0 else " — DIRECTION CHURN (policy bug)")
    )
    for s in info.get("scores") or []:
        lines.append(
            f"- score[{s['leg']}]: "
            f"{_fmt_num(s['violation_minutes_modeled'], 'modeled violation-min')}, "
            f"{_fmt_num(s['wasted_replica_hours_modeled'], 'wasted replica-h')}, "
            f"{s['flaps']} flap(s)"
        )
    lines.append("")
    return lines


def render(report, fmt, comparison=None):
    if fmt == "json":
        out = dict(report)
        if comparison is not None:
            out["baseline_comparison"] = comparison
        # strict JSON like every record line: non-finite stats (a blown-up
        # run's loss mean) become the sanitizer's string forms, never bare
        # NaN tokens a downstream jq/ingest would choke on
        return json.dumps(json_safe(out), indent=2, allow_nan=False)
    md = fmt == "md"
    lines = []
    title = f"Run report: {report['source']}"
    lines.append(f"# {title}" if md else title)
    lines.append("")
    if md:
        lines.append("| metric | value |")
        lines.append("|---|---|")
        lines.extend(f"| {k} | {v} |" for k, v in _rows(report))
    else:
        width = max(len(k) for k, _ in _rows(report))
        lines.extend(f"{k.ljust(width)}  {v}" for k, v in _rows(report))
    lines.append("")
    lines.extend(_cost_lines(report["cost_model"]))
    lines.append("")
    lines.extend(
        _memory_lines(
            report.get("xla_audit"), md, stash=report.get("stash_memory")
        )
    )
    lines.extend(_comms_lines(report.get("xla_audit"), md))
    lines.extend(_reliability_lines(report.get("reliability"), md))
    lines.extend(_serving_lines(report.get("serving"), md))
    lines.extend(_fleet_lines(report.get("fleet"), md))
    lines.extend(_tracing_lines(report.get("tracing"), md))
    lines.extend(
        _alerts_lines(report.get("alerts"), report.get("rollups"), md)
    )
    lines.extend(_divergence_lines(report.get("divergence"), md))
    lines.extend(_capacity_lines(report.get("capacity"), md))
    header = "## Span breakdown" if md else "span breakdown:"
    lines.append(header)
    if report["spans"]:
        for row in report["spans"]:
            lines.append(
                f"- {row['name']}: {row['total_s']:.3f}s over {row['count']} span(s)"
            )
    else:
        lines.append("- (no spans recorded)")
    lines.append("")
    if report["step_loss_sparkline"]:
        sl = report["step_loss"]
        lines.append("## Step loss" if md else "step loss:")
        lines.append(
            f"{report['steps']} steps, first {_fmt_num(sl['first'])} -> "
            f"last {_fmt_num(sl['last'])}"
            + (f", {sl['non_finite']} NON-FINITE" if sl["non_finite"] else "")
        )
        lines.append(report["step_loss_sparkline"])
        lines.append("")
    if comparison is not None:
        lines.append("## Baseline" if md else "baseline:")
        delta = comparison["delta_fraction"]
        if comparison.get("compile_polluted"):
            verdict = (
                "regression gate SKIPPED — this run's only throughput "
                "records include compile time"
            )
        elif comparison["regression"]:
            verdict = (
                f"REGRESSION beyond {comparison['threshold'] * 100:.0f}% threshold"
            )
        else:
            verdict = f"within {comparison['threshold'] * 100:.0f}% threshold"
        lines.append(
            f"vs {comparison['baseline']}: "
            f"{_fmt_num(comparison['baseline_samples_per_sec'], 'samples/s')} "
            f"baseline, {'+' if delta is not None and delta >= 0 else ''}"
            f"{_fmt_num(delta, pct=True)} ({verdict})"
        )
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.observability.report",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run", help="metrics JSONL of the run to report on")
    ap.add_argument(
        "--baseline",
        default=None,
        help="metrics JSONL or bench/capture JSON to compare throughput "
        "against (regression beyond --threshold exits 2)",
    )
    ap.add_argument(
        "--trace",
        default=None,
        help="a torch.profiler trace dir or *.pt.trace.json[.gz] of this run "
        "(e.g. the --profile-dir artifact): its measured comm/compute "
        "split upgrades the overlap-efficiency row from the comms-model "
        "bound to a measurement",
    )
    ap.add_argument("--format", choices=("md", "text", "json"), default="md")
    ap.add_argument(
        "--slo-ms",
        type=float,
        default=None,
        help="latency objective for the Serving section's SLO verdict "
        "(overrides the serving summary record's own threshold)",
    )
    ap.add_argument(
        "--threshold",
        type=float,
        default=0.10,
        help="relative throughput-regression gate (default 0.10 = 10%%)",
    )
    args = ap.parse_args(argv)
    try:
        records = read_jsonl(args.run)
    except (OSError, ValueError) as e:
        print(f"report: cannot read {args.run}: {e}", file=sys.stderr)
        return 1
    trace = None
    if args.trace:
        from shallowspeed_tpu_torch.observability import trace_stats

        traces = trace_stats.find_traces(args.trace)
        if not traces:
            print(
                f"report: no *.trace.json.gz under {args.trace}", file=sys.stderr
            )
            return 1
        # one capture = one trace; with several, the newest wins (the
        # capture helpers timestamp their subdirs)
        trace = trace_stats.summarize(traces[-1])
    report = build_report(records, source=args.run, trace=trace, slo_ms=args.slo_ms)
    comparison = None
    if args.baseline:
        try:
            base_tp, label = baseline_throughput(args.baseline)
        except (OSError, ValueError) as e:
            print(f"report: cannot read baseline {args.baseline}: {e}", file=sys.stderr)
            return 1
        if base_tp is None:
            print(f"report: {label}", file=sys.stderr)
            return 1
        if report["throughput_samples_per_sec"] is None:
            print(
                f"report: {args.run} has no throughput records to compare",
                file=sys.stderr,
            )
            return 1
        comparison = compare(report, base_tp, label, args.threshold)
    print(render(report, args.format, comparison))
    if comparison is not None and comparison.get("compile_polluted"):
        print(
            "report: regression gate skipped — no steady-state epoch record "
            "(this run's throughput includes compile time)",
            file=sys.stderr,
        )
    if comparison is not None and comparison["regression"]:
        print(
            f"report: THROUGHPUT REGRESSION beyond {args.threshold * 100:.0f}% "
            f"({comparison['delta_fraction'] * 100:.1f}% vs baseline)",
            file=sys.stderr,
        )
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
