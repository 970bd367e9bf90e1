"""Latency-denominated load bench: p50/p99, goodput and the saturation knee,
plus the seeded CHAOS SOAK — the port of ``shallowspeed_tpu/serving/
bench_serving.py`` without its fleet half.

    python -m shallowspeed_tpu_torch.serving.bench_serving [--device cuda|cpu]
        [--dp N] [--pp M] [--tp T] [--schedule gpipe]
        [--rates 50,100,200,400] [--requests 100] [--slo-ms 50] [--seed 0]
        [--out BENCH_SERVING.json]

    # chaos soak: inject die/slow/nan/error faults + one mid-traffic hot
    # reload into seeded open-loop traffic and measure what degrades
    python -m shallowspeed_tpu_torch.serving.bench_serving \
        --chaos "error@dispatch=3,slow@dispatch=5:ms=30,die@dispatch=7,nan@dispatch=9" \
        --reload-dir ck/ --reload-at 5 --requests 80 --rates 300 \
        --slo-ms 2000 --chaos-out CHAOS.json --metrics-out chaos.jsonl

For each offered rate the sweep drives ``--requests`` seeded Poisson
arrivals through a ``ServingEngine`` in open-loop mode (arrivals
independent of completions, enqueue backdated to the scheduled arrival —
queueing delay lands in latency, never silently throttles the offered
load) and records p50/p99 latency, goodput (SLO-met completions per
second), achieved rate, queue depth and padding waste. The saturation knee
is the first rate whose tail violates the SLO or whose achieved rate falls
measurably below the offered one (``observability.slo.slo_breach``).

Output is ONE versioned JSON document with the JAX record's keys
(``bench_version`` + per-row fields): the analytical latency floor
(``costmodel.serving_latency_bound`` — the card's, an H100's on a CUDA
session) is recorded next to the measured percentiles, so the gap between
model and tail is a number, not prose.

The chaos soak (``chaos_soak``) replays the SAME seeded stream twice — a
clean baseline pass, then a pass with a ``faults.py`` dispatch-fault plan
active and one mid-traffic hot weight reload — and reports availability,
goodput retention, the per-verdict terminal counts, breaker trips, the
measured recovery time, and two hard invariants: ZERO silently-lost
requests (every submitted id reaches a terminal verdict) and bitwise
parity of every ``"ok"`` response against a direct ``predict()`` under
the weights active at its dispatch (verified per dispatch). ``die`` faults
raise ``InjectedFault`` out of ``step()``; the soak's operator loop
catches and re-enters — the queue is intact by the engine's contract.

Refused with exit 2 and a pointer: ``--fleet``, ``--kill-after``,
``--no-scale-up``, ``--fleet-policy``, ``--fleet-retry`` and
``--fleet-out`` (the fleet chaos soak comes with the fleet slice,
ROADMAP.md §A item 5), and ``--aot-cache`` (item 14).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from shallowspeed_tpu_torch import faults as F
from shallowspeed_tpu_torch.observability import slo
from shallowspeed_tpu_torch.observability.metrics import json_safe
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.serving.loadgen import (
    poisson_arrivals,
    request_payloads,
    run_open_loop,
)

BENCH_VERSION = 1
CHAOS_VERSION = 1
SWEEP_ROW_FIELDS = (
    "offered_rps",
    "completed",
    "dropped",
    "p50_latency_s",
    "p99_latency_s",
    "goodput_rps",
    "achieved_rps",
    "queue_depth_max",
    "queue_depth_mean",
    "padding_waste",
    "dispatches",
)


def find_knee(rows, slo_ms, achieved_fraction=slo.SLO_ACHIEVED_FRACTION):
    """The saturation knee: the first offered rate (rows are swept in
    ascending offered order) that breaches the shared SLO predicate —
    p99 above the SLO, or achieved rate below ``achieved_fraction`` x
    offered. The breach definition lives in ``observability.slo.
    slo_breach`` (the capacity scoreboard scores violation minutes with
    the SAME call, so knee and scoreboard can never disagree). None =
    no knee inside the swept range (the verdict then says so instead of
    guessing)."""
    for row in rows:
        if slo.slo_breach(
            row.get("p99_latency_s"),
            row.get("offered_rps"),
            row.get("achieved_rps"),
            slo_ms,
            achieved_fraction=achieved_fraction,
        ):
            return row["offered_rps"]
    return None


def sweep(
    session,
    rates,
    n_requests=100,
    seed=0,
    slo_ms=None,
    rows_choices=(1, 2, 3, 4, 8),
    metrics=None,
    max_slots=None,
    dispatch_floor_ms=0.0,
    on_rate=None,
):
    """Run the offered-load sweep on an existing session; returns the
    versioned JSON-able bench record. The SAME seeded request stream is
    replayed at every rate (only the arrival clock changes), so rows
    differ by load, not workload. ``dispatch_floor_ms``/``max_slots``
    shape the engine as the JAX package's replay fleet shapes its workers
    (engine.py "dispatch floor"). ``on_rate(rate, payloads, done)``, when
    given, sees each rate's completed requests after its summary (a
    caller's own checks, e.g. response parity; it adds nothing to the
    record). One engine serves every rate, so request ids run on across
    rates: request ``r`` carries ``payloads[r.id % n_requests]``."""
    engine = ServingEngine(
        session, slo_ms=slo_ms, metrics=metrics, max_slots=max_slots,
        dispatch_floor_ms=dispatch_floor_ms,
    )
    # warm every rung before the sweep: the percentiles must measure
    # serving under load, not the first rate's one-time costs
    engine.warm_ladder()
    payloads = request_payloads(
        n_requests, session.spec.sizes[0], seed=seed, rows_choices=rows_choices
    )
    rows = []
    for rate in sorted(rates):
        engine.reset_stats()
        arrivals = poisson_arrivals(rate, n_requests, seed=seed)
        done = run_open_loop(engine, payloads, arrivals)
        rec = engine.record_summary(offered_rps=rate)
        rows.append({k: rec.get(k) for k in SWEEP_ROW_FIELDS})
        if on_rate is not None:
            on_rate(rate, payloads, done)
    bound = session.inference_latency_bound()
    knee_rps = find_knee(rows, slo_ms)
    record = {
        "bench": "serving",
        "bench_version": BENCH_VERSION,
        "config": {
            "dp": session.dp,
            "pp": session.pp,
            "tp": session.tp,
            "schedule": session.schedule,
            "slot_rows": session.slot_rows,
            "slot_ladder": list(session.slot_ladder),
            "requests_per_rate": n_requests,
            "seed": seed,
            "slo_ms": slo_ms,
            "rows_choices": list(rows_choices),
            "max_slots": max_slots,
            "dispatch_floor_ms": dispatch_floor_ms,
        },
        "latency_bound_s": bound["seconds"],
        "latency_bound_ticks": bound["ticks"],
        "latency_bound_source": bound["peak_source"],
        "sweep": rows,
        "knee_rps": knee_rps,
    }
    if metrics is not None:
        # the sweep summary in the metrics stream too (schema v11): the
        # measured knee lands beside the run it came from, so the
        # knee-proximity alert rule can be armed from the record —
        # never from a hand-copied constant (slo.default_serving_rules)
        metrics.serving(
            "sweep",
            knee_rps=knee_rps,
            rates=[r.get("offered_rps") for r in rows],
            slo_ms=slo_ms,
            requests_per_rate=n_requests,
            latency_bound_s=bound["seconds"],
        )
    return record


def chaos_soak(
    session,
    faults,
    n_requests=80,
    rate=200.0,
    seed=0,
    slo_ms=None,
    rows_choices=(1, 2, 3, 4, 8),
    deadline_ms=None,
    metrics=None,
    reload_dir=None,
    reload_at=None,
    loaded_step=None,
    retry_budget=2,
    breaker_threshold=2,
    max_slots=None,
    verify=True,
    baseline=True,
):
    """The seeded degradation experiment (module docstring): returns the
    versioned JSON-able chaos record. ``faults`` is a ``@dispatch=``
    fault spec/plan; ``reload_at`` triggers the checkpoint-dir WATCHER
    reload once attempted dispatch N is reached (the breaker triggers its
    own reloads independently when poisoned weights trip it);
    ``baseline=True`` first replays the identical stream through a clean
    engine so goodput/p99 retention are measured, not guessed."""
    payloads = request_payloads(
        n_requests, session.spec.sizes[0], seed=seed, rows_choices=rows_choices
    )
    arrivals = poisson_arrivals(rate, n_requests, seed=seed)
    base_stats = None
    if baseline:
        # faults="" pins an EMPTY plan: the engine default falls back to
        # the SHALLOWSPEED_FAULTS environment, which would make the
        # "clean" baseline anything but
        clean = ServingEngine(session, slo_ms=slo_ms, faults="")
        clean.warm_ladder()
        run_open_loop(clean, payloads, arrivals, deadline_ms=deadline_ms)
        base_stats = clean.stats()
    engine = ServingEngine(
        session,
        slo_ms=slo_ms,
        metrics=metrics,
        retry=retry_budget,
        breaker_threshold=breaker_threshold,
        reload_dir=reload_dir,
        loaded_step=loaded_step,
        faults=faults,
        # a small packing capacity spreads the stream over MORE dispatches,
        # so every @dispatch= anchor in the plan is actually reached
        max_slots=max_slots,
    )
    engine.warm_ladder()
    # the zero-recompile anchor of the JAX record: the port's session keeps
    # no jit_compiles counter, so ``recompiles`` stays None; the mesh's
    # rung programs are held by ``predict_cache_stable``
    counters = getattr(session._metrics, "counters", None)
    compiles_before = counters.get("jit_compiles") if counters else None
    cache_before = set(getattr(session, "_predict_cache", {}))
    submitted, done = [], []
    crashes = 0
    parity_mismatches = 0
    reload_done = reload_at is None or reload_dir is None
    t0 = engine.clock()
    i, n = 0, n_requests
    while i < n or engine.queue_depth:
        now = engine.clock() - t0
        while i < n and arrivals[i] <= now:
            submitted.append(
                engine.submit(
                    payloads[i], deadline_ms=deadline_ms,
                    arrival_t=t0 + arrivals[i],
                )
            )
            i += 1
        if not reload_done and engine.dispatch_seq >= reload_at:
            engine.watch_reload()  # the mid-traffic hot swap (watcher leg)
            reload_done = True
        if engine.queue_depth:
            try:
                batch = engine.step()
            except F.InjectedFault:
                # the injected dispatch-loop death: queue intact (die fires
                # before any pop), the operator loop simply re-enters
                crashes += 1
                continue
            if verify:
                # parity under the weights active AT THIS DISPATCH — the
                # oracle runs before any later reload can swap them
                for r in batch:
                    if r.verdict == "ok" and not np.array_equal(
                        r.result, session.predict(payloads[r.id])
                    ):
                        parity_mismatches += 1
            done.extend(batch)
        elif i < n:
            time.sleep(max(0.0, arrivals[i] - (engine.clock() - t0)))
    stats = engine.record_summary(offered_rps=rate, name="chaos")
    compiles_after = counters.get("jit_compiles") if counters else None
    lost = [r.id for r in submitted if r.verdict == "queued"]
    verdicts = {}
    for r in submitted:
        verdicts[r.verdict] = verdicts.get(r.verdict, 0) + 1
    retention = None
    if base_stats and base_stats.get("goodput_rps") and stats.get("goodput_rps"):
        retention = stats["goodput_rps"] / base_stats["goodput_rps"]
    return {
        "bench": "serving_chaos",
        "bench_version": CHAOS_VERSION,
        "config": {
            "dp": session.dp,
            "pp": session.pp,
            "tp": session.tp,
            "schedule": session.schedule,
            "requests": n_requests,
            "rate": rate,
            "seed": seed,
            "slo_ms": slo_ms,
            "deadline_ms": deadline_ms,
            "faults": str(faults),
            "reload_at": reload_at,
            "reload_dir": None if reload_dir is None else str(reload_dir),
            "retry_budget": retry_budget,
            "breaker_threshold": breaker_threshold,
        },
        "submitted": len(submitted),
        "verdicts": verdicts,
        "silently_lost": lost,  # MUST be [] — the no-silent-loss invariant
        # a plan entry that never fired means the soak ended before its
        # dispatch anchor — the chaos coverage claim would be hollow
        "faults_unfired": len(engine._faults.pending_dispatch),
        "parity_mismatches": parity_mismatches,
        "crashes_recovered": crashes,
        "availability": stats.get("availability"),
        "goodput_rps": stats.get("goodput_rps"),
        "baseline_goodput_rps": base_stats.get("goodput_rps") if base_stats else None,
        "goodput_retention": retention,
        "p99_latency_s": stats.get("p99_latency_s"),
        "baseline_p99_latency_s": base_stats.get("p99_latency_s") if base_stats else None,
        "breaker_trips": stats.get("breaker_trips"),
        "reloads": stats.get("reloads"),
        "recovery_s": stats.get("recovery_s"),
        "degraded_at_exit": stats.get("degraded"),
        # the zero-recompile contract across hot reloads (None without a
        # metrics recorder on the session — the counter needs one)
        "recompiles": (
            None
            if compiles_before is None
            else int(compiles_after - compiles_before)
        ),
        "predict_cache_stable": set(
            getattr(session, "_predict_cache", {})
        ) == cache_before,
    }


FLEET_REFUSAL = (
    "comes with the fleet slice: the fleet chaos soak spawns replica worker "
    "processes (ROADMAP.md §A item 5)"
)
# refused flags: (dest, the flag's refusal) — parsed so a JAX bench command
# line reads, then refused with exit 2 before anything is built
REFUSED = (
    ("fleet", f"--fleet {FLEET_REFUSAL}"),
    ("kill_after", f"--kill-after {FLEET_REFUSAL}"),
    ("no_scale_up", f"--no-scale-up {FLEET_REFUSAL}"),
    ("fleet_policy", f"--fleet-policy {FLEET_REFUSAL}"),
    ("fleet_retry", f"--fleet-retry {FLEET_REFUSAL}"),
    ("fleet_out", f"--fleet-out {FLEET_REFUSAL}"),
    ("aot_cache", "--aot-cache (the AOT executable cache) is not ported "
     "(ROADMAP.md §A item 14)"),
)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.serving.bench_serving",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument(
        "--tp", type=int, default=1,
        help="tensor (model-axis) parallelism for the served layout",
    )
    ap.add_argument(
        "--schedule",
        choices=["naive", "gpipe", "pipedream", "interleaved"],
        default="gpipe",
    )
    ap.add_argument("--global-batch-size", type=int, default=128)
    ap.add_argument("--mubatches", type=int, default=4)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--checkpoint", default=None, help="serve these weights")
    ap.add_argument(
        "--rates",
        default="50,100,200,400",
        help="comma-separated offered loads (requests/second)",
    )
    ap.add_argument("--requests", type=int, default=100, help="requests per rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument(
        "--rows",
        default="1,2,3,4,8",
        help="comma-separated request row-count choices",
    )
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument(
        "--chaos",
        default=None,
        help="run the chaos soak instead of the sweep: a dispatch-fault "
        "spec (e.g. 'error@dispatch=3,nan@dispatch=9') injected into the "
        "seeded stream",
    )
    ap.add_argument(
        "--reload-dir",
        default=None,
        help="step-checkpoint directory the engine hot-reloads verified "
        "weights from (breaker-triggered, plus --reload-at's watcher leg)",
    )
    ap.add_argument(
        "--reload-at",
        type=int,
        default=None,
        help="trigger one mid-traffic watch_reload() once attempted "
        "dispatch N is reached",
    )
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--retry-budget", type=int, default=2)
    ap.add_argument("--breaker", type=int, default=2)
    ap.add_argument(
        "--max-slots",
        type=int,
        default=None,
        help="packing capacity per dispatch (the chaos soak: small values "
        "spread the stream over more dispatches so every @dispatch= "
        "anchor is reached)",
    )
    ap.add_argument(
        "--dispatch-floor-ms",
        type=float,
        default=0.0,
        help="per-dispatch service-time floor (engine.py 'dispatch floor')",
    )
    ap.add_argument(
        "--chaos-out", default=None, help="write the chaos JSON record here"
    )
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="refused: the fleet slice (ROADMAP.md §A item 5)")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="refused: the fleet slice")
    ap.add_argument("--no-scale-up", action="store_true",
                    help="refused: the fleet slice")
    ap.add_argument("--fleet-policy", choices=["least_queue", "p2c"],
                    default=None, help="refused: the fleet slice")
    ap.add_argument("--fleet-retry", type=int, default=None,
                    help="refused: the fleet slice")
    ap.add_argument("--fleet-out", default=None, help="refused: the fleet slice")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="refused: ROADMAP.md §A item 14")
    ap.add_argument(
        "--metrics-out",
        default=None,
        help="JSONL sink for the run's request/serving/serving_health/"
        "reload/trace records (the report CLI's Serving, Degradation and "
        "Tracing evidence)",
    )
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, why in REFUSED:
        if getattr(args, dest):
            print(f"{ap.prog}: error: {why}", file=sys.stderr)
            return 2

    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.checkpoint import STEP_CHECKPOINT_RE
    from shallowspeed_tpu_torch.observability import JsonlMetrics

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    session = TrainingSession(
        dp=args.dp,
        pp=args.pp,
        tp=args.tp,
        schedule=args.schedule,
        global_batch_size=args.global_batch_size,
        mubatches=args.mubatches,
        data_dir=args.data_dir,
        resume=args.checkpoint,
        metrics=metrics,
        device=args.device,
    )
    if args.chaos is not None or args.reload_dir is not None:
        # a session restored from a step snapshot seeds the watcher's
        # freshness floor, so --reload-at picks up strictly NEWER weights
        loaded_step = None
        if args.checkpoint:
            m = STEP_CHECKPOINT_RE.match(os.path.basename(args.checkpoint))
            if m:
                loaded_step = int(m.group(1))
        record = chaos_soak(
            session,
            faults=args.chaos,
            n_requests=args.requests,
            rate=float(args.rates.split(",")[0]),
            seed=args.seed,
            slo_ms=args.slo_ms,
            rows_choices=tuple(
                int(r) for r in args.rows.split(",") if r.strip()
            ),
            deadline_ms=args.deadline_ms,
            metrics=metrics,
            reload_dir=args.reload_dir,
            reload_at=args.reload_at,
            loaded_step=loaded_step,
            retry_budget=args.retry_budget,
            breaker_threshold=args.breaker,
            max_slots=args.max_slots,
        )
        text = json.dumps(json_safe(record), indent=2, allow_nan=False)
        if args.chaos_out:
            with open(args.chaos_out, "w", encoding="utf-8") as f:
                f.write(text + "\n")
            print(f"chaos record written: {args.chaos_out}")
        else:
            print(text)
        print(
            f"chaos: {record['submitted']} submitted, verdicts "
            f"{record['verdicts']}, availability "
            + (
                f"{record['availability'] * 100:.1f}%"
                if record["availability"] is not None
                else "n/a"
            )
            + f", {record['breaker_trips']} breaker trip(s), "
            f"{record['reloads']} reload(s), "
            f"{record['crashes_recovered']} crash(es) recovered"
        )
        if metrics is not None:
            session.close()
            metrics.close()
            print(f"telemetry written: {metrics.path}")
        failures = []
        if record["silently_lost"]:
            failures.append(f"{len(record['silently_lost'])} request(s) LOST")
        if record["parity_mismatches"]:
            failures.append(
                f"{record['parity_mismatches']} parity MISMATCH(ES)"
            )
        if record["recompiles"]:
            failures.append(
                f"{record['recompiles']} recompile(s) after hot reload"
            )
        if not record["predict_cache_stable"]:
            failures.append("predict cache changed across reload")
        if failures:
            print("chaos: " + "; ".join(failures), file=sys.stderr)
            return 1
        return 0
    record = sweep(
        session,
        rates=[float(r) for r in args.rates.split(",") if r.strip()],
        n_requests=args.requests,
        seed=args.seed,
        slo_ms=args.slo_ms,
        rows_choices=tuple(int(r) for r in args.rows.split(",") if r.strip()),
        metrics=metrics,
        max_slots=args.max_slots,
        dispatch_floor_ms=args.dispatch_floor_ms,
    )
    text = json.dumps(json_safe(record), indent=2, allow_nan=False)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"bench_serving record written: {args.out}")
        knee = record["knee_rps"]
        print(
            "saturation knee: "
            + (f"{knee} rps" if knee is not None else "not reached in sweep")
        )
    else:
        print(text)
    if metrics is not None:
        session.close()
        metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
