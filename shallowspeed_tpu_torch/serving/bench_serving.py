"""Latency-denominated load bench: p50/p99, goodput and the saturation knee,
plus the seeded CHAOS SOAK and the FLEET chaos soak — the port of
``shallowspeed_tpu/serving/bench_serving.py``.

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

    # fleet chaos soak: 3 replica worker processes behind the router, the
    # busiest one SIGKILLed after 20 served responses, a replacement
    # scaled up from the newest good snapshot — zero silently-lost
    # requests, worker-side bitwise parity, measured goodput dip +
    # recovery
    python -m shallowspeed_tpu_torch.serving.bench_serving --fleet 3 \
        --checkpoint ck/step-00000008.npz --reload-dir ck/ \
        --kill-after 20 --requests 120 --rates 300 --slo-ms 2000 \
        --fleet-out FLEET_CHAOS.json --metrics-out fleet.jsonl

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

The fleet chaos soak (``fleet_chaos_soak``, ``--fleet N``) drives the
seeded stream through a ``ServingFleet`` of N replica worker processes on
``--device`` (on a card they share it, each with its own CUDA context),
SIGKILLs the busiest replica after ``--kill-after`` served responses and
scales up a replacement: zero silently-lost requests and zero worker-side
parity mismatches are gated (exit 1 otherwise).

``--aot-cache DIR`` hands the AOT program cache (``aot_cache.py``) to the
session, or to every fleet replica: the first replicas store the rung
ladder's resolved programs, a scale-up replacement loads them (its
``scale_up_s`` beside the initial replicas' ``initial_ready_s``).
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
FLEET_CHAOS_VERSION = 1
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


def fleet_chaos_soak(
    worker_config,
    in_dim,
    n_replicas=3,
    kill_after=20,
    scale_up=True,
    n_requests=120,
    rate=300.0,
    seed=0,
    slo_ms=None,
    deadline_ms=None,
    rows_choices=(1, 2, 3, 4, 8),
    metrics=None,
    retry=2,
    policy="least_queue",
):
    """The FLEET chaos soak: drive the seeded
    stream through a ``ServingFleet`` and SIGKILL one replica mid-soak —
    the honest preemption, nothing flushes — then (``scale_up=True``)
    spawn a replacement from the newest good snapshot once the death is
    detected. Returns the versioned JSON-able record.

    The kill is anchored at the ``kill_after``-th served response (a
    completion count, so it replays deterministically against the seeded
    stream) and lands on the ready replica with the MOST un-acked
    in-flight requests — the worst case failover has to re-route.

    Hard invariants the record carries (``main`` gates on them):
    ``silently_lost`` must be ``[]`` (every admitted request
    reaches exactly one terminal verdict, SIGKILL or not),
    ``parity_mismatches`` must be 0 (every "ok" response bitwise-equal
    to its replica's direct ``predict()``, checked in the worker before
    the pipe hop). The degradation story is measured, not guessed:
    goodput before the kill vs after, the service stall (kill -> next
    served response), failover + requeue counts, the replacement's
    spawn-to-ready wall, and the fleet's own ``recovery_s``."""
    from shallowspeed_tpu_torch.serving.fleet import FleetError, ServingFleet

    config = dict(worker_config)
    config["verify"] = True  # the parity invariant is the point
    fleet = ServingFleet(
        config,
        n_replicas=n_replicas,
        policy=policy,
        slo_ms=slo_ms,
        retry=retry,
        metrics=metrics,
        seed=seed,
    )
    payloads = request_payloads(
        n_requests, in_dim, seed=seed, rows_choices=rows_choices
    )
    arrivals = poisson_arrivals(rate, n_requests, seed=seed)
    submitted, done, ok_times = [], [], []
    victim = None
    kill_t = None
    killed_inflight = None
    scaled = False
    scale_t = None
    initial_ready = []
    try:
        fleet.start()  # every ladder warmed before traffic
        # the initial replicas' spawn->ready walls: the cold-start
        # baseline the replacement's scale_up_s is compared against
        initial_ready = [
            w
            for w in (
                info.snapshot()["ready_wall_s"]
                for info in fleet.replicas.values()
            )
            if w is not None
        ]
        t0 = fleet.clock()
        i = 0
        while i < n_requests or fleet.queue_depth:
            now = fleet.clock() - t0
            while i < n_requests and arrivals[i] <= now:
                submitted.append(
                    fleet.submit(
                        payloads[i], deadline_ms=deadline_ms,
                        arrival_t=t0 + arrivals[i],
                    )
                )
                i += 1
            batch = fleet.step()
            done.extend(batch)
            for r in batch:
                if r.verdict == "ok":
                    ok_times.append(r.complete_t - t0)
            if victim is None and len(ok_times) >= kill_after:
                ready = [
                    info for info in fleet.replicas.values()
                    if info.state == "ready"
                ]
                if ready:
                    # the worst case: the replica holding the most
                    # un-acked work (ties to the lowest id — replayable).
                    # Wait for a moment when the victim actually HOLDS
                    # work — a kill with nothing in flight exercises
                    # death detection but not failover; the bounded
                    # fallback (twice the anchor) keeps the kill certain
                    # even if the stream never catches a replica busy
                    chosen = max(
                        ready, key=lambda r: (r.inflight, -r.replica_id)
                    )
                    if (
                        chosen.inflight >= 1
                        or len(ok_times) >= 2 * kill_after
                        or i >= n_requests
                    ):
                        victim = chosen.replica_id
                        killed_inflight = chosen.inflight
                        kill_t = fleet.clock() - t0
                        fleet.sigkill_replica(victim)
            if (
                victim is not None
                and scale_up
                and not scaled
                and any(
                    info.state == "dead" for info in fleet.replicas.values()
                )
            ):
                # elasticity as the recovery path: replacement from the
                # newest find_latest_good snapshot, warming off-path
                fleet.scale_up(wait_ready=False)
                scaled = True
                scale_t = fleet.clock() - t0
            if not fleet.queue_depth and i < n_requests:
                time.sleep(max(0.0, arrivals[i] - (fleet.clock() - t0)))
        if scaled:
            # let the replacement finish warming so its spawn-to-ready
            # wall is measured, not cut off by the soak ending first
            try:
                fleet.wait_ready()
            except FleetError:
                pass  # a failed replacement is part of the record
        end_t = fleet.clock() - t0
        stats = fleet.record_summary(offered_rps=rate)
    finally:
        fleet.stop()
    # the distributed-tracing gate: with a JSONL sink attached, re-read
    # the parent + .r* shards and assert every terminal request left a
    # complete, clock-aligned span chain — a SIGKILL that orphans a chain
    # is a tracing bug even when no request was lost
    trace_chains = trace_problems = None
    metrics_path = getattr(metrics, "path", None)
    if metrics_path:
        from shallowspeed_tpu_torch.observability import tracing
        from shallowspeed_tpu_torch.observability.metrics import read_jsonl

        metrics.flush()
        try:
            recs = read_jsonl(f"{metrics_path}*")
        except (OSError, ValueError) as e:
            trace_problems = [f"trace shards unreadable: {e}"[:200]]
        else:
            chains = tracing.assemble_chains(recs)
            trace_chains = len(chains)
            trace_problems = tracing.verify_terminal_chains(recs, chains)
    lost = [r.id for r in submitted if r.verdict == "queued"]
    verdicts = {}
    for r in submitted:
        verdicts[r.verdict] = verdicts.get(r.verdict, 0) + 1
    # the goodput dip, measured: served rate before the kill, the service
    # stall the kill caused, and the served rate over the recovery tail
    before = [t for t in ok_times if kill_t is None or t < kill_t]
    after = [t for t in ok_times if kill_t is not None and t >= kill_t]
    goodput_before = (
        len(before) / kill_t if kill_t else None
    )
    goodput_after = (
        len(after) / (end_t - kill_t)
        if kill_t is not None and end_t > kill_t
        else None
    )
    stall_s = (min(after) - kill_t) if after else None
    return {
        "bench": "serving_fleet_chaos",
        "bench_version": FLEET_CHAOS_VERSION,
        "config": {
            "n_replicas": n_replicas,
            "policy": policy,
            "requests": n_requests,
            "rate": rate,
            "seed": seed,
            "slo_ms": slo_ms,
            "deadline_ms": deadline_ms,
            "kill_after": kill_after,
            "scale_up": scale_up,
            "fleet_retry": retry,
            "session": {
                k: str(v) if k in ("data_dir", "resume") and v else v
                for k, v in (worker_config.get("session") or {}).items()
            },
        },
        "submitted": len(submitted),
        "verdicts": verdicts,
        "silently_lost": lost,  # MUST be [] — the no-silent-loss invariant
        "parity_mismatches": stats.get("parity_mismatches"),
        # span-chain completeness over the merged shards (None without a
        # JSONL sink); trace_problems MUST be [] — zero orphan/unclosed
        # chains across the kill
        "trace_chains": trace_chains,
        "trace_problems": trace_problems,
        "killed_replica": victim,
        "kill_t_s": kill_t,
        # how much un-acked work the SIGKILL destroyed — 0 means the
        # bounded fallback fired on an idle replica, so a failover count
        # of 0 is the honest outcome, not a miss (the smoke gates on
        # this pair together)
        "killed_inflight": killed_inflight,
        "replicas_dead": stats.get("replicas_dead"),
        "failovers": stats.get("failovers"),
        "failover_requeued": stats.get("failover_requeued"),
        "reroutes": stats.get("reroutes"),
        "scale_ups": stats.get("scale_ups"),
        "scale_up_s": stats.get("scale_up_s"),
        # spawn->ready walls of the INITIAL replicas (cold start): the
        # baseline a replacement's scale_up_s reads against
        "initial_ready_s": initial_ready,
        "initial_ready_s_mean": (
            sum(initial_ready) / len(initial_ready) if initial_ready else None
        ),
        "recovery_s": stats.get("recovery_s"),
        "goodput_before_rps": goodput_before,
        "goodput_after_rps": goodput_after,
        "kill_stall_s": stall_s,
        "availability": stats.get("availability"),
        "p50_latency_s": stats.get("p50_latency_s"),
        "p99_latency_s": stats.get("p99_latency_s"),
        "routing": stats.get("routing"),
        "routing_skew": stats.get("routing_skew"),
        "degraded_at_exit": stats.get("degraded"),
    }


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
    ap.add_argument(
        "--fleet",
        type=int,
        default=0,
        metavar="N",
        help="run the FLEET chaos soak instead: N replica worker "
        "processes behind the router, one SIGKILLed mid-soak",
    )
    ap.add_argument(
        "--kill-after",
        type=int,
        default=20,
        help="fleet soak: SIGKILL the busiest replica once this many "
        "responses have served (a completion anchor — deterministic "
        "against the seeded stream)",
    )
    ap.add_argument(
        "--no-scale-up",
        action="store_true",
        help="fleet soak: do NOT spawn a replacement replica after the "
        "kill (measures failover without elasticity)",
    )
    ap.add_argument(
        "--fleet-policy",
        choices=["least_queue", "p2c"],
        default="least_queue",
    )
    ap.add_argument(
        "--fleet-retry",
        type=int,
        default=2,
        help="fleet-level placement budget per request",
    )
    ap.add_argument(
        "--fleet-out", default=None, help="write the fleet chaos JSON here"
    )
    ap.add_argument(
        "--aot-cache",
        default=None,
        metavar="DIR",
        help="AOT program cache directory (shared by every fleet replica: "
        "the first replicas write entries on their cold start, a scale-up "
        "replacement loads them — its scale_up_s vs the initial replicas' "
        "cold ready walls is the record's scoreboard)",
    )
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

    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.checkpoint import STEP_CHECKPOINT_RE
    from shallowspeed_tpu_torch.observability import JsonlMetrics

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    if args.fleet:
        return _fleet_main(args, metrics)
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
        aot_cache_dir=args.aot_cache,
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


def _fleet_main(args, metrics):
    """The ``--fleet N`` bench path: the fleet chaos soak (one replica
    SIGKILLed mid-soak, replacement scaled up), its JSON record, and the
    gate on its hard invariants."""
    from shallowspeed_tpu_torch.serving.loadgen import payload_in_dim

    in_dim = payload_in_dim(args.data_dir)
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
            retry=args.retry_budget,
            breaker_threshold=args.breaker,
            reload_dir=args.reload_dir,
        ),
    }
    record = fleet_chaos_soak(
        worker_config,
        in_dim=in_dim,
        n_replicas=args.fleet,
        kill_after=args.kill_after,
        scale_up=not args.no_scale_up,
        n_requests=args.requests,
        rate=float(args.rates.split(",")[0]),
        seed=args.seed,
        slo_ms=args.slo_ms,
        deadline_ms=args.deadline_ms,
        rows_choices=tuple(int(r) for r in args.rows.split(",") if r.strip()),
        metrics=metrics,
        retry=args.fleet_retry,
        policy=args.fleet_policy,
    )
    text = json.dumps(json_safe(record), indent=2, allow_nan=False)
    if args.fleet_out:
        with open(args.fleet_out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"fleet chaos record written: {args.fleet_out}")
    else:
        print(text)
    kill_t = record["kill_t_s"]
    print(
        f"fleet chaos: {record['submitted']} submitted, verdicts "
        f"{record['verdicts']}, replica {record['killed_replica']} "
        f"SIGKILLed at t={'n/a' if kill_t is None else f'{kill_t:.2f}s'}, "
        f"{record['failovers']} failover(s) ({record['failover_requeued']} "
        f"requeued), {record['scale_ups']} scale-up(s)"
        + (
            f" (ready in {record['scale_up_s']:.2f}s)"
            if record["scale_up_s"] is not None
            else ""
        )
        + ", availability "
        + (
            f"{record['availability'] * 100:.1f}%"
            if record["availability"] is not None
            else "n/a"
        )
    )
    if metrics is not None:
        metrics.close()
        print(f"telemetry written: {metrics.path} (+ .r* replica shards)")
    failures = []
    if record["silently_lost"]:
        failures.append(f"{len(record['silently_lost'])} request(s) LOST")
    if record["parity_mismatches"]:
        failures.append(f"{record['parity_mismatches']} parity MISMATCH(ES)")
    if record["trace_problems"]:
        failures.append(
            f"{len(record['trace_problems'])} incomplete span chain(s): "
            + "; ".join(record["trace_problems"][:3])
        )
    if record["killed_replica"] is None:
        failures.append(
            "the SIGKILL never fired (stream ended before --kill-after)"
        )
    if record["degraded_at_exit"]:
        failures.append("fleet DEGRADED at exit (quorum down)")
    if not args.no_scale_up and not record["scale_ups"]:
        failures.append("scale-up never triggered")
    if failures:
        print("fleet chaos: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
