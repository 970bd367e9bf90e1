"""Serve entry point: wire weights to an engine and drive seeded load.

    python -m shallowspeed_tpu_torch.serving [--device cuda|cpu]
        [--dp N] [--pp M] [--tp T] [--schedule gpipe] [--virtual-stages V]
        [--checkpoint ck.npz] [--requests 200] [--rate 100] [--seed 0]
        [--slo-ms 50] [--verify] [--audit] [--metrics-out serve.jsonl]
        [--faults SPEC] [--retry-budget 2] [--breaker 3] [--knee-rps R]
        [--fleet N] [--fleet-policy least_queue|p2c] [--fleet-retry 2]
        [--fleet-max-queue Q]

The JAX serve CLI's (``python -m shallowspeed_tpu.serving``) flags and
output, on the port: builds a ``TrainingSession`` on the requested layout
(the flagship MLP from the deterministic init, or ``--checkpoint`` — any
layout's checkpoint, the JAX package's included, restores onto the serving
layout), wraps it in a ``ServingEngine``, warms every ladder rung, and
drives seeded Poisson load (or a closed-loop population) through it. The
sequential layout runs the CUDA forward kernel; the mesh layouts (dp, pp,
tp, the four schedules, virtual stages) serve on the plain backend, as the
JAX CLI's sessions do. ``--audit`` holds every mesh inference rung to the
forward-only serving contract (its movers' census) and to dispatch safety
(it writes none of its params) before it serves a request
(``observability/program_audit.py``). ``--verify`` re-computes every ``"ok"`` response
with a direct ``session.predict()`` of the same rows and demands bitwise
equality. ``--faults`` injects the chaos plan (``@dispatch=`` grammar;
also read from ``SHALLOWSPEED_FAULTS``). The loadgen drive loops are the
operator loop: an injected ``die`` (mode=exc) is absorbed and the loop
re-enters with the queue intact; ``mode=sigkill`` kills the process. Runs
on the GPU unless ``--device cpu`` is given; a missing GPU is an error,
not a fallback.

With ``--metrics-out`` the stream carries the engine's ``request``,
``serving``, ``serving_health``, ``reload`` and ``trace`` records (one
span chain a request: queue/pack/dispatch/verify/ack) and its live
telemetry (``rollup`` windows, ``alert`` transitions) beside the
session's: render it with ``python -m
shallowspeed_tpu_torch.observability.report <metrics-out>`` (the Serving,
Degradation and Tracing sections) or tail it with ``...observability.watch
<metrics-out> --follow``. ``--knee-rps`` arms the knee-proximity alert rule
with a measured saturation knee from a ``bench_serving`` sweep record.

``--fleet N`` serves through a ``ServingFleet`` instead: N replica worker
processes (each its own session on the requested layout and ``--device``,
its ladder warmed before it takes traffic; on a card the replicas share
it, each with its own CUDA context) behind the router. Every per-engine
flag applies PER REPLICA (``--faults`` / ``SHALLOWSPEED_FAULTS`` inject
into every worker — a ``die@dispatch=N:mode=sigkill`` plan kills replicas
and exercises failover); ``--verify`` moves the bitwise-parity check into
each worker, per response; ``--fleet-policy``, ``--fleet-retry`` and
``--fleet-max-queue`` set the placement policy, the per-request placement
budget and the bounded fleet queue. Workers write per-replica
``<metrics-out>.r{replica_id}`` JSONL shards beside the parent's file.

Refused with exit 2 and a pointer: ``--aot-cache`` (ROADMAP.md §A item
14).

Graceful drain: SIGTERM/SIGINT stop ADMISSION, drain everything already
queued to a terminal verdict, flush the metrics sink, and exit under the
normal code contract.

Exit codes (the JAX CLI's contract):
  0  clean — including a signal-drained run whose accepted requests all
     served;
  1  failed responses: dropped / expired / error / unhealthy verdicts, or a
     bitwise mismatch under --verify (or an audit mismatch raising out of
     warm-up);
  2  usage errors (argparse) and the refused flags above;
  3  DEGRADED at exit — the health breaker is still open; in fleet mode,
     the fleet is still degraded (a QUORUM of replicas down) at exit.
"""

import argparse
import signal
import sys

import numpy as np


class GracefulStop:
    """The SIGTERM/SIGINT latch: ``install()`` registers both handlers
    (remembering the previous ones for ``restore()``), the drivers poll
    ``stop()``."""

    def __init__(self):
        self.signum = None
        self._previous = {}

    def _handle(self, signum, frame):
        self.signum = signum

    def stop(self):
        return self.signum is not None

    def install(self):
        for s in (signal.SIGTERM, signal.SIGINT):
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def restore(self):
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous.clear()


# refused flags: (flag, pointer) — parsed so a JAX serve command line
# reads, then refused with exit 2 before anything is built
REFUSED = (
    ("aot_cache", "--aot-cache (the AOT executable cache) is not ported "
     "(ROADMAP.md §A item 14)"),
)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.serving",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument(
        "--tp",
        type=int,
        default=1,
        help="tensor (model-axis) parallelism: serve through Megatron-"
        "sharded layers (forward-only — one all-reduce per row-parallel "
        "layer)",
    )
    ap.add_argument(
        "--schedule",
        choices=["naive", "gpipe", "pipedream", "interleaved"],
        default="gpipe",
    )
    ap.add_argument("--virtual-stages", type=int, default=1)
    ap.add_argument("--global-batch-size", type=int, default=128)
    ap.add_argument("--mubatches", type=int, default=4)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument(
        "--checkpoint",
        default=None,
        help="weights to serve (any layout's checkpoint restores onto the "
        "serving layout)",
    )
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=100.0, help="offered rps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--rows", default="1,2,3,4,8", help="request row-count choices"
    )
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument(
        "--knee-rps",
        type=float,
        default=None,
        help="measured saturation knee (bench_serving sweep record's "
        "knee_rps) — arms the knee-proximity alert rule; absent = rule off",
    )
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=None,
        help="per-request deadline tag (default: score against --slo-ms); "
        "expired deadlines are SHED with verdict 'expired' at pack time",
    )
    ap.add_argument(
        "--closed-loop",
        type=int,
        default=0,
        metavar="C",
        help="drive a fixed population of C in-flight requests instead of "
        "open-loop Poisson arrivals",
    )
    ap.add_argument(
        "--max-slots",
        type=int,
        default=None,
        help="packing capacity per dispatch (default: the ladder's top rung)",
    )
    ap.add_argument(
        "--slot-rows",
        type=int,
        default=None,
        help="global rows per microbatch slot (default: 8, rounded up to a "
        "dp multiple)",
    )
    ap.add_argument(
        "--slot-ladder",
        default=None,
        help="comma-separated slot counts per dispatch (default 1,2,4,8,16) "
        "— bounds the mesh's inference programs at one per rung",
    )
    ap.add_argument(
        "--faults",
        default=None,
        help="chaos injection spec (e.g. 'error@dispatch=4,slow@dispatch=6"
        ":ms=50'); default: the SHALLOWSPEED_FAULTS environment plan",
    )
    ap.add_argument(
        "--retry-budget",
        type=int,
        default=2,
        help="total dispatch attempts per request before verdict 'error' "
        "(the shared retry.RetryPolicy budget)",
    )
    ap.add_argument(
        "--breaker",
        type=int,
        default=3,
        help="consecutive failed dispatches that open the health breaker "
        "(degraded: admission refused; exit 3 if still open at exit)",
    )
    ap.add_argument(
        "--fleet",
        type=int,
        default=0,
        metavar="N",
        help="serve through a ServingFleet of N replica worker processes "
        "(each its own session on this layout and --device; on a card "
        "they share it) instead of one in-process engine; exit 3 if a "
        "quorum of replicas is down at exit",
    )
    ap.add_argument(
        "--fleet-policy",
        choices=["least_queue", "p2c"],
        default="least_queue",
        help="fleet placement policy: least outstanding load, or "
        "power-of-two-choices",
    )
    ap.add_argument(
        "--fleet-retry",
        type=int,
        default=2,
        help="fleet-level placement budget per request (the shared "
        "retry.RetryPolicy, one attempt per routing) — failover and "
        "verdict reroutes consume it",
    )
    ap.add_argument(
        "--fleet-max-queue",
        type=int,
        default=None,
        help="bounded fleet queue: admissions beyond it are DROPPED "
        "(reason fleet_queue_full); default unbounded",
    )
    ap.add_argument(
        "--aot-cache", default=None, metavar="DIR",
        help="refused: ROADMAP.md §A item 14",
    )
    ap.add_argument(
        "--verify",
        action="store_true",
        help="re-compute every 'ok' response with a direct predict() of the "
        "same rows and demand bitwise equality (exit 1 on any mismatch)",
    )
    ap.add_argument(
        "--audit",
        action="store_true",
        help="census every compiled inference program against the "
        "forward-only serving contract before the first dispatch",
    )
    ap.add_argument("--metrics-out", default=None)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, why in REFUSED:
        if getattr(args, dest):
            print(f"{ap.prog}: error: {why}", file=sys.stderr)
            return 2
    if args.fleet:
        return _fleet_main(args)

    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.observability import JsonlMetrics
    from shallowspeed_tpu_torch.serving.engine import ServingEngine
    from shallowspeed_tpu_torch.serving.loadgen import (
        poisson_arrivals,
        request_payloads,
        run_closed_loop,
        run_open_loop,
    )

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    session = TrainingSession(
        dp=args.dp,
        pp=args.pp,
        tp=args.tp,
        schedule=args.schedule,
        virtual_stages=args.virtual_stages,
        global_batch_size=args.global_batch_size,
        mubatches=args.mubatches,
        data_dir=args.data_dir,
        resume=args.checkpoint,
        metrics=metrics,
        audit=args.audit,
        predict_slot_rows=args.slot_rows,
        predict_slot_ladder=(
            tuple(int(r) for r in args.slot_ladder.split(","))
            if args.slot_ladder
            else None
        ),
        device=args.device,
    )
    engine = ServingEngine(
        session,
        max_slots=args.max_slots,
        slo_ms=args.slo_ms,
        metrics=metrics,
        retry=args.retry_budget,
        breaker_threshold=args.breaker,
        faults=args.faults,
        knee_rps=args.knee_rps,
    )
    payloads = request_payloads(
        args.requests,
        session.spec.sizes[0],
        seed=args.seed,
        rows_choices=tuple(int(r) for r in args.rows.split(",") if r.strip()),
    )
    print(
        f"serving: DP={args.dp} x PP={args.pp} ({args.schedule}), "
        f"slot_rows={session.slot_rows}, ladder={session.slot_ladder}, "
        f"{args.requests} requests"
        + (
            f" closed-loop C={args.closed_loop}"
            if args.closed_loop
            else f" @ {args.rate} rps Poisson (seed {args.seed})"
        )
        + (f", weights from {args.checkpoint}" if args.checkpoint else "")
    )
    # warm every rung before traffic: the percentiles must measure serving,
    # not the kernel build, first launches or a rung program's build
    engine.warm_ladder()
    stopper = GracefulStop().install()
    try:
        if args.closed_loop:
            done = run_closed_loop(
                engine, payloads, concurrency=args.closed_loop,
                deadline_ms=args.deadline_ms, should_stop=stopper.stop,
            )
        else:
            arrivals = poisson_arrivals(args.rate, args.requests, seed=args.seed)
            done = run_open_loop(
                engine, payloads, arrivals, deadline_ms=args.deadline_ms,
                should_stop=stopper.stop,
            )
    finally:
        stopper.restore()
    last_error = engine.stats()["last_error"]
    rec = engine.record_summary(
        offered_rps=None if args.closed_loop else args.rate
    )
    if stopper.stop():
        sig = signal.Signals(stopper.signum).name
        print(
            f"{sig} received: admission stopped, queue drained "
            f"({rec['completed']} served of {len(done)} accepted)"
        )

    def ms(v):
        return f"{v * 1e3:.2f} ms" if v is not None else "n/a"

    print(
        f"completed {rec['completed']}/{args.requests}, dropped "
        f"{rec['dropped']}, expired {rec['expired']}, errors "
        f"{rec['errors']}, unhealthy {rec['unhealthy']}, "
        f"{rec['dispatches']} dispatches "
        f"({rec['slots_dispatched']} slots"
        + (
            f", padding waste {rec['padding_waste'] * 100:.1f}%)"
            if rec["padding_waste"] is not None
            else ")"
        )
    )
    print(
        f"latency p50 {ms(rec['p50_latency_s'])}, p99 "
        f"{ms(rec['p99_latency_s'])}, model floor "
        f"{ms(rec['latency_bound_s'])} ({rec['latency_bound_source']})"
    )
    if rec["goodput_rps"] is not None:
        print(
            f"goodput {rec['goodput_rps']:.1f} rps ({rec['slo_met']}/"
            f"{rec['completed']} within SLO), queue depth max "
            f"{rec['queue_depth_max']}"
        )
    if rec["failed_dispatches"]:
        print(
            f"dispatch errors: {rec['failed_dispatches']} failed dispatch(es), "
            f"last: {last_error}"
        )
    if rec["breaker_trips"] or rec["reloads"]:
        print(
            f"degradation: {rec['breaker_trips']} breaker trip(s), "
            f"{rec['reloads']} reload(s)"
            + (
                f", recovered in {rec['recovery_s'] * 1e3:.1f} ms"
                if rec["recovery_s"] is not None
                else ""
            )
        )
    failures = (
        rec["dropped"] + rec["expired"] + rec["errors"] + rec["unhealthy"]
    )
    if args.verify:
        served = [r for r in done if r.verdict == "ok"]
        mismatched = 0
        for req in sorted(served, key=lambda r: r.id):
            direct = session.predict(payloads[req.id])  # ids are submit order
            if not np.array_equal(req.result, direct):
                mismatched += 1
        print(
            f"verify: {len(served) - mismatched}/{len(served)} responses "
            "bitwise-equal to direct predict()"
            + ("" if mismatched == 0 else f" — {mismatched} MISMATCHED")
        )
        failures += mismatched
    if metrics is not None:
        session.close()
        metrics.close()
        print(
            f"telemetry written: {metrics.path} (request + trace records; "
            "the report CLI renders the Serving and Tracing sections)"
        )
    if engine.degraded:
        print("serving: engine DEGRADED at exit (breaker open)", file=sys.stderr)
        return 3
    if failures:
        print(
            f"serving: {failures} dropped/expired/errored/unhealthy/"
            "incorrect response(s)",
            file=sys.stderr,
        )
        return 1
    return 0


def _fleet_main(args):
    """The ``--fleet N`` serve path: N replica workers behind the router,
    the same seeded load, the same exit-code contract (module
    docstring)."""
    from shallowspeed_tpu_torch.observability import JsonlMetrics
    from shallowspeed_tpu_torch.serving.fleet import ServingFleet
    from shallowspeed_tpu_torch.serving.loadgen import (
        payload_in_dim,
        poisson_arrivals,
        request_payloads,
        run_closed_loop,
        run_open_loop,
    )

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    worker_config = {
        "session": dict(
            dp=args.dp,
            pp=args.pp,
            tp=args.tp,
            schedule=args.schedule,
            virtual_stages=args.virtual_stages,
            global_batch_size=args.global_batch_size,
            mubatches=args.mubatches,
            data_dir=args.data_dir,
            resume=args.checkpoint,
            audit=args.audit,
            predict_slot_rows=args.slot_rows,
            predict_slot_ladder=(
                tuple(int(r) for r in args.slot_ladder.split(","))
                if args.slot_ladder
                else None
            ),
            device=args.device,
        ),
        "engine": dict(
            max_slots=args.max_slots,
            slo_ms=args.slo_ms,
            retry=args.retry_budget,
            breaker_threshold=args.breaker,
            faults=args.faults,
            knee_rps=args.knee_rps,
        ),
        "verify": args.verify,
    }
    fleet = ServingFleet(
        worker_config,
        n_replicas=args.fleet,
        policy=args.fleet_policy,
        max_queue=args.fleet_max_queue,
        slo_ms=args.slo_ms,
        retry=args.fleet_retry,
        metrics=metrics,
        seed=args.seed,
        knee_rps=args.knee_rps,
    )
    print(
        f"fleet: {args.fleet} replicas x (DP={args.dp} x PP={args.pp} x "
        f"TP={args.tp}, {args.schedule}), policy {args.fleet_policy}, "
        f"{args.requests} requests"
        + (
            f" closed-loop C={args.closed_loop}"
            if args.closed_loop
            else f" @ {args.rate} rps Poisson (seed {args.seed})"
        )
        + (f", weights from {args.checkpoint}" if args.checkpoint else "")
    )
    stopper = GracefulStop().install()
    try:
        fleet.start()  # every replica's ladder warmed before traffic
        payloads = request_payloads(
            args.requests,
            payload_in_dim(args.data_dir),
            seed=args.seed,
            rows_choices=tuple(
                int(r) for r in args.rows.split(",") if r.strip()
            ),
        )
        if args.closed_loop:
            done = run_closed_loop(
                fleet, payloads, concurrency=args.closed_loop,
                deadline_ms=args.deadline_ms, should_stop=stopper.stop,
            )
        else:
            arrivals = poisson_arrivals(args.rate, args.requests, seed=args.seed)
            done = run_open_loop(
                fleet, payloads, arrivals, deadline_ms=args.deadline_ms,
                should_stop=stopper.stop,
            )
        rec = fleet.record_summary(
            offered_rps=None if args.closed_loop else args.rate
        )
    finally:
        stopper.restore()
        fleet.stop()
    if stopper.stop():
        sig = signal.Signals(stopper.signum).name
        print(
            f"{sig} received: admission stopped, fleet drained "
            f"({rec['completed']} served)"
        )

    def ms(v):
        return f"{v * 1e3:.2f} ms" if v is not None else "n/a"

    print(
        f"completed {rec['completed']}/{args.requests}, dropped "
        f"{rec['dropped']}, expired {rec['expired']}, errors "
        f"{rec['errors']}, unhealthy {rec['unhealthy']}; latency p50 "
        f"{ms(rec['p50_latency_s'])}, p99 {ms(rec['p99_latency_s'])}"
    )
    routing = ", ".join(
        f"r{rid}: {n}" for rid, n in sorted(rec["routing"].items())
    )
    print(
        f"routing: {routing}"
        + (
            f" — skew {rec['routing_skew']:.2f}x"
            if rec["routing_skew"] is not None
            else ""
        )
    )
    if rec["failovers"] or rec["replicas_dead"]:
        print(
            f"failover: {rec['replicas_dead']} replica death(s), "
            f"{rec['failovers']} failover(s), {rec['failover_requeued']} "
            f"in-flight re-queued, {rec['reroutes']} reroute(s)"
            + (
                f", recovered in {rec['recovery_s'] * 1e3:.1f} ms"
                if rec["recovery_s"] is not None
                else ""
            )
        )
    if args.verify:
        served = rec["completed"]
        mism = rec["parity_mismatches"]
        print(
            f"verify: {served - mism}/{served} responses bitwise-equal to "
            "the serving replica's direct predict()"
            + ("" if mism == 0 else f" — {mism} MISMATCHED")
        )
    if metrics is not None:
        metrics.close()
        print(
            f"telemetry written: {metrics.path} (+ .r* replica shards; "
            "pass the glob to the report CLI for the merged Fleet and "
            "Tracing sections)"
        )
    failures = (
        rec["dropped"] + rec["expired"] + rec["errors"] + rec["unhealthy"]
        + rec["parity_mismatches"]
    )
    if rec["degraded"]:
        print(
            "serving: fleet DEGRADED at exit (quorum of replicas down)",
            file=sys.stderr,
        )
        return 3
    if failures:
        print(
            f"serving: {failures} dropped/expired/errored/unhealthy/"
            "incorrect response(s)",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
