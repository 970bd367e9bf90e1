"""Serve entry point: wire weights to an engine and drive seeded load.

    python -m shallowspeed_tpu_torch.serving [--device cuda|cpu]
        [--checkpoint ck.npz] [--requests 200] [--rate 100] [--seed 0]
        [--rows 1,2,3,4,8] [--slot-rows 8] [--slot-ladder 1,2,4,8,16]
        [--max-slots N] [--closed-loop C] [--deadline-ms D] [--slo-ms S]
        [--retry-budget 2] [--breaker 3] [--verify] [--metrics-out serve.jsonl]

Builds the port's ``TrainingSession`` (the flagship MLP from the
deterministic init, or ``--checkpoint`` — any checkpoint the JAX package
wrote), wraps it in a ``ServingEngine``, warms every ladder rung, and
drives seeded Poisson load (or a closed-loop population) through it.
``--verify`` re-computes every ``"ok"`` response with a direct
``session.predict()`` of the same rows and demands bitwise equality.
Runs on the GPU unless ``--device cpu`` is given; a missing GPU is an
error, not a fallback.

``--metrics-out`` records what the session records (its construction
spans and the ``cost_model`` behind the latency floor, schema v13); the
engine's per-request records come with the rest of serving.

SIGTERM/SIGINT stop admission, drain what was accepted, and exit under the
normal code contract.

Exit codes (the JAX CLI's contract):
  0  clean;
  1  failed responses: dropped / expired / error / unhealthy verdicts, or a
     bitwise mismatch under --verify;
  2  usage errors (argparse);
  3  DEGRADED at exit — the health breaker is still open.
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.serving",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--checkpoint", default=None, help="weights to serve")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=100.0, help="offered rps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--rows", default="1,2,3,4,8", help="request row-count choices"
    )
    ap.add_argument("--slo-ms", type=float, default=None)
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
        "--slot-rows", type=int, default=None, help="rows per slot (default 8)"
    )
    ap.add_argument(
        "--slot-ladder",
        default=None,
        help="comma-separated slot counts per dispatch (default 1,2,4,8,16)",
    )
    ap.add_argument(
        "--retry-budget",
        type=int,
        default=2,
        help="total dispatch attempts per request before verdict 'error'",
    )
    ap.add_argument(
        "--breaker",
        type=int,
        default=3,
        help="consecutive failed dispatches that open the health breaker "
        "(degraded: admission refused; exit 3 if still open at exit)",
    )
    ap.add_argument(
        "--verify",
        action="store_true",
        help="re-compute every 'ok' response with a direct predict() of the "
        "same rows and demand bitwise equality (exit 1 on any mismatch)",
    )
    ap.add_argument(
        "--metrics-out", default=None,
        help="record the session's telemetry (spans, cost_model) to this JSONL file",
    )
    args = ap.parse_args(argv)

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
        metrics=metrics,
        resume=args.checkpoint,
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
        retry=args.retry_budget,
        breaker_threshold=args.breaker,
    )
    payloads = request_payloads(
        args.requests,
        session.spec.sizes[0],
        seed=args.seed,
        rows_choices=tuple(int(r) for r in args.rows.split(",") if r.strip()),
    )
    print(
        f"serving: sequential on {session.device}, "
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
    # not the kernel build and first-launch costs
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
            f"last: {rec['last_error']}"
        )
    if rec["breaker_trips"]:
        print(
            f"degradation: {rec['breaker_trips']} breaker trip(s)"
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
        print(f"telemetry written: {metrics.path}")
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


if __name__ == "__main__":
    sys.exit(main())
