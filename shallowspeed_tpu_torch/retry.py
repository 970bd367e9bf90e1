"""Bounded exponential-backoff retry: a copy of ``shallowspeed_tpu/retry.py``.

Three consumers: the serving engine's dispatch recovery (``RetryPolicy``,
the policy as a value for a caller that owns its retry loop), the
checkpoint write path (``checkpoint.write_snapshot`` retries the atomic
write on a transient ``OSError`` through ``retry_call``) and the
multi-process join (``parallel/multihost.initialize`` retries an explicit
coordinator through ``retry_call``, on the JAX schedule). Delay for attempt ``i``
(0-based, before retry ``i+1``) is ``min(base * factor**i, max_delay)``
plus uniform jitter in ``[-jitter, +jitter] * delay``, DETERMINISTIC given
``seed``.

CLI (for shell consumers — prints one delay per line, in seconds)::

    python -m shallowspeed_tpu_torch.retry --attempts 8 --base 60 --max 1200
"""

import argparse
import random
import sys
import time


def backoff_delay(
    attempt, base=1.0, factor=2.0, max_delay=60.0, jitter=0.1, seed=None
):
    """Delay in seconds before retry ``attempt + 1`` (attempt is 0-based);
    the same (seed, attempt) pair always gives the same delay."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    if base < 0 or factor < 1.0 or max_delay < 0:
        raise ValueError("need base >= 0, factor >= 1, max_delay >= 0")
    if not 0 <= jitter < 1:
        raise ValueError("jitter must be in [0, 1)")
    delay = min(base * factor**attempt, max_delay)
    if jitter:
        rng = random.Random(f"{seed}:{attempt}")
        delay *= 1.0 + rng.uniform(-jitter, jitter)
    return max(0.0, delay)


def backoff_delays(attempts, **kwargs):
    """The full schedule: ``[backoff_delay(0), ..., backoff_delay(n-1)]``."""
    return [backoff_delay(i, **kwargs) for i in range(attempts)]


class RetryPolicy:
    """The backoff policy as a value: a bounded total-attempts budget plus
    the ``backoff_delay`` schedule, for consumers that own their retry loop
    (the serving engine re-queues a failed batch and retries it on a later
    ``step()``). ``attempts`` is the TOTAL budget; ``base=0`` makes every
    delay 0 — bounded retries, no stall."""

    __slots__ = ("attempts", "base", "factor", "max_delay", "jitter", "seed")

    def __init__(
        self, attempts=3, base=0.1, factor=2.0, max_delay=5.0, jitter=0.1,
        seed=None,
    ):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = int(attempts)
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.seed = seed
        # validate eagerly: a bad policy fails at configure time
        backoff_delay(
            0, base=base, factor=factor, max_delay=max_delay, jitter=jitter,
            seed=seed,
        )

    def delay(self, attempt):
        """Seconds to wait before retry ``attempt + 1`` (0-based)."""
        return backoff_delay(
            attempt, base=self.base, factor=self.factor,
            max_delay=self.max_delay, jitter=self.jitter, seed=self.seed,
        )

    def exhausted(self, attempts_used):
        """True once ``attempts_used`` has consumed the whole budget."""
        return attempts_used >= self.attempts

    def __repr__(self):
        return (
            f"RetryPolicy(attempts={self.attempts}, base={self.base}, "
            f"factor={self.factor}, max_delay={self.max_delay})"
        )


def retry_call(
    fn,
    *,
    attempts=3,
    base=0.1,
    factor=2.0,
    max_delay=5.0,
    jitter=0.1,
    seed=None,
    retry_on=(OSError,),
    on_retry=None,
    sleep=time.sleep,
):
    """Call ``fn()`` with bounded exponential-backoff retries. Retries only
    on exception types in ``retry_on``; everything else, and the last
    failing attempt, propagates unwrapped. ``on_retry(attempt, exc,
    delay)`` observes each retry (attempt 0-based); ``sleep`` is injectable
    for tests. ``attempts`` is the TOTAL call budget (>= 1): at most
    ``attempts`` calls and ``attempts - 1`` sleeps."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = backoff_delay(
                attempt, base=base, factor=factor, max_delay=max_delay,
                jitter=jitter, seed=seed,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.retry",
        description="Print a bounded exponential-backoff schedule, one delay "
        "(integer seconds) per line.",
    )
    ap.add_argument("--attempts", type=int, default=8)
    ap.add_argument("--base", type=float, default=1.0)
    ap.add_argument("--factor", type=float, default=2.0)
    ap.add_argument("--max", dest="max_delay", type=float, default=60.0)
    ap.add_argument("--jitter", type=float, default=0.1)
    ap.add_argument(
        "--seed", type=int, default=0,
        help="jitter seed (schedules are deterministic per seed)",
    )
    args = ap.parse_args(argv)
    try:
        delays = backoff_delays(
            args.attempts, base=args.base, factor=args.factor,
            max_delay=args.max_delay, jitter=args.jitter, seed=args.seed,
        )
    except ValueError as e:
        print(f"retry: {e}", file=sys.stderr)
        return 1
    for d in delays:
        print(int(round(d)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
