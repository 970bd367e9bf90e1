"""Bounded exponential-backoff retry policy.

A copy of what the serving engine uses from ``shallowspeed_tpu/retry.py``:
``backoff_delay`` and ``RetryPolicy``. Delay for attempt ``i`` (0-based,
before retry ``i+1``) is ``min(base * factor**i, max_delay)`` plus uniform
jitter in ``[-jitter, +jitter] * delay``, DETERMINISTIC given ``seed``.
"""

import random


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
