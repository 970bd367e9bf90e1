"""Load generation for the serving engine: seeded arrivals + drive modes.

The counterpart of ``shallowspeed_tpu/serving/loadgen.py``. Everything is
seeded: two runs with one seed offer the identical request stream (sizes,
contents, arrival times), which lets ``--verify`` assert bitwise response
parity under load and lets the port and the JAX package be fed the same
stream.

- **open loop** (``run_open_loop``): Poisson arrivals REGARDLESS of
  completions, enqueue timestamps backdated to the scheduled arrival (the
  coordinated-omission correction);
- **closed loop** (``run_closed_loop``): a fixed population of
  ``concurrency`` outstanding requests, each completion replaced at once.

Both read ``engine.clock``, so every timestamp lives in one clock domain.
"""

import time

import numpy as np


def poisson_arrivals(rate_rps, n, seed=0):
    """``n`` seeded Poisson arrival times (seconds from start): cumulative
    exponential interarrivals at ``rate_rps`` requests/second."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if n < 1:
        raise ValueError("n must be >= 1")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def request_payloads(n, in_dim, seed=0, rows_choices=(1, 2, 3, 4, 8)):
    """``n`` seeded variable-size standard-normal request payloads, each
    ``(rows, in_dim)`` float32 with ``rows`` drawn from ``rows_choices``."""
    rng = np.random.RandomState(seed)
    sizes = rng.choice(list(rows_choices), size=n)
    return [rng.randn(int(rows), in_dim).astype(np.float32) for rows in sizes]


def run_open_loop(engine, payloads, arrivals, deadline_ms=None, should_stop=None):
    """Replay ``payloads`` on the ``arrivals`` schedule (seconds from start,
    one per payload); returns the completed requests. All due arrivals are
    submitted (backdated), then one batching step serves the queue's head;
    the host sleeps only when idle. ``deadline_ms`` counts from the
    SCHEDULED arrival. ``should_stop``: a zero-arg callable polled each
    iteration; once True, admission stops and the queue drains."""
    if len(payloads) != len(arrivals):
        raise ValueError("one arrival time per payload")
    t0 = engine.clock()
    done, i, n = [], 0, len(payloads)
    while i < n or engine.queue_depth:
        if should_stop is not None and should_stop():
            done.extend(engine.drain())
            break
        now = engine.clock() - t0
        while i < n and arrivals[i] <= now:
            engine.submit(
                payloads[i], deadline_ms=deadline_ms, arrival_t=t0 + arrivals[i]
            )
            i += 1
        if engine.queue_depth:
            done.extend(engine.step())
        elif i < n:
            time.sleep(max(0.0, arrivals[i] - (engine.clock() - t0)))
    return done


def run_closed_loop(
    engine, payloads, concurrency=4, deadline_ms=None, should_stop=None
):
    """Keep ``concurrency`` requests queued, submitting the next as
    completions free slots; returns the completed requests. ``deadline_ms``
    counts from the submit-time clock (no arrival schedule to backdate to)."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    done, i, n = [], 0, len(payloads)
    while i < n or engine.queue_depth:
        if should_stop is not None and should_stop():
            done.extend(engine.drain())
            break
        while i < n and engine.queue_depth < concurrency:
            engine.submit(payloads[i], deadline_ms=deadline_ms)
            i += 1
        done.extend(engine.step())
    return done
