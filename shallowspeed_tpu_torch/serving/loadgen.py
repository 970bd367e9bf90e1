"""Load generation for the serving engine: seeded arrivals + drive modes.

The counterpart of ``shallowspeed_tpu/serving/loadgen.py`` (the same
streams for the same seeds). Everything is seeded: two runs with one seed
offer the identical request stream (sizes, contents, arrival times), which
lets ``--verify`` assert bitwise response parity under load, the bench
sweep compare rates on one workload, and the port and the JAX package be
fed the same stream.

Two drive modes (the classic load-testing pair):

- **open loop** (``run_open_loop``): requests arrive on a Poisson schedule
  REGARDLESS of completions, so queueing delay shows up as latency instead
  of silently throttling the offered load. Enqueue timestamps are
  backdated to the scheduled arrival (the coordinated-omission
  correction);
- **closed loop** (``run_closed_loop``): a fixed population of
  ``concurrency`` outstanding requests, each completion replaced at once.

Both drive loops are the operator loop: an injected ``die@dispatch=N``
(mode=exc) is absorbed and the loop re-enters with the queue intact. Both
read ``engine.clock``, so every timestamp lives in one clock domain.
"""

import os
import time

import numpy as np

from shallowspeed_tpu_torch.faults import InjectedFault


def _step_reentrant(engine):
    """One engine.step() under the operator-loop contract: an injected
    dispatch-loop death (``die@dispatch=N``, mode=exc) fires BEFORE any
    request is popped, so the queue is intact — the drive loops catch it and
    simply re-enter on the next iteration, which is the re-entry the
    fault models (``mode=sigkill`` still kills the process honestly).
    Real dispatch exceptions are the ENGINE's to recover (re-queue +
    retry budget) and never reach here."""
    try:
        return engine.step()
    except InjectedFault:
        return []


def payload_in_dim(data_dir, default=784):
    """The request payload width for a caller without a session of its
    own (the JAX package's fleet parent): the data layer's training-split
    width when ``data_dir`` holds one, else ``default`` (the flagship MLP's
    MNIST input)."""
    if data_dir:
        x_path = os.path.join(os.fspath(data_dir), "x_train.npy")
        if os.path.exists(x_path):
            return int(np.load(x_path, mmap_mode="r").shape[1])
    return int(default)


def poisson_arrivals(rate_rps, n, seed=0):
    """``n`` seeded Poisson arrival times (seconds from start): cumulative
    exponential interarrivals at ``rate_rps`` requests/second."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if n < 1:
        raise ValueError("n must be >= 1")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def request_payloads(n, in_dim, seed=0, rows_choices=(1, 2, 3, 4, 8), data=None):
    """``n`` seeded variable-size request payloads, each ``(rows, in_dim)``
    float32 with ``rows`` drawn from ``rows_choices``. ``data``: an
    optional ``(N, in_dim)`` pool (e.g. the validation split) to sample
    real rows from; default is standard-normal synthetic inputs."""
    rng = np.random.RandomState(seed)
    sizes = rng.choice(list(rows_choices), size=n)
    payloads = []
    for rows in sizes:
        if data is not None:
            idx = rng.randint(0, data.shape[0], size=int(rows))
            payloads.append(np.asarray(data[idx], np.float32))
        else:
            payloads.append(rng.randn(int(rows), in_dim).astype(np.float32))
    return payloads


def run_open_loop(
    engine, payloads, arrivals, deadline_ms=None, sleep=time.sleep,
    should_stop=None, on_tick=None, tick_s=0.05,
):
    """Replay ``payloads`` against the engine on the ``arrivals`` schedule
    (seconds from start, one per payload); returns the completed requests.

    Single-threaded approximation of an open-loop client: all due arrivals
    are submitted (backdated to their scheduled time), then one batching
    step serves the queue's head; the host sleeps only when idle. The
    engine drains fully before returning.

    Deadline semantics: ``deadline_ms`` counts from the SCHEDULED arrival
    (the backdated ``arrival_t``), so a request that sat unsubmitted while
    the host was busy has already burned queue time against its deadline —
    the coordinated-omission-corrected reading (contrast the closed-loop
    drive below).

    ``should_stop``: an optional zero-arg callable polled each iteration —
    the graceful-drain hook (serving ``__main__``'s SIGTERM/SIGINT
    handler): once it returns True, ADMISSION stops (remaining payloads
    are never submitted) but everything already queued is drained to a
    terminal verdict before returning.

    ``on_tick``: an optional ``on_tick(elapsed_s)`` callable invoked once
    per loop iteration with seconds since the drive started — a poll hook
    (the JAX package's autoscaler makes its decisions there), on the drive
    loop's thread, so it never races the submit/step loop. When set, idle
    sleeps are capped at ``tick_s`` so the hook keeps observing through
    quiet troughs instead of sleeping until the next arrival."""
    if len(payloads) != len(arrivals):
        raise ValueError("one arrival time per payload")
    t0 = engine.clock()
    done, i, n = [], 0, len(payloads)
    while i < n or engine.queue_depth:
        if should_stop is not None and should_stop():
            while engine.queue_depth:
                done.extend(_step_reentrant(engine))
            break
        if on_tick is not None:
            on_tick(engine.clock() - t0)
        now = engine.clock() - t0
        while i < n and arrivals[i] <= now:
            engine.submit(
                payloads[i], deadline_ms=deadline_ms, arrival_t=t0 + arrivals[i]
            )
            i += 1
        if engine.queue_depth:
            done.extend(_step_reentrant(engine))
        elif i < n:
            idle = max(0.0, arrivals[i] - (engine.clock() - t0))
            sleep(min(idle, tick_s) if on_tick is not None else idle)
    return done


def run_closed_loop(
    engine, payloads, concurrency=4, deadline_ms=None, should_stop=None
):
    """Drive a fixed in-flight population: keep ``concurrency`` requests
    queued, submitting the next as completions free slots; returns the
    completed requests. ``should_stop`` is the same graceful-drain hook as
    ``run_open_loop``'s.

    Deadline semantics — deliberately DIFFERENT from the open loop: a
    closed-loop drive never backdates arrivals (there is no arrival
    schedule — the population model admits a request the moment a slot
    frees), so ``deadline_ms`` counts from the SUBMIT-time clock and
    ``met_deadline``/``slo_ok`` score pure service latency with no queue
    backlog charged; use the open loop when coordinated-omission-corrected
    tails are the question."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    done, i, n = [], 0, len(payloads)
    while i < n or engine.queue_depth:
        if should_stop is not None and should_stop():
            while engine.queue_depth:
                done.extend(_step_reentrant(engine))
            break
        while i < n and engine.queue_depth < concurrency:
            engine.submit(payloads[i], deadline_ms=deadline_ms)
            i += 1
        done.extend(_step_reentrant(engine))
    return done
