"""Seeded diurnal traffic replay: the workload half of the capacity
scoreboard.

Copied from ``shallowspeed_tpu/serving/replay.py`` (pure numpy): one
``RandomState(seed)`` draws the spikes and the thinned arrivals, so a trace
is bitwise the JAX package's for the same seed and shape
(``tests/test_torch_replay.py``).

A capacity decision can only be judged against a workload that can be
REPLAYED — the same arrival schedule, byte for byte, offered to a static
fleet, an autoscaled fleet, and the offline oracle. This module builds
that schedule: an inhomogeneous Poisson process whose rate follows a
compressed diurnal curve (a day's sinusoid squeezed into minutes of wall
time) with seeded flash-crowd spikes layered on top, realized by
Lewis-Shedler thinning so the arrivals are EXACTLY Poisson in the
modulated rate, not a per-bucket approximation.

Determinism contract (pinned by ``tests/test_torch_replay.py``): the entire
trace — spike placement and the thinned arrival times — is drawn from
one ``np.random.RandomState(seed)``, so the same ``(seed, shape
parameters)`` produce a byte-identical ``arrivals`` array and rate
trace on every machine. The trace is driven through
``loadgen.run_open_loop``'s coordinated-omission-corrected backdating,
so a fleet that falls behind burns queued deadlines honestly instead of
silently throttling the offered load.

The RATE TRACE is the oracle's evidence: per-bucket analytic rate (the
modulation the arrivals were thinned against) plus the realized arrival
count. ``bench_replay`` computes the offline-oracle replica schedule
from this trace and the measured knee — the autoscaler never sees it.
"""

import math

import numpy as np

TRACE_VERSION = 1

# the real-world day the compressed trace stands for — recorded in the
# trace config so the scoreboard's "violation minutes" can be read in
# either clock (compressed wall seconds x compression = modeled seconds)
REAL_DAY_S = 86400.0


def diurnal_rate(t, day_s, base_rps, peak_rps, spikes=()):
    """The analytic modulation ``r(t)`` in requests/second: a raised
    cosine through one day (trough at ``t=0``, peak at ``t=day_s/2``)
    with each flash-crowd spike multiplying the rate over its
    ``[start, start+duration)`` window. ``spikes``: dicts with
    ``start``/``duration``/``mult``."""
    r = base_rps + (peak_rps - base_rps) * 0.5 * (
        1.0 - math.cos(2.0 * math.pi * t / day_s)
    )
    for sp in spikes:
        if sp["start"] <= t < sp["start"] + sp["duration"]:
            r *= sp["mult"]
    return r


def diurnal_trace(
    day_s=120.0,
    base_rps=20.0,
    peak_rps=120.0,
    seed=0,
    n_spikes=1,
    spike_mult=3.0,
    spike_duration_s=None,
    bucket_s=5.0,
):
    """Build one seeded replayable trace; returns a JSON-able dict:

    - ``arrivals``: ascending arrival times in ``[0, day_s)`` (numpy
      float64 — the schedule ``run_open_loop`` replays),
    - ``buckets``: the rate trace — per ``bucket_s`` window, the
      analytic mean rate (integrated, not point-sampled, so spikes
      shorter than a bucket still register) and the realized arrival
      count/rate,
    - ``config``: every shape parameter plus ``rate_max`` (the thinning
      bound) and ``compression`` (modeled day / compressed day).

    Spikes are placed in the busy half of the day (``[0.25, 0.75] x
    day_s``) so a flash crowd lands on top of real load — the case an
    autoscaler must survive — with duration defaulting to one tenth of
    the day. Thinning draws (exponential gaps at ``rate_max``, one
    uniform per candidate) come from the same ``RandomState`` as the
    spike placement: one seed, one byte stream, one trace."""
    if day_s <= 0:
        raise ValueError("day_s must be positive")
    if base_rps <= 0 or peak_rps < base_rps:
        raise ValueError("need 0 < base_rps <= peak_rps")
    if bucket_s <= 0:
        raise ValueError("bucket_s must be positive")
    rng = np.random.RandomState(seed)
    if spike_duration_s is None:
        spike_duration_s = day_s / 10.0
    spikes = []
    for _ in range(int(n_spikes)):
        start = float(
            rng.uniform(0.25 * day_s, 0.75 * day_s - spike_duration_s)
        )
        spikes.append(
            {
                "start": start,
                "duration": float(spike_duration_s),
                "mult": float(spike_mult),
            }
        )
    spikes.sort(key=lambda sp: sp["start"])
    # Lewis-Shedler thinning against a guaranteed envelope: the cosine
    # never exceeds peak_rps and spikes only multiply, so peak x the
    # largest mult dominates r(t) everywhere
    rate_max = peak_rps * max([sp["mult"] for sp in spikes] or [1.0])
    arrivals = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= day_s:
            break
        if rng.uniform() * rate_max <= diurnal_rate(
            t, day_s, base_rps, peak_rps, spikes
        ):
            arrivals.append(t)
    arrivals = np.asarray(arrivals, np.float64)
    n_buckets = int(math.ceil(day_s / bucket_s))
    counts, _edges = np.histogram(
        arrivals, bins=n_buckets, range=(0.0, n_buckets * bucket_s)
    )
    buckets = []
    for b in range(n_buckets):
        t0, t1 = b * bucket_s, min((b + 1) * bucket_s, day_s)
        # integrate the analytic rate over the bucket on a fine grid
        # (closed form exists for the cosine but not across spike edges)
        grid = np.linspace(t0, t1, 33)
        mean_rate = float(
            np.mean(
                [diurnal_rate(g, day_s, base_rps, peak_rps, spikes) for g in grid]
            )
        )
        width = t1 - t0
        buckets.append(
            {
                "t0": t0,
                "t1": t1,
                "rate_rps": mean_rate,
                "arrivals": int(counts[b]),
                "offered_rps": (int(counts[b]) / width) if width > 0 else 0.0,
            }
        )
    return {
        "version": TRACE_VERSION,
        "arrivals": arrivals,
        "buckets": buckets,
        "config": {
            "day_s": float(day_s),
            "base_rps": float(base_rps),
            "peak_rps": float(peak_rps),
            "seed": int(seed),
            "spikes": spikes,
            "bucket_s": float(bucket_s),
            "rate_max": float(rate_max),
            "n_arrivals": int(arrivals.shape[0]),
            "compression": REAL_DAY_S / float(day_s),
        },
    }
