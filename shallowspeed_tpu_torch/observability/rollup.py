"""Streaming rollups: tumbling-window online aggregation with a
mergeable, deterministic quantile sketch.

Copied from ``shallowspeed_tpu/observability/rollup.py`` (pure Python);
``tests/test_torch_observability.py`` holds the copy's output to the
JAX module's on the same inputs.

The report CLI computes percentiles AFTER a run finishes, from the full
raw record stream; nothing in the repo computed anything while a run was
alive. This module is the sensor half of the live-telemetry layer
(docs/observability.md § Live telemetry): bounded-memory aggregators
that fold a sample stream into TUMBLING windows (fixed width, aligned
to ``floor(t / window_s)``), close each window the moment a sample with
``t >= window_end`` arrives, and keep a bounded ring of closed windows.
Closing is driven purely by SAMPLE timestamps, never by wall clock —
the property that makes ``observability.watch --follow`` and ``--once``
produce bit-identical rollups over the same bytes, and makes replays
deterministic.

Per window, a :class:`RollupWindow` aggregates:

- counters   monotonic per-name sums (``completed``, ``errors``, ...);
- rates      each counter's per-window rate (count / window_s) plus an
             EWMA of that rate across windows (:class:`EwmaRate`) —
             the smoothed signal slow burn-rate rules read;
- gauges     last value wins within the window (``queue_depth``,
             ``loss``, ...), plus per-window min/max;
- sketches   a :class:`QuantileSketch` per observed metric
             (``latency_s``, ``step_s``, ...) — p50/p90/p99 per window.

THE SKETCH AND ITS ERROR BOUND. ``QuantileSketch`` is a log-bucketed
histogram (the DDSketch construction, arXiv 1908.10693): positive
values land in bucket ``ceil(log_gamma(x))`` with
``gamma = (1 + alpha) / (1 - alpha)``, so bucket ``i`` covers
``(gamma^(i-1), gamma^i]`` and the bucket representative
``2 * gamma^i / (gamma + 1)`` is within RELATIVE error ``alpha`` of
every value in the bucket. Consequence (the documented bound):
``percentile(q)`` returns a value within relative error ``alpha``
(default ``DEFAULT_ALPHA`` = 1%) of the empirical q-quantile SAMPLE.
The shared oracle ``stats.percentile`` linearly interpolates between
the two adjacent order statistics, so the tested bound against it is
``TEST_RELATIVE_BOUND`` = 2.5 x alpha — alpha for the bucket plus
slack for interpolation between adjacent samples (the tests pick
quantiles that do not sit exactly on a bimodal mass boundary, where
linear interpolation manufactures a value BETWEEN the modes that no
sketch — and no sample — can match). Buckets are exact integer counts
in a dict keyed by bucket index: merging two sketches is bucket-count
addition, which is associative and commutative, so
merge-of-shard-sketches == sketch-of-concatenated-samples EXACTLY on
every structural field (bucket counts, count, zero, min, max — and
therefore every percentile, tested), with only the float ``sum``
subject to addition-order rounding.

SHARD MERGING. Fleet replicas write ``.r{replica_id}`` shards and
multihost processes ``.p{process}`` shards, each rolling up in its own
clock domain. :func:`merge_rollup_records` re-aligns each shard's
window bounds onto the parent timeline using the fleet handshake's clock-offset
estimates (``tracing.clock_offsets`` — worker t + offset = parent t),
snaps to the nearest window boundary, and merges windows that land on
the same (source, window) cell: counters add, sketches merge, gauges
last-wins with a (window_end, replica_id) tie-break so the result is
independent of shard read order.
"""

import math

DEFAULT_ALPHA = 0.01  # sketch relative-error bound (module docstring)
# tested tolerance vs the linear-interpolating stats.percentile oracle:
# alpha for the bucket representative + slack for interpolation between
# adjacent order statistics
TEST_RELATIVE_BOUND = 2.5 * DEFAULT_ALPHA
DEFAULT_WINDOW_S = 1.0
DEFAULT_RING = 64  # closed windows kept per builder (bounded memory)
DEFAULT_QUANTILES = (50.0, 90.0, 99.0)


class QuantileSketch:
    """Mergeable log-bucketed quantile sketch with a relative-error
    guarantee of ``alpha`` vs the empirical quantile (module docstring).

    Non-positive values (a latency can be 0.0; a loss delta can be
    negative) are counted exactly: zeros in ``zero``, negatives in a
    mirrored bucket table — the guarantee is relative error ``alpha``
    on ``|x|`` for every sample.
    """

    __slots__ = (
        "alpha",
        "_gamma",
        "_log_gamma",
        "count",
        "sum",
        "min",
        "max",
        "zero",
        "buckets",
        "neg_buckets",
    )

    def __init__(self, alpha=DEFAULT_ALPHA):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha!r}")
        self.alpha = float(alpha)
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.zero = 0
        self.buckets = {}  # bucket index -> exact count (positive values)
        self.neg_buckets = {}  # same table for -x of negative values

    def _index(self, x):
        return int(math.ceil(math.log(x) / self._log_gamma - 1e-12))

    def _representative(self, idx):
        # midpoint of bucket (gamma^(i-1), gamma^i] in relative terms:
        # max relative error (gamma - 1) / (gamma + 1) == alpha exactly
        return 2.0 * self._gamma**idx / (self._gamma + 1.0)

    def add(self, x, count=1):
        x = float(x)
        if not math.isfinite(x):
            raise ValueError(f"QuantileSketch.add: non-finite sample {x!r}")
        if count <= 0:
            return
        self.count += count
        self.sum += x * count
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x
        if x == 0.0:
            self.zero += count
        elif x > 0.0:
            idx = self._index(x)
            self.buckets[idx] = self.buckets.get(idx, 0) + count
        else:
            idx = self._index(-x)
            self.neg_buckets[idx] = self.neg_buckets.get(idx, 0) + count

    def merge(self, other):
        """Fold ``other`` into this sketch in place. Bucket-count
        addition: exact, associative, commutative — the merge-of-shards
        == sketch-of-concatenation property the tests pin."""
        if not isinstance(other, QuantileSketch):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if other.alpha != self.alpha:
            raise ValueError(
                f"cannot merge sketches with different alpha "
                f"({self.alpha} vs {other.alpha})"
            )
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        self.zero += other.zero
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c
        for idx, c in other.neg_buckets.items():
            self.neg_buckets[idx] = self.neg_buckets.get(idx, 0) + c
        return self

    def percentile(self, q):
        """The q-th percentile (0..100): a value within relative error
        ``alpha`` of the empirical q-quantile sample; ``None`` when
        empty. Clamped into the exact observed [min, max], so a
        constant stream reads back exactly."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
        # rank of the target order statistic under the shared
        # stats.percentile definition's index scale
        target = (q / 100.0) * (self.count - 1)
        rank = int(math.floor(target + 0.5))  # nearest sample's rank
        cum = 0
        value = None
        # ascending value order: negatives (most negative first = largest
        # |x| bucket first), then zeros, then positives ascending
        for idx in sorted(self.neg_buckets, reverse=True):
            cum += self.neg_buckets[idx]
            if cum > rank:
                value = -self._representative(idx)
                break
        if value is None and self.zero:
            cum += self.zero
            if cum > rank:
                value = 0.0
        if value is None:
            for idx in sorted(self.buckets):
                cum += self.buckets[idx]
                if cum > rank:
                    value = self._representative(idx)
                    break
        if value is None:  # numerically impossible, but never under-report
            value = self.max
        if self.min is not None:
            value = max(value, self.min)
        if self.max is not None:
            value = min(value, self.max)
        return float(value)

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def summary(self, quantiles=DEFAULT_QUANTILES):
        """JSON-able per-window quantile summary (the ``quantiles``
        block of a rollup record)."""
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
        }
        for q in quantiles:
            out[f"p{q:g}"] = self.percentile(q)
        return out

    def to_dict(self):
        """Full JSON-able state — what rollup records carry so a reader
        can re-merge shard sketches EXACTLY (JSON object keys must be
        strings, so bucket indices are stringified)."""
        return {
            "alpha": self.alpha,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "zero": self.zero,
            "buckets": {str(i): c for i, c in sorted(self.buckets.items())},
            "neg_buckets": {
                str(i): c for i, c in sorted(self.neg_buckets.items())
            },
        }

    @classmethod
    def from_dict(cls, d):
        sk = cls(alpha=d.get("alpha", DEFAULT_ALPHA))
        sk.count = int(d.get("count", 0))
        sk.sum = float(d.get("sum", 0.0))
        sk.min = d.get("min")
        sk.max = d.get("max")
        sk.zero = int(d.get("zero", 0))
        sk.buckets = {int(i): int(c) for i, c in (d.get("buckets") or {}).items()}
        sk.neg_buckets = {
            int(i): int(c) for i, c in (d.get("neg_buckets") or {}).items()
        }
        return sk


class EwmaRate:
    """EWMA of a per-window rate, decayed by window width: after each
    closed window, ``ewma += (1 - exp(-window_s / tau)) * (rate - ewma)``
    — a time-constant smoother independent of window width choice."""

    __slots__ = ("tau_s", "value")

    def __init__(self, tau_s=30.0):
        self.tau_s = float(tau_s)
        self.value = None

    def update(self, rate, window_s):
        if self.value is None:
            self.value = float(rate)
        else:
            k = 1.0 - math.exp(-float(window_s) / self.tau_s)
            self.value += k * (float(rate) - self.value)
        return self.value


class RollupWindow:
    """One live tumbling window: counters + gauges + per-metric sketches."""

    __slots__ = ("start", "end", "counters", "gauges", "sketches", "late")

    def __init__(self, start, end):
        self.start = start
        self.end = end
        self.counters = {}
        self.gauges = {}  # name -> (last_t, last_value, min, max)
        self.sketches = {}
        self.late = 0

    def count(self, name, inc=1.0):
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, t, name, value):
        prev = self.gauges.get(name)
        if prev is None:
            self.gauges[name] = [t, value, value, value]
            return
        if t >= prev[0]:
            prev[0], prev[1] = t, value
        prev[2] = min(prev[2], value)
        prev[3] = max(prev[3], value)

    def observe(self, name, value, alpha=DEFAULT_ALPHA):
        sk = self.sketches.get(name)
        if sk is None:
            sk = self.sketches[name] = QuantileSketch(alpha=alpha)
        sk.add(value)


class RollupBuilder:
    """The streaming aggregator one telemetry source owns.

    Feed methods take the SAMPLE timestamp ``t`` explicitly (record
    ``ts``, a completion clock — never "now"): a sample with
    ``t >= window_end`` first closes the current window (pushing its
    summary onto the bounded ``closed`` ring and emitting a ``rollup``
    record through ``metrics`` when attached), then opens the sample's
    own window. Samples OLDER than the current window (out-of-order
    arrivals across shard interleave) fold into the CURRENT window and
    bump its ``late`` counter — deterministic in stream order, and the
    lateness is visible rather than silently re-writing closed history.
    """

    def __init__(
        self,
        source,
        window_s=DEFAULT_WINDOW_S,
        ring=DEFAULT_RING,
        metrics=None,
        replica_id=None,
        alpha=DEFAULT_ALPHA,
        ewma_tau_s=30.0,
        quantiles=DEFAULT_QUANTILES,
        on_close=None,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s!r}")
        self.source = source
        self.window_s = float(window_s)
        self.metrics = metrics
        self.replica_id = replica_id
        self.alpha = float(alpha)
        self.quantiles = tuple(quantiles)
        self.on_close = on_close  # callback(summary) — the SLO evaluator taps here
        self._ewma = {}  # counter name -> EwmaRate
        self._ewma_tau_s = float(ewma_tau_s)
        self._window = None
        self._seq = 0
        self._ring = int(ring)
        self.closed = []  # bounded ring of closed-window summaries

    # -- feeding ------------------------------------------------------------

    def _roll(self, t):
        w = self._window
        if w is None:
            start = math.floor(t / self.window_s) * self.window_s
            self._window = RollupWindow(start, start + self.window_s)
            return self._window
        if t >= w.end:
            self._close(w)
            start = math.floor(t / self.window_s) * self.window_s
            self._window = RollupWindow(start, start + self.window_s)
            return self._window
        if t < w.start:
            w.late += 1
        return w

    def count(self, t, name, inc=1.0):
        self._roll(t).count(name, inc)

    def gauge(self, t, name, value):
        self._roll(t).gauge(t, name, value)

    def observe(self, t, name, value):
        self._roll(t).observe(name, value, alpha=self.alpha)

    def flush(self):
        """Close the live window now (run end / summary time); no-op when
        nothing was fed since the last close."""
        if self._window is not None:
            self._close(self._window)
            self._window = None

    # -- closing ------------------------------------------------------------

    def _close(self, w):
        summary = self._summarize(w)
        self.closed.append(summary)
        if len(self.closed) > self._ring:
            del self.closed[: len(self.closed) - self._ring]
        self._seq += 1
        if self.metrics is not None:
            self.metrics.rollup(self.source, **summary)
        if self.on_close is not None:
            self.on_close(summary)
        return summary

    def _summarize(self, w):
        rates = {}
        for name, total in w.counters.items():
            rate = total / self.window_s
            ewma = self._ewma.get(name)
            if ewma is None:
                ewma = self._ewma[name] = EwmaRate(tau_s=self._ewma_tau_s)
            rates[name] = {"rate": rate, "ewma": ewma.update(rate, self.window_s)}
        return {
            "window_start": w.start,
            "window_end": w.end,
            "window_s": self.window_s,
            "seq": self._seq,
            "counters": dict(w.counters),
            "rates": rates,
            "gauges": {
                name: {"last": g[1], "min": g[2], "max": g[3]}
                for name, g in w.gauges.items()
            },
            "quantiles": {
                name: sk.summary(self.quantiles)
                for name, sk in w.sketches.items()
            },
            "sketches": {
                name: sk.to_dict() for name, sk in w.sketches.items()
            },
            "late": w.late,
            "replica_id": self.replica_id,
        }

    # -- live snapshot ------------------------------------------------------

    def snapshot(self):
        """The status() surface: the last CLOSED window summary plus the
        live (still-open) window's partial aggregates."""
        live = None
        if self._window is not None:
            live = self._summarize(self._window)
        return {
            "source": self.source,
            "window_s": self.window_s,
            "windows_closed": self._seq,
            "last_window": self.closed[-1] if self.closed else None,
            "live_window": live,
        }


# -- shard merging ----------------------------------------------------------


def merge_rollup_records(records, offsets=None):
    """Merge ``rollup`` records across ``.r*``/``.p*`` shards onto one
    timeline (module docstring).

    ``offsets`` maps ``replica_id`` to the fleet handshake's clock-offset estimate
    (either the bare ``offset_s`` float or the full
    ``tracing.clock_offsets`` dict per replica); a shard's window bounds
    are shifted by its offset, snapped to the nearest window boundary,
    and windows landing on the same (source, window_start) cell merge:
    counters/rates add, sketches merge exactly, gauges last-wins with a
    (window_end, replica_id) tie-break — independent of shard order.

    Returns the merged summaries sorted by (source, window_start).
    """
    offsets = offsets or {}
    cells = {}
    for rec in records:
        if rec.get("kind") != "rollup":
            continue
        rid = rec.get("replica_id")
        off = offsets.get(rid, 0.0)
        if isinstance(off, dict):
            off = off.get("offset_s", 0.0) or 0.0
        window_s = rec.get("window_s") or DEFAULT_WINDOW_S
        start = (rec.get("window_start") or 0.0) + off
        aligned = round(start / window_s) * window_s
        key = (rec.get("name"), aligned)
        cell = cells.get(key)
        if cell is None:
            cell = cells[key] = {
                "source": rec.get("name"),
                "window_start": aligned,
                "window_end": aligned + window_s,
                "window_s": window_s,
                "counters": {},
                "gauges": {},
                "sketches": {},
                "late": 0,
                "shards": 0,
                "replica_ids": [],
                "_gauge_order": {},
            }
        cell["shards"] += 1
        if rid not in cell["replica_ids"]:
            cell["replica_ids"].append(rid)
        cell["late"] += rec.get("late") or 0
        for name, total in (rec.get("counters") or {}).items():
            cell["counters"][name] = cell["counters"].get(name, 0.0) + total
        # gauge last-wins across shards, ordered by the shard's aligned
        # window_end then replica_id — NOT by shard read order
        order_key = (
            (rec.get("window_end") or 0.0) + off,
            -1 if rid is None else rid,
        )
        for name, g in (rec.get("gauges") or {}).items():
            prev_key = cell["_gauge_order"].get(name)
            prev = cell["gauges"].get(name)
            if prev is None or prev_key is None or order_key >= prev_key:
                merged = dict(g)
                if prev is not None:
                    merged["min"] = min(prev["min"], g["min"])
                    merged["max"] = max(prev["max"], g["max"])
                cell["gauges"][name] = merged
                cell["_gauge_order"][name] = order_key
            else:
                prev["min"] = min(prev["min"], g["min"])
                prev["max"] = max(prev["max"], g["max"])
        for name, sk_dict in (rec.get("sketches") or {}).items():
            sk = QuantileSketch.from_dict(sk_dict)
            have = cell["sketches"].get(name)
            if have is None:
                cell["sketches"][name] = sk
            else:
                have.merge(sk)
    out = []
    for key in sorted(cells, key=lambda k: (str(k[0]), k[1])):
        cell = cells[key]
        cell.pop("_gauge_order")
        cell["replica_ids"].sort(key=lambda r: -1 if r is None else r)
        window_s = cell["window_s"]
        cell["rates"] = {
            name: {"rate": total / window_s}
            for name, total in cell["counters"].items()
        }
        cell["quantiles"] = {
            name: sk.summary() for name, sk in cell["sketches"].items()
        }
        cell["sketches"] = {
            name: sk.to_dict() for name, sk in cell["sketches"].items()
        }
        out.append(cell)
    return out
