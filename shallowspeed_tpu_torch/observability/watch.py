"""Live telemetry watcher: a refreshing terminal dashboard over JSONL
metrics shards.

Copied from ``shallowspeed_tpu/observability/watch.py`` (pure Python);
``tests/test_torch_observability.py`` holds the copy's output to the
JAX module's on the same inputs.

    # tail a LIVE run (new shards are picked up as they appear)
    python -m shallowspeed_tpu_torch.observability.watch run.jsonl --follow \
        [--interval 0.5] [--idle-exit 5] [--max-wall 300]

    # one shot over a FINISHED run (CI / post-mortem)
    python -m shallowspeed_tpu_torch.observability.watch run.jsonl --once \
        [--format text|json]

Path resolution is the ONE shard-glob path ``read_jsonl`` uses
(``metrics._expand_shards``): an existing file is read as-is, an
explicit glob expands sorted, and a bare missing path falls back to its
``.p[0-9]*`` / ``.r[0-9]*`` shards — so a live fleet run's per-replica
shards and a finished single file resolve IDENTICALLY in both readers
(pass ``fleet.jsonl*`` to merge a fleet parent with its ``.r*``
shards, exactly as ``read_jsonl`` would).

Determinism contract: every aggregate the watcher shows is a pure
function of the record BYTES read so far — windows close on record
``ts`` (rollup.py), never on wall clock, and the final ``--follow``
snapshot over a finished file equals the ``--once`` snapshot over the
same file bit-for-bit (``make alerts-smoke`` gates on this). Wall
clock only decides WHEN to poll and when to give up (``--idle-exit``:
exit once no shard grows for that many seconds; ``--max-wall``: hard
cap — both are how CI runs a watcher against a live run and still
terminates).

Compatibility: records with a schema version NEWER than this reader
are counted (``skipped_newer``) and skipped, not misread — the live
dashboard stays up through a rolling upgrade, while the strict
``read_jsonl`` contract (refuse loudly) still guards programmatic
consumers. Incomplete trailing lines (a writer mid-append) are left in
the tail buffer until their newline arrives; complete-but-malformed
lines are counted as ``malformed`` and fail ``--once`` loudly.
"""

import argparse
import json
import os
import sys
import time
from collections import deque

from shallowspeed_tpu_torch.observability.metrics import (
    SCHEMA_VERSION,
    _expand_shards,
)
from shallowspeed_tpu_torch.observability.rollup import RollupBuilder

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values, width=32):
    """Tiny local sparkline (non-finite-free inputs): last ``width``
    values scaled to the observed range."""
    vals = [v for v in values if v is not None][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))] for v in vals
    )


def _fmt(v, unit=""):
    if v is None:
        return "n/a"
    if isinstance(v, float):
        if abs(v) >= 100:
            return f"{v:.0f}{unit}"
        if abs(v) >= 1:
            return f"{v:.2f}{unit}"
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


class _Tailer:
    """Incremental reader of one shard: consumes complete lines only,
    keeps the partial tail until its newline lands."""

    __slots__ = ("path", "offset", "buf")

    def __init__(self, path):
        self.path = path
        self.offset = 0
        self.buf = ""

    def poll(self):
        """Yield newly-completed lines since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self.offset:
            return []
        with open(self.path, encoding="utf-8") as f:
            f.seek(self.offset)
            chunk = f.read(size - self.offset)
            self.offset = f.tell()
        data = self.buf + chunk
        lines = data.split("\n")
        self.buf = lines.pop()  # "" when chunk ended on a newline
        return [ln for ln in lines if ln.strip()]


class WatchState:
    """The fold: record stream in, deterministic snapshot out."""

    def __init__(self, window_s=1.0, history=240):
        self.records = 0
        self.skipped_newer = 0
        self.malformed = 0
        self.rollups = {}  # display key -> latest emitted rollup record
        self.trends = {}  # display key -> deque of terminal/steps rate
        self.alerts = []  # alert transitions in stream order
        self.active = {}  # (rule, replica_id) -> latest firing record
        self.events = deque(maxlen=12)  # recent health events
        self.summaries = {}  # latest `serving`/`fleet` summary per name
        # the capacity loop (schema v13): live fleet size + the most
        # recent autoscale decision — folded from `autoscale` records
        # and the fleet_health scale_up/scale_down target field, so the
        # dashboard shows the loop acting whether or not a policy runs
        self.fleet_replicas = None
        self.autoscale_count = 0
        self.last_autoscale = None
        self.history = history
        # the watcher's OWN rollups recomputed from raw records — the
        # surface for runs that predate v11 emitters, and the
        # determinism gate's comparison object
        self.computed = {
            "serving": RollupBuilder("serving", window_s=window_s),
            "train": RollupBuilder("train", window_s=window_s),
        }

    def ingest_line(self, line):
        try:
            rec = json.loads(line)
        except ValueError:
            self.malformed += 1
            return
        if not isinstance(rec, dict):
            self.malformed += 1
            return
        if rec.get("v", 0) > SCHEMA_VERSION:
            self.skipped_newer += 1
            return
        self.records += 1
        kind = rec.get("kind")
        ts = rec.get("ts")
        if kind == "rollup":
            rid = rec.get("replica_id")
            key = rec.get("name") or "?"
            if rid is not None:
                key = f"{key}.r{rid}"
            self.rollups[key] = rec
            rate = None
            for counter in ("terminal", "steps"):
                r = (rec.get("rates") or {}).get(counter)
                if r is not None:
                    rate = r.get("rate")
                    break
            trend = self.trends.get(key)
            if trend is None:
                trend = self.trends[key] = deque(maxlen=self.history)
            trend.append(rate)
        elif kind == "alert":
            self.alerts.append(rec)
            akey = (rec.get("name"), rec.get("replica_id"))
            if rec.get("state") == "firing":
                self.active[akey] = rec
            else:
                self.active.pop(akey, None)
        elif kind == "request" and ts is not None:
            c = self.computed["serving"]
            c.count(ts, rec.get("name") or "?")
            c.count(ts, "terminal")
            if rec.get("latency_s") is not None:
                c.observe(ts, "latency_s", rec["latency_s"])
            if rec.get("queue_s") is not None:
                c.observe(ts, "queue_s", rec["queue_s"])
        elif kind == "step" and ts is not None:
            c = self.computed["train"]
            c.count(ts, "steps")
            if rec.get("loss") is not None:
                c.gauge(ts, "loss", rec["loss"])
        elif kind == "autoscale":
            self.autoscale_count += 1
            self.last_autoscale = rec
            if rec.get("replicas_after") is not None:
                self.fleet_replicas = rec["replicas_after"]
        elif kind in ("serving_health", "fleet_health", "health"):
            self.events.append(rec)
            if (
                kind == "fleet_health"
                and rec.get("name") in ("scale_up", "scale_down")
                and rec.get("target") is not None
            ):
                self.fleet_replicas = rec["target"]
        elif kind in ("serving", "fleet"):
            self.summaries[f"{kind}:{rec.get('name')}"] = rec

    def snapshot(self):
        """JSON-able state — a pure function of the bytes ingested (the
        --follow == --once determinism object)."""
        return {
            "records": self.records,
            "skipped_newer": self.skipped_newer,
            "malformed": self.malformed,
            "rollups": {
                k: {f: v for f, v in rec.items() if f != "sketches"}
                for k, rec in sorted(self.rollups.items())
            },
            "computed": {
                name: b.snapshot() for name, b in self.computed.items()
            },
            "alerts": {
                "transitions": list(self.alerts),
                "active": sorted(
                    r.get("name") or "?" for r in self.active.values()
                ),
                "fired": sum(
                    1 for a in self.alerts if a.get("state") == "firing"
                ),
                "resolved": sum(
                    1 for a in self.alerts if a.get("state") == "resolved"
                ),
            },
            "summaries": dict(sorted(self.summaries.items())),
            "fleet": {
                "replicas": self.fleet_replicas,
                "autoscale_decisions": self.autoscale_count,
                "last_autoscale": self.last_autoscale,
            },
        }

    # -- text rendering -----------------------------------------------------

    def render_text(self, path, shards):
        lines = [
            f"watch {path} — {len(shards)} shard(s), {self.records} "
            f"record(s)"
            + (
                f", {self.skipped_newer} newer-schema skipped"
                if self.skipped_newer
                else ""
            )
            + (f", {self.malformed} MALFORMED" if self.malformed else "")
        ]
        if self.active:
            firing = ", ".join(
                f"{rec.get('name')}[{rec.get('severity')}]"
                for rec in self.active.values()
            )
            lines.append(f"ALERTS FIRING: {firing}")
        else:
            lines.append("alerts: none firing")
        if self.fleet_replicas is not None or self.last_autoscale:
            parts = [f"fleet: {_fmt(self.fleet_replicas)} replica(s)"]
            la = self.last_autoscale
            if la:
                parts.append(
                    f"last autoscale [{_fmt(la.get('t'))}] "
                    f"{la.get('name')} ({la.get('direction')}, rule "
                    f"{la.get('rule')}, {_fmt(la.get('replicas_before'))}"
                    f"→{_fmt(la.get('replicas_after'))})"
                )
            lines.append(" | ".join(parts))
        for a in self.alerts[-6:]:
            t = a.get("t")
            lines.append(
                f"  [{_fmt(t)}] {a.get('name')} {a.get('state', '?').upper()}"
                f" — {a.get('reason', '')}"
            )
        for key, rec in sorted(self.rollups.items()):
            counters = rec.get("counters") or {}
            rates = rec.get("rates") or {}
            gauges = rec.get("gauges") or {}
            quant = rec.get("quantiles") or {}
            parts = [
                f"{key:<12} win#{rec.get('seq')} "
                f"[{_fmt(rec.get('window_start'))},"
                f"{_fmt(rec.get('window_end'))})"
            ]
            for counter in ("terminal", "steps"):
                if counter in rates:
                    parts.append(
                        f"{_fmt(counters.get(counter))} {counter} "
                        f"({_fmt(rates[counter].get('rate'))}/s, "
                        f"ewma {_fmt(rates[counter].get('ewma'))}/s)"
                    )
            lat = quant.get("latency_s") or quant.get("step_s")
            if lat:
                parts.append(
                    f"p50 {_fmt(lat.get('p50'))}s p99 {_fmt(lat.get('p99'))}s"
                )
            for gname in ("queue_depth", "loss", "throughput", "mfu"):
                g = gauges.get(gname)
                if g:
                    parts.append(f"{gname} {_fmt(g.get('last'))}")
            lines.append(" | ".join(parts))
            spark = _sparkline(self.trends.get(key, ()))
            if spark:
                lines.append(f"{'':<12} rate {spark}")
        for name, builder in sorted(self.computed.items()):
            snap = builder.snapshot()
            last = snap["last_window"] or snap["live_window"]
            if not last:
                continue
            counters = last.get("counters") or {}
            quant = last.get("quantiles") or {}
            parts = [f"computed:{name:<4} windows {snap['windows_closed']}"]
            if counters:
                top = sorted(counters.items())[:4]
                parts.append(
                    " ".join(f"{k}={_fmt(v)}" for k, v in top)
                )
            lat = quant.get("latency_s")
            if lat:
                parts.append(
                    f"p50 {_fmt(lat.get('p50'))}s p99 {_fmt(lat.get('p99'))}s"
                )
            lines.append(" | ".join(parts))
        for ev in list(self.events)[-4:]:
            lines.append(
                f"  health [{_fmt(ev.get('ts'))}] {ev.get('kind')}:"
                f"{ev.get('name')}"
            )
        return "\n".join(lines)


def _resolve(path):
    """The shared resolution, softened for a not-yet-written live run:
    an unmatched glob means "no shards yet", not an error."""
    try:
        return [s for s in _expand_shards(path) if os.path.exists(s)]
    except FileNotFoundError:
        return []


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.observability.watch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("path", help="metrics JSONL path, glob, or shard base")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument(
        "--follow", action="store_true", help="tail live shards (default)"
    )
    mode.add_argument(
        "--once", action="store_true", help="read everything once and exit"
    )
    ap.add_argument("--format", choices=["text", "json"], default="text")
    ap.add_argument(
        "--interval", type=float, default=0.5, help="poll period (seconds)"
    )
    ap.add_argument(
        "--window",
        type=float,
        default=1.0,
        help="tumbling-window width for the watcher's own computed rollups",
    )
    ap.add_argument(
        "--idle-exit",
        type=float,
        default=None,
        metavar="S",
        help="--follow: exit 0 once no shard has grown for S seconds "
        "(after at least one record)",
    )
    ap.add_argument(
        "--max-wall",
        type=float,
        default=None,
        metavar="S",
        help="--follow: hard wall-clock cap",
    )
    args = ap.parse_args(argv)
    follow = not args.once

    state = WatchState(window_s=args.window)
    tailers = {}
    start = time.monotonic()
    last_growth = start
    clear = follow and args.format == "text" and sys.stdout.isatty()
    rendered = False

    while True:
        shards = _resolve(args.path)
        grew = False
        for shard in shards:
            tailer = tailers.get(shard)
            if tailer is None:
                tailer = tailers[shard] = _Tailer(shard)
            for line in tailer.poll():
                state.ingest_line(line)
                grew = True
        now = time.monotonic()
        if grew:
            last_growth = now
        if args.format == "text" and (grew or not rendered):
            frame = state.render_text(args.path, shards)
            if clear:
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            else:
                print(frame)
                print("---")
            sys.stdout.flush()
            rendered = True
        if not follow:
            break
        if (
            args.idle_exit is not None
            and state.records > 0
            and now - last_growth >= args.idle_exit
        ):
            break
        if args.max_wall is not None and now - start >= args.max_wall:
            break
        time.sleep(args.interval)

    if args.format == "json":
        # the deterministic final snapshot (no wall clock inside) — what
        # make alerts-smoke diffs between --follow and --once
        print(
            json.dumps(
                _json_safe_snapshot(state.snapshot()),
                indent=2,
                allow_nan=False,
                sort_keys=True,
            )
        )
    if not follow and (state.records == 0 or state.malformed):
        return 1
    return 0


def _json_safe_snapshot(snapshot):
    from shallowspeed_tpu_torch.observability.metrics import json_safe

    return json_safe(snapshot)


if __name__ == "__main__":
    sys.exit(main())
