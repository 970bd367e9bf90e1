"""Summarize a torch.profiler (Kineto) chrome trace: the port's counterpart
of ``shallowspeed_tpu/observability/trace_stats.py``.

Reads the ``*.pt.trace.json[.gz]`` that ``spans.capture`` (``train.py
--profile-dir``) or ``TrainingSession.measure_dispatch_overhead`` leaves
behind, plain or gzipped, and reports what the JAX module reports from a
``jax.profiler`` trace, with the same keys:

- ``dispatch_busy``: the interval union of the device events (Kineto
  ``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``); on a trace with no
  device event (a CPU run) the union of the ``cpu_op`` events, as the JAX
  module falls back to the XLA thunks of its CPU backend;
- ``summarize``: device op count, wall span, busy time, issue rate,
  overlap, the comm/compute split (NCCL kernels are communication; one
  card runs none) and the op breakdown by kernel name (``void (anonymous
  namespace)::linear_act_fwd_kernel<32, 32, 2, 4>(...)`` counts as
  ``linear_act_fwd_kernel``).

    from shallowspeed_tpu_torch.observability import trace_stats
    stats = trace_stats.summarize("trace/host_1.123.pt.trace.json.gz")

CLI: ``python -m shallowspeed_tpu_torch.observability.trace_stats DIR|FILE
[--json]``.
"""

import argparse
import collections
import gzip
import json
import sys
from pathlib import Path

# Kineto event categories of work on the device (a kernel, a copy, a fill)
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kineto's host-side operator category: the CPU fallback's op stream
CPU_OP_CAT = "cpu_op"


def is_comm_op(name):
    """True when a device event is communication: an NCCL kernel."""
    return "nccl" in str(name).lower()


def kernel_key(name):
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameter list: ``void (anonymous
    namespace)::k<1, 2>(float*)`` -> ``k``."""
    n = str(name).replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    for sep in ("<", "("):
        n = n.split(sep, 1)[0]
    return n.strip() or str(name)


def _union_us(events):
    """Total covered length of the [ts, ts+dur) intervals of ``events``."""
    covered, end = 0.0, None
    for s, e in sorted((ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in events):
        if end is None or s > end:
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered


def find_traces(path):
    """A file path as-is, or every ``*.trace.json`` / ``*.trace.json.gz``
    under a directory, sorted."""
    p = Path(path)
    if p.is_file():
        return [p]
    return sorted(set(p.rglob("*.trace.json.gz")) | set(p.rglob("*.trace.json")))


def load(trace_path):
    """The trace dict of a plain or gzipped chrome-trace JSON file."""
    opener = gzip.open if str(trace_path).endswith(".gz") else open
    with opener(trace_path, "rt", encoding="utf-8") as f:
        return json.load(f)


def device_events(trace):
    """The complete (``ph`` X) events of a trace that ran on the device."""
    return [
        e
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS
    ]


def dispatch_busy(trace_path):
    """Op-execution interval UNION of one trace — the device side of the
    dispatch-overhead probe (``api.measure_dispatch_overhead``).

    The device events when the trace has any (``source`` ``"device"``);
    otherwise the ``cpu_op`` events (``source`` ``"host-cpu-ops"``: the
    CPU path's operators, which nest, so the union counts each instant
    once). Split by ``is_comm_op`` into comm and compute unions.

    Returns ``{"op_events", "busy_union_s", "comm_union_s",
    "compute_union_s", "source", "trace"}`` — ``op_events == 0`` (with
    ``busy_union_s`` None) when the trace holds nothing attributable,
    which callers must surface, not paper over."""
    tr = load(trace_path)
    ops = device_events(tr)
    source = "device"
    if not ops:
        ops = [
            e
            for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == CPU_OP_CAT
        ]
        source = "host-cpu-ops"
    if not ops:
        return {
            "trace": str(trace_path),
            "op_events": 0,
            "busy_union_s": None,
            "comm_union_s": None,
            "compute_union_s": None,
            "source": source,
        }
    return {
        "trace": str(trace_path),
        "op_events": len(ops),
        "busy_union_s": _union_us(ops) / 1e6,
        "comm_union_s": _union_us(e for e in ops if is_comm_op(e["name"])) / 1e6,
        "compute_union_s": _union_us(e for e in ops if not is_comm_op(e["name"])) / 1e6,
        "source": source,
    }


def dispatch_overhead_share(busy_union_s, host_wall_s):
    """The share of the host wall NOT covered by op execution — ``1 -
    busy/wall``, clamped at 0 (timer jitter must not report negative
    overhead). ``None`` when either side is unmeasured."""
    if not host_wall_s or busy_union_s is None:
        return None
    return max(0.0, 1.0 - busy_union_s / host_wall_s)


def summarize(trace_path):
    """Device-op statistics for one trace (dict, JSON-able), with the JAX
    module's keys: ``device_ops``, ``span_ms``, ``busy_ms``,
    ``ns_per_op_issued``, ``unit_overlap``, ``comm_ops``/``comm_ms``/
    ``compute_ms``/``comm_fraction``, ``exposed_comm_ms``/
    ``comm_union_ms``/``overlap_efficiency`` (per device, comm time with
    no compute in flight on it) and ``top_ops`` (count per kernel name).
    ``{"device_ops": 0}`` when the trace holds no device event."""
    ops = device_events(load(trace_path))
    if not ops:
        return {"trace": str(trace_path), "device_ops": 0}
    t0 = min(e["ts"] for e in ops)
    t1 = max(e["ts"] + e.get("dur", 0) for e in ops)
    span_us = t1 - t0
    busy_us = sum(e.get("dur", 0) for e in ops)
    comm = [e for e in ops if is_comm_op(e["name"])]
    comm_us = sum(e.get("dur", 0) for e in comm)
    kinds = collections.Counter(kernel_key(e["name"]) for e in ops)
    exposed_us = 0.0
    comm_union_us = 0.0
    for pid in {e["pid"] for e in comm}:
        dev = [e for e in ops if e["pid"] == pid]
        compute_cover = _union_us(e for e in dev if not is_comm_op(e["name"]))
        exposed_us += _union_us(dev) - compute_cover
        comm_union_us += _union_us(e for e in dev if is_comm_op(e["name"]))
    return {
        "trace": str(trace_path),
        "device_ops": len(ops),
        "span_ms": round(span_us / 1e3, 3),
        "busy_ms": round(busy_us / 1e3, 3),
        "ns_per_op_issued": round(1e3 * span_us / len(ops), 1),
        "unit_overlap": round(busy_us / span_us, 2) if span_us else 0.0,
        "comm_ops": len(comm),
        "comm_ms": round(comm_us / 1e3, 3),
        "compute_ms": round((busy_us - comm_us) / 1e3, 3),
        "comm_fraction": round(comm_us / busy_us, 4) if busy_us else 0.0,
        "exposed_comm_ms": round(exposed_us / 1e3, 3),
        "comm_union_ms": round(comm_union_us / 1e3, 3),
        "overlap_efficiency": (
            round(1.0 - exposed_us / comm_union_us, 4) if comm_union_us else None
        ),
        "top_ops": dict(kinds.most_common(8)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="trace dir or a *.trace.json[.gz] file")
    ap.add_argument("--json", action="store_true", help="one JSON line per trace")
    args = ap.parse_args(argv)
    traces = find_traces(args.path)
    if not traces:
        print(f"no *.trace.json[.gz] under {args.path}", file=sys.stderr)
        sys.exit(1)
    for t in traces:
        s = summarize(t)
        if args.json:
            from shallowspeed_tpu_torch.observability.metrics import json_safe

            print(json.dumps(json_safe(s), allow_nan=False))
        else:
            print(f"{s['trace']}:")
            for k, v in s.items():
                if k != "trace":
                    print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
