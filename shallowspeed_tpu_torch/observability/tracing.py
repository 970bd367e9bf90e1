"""Distributed request tracing: cross-process span chains + attribution.

Copied from ``shallowspeed_tpu/observability/tracing.py`` (pure Python, the
schema-v10 ``trace`` record kind): the same chains, alignment, attribution
and waterfalls for the same records, so the port's report renders a JAX
stream's Tracing section and the JAX report renders the port's.
``tests/test_torch_tracing.py`` holds the copy to the JAX module. The port
serves one engine per process today; the fleet's worker shards and its
clock handshake (the cross-process half below) come with the fleet.

A serving request crosses up to three processes — router → fleet queue →
worker process → engine queue → pack → rung dispatch → health verify →
ack — and before this module each left timestamps in its own JSONL shard
with its own ``time.perf_counter()`` origin and no causal linkage, so
"where did the p99 go" was unanswerable from the shards we already
write. This module is the request-level layer on top of the schema-v10
``trace`` record kind (docs/observability.md § Tracing):

- ``Tracer``             the emitter: one CLOSED span per record (a span
                         is emitted once, at its end, with both
                         endpoints — a killed process simply leaves the
                         spans it finished, never a half-open record),
                         with process-unique span ids and parent/child
                         linkage that survives the worker pipe (the
                         parent ships ``{"trace_id", "parent"}``
                         alongside the request; the worker ships its
                         last span id back with the response);
- ``clock_offsets``      the cross-process clock alignment: the fleet's
                         heartbeat handshake round-trips
                         ``clock_probe`` messages per worker and records
                         the classic NTP-style estimate — for a probe
                         sent at parent time ``t0``, answered at worker
                         time ``tw`` and received at parent time ``t1``,
                         ``offset = tw - (t0 + t1)/2`` with uncertainty
                         ``(t1 - t0)/2`` (the true offset lies inside
                         ``offset ± uncertainty`` whenever the two legs'
                         asymmetry is bounded by the round trip, which
                         one process on one host guarantees). The best
                         (lowest-uncertainty) estimate per replica wins;
- ``assemble_chains``    the reader: joins parent + ``.r{replica_id}``
                         shards into per-request chains keyed by
                         ``trace_id``, mapping every worker-clock
                         timestamp onto the parent timeline
                         (``parent_t = worker_t - offset``). A chain for
                         a TERMINAL request must be complete — every
                         span's parent present, a terminal span present
                         — and ``verify_terminal_chains(strict=True)``
                         REFUSES orphan/unclosed chains instead of
                         rendering half a story;
- ``attribution``        the scoreboard: per-phase latency attribution,
                         both mean and P99-CONDITIONAL (which phase
                         dominates the slowest 1% — the
                         makespan-quantization scoreboard the MPMD
                         per-stage runtime will be judged against), SLO
                         burn per phase, and per-request ``waterfall``
                         text for the worst-k requests.

Span taxonomy (all typed — the reader charges inter-span gaps by type):

    fleet.queue       fleet admission → first placement (parent clock)
    route             placement decision + pipe send; the forward pipe
                      hop lands in the gap charged to this phase
    worker.queue      engine admission → dispatch pop (worker clock)
    pack              slot packing + padding of the dispatch batch
    dispatch          the rung-program dispatch (predict call wall)
    verify            finiteness gate + optional bitwise parity check
    failover.requeue  a dead replica's un-acked request re-entering the
                      fleet queue head — links the dead replica's
                      partial chain to the surviving replica's spans
    ack               the terminal span (one per request): response
                      receipt + completion; the return pipe hop lands in
                      the gap charged to this phase

Clock-domain contract: every parent-side span and every request-record
timestamp is a PARENT-process ``perf_counter`` value; worker spans carry
``clock: "worker"`` raw values that only the recorded per-replica offset
can place on the parent timeline. A chain whose worker spans have no
offset record is flagged ``alignment: "missing"`` (rendered as degraded,
with the uncertainty shown when one exists) rather than silently joined
on incomparable clocks.
"""

import math
from collections import defaultdict

from shallowspeed_tpu_torch.observability.stats import percentile

# the typed span alphabet (module docstring); "clock_offset" records ride
# the same kind but are alignment metadata, not spans. The two
# ``stage.*`` names are the MPMD runtime's training-side spans (the JAX
# package's ``parallel/mpmd.py``): ``stage.dispatch`` is one stage
# program's host issue window (fields: stage/op/mb), ``stage.relay`` one
# device-to-device activation transfer (fields: stage/to_stage/
# direction/mb) — emitted for the first batch of each epoch dispatch so
# the Tracing attribution can show where MPMD wall goes vs lockstep
# without flooding the stream.
SPAN_NAMES = (
    "fleet.queue",
    "route",
    "worker.queue",
    "pack",
    "dispatch",
    "verify",
    "failover.requeue",
    "ack",
    "stage.dispatch",
    "stage.relay",
)

# gap charging: the idle time between two consecutive spans belongs to
# the phase that was "in flight" across it — the forward pipe hop before
# worker.queue is routing, the return hop before ack is acking, a
# re-queued wait before a later route is fleet queueing, the
# death-detection wait before a failover span is the failover's
GAP_CHARGE = {
    "worker.queue": "route",
    "ack": "ack",
    "route": "fleet.queue",
    "failover.requeue": "failover.requeue",
}


class TraceError(ValueError):
    """A terminal request's span chain is incomplete: orphan spans,
    no terminal span, or no chain at all for a traced request."""


class Tracer:
    """Span emitter bound to one metrics recorder and one process.

    ``process`` prefixes every span id (``"f"`` for the fleet parent,
    ``"e"`` for a standalone engine, ``"r{replica_id}"`` for a worker) so
    ids never collide across the processes whose shards one reader
    merges. ``clock_domain`` stamps which perf_counter origin the span
    endpoints live in; ``terminal_ack=False`` suppresses the terminal
    ``ack`` span (a fleet WORKER's completions are worker-terminal, not
    request-terminal — the parent owns the one ack per request).

    Disabled recorders cost one attribute check per call site:
    ``enabled`` mirrors the recorder's, ``new_trace`` is never called on
    the disabled path, and ``span`` returns ``None`` without emitting.
    """

    __slots__ = ("_metrics", "process", "replica_id", "clock_domain",
                 "terminal_ack", "enabled", "_n")

    def __init__(self, metrics, process="e", replica_id=None,
                 clock_domain="parent", terminal_ack=True):
        self._metrics = metrics
        self.process = str(process)
        self.replica_id = replica_id
        self.clock_domain = clock_domain
        self.terminal_ack = bool(terminal_ack)
        self.enabled = bool(getattr(metrics, "enabled", False))
        self._n = 0

    def new_trace(self, req_id):
        """The request's trace id, minted ONCE by the admitting process
        and shipped (never re-minted) across every hop after that."""
        return f"{self.process}-{int(req_id)}"

    def span(self, name, trace_id, t0, t1, parent=None, terminal=False,
             **fields):
        """Emit one closed span; returns its span id (``None`` when
        tracing is disabled or the request carries no trace id)."""
        if not self.enabled or trace_id is None:
            return None
        self._n += 1
        span_id = f"{self.process}.{self._n}"
        self._metrics.trace(
            name,
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent,
            t0=t0,
            t1=t1,
            clock=self.clock_domain,
            replica_id=self.replica_id,
            terminal=bool(terminal),
            **fields,
        )
        return span_id

    def clock_offset(self, replica_id, offset_s, rtt_s, uncertainty_s):
        """Record one per-replica clock-alignment estimate (module
        docstring). Callers emit only IMPROVED estimates, so the reader's
        last-record-wins fold always holds the best one."""
        if not self.enabled:
            return
        self._metrics.trace(
            "clock_offset",
            trace_id=None,
            span_id=None,
            parent_id=None,
            t0=None,
            t1=None,
            clock="parent",
            replica_id=replica_id,
            terminal=False,
            offset_s=offset_s,
            rtt_s=rtt_s,
            uncertainty_s=uncertainty_s,
        )


# ---------------------------------------------------------------------------
# the reader: shards -> aligned chains
# ---------------------------------------------------------------------------


def clock_offsets(records):
    """Per-replica clock alignment from the ``clock_offset`` trace
    records: ``{replica_id: {"offset_s", "rtt_s", "uncertainty_s"}}``.
    Last record wins — the emitter records improvements only, so last IS
    best."""
    out = {}
    for r in records:
        if r.get("kind") == "trace" and r.get("name") == "clock_offset":
            out[r.get("replica_id")] = {
                "offset_s": r.get("offset_s"),
                "rtt_s": r.get("rtt_s"),
                "uncertainty_s": r.get("uncertainty_s"),
            }
    return out


class Chain:
    """One request's span chain, clock-aligned onto the parent timeline.

    ``spans``: dicts with the raw record fields plus ``t0_aligned``/
    ``t1_aligned`` (parent-timeline endpoints; identity for parent-clock
    spans, ``t - offset`` for worker-clock spans). ``alignment``:
    ``"parent"`` (no cross-clock spans), ``"aligned"`` (worker spans
    mapped via a recorded offset), or ``"missing"`` (worker spans with NO
    offset record — their raw values are kept un-mapped and the chain is
    flagged, never silently joined)."""

    __slots__ = ("trace_id", "spans", "alignment", "uncertainty_s")

    def __init__(self, trace_id):
        self.trace_id = trace_id
        self.spans = []
        self.alignment = "parent"
        self.uncertainty_s = 0.0

    @property
    def terminal_span(self):
        for s in reversed(self.spans):
            if s.get("terminal"):
                return s
        return None

    @property
    def verdict(self):
        t = self.terminal_span
        return t.get("verdict") if t else None

    @property
    def t0(self):
        ts = [s["t0_aligned"] for s in self.spans if s["t0_aligned"] is not None]
        return min(ts) if ts else None

    @property
    def t_end(self):
        t = self.terminal_span
        if t is not None and t["t1_aligned"] is not None:
            return t["t1_aligned"]
        ts = [s["t1_aligned"] for s in self.spans if s["t1_aligned"] is not None]
        return max(ts) if ts else None

    @property
    def latency_s(self):
        if self.t0 is None or self.t_end is None:
            return None
        return self.t_end - self.t0

    @property
    def replicas(self):
        return sorted(
            {s["replica_id"] for s in self.spans if s.get("replica_id") is not None}
        )

    def problems(self):
        """Why this chain is NOT a complete request story: orphan spans
        (parent id absent from the chain), unclosed spans (an endpoint
        missing), or no terminal span. Alignment degradation is reported
        separately (``alignment``/``uncertainty_s``) — a mis-estimated
        clock skews durations but does not orphan causality."""
        out = []
        ids = {s["span_id"] for s in self.spans if s.get("span_id")}
        for s in self.spans:
            parent = s.get("parent_id")
            if parent is not None and parent not in ids:
                out.append(
                    f"{self.trace_id}: orphan span {s.get('name')} "
                    f"({s.get('span_id')}) — parent {parent} not in chain"
                )
            if s.get("t0") is None or s.get("t1") is None:
                out.append(
                    f"{self.trace_id}: unclosed span {s.get('name')} "
                    f"({s.get('span_id')})"
                )
        if self.terminal_span is None:
            out.append(f"{self.trace_id}: no terminal span")
        return out


def assemble_chains(records):
    """Join a merged record stream (parent JSONL + ``.r*`` shards — pass
    a glob to ``read_jsonl``) into ``{trace_id: Chain}``, with every
    worker-clock span mapped onto the parent timeline via the recorded
    per-replica offsets."""
    offsets = clock_offsets(records)
    chains = {}
    for r in records:
        if r.get("kind") != "trace" or r.get("name") == "clock_offset":
            continue
        tid = r.get("trace_id")
        if tid is None:
            continue
        chain = chains.get(tid)
        if chain is None:
            chain = chains[tid] = Chain(tid)
        span = dict(r)
        t0, t1 = r.get("t0"), r.get("t1")
        if r.get("clock") == "worker":
            off = offsets.get(r.get("replica_id"))
            if off is not None and off.get("offset_s") is not None:
                shift = off["offset_s"]
                t0 = None if t0 is None else t0 - shift
                t1 = None if t1 is None else t1 - shift
                if chain.alignment == "parent":
                    chain.alignment = "aligned"
                unc = off.get("uncertainty_s")
                if unc is not None:
                    chain.uncertainty_s = max(chain.uncertainty_s, unc)
            else:
                chain.alignment = "missing"
        span["t0_aligned"], span["t1_aligned"] = t0, t1
        chain.spans.append(span)
    for chain in chains.values():
        chain.spans.sort(
            key=lambda s: (
                s["t0_aligned"] if s["t0_aligned"] is not None else math.inf
            )
        )
    return chains


def traced_terminal_requests(records):
    """``{trace_id: verdict}`` from the terminal ``request`` records that
    carry a ``trace_id`` (schema v10 stamps it at admission). One trace
    can hold several request records — a worker-terminal ``error`` the
    fleet re-routed to an ``ok`` elsewhere — and shard concatenation
    order says nothing about causal order, so an ``ok`` wins outright
    (the exactly-one-terminal-verdict contract means a request some
    process served as ``ok`` IS ok); among non-ok records the last one
    read stands. The chain's terminal ``ack`` span stays the
    authoritative per-request fate."""
    out = {}
    for r in records:
        if r.get("kind") == "request" and r.get("trace_id") is not None:
            if out.get(r["trace_id"]) != "ok":
                out[r["trace_id"]] = r.get("name")
    return out


def verify_terminal_chains(records, chains=None, strict=False):
    """The completeness gate: every terminal request with a ``trace_id``
    must have a chain with no orphan/unclosed spans and a terminal span.
    Returns the list of problem strings (empty = every chain complete);
    ``strict=True`` raises ``TraceError`` instead of returning them."""
    if chains is None:
        chains = assemble_chains(records)
    problems = []
    for tid in sorted(traced_terminal_requests(records)):
        chain = chains.get(tid)
        if chain is None:
            problems.append(f"{tid}: terminal request has no span chain")
            continue
        problems.extend(chain.problems())
    if strict and problems:
        raise TraceError(
            f"{len(problems)} incomplete span chain problem(s): "
            + "; ".join(problems[:10])
        )
    return problems


# ---------------------------------------------------------------------------
# attribution: chains -> where the latency went
# ---------------------------------------------------------------------------


def causal_order(chain):
    """The chain's spans in CAUSAL order — a depth-first walk of the
    parent/child links from the roots, siblings by aligned start time.
    Span durations are clock-skew-invariant, but a residual alignment
    error (within the recorded uncertainty) can shuffle the
    CHRONOLOGICAL order across the process boundary — the causal links
    cannot be shuffled, so attribution walks them instead."""
    ids = {s["span_id"]: s for s in chain.spans if s.get("span_id")}
    children = defaultdict(list)
    roots = []
    for s in chain.spans:
        parent = s.get("parent_id")
        if parent is not None and parent in ids:
            children[parent].append(s)
        else:
            roots.append(s)

    def t_key(s):
        return s["t0_aligned"] if s["t0_aligned"] is not None else math.inf

    out = []
    stack = sorted(roots, key=t_key, reverse=True)
    while stack:
        s = stack.pop()
        out.append(s)
        stack.extend(
            sorted(children.get(s.get("span_id"), ()), key=t_key, reverse=True)
        )
    return out


def chain_phases(chain):
    """Per-phase seconds for one chain, on the aligned timeline. Each
    span's own duration is charged to its name; the gap between two
    CAUSALLY consecutive spans is charged by ``GAP_CHARGE`` (the forward
    pipe hop to ``route``, the return hop to ``ack``, re-queue waits to
    ``fleet.queue``, death-detection waits to ``failover.requeue``), so
    the phases sum to the chain's total latency. Residual
    clock-misalignment (within the recorded uncertainty) can make
    aligned spans overlap — negative gaps clamp to zero rather than
    subtracting phantom time, so attribution degrades by at most the
    uncertainty instead of inverting."""
    phases = defaultdict(float)
    prev_end = None
    for s in causal_order(chain):
        t0, t1 = s["t0_aligned"], s["t1_aligned"]
        if t0 is None or t1 is None:
            continue
        if prev_end is not None and t0 > prev_end:
            phases[GAP_CHARGE.get(s["name"], s["name"])] += t0 - prev_end
        phases[s["name"]] += max(0.0, t1 - t0)
        prev_end = t1 if prev_end is None else max(prev_end, t1)
    return dict(phases)


def attribution(chains, slo_ms=None, worst_k=3):
    """Aggregate phase attribution over complete chains:

    - ``phases_mean``: each phase's share of TOTAL latency across all
      chains (time-weighted — a phase that dominates the slow requests
      shows up even if the fast majority never enters it);
    - ``phases_p99``: the same shares CONDITIONED on the slowest 1% of
      chains (latency >= p99) — which phase the tail actually spends its
      time in. This is the makespan-quantization scoreboard: whole-rung
      dispatch shows up here as ``dispatch`` dominating the tail;
    - ``slo_burn``: for chains with an effective deadline (the ack
      span's own ``deadline_ms`` tag, else ``slo_ms``), each phase's
      mean share of the SLO budget — a phase burning >100% alone
      guarantees a violation;
    - ``worst``: the worst-``k`` chains by latency (render with
      ``waterfall``).
    """
    complete = [
        c for c in chains.values()
        if c.latency_s is not None and not c.problems()
    ]
    if not complete:
        return None
    lats = [c.latency_s for c in complete]
    p99 = percentile(lats, 99)
    tail = [c for c in complete if c.latency_s >= p99]
    per_chain = {c.trace_id: chain_phases(c) for c in complete}

    def shares(pool):
        total = sum(c.latency_s for c in pool)
        agg = defaultdict(float)
        for c in pool:
            for name, secs in per_chain[c.trace_id].items():
                agg[name] += secs
        if total <= 0:
            return {}
        return {name: secs / total for name, secs in sorted(agg.items())}

    p99_shares = shares(tail)
    burn = None
    with_slo = []
    for c in complete:
        term = c.terminal_span or {}
        bound = term.get("deadline_ms")
        if bound is None:
            bound = slo_ms
        if bound:
            with_slo.append((c, bound / 1000.0))
    if with_slo:
        agg = defaultdict(float)
        for c, budget in with_slo:
            for name, secs in per_chain[c.trace_id].items():
                agg[name] += secs / budget
        burn = {
            name: total / len(with_slo) for name, total in sorted(agg.items())
        }
    return {
        "chains": len(complete),
        "p99_latency_s": p99,
        "p99_chains": len(tail),
        "phases_mean": shares(complete),
        "phases_p99": p99_shares,
        "p99_dominant_phase": (
            max(p99_shares, key=p99_shares.get) if p99_shares else None
        ),
        "slo_burn": burn,
        "slo_chains": len(with_slo),
        "worst": sorted(complete, key=lambda c: -c.latency_s)[:worst_k],
    }


def waterfall(chain, width=40):
    """Text waterfall for one chain: each span as a bar positioned on the
    chain's aligned timeline, with its phase window in milliseconds.
    Worker spans are tagged with their replica; a degraded alignment is
    noted on the header line."""
    t0, total = chain.t0, chain.latency_s
    header = f"{chain.trace_id}  {total * 1e3:.1f} ms  {chain.verdict}"
    if len(chain.replicas) > 1:
        header += "  (replicas " + " -> ".join(f"r{r}" for r in chain.replicas) + ")"
    if chain.alignment == "missing":
        header += "  [ALIGNMENT MISSING: worker clocks unmapped]"
    elif chain.uncertainty_s:
        header += f"  [clock ±{chain.uncertainty_s * 1e3:.2f} ms]"
    lines = [header]
    for s in causal_order(chain):
        a, b = s["t0_aligned"], s["t1_aligned"]
        if a is None or b is None or total is None or total <= 0:
            continue
        lo = max(0, min(width - 1, int((a - t0) / total * width)))
        hi = max(lo + 1, min(width, int(math.ceil((b - t0) / total * width))))
        bar = " " * lo + "█" * (hi - lo) + " " * (width - hi)
        tag = f" r{s['replica_id']}" if s.get("replica_id") is not None else ""
        lines.append(
            f"  {s['name']:<16} |{bar}| "
            f"{(a - t0) * 1e3:8.2f} -> {(b - t0) * 1e3:8.2f} ms{tag}"
        )
    return lines
