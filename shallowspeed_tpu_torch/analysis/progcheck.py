"""Send/recv match & deadlock analysis over lowered tick programs.

The port's copy of ``shallowspeed_tpu/analysis/progcheck.py`` (numpy only);
``tests/test_torch_lowering.py`` holds its verdicts equal to the JAX
package's.

The lowering simulator (parallel/lowering.py) refuses schedules it cannot
place, but the TickProgram it emits is then trusted as-is: the executor
dispatches the tables, and the planned MPMD runtime (ROADMAP item 1,
arXiv 2412.14374) will dispatch each stage's stream ASYNCHRONOUSLY with
no lockstep barrier. These passes re-derive, from the ARTIFACT alone,
exactly the properties that asynchronous dispatch needs — which makes
the analyzer the MPMD runtime's spec, the same static-schedule reasoning
PipeDream applies before execution (arXiv 1806.03377):

- ``check_send_recv``: a tick-replay over the mailbox tables. Every send
  has a delivery slot on the peer stage; every mailbox read consumes a
  message delivered on an EARLIER tick (the executor's deliver-at-end-of-
  tick timing); a delivery never clobbers an undelivered message; no
  message is left unconsumed at program end. Violations name the tick,
  stage and slot.
- ``check_deadlock_free``: the tick-free proof. Per-stage instruction
  streams are reconstructed from the tables and messages are matched by
  (chunk, microbatch) KEY — no tick numbers involved — then the
  happens-before graph (per-stage program order + send->recv edges +
  bounded-mailbox slot-reuse edges: the sender of a slot's next message
  waits for the consumer of its previous one) is checked acyclic. An
  acyclic graph means the streams, dispatched asynchronously with the
  program's finite mailbox depths, can always make progress; a cycle is
  reported as the literal wait chain, tick by tick.

``analyze_program`` runs every pass (including the stash-lifetime pass,
``analysis/stash.py``) and returns a JSON-able verdict dict — the field
set of the schema-v9 ``static_analysis`` record — raising
``ProgramAnalysisError`` on the first violated contract.
"""

import numpy as np

from shallowspeed_tpu_torch.parallel.lowering import OP_NOOP


class ProgramAnalysisError(ValueError):
    """A lowered tick program violates a statically-checkable contract —
    either the tables were tampered with, or the lowering itself
    regressed. The message names the offending tick/stage/slot."""


def _active_cells(prog):
    """Per-stage MPMD streams: the (tick, stage) cells each device runs,
    in its own program order (tick order within a column)."""
    op = np.asarray(prog.op)
    return [
        [int(t) for t in np.nonzero(op[:, s] != OP_NOOP)[0]]
        for s in range(prog.num_stages)
    ]


def _cell_key(prog, t, s):
    """The (chunk, microbatch) identity of the compute at cell (t, s)."""
    chunk = int(prog.chunk[t, s]) if prog.chunk is not None else 0
    return (chunk, int(prog.mb[t, s]))


def _sent_key(prog, t, s, direction):
    """The key a send at (t, s) delivers under, after the ring's chunk
    shift (forward wrap P-1 -> 0 advances the chunk; backward mirrors)."""
    chunk, mb = _cell_key(prog, t, s)
    P = prog.num_stages
    if direction == "fwd":
        return (chunk + (1 if s == P - 1 else 0), mb)
    return (chunk - (1 if s == 0 else 0), mb)


def check_send_recv(prog):
    """Replay the mailbox tables tick by tick and prove the send/recv
    match contract (module docstring). Returns the pass's stats dict."""
    P, T = prog.num_stages, prog.num_ticks
    tables = {
        "fwd": (prog.send_fwd, prog.in_fwd_slot, prog.read_fwd_slot,
                int(prog.n_fwd_slots), +1),
        "bwd": (prog.send_bwd, prog.in_bwd_slot, prog.read_bwd_slot,
                int(prog.n_bwd_slots), -1),
    }
    # per (direction, stage): slot -> tick the occupying message was sent
    occupied = {d: [dict() for _ in range(P)] for d in tables}
    stats = {
        "sends_fwd": 0, "sends_bwd": 0,
        "mail_peak_fwd": 0, "mail_peak_bwd": 0,
    }
    for t in range(T):
        # reads first: a message consumed at tick t frees its slot for an
        # arrival in this very tick (lowering._Mailbox.consume semantics)
        for d, (_, _, read_tab, trash, _) in tables.items():
            for s in range(P):
                slot = int(read_tab[t, s])
                if slot == trash:
                    continue
                sent = occupied[d][s].pop(slot, None)
                if sent is None:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: reads {d} mailbox slot {slot}"
                        " which holds no message — recv with no matching"
                        " send"
                    )
                if sent >= t:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: reads {d} mailbox slot {slot}"
                        f" delivered this same tick (sent at tick {sent});"
                        " payloads are consumable from tick t+1"
                    )
        # then deliveries
        for d, (send_tab, in_tab, _, trash, step) in tables.items():
            for s in range(P):
                dst = (s + step) % P
                sends = int(send_tab[t, s])
                slot = int(in_tab[t, dst])
                if sends:
                    stats[f"sends_{d}"] += 1
                    if slot == trash:
                        raise ProgramAnalysisError(
                            f"tick {t} stage {s}: {d} send has no delivery"
                            f" slot on peer stage {dst} — unmatched send"
                        )
                    if slot in occupied[d][dst]:
                        raise ProgramAnalysisError(
                            f"tick {t} stage {s}: {d} send clobbers mailbox"
                            f" slot {slot} on stage {dst} (still holding the"
                            f" message sent at tick {occupied[d][dst][slot]})"
                        )
                    occupied[d][dst][slot] = t
                    stats[f"mail_peak_{d}"] = max(
                        stats[f"mail_peak_{d}"], len(occupied[d][dst])
                    )
                elif slot != trash:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {dst}: {d} delivery into slot"
                        f" {slot} with no send from stage {s} this tick —"
                        " phantom arrival"
                    )
    for d, (_, _, _, trash, _) in tables.items():
        for s in range(P):
            if occupied[d][s]:
                slot, sent = next(iter(occupied[d][s].items()))
                raise ProgramAnalysisError(
                    f"stage {s}: {d} mailbox slot {slot} still holds the"
                    f" message sent at tick {sent} at program end — send"
                    " with no consuming recv on the peer stage"
                )
    for d in tables:
        depth = int(prog.n_fwd_slots if d == "fwd" else prog.n_bwd_slots)
        peak = stats[f"mail_peak_{d}"]
        if peak > depth:
            raise ProgramAnalysisError(
                f"{d} mailbox peak occupancy {peak} exceeds the allocated"
                f" depth {depth}"
            )
    return stats


def _message_edges(prog):
    """Key-matched send->recv pairs plus bounded-mailbox slot-reuse
    pairs, as ``(edge_kind, (t_from, s_from), (t_to, s_to))`` cell edges
    — derived WITHOUT comparing tick numbers (ticks only order cells
    within one stage's own stream), so the deadlock proof does not
    assume the lockstep schedule it is meant to replace. ``"msg"`` edges
    run sender-cell -> consumer-cell; ``"reuse"`` edges run
    previous-consumer-cell -> next-sender-cell (a bounded mailbox's slot
    must be freed before it can take the next delivery)."""
    P, T = prog.num_stages, prog.num_ticks
    edges = []
    for d, (send_tab, in_tab, read_tab, trash, step) in {
        "fwd": (prog.send_fwd, prog.in_fwd_slot, prog.read_fwd_slot,
                int(prog.n_fwd_slots), +1),
        "bwd": (prog.send_bwd, prog.in_bwd_slot, prog.read_bwd_slot,
                int(prog.n_bwd_slots), -1),
    }.items():
        # sends per (dst stage, key) — the ring is neighbor-only, so the
        # (src, dst, key) triple names one message
        sends = {}
        for s in range(P):
            dst = (s + step) % P
            for t in range(T):
                if int(send_tab[t, s]):
                    key = (dst, _sent_key(prog, t, s, d))
                    if key in sends:
                        raise ProgramAnalysisError(
                            f"tick {t} stage {s}: duplicate {d} send for"
                            f" (chunk, microbatch) {key[1]} to stage {dst}"
                        )
                    sends[key] = (t, s)
        # recv (consuming cell) per key; slot-reuse chains per (stage,
        # slot) in the receiver's own stream order
        for s in range(P):
            prev_consumer_of_slot = {}
            for t in range(T):
                slot = int(read_tab[t, s])
                if slot != trash:
                    key = (s, _cell_key(prog, t, s))
                    sender = sends.pop(key, None)
                    if sender is None:
                        raise ProgramAnalysisError(
                            f"tick {t} stage {s}: {d} recv for (chunk,"
                            f" microbatch) {key[1]} has no matching send"
                            " on the peer stage"
                        )
                    edges.append(("msg", sender, (t, s)))
                    prev_consumer_of_slot[slot] = (t, s)
                # a delivery into slot k can only happen once slot k's
                # previous message was consumed: under async dispatch the
                # SENDER of the new message waits on that consumer
                in_slot = int(in_tab[t, s])
                if in_slot != trash:
                    src = (s - step) % P
                    prev = prev_consumer_of_slot.get(in_slot)
                    if prev is not None and int(send_tab[t, src]):
                        edges.append(("reuse", prev, (t, src)))
        if sends:
            (dst, key), (t, s) = next(iter(sends.items()))
            raise ProgramAnalysisError(
                f"tick {t} stage {s}: {d} send for (chunk, microbatch)"
                f" {key} has no consuming recv on stage {dst}"
            )
    return edges


def check_deadlock_free(prog):
    """Prove the per-stage streams cannot deadlock under asynchronous
    (MPMD) dispatch with the program's bounded mailboxes.

    Each cell is modeled as TWO events — ``R`` (its recvs complete; the
    consumed mailbox slots free here) and ``X`` (its compute and sends
    complete) — because a blocked sender waits only on the consumer
    FREEING the slot, not on the consumer's whole cell: collapsing the
    two manufactures wait cycles in perfectly healthy steady states
    (e.g. the interleaved schedule's same-tick consume-and-send ring).
    The happens-before graph is then:

    - ``R -> X`` within each cell;
    - ``X(prev) -> R(next)`` along each stage's own stream (serial
      async dispatch);
    - ``X(sender) -> R(consumer)`` for every key-matched message;
    - ``R(previous consumer) -> X(next sender)`` for every reuse of a
      bounded mailbox slot (the send blocks until the slot frees).

    Acyclic means the streams, dispatched with no lockstep barrier and
    the program's finite mailbox depths, always make progress; a cycle
    raises ``ProgramAnalysisError`` spelling out the literal wait chain
    tick by tick. Returns the pass's stats dict."""
    R, X = 0, 1
    streams = _active_cells(prog)
    succ = {}

    def node(cell, phase):
        v = (cell[0], cell[1], phase)
        succ.setdefault(v, [])
        return v

    for s, ticks in enumerate(streams):
        for t in ticks:
            succ.setdefault((t, s, R), []).append(node((t, s), X))
        for a, b in zip(ticks, ticks[1:]):
            succ[(a, s, X)].append(node((b, s), R))
    n_message_edges = n_reuse_edges = 0
    for kind, frm, to in _message_edges(prog):
        if kind == "msg":
            succ[node(frm, X)].append(node(to, R))
            n_message_edges += 1
        else:  # reuse: the new send waits on the old message's consumer
            if frm == to:
                continue  # a cell may free and refill its own slot
            succ[node(frm, R)].append(node(to, X))
            n_reuse_edges += 1
    # iterative 3-color DFS; a back edge is a genuine wait cycle
    WHITE, GREY, BLACK = 0, 1, 2
    color = {v: WHITE for v in succ}
    for root in succ:
        if color[root] != WHITE:
            continue
        stack = [(root, iter(succ[root]))]
        color[root] = GREY
        path = [root]
        while stack:
            _, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GREY:
                    i = path.index(nxt)
                    cycle = path[i:] + [nxt]
                    chain = " -> ".join(
                        f"stage {s} tick {t} ({'recv' if p == R else 'send'})"
                        for t, s, p in cycle
                    )
                    raise ProgramAnalysisError(
                        "cyclic wait under asynchronous (MPMD) dispatch: "
                        + chain
                    )
                if color[nxt] == WHITE:
                    color[nxt] = GREY
                    stack.append((nxt, iter(succ[nxt])))
                    path.append(nxt)
                    advanced = True
                    break
            if not advanced:
                color[path[-1]] = BLACK
                stack.pop()
                path.pop()
    return {
        "cells": sum(len(t) for t in streams),
        "message_edges": n_message_edges,
        "reuse_edges": n_reuse_edges,
    }


def analyze_program(prog, program="program"):
    """Run every program-level static pass over one lowered TickProgram.

    Returns the JSON-able verdict dict the schema-v9 ``static_analysis``
    record carries (pass names + per-pass stats, zero findings — a
    violated contract raises ``ProgramAnalysisError`` instead, naming the
    offending tick, BEFORE any dispatch can happen)."""
    from shallowspeed_tpu_torch.analysis.stash import check_stash_lifetime

    send_recv = check_send_recv(prog)
    deadlock = check_deadlock_free(prog)
    stash = check_stash_lifetime(prog)
    return {
        "program": program,
        "passes": ["send_recv", "deadlock", "stash"],
        "findings": 0,
        "is_training": bool(prog.is_training),
        "num_ticks": int(prog.num_ticks),
        "num_stages": int(prog.num_stages),
        "send_recv": send_recv,
        "deadlock": deadlock,
        "stash": stash,
    }
