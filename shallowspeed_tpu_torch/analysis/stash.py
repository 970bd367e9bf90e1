"""Stash-lifetime analysis over lowered tick programs.

The port's copy of ``shallowspeed_tpu/analysis/stash.py``;
``tests/test_torch_lowering.py`` holds its verdicts equal to the JAX
package's.

The activation stash (and, in split-backward programs, the grad stash)
is the schedule's REAL memory: lowering sizes the physical buffers from
the simulator's peak slot pressure (``n_stash_slots``/``n_gstash_slots``
— GPipe peaks at M, PipeDream-Flush at min(M, depth - stage)). This pass
re-proves, from the emitted tables alone, the lifetime discipline those
buffer shapes assume:

- **write-before-read**: a backward (or split B-input peek / B-weight
  read) only ever touches a slot a forward filled and has not yet freed;
- **no double-write**: a forward never claims a live slot, and never
  reuses a slot in the very tick that freed it (stash reuse is legal
  from the NEXT tick — ``stash_free_from[slot] = t + 1`` in the
  simulator — unlike the mailboxes' same-tick reuse);
- **no leak**: every claimed slot is freed by program end;
- **exact peak**: the measured peak of concurrently-live slots equals
  the allocated depth — the buffers are sized to the schedule's true
  pressure, neither torn (too small) nor quietly padded (too large).

Recompute programs add the stage-input (xin) stash — filled by forwards,
freed by the matching OP_RECOMPUTE cell — replayed under the same
discipline, and ``assert_recompute_peak_drop`` is the pass the smoke
targets run: it proves, from the two programs' ACTUAL tick tables, that
the recompute twin's activation-stash peak is strictly below the stashed
twin's (or already at the floor of one live slot, where no schedule can
go lower).

Violations raise ``ProgramAnalysisError`` naming the tick, stage and
slot. Inference programs (no stash tables in use) pass trivially with
zeroed stats.
"""

from shallowspeed_tpu_torch.analysis.progcheck import ProgramAnalysisError


def _check_one_stash(prog, label, write_tab, read_tab, peek_tab, depth):
    """Replay one stash's write/peek/read tables; returns (peak, writes)."""
    P, T = prog.num_stages, prog.num_ticks
    trash = int(depth)
    live = [dict() for _ in range(P)]  # slot -> claiming tick
    freed_at = [dict() for _ in range(P)]  # slot -> freeing tick
    peak = writes = reads = peeks = 0
    for t in range(T):
        for s in range(P):
            r = int(read_tab[t, s]) if read_tab is not None else trash
            w = int(write_tab[t, s]) if write_tab is not None else trash
            p = int(peek_tab[t, s]) if peek_tab is not None else trash
            if p != trash and p not in live[s]:
                raise ProgramAnalysisError(
                    f"tick {t} stage {s}: peeks {label} slot {p} which"
                    " holds no live value — read before write"
                )
            if p != trash:
                peeks += 1
            if r != trash:
                if r not in live[s]:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: reads {label} slot {r} which"
                        " holds no live value — read before write"
                    )
                del live[s][r]
                freed_at[s][r] = t
                reads += 1
            if w != trash:
                if w >= depth:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: writes {label} slot {w}"
                        f" outside the allocated depth {depth}"
                    )
                if w in live[s]:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: writes {label} slot {w}"
                        f" while it still holds the value stashed at tick"
                        f" {live[s][w]} — double write"
                    )
                if freed_at[s].get(w) == t:
                    raise ProgramAnalysisError(
                        f"tick {t} stage {s}: writes {label} slot {w} in"
                        " the same tick that freed it (stash reuse is"
                        " legal from the next tick)"
                    )
                live[s][w] = t
                writes += 1
                peak = max(peak, max(len(live[d]) for d in range(P)))
    for s in range(P):
        if live[s]:
            slot, t0 = next(iter(live[s].items()))
            raise ProgramAnalysisError(
                f"stage {s}: {label} slot {slot} (stashed at tick {t0}) is"
                " still live at program end — leaked stash slot"
            )
    if writes and peak != depth:
        raise ProgramAnalysisError(
            f"{label} measured peak {peak} != allocated depth {depth} —"
            " the buffers are not sized to the schedule's true pressure"
        )
    return {"peak": peak, "writes": writes, "reads": reads, "peeks": peeks}


def check_stash_lifetime(prog):
    """Prove the stash-lifetime contract for one lowered TickProgram
    (module docstring). Returns the pass's stats dict."""
    stats = {
        "stash_slots": int(prog.n_stash_slots),
        "gstash_slots": int(prog.n_gstash_slots),
    }
    if not prog.is_training:
        # inference programs stash nothing; their tables are all-trash
        stats["stash"] = {"peak": 0, "writes": 0, "reads": 0, "peeks": 0}
        stats["gstash"] = {"peak": 0, "writes": 0, "reads": 0, "peeks": 0}
        return stats
    stats["stash"] = _check_one_stash(
        prog, "activation stash", prog.stash_write, prog.stash_read,
        prog.stash_peek, int(prog.n_stash_slots),
    )
    if prog.backward_split:
        # split programs: every B-input must also have peeked the
        # activation stash its B-weight frees
        stats["gstash"] = _check_one_stash(
            prog, "grad stash", prog.gstash_write, prog.gstash_read,
            None, int(prog.n_gstash_slots),
        )
        if stats["gstash"]["writes"] != stats["gstash"]["reads"]:
            raise ProgramAnalysisError(
                "grad stash writes and reads disagree: "
                f"{stats['gstash']['writes']} B-inputs vs "
                f"{stats['gstash']['reads']} B-weights"
            )
    else:
        stats["gstash"] = {"peak": 0, "writes": 0, "reads": 0, "peeks": 0}
    stats["xin_slots"] = int(getattr(prog, "n_xin_slots", 0) or 0)
    if getattr(prog, "recompute", False):
        stats["xin"] = _check_one_stash(
            prog, "recompute input stash", prog.xin_write, prog.xin_read,
            None, int(prog.n_xin_slots),
        )
        if stats["xin"]["writes"] != stats["xin"]["reads"]:
            raise ProgramAnalysisError(
                "recompute input stash writes and reads disagree: "
                f"{stats['xin']['writes']} forwards stashed vs "
                f"{stats['xin']['reads']} recomputes freed"
            )
    else:
        stats["xin"] = {"peak": 0, "writes": 0, "reads": 0, "peeks": 0}
    if stats["stash"]["writes"] != stats["stash"]["reads"]:
        raise ProgramAnalysisError(
            "activation stash writes and reads disagree: "
            f"{stats['stash']['writes']} forwards stashed vs "
            f"{stats['stash']['reads']} backwards freed"
        )
    return stats


def assert_recompute_peak_drop(stashed_prog, rec_prog):
    """Prove — from the two twins' ACTUAL tick tables, not their
    allocation metadata — that recompute shortened the activation-stash
    lifetime: the recompute program's measured peak of concurrently-live
    residual-stash slots must be STRICTLY below the stashed twin's, or
    already sit at the floor of one live slot (a schedule that never
    holds more than one stash — the naive schedules — has nothing left
    to reclaim; demanding a drop there would be dishonest). The grad
    stash of split programs is held to the same bar. Returns the
    comparison dict the smoke target prints."""
    if not getattr(rec_prog, "recompute", False):
        raise ProgramAnalysisError(
            "assert_recompute_peak_drop: second program is not a"
            " recompute program"
        )
    if getattr(stashed_prog, "recompute", False):
        raise ProgramAnalysisError(
            "assert_recompute_peak_drop: first program must be the"
            " stashed twin"
        )
    s0 = check_stash_lifetime(stashed_prog)
    s1 = check_stash_lifetime(rec_prog)
    out = {
        "stash_peak_stashed": s0["stash"]["peak"],
        "stash_peak_recompute": s1["stash"]["peak"],
        "gstash_peak_stashed": s0["gstash"]["peak"],
        "gstash_peak_recompute": s1["gstash"]["peak"],
        "xin_peak": s1["xin"]["peak"],
    }
    for name in ("stash", "gstash"):
        p0, p1 = s0[name]["peak"], s1[name]["peak"]
        if p0 == 0:
            continue  # e.g. no grad stash in combined-backward programs
        if p0 > 1 and not p1 < p0:
            raise ProgramAnalysisError(
                f"recompute did not shorten the {name} lifetime: peak"
                f" {p1} is not strictly below the stashed twin's {p0}"
            )
        if p0 == 1 and p1 != 1:
            raise ProgramAnalysisError(
                f"{name} peak {p1} regressed from the stashed twin's"
                " floor of 1 live slot"
            )
    return out
