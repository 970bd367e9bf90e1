"""The port's copies of the pipeline tables against the JAX package's:
``shallowspeed_tpu_torch/schedules.py``, ``parallel/lowering.py`` and
``analysis/progcheck.py`` + ``analysis/stash.py``.

Copies, so everything is held EXACTLY: every instruction stream, every
field and table of every lowered ``TickProgram``, the program statistics,
and the analyzers' verdicts (and their refusals), over the schedule x size
cases of ``tests/test_schedules.py``, ``tests/test_lowering.py`` and
``tests/test_analysis.py``.
"""

import dataclasses

import numpy as np
import pytest

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.analysis import progcheck as jcheck
from shallowspeed_tpu.analysis import stash as jstash
from shallowspeed_tpu.parallel import lowering as JL
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.analysis import progcheck as tcheck
from shallowspeed_tpu_torch.analysis import stash as tstash
from shallowspeed_tpu_torch.parallel import lowering as TL

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
TRAIN = ("NaiveParallelSchedule", "GPipeSchedule", "PipeDreamFlushSchedule")
GRID = [(4, 1), (4, 2), (4, 4), (2, 4), (8, 4), (1, 3), (4, 8)]

# (schedule class name, M, P, lower_schedule keywords): test_lowering.py's
# grid for every flat training schedule and inference, its split sizes,
# test_analysis.py's lattice (interleaved, interleaved inference) and the
# recompute twins
CASES = (
    [(c, m, p, {}) for c in TRAIN for m, p in GRID]
    + [("InferenceSchedule", m, p, {"training": False}) for m, p in GRID]
    + [
        (c, m, p, {"backward_split": True})
        for c in TRAIN
        for m, p in [(4, 2), (4, 4), (8, 4), (2, 4)]
    ]
    + [("InterleavedSchedule", m, p, {"virtual": 2}) for m, p in [(4, 4), (8, 4), (4, 2)]]
    + [
        ("InterleavedInferenceSchedule", m, p, {"training": False, "virtual": 2})
        for m, p in [(4, 4), (8, 4), (4, 2)]
    ]
    + [(c, 4, 4, {"recompute": True}) for c in TRAIN]
)


def _id(case):
    name, m, p, kw = case
    return f"{name}-M{m}-P{p}" + "".join(f"-{k}" for k in sorted(kw))


def _pair(case):
    name, m, p, kw = case
    return (
        JL.lower_schedule(getattr(JS, name), m, p, **kw),
        TL.lower_schedule(getattr(TS, name), m, p, **kw),
    )


def _assert_programs_equal(j, t):
    assert type(t).__name__ == "TickProgram"
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_tick_program_equal(case):
    """Every field and every table of the lowered program, and the
    statistics computed from them."""
    j, t = _pair(case)
    _assert_programs_equal(j, t)
    assert TL.utilization(t) == JL.utilization(j)
    assert TL.weighted_makespan(t) == JL.weighted_makespan(j)
    assert TL.weighted_utilization(t) == JL.weighted_utilization(j)
    assert TL.program_stats(t) == JL.program_stats(j)


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_program_cost_models_equal_at_the_flagship(pp):
    """``program_stats`` with a model (the stash bytes), ``program_flops``
    and ``program_comm_bytes`` read the port's own slot shapes and relay
    width; the numbers equal the JAX package's."""
    jspec = jmodel.make_model_spec(FLAGSHIP, pp, 128)
    tspec = tmodel.make_model_spec(FLAGSHIP, pp, 128)
    for name in TRAIN:
        j = JL.lower_schedule(getattr(JS, name), 4, pp)
        t = TL.lower_schedule(getattr(TS, name), 4, pp)
        assert TL.program_stats(t, spec=tspec, mubatch_size=16) == JL.program_stats(
            j, spec=jspec, mubatch_size=16
        )
        assert TL.program_flops(t, tspec, 16) == JL.program_flops(j, jspec, 16)
        assert TL.program_comm_bytes(t, tspec, 16) == JL.program_comm_bytes(j, jspec, 16)


def _stream(cmds):
    return [(type(c).__name__, dataclasses.asdict(c)) for c in cmds]


STREAMS = (
    [(c, m, st, s, {}) for c in TRAIN for m in (1, 4, 8) for st, s in [(1, 0), (4, 0), (4, 1), (4, 2), (4, 3)]]
    + [(c, 4, 4, s, {"backward_split": True}) for c in TRAIN for s in range(4)]
    + [(c, 4, 4, s, {"recompute": True}) for c in TRAIN for s in range(4)]
    + [("InferenceSchedule", m, 4, s, {}) for m in (1, 4) for s in range(4)]
    + [("InterleavedSchedule", 8, 4, s, {"num_chunks": 2}) for s in range(4)]
    + [("InterleavedInferenceSchedule", 3, 4, s, {"num_chunks": 2}) for s in range(4)]
)


@pytest.mark.parametrize(
    "name,m,stages,stage,kw", STREAMS,
    ids=[f"{n}-M{m}-S{st}-s{s}" + "".join(f"-{k}" for k in kw) for n, m, st, s, kw in STREAMS],
)
def test_flat_commands_equal(name, m, stages, stage, kw):
    """The instruction stream of every stage, command by command."""
    j = JS.flat_commands(getattr(JS, name)(m, stages, stage, **kw))
    t = TS.flat_commands(getattr(TS, name)(m, stages, stage, **kw))
    assert _stream(t) == _stream(j) and len(t) > 0


def test_registry_and_instruction_set_equal():
    assert {k: v.__name__ for k, v in TS.SCHEDULES.items()} == {
        k: v.__name__ for k, v in JS.SCHEDULES.items()
    }
    names = lambda mod: sorted(  # noqa: E731
        n for n, v in vars(mod).items()
        if isinstance(v, type) and issubclass(v, mod.Instruction)
    )
    assert names(TS) == names(JS)
    assert (TL.OP_NOOP, TL.OP_FWD, TL.OP_BWD, TL.OP_BWD_W, TL.OP_RECOMPUTE) == (
        JL.OP_NOOP, JL.OP_FWD, JL.OP_BWD, JL.OP_BWD_W, JL.OP_RECOMPUTE,
    )


ANALYZED = [c for c in CASES if (c[1], c[2]) in [(4, 4), (8, 4), (4, 2)]]


@pytest.mark.parametrize("case", ANALYZED, ids=[_id(c) for c in ANALYZED])
def test_analyze_program_verdicts_equal(case):
    """``analyze_program``'s whole verdict dict on every clean program."""
    j, t = _pair(case)
    assert tcheck.analyze_program(t, program="p") == jcheck.analyze_program(j, program="p")


def _tampered(lower, fields, which):
    """test_analysis.py's tampered GPipe M=4 P=4 tables, built from one
    lowering module's program."""
    base = lower.lower_schedule(fields.GPipeSchedule, 4, 4)
    if which == "unmatched_send":
        rf = np.array(base.read_fwd_slot)
        t, s = np.argwhere(rf != base.n_fwd_slots)[0]
        rf[t, s] = base.n_fwd_slots
        return dataclasses.replace(base, read_fwd_slot=rf)
    if which == "recv_without_send":
        rf = np.array(base.read_fwd_slot)
        rf[0, 2] = 0
        return dataclasses.replace(base, read_fwd_slot=rf)
    if which == "stash_leak":
        sr = np.array(base.stash_read)
        t, s = np.argwhere(sr != base.n_stash_slots)[-1]
        sr[t, s] = base.n_stash_slots
        return dataclasses.replace(base, stash_read=sr)
    if which == "stash_read_before_write":
        sr = np.array(base.stash_read)
        sr[0, 3] = 0
        return dataclasses.replace(base, stash_read=sr)
    if which == "stash_double_write":
        sw = np.array(base.stash_write)
        writes = np.argwhere(sw != base.n_stash_slots)
        (t0, s0), (t1, s1) = writes[0], writes[writes[:, 1] == writes[0][1]][1]
        sw[t1, s1] = sw[t0, s0]
        return dataclasses.replace(base, stash_write=sw)
    raise AssertionError(which)


@pytest.mark.parametrize(
    "which,check",
    [
        ("unmatched_send", "check_send_recv"),
        ("recv_without_send", "check_send_recv"),
        ("stash_leak", "check_stash_lifetime"),
        ("stash_read_before_write", "check_stash_lifetime"),
        ("stash_double_write", "check_stash_lifetime"),
    ],
)
def test_refusals_equal(which, check):
    """The same tampered tables are refused by both packages with the same
    words."""
    jmod = jcheck if check == "check_send_recv" else jstash
    tmod = tcheck if check == "check_send_recv" else tstash
    with pytest.raises(jcheck.ProgramAnalysisError) as je:
        getattr(jmod, check)(_tampered(JL, JS, which))
    with pytest.raises(tcheck.ProgramAnalysisError) as te:
        getattr(tmod, check)(_tampered(TL, TS, which))
    assert str(te.value) == str(je.value)


def test_recompute_peak_drop_equal():
    for name in ("GPipeSchedule", "NaiveParallelSchedule"):
        j = jstash.assert_recompute_peak_drop(
            JL.lower_schedule(getattr(JS, name), 4, 4),
            JL.lower_schedule(getattr(JS, name), 4, 4, recompute=True),
        )
        t = tstash.assert_recompute_peak_drop(
            TL.lower_schedule(getattr(TS, name), 4, 4),
            TL.lower_schedule(getattr(TS, name), 4, 4, recompute=True),
        )
        assert t == j


@pytest.mark.parametrize("name", TRAIN + ("InferenceSchedule",))
@pytest.mark.parametrize("m,p", [(4, 4), (4, 2), (8, 4), (1, 3)])
def test_silent_links_land_in_the_trash_slot(name, m, p):
    """What the port's executor relies on to skip silent links: whenever a
    stage sends nothing on a tick, its neighbour's delivery slot for that
    tick is the trash slot (the JAX executor ships a zero payload there),
    and whenever it sends, the slot is a real one."""
    kw = {"training": False} if name == "InferenceSchedule" else {}
    prog = TL.lower_schedule(getattr(TS, name), m, p, **kw)
    for t in range(prog.num_ticks):
        for s in range(p):
            r, q = (s + 1) % p, (s - 1) % p
            assert (prog.in_fwd_slot[t, r] == prog.n_fwd_slots) == (prog.send_fwd[t, s] == 0)
            assert (prog.in_bwd_slot[t, q] == prog.n_bwd_slots) == (prog.send_bwd[t, s] == 0)
