"""The port's MPMD runtime (``shallowspeed_tpu_torch/parallel/mpmd.py``)
against its lockstep executor and the JAX package's MPMD runner.

- Training parity, the JAX test file's sizes (``SIZES``, B=32, M=4, 2
  batches): on every point of the JAX ``LATTICE``, the recompute lattice
  and the fuzz, the port's MPMD runner ends bitwise on the port's lockstep
  epoch (params, optimizer state, loss), with the JAX runner's dispatch and
  relay counts, and within the cross-engine class ``rtol=2e-4, atol=2e-6``
  of the JAX MPMD runner. Fuzz seed 2 is held to the JAX lockstep
  ``E.make_pipeline_step`` instead (the JAX MPMD runner fails its own
  lockstep test at that seed; ROADMAP §C).
- The admission gate refuses tampered training and inference tables before
  any stage program is built.
- ``stage_cells``, ``planned_programs`` (the JAX set minus the packed
  representation's roles) and ``expected_stage_comms`` equal the JAX
  functions.
- The ``stage.*`` span chain of a traced batch: the JAX runner's names and
  fields, in order.
- A runner asked for ``cuda`` without a GPU raises.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as JM
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.optimizer import SGD as JSGD
from shallowspeed_tpu.optimizer import Adam as JAdam
from shallowspeed_tpu.optimizer import MomentumSGD as JMomentum
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import mpmd as jmpmd
from shallowspeed_tpu.parallel.lowering import lower_schedule as jlower
from shallowspeed_tpu.parallel.mesh import make_mesh as jmesh
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.analysis import ProgramAnalysisError
from shallowspeed_tpu_torch.optimizer import SGD, Adam, MomentumSGD, tree_leaves
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel import mpmd
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

SIZES = (40, 36, 32, 28, 24, 20, 14, 10)  # tests/test_mpmd.py's
RTOL, ATOL = 2e-4, 2e-6  # cross-engine

# optimizer name -> (port, JAX) constructors
OPTS = {
    "sgd": (lambda: SGD(0.01), lambda: JSGD(0.01)),
    "momentum": (lambda: MomentumSGD(0.005, 0.9), lambda: JMomentum(0.005, 0.9)),
    "adam": (lambda: Adam(0.003), lambda: JAdam(0.003)),
}

# tests/test_mpmd.py:33-44: name -> (dp, pp, tp, V, schedule, backward_split, optimizer)
LATTICE = {
    "gpipe-pp4": (1, 4, 1, 1, "GPipeSchedule", False, "sgd"),
    "pipedream-pp4": (1, 4, 1, 1, "PipeDreamFlushSchedule", False, "sgd"),
    "dp2-gpipe": (2, 2, 1, 1, "GPipeSchedule", False, "momentum"),
    "bsplit-pp4": (1, 4, 1, 1, "GPipeSchedule", True, "sgd"),
    "tp2-pp2": (1, 2, 2, 1, "GPipeSchedule", False, "sgd"),
    "interleaved-V2": (1, 2, 1, 2, "InterleavedSchedule", False, "sgd"),
    "dp2-pp2-tp2": (2, 2, 2, 1, "PipeDreamFlushSchedule", False, "momentum"),
}

# tests/test_mpmd.py's recompute lattice: name -> (dp, pp, tp, schedule, split, optimizer, act)
RECOMPUTE_LATTICE = {
    "gpipe-pp4-recompute": (1, 4, 1, "GPipeSchedule", False, "sgd", "relu"),
    "pd-pp4-split-recompute-gelu": (1, 4, 1, "PipeDreamFlushSchedule", True, "sgd", "gelu"),
    "dp2-pp2-recompute": (2, 2, 1, "GPipeSchedule", False, "momentum", "relu"),
    "tp2-pp2-recompute-gelu": (1, 2, 2, "GPipeSchedule", False, "sgd", "gelu"),
}


def _data(sizes, B, batches, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(batches, B, sizes[0]).astype(np.float32)
    Y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], (batches, B))]
    return X, Y


def _port_pair(dp, pp, tp, V, sched, bsplit, opt, sizes, M, B, X, Y, recompute, act):
    """The port's lockstep epoch and MPMD runner over the same batches:
    (lockstep leaves, its state leaves, its loss, the MPMD leaves, state
    leaves, loss, runner)."""
    spec = TM.make_model_spec(sizes, pp * V, B, act=act)
    mesh = VirtualMesh(dp, pp, "cpu", tp=tp)
    order = TE.interleave_order(pp * V, pp) if V > 1 else None
    prog = tlower(getattr(TS, sched), M, pp, virtual=V, backward_split=bsplit,
                  recompute=recompute)
    o = OPTS[opt][0]()
    st, fl = TE.init_stacked(spec, mesh, order=order)
    ost = o.init(st)
    epoch = TE.make_pipeline_epoch(mesh, spec, prog, B // dp // M, o)
    st, ost, loss = epoch(st, fl, ost, torch.from_numpy(X), torch.from_numpy(Y))
    st2, fl2 = TE.init_stacked(spec, mesh, order=order)
    ost2 = o.init(st2)
    runner = mpmd.MpmdTrainRunner(mesh, spec, prog, B // dp // M, o)
    st2, ost2, loss2 = runner.run(st2, fl2, ost2, X, Y)
    return (tree_leaves(st), tree_leaves(ost), loss, tree_leaves(st2), tree_leaves(ost2),
            loss2, runner)


def _jax_mpmd(dp, pp, tp, V, sched, bsplit, opt, sizes, M, B, X, Y, recompute, act):
    """The JAX MPMD runner over the same batches: (leaves, runner)."""
    spec = JM.make_model_spec(sizes, pp * V, B, act=act)
    mesh = jmesh(dp, pp, tp=tp)
    order = JE.interleave_order(pp * V, pp) if V > 1 else None
    prog = jlower(getattr(JS, sched), M, pp, virtual=V, backward_split=bsplit,
                  recompute=recompute)
    o = OPTS[opt][1]()
    st, fl = JE.init_stacked(spec, mesh, order=order)
    runner = jmpmd.MpmdTrainRunner(mesh, spec, prog, B // dp // M, o)
    st, _, _ = runner.run(st, fl, o.init(st), X, Y)
    return [np.asarray(a) for a in jax.tree.leaves(jax.device_get(st))], runner


def _jax_lockstep(dp, pp, tp, V, sched, bsplit, opt, sizes, M, B, X, Y, recompute, act):
    """The JAX lockstep step over the same batches: the leaves."""
    spec = JM.make_model_spec(sizes, pp * V, B, act=act)
    mesh = jmesh(dp, pp, tp=tp)
    order = JE.interleave_order(pp * V, pp) if V > 1 else None
    prog = jlower(getattr(JS, sched), M, pp, virtual=V, backward_split=bsplit,
                  recompute=recompute)
    o = OPTS[opt][1]()
    st, fl = JE.init_stacked(spec, mesh, order=order)
    ost = o.init(st)
    step = JE.make_pipeline_step(mesh, spec, prog, B // dp // M, o)
    for i in range(len(X)):
        st, ost, _ = step(st, fl, ost, jnp.asarray(X[i]), jnp.asarray(Y[i]))
    return [np.asarray(a) for a in jax.tree.leaves(jax.device_get(st))]


def _check(label, layout, sizes=SIZES, M=4, B=32, batches=2, data_seed=0, recompute=False,
           act="relu", oracle="mpmd"):
    X, Y = _data(sizes, B, batches, data_seed)
    args = layout + (sizes, M, B, X, Y, recompute, act)
    lock, lock_st, lock_loss, got, got_st, got_loss, runner = _port_pair(*args)
    assert runner.admission["findings"] == 0 and runner.dispatch_count > 0
    for a, b in zip(lock, got):
        assert torch.equal(a, b), label
    assert len(lock_st) == len(got_st)
    for a, b in zip(lock_st, got_st):
        assert torch.equal(a, b), label
    assert torch.equal(lock_loss, got_loss), label
    if oracle == "mpmd":
        want, jrunner = _jax_mpmd(*args)
        assert (runner.dispatch_count, runner.relay_count) == (
            jrunner.dispatch_count, jrunner.relay_count), label
    else:
        want = _jax_lockstep(*args)
    assert len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("layout", sorted(LATTICE))
def test_mpmd_bitwise_lockstep_and_close_to_jax(layout):
    """Every point of the JAX lattice: the MPMD runner's weights, state and
    loss are bitwise the lockstep epoch's, its counts the JAX runner's, its
    weights within the cross-engine class of the JAX MPMD runner's."""
    _check(layout, LATTICE[layout])


@pytest.mark.parametrize(
    "layout",
    [lay if lay.startswith("gpipe") else pytest.param(lay, marks=pytest.mark.slow)
     for lay in sorted(RECOMPUTE_LATTICE)],
)
def test_mpmd_recompute_bitwise_lockstep_and_close_to_jax(layout):
    """recompute programs: the no-stash forward and recompute roles, bitwise
    the lockstep recompute epoch (the gpipe point in tier 1, as in the JAX
    file)."""
    dp, pp, tp, sched, bsplit, opt, act = RECOMPUTE_LATTICE[layout]
    _check(layout, (dp, pp, tp, 1, sched, bsplit, opt), recompute=True, act=act)


@pytest.mark.parametrize(
    "seed", [s if s not in (1, 4) else pytest.param(s, marks=pytest.mark.slow) for s in range(6)]
)
def test_mpmd_fuzz_bitwise_lockstep(seed):
    """The JAX file's random lattice (sizes, mesh, schedule, split,
    optimizer): bitwise the port's lockstep; within the cross-engine class
    of the JAX MPMD runner, at seed 2 of the JAX lockstep step."""
    rng = np.random.RandomState(7000 + seed)
    dp, pp = [(2, 2), (1, 4), (2, 1)][seed % 3]
    tp = 2 if seed % 2 == 0 and dp * pp <= 4 else 1
    V = 2 if seed % 3 == 2 and pp > 1 else 1
    sched = (
        "InterleavedSchedule" if V > 1
        else ["GPipeSchedule", "PipeDreamFlushSchedule", "NaiveParallelSchedule"][seed % 3]
    )
    bsplit = V == 1 and bool(seed % 2)
    opt = ["sgd", "momentum", "adam"][seed % 3]
    n_sizes = pp * V * int(rng.randint(2, 4))
    widths = sorted(rng.randint(8, 48, size=n_sizes - 1).tolist(), reverse=True)
    sizes = tuple(widths) + (int(rng.randint(4, min(8, min(widths)) + 1)),)
    M = int(pp * rng.choice([1, 2]))
    B = int(dp * M * rng.choice([4, 8]))
    _check(
        f"seed={seed} dp={dp} pp={pp} tp={tp} V={V} bsplit={bsplit}",
        (dp, pp, tp, V, sched, bsplit, opt), sizes=sizes, M=M, B=B, data_seed=8000 + seed,
        oracle="lockstep" if seed == 2 else "mpmd",
    )


def test_tampered_tables_refused_before_any_stage_program(monkeypatch):
    """The admission gate runs first: a training table with one forward
    send erased and an inference table with a consuming read dropped are
    refused before any stage program is built."""
    spec = TM.make_model_spec(SIZES, 4, 32)
    mesh = VirtualMesh(1, 4, "cpu")
    prog = tlower(TS.GPipeSchedule, 4, 4)
    send_fwd = np.array(prog.send_fwd)
    t, s = np.argwhere(send_fwd == 1)[0]
    send_fwd[t, s] = 0
    bad = dataclasses.replace(prog, send_fwd=send_fwd)

    def no_build(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("stage programs built before the admission gate")

    monkeypatch.setattr(mpmd, "_StagePrograms", no_build)
    with pytest.raises(ProgramAnalysisError):
        mpmd.MpmdTrainRunner(mesh, spec, bad, 8, SGD(0.01))
    iprog = tlower(TS.InferenceSchedule, 2, 4, training=False)
    rf = np.array(iprog.read_fwd_slot)
    hit = np.argwhere(rf != iprog.n_fwd_slots)[0]
    rf[hit[0], hit[1]] = iprog.n_fwd_slots
    with pytest.raises(ProgramAnalysisError):
        mpmd.MpmdInferenceRunner(mesh, spec, dataclasses.replace(iprog, read_fwd_slot=rf), 8)
    # the untampered tables pass the gate (and reach the builder)
    with pytest.raises(AssertionError, match="before the admission gate"):
        mpmd.MpmdTrainRunner(mesh, spec, prog, 8, SGD(0.01))


PLAN_LAYOUTS = [
    # (dp, pp, tp, V, schedule, split, recompute)
    (1, 4, 1, 1, "GPipeSchedule", False, False),
    (1, 4, 1, 1, "PipeDreamFlushSchedule", True, False),
    (1, 4, 1, 1, "GPipeSchedule", False, True),
    (1, 2, 1, 2, "InterleavedSchedule", False, False),
    (2, 2, 2, 1, "NaiveParallelSchedule", False, False),
]


@pytest.mark.parametrize("layout", PLAN_LAYOUTS, ids=lambda l: "-".join(map(str, l)))
def test_stage_cells_and_planned_programs_equal_jax(layout):
    """The host plan and the program set are the JAX runner's (minus the
    pack/unpack/state_pack/state_unpack roles of its packed representation),
    and each label is the JAX label."""
    dp, pp, tp, V, sched, split, rec = layout
    M, B = 4, 32
    tprog = tlower(getattr(TS, sched), M, pp, virtual=V, backward_split=split, recompute=rec)
    jprog = jlower(getattr(JS, sched), M, pp, virtual=V, backward_split=split, recompute=rec)
    assert mpmd.stage_cells(tprog) == jmpmd.stage_cells(jprog)
    tspec = TM.make_model_spec(SIZES, pp * V, B)
    jspec = JM.make_model_spec(SIZES, pp * V, B)
    mb = B // dp // M
    tr = mpmd.MpmdTrainRunner(VirtualMesh(dp, pp, "cpu", tp=tp), tspec, tprog, mb, Adam(0.01))
    jr = jmpmd.MpmdTrainRunner(jmesh(dp, pp, tp=tp), jspec, jprog, mb, JAdam(0.01))
    packed = ("pack", "unpack", "state_pack", "state_unpack")
    want = [k for k in jr.planned_programs() if k[1] not in packed]
    assert tr.planned_programs() == want
    for key in want:
        assert tr.programs.label(*key) == jr.programs.label(*key)


@pytest.mark.parametrize("dp,tp", [(1, 1), (1, 2), (2, 2)])
def test_expected_stage_comms_equal_jax(dp, tp):
    """The per-stage comms contract for every role the port has, both
    ``sends`` values; the packed representation's roles are unknown here."""
    tspec = TM.make_model_spec((24, 20, 18, 16), 2, 16 * dp)
    jspec = JM.make_model_spec((24, 20, 18, 16), 2, 16 * dp)
    roles = ("fwd", "fwd_ns", "recompute", "bwd", "bwd_in", "bwd_w", "update",
             "loss_sync", "infer_fwd")
    for role in roles:
        for sends in (True, False):
            assert mpmd.expected_stage_comms(role, tspec, dp, tp, sends=sends) == (
                jmpmd.expected_stage_comms(role, jspec, dp, tp, sends=sends)
            ), (role, sends)
    for role in ("pack", "state_unpack", "zigzag"):
        with pytest.raises(ValueError, match="unknown stage-program role"):
            mpmd.expected_stage_comms(role, tspec, dp, tp)


class _SpanSink:
    """A recorder that keeps every trace record."""

    enabled = True

    def __init__(self):
        self.records = []

    def trace(self, name, **fields):
        self.records.append(dict(fields, name=name))


def _span_chain(records):
    """(name, trace_id, terminal, fields) per span, without the clock and
    the span ids."""
    drop = {"t0", "t1", "span_id", "parent_id", "clock", "replica_id", "name", "trace_id",
            "terminal"}
    return [
        (r["name"], r["trace_id"], r["terminal"], {k: v for k, v in r.items() if k not in drop})
        for r in records
    ]


@pytest.mark.parametrize("split", [False, True], ids=["combined", "split"])
def test_stage_span_chain_equals_jax(split):
    """A traced run (``trace_batches=1``): one chain for the first batch,
    ``stage.dispatch``/``stage.relay`` spans with the JAX runner's names and
    fields in the JAX runner's order, the last update the terminal."""
    from shallowspeed_tpu.observability.tracing import Tracer as JTracer
    from shallowspeed_tpu_torch.observability.tracing import Tracer as TTracer

    M, B, pp = 4, 32, 4
    X, Y = _data(SIZES, B, 2, 0)
    tsink, jsink = _SpanSink(), _SpanSink()
    tspec = TM.make_model_spec(SIZES, pp, B)
    tmesh = VirtualMesh(1, pp, "cpu")
    tprog = tlower(TS.PipeDreamFlushSchedule, M, pp, backward_split=split)
    st, fl = TE.init_stacked(tspec, tmesh)
    tr = mpmd.MpmdTrainRunner(tmesh, tspec, tprog, B // M, SGD(0.01),
                              tracer=TTracer(tsink, process="m"))
    tr.run(st, fl, (), X, Y, trace_id="mpmd-0")
    jspec = JM.make_model_spec(SIZES, pp, B)
    jm = jmesh(1, pp)
    jprog = jlower(JS.PipeDreamFlushSchedule, M, pp, backward_split=split)
    jst, jfl = JE.init_stacked(jspec, jm)
    jr = jmpmd.MpmdTrainRunner(jm, jspec, jprog, B // M, JSGD(0.01),
                               tracer=JTracer(jsink, process="m"))
    jr.run(jst, jfl, (), X, Y, trace_id="mpmd-0")
    got, want = _span_chain(tsink.records), _span_chain(jsink.records)
    assert got == want
    assert {r["trace_id"] for r in tsink.records} == {"mpmd-0-b0"}
    assert got[-1][0] == "stage.dispatch" and got[-1][2] and got[-1][3]["op"] == "update"
    assert sum(name == "stage.relay" for name, *_ in got) == tr.relay_count // 2


def test_runner_on_cuda_without_a_gpu_raises(monkeypatch):
    """A runner whose mesh names ``cuda`` raises where no GPU is present
    (``resolve_device``); it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TM.make_model_spec(SIZES, 4, 32)
    mesh = types.SimpleNamespace(dp=1, pp=4, device=torch.device("cuda"), shape={"dp": 1, "pp": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpmd.MpmdTrainRunner(mesh, spec, tlower(TS.GPipeSchedule, 4, 4), 8, SGD(0.01))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpmd.MpmdInferenceRunner(
            mesh, spec, tlower(TS.InferenceSchedule, 1, 4, training=False), 8
        )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh(1, 4, "cuda")


def test_stage_views_are_rows_and_reassemble_in_place():
    """Stage views are row slices of the stacked tensors (writing one
    writes the session's rows), and the reassembly is the identity; a view
    of another tensor is refused."""
    spec = TM.make_model_spec(SIZES, 4, 32)
    mesh = VirtualMesh(1, 2, "cpu")
    st, fl = TE.init_stacked(spec, mesh, order=TE.interleave_order(4, 2))
    views = [mpmd.stage_param_view(st, s, 2) for s in range(2)]
    views[1]["W"][0][0].fill_(3.0)
    assert torch.all(st["W"][0][2] == 3.0)
    assert mpmd.full_param_from_stage(views, st) is st
    copy = {k: tuple(a.clone() for a in st[k]) for k in ("W", "b")}
    with pytest.raises(ValueError, match="not its rows"):
        mpmd.full_param_from_stage(views, copy)
    fv = mpmd.stage_flags_view(fl, 1, 2, torch.device("cpu"))
    assert fv["active"] == np.asarray(fl["active"])[2:4].tolist()
    assert fv["head_mask"].dtype == torch.bool and fv["head_mask"].shape[0] == 2
    opt = Adam(0.01)
    state = opt.init(st)
    sv = [mpmd.stage_state_view(opt, state, s, 2) for s in range(2)]
    assert sv[0]["t"] is state["t"] and sv[1]["m"]["W"][0].data_ptr() == state["m"]["W"][0][2].data_ptr()
    sv[1]["t"] = state["t"] + 1.0
    sv[0]["t"] = state["t"] + 1.0
    full = mpmd.full_state_from_stage(opt, sv, state)
    assert full["m"] is state["m"] and full["t"] is sv[0]["t"]
    assert mpmd.stage_state_view(SGD(0.1), (), 0, 2) == ()
