"""The port's fault-injection harness against the JAX package's: the spec
grammar, the plan's queries, the corruption helpers and the poisons.

``faults.py`` is a copy, so the same spec must parse to the same plan (or
fail with the same message), the same seed must touch the same byte
offsets, and ``nan``/``flip`` must land on the same logical element — flat
element 0 of global layer 0's W — on both layouts.
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu import faults as jfaults
from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu.parallel import executor as jexec
from shallowspeed_tpu_torch import faults as tfaults
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)

GOOD_SPECS = [
    "",
    "die@step=7",
    "die@step=7:mode=sigkill",
    "nan@step=3",
    "flip@step=0",
    "die@step=9,nan@step=3",
    " nan@step=3 , die@step=3 ,flip@step=3",
    "error@dispatch=4",
    "slow@dispatch=6:ms=50",
    "nan@dispatch=8,die@dispatch=2:mode=exc",
    "die@save=2:mode=sigkill",
    "slow@save=1:ms=200",
    "corrupt@save=3",
    "die@step=11,corrupt@save=1,slow@dispatch=0:ms=0.5",
]
BAD_SPECS = [
    "boom@step=1",
    "die",
    "die@step=-1",
    "die@step=x",
    "die@step=1:mode=gentle",
    "nan@step=1:mode=exc",
    "nan@step=1:ms=5",
    "slow@dispatch=1",
    "slow@dispatch=1:ms=-2",
    "error@step=1",
    "flip@dispatch=1",
    "corrupt@step=1",
    "nan@save=1",
    "die@step=1:dispatch=2",
    "die@step=1:color=red",
    "die@save=-3",
]


def _plan_fields(plan):
    return [
        (repr(f), f.kind, f.step, f.dispatch, f.save, f.mode, f.ms, f.trigger)
        for f in plan.faults
    ]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_spec_parses_as_in_jax(spec):
    ours, theirs = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert _plan_fields(ours) == _plan_fields(theirs)
    assert bool(ours) == bool(theirs)
    for plan in (ours, theirs):
        # the plan's queries, read as one record per fault
        plan.summary = (
            [repr(f) for f in plan.pending],
            [repr(f) for f in plan.pending_dispatch],
            [repr(f) for f in plan.pending_save],
            [repr(f) for f in plan.due_at_save(1)],
            [repr(f) for f in plan.due_at_dispatch(4)],
            repr(plan.first_in(0, 10)),
            repr(plan.first_in(4, 12)),
        )
    assert ours.summary == theirs.summary


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_spec_fails_as_in_jax(spec):
    with pytest.raises(ValueError) as theirs:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        tfaults.FaultPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


def test_env_plan_make_plan_and_die(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_VAR, "die@step=5,nan@step=2")
    assert tfaults.ENV_VAR == jfaults.ENV_VAR == "SHALLOWSPEED_FAULTS"
    assert (tfaults.KINDS, tfaults.SERVING_KINDS, tfaults.SAVE_KINDS, tfaults.DIE_MODES) == (
        jfaults.KINDS, jfaults.SERVING_KINDS, jfaults.SAVE_KINDS, jfaults.DIE_MODES,
    )
    plan = tfaults.make_plan(None)
    assert [repr(f) for f in plan.faults] == ["die@step=5:mode=exc", "nan@step=2"]
    assert tfaults.make_plan(plan) is plan
    assert repr(tfaults.make_plan("flip@step=1").faults[0]) == "flip@step=1"
    assert _plan_fields(tfaults.from_env({"HOME": "/"})) == []
    with pytest.raises(tfaults.InjectedFault, match="die@step=5"):
        plan.fire_die(plan.faults[0])
    assert plan.faults[0].fired and [f.step for f in plan.pending] == [2]
    # sigkill parses; it is fired only in a subprocess (test_torch_recovery)
    assert tfaults.FaultPlan.parse("die@step=1:mode=sigkill").faults[0].mode == "sigkill"


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_corruption_helpers_touch_the_jax_offsets(tmp_path, seed):
    """``corrupt_checkpoint_bytes`` and ``corrupt_buffer`` flip the same
    offsets as the JAX package's for the same seed, and the same bytes."""
    payload = np.random.RandomState(seed).bytes(4096)
    paths = [tmp_path / "ours.bin", tmp_path / "theirs.bin"]
    for p in paths:
        p.write_bytes(payload)
    offs = tfaults.corrupt_checkpoint_bytes(paths[0], seed=seed)
    assert offs == jfaults.corrupt_checkpoint_bytes(paths[1], seed=seed)
    assert paths[0].read_bytes() == paths[1].read_bytes() != payload
    assert all(o >= 64 for o in offs) and len(offs) == 16

    def buffer():
        rng = np.random.RandomState(seed)
        return {"b0": rng.randn(3).astype(np.float32), "w0": rng.randn(4, 5).astype(np.float32)}

    ours, theirs = buffer(), buffer()
    ro = ours["b0"]
    ro.setflags(write=False)  # a read-only view must not stop the injection
    assert tfaults.corrupt_buffer(ours, seed=seed) == jfaults.corrupt_buffer(theirs, seed=seed)
    for k in ours:
        assert ours[k].tobytes() == theirs[k].tobytes()
    assert ours["b0"].tobytes() != ro.tobytes()


def _jax_poisoned(fn, spec, layout):
    """The JAX poison on the JAX layout's tree, read back as logical host
    arrays."""
    logical = jmodel.init_model(spec)
    if layout == "sequential":
        return [[{k: np.asarray(v) for k, v in l.items()} for l in st] for st in fn(logical)]
    stacked, _ = jexec.stack_params(logical, spec)
    return jexec.unstack_params(fn(stacked), spec)


@pytest.mark.parametrize(
    "layout", ["sequential", "dp2xpp4"],
)
def test_poisons_land_on_the_jax_element(layout):
    """``nan`` and ``flip`` change exactly the logical element the JAX
    package's do — global layer 0's W[0, 0] — and ``flip`` leaves the same
    bits."""
    mesh = dict(dp=2, pp=4) if layout == "dp2xpp4" else {}
    jspec = jmodel.make_model_spec(SIZES, 4 if mesh else 1, 32)
    for hook, jfn in (("poison_weights", jfaults.poison_nan), ("flip_weights", jfaults.poison_bitflip)):
        ts = TorchSession(device="cpu", sizes=SIZES, global_batch_size=32, **mesh)
        init = ts.params()
        getattr(ts, hook)()
        ours, theirs = ts.params(), _jax_poisoned(jfn, jspec, layout)
        changed = []
        for s, (s0, so, st) in enumerate(zip(init, ours, theirs)):
            for l, (l0, lo, lt) in enumerate(zip(s0, so, st)):
                for k in ("W", "b"):
                    assert lo[k].tobytes() == lt[k].tobytes(), (hook, s, l, k)
                    diff = np.argwhere(lo[k].view(np.uint32) != l0[k].view(np.uint32))
                    changed += [(s, l, k, tuple(i)) for i in diff]
        assert changed == [(0, 0, "W", (0, 0))], hook


def test_poison_writes_into_the_tensor_the_next_step_reads():
    """In place: the session's live tensor, not a rebound copy."""
    ts = TorchSession(device="cpu", sizes=SIZES, global_batch_size=32)
    live = ts._params[0].W[0]
    ts.poison_weights()
    assert torch.isnan(live[0, 0]) and torch.isfinite(live.view(-1)[1:]).all()
    with pytest.raises(ValueError, match="no tensor leaf"):
        tfaults.poison_nan([[{}]])
    with pytest.raises(ValueError, match="float32"):
        tfaults.poison_bitflip([torch.zeros(2, dtype=torch.float64)])
