"""The batch step's CUDA graph (``trainer.StepGraph``) on the CPU.

The key (``trainer.step_graph_key``) is a pure function of the state and
the inputs; on CPU tensors the wrapped step is the unwrapped one, bit for
bit. The graph's policy (when it captures, replays, drops, refuses) runs
here with a stand-in for the CUDA capture, ``_FakeGraph``: its capture
executes nothing and its replay runs the step again on the graph's static
buffers, as the card's replay reruns the captured work. The card's own
graph is held to the eager step in ``chip_smoke.py`` (phase 7b). The whole
file takes about 6 s on one worker, 4 of them ``import torch``.
"""

import logging
import sys
import threading

import numpy as np
import pytest
import torch

from shallowspeed_tpu_torch import convert, cuda_ops, trainer
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import optimizer as topt
from shallowspeed_tpu_torch.observability import spans

SIZES = (20, 16, 15, 12, 10)
B, M = 32, 4
STEPS = 8


def _session(opt_name, lr=0.05):
    spec = tmodel.make_model_spec(SIZES, 1, B)
    params = convert.params_from_numpy(tmodel.init_model(spec), "cpu")
    opt = topt.make_optimizer(opt_name, lr)
    return spec, params, opt, opt.init(tmodel.param_tree(params))


def _batches(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, M, B // M, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], (n, M, B // M))]
    return torch.from_numpy(X), torch.from_numpy(Y)


def _leaves(params, state):
    return [t.clone() for t in topt.tree_leaves(tmodel.param_tree(params))] + [
        t.clone() for t in topt.tree_leaves(state)
    ]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _drive(step, params, state, X, Y):
    """``step`` over every batch, each loss read before the next call."""
    losses = []
    for xb, yb in zip(X, Y):
        params, state, loss = step(params, state, xb, yb)[:3]
        losses.append(loss.clone())
    return params, state, torch.stack(losses)


class _FakeGraph:
    """A captured graph's stand-in: ``replay`` reruns the captured step on
    the static buffers and writes its loss into the static loss tensor.
    The wrappers it runs count no launch, as a replay runs no wrapper."""

    def __init__(self, run):
        self.run = run
        self.loss = torch.zeros(())

    def replay(self):
        before = dict(cuda_ops.LAUNCHES)
        self.loss.copy_(self.run()[2])
        cuda_ops.LAUNCHES.update(before)


@pytest.fixture
def engaged(monkeypatch):
    """The graph engages on CPU tensors, captured by ``_FakeGraph``;
    yields the list of captures asked for."""
    recorded = []

    def record(self, run, device):
        recorded.append(device)
        graph = _FakeGraph(run)
        return graph, (None, None, graph.loss)

    monkeypatch.setattr(trainer.StepGraph, "_on_card", staticmethod(lambda xb: True))
    monkeypatch.setattr(trainer.StepGraph, "_record", record)
    return recorded


def test_key_is_a_pure_function_of_state_and_inputs(monkeypatch):
    """Stable across calls on the same tensors; changes on a rebound leaf,
    a new shape and another stream (~0.1 s). A step with aux outputs never
    engages, so its flags are no part of the key (tested below)."""
    _, params, _, state = _session("momentum")
    X, Y = _batches(2)
    key = trainer.step_graph_key(params, state, X[0], Y[0])
    assert trainer.step_graph_key(params, state, X[0], Y[0]) == key
    assert trainer.step_graph_key(params, state, X[1], Y[1]) == key  # other rows, same shapes
    rebound = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    assert trainer.step_graph_key(rebound, state, X[0], Y[0]) != key
    state[0][0]["W"] = state[0][0]["W"].clone()
    assert trainer.step_graph_key(params, state, X[0], Y[0]) != key
    state = topt.make_optimizer("momentum", 0.05).init(tmodel.param_tree(params))
    key = trainer.step_graph_key(params, state, X[0], Y[0])
    assert trainer.step_graph_key(params, state, X[0, :2], Y[0, :2]) != key
    streams = []
    for handle in (1, 2):
        monkeypatch.setattr(trainer, "_current_stream", lambda t, h=handle: h)
        streams.append(trainer.step_graph_key(params, state, X[0], Y[0]))
    assert key not in streams and streams[0] != streams[1]
    monkeypatch.undo()
    assert trainer.step_graph_key(params, state, X[0], Y[0]) == key


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("fuse", [False, True], ids=["loop", "fused"])
@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam"])
def test_cpu_wrapped_step_is_the_unwrapped_step(opt_name, fuse, clip):
    """On CPU tensors the graph never engages: the wrapped step gives the
    unwrapped step's bits, loss by loss (~0.1 s a case)."""
    X, Y = _batches()
    spec, p_a, opt, s_a = _session(opt_name)
    _, p_b, _, s_b = _session(opt_name)
    step = trainer._make_batch_step(spec, opt, fuse_mubatches=fuse, clip_norm=clip)
    p_a, s_a, la = _drive(step, p_a, s_a, X, Y)
    p_b, s_b, lb = _drive(step.graph.step, p_b, s_b, X, Y)
    assert torch.equal(la, lb)
    _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))
    assert step.graph.graph is step.graph.key is step.graph.held is None


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("fuse", [False, True], ids=["loop", "fused"])
@pytest.mark.parametrize("opt_name", ["sgd", "momentum"])
def test_graphed_steps_are_the_eager_steps(engaged, opt_name, fuse, clip):
    """With the graph engaged: call 1 eager, call 2 captures and replays,
    calls 3-8 replay; weights, state and every loss bitwise the eager
    steps', one capture, seven replays, in the program trace too
    (~0.1 s a case)."""
    X, Y = _batches()
    spec, p_a, opt, s_a = _session(opt_name)
    _, p_b, _, s_b = _session(opt_name)
    step = trainer._make_batch_step(spec, opt, fuse_mubatches=fuse, clip_norm=clip)
    with spans.recording() as tr:
        p_a, s_a, la = _drive(step, p_a, s_a, X, Y)
    eager = trainer._make_batch_step(spec, opt, fuse_mubatches=fuse, clip_norm=clip)
    p_b, s_b, lb = _drive(eager.graph.step, p_b, s_b, X, Y)
    assert torch.equal(la, lb)
    _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))
    assert len(engaged) == 1
    assert tr.counters["trainer.graph_captures"] == 1
    assert tr.counters["trainer.graph_replays"] == STEPS - 1
    assert sum(1 for r in tr.spans if r[0] == "trainer.step") == STEPS


def test_replay_counts_the_captured_launches(monkeypatch):
    """A replay adds the launches its capture counted, per entry, and the
    capture's own are taken back: N calls count N eager steps' launches
    (~0.01 s)."""

    def step(params, opt_state, xb, yb):
        for entry in ("linear_act_fwd",) * 3 + ("linear_act_bwd",) * 2:
            cuda_ops._count(entry)  # what each wrapper's launch counts
        return params, opt_state, xb.sum()

    def record(self, run, device):
        graph = _FakeGraph(run)
        run()  # a capture runs the step's host code, wrappers and all
        return graph, (None, None, graph.loss)

    monkeypatch.setattr(trainer.StepGraph, "_on_card", staticmethod(lambda xb: True))
    monkeypatch.setattr(trainer.StepGraph, "_record", record)
    _, params, _, state = _session("sgd")
    X, Y = _batches()
    before = dict(cuda_ops.LAUNCHES)
    g = trainer.StepGraph(step)
    with spans.recording() as tr:
        _drive(g, params, state, X, Y)
    got = {k: cuda_ops.LAUNCHES[k] - n for k, n in before.items()}
    one = dict.fromkeys(cuda_ops.LAUNCHES, 0)
    one.update(linear_act_fwd=3, linear_act_bwd=2)
    assert got == {k: n * STEPS for k, n in one.items()}
    assert g.launches == one
    assert tr.counters["trainer.graph_replays"] == STEPS - 1


@pytest.mark.parametrize("fuse", [False, True], ids=["loop", "fused"])
def test_a_rebinding_optimizer_is_never_held(engaged, fuse):
    """Adam rebinds ``t`` every step, so no call leaves its key standing:
    nothing is held, nothing captured, every step eager and bitwise the
    unwrapped step's (~0.1 s a case)."""
    X, Y = _batches()
    spec, p_a, opt, s_a = _session("adam")
    _, p_b, _, s_b = _session("adam")
    step = trainer._make_batch_step(spec, opt, fuse_mubatches=fuse)
    for xb, yb in zip(X, Y):
        p_a, s_a, _ = step(p_a, s_a, xb, yb)
        assert step.graph.held is None
    p_b, s_b, _ = _drive(step.graph.step, p_b, s_b, X, Y)
    _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))
    assert engaged == []


@pytest.mark.parametrize("aux", ["with_grad_norm", "with_digests", "with_step_stats"])
def test_steps_with_aux_outputs_never_engage(engaged, aux):
    """A step built with aux outputs keeps its per-step tensors across
    steps, so it never captures: the epoch's aux and weights are the
    unwrapped step's (~0.2 s a case)."""
    X, Y = _batches()
    spec, p_a, opt, s_a = _session("sgd")
    _, p_b, _, s_b = _session("sgd")
    epoch = trainer.make_train_epoch(spec, opt, clip_norm=0.5, **{aux: True})
    p_a, s_a, la, aux_a = epoch(p_a, s_a, X, Y)
    assert engaged == []
    if aux != "with_step_stats":
        step = trainer._make_batch_step(spec, opt, clip_norm=0.5, **{aux: True})
        for xb, yb in zip(X, Y):
            step(p_b, s_b, xb, yb)
        assert step.graph.held is None and engaged == []
        _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))


def test_a_new_key_drops_the_graph_and_recaptures(engaged):
    """Rebinding every leaf (as ``load_weights`` does) runs the next call
    eagerly and drops the graph; its repeat captures again. Weights stay
    bitwise the eager steps' through the swap (~0.1 s)."""
    X, Y = _batches()
    spec, p_a, opt, s_a = _session("momentum")
    _, p_b, _, s_b = _session("momentum")
    step = trainer._make_batch_step(spec, opt)
    eager = step.graph.step
    half = STEPS // 2
    with spans.recording() as tr:
        p_a, s_a, _ = _drive(step, p_a, s_a, X[:half], Y[:half])
        p_b, s_b, _ = _drive(eager, p_b, s_b, X[:half], Y[:half])
        assert step.graph.key is not None
        host = convert.params_to_numpy(p_b)
        p_a = convert.params_from_numpy(host, "cpu")
        p_b = convert.params_from_numpy(host, "cpu")
        p_a, s_a, _ = step(p_a, s_a, X[half], Y[half])
        assert step.graph.graph is None and len(engaged) == 1
        p_b, s_b, _ = eager(p_b, s_b, X[half], Y[half])
        p_a, s_a, la = _drive(step, p_a, s_a, X[half + 1:], Y[half + 1:])
        p_b, s_b, lb = _drive(eager, p_b, s_b, X[half + 1:], Y[half + 1:])
    assert torch.equal(la, lb)
    _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))
    assert tr.counters["trainer.graph_captures"] == 2
    assert tr.counters["trainer.graph_replays"] == STEPS - 2


def test_a_failed_capture_runs_eagerly_and_is_logged_once(monkeypatch, caplog):
    """A capture that raises leaves the state as it was; the key runs
    eagerly from then on, with one log line and no second attempt
    (~0.1 s)."""
    tries = []

    def refuse(self, run, device):
        tries.append(device)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(trainer.StepGraph, "_on_card", staticmethod(lambda xb: True))
    monkeypatch.setattr(trainer.StepGraph, "_record", refuse)
    X, Y = _batches()
    spec, p_a, opt, s_a = _session("sgd")
    _, p_b, _, s_b = _session("sgd")
    step = trainer._make_batch_step(spec, opt)
    before = dict(cuda_ops.LAUNCHES)
    with caplog.at_level(logging.WARNING, logger=trainer.__name__):
        p_a, s_a, la = _drive(step, p_a, s_a, X, Y)
    p_b, s_b, lb = _drive(step.graph.step, p_b, s_b, X, Y)
    assert torch.equal(la, lb)
    _assert_bitwise(_leaves(p_a, s_a), _leaves(p_b, s_b))
    assert len(tries) == 1 and len(step.graph.refused) == 1
    assert len([r for r in caplog.records if "capture" in r.getMessage()]) == 1
    assert step.graph.graph is None
    assert dict(cuda_ops.LAUNCHES) == before


def test_a_capture_tallies_only_its_own_threads_launches():
    """While one thread captures, another thread's launches still count in
    ``LAUNCHES`` and never in the capture's tally, under a short switch
    interval (~0.5 s)."""
    n_capture, n_other = 20000, 30000
    before = dict(cuda_ops.LAUNCHES)
    started, tallies = threading.Event(), []

    def capture():
        with cuda_ops.capture_launches() as counts:
            started.set()
            for _ in range(n_capture):
                cuda_ops._count("linear_act_fwd")
        tallies.append(counts)

    def other():
        started.wait(timeout=10)
        for _ in range(n_other):
            cuda_ops._count("linear_act_bwd")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capture), threading.Thread(target=other)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tallies[0] == dict.fromkeys(cuda_ops.LAUNCHES, 0) | {"linear_act_fwd": n_capture}
    got = {k: cuda_ops.LAUNCHES[k] - n for k, n in before.items()}
    assert got == dict.fromkeys(cuda_ops.LAUNCHES, 0) | {"linear_act_bwd": n_other}
