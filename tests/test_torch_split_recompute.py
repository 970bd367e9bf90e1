"""The split backward (2BP) and activation recompute in the port's executor.

Inside the port, bitwise (the JAX package's claims,
``tests/test_fuzz_layouts.py:487`` and ``:547``): a split run's final
weights and loss equal the unsplit ``"xla"`` run's, and a recompute run's
the stashed run's, on ``BSPLIT_LAYOUTS``' pp4-gpipe, pp4-pipedream-clip and
dp2-naive, dp2pp2-bucketed and zero1 entries and a DP=2 x PP=2 GPipe with
a clip, and recompute composed with split at PP=4 PipeDream. Split equals unsplit
because ``_stage_bwd_input``/``_stage_bwd_weight`` compute each slot's
effective grad, dx, dW and db with the plain backward's expressions and
torch calls, and the lowering orders the B-weights as the B-inputs, so the
accumulators add the same terms in the same order; recompute re-runs the
same ``_stage_fwd`` from the same input bits.

Against JAX: each split or recompute run within the cross-engine class
``rtol=2e-4, atol=2e-6`` of ``E.make_pipeline_step``'s on the 8-device
virtual CPU mesh; through the session (per-epoch and fused run) and the
CLI; and the JAX session's refusals word for word
(``tests/test_api.py:223-246``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as JM
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.optimizer import SGD
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import lower_schedule as jlower
from shallowspeed_tpu.parallel import make_mesh as jmesh
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

SIZES = (40, 36, 32, 28, 24, 20, 14, 10)
B, M, LR, STEPS = 32, 4, 0.01, 2
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
# layout -> (dp, pp, schedule, clip, the executor's sync options):
# tests/test_fuzz_layouts.py's BSPLIT_LAYOUTS (dp2-naive without its
# buckets), plus DP=2 x PP=2 GPipe + clip
LAYOUTS = {
    "pp4-gpipe": (1, 4, "GPipeSchedule", None, {}),
    "pp4-pipedream-clip": (1, 4, "PipeDreamFlushSchedule", 0.05, {}),
    "dp2-naive": (2, 1, "NaiveParallelSchedule", None, {}),
    "dp2pp2-gpipe-clip": (2, 2, "GPipeSchedule", 0.05, {}),
    "dp2pp2-bucketed": (2, 2, "GPipeSchedule", 0.05, dict(grad_bucket_bytes=1024)),
    "zero1": (2, 2, "PipeDreamFlushSchedule", None, dict(zero=1)),
}
# feature -> the lowering's flags; "recompute+split" at pp4-pipedream only
FEATURES = {
    "split": dict(backward_split=True),
    "recompute": dict(recompute=True),
}


def _data(seed=11):
    rng = np.random.RandomState(seed)
    X = rng.randn(STEPS, B, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], (STEPS, B))]
    return X, Y


def _torch_run(layout, X, Y, **lower_kw):
    dp, pp, sched, clip, sync = LAYOUTS[layout]
    spec = TM.make_model_spec(SIZES, pp, B)
    mesh = VirtualMesh(dp, pp, "cpu")
    prog = tlower(getattr(TS, sched), M, pp, **lower_kw)
    stacked, flags = TE.init_stacked(spec, mesh)
    opt = make_optimizer("sgd", LR)
    state = opt.init(stacked)
    step = TE.make_pipeline_step(mesh, spec, prog, B // dp // M, opt, clip_norm=clip, **sync)
    for i in range(STEPS):
        stacked, state, loss = step(
            stacked, flags, state, torch.from_numpy(X[i]), torch.from_numpy(Y[i])
        )
    leaves = [a.numpy() for k in ("W", "b") for a in stacked[k]]
    return leaves, float(loss), TE.unstack_params(stacked, spec)


def _jax_run(layout, X, Y, **lower_kw):
    dp, pp, sched, clip, sync = LAYOUTS[layout]
    spec = JM.make_model_spec(SIZES, pp, B)
    mesh = jmesh(dp, pp)
    prog = jlower(getattr(JS, sched), M, pp, **lower_kw)
    stacked, flags = JE.init_stacked(spec, mesh)
    step = JE.make_pipeline_step(mesh, spec, prog, B // dp // M, SGD(LR), clip_norm=clip, **sync)
    for i in range(STEPS):
        stacked, _, loss = step(stacked, flags, (), jnp.asarray(X[i]), jnp.asarray(Y[i]))
    return float(loss), JE.unstack_params(stacked, spec)


def _close(got, want):
    for sa, sb in zip(got, want):
        for la, lb in zip(sa, sb):
            for k in ("W", "b"):
                np.testing.assert_allclose(la[k], np.asarray(lb[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bitwise_inside_the_port_and_close_to_jax(layout, feature):
    """Split == unsplit and recompute == stashed, bit for bit (weights and
    loss); the feature's run within the cross-engine class of JAX's."""
    X, Y = _data()
    base_leaves, base_loss, _ = _torch_run(layout, X, Y)
    leaves, loss, params = _torch_run(layout, X, Y, **FEATURES[feature])
    assert loss == base_loss, layout
    for a, b in zip(base_leaves, leaves):
        np.testing.assert_array_equal(a, b, err_msg=layout)
    want_loss, want = _jax_run(layout, X, Y, **FEATURES[feature])
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _close(params, want)


def test_recompute_with_split_is_bitwise_the_stashed_unsplit_run():
    """``tests/test_fuzz_layouts.py``'s pp4-pipedream-split recompute entry:
    recompute composed with the split backward."""
    X, Y = _data(seed=12)
    base_leaves, base_loss, _ = _torch_run("pp4-pipedream-clip", X, Y)
    leaves, loss, params = _torch_run(
        "pp4-pipedream-clip", X, Y, backward_split=True, recompute=True
    )
    assert loss == base_loss
    for a, b in zip(base_leaves, leaves):
        np.testing.assert_array_equal(a, b)
    want_loss, want = _jax_run("pp4-pipedream-clip", X, Y, backward_split=True, recompute=True)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _close(params, want)


# ---------------------------------------------------------------------------
# Through the session and the CLI
# ---------------------------------------------------------------------------

SESSION = dict(sizes=(24, 20, 18, 16, 14, 12, 11, 10), global_batch_size=32, lr=0.01)


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("split_recompute")
    rng = np.random.RandomState(6)
    for suffix, n in (("train", 5 * 32 + 3), ("val", 40)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 24).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


@pytest.mark.parametrize("feature", ["backward_split", "recompute"])
def test_session_hash_equals_the_plain_run_and_jax_follows(split_dir, feature):
    """DP=2 x PP=4 GPipe with a clip: an epoch and a fused run with eval,
    the model hash equal to the plain session's after each; the JAX
    session with the same flag within the cross-engine class."""
    kw = dict(SESSION, data_dir=split_dir, dp=2, pp=4, schedule="gpipe", clip_norm=0.05)
    plain = TorchSession(device="cpu", **kw)
    ts = TorchSession(device="cpu", **kw, **{feature: True})
    js = JaxSession(**kw, **{feature: True})
    assert ts.train_epoch() == plain.train_epoch()
    assert ts.model_hash() == plain.model_hash()
    losses, accs = ts.train_run(2)
    assert (losses, accs) == plain.train_run(2)
    assert ts.model_hash() == plain.model_hash()
    js.train_epoch()
    jl, ja = js.train_run(2)
    np.testing.assert_allclose(losses, jl, rtol=RTOL, atol=ATOL)
    _close(ts.params(), js.params())


def test_cli_split_and_recompute_print_the_plain_hash(tmp_path, capsys):
    rng = np.random.RandomState(7)
    for suffix, n in (("train", 3 * 32 + 5), ("val", 20)):
        np.save(tmp_path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(tmp_path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    base = ["--device", "cpu", "--data-dir", str(tmp_path), "--epochs", "1", "--no-eval",
            "--pp", "4", "--schedule", "pipedream", "--global-batch-size", "32"]
    hashes = []
    for extra in ([], ["--backward-split", "--recompute"]):
        assert tcli.main(base + extra) == 0
        hashes.append(re.search(r"final model hash: ([0-9a-f]{40})", capsys.readouterr().out)[1])
    assert len(set(hashes)) == 1


def _message(cls, **kw):
    with pytest.raises(ValueError) as e:
        cls(**kw)
    return str(e.value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(backward_split=True),
        dict(pp=2, schedule="interleaved", virtual_stages=2, backward_split=True),
        dict(pp=2, schedule="gpipe", kernel_backend="pallas", backward_split=True),
        dict(recompute=True),
        dict(pp=2, schedule="interleaved", virtual_stages=2, recompute=True),
        dict(pp=2, schedule="gpipe", kernel_backend="pallas", recompute=True),
        dict(pp=2, schedule="gpipe", virtual_stages=2),
        dict(pp=2, schedule="interleaved", virtual_stages=0),
    ],
    ids=["split-seq", "split-interleaved", "split-pallas", "rec-seq", "rec-interleaved",
         "rec-pallas", "v2-gpipe", "v0"],
)
def test_refusals_are_the_jax_sessions_word_for_word(split_dir, kw):
    kw = dict(SESSION, data_dir=split_dir, **kw)
    assert _message(TorchSession, device="cpu", **kw) == _message(JaxSession, **kw)


@pytest.mark.parametrize(
    "argv",
    [["--recompute"], ["--recompute", "--pp", "2", "--schedule", "interleaved",
                       "--virtual-stages", "2"]],
    ids=["sequential", "interleaved"],
)
def test_cli_recompute_refusals_at_parse_time(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert "--recompute" in capsys.readouterr().err
