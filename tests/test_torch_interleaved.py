"""Interleaved (virtual-stage) schedules in the port's executor against the
JAX package's (``tests/test_interleaved.py``).

- The device-major stacked order (``interleave_order``) and the ordered
  ``stack_params``/``unstack_params`` are copies: held exactly.
- The port's interleaved step and epoch on the CPU against
  ``E.make_pipeline_step``/``make_pipeline_epoch`` on the 8-device virtual
  CPU mesh, over (dp, P, V) in {(1, 2, 2), (2, 2, 2), (1, 4, 2)} and both
  kernel backends (on the CPU the pallas backend is the flag kernels' plain
  version): params and losses within the cross-engine class ``rtol=2e-4,
  atol=2e-6``. P=4 x V=2 cuts the 8-size list into 8 stages, the last
  with no Linear: the reference's quirk, which both packages keep.
- The port's interleaved run against its own sequential trainer within the
  executor's cross-layout class ``rtol=3e-4, atol=3e-6``, on a 16-size list
  where every stage keeps a Linear (``tests/test_interleaved.py:69-97``).
- Interleaved inference against the sequential predict, and through the
  session: training, eval, predict, ``train_run`` and the CLI against the
  JAX session on one split.
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
from shallowspeed_tpu_torch import convert, trainer
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

SIZES = (40, 36, 32, 28, 24, 20, 14, 10)
SIZES16 = (24, 22, 21, 20, 19, 18, 17, 16, 16, 15, 14, 13, 13, 12, 11, 10)  # test_interleaved.py's
B, M, LR, NB = 32, 4, 0.01, 3
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # cross-layout (tests/test_executor.py)
LAYOUTS = [(1, 2, 2), (2, 2, 2), (1, 4, 2)]


def _data(sizes, nb=NB, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(nb, B, sizes[0]).astype(np.float32)
    Y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], (nb, B))]
    return X, Y


def _flat(params):
    return [l for stage in params for l in stage]


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("W", "b"):
            np.testing.assert_allclose(
                np.asarray(a[k]).reshape(-1), np.asarray(b[k]).reshape(-1), rtol=rtol, atol=atol
            )


@pytest.mark.parametrize("P,V", [(2, 2), (4, 2), (2, 4), (1, 4), (1, 2)])
def test_interleave_order_and_ordered_stacking_equal_jax(P, V):
    sizes = SIZES16 if P * V > 4 else SIZES
    assert TE.interleave_order(P * V, P) == JE.interleave_order(P * V, P)
    jspec = JM.make_model_spec(sizes, P * V, B)
    tspec = TM.make_model_spec(sizes, P * V, B)
    order = TE.interleave_order(P * V, P)
    params = JM.init_model(jspec)
    (jst, jfl), (tst, tfl) = (
        JE.stack_params(params, jspec, order=order),
        TE.stack_params(params, tspec, order=order),
    )
    for k in ("W", "b"):
        for a, b in zip(tst[k], jst[k]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for k in jfl:
        assert np.array_equal(tfl[k], jfl[k]), k
    back = TE.unstack_params(convert.stacked_from_numpy(params, tspec, "cpu", order=order)[0],
                             tspec, order=order)
    want = JE.unstack_params(jst, jspec, order=order)
    for la, lb in zip(_flat(back), _flat(want)):
        assert np.array_equal(la["W"], lb["W"]) and np.array_equal(la["b"], lb["b"])
    with pytest.raises(ValueError, match="do not split"):
        TE.interleave_order(P * V + 1, 2 * P * V)
    with pytest.raises(ValueError, match="must permute"):
        TE.stack_params(params, tspec, order=[0] * (P * V))


def _jax_interleaved(sizes, X, Y, dp, P, V, epoch=False):
    mesh = jmesh(dp, P)
    spec = JM.make_model_spec(sizes, P * V, B)
    order = JE.interleave_order(P * V, P)
    prog = jlower(JS.InterleavedSchedule, M, P, virtual=V)
    stacked, flags = JE.init_stacked(spec, mesh, order=order)
    if epoch:
        fn = JE.make_pipeline_epoch(mesh, spec, prog, B // dp // M, SGD(LR))
        stacked, _, loss = fn(stacked, flags, (), jnp.asarray(X), jnp.asarray(Y))
    else:
        step = JE.make_pipeline_step(mesh, spec, prog, B // dp // M, SGD(LR))
        for i in range(X.shape[0]):
            stacked, _, loss = step(stacked, flags, (), jnp.asarray(X[i]), jnp.asarray(Y[i]))
    return _flat(JE.unstack_params(stacked, spec, order=order)), float(loss)


def _torch_interleaved(sizes, X, Y, dp, P, V, kernel_backend="xla", epoch=False):
    mesh = VirtualMesh(dp, P, "cpu")
    spec = TM.make_model_spec(sizes, P * V, B)
    order = TE.interleave_order(P * V, P)
    prog = tlower(TS.InterleavedSchedule, M, P, virtual=V)
    stacked, flags = TE.init_stacked(spec, mesh, order=order)
    opt = make_optimizer("sgd", LR)
    state = opt.init(stacked)
    kw = dict(kernel_backend=kernel_backend)
    if epoch:
        fn = TE.make_pipeline_epoch(mesh, spec, prog, B // dp // M, opt, **kw)
        stacked, state, loss = fn(stacked, flags, state, torch.from_numpy(X), torch.from_numpy(Y))
    else:
        step = TE.make_pipeline_step(mesh, spec, prog, B // dp // M, opt, **kw)
        for i in range(X.shape[0]):
            stacked, state, loss = step(
                stacked, flags, state, torch.from_numpy(X[i]), torch.from_numpy(Y[i])
            )
    return _flat(TE.unstack_params(stacked, spec, order=order)), float(loss), (stacked, flags, spec, order)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dp,P,V", LAYOUTS)
def test_interleaved_step_matches_jax(dp, P, V, backend):
    X, Y = _data(SIZES)
    want, want_loss = _jax_interleaved(SIZES, X, Y, dp, P, V)
    got, loss, _ = _torch_interleaved(SIZES, X, Y, dp, P, V, backend)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("dp,P,V", LAYOUTS)
def test_interleaved_epoch_matches_jax_and_the_pallas_backend_bitwise(dp, P, V):
    """The epoch function: within the cross-engine class of JAX's, and on
    the CPU the pallas backend is the xla backend bit for bit."""
    X, Y = _data(SIZES, seed=1)
    want, want_loss = _jax_interleaved(SIZES, X, Y, dp, P, V, epoch=True)
    got, loss, _ = _torch_interleaved(SIZES, X, Y, dp, P, V, epoch=True)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _close(got, want, RTOL, ATOL)
    pal, pal_loss, _ = _torch_interleaved(SIZES, X, Y, dp, P, V, "pallas", epoch=True)
    assert pal_loss == loss
    for a, b in zip(pal, got):
        assert np.array_equal(a["W"], b["W"]) and np.array_equal(a["b"], b["b"])


def _sequential(sizes, X, Y):
    spec = TM.make_model_spec(sizes, 1, B)
    params = convert.params_from_numpy(TM.init_model(spec), "cpu")
    opt = make_optimizer("sgd", LR)
    state = opt.init(TM.param_tree(params))
    step = trainer.make_train_step(spec, opt)
    for i in range(X.shape[0]):
        params, state = step(
            params, state,
            torch.from_numpy(X[i].reshape(M, B // M, -1)),
            torch.from_numpy(Y[i].reshape(M, B // M, -1)),
        )
    return _flat(convert.params_to_numpy(params))


@pytest.mark.parametrize("dp,P,V", LAYOUTS + [(1, 1, 4)])
def test_interleaved_matches_the_sequential_trainer(dp, P, V):
    X, Y = _data(SIZES16)
    got, _, _ = _torch_interleaved(SIZES16, X, Y, dp, P, V, "pallas")
    _close(got, _sequential(SIZES16, X, Y), LAYOUT_RTOL, LAYOUT_ATOL)


def test_interleaved_predict_matches_sequential_predict():
    """``tests/test_interleaved.py:108``: the interleaved inference program
    on trained weights against the sequential predict and JAX's program."""
    X, Y = _data(SIZES16)
    _, _, (stacked, flags, spec, order) = _torch_interleaved(SIZES16, X, Y, 2, 4, 2, "pallas")
    mesh = VirtualMesh(2, 4, "cpu")
    eval_prog = tlower(TS.InterleavedInferenceSchedule, 1, 4, training=False, virtual=2)
    ev = TE.make_pipeline_step(mesh, spec, eval_prog, B // 2, kernel_backend="pallas")
    preds = ev(stacked, flags, torch.from_numpy(X[0])).numpy()[:, : SIZES16[-1]]
    spec1 = TM.make_model_spec(SIZES16, 1, B)
    seq = convert.params_from_numpy([_flat(TE.unstack_params(stacked, spec, order=order))], "cpu")
    pred1 = trainer.make_predict(spec1)(seq, torch.from_numpy(X[0])).numpy()
    np.testing.assert_allclose(preds, pred1, rtol=2e-4, atol=1e-5)

    jspec = JM.make_model_spec(SIZES16, 8, B)
    jmesh2 = jmesh(2, 4)
    jst, jfl = JE.put_stacked(*JE.stack_params(TE.unstack_params(stacked, spec, order=order),
                                               jspec, order=order), jmesh2)
    jev = JE.make_pipeline_step(
        jmesh2, jspec, jlower(JS.InterleavedInferenceSchedule, 1, 4, training=False, virtual=2),
        B // 2,
    )
    jpreds = np.asarray(jev(jst, jfl, jnp.asarray(X[0])))[:, : SIZES16[-1]]
    np.testing.assert_allclose(preds, jpreds, rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# Through the session and the CLI
# ---------------------------------------------------------------------------

SESSION = dict(sizes=(24, 20, 18, 16, 14, 12, 11, 10), global_batch_size=32, lr=0.01)
INTERLEAVED = dict(pp=2, schedule="interleaved", virtual_stages=2, kernel_backend="pallas")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("interleaved_split")
    rng = np.random.RandomState(3)
    for suffix, n in (("train", 6 * 32 + 5), ("val", 50)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 24).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


@pytest.mark.parametrize("dp", [pytest.param(1, marks=pytest.mark.slow), 2])
def test_session_trains_evaluates_and_predicts_like_jax(split, dp):
    """An interleaved session's epoch, accuracy, predict and fused run with
    eval against the JAX session's; params() and model_hash() are logical,
    so the hash at init is the sequential session's."""
    kw = dict(SESSION, data_dir=split, dp=dp, **INTERLEAVED)
    js, ts = JaxSession(**kw), TorchSession(device="cpu", **kw)
    assert ts.V == 2 and not ts.sequential and ts.spec.n_stages == 4
    assert ts.model_hash() == js.model_hash()
    assert ts.model_hash() == TorchSession(device="cpu", **SESSION).model_hash()
    np.testing.assert_allclose(ts.train_epoch(), js.train_epoch(), rtol=RTOL, atol=ATOL)
    assert abs(ts.accuracy() - js.accuracy()) <= 1 / 50
    _close(_flat(ts.params()), _flat(js.params()), RTOL, ATOL)
    x = np.random.RandomState(4).rand(3 * ts.slot_rows + 1, 24).astype(np.float32)
    np.testing.assert_allclose(ts.predict(x), js.predict(x), rtol=RTOL, atol=1e-6)
    tl, ta = ts.train_run(2)
    jl, ja = js.train_run(2)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ta, ja, atol=1 / 50)
    _close(_flat(ts.params()), _flat(js.params()), RTOL, ATOL)
    ts.assert_replicas_in_sync()


def test_session_chunked_steps_are_one_epoch_bitwise(split):
    whole = TorchSession(device="cpu", data_dir=split, **SESSION, **INTERLEAVED)
    whole.train_epoch()
    chunked = TorchSession(device="cpu", data_dir=split, **SESSION, **INTERLEAVED)
    chunked.train_steps(2)
    assert chunked.train_steps(10)[0] == 4
    assert chunked.model_hash() == whole.model_hash()


def test_cli_trains_an_interleaved_layout_on_cpu(tmp_path, capsys):
    """The CLI trains the flagship: a 784-wide split of 3 batches."""
    rng = np.random.RandomState(5)
    for suffix, n in (("train", 3 * 32 + 5), ("val", 20)):
        np.save(tmp_path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(tmp_path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    rc = tcli.main([
        "--device", "cpu", "--data-dir", str(tmp_path), "--epochs", "1", "--dp", "2",
        "--pp", "2", "--schedule", "interleaved", "--virtual-stages", "2",
        "--kernel-backend", "pallas", "--global-batch-size", "32",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "DP=2 x PP=2 x TP=1 (interleaved pipeline, V=2)" in out
    assert "DP replicas in sync ✓" in out
    assert re.search(r"final model hash: [0-9a-f]{40}", out)
    assert re.search(r"Epoch: 1, Time Spent: [0-9.]+s, Accuracy: [0-9.]+%", out)
