"""The gelu family on the port's mesh (the ``transformer`` zoo model's
expressions: the f32 ``gelu_grad_mult(z)`` in the mask slot, residual adds
forward and skip grads backward) against the JAX package's XLA executor.

A narrowed transformer-family spec at PP=2 and DP=2 x PP=2, GPipe and
PipeDream, 2 SGD steps: params and loss within the cross-engine class
``rtol=2e-4, atol=2e-6`` of ``E.make_pipeline_step`` on the 8-device
virtual CPU mesh, and within the executor's cross-layout class
``rtol=3e-4, atol=3e-6`` of the port's sequential gelu trainer. Then the
full-width ``transformer`` through the session at DP=2 x PP=2 PipeDream
against the JAX session, and pallas x gelu refused in the JAX words
(``tests/test_api.py:248-255``).
"""

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
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

NARROW_BLOCKS = (20, 24, 12, 24, 12, 24, 12, 10)  # the transformer zoo, narrowed
B, M, LR, STEPS = 32, 4, 0.01, 2
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # cross-layout (tests/test_executor.py)


def _data(seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(STEPS, B, NARROW_BLOCKS[0]).astype(np.float32)
    Y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, (STEPS, B))]
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


def _sequential(X, Y):
    spec = TM.make_model_spec(NARROW_BLOCKS, 1, B, act="gelu")
    params = convert.params_from_numpy(TM.init_model(spec), "cpu")
    opt = make_optimizer("sgd", LR)
    state = opt.init(TM.param_tree(params))
    step = trainer.make_train_step(spec, opt)
    for i in range(STEPS):
        params, state = step(
            params, state,
            torch.from_numpy(X[i].reshape(M, B // M, -1)),
            torch.from_numpy(Y[i].reshape(M, B // M, -1)),
        )
    return _flat(convert.params_to_numpy(params))


@pytest.mark.parametrize("schedule", ["GPipeSchedule", "PipeDreamFlushSchedule"])
@pytest.mark.parametrize("dp,pp", [(1, 2), (2, 2)])
def test_gelu_mesh_matches_jax_and_the_sequential_trainer(dp, pp, schedule):
    X, Y = _data()
    jspec = JM.make_model_spec(NARROW_BLOCKS, pp, B, act="gelu")
    tspec = TM.make_model_spec(NARROW_BLOCKS, pp, B, act="gelu")
    assert any(f for s in tspec.stages for f in s.res_flags)  # residuals on the path
    mesh = jmesh(dp, pp)
    jst, jfl = JE.init_stacked(jspec, mesh)
    jstep = JE.make_pipeline_step(
        mesh, jspec, jlower(getattr(JS, schedule), M, pp), B // dp // M, SGD(LR)
    )
    tmesh = VirtualMesh(dp, pp, "cpu")
    tst, tfl = TE.init_stacked(tspec, tmesh)
    assert np.array_equal(tfl["residual"], np.asarray(jfl["residual"]))
    opt = make_optimizer("sgd", LR)
    state = opt.init(tst)
    tstep = TE.make_pipeline_step(
        tmesh, tspec, tlower(getattr(TS, schedule), M, pp), B // dp // M, opt
    )
    for i in range(STEPS):
        jst, _, jloss = jstep(jst, jfl, (), jnp.asarray(X[i]), jnp.asarray(Y[i]))
        tst, state, tloss = tstep(tst, tfl, state, torch.from_numpy(X[i]), torch.from_numpy(Y[i]))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    got = _flat(TE.unstack_params(tst, tspec))
    _close(got, _flat(JE.unstack_params(jst, jspec)), RTOL, ATOL)
    _close(got, _sequential(X, Y), LAYOUT_RTOL, LAYOUT_ATOL)


@pytest.fixture(scope="module")
def wide_split(tmp_path_factory):
    path = tmp_path_factory.mktemp("gelu_split")
    rng = np.random.RandomState(8)
    for suffix, n in (("train", 2 * 32 + 3), ("val", 30)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


def test_transformer_session_on_the_mesh_matches_jax(wide_split):
    """The zoo model at full width, DP=2 x PP=2 PipeDream: an epoch,
    accuracy and predict against the JAX session."""
    kw = dict(model="transformer", data_dir=wide_split, global_batch_size=32, lr=0.01,
              dp=2, pp=2, schedule="pipedream")
    js, ts = JaxSession(**kw), TorchSession(device="cpu", **kw)
    assert ts.spec.act == "gelu" and ts.model_hash() == js.model_hash()
    np.testing.assert_allclose(ts.train_epoch(), js.train_epoch(), rtol=RTOL, atol=ATOL)
    _close(_flat(ts.params()), _flat(js.params()), RTOL, ATOL)
    assert abs(ts.accuracy() - js.accuracy()) <= 1 / 30
    x = np.random.RandomState(9).rand(5, 784).astype(np.float32)
    np.testing.assert_allclose(ts.predict(x), js.predict(x), rtol=RTOL, atol=1e-6)


def test_pallas_with_gelu_is_refused_in_the_jax_words(wide_split):
    kw = dict(data_dir=wide_split, model="transformer", pp=2, schedule="gpipe",
              kernel_backend="pallas")
    with pytest.raises(ValueError, match="gelu-family") as t:
        TorchSession(device="cpu", **kw)
    with pytest.raises(ValueError) as j:
        JaxSession(**kw)
    assert str(t.value) == str(j.value)
