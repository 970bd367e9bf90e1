"""The port's trainer (shallowspeed_tpu_torch/trainer.py) against the JAX
package's, and the port's own bitwise claims.

The same seeded numpy batches go through ``trainer.make_train_step`` /
``make_train_epoch`` / ``make_train_run`` of both packages (the port on the
CPU, its plain path). Across packages the tolerance is the one
``tests/test_torch_oracle.py`` and ``tests/test_trainer.py`` hold a
cross-engine trajectory to. Inside the port, eager ops in a fixed order
make an epoch bitwise equal to a loop of its steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import optimizer as jopt
from shallowspeed_tpu import trainer as jtrainer
from shallowspeed_tpu_torch import convert
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import optimizer as topt
from shallowspeed_tpu_torch import trainer as ttrainer

SIZES = (20, 16, 15, 12, 10)
B, M, NB = 32, 4, 5
RTOL, ATOL = 2e-4, 2e-6  # cross-engine trajectory (test_torch_oracle.py)


def _data(seed=0, nb=NB, sizes=SIZES):
    rng = np.random.RandomState(seed)
    X = rng.randn(nb, M, B // M, sizes[0]).astype(np.float32)
    Y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], (nb, M, B // M))]
    return X, Y


def _both(sizes=SIZES, opt="sgd", lr=0.05):
    jspec = jmodel.make_model_spec(sizes, 1, B)
    tspec = tmodel.make_model_spec(sizes, 1, B)
    host = jmodel.init_model(jspec)
    jp = jax.tree.map(jnp.asarray, host)
    tp = convert.params_from_numpy(host, "cpu")
    jo, to = jopt.make_optimizer(opt, lr), topt.make_optimizer(opt, lr)
    return jspec, tspec, jp, tp, jo, to


def _assert_params_close(tp, jp, rtol=RTOL, atol=ATOL):
    for a, b in zip(convert.params_to_numpy(tp), jp):
        for la, lb in zip(a, b):
            np.testing.assert_allclose(la["W"], np.asarray(lb["W"]), rtol=rtol, atol=atol)
            np.testing.assert_allclose(
                la["b"], np.asarray(lb["b"]).reshape(1, -1), rtol=rtol, atol=atol
            )


def _bits(stages):
    return [a.clone() for a in topt.tree_leaves(tmodel.param_tree(stages))]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_train_step_matches_jax(opt, fuse):
    jspec, tspec, jp, tp, jo, to = _both(opt=opt, lr=0.05 if opt == "sgd" else 1e-3)
    X, Y = _data()
    jstep = jtrainer.make_train_step(jspec, jo, fuse_mubatches=fuse)
    tstep = ttrainer.make_train_step(tspec, to, fuse_mubatches=fuse)
    js, ts = jo.init(jp), to.init(tmodel.param_tree(tp))
    for i in range(NB):
        jp, js = jstep(jp, js, jnp.asarray(X[i]), jnp.asarray(Y[i]))
        tp, ts = tstep(tp, ts, torch.from_numpy(X[i]), torch.from_numpy(Y[i]))
    _assert_params_close(tp, jp)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_train_epoch_matches_jax_with_grad_norm(clip):
    """The epoch's mean loss and its pre-clip grad-norm aux."""
    jspec, tspec, jp, tp, jo, to = _both()
    X, Y = _data(1)
    jep = jtrainer.make_train_epoch(jspec, jo, clip_norm=clip, with_grad_norm=True)
    tep = ttrainer.make_train_epoch(tspec, to, clip_norm=clip, with_grad_norm=True)
    jp, _, jloss, jaux = jep(jp, (), jnp.asarray(X), jnp.asarray(Y))
    tp, _, tloss, taux = tep(tp, (), torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(
        float(taux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-5
    )
    _assert_params_close(tp, jp)


def test_epoch_is_bitwise_a_loop_of_steps():
    """The JAX package holds this at 1e-6 (jit fuses the two programs
    differently); eager PyTorch runs the same ops in the same order, so the
    port holds it bitwise, loss included."""
    _, tspec, _, tp_a, _, to = _both(opt="momentum", lr=1e-3)
    _, _, _, tp_b, _, _ = _both()
    X, Y = (torch.from_numpy(a) for a in _data(2))
    ep = ttrainer.make_train_epoch(tspec, to, clip_norm=0.5)
    sa = to.init(tmodel.param_tree(tp_a))
    tp_a, sa, mean_loss = ep(tp_a, sa, X, Y)
    step = ttrainer._make_batch_step(tspec, to, clip_norm=0.5)
    sb = to.init(tmodel.param_tree(tp_b))
    loss_sum = torch.zeros(())
    for xb, yb in zip(X, Y):
        tp_b, sb, loss = step(tp_b, sb, xb, yb)
        loss_sum = loss_sum + loss
    assert all(torch.equal(a, b) for a, b in zip(_bits(tp_a), _bits(tp_b)))
    assert torch.equal(mean_loss, loss_sum / NB)


def test_scanned_matches_fused():
    """One full-batch forward/backward per step equals the microbatch loop
    within float noise (test_trainer.py's tolerance)."""
    _, tspec, _, tp_a, _, to = _both()
    _, _, _, tp_b, _, _ = _both()
    X, Y = (torch.from_numpy(a) for a in _data(3))
    tp_a, _, la = ttrainer.make_train_epoch(tspec, to)(tp_a, (), X, Y)
    tp_b, _, lb = ttrainer.make_train_epoch(tspec, to, fuse_mubatches=True)(tp_b, (), X, Y)
    for a, b in zip(_bits(tp_a), _bits(tp_b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)


@pytest.mark.parametrize("with_eval", [True, False])
def test_train_run_matches_jax_and_its_epochs(with_eval):
    """The whole run against the JAX run, and bitwise against looping the
    port's own epoch with a whole-split accuracy after each."""
    jspec, tspec, jp, tp, jo, to = _both(opt="adam", lr=1e-3)
    X, Y = _data(4)
    rng = np.random.RandomState(9)
    vx = rng.randn(50, SIZES[0]).astype(np.float32)
    vy = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], 50)]
    jrun = jtrainer.make_train_run(jspec, jo, with_eval=with_eval)
    trun = ttrainer.make_train_run(tspec, to, with_eval=with_eval)
    jargs = (jnp.asarray(X), jnp.asarray(Y)) + ((jnp.asarray(vx), jnp.asarray(vy)) if with_eval else ())
    targs = (torch.from_numpy(X), torch.from_numpy(Y)) + (
        (torch.from_numpy(vx), torch.from_numpy(vy)) if with_eval else ()
    )
    jout = jrun(jp, jo.init(jp), *jargs, 3)
    tout = trun(tp, to.init(tmodel.param_tree(tp)), *targs, 3)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=1e-5)
    assert tout[2].shape == (3,)
    if with_eval:
        # the same hit counts; the float32 mean is summed in another order
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=1e-6)
    _assert_params_close(tout[0], jout[0])

    _, _, _, tq, _, _ = _both()
    sq = to.init(tmodel.param_tree(tq))
    ep = ttrainer.make_train_epoch(tspec, to)
    predict = ttrainer.make_predict(tspec)
    for e in range(3):
        tq, sq, loss = ep(tq, sq, *targs[:2])
        assert torch.equal(loss, tout[2][e])
        if with_eval:
            acc = ttrainer.accuracy(predict, tq, targs[2], targs[3])
            assert acc == pytest.approx(float(tout[3][e]), abs=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(_bits(tq), _bits(tout[0])))


def test_loss_fn_and_accuracy_match_jax():
    jspec, tspec, jp, tp, _, _ = _both()
    rng = np.random.RandomState(5)
    x = rng.randn(2500, SIZES[0]).astype(np.float32)  # 3 chunks, ragged tail
    y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], 2500)]
    np.testing.assert_allclose(
        float(ttrainer.make_loss_fn(tspec)(tp, torch.from_numpy(x[:B]), torch.from_numpy(y[:B]))),
        float(jtrainer.make_loss_fn(jspec)(jp, x[:B], y[:B])),
        rtol=1e-6,
    )
    got = ttrainer.accuracy(
        ttrainer.make_predict(tspec), tp, torch.from_numpy(x), torch.from_numpy(y)
    )
    want = jtrainer.accuracy(jtrainer.make_predict(jspec), jp, x, y)
    assert got == want


def test_kernel_paths_refuse():
    """The fused train kernels' paths (B9-B11) refuse outside their
    constraint set — unfused microbatches, megakernel with epoch_kernel,
    run_kernel with eval — and nothing falls back to the loop."""
    _, tspec, _, _, _, to = _both()
    for call, match in (
        (lambda: ttrainer.make_train_step(tspec, to, megakernel=True), "fuse_mubatches"),
        (lambda: ttrainer.make_train_epoch(tspec, to, epoch_kernel=True), "fuse_mubatches"),
        (lambda: ttrainer.make_train_epoch(
            tspec, to, fuse_mubatches=True, megakernel=True, epoch_kernel=True), "exclusive"),
        (lambda: ttrainer.make_train_run(
            tspec, to, fuse_mubatches=True, with_eval=True, run_kernel=True), "with_eval=False"),
        (lambda: ttrainer.make_train_run(
            tspec, to, fuse_mubatches=True, with_eval=False, run_kernel=True,
            epoch_kernel=True), "subsumes"),
    ):
        with pytest.raises(ValueError, match=match):
            call()
