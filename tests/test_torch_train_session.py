"""The slice as a whole: the port's ``TrainingSession`` and training CLI
against the JAX package's, on the same synthetic split.

The split is written to ``tmp_path`` as ``.npy`` from a seed (Gaussian
class clusters scaled into [0, 1], like ``prepare_data.py --source
synthetic``). The port runs on the CPU (its plain path). Losses,
accuracies and final params are held to the JAX session at the
cross-engine tolerance of ``tests/test_torch_oracle.py`` and
``tests/test_trainer.py``.
"""

import re

import numpy as np
import pytest
import torch

from shallowspeed_tpu import checkpoint as jckpt
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession

RTOL, ATOL = 2e-4, 2e-6  # cross-engine trajectory (test_torch_oracle.py)
NARROW = (784, 32, 31, 30, 10)


def _write_split(path, n_train, n_val=300, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1.0, (10, 784)).astype(np.float32)
    for suffix, n in (("train", n_train), ("val", n_val)):
        labels = rng.randint(0, 10, n)
        x = centers[labels] + rng.normal(0, 2.0, (n, 784)).astype(np.float32)
        x = np.clip((x + 8.0) / 16.0, 0.0, 1.0).astype(np.float32)
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[labels])
    return path


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """8 batches of 128 (plus a ragged tail the drop-last removes)."""
    return _write_split(tmp_path_factory.mktemp("split"), 8 * 128 + 50)


def _assert_params_close(got, want):
    for sa, sb in zip(got, want):
        for la, lb in zip(sa, sb):
            np.testing.assert_allclose(la["W"], lb["W"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(la["b"], lb["b"], rtol=RTOL, atol=ATOL)


def _assert_state_close(got, want):
    if want is None:
        assert got is None
        return
    assert set(got["parts"]) == set(want["parts"])
    assert got["scalars"] == pytest.approx(want["scalars"])
    for k in want["parts"]:
        _assert_params_close(got["parts"][k], want["parts"][k])


def test_flagship_two_epochs_match_jax(split):
    """The reference's recipe at full flagship width (B=128, M=4, SGD at lr
    0.006) for 2 epochs of 8 batches: per-epoch losses, accuracy() and the
    final params."""
    js = JaxSession(data_dir=split)
    ts = TorchSession(data_dir=split, device="cpu")
    assert ts.batches_per_epoch == js.batches_per_epoch == 8
    assert ts.spec.sizes == FLAGSHIP_SIZES
    for _ in range(2):
        lj, lt = js.train_epoch(), ts.train_epoch()
        np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
        assert ts.accuracy() == js.accuracy()
    assert (ts.epoch, ts.step_in_epoch, ts.global_step) == (2, 0, 16)
    _assert_params_close(ts.params(), js.params())
    assert ts.opt_state_logical() is None


@pytest.mark.parametrize(
    "kw",
    [
        dict(fuse_mubatches=True),
        dict(optimizer="momentum", lr=0.01, weight_decay=0.05),
        dict(optimizer="adam", lr=1e-3),
        dict(clip_norm=0.05, lr=0.05),
    ],
    ids=["fused", "momentum-wd", "adam", "clip"],
)
def test_recipe_variants_match_jax(split, kw):
    """fuse_mubatches, momentum (with decoupled weight decay), Adam and
    clip_norm at a reduced width, 2 epochs each, optimizer state included."""
    js = JaxSession(sizes=NARROW, data_dir=split, **kw)
    ts = TorchSession(sizes=NARROW, data_dir=split, device="cpu", **kw)
    for _ in range(2):
        np.testing.assert_allclose(ts.train_epoch(), js.train_epoch(), rtol=RTOL, atol=ATOL)
    _assert_params_close(ts.params(), js.params())
    _assert_state_close(ts.opt_state_logical(), js.opt_state_logical())


def test_train_run_matches_jax(split):
    js = JaxSession(sizes=NARROW, data_dir=split, optimizer="momentum", lr=0.01)
    ts = TorchSession(sizes=NARROW, data_dir=split, device="cpu", optimizer="momentum", lr=0.01)
    lj, aj = js.train_run(2)
    lt, at = ts.train_run(2)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-6)
    assert ts.epoch == 2
    _assert_params_close(ts.params(), js.params())
    lt2, at2 = ts.train_run(1, with_eval=False)
    assert at2 is None and len(lt2) == 1 and ts.epoch == 3


def test_chunked_steps_are_bitwise_one_epoch(split):
    """train_steps in chunks (clipped at the epoch boundary) applies the
    same updates as one train_epoch: bitwise-equal params."""
    a = TorchSession(sizes=NARROW, data_dir=split, device="cpu", optimizer="adam", lr=1e-3)
    b = TorchSession(sizes=NARROW, data_dir=split, device="cpu", optimizer="adam", lr=1e-3)
    loss = a.train_epoch()
    assert b.train_steps(3) == (3, None)
    assert (b.step_in_epoch, b.global_step) == (3, 3)
    with pytest.raises(ValueError, match="mid-flight"):
        b.train_epoch()
    steps, epoch_loss = b.train_steps(100)  # clipped at the boundary
    assert steps == 5 and b.epoch == 1 and b.step_in_epoch == 0
    assert epoch_loss == pytest.approx(loss, rel=1e-6)
    for sa, sb in zip(a.params(), b.params()):
        for la, lb in zip(sa, sb):
            assert np.array_equal(la["W"], lb["W"]) and np.array_equal(la["b"], lb["b"])
    sa, sb = a.opt_state_logical(), b.opt_state_logical()
    assert sa["scalars"] == sb["scalars"] == {"t": 8.0}
    with pytest.raises(ValueError, match="n must be"):
        b.train_steps(0)


def test_resume_continues_a_jax_run(split, tmp_path):
    """A JAX momentum run's checkpoint (params + velocity) resumes in the
    port, which then tracks the uninterrupted JAX run."""
    kw = dict(sizes=NARROW, data_dir=split, optimizer="momentum", lr=0.01)
    js = JaxSession(**kw)
    js.train_epoch()
    path = tmp_path / "ck.npz"
    js.save(str(path))
    ts = TorchSession(device="cpu", resume=path, **kw)
    assert ts.epoch == 1
    _assert_state_close(ts.opt_state_logical(), js.opt_state_logical())
    js.train_epoch()
    ts.train_epoch()
    _assert_params_close(ts.params(), js.params())
    with pytest.raises(ValueError, match="optimizer"):
        TorchSession(device="cpu", resume=path, **dict(kw, optimizer="adam"))
    with pytest.raises(ValueError, match="momentum="):
        TorchSession(device="cpu", resume=path, **dict(kw, momentum=0.5))


def test_mid_epoch_checkpoint_restores_cursor(split, tmp_path):
    """A JAX step checkpoint taken mid-epoch restores the epoch/step cursor;
    train_steps finishes that epoch."""
    kw = dict(sizes=NARROW, data_dir=split)
    js = JaxSession(checkpoint_dir=tmp_path / "ck", **kw)
    js.train_steps(3)
    path = js.save_step_checkpoint()
    ts = TorchSession(device="cpu", resume=path, **kw)
    assert (ts.epoch, ts.step_in_epoch) == (0, 3)
    js.train_steps(5)
    steps, _ = ts.train_steps(5)
    assert steps == 5 and ts.epoch == 1
    _assert_params_close(ts.params(), js.params())


def test_serving_session_refuses_training_and_unported_options(split, tmp_path):
    ts = TorchSession(device="cpu")
    for call in (ts.train_epoch, lambda: ts.train_steps(1), lambda: ts.train_run(1), ts.accuracy):
        with pytest.raises(RuntimeError, match="data_dir"):
            call()
    assert ts.batches_per_epoch == 0 and ts.global_step == 0
    # tp is ported: tp = 2 alone is a mesh layout (the sequential path's
    # options refuse it in the JAX session's words)
    tp2 = TorchSession(device="cpu", data_dir=split, tp=2)
    assert tp2.tp == 2 and not tp2.sequential and tp2.batches_per_epoch == 8
    with pytest.raises(ValueError, match="sequential path only"):
        TorchSession(device="cpu", data_dir=split, tp=2, fuse_mubatches=True)
    # ZeRO and the buckets are ported; the sequential path refuses them in
    # the JAX session's words (it has no dp axis and no gradient sync)
    for kw, match in (
        (dict(zero=1), "the sequential path has no mesh"),
        (dict(grad_bucket_bytes=1024), "the sequential path has no gradient sync"),
    ):
        with pytest.raises(ValueError, match=match):
            TorchSession(device="cpu", data_dir=split, **kw)
    # fault injection and checkpoint writing are ported: accepted
    ts = TorchSession(device="cpu", data_dir=split, faults="die@step=1")
    assert ts.faults_active
    with pytest.raises(ValueError, match="die@step=1"):
        ts.train_epoch()
    ts = TorchSession(device="cpu", data_dir=split, checkpoint_dir=tmp_path / "ck")
    assert ts.save_step_checkpoint().is_file() and not ts.faults_active
    for kw in (dict(megakernel=True), dict(epoch_kernel=True), dict(run_kernel=True)):
        with pytest.raises(ValueError, match="requires fuse_mubatches=True"):
            TorchSession(device="cpu", data_dir=split, **kw)
    with pytest.raises(ValueError, match="subsumes"):
        TorchSession(device="cpu", fuse_mubatches=True, run_kernel=True, epoch_kernel=True)
    with pytest.raises(ValueError, match="kernel_backend"):
        TorchSession(device="cpu", kernel_backend="triton")
    with pytest.raises(ValueError, match="mubatches"):
        TorchSession(device="cpu", mubatches=3)
    with pytest.raises(ValueError, match="clip_norm"):
        TorchSession(device="cpu", clip_norm=0.0)
    with pytest.raises(ValueError, match="optimizer"):
        TorchSession(device="cpu", optimizer="lion")
    with pytest.raises(ValueError, match="fewer than one"):
        TorchSession(device="cpu", data_dir=split, global_batch_size=4096, mubatches=4)


def test_cli_trains_on_cpu_and_needs_a_gpu_otherwise(split, capsys, monkeypatch):
    """``python -m shallowspeed_tpu_torch.train --device cpu`` for 1 epoch
    prints the root train.py's lines and exits 0; without ``--device cpu``
    it raises on a host without a GPU."""
    argv = ["--device", "cpu", "--epochs", "1", "--data-dir", str(split)]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "batches/epoch=8" in out
    assert "Epoch: 0, Time Spent:" in out and "Epoch: 0, mean train loss:" in out
    lines = out.splitlines()
    assert "Epoch: 1, Time Spent:" in out and "Accuracy:" in lines[-2]
    assert re.fullmatch(r"final model hash: [0-9a-f]{40}", lines[-1])
    assert tcli.main(argv + ["--fused-run", "--model", "mnist-mlp"]) == 0
    out = capsys.readouterr().out
    assert "Epoch: 0, Accuracy:" in out and "Epoch: 0, mean train loss:" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--epochs", "1", "--data-dir", str(split)])


def test_jax_checkpoint_format_unchanged(tmp_path):
    """The resume path reads the JAX package's writer's files: an
    epoch-boundary snapshot sets the next epoch (guards the shared format)."""
    from shallowspeed_tpu import model as jmodel

    spec = jmodel.make_model_spec(NARROW, 1, 128)
    path = tmp_path / "e.npz"
    jckpt.save_checkpoint(path, jmodel.init_model(spec), spec, epoch=4)
    split = _write_split(tmp_path, 256)
    ts = TorchSession(sizes=NARROW, device="cpu", data_dir=split, resume=path)
    assert (ts.epoch, ts.step_in_epoch, ts.batches_per_epoch) == (5, 0, 2)
