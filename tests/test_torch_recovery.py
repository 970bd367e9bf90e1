"""Crash recovery of the port: kill a run at a pinned step, resume from the
newest step checkpoint that verifies, and hold the result to an
uninterrupted twin — bitwise on the port's own paths, within the
cross-engine class across the two frameworks.

The contract is the JAX package's (``tests/test_recovery.py``): chunked
``train_steps`` applies the same per-batch updates in the same order as
whole epochs, and a v2 snapshot holds the whole resumable state (params,
optimizer state, step cursor), so a killed-and-resumed run's weight hash is
its twin's. Here on the four training paths of the port — the microbatch
loop, the fused train kernel's plain version per batch (Adam, with its
mirrors and step count) and per epoch, the DP=2 x PP=4 executor through
the flag entries and the interleaved DP=2 x PP=2 x V=2 one (whose stacked
rows are in the device-major order, and whose snapshots are logical) — and
through the CLI with a real SIGKILL.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import faults
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import (
    CheckpointError,
    list_step_checkpoints,
    step_checkpoint_path,
    verify_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 32
BATCHES = 6  # batches per epoch: step 8 is epoch 1, step 2
EPOCHS = 2
EVERY = 4  # the step grid
RTOL, ATOL = 2e-4, 2e-6  # cross-engine class (test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # the executor's cross-layout class

PATHS = {
    "sequential": dict(),
    "fused-megakernel-adam": dict(
        fuse_mubatches=True, megakernel=True, optimizer="adam", lr=5e-5
    ),
    "fused-epoch-kernel": dict(fuse_mubatches=True, epoch_kernel=True),
    "dp2xpp4-pallas": dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas"),
    "dp2xpp2xv2-interleaved-pallas": dict(
        dp=2, pp=2, schedule="interleaved", virtual_stages=2, kernel_backend="pallas"
    ),
}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("recovery_split")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", BATCHES * GBS + 5), ("val", 40)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, SIZES[0]).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


@pytest.fixture(scope="module")
def wide_split(tmp_path_factory):
    """The CLI trains the flagship: a 784-wide split of the same shape."""
    path = tmp_path_factory.mktemp("recovery_wide_split")
    rng = np.random.RandomState(1)
    for suffix, n in (("train", BATCHES * GBS + 5), ("val", 40)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


def _session(split, cls=TorchSession, **kw):
    kw.setdefault("sizes", SIZES)
    kw.setdefault("global_batch_size", GBS)
    kw.setdefault("lr", 0.01)
    if cls is TorchSession:
        kw["device"] = "cpu"
    return cls(data_dir=split, **kw)


def _drive(run, target=EPOCHS, every=EVERY):
    """The CLI's step loop: chunks cut at the grid, a snapshot on it."""
    nb = run.batches_per_epoch
    while run.epoch < target:
        n = min(every - run.global_step % every, nb - run.step_in_epoch)
        run.train_steps(n)
        if run.global_step % every == 0:
            run.save_step_checkpoint()


def _twin(split, **kw):
    run = _session(split, **kw)
    for _ in range(EPOCHS):
        run.train_epoch()
    return run


def _flat(params):
    return np.concatenate([l[k].ravel() for st in params for l in st for k in ("W", "b")])


@pytest.mark.parametrize("path", list(PATHS))
def test_kill_and_resume_is_bitwise_the_twin(split, tmp_path, path):
    """``die@step=11`` (exc) on a run saving every 4 steps, then
    ``resume="auto"``: it restores step 8 (epoch 1, step 2) and finishes
    bitwise equal to the uninterrupted twin, optimizer state included."""
    kw = PATHS[path]
    twin = _twin(split, **kw)
    ck = tmp_path / "ck"
    killed = _session(split, checkpoint_dir=ck, faults="die@step=11", **kw)
    with pytest.raises(faults.InjectedFault, match="die@step=11"):
        _drive(killed)
    assert killed.global_step == 11
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [4, 8]
    resumed = _session(split, checkpoint_dir=ck, resume="auto", **kw)
    assert resumed.resumed_from == str(step_checkpoint_path(ck, 8))
    assert (resumed.epoch, resumed.step_in_epoch) == (1, 2)
    _drive(resumed)
    assert resumed.model_hash() == twin.model_hash()
    if twin.opt_state_logical() is not None:
        assert _flat(resumed.opt_state_logical()["parts"]["m"]).tobytes() == _flat(
            twin.opt_state_logical()["parts"]["m"]
        ).tobytes()
        assert resumed.opt_state_logical()["scalars"] == {"t": float(EPOCHS * BATCHES)}


def test_resume_auto_edge_cases(split, tmp_path):
    """A corrupt newest snapshot is skipped; an empty directory is a fresh
    start; a directory where nothing verifies is unrecoverable; auto needs
    a directory."""
    ck = tmp_path / "ck"
    run = _session(split, checkpoint_dir=ck)
    hashes = {}
    for _ in range(3):
        run.train_steps(2)
        run.save_step_checkpoint()
        hashes[run.global_step] = run.model_hash()
    faults.corrupt_checkpoint_bytes(step_checkpoint_path(ck, 6))
    res = _session(split, checkpoint_dir=ck, resume="auto")
    assert res.resumed_from == str(step_checkpoint_path(ck, 4))
    assert res.model_hash() == hashes[4] and (res.epoch, res.step_in_epoch) == (0, 4)

    fresh = _session(split, checkpoint_dir=tmp_path / "empty", resume="auto")
    assert fresh.resumed_from is None and fresh.global_step == 0
    assert fresh.model_hash() == _session(split).model_hash()

    for step in (2, 4):
        faults.corrupt_checkpoint_bytes(step_checkpoint_path(ck, step))
    with pytest.raises(CheckpointError, match="no snapshot verifies") as e:
        _session(split, checkpoint_dir=ck, resume="auto")
    assert "step-00000002.npz" in str(e.value) and "step-00000006.npz" in str(e.value)
    with pytest.raises(ValueError, match="pass checkpoint_dir"):
        _session(split, resume="auto")


def test_nan_snapshot_is_skipped_and_never_rotates_the_last_finite_out(split, tmp_path):
    """``nan@step=5`` blows the run up: every grid save after it carries
    ``all_finite: false`` and rotates nothing (keep=2), discovery skips
    them, and the next finite save's rotation reclaims the non-finite pile,
    never the last finite snapshot."""
    ck = tmp_path / "ck"
    run = _session(split, checkpoint_dir=ck, checkpoint_keep=2, faults="nan@step=5")
    _drive(run, every=2)
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [2, 4, 6, 8, 10, 12]
    assert verify_checkpoint(step_checkpoint_path(ck, 6))["all_finite"] is False
    assert verify_checkpoint(step_checkpoint_path(ck, 4))["all_finite"] is True
    res = _session(split, checkpoint_dir=ck, checkpoint_keep=2, resume="auto")
    assert res.resumed_from == str(step_checkpoint_path(ck, 4))
    assert np.isfinite(_flat(res.params())).all()
    res.train_steps(2)
    res.save_step_checkpoint()  # finite again: rotation ranks usable first
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [4, 6]
    assert verify_checkpoint(step_checkpoint_path(ck, 6), require_finite=True)


def test_composed_faults_at_one_step_all_fire_and_a_later_one_cuts_the_chunk(split):
    """``nan`` and ``flip`` at step 3 both fire before it, in spec order;
    ``die@step=5`` cuts a 6-step chunk at step 5 and fires on the next call."""
    run = _session(split, faults="flip@step=3,nan@step=3,die@step=5")
    assert run.train_steps(6) == (3, None)
    assert run.train_steps(6) == (2, None)  # both step-3 faults fired
    assert [repr(f) for f in run._faults.pending] == ["die@step=5:mode=exc"]
    assert not np.isfinite(_flat(run.params())).all()
    with pytest.raises(faults.InjectedFault):
        run.train_steps(1)
    assert run.global_step == 5 and not run._faults.pending


@pytest.mark.parametrize("entry", ["train_epoch", "train_run"])
def test_pending_faults_refuse_the_stepless_entry_points(split, entry):
    run = _session(split, fuse_mubatches=True, run_kernel=True, faults="die@step=3")
    with pytest.raises(ValueError, match="drive this run with train_steps"):
        getattr(run, entry)(*([] if entry == "train_epoch" else [1]))
    assert run.global_step == 0


def test_async_die_at_save_leaves_4_and_8_and_resumes_bitwise(split, tmp_path):
    """``die@save=2`` under the async writer kills save 2 (step 12) in its
    window; the failure surfaces on the training thread (at the next save,
    here at ``close``), ``[4, 8]`` stay, and the resume is bitwise the
    twin."""
    ck = tmp_path / "ck"
    run = _session(split, checkpoint_dir=ck, async_checkpoint=True, faults="die@save=2")
    _drive(run)  # save 2 is the run's last: the failure waits for close
    with pytest.raises(faults.InjectedFault, match="die@save=2"):
        run.close()
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [4, 8]
    assert list(ck.glob("*.tmp")) == []
    resumed = _session(split, checkpoint_dir=ck, resume="auto")
    _drive(resumed)
    assert resumed.model_hash() == _twin(split).model_hash()


def test_elastic_resume_dp2xpp4_to_sequential(split, tmp_path):
    """Killed at DP=2 x PP=4, resumed sequentially: bitwise at the restore
    (the snapshot is logical), then within the executor's cross-layout
    class of the uninterrupted mesh run."""
    mesh = PATHS["dp2xpp4-pallas"]
    ck = tmp_path / "ck"
    killed = _session(split, checkpoint_dir=ck, faults="die@step=11", **mesh)
    hashes = {}
    nb = killed.batches_per_epoch
    with pytest.raises(faults.InjectedFault):
        while True:
            killed.train_steps(min(EVERY - killed.global_step % EVERY, nb - killed.step_in_epoch))
            if killed.global_step % EVERY == 0:
                killed.save_step_checkpoint()
                hashes[killed.global_step] = killed.model_hash()
    resumed = _session(split, checkpoint_dir=ck, resume="auto")
    assert resumed.sequential and resumed.model_hash() == hashes[8]
    _drive(resumed)
    np.testing.assert_allclose(
        _flat(resumed.params()), _flat(_twin(split, **mesh).params()),
        rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL,
    )


def test_round_trip_between_the_frameworks(split, tmp_path):
    """JAX trains an epoch and saves; the port resumes: the hash at the
    handover is equal and the next epoch stays within the cross-engine
    class. The reverse from a mid-epoch step checkpoint of the port."""
    js = _session(split, cls=JaxSession)
    js.train_epoch()
    js.save(tmp_path / "jax.npz")
    ts = _session(split, resume=tmp_path / "jax.npz")
    assert ts.model_hash() == js.model_hash() and ts.epoch == js.epoch == 1
    js.train_epoch()
    ts.train_epoch()
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)

    ts = _session(split, optimizer="momentum", checkpoint_dir=tmp_path / "ck")
    ts.train_steps(3)
    path = ts.save_step_checkpoint()
    js = _session(split, cls=JaxSession, optimizer="momentum", resume=path)
    assert js.model_hash() == ts.model_hash()
    assert (js.epoch, js.step_in_epoch) == (ts.epoch, ts.step_in_epoch) == (0, 3)
    js.train_steps(BATCHES)
    ts.train_steps(BATCHES)
    assert ts.epoch == js.epoch == 1
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)


def test_interleaved_checkpoints_round_trip_between_the_frameworks(split, tmp_path):
    """An interleaved DP=2 x PP=2 x V=2 checkpoint, both ways: JAX writes
    an epoch snapshot (momentum state included) and the port resumes it
    with the same hash and state, then the port writes a mid-epoch step
    snapshot and JAX resumes that; each next stretch stays within the
    cross-engine class."""
    kw = dict(PATHS["dp2xpp2xv2-interleaved-pallas"], optimizer="momentum")
    js = _session(split, cls=JaxSession, **kw)
    js.train_epoch()
    js.save(tmp_path / "jax.npz")
    ts = _session(split, resume=tmp_path / "jax.npz", **kw)
    assert ts.model_hash() == js.model_hash() and ts.epoch == js.epoch == 1
    assert _flat(ts.opt_state_logical()["parts"][""]).tobytes() == _flat(
        js.opt_state_logical()["parts"][""]
    ).tobytes()
    js.train_epoch()
    ts.train_epoch()
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)

    ts = _session(split, checkpoint_dir=tmp_path / "ck", **kw)
    ts.train_steps(3)
    path = ts.save_step_checkpoint()
    js = _session(split, cls=JaxSession, resume=path, **kw)
    assert js.model_hash() == ts.model_hash()
    assert (js.epoch, js.step_in_epoch) == (ts.epoch, ts.step_in_epoch) == (0, 3)
    js.train_steps(BATCHES)
    ts.train_steps(BATCHES)
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)


def _cli(split, ck, *extra):
    return [
        "--device", "cpu", "--data-dir", str(split), "--epochs", str(EPOCHS),
        "--global-batch-size", str(GBS), "--no-eval", "--checkpoint-dir", str(ck),
        "--checkpoint-every-steps", str(EVERY), *extra,
    ]


def _hash_line(out):
    lines = out.splitlines()
    assert re.fullmatch(r"final model hash: [0-9a-f]{40}", lines[-1]), lines[-3:]
    assert "Accuracy:" in lines[-2]
    return lines[-1]


def test_cli_sigkill_then_resume_auto_prints_the_twin_hash(wide_split, tmp_path, capsys):
    """A real SIGKILL at step 11 in a subprocess (exit -9), then
    ``--resume auto``: ``resumed at epoch 1, step 2`` and the twin's
    ``final model hash:`` line."""
    epoch_file = tmp_path / "epoch.npz"
    assert tcli.main(_cli(wide_split, tmp_path / "twin", "--checkpoint", str(epoch_file))) == 0
    twin = _hash_line(capsys.readouterr().out)
    # --checkpoint: the epoch-boundary snapshot after the last epoch
    saved = TorchSession(device="cpu", data_dir=wide_split, global_batch_size=GBS, resume=epoch_file)
    assert saved.epoch == EPOCHS and twin == f"final model hash: {saved.model_hash()}"
    ck = tmp_path / "ck"
    env = dict(os.environ, SHALLOWSPEED_FAULTS="die@step=11:mode=sigkill")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-m", "shallowspeed_tpu_torch.train", *_cli(wide_split, ck)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -9, proc.stderr
    assert "final model hash" not in proc.stdout
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [4, 8]
    assert tcli.main(_cli(wide_split, ck, "--resume", "auto")) == 0
    out = capsys.readouterr().out
    assert "resumed at epoch 1, step 2" in out
    assert _hash_line(out) == twin
    assert tcli.main(_cli(wide_split, tmp_path / "none", "--resume", "auto")) == 0
    assert "no resumable checkpoint found — fresh start" in capsys.readouterr().out


def test_cli_exit_code_4_on_a_directory_of_corrupt_snapshots(wide_split, tmp_path, capsys):
    ck = tmp_path / "ck"
    run = TorchSession(device="cpu", data_dir=wide_split, global_batch_size=GBS, checkpoint_dir=ck)
    for _ in range(2):
        run.train_steps(1)
        faults.corrupt_checkpoint_bytes(run.save_step_checkpoint())
    assert tcli.main(_cli(wide_split, ck, "--resume", "auto")) == 4
    assert "CHECKPOINT UNRECOVERABLE:" in capsys.readouterr().err


@pytest.mark.parametrize(
    "argv, env, match",
    [
        (["--checkpoint-every-steps", "-1"], None, "must be >= 0"),
        (["--checkpoint-every-steps", "4"], None, "needs --checkpoint-dir"),
        (["--checkpoint-dir", "ck", "--checkpoint-every-steps", "4", "--fused-run"], None,
         "incompatible with --fused-run"),
        (["--resume", "auto"], None, "discovers snapshots in --checkpoint-dir"),
        (["--async-checkpoint"], None, "--async-checkpoint needs --checkpoint-dir"),
        (["--checkpoint-dir", "ck", "--resume", "auto", "--fused-run"], None,
         "no mid-epoch entry point"),
        (["--keep", "0"], None, "--keep must be >= 1"),
        (["--fused-run"], "die@step=3", "SHALLOWSPEED_FAULTS"),
    ],
)
def test_cli_parse_time_refusals(argv, env, match, capsys, monkeypatch):
    """The root CLI's refusals, before any device or data is touched."""
    if env:
        monkeypatch.setenv("SHALLOWSPEED_FAULTS", env)
    with pytest.raises(SystemExit) as e:
        tcli.main(["--data-dir", "/nonexistent", *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err
