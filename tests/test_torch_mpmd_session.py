"""``TrainingSession(runtime="mpmd")`` and the CLI's ``--runtime`` in the port,
against the port's lockstep session and the JAX session's words.

- Training: two epochs under mpmd end on the lockstep session's
  ``model_hash()`` (bitwise params and momentum), with the same losses;
  ``train_steps`` chunks are the same steps.
- Serving: ``predict`` under mpmd is bitwise the lockstep ``predict``, and
  ``predict_async`` one slot at a time is bitwise ``predict``, also after
  a hot reload replaces the weights.
- The envelope: every refusal raises the JAX session's ``ValueError`` text
  (the JAX session on the same arguments), ``train_run`` likewise;
  ``predict_async`` outside mpmd and with too many rows refuses.
- Checkpoints: an async step snapshot equals the sync one array for array;
  a run killed under one runtime resumes under the other on its
  uninterrupted twin's hash (mpmd -> lockstep in tier 1, the other
  direction ``slow``).
- The CLI: ``--runtime mpmd`` prints the lockstep run's hash line; its
  three refusals exit 2 with the root CLI's error line.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import load_checkpoint
from shallowspeed_tpu_torch.faults import InjectedFault

ROOT = Path(__file__).resolve().parent.parent
BASE = dict(pp=4, schedule="gpipe", global_batch_size=32, mubatches=4)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_mpmd.py's split: 128 training rows (4 batches of 32) and
    64 validation rows, 784 wide."""
    d = tmp_path_factory.mktemp("mpmd_data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 64)):
        np.save(d / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(d / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return d


def _session(data_dir, runtime, **kw):
    return TorchSession(device="cpu", data_dir=data_dir, runtime=runtime, **dict(BASE, **kw))


def _bitwise(a, b):
    return all(
        np.array_equal(la[k], lb[k])
        for sa, sb in zip(a, b)
        for la, lb in zip(sa, sb)
        for k in ("W", "b")
    )


@pytest.fixture(scope="module")
def twins(data_dir):
    """Lockstep and mpmd sessions (momentum), two epochs each, the losses."""
    out = {}
    for rt in ("lockstep", "mpmd"):
        s = _session(data_dir, rt, optimizer="momentum", lr=0.005)
        out[rt] = (s, [s.train_epoch() for _ in range(2)])
    return out


def test_session_hash_losses_and_state_equal_lockstep(twins):
    (a, la), (b, lb) = twins["lockstep"], twins["mpmd"]
    assert b.runtime == "mpmd" and b._mpmd.dispatch_count > 0
    assert la == lb
    assert a.model_hash() == b.model_hash()
    assert _bitwise(a.params(), b.params())
    oa, ob = a.opt_state_logical(), b.opt_state_logical()
    assert _bitwise(oa["parts"][""], ob["parts"][""])
    # 8 steps: per batch 4 x (fwd + bwd) cells a stage, 4 updates, 1 loss sync
    assert b._mpmd.dispatch_count == 8 * (4 * 4 * 2 + 4 + 1)
    assert b._mpmd.relay_count == 8 * 2 * 3 * 4


def test_predict_and_predict_async_bitwise_lockstep(twins, data_dir, tmp_path):
    (a, _), (b, _) = twins["lockstep"], twins["mpmd"]
    x = np.random.RandomState(1).rand(50, 784).astype(np.float32)
    want = a.predict(x)
    assert np.array_equal(b.predict(x), want)
    S = b.slot_rows
    resolvers = [b.predict_async(x[i : i + S]) for i in range(0, 48, S)]
    got = np.concatenate([r() for r in resolvers], axis=0)
    assert np.array_equal(got, want[:48])
    one = b.predict_async(x[:3])()
    assert one.shape == (3, 10) and np.array_equal(one, b.predict(x[:3]))
    # a hot reload replaces the stacked tensors: the cached views follow
    fresh = _session(data_dir, "lockstep")
    fresh.train_epoch()
    path = tmp_path / "fresh.npz"
    fresh.save(path)
    b2 = _session(data_dir, "mpmd")
    b2.train_steps(2)
    b2.predict(x[:8])
    b2.load_weights(path)
    assert np.array_equal(b2.predict_async(x[:8])(), fresh.predict(x[:8]))
    assert np.array_equal(b2.predict(x), fresh.predict(x))


def test_train_steps_chunks_are_one_epoch(data_dir, twins):
    s = _session(data_dir, "mpmd", optimizer="momentum", lr=0.005)
    assert s.train_steps(3) == (3, None)
    steps, loss = s.train_steps(5)
    assert steps == 1 and loss == pytest.approx(twins["mpmd"][1][0], rel=1e-6)
    s.train_steps(4)
    assert s.model_hash() == twins["lockstep"][0].model_hash()


ENVELOPE = [
    # (options, words of the refusal)
    (dict(pp=1, dp=1), "the sequential path has no stages"),
    (dict(zero1=True), "does not support zero (stage 1)"),
    (dict(dp=2, zero=3), "does not support zero (stage 3)"),
    (dict(grad_bucket_bytes=1024), "does not support grad_bucket_bytes"),
    (dict(clip_norm=0.1), "does not support clip_norm"),
    (dict(kernel_backend="pallas"), "kernel_backend='pallas' is lockstep-only"),
    (dict(record_steps=True), "per-step flight aux"),
    (dict(digests=True), "per-step digest aux"),
    (dict(runtime="zigzag"), "runtime must be 'lockstep' or 'mpmd'"),
]


@pytest.mark.parametrize("case", range(len(ENVELOPE)))
def test_envelope_refusals_in_the_jax_words(case, data_dir):
    kw, words = ENVELOPE[case]
    kw = dict(dict(BASE, data_dir=data_dir, runtime="mpmd"), **kw)
    with pytest.raises(ValueError) as got:
        TorchSession(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        JaxSession(**kw)
    assert words in str(got.value)
    assert str(got.value) == str(want.value)


def test_train_run_and_predict_async_refusals(data_dir):
    s = _session(data_dir, "mpmd")
    j = JaxSession(data_dir=data_dir, runtime="mpmd", **BASE)
    for sess in (s, j):
        with pytest.raises(ValueError, match="train_epoch") as e:
            sess.train_run(1)
        if sess is s:
            got = str(e.value)
    assert got == str(e.value)
    for kw in (dict(BASE), dict(BASE, pp=1, dp=1)):
        lock = TorchSession(device="cpu", **kw)
        with pytest.raises(ValueError, match="runtime='mpmd'"):
            lock.predict_async(np.zeros((1, 784), np.float32))
    with pytest.raises(ValueError, match="one slot"):
        s.predict_async(np.zeros((s.slot_rows + 1, 784), np.float32))
    with pytest.raises(ValueError, match="one slot"):
        s.predict_async(np.zeros((0, 784), np.float32))


def test_session_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(runtime="mpmd", **BASE)


def test_async_step_checkpoint_equals_sync(data_dir, tmp_path):
    paths = {}
    for name, async_ in (("sync", False), ("async", True)):
        run = _session(data_dir, "mpmd", optimizer="momentum", lr=0.005,
                       checkpoint_dir=tmp_path / name, async_checkpoint=async_)
        run.train_steps(2)
        paths[name] = run.save_step_checkpoint()
        run.drain_checkpoints()
        run.close()
    a = load_checkpoint(paths["sync"], 4, 32, with_opt_state=True)
    b = load_checkpoint(paths["async"], 4, 32, with_opt_state=True)
    assert _bitwise(a[0], b[0])
    assert _bitwise(a[3]["parts"][""], b[3]["parts"][""])
    assert a[2]["global_step"] == b[2]["global_step"] == 2


@pytest.mark.parametrize(
    "killed,resumed",
    [("mpmd", "lockstep"), pytest.param("lockstep", "mpmd", marks=pytest.mark.slow)],
)
def test_kill_and_resume_across_runtimes(killed, resumed, data_dir, tmp_path):
    """A run killed at step 3 under one runtime (its chunk cut at the
    fault, a snapshot after each chunk) resumes under the other from its
    step-3 snapshot and ends on the uninterrupted twin's hash."""
    twin = _session(data_dir, resumed, optimizer="momentum", lr=0.005)
    for _ in range(2):
        twin.train_epoch()
    ck = tmp_path / "ck"
    run = _session(data_dir, killed, optimizer="momentum", lr=0.005, checkpoint_dir=ck,
                   faults="die@step=3")
    with pytest.raises(InjectedFault):
        while run.epoch < 2:
            run.train_steps(2)
            run.save_step_checkpoint()
    res = _session(data_dir, resumed, optimizer="momentum", lr=0.005, checkpoint_dir=ck,
                   resume="auto")
    assert res.resumed_from is not None and res.global_step == 3
    while res.epoch < 2:
        res.train_steps(2)
    assert res.model_hash() == twin.model_hash()


def _cli_lines(capsys, argv):
    assert tcli.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_cli_runtime_mpmd_prints_the_lockstep_hash(data_dir, capsys):
    argv = ["--device", "cpu", "--data-dir", str(data_dir), "--epochs", "1", "--no-eval",
            "--pp", "4", "--schedule", "gpipe", "--global-batch-size", "32"]
    lock = _cli_lines(capsys, argv)
    mp = _cli_lines(capsys, argv + ["--runtime", "mpmd"])
    assert "layout: DP=1 x PP=4 x TP=1 (gpipe pipeline, mpmd runtime) batches/epoch=4" in mp[0]
    assert mp[-1].startswith("final model hash: ") and mp[-1] == lock[-1]


@pytest.mark.parametrize(
    "argv",
    [
        ["--runtime", "mpmd"],
        ["--runtime", "mpmd", "--pp", "2", "--fused-run"],
        ["--runtime", "mpmd", "--dp", "2", "--pp", "2", "--zero", "2"],
    ],
    ids=["sequential", "fused-run", "zero"],
)
def test_cli_runtime_refusals_exit_2_in_the_root_words(argv, capsys):
    """Each refusal exits 2 at parse time; its error line is the root
    CLI's (which refuses before it imports JAX)."""
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(argv)
    assert e.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    root = subprocess.run(
        [sys.executable, str(ROOT / "train.py"), *argv],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert root.returncode == 2
    want = root.stderr.strip().splitlines()[-1]
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]
