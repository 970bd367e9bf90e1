"""The slice as a whole: the port's ``TrainingSession`` on a mesh layout and
its training CLI against the JAX package's, on the same synthetic split.

The port runs its lockstep executor on the CPU (every virtual rank on the
one device, the flag kernels' plain versions); the JAX session runs its
``shard_map`` executor on the 8-device virtual CPU mesh. Full flagship
width, DP=2 x PP=4 GPipe with ``kernel_backend="pallas"``: losses and
params within the cross-engine class ``rtol=2e-4, atol=2e-6``, accuracies
within one sample, ``predict`` within 1e-6 on the same weights.
"""

import re

import numpy as np
import pytest
import torch

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession

RTOL, ATOL = 2e-4, 2e-6
MESH = dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas")
N_VAL = 300


def _write_split(path, n_train, n_val=N_VAL, seed=0):
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
        assert len(sa) == len(sb)
        for la, lb in zip(sa, sb):
            np.testing.assert_allclose(la["W"], lb["W"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(la["b"], lb["b"], rtol=RTOL, atol=ATOL)


def _bitwise(a, b):
    return all(
        np.array_equal(la[k], lb[k])
        for sa, sb in zip(a, b)
        for la, lb in zip(sa, sb)
        for k in ("W", "b")
    )


@pytest.fixture(scope="module")
def trained(split):
    """Both sessions, 2 epochs each with accuracy() after every epoch."""
    js = JaxSession(data_dir=split, **MESH)
    ts = TorchSession(data_dir=split, device="cpu", **MESH)
    out = {"jax": (js, [], []), "torch": (ts, [], [])}
    for _ in range(2):
        for s, losses, accs in out.values():
            losses.append(s.train_epoch())
            accs.append(s.accuracy())
    return out


def test_two_epochs_match_jax(trained):
    js, jl, ja = trained["jax"]
    ts, tl, ta = trained["torch"]
    assert ts.batches_per_epoch == js.batches_per_epoch == 8
    assert (ts.epoch, ts.step_in_epoch, ts.global_step) == (2, 0, 16)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert all(abs(a - b) * N_VAL <= 1.0 + 1e-9 for a, b in zip(ta, ja)), (ta, ja)
    _assert_params_close(ts.params(), js.params())


def test_predict_matches_jax(trained, tmp_path):
    """``predict`` packs ladder rungs into the inference program: within the
    params class after training, and within 1e-6 on the JAX session's own
    weights (swapped in through its checkpoint)."""
    js, ts = trained["jax"][0], trained["torch"][0]
    x = np.random.RandomState(3).rand(45, 784).astype(np.float32)
    assert ts.slot_rows == js.slot_rows == 8 and ts.slot_ladder == js.slot_ladder
    want = js.predict(x)
    np.testing.assert_allclose(ts.predict(x), want, rtol=RTOL, atol=ATOL)
    path = tmp_path / "jax.npz"
    js.save(path)
    view = TorchSession(device="cpu", **MESH)
    view.load_weights(path)
    got = view.predict(x)
    assert got.shape == (45, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a whole slot gives the same bits in any rung's program (rung 1 here,
    # rung 8 above); the softmax's stability max spans a slot's microbatch
    np.testing.assert_array_equal(view.predict(x[:8]), got[:8])
    assert view.predict(np.zeros((0, 784), np.float32)).shape == (0, 10)
    big = np.random.RandomState(4).rand(8 * 16 + 3, 784).astype(np.float32)
    np.testing.assert_allclose(view.predict(big), js.predict(big), rtol=0, atol=1e-6)


def test_train_steps_in_two_chunks_is_one_epoch_bitwise(split):
    whole = TorchSession(data_dir=split, device="cpu", **MESH)
    loss = whole.train_epoch()
    chunked = TorchSession(data_dir=split, device="cpu", **MESH)
    assert chunked.train_steps(3) == (3, None)
    assert chunked.step_in_epoch == 3
    with pytest.raises(ValueError, match="mid-flight"):
        chunked.train_epoch()
    steps, chunk_loss = chunked.train_steps(100)
    assert steps == 5 and chunked.epoch == 1 and chunked.step_in_epoch == 0
    assert _bitwise(chunked.params(), whole.params())
    assert chunk_loss == pytest.approx(loss, rel=1e-6)


@pytest.mark.parametrize(
    "opt,lr,clip",
    [("momentum", 0.006, None), ("adam", 2e-4, 0.05)],
    ids=["momentum", "adam-clip"],
)
def test_stateful_optimizer_state_and_resume_match_jax(split, tmp_path, opt, lr, clip):
    """``opt_state_logical`` after 3 steps matches the JAX session's; a
    session resumed from the JAX session's mid-epoch snapshot carries its
    optimizer state and cursor on, and finishes the epoch as it does."""
    kw = dict(data_dir=split, optimizer=opt, lr=lr, clip_norm=clip, **MESH)
    js = JaxSession(**kw, checkpoint_dir=tmp_path / "ck")
    ts = TorchSession(device="cpu", **kw)
    js.train_steps(3)
    ts.train_steps(3)
    jstate, tstate = js.opt_state_logical(), ts.opt_state_logical()
    assert set(tstate["parts"]) == set(jstate["parts"])
    assert tstate["scalars"] == pytest.approx(jstate["scalars"])
    for k in jstate["parts"]:
        _assert_params_close(tstate["parts"][k], jstate["parts"][k])
    path = js.save_step_checkpoint()
    resumed = TorchSession(device="cpu", resume=path, **kw)
    assert (resumed.epoch, resumed.step_in_epoch) == (0, 3)
    assert resumed.opt_state_logical()["scalars"] == jstate["scalars"]
    for k in jstate["parts"]:
        assert _bitwise(resumed.opt_state_logical()["parts"][k], jstate["parts"][k])
    js.train_steps(5)
    steps, _ = resumed.train_steps(5)
    assert steps == 5 and resumed.epoch == 1
    _assert_params_close(resumed.params(), js.params())


def test_train_run_with_eval_matches_jax(split):
    """The evaluated run: each epoch followed by the whole split through
    one padded inference microbatch (the JAX session's fused-run eval)."""
    kw = dict(data_dir=split, **MESH)
    js = JaxSession(**kw)
    ts = TorchSession(device="cpu", **kw)
    jl, ja = js.train_run(1)
    tl, ta = ts.train_run(1)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert abs(ta[0] - ja[0]) * N_VAL <= 1.0 + 1e-9
    assert ts.epoch == 1
    losses, accs = ts.train_run(1, with_eval=False)
    assert accs is None and len(losses) == 1 and ts.epoch == 2


def test_xla_backend_is_the_pallas_backend_bitwise(split):
    a = TorchSession(data_dir=split, device="cpu", **dict(MESH, kernel_backend="xla"))
    b = TorchSession(data_dir=split, device="cpu", **MESH)
    assert a.train_steps(2) == b.train_steps(2)
    assert _bitwise(a.params(), b.params())


def test_refusals(split):
    """The JAX session's refusals with its words, and what this slice
    leaves out with a pointer to its ROADMAP.md item."""
    with pytest.raises(ValueError, match="needs a mesh layout"):
        TorchSession(device="cpu", kernel_backend="pallas")
    with pytest.raises(ValueError, match="fuse_mubatches applies to the sequential path only"):
        TorchSession(device="cpu", fuse_mubatches=True, **MESH)
    with pytest.raises(ValueError, match="requires fuse_mubatches=True"):
        TorchSession(device="cpu", megakernel=True, **MESH)
    for flag in ("megakernel", "epoch_kernel", "run_kernel"):
        with pytest.raises(ValueError, match="fuse_mubatches applies"):
            TorchSession(device="cpu", fuse_mubatches=True, **{flag: True}, **MESH)
    with pytest.raises(ValueError, match="hard-codes the relu/identity slot"):
        TorchSession(device="cpu", model="transformer", **MESH)
    # the schedule lattice is ported: the gelu family on the mesh, split,
    # recompute and interleaving build (the JAX refusals are in
    # tests/test_torch_split_recompute.py and test_torch_mesh_gelu.py)
    TorchSession(device="cpu", model="transformer", **dict(MESH, kernel_backend="xla"))
    with pytest.raises(ValueError, match="requires schedule='interleaved'"):
        TorchSession(device="cpu", **dict(MESH, virtual_stages=2))
    # ZeRO and the bucketed sync are ported: every stage builds (the JAX
    # refusals are in tests/test_torch_zero.py); so is tp, on the plain
    # backend (its refusals are in tests/test_torch_tensor_parallel.py)
    for kw in (
        dict(zero=1), dict(zero1=True), dict(zero=2), dict(grad_bucket_bytes=1 << 16),
        dict(zero=2, grad_bucket_bytes=1 << 16), dict(zero=3, kernel_backend="xla"),
    ):
        TorchSession(device="cpu", data_dir=split, **dict(MESH, **kw))
    with pytest.raises(ValueError, match="tensor parallelism"):
        TorchSession(device="cpu", data_dir=split, **dict(MESH, tp=2))
    assert TorchSession(device="cpu", data_dir=split, **dict(MESH, tp=2, kernel_backend="xla")).tp == 2
    with pytest.raises(NotImplementedError, match="§A item 7\\)"):
        TorchSession(device="cpu", runtime="mpmd", **MESH)
    with pytest.raises(ValueError, match="schedule must be one of"):
        TorchSession(device="cpu", **dict(MESH, schedule="zigzag"))
    with pytest.raises(ValueError, match="divisible by dp"):
        TorchSession(device="cpu", **dict(MESH, dp=3))
    with pytest.raises(ValueError, match="mubatches must divide the local batch"):
        TorchSession(device="cpu", mubatches=3, **MESH)
    with pytest.raises(ValueError, match="multiple of dp"):
        TorchSession(device="cpu", predict_slot_rows=7, **MESH)


@pytest.mark.parametrize(
    "dp,pp,schedule", [(4, 1, "naive"), (1, 4, "naive"), (1, 4, "pipedream")]
)
def test_reference_layouts_train_one_step_like_jax(split, dp, pp, schedule):
    """The other reference layouts (and PipeDream-Flush) through the session."""
    kw = dict(data_dir=split, dp=dp, pp=pp, schedule=schedule, kernel_backend="pallas")
    js, ts = JaxSession(**kw), TorchSession(device="cpu", **kw)
    js.train_steps(1)
    ts.train_steps(1)
    _assert_params_close(ts.params(), js.params())


@pytest.fixture(scope="module")
def chip_split(tmp_path_factory):
    """chip_smoke.py's split (16 batches of 128, 1000 validation rows) and a
    copy whose inputs are scaled by ``1 + 1e-7 * N(0, 1)``: about one
    float32 rounding, what two engines' different summation orders leave."""
    base = _write_split(tmp_path_factory.mktemp("chip"), 16 * 128, 1000)
    perturbed = _write_split(tmp_path_factory.mktemp("perturbed"), 16 * 128, 1000)
    x = np.load(perturbed / "x_train.npy")
    noise = np.random.RandomState(1).randn(*x.shape)
    np.save(perturbed / "x_train.npy", (x * (1 + 1e-7 * noise)).astype(np.float32))
    return base, perturbed


# (lr, clip, whether 4 Adam steps stay in the cross-engine class under the
# perturbation). A clip of 0.01 binds on every batch (the flagship's
# gradient norm is ~0.048 there); at lr 2e-4 it lifts Adam's eps to ~5e-8
# against gradients of which a third are below 1e-7, and one rounding on
# the inputs moves the params ~3.7e-4. chip_smoke.py phase 9b therefore
# holds its Adam+clip run card-vs-CPU at lr 5e-5.
ADAM_CLIP_RECIPES = [
    (2e-4, None, True),
    (2e-4, 0.01, False),
    (2e-4, 0.02, True),
    (1e-4, 0.01, True),
    (5e-5, 0.01, True),
]


@pytest.mark.parametrize(
    "lr,clip,holds", ADAM_CLIP_RECIPES, ids=[f"lr{r[0]:g}-clip{r[1]}" for r in ADAM_CLIP_RECIPES]
)
def test_adam_with_binding_clip_conditioning(chip_split, lr, clip, holds):
    """Which Adam + clip recipes a card-vs-CPU comparison can hold to the
    cross-engine class: the same DP=2 x PP=4 session on the CPU from the
    same init, 4 steps on the split and on its perturbed copy."""
    runs = []
    for data_dir in chip_split:
        s = TorchSession(
            data_dir=data_dir, device="cpu", optimizer="adam", lr=lr, clip_norm=clip, **MESH
        )
        s.train_steps(4)
        runs.append(np.concatenate([l[k].ravel() for st in s.params() for l in st for k in ("W", "b")]))
    a, b = runs
    assert np.allclose(a, b, rtol=RTOL, atol=ATOL) == holds, float(np.abs(a - b).max())


def test_cli_trains_a_mesh_layout_on_cpu(split, capsys):
    argv = [
        "--device", "cpu", "--epochs", "1", "--data-dir", str(split),
        "--dp", "2", "--pp", "4", "--schedule", "gpipe", "--kernel-backend", "pallas",
    ]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "layout: DP=2 x PP=4 x TP=1 (gpipe pipeline) batches/epoch=8" in out
    assert "Epoch: 0, mean train loss:" in out
    lines = out.splitlines()
    assert "Epoch: 1, Time Spent:" in out and "Accuracy:" in lines[-3]
    assert lines[-2] == "DP replicas in sync ✓"
    assert re.fullmatch(r"final model hash: [0-9a-f]{40}", lines[-1])
    assert tcli.main(argv + ["--fused-run", "--no-eval"]) == 0
    assert "Epoch: 0, mean train loss:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs a mesh layout"):
        tcli.main(["--device", "cpu", "--data-dir", str(split), "--kernel-backend", "pallas"])


def test_cli_trains_a_tp_layout_on_cpu(split, capsys):
    """``--tp 2`` through the CLI: the root CLI's layout line, and the hash
    line of the same session driven directly."""
    argv = [
        "--device", "cpu", "--epochs", "1", "--no-eval", "--data-dir", str(split),
        "--dp", "2", "--pp", "2", "--tp", "2", "--zero", "2",
        "--precision", "highest", "--scan-unroll", "1", "--tick-unroll", "1",
    ]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "layout: DP=2 x PP=2 x TP=2 (naive pipeline + tensor-parallel) batches/epoch=8" in out
    lines = out.splitlines()
    assert lines[-2] == "DP replicas in sync ✓"
    s = TorchSession(data_dir=split, device="cpu", dp=2, pp=2, tp=2, zero=2, schedule="naive")
    s.train_epoch()
    assert lines[-1] == f"final model hash: {s.model_hash()}"
    assert tcli.main(["--device", "cpu", "--data-dir", str(split), "--epochs", "0", "--no-eval",
                      "--tp", "2"]) == 0
    assert "(tensor-parallel)" in capsys.readouterr().out


# The root CLI tests' command lines (tests/test_cli.py; without --audit,
# --runtime mpmd and --aot-cache, which the port refuses or lacks), each
# with None (parses) or the refusal the root CLI prints (exit 2)
ROOT_CLI_LINES = [
    (["--epochs", "2", "--global-batch-size", "32", "--mubatches", "2"], None),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--fuse-mubatches"], None),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--fuse-mubatches", "--epoch-kernel"], None),
    (["--dp", "2", "--pp", "2", "--schedule", "pipedream", "--epochs", "1",
      "--global-batch-size", "32", "--mubatches", "2", "--no-eval"], None),
    (["--dp", "2", "--epochs", "1", "--global-batch-size", "32", "--mubatches", "2",
      "--no-eval", "--grad-bucket-bytes", "65536"], None),
    (["--pp", "4", "--schedule", "pipedream", "--epochs", "1", "--global-batch-size", "32",
      "--mubatches", "2", "--no-eval", "--backward-split"], None),
    (["--dp", "2", "--pp", "2", "--schedule", "interleaved", "--virtual-stages", "2",
      "--zero1", "--optimizer", "momentum", "--epochs", "1", "--global-batch-size", "32",
      "--mubatches", "2", "--no-eval"], None),
    (["--dp", "2", "--pp", "2", "--optimizer", "momentum", "--epochs", "1",
      "--global-batch-size", "32", "--mubatches", "1", "--zero", "2", "--no-eval"], None),
    (["--dp", "2", "--pp", "2", "--optimizer", "momentum", "--epochs", "1",
      "--global-batch-size", "32", "--mubatches", "1", "--zero", "3"], None),
    (["--zero1", "--zero", "2"], "conflicting dp-stage selectors"),
    (["--zero", "3", "--dp", "2", "--fused-run"], "incompatible with --fused-run"),
    (["--zero", "3", "--dp", "2", "--kernel-backend", "pallas"],
     "incompatible with --kernel-backend pallas"),
    (["--zero", "3", "--dp", "2", "--grad-bucket-bytes", "1024"], "syncs gradients per tick"),
    (["--zero", "2", "--dp", "2", "--digests"], "--digests is incompatible"),
    (["--dp", "2", "--pp", "2", "--schedule", "gpipe", "--epochs", "1",
      "--global-batch-size", "32", "--mubatches", "2", "--no-eval", "--kernel-backend",
      "pallas"], None),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--clip-norm", "0.5", "--weight-decay", "0.01", "--optimizer", "momentum", "--lr",
      "0.001"], None),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--checkpoint", "ck.npz"], None),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--resume", "ck.npz"], None),
    (["--epochs", "2", "--global-batch-size", "32", "--mubatches", "2", "--fused-run"], None),
    (["--epochs", "2", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--fuse-mubatches", "--fused-run", "--run-kernel"], None),
    (["--fused-run", "--checkpoint-every-steps", "2", "--checkpoint-dir", "d"],
     "incompatible with --fused-run"),
    (["--fused-run", "--resume", "auto", "--checkpoint-dir", "d"], "no mid-epoch entry point"),
    (["--checkpoint-every-steps", "2"], "--checkpoint-dir"),
    (["--resume", "auto"], "--checkpoint-dir"),
    (["--epochs", "1", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--health", "halt"], None),
    (["--epochs", "2", "--global-batch-size", "32", "--mubatches", "2", "--no-eval",
      "--checkpoint-dir", "d", "--checkpoint-every-steps", "4", "--resume", "auto"], None),
]


@pytest.mark.parametrize("case", range(len(ROOT_CLI_LINES)))
def test_cli_parses_the_root_cli_command_lines(case, capsys):
    """Each root CLI test's command line parses on the port's CLI as the
    root CLI parses it, also with the root CLI's XLA knobs spelled out at
    their neutral values; other values of those knobs are refused."""
    argv, refusal = ROOT_CLI_LINES[case]
    for extra in ([], ["--precision", "highest", "--scan-unroll", "1", "--tick-unroll", "1"]):
        if refusal is None:
            args = tcli.parse_args(argv + extra)
            assert (args.tp, args.precision, args.scan_unroll, args.tick_unroll) == (1, "highest", 1, 1)
        else:
            with pytest.raises(SystemExit) as e:
                tcli.parse_args(argv + extra)
            assert e.value.code == 2 and refusal in capsys.readouterr().err
    if refusal is not None:
        return
    for knob, words in (
        (["--scan-unroll", "2"], "lax.scan unroll factor"),
        (["--tick-unroll", "4"], "lax.scan unroll factor"),
        (["--precision", "default"], "precision='default'"),
    ):
        with pytest.raises(SystemExit) as e:
            tcli.parse_args(argv + knob)
        assert e.value.code == 2 and words in capsys.readouterr().err


def test_mesh_session_needs_a_gpu_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(**MESH)
