"""The port's fused train kernel (``cuda_ops.fused_train_call``, TPU kernels
B9-B11) and its kernel paths, against the JAX package.

On the CPU the wrapper runs the kernel's plain version,
``fused_train_reference``; the CUDA kernel itself is held against that plain
version on the card by ``chip_smoke.py`` phase 8. Here the same seeded numpy
batches go through ``pallas_ops.fused_train_call`` (interpret mode off a
TPU, as tests/test_pallas_ops.py runs it) and the port's plain version, in
the step, epoch and run modes, for each optimizer, with and without the
clip and the weight decay. Then the port's own bitwise claims, the refusal
set against ``shallowspeed_tpu.trainer._validate_megakernel``, the session
and the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import optimizer as jopt
from shallowspeed_tpu import pallas_ops
from shallowspeed_tpu import trainer as jtrainer
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import _build, convert, cuda_ops
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import optimizer as topt
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch import trainer as ttrainer
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession

# params, mirrors and losses after 1-6 steps: the cross-engine trajectory
# class (tests/test_torch_oracle.py, tests/test_torch_trainer.py); measured
# at most 1.2e-5 relative on these inputs
RTOL, ATOL = 2e-4, 2e-6
SIZES = (20, 16, 12, 10)
B, M, NB = 32, 4, 3
OPTS = {
    "sgd": (None, 0.05),
    "momentum": ({"kind": "momentum", "mu": 0.9}, 0.01),
    "adam": ({"kind": "adam", "b1": 0.9, "b2": 0.999, "eps": 1e-8}, 1e-3),
}
CLIP = 0.05  # far below these batches' gradient norm: binds on every batch
# the decay cases' lr * weight_decay: each step shrinks every param by 2%,
# ~100x the tolerance above, so a plain version that skipped the decay fails
DECAY_SHRINK = 0.02


def _data(seed, nb=NB, sizes=SIZES, rows=B):
    rng = np.random.RandomState(seed)
    X = rng.rand(nb, rows, sizes[0]).astype(np.float32)
    Y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], (nb, rows))]
    return X, Y


def _operands(kind, sizes=SIZES, rows=B):
    """The stage's init params with zero optimizer state, for both packages."""
    host = jmodel.init_model(jmodel.make_model_spec(sizes, 1, rows))[0]
    n_mirrors, n_scalars = cuda_ops._OPT_GEOMETRY[kind]
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in host]
    tp = [{k: torch.tensor(v) for k, v in layer.items()} for layer in host]
    jm = [[{k: jnp.zeros_like(v) for k, v in la.items()} for la in jp] for _ in range(n_mirrors)]
    tm = [[{k: torch.zeros_like(v) for k, v in la.items()} for la in tp] for _ in range(n_mirrors)]
    js = [jnp.zeros((), jnp.float32)] * n_scalars
    ts = [torch.zeros(()) for _ in range(n_scalars)]
    return (jp, jm, js), (tp, tm, ts)


def _call_both(mode, kind, clip, decay, sizes=SIZES, rows=B, nb=NB, seed=0):
    """One fused call through both packages; ``decay`` turns on a weight
    decay of ``DECAY_SHRINK / lr``."""
    opt, lr = OPTS[kind]
    wd = DECAY_SHRINK / lr if decay else 0.0
    X, Y = _data(seed, nb, sizes, rows)
    if mode == "step":
        X, Y = X[0], Y[0]
    kw = dict(
        epoch_mode=mode != "step",
        relu_flags=jmodel.make_model_spec(sizes, 1, rows).stages[0].relu_flags,
        group_rows=rows // M, batch_size=rows, lr=lr, weight_decay=wd, opt=opt,
        clip_norm=clip, n_epochs=2 if mode == "run" else None,
    )
    (jp, jm, js), (tp, tm, ts) = _operands(kind, sizes, rows)
    want = pallas_ops.fused_train_call(
        jp, jnp.asarray(X), jnp.asarray(Y), precision=jax.lax.Precision.HIGHEST,
        mirrors=jm, scalars=js, **kw,
    )
    got = cuda_ops.fused_train_reference(
        tp, torch.from_numpy(X), torch.from_numpy(Y), mirrors=tm, scalars=ts, **kw
    )
    return got, want


def _assert_group_close(got, want):
    for lt, lj in zip(got, want):
        for key in ("W", "b"):
            np.testing.assert_allclose(
                lt[key].numpy(), np.asarray(lj[key]).reshape(lt[key].shape),
                rtol=RTOL, atol=ATOL,
            )


@pytest.mark.parametrize("decay", [False, True], ids=["no-decay", "decay"])
@pytest.mark.parametrize("clip", [None, CLIP], ids=["no-clip", "clip"])
@pytest.mark.parametrize("kind", sorted(OPTS))
@pytest.mark.parametrize("mode", ["step", "epoch", "run"])
def test_reference_matches_pallas(mode, kind, clip, decay):
    """Params, every optimizer mirror, Adam's t and the loss(es) after one
    batch, one 3-batch epoch, or a 2-epoch run."""
    got, want = _call_both(mode, kind, clip, decay)
    _assert_group_close(got[0], want[0])
    assert len(got[1]) == len(want[1]) == cuda_ops._OPT_GEOMETRY[kind][0]
    for mt, mj in zip(got[1], want[1]):
        _assert_group_close(mt, mj)
    assert [float(t) for t in got[2]] == [float(t) for t in want[2]]
    if mode == "step":
        assert [float(t) for t in got[2]] == ([1.0] if kind == "adam" else [])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5)
    assert got[3].shape == ((2,) if mode == "run" else ())


def test_flagship_width_matches_pallas():
    """The flagship at full width, B=128 in groups of 32, 2 batches in epoch
    mode, SGD with weight decay (tests/test_pallas_ops.py's flagship case)."""
    got, want = _call_both("epoch", "sgd", None, True, sizes=FLAGSHIP_SIZES, rows=128, nb=2)
    _assert_group_close(got[0], want[0])
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


def test_clip_binds():
    """The clip of the parity cases is live: it changes the result."""
    clipped, _ = _call_both("epoch", "sgd", CLIP, False)
    free, _ = _call_both("epoch", "sgd", None, False)
    assert not torch.equal(clipped[0][0]["W"], free[0][0]["W"])


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_decay_binds(kind):
    """The decay of the parity cases is live: in both packages it moves
    every weight leaf by far more than the parity tolerance (the biases
    start at 0, where a decay has nothing to shrink)."""
    (decayed, jdecayed), (free, jfree) = (_call_both("step", kind, None, d) for d in (True, False))
    for lt, lf, jt, jf in zip(decayed[0], free[0], jdecayed[0], jfree[0]):
        for a, b in ((lt["W"].numpy(), lf["W"].numpy()), (np.asarray(jt["W"]), np.asarray(jf["W"]))):
            allowed = ATOL + RTOL * np.abs(b)
            assert (np.abs(a - b) / allowed).max() > 10


def _leaves(stage, mirrors, scalars):
    out = [t for layer in stage for t in (layer["W"], layer["b"])]
    out += [t for m in mirrors for layer in m for t in (layer["W"], layer["b"])]
    return out + list(scalars)


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_plain_epoch_is_a_loop_of_steps_and_run_a_loop_of_epochs(kind):
    """Inside the port, bitwise: an epoch equals a loop of steps (loss =
    (0 + l_0 + ... ) / nb), and a run a loop of epochs."""
    opt, lr = OPTS[kind]
    relu = tmodel.make_model_spec(SIZES, 1, B).stages[0].relu_flags
    X, Y = (torch.from_numpy(a) for a in _data(4))
    kw = dict(relu_flags=relu, group_rows=B // M, batch_size=B, lr=lr,
              weight_decay=1e-4, opt=opt, clip_norm=CLIP)

    (_, (sa, ma, ta)), (_, (sb, mb, tb)), (_, (sc, mc, tc)) = (
        _operands(kind) for _ in range(3)
    )
    _, _, _, epoch_loss = cuda_ops.fused_train_call(
        sa, X, Y, epoch_mode=True, mirrors=ma, scalars=ta, **kw
    )
    loss_sum = torch.zeros(())
    for xb, yb in zip(X, Y):
        loss_sum = loss_sum + cuda_ops.fused_train_call(
            sb, xb, yb, epoch_mode=False, mirrors=mb, scalars=tb, **kw
        )[3]
    assert torch.equal(epoch_loss, loss_sum / NB)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(sa, ma, ta), _leaves(sb, mb, tb)))

    # a 2-epoch run against the first state plus one more epoch
    _, _, _, losses = cuda_ops.fused_train_call(
        sc, X, Y, epoch_mode=True, mirrors=mc, scalars=tc, n_epochs=2, **kw
    )
    _, _, _, second = cuda_ops.fused_train_call(
        sa, X, Y, epoch_mode=True, mirrors=ma, scalars=ta, **kw
    )
    assert torch.equal(losses, torch.stack([epoch_loss, second]))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(sa, ma, ta), _leaves(sc, mc, tc)))


# ---------------------------------------------------------------------------
# the trainer's kernel paths
# ---------------------------------------------------------------------------


def _torch_run(path, kind, X, Y, epochs=2, clip=None):
    """The port's trainer from init over ``epochs`` epochs: ``path`` is
    "fused" (the fuse_mubatches loop), "mega", "epoch" or "run"."""
    spec = tmodel.make_model_spec(SIZES, 1, B)
    stages = convert.params_from_numpy(tmodel.init_model(spec), "cpu")
    opt = topt.make_optimizer(kind, OPTS[kind][1], weight_decay=1e-4)
    state = opt.init(tmodel.param_tree(stages))
    if path == "run":
        run = ttrainer.make_train_run(
            spec, opt, fuse_mubatches=True, clip_norm=clip, with_eval=False, run_kernel=True
        )
        stages, state, losses = run(stages, state, X, Y, epochs)
        return stages, state, losses
    epoch = ttrainer.make_train_epoch(
        spec, opt, fuse_mubatches=True, clip_norm=clip, megakernel=path == "mega",
        epoch_kernel=path == "epoch",
    )
    losses = []
    for _ in range(epochs):
        stages, state, loss = epoch(stages, state, X, Y)
        losses.append(loss)
    return stages, state, torch.stack(losses)


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_kernel_paths_equal_the_fused_path_on_cpu(kind):
    """On the CPU the three kernel paths run the plain version, which
    composes the fused path's own torch ops: bitwise the same params,
    optimizer state and losses as ``fuse_mubatches`` without a kernel."""
    rng = np.random.RandomState(6)
    X = torch.from_numpy(rng.rand(NB, M, B // M, SIZES[0]).astype(np.float32))
    Y = torch.from_numpy(
        np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], (NB, M, B // M))]
    )
    ref = _torch_run("fused", kind, X, Y, clip=CLIP)
    for path in ("mega", "epoch", "run"):
        got = _torch_run(path, kind, X, Y, clip=CLIP)
        assert torch.equal(got[2], ref[2]), path
        for a, b in zip(topt.tree_leaves([tmodel.param_tree(got[0]), got[1]]),
                        topt.tree_leaves([tmodel.param_tree(ref[0]), ref[1]])):
            assert torch.equal(a, b), path


class _NotAnOptimizer:
    lr = 0.01
    weight_decay = 0.0


# (sizes, n_stages, batch, optimizer name or None, act, fuse_mubatches)
REFUSAL_CASES = {
    "unfused": ((20, 16, 12, 10), 1, 32, "sgd", "relu", False),
    "gelu": ((20, 16, 12, 10), 1, 32, "sgd", "gelu", True),
    "not-an-optimizer": ((20, 16, 12, 10), 1, 32, None, "relu", True),
    "two-stages": ((20, 16, 12, 10), 2, 32, "sgd", "relu", True),
    "over-budget": ((4096, 4096, 10), 1, 2048, "sgd", "relu", True),
    "momentum-over-budget": ((700, 700, 10), 1, 128, "momentum", "relu", True),
    "epoch-stream-over-budget": ((1000, 256, 10), 1, 512, "sgd", "relu", True),
    "flagship-adam": (FLAGSHIP_SIZES, 1, 128, "adam", "relu", True),
    "flagship-sgd": (FLAGSHIP_SIZES, 1, 128, "sgd", "relu", True),
}


def _refusal(validate, spec, opt, fuse, name):
    try:
        validate(spec, opt, fuse, name=name)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", ["megakernel", "epoch_kernel", "run_kernel"])
@pytest.mark.parametrize("case", sorted(REFUSAL_CASES))
def test_refusals_match_jax(case, name):
    """For the same configuration the port refuses exactly where
    ``shallowspeed_tpu.trainer._validate_megakernel`` refuses, with the
    same words (the budget is the JAX package's, as it applies off the
    TPU)."""
    sizes, stages, batch, opt_name, act, fuse = REFUSAL_CASES[case]
    if opt_name is None:
        jo = to = _NotAnOptimizer()
    else:
        jo, to = jopt.make_optimizer(opt_name, 0.01), topt.make_optimizer(opt_name, 0.01)
    jspec = jmodel.make_model_spec(sizes, stages, batch, act=act)
    tspec = tmodel.make_model_spec(sizes, stages, batch, act=act)
    want = _refusal(jtrainer._validate_megakernel, jspec, jo, fuse, name)
    got = _refusal(ttrainer._validate_megakernel, tspec, to, fuse, name)
    assert got == want
    if case.startswith("flagship"):
        assert got is None
    elif case != "epoch-stream-over-budget" or name != "megakernel":
        assert got is not None


def test_kernel_paths_refuse_grad_norm_and_empty_runs_as_jax_does():
    """with_grad_norm on every kernel path and a 0-epoch run kernel raise in
    both packages."""
    jspec = jmodel.make_model_spec(SIZES, 1, B)
    tspec = tmodel.make_model_spec(SIZES, 1, B)
    jo, to = jopt.SGD(0.01), topt.SGD(0.01)
    factories = (
        lambda tr, spec, o: tr.make_train_epoch(
            spec, o, fuse_mubatches=True, megakernel=True, with_grad_norm=True),
        lambda tr, spec, o: tr.make_train_epoch(
            spec, o, fuse_mubatches=True, epoch_kernel=True, with_grad_norm=True),
        lambda tr, spec, o: tr.make_train_run(
            spec, o, fuse_mubatches=True, with_eval=False, run_kernel=True,
            with_grad_norm=True),
    )
    for make in factories:
        for tr, spec, o in ((jtrainer, jspec, jo), (ttrainer, tspec, to)):
            with pytest.raises(ValueError, match="with_grad_norm.* unavailable on the kernel paths"):
                make(tr, spec, o)
    X, Y = _data(1)
    Xm, Ym = X.reshape(NB, M, B // M, -1), Y.reshape(NB, M, B // M, -1)
    jrun = jtrainer.make_train_run(jspec, jo, fuse_mubatches=True, with_eval=False, run_kernel=True)
    trun = ttrainer.make_train_run(tspec, to, fuse_mubatches=True, with_eval=False, run_kernel=True)
    jp = jax.tree.map(jnp.asarray, jmodel.init_model(jspec))
    tp = convert.params_from_numpy(tmodel.init_model(tspec), "cpu")
    msgs = []
    for run, args in ((jrun, (jp, (), jnp.asarray(Xm), jnp.asarray(Ym), 0)),
                      (trun, (tp, (), torch.from_numpy(Xm), torch.from_numpy(Ym), 0))):
        with pytest.raises(ValueError) as e:
            run(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "run_kernel requires n_epochs >= 1"


# ---------------------------------------------------------------------------
# the wrapper and the kernel's operand table
# ---------------------------------------------------------------------------


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    """CPU tensors take the plain version, bitwise, and count no launch; the
    update is in place, so the returned trees are the tensors passed in."""
    (_, (tp, tm, ts)), (_, (rp, rm, rs)) = _operands("momentum"), _operands("momentum")
    X, Y = (torch.from_numpy(a) for a in _data(2))
    kw = dict(epoch_mode=True, relu_flags=(True, True, False), group_rows=8, batch_size=B,
              lr=0.01, weight_decay=0.0, opt=OPTS["momentum"][0])
    before = dict(cuda_ops.LAUNCHES)
    w0 = tp[0]["W"].clone()
    out = cuda_ops.fused_train_call(tp, X, Y, mirrors=tm, scalars=ts, **kw)
    assert cuda_ops.LAUNCHES == before
    assert out[0] is tp and out[1][0] is tm[0] and out[0][0]["W"] is tp[0]["W"]
    assert not torch.equal(tp[0]["W"], w0)
    want = cuda_ops.fused_train_reference(rp, X, Y, mirrors=rm, scalars=rs, **kw)
    assert torch.equal(out[3], want[3])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tp, tm, ts), _leaves(rp, rm, rs)))
    with pytest.raises(ValueError, match="expects"):
        cuda_ops.fused_train_call(
            tp, X, Y, epoch_mode=True, relu_flags=(True, True, False), group_rows=8,
            batch_size=B, lr=0.01, weight_decay=0.0, opt=OPTS["adam"][0], mirrors=tm,
        )
    with pytest.raises(ValueError, match="n_epochs requires epoch_mode"):
        cuda_ops.fused_train_call(
            tp, X[0], Y[0], epoch_mode=False, relu_flags=(True, True, False),
            group_rows=8, batch_size=B, lr=0.01, weight_decay=0.0, n_epochs=2,
        )


def test_budget_predicates_are_the_jax_packages():
    for sizes, rows in ((FLAGSHIP_SIZES, 128), ((700, 700, 10), 128), ((1000, 256, 10), 512),
                        ((4096, 4096, 10), 2048)):
        for n in (0, 1, 2):
            assert cuda_ops._kernel_bytes(rows, sizes, n) == pallas_ops._kernel_bytes(rows, sizes, n)
            assert cuda_ops.train_step_kernel_fits(rows, sizes, n) == (
                pallas_ops.train_step_kernel_fits(rows, sizes, n)
            )
            assert cuda_ops.train_epoch_kernel_fits(rows, sizes, n) == (
                pallas_ops.train_epoch_kernel_fits(rows, sizes, n)
            )
    assert cuda_ops.SINGLE_BLOCK_BUDGET_BYTES == pallas_ops.SINGLE_BLOCK_BUDGET_BYTES
    assert cuda_ops._OPT_GEOMETRY == pallas_ops._OPT_GEOMETRY


def test_table_and_hyper_fields_match_the_source():
    """The Python side of the operand table (field names and order, the
    header length, the partition's tiles, the hyperparameters' order) is the
    CUDA source's: a mismatch would show only on the card."""
    import re

    src = (_build.CSRC / "fused_train.cu").read_text()

    def enum(name):
        body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
        return tuple(f.strip() for f in body.split(",") if f.strip())

    assert enum("Header") == tuple(f"H_{f}" for f in cuda_ops.TABLE_HEADER)
    assert enum("Layer") == tuple(f"R_{f}" for f in cuda_ops.TABLE_LAYER)
    assert f"constexpr int HEADER_LEN = {cuda_ops.TABLE_HEADER_LEN};" in src
    assert f"constexpr int LAYER_LEN = {len(cuda_ops.TABLE_LAYER)};" in src
    for name, value in (("ROW_TILE", cuda_ops.FUSED_ROW_TILE), ("COL_TILE", cuda_ops.FUSED_COL_TILE),
                        ("KC", cuda_ops.FUSED_KC), ("DW_N", cuda_ops.FUSED_DW_N),
                        ("DW_K", cuda_ops.FUSED_DW_K), ("MAX_CLUSTER", cuda_ops.FUSED_CLUSTER)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int WARPS = THREADS / 32;" in src
    assert f"constexpr int THREADS = {32 * cuda_ops.FUSED_WARPS};" in src
    assert f"constexpr int MAX_LAYERS = {cuda_ops.FUSED_MAX_LAYERS};" in src
    hyper = re.search(r"struct Hyper \{ float ([^;]*); \};", src).group(1)
    assert tuple(f.strip() for f in hyper.split(",")) == cuda_ops.HYPER
    assert len(cuda_ops.TABLE_HEADER) <= cuda_ops.TABLE_HEADER_LEN


@pytest.mark.parametrize("widths,rows,group", [(FLAGSHIP_SIZES, 128, 32), ((20, 16, 12, 10), 32, 8),
                                               ((5, 3), 7, 7)])
def test_workspace_layout_regions_are_disjoint(widths, rows, group):
    """Every region of the kernel's workspace has its size, none overlaps
    another, and they fill the total; the clip's regions hold one sum per dW
    tile and per column of tiles."""
    layers, row_loss, total = cuda_ops.fused_train_layout(widths, rows)
    regions = [(row_loss, rows)]
    for l, rec in enumerate(layers):
        K, N = widths[l], widths[l + 1]
        tn, tk = cuda_ops.dw_tile_grid(N, K)
        assert (rec["K"], rec["N"]) == (K, N)
        assert rec["ACT_IN"] == (layers[l - 1]["ACT_OUT"] if l else -1)
        regions += [(rec["ACT_OUT"], rows * N), (rec["G"], rows * N), (rec["DW"], N * K),
                    (rec["DB"], N), (rec["SQW"], tn * tk), (rec["SQB"], tn)]
    regions.sort()
    assert regions[0][0] == 0
    for (a, n), (b, _) in zip(regions, regions[1:]):
        assert a + n == b
    assert regions[-1][0] + regions[-1][1] == total
    assert cuda_ops.fused_plan(widths, rows, group)["n_items"] >= 1


# ---------------------------------------------------------------------------
# the session and the CLI
# ---------------------------------------------------------------------------


def _write_split(path, n_train, n_val, seed=0):
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
    """3 batches of 128 and 100 validation rows: the JAX epoch kernel runs
    interpreted here, so the split is small."""
    return _write_split(tmp_path_factory.mktemp("fused_split"), 3 * 128, 100)


def test_epoch_kernel_session_matches_jax(split):
    """``TrainingSession(fuse_mubatches=True, epoch_kernel=True)`` of both
    packages, the flagship at full width for 2 epochs: losses, accuracy()
    and params within the cross-engine class; in the port, ``train_steps``
    in chunks is bitwise one epoch."""
    kw = dict(data_dir=split, fuse_mubatches=True, epoch_kernel=True)
    js = JaxSession(**kw)
    ts = TorchSession(device="cpu", **kw)
    for _ in range(2):
        np.testing.assert_allclose(ts.train_epoch(), js.train_epoch(), rtol=RTOL, atol=ATOL)
        assert ts.accuracy() == js.accuracy()
    for sa, sb in zip(ts.params(), js.params()):
        for la, lb in zip(sa, sb):
            for key in ("W", "b"):
                np.testing.assert_allclose(la[key], lb[key], rtol=RTOL, atol=ATOL)
    chunked = TorchSession(device="cpu", **kw)
    chunked.train_epoch()
    assert chunked.train_steps(2) == (2, None)
    steps, loss = chunked.train_steps(5)
    assert steps == 1 and chunked.epoch == 2 and loss is not None
    for sa, sb in zip(ts.params(), chunked.params()):
        for la, lb in zip(sa, sb):
            assert np.array_equal(la["W"], lb["W"]) and np.array_equal(la["b"], lb["b"])


def test_session_kernel_flags(split):
    """The constructor's rules (each flag needs fuse_mubatches, run_kernel
    excludes the others), a refused over-budget model, and on the CPU the
    run kernel's session run bitwise the epoch kernel's, the megakernel's
    and the plain fused session's."""
    for kw in (dict(megakernel=True), dict(epoch_kernel=True), dict(run_kernel=True)):
        with pytest.raises(ValueError, match="requires fuse_mubatches=True"):
            TorchSession(device="cpu", data_dir=split, **kw)
    for kw in (dict(megakernel=True), dict(epoch_kernel=True)):
        with pytest.raises(ValueError, match="subsumes"):
            TorchSession(device="cpu", data_dir=split, fuse_mubatches=True, run_kernel=True, **kw)
    with pytest.raises(ValueError, match="exceed the epoch_kernel VMEM budget"):
        TorchSession(device="cpu", data_dir=split, sizes=(784, 2048, 2048, 10),
                     fuse_mubatches=True, epoch_kernel=True)
    kw = dict(sizes=(784, 32, 31, 10), data_dir=split, fuse_mubatches=True, optimizer="adam",
              lr=1e-3)
    run = TorchSession(device="cpu", run_kernel=True, **kw)
    losses, accs = run.train_run(2, with_eval=False)
    assert accs is None and run.epoch == 2
    assert run.opt_state_logical()["scalars"] == {"t": 6.0}
    # on the CPU every kernel path's session is bitwise the fused session
    for flags in (dict(epoch_kernel=True), dict(megakernel=True), {}):
        other = TorchSession(device="cpu", **flags, **kw)
        assert [other.train_epoch(), other.train_epoch()] == losses, flags
        for sa, sb in zip(run.params(), other.params()):
            for la, lb in zip(sa, sb):
                assert np.array_equal(la["W"], lb["W"]) and np.array_equal(la["b"], lb["b"])
    losses, accs = run.train_run(1)  # the evaluated run takes the epoch kernel
    assert len(losses) == len(accs) == 1 and run.epoch == 3


def test_cli_kernel_flags(split, capsys):
    base = ["--device", "cpu", "--epochs", "1", "--data-dir", str(split), "--fuse-mubatches"]
    assert tcli.main(base + ["--epoch-kernel"]) == 0
    out = capsys.readouterr().out
    assert "batches/epoch=3" in out and "Epoch: 0, mean train loss:" in out
    assert tcli.main(base + ["--run-kernel", "--fused-run", "--no-eval"]) == 0
    assert "Epoch: 1, Time Spent:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="megakernel .* requires fuse_mubatches=True"):
        tcli.main(base[:-1] + ["--megakernel"])
