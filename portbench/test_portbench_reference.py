"""The plain reference against the port's CPU path, one training step of
each cell's kind at a small size, and the reference's independence."""

import ast
import functools
import math
from pathlib import Path

import pytest
import torch

from portbench.reference import mlp
from portbench.work import inputs

SIZES = (784, 32, 24, 16, 16, 16, 12, 10)  # 8 sizes: 4 stages of 7 Linears
TRAFFIC = dict(
    dim=784, classes=10, center_std=1.0, noise_std=2.0, offset=8.0, span=16.0,
    train_rows=128, val_rows=16,  # one batch: the step's loss is its epoch's
)
KINDS = {
    "sequential": {},
    "epoch-kernel": dict(fuse_mubatches=True, epoch_kernel=True),
    "pp4-gpipe": dict(pp=4, schedule="gpipe", kernel_backend="pallas"),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_step_matches_the_ports_cpu_path(kind, tmp_path):
    from shallowspeed_tpu_torch import TrainingSession

    draw = functools.partial(inputs.draw_weights, SIZES)
    weights, split = inputs.make_inputs(draw, TRAFFIC, 9, "cpu")
    inputs.write_split(tmp_path, split)
    arrays = {}
    for i, (w, b) in enumerate(weights):
        arrays[f"w{i}"], arrays[f"b{i}"] = w.numpy(), (b + 0.01 * (i + 1)).numpy()
    meta = {"sizes": list(SIZES), "global_batch_size": 128, "act": "relu"}
    session = TrainingSession(
        sizes=SIZES, global_batch_size=128, mubatches=4, lr=0.006, data_dir=str(tmp_path),
        device="cpu", **KINDS[kind],
    )
    session.load_weights(tmp_path / "w.npz", verified=(meta, arrays))
    _, loss = session.train_steps(1)
    got = [(layer["W"], layer["b"]) for stage in session.params() for layer in stage]

    start = [(torch.from_numpy(arrays[f"w{i}"]), torch.from_numpy(arrays[f"b{i}"]))
             for i in range(len(SIZES) - 1)]
    ref = mlp.Trainer(start, 0.006, 128, 4)
    ref_loss = ref.step(split[0][:128], split[1][:128])
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for (w, b), (rw, rb), (w0, b0) in zip(got, ref.params, start):
        for have, want, was in ((w, rw, w0), (b, rb, b0)):
            # a step moves a weight by ~1e-6 of itself, and sums in another
            # order round some weights one float apart: hold the change
            d_want = want.double() - was.double()
            d_have = torch.from_numpy(have).double() - was.double()
            assert torch.linalg.vector_norm(d_want) > 0
            gap = torch.linalg.vector_norm(d_have - d_want) / torch.linalg.vector_norm(d_want)
            assert gap < 1e-4


def test_the_head_keeps_the_references_quirks():
    z = torch.tensor([[1.0, 2.0], [3.0, 4.0], [50.0, 0.0], [0.0, 0.0]])
    params = [(torch.eye(2), torch.zeros(1, 2))]
    y = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    got = mlp.batch_loss(params, z, y, 2, 8)
    want = 0.0
    for rows in (z[:2], z[2:]):  # the stability max over each microbatch
        e = torch.exp(rows - rows.max())
        p = e / (e.sum(dim=1, keepdim=True) + 1e-7)
        want += float(((y[: len(rows)] if rows is z[:2] else y[2:]) - p).pow(2).sum())
    assert float(got) == pytest.approx(want / 8, rel=1e-6)
    assert not math.isnan(float(got))


def test_the_reference_imports_nothing_of_the_port():
    for path in (Path(mlp.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "shallowspeed_tpu_torch", "shallowspeed_tpu", "jax", "jaxlib", "flax"
                ), f"{path.name} imports {n}"


def test_tf32_switch_is_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    with mlp.matmul_precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
