"""Pytest settings of the benchmark's own tests (``python -m pytest
portbench/ -q``). Tests that need a CUDA device carry the ``card`` marker
and take the ``card`` fixture, which skips them, with the reason, where no
device is present; it decides when the test runs, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skipped with a reason without one)"
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check's control and the kernels run only there")
    return torch.device("cuda")


def make_tiny_root(dst, rows=6144, deep=(784, 64, 64, 64, 64, 64, 64, 10)):
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) under
    ``dst`` whose cells run in seconds on the CPU: ``rows`` training rows,
    a chunk of many steps cut to the shorter epoch, and mlp-deep's 22
    hidden layers of 2048 replaced by 6 of 64. Limits, layouts, batches and
    the flagship's sizes are the real ones."""
    import json
    import shutil
    from pathlib import Path

    src = Path(__file__).resolve().parent
    dst = Path(dst)
    shutil.copytree(src, dst / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src.parent / "BENCHMARK.json", dst)
    for t in (dst / "portbench" / "traffic").glob("*.json"):
        d = json.loads(t.read_text())
        d["train_rows"], d["val_rows"] = rows, 64
        if d["chunk_steps"] > 1:
            d["chunk_steps"] = rows // d["global_batch_size"]
        t.write_text(json.dumps(d))
    c = dst / "portbench" / "configs" / "mlp-deep.json"
    d = json.loads(c.read_text())
    d["sizes"] = list(deep)
    c.write_text(json.dumps(d))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
