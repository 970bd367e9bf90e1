"""Model families (``families/``): the MLP family reads what the harness read
before families existed, bit for bit, and a family the harness has never
seen is added as new files alone, runs correct on the CPU and is caught
under the faults.

    python -m pytest portbench/test_portbench_families.py -q
"""

import hashlib
import io
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = harness.ROOT
SEED = 2**33 + 7

# The tiny root's numbers at SEED and the model FLOPs of a trained sample,
# as the harness gave them before it had families (floats as float.hex).
GOLDEN = {
    "mnist-mlp.epoch-kernel": (
        {"grad": "0x1.85d3a9138d9e7p-21", "change": "0x1.55aa7a458d03bp-22",
         "epoch_loss": "0x1.d9c8525330411p-25", "leaves_compared": 14},
        1082052,
    ),
    "mlp-deep.seq-b1024": (
        {"grad": "0x1.6bc7f384ffd03p-25", "change": "0x1.0215ccb799585p-24",
         "leaves_compared": 14},
        427776,
    ),
    "mlp-deep.pp4-gpipe-b1024": (
        {"grad": "0x1.9551a85e2a40fp-23", "change": "0x1.25770b26bb344p-23",
         "leaves_compared": 14},
        427776,
    ),
}
FULL_FLOPS = {"mnist-mlp": 6 * 180342, "mlp-deep": 6 * 89706496}


@pytest.fixture
def one_thread():
    """The CPU's products sum in an order that depends on the thread count
    (the flagship's 784-wide Linear reads differently at 1, 3 and 8
    threads), so the literals hold at one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _numbers(log):
    found = re.findall(r"numbers (\{.*\})", log)
    assert len(found) == 1, log
    return {k: v.hex() if isinstance(v, float) else v for k, v in json.loads(found[0]).items()}


def _model_flops(cell):
    from portbench.readers import mfu

    ctx = {"config": cell["config"], "family": cell["family"],
           "window": {"samples_per_s": 1.0}, "peaks": {"fp32_flops_per_s": 100.0}}
    return mfu.read(ctx, {})


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_the_mlp_family_reads_bitwise_what_the_harness_read(tiny_root, name, one_thread):
    numbers, flops = GOLDEN[name]
    log = io.StringIO()
    harness.run(harness.Bench(tiny_root), name, SEED, 0.2, False, device="cpu", log=log)
    assert _numbers(log.getvalue()) == numbers
    cell = harness.Bench(tiny_root).cell(name)
    assert cell["family"].train_flops_per_sample(cell["config"]) == flops
    assert _model_flops(cell) == flops
    full = harness.Bench(ROOT).cell(name)
    assert _model_flops(full) == FULL_FLOPS[full["entry"]["config"]]


def _digest(folder):
    return {
        p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


# What a change that adds a model family brings: the family, its plain
# reference, a configuration naming the family, a traffic mix and a cell.
# The family is the port's zoo entry "transformer" (exact-erf gelu blocks
# with residual adds, the softmax-MSE head); its leaves are every W, then
# every b, an order the MLP family does not use.
FAMILY = '''"""The port's zoo entry ``transformer``; leaves: every W, then every b."""

import importlib.util
import math
from pathlib import Path

import torch


def _reference():
    path = Path(__file__).resolve().parent.parent / "reference" / "transformer.py"
    spec = importlib.util.spec_from_file_location("transformer_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_traffic(cfg, traffic):
    if cfg["sizes"][0] != traffic["dim"] or cfg["sizes"][-1] != traffic["classes"]:
        raise ValueError("the blocks do not take the split's features to its classes")


def draw_weights(cfg, g, device):
    s = cfg["sizes"]
    flat = torch.randn(sum(i * o for i, o in zip(s[:-1], s[1:])), generator=g, device=device)
    out, off = [], 0
    for i, o in zip(s[:-1], s[1:]):
        w = flat[off : off + o * i].view(o, i) / math.sqrt(i)
        out.append((w, torch.zeros((1, o), device=device)))
        off += o * i
    return out


def session_kwargs(cfg, traffic):
    return dict(model="transformer", global_batch_size=traffic["global_batch_size"],
                mubatches=traffic["mubatches"], lr=cfg["lr"], optimizer=cfg["optimizer"],
                **traffic["session"])


def leaves(weights):
    return [w for w, _ in weights] + [b for _, b in weights]


def state(session):
    layers = [layer for stage in session.params() for layer in stage]
    return [layer["W"] for layer in layers] + [layer["b"] for layer in layers]


def checkpoint(cfg, traffic, host):
    n = len(host) // 2
    meta = {"sizes": list(cfg["sizes"]), "global_batch_size": traffic["global_batch_size"],
            "act": "gelu"}
    arrays = {}
    for i in range(n):
        arrays[f"w{i}"], arrays[f"b{i}"] = host[i], host[n + i]
    return meta, arrays


def reference(weights, cfg, traffic):
    return _reference().Trainer(weights, cfg["sizes"], cfg["lr"],
                                traffic["global_batch_size"], traffic["mubatches"])


def train_flops_per_sample(cfg):
    s = cfg["sizes"]
    return 6 * sum(i * o for i, o in zip(s[:-1], s[1:]))
'''

REFERENCE = '''"""Transformer-style blocks in plain PyTorch, float32: Linear g is followed
by exact-erf gelu where g is even and not the last, and adds the input of
Linear g - 1 where g is odd and that input's width is its output's; the
softmax-MSE head of reference/mlp.py. Gradients from autograd."""

import torch


def batch_loss(params, sizes, x, y, mubatches, batch_size):
    h, before = x, None
    for g, (w, b) in enumerate(params):
        out = h @ w.T + b
        if g % 2 == 0 and g != len(params) - 1:
            out = torch.nn.functional.gelu(out)
        if g % 2 == 1 and sizes[g - 1] == sizes[g + 1]:
            out = out + before
        before, h = h, out
    z = h.reshape(mubatches, -1, h.shape[-1])
    m = torch.amax(z, dim=(1, 2), keepdim=True).detach()
    e = torch.exp(z - m)
    p = e / (e.sum(dim=-1, keepdim=True) + 1e-7)
    return ((y.reshape(p.shape) - p) ** 2).sum() / batch_size


class Trainer:
    def __init__(self, weights, sizes, lr, batch_size, mubatches):
        self.params = [(w.clone(), b.clone()) for w, b in weights]
        self.sizes, self.lr, self.B, self.M = sizes, lr, batch_size, mubatches

    def leaves(self):
        return [w for w, _ in self.params] + [b for _, b in self.params]

    def step(self, x, y):
        leaves = [t.requires_grad_(True) for t in self.leaves()]
        loss = batch_loss(self.params, self.sizes, x, y, self.M, self.B)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.requires_grad_(False)
                t.sub_(self.lr * g)
        return float(loss.detach())
'''

CELL = "transformer.seq-b128"


def _with_a_new_family(root):
    """A copy of the benchmark under ``root`` with the transformer family,
    its configuration, traffic and cell added; returns the digest of the
    files that were there before."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / "portbench")
    pb = root / "portbench"
    (pb / "families/transformer.py").write_text(FAMILY)
    (pb / "reference/transformer.py").write_text(REFERENCE)
    (pb / "configs/transformer.json").write_text(json.dumps({
        "name": "transformer", "family": "transformer",
        "sizes": [784, 1024, 256, 1024, 256, 1024, 256, 10],
        "optimizer": "sgd", "lr": 0.006, "dtype": "float32",
    }))
    traffic = json.loads((pb / "traffic/seq-b1024.json").read_text())
    traffic.update(train_rows=1024, val_rows=64, global_batch_size=128)
    (pb / "traffic/seq-b128.json").write_text(json.dumps(traffic))
    # on the CPU sound runs read grad and change under 5e-7, both faults 0.03 or more
    (pb / f"workloads/{CELL}.json").write_text(json.dumps(
        {"why": "gelu blocks", "trace_chunks": 2, "limits": {"grad": 1e-3, "change": 1e-3}}
    ))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "transformer", "source": "the port's MODEL_ZOO",
                            "file": "portbench/configs/transformer.json", "reduced": [],
                            "why": "gelu blocks with residual adds"})
    spec["workloads"].append({"name": CELL, "config": "transformer", "traffic": "seq-b128",
                              "chips": 1, "why": "gelu blocks"})
    mfu = next(m for m in spec["per_layer"] if m["name"] == "mfu.train")
    mfu["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


@pytest.mark.parametrize("fault", [None, "half_batch", "stale_state"])
def test_a_new_family_is_new_files_alone_and_its_check_holds(tmp_path, fault):
    before = _with_a_new_family(tmp_path)
    bench = harness.Bench(tmp_path)
    assert bench.validate() == []
    cell = bench.cell(CELL)
    assert cell["family"].__name__ == "portbench.families.transformer"
    assert _model_flops(cell) == 6 * (784 * 1024 + 5 * 256 * 1024 + 256 * 10)

    result = harness.run(bench, CELL, 2**31 + 13, 0.2, False, device="cpu", fault=fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert set(result["checks"]) == {"grad", "change"}
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("broken", ["missing", "does_not_load", "lacks_a_function"])
def test_validate_names_a_configuration_whose_family_is_broken(tmp_path, broken):
    _with_a_new_family(tmp_path)
    path = tmp_path / "portbench/families/transformer.py"
    if broken == "missing":
        path.unlink()
    elif broken == "does_not_load":
        path.write_text("import portbench.no_such_module\n" + FAMILY)
    else:
        path.write_text(FAMILY.replace("def train_flops_per_sample", "def _train_flops"))
    bad = harness.Bench(tmp_path).validate()
    want = {
        "missing": "config transformer: no family file families/transformer.py",
        "does_not_load": "config transformer: family transformer does not load",
        "lacks_a_function": "config transformer: family transformer lacks train_flops_per_sample()",
    }[broken]
    assert len(bad) == 1 and bad[0].startswith(want), bad
