"""Import hygiene of the port: it runs where JAX is not installed.

Every module of ``shallowspeed_tpu_torch`` imports with ``jax`` blocked,
and neither the package nor ``chip_smoke.py`` names the JAX package
``shallowspeed_tpu`` in an import (an AST check, so a lazy import inside a
function is caught too).
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import shallowspeed_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "shallowspeed_tpu_torch"


def _modules():
    names = [shallowspeed_tpu_torch.__name__]
    for info in pkgutil.walk_packages([str(PKG)], prefix="shallowspeed_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _is_jax_package(name):
    # compared exactly: shallowspeed_tpu_torch itself starts with the string
    return name == "shallowspeed_tpu" or name.startswith("shallowspeed_tpu.")


def _is_jax(name):
    return name == "jax" or name.startswith("jax.") or name == "jaxlib"


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {
        "shallowspeed_tpu_torch.serving.__main__",
        "shallowspeed_tpu_torch.optimizer",
        "shallowspeed_tpu_torch.data",
        "shallowspeed_tpu_torch.train",
        "shallowspeed_tpu_torch.trainer",
        "shallowspeed_tpu_torch.cuda_ops",
        "shallowspeed_tpu_torch.schedules",
        "shallowspeed_tpu_torch.parallel.lowering",
        "shallowspeed_tpu_torch.parallel.mesh",
        "shallowspeed_tpu_torch.parallel.executor",
        "shallowspeed_tpu_torch.analysis.progcheck",
        "shallowspeed_tpu_torch.analysis.stash",
        "shallowspeed_tpu_torch.analysis.rules",
        "shallowspeed_tpu_torch.analysis.lint",
        "shallowspeed_tpu_torch.observability.program_audit",
        "shallowspeed_tpu_torch.utils",
        "shallowspeed_tpu_torch.faults",
        "shallowspeed_tpu_torch.aot_cache",
    } <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'shallowspeed_tpu' "
        "or k.startswith('shallowspeed_tpu.'))\n"
        "assert not bad, bad\n"
        "print('imported', len(" + repr(mods) + "))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_training_profile.py"]
    + sorted((ROOT / "scripts").glob("torch_*_phase.py"))
    + [ROOT / "scripts" / "torch_aot_child.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_of_jax_or_the_jax_package(path):
    names = _imported_names(path)
    assert not [n for n in names if _is_jax_package(n) or _is_jax(n)], names


def test_kernel_sources_name_no_jax_import():
    """The CUDA sources of the port stand alone: plain C entry points, no
    Python and no JAX (each names the TPU kernel it replaces in a comment)."""
    sources = sorted((PKG / "csrc").glob("*.cu"))
    assert [p.stem for p in sources] == ["fused_train", "linear_act_bwd", "linear_act_fwd"]
    for p in sources:
        text = p.read_text()
        assert f'extern "C" int {p.stem}(' in text
        assert "pallas_ops.py:" in text and "#include <torch" not in text


def test_exact_name_comparison():
    assert _is_jax_package("shallowspeed_tpu.ops")
    assert _is_jax_package("shallowspeed_tpu")
    assert not _is_jax_package("shallowspeed_tpu_torch.ops")
    assert not _is_jax_package("shallowspeed_tpu_torch")
