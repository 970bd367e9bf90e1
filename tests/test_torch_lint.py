"""The port's house-rule linter (``shallowspeed_tpu_torch/analysis/{rules,
lint}.py``) against the JAX package's: the same findings on every fixture,
the port tree lint-clean under its own targets, the port's scopes, the
suppression idiom, the CLI's exit codes and reports, the schema registry,
and the copies' source pinned to the JAX modules but for the scope lines,
the targets and the package name."""

import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from shallowspeed_tpu.analysis import rules as jax_rules
from shallowspeed_tpu_torch.analysis import lint as lint_cli
from shallowspeed_tpu_torch.analysis import rules

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"

# every fixture file, under each scope flag forced on and under none (the
# fixtures live under tests/, outside the real scopes)
_SCOPES = {
    "none": {},
    "metrics": {"metrics_path": True},
    "atomic": {"atomic_module": True},
    "donation": {"donation_ok": True},
}
_CASES = [
    (kind, f.name, scope)
    for kind in ("bad", "good")
    for f in sorted((FIXTURES / kind).glob("*.py"))
    for scope in _SCOPES
]


@pytest.mark.parametrize(
    "kind, name, scope", _CASES, ids=[f"{k}-{n[:-3]}-{s}" for k, n, s in _CASES]
)
def test_fixture_findings_equal_the_jax_linter(kind, name, scope):
    """Rule, path, line, column and message of every finding equal the JAX
    linter's on the same file under the same scope."""
    path = FIXTURES / kind / name
    mine = rules.lint_file(path, scope=rules.Scope(**_SCOPES[scope]))
    ref = jax_rules.lint_file(path, scope=jax_rules.Scope(**_SCOPES[scope]))
    assert [f.as_dict() for f in mine] == [f.as_dict() for f in ref]
    if kind == "good":
        assert mine == []


def test_port_tree_is_lint_clean():
    """The gate: the port's package, ``chip_smoke.py`` and the port's
    scripts lint clean under the port's scopes."""
    findings, n_files = lint_cli.lint_paths()
    assert n_files > 50  # the real tree, not an accidental empty walk
    assert findings == [], "\n".join(f.format() for f in findings)


def test_rules_run_without_torch_or_jax(tmp_path):
    """The rules module imports nothing of the code it lints: loaded by
    its path with torch and jax blocked, it lints a file."""
    bad = FIXTURES / "bad" / "broad_except.py"
    code = (
        "import importlib.util, sys\n"
        "for m in ('torch', 'jax', 'jaxlib', 'numpy'):\n"
        "    sys.modules[m] = None\n"
        f"spec = importlib.util.spec_from_file_location('rules', {str(Path(rules.__file__))!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"found = mod.lint_file({str(bad)!r})\n"
        "print([f.rule for f in found])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['BLE001']"


def test_default_targets_are_the_port_and_exclude_tests():
    files = [f.relative_to(ROOT).as_posix() for f in lint_cli.iter_target_files()]
    assert "chip_smoke.py" in files
    assert "shallowspeed_tpu_torch/analysis/lint.py" in files
    assert "scripts/torch_mpmd_phase.py" in files
    assert not any(f.startswith("tests/") for f in files)
    assert not any(f.startswith("shallowspeed_tpu/") for f in files)
    # the JAX package's scripts stay with the JAX linter
    assert "scripts/analyze_smoke.py" not in files


def test_scope_for_the_port_paths():
    sf = rules.scope_for
    assert sf("shallowspeed_tpu_torch/observability/metrics.py").metrics_path
    assert sf("shallowspeed_tpu_torch/observability/program_audit.py").metrics_path
    assert sf("shallowspeed_tpu_torch/serving/engine.py").metrics_path
    assert sf("shallowspeed_tpu_torch/checkpoint.py").atomic_module
    assert sf("shallowspeed_tpu_torch/trainer.py").donation_ok
    assert sf("shallowspeed_tpu_torch/parallel/executor.py").donation_ok
    for neutral in (
        "shallowspeed_tpu_torch/api.py",
        "shallowspeed_tpu_torch/parallel/mpmd.py",
        # the JAX package's own paths are not the port's scopes
        "shallowspeed_tpu/observability/metrics.py",
        "shallowspeed_tpu/checkpoint.py",
        "shallowspeed_tpu/trainer.py",
        "chip_smoke.py",
    ):
        s = sf(neutral)
        assert not (s.metrics_path or s.atomic_module or s.donation_ok), neutral


def test_justified_noqa_suppresses_and_bare_noqa_does_not():
    bad = "try:\n    pass\nexcept Exception:  {}\n    pass\n"
    justified = bad.format("# noqa: BLE001 — probe only, absence is fine")
    assert rules.lint_source(justified, path="x.py") == []
    bare = bad.format("# noqa: BLE001")
    assert [f.rule for f in rules.lint_source(bare, path="x.py")] == ["BLE001"]
    wrong = bad.format("# noqa: SSP002 — not the rule that fired")
    assert [f.rule for f in rules.lint_source(wrong, path="x.py")] == ["BLE001"]


def _marker_line(path):
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if "# MARK" in line:
            return i
    raise AssertionError(f"{path}: no # MARK line")


def test_cli_exit_codes_and_json_report(capsys):
    bad = str(FIXTURES / "bad" / "broad_except.py")
    good = str(FIXTURES / "good" / "broad_except.py")
    assert lint_cli.main([good]) == 0
    assert "clean: 0 findings" in capsys.readouterr().out
    assert lint_cli.main([bad]) == 2
    out = capsys.readouterr().out
    assert f"{bad}:{_marker_line(Path(bad))}" in out and "BLE001" in out
    assert lint_cli.main([bad, "--format", "json"]) == 2
    rep = json.loads(capsys.readouterr().out)
    assert rep["lint_report_version"] == lint_cli.LINT_REPORT_VERSION == 1
    assert rep["files_scanned"] == 1
    assert rep["counts"] == {"BLE001": 1}
    assert rep["findings"][0]["path"] == bad
    assert rep["findings"][0]["line"] == _marker_line(Path(bad))
    assert lint_cli.main(["/nonexistent/nope.py"]) == 1
    capsys.readouterr()


def test_cli_metrics_out_records_the_verdict(tmp_path, capsys):
    from shallowspeed_tpu_torch.observability import SCHEMA_VERSION, read_jsonl

    bad = str(FIXTURES / "bad" / "broad_except.py")
    out = tmp_path / "lint.jsonl"
    assert lint_cli.main([bad, "--metrics-out", str(out)]) == 2
    capsys.readouterr()
    recs = [r for r in read_jsonl(out) if r["kind"] == "static_analysis"]
    assert len(recs) == 1
    r = recs[0]
    assert r["name"] == "lint" and r["v"] == SCHEMA_VERSION
    assert r["findings"] == 1 and r["by_rule"] == {"BLE001": 1}
    assert r["passes"] == sorted(rules.RULE_IDS)
    assert any("broad_except.py" in line for line in r["finding_lines"])


def test_schema_kinds_registry_is_the_ports_metrics():
    """The AST-parsed registry is the port's own ``metrics.SCHEMA_KINDS``,
    read without importing the module."""
    from shallowspeed_tpu_torch.observability.metrics import SCHEMA_KINDS

    parsed = rules.load_schema_kinds()
    assert parsed == SCHEMA_KINDS
    assert Path(rules.__file__).resolve().parents[1] == (
        ROOT / "shallowspeed_tpu_torch"
    )


def _diff(name):
    """The +/- lines between the JAX module (package name replaced) and
    the port's copy."""
    ref = re.sub(
        r"shallowspeed_tpu\b", "shallowspeed_tpu_torch",
        (ROOT / "shallowspeed_tpu" / "analysis" / f"{name}.py").read_text(),
    ).splitlines()
    mine = (ROOT / "shallowspeed_tpu_torch" / "analysis" / f"{name}.py").read_text().splitlines()
    return [
        line[0] + line[1:].strip()
        for line in difflib.unified_diff(ref, mine, n=0, lineterm="")
        if line[:1] in "+-" and not line.startswith(("+++", "---"))
    ]


# the copies' only differences: the scope lines and the docstring lines that
# describe them (rules), the default targets and their docstring (lint). The
# port's side is pinned line by line; the JAX side by its count of lines
_RULES_ADDED = [
    "+- ``SSP003``  modules owning durable on-disk formats (``checkpoint.py``)",
    "+may only write through",
    "+trainer/executor modules (the donation hazard: a",
    "+donating program must never be deserialized and",
    "+dispatched); torch has no ``donate_argnums``, so on",
    "+this package the rule finds nothing, and it stays so that",
    "+a ``jax.jit`` brought in by mistake is caught where it",
    "+lands (the port's in-place writes are checked at run time",
    "+instead: ``program_audit.check_dispatch_safety``);",
    "+linted code, so the linter runs without torch as well as without jax.",
    "+atomic_module: bool = False  # SSP003: checkpoint.py",
    '+atomic_module=p.endswith("shallowspeed_tpu_torch/checkpoint.py"),',
    "+(",
    '+"shallowspeed_tpu_torch/trainer.py",',
    '+"shallowspeed_tpu_torch/parallel/executor.py",',
    "+)",
    '+torch or jax). Returns ``{kind: version_introduced}``."""',
]
_LINT_ADDED = [
    "+Default targets (repo-root-relative globs): the ``shallowspeed_tpu_torch``",
    "+package, ``chip_smoke.py`` and the port's ``scripts/torch_*.py`` — NOT",
    "+``tests/`` (the fixture corpus under ``tests/lint_fixtures/`` exists to",
    "+violate the rules, and test code legitimately asserts on broad exception",
    "+classes) and not the JAX package's files (its own linter holds them).",
    '+"chip_smoke.py",',
    '+"scripts/torch_*.py",',
    "+paths = [p for t in DEFAULT_TARGETS for p in sorted(root.glob(t))]",
]


@pytest.mark.parametrize(
    "name, added, n_removed", [("rules", _RULES_ADDED, 12), ("lint", _LINT_ADDED, 10)]
)
def test_copies_differ_only_in_scopes_targets_and_package(name, added, n_removed):
    diff = _diff(name)
    assert [d for d in diff if d[0] == "+"] == added
    assert sum(d[0] == "-" for d in diff) == n_removed
