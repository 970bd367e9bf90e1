"""The house-rule linter CLI: ``python -m shallowspeed_tpu_torch.analysis.lint``.

Runs the AST rules in ``analysis/rules.py`` over the repo (or explicit
paths) and reports findings as ``path:line:col: RULE message``. Exit
codes follow the gate contract ``make lint`` relies on:

- 0  no findings;
- 1  the linter itself failed (unreadable path, broken registry);
- 2  findings — one line each, file:line named, so CI output is
     actionable without re-running anything.

``--format json`` emits the stable machine-readable report instead
(``lint_report_version`` pins the shape): ``{"lint_report_version": 1,
"files_scanned": n, "findings": [{rule, path, line, col, message}...],
"counts": {rule: n}}``.

Default targets (repo-root-relative globs): the ``shallowspeed_tpu_torch``
package, ``chip_smoke.py`` and the port's ``scripts/torch_*.py`` — NOT
``tests/`` (the fixture corpus under ``tests/lint_fixtures/`` exists to
violate the rules, and test code legitimately asserts on broad exception
classes) and not the JAX package's files (its own linter holds them).
"""

import argparse
import json
import sys
from pathlib import Path

from shallowspeed_tpu_torch.analysis.rules import (
    RULE_IDS,
    lint_file,
    load_schema_kinds,
)

DEFAULT_TARGETS = (
    "shallowspeed_tpu_torch",
    "chip_smoke.py",
    "scripts/torch_*.py",
)

LINT_REPORT_VERSION = 1


def _repo_root():
    """The repo root: the directory holding the ``shallowspeed_tpu_torch``
    package this module was imported from."""
    return Path(__file__).resolve().parents[2]


def iter_target_files(paths=None, root=None):
    """Expand targets into the sorted list of .py files to lint."""
    root = Path(root) if root is not None else _repo_root()
    if not paths:
        paths = [p for t in DEFAULT_TARGETS for p in sorted(root.glob(t))]
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts
            )
        elif p.exists():
            files.append(p)
        else:
            raise FileNotFoundError(f"lint target does not exist: {p}")
    return sorted(set(files))


def lint_paths(paths=None, root=None):
    """Lint the target set; returns ``(findings, files_scanned)``."""
    kinds = load_schema_kinds()
    findings = []
    files = iter_target_files(paths, root=root)
    for f in files:
        findings.extend(lint_file(f, schema_kinds=kinds))
    return findings, len(files)


def report(findings, files_scanned, fmt="text"):
    """Render the findings; returns the report string."""
    if fmt == "json":
        counts = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return json.dumps(
            {
                "lint_report_version": LINT_REPORT_VERSION,
                "files_scanned": files_scanned,
                "findings": [f.as_dict() for f in findings],
                "counts": counts,
            },
            indent=2,
            sort_keys=True,
            allow_nan=False,
        )
    lines = [f.format() for f in findings]
    verdict = (
        f"{len(findings)} finding(s) in {files_scanned} file(s)"
        if findings
        else f"clean: 0 findings in {files_scanned} file(s)"
    )
    return "\n".join([*lines, verdict])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.analysis.lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the repo's lintable set)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (json is the stable machine-readable shape)",
    )
    ap.add_argument(
        "--metrics-out", default=None,
        help="also record the verdict as a schema-v9 static_analysis "
        "JSONL record (name: 'lint', per-rule finding counts)",
    )
    args = ap.parse_args(argv)
    try:
        findings, n_files = lint_paths(args.paths or None)
    except (OSError, ValueError) as e:
        print(f"lint: error: {e}", file=sys.stderr)
        return 1
    if args.metrics_out:
        from shallowspeed_tpu_torch.observability import JsonlMetrics

        counts = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        with JsonlMetrics(args.metrics_out) as m:
            m.static_analysis(
                "lint",
                passes=sorted(RULE_IDS),
                findings=len(findings),
                by_rule=counts,
                files_scanned=n_files,
                finding_lines=[f.format() for f in findings[:50]],
            )
    print(report(findings, n_files, fmt=args.format))
    return 2 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
