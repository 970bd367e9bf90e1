"""Static program analysis: the port's copies of the JAX package's
``analysis/`` modules.

- ``progcheck`` (send/recv match, deadlock freedom) and ``stash`` (stash
  lifetimes) run over lowered tick programs. The MPMD runtime
  (``parallel/mpmd.py``, per-stage streams in one process) admits a program
  through ``analyze_program`` before it builds a stage program.
- ``rules`` and ``lint``: the house-rule AST linter (stdlib ``ast``, no
  imports of the code it lints, so it runs without torch):
  ``python -m shallowspeed_tpu_torch.analysis.lint`` over the port's
  package, ``chip_smoke.py`` and ``scripts/torch_*.py`` (exit 0 clean, 1
  linter failure, 2 findings; ``--format json``, ``--metrics-out``).

The run-time counterpart of the JAX package's HLO dispatch-safety pass,
the in-place write check on a serving rung's params, lives in
``observability/program_audit.py`` beside the comms census.
"""

from shallowspeed_tpu_torch.analysis.progcheck import (
    ProgramAnalysisError,
    analyze_program,
    check_deadlock_free,
    check_send_recv,
)
from shallowspeed_tpu_torch.analysis.rules import (
    RULE_IDS,
    Finding,
    Scope,
    lint_file,
    lint_source,
    load_schema_kinds,
    scope_for,
)
from shallowspeed_tpu_torch.analysis.stash import check_stash_lifetime

__all__ = [
    "RULE_IDS",
    "Finding",
    "ProgramAnalysisError",
    "Scope",
    "analyze_program",
    "check_deadlock_free",
    "check_send_recv",
    "check_stash_lifetime",
    "lint_file",
    "lint_source",
    "load_schema_kinds",
    "scope_for",
]
