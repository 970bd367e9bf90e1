"""House-rule AST lint rules — the conventions generic linters can't see.

Every rule encodes an invariant this repo already enforces by review
(docs/static-analysis.md has the catalog with the why behind each):

- ``BLE001``  a broad ``except Exception``/``except BaseException``/bare
              ``except`` must either re-raise or carry the justification
              idiom ``# noqa: BLE001 — <why>`` on the except line;
- ``SSP002``  ``json.dumps`` on metrics paths (``observability/``,
              ``serving/``) must pass ``allow_nan=False`` — every record
              line must be STRICT JSON (the ``_json_safe`` lesson);
- ``SSP003``  modules owning durable on-disk formats (``checkpoint.py``)
              may only write through
              ``checkpoint.atomic_write`` — no raw ``open(.., "w")``,
              ``os.fdopen`` write modes or ``Path.write_*`` outside the
              ``atomic_write`` body itself;
- ``SSP004``  ``donate_argnums`` is allowed only in the whitelisted
              trainer/executor modules (the donation hazard: a
              donating program must never be deserialized and
              dispatched); torch has no ``donate_argnums``, so on
              this package the rule finds nothing, and it stays so that
              a ``jax.jit`` brought in by mistake is caught where it
              lands (the port's in-place writes are checked at run time
              instead: ``program_audit.check_dispatch_safety``);
- ``SSP005``  every dict literal handed to ``_emit`` must carry a
              ``"kind"`` that is a string literal registered in the
              ``metrics.SCHEMA_KINDS`` table (schema-version
              discipline);
- ``SSP006``  in a class that owns a ``threading.Lock``/``RLock``,
              attributes ever ASSIGNED under a ``with self.<lock>:``
              block are lock-guarded: touching them outside a with-lock
              block in that class (``__init__`` excepted — construction
              happens-before publication) is a data race waiting for a
              second thread.

Suppression: ``# noqa: <RULE> — <why>`` on the offending line (the
BLE001 idiom generalized); a bare ``noqa`` without a justification does
NOT suppress. Rules are pure ``ast`` + source text — no imports of the
linted code, so the linter runs without torch as well as without jax.
"""

import ast
import dataclasses
import re
from pathlib import Path

RULE_IDS = ("BLE001", "SSP002", "SSP003", "SSP004", "SSP005", "SSP006")

# the justification idiom: rule id(s) then an em-dash (or --) and WHY
_NOQA_RE = re.compile(
    r"#\s*noqa:\s*(?P<ids>[A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*)"
    r"(?:\s*[—–-]+\s*(?P<why>\S.*))?"
)

_WRITE_MODE_RE = re.compile(r"[wax+]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding: stable rule id + precise location + message."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Scope:
    """Which path-scoped rules apply to the file being linted. Derived
    from the repo-relative path by ``scope_for``; tests may force flags
    to exercise scoped rules on fixture files."""

    metrics_path: bool = False  # SSP002: observability/ + serving/
    atomic_module: bool = False  # SSP003: checkpoint.py
    donation_ok: bool = False  # SSP004: trainer.py + parallel/executor.py


def scope_for(path):
    """Default rule scope for a repo file, by its path."""
    p = Path(path).as_posix()
    return Scope(
        metrics_path=(
            "shallowspeed_tpu_torch/observability/" in p
            or "shallowspeed_tpu_torch/serving/" in p
        ),
        atomic_module=p.endswith("shallowspeed_tpu_torch/checkpoint.py"),
        donation_ok=p.endswith(
            (
                "shallowspeed_tpu_torch/trainer.py",
                "shallowspeed_tpu_torch/parallel/executor.py",
            )
        ),
    )


_SCHEMA_KINDS_CACHE = {}


def load_schema_kinds(metrics_path=None):
    """The ``SCHEMA_KINDS`` registry, parsed from metrics.py by AST — the
    linter must not import the package it lints (and must run without
    torch or jax). Returns ``{kind: version_introduced}``."""
    if metrics_path is None:
        metrics_path = (
            Path(__file__).resolve().parents[1] / "observability" / "metrics.py"
        )
    key = str(metrics_path)
    if key not in _SCHEMA_KINDS_CACHE:
        tree = ast.parse(Path(metrics_path).read_text(encoding="utf-8"))
        kinds = None
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "SCHEMA_KINDS"
                    for t in node.targets
                )
            ):
                kinds = ast.literal_eval(node.value)
        if not isinstance(kinds, dict) or not kinds:
            raise ValueError(
                f"{metrics_path}: no SCHEMA_KINDS table found — the metrics"
                " schema registry is the linter's ground truth"
            )
        _SCHEMA_KINDS_CACHE[key] = kinds
    return _SCHEMA_KINDS_CACHE[key]


def _suppressed(lines, lineno, rule):
    """True when the source line carries a JUSTIFIED noqa for ``rule``."""
    if not 1 <= lineno <= len(lines):
        return False
    m = _NOQA_RE.search(lines[lineno - 1])
    if not m or not m.group("why"):
        return False
    ids = {i.strip() for i in m.group("ids").split(",")}
    return rule in ids


class _RuleVisitor(ast.NodeVisitor):
    """One pass over a module collecting findings for every rule."""

    def __init__(self, path, lines, scope, schema_kinds):
        self.path = str(path)
        self.lines = lines
        self.scope = scope
        self.schema_kinds = schema_kinds
        self.findings = []
        self._func_stack = []

    def _emit(self, rule, node, message):
        if not _suppressed(self.lines, node.lineno, rule):
            self.findings.append(
                Finding(rule, self.path, node.lineno, node.col_offset, message)
            )

    # -- BLE001: justified broad excepts ------------------------------------

    def visit_ExceptHandler(self, node):
        names = set()
        types = (
            node.type.elts if isinstance(node.type, ast.Tuple)
            else [node.type] if node.type is not None else []
        )
        for t in types:
            if isinstance(t, ast.Name):
                names.add(t.id)
        broad = node.type is None or names & {"Exception", "BaseException"}
        reraises = any(isinstance(n, ast.Raise) for n in ast.walk(node))
        if broad and not reraises:
            self._emit(
                "BLE001", node,
                "broad except that swallows: justify with"
                " '# noqa: BLE001 — <why>' (or narrow / re-raise)",
            )
        self.generic_visit(node)

    # -- function context (SSP003 exempts atomic_write itself) ---------------

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- call-shaped rules ---------------------------------------------------

    def visit_Call(self, node):
        self._check_json_dumps(node)
        self._check_raw_write(node)
        self._check_donation(node)
        self._check_emit_kind(node)
        self.generic_visit(node)

    def _check_json_dumps(self, node):
        if not self.scope.metrics_path:
            return
        f = node.func
        if not (
            isinstance(f, ast.Attribute)
            and f.attr == "dumps"
            and isinstance(f.value, ast.Name)
            and f.value.id == "json"
        ):
            return
        for kw in node.keywords:
            if kw.arg == "allow_nan":
                if isinstance(kw.value, ast.Constant) and kw.value.value is False:
                    return
                break
        self._emit(
            "SSP002", node,
            "json.dumps on a metrics path must pass allow_nan=False"
            " (every record line must be strict JSON)",
        )

    def _check_raw_write(self, node):
        if not self.scope.atomic_module or "atomic_write" in self._func_stack:
            return
        f = node.func
        opener = None
        if isinstance(f, ast.Name) and f.id == "open":
            opener, mode_pos = "open", 1
        elif (
            isinstance(f, ast.Attribute) and f.attr == "fdopen"
            and isinstance(f.value, ast.Name) and f.value.id == "os"
        ):
            opener, mode_pos = "os.fdopen", 1
        if opener is not None:
            mode = None
            if len(node.args) > mode_pos:
                mode = node.args[mode_pos]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if mode is None:
                return  # default "r": a read is not a write
            if not isinstance(mode, ast.Constant) or (
                isinstance(mode.value, str) and _WRITE_MODE_RE.search(mode.value)
            ):
                self._emit(
                    "SSP003", node,
                    f"raw {opener}(..) write in a durable-format module:"
                    " route it through checkpoint.atomic_write",
                )
            return
        if isinstance(f, ast.Attribute) and f.attr in (
            "write_text", "write_bytes",
        ):
            self._emit(
                "SSP003", node,
                f"Path.{f.attr} in a durable-format module: route it"
                " through checkpoint.atomic_write",
            )

    def _check_donation(self, node):
        if self.scope.donation_ok:
            return
        for kw in node.keywords:
            if kw.arg == "donate_argnums":
                self._emit(
                    "SSP004", node,
                    "donate_argnums outside the whitelisted trainer/executor"
                    " modules (a donating program must never reach the"
                    " serving or AOT-deserialize paths)",
                )

    def _check_emit_kind(self, node):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if name != "_emit" or not node.args:
            return
        rec = node.args[0]
        if not isinstance(rec, ast.Dict):
            return  # pass-through dicts are built from already-linted sites
        for k, v in zip(rec.keys, rec.values):
            if isinstance(k, ast.Constant) and k.value == "kind":
                if not (isinstance(v, ast.Constant) and isinstance(v.value, str)):
                    self._emit(
                        "SSP005", v if v is not None else node,
                        "record 'kind' must be a string literal (the schema"
                        " registry cannot check a computed kind)",
                    )
                elif v.value not in self.schema_kinds:
                    self._emit(
                        "SSP005", v,
                        f"record kind {v.value!r} is not registered in"
                        " metrics.SCHEMA_KINDS — register it with its"
                        " schema version (additive bump) first",
                    )

    # -- SSP006: lock discipline --------------------------------------------

    def visit_ClassDef(self, node):
        self._check_lock_discipline(node)
        self.generic_visit(node)

    def _check_lock_discipline(self, cls):
        locks = set()
        for n in ast.walk(cls):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                f = n.value.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in ("Lock", "RLock")
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "threading"
                ):
                    for t in n.targets:
                        if self._self_attr(t):
                            locks.add(t.attr)
        if not locks:
            return
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        guarded = set()
        for m in methods:
            if m.name == "__init__":
                continue
            self._walk_lock(m.body, False, locks, guarded, collect=True)
        guarded -= locks
        if not guarded:
            return
        for m in methods:
            if m.name == "__init__":
                continue
            self._walk_lock(m.body, False, locks, guarded, collect=False)

    @staticmethod
    def _self_attr(node):
        return (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        )

    def _is_lock_with(self, stmt, locks):
        return isinstance(stmt, ast.With) and any(
            self._self_attr(item.context_expr)
            and item.context_expr.attr in locks
            for item in stmt.items
        )

    def _walk_lock(self, stmts, under_lock, locks, guarded, collect):
        """Walk statements tracking with-lock nesting. ``collect=True``
        gathers attrs ASSIGNED under a lock; ``collect=False`` flags any
        access to a guarded attr outside a lock."""
        for stmt in stmts:
            locked = under_lock or self._is_lock_with(stmt, locks)
            # examine this statement's own expressions (not nested blocks)
            for n in ast.walk(stmt):
                if not self._self_attr(n) or n.attr in locks:
                    continue
                # a nested statement list re-walks with its own lock state;
                # restrict this sweep to nodes not inside a deeper With
                if self._in_nested_block(stmt, n):
                    continue
                if collect:
                    if locked and isinstance(n.ctx, ast.Store):
                        guarded.add(n.attr)
                elif not locked and n.attr in guarded:
                    self._emit(
                        "SSP006", n,
                        f"attribute self.{n.attr} is lock-guarded (assigned"
                        " under a with-lock block in this class) but touched"
                        " here outside the lock",
                    )
            for field in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, field, None)
                if inner:
                    self._walk_lock(inner, locked, locks, guarded, collect)
            for h in getattr(stmt, "handlers", ()):
                self._walk_lock(h.body, locked, locks, guarded, collect)

    @staticmethod
    def _in_nested_block(stmt, node):
        """True when ``node`` sits inside a nested compound statement of
        ``stmt`` (those are re-walked with their own lock state)."""
        for field in ("body", "orelse", "finalbody"):
            for inner in getattr(stmt, field, ()):
                if node in set(ast.walk(inner)):
                    return True
        for h in getattr(stmt, "handlers", ()):
            for inner in h.body:
                if node in set(ast.walk(inner)):
                    return True
        return False


def lint_source(source, path="<string>", scope=None, schema_kinds=None):
    """Lint one module's source text; returns a list of Findings."""
    if scope is None:
        scope = scope_for(path)
    if schema_kinds is None:
        schema_kinds = load_schema_kinds()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [
            Finding(
                "E999", str(path), e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}",
            )
        ]
    visitor = _RuleVisitor(str(path), source.splitlines(), scope, schema_kinds)
    visitor.visit(tree)
    return sorted(visitor.findings, key=lambda f: (f.path, f.line, f.col))


def lint_file(path, scope=None, schema_kinds=None):
    """Lint one file; returns a list of Findings."""
    text = Path(path).read_text(encoding="utf-8")
    return lint_source(text, path=path, scope=scope, schema_kinds=schema_kinds)
