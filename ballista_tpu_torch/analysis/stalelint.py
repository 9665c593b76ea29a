"""stalelint: cache-coherence static analysis over the declared registry.

Four rule families, proven over the AST of the whole package (same
engine style as racelint/lifelint; ``# stalelint: disable=<rule>``
suppressions are honored on the flagged line, its enclosing statement,
or the enclosing ``def`` line, and count against the shared
``analysis/budget.py`` ledger):

- **undeclared-cache** — a dict/LRU-shaped instance attribute, module
  global, or ``lru_cache`` decorator whose name or constructor matches
  the cache idiom (``*_cache``/``*Cache``, pool, registry, snapshot,
  hint, memo, LUT) must resolve to a declared
  :class:`~ballista_tpu_torch.analysis.cachereg.CacheEntry` (or a written
  :class:`~ballista_tpu_torch.analysis.cachereg.Exempt`). New caches cannot
  land without writing down their key composition, scope, coherence
  class, and invalidation sites.
- **missing-invalidation** — every mutator named in a declared
  :class:`~ballista_tpu_torch.analysis.cachereg.InvalidationContract` must
  contain a call whose dotted name ends with each required invalidation
  suffix. Dropping ``self._plan_cache.clear()`` from ``register_table``,
  or ``job.eager_plan_bytes.pop(...)`` from ``apply_certified_rewrite``,
  is a gate failure — the contract the JobInfo comments used to carry in
  prose.
- **snapshot-escape** — ``snapshot``-class caches may only be READ
  through their declared seam (``Executor._job_snapshot``). Any other
  load of the live anchor from its owning file — passing
  ``self._plan_cache`` itself into a task attempt instead of the frozen
  copy is the exact q15 warm-drift bug — is an error. Writes (commit
  merges, invalidation pops) and declared persistence sinks
  (``ok_calls``) stay legal: learning still lands, it just cannot be
  adopted mid-job.
- **unvalidated-speculation** — operator code (``exec/``, ``ops/``,
  outside the ``exec/base.py`` seam itself) may only write to the
  speculative plan cache (``ctx.plan_cache`` and its local aliases) from
  a function that is wired into the validation seam — i.e. one that also
  calls ``defer_speculation``/``defer_learn``/``defer_commit``. A bare
  write with no validation path is a guess no future run ever checks.

Runtime counterpart: :mod:`ballista_tpu_torch.analysis.stalewitness`
(``BALLISTA_CACHE_WITNESS=1``) — sampled cache hits must hash-match a
fresh re-derivation, the staleness analogue of the replay witness.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from ballista_tpu_torch.analysis import cachereg

_SUPPRESS_RE = re.compile(r"#\s*stalelint:\s*disable=([A-Za-z0-9_,\- ]+)")

RULES = {
    "undeclared-cache": "cache-shaped state not declared in "
    "analysis/cachereg.py",
    "missing-invalidation": "version-source mutator dropped a declared "
    "invalidation call",
    "snapshot-escape": "live snapshot-class state read outside its "
    "declared seam",
    "unvalidated-speculation": "speculative cache written outside the "
    "validation seam",
}

# Directories + top-level modules swept by the undeclared-cache rule
# (analysis/, testing/, proto/, tpch are out: witness record maps and
# test fixtures are not product caches).
TARGET_DIRS = (
    "client", "columnar", "compilecache", "exec", "executor", "expr",
    "obs", "ops", "parallel", "plan", "scheduler", "sql",
)
TARGET_MODULES = (
    "avro.py", "cli.py", "config.py", "datatypes.py",
    "distributed_plan.py", "errors.py", "event_loop.py", "functions.py",
    "plugin.py", "rewrite.py", "scheduler_types.py", "serde.py",
    "standalone.py", "utils.py",
)

# name fragments that mark a binding as cache-idiomatic
_NAME_HINTS = ("cache", "pool", "registry", "snapshot", "hint", "memo",
               "lut")
# constructor names that mark a value as cache-idiomatic regardless of
# the binding name
_CLASS_SUFFIXES = ("Cache", "Registry", "Pool", "Store", "Ladder")
_DICTISH_CALLS = ("dict", "OrderedDict", "defaultdict",
                  "WeakValueDictionary")

# rule 4: the speculative plan cache as operator code sees it
_SPEC_ATTR = "plan_cache"
_RULE4_DIRS = ("exec", "ops")
_RULE4_SEAM_FILES = ("ballista_tpu_torch/exec/base.py",)
_VALIDATION_CALLS = ("defer_speculation", "defer_learn", "defer_commit")

_WRITE_METHODS = ("update", "pop", "clear", "setdefault", "popitem")


@dataclasses.dataclass(frozen=True)
class StaleDiagnostic:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def target_files() -> list[pathlib.Path]:
    root = _package_root() / "ballista_tpu_torch"
    files: list[pathlib.Path] = []
    for d in TARGET_DIRS:
        files += sorted((root / d).rglob("*.py"))
    files += [root / m for m in TARGET_MODULES if (root / m).exists()]
    return files


def _suppressed(source_lines: list[str], line: int, rule: str) -> bool:
    if line < 1 or line > len(source_lines):
        return False
    m = _SUPPRESS_RE.search(source_lines[line - 1])
    return bool(m) and rule in [
        s.strip() for s in m.group(1).split(",")
    ]


class _Marked:
    """Suppression lookup honoring the flagged line, its enclosing
    statement's first line, and the enclosing def line (detlint's
    contract)."""

    def __init__(self, source: str, tree: ast.Module):
        self.lines = source.splitlines()
        self._def_line: dict[int, int] = {}
        self._stmt_line: dict[int, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(node):
                    ln = getattr(sub, "lineno", None)
                    if ln is not None and ln not in self._def_line:
                        self._def_line[ln] = node.lineno
            if isinstance(node, ast.stmt):
                for sub in ast.walk(node):
                    ln = getattr(sub, "lineno", None)
                    if ln is not None and ln not in self._stmt_line:
                        self._stmt_line[ln] = node.lineno

    def __call__(self, line: int, rule: str) -> bool:
        for ln in {line, self._stmt_line.get(line), self._def_line.get(line)}:
            if ln is not None and _suppressed(self.lines, ln, rule):
                return True
        return False


def _name_hit(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in _NAME_HINTS)


def _call_name(func: ast.expr) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted rendering: ``job.eager_plan_bytes.pop`` ->
    'job.eager_plan_bytes.pop' (call suffix matching)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _cacheish_value(value: ast.expr | None) -> bool:
    if value is None:
        return False
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(value, ast.Call):
        name = _call_name(value.func)
        if name in _DICTISH_CALLS:
            return True
        if any(name.endswith(sfx) for sfx in _CLASS_SUFFIXES):
            return True
        if name == "field":
            # dataclasses.field(default_factory=dict/OrderedDict/...)
            for kw in value.keywords:
                if kw.arg == "default_factory" and isinstance(
                    kw.value, ast.Name
                ) and kw.value.id in _DICTISH_CALLS + ("dict",):
                    return True
    return False


def _cache_class_call(value: ast.expr | None) -> bool:
    return isinstance(value, ast.Call) and any(
        _call_name(value.func).endswith(sfx) for sfx in _CLASS_SUFFIXES
    )


# ---------------------------------------------------------------------------
# rule 1: undeclared-cache
# ---------------------------------------------------------------------------

def _rule_undeclared(
    tree: ast.Module, filename: str, marked: _Marked, index: dict[str, str]
) -> list[StaleDiagnostic]:
    out: list[StaleDiagnostic] = []
    flagged: set[tuple[str, int]] = set()

    def check(qual: str, value: ast.expr | None, line: int) -> None:
        name = qual.rsplit(".", 1)[-1]
        if not _cacheish_value(value):
            return
        if not (_name_hit(name) or _cache_class_call(value)):
            return
        anchor = f"{filename}::{qual}"
        if anchor in index or (qual, line) in flagged:
            return
        flagged.add((qual, line))
        if marked(line, "undeclared-cache"):
            return
        out.append(StaleDiagnostic(
            filename, line, "undeclared-cache",
            f"`{qual}` looks like a cache but has no CacheEntry — "
            f"declare anchor '{anchor}' (or an Exempt with a reason) in "
            "analysis/cachereg.py",
        ))

    def split(node: ast.stmt) -> tuple[list[ast.expr], ast.expr | None]:
        if isinstance(node, ast.Assign):
            return node.targets, node.value
        if isinstance(node, ast.AnnAssign):
            return [node.target], node.value
        return [], None

    # module globals: Name targets at module level only (locals inside
    # functions are attempt-scoped, not shared caches)
    for node in tree.body:
        for t, value in [(t, v) for ts, v in [split(node)] for t in ts]:
            if isinstance(t, ast.Name):
                check(t.id, value, node.lineno)
        if not isinstance(node, ast.ClassDef):
            continue
        cls = node
        # class-body fields (dataclass fields included)
        for sub in cls.body:
            for t, value in [(t, v) for ts, v in [split(sub)] for t in ts]:
                if isinstance(t, ast.Name):
                    check(f"{cls.name}.{t.id}", value, sub.lineno)
        # instance attributes anywhere in the class's methods
        for sub in ast.walk(cls):
            for t, value in [(t, v) for ts, v in [split(sub)] for t in ts]:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    check(f"{cls.name}.{t.attr}", value, sub.lineno)
    # lru_cache / functools.cache decorators are caches with no explicit
    # invalidation story at all: they must be declared or exempted
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            base = dec.func if isinstance(dec, ast.Call) else dec
            if _call_name(base) in ("lru_cache", "cache") or (
                isinstance(base, ast.Attribute)
                and base.attr in ("lru_cache", "cache")
            ):
                anchor = f"{filename}::{node.name}"
                if anchor in index or marked(
                    node.lineno, "undeclared-cache"
                ):
                    continue
                out.append(StaleDiagnostic(
                    filename, node.lineno, "undeclared-cache",
                    f"`@{_call_name(base)}` on `{node.name}` is an "
                    f"undeclared cache — declare anchor '{anchor}' in "
                    "analysis/cachereg.py",
                ))
    return out


# ---------------------------------------------------------------------------
# rule 2: missing-invalidation
# ---------------------------------------------------------------------------

def _rule_missing_invalidation(
    tree: ast.Module, filename: str, marked: _Marked
) -> list[StaleDiagnostic]:
    out: list[StaleDiagnostic] = []
    contracts = [c for c in cachereg.CONTRACTS if c.file == filename]
    if not contracts:
        return out
    funcs: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            funcs.setdefault(node.name, node)
    for c in contracts:
        for mut in c.mutators:
            fn = funcs.get(mut)
            if fn is None:
                out.append(StaleDiagnostic(
                    filename, 1, "missing-invalidation",
                    f"contract '{c.source}': mutator `{mut}` not found "
                    "(renamed? update analysis/cachereg.py)",
                ))
                continue
            calls = {
                _dotted(sub.func)
                for sub in ast.walk(fn)
                if isinstance(sub, ast.Call)
            }
            for suffix in c.must_call:
                if any(d.endswith(suffix) for d in calls):
                    continue
                if marked(fn.lineno, "missing-invalidation"):
                    continue
                out.append(StaleDiagnostic(
                    filename, fn.lineno, "missing-invalidation",
                    f"`{mut}` mutates version source '{c.source}' but "
                    f"never calls `...{suffix}(...)` — dependent caches "
                    f"{', '.join(c.caches)} would serve stale state",
                ))
    return out


# ---------------------------------------------------------------------------
# rule 3: snapshot-escape
# ---------------------------------------------------------------------------

def _enclosing_funcs(tree: ast.Module) -> dict[ast.AST, list[str]]:
    """node -> names of every enclosing function (innermost last)."""
    chains: dict[ast.AST, list[str]] = {}

    def walk(node: ast.AST, stack: list[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, stack + [child.name])
            else:
                chains[child] = stack
                walk(child, stack)

    walk(tree, [])
    return chains


def _rule_snapshot_escape(
    tree: ast.Module, filename: str, marked: _Marked
) -> list[StaleDiagnostic]:
    entries = [
        (e, a.split("::", 1)[1])
        for e in cachereg.CACHES
        if e.coherence == "snapshot"
        for a in e.anchors
        if a.startswith(filename + "::")
    ]
    if not entries:
        return []
    out: list[StaleDiagnostic] = []
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    chains = _enclosing_funcs(tree)

    for e, qual in entries:
        attr = qual.rsplit(".", 1)[-1]
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Attribute)
                and node.attr == attr
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                continue
            if any(fn in e.seam for fn in chains.get(node, [])):
                continue
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                continue
            parent = parents.get(node)
            # receiver of a mutation method: self.X.update(...) etc.
            if (
                isinstance(parent, ast.Attribute)
                and parent.attr in _WRITE_METHODS
                and isinstance(parents.get(parent), ast.Call)
                and parents[parent].func is parent
            ):
                continue
            # store-subscript: self.X[k] = v
            if isinstance(parent, ast.Subscript) and isinstance(
                parent.ctx, ast.Store
            ):
                continue
            # argument to a declared persistence sink
            if isinstance(parent, ast.Call) and node in (
                list(parent.args) + [kw.value for kw in parent.keywords]
            ):
                callee = _dotted(parent.func).rsplit(".", 1)[-1]
                if callee in e.ok_calls:
                    continue
            if marked(node.lineno, "snapshot-escape"):
                continue
            out.append(StaleDiagnostic(
                filename, node.lineno, "snapshot-escape",
                f"live read of snapshot-class `{e.name}` "
                f"(self.{attr}) outside its seam "
                f"{e.seam} — task paths must go through the frozen "
                "job-snapshot copy (the q15 warm-drift shape)",
            ))
    return out


# ---------------------------------------------------------------------------
# rule 4: unvalidated-speculation
# ---------------------------------------------------------------------------

def _rule4_applies(filename: str) -> bool:
    if filename in _RULE4_SEAM_FILES:
        return False
    return any(
        filename.startswith(f"ballista_tpu_torch/{d}/") for d in _RULE4_DIRS
    )


def _rule_unvalidated_speculation(
    tree: ast.Module, filename: str, marked: _Marked
) -> list[StaleDiagnostic]:
    if not _rule4_applies(filename):
        return []
    out: list[StaleDiagnostic] = []

    def outermost_funcs(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child
            else:
                yield from outermost_funcs(child)

    def contains_spec_attr(expr: ast.expr) -> bool:
        return any(
            isinstance(n, ast.Attribute) and n.attr == _SPEC_ATTR
            for n in ast.walk(expr)
        )

    for fn in outermost_funcs(tree):
        validated = any(
            isinstance(n, ast.Call)
            and _call_name(n.func) in _VALIDATION_CALLS
            for n in ast.walk(fn)
        )
        aliases: set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and contains_spec_attr(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
            elif isinstance(n, ast.AnnAssign) and n.value is not None \
                    and contains_spec_attr(n.value):
                if isinstance(n.target, ast.Name):
                    aliases.add(n.target.id)

        def is_spec_ref(base: ast.expr) -> bool:
            if isinstance(base, ast.Attribute) and base.attr == _SPEC_ATTR:
                return True
            return isinstance(base, ast.Name) and base.id in aliases

        writes: list[int] = []
        for n in ast.walk(fn):
            if (
                isinstance(n, ast.Subscript)
                and isinstance(n.ctx, ast.Store)
                and is_spec_ref(n.value)
            ):
                writes.append(n.lineno)
            elif (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("update", "setdefault")
                and is_spec_ref(n.func.value)
            ):
                writes.append(n.lineno)
        if not writes or validated:
            continue
        for line in writes:
            if marked(line, "unvalidated-speculation"):
                continue
            out.append(StaleDiagnostic(
                filename, line, "unvalidated-speculation",
                f"`{fn.name}` writes the speculative plan cache but "
                "never wires a validation path "
                "(defer_speculation/defer_learn/defer_commit) — a guess "
                "no future run ever checks",
            ))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def lint_source(source: str, filename: str) -> list[StaleDiagnostic]:
    tree = ast.parse(source, filename=filename)
    marked = _Marked(source, tree)
    index = cachereg.anchor_index()
    diags = (
        _rule_undeclared(tree, filename, marked, index)
        + _rule_missing_invalidation(tree, filename, marked)
        + _rule_snapshot_escape(tree, filename, marked)
        + _rule_unvalidated_speculation(tree, filename, marked)
    )
    return sorted(diags, key=lambda d: (d.file, d.line, d.rule))


def lint_paths(paths=None) -> list[StaleDiagnostic]:
    root = _package_root()
    files = (
        [pathlib.Path(p) for p in paths] if paths else target_files()
    )
    diags: list[StaleDiagnostic] = []
    seen: set[str] = set()
    for path in files:
        rel = str(path.relative_to(root)) if path.is_absolute() else str(path)
        seen.add(rel)
        diags += lint_source(path.read_text(), rel)
    if paths is None:
        # contracts over files outside the sweep would silently never run
        for c in cachereg.CONTRACTS:
            if c.file not in seen:
                diags.append(StaleDiagnostic(
                    c.file, 1, "missing-invalidation",
                    f"contract '{c.source}' targets a file outside the "
                    "stalelint sweep",
                ))
    return sorted(set(diags), key=lambda d: (d.file, d.line, d.rule))


def suppression_count(paths=None) -> int:
    root = _package_root()
    files = (
        [pathlib.Path(p) for p in paths] if paths else target_files()
    )
    n = 0
    for path in files:
        for line in path.read_text().splitlines():
            if _SUPPRESS_RE.search(line):
                n += 1
    return n
