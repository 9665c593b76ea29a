"""durlint: distributed-durability static analysis over the declared
state registry.

Four rule families, proven over the AST of the scheduler control plane
(same engine style as stalelint; ``# durlint: disable=<rule>``
suppressions are honored on the flagged line, its enclosing statement,
or the enclosing ``def`` line, and count against the shared
``analysis/budget.py`` ledger):

- **undeclared-state** — every mutable container assigned to ``self``
  anywhere in a declared control-plane class
  (:data:`~ballista_tpu_torch.analysis.durreg.CONTROL_CLASSES`), and EVERY
  dataclass field of ``JobInfo``, must resolve to a declared
  :class:`~ballista_tpu_torch.analysis.durreg.StateEntry` anchor. New
  scheduler state cannot land without writing down whether a restart
  keeps it, rebuilds it, or legitimately loses it.
- **unpersisted-mutation** — every mutator named in a declared
  :class:`~ballista_tpu_torch.analysis.durreg.PersistenceContract` must
  contain a call whose dotted name ends with each required persistence
  suffix. Dropping ``self.state.save_job(job)`` from
  ``_on_job_failed`` is a gate failure — the job would vanish from the
  backend while its terminal status exists only in dying memory.
- **recovery-gap** — every ``persisted`` entry's declared load method
  must actually be CALLED in ``_recover_state`` (write-only durability:
  a key that is saved religiously and never read back survives every
  restart while recovering nothing).
- **unguarded-backend-write** — ``backend.put``/``backend.delete``
  calls in the sweep must sit lexically inside
  ``with <...>.lock():`` or in a declared
  :class:`~ballista_tpu_torch.analysis.durreg.WriteSeam` — a lock-free
  read-modify-write against shared etcd is the split-brain shape that
  corrupts two-scheduler deployments.

Runtime counterpart: :mod:`ballista_tpu_torch.analysis.durwitness`
(``BALLISTA_DUR_WITNESS=1``) — a restarted scheduler's recovered state
is diffed against the declared durability classes.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from ballista_tpu_torch.analysis import durreg
from ballista_tpu_torch.analysis.stalelint import _Marked, _call_name, _dotted

_SUPPRESS_RE = re.compile(r"#\s*durlint:\s*disable=([A-Za-z0-9_,\- ]+)")

RULES = {
    "undeclared-state": "mutable control-plane state not declared in "
    "analysis/durreg.py",
    "unpersisted-mutation": "declared mutator dropped a required "
    "persistence call",
    "recovery-gap": "persisted key written but never read back in "
    "_recover_state",
    "unguarded-backend-write": "state-backend write outside the "
    "lock/ownership seam",
}

# Files swept: the scheduler control plane plus the history log (the
# one declared write seam outside scheduler/).
TARGET_DIR = "scheduler"
TARGET_MODULES = ("obs/history.py",)

# container shapes that count as mutable state for undeclared-state
_CONTAINER_CALLS = (
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter",
)
# methods that count as backend writes for unguarded-backend-write
_BACKEND_WRITES = ("put", "delete")


@dataclasses.dataclass(frozen=True)
class DurDiagnostic:
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
    files = sorted((root / TARGET_DIR).rglob("*.py"))
    files += [root / m for m in TARGET_MODULES if (root / m).exists()]
    return files


class _DurMarked(_Marked):
    """stalelint's suppression-lookup engine, re-keyed to the durlint
    marker."""

    def __call__(self, line: int, rule: str) -> bool:
        for ln in {line, self._stmt_line.get(line), self._def_line.get(line)}:
            if ln is None or ln < 1 or ln > len(self.lines):
                continue
            m = _SUPPRESS_RE.search(self.lines[ln - 1])
            if m and rule in [s.strip() for s in m.group(1).split(",")]:
                return True
        return False


def _container_value(value: ast.expr | None) -> bool:
    if value is None:
        return False
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        name = _call_name(value.func)
        if name in _CONTAINER_CALLS:
            return True
        if name == "field":
            # dataclasses.field(default_factory=dict/list/set/...)
            for kw in value.keywords:
                if kw.arg == "default_factory" and isinstance(
                    kw.value, ast.Name
                ) and kw.value.id in _CONTAINER_CALLS:
                    return True
    return False


# ---------------------------------------------------------------------------
# rule 1: undeclared-state
# ---------------------------------------------------------------------------

def _rule_undeclared_state(
    tree: ast.Module, filename: str, marked: _DurMarked,
    index: dict[str, str],
) -> list[DurDiagnostic]:
    out: list[DurDiagnostic] = []
    modes = {
        qual.split("::", 1)[1]: mode
        for qual, mode in durreg.CONTROL_CLASSES.items()
        if qual.startswith(filename + "::")
    }
    if not modes:
        return out
    for node in tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name in modes):
            continue
        mode = modes[node.name]
        flagged: set[str] = set()

        def flag(attr: str, line: int, what: str) -> None:
            anchor = f"{filename}::{node.name}.{attr}"
            if anchor in index or attr in flagged:
                return
            flagged.add(attr)
            if marked(line, "undeclared-state"):
                return
            out.append(DurDiagnostic(
                filename, line, "undeclared-state",
                f"`{node.name}.{attr}` is {what} with no durability "
                f"declaration — add anchor '{anchor}' to a StateEntry "
                "in analysis/durreg.py (persisted, rebuilt, or "
                "ephemeral with a written story)",
            ))

        if mode == "dataclass-fields":
            # EVERY field of the record must be anchored: a scalar
            # status field is exactly the state a restart loses
            for sub in node.body:
                target = None
                if isinstance(sub, ast.AnnAssign) and isinstance(
                    sub.target, ast.Name
                ):
                    target = sub.target.id
                elif isinstance(sub, ast.Assign) and len(
                    sub.targets
                ) == 1 and isinstance(sub.targets[0], ast.Name):
                    target = sub.targets[0].id
                if target is not None and not target.startswith("_"):
                    flag(target, sub.lineno, "a dataclass field")
            continue
        # init-containers: any `self.x = <mutable container>` anywhere
        # in the class's methods (state introduced lazily counts too)
        for sub in ast.walk(node):
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AnnAssign):
                targets, value = [sub.target], sub.value
            if not _container_value(value):
                continue
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    flag(t.attr, sub.lineno, "a mutable container")
    return out


# ---------------------------------------------------------------------------
# rule 2: unpersisted-mutation
# ---------------------------------------------------------------------------

def _rule_unpersisted_mutation(
    tree: ast.Module, filename: str, marked: _DurMarked
) -> list[DurDiagnostic]:
    out: list[DurDiagnostic] = []
    contracts = [c for c in durreg.CONTRACTS if c.file == filename]
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
                out.append(DurDiagnostic(
                    filename, 1, "unpersisted-mutation",
                    f"contract '{c.source}': mutator `{mut}` not found "
                    "(renamed? update analysis/durreg.py)",
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
                if marked(fn.lineno, "unpersisted-mutation"):
                    continue
                out.append(DurDiagnostic(
                    filename, fn.lineno, "unpersisted-mutation",
                    f"`{mut}` mutates durable state '{c.source}' but "
                    f"never calls `...{suffix}(...)` — declared fields "
                    f"{', '.join(c.fields)} would not survive a "
                    "scheduler restart",
                ))
    return out


# ---------------------------------------------------------------------------
# rule 3: recovery-gap
# ---------------------------------------------------------------------------

def _rule_recovery_gap(
    tree: ast.Module, filename: str, marked: _DurMarked
) -> list[DurDiagnostic]:
    if filename != "ballista_tpu_torch/scheduler/server.py":
        return []
    out: list[DurDiagnostic] = []
    recover = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_recover_state":
            recover = node
            break
    if recover is None:
        return [DurDiagnostic(
            filename, 1, "recovery-gap",
            "_recover_state not found — the recovery entry point the "
            "persisted registry is proven against (renamed? update "
            "analysis/durlint.py)",
        )]
    calls = {
        _dotted(sub.func)
        for sub in ast.walk(recover)
        if isinstance(sub, ast.Call)
    }
    for e in durreg.entries("persisted"):
        if e.load is None:
            continue  # verify_anchors already flags this
        if any(d.endswith(e.load) for d in calls):
            continue
        if marked(recover.lineno, "recovery-gap"):
            continue
        out.append(DurDiagnostic(
            filename, recover.lineno, "recovery-gap",
            f"persisted entry '{e.name}' declares load `{e.load}` but "
            "_recover_state never calls it — write-only durability: "
            "the key survives every restart while recovering nothing",
        ))
    return out


# ---------------------------------------------------------------------------
# rule 4: unguarded-backend-write
# ---------------------------------------------------------------------------

def _rule_unguarded_backend_write(
    tree: ast.Module, filename: str, marked: _DurMarked
) -> list[DurDiagnostic]:
    out: list[DurDiagnostic] = []
    seams = {
        fn
        for s in durreg.WRITE_SEAMS
        if s.file == filename
        for fn in s.functions
    }

    def is_backend_write(call: ast.Call) -> bool:
        func = call.func
        return (
            isinstance(func, ast.Attribute)
            and func.attr in _BACKEND_WRITES
            and isinstance(func.value, ast.Attribute)
            and func.value.attr == "backend"
        )

    def is_lock_with(node: ast.With) -> bool:
        return any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func).endswith("lock")
            for item in node.items
        )

    def walk(node: ast.AST, locked: bool, seam: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_locked = locked
            child_seam = seam
            if isinstance(child, ast.With) and is_lock_with(child):
                child_locked = True
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_seam = seam or child.name in seams
                # a nested def is a new lexical frame: an enclosing
                # `with lock:` does not guard calls made later through
                # the closure
                child_locked = False
            if (
                isinstance(child, ast.Call)
                and is_backend_write(child)
                and not child_locked
                and not child_seam
                and not marked(child.lineno, "unguarded-backend-write")
            ):
                out.append(DurDiagnostic(
                    filename, child.lineno, "unguarded-backend-write",
                    f"`{_dotted(child.func)}` writes the state backend "
                    "outside `with backend.lock():` and outside any "
                    "declared WriteSeam — on a shared etcd backend this "
                    "is the split-brain shape (declare a seam with "
                    "reasoning in analysis/durreg.py or take the lock)",
                ))
            walk(child, child_locked, child_seam)

    walk(tree, False, False)
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def lint_source(source: str, filename: str) -> list[DurDiagnostic]:
    tree = ast.parse(source, filename=filename)
    marked = _DurMarked(source, tree)
    index = durreg.anchor_index()
    diags = (
        _rule_undeclared_state(tree, filename, marked, index)
        + _rule_unpersisted_mutation(tree, filename, marked)
        + _rule_recovery_gap(tree, filename, marked)
        + _rule_unguarded_backend_write(tree, filename, marked)
    )
    return sorted(diags, key=lambda d: (d.file, d.line, d.rule))


def lint_paths(paths=None) -> list[DurDiagnostic]:
    root = _package_root()
    files = (
        [pathlib.Path(p) for p in paths] if paths else target_files()
    )
    diags: list[DurDiagnostic] = []
    seen: set[str] = set()
    for path in files:
        rel = str(path.relative_to(root)) if path.is_absolute() else str(path)
        seen.add(rel)
        diags += lint_source(path.read_text(), rel)
    if paths is None:
        # contracts/classes/seams over files outside the sweep would
        # silently never run
        for c in durreg.CONTRACTS:
            if c.file not in seen:
                diags.append(DurDiagnostic(
                    c.file, 1, "unpersisted-mutation",
                    f"contract '{c.source}' targets a file outside the "
                    "durlint sweep",
                ))
        for qual in durreg.CONTROL_CLASSES:
            rel = qual.split("::", 1)[0]
            if rel not in seen:
                diags.append(DurDiagnostic(
                    rel, 1, "undeclared-state",
                    f"control class '{qual}' lives outside the durlint "
                    "sweep",
                ))
        for s in durreg.WRITE_SEAMS:
            if s.file not in seen:
                diags.append(DurDiagnostic(
                    s.file, 1, "unguarded-backend-write",
                    f"write seam over '{s.file}' targets a file outside "
                    "the durlint sweep",
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
