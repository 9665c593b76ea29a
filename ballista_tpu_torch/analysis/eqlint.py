"""eqlint: the no-uncertified-mutation closure over physical plans (port
of ``ballista_tpu/analysis/eqlint.py``, aimed at ``ballista_tpu_torch/``).

``ballista_tpu_torch/rewrite.py`` is the certified plan-rewrite API — the ONLY
sanctioned way to change the structure of an ``ExecutionPlan`` tree or a
stage plan after construction. This AST lint is what makes that claim
load-bearing rather than advisory (the same move racelint made for
status writes with its undeclared-transition rule): a direct write to a
structural plan field anywhere else in the tree is a finding.

==========================  ================================================
rule                        rationale
==========================  ================================================
uncertified-plan-write      ``node.input = x`` / ``join.join_type = ...`` /
                            ``writer.output_partitions = n`` outside
                            rewrite.py mutates a plan with NO certificate:
                            no schema-equivalence proof, no bucket-compat
                            proof, no vocabulary gate. Adaptive execution
                            built on ad-hoc attribute surgery is exactly
                            the silent-wrong-answer source the AQE
                            literature documents (PAPERS.md). Constructors
                            (``self.field = ...`` inside ``__init__`` /
                            ``__post_init__``) are the sanctioned way to
                            BUILD plans; ``exec.base.replace_children`` is
                            the one sanctioned child-rebind primitive.
uncertified-stage-write     ``stage.plan = x`` where the receiver is a
                            ``QueryStage``: swapping a stage's pristine
                            template bypasses the scheduler's certificate
                            gate (SchedulerServer.apply_certified_rewrite
                            is the sanctioned swap point).
==========================  ================================================

Suppression: ``# eqlint: disable=<rule>`` on the offending line or the
enclosing ``def`` line; :func:`suppression_count` counts them (the port's
tree has none), and the shared ledger over all the lints
(``analysis/budget.py``) holds the count to its budget.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

RULES: dict[str, str] = {
    "uncertified-plan-write": "direct write to a structural ExecutionPlan "
    "field outside rewrite.py / sanctioned constructors",
    "uncertified-stage-write": "direct swap of a QueryStage's plan "
    "template outside the certified rewrite path",
}

_SUPPRESS_RE = re.compile(r"#\s*eqlint:\s*disable=([A-Za-z0-9_,\- ]+)")

# Child slots + structure-defining fields of the physical-plan node
# vocabulary (exec/, executor/shuffle.py, distributed_plan.py). Writing
# any of these changes what a plan COMPUTES — exactly what a rewrite
# certificate exists to prove safe. Deliberately excludes runtime-state
# fields (metrics, caches, learned flags): mutating those changes cost,
# not semantics.
CHILD_SLOTS = frozenset({"input", "left", "right", "inputs"})
STRUCT_FIELDS = frozenset(
    {
        "on",
        "join_type",
        "partition_mode",
        "partition_keys",
        "output_partitions",
        "predicate",
        "exprs",
        "sort_exprs",
        "agg_exprs",
        "group_exprs",
        "window_exprs",
        "output_partition_count",
        "input_partition_count",
    }
)

# Files where structural writes are the sanctioned mechanism itself.
SANCTIONED_FILES = frozenset({"rewrite.py"})
# (file basename, function) pairs sanctioned individually: the single
# child-rebind primitive every copy-on-write path routes through.
SANCTIONED_FUNCTIONS = frozenset({("base.py", "replace_children")})

# Default lint surface: every module that builds, splits, serializes, or
# executes physical plans, the mesh tier's ``parallel/`` among them; a
# directory that is absent is skipped.
TARGET_DIRS = ("exec", "executor", "scheduler", "client", "obs", "parallel")
TARGET_FILES = (
    "distributed_plan.py",
    "serde.py",
    "standalone.py",
    "cli.py",
    "plugin.py",
)


@dataclasses.dataclass(frozen=True)
class EqDiagnostic:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]


def target_files(paths=None) -> list[pathlib.Path]:
    if paths is not None:
        return [pathlib.Path(p) for p in paths]
    root = _package_root()
    out: list[pathlib.Path] = []
    for d in TARGET_DIRS:
        out.extend(sorted((root / d).glob("*.py")))
    for f in TARGET_FILES:
        p = root / f
        if p.exists():
            out.append(p)
    return out


def _suppressed(lines: list[str], fn_line: int | None, line: int) -> frozenset:
    out: set[str] = set()
    for ln in (fn_line, line):
        if ln is None or ln < 1 or ln > len(lines):
            continue
        m = _SUPPRESS_RE.search(lines[ln - 1])
        if m:
            out |= {t.strip() for t in m.group(1).split(",")}
    return frozenset(out)


class _FnCtx:
    """Per-function context: name, whether it is a constructor, and the
    local names assigned from QueryStage(...) constructions (the
    uncertified-stage-write receiver inference)."""

    def __init__(self, name: str, line: int):
        self.name = name
        self.line = line
        self.stage_locals: set[str] = set()


def _is_stage_receiver(value: ast.AST, ctx: _FnCtx | None) -> bool:
    """Receiver inference for ``<x>.plan = ...``: a Name locally bound to
    ``QueryStage(...)``, a subscript of something spelled ``.stages``
    (``job.stages[sid]``), or a call/attr chain ending in ``.stages``."""
    if isinstance(value, ast.Name):
        return ctx is not None and value.id in ctx.stage_locals
    if isinstance(value, ast.Subscript):
        v = value.value
        return isinstance(v, ast.Attribute) and v.attr == "stages"
    return False


def lint_source(
    source: str, filename: str = "<memory>"
) -> list[EqDiagnostic]:
    basename = pathlib.PurePath(filename).name
    if basename in SANCTIONED_FILES:
        return []
    tree = ast.parse(source, filename=filename)
    lines = source.splitlines()
    diags: list[EqDiagnostic] = []

    def emit(node: ast.AST, rule: str, msg: str, fn: _FnCtx | None) -> None:
        sup = _suppressed(lines, fn.line if fn else None, node.lineno)
        if rule in sup or "all" in sup:
            return
        diags.append(EqDiagnostic(filename, node.lineno, rule, msg))

    def check_target(target: ast.AST, node: ast.AST, fn: _FnCtx | None):
        if isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                check_target(t, node, fn)
            return
        if not isinstance(target, ast.Attribute):
            return
        attr = target.attr
        recv = target.value
        in_ctor = (
            fn is not None
            and fn.name in ("__init__", "__post_init__")
            and isinstance(recv, ast.Name)
            and recv.id == "self"
        )
        sanctioned = fn is not None and (
            (basename, fn.name) in SANCTIONED_FUNCTIONS
        )
        if attr in CHILD_SLOTS or attr in STRUCT_FIELDS:
            if in_ctor or sanctioned:
                return
            emit(
                node,
                "uncertified-plan-write",
                f"direct write to structural plan field .{attr} — route "
                "through ballista_tpu_torch.rewrite (certified rewrite ops) or "
                "construct a new node",
                fn,
            )
        elif attr == "plan" and _is_stage_receiver(recv, fn):
            if sanctioned:
                return
            emit(
                node,
                "uncertified-stage-write",
                "direct swap of a QueryStage plan template — the "
                "scheduler's certified-rewrite acceptance path "
                "(apply_certified_rewrite) is the sanctioned swap point",
                fn,
            )

    def walk(node: ast.AST, fn: _FnCtx | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = _FnCtx(node.name, node.lineno)
        elif isinstance(node, ast.Assign):
            # stage-receiver inference: x = QueryStage(...) or
            # x = <y>.stages[...] (the scheduler's template lookup idiom)
            if fn is not None and (
                (
                    isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id == "QueryStage"
                )
                # covers x = <y>.stages[...] (the Subscript branch of
                # the receiver inference) and stage-local aliasing
                or _is_stage_receiver(node.value, fn)
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        fn.stage_locals.add(t.id)
            for t in node.targets:
                check_target(t, node, fn)
        elif isinstance(node, ast.AugAssign):
            check_target(node.target, node, fn)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            check_target(node.target, node, fn)
        for child in ast.iter_child_nodes(node):
            walk(child, fn)

    walk(tree, None)
    return diags


def lint_paths(paths=None) -> list[EqDiagnostic]:
    out: list[EqDiagnostic] = []
    root = _package_root().parent
    for f in target_files(paths):
        rel = str(f.relative_to(root)) if f.is_relative_to(root) else str(f)
        out.extend(lint_source(f.read_text(), rel))
    return out


def suppression_count(paths=None) -> int:
    n = 0
    for f in target_files(paths):
        n += len(_SUPPRESS_RE.findall(f.read_text()))
    return n
