"""detlint: determinism lint over the data plane and the plan pipeline
(the port's copy of ``ballista_tpu/analysis/detlint.py``). Its five rules
are the reference's. The one rule text that changes is the exemption of
``undeclared-rng``: the reference exempts ``jax.random`` for its explicit
keys, the port exempts a draw that takes an explicit seeded
``torch.Generator``.

Bit-exactness under fault injection — the invariant the replay witness
(analysis/replay.py) checks at runtime — dies by a thousand innocuous
cuts: a ``set`` iteration whose order leaks into plan construction, an
unseeded RNG in partition routing, a float reduction folded in task-
completion order. This lint flags those patterns statically, over
``ops/``, ``exec/``, ``executor/``, ``scheduler/``, and
``compilecache/``:

=====================  ====================================================
rule                   rationale
=====================  ====================================================
unordered-iteration    Iterating a ``set``/``frozenset`` (literal,
                       comprehension, constructor call, set-typed local or
                       ``self`` attribute, or a call whose annotation
                       returns ``set``) in an ORDER-SENSITIVE position
                       (``for``, comprehensions, ``list``/``tuple``/
                       ``enumerate``/``join``): Python set order varies
                       with PYTHONHASHSEED and insertion history, so
                       anything built from the walk — plan children, serde
                       output, partition routing — varies run to run.
                       Wrap in ``sorted(...)`` or declare the
                       nondeterminism.
undeclared-rng         ``random.*`` / ``np.random.*`` without a declared
                       seed or an explicit nondeterminism declaration.
                       Control-plane placement choices (the scheduler's
                       random stage pick) are legitimately nondeterministic
                       — they must SAY so with ``# detlint: nondet=<why>``
                       so the data plane stays provably seeded. The
                       port also flags torch's draws from its global
                       generator (``torch.rand``, ``torch.randint``,
                       ``torch.randperm``, ... and ``torch.random.*``); a
                       draw that takes an explicit ``generator=`` (a
                       seeded ``torch.Generator``) is exempt, as it is
                       deterministic by construction.
wallclock-in-dataplane ``time.time()`` inside ``ops/``/``exec/``/
                       ``compilecache/``: a wall-clock read in a kernel or
                       operator is either dead code or a value that varies
                       per run. Metrics timers use ``perf_counter`` via
                       ``Metrics.time`` and are exempt by construction.
reduction-order        Augmented accumulation (``acc += ...``) inside a
                       loop over ``as_completed(...)`` or
                       ``imap_unordered(...)``: float addition is not
                       associative, so a partial-aggregate merge folded in
                       completion order differs run to run in the last
                       ULP — the chaos suites' bit-exact assertions are
                       exactly what this breaks.
completion-order       ``yield``/``.append(...)``/``.extend(...)`` inside
                       a completion-ordered loop: result order then
                       depends on thread scheduling (the overlapped-fetch
                       merge hazard — the shipped reader consumes
                       per-location queues in LOCATION order for exactly
                       this reason, docs/shuffle.md).
=====================  ====================================================

Declared nondeterminism: ``# detlint: nondet=<why>`` on the line or the
enclosing ``def`` line declares a site deliberately nondeterministic
(control-plane placement, id minting); :func:`nondet_sites` enumerates
them and the tier-1 suite pins the list. Suppression:
``# detlint: disable=<rule>`` with the shared budget ledger
(analysis/budget.py)."""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

RULES: dict[str, str] = {
    "unordered-iteration": "set iteration in an order-sensitive position",
    "undeclared-rng": "random.* without a declared seed or nondet note",
    "wallclock-in-dataplane": "time.time() inside ops//exec//compilecache/",
    "reduction-order": "accumulation folded in task-completion order",
    "completion-order": "output order depends on thread completion order",
}

_SUPPRESS_RE = re.compile(r"#\s*detlint:\s*disable=([A-Za-z0-9_,\- ]+)")
_NONDET_RE = re.compile(r"#\s*detlint:\s*nondet=([A-Za-z0-9_\-]+)")

TARGET_DIRS = ("ops", "exec", "executor", "scheduler", "compilecache", "obs")
# wall-clock reads are only categorically wrong in the data plane proper;
# the control plane legitimately timestamps (heartbeats, TTLs, deadlines)
WALLCLOCK_DIRS = ("ops", "exec", "compilecache")

# torch's draws from its process-wide generator: the undeclared-rng rule
# covers them unless the call passes an explicit ``generator=``
_TORCH_DRAWS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.multinomial", "torch.bernoulli", "torch.normal", "torch.poisson",
})

_COMPLETION_ITERS = ("as_completed", "imap_unordered")
_ORDER_SENSITIVE_CALLS = frozenset({"list", "tuple", "enumerate"})


@dataclasses.dataclass(frozen=True)
class DetDiagnostic:
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
    return out


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ann_is_set(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "frozenset")
    if isinstance(ann, ast.Subscript):
        return _ann_is_set(ann.value)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip().startswith(("set", "frozenset"))
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, source: str, filename: str):
        self.filename = filename
        self.lines = source.splitlines()
        self.diags: list[DetDiagnostic] = []
        self.fn_stack: list[int] = []  # def line numbers
        self.set_locals_stack: list[set[str]] = [set()]
        # self.<attr> assigned a set construct in any method
        self.set_attrs: set[str] = set()
        # functions whose return annotation is set-typed
        self.set_returning: set[str] = set()
        self.completion_loop_depth = 0
        self.stmt_line = 0  # first line of the enclosing statement
        tree = ast.parse(source, filename=filename)
        # pre-pass: set-typed attributes + set-returning defs
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _ann_is_set(node.returns):
                    self.set_returning.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                value = node.value
                if value is not None and self._is_set_expr_shallow(value):
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            self.set_attrs.add(t.attr)
        self.visit(tree)

    # -- plumbing -------------------------------------------------------------
    def visit(self, node):
        if isinstance(node, ast.stmt):
            self.stmt_line = node.lineno
        return super().visit(node)

    def _marked(self, line: int, kinds=("disable", "nondet")) -> set[str]:
        # honored on the flagged line, the enclosing statement's first
        # line (multi-line calls), or the enclosing def line
        out: set[str] = set()
        for ln in [line, self.stmt_line] + self.fn_stack[-1:]:
            if ln < 1 or ln > len(self.lines):
                continue
            text = self.lines[ln - 1]
            if "disable" in kinds:
                m = _SUPPRESS_RE.search(text)
                if m:
                    out |= {t.strip() for t in m.group(1).split(",")}
            if "nondet" in kinds and _NONDET_RE.search(text):
                out.add("__nondet__")
        return out

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        marks = self._marked(node.lineno)
        if rule in marks or "all" in marks or "__nondet__" in marks:
            return
        self.diags.append(
            DetDiagnostic(self.filename, node.lineno, rule, msg)
        )

    # -- set-typed expression inference ---------------------------------------
    def _is_set_expr_shallow(self, node: ast.AST) -> bool:
        """Syntactically a set, without local-name context (pre-pass)."""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            if fname in ("set", "frozenset"):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "intersection",
                "union",
                "difference",
                "symmetric_difference",
            ):
                return True
        return False

    def _is_set_expr(self, node: ast.AST) -> bool:
        if self._is_set_expr_shallow(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.set_locals_stack[-1]
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr in self.set_attrs
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            if fname is not None and (
                fname.split(".")[-1] in self.set_returning
            ):
                return True
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub)
        ):
            return self._is_set_expr(node.left) or self._is_set_expr(
                node.right
            )
        return False

    # -- visitors -------------------------------------------------------------
    def visit_FunctionDef(self, node):
        self.fn_stack.append(node.lineno)
        self.set_locals_stack.append(set())
        self.generic_visit(node)
        self.set_locals_stack.pop()
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        if self._is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.set_locals_stack[-1].add(t.id)
        self.generic_visit(node)

    def _check_iter(self, iter_node: ast.AST, where: ast.AST) -> None:
        if self._is_set_expr(iter_node):
            self._emit(
                where,
                "unordered-iteration",
                "iteration over a set in an order-sensitive position — "
                "wrap in sorted(...) or declare with "
                "# detlint: nondet=<why>",
            )

    def _is_completion_iter(self, iter_node: ast.AST) -> bool:
        if not isinstance(iter_node, ast.Call):
            return False
        fname = _dotted(iter_node.func) or ""
        return fname.split(".")[-1] in _COMPLETION_ITERS

    def visit_For(self, node):
        self._check_iter(node.iter, node)
        completion = self._is_completion_iter(node.iter)
        if completion and self.completion_loop_depth == 0:
            # the scan walks the whole body, so a nested completion loop
            # is already covered — re-scanning it would double-emit
            self._scan_completion_body(node)
        if completion:
            self.completion_loop_depth += 1
        self.generic_visit(node)
        if completion:
            self.completion_loop_depth -= 1

    def _scan_completion_body(self, loop: ast.For) -> None:
        for sub in ast.walk(loop):
            if sub is loop:
                continue
            if isinstance(sub, ast.AugAssign) and isinstance(
                sub.op, (ast.Add, ast.Mult)
            ):
                self._emit(
                    sub,
                    "reduction-order",
                    "accumulation inside a completion-ordered loop: float "
                    "folds are not associative — collect then fold in a "
                    "canonical (submission-index) order",
                )
            elif isinstance(sub, (ast.Yield, ast.YieldFrom)):
                self._emit(
                    sub,
                    "completion-order",
                    "yield inside a completion-ordered loop: result order "
                    "depends on thread scheduling — re-order by "
                    "submission index before yielding",
                )
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("append", "extend")
            ):
                self._emit(
                    sub,
                    "completion-order",
                    "ordered-output build inside a completion-ordered "
                    "loop — index results by submission order instead",
                )

    def visit_comprehension_node(self, node):
        for gen in node.generators:
            # anchor the finding (and its marker lookup) at the iterable
            self._check_iter(gen.iter, gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_comprehension_node
    visit_GeneratorExp = visit_comprehension_node
    visit_DictComp = visit_comprehension_node

    def visit_Call(self, node):
        fname = _dotted(node.func) or ""
        base = fname.split(".")[-1]
        # list(<set>) / tuple(<set>) / enumerate(<set>) / s.join(<set>)
        if (
            fname in _ORDER_SENSITIVE_CALLS or base == "join"
        ) and node.args:
            if self._is_set_expr(node.args[0]):
                self._emit(
                    node,
                    "unordered-iteration",
                    f"{base}() over a set is order-sensitive — wrap in "
                    "sorted(...)",
                )
        # undeclared RNG (a draw with an explicit generator= is seeded)
        if (
            fname.startswith("random.") or ".random." in f".{fname}"
            or fname in _TORCH_DRAWS
        ) and not any(kw.arg == "generator" for kw in node.keywords):
            self._emit(
                node,
                "undeclared-rng",
                f"{fname}() without a declared seed — seed it, or declare "
                "with # detlint: nondet=<why> if this is deliberate "
                "control-plane nondeterminism",
            )
        if fname in ("time.time", "time.time_ns") and any(
            f"/{d}/" in self.filename.replace("\\", "/")
            or self.filename.replace("\\", "/").startswith(f"{d}/")
            for d in WALLCLOCK_DIRS
        ):
            self._emit(
                node,
                "wallclock-in-dataplane",
                "wall-clock read in the data plane — a per-run-varying "
                "value in a kernel/operator path (metrics timers use "
                "Metrics.time / perf_counter)",
            )
        self.generic_visit(node)


def lint_source(source: str, filename: str = "<memory>") -> list[DetDiagnostic]:
    return _Linter(source, filename).diags


def lint_paths(paths=None) -> list[DetDiagnostic]:
    out: list[DetDiagnostic] = []
    root = _package_root().parent
    for f in target_files(paths):
        rel = str(f.relative_to(root)) if f.is_relative_to(root) else str(f)
        out.extend(lint_source(f.read_text(), rel))
    return out


def nondet_sites(paths=None) -> list[tuple[str, int, str]]:
    """Every declared-nondeterminism site: (file, line, why). Enumerable
    so the tier-1 suite pins the list — a new deliberate nondeterminism
    must show up in a test diff, exactly like lifelint's ownership
    transfers."""
    out: list[tuple[str, int, str]] = []
    root = _package_root().parent
    for f in target_files(paths):
        rel = str(f.relative_to(root)) if f.is_relative_to(root) else str(f)
        for i, line in enumerate(f.read_text().splitlines(), 1):
            m = _NONDET_RE.search(line)
            if m:
                out.append((rel, i, m.group(1)))
    return out


def suppression_count(paths=None) -> int:
    n = 0
    for f in target_files(paths):
        n += len(_SUPPRESS_RE.findall(f.read_text()))
    return n
