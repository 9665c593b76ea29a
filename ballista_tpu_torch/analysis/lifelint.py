"""lifelint: resource-lifecycle & error-taxonomy static analysis (the
port's copy of ``ballista_tpu/analysis/lifelint.py``, with its rules, over
the port's tree and its ``errors.py`` taxonomy).

Ballista's reliability story rests on executors that persist shuffle
state, serve it over Flight, and get killed/restarted at will — which
only works if every channel, thread pool, file, mmap and spill set has a
provable owner, and every error that crosses the task boundary is
classified correctly (``errors.error_is_retryable`` decides whether a
failed task burns a bounded retry or the whole job). planlint proves
plans and racelint proves locks; lifelint is the same
verify-before-run posture for *lifecycle* and *error propagation* — the
discipline Rust's ownership/borrow checker gives the reference
implementation for free.

Rule families (AST-based, import-free over the source tree):

==================== ========================================================
rule                 rationale
==================== ========================================================
leaked-resource      A resource acquisition (gRPC channel, Flight client,
                     thread/pool, open file, ``pa.memory_map``, IPC writer,
                     SpillManager, gRPC server) with no provable owner: not
                     ``with``-managed, never released, and never handed off
                     (returned/yielded, stored into an owning class with a
                     releasing method, stored into a container, or passed to
                     a class that releases it). Class-held resources
                     (``self.x = ctor()``) require a method of that class to
                     release ``self.x`` (directly or through a local alias).
leak-on-error        The release exists but only on the straight-line path:
                     an exception (or, in a generator, consumer abandonment
                     — ``GeneratorExit`` — while suspended at a ``yield``)
                     skips it. Releases must sit in a ``finally`` (or the
                     acquisition in a ``with``) whenever anything between
                     acquire and release can raise.
unclassified-raise   A ``raise`` in the task-boundary surfaces (executor/,
                     exec/, client/, scheduler/) of an exception type that
                     maps into neither ``errors.NON_RETRYABLE_ERROR_TYPES``
                     nor ``errors.RETRYABLE_ERROR_TYPES``. Task errors cross
                     the wire as "TypeName: message" strings; an unlisted
                     type silently defaults to *retryable*, so a
                     deterministic failure would burn every bounded attempt
                     before failing the job.
swallowed-error      A bare ``except:`` — or an ``except Exception/
                     BaseException:`` handler that neither re-raises nor
                     logs — silently discards a failure. Exempt: the
                     close-suppression idiom (a ``try`` body consisting only
                     of release calls, where failure to close is the
                     expected case being suppressed).
untyped-injection    A handler catching a fault-injection type
                     (``Injected*``) that does not re-raise: chaos faults
                     must surface through the SAME typed error paths real
                     faults take, or the chaos suite proves nothing about
                     production error flow.
==================== ========================================================

Ownership-transfer annotation: append ``# lifelint: transfer`` to an
acquisition line whose ownership moves somewhere the analysis cannot see
(e.g. a fire-and-forget worker bounded by a semaphore, or the
executor-injected ``TaskContext.shuffle_locations`` hand-off). Transfers
are declared design facts, not suppressions, and are listed by
``transfer_sites()`` — but keep them rare and commented.

Suppression: append ``# lifelint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the offending line or the enclosing ``def`` line.
The tier-1 suite budgets suppressions at ≤ 5 tree-wide (shared across
rule families, like racelint's).

Scope/limitations (deliberate): acquisition tracking is function-local
with one level of alias (``y = x``) and factory propagation (a function
whose returns are all fresh resources is itself an acquisition site);
resources passed to arbitrary calls are treated as *shared*, not
transferred — only constructors of locally-defined classes that provably
release the stored attribute count as transfer sinks. Locks are covered
by racelint/witness, not here; bounded queues and per-location fetch
queues are covered by the runtime witness
(:mod:`ballista_tpu_torch.analysis.reswitness`), which this module's static
rules complement.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

RULES: dict[str, str] = {
    "leaked-resource": "resource acquisition (channel/client/pool/thread/"
    "file/mmap/spill) with no provable owner: never released and never "
    "handed off to something that releases it",
    "leak-on-error": "release only on the straight-line path — an "
    "exception edge (or generator cancellation at a yield) skips it; "
    "use with/finally",
    "unclassified-raise": "raised exception type missing from the "
    "errors.py retryable/non-retryable taxonomy — it would silently "
    "default to retryable at the task boundary",
    "swallowed-error": "bare except (or except Exception) that neither "
    "re-raises nor logs — failures vanish",
    "untyped-injection": "fault-injection handler (Injected*) that does "
    "not re-raise typed — chaos faults must take the production error "
    "path",
}

_SUPPRESS_RE = re.compile(r"#\s*lifelint:\s*disable=([A-Za-z0-9_,\- ]+)")
_TRANSFER_RE = re.compile(r"#\s*lifelint:\s*transfer\b(?:=(\S+))?")

# resource constructors: dotted call name -> (kind, release-method names)
_RESOURCE_CTORS: dict[str, tuple[str, tuple[str, ...]]] = {
    "grpc.insecure_channel": ("grpc-channel", ("close",)),
    "_grpc.insecure_channel": ("grpc-channel", ("close",)),
    "grpc.secure_channel": ("grpc-channel", ("close",)),
    "grpc.server": ("grpc-server", ("stop",)),
    "paflight.connect": ("flight-client", ("close",)),
    "flight.connect": ("flight-client", ("close",)),
    "paflight.FlightClient": ("flight-client", ("close",)),
    "ThreadPoolExecutor": ("thread-pool", ("shutdown",)),
    "futures.ThreadPoolExecutor": ("thread-pool", ("shutdown",)),
    "concurrent.futures.ThreadPoolExecutor": ("thread-pool", ("shutdown",)),
    "threading.Thread": ("thread", ("join",)),
    "open": ("file", ("close",)),
    "pa.OSFile": ("file", ("close",)),
    "pa.memory_map": ("mmap", ("close",)),
    "paipc.new_file": ("ipc-writer", ("close",)),
    "pa.ipc.new_file": ("ipc-writer", ("close",)),
    "paipc.open_file": ("ipc-reader", ("close",)),
    "pa.ipc.open_file": ("ipc-reader", ("close",)),
    "SpillManager": ("spill-manager", ("close",)),
}

# any of these discharges the obligation for its kind (a close method may
# legitimately be named stop/shutdown/join on wrappers)
_RELEASE_METHODS = frozenset(
    {"close", "shutdown", "join", "stop", "cancel", "terminate", "release"}
)

# calls that take OWNERSHIP of an argument resource (the wrapper releases
# the inner resource with itself, or manages it as a context). NOTE
# pyarrow's ``ipc.open_file``/``open_stream`` are deliberately NOT here:
# the returned reader has no ``close()`` and its ``with`` is a no-op — it
# never closes the source file/mmap you hand it (the reader.py mmap leak shape).
_TRANSFER_SINKS = frozenset(
    {
        "contextlib.closing",
        "closing",
        "enter_context",  # ExitStack
        "grpc.server",  # the server drives its worker pool's lifetime
    }
)

# container-mutator method names: `xs.append(res)` stores the resource in
# an owned collection — ownership moved to the container's owner
_CONTAINER_MUTATORS = frozenset(
    {"append", "add", "insert", "extend", "put", "put_nowait",
     "setdefault", "register", "appendleft"}
)

_EXC_BASES = frozenset({"Exception", "BaseException"})


@dataclasses.dataclass(frozen=True)
class LifeDiagnostic:
    file: str
    line: int
    rule: str
    message: str
    function: str = ""

    def __str__(self) -> str:
        where = f" [{self.function}]" if self.function else ""
        return f"{self.file}:{self.line}: {self.rule}{where}: {self.message}"


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(name: str | None) -> str:
    return (name or "").split(".")[-1]


def _ctor_kind(call: ast.Call) -> tuple[str, tuple[str, ...]] | None:
    d = _dotted(call.func)
    if d is None:
        return None
    hit = _RESOURCE_CTORS.get(d)
    if hit is None:
        # unqualified class name fallback (from-imports): match terminal
        hit = _RESOURCE_CTORS.get(_terminal(d)) if "." in d else None
    return hit


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ClassInfo:
    name: str
    file: str
    node: ast.ClassDef
    methods: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict
    )
    # attr -> (kind, line) for self.attr = <resource ctor>
    resource_attrs: dict[str, tuple[str, int]] = dataclasses.field(
        default_factory=dict
    )
    # attrs with release evidence (self.attr.close() or alias release)
    released_attrs: set[str] = dataclasses.field(default_factory=set)
    # __init__ params stored to self attrs: param name -> attr
    init_stores: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _ModuleInfo:
    name: str
    file: str
    tree: ast.Module
    lines: list[str]
    classes: dict[str, _ClassInfo] = dataclasses.field(default_factory=dict)
    functions: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict
    )


def _collect_module(source: str, filename: str) -> _ModuleInfo:
    tree = ast.parse(source, filename=filename)
    mi = _ModuleInfo(
        pathlib.Path(filename).stem, filename, tree, source.splitlines()
    )
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            mi.functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(node.name, filename, node)
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    ci.methods[item.name] = item
            mi.classes[ci.name] = ci
    return mi


def _suppressed(mi: _ModuleInfo, fn_line: int, line: int) -> frozenset:
    out: set[str] = set()
    for ln in (line, fn_line):
        if 0 < ln <= len(mi.lines):
            m = _SUPPRESS_RE.search(mi.lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(","))
    return frozenset(out)


def _transfer_note(mi: _ModuleInfo, line: int) -> str | None:
    """The ``# lifelint: transfer[=note]`` annotation on ``line``, if any
    (a declared ownership hand-off, not a suppression)."""
    if 0 < line <= len(mi.lines):
        m = _TRANSFER_RE.search(mi.lines[line - 1])
        if m:
            return m.group(1) or "declared"
    return None


# --------------------------------------------------------------------------
# resource-lifecycle analysis
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Acq:
    """One tracked acquisition inside a function."""

    kind: str
    releases: tuple[str, ...]
    line: int
    node: ast.Call | None = None
    var: str | None = None  # local name when assigned to one
    self_attr: str | None = None  # self.<attr> when stored directly
    with_managed: bool = False
    discharged: bool = False  # escaped to an owner
    release_lines: list[tuple[int, bool]] = dataclasses.field(
        default_factory=list
    )  # (line, in_finally)


class _Analysis:
    def __init__(self, modules: list[_ModuleInfo]):
        self.modules = modules
        self.classes: dict[str, _ClassInfo] = {}
        for m in modules:
            for c in m.classes.values():
                self.classes.setdefault(c.name, c)
        self._collect_class_facts()
        # factory fixpoint: functions/methods whose returns are all fresh
        # resources become acquisition sites themselves
        self.factories: dict[str, tuple[str, tuple[str, ...]]] = {}
        for _round in range(2):
            for mi in self.modules:
                for fn in mi.functions.values():
                    self._maybe_factory(fn)
                for ci in mi.classes.values():
                    for meth in ci.methods.values():
                        self._maybe_factory(meth)
        # sink classes: ctor takes ownership of resource args because the
        # class releases what it stores
        self.sink_classes: set[str] = set()
        for ci in self.classes.values():
            if ci.released_attrs or any(
                m in ci.methods for m in ("close", "stop", "shutdown",
                                          "__exit__")
            ):
                self.sink_classes.add(ci.name)

    # -- class facts --------------------------------------------------------
    def _collect_class_facts(self) -> None:
        for mi in self.modules:
            for ci in mi.classes.values():
                init = ci.methods.get("__init__")
                if init is not None:
                    params = {
                        a.arg for a in init.args.args + init.args.kwonlyargs
                    }
                    for sub in ast.walk(init):
                        if (
                            isinstance(sub, ast.Assign)
                            and len(sub.targets) == 1
                            and isinstance(sub.targets[0], ast.Attribute)
                            and isinstance(sub.targets[0].value, ast.Name)
                            and sub.targets[0].value.id == "self"
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id in params
                        ):
                            ci.init_stores[sub.value.id] = (
                                sub.targets[0].attr
                            )
                for meth in ci.methods.values():
                    self._release_evidence(meth, ci)

    def _release_evidence(self, meth: ast.FunctionDef, ci: _ClassInfo):
        """Record self-attrs this method provably releases: direct
        ``self.x.close()`` or via a local alias (incl. tuple swaps like
        ``pool, self._pool = self._pool, None``)."""
        aliases: dict[str, str] = {}
        for sub in ast.walk(meth):
            if isinstance(sub, ast.Assign):
                tgts, vals = sub.targets, [sub.value]
                if (
                    len(tgts) == 1
                    and isinstance(tgts[0], ast.Tuple)
                    and isinstance(sub.value, ast.Tuple)
                    and len(tgts[0].elts) == len(sub.value.elts)
                ):
                    tgts, vals = tgts[0].elts, sub.value.elts
                elif len(tgts) == 1:
                    tgts = [tgts[0]]
                for t, v in zip(tgts, vals * len(tgts) if len(vals) == 1
                                else vals):
                    if (
                        isinstance(t, ast.Name)
                        and isinstance(v, ast.Attribute)
                        and isinstance(v.value, ast.Name)
                        and v.value.id == "self"
                    ):
                        aliases[t.id] = v.attr
            elif isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ):
                if sub.func.attr not in _RELEASE_METHODS:
                    continue
                recv = sub.func.value
                if (
                    isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"
                ):
                    ci.released_attrs.add(recv.attr)
                elif isinstance(recv, ast.Name) and recv.id in aliases:
                    ci.released_attrs.add(aliases[recv.id])
        # `for t in self._threads: t.join()` — loop-variable alias
        for sub in ast.walk(meth):
            if (
                isinstance(sub, ast.For)
                and isinstance(sub.target, ast.Name)
                and isinstance(sub.iter, ast.Attribute)
                and isinstance(sub.iter.value, ast.Name)
                and sub.iter.value.id == "self"
            ):
                var, attr = sub.target.id, sub.iter.attr
                for inner in ast.walk(sub):
                    if (
                        isinstance(inner, ast.Call)
                        and isinstance(inner.func, ast.Attribute)
                        and inner.func.attr in _RELEASE_METHODS
                        and isinstance(inner.func.value, ast.Name)
                        and inner.func.value.id == var
                    ):
                        ci.released_attrs.add(attr)

    # -- factory detection --------------------------------------------------
    def _returned_resource(
        self, expr: ast.AST
    ) -> tuple[str, tuple[str, ...]] | None:
        if not isinstance(expr, ast.Call):
            return None
        hit = _ctor_kind(expr)
        if hit is not None:
            return hit
        d = _terminal(_dotted(expr.func))
        return self.factories.get(d)

    def _maybe_factory(self, fn: ast.FunctionDef) -> None:
        returns = [
            n for n in ast.walk(fn)
            if isinstance(n, ast.Return) and n.value is not None
        ]
        if not returns:
            return
        kinds = [self._returned_resource(r.value) for r in returns]
        if all(k is not None for k in kinds) and kinds:
            self.factories[fn.name] = kinds[0]


def _nested_defs(fn: ast.FunctionDef) -> set[ast.AST]:
    """All nodes belonging to nested function/lambda bodies (excluded from
    the enclosing function's walk; nested defs are checked separately)."""
    out: set[ast.AST] = set()
    for node in ast.walk(fn):
        if node is fn:
            continue
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            for sub in ast.walk(node):
                if sub is not node:
                    out.add(sub)
    return out


def _finally_nodes(fn: ast.FunctionDef) -> set[ast.AST]:
    out: set[ast.AST] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    out.add(sub)
    return out


def _check_resources(
    fn: ast.FunctionDef,
    mi: _ModuleInfo,
    ci: _ClassInfo | None,
    analysis: _Analysis,
    diags: list[LifeDiagnostic],
    class_obligations: list[tuple[_ClassInfo, str, str, int, _ModuleInfo]],
) -> None:
    nested = _nested_defs(fn)
    in_finally = _finally_nodes(fn)
    parent: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(fn):
        if node in nested:
            continue
        for child in ast.iter_child_nodes(node):
            parent[child] = node

    def ctor_hit(call: ast.Call):
        hit = _ctor_kind(call)
        if hit is not None:
            return hit
        return analysis.factories.get(_terminal(_dotted(call.func)))

    # --- pass 1: acquisitions ---------------------------------------------
    acqs: list[_Acq] = []
    by_var: dict[str, _Acq] = {}
    for node in ast.walk(fn):
        if node in nested or not isinstance(node, ast.Call):
            continue
        hit = ctor_hit(node)
        if hit is None:
            continue
        kind, rels = hit
        p = parent.get(node)
        acq = _Acq(kind, rels, node.lineno, node)
        if isinstance(p, ast.withitem):
            acq.with_managed = True
        elif isinstance(p, ast.Call):
            # argument to another call: transfer sink or sink class?
            d = _dotted(p.func)
            t = _terminal(d)
            if (d in _TRANSFER_SINKS or t in _TRANSFER_SINKS
                    or t in analysis.sink_classes):
                acq.discharged = True
            # else: anonymous resource consumed by an arbitrary call —
            # nobody can release it; falls through as a leak
        elif isinstance(p, (ast.Return, ast.Yield, ast.YieldFrom)):
            acq.discharged = True  # caller/consumer owns it
        elif isinstance(p, ast.Assign) and len(p.targets) == 1:
            t = p.targets[0]
            if isinstance(t, ast.Name):
                acq.var = t.id
                by_var[t.id] = acq
            elif (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                acq.self_attr = t.attr
            else:
                acq.discharged = True  # container/subscript store
        elif isinstance(p, ast.Attribute):
            # `ctor().start()` — the instance is dropped on the spot
            pass
        elif isinstance(p, (ast.Tuple, ast.List)):
            acq.discharged = True  # collected into a structure
        acqs.append(acq)

    # --- pass 2: releases / escapes / aliases for tracked locals ----------
    aliases: dict[str, _Acq] = {}
    yields: list[int] = []
    for node in ast.walk(fn):
        if node in nested:
            continue
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            yields.append(node.lineno)
        if isinstance(node, ast.Assign):
            tgts, vals = node.targets, [node.value]
            if (
                len(tgts) == 1
                and isinstance(tgts[0], ast.Tuple)
                and isinstance(node.value, ast.Tuple)
                and len(tgts[0].elts) == len(node.value.elts)
            ):
                tgts, vals = tgts[0].elts, node.value.elts
            for t, v in zip(tgts, vals if len(vals) == len(tgts)
                            else vals * len(tgts)):
                src = None
                if isinstance(v, ast.Name):
                    src = by_var.get(v.id) or aliases.get(v.id)
                if src is None:
                    continue
                if isinstance(t, ast.Name):
                    aliases[t.id] = src
                elif (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    # self.<attr> = x : ownership moves to the instance
                    src.discharged = True
                    src.self_attr = t.attr
                else:
                    src.discharged = True  # container store
        elif isinstance(node, ast.Return) and isinstance(
            node.value, (ast.Name, ast.Tuple)
        ):
            names = (
                [node.value]
                if isinstance(node.value, ast.Name)
                else [e for e in node.value.elts if isinstance(e, ast.Name)]
            )
            for nm in names:
                src = by_var.get(nm.id) or aliases.get(nm.id)
                if src is not None:
                    src.discharged = True
        elif isinstance(node, (ast.Yield, ast.YieldFrom)):
            v = node.value
            if isinstance(v, ast.Name):
                src = by_var.get(v.id) or aliases.get(v.id)
                if src is not None:
                    src.discharged = True
        elif isinstance(node, ast.Call):
            d = _dotted(node.func)
            t = _terminal(d)
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                # release on the resource itself (or an alias)
                if isinstance(recv, ast.Name):
                    src = by_var.get(recv.id) or aliases.get(recv.id)
                    if src is not None and node.func.attr in set(
                        src.releases
                    ) | set(_RELEASE_METHODS):
                        src.release_lines.append(
                            (node.lineno, node in in_finally)
                        )
                # container mutator absorbing the resource as an argument
                if node.func.attr in _CONTAINER_MUTATORS:
                    for a in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        for nm in ast.walk(a):
                            if isinstance(nm, ast.Name):
                                src = by_var.get(nm.id) or aliases.get(nm.id)
                                if src is not None:
                                    src.discharged = True
            # resource passed to a transfer sink / sink class
            if (d in _TRANSFER_SINKS or t in _TRANSFER_SINKS
                    or t in analysis.sink_classes):
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    if isinstance(a, ast.Name):
                        src = by_var.get(a.id) or aliases.get(a.id)
                        if src is not None:
                            src.discharged = True

    # IPC readers over an explicitly-owned source are VIEWS: pyarrow's
    # reader has no close(); the obligation lives (and is checked) on the
    # source file/mmap it reads. Only a reader over an INTERNAL fd (a
    # plain path string) carries its own obligation.
    for acq in acqs:
        if acq.kind != "ipc-reader" or acq.node is None:
            continue
        for a in list(acq.node.args) + [
            kw.value for kw in acq.node.keywords
        ]:
            if isinstance(a, ast.Name) and (
                a.id in by_var or a.id in aliases
            ):
                acq.discharged = True
            elif isinstance(a, ast.Call) and ctor_hit(a) is not None:
                # open_file(memory_map(p)): the source is anonymous and
                # flagged on its own — don't double-report the view
                acq.discharged = True

    # --- verdicts ----------------------------------------------------------
    def emit(line: int, rule: str, msg: str) -> None:
        sup = _suppressed(mi, fn.lineno, line)
        if rule in sup or "all" in sup:
            return
        if _transfer_note(mi, line) is not None:
            return  # declared ownership hand-off
        diags.append(LifeDiagnostic(mi.file, line, rule, msg, fn.name))

    is_ctx_method = ci is not None and fn.name in (
        "__exit__", "__del__", "close", "stop", "shutdown", "__enter__"
    )
    for acq in acqs:
        if acq.with_managed or acq.discharged:
            continue
        if acq.self_attr is not None:
            if ci is not None:
                class_obligations.append(
                    (ci, acq.self_attr, acq.kind, acq.line, mi)
                )
            continue
        if not acq.release_lines:
            emit(
                acq.line, "leaked-resource",
                f"{acq.kind} acquired here is never released "
                f"({'/'.join(acq.releases)}) and never handed off",
            )
            continue
        if any(in_f for _ln, in_f in acq.release_lines):
            continue  # a finally-guarded release reaches every edge
        if is_ctx_method:
            continue  # release methods run on already-owned state
        first_release = min(ln for ln, _f in acq.release_lines)
        held_yields = [y for y in yields if acq.line < y < first_release]
        if held_yields:
            emit(
                acq.line, "leak-on-error",
                f"{acq.kind} held across yield (line {held_yields[0]}) "
                "with release outside finally — consumer abandonment "
                "(GeneratorExit) leaks it",
            )
            continue
        # anything that can raise between acquire and release skips it
        risky = _risky_between(fn, nested, acq, first_release, by_var,
                               aliases)
        if risky is not None:
            emit(
                acq.line, "leak-on-error",
                f"{acq.kind} release at line {first_release} is not in a "
                f"finally, but line {risky} between acquire and release "
                "can raise past it",
            )


def _risky_between(
    fn: ast.FunctionDef,
    nested: set[ast.AST],
    acq: _Acq,
    first_release: int,
    by_var: dict[str, _Acq],
    aliases: dict[str, _Acq],
) -> int | None:
    """Line of a call between acquire and release that may raise, or None.
    Calls on the resource itself (or its aliases) are exempt — failures of
    the resource's own methods are the release idiom's concern, and e.g.
    ``q.put``/``pool.submit`` sequences between create and close would
    otherwise always trip the rule."""
    for node in ast.walk(fn):
        if node in nested or not isinstance(node, ast.Call):
            continue
        if not (acq.line < node.lineno < first_release):
            continue
        if isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Name
        ):
            src = by_var.get(node.func.value.id) or aliases.get(
                node.func.value.id
            )
            if src is acq:
                continue
        return node.lineno
    return None


def _check_class_obligations(
    obligations: list[tuple[_ClassInfo, str, str, int, _ModuleInfo]],
    diags: list[LifeDiagnostic],
) -> None:
    for ci, attr, kind, line, mi in obligations:
        if attr in ci.released_attrs:
            continue
        sup = _suppressed(mi, line, line)
        if "leaked-resource" in sup or "all" in sup:
            continue
        if _transfer_note(mi, line) is not None:
            continue
        diags.append(
            LifeDiagnostic(
                mi.file, line, "leaked-resource",
                f"self.{attr} holds a {kind} but no method of "
                f"{ci.name} releases it",
            )
        )


# --------------------------------------------------------------------------
# error-taxonomy analysis
# --------------------------------------------------------------------------


def _classified_types() -> frozenset[str]:
    from ballista_tpu_torch.errors import (
        NON_RETRYABLE_ERROR_TYPES,
        RETRYABLE_ERROR_TYPES,
    )

    return frozenset(NON_RETRYABLE_ERROR_TYPES) | frozenset(
        RETRYABLE_ERROR_TYPES
    )


# process-exit / control-flow types that never cross the task boundary as
# a task error string
_TAXONOMY_EXEMPT = frozenset(
    {"SystemExit", "KeyboardInterrupt", "GeneratorExit", "StopIteration"}
)


def _exc_factories(modules: list[_ModuleInfo]) -> dict[str, str]:
    """Functions/methods whose every return is a constructor call of a
    classified exception type: ``raise _escalate(...)`` then classifies as
    what the factory returns."""
    classified = _classified_types()
    out: dict[str, str] = {}
    for _round in range(2):
        for mi in modules:
            fns: list[ast.FunctionDef] = list(mi.functions.values())
            for ci in mi.classes.values():
                fns.extend(ci.methods.values())
            for fn in fns:
                returns = [
                    n for n in ast.walk(fn)
                    if isinstance(n, ast.Return) and n.value is not None
                ]
                if not returns:
                    continue
                names = []
                for r in returns:
                    if not isinstance(r.value, ast.Call):
                        names = []
                        break
                    t = _terminal(_dotted(r.value.func))
                    if t in classified:
                        names.append(t)
                    elif t in out:
                        names.append(out[t])
                    else:
                        names = []
                        break
                if names:
                    out[fn.name] = names[0]
    return out


def _check_taxonomy(
    mi: _ModuleInfo,
    factories: dict[str, str],
    classified: frozenset[str],
    diags: list[LifeDiagnostic],
) -> None:
    if mi.name == "__main__":
        return  # CLI entry points exit, they don't report task errors

    def handler_ctx(fn: ast.FunctionDef) -> dict[ast.AST, set[str]]:
        """Map each node to the caught-exception variable names in scope."""
        scopes: dict[ast.AST, set[str]] = {}

        def walk(node: ast.AST, names: set[str]):
            scopes[node] = names
            for child in ast.iter_child_nodes(node):
                if isinstance(node, ast.Try) and isinstance(
                    child, ast.ExceptHandler
                ):
                    walk(
                        child,
                        names | ({child.name} if child.name else set()),
                    )
                else:
                    walk(child, names)

        walk(fn, set())
        return scopes

    fns: list[tuple[ast.FunctionDef, str]] = [
        (f, f.name) for f in mi.functions.values()
    ]
    for ci in mi.classes.values():
        fns.extend((m, f"{ci.name}.{m.name}") for m in ci.methods.values())

    for fn, disp in fns:
        scopes = handler_ctx(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            caught = scopes.get(node, set())
            exc = node.exc
            tname: str | None = None
            if isinstance(exc, ast.Call):
                tname = _terminal(_dotted(exc.func))
                tname = factories.get(tname, tname)
            elif isinstance(exc, ast.Name):
                if exc.id in caught:
                    continue  # re-raise of the caught exception
                tname = exc.id
            else:
                continue  # attribute relay (raise item.exc) etc.
            if tname is None or tname in _TAXONOMY_EXEMPT:
                continue
            if tname in classified:
                continue
            if not tname or not tname[0].isupper():
                continue  # dynamic/variable raise — out of scope
            sup = _suppressed(mi, fn.lineno, node.lineno)
            if "unclassified-raise" in sup or "all" in sup:
                continue
            diags.append(
                LifeDiagnostic(
                    mi.file, node.lineno, "unclassified-raise",
                    f"raise of {tname} which is in neither "
                    "NON_RETRYABLE_ERROR_TYPES nor RETRYABLE_ERROR_TYPES "
                    "(errors.py) — it would silently default to retryable "
                    "at the task boundary",
                    disp,
                )
            )


# --------------------------------------------------------------------------
# swallow / injection handler analysis
# --------------------------------------------------------------------------

_LOG_CALL_RE = re.compile(
    r"\b(log|logger|logging)\.(debug|info|warning|error|exception|critical)"
    r"\b|\bwarnings\.warn\b|\btraceback\."
)


def _handler_types(h: ast.ExceptHandler) -> list[str]:
    t = h.type
    if t is None:
        return []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return [_terminal(_dotted(e)) or "" for e in elts]


def _body_has(node_list: list[ast.stmt], kinds: tuple) -> bool:
    for stmt in node_list:
        for sub in ast.walk(stmt):
            if isinstance(sub, kinds):
                return True
    return False


def _body_logs(mi: _ModuleInfo, h: ast.ExceptHandler) -> bool:
    start = h.lineno
    end = max(
        getattr(s, "end_lineno", s.lineno) for s in h.body
    ) if h.body else h.lineno
    text = "\n".join(mi.lines[start - 1:end])
    return bool(_LOG_CALL_RE.search(text))


def _is_release_only_try(try_node: ast.Try) -> bool:
    """The close-suppression idiom: every statement in the try body is a
    release-method call (or pass)."""
    for stmt in try_node.body:
        if isinstance(stmt, ast.Pass):
            continue
        if not (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr in _RELEASE_METHODS
        ):
            return False
    return True


def _check_handlers(
    mi: _ModuleInfo, diags: list[LifeDiagnostic]
) -> None:
    fns: list[ast.FunctionDef] = list(mi.functions.values())
    for ci in mi.classes.values():
        fns.extend(ci.methods.values())
    for fn in fns:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            for h in node.handlers:
                types = _handler_types(h)
                raises = _body_has(h.body, (ast.Raise,))
                sup = _suppressed(mi, fn.lineno, h.lineno)
                if any(t.startswith("Injected") for t in types):
                    if not raises and not (
                        "untyped-injection" in sup or "all" in sup
                    ):
                        diags.append(
                            LifeDiagnostic(
                                mi.file, h.lineno, "untyped-injection",
                                "handler catches a fault-injection type "
                                f"({[t for t in types if t.startswith('Injected')][0]}) "
                                "without re-raising typed — chaos faults "
                                "must take the production error path",
                                fn.name,
                            )
                        )
                    continue
                broad = h.type is None or any(t in _EXC_BASES for t in types)
                if not broad:
                    continue
                if raises:
                    continue
                if _body_logs(mi, h):
                    continue
                if _is_release_only_try(node):
                    continue
                # relay: the caught exception object is handed onward
                # (``self.action.on_error(e)``, ``_Err(e)`` into a queue)
                if h.name and any(
                    isinstance(sub, ast.Call)
                    and any(
                        isinstance(n, ast.Name) and n.id == h.name
                        for a in list(sub.args)
                        + [kw.value for kw in sub.keywords]
                        for n in ast.walk(a)
                    )
                    for stmt in h.body
                    for sub in ast.walk(stmt)
                ):
                    continue
                # fallback: the handler REACTS by substituting a value or
                # leaving — the failure is handled, not discarded
                if _body_has(h.body, (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign, ast.Return)):
                    continue
                if "swallowed-error" in sup or "all" in sup:
                    continue
                label = "bare except" if h.type is None else (
                    f"except {'/'.join(types)}"
                )
                diags.append(
                    LifeDiagnostic(
                        mi.file, h.lineno, "swallowed-error",
                        f"{label} neither re-raises nor logs — the "
                        "failure vanishes (log it, type it, or narrow "
                        "the except)",
                        fn.name,
                    )
                )


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

# resource-lifecycle + handler rules: the full control & data plane
_RESOURCE_TARGETS = (
    "scheduler",
    "executor",
    "exec",
    "client",
    "compilecache",
    "event_loop.py",
    "standalone.py",
    # observability plane: JSONL export files + the metrics HTTP
    # server's listening socket
    "obs",
)

# error-taxonomy closure: the surfaces whose raises cross the task
# boundary as wire strings (executor catch-alls serialize them)
_TAXONOMY_TARGETS = ("executor", "exec", "client", "scheduler")


def _target_files(subs, paths=None) -> list[pathlib.Path]:
    if paths is not None:
        out: list[pathlib.Path] = []
        for p in paths:
            p = pathlib.Path(p)
            out.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
        return out
    root = pathlib.Path(__file__).resolve().parent.parent
    files: list[pathlib.Path] = []
    for sub in subs:
        p = root / sub
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return files


def _load(paths=None) -> tuple[list[_ModuleInfo], list[_ModuleInfo]]:
    res_files = _target_files(_RESOURCE_TARGETS, paths)
    tax_files = _target_files(_TAXONOMY_TARGETS, paths)
    cache: dict[str, _ModuleInfo] = {}

    def mod(f: pathlib.Path) -> _ModuleInfo:
        key = str(f)
        if key not in cache:
            cache[key] = _collect_module(f.read_text(), key)
        return cache[key]

    return [mod(f) for f in res_files], [mod(f) for f in tax_files]


def lint_paths(paths=None) -> list[LifeDiagnostic]:
    """Analyze files/directories (default: the control & data planes)."""
    res_mods, tax_mods = _load(paths)
    return _diagnose(res_mods, tax_mods)


def lint_source(
    source: str, filename: str = "synth.py"
) -> list[LifeDiagnostic]:
    """Single-module convenience for tests (all rules applied)."""
    mi = _collect_module(source, filename)
    return _diagnose([mi], [mi])


def _diagnose(
    res_mods: list[_ModuleInfo], tax_mods: list[_ModuleInfo]
) -> list[LifeDiagnostic]:
    diags: list[LifeDiagnostic] = []
    analysis = _Analysis(res_mods)
    obligations: list = []
    for mi in res_mods:
        for fn in mi.functions.values():
            _walk_with_nested(fn, mi, None, analysis, diags, obligations)
        for ci in mi.classes.values():
            for meth in ci.methods.values():
                _walk_with_nested(meth, mi, ci, analysis, diags, obligations)
        _check_handlers(mi, diags)
    _check_class_obligations(obligations, diags)
    classified = _classified_types()
    factories = _exc_factories(tax_mods)
    for mi in tax_mods:
        _check_taxonomy(mi, factories, classified, diags)
    diags.sort(key=lambda d: (d.file, d.line, d.rule))
    return diags


def _walk_with_nested(
    fn: ast.FunctionDef,
    mi: _ModuleInfo,
    ci: _ClassInfo | None,
    analysis: _Analysis,
    diags: list[LifeDiagnostic],
    obligations: list,
) -> None:
    _check_resources(fn, mi, ci, analysis, diags, obligations)
    for node in ast.walk(fn):
        if node is not fn and isinstance(node, ast.FunctionDef):
            # nested defs get their own resource check (acquisitions in a
            # closure are owned by that closure unless they escape)
            _check_resources(node, mi, ci, analysis, diags, obligations)


def suppression_count(paths=None) -> int:
    """Number of ``# lifelint: disable=`` escape hatches in the targets
    (transfer annotations are NOT suppressions and are not counted)."""
    n = 0
    seen = set()
    for f in _target_files(_RESOURCE_TARGETS, paths) + _target_files(
        _TAXONOMY_TARGETS, paths
    ):
        if str(f) in seen:
            continue
        seen.add(str(f))
        n += len(_SUPPRESS_RE.findall(f.read_text()))
    return n


def transfer_sites(paths=None) -> list[tuple[str, int, str]]:
    """Every declared ``# lifelint: transfer`` annotation: (file, line,
    note) — the audited ownership hand-offs."""
    out: list[tuple[str, int, str]] = []
    seen = set()
    for f in _target_files(_RESOURCE_TARGETS, paths) + _target_files(
        _TAXONOMY_TARGETS, paths
    ):
        if str(f) in seen:
            continue
        seen.add(str(f))
        for i, line in enumerate(f.read_text().splitlines(), 1):
            m = _TRANSFER_RE.search(line)
            if m:
                out.append((str(f), i, m.group(1) or "declared"))
    return out
