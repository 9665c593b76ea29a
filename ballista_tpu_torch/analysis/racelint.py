"""racelint: lock-discipline & state-machine static analysis (the port's
copy of ``ballista_tpu/analysis/racelint.py``, with its rules and
transition tables, over the port's control plane and its kernel builder
and wrappers).

The scheduler/executor control plane is genuinely concurrent:
``SchedulerServer``, ``StageManager``, ``ExecutorManager``, the state
backends, the Flight connection pool, the event loop, and the executor
poll/heartbeat/cleanup threads juggle ~15 locks across a dozen daemon
threads. Without a static check, the next recovery change could
reintroduce exactly the deadlock and silent-race classes fixed by hand
before (the ``EventLoop.stop()`` full-queue deadlock, the ``next_task``
re-resolution race). racelint is the default-on gate for that: an
AST-based, import-free analysis of the concurrent control plane with four
rule families:

==================== ========================================================
rule                 rationale
==================== ========================================================
unguarded-field      For each class owning a ``threading.Lock``/``RLock``
                     (or a :func:`witness.make_lock`), infer the fields
                     *written* under ``with self._lock`` — those are the
                     lock's protectorate — and flag any read/write of them
                     outside the lock (``__init__`` exempt: construction is
                     single-threaded). Same inference for module globals
                     written under a module-level lock.
lock-order-cycle     Build the inter-class lock acquisition graph from
                     nested ``with``-lock scopes and calls into lock-taking
                     methods (receiver types resolved from ``self.x =
                     Class()`` constructor assignments), and fail on cycles
                     — the static deadlock hazard. Also flags re-acquiring
                     a NON-reentrant lock through a call chain.
blocking-under-lock  gRPC/Flight/socket/``sleep``/blocking ``queue.get``/
                     ``queue.put``/file-IO reachable while a lock is held —
                     the exact shape of the ``EventLoop.stop()``
                     deadlock (a bounded-queue ``put`` under a lock the
                     consumer needs). Propagated transitively through
                     resolved calls.
undeclared-transition Every ``.state = TaskState.X`` assignment must be a
                     declared edge of
                     :data:`~ballista_tpu_torch.analysis.statemachine.TASK_TRANSITIONS`
                     (source state inferred from enclosing guards and
                     assignment flow, or the function must gate on the
                     declared table), and every ``.status = "<s>"`` string
                     must be a declared job state with declared in-edges.
==================== ========================================================

Suppression: append ``# racelint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the offending line or to the enclosing ``def`` line.
The tier-1 suite budgets suppressions at ≤ 5 tree-wide.

Scope/limitations (deliberate): receiver types are resolved only through
``self.attr = ClassName(...)`` constructor assignments and ``self`` calls
(including inherited methods), so cross-object accesses like
``rest.py``'s ``server.jobs`` snapshots are out of scope — the rule is a
per-class discipline check, not an escape analysis. Locks passed as
arguments or returned from functions are not tracked.

The static lock-order graph is exported (:func:`lock_order_graph`,
``--dot``) and shares its node vocabulary (``Class._lockfield`` /
``module._LOCK``) with the runtime witness
(:mod:`ballista_tpu_torch.analysis.witness`), which asserts during tests that
every acquisition order actually taken is consistent with this graph.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from ballista_tpu_torch.analysis.statemachine import (
    JOB_STATES,
    JOB_TRANSITIONS,
    TASK_TRANSITIONS,
)

RULES: dict[str, str] = {
    "unguarded-field": "read/write of a lock-guarded field (one written "
    "under the owning lock) outside any holder of that lock",
    "lock-order-cycle": "cycle in the static lock acquisition-order graph "
    "(or re-acquisition of a non-reentrant lock) — deadlock hazard",
    "blocking-under-lock": "blocking call (RPC/Flight/sleep/queue/IO) "
    "reachable while a lock is held — the EventLoop.stop() deadlock shape",
    "undeclared-transition": "status assignment that is not a declared "
    "edge of the canonical task/job state machine",
}

_SUPPRESS_RE = re.compile(r"#\s*racelint:\s*disable=([A-Za-z0-9_,\- ]+)")

# threading constructors (and the witness factory) that create a lock
_LOCK_CTORS = {
    "threading.Lock": False,
    "threading.RLock": True,
    "Lock": False,
    "RLock": True,
    "make_lock": None,  # reentrant= kwarg decides
    "witness.make_lock": None,
}

# dotted call names that block the calling thread
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep()",
    "sleep": "sleep()",
    "paflight.connect": "Flight dial (paflight.connect)",
    "flight.connect": "Flight dial",
    "grpc.insecure_channel": "gRPC channel setup",
    "_grpc.insecure_channel": "gRPC channel setup",
    "shutil.rmtree": "file-tree removal",
    "os.walk": "filesystem walk",
    "socket.create_connection": "socket connect",
    "open": "file open",
}

# RPC verbs of this codebase's two gRPC services (scheduler/rpc.py): a
# stub call on any of these is a network round trip with a deadline
_RPC_METHODS = {
    "PollWork", "RegisterExecutor", "HeartBeatFromExecutor",
    "UpdateTaskStatus", "ExecuteQuery", "GetJobStatus", "GetFileMetadata",
    "LaunchTask", "StopExecutor",
}

# attribute-call names that block regardless of receiver
_BLOCKING_ATTRS = {
    "do_get": "Flight do_get stream",
    "read_all": "Flight read_all",
    "serve": "server loop",
    "join": "thread join",
    "wait": "event wait",
    **{m: f"{m} RPC" for m in _RPC_METHODS},
}

# receiver-method calls that MUTATE the receiver (write for rule 1)
_MUTATORS = {
    "append", "add", "pop", "popitem", "clear", "update", "discard",
    "remove", "setdefault", "extend", "insert", "put", "put_nowait",
}


@dataclasses.dataclass(frozen=True)
class RaceDiagnostic:
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


def _lock_ctor_kind(value: ast.AST) -> bool | None:
    """True/False (reentrant) when ``value`` constructs a lock, else None."""
    if not isinstance(value, ast.Call):
        return None
    d = _dotted(value.func)
    if d not in _LOCK_CTORS:
        return None
    kind = _LOCK_CTORS[d]
    if kind is not None:
        return kind
    for kw in value.keywords:  # make_lock(..., reentrant=True)
        if kw.arg == "reentrant" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


# --------------------------------------------------------------------------
# module / class models
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ClassInfo:
    name: str
    module: str
    file: str
    node: ast.ClassDef
    bases: list[str] = dataclasses.field(default_factory=list)
    # lock field -> (lock_id, reentrant)
    lock_fields: dict[str, tuple[str, bool]] = dataclasses.field(
        default_factory=dict
    )
    # attr -> class name (constructor-typed)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    methods: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class _ModuleInfo:
    name: str  # module stem (for lock ids)
    file: str
    tree: ast.Module
    lines: list[str]
    classes: dict[str, _ClassInfo] = dataclasses.field(default_factory=dict)
    functions: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict
    )
    # module-level lock var -> (lock_id, reentrant)
    module_locks: dict[str, tuple[str, bool]] = dataclasses.field(
        default_factory=dict
    )
    module_globals: set[str] = dataclasses.field(default_factory=set)


def _collect_module(source: str, filename: str) -> _ModuleInfo:
    tree = ast.parse(source, filename=filename)
    stem = pathlib.Path(filename).stem
    mi = _ModuleInfo(stem, filename, tree, source.splitlines())
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ):
            name = node.targets[0].id
            mi.module_globals.add(name)
            kind = _lock_ctor_kind(node.value)
            if kind is not None:
                mi.module_locks[name] = (f"{stem}.{name}", kind)
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            mi.module_globals.add(node.target.id)
        elif isinstance(node, ast.FunctionDef):
            mi.functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(node.name, stem, filename, node)
            ci.bases = [b for b in (_dotted(x) for x in node.bases) if b]
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    ci.methods[item.name] = item
            # discover lock fields + constructor-typed attrs in any method
            for meth in ci.methods.values():
                for sub in ast.walk(meth):
                    if not (
                        isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Attribute)
                        and isinstance(sub.targets[0].value, ast.Name)
                        and sub.targets[0].value.id == "self"
                    ):
                        continue
                    field = sub.targets[0].attr
                    kind = _lock_ctor_kind(sub.value)
                    if kind is not None:
                        ci.lock_fields[field] = (
                            f"{ci.name}.{field}", kind
                        )
                    elif isinstance(sub.value, ast.Call):
                        d = _dotted(sub.value.func) or ""
                        ci.attr_types.setdefault(field, d.split(".")[-1])
            mi.classes[ci.name] = ci
    return mi


# --------------------------------------------------------------------------
# per-function walk: accesses, acquisitions, calls, blocking sites
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _FnFacts:
    key: tuple  # ("m", Class, name) | ("f", module, name)
    node: ast.FunctionDef
    module: _ModuleInfo
    cls: _ClassInfo | None
    # (field, write?, frozenset(held lock ids), line) for self.X accesses
    field_accesses: list[tuple[str, bool, frozenset, int]] = (
        dataclasses.field(default_factory=list)
    )
    # same for module globals
    global_accesses: list[tuple[str, bool, frozenset, int]] = (
        dataclasses.field(default_factory=list)
    )
    # (lock_id, reentrant, frozenset(held BEFORE), line)
    acquisitions: list[tuple[str, bool, frozenset, int]] = (
        dataclasses.field(default_factory=list)
    )
    # (callee_key, frozenset(held), line, display)
    calls: list[tuple[tuple, frozenset, int, str]] = dataclasses.field(
        default_factory=list
    )
    # (description, frozenset(held), line)
    blocking: list[tuple[str, frozenset, int]] = dataclasses.field(
        default_factory=list
    )


class _Registry:
    """Cross-module class/function lookup."""

    def __init__(self, modules: list[_ModuleInfo]):
        self.modules = modules
        self.classes: dict[str, _ClassInfo] = {}
        for m in modules:
            for c in m.classes.values():
                self.classes.setdefault(c.name, c)

    def resolve_method(
        self, cls: _ClassInfo | None, name: str
    ) -> tuple | None:
        """("m", file, DefiningClassName, name) through the base chain —
        the file keeps keys unique across same-named modules/classes."""
        seen = set()
        while cls is not None and cls.name not in seen:
            seen.add(cls.name)
            if name in cls.methods:
                return ("m", cls.file, cls.name, name)
            nxt = None
            for b in cls.bases:
                base = self.classes.get(b.split(".")[-1])
                if base is not None:
                    nxt = base
                    break
            cls = nxt
        return None


def _walk_function(
    fn: ast.FunctionDef,
    mi: _ModuleInfo,
    ci: _ClassInfo | None,
    reg: _Registry,
    nested_out: list,
) -> _FnFacts:
    key = (
        ("m", ci.file, ci.name, fn.name)
        if ci
        else ("f", mi.file, fn.name)
    )
    facts = _FnFacts(key, fn, mi, ci)
    # locals: params + names assigned without a `global` declaration
    globals_decl: set[str] = set()
    local_names: set[str] = set()
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        local_names.add(p.arg)
    if a.vararg:
        local_names.add(a.vararg.arg)
    if a.kwarg:
        local_names.add(a.kwarg.arg)
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Global):
            globals_decl.update(sub.names)
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            local_names.add(sub.id)
        elif isinstance(sub, (ast.For,)) and isinstance(
            sub.target, ast.Name
        ):
            local_names.add(sub.target.id)
    local_names -= globals_decl

    def lock_of(expr: ast.AST) -> tuple[str, bool] | None:
        if isinstance(expr, ast.Name) and expr.id in mi.module_locks:
            return mi.module_locks[expr.id]
        if (
            ci is not None
            and isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in ci.lock_fields
        ):
            return ci.lock_fields[expr.attr]
        return None

    def record_field(name: str, write: bool, held: frozenset, line: int):
        if ci is None:
            return
        if name in ci.lock_fields:
            return
        if name in ci.methods or (
            reg.resolve_method(ci, name) is not None
        ):
            return  # method reference, not data
        facts.field_accesses.append((name, write, held, line))

    def record_global(name: str, write: bool, held: frozenset, line: int):
        if name in mi.module_locks or name not in mi.module_globals:
            return
        if name in mi.functions or name in mi.classes:
            return
        if not write and name in local_names:
            return  # shadowed
        facts.global_accesses.append((name, write, held, line))

    def scan_expr(expr: ast.AST, held: frozenset) -> None:
        """Record calls/accesses/blocking sites in an expression tree,
        PRUNING nested function/lambda subtrees (they run later, with no
        lock inherited — ast.walk would descend into them, wrongly
        attributing a deferred callback's body to the current locks)."""
        stack: list[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue  # deferred body: pruned, children not visited
            stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, ast.Call):
                _scan_call(node, held)
            elif isinstance(node, ast.Attribute):
                if (
                    isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                ):
                    write = isinstance(node.ctx, (ast.Store, ast.Del))
                    record_field(node.attr, write, held, node.lineno)
            elif isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    record_global(node.id, False, held, node.lineno)
                elif node.id in globals_decl:
                    record_global(node.id, True, held, node.lineno)

    def _scan_call(node: ast.Call, held: frozenset) -> None:
        d = _dotted(node.func)
        line = node.lineno
        # blocking primitives -------------------------------------------------
        if d in _BLOCKING_DOTTED:
            facts.blocking.append((_BLOCKING_DOTTED[d], held, line))
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = node.func.value
            recv_is_str = isinstance(recv, ast.Constant) and isinstance(
                recv.value, str
            )
            if attr in _BLOCKING_ATTRS and not recv_is_str:
                facts.blocking.append(
                    (f"{_BLOCKING_ATTRS[attr]} (.{attr}())", held, line)
                )
            elif attr == "get" and not node.args:
                # zero-positional .get() is a queue get (dict.get needs a
                # key); timeout= keeps it blocking, just bounded
                facts.blocking.append(("blocking queue.get()", held, line))
            elif attr == "put" and len(node.args) <= 1:
                # one-positional .put(item) is a queue put (KV-store puts
                # carry (key, value)); a bounded queue makes it blocking
                facts.blocking.append(
                    ("queue.put() (may block on a bounded queue)",
                     held, line)
                )
            # receiver mutation => write of the receiver field/global
            if attr in _MUTATORS:
                tgt = recv
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    record_field(tgt.attr, True, held, line)
                elif isinstance(tgt, ast.Name):
                    record_global(tgt.id, True, held, line)
        # call resolution -----------------------------------------------------
        callee = None
        disp = d or "<call>"
        if isinstance(node.func, ast.Name):
            nm = node.func.id
            if ci is not None and nm in mi.classes and nm == ci.name:
                callee = reg.resolve_method(mi.classes[nm], "__init__")
            elif nm in mi.functions:
                callee = ("f", mi.file, nm)
            elif nm in reg.classes:
                callee = reg.resolve_method(reg.classes[nm], "__init__")
        elif isinstance(node.func, ast.Attribute):
            recv = node.func.value
            meth = node.func.attr
            if isinstance(recv, ast.Name) and recv.id == "self":
                callee = reg.resolve_method(ci, meth)
            elif (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and ci is not None
            ):
                tname = ci.attr_types.get(recv.attr)
                target = reg.classes.get(tname) if tname else None
                if target is not None:
                    callee = reg.resolve_method(target, meth)
        if callee is not None:
            facts.calls.append((callee, held, line, disp))

    def walk_stmts(stmts: list[ast.stmt], held: frozenset) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.FunctionDef):
                nested_out.append((stmt, mi, ci))
                continue
            if isinstance(stmt, ast.With):
                inner = held
                for item in stmt.items:
                    lk = lock_of(item.context_expr)
                    scan_expr(item.context_expr, inner)
                    if lk is not None:
                        lock_id, reentrant = lk
                        facts.acquisitions.append(
                            (lock_id, reentrant, inner, stmt.lineno)
                        )
                        inner = inner | {lock_id}
                walk_stmts(stmt.body, inner)
                continue
            if isinstance(stmt, ast.If):
                scan_expr(stmt.test, held)
                walk_stmts(stmt.body, held)
                walk_stmts(stmt.orelse, held)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                scan_expr(stmt.iter, held)
                scan_expr(stmt.target, held)
                walk_stmts(stmt.body, held)
                walk_stmts(stmt.orelse, held)
                continue
            if isinstance(stmt, ast.While):
                scan_expr(stmt.test, held)
                walk_stmts(stmt.body, held)
                walk_stmts(stmt.orelse, held)
                continue
            if isinstance(stmt, ast.Try):
                walk_stmts(stmt.body, held)
                for h in stmt.handlers:
                    walk_stmts(h.body, held)
                walk_stmts(stmt.orelse, held)
                walk_stmts(stmt.finalbody, held)
                continue
            # subscript stores mutate the container: self.X[k] = v
            if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        record_field(base.attr, True, held, stmt.lineno)
                    elif isinstance(base, ast.Name) and not isinstance(
                        t, ast.Name
                    ):
                        record_global(base.id, True, held, stmt.lineno)
            if isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Name):
                        record_global(base.id, True, held, stmt.lineno)
                    elif (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        record_field(base.attr, True, held, stmt.lineno)
            scan_expr(stmt, held)

    walk_stmts(fn.body, frozenset())
    # plain `self.x = v` is seen by both the Assign-target handler and
    # scan_expr's Store-ctx walk — merge per (name, line, held), keeping
    # the stronger (write) classification, so a violation emits once
    facts.field_accesses = _dedupe_accesses(facts.field_accesses)
    facts.global_accesses = _dedupe_accesses(facts.global_accesses)
    return facts


def _dedupe_accesses(
    accesses: list[tuple[str, bool, frozenset, int]]
) -> list[tuple[str, bool, frozenset, int]]:
    merged: dict[tuple, bool] = {}
    for name, write, held, line in accesses:
        key = (name, line, held)
        merged[key] = merged.get(key, False) or write
    return sorted(
        ((n, w, h, l) for (n, l, h), w in merged.items()),
        key=lambda a: (a[3], a[0]),
    )


# --------------------------------------------------------------------------
# analysis passes
# --------------------------------------------------------------------------


def _suppressed(mi: _ModuleInfo, fn: ast.FunctionDef, line: int) -> frozenset:
    out: set[str] = set()
    for ln in (line, fn.lineno):
        if 0 < ln <= len(mi.lines):
            m = _SUPPRESS_RE.search(mi.lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(","))
    return frozenset(out)


class _Analysis:
    def __init__(self, modules: list[_ModuleInfo]):
        self.modules = modules
        self.reg = _Registry(modules)
        self.fns: dict[tuple, _FnFacts] = {}
        self.lock_reentrant: dict[str, bool] = {}
        pending: list[tuple[ast.FunctionDef, _ModuleInfo, _ClassInfo | None]]
        pending = []
        for mi in modules:
            for lock_id, kind in mi.module_locks.values():
                self.lock_reentrant[lock_id] = kind
            for fn in mi.functions.values():
                pending.append((fn, mi, None))
            for ci in mi.classes.values():
                for lock_id, kind in ci.lock_fields.values():
                    self.lock_reentrant[lock_id] = kind
                for meth in ci.methods.values():
                    pending.append((meth, mi, ci))
        while pending:
            fn, mi, ci = pending.pop()
            facts = _walk_function(fn, mi, ci, self.reg, pending)
            # nested defs share the enclosing key space via (key, name)
            self.fns.setdefault(facts.key, facts)
        self._fixpoint()

    def _fixpoint(self) -> None:
        """Transitive may-acquire lock set and may-block flag per fn."""
        self.may_acquire: dict[tuple, set[str]] = {
            k: {a[0] for a in f.acquisitions} for k, f in self.fns.items()
        }
        self.may_block: dict[tuple, str | None] = {
            k: (f.blocking[0][0] if f.blocking else None)
            for k, f in self.fns.items()
        }
        changed = True
        while changed:
            changed = False
            for k, f in self.fns.items():
                for callee, _held, _line, disp in f.calls:
                    extra = self.may_acquire.get(callee, set())
                    if not extra <= self.may_acquire[k]:
                        self.may_acquire[k] |= extra
                        changed = True
                    cb = self.may_block.get(callee)
                    if cb and self.may_block[k] is None:
                        self.may_block[k] = f"{disp}() -> {cb}"
                        changed = True

    # -- rule 2: lock-order graph -------------------------------------------
    def lock_edges(self) -> dict[tuple[str, str], list[tuple[str, int]]]:
        edges: dict[tuple[str, str], list[tuple[str, int]]] = {}
        for f in self.fns.values():
            for lock_id, _re, held, line in f.acquisitions:
                for h in held:
                    if h != lock_id:
                        edges.setdefault((h, lock_id), []).append(
                            (f.module.file, line)
                        )
            for callee, held, line, _d in f.calls:
                for m in self.may_acquire.get(callee, ()):
                    for h in held:
                        if h != m:
                            edges.setdefault((h, m), []).append(
                                (f.module.file, line)
                            )
        return edges

    def diagnostics(self) -> list[RaceDiagnostic]:
        diags: list[RaceDiagnostic] = []

        def emit(
            mi: _ModuleInfo, fn: ast.FunctionDef, line: int, rule: str,
            msg: str,
        ) -> None:
            sup = _suppressed(mi, fn, line)
            if rule in sup or "all" in sup:
                return
            diags.append(
                RaceDiagnostic(mi.file, line, rule, msg, fn.name)
            )

        # -- rule 1: guarded-field inference ---------------------------------
        by_class: dict[str, list[_FnFacts]] = {}
        by_module: dict[str, list[_FnFacts]] = {}
        for f in self.fns.values():
            if f.cls is not None:
                by_class.setdefault(f.cls.name, []).append(f)
            by_module.setdefault(f.module.name, []).append(f)

        _INIT = ("__init__", "__post_init__")
        for cname, fns in by_class.items():
            ci = self.reg.classes[cname]
            if not ci.lock_fields:
                continue
            own_locks = {lid for lid, _k in ci.lock_fields.values()}
            guards: dict[str, set[str]] = {}
            for f in fns:
                if f.node.name in _INIT:
                    continue
                for field, write, held, _line in f.field_accesses:
                    if write and (held & own_locks):
                        guards.setdefault(field, set()).update(
                            held & own_locks
                        )
            for f in fns:
                if f.node.name in _INIT:
                    continue
                for field, write, held, line in f.field_accesses:
                    locks = guards.get(field)
                    if not locks or (held & locks):
                        continue
                    emit(
                        f.module, f.node, line, "unguarded-field",
                        f"{'write to' if write else 'read of'} "
                        f"{cname}.{field} without holding "
                        f"{sorted(locks)} (field is written under that "
                        "lock elsewhere)",
                    )

        for mname, fns in by_module.items():
            mi = fns[0].module
            if not mi.module_locks:
                continue
            mlocks = {lid for lid, _k in mi.module_locks.values()}
            guards = {}
            for f in fns:
                for name, write, held, _line in f.global_accesses:
                    if write and (held & mlocks):
                        guards.setdefault(name, set()).update(held & mlocks)
            for f in fns:
                for name, write, held, line in f.global_accesses:
                    locks = guards.get(name)
                    if not locks or (held & locks):
                        continue
                    emit(
                        f.module, f.node, line, "unguarded-field",
                        f"{'write to' if write else 'read of'} module "
                        f"global {name} without holding {sorted(locks)}",
                    )

        # -- rule 2: cycles + non-reentrant re-acquisition -------------------
        edges = self.lock_edges()
        adj: dict[str, set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        cycle = _find_cycle(adj)
        if cycle:
            first = edges[(cycle[0], cycle[1])][0]
            mi_fn = self._site_fn(first)
            path = " -> ".join(cycle)
            if mi_fn is not None:
                emit(
                    mi_fn[0], mi_fn[1], first[1], "lock-order-cycle",
                    f"lock acquisition cycle: {path}",
                )
            else:
                diags.append(
                    RaceDiagnostic(
                        first[0], first[1], "lock-order-cycle",
                        f"lock acquisition cycle: {path}",
                    )
                )
        for f in self.fns.values():
            for lock_id, _re, held, line in f.acquisitions:
                if lock_id in held and not self.lock_reentrant.get(
                    lock_id, True
                ):
                    emit(
                        f.module, f.node, line, "lock-order-cycle",
                        f"re-acquisition of non-reentrant {lock_id} "
                        "while already held (self-deadlock)",
                    )
            for callee, held, line, disp in f.calls:
                for m in self.may_acquire.get(callee, ()):
                    if m in held and not self.lock_reentrant.get(m, True):
                        emit(
                            f.module, f.node, line, "lock-order-cycle",
                            f"{disp}() re-acquires non-reentrant {m} "
                            "already held here (self-deadlock)",
                        )

        # -- rule 3: blocking under lock -------------------------------------
        for f in self.fns.values():
            for desc, held, line in f.blocking:
                if held:
                    emit(
                        f.module, f.node, line, "blocking-under-lock",
                        f"{desc} while holding {sorted(held)}",
                    )
            for callee, held, line, disp in f.calls:
                if not held:
                    continue
                cb = self.may_block.get(callee)
                if cb:
                    emit(
                        f.module, f.node, line, "blocking-under-lock",
                        f"{disp}() may block ({cb}) while holding "
                        f"{sorted(held)}",
                    )

        # -- rule 4: state machine -------------------------------------------
        for f in self.fns.values():
            diags.extend(
                d for d in _check_transitions(f)
                if not (
                    _suppressed(f.module, f.node, d.line)
                    & {d.rule, "all"}
                )
            )

        diags.sort(key=lambda d: (d.file, d.line, d.rule))
        return diags

    def suppression_count(self) -> int:
        return sum(
            len(_SUPPRESS_RE.findall("\n".join(m.lines)))
            for m in self.modules
        )

    def _site_fn(self, site: tuple[str, int]):
        for f in self.fns.values():
            if f.module.file == site[0] and (
                f.node.lineno <= site[1] <= max(
                    getattr(f.node, "end_lineno", f.node.lineno),
                    f.node.lineno,
                )
            ):
                return f.module, f.node
        return None


def _find_cycle(adj: dict[str, set[str]]) -> list[str] | None:
    """First cycle found via DFS, as [n0, n1, ..., n0]."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    stack: list[str] = []

    def dfs(n: str) -> list[str] | None:
        color[n] = GREY
        stack.append(n)
        for m in sorted(adj.get(n, ())):
            if color.get(m, WHITE) == GREY:
                i = stack.index(m)
                return stack[i:] + [m]
            if color.get(m, WHITE) == WHITE:
                color.setdefault(m, WHITE)
                found = dfs(m)
                if found:
                    return found
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(adj):
        if color[n] == WHITE:
            found = dfs(n)
            if found:
                return found
    return None


# --------------------------------------------------------------------------
# rule 4: state-machine verification
# --------------------------------------------------------------------------

_TASK_EDGE_SET = set(TASK_TRANSITIONS)
_JOB_EDGE_SET = set(JOB_TRANSITIONS)


def _key(expr: ast.AST) -> str:
    """Stable identity for an lvalue/rvalue expression: the dotted chain
    when one exists ("t.state", "new_state") — ast.dump embeds Load/Store
    ctx, which would keep an if-test fact from ever matching the
    assignment target it guards."""
    d = _dotted(expr)
    return d if d is not None else ast.dump(expr)


def _module_mentions_taskstate(mi: _ModuleInfo) -> bool:
    cached = getattr(mi, "_mentions_taskstate", None)
    if cached is None:
        cached = any(
            (isinstance(n, ast.Name) and n.id == "TaskState")
            or (isinstance(n, ast.ClassDef) and n.name == "TaskState")
            or (
                isinstance(n, ast.ImportFrom)
                and any(a.name == "TaskState" for a in n.names)
            )
            for n in ast.walk(mi.tree)
        )
        mi._mentions_taskstate = cached
    return cached


def _task_const(expr: ast.AST) -> str | None:
    """'pending' for ``TaskState.PENDING`` attribute refs."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "TaskState"
    ):
        return expr.attr.lower()
    return None


def _facts_from_test(test: ast.AST) -> dict[str, set[str]]:
    """expr-dump -> possible states, from an if-test (Eq / In / And)."""
    out: dict[str, set[str]] = {}
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            for k, s in _facts_from_test(v).items():
                out.setdefault(k, set()).update(s)
        return out
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, op, right = test.left, test.ops[0], test.comparators[0]
        if isinstance(op, ast.Eq):
            s = _task_const(right)
            if s is None and isinstance(right, ast.Constant) and (
                isinstance(right.value, str)
            ):
                s = right.value
            if s is not None:
                out[_key(left)] = {s}
        elif isinstance(op, ast.In) and isinstance(
            right, (ast.Tuple, ast.List, ast.Set)
        ):
            states = set()
            for elt in right.elts:
                s = _task_const(elt)
                if s is None and isinstance(elt, ast.Constant) and (
                    isinstance(elt.value, str)
                ):
                    s = elt.value
                if s is not None:
                    states.add(s)
            if states:
                out[_key(left)] = states
    return out


def _fn_has_table_guard(fn: ast.FunctionDef) -> bool:
    """The function gates on the declared table (membership test on
    ``_LEGAL``/``TASK_TRANSITIONS`` or a call to
    ``is_legal_task_transition``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
        ):
            for comp in node.comparators:
                d = _dotted(comp) or ""
                if d.split(".")[-1] in ("_LEGAL", "TASK_TRANSITIONS"):
                    return True
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.split(".")[-1] == "is_legal_task_transition":
                return True
    return False


def _check_transitions(f: _FnFacts) -> list[RaceDiagnostic]:
    fn = f.node
    mi = f.module
    mentions_taskstate = _module_mentions_taskstate(mi)
    guarded = _fn_has_table_guard(fn)
    diags: list[RaceDiagnostic] = []

    def check_edges(
        sources: set[str] | None, targets: set[str], table: set,
        names: tuple, kind: str, line: int,
    ) -> None:
        bad_states = [t for t in targets if t not in names]
        if bad_states:
            diags.append(
                RaceDiagnostic(
                    mi.file, line, "undeclared-transition",
                    f"assignment to undeclared {kind} state "
                    f"{bad_states}", fn.name,
                )
            )
            return
        if sources is None:
            if not guarded:
                declared_in = {t for t in targets if any(
                    (s, t) in table for s in names
                )}
                if declared_in != set(targets):
                    diags.append(
                        RaceDiagnostic(
                            mi.file, line, "undeclared-transition",
                            f"{kind} state {sorted(set(targets) - declared_in)} "
                            "has no declared in-edge", fn.name,
                        )
                    )
            return
        for s in sources:
            for t in targets:
                if s != t and (s, t) not in table:
                    diags.append(
                        RaceDiagnostic(
                            mi.file, line, "undeclared-transition",
                            f"{kind} transition {s} -> {t} is not a "
                            "declared edge", fn.name,
                        )
                    )

    def walk(stmts, env: dict[str, set[str]], aliases: dict[str, str]):
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                benv = dict(env)
                benv.update(_facts_from_test(stmt.test))
                walk(stmt.body, benv, dict(aliases))
                walk(stmt.orelse, dict(env), dict(aliases))
                continue
            if isinstance(stmt, (ast.For, ast.While, ast.With)):
                walk(stmt.body, env, aliases)
                walk(getattr(stmt, "orelse", []), env, aliases)
                continue
            if isinstance(stmt, ast.Try):
                walk(stmt.body, env, aliases)
                for h in stmt.handlers:
                    walk(h.body, env, aliases)
                walk(stmt.orelse, env, aliases)
                walk(stmt.finalbody, env, aliases)
                continue
            if isinstance(stmt, ast.FunctionDef):
                continue
            if not (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Attribute)
            ):
                continue
            target = stmt.targets[0]
            key = _key(target)

            def source_states() -> set[str] | None:
                if key in env:
                    return env[key]
                alias = aliases.get(key)
                if alias is not None and alias in env:
                    return env[alias]
                return None

            if target.attr == "state":
                tconst = _task_const(stmt.value)
                if tconst is not None:
                    check_edges(
                        source_states(), {tconst}, _TASK_EDGE_SET,
                        tuple(s for s, _t in _TASK_EDGE_SET) + tuple(
                            t for _s, t in _TASK_EDGE_SET
                        ),
                        "task", stmt.lineno,
                    )
                    env[key] = {tconst}
                    aliases.pop(key, None)
                elif isinstance(stmt.value, ast.Name) and mentions_taskstate:
                    vkey = _key(stmt.value)
                    if vkey in env:
                        check_edges(
                            source_states(), env[vkey], _TASK_EDGE_SET,
                            tuple(s for s, _t in _TASK_EDGE_SET) + tuple(
                                t for _s, t in _TASK_EDGE_SET
                            ),
                            "task", stmt.lineno,
                        )
                        env[key] = set(env[vkey])
                    elif not guarded:
                        diags.append(
                            RaceDiagnostic(
                                mi.file, stmt.lineno,
                                "undeclared-transition",
                                "dynamic task-state assignment without a "
                                "declared-table guard "
                                "(test membership in TASK_TRANSITIONS/"
                                "_LEGAL first)", fn.name,
                            )
                        )
                    else:
                        env.pop(key, None)
                        aliases[key] = _key(stmt.value)
            elif target.attr == "status" and isinstance(
                stmt.value, ast.Constant
            ) and isinstance(stmt.value.value, str):
                check_edges(
                    source_states(), {stmt.value.value}, _JOB_EDGE_SET,
                    JOB_STATES, "job", stmt.lineno,
                )
                env[key] = {stmt.value.value}
                aliases.pop(key, None)

    walk(fn.body, {}, {})
    return diags


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

_DEFAULT_TARGETS = (
    "scheduler",
    "executor",
    "client/flight.py",
    "event_loop.py",
    "standalone.py",
    "testing/faults.py",
    # streaming-pipeline primitives: bounded-queue handoff between
    # background workers and consuming generators (the shuffle reader's
    # overlapped fetch lives in executor/, covered above; the scan
    # prefetch pipeline lives here)
    "exec/pipeline.py",
    # observability plane: the trace ring/outbox is written by every task
    # thread and drained by the poll/heartbeat loops
    "obs",
    # the kernel builder and the three kernel wrappers: module state (built
    # libraries, launchers, launch counts) that concurrent task threads
    # share, which the reference left to XLA
    "ops/cuda_build.py",
    "ops/onehot_agg.py",
    "ops/partition.py",
    "ops/prefix_sum.py",
)


def _target_files(paths=None) -> list[pathlib.Path]:
    if paths is not None:
        out = []
        for p in paths:
            p = pathlib.Path(p)
            out.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
        return out
    root = pathlib.Path(__file__).resolve().parent.parent
    files: list[pathlib.Path] = []
    for sub in _DEFAULT_TARGETS:
        p = root / sub
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return files


def _load(paths=None) -> _Analysis:
    modules = [
        _collect_module(f.read_text(), str(f)) for f in _target_files(paths)
    ]
    return _Analysis(modules)


def analyze(paths=None) -> _Analysis:
    """Parse + analyze the targets ONCE; the returned object answers
    ``.diagnostics()``, ``.lock_edges()``, and ``.suppression_count()``
    without re-reading anything (the combined CLI gate uses this)."""
    return _load(paths)


def lint_paths(paths=None) -> list[RaceDiagnostic]:
    """Analyze files/directories (default: the concurrent control plane)."""
    return _load(paths).diagnostics()


def lint_source(source: str, filename: str = "synth.py") -> list[RaceDiagnostic]:
    """Single-module convenience for tests."""
    return _Analysis([_collect_module(source, filename)]).diagnostics()


def lock_order_graph(
    paths=None,
) -> dict[tuple[str, str], list[tuple[str, int]]]:
    """The static lock acquisition-order graph: ``(held, acquired) ->
    [(file, line), ...]``. Shares node names with the runtime witness."""
    return _load(paths).lock_edges()


def lock_order_dot(paths=None) -> str:
    """Graphviz dump of the lock-order graph (``--dot``)."""
    edges = lock_order_graph(paths)
    out = ["digraph lock_order {"]
    for (a, b), sites in sorted(edges.items()):
        f, line = sites[0]
        label = f"{pathlib.Path(f).name}:{line}"
        out.append(f'  "{a}" -> "{b}" [label="{label}"];')
    out.append("}")
    return "\n".join(out)


def suppression_count(paths=None) -> int:
    """Number of ``# racelint: disable=`` escape hatches in the targets."""
    n = 0
    for f in _target_files(paths):
        n += len(_SUPPRESS_RE.findall(f.read_text()))
    return n
