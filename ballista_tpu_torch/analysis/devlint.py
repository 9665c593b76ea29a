"""AST lint for the card's hazards in the port's device programs (the
port's counterpart of ``ballista_tpu/analysis/jaxlint.py``).

Static, import-free analysis over the torch device programs that
``compilecache.registry.PROGRAMS`` declares, and the module-level
functions of the same module they call by name. It flags the coding
patterns that stall the card or make its results vary from run to run:

==================  =========================================================
rule                rationale
==================  =========================================================
host-sync           ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
                    ``bool()``/``int()``/``float()`` of a tensor expression,
                    a Python ``if``/``while``/``assert`` on a tensor value
                    (a reduction such as ``.any()``/``.all()``, a compare
                    of a tensor), and ``torch.cuda.synchronize``/
                    ``.synchronize()``: each waits for the card to drain its
                    queue and copies to the host, so the card idles while
                    the host decides. The counterpart of jaxlint's
                    ``host-sync`` and ``tracer-branch``.
dynamic-shape       ``torch.nonzero``/``torch.unique``/``torch.argwhere``/
                    ``masked_select``, one-argument ``torch.where`` and
                    boolean-mask indexing (``x[mask]``, ``x[mask] = v``)
                    have an output size that depends on the values: torch
                    syncs to learn it. Keep the capacity, clear validity
                    bits, or compact with a stable argsort of ``~valid``.
order-free-sum      ``index_add_``/``scatter_add_``/``scatter_reduce_(...,
                    "sum")`` and ``torch.cumsum`` of an operand that is not
                    statically an integer or bool: on the card these add
                    floats in an order that follows thread timing, so a
                    float result differs in its last bits from run to run
                    (20 bit patterns in 20 calls of ``torch.cumsum`` on one
                    6M-row f64 column). Float sums go through the one-hot
                    kernel or ``ops/prefix_sum``; integer ones are exact in
                    any order.
==================  =========================================================

No counterpart of jaxlint's ``missing-static``: eager torch takes shapes
as plain Python values at every call, so no argument is traced and none
needs declaring static.

An operand counts as integer when the source says so: a constant int, a
compare (bool), ``.to(torch.int64/int32/.../bool)``, ``.long()``/
``.int()``/``.bool()``, a constructor with an integer ``dtype=``,
``torch.arange``/``bincount``/``searchsorted``/``argsort``,
``torch.ones_like`` (and the other ``*_like``) of an integer operand, a
``cumsum`` with an integer ``dtype=``, and arithmetic, slicing and
``clamp`` of integer operands; a local is integer when every assignment
to it is. ``scatter_reduce_`` with ``reduce="amin"``/``"amax"`` is no
sum. The receiver of ``index_add_`` decides the sum's type as much as its
source does.

Scope rules that follow from how the port runs:

- a callee that the registry declares host-only
  (``compilecache.registry.HOST_ONLY``: host helpers and the kernels'
  plain versions, which run on CPU tensors only) is not followed;
- the body of an ``if <x>.device.type == "cpu":`` (and the ``else`` of
  ``!= "cpu"`` or ``== "cuda"``) runs on CPU tensors only and is not
  linted.

Suppression: append ``# devlint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the offending line, or to the ``def`` line of a
program or callee to suppress within the whole function. Suppressions
count against ``analysis/budget.py``.

Also exposed: :func:`device_program_report`, the source-derived list of
the port's device programs (the ``extern "C"`` entry points of
``csrc/*.cu``, the functions that launch them through their ctypes
library, and the public functions of the program modules) that
``compilecache.registry.check_vocabulary`` closes ``PROGRAMS`` over.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

RULES: dict[str, str] = {
    "host-sync": "host synchronization (.item()/.tolist()/.cpu()/.numpy()/"
    "bool()/int()/float() of a tensor, a branch on a tensor value, "
    "torch.cuda.synchronize) inside a device program",
    "dynamic-shape": "value-dependent output size (nonzero/unique/"
    "masked_select/1-arg where/boolean-mask indexing) inside a device "
    "program",
    "order-free-sum": "float sum whose order the card does not fix "
    "(index_add_/scatter_add_/scatter_reduce_ sum/cumsum of a non-integer "
    "operand) inside a device program",
}

_SUPPRESS_RE = re.compile(r"#\s*devlint:\s*disable=([A-Za-z0-9_,\- ]+)")

# the modules whose public functions are device programs: the substrate,
# the expression evaluator and the adaptive shrink
PROGRAM_MODULES = ("ops", "expr/physical.py", "exec/shrink.py")

_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DYNAMIC_SHAPE_CALLS = {
    "torch.nonzero", "torch.unique", "torch.unique_consecutive",
    "torch.masked_select", "torch.argwhere",
}
_DYNAMIC_SHAPE_METHODS = {"nonzero", "unique", "unique_consecutive", "masked_select"}
_SUM_METHODS = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
_REDUCE_METHODS = {"scatter_reduce_", "scatter_reduce"}
_ORDER_FREE_REDUCES = {"sum", "mean"}

# torch calls whose result is no tensor
_NON_TENSOR_TORCH = {
    "torch.device", "torch.dtype", "torch.Size", "torch.iinfo", "torch.finfo",
    "torch.is_tensor", "torch.get_default_dtype", "torch.promote_types",
    "torch.result_type",
}
# tensor methods whose result is a host value
_HOST_METHODS = {
    "numel", "dim", "size", "element_size", "data_ptr", "is_contiguous",
    "stride", "nelement", "get_device", "storage_offset", "is_floating_point",
    "item", "tolist", "numpy",
}
_REDUCTIONS = {
    "any", "all", "sum", "max", "min", "amax", "amin", "count_nonzero",
    "prod", "mean", "argmax", "argmin",
}
_INT_DTYPES = {
    "int8", "int16", "int32", "int64", "uint8", "bool", "long", "int",
    "short",
}
# methods that keep an integer receiver integer
_INT_PRESERVING = {
    "clamp", "clamp_", "clamp_min", "clamp_max", "view", "reshape", "flatten",
    "contiguous", "clone", "unsqueeze", "squeeze", "expand", "expand_as",
    "repeat", "t", "flip", "roll", "narrow", "index_select", "gather", "take",
    "masked_fill", "masked_fill_", "index_add_", "index_add", "scatter_",
    "scatter", "scatter_add_", "scatter_reduce_", "cumsum", "sum", "neg",
    "abs", "sub", "add", "mul", "diff", "repeat_interleave", "fill_", "zero_",
    "copy_", "sort", "to",
}
_INT_RESULT_METHODS = {
    "long", "int", "bool", "short", "byte", "char", "argsort", "argmax",
    "argmin", "nonzero", "count_nonzero", "bincount", "searchsorted", "numel",
}
_INT_PRESERVING_TORCH = {
    "torch.cumsum", "torch.clamp", "torch.abs", "torch.neg", "torch.flip",
    "torch.roll", "torch.diff", "torch.index_select", "torch.gather",
    "torch.take", "torch.repeat_interleave", "torch.zeros_like",
    "torch.ones_like", "torch.empty_like",
}
_BOOL_TORCH = {
    "torch.isnan", "torch.isinf", "torch.isfinite", "torch.logical_and",
    "torch.logical_or", "torch.logical_not", "torch.logical_xor",
    "torch.isin", "torch.eq", "torch.ne", "torch.lt", "torch.le", "torch.gt",
    "torch.ge",
}
_INT_RESULT_TORCH = {
    "torch.arange", "torch.randperm", "torch.searchsorted", "torch.argsort",
    "torch.argmax", "torch.argmin", "torch.nonzero", "torch.count_nonzero",
    "torch.bucketize",
} | _BOOL_TORCH
# attributes that hold a bool tensor in the port (DeviceBatch.valid)
_BOOL_ATTRS = {"valid"}


@dataclasses.dataclass(frozen=True)
class LintDiagnostic:
    file: str
    line: int
    rule: str
    message: str
    kernel: str = ""  # enclosing program or callee

    def __str__(self) -> str:
        where = f" [{self.kernel}]" if self.kernel else ""
        return f"{self.file}:{self.line}: {self.rule}{where}: {self.message}"


@dataclasses.dataclass
class DeviceProgram:
    """One linted function: a registered program or a callee of one."""

    name: str
    file: str
    line: int
    params: tuple[str, ...]
    hazards: tuple[LintDiagnostic, ...] = ()


def _dotted(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _suppressed(source_lines: list[str], lineno: int) -> frozenset[str]:
    line = source_lines[lineno - 1] if 0 < lineno <= len(source_lines) else ""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return frozenset()
    return frozenset(p.strip() for p in m.group(1).split(","))


def _dtype_kw(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def _int_dtype(node: ast.AST | None) -> bool | None:
    """True for ``torch.int64``-like dtypes, False for other ``torch.*``
    dtypes, None when the node names no dtype."""
    d = _dotted(node) if node is not None else None
    if d is None or not d.startswith("torch."):
        return None
    return d.split(".", 1)[1] in _INT_DTYPES


def _cpu_only_branch(test: ast.AST) -> str | None:
    """"body" when ``test`` holds only for CPU tensors
    (``x.device.type == "cpu"``, all conjuncts so), "orelse" when its
    negation does (``!= "cpu"``, ``== "cuda"``), else None."""
    tests = test.values if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And) else [test]
    sides = set()
    for t in tests:
        if not (
            isinstance(t, ast.Compare) and len(t.ops) == 1
            and isinstance(t.comparators[0], ast.Constant)
            and (_dotted(t.left) or "").endswith("device.type")
        ):
            return None
        value, op = t.comparators[0].value, t.ops[0]
        if (value, type(op)) == ("cpu", ast.Eq):
            sides.add("body")
        elif (value, type(op)) in (("cpu", ast.NotEq), ("cuda", ast.Eq)):
            sides.add("orelse")
        else:
            return None
    return sides.pop() if len(sides) == 1 else None


class _Types:
    """Flow-insensitive static types of one function's locals: which hold
    tensors, numpy arrays, integers or bool masks."""

    def __init__(self, fn: ast.FunctionDef):
        self.assigns: dict[str, list] = {}
        self.tensor_params: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                args = node.args
                for a in args.posonlyargs + args.args + args.kwonlyargs:
                    ann = _dotted(a.annotation) if getattr(a, "annotation", None) is not None else None
                    if ann in ("torch.Tensor", "Tensor"):
                        self.tensor_params.add(a.arg)
                    else:
                        self._set(a.arg, None)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    self._target(t, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._target(node.target, node.value)
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                self._set(node.target.id, ast.BinOp(ast.Name(node.target.id), node.op, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                self._target(node.target, None)
            elif isinstance(node, ast.NamedExpr):
                self._target(node.target, node.value)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        self._target(item.optional_vars, None)
        self._busy: set = set()

    def _set(self, name: str, value) -> None:
        self.assigns.setdefault(name, []).append(value)

    def _target(self, t, value) -> None:
        if isinstance(t, ast.Name):
            self._set(t.id, value)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e, None)
        elif isinstance(t, ast.Starred):
            self._target(t.value, None)

    def _name(self, name: str, tag: str, pred, combine) -> bool:
        """``combine`` (all/any) of ``pred`` over the assignments to
        ``name``. A name met again while it is being resolved (``x = f(x)``)
        counts as the identity of ``combine``: it keeps the type its other
        assignments give it."""
        vals = self.assigns.get(name)
        if not vals:
            return False
        if (tag, name) in self._busy:
            return combine is all
        self._busy.add((tag, name))
        try:
            return combine(v is not None and pred(v) for v in vals)
        finally:
            self._busy.discard((tag, name))

    # -- tensors and numpy arrays --------------------------------------------
    def is_numpy(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            d = _dotted(e.func) or ""
            if d.startswith(("np.", "numpy.")):
                return True
            return isinstance(e.func, ast.Attribute) and self.is_numpy(e.func.value)
        if isinstance(e, ast.Subscript):
            return self.is_numpy(e.value)
        if isinstance(e, ast.Name):
            return self._name(e.id, "numpy", self.is_numpy, all)
        return False

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tensor_params or self._name(
                e.id, "tensor", lambda v: not (isinstance(v, ast.Constant) and v.value is None) and self.is_tensor(v), any,
            )
        if isinstance(e, ast.Call):
            d = _dotted(e.func) or ""
            if d.startswith("torch."):
                return d not in _NON_TENSOR_TORCH and not d.startswith("torch.cuda.")
            if isinstance(e.func, ast.Attribute):
                recv, meth = e.func.value, e.func.attr
                if meth in _HOST_METHODS or self.is_numpy(recv):
                    return False
                return meth in _REDUCTIONS or self.is_tensor(recv)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr in _BOOL_ATTRS or (e.attr in ("T", "mT", "indices") and self.is_tensor(e.value))
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False

    # -- integer (or bool) operands ------------------------------------------
    def is_int(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Constant):
            return isinstance(e.value, (bool, int))
        if isinstance(e, ast.Compare):
            return True
        if isinstance(e, ast.Name):
            return self._name(e.id, "int", self.is_int, all)
        if isinstance(e, ast.Attribute):
            if e.attr in _BOOL_ATTRS or e.attr in ("shape", "capacity", "indices"):
                return True
            return e.attr in ("T", "mT") and self.is_int(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_int(e.value)
        if isinstance(e, ast.BinOp):
            return not isinstance(e.op, ast.Div) and self.is_int(e.left) and self.is_int(e.right)
        if isinstance(e, ast.UnaryOp):
            return isinstance(e.op, ast.Not) or self.is_int(e.operand)
        if isinstance(e, ast.IfExp):
            return self.is_int(e.body) and self.is_int(e.orelse)
        if isinstance(e, (ast.List, ast.Tuple)):
            return bool(e.elts) and all(self.is_int(x) for x in e.elts)
        if isinstance(e, ast.Call):
            return self._int_call(e)
        return False

    def _int_call(self, e: ast.Call) -> bool:
        declared = _int_dtype(_dtype_kw(e))
        if declared is not None:
            return declared
        d = _dotted(e.func) or ""
        if d in ("int", "len", "bool"):
            return True
        if isinstance(e.func, ast.Attribute) and not d.startswith("torch."):
            recv, meth = e.func.value, e.func.attr
            if meth == "to" and e.args:
                as_dtype = _int_dtype(e.args[0])
                if as_dtype is not None:
                    return as_dtype
                return self.is_int(recv)
            if meth in _INT_RESULT_METHODS:
                return True
            return meth in _INT_PRESERVING and self.is_int(recv)
        if d in _INT_RESULT_TORCH:
            return not (d == "torch.arange" and any(
                isinstance(a, ast.Constant) and isinstance(a.value, float) for a in e.args
            ))
        if d == "torch.bincount":
            return not any(kw.arg == "weights" for kw in e.keywords) and len(e.args) < 2
        if d == "torch.full" and len(e.args) >= 2:
            return self.is_int(e.args[1])
        if d == "torch.full_like" and len(e.args) >= 2:
            return self.is_int(e.args[0]) and self.is_int(e.args[1])
        if d in ("torch.where", "torch.minimum", "torch.maximum"):
            args = e.args[1:] if d == "torch.where" else e.args
            return len(args) == 2 and all(self.is_int(a) for a in args)
        if d in ("torch.cat", "torch.stack") and e.args:
            return self.is_int(e.args[0])
        if d in _INT_PRESERVING_TORCH and e.args:
            return self.is_int(e.args[0])
        return False

    # -- bool masks ------------------------------------------------------------
    def is_bool(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops)
        if isinstance(e, ast.Name):
            return self._name(e.id, "bool", self.is_bool, all)
        if isinstance(e, ast.Attribute):
            return e.attr in _BOOL_ATTRS
        if isinstance(e, ast.Subscript):
            return self.is_bool(e.value)
        if isinstance(e, ast.UnaryOp):
            return isinstance(e.op, ast.Invert) and self.is_bool(e.operand)
        if isinstance(e, ast.BinOp):
            return isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)) and (
                self.is_bool(e.left) and self.is_bool(e.right)
            )
        if isinstance(e, ast.Call):
            d = _dotted(e.func) or ""
            dt = _dotted(_dtype_kw(e)) if _dtype_kw(e) is not None else None
            if dt is not None:
                return dt == "torch.bool"
            if d in _BOOL_TORCH:
                return True
            if isinstance(e.func, ast.Attribute) and not d.startswith("torch."):
                meth = e.func.attr
                if meth == "to" and e.args:
                    return _dotted(e.args[0]) == "torch.bool"
                if meth in ("bool", "isnan", "isinf", "isfinite", "logical_not", "logical_and",
                            "logical_or", "eq", "ne", "lt", "le", "gt", "ge", "isin"):
                    return True
                return meth in ("clone", "contiguous", "view", "reshape", "flatten", "expand",
                                "expand_as", "unsqueeze", "squeeze") and self.is_bool(e.func.value)
            if d in ("torch.zeros_like", "torch.ones_like", "torch.empty_like") and e.args:
                return self.is_bool(e.args[0])
            if d == "torch.where" and len(e.args) == 3:
                return self.is_bool(e.args[1]) and self.is_bool(e.args[2])
        return False


class _ProgramLinter(ast.NodeVisitor):
    """Lints ONE device program (or callee) body."""

    def __init__(self, fn: ast.FunctionDef, file: str, source_lines: list[str]):
        self.fn = fn
        self.file = file
        self.lines = source_lines
        args = fn.args
        self.params = tuple(
            a.arg
            for a in (args.posonlyargs + args.args + args.kwonlyargs)
            if a.arg not in ("self", "cls")
        )
        self.types = _Types(fn)
        self.fn_suppress = _suppressed(source_lines, fn.lineno)
        self.diags: list[LintDiagnostic] = []

    def _emit(self, rule: str, lineno: int, message: str) -> None:
        sup = _suppressed(self.lines, lineno) | self.fn_suppress
        if rule in sup or "all" in sup:
            return
        self.diags.append(LintDiagnostic(self.file, lineno, rule, message, self.fn.name))

    # -- branches ----------------------------------------------------------------
    def _branch(self, node, what: str) -> None:
        if self.types.is_tensor(node.test):
            self._emit("host-sync", node.lineno, f"{what} on a tensor value waits for the card")

    def visit_If(self, node: ast.If) -> None:
        cpu = _cpu_only_branch(node.test)
        if cpu is None:
            self._branch(node, "if-branch")
        self.visit(node.test)
        for side in ("body", "orelse"):
            if side != cpu:
                for stmt in getattr(node, side):
                    self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self._branch(node, "while-loop")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._branch(node, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._branch(node, "conditional expression")
        self.generic_visit(node)

    # -- subscripts --------------------------------------------------------------
    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.types.is_bool(node.slice) and not self.types.is_numpy(node.value):
            self._emit(
                "dynamic-shape", node.lineno,
                "boolean-mask indexing has a value-dependent size (torch syncs for it)",
            )
        self.generic_visit(node)

    # -- calls ---------------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func) or ""
        t = self.types
        meth = node.func.attr if isinstance(node.func, ast.Attribute) else None
        recv = node.func.value if meth is not None else None
        if meth in _HOST_SYNC_METHODS and not node.args and not t.is_numpy(recv):
            self._emit("host-sync", node.lineno, f".{meth}() copies to the host and waits for the card")
        if d == "torch.cuda.synchronize" or (meth == "synchronize" and not d.startswith("torch.cuda.")):
            self._emit("host-sync", node.lineno, f"{d or '.synchronize'}() waits for the card")
        if (
            isinstance(node.func, ast.Name) and node.func.id in ("float", "int", "bool")
            and node.args and t.is_tensor(node.args[0])
        ):
            self._emit(
                "host-sync", node.lineno,
                f"{node.func.id}() of a tensor copies it to the host and waits for the card",
            )
        if d in _DYNAMIC_SHAPE_CALLS or (
            meth in _DYNAMIC_SHAPE_METHODS and not d.startswith("torch.") and not t.is_numpy(recv)
        ):
            self._emit("dynamic-shape", node.lineno, f"{d or meth}() has a value-dependent output size")
        if d == "torch.where" and len(node.args) == 1 and not node.keywords:
            self._emit(
                "dynamic-shape", node.lineno,
                "one-argument torch.where() has a value-dependent output size",
            )
        self._order_free(node, d, meth, recv)
        self.generic_visit(node)

    def _order_free(self, node: ast.Call, d: str, meth: str | None, recv) -> None:
        t = self.types
        args = node.args
        kw = {k.arg: k.value for k in node.keywords}
        if d.startswith("torch.") and d != "torch.cumsum":
            # torch.index_add(input, dim, index, source): the method's form
            name = d.split(".", 1)[1]
            if name in _SUM_METHODS | _REDUCE_METHODS and args:
                meth, recv, args = name, args[0], args[1:]
            else:
                meth = None
        if meth in _SUM_METHODS:
            src = args[2] if len(args) > 2 else kw.get("source", kw.get("src"))
            if not (t.is_int(recv) or (src is not None and t.is_int(src))):
                self._emit(
                    "order-free-sum", node.lineno,
                    f"{meth}() of a non-integer operand adds floats in no fixed order on the card",
                )
        elif meth in _REDUCE_METHODS:
            reduce = args[3] if len(args) > 3 else kw.get("reduce")
            src = args[2] if len(args) > 2 else kw.get("src")
            if (
                isinstance(reduce, ast.Constant) and reduce.value in _ORDER_FREE_REDUCES
                and not (t.is_int(recv) or (src is not None and t.is_int(src)))
            ):
                self._emit(
                    "order-free-sum", node.lineno,
                    f'{meth}(..., "{reduce.value}") of a non-integer operand adds floats in no '
                    "fixed order on the card",
                )
        if d == "torch.cumsum" or (meth == "cumsum" and not d.startswith("torch.")):
            operand = args[0] if d == "torch.cumsum" and args else recv
            declared = _int_dtype(_dtype_kw(node))
            if not (declared or (declared is None and operand is not None and t.is_int(operand))):
                self._emit(
                    "order-free-sum", node.lineno,
                    "cumsum of a non-integer operand adds floats in no fixed order on the card",
                )


def _module_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _callees(fn: ast.FunctionDef, names) -> list[str]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in names:
            if node.func.id not in out:
                out.append(node.func.id)
    return out


def lint_source(
    source: str, filename: str = "<string>", programs=None, module: str = "",
    host_only=frozenset(),
) -> tuple[list[LintDiagnostic], list[DeviceProgram]]:
    """Lint one module's source. ``programs`` names its device programs
    (None: every module-level function); they and the module-level
    functions they call by name are linted, except callees whose
    ``<module>.<name>`` is in ``host_only``. Returns (diagnostics, linted
    functions)."""
    tree = ast.parse(source, filename=filename)
    lines = source.splitlines()
    funcs = _module_functions(tree)
    todo = [n for n in (funcs if programs is None else programs) if n in funcs]
    seen: set[str] = set()
    diags: list[LintDiagnostic] = []
    linted: list[DeviceProgram] = []
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        fn = funcs[name]
        linter = _ProgramLinter(fn, filename, lines)
        for stmt in fn.body:
            linter.visit(stmt)
        linted.append(DeviceProgram(name, filename, fn.lineno, linter.params, tuple(linter.diags)))
        diags.extend(linter.diags)
        todo.extend(
            c for c in _callees(fn, funcs)
            if c not in seen and f"{module}.{c}" not in host_only
        )
    return diags, linted


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent


def _module_key(path: pathlib.Path, root: pathlib.Path) -> str:
    return ".".join(path.relative_to(root).with_suffix("").parts)


def _registry_targets(root: pathlib.Path) -> dict[pathlib.Path, list[str]]:
    """file -> the registered torch programs it holds."""
    from ballista_tpu_torch.compilecache import registry

    out: dict[pathlib.Path, list[str]] = {}
    for name, spec in sorted(registry.PROGRAMS.items()):
        if spec.route != "torch":
            continue
        module, _, fn = name.rpartition(".")
        out.setdefault(root / (module.replace(".", "/") + ".py"), []).append(fn)
    return out


def lint_paths(paths=None) -> list[LintDiagnostic]:
    """Lint the registered device programs (default), or every
    module-level function of ``paths`` (files or directories)."""
    from ballista_tpu_torch.compilecache import registry

    root = _package_root()
    diags: list[LintDiagnostic] = []
    if paths is None:
        for f, programs in _registry_targets(root).items():
            d, _ = lint_source(
                f.read_text(), _rel(f), programs, _module_key(f, root), frozenset(registry.HOST_ONLY),
            )
            diags.extend(d)
        return diags
    for f in _files(paths):
        d, _ = lint_source(f.read_text(), _rel(f))
        diags.extend(d)
    return diags


def _files(paths) -> list[pathlib.Path]:
    out = []
    for p in paths:
        p = pathlib.Path(p)
        out.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return out


def _rel(f: pathlib.Path) -> str:
    root = _package_root().parent
    return str(f.relative_to(root)) if f.is_relative_to(root) else str(f)


# an extern "C" entry point: a definition that starts a line
_ENTRY_RE = re.compile(r"^[A-Za-z_][\w \t\*]*?[\s\*]([A-Za-z_]\w*)\s*\(", re.MULTILINE)


def _extern_entries(text: str) -> list[tuple[str, int]]:
    start = text.find('extern "C"')
    if start < 0:
        return []
    return [
        (m.group(1), text.count("\n", 0, m.start()) + 1)
        for m in _ENTRY_RE.finditer(text, start)
    ]


def _ctypes_calls(fn: ast.FunctionDef, entries) -> list[str]:
    """The extern "C" entries ``fn`` calls through a ctypes library (a
    receiver whose name ends in ``lib``)."""
    out = []
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in entries
            and (_dotted(node.func.value) or "").rsplit(".", 1)[-1].endswith("lib")
            and node.func.attr not in out
        ):
            out.append(node.func.attr)
    return sorted(out)


def program_files(root: pathlib.Path | None = None) -> list[pathlib.Path]:
    root = root or _package_root()
    out: list[pathlib.Path] = []
    for m in PROGRAM_MODULES:
        p = root / m
        out.extend(sorted(p.glob("*.py")) if p.is_dir() else [p])
    return [f for f in out if f.name != "__init__.py"]


def device_program_report(root=None) -> dict[str, dict]:
    """The port's device programs as the source shows them:
    ``{"cuda.<entry>": {"file", "line"}}`` for every ``extern "C"`` entry
    point of ``csrc/*.cu``, and ``{"<module>.<function>": {"file", "line",
    "params", "launches"}}`` for every public module-level function of
    :data:`PROGRAM_MODULES` and every function there that calls an entry
    point through its ctypes library (``launches``: the entries)."""
    from ballista_tpu_torch.compilecache import registry

    root = pathlib.Path(root) if root is not None else _package_root()
    report: dict[str, dict] = {}
    for cu in sorted((root / "csrc").glob("*.cu")):
        for name, line in _extern_entries(cu.read_text()):
            report[f"cuda.{name}"] = {"file": _rel(cu), "line": line}
    kernels = {
        k.split(".", 1)[1] for k in report
        if k not in registry.HOST_ONLY
    }
    for f in program_files(root):
        tree = ast.parse(f.read_text(), filename=str(f))
        for fn in _module_functions(tree).values():
            launches = _ctypes_calls(fn, kernels)
            if fn.name.startswith("_") and not launches:
                continue
            args = fn.args
            report[f"{_module_key(f, root)}.{fn.name}"] = {
                "file": _rel(f),
                "line": fn.lineno,
                "params": [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs],
                "launches": [f"cuda.{e}" for e in launches],
            }
    return report


def suppression_count(paths=None) -> int:
    """Number of ``# devlint: disable=`` escape hatches in the program
    files (the shared budget ledger holds it)."""
    files = program_files() if paths is None else _files(paths)
    return sum(len(_SUPPRESS_RE.findall(f.read_text())) for f in files)
