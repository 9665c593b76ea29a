"""Compile logical expressions into torch evaluators.

The port of ``ballista_tpu/expr/physical.py``. A compiled expression
evaluates against a :class:`~ballista_tpu_torch.columnar.batch.DeviceBatch`
and returns a :class:`ColumnValue`: one tensor of the batch's capacity, an
optional null mask, and a host dictionary for STRING results. Evaluation is
eager; string predicates are resolved on the host against the sorted
dictionary and become integer compares on the device.

SQL three-valued logic: AND/OR use Kleene semantics; comparisons and
arithmetic propagate null as the OR of the operand nulls.

Every expression kind of the reference is ported. Host-side tables over a
dictionary (LIKE, ``substr``) are built once per (dictionary, pattern) and
kept on the device beside the dictionary (``dict_util.memo``), so a warm
query gathers by code without rebuilding or uploading them. A plugin UDF's body
(``plugin.py``) runs eagerly on the argument tensors, on the batch's
device, and must return one value a row there.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ballista_tpu_torch.columnar import dict_util
from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.datatypes import DataType, Schema, common_type
from ballista_tpu_torch.errors import ExecutionError, PlanError
from ballista_tpu_torch.expr import logical as L

@dataclasses.dataclass
class ColumnValue:
    """One evaluated expression column (capacity-length tensor)."""

    values: torch.Tensor
    nulls: torch.Tensor | None
    dtype: DataType
    dictionary: Dictionary | None = None


def _or_nulls(*masks: torch.Tensor | None) -> torch.Tensor | None:
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out | m)
    return out


class PhysExpr:
    """A compiled expression: static dtype + evaluate(batch)."""

    def __init__(self, dtype: DataType, fn, display: str):
        self.dtype = dtype
        self._fn = fn
        self.display = display

    def evaluate(self, batch: DeviceBatch) -> ColumnValue:
        return self._fn(batch)

    def __repr__(self) -> str:
        return f"PhysExpr({self.display})"


def compile_expr(expr: L.Expr, schema: Schema) -> PhysExpr:
    """Logical expression -> torch evaluator against ``schema`` batches."""
    dtype = expr.data_type(schema)
    return PhysExpr(dtype, _compile(expr, schema), expr.name())


def _compile(expr: L.Expr, schema: Schema):
    if isinstance(expr, L.Alias):
        return _compile(expr.expr, schema)
    if isinstance(expr, L.Column):
        return _compile_column(expr, schema)
    if isinstance(expr, L.Literal):
        return _compile_literal(expr)
    if isinstance(expr, L.IntervalLiteral):
        return _compile_interval(expr)
    if isinstance(expr, L.BinaryExpr):
        return _compile_binary(expr, schema)
    if isinstance(expr, L.Not):
        return _compile_not(expr, schema)
    if isinstance(expr, L.Negative):
        return _compile_negative(expr, schema)
    if isinstance(expr, (L.IsNull, L.IsNotNull)):
        return _compile_is_null(expr, schema)
    if isinstance(expr, L.Cast):
        return _compile_cast(expr, schema)
    if isinstance(expr, L.Case):
        return _compile_case(expr, schema)
    if isinstance(expr, L.Between):
        low = L.BinaryExpr(expr.expr, L.Operator.GTEQ, expr.low)
        high = L.BinaryExpr(expr.expr, L.Operator.LTEQ, expr.high)
        both: L.Expr = L.BinaryExpr(low, L.Operator.AND, high)
        if expr.negated:
            both = L.Not(both)
        return _compile(both, schema)
    if isinstance(expr, L.InList):
        return _compile_in_list(expr, schema)
    if isinstance(expr, L.Like):
        return _compile_like(expr, schema)
    if isinstance(expr, L.ScalarFunction):
        return _compile_scalar_fn(expr, schema)
    if isinstance(expr, L.AggregateExpr):
        raise PlanError(
            f"aggregate {expr.name()} cannot be compiled as a row expression; "
            "the physical planner must split it into an Aggregate operator"
        )
    raise PlanError(f"cannot compile expression {expr!r}")


# -- leaves -------------------------------------------------------------------


def _compile_column(expr: L.Column, schema: Schema):
    idx = L.resolve_field_index(schema, expr.cname)
    field = schema.fields[idx]

    def fn(batch: DeviceBatch) -> ColumnValue:
        d = None
        if field.dtype == DataType.STRING:
            d = batch.dictionaries.get(batch.schema.fields[idx].name)
        return ColumnValue(batch.columns[idx], batch.nulls[idx], field.dtype, d)

    return fn


def _compile_literal(expr: L.Literal):
    dtype = expr.dtype

    def fn(batch: DeviceBatch) -> ColumnValue:
        cap, dev = batch.capacity, batch.device
        if expr.value is None:
            if dtype == DataType.NULL:
                return ColumnValue(
                    torch.zeros(cap, dtype=torch.bool, device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev),
                    DataType.NULL,
                )
            # typed NULL: carrier zeros of the declared dtype, all null
            return ColumnValue(
                torch.zeros(cap, dtype=dtype.to_torch(), device=dev),
                torch.ones(cap, dtype=torch.bool, device=dev),
                dtype,
                Dictionary(()) if dtype == DataType.STRING else None,
            )
        if dtype == DataType.STRING:
            return ColumnValue(
                torch.zeros(cap, dtype=torch.int32, device=dev), None, dtype,
                Dictionary((expr.value,)),
            )
        return ColumnValue(
            torch.full((cap,), expr.value, dtype=dtype.to_torch(), device=dev),
            None,
            dtype,
        )

    return fn


def _compile_interval(expr: L.IntervalLiteral):
    if expr.months:
        raise PlanError(
            f"{expr.name()} with months reached device compilation; "
            "month intervals must be constant-folded against date literals"
        )

    def fn(batch: DeviceBatch) -> ColumnValue:
        return ColumnValue(
            torch.full((batch.capacity,), expr.days, dtype=torch.int32, device=batch.device),
            None,
            DataType.INT32,
        )

    return fn


# -- binary -------------------------------------------------------------------

_CMP = {
    L.Operator.EQ: lambda a, b: a == b,
    L.Operator.NEQ: lambda a, b: a != b,
    L.Operator.LT: lambda a, b: a < b,
    L.Operator.LTEQ: lambda a, b: a <= b,
    L.Operator.GT: lambda a, b: a > b,
    L.Operator.GTEQ: lambda a, b: a >= b,
}

_ARITH = {
    L.Operator.PLUS: torch.add,
    L.Operator.MINUS: torch.sub,
    L.Operator.MULTIPLY: torch.mul,
}


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL integer division truncates toward zero; a zero divisor gives 0
    (the reference's safe divisor)."""
    safe_b = torch.where(b == 0, torch.ones_like(b), b)
    q = torch.div(a.abs(), safe_b.abs(), rounding_mode="floor")
    return torch.where((a < 0) != (b < 0), -q, q).to(a.dtype)


def _compile_binary(expr: L.BinaryExpr, schema: Schema):
    op = expr.op
    lf = _compile(expr.left, schema)
    rf = _compile(expr.right, schema)
    lt = expr.left.data_type(schema)
    rt = expr.right.data_type(schema)

    if op.is_logical:
        return _compile_logical(op, lf, rf)
    if DataType.STRING in (lt, rt) and op.is_comparison:
        return _compile_string_cmp(op, lf, rf, lt, rt)
    if DataType.STRING in (lt, rt):
        raise PlanError(f"arithmetic on strings: {expr.name()}")

    out_dtype = expr.data_type(schema)

    def fn(batch: DeviceBatch) -> ColumnValue:
        lv = lf(batch)
        rv = rf(batch)
        nulls = _or_nulls(lv.nulls, rv.nulls)
        a, b = lv.values, rv.values
        if op.is_comparison:
            td = common_type(lt, rt).to_torch()
            return ColumnValue(_CMP[op](a.to(td), b.to(td)), nulls, DataType.BOOL)
        td = out_dtype.to_torch()
        a, b = a.to(td), b.to(td)
        if op == L.Operator.DIVIDE:
            if out_dtype.is_integer:
                return ColumnValue(_trunc_div(a, b), nulls, out_dtype)
            return ColumnValue(a / b, nulls, out_dtype)
        if op == L.Operator.MODULO:
            safe = torch.where(b == 0, torch.ones_like(b), b)
            return ColumnValue(a - _trunc_div(a, safe) * safe, nulls, out_dtype)
        return ColumnValue(_ARITH[op](a, b).to(td), nulls, out_dtype)

    return fn


def _compile_logical(op: L.Operator, lf, rf):
    """Kleene three-valued AND/OR."""

    def fn(batch: DeviceBatch) -> ColumnValue:
        lv = lf(batch)
        rv = rf(batch)
        a = lv.values.to(torch.bool)
        b = rv.values.to(torch.bool)
        ln, rn = lv.nulls, rv.nulls
        if op == L.Operator.AND:
            vals = a & b
        else:
            vals = a | b
        if ln is None and rn is None:
            return ColumnValue(vals, None, DataType.BOOL)
        ln_ = ln if ln is not None else torch.zeros_like(a)
        rn_ = rn if rn is not None else torch.zeros_like(a)
        if op == L.Operator.AND:
            # NULL unless the other side is definite FALSE
            nulls = (ln_ & (rn_ | b)) | (rn_ & (ln_ | a))
        else:
            # NULL unless the other side is definite TRUE
            nulls = (ln_ & (rn_ | ~b)) | (rn_ & (ln_ | ~a))
        return ColumnValue(vals, nulls, DataType.BOOL)

    return fn


def _compile_string_cmp(op: L.Operator, lf, rf, lt: DataType, rt: DataType):
    """String comparison by dictionary code: col-vs-literal resolves the
    literal against the column's sorted dictionary with bisect; col-vs-col
    remaps both sides onto a merged dictionary and compares codes."""
    if not (lt == DataType.STRING and rt == DataType.STRING):
        raise PlanError("string compared against non-string")

    def fn(batch: DeviceBatch) -> ColumnValue:
        lv = lf(batch)
        rv = rf(batch)
        nulls = _or_nulls(lv.nulls, rv.nulls)
        ld, rd = lv.dictionary, rv.dictionary
        if ld is None or rd is None:
            raise PlanError("string column without dictionary in comparison")
        # a literal is the only producer of a one-value dictionary
        if len(rd) == 1:
            return ColumnValue(
                _cmp_codes_vs_literal(op, lv.values, ld, rd.values[0]),
                nulls, DataType.BOOL,
            )
        if len(ld) == 1:
            flipped = {
                L.Operator.LT: L.Operator.GT,
                L.Operator.LTEQ: L.Operator.GTEQ,
                L.Operator.GT: L.Operator.LT,
                L.Operator.GTEQ: L.Operator.LTEQ,
            }.get(op, op)
            return ColumnValue(
                _cmp_codes_vs_literal(flipped, rv.values, rd, ld.values[0]),
                nulls, DataType.BOOL,
            )
        if ld.values == rd.values:
            lcodes, rcodes = lv.values, rv.values
        else:
            _, (ra, rb) = dict_util.merge_many((ld, rd))
            lcodes = dict_util.remap_codes(lv.values, ra)
            rcodes = dict_util.remap_codes(rv.values, rb)
        return ColumnValue(_CMP[op](lcodes, rcodes), nulls, DataType.BOOL)

    return fn


def _cmp_codes_vs_literal(
    op: L.Operator, codes: torch.Tensor, d: Dictionary, s: str
) -> torch.Tensor:
    if op in (L.Operator.EQ, L.Operator.NEQ):
        i = d.index_of(s)
        if i < 0:
            return torch.full_like(codes, op == L.Operator.NEQ, dtype=torch.bool)
        return codes == i if op == L.Operator.EQ else codes != i
    if op == L.Operator.LT:
        return codes < dict_util.bisect_left(d, s)
    if op == L.Operator.LTEQ:
        return codes < dict_util.bisect_right(d, s)
    if op == L.Operator.GT:
        return codes >= dict_util.bisect_right(d, s)
    if op == L.Operator.GTEQ:
        return codes >= dict_util.bisect_left(d, s)
    raise PlanError(f"unsupported string comparison {op}")


# -- unary / null checks ------------------------------------------------------


def _compile_not(expr: L.Not, schema: Schema):
    f = _compile(expr.expr, schema)

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        return ColumnValue(~v.values.to(torch.bool), v.nulls, DataType.BOOL)

    return fn


def _compile_negative(expr: L.Negative, schema: Schema):
    f = _compile(expr.expr, schema)
    dtype = expr.data_type(schema)

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        return ColumnValue(-v.values, v.nulls, dtype)

    return fn


def _compile_is_null(expr, schema: Schema):
    f = _compile(expr.expr, schema)
    want_null = isinstance(expr, L.IsNull)

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        if v.nulls is None:
            out = torch.full_like(v.values, not want_null, dtype=torch.bool)
            return ColumnValue(out, None, DataType.BOOL)
        return ColumnValue(v.nulls if want_null else ~v.nulls, None, DataType.BOOL)

    return fn


def _compile_cast(expr: L.Cast, schema: Schema):
    f = _compile(expr.expr, schema)
    src = expr.expr.data_type(schema)
    dst = expr.to

    if src == DataType.STRING and dst != DataType.STRING:
        # parse the dictionary values on the host; codes gather the table
        def fn(batch: DeviceBatch) -> ColumnValue:
            v = f(batch)
            if v.dictionary is None:
                raise PlanError("cast of string column without dictionary")
            table = np.asarray(
                [_parse_scalar(s, dst) for s in v.dictionary.values],
                dtype=dst.to_np(),
            )
            if len(table) == 0:
                vals = torch.zeros_like(v.values, dtype=dst.to_torch())
            else:
                t = torch.from_numpy(table).to(v.values.device)
                vals = t[v.values.clamp(0, len(table) - 1).long()]
            return ColumnValue(vals, v.nulls, dst)

        return fn

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        if src == dst:
            return v
        if dst == DataType.STRING:
            raise PlanError(f"cast {src.value} -> string is not supported")
        if src == DataType.DATE32 and dst == DataType.TIMESTAMP_US:
            vals = v.values.to(torch.int64) * 86_400_000_000
        elif src == DataType.TIMESTAMP_US and dst == DataType.DATE32:
            vals = torch.div(
                v.values, 86_400_000_000, rounding_mode="floor"
            ).to(torch.int32)
        else:
            vals = v.values
            if dst.is_integer and src.is_floating:
                vals = torch.trunc(vals)  # SQL casts truncate
            vals = vals.to(dst.to_torch())
        return ColumnValue(vals, v.nulls, dst)

    return fn


def _parse_scalar(s: str, dtype: DataType):
    if dtype.is_integer:
        return int(float(s))
    if dtype.is_floating:
        return float(s)
    if dtype == DataType.BOOL:
        return s.strip().lower() in ("true", "t", "1", "yes")
    if dtype == DataType.DATE32:
        import datetime

        return (
            datetime.date.fromisoformat(s.strip()) - datetime.date(1970, 1, 1)
        ).days
    raise PlanError(f"cannot parse string as {dtype}")


# -- CASE ---------------------------------------------------------------------


def _compile_case(expr: L.Case, schema: Schema):
    out_dtype = expr.data_type(schema)
    conds = [_compile(c, schema) for c, _ in expr.branches]
    vals = [_compile(v, schema) for _, v in expr.branches]
    other = _compile(expr.otherwise, schema) if expr.otherwise is not None else None
    if out_dtype == DataType.STRING:
        raise PlanError("CASE producing strings is not supported on device yet")
    td = out_dtype.to_torch()

    def parts(v: ColumnValue, cap: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
        # (values, nulls) of a branch; an untyped NULL is all null
        if v.dtype == DataType.NULL:
            return (
                torch.zeros(cap, dtype=td, device=dev),
                torch.ones(cap, dtype=torch.bool, device=dev),
            )
        nulls = v.nulls if v.nulls is not None else torch.zeros(cap, dtype=torch.bool, device=dev)
        return v.values.to(td), nulls

    def fn(batch: DeviceBatch) -> ColumnValue:
        cap, dev = batch.capacity, batch.device
        cvs = [c(batch) for c in conds]
        vvs = [v(batch) for v in vals]
        if other is not None:
            acc, acc_null = parts(other(batch), cap, dev)
        else:  # no ELSE: NULL
            acc = torch.zeros(cap, dtype=td, device=dev)
            acc_null = torch.ones(cap, dtype=torch.bool, device=dev)
        # fold from the last WHEN to the first, so earlier branches win
        for cv, vv in zip(reversed(cvs), reversed(vvs)):
            hit = cv.values.to(torch.bool)
            if cv.nulls is not None:
                hit = hit & ~cv.nulls  # a NULL condition is no match
            bv, bn = parts(vv, cap, dev)
            acc = torch.where(hit, bv, acc)
            acc_null = torch.where(hit, bn, acc_null)
        return ColumnValue(acc, acc_null, out_dtype)

    return fn


# -- IN / LIKE ----------------------------------------------------------------


def _isin(values: torch.Tensor, targets: list) -> torch.Tensor:
    """``values`` in ``targets`` (host scalars): one compare per target, so
    no table is uploaded per batch."""
    hit = torch.zeros_like(values, dtype=torch.bool)
    for t in targets:
        hit |= values == t
    return hit


def _compile_in_list(expr: L.InList, schema: Schema):
    et = expr.expr.data_type(schema)
    f = _compile(expr.expr, schema)
    lits = []
    for v in expr.values:
        if not isinstance(v, L.Literal):
            raise PlanError("IN list values must be literals")
        lits.append(v.value)
    if et != DataType.STRING:
        # the literals take the column's type, as the reference casts them
        targets = np.asarray(lits, dtype=et.to_np()).tolist()

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        if et == DataType.STRING:
            if v.dictionary is None:
                raise PlanError("string IN without dictionary")
            # a literal missing from the dictionary matches nothing
            codes = [c for c in (v.dictionary.index_of(s) for s in lits) if c >= 0]
            hit = _isin(v.values, codes)
        else:
            hit = _isin(v.values, targets)
        if expr.negated:
            hit = ~hit
        # NOT IN keeps the input's nulls, as IN does
        return ColumnValue(hit, v.nulls, DataType.BOOL)

    return fn


def like_to_regex(pattern: str) -> "re.Pattern[str]":
    """SQL LIKE pattern -> anchored regex (% = .*, _ = .)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _compile_like(expr: L.Like, schema: Schema):
    if expr.expr.data_type(schema) != DataType.STRING:
        raise PlanError("LIKE on non-string column")
    f = _compile(expr.expr, schema)
    rx = like_to_regex(expr.pattern)

    def fn(batch: DeviceBatch) -> ColumnValue:
        v = f(batch)
        d = v.dictionary
        if d is None:
            raise PlanError("LIKE on string column without dictionary")

        def table() -> torch.Tensor:
            # the pattern's verdict on every dictionary value, on the device
            t = np.fromiter((rx.match(s) is not None for s in d.values), dtype=bool, count=len(d))
            if expr.negated:
                t = ~t
            return torch.from_numpy(t).to(v.values.device)

        t = dict_util.memo(("like", expr.pattern, expr.negated, str(v.values.device)), (d,), table)
        if len(t) == 0:
            hit = torch.zeros_like(v.values, dtype=torch.bool)
        else:
            hit = t[v.values.clamp(0, len(t) - 1).long()]
        return ColumnValue(hit, v.nulls, DataType.BOOL)

    return fn


# -- scalar functions ---------------------------------------------------------


def _compile_scalar_fn(expr: L.ScalarFunction, schema: Schema):
    name = expr.fname
    args = [_compile(a, schema) for a in expr.args]
    out_dtype = expr.data_type(schema)
    td = out_dtype.to_torch()

    if name in ("extract_year", "extract_month", "extract_day"):
        part = ("year", "month", "day").index(name.split("_")[1])
        src = expr.args[0].data_type(schema)

        def fn(batch: DeviceBatch) -> ColumnValue:
            v = args[0](batch)
            days = v.values
            if src == DataType.TIMESTAMP_US:
                days = torch.div(days, 86_400_000_000, rounding_mode="floor")
            return ColumnValue(
                civil_from_days(days.to(torch.int32))[part], v.nulls, DataType.INT32
            )

        return fn

    if name == "coalesce":

        def fn(batch: DeviceBatch) -> ColumnValue:
            vs = [a(batch) for a in args]
            acc = vs[-1].values.to(td)
            acc_null = vs[-1].nulls
            for v in reversed(vs[:-1]):
                if v.nulls is None:
                    acc, acc_null = v.values.to(td), None
                    continue
                acc = torch.where(v.nulls, acc, v.values.to(td))
                if acc_null is None:
                    acc_null = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
                acc_null = v.nulls & acc_null
            return ColumnValue(acc, acc_null, out_dtype)

        return fn

    if name == "substr":
        for a in expr.args[1:]:
            if not isinstance(a, L.Literal):
                raise PlanError("substr start/length must be literals")
        start = expr.args[1].value  # SQL substr is 1-based
        length = expr.args[2].value if len(expr.args) > 2 else None
        stop = None if length is None else start - 1 + length

        def fn(batch: DeviceBatch) -> ColumnValue:
            v = args[0](batch)
            d = v.dictionary
            if d is None:
                raise PlanError("substr on string column without dictionary")

            def cut() -> tuple[Dictionary, torch.Tensor]:
                # a new sorted dictionary of the cut strings, and the remap
                # of the old codes onto it (on the device)
                strs = [s[start - 1 : stop] for s in d.values]
                uniq = tuple(sorted(set(strs)))
                pos = {s: i for i, s in enumerate(uniq)}
                table = np.fromiter((pos[s] for s in strs), dtype=np.int32, count=len(strs))
                return Dictionary(uniq), torch.from_numpy(table).to(v.values.device)

            out_d, table = dict_util.memo(("substr", start, length, str(v.values.device)), (d,), cut)
            codes = v.values if len(table) == 0 else table[v.values.clamp(0, len(table) - 1).long()]
            return ColumnValue(codes, v.nulls, DataType.STRING, out_d)

        return fn

    simple = {
        "abs": torch.abs,
        # floor and ceil of an integer are the integer
        "floor": lambda x: torch.floor(x) if x.dtype.is_floating_point else x,
        "ceil": lambda x: torch.ceil(x) if x.dtype.is_floating_point else x,
        "sqrt": lambda x: _sqrt(x.to(torch.float64)),
    }
    if name in simple:
        g = simple[name]

        def fn(batch: DeviceBatch) -> ColumnValue:
            v = args[0](batch)
            return ColumnValue(g(v.values).to(td), v.nulls, out_dtype)

        return fn

    if name == "round":
        ndigits = 0
        if len(expr.args) > 1:
            if not isinstance(expr.args[1], L.Literal):
                raise PlanError("round() digits must be a literal")
            ndigits = int(expr.args[1].value)
        scale = 10.0**ndigits

        def fn(batch: DeviceBatch) -> ColumnValue:
            v = args[0](batch)
            x = v.values if v.values.dtype == torch.float32 else v.values.to(torch.float64)
            # torch.round, like jnp.round, rounds half to even
            return ColumnValue((torch.round(x * scale) / scale).to(td), v.nulls, out_dtype)

        return fn

    # UDF plugins: the body runs on the batch's device like a built-in
    # (ballista_tpu_torch/plugin.py, ref core/src/plugin/)
    from ballista_tpu_torch.plugin import global_registry

    udf = global_registry.get(name)
    if udf is not None:
        g = udf.fn

        def fn(batch: DeviceBatch) -> ColumnValue:
            vs = [a(batch) for a in args]
            out = g(*[v.values for v in vs])
            if not (
                isinstance(out, torch.Tensor)
                and tuple(out.shape) == (batch.capacity,)
                and out.device == batch.device
            ):
                got = (
                    f"a tensor of shape {tuple(out.shape)} on {out.device}"
                    if isinstance(out, torch.Tensor) else type(out).__name__
                )
                raise ExecutionError(
                    f"UDF {udf.name!r} returned {got}; it must return one "
                    f"value a row: a tensor of shape ({batch.capacity},) on "
                    f"{batch.device}, the batch's device"
                )
            # null-strict: result is NULL where any argument is NULL
            nulls = None
            for v in vs:
                if v.nulls is not None:
                    nulls = v.nulls if nulls is None else (nulls | v.nulls)
            return ColumnValue(out.to(td), nulls, out_dtype)

        return fn

    raise PlanError(f"unknown scalar function {name!r}")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f64 square root. The card's is; torch's vectorized
    CPU one misses the nearest double on about 1% of inputs (sqrt(0.5)
    among them), where numpy's, like the reference's, is exact."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):  # NaN for x < 0, as on the card
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def civil_from_days(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Days since the epoch -> (year, month, day), int32: Howard Hinnant's
    branchless proleptic-Gregorian civil_from_days, exact for every int32
    day (floor division, so days before 1970 come out right)."""

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    z = z.to(torch.int32) + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9).to(torch.int32)
    y = y + (m <= 2).to(torch.int32)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)
