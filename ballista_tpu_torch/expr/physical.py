"""Compile logical expressions into torch evaluators.

The port of ``ballista_tpu/expr/physical.py``. A compiled expression
evaluates against a :class:`~ballista_tpu_torch.columnar.batch.DeviceBatch`
and returns a :class:`ColumnValue`: one tensor of the batch's capacity, an
optional null mask, and a host dictionary for STRING results. Evaluation is
eager; string predicates are resolved on the host against the sorted
dictionary and become integer compares on the device.

SQL three-valued logic: AND/OR use Kleene semantics; comparisons and
arithmetic propagate null as the OR of the operand nulls.

The expression kinds ported so far are those TPC-H q1 and q6 reach: column,
literal (dates included), arithmetic, comparison, BETWEEN, AND/OR, NOT,
negation, IS [NOT] NULL, CAST, and string compares against the dictionary.
The others (CASE, IN, LIKE, intervals, scalar functions) raise
``NotImplementedError``; they are ROADMAP queue 1, item 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ballista_tpu_torch.columnar import dict_util
from ballista_tpu_torch.columnar.batch import DeviceBatch, Dictionary
from ballista_tpu_torch.datatypes import DataType, Schema, common_type
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.expr import logical as L

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 2: expressions)"


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
    if isinstance(expr, L.Between):
        low = L.BinaryExpr(expr.expr, L.Operator.GTEQ, expr.low)
        high = L.BinaryExpr(expr.expr, L.Operator.LTEQ, expr.high)
        both: L.Expr = L.BinaryExpr(low, L.Operator.AND, high)
        if expr.negated:
            both = L.Not(both)
        return _compile(both, schema)
    if isinstance(expr, L.AggregateExpr):
        raise PlanError(
            f"aggregate {expr.name()} cannot be compiled as a row expression; "
            "the physical planner must split it into an Aggregate operator"
        )
    raise NotImplementedError(
        f"expression {type(expr).__name__} ({expr.name()}) {_NOT_PORTED}"
    )


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
