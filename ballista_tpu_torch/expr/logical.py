"""Logical expression AST.

The equivalent of DataFusion's ``Expr`` as used throughout the reference's
logical-plan serde (ballista/rust/core/src/serde/logical_plan/to_proto.rs,
from_proto.rs — Column/Literal/BinaryExpr/Case/Cast/InList/Between/Like/
AggregateExpr/Alias arms). Expressions are immutable trees; type and
nullability are inferred against an input :class:`~ballista_tpu.datatypes.Schema`.

Column resolution supports qualified names: a schema produced under a table
alias carries fields named ``alias.col``; ``Column("col")`` resolves by exact
match first, then by unique ``.col`` suffix (the DataFusion behavior the
reference relies on for self-joins like TPC-H q7's ``nation n1, nation n2``).
"""

from __future__ import annotations

import dataclasses
import datetime
from enum import Enum
from typing import Sequence

from ballista_tpu_torch.datatypes import DataType, Schema, common_type
from ballista_tpu_torch.errors import PlanError, SchemaError


def resolve_field_index(schema: Schema, name: str) -> int:
    """Exact match, then unique unqualified-suffix match (bare name against
    ``alias.name`` fields), then unique base-name match (``table.name``
    against bare fields — tables referenced without an alias produce
    unqualified schemas)."""
    exact = [i for i, f in enumerate(schema.fields) if f.name == name]
    if len(exact) == 1:
        return exact[0]
    if len(exact) > 1:
        # duplicate field names (an unqualifiable join collision, or an
        # unaliased self-join): refuse rather than silently pick a side
        raise SchemaError(
            f"ambiguous column {name!r}: appears {len(exact)} times; "
            "qualify it or alias the tables"
        )
    if "." not in name:
        hits = [
            i for i, f in enumerate(schema.fields) if f.name.endswith("." + name)
        ]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SchemaError(
                f"ambiguous column {name!r}: matches "
                f"{[schema.fields[i].name for i in hits]}"
            )
    else:
        base = name.rsplit(".", 1)[1]
        hits = [i for i, f in enumerate(schema.fields) if f.name == base]
        if len(hits) == 1:
            return hits[0]
    raise SchemaError(f"column {name!r} not found; available: {schema.names}")


class Operator(Enum):
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTEQ = "<="
    GT = ">"
    GTEQ = ">="
    PLUS = "+"
    MINUS = "-"
    MULTIPLY = "*"
    DIVIDE = "/"
    MODULO = "%"
    AND = "AND"
    OR = "OR"

    @property
    def is_comparison(self) -> bool:
        return self in (
            Operator.EQ,
            Operator.NEQ,
            Operator.LT,
            Operator.LTEQ,
            Operator.GT,
            Operator.GTEQ,
        )

    @property
    def is_logical(self) -> bool:
        return self in (Operator.AND, Operator.OR)

    @property
    def is_arithmetic(self) -> bool:
        return self in (
            Operator.PLUS,
            Operator.MINUS,
            Operator.MULTIPLY,
            Operator.DIVIDE,
            Operator.MODULO,
        )


class AggFunc(Enum):
    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    STDDEV = "stddev"          # sample (DataFusion's stddev)
    STDDEV_POP = "stddev_pop"
    VARIANCE = "variance"      # sample
    VAR_POP = "var_pop"
    CORR = "corr"              # two-argument (arg, arg2)


class Expr:
    """Base class. Subclasses are frozen dataclasses."""

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def nullable(self, schema: Schema) -> bool:
        raise NotImplementedError

    def name(self) -> str:
        """Output column name when this expr is projected (DataFusion-style
        display name, e.g. ``SUM(l_quantity)``)."""
        raise NotImplementedError

    def children(self) -> list["Expr"]:
        return []

    def with_children(self, children: list["Expr"]) -> "Expr":
        if children:
            raise PlanError(f"{type(self).__name__} takes no children")
        return self

    # -- builder sugar (mirrors the reference client's DataFrame exprs) ------
    def _bin(self, op: Operator, other) -> "BinaryExpr":
        return BinaryExpr(self, op, _wrap(other))

    def __eq__(self, other):  # type: ignore[override]
        if isinstance(other, (Expr, int, float, str, bool, datetime.date)):
            return self._bin(Operator.EQ, other)
        return NotImplemented

    def __ne__(self, other):  # type: ignore[override]
        if isinstance(other, (Expr, int, float, str, bool, datetime.date)):
            return self._bin(Operator.NEQ, other)
        return NotImplemented

    __hash__ = None  # type: ignore[assignment]

    def __lt__(self, other):
        return self._bin(Operator.LT, other)

    def __le__(self, other):
        return self._bin(Operator.LTEQ, other)

    def __gt__(self, other):
        return self._bin(Operator.GT, other)

    def __ge__(self, other):
        return self._bin(Operator.GTEQ, other)

    def __add__(self, other):
        return self._bin(Operator.PLUS, other)

    def __sub__(self, other):
        return self._bin(Operator.MINUS, other)

    def __mul__(self, other):
        return self._bin(Operator.MULTIPLY, other)

    def __truediv__(self, other):
        return self._bin(Operator.DIVIDE, other)

    def __mod__(self, other):
        return self._bin(Operator.MODULO, other)

    def __and__(self, other):
        return self._bin(Operator.AND, other)

    def __or__(self, other):
        return self._bin(Operator.OR, other)

    def __invert__(self):
        return Not(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNotNull":
        return IsNotNull(self)

    def between(self, low, high) -> "Between":
        return Between(self, _wrap(low), _wrap(high), negated=False)

    def like(self, pattern: str) -> "Like":
        return Like(self, pattern, negated=False)

    def in_list(self, values: Sequence, negated: bool = False) -> "InList":
        return InList(self, tuple(_wrap(v) for v in values), negated)

    def cast(self, dtype: DataType) -> "Cast":
        return Cast(self, dtype)

    def sort(self, ascending: bool = True, nulls_first: bool | None = None):
        """Sort-order wrapper for DataFrame.sort (ref python bindings:
        col("x").sort(...)). Default null placement follows SQL: NULLS
        LAST ascending, NULLS FIRST descending."""
        from ballista_tpu_torch.plan.logical import SortExpr

        nf = (not ascending) if nulls_first is None else nulls_first
        return SortExpr(self, ascending, nf)

    # equality for tests/optimizer (dataclass __eq__ is overridden by sugar)
    def same_as(self, other: "Expr") -> bool:
        return type(self) is type(other) and self._key() == other._key()

    def _key(self):
        # Expr.__eq__ is builder sugar (returns a truthy BinaryExpr), so keys
        # must normalize Exprs at ANY nesting depth — e.g. Case.branches is a
        # tuple of (cond, value) tuples — or tuple comparison would call the
        # sugar and treat all exprs as equal.
        def norm(v):
            if isinstance(v, Expr):
                return ("expr", type(v).__name__, v._key())
            if isinstance(v, tuple):
                return tuple(norm(x) for x in v)
            return v

        return tuple(
            norm(getattr(self, f.name))
            for f in dataclasses.fields(self)  # type: ignore[arg-type]
        )


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal.infer(v)


def col_or_expr(v) -> Expr:
    """DataFrame-builder argument coercion: bare strings are COLUMN
    references (pyspark/datafusion-python convention), everything else
    wraps as usual (non-Expr -> literal)."""
    return col(v) if isinstance(v, str) else _wrap(v)


def col(name: str) -> "Column":
    return Column(name)


def lit(v) -> "Literal":
    return Literal.infer(v)


@dataclasses.dataclass(frozen=True, eq=False)
class Column(Expr):
    cname: str

    def data_type(self, schema: Schema) -> DataType:
        return schema.fields[resolve_field_index(schema, self.cname)].dtype

    def nullable(self, schema: Schema) -> bool:
        return schema.fields[resolve_field_index(schema, self.cname)].nullable

    def name(self) -> str:
        return self.cname

    def __repr__(self) -> str:
        return f"#{self.cname}"


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: object  # python scalar; None for NULL
    dtype: DataType

    @classmethod
    def infer(cls, v) -> "Literal":
        if v is None:
            return cls(None, DataType.NULL)
        if isinstance(v, bool):
            return cls(v, DataType.BOOL)
        if isinstance(v, int):
            return cls(v, DataType.INT64)
        if isinstance(v, float):
            return cls(v, DataType.FLOAT64)
        if isinstance(v, str):
            return cls(v, DataType.STRING)
        if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
            days = (v - datetime.date(1970, 1, 1)).days
            return cls(days, DataType.DATE32)
        if isinstance(v, datetime.datetime):
            epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
            us = int((v - epoch).total_seconds() * 1_000_000)
            return cls(us, DataType.TIMESTAMP_US)
        raise PlanError(f"cannot infer literal type of {v!r}")

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def nullable(self, schema: Schema) -> bool:
        return self.value is None

    def name(self) -> str:
        if self.dtype == DataType.STRING:
            return f"Utf8({self.value!r})"
        return str(self.value)

    def __repr__(self) -> str:
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class IntervalLiteral(Expr):
    """SQL INTERVAL. Months and days kept separate (months are not a fixed
    number of days). Only appears in date arithmetic; date +/- interval with
    months is constant-folded at plan time (TPC-H only applies intervals to
    date literals), day-only intervals also evaluate on device."""

    months: int = 0
    days: int = 0

    def data_type(self, schema: Schema) -> DataType:
        return DataType.INT32  # days representation when device-evaluated

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        return f"INTERVAL {self.months} months {self.days} days"

    def __repr__(self) -> str:
        return self.name()


@dataclasses.dataclass(frozen=True, eq=False)
class BinaryExpr(Expr):
    left: Expr
    op: Operator
    right: Expr

    def data_type(self, schema: Schema) -> DataType:
        if self.op.is_comparison or self.op.is_logical:
            return DataType.BOOL
        lt_ = self.left.data_type(schema)
        rt = self.right.data_type(schema)
        # date32 - date32 = int32 days; date32 +/- int = date32
        if lt_ == DataType.DATE32 and rt == DataType.DATE32:
            if self.op == Operator.MINUS:
                return DataType.INT32
            raise PlanError(f"cannot {self.op.value} two dates")
        if DataType.DATE32 in (lt_, rt) and self.op in (
            Operator.PLUS,
            Operator.MINUS,
        ):
            return DataType.DATE32
        out = common_type(lt_, rt)
        if self.op == Operator.DIVIDE and out.is_integer:
            return out  # SQL integer division truncates
        return out

    def nullable(self, schema: Schema) -> bool:
        return self.left.nullable(schema) or self.right.nullable(schema)

    def name(self) -> str:
        return f"{self.left.name()} {self.op.value} {self.right.name()}"

    def children(self) -> list[Expr]:
        return [self.left, self.right]

    def with_children(self, children: list[Expr]) -> "BinaryExpr":
        return BinaryExpr(children[0], self.op, children[1])

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op.value} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Expr):
    expr: Expr

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        return f"NOT {self.expr.name()}"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "Not":
        return Not(children[0])

    def __repr__(self) -> str:
        return f"NOT {self.expr!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class Negative(Expr):
    expr: Expr

    def data_type(self, schema: Schema) -> DataType:
        return self.expr.data_type(schema)

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        return f"(- {self.expr.name()})"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "Negative":
        return Negative(children[0])


@dataclasses.dataclass(frozen=True, eq=False)
class IsNull(Expr):
    expr: Expr

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        return f"{self.expr.name()} IS NULL"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "IsNull":
        return IsNull(children[0])


@dataclasses.dataclass(frozen=True, eq=False)
class IsNotNull(Expr):
    expr: Expr

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        return f"{self.expr.name()} IS NOT NULL"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "IsNotNull":
        return IsNotNull(children[0])


@dataclasses.dataclass(frozen=True, eq=False)
class Cast(Expr):
    expr: Expr
    to: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.to

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        return f"CAST({self.expr.name()} AS {self.to.value})"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "Cast":
        return Cast(children[0], self.to)


@dataclasses.dataclass(frozen=True, eq=False)
class Case(Expr):
    """CASE WHEN c1 THEN v1 [WHEN ...] [ELSE e] END (no base-operand form;
    the parser desugars ``CASE x WHEN v`` into ``WHEN x = v``)."""

    branches: tuple[tuple[Expr, Expr], ...]
    otherwise: Expr | None

    def data_type(self, schema: Schema) -> DataType:
        t = self.branches[0][1].data_type(schema)
        for _, v in self.branches[1:]:
            t = common_type(t, v.data_type(schema))
        if self.otherwise is not None:
            t = common_type(t, self.otherwise.data_type(schema))
        return t

    def nullable(self, schema: Schema) -> bool:
        if self.otherwise is None:
            return True
        return any(v.nullable(schema) for _, v in self.branches) or (
            self.otherwise.nullable(schema)
        )

    def name(self) -> str:
        parts = ["CASE"]
        for c, v in self.branches:
            parts.append(f"WHEN {c.name()} THEN {v.name()}")
        if self.otherwise is not None:
            parts.append(f"ELSE {self.otherwise.name()}")
        parts.append("END")
        return " ".join(parts)

    def children(self) -> list[Expr]:
        out: list[Expr] = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.otherwise is not None:
            out.append(self.otherwise)
        return out

    def with_children(self, children: list[Expr]) -> "Case":
        n = len(self.branches)
        branches = tuple(
            (children[2 * i], children[2 * i + 1]) for i in range(n)
        )
        otherwise = children[2 * n] if self.otherwise is not None else None
        return Case(branches, otherwise)


@dataclasses.dataclass(frozen=True, eq=False)
class InList(Expr):
    expr: Expr
    values: tuple[Expr, ...]  # literals after folding
    negated: bool

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        inner = ", ".join(v.name() for v in self.values)
        return f"{self.expr.name()} {'NOT ' if self.negated else ''}IN ({inner})"

    def children(self) -> list[Expr]:
        return [self.expr, *self.values]

    def with_children(self, children: list[Expr]) -> "InList":
        return InList(children[0], tuple(children[1:]), self.negated)


@dataclasses.dataclass(frozen=True, eq=False)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return (
            self.expr.nullable(schema)
            or self.low.nullable(schema)
            or self.high.nullable(schema)
        )

    def name(self) -> str:
        neg = "NOT " if self.negated else ""
        return (
            f"{self.expr.name()} {neg}BETWEEN {self.low.name()} "
            f"AND {self.high.name()}"
        )

    def children(self) -> list[Expr]:
        return [self.expr, self.low, self.high]

    def with_children(self, children: list[Expr]) -> "Between":
        return Between(children[0], children[1], children[2], self.negated)


@dataclasses.dataclass(frozen=True, eq=False)
class Like(Expr):
    """SQL LIKE with %/_ wildcards. Evaluated host-side over the (small)
    string dictionary, becoming a code-lookup on device."""

    expr: Expr
    pattern: str
    negated: bool

    def data_type(self, schema: Schema) -> DataType:
        return DataType.BOOL

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr.name()} {neg}LIKE {self.pattern!r}"

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "Like":
        return Like(children[0], self.pattern, self.negated)


@dataclasses.dataclass(frozen=True, eq=False)
class Alias(Expr):
    expr: Expr
    aname: str

    def data_type(self, schema: Schema) -> DataType:
        return self.expr.data_type(schema)

    def nullable(self, schema: Schema) -> bool:
        return self.expr.nullable(schema)

    def name(self) -> str:
        return self.aname

    def children(self) -> list[Expr]:
        return [self.expr]

    def with_children(self, children: list[Expr]) -> "Alias":
        return Alias(children[0], self.aname)

    def __repr__(self) -> str:
        return f"{self.expr!r} AS {self.aname}"


@dataclasses.dataclass(frozen=True, eq=False)
class Wildcard(Expr):
    """``*`` — only valid inside COUNT(*) or as a SELECT item (expanded by
    the SQL planner)."""

    def data_type(self, schema: Schema) -> DataType:
        return DataType.INT64

    def nullable(self, schema: Schema) -> bool:
        return False

    def name(self) -> str:
        return "*"


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """``ROWS/RANGE BETWEEN <start> AND <end>`` (ref WindowFrame,
    datafusion.proto:236-277). Bound types: ``up`` unbounded preceding,
    ``p`` n preceding, ``cur`` current row, ``f`` n following, ``uf``
    unbounded following."""

    units: str  # "rows" | "range"
    start_type: str = "up"
    start_n: int = 0
    end_type: str = "cur"
    end_n: int = 0

    _ORDER = {"up": 0, "p": 1, "cur": 2, "f": 3, "uf": 4}

    def __post_init__(self):
        if self.units not in ("rows", "range"):
            raise PlanError(f"bad window frame units {self.units!r}")
        for t in (self.start_type, self.end_type):
            if t not in self._ORDER:
                raise PlanError(f"bad window frame bound {t!r}")
        after = self._ORDER[self.start_type] > self._ORDER[self.end_type]
        if self.start_type == self.end_type == "p":
            after = self.start_n < self.end_n  # larger N precedes = earlier
        elif self.start_type == self.end_type == "f":
            after = self.start_n > self.end_n
        if self.start_type == "uf" or self.end_type == "up" or after:
            raise PlanError("window frame start after end")

    def describe(self) -> str:
        def b(t, n):
            return {
                "up": "UNBOUNDED PRECEDING",
                "p": f"{n} PRECEDING",
                "cur": "CURRENT ROW",
                "f": f"{n} FOLLOWING",
                "uf": "UNBOUNDED FOLLOWING",
            }[t]

        return (
            f"{self.units.upper()} BETWEEN {b(self.start_type, self.start_n)}"
            f" AND {b(self.end_type, self.end_n)}"
        )


_RANKING_WINDOW = ("row_number", "rank", "dense_rank")
_AGG_WINDOW = ("sum", "avg", "min", "max", "count")
_SHIFT_WINDOW = ("lag", "lead")


@dataclasses.dataclass(frozen=True, eq=False)
class WindowFunction(Expr):
    """Window function: ranking (row_number/rank/dense_rank), aggregate
    over a frame (sum/avg/min/max/count ... OVER (... ROWS/RANGE ...)),
    or shift (lag/lead). Evaluated by the Window plan node, not
    row-expression compilation. ref: PhysicalWindowExprNode + WindowFrame
    (ballista.proto:352-366, datafusion.proto:236-277)."""

    fname: str
    partition_by: tuple[Expr, ...]
    # (expr, ascending, nulls_first) — nulls_first None = SQL default
    # (FIRST for DESC, LAST for ASC, matching the engine's Sort)
    order_by: tuple[tuple[Expr, bool, bool | None], ...]
    arg: Expr | None
    frame: WindowFrame | None
    offset: int  # lag/lead distance

    def __init__(self, fname, partition_by, order_by, arg=None, frame=None,
                 offset=1):
        object.__setattr__(self, "fname", fname)
        object.__setattr__(self, "partition_by", tuple(partition_by))
        object.__setattr__(
            self,
            "order_by",
            tuple(
                (t[0], t[1], t[2] if len(t) > 2 else None) for t in order_by
            ),
        )
        object.__setattr__(self, "arg", arg)
        object.__setattr__(self, "frame", frame)
        object.__setattr__(self, "offset", int(offset))
        if fname not in _RANKING_WINDOW + _AGG_WINDOW + _SHIFT_WINDOW:
            raise PlanError(f"unsupported window function {fname!r}")
        if fname in _RANKING_WINDOW:
            if arg is not None or frame is not None:
                raise PlanError(f"{fname}() takes no argument and no frame")
        elif arg is None:
            raise PlanError(f"{fname}() window requires an argument")
        if fname in _SHIFT_WINDOW and frame is not None:
            raise PlanError(f"{fname}() takes no frame")

    def data_type(self, schema: Schema) -> DataType:
        if self.fname in _RANKING_WINDOW or self.fname == "count":
            return DataType.INT64
        if self.fname == "avg":
            return DataType.FLOAT64
        at = self.arg.data_type(schema)
        if self.fname == "sum":
            if at.is_integer:
                return DataType.INT64
            if at.is_floating:
                return DataType.FLOAT64
        return at

    def nullable(self, schema: Schema) -> bool:
        # empty frames / shifted-off-partition rows yield NULL
        return self.fname not in _RANKING_WINDOW + ("count",)

    def children(self) -> list[Expr]:
        kids = list(self.partition_by) + [e for e, _, _ in self.order_by]
        if self.arg is not None:
            kids.append(self.arg)
        return kids

    def with_children(self, children: list[Expr]) -> "WindowFunction":
        np_ = len(self.partition_by)
        no_ = len(self.order_by)
        return WindowFunction(
            self.fname,
            tuple(children[:np_]),
            tuple(
                (c, asc, nf)
                for c, (_, asc, nf) in zip(
                    children[np_ : np_ + no_], self.order_by
                )
            ),
            arg=children[np_ + no_] if self.arg is not None else None,
            frame=self.frame,
            offset=self.offset,
        )

    def name(self) -> str:
        parts = []
        if self.partition_by:
            parts.append(
                "PARTITION BY " + ", ".join(e.name() for e in self.partition_by)
            )
        if self.order_by:
            parts.append(
                "ORDER BY "
                + ", ".join(
                    f"{e.name()}{'' if asc else ' DESC'}"
                    + (
                        ""
                        if nf is None
                        else (" NULLS FIRST" if nf else " NULLS LAST")
                    )
                    for e, asc, nf in self.order_by
                )
            )
        if self.frame is not None:
            parts.append(self.frame.describe())
        if self.fname in _SHIFT_WINDOW:
            args = f"{self.arg.name()}, {self.offset}"
        elif self.arg is not None:
            args = self.arg.name()
        else:
            args = ""
        return f"{self.fname}({args}) OVER ({' '.join(parts)})"


@dataclasses.dataclass(frozen=True, eq=False)
class AggregateExpr(Expr):
    func: AggFunc
    arg: Expr  # Wildcard for COUNT(*)
    distinct: bool = False
    arg2: Expr | None = None  # CORR's second argument

    def data_type(self, schema: Schema) -> DataType:
        if self.func == AggFunc.COUNT:
            return DataType.INT64
        at = self.arg.data_type(schema)
        if self.func in (
            AggFunc.AVG, AggFunc.STDDEV, AggFunc.STDDEV_POP,
            AggFunc.VARIANCE, AggFunc.VAR_POP, AggFunc.CORR,
        ):
            return DataType.FLOAT64
        if self.func == AggFunc.SUM:
            # SUM widens to the largest type of its class (DataFusion's rule).
            if at.is_integer:
                return DataType.INT64
            if at.is_floating:
                return DataType.FLOAT64
            return at
        return at  # MIN/MAX preserve type

    def nullable(self, schema: Schema) -> bool:
        return self.func != AggFunc.COUNT

    def name(self) -> str:
        d = "DISTINCT " if self.distinct else ""
        if self.arg2 is not None:
            return (
                f"{self.func.value.upper()}"
                f"({d}{self.arg.name()}, {self.arg2.name()})"
            )
        return f"{self.func.value.upper()}({d}{self.arg.name()})"

    def children(self) -> list[Expr]:
        return [self.arg] + ([self.arg2] if self.arg2 is not None else [])

    def with_children(self, children: list[Expr]) -> "AggregateExpr":
        return AggregateExpr(
            self.func, children[0], self.distinct,
            children[1] if len(children) > 1 else None,
        )

    def __repr__(self) -> str:
        return self.name()


@dataclasses.dataclass(frozen=True, eq=False)
class PercentileExpr(AggregateExpr):
    """``approx_percentile_cont(x, q)`` / ``median(x)``. Holistic (not
    algebraic): the optimizer splits it out of Aggregate nodes into a
    dedicated Percentile plan node (sort-based exact selection — sorting
    is cheap on this engine, so 'approx' actually computes the exact
    continuous percentile; name kept for reference-API parity,
    DataFusion's approx_percentile_cont)."""

    q: float = 0.5

    def __init__(self, arg: Expr, q: float):
        object.__setattr__(self, "func", AggFunc.SUM)  # unused marker
        object.__setattr__(self, "arg", arg)
        object.__setattr__(self, "distinct", False)
        object.__setattr__(self, "arg2", None)
        if not (0.0 <= q <= 1.0):
            raise PlanError(f"percentile {q} outside [0, 1]")
        object.__setattr__(self, "q", float(q))

    def data_type(self, schema: Schema) -> DataType:
        return DataType.FLOAT64

    def nullable(self, schema: Schema) -> bool:
        return True  # group with no non-null values

    def name(self) -> str:
        return f"APPROX_PERCENTILE_CONT({self.arg.name()}, {self.q:g})"

    def children(self) -> list[Expr]:
        return [self.arg]

    def with_children(self, children: list[Expr]) -> "PercentileExpr":
        return PercentileExpr(children[0], self.q)


@dataclasses.dataclass(frozen=True, eq=False)
class UdafExpr(AggregateExpr):
    """A registered aggregate UDF call (ref python/src/udaf.rs). Subclasses
    AggregateExpr so the planner's aggregate discovery and the two-phase
    decomposition treat it like any built-in; the wire format carries only
    the name (both ends load the same plugin dir, like scalar UDFs)."""

    uname: str = ""

    def __init__(self, uname: str, arg: Expr):
        object.__setattr__(self, "func", AggFunc.SUM)  # unused marker
        object.__setattr__(self, "arg", arg)
        object.__setattr__(self, "distinct", False)
        object.__setattr__(self, "arg2", None)
        object.__setattr__(self, "uname", uname.lower())

    def data_type(self, schema: Schema) -> DataType:
        from ballista_tpu_torch.plugin import lookup_udaf

        rt = lookup_udaf(self.uname).return_type
        if rt == "same":
            return self.arg.data_type(schema)
        return rt

    def nullable(self, schema: Schema) -> bool:
        return True

    def name(self) -> str:
        return f"{self.uname}({self.arg.name()})"

    def children(self) -> list[Expr]:
        return [self.arg]

    def with_children(self, children: list[Expr]) -> "UdafExpr":
        return UdafExpr(self.uname, children[0])


# Scalar function registry: name -> (return-type rule, min arity, max arity).
# Type rules: "same" (arg 0's type), or a fixed DataType.
_SCALAR_FUNCS: dict[str, tuple[object, int, int]] = {
    "abs": ("same", 1, 1),
    "round": ("same", 1, 2),
    "floor": ("same", 1, 1),
    "ceil": ("same", 1, 1),
    "sqrt": (DataType.FLOAT64, 1, 1),
    "extract_year": (DataType.INT32, 1, 1),
    "extract_month": (DataType.INT32, 1, 1),
    "extract_day": (DataType.INT32, 1, 1),
    "substr": (DataType.STRING, 2, 3),
    "coalesce": ("common", 1, 99),
}


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarFunction(Expr):
    fname: str
    args: tuple[Expr, ...]

    def __post_init__(self):
        spec = _SCALAR_FUNCS.get(self.fname)
        if spec is None:
            # UDF plugins (ballista_tpu/plugin.py, ref core/src/plugin/)
            from ballista_tpu_torch.plugin import lookup_udf

            udf = lookup_udf(self.fname)  # raises PlanError when unknown
            lo, hi = udf.min_args, udf.max_args
        else:
            _, lo, hi = spec
        if not (lo <= len(self.args) <= hi):
            raise PlanError(
                f"{self.fname} takes {lo}..{hi} args, got {len(self.args)}"
            )

    def data_type(self, schema: Schema) -> DataType:
        spec = _SCALAR_FUNCS.get(self.fname)
        if spec is None:
            from ballista_tpu_torch.plugin import lookup_udf

            rule = lookup_udf(self.fname).return_type
        else:
            rule = spec[0]
        if rule == "same":
            return self.args[0].data_type(schema)
        if rule == "common":
            t = self.args[0].data_type(schema)
            for a in self.args[1:]:
                t = common_type(t, a.data_type(schema))
            return t
        return rule  # fixed DataType

    def nullable(self, schema: Schema) -> bool:
        if self.fname == "coalesce":
            return all(a.nullable(schema) for a in self.args)
        return any(a.nullable(schema) for a in self.args)

    def name(self) -> str:
        return f"{self.fname}({', '.join(a.name() for a in self.args)})"

    def children(self) -> list[Expr]:
        return list(self.args)

    def with_children(self, children: list[Expr]) -> "ScalarFunction":
        return ScalarFunction(self.fname, tuple(children))


def find_aggregates(expr: Expr) -> list[AggregateExpr]:
    """All AggregateExpr nodes in an expression tree (pre-order)."""
    out: list[AggregateExpr] = []
    if isinstance(expr, AggregateExpr):
        out.append(expr)
    for c in expr.children():
        out.extend(find_aggregates(c))
    return out


def find_columns(expr: Expr) -> list[str]:
    """All column names referenced (pre-order, with duplicates removed,
    order preserved)."""
    out: list[str] = []

    def walk(e: Expr) -> None:
        if isinstance(e, Column) and e.cname not in out:
            out.append(e.cname)
        for c in e.children():
            walk(c)

    walk(expr)
    return out
