"""Expression layer: the logical AST (a copy of the reference's) and its
compilation to torch evaluators (:mod:`ballista_tpu_torch.expr.physical`,
whose names are imported at their first use, so that this package stays
device-free)."""

from ballista_tpu_torch import _lazy
from ballista_tpu_torch.expr.logical import (
    AggFunc,
    AggregateExpr,
    Alias,
    Between,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Expr,
    InList,
    IntervalLiteral,
    IsNotNull,
    IsNull,
    Like,
    Literal,
    Negative,
    Not,
    Operator,
    ScalarFunction,
    Wildcard,
    col,
    lit,
)

__getattr__ = _lazy(
    __name__, {"ColumnValue": "ballista_tpu_torch.expr.physical", "compile_expr": "ballista_tpu_torch.expr.physical"}
)

__all__ = [
    "AggFunc",
    "AggregateExpr",
    "Alias",
    "Between",
    "BinaryExpr",
    "Case",
    "Cast",
    "Column",
    "ColumnValue",
    "Expr",
    "InList",
    "IntervalLiteral",
    "IsNotNull",
    "IsNull",
    "Like",
    "Literal",
    "Negative",
    "Not",
    "Operator",
    "ScalarFunction",
    "Wildcard",
    "col",
    "compile_expr",
    "lit",
]
