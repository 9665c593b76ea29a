"""Expression helpers for the DataFrame builder API.

Mirrors the reference Python bindings' function surface
(ref:python/src/functions.rs — col/lit and the aggregate constructors the
PyDataFrame aggregate/select calls take): thin constructors over
``ballista_tpu_torch.expr.logical`` so DataFrame programs read like the SQL they
replace. ``sum``/``min``/``max`` shadow builtins by design (same as
pyspark/datafusion-python); import the module qualified if that matters.
"""

from __future__ import annotations

from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.expr.logical import col, lit  # noqa: F401  (re-export)


_wrap = L.col_or_expr


def alias(e, name: str) -> L.Expr:
    return _wrap(e).alias(name)


def count(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.COUNT, _wrap(e))


def count_star() -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.COUNT, L.Wildcard())


def count_distinct(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.COUNT, _wrap(e), distinct=True)


def sum(e) -> L.AggregateExpr:  # noqa: A001 - mirrors the SQL name
    return L.AggregateExpr(L.AggFunc.SUM, _wrap(e))


def avg(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.AVG, _wrap(e))


def min(e) -> L.AggregateExpr:  # noqa: A001
    return L.AggregateExpr(L.AggFunc.MIN, _wrap(e))


def max(e) -> L.AggregateExpr:  # noqa: A001
    return L.AggregateExpr(L.AggFunc.MAX, _wrap(e))


def stddev(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.STDDEV, _wrap(e))


def stddev_pop(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.STDDEV_POP, _wrap(e))


def variance(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.VARIANCE, _wrap(e))


def var_pop(e) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.VAR_POP, _wrap(e))


def corr(a, b) -> L.AggregateExpr:
    return L.AggregateExpr(L.AggFunc.CORR, _wrap(a), arg2=_wrap(b))


def udaf(name: str, e) -> L.Expr:
    """Call a registered aggregate UDF (plugin register_udaf) by name."""
    from ballista_tpu_torch.expr.logical import UdafExpr

    return UdafExpr(name, _wrap(e))
