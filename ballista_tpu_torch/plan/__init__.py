"""Plan IR: logical plan nodes and the optimizer (a copy of the
reference's ``ballista_tpu.plan``)."""

from ballista_tpu_torch.plan.logical import (
    Aggregate,
    CrossJoin,
    Distinct,
    EmptyRelation,
    Filter,
    Join,
    JoinType,
    Limit,
    LogicalPlan,
    Projection,
    Sort,
    SortExpr,
    SubqueryAlias,
    TableScan,
    Union,
)

__all__ = [
    "Aggregate",
    "CrossJoin",
    "Distinct",
    "EmptyRelation",
    "Filter",
    "Join",
    "JoinType",
    "Limit",
    "LogicalPlan",
    "Projection",
    "Sort",
    "SortExpr",
    "SubqueryAlias",
    "TableScan",
    "Union",
]
