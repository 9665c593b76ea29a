"""Physical planner: logical plan -> ExecutionPlan tree (port of
``ballista_tpu/exec/planner.py``, single-process tier).

It builds the reference's operator tree node for node, so a plan's
``display()`` is the reference's: aggregates lower to a partial/final pair
around a coalesce, pushed-down scan filters become FilterExecs, sorts and
limits gather their input. Logical nodes whose operators are not ported yet
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from ballista_tpu_torch.exec.aggregate import HashAggregateExec
from ballista_tpu_torch.exec.base import ExecutionPlan
from ballista_tpu_torch.exec.pipeline import (
    CoalescePartitionsExec,
    FilterExec,
    ProjectionExec,
)
from ballista_tpu_torch.exec.sort import GlobalLimitExec, SortExec
from ballista_tpu_torch.plan import logical as P

_NOT_PORTED = {
    "Join": "joins (ROADMAP queue 1, item 6)",
    "CrossJoin": "joins (ROADMAP queue 1, item 6)",
    "Union": "joins and unions (ROADMAP queue 1, item 6)",
    "EmptyRelation": "joins and unions (ROADMAP queue 1, item 6)",
    "Distinct": "the sort-based aggregate (ROADMAP queue 1, item 4)",
    "SubqueryAlias": "the rename operator (ROADMAP queue 1, item 6)",
    "Window": "window functions (ROADMAP queue 1, item 7)",
    "Percentile": "percentiles (ROADMAP queue 1, item 7)",
}


class TableProvider:
    """Resolves a table name to a scan operator."""

    def scan(
        self, table: str, projection: list[str] | None, partitions: int
    ) -> ExecutionPlan:
        raise NotImplementedError


class PhysicalPlanner:
    def __init__(self, provider: TableProvider, partitions: int = 2):
        self.provider = provider
        self.partitions = partitions

    def plan(self, logical: P.LogicalPlan) -> ExecutionPlan:
        return self._plan(logical)

    def _plan(self, node: P.LogicalPlan) -> ExecutionPlan:
        if isinstance(node, P.TableScan):
            if node.source is not None:
                raise NotImplementedError(
                    f"file scans ({node.source[0]}) are not ported yet "
                    "(ROADMAP queue 1, item 3)"
                )
            projection = list(node.projection) if node.projection else None
            scan = self.provider.scan(node.table_name, projection, self.partitions)
            scan.table_name = node.table_name
            for f in node.filters:
                scan = FilterExec(scan, f)
            return scan
        if isinstance(node, P.Projection):
            return ProjectionExec(self._plan(node.input), list(node.exprs))
        if isinstance(node, P.Filter):
            return FilterExec(self._plan(node.input), node.predicate)
        if isinstance(node, P.Aggregate):
            child = self._plan(node.input)
            partial = HashAggregateExec(
                child, list(node.group_exprs), list(node.agg_exprs), mode="partial"
            )
            return HashAggregateExec(
                CoalescePartitionsExec(partial),
                list(node.group_exprs),
                list(node.agg_exprs),
                mode="final",
                spec=partial.spec,
            )
        if isinstance(node, P.Sort):
            return SortExec(self._plan(node.input), list(node.sort_exprs))
        if isinstance(node, P.Limit):
            child = self._plan(node.input)
            if child.output_partitioning().n > 1:
                child = CoalescePartitionsExec(child)
            return GlobalLimitExec(child, node.skip, node.fetch)
        what = _NOT_PORTED.get(type(node).__name__)
        if what is not None:
            raise NotImplementedError(
                f"{type(node).__name__} needs {what}, not ported yet"
            )
        raise NotImplementedError(f"cannot lower {type(node).__name__}")
