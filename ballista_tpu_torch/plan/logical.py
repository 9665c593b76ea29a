"""Logical plan nodes.

The DataFusion ``LogicalPlan`` equivalent; the reference serializes these
node kinds in ballista.proto:34-268 (ListingTableScanNode, ProjectionNode,
SelectionNode, AggregateNode, SortNode, LimitNode, JoinNode, UnionNode,
CrossJoinNode, SubqueryAliasNode...). Nodes are immutable; schemas are
computed, not stored (except scans).
"""

from __future__ import annotations

import dataclasses
from enum import Enum

from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.expr import logical as L


class LogicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list["LogicalPlan"]:
        return []

    def with_children(self, children: list["LogicalPlan"]) -> "LogicalPlan":
        if children:
            raise PlanError(f"{type(self).__name__} takes no children")
        return self

    def display(self) -> str:
        """Multi-line indented plan rendering (DataFusion `display_indent`)."""
        lines: list[str] = []

        def walk(node: "LogicalPlan", depth: int) -> None:
            lines.append("  " * depth + node.describe())
            for c in node.children():
                walk(c, depth + 1)

        walk(self, 0)
        return "\n".join(lines)

    def describe(self) -> str:
        return type(self).__name__


class JoinType(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    SEMI = "semi"
    ANTI = "anti"


@dataclasses.dataclass(frozen=True, eq=False)
class SortExpr:
    expr: L.Expr
    ascending: bool = True
    nulls_first: bool = False  # SQL default: NULLS LAST for ASC


@dataclasses.dataclass(frozen=True, eq=False)
class TableScan(LogicalPlan):
    """Scan of a registered table. ``projection`` prunes columns;
    ``filters`` are pushed-down predicates the scan may apply early
    (row-group pruning for parquet).

    ``source`` carries file-table registration info (kind, path, has_header,
    delimiter) so remote schedulers/executors can re-create the scan without
    a shared catalog — the same role as the reference's serialized
    ListingTableScan paths (ballista.proto:60-92). None = in-memory table
    resolved from the local registry (in-proc modes only)."""

    table_name: str
    source_schema: Schema
    projection: tuple[str, ...] | None = None
    filters: tuple[L.Expr, ...] = ()
    source: tuple[str, str, bool, str] | None = None

    def schema(self) -> Schema:
        if self.projection is None:
            return self.source_schema
        return self.source_schema.select(list(self.projection))

    def describe(self) -> str:
        proj = f" projection={list(self.projection)}" if self.projection else ""
        filt = f" filters={[f.name() for f in self.filters]}" if self.filters else ""
        return f"TableScan: {self.table_name}{proj}{filt}"


@dataclasses.dataclass(frozen=True, eq=False)
class EmptyRelation(LogicalPlan):
    """Zero-column relation; ``produce_one_row`` backs `SELECT <exprs>`."""

    produce_one_row: bool = True
    out_schema: Schema = Schema([])

    def schema(self) -> Schema:
        return self.out_schema

    def describe(self) -> str:
        return f"EmptyRelation: produce_one_row={self.produce_one_row}"


@dataclasses.dataclass(frozen=True, eq=False)
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: tuple[L.Expr, ...]

    def schema(self) -> Schema:
        ins = self.input.schema()
        return Schema(
            [Field(e.name(), e.data_type(ins), e.nullable(ins)) for e in self.exprs]
        )

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Projection":
        return Projection(children[0], self.exprs)

    def describe(self) -> str:
        return "Projection: " + ", ".join(e.name() for e in self.exprs)


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: L.Expr

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Filter":
        return Filter(children[0], self.predicate)

    def describe(self) -> str:
        return f"Filter: {self.predicate.name()}"


@dataclasses.dataclass(frozen=True, eq=False)
class Aggregate(LogicalPlan):
    """GROUP BY. Output schema = group exprs then aggregate exprs
    (DataFusion's column order, which the reference's stage tests rely on)."""

    input: LogicalPlan
    group_exprs: tuple[L.Expr, ...]
    agg_exprs: tuple[L.Expr, ...]  # each contains >=1 AggregateExpr

    def schema(self) -> Schema:
        ins = self.input.schema()
        fields = [
            Field(e.name(), e.data_type(ins), e.nullable(ins))
            for e in self.group_exprs
        ]
        fields += [
            Field(e.name(), e.data_type(ins), e.nullable(ins))
            for e in self.agg_exprs
        ]
        return Schema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Aggregate":
        return Aggregate(children[0], self.group_exprs, self.agg_exprs)

    def describe(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        a = ", ".join(e.name() for e in self.agg_exprs)
        return f"Aggregate: groupBy=[{g}], aggr=[{a}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Sort(LogicalPlan):
    input: LogicalPlan
    sort_exprs: tuple[SortExpr, ...]

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Sort":
        return Sort(children[0], self.sort_exprs)

    def describe(self) -> str:
        parts = [
            f"{s.expr.name()} {'ASC' if s.ascending else 'DESC'}"
            for s in self.sort_exprs
        ]
        return "Sort: " + ", ".join(parts)


@dataclasses.dataclass(frozen=True, eq=False)
class Limit(LogicalPlan):
    input: LogicalPlan
    skip: int
    fetch: int | None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Limit":
        return Limit(children[0], self.skip, self.fetch)

    def describe(self) -> str:
        return f"Limit: skip={self.skip}, fetch={self.fetch}"


@dataclasses.dataclass(frozen=True, eq=False)
class Join(LogicalPlan):
    """Equi-join with optional residual filter (non-equi condition applied
    post-match), like DataFusion's Join { on, filter } (ballista.proto
    JoinNode)."""

    left: LogicalPlan
    right: LogicalPlan
    on: tuple[tuple[L.Expr, L.Expr], ...]  # (left_key, right_key) pairs
    join_type: JoinType
    filter: L.Expr | None = None

    def schema(self) -> Schema:
        if self.join_type in (JoinType.SEMI, JoinType.ANTI):
            return self.left.schema()
        ls = self.left.schema()
        rs = self.right.schema()
        if self.join_type in (JoinType.LEFT, JoinType.FULL):
            rs = Schema([Field(f.name, f.dtype, True) for f in rs])
        if self.join_type in (JoinType.RIGHT, JoinType.FULL):
            ls = Schema([Field(f.name, f.dtype, True) for f in ls])
        return ls.join(rs)

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, children: list[LogicalPlan]) -> "Join":
        return Join(children[0], children[1], self.on, self.join_type, self.filter)

    def describe(self) -> str:
        on = ", ".join(f"{a.name()} = {b.name()}" for a, b in self.on)
        f = f" filter={self.filter.name()}" if self.filter is not None else ""
        return f"Join({self.join_type.value}): on=[{on}]{f}"


@dataclasses.dataclass(frozen=True, eq=False)
class CrossJoin(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan

    def schema(self) -> Schema:
        return self.left.schema().join(self.right.schema())

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, children: list[LogicalPlan]) -> "CrossJoin":
        return CrossJoin(children[0], children[1])

    def describe(self) -> str:
        return "CrossJoin"


@dataclasses.dataclass(frozen=True, eq=False)
class Union(LogicalPlan):
    inputs: tuple[LogicalPlan, ...]
    all: bool  # UNION ALL keeps duplicates; UNION wraps in Distinct

    def schema(self) -> Schema:
        first = self.inputs[0].schema()
        for other in self.inputs[1:]:
            o = other.schema()
            if len(o) != len(first):
                raise PlanError(
                    f"UNION inputs have {len(first)} vs {len(o)} columns"
                )
        return first

    def children(self) -> list[LogicalPlan]:
        return list(self.inputs)

    def with_children(self, children: list[LogicalPlan]) -> "Union":
        return Union(tuple(children), self.all)

    def describe(self) -> str:
        return f"Union: all={self.all}"


@dataclasses.dataclass(frozen=True, eq=False)
class Distinct(LogicalPlan):
    """SELECT DISTINCT — lowered to a group-by over all columns."""

    input: LogicalPlan

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Distinct":
        return Distinct(children[0])

    def describe(self) -> str:
        return "Distinct"


@dataclasses.dataclass(frozen=True, eq=False)
class Window(LogicalPlan):
    """Appends one column per window expression — ranking, aggregate-over-
    frame, or lag/lead (DataFusion WindowAggExec's role; ref
    ballista.proto:531 WindowAggExecNode). ``names`` are the appended
    output column names (the SQL planner's select list then references
    them as ordinary columns)."""

    input: LogicalPlan
    window_exprs: tuple  # of L.WindowFunction
    names: tuple  # of str, same length

    def schema(self) -> Schema:
        from ballista_tpu_torch.datatypes import Field

        ins = self.input.schema()
        return Schema(
            list(ins.fields)
            + [
                Field(n, w.data_type(ins), w.nullable(ins))
                for n, w in zip(self.names, self.window_exprs)
            ]
        )

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Window":
        return Window(children[0], self.window_exprs, self.names)

    def describe(self) -> str:
        return "Window: " + ", ".join(
            f"{n} = {w.name()}" for n, w in zip(self.names, self.window_exprs)
        )


@dataclasses.dataclass(frozen=True, eq=False)
class Percentile(LogicalPlan):
    """Holistic percentile aggregate: one row per distinct group-key
    combination, carrying each requested continuous percentile of its
    value expression (sort-based exact selection; see exec/percentile.py).
    Produced by the optimizer's aggregate split — SQL never plans it
    directly. Output schema: group columns (names given, so the split can
    use internal names that cannot collide in the re-join) then one
    FLOAT64 column per (value, q, name) request."""

    input: LogicalPlan
    group_exprs: tuple[L.Expr, ...]
    group_names: tuple[str, ...]
    requests: tuple  # of (value expr, q float, output name)

    def schema(self) -> Schema:
        ins = self.input.schema()
        fields = [
            Field(n, e.data_type(ins), e.nullable(ins))
            for e, n in zip(self.group_exprs, self.group_names)
        ]
        fields += [
            Field(n, DataType.FLOAT64, True) for _, _, n in self.requests
        ]
        return Schema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "Percentile":
        return Percentile(
            children[0], self.group_exprs, self.group_names, self.requests
        )

    def describe(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        r = ", ".join(f"{n}=p{q:g}({e.name()})" for e, q, n in self.requests)
        return f"Percentile: groupBy=[{g}], [{r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class SubqueryAlias(LogicalPlan):
    """``FROM (subquery) alias`` / ``FROM table alias`` — requalifies every
    output field as ``alias.base`` so self-joins can disambiguate
    (TPC-H q7's ``nation n1, nation n2``)."""

    input: LogicalPlan
    alias: str

    def schema(self) -> Schema:
        fields = []
        for f in self.input.schema():
            base = f.name.rsplit(".", 1)[-1]
            fields.append(Field(f"{self.alias}.{base}", f.dtype, f.nullable))
        return Schema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def with_children(self, children: list[LogicalPlan]) -> "SubqueryAlias":
        return SubqueryAlias(children[0], self.alias)

    def describe(self) -> str:
        return f"SubqueryAlias: {self.alias}"
