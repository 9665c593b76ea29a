"""Pre-execution plan verification.

Proves a plan is executable BEFORE any stage is scheduled. The scheduler
otherwise trusts the physical plan it splits into stages — schema
mismatches, unresolved columns, illegal device dtypes, and partition-count
disagreements at shuffle boundaries only surface at task runtime on an
executor (a sort whose ``fetch=None`` is lost in a serde round trip is
exactly this class). Three entry points:

- :func:`verify_logical` — walk a logical plan DAG checking parent/child
  schema agreement, column resolution, expression typing, and TPU dtype
  legality.
- :func:`verify_physical` — the same over an ExecutionPlan tree, plus
  exchange-boundary checks (partitioned-join partition counts,
  final-aggregate state layout vs the partial's spec).
- :func:`verify_stages` — stage-DAG well-formedness over the distributed
  planner's output: unique ids, dependency-ordered (therefore acyclic)
  references, and schema/partition-count agreement between every
  ``UnresolvedShuffleExec`` placeholder and the writer stage it reads.

All raise :class:`~ballista_tpu_torch.errors.PlanVerificationError` carrying the
operator path root -> offender and, when the source SQL is supplied and the
offending token can be located in it, a (line, column) span.

Port of ``ballista_tpu/analysis/verifier.py`` with its checks and messages
unchanged, the mesh operators' arms among them.
"""

from __future__ import annotations

import dataclasses
import re

from ballista_tpu_torch.datatypes import DataType, Schema, common_type, _DEVICE_DTYPE
from ballista_tpu_torch.errors import BallistaError, PlanVerificationError
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan import logical as P

# Aggregates whose argument must be numeric (or bool, which sums/averages
# as 0/1 on device). MIN/MAX order any comparable type; COUNT takes
# anything including the wildcard.
_NUMERIC_ONLY_AGGS = frozenset(
    {
        L.AggFunc.SUM,
        L.AggFunc.AVG,
        L.AggFunc.STDDEV,
        L.AggFunc.STDDEV_POP,
        L.AggFunc.VARIANCE,
        L.AggFunc.VAR_POP,
        L.AggFunc.CORR,
    }
)


def sql_span(sql: str | None, token: str | None) -> tuple[int, int] | None:
    """1-based (line, column) of ``token``'s first occurrence in ``sql``.

    Tries the token verbatim, then its unqualified tail (``l.x`` -> ``x``).
    None when the SQL is unknown or the token does not appear (plans built
    via the DataFrame API have no SQL to point into)."""
    if not sql or not token:
        return None
    candidates = [token]
    base = token.rsplit(".", 1)[-1]
    if base != token:
        candidates.append(base)
    for t in candidates:
        if not t or not re.match(r"^[A-Za-z_][A-Za-z_0-9.]*$", t):
            continue
        m = re.search(rf"(?i)(?<![A-Za-z_0-9]){re.escape(t)}(?![A-Za-z_0-9])", sql)
        if m:
            line = sql.count("\n", 0, m.start()) + 1
            col = m.start() - (sql.rfind("\n", 0, m.start()) + 1) + 1
            return (line, col)
    return None


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one verification pass, for ``EXPLAIN VERIFY`` output."""

    kind: str  # "logical" | "physical" | "stages"
    nodes: int = 0
    checks: int = 0
    detail: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        extra = f", {d}" if (d := "; ".join(self.detail)) else ""
        return (
            f"{self.kind} plan: OK — {self.nodes} operators, "
            f"{self.checks} checks{extra}"
        )


class _Walk:
    """Shared walk state: operator path, check counter, SQL span lookup."""

    def __init__(self, kind: str, sql: str | None = None):
        self.report = VerifyReport(kind)
        self.sql = sql
        self.path: list[str] = []

    def fail(self, message: str, token: str | None = None) -> None:
        raise PlanVerificationError(
            message, path=tuple(self.path), span=sql_span(self.sql, token)
        )

    def check(self) -> None:
        self.report.checks += 1

    def resolve(self, expr: L.Expr, schema: Schema, what: str) -> DataType:
        """Type an expression against a schema; unresolved columns and
        type errors become verification failures naming the column.
        Column lookup is the ENGINE's rule (exact, then unique
        unqualified-suffix, then base-name — expr.logical
        resolve_field_index), so the verifier accepts exactly the plans
        execution accepts."""
        self.check()
        for cname in L.find_columns(expr):
            try:
                L.resolve_field_index(schema, cname)
            except BallistaError as e:
                self.fail(f"{what}: {e}", token=cname)
        try:
            return expr.data_type(schema)
        except BallistaError as e:
            self.fail(f"{what} {expr.name()!r} does not type-check: {e}")

    def legal_fields(self, schema: Schema) -> None:
        """Every output field must map onto a TPU-representable dtype."""
        self.check()
        for f in schema:
            if not isinstance(f.dtype, DataType) or f.dtype not in _DEVICE_DTYPE:
                self.fail(
                    f"column {f.name!r} has no TPU device representation "
                    f"for dtype {f.dtype!r}",
                    token=f.name,
                )

    def schema_of(self, node, describe: str) -> Schema:
        self.check()
        try:
            return node.schema()
        except BallistaError as e:
            # surface the offending column as the span token when the
            # underlying SchemaError names one
            m = re.search(r"column '([^']+)'", str(e))
            self.fail(
                f"schema computation failed: {e}",
                token=m.group(1) if m else None,
            )


# ------------------------------------------------------------- logical ----


def verify_logical(plan: P.LogicalPlan, sql: str | None = None) -> VerifyReport:
    """Statically verify a logical plan; raises PlanVerificationError."""
    w = _Walk("logical", sql)
    _verify_logical_node(w, plan)
    return w.report


def _check_aggregate_expr(w: _Walk, agg: L.AggregateExpr, ins: Schema) -> None:
    if isinstance(agg.arg, L.Wildcard):
        if agg.func != L.AggFunc.COUNT:
            w.fail(f"{agg.func.value.upper()}(*) is only valid for COUNT")
        return
    at = w.resolve(agg.arg, ins, f"aggregate {agg.name()!r} argument")
    w.check()
    if agg.func in _NUMERIC_ONLY_AGGS and not (
        at.is_numeric or at == DataType.BOOL or at == DataType.NULL
    ):
        w.fail(
            f"{agg.func.value.upper()} over non-numeric dtype {at.value} "
            f"({agg.arg.name()!r}) is illegal on device",
            token=L.find_columns(agg.arg)[0] if L.find_columns(agg.arg) else None,
        )
    if agg.arg2 is not None:
        w.resolve(agg.arg2, ins, f"aggregate {agg.name()!r} second argument")


def _verify_logical_node(w: _Walk, node: P.LogicalPlan) -> None:
    w.report.nodes += 1
    w.path.append(node.describe())
    try:
        # expression-level checks run FIRST: they pinpoint the offending
        # column (token -> SQL span) where a bare node.schema() failure
        # could only say "schema computation failed"
        _logical_node_checks(w, node)
        schema = w.schema_of(node, node.describe())
        w.legal_fields(schema)
        for child in node.children():
            _verify_logical_node(w, child)
    finally:
        w.path.pop()


def _logical_node_checks(w: _Walk, node: P.LogicalPlan) -> None:
    if isinstance(node, P.TableScan):
        if node.projection is not None:
            for cname in node.projection:
                w.check()
                if not node.source_schema.has(cname):
                    w.fail(
                        f"scan projection drops through unknown column "
                        f"{cname!r}; table {node.table_name!r} has: "
                        f"{node.source_schema.names}",
                        token=cname,
                    )
        for f in node.filters:
            dt = w.resolve(f, node.schema(), "pushed-down filter")
            if dt not in (DataType.BOOL, DataType.NULL):
                w.fail(
                    f"pushed-down filter {f.name()!r} is {dt.value}, "
                    "not boolean"
                )
    elif isinstance(node, P.Projection):
        ins = w.schema_of(node.input, "input")
        for e in node.exprs:
            w.resolve(e, ins, "projection expression")
    elif isinstance(node, P.Filter):
        ins = w.schema_of(node.input, "input")
        dt = w.resolve(node.predicate, ins, "filter predicate")
        if dt not in (DataType.BOOL, DataType.NULL):
            w.fail(
                f"filter predicate {node.predicate.name()!r} is "
                f"{dt.value}, not boolean"
            )
    elif isinstance(node, P.Aggregate):
        ins = w.schema_of(node.input, "input")
        for g in node.group_exprs:
            # NULL-typed keys (e.g. GROUP BY NULL) execute fine — the
            # device maps NULL to a bool placeholder — so dtype is NOT
            # checked here: the verifier accepts what execution accepts
            w.resolve(g, ins, "group expression")
            if L.find_aggregates(g):
                w.fail(
                    f"group expression {g.name()!r} contains an "
                    "aggregate"
                )
        for e in node.agg_exprs:
            aggs = L.find_aggregates(e)
            w.check()
            if not aggs:
                w.fail(
                    f"aggregate list expression {e.name()!r} contains "
                    "no aggregate function"
                )
            for agg in aggs:
                _check_aggregate_expr(w, agg, ins)
    elif isinstance(node, P.Sort):
        ins = w.schema_of(node.input, "input")
        for s in node.sort_exprs:
            w.resolve(s.expr, ins, "sort key")
    elif isinstance(node, P.Limit):
        w.check()
        if node.skip < 0 or (node.fetch is not None and node.fetch < 0):
            w.fail(
                f"limit bounds out of range: skip={node.skip}, "
                f"fetch={node.fetch}"
            )
    elif isinstance(node, P.Join):
        ls = w.schema_of(node.left, "left input")
        rs = w.schema_of(node.right, "right input")
        w.check()
        if not node.on:
            w.fail("equi-join with empty key list (use CROSS JOIN)")
        for a, b in node.on:
            ta = w.resolve(a, ls, "left join key")
            tb = w.resolve(b, rs, "right join key")
            w.check()
            try:
                common_type(ta, tb)
            except BallistaError:
                w.fail(
                    f"join key dtype mismatch: {a.name()} is "
                    f"{ta.value} but {b.name()} is {tb.value}",
                    token=a.name(),
                )
        if node.filter is not None:
            combined = Schema(list(ls.fields) + list(rs.fields))
            dt = w.resolve(node.filter, combined, "join residual filter")
            if dt not in (DataType.BOOL, DataType.NULL):
                w.fail(
                    f"join residual filter {node.filter.name()!r} is "
                    f"{dt.value}, not boolean"
                )
    elif isinstance(node, P.Union):
        first = w.schema_of(node.inputs[0], "input")
        for other in node.inputs[1:]:
            os_ = w.schema_of(other, "input")
            w.check()
            if len(os_) != len(first):
                w.fail(
                    f"UNION inputs disagree on arity: {len(first)} vs "
                    f"{len(os_)} columns"
                )
            for fa, fb in zip(first, os_):
                w.check()
                try:
                    common_type(fa.dtype, fb.dtype)
                except BallistaError:
                    w.fail(
                        f"UNION column {fa.name!r} has no common type: "
                        f"{fa.dtype.value} vs {fb.dtype.value}",
                        token=fa.name,
                    )
    elif isinstance(node, P.Window):
        ins = w.schema_of(node.input, "input")
        w.check()
        if len(node.names) != len(node.window_exprs):
            w.fail(
                f"window emits {len(node.window_exprs)} expressions "
                f"but {len(node.names)} names"
            )
        for wx in node.window_exprs:
            w.resolve(wx, ins, "window expression")
    elif isinstance(node, P.Percentile):
        ins = w.schema_of(node.input, "input")
        w.check()
        if len(node.group_names) != len(node.group_exprs):
            w.fail("percentile group names/exprs length mismatch")
        for g in node.group_exprs:
            w.resolve(g, ins, "percentile group key")
        for v, q, _name in node.requests:
            vt = w.resolve(v, ins, "percentile value expression")
            if not (vt.is_numeric or vt in (DataType.BOOL, DataType.NULL)):
                w.fail(
                    f"percentile over non-numeric dtype {vt.value} "
                    f"({v.name()!r})"
                )
            w.check()
            if not (0.0 <= q <= 1.0):
                w.fail(f"percentile q={q} outside [0, 1]")


# ------------------------------------------------------------ physical ----


def verify_physical(plan, sql: str | None = None) -> VerifyReport:
    """Statically verify an ExecutionPlan tree; raises
    PlanVerificationError. Exchange-boundary checks (partitioned-join
    partition counts, final-aggregate layout vs the partial spec) are the
    physical tier's additions over the logical walk."""
    w = _Walk("physical", sql)
    _verify_physical_node(w, plan)
    return w.report


def _verify_physical_node(w: _Walk, node) -> None:
    # imported here: analysis must stay importable without pulling the
    # whole exec layer (torch, the kernels) in at module-import time
    from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec
    from ballista_tpu_torch.exec.aggregate import HashAggregateExec
    from ballista_tpu_torch.exec.joins import HashJoinExec, UnionExec
    from ballista_tpu_torch.exec.mesh import (
        MeshAggregateExec,
        MeshJoinExec,
        MeshSortExec,
        MeshWindowExec,
    )
    from ballista_tpu_torch.exec.pipeline import FilterExec, ProjectionExec
    from ballista_tpu_torch.exec.percentile import PercentileExec
    from ballista_tpu_torch.exec.repartition import HashRepartitionExec
    from ballista_tpu_torch.exec.sort import GlobalLimitExec, SortExec
    from ballista_tpu_torch.exec.window import WindowExec
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec

    w.report.nodes += 1
    w.path.append(node.describe())
    try:
        schema = w.schema_of(node, node.describe())
        w.legal_fields(schema)

        if isinstance(node, FilterExec):
            dt = w.resolve(node.predicate, node.input.schema(), "filter predicate")
            if dt not in (DataType.BOOL, DataType.NULL):
                w.fail(
                    f"filter predicate {node.predicate.name()!r} is "
                    f"{dt.value}, not boolean"
                )
        elif isinstance(node, ProjectionExec):
            ins = w.schema_of(node.input, "input")
            for e in node.exprs:
                w.resolve(e, ins, "projection expression")
        elif isinstance(node, (HashJoinExec, MeshJoinExec)):
            ls = w.schema_of(node.left, "left input")
            rs = w.schema_of(node.right, "right input")
            for a, b in node.on:
                ta = w.resolve(a, ls, "left join key")
                tb = w.resolve(b, rs, "right join key")
                w.check()
                try:
                    common_type(ta, tb)
                except BallistaError:
                    w.fail(
                        f"join key dtype mismatch: {a.name()} is "
                        f"{ta.value} but {b.name()} is {tb.value}",
                        token=a.name(),
                    )
            if (
                isinstance(node, HashJoinExec)
                and node.partition_mode == "partitioned"
            ):
                # both sides must present the same bucket count, or task K
                # of one side probes a bucket the other side never wrote
                nl = node.left.output_partitioning().n
                nr = node.right.output_partitioning().n
                w.check()
                if nl != nr:
                    w.fail(
                        "partitioned join inputs disagree on partition "
                        f"count: left={nl}, right={nr}"
                    )
        elif isinstance(node, (HashAggregateExec, MeshAggregateExec)):
            ins = w.schema_of(node.input, "input")
            if isinstance(node, HashAggregateExec) and node.mode == "final":
                # the final merge consumes the partial's wire layout
                # (group keys then state slots); a stage boundary or serde
                # drift that changes it must fail here, not on-device
                spec = node.spec
                expected = list(spec.group_names) + [s.name for s in spec.slots]
                w.check()
                if ins.names != expected:
                    w.fail(
                        "final aggregate input layout does not match the "
                        f"partial spec: got {ins.names}, expected {expected}"
                    )
            else:
                for g in node.group_exprs:
                    w.resolve(g, ins, "group expression")
                for e in node.agg_exprs:
                    for agg in L.find_aggregates(e):
                        _check_aggregate_expr(w, agg, ins)
        elif isinstance(node, (SortExec, MeshSortExec)):
            ins = w.schema_of(node.input, "input")
            for s in node.sort_exprs:
                w.resolve(s.expr, ins, "sort key")
            w.check()
            if node.fetch is not None and node.fetch < 0:
                w.fail(f"sort fetch out of range: {node.fetch}")
        elif isinstance(node, GlobalLimitExec):
            w.check()
            if node.skip < 0 or (node.fetch is not None and node.fetch < 0):
                w.fail(
                    f"limit bounds out of range: skip={node.skip}, "
                    f"fetch={node.fetch}"
                )
        elif isinstance(node, UnionExec):
            first = w.schema_of(node.inputs[0], "input")
            for other in node.inputs[1:]:
                os_ = w.schema_of(other, "input")
                w.check()
                if len(os_) != len(first):
                    w.fail(
                        f"union inputs disagree on arity: {len(first)} vs "
                        f"{len(os_)} columns"
                    )
                for fa, fb in zip(first, os_):
                    w.check()
                    try:
                        common_type(fa.dtype, fb.dtype)
                    except BallistaError:
                        w.fail(
                            f"union column {fa.name!r} has no common type: "
                            f"{fa.dtype.value} vs {fb.dtype.value}",
                            token=fa.name,
                        )
        elif isinstance(node, HashRepartitionExec):
            ins = w.schema_of(node.input, "input")
            for k in node.keys:
                w.resolve(k, ins, "repartition key")
            w.check()
            if node.partitions < 1:
                w.fail(f"repartition into {node.partitions} partitions")
        elif isinstance(node, (WindowExec, MeshWindowExec)):
            local = node._local if isinstance(node, MeshWindowExec) else node
            ins = w.schema_of(node.input, "input")
            for wx in local.window_exprs:
                w.resolve(wx, ins, "window expression")
        elif isinstance(node, PercentileExec):
            ins = w.schema_of(node.input, "input")
            for g in node.group_exprs:
                w.resolve(g, ins, "percentile group key")
            for v, q, _name in node.requests:
                w.resolve(v, ins, "percentile value expression")
                w.check()
                if not (0.0 <= q <= 1.0):
                    w.fail(f"percentile q={q} outside [0, 1]")
        elif isinstance(node, ShuffleWriterExec):
            ins = w.schema_of(node.input, "input")
            for k in node.partition_keys:
                w.resolve(k, ins, "shuffle partition key")
            w.check()
            if node.output_partitions < 1:
                w.fail(
                    f"shuffle writer with {node.output_partitions} output "
                    "partitions"
                )
            if not node.partition_keys and node.output_partitions != 1:
                w.fail(
                    "unkeyed shuffle writer must coalesce to 1 output "
                    f"partition, got {node.output_partitions}"
                )
        elif isinstance(node, UnresolvedShuffleExec):
            w.check()
            if node.output_partition_count < 1 or node.input_partition_count < 1:
                w.fail(
                    "unresolved shuffle with non-positive partition counts: "
                    f"input={node.input_partition_count}, "
                    f"output={node.output_partition_count}"
                )

        for child in node.children():
            _verify_physical_node(w, child)
    finally:
        w.path.pop()


# -------------------------------------------------------------- stages ----


def verify_stages(stages, sql: str | None = None) -> VerifyReport:
    """Stage-DAG well-formedness over DistributedPlanner output (a list of
    QueryStage in dependency order). Verifies each stage's plan, then the
    cross-stage contract every UnresolvedShuffleExec placeholder carries:
    the referenced writer stage exists, appears earlier (so the DAG is
    acyclic), agrees on output partition count, and produces the schema
    the placeholder advertises. Raises PlanVerificationError."""
    from ballista_tpu_torch.distributed_plan import find_unresolved_shuffles
    from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec

    w = _Walk("stages", sql)
    w.check()
    if not stages:
        w.fail("job has no stages")
    by_id: dict[int, object] = {}
    order: dict[int, int] = {}
    for i, stage in enumerate(stages):
        w.check()
        if stage.stage_id in by_id:
            w.path.append(f"stage {stage.stage_id}")
            w.fail(f"duplicate stage id {stage.stage_id}")
        by_id[stage.stage_id] = stage
        order[stage.stage_id] = i
    for stage in stages:
        w.path.append(f"stage {stage.stage_id}")
        try:
            w.check()
            if not isinstance(stage.plan, ShuffleWriterExec):
                w.fail(
                    "stage plan root must be ShuffleWriterExec, got "
                    f"{type(stage.plan).__name__}"
                )
            try:
                sub = verify_physical(stage.plan, sql)
            except PlanVerificationError as e:
                # re-anchor the sub-verifier's operator path under the
                # owning stage so the diagnostic names both
                raise PlanVerificationError(
                    e.reason,
                    path=(f"stage {stage.stage_id}",) + e.path,
                    span=e.span,
                ) from None
            w.report.nodes += sub.nodes
            w.report.checks += sub.checks
            for u in find_unresolved_shuffles(stage.plan):
                w.check()
                ref = by_id.get(u.stage_id)
                if ref is None:
                    w.fail(
                        f"reads stage {u.stage_id}, which does not exist "
                        f"in this job (stages: {sorted(by_id)})"
                    )
                if order[u.stage_id] >= order[stage.stage_id]:
                    w.fail(
                        f"reads stage {u.stage_id}, which is not scheduled "
                        "before it (dependency cycle or mis-ordered plan)"
                    )
                w.check()
                if u.output_partition_count != ref.plan.output_partitions:
                    w.fail(
                        f"partition-count mismatch with stage {u.stage_id}: "
                        f"reader expects {u.output_partition_count} "
                        f"partitions, writer produces "
                        f"{ref.plan.output_partitions}"
                    )
                upstream = ref.plan.input.schema()
                mine = u.schema()
                w.check()
                if [
                    (f.name, f.dtype) for f in mine
                ] != [(f.name, f.dtype) for f in upstream]:
                    w.fail(
                        f"schema mismatch with stage {u.stage_id}: reader "
                        f"expects {mine!r}, writer produces {upstream!r}"
                    )
        finally:
            w.path.pop()
    w.report.detail.append(f"{len(stages)} stages")
    return w.report
