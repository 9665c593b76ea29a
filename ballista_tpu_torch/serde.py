"""Plan serde: logical/physical plans and expressions <-> protobuf (port
of ``ballista_tpu/serde.py``).

The reference's core serde layer (ballista/rust/core/src/serde/: the
``AsExecutionPlan`` trait mod.rs:58-81 and the 23-arm physical match
mod.rs:110-643). The messages are the reference's (``proto/``, a verbatim
copy of its generated module), and every field is encoded from the port's
operators as the reference encodes it from its own, so a plan's bytes are
the reference's bytes. Memory scans travel by table name and are rebuilt
through the decoding side's ``TableProvider``; file scans (CSV, Parquet
with its pushed-down predicates, Avro) travel by path and schema, and the
decoding process opens the file itself.

Third-party operators travel as extension nodes through the codec's
``PhysicalExtensionCodec`` (its name, its payload, the children's plans),
as in the reference. A mesh operator (``Mesh*Exec``) travels without its
runtime: the decoding side binds its own ``MeshRuntime`` (an executor's,
over its own shards on its own device).
"""

from __future__ import annotations

from typing import Callable

from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec
from ballista_tpu_torch.errors import InternalError, PlanError
from ballista_tpu_torch.exec.aggregate import HashAggregateExec, decompose_aggregates
from ballista_tpu_torch.exec.base import ExecutionPlan
from ballista_tpu_torch.exec.joins import (
    CrossJoinExec,
    EmptyExec,
    HashJoinExec,
    UnionExec,
)
from ballista_tpu_torch.exec.mesh import (
    MeshAggregateExec,
    MeshJoinExec,
    MeshSortExec,
    MeshWindowExec,
)
from ballista_tpu_torch.exec.percentile import PercentileExec
from ballista_tpu_torch.exec.pipeline import (
    CoalescePartitionsExec,
    FilterExec,
    ProjectionExec,
    RenameExec,
)
from ballista_tpu_torch.exec.planner import TableProvider
from ballista_tpu_torch.exec.repartition import HashRepartitionExec
from ballista_tpu_torch.exec.scan import (
    AvroScanExec,
    CsvScanExec,
    MemoryScanExec,
    ParquetScanExec,
)
from ballista_tpu_torch.exec.sort import GlobalLimitExec, SortExec
from ballista_tpu_torch.exec.window import WindowExec
from ballista_tpu_torch.executor.reader import ShuffleReaderExec
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan import logical as P
from ballista_tpu_torch.plan.logical import SortExpr
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler_types import PartitionLocation

# ----------------------------------------------------------------- types ----

_DT_TO_P = {
    DataType.BOOL: pb.DT_BOOL,
    DataType.INT32: pb.DT_INT32,
    DataType.INT64: pb.DT_INT64,
    DataType.FLOAT32: pb.DT_FLOAT32,
    DataType.FLOAT64: pb.DT_FLOAT64,
    DataType.DATE32: pb.DT_DATE32,
    DataType.TIMESTAMP_US: pb.DT_TIMESTAMP_US,
    DataType.STRING: pb.DT_STRING,
    DataType.NULL: pb.DT_NULL,
}
_DT_FROM_P = {v: k for k, v in _DT_TO_P.items()}


def schema_to_proto(s: Schema) -> pb.SchemaP:
    return pb.SchemaP(
        fields=[
            pb.FieldP(name=f.name, dtype=_DT_TO_P[f.dtype], nullable=f.nullable)
            for f in s
        ]
    )


def schema_from_proto(p: pb.SchemaP) -> Schema:
    return Schema(
        [Field(f.name, _DT_FROM_P[f.dtype], f.nullable) for f in p.fields]
    )


# ----------------------------------------------------------- expressions ----


def expr_to_proto(e: L.Expr) -> pb.ExprNode:
    if isinstance(e, L.Column):
        return pb.ExprNode(column=e.cname)
    if isinstance(e, L.Literal):
        sv = pb.ScalarValueP(dtype=_DT_TO_P[e.dtype])
        if e.value is None:
            sv.null_value = True
        elif e.dtype == DataType.BOOL:
            sv.bool_value = e.value
        elif e.dtype in (DataType.INT32, DataType.INT64):
            sv.int64_value = int(e.value)
        elif e.dtype in (DataType.FLOAT32, DataType.FLOAT64):
            sv.float64_value = float(e.value)
        elif e.dtype == DataType.STRING:
            sv.string_value = e.value
        elif e.dtype == DataType.DATE32:
            sv.date32_value = int(e.value)
        elif e.dtype == DataType.TIMESTAMP_US:
            sv.timestamp_us_value = int(e.value)
        else:
            raise PlanError(f"cannot serialize literal {e!r}")
        return pb.ExprNode(literal=sv)
    if isinstance(e, L.BinaryExpr):
        return pb.ExprNode(
            binary=pb.BinaryExprNode(
                left=expr_to_proto(e.left),
                op=getattr(pb, f"OP_{e.op.name}"),
                right=expr_to_proto(e.right),
            )
        )
    if isinstance(e, L.Not):
        return pb.ExprNode(**{"not": expr_to_proto(e.expr)})
    if isinstance(e, L.Negative):
        return pb.ExprNode(negative=expr_to_proto(e.expr))
    if isinstance(e, L.IsNull):
        return pb.ExprNode(is_null=expr_to_proto(e.expr))
    if isinstance(e, L.IsNotNull):
        return pb.ExprNode(is_not_null=expr_to_proto(e.expr))
    if isinstance(e, L.Cast):
        return pb.ExprNode(
            cast=pb.CastNode(expr=expr_to_proto(e.expr), to=_DT_TO_P[e.to])
        )
    if isinstance(e, L.Case):
        node = pb.CaseNode(
            branches=[
                pb.CaseNode.WhenThen(
                    when=expr_to_proto(c), then=expr_to_proto(v)
                )
                for c, v in e.branches
            ]
        )
        if e.otherwise is not None:
            node.otherwise.CopyFrom(expr_to_proto(e.otherwise))
        return pb.ExprNode(case_=node)
    if isinstance(e, L.InList):
        return pb.ExprNode(
            in_list=pb.InListNode(
                expr=expr_to_proto(e.expr),
                values=[expr_to_proto(v) for v in e.values],
                negated=e.negated,
            )
        )
    if isinstance(e, L.Between):
        return pb.ExprNode(
            between=pb.BetweenNode(
                expr=expr_to_proto(e.expr),
                low=expr_to_proto(e.low),
                high=expr_to_proto(e.high),
                negated=e.negated,
            )
        )
    if isinstance(e, L.Like):
        return pb.ExprNode(
            like=pb.LikeNode(
                expr=expr_to_proto(e.expr), pattern=e.pattern, negated=e.negated
            )
        )
    if isinstance(e, L.Alias):
        return pb.ExprNode(
            alias=pb.AliasNode(expr=expr_to_proto(e.expr), alias=e.aname)
        )
    if isinstance(e, L.PercentileExpr):
        return pb.ExprNode(
            aggregate=pb.AggregateExprNode(
                is_percentile=True, percentile_q=e.q,
                arg=expr_to_proto(e.arg),
            )
        )
    if isinstance(e, L.UdafExpr):
        return pb.ExprNode(
            aggregate=pb.AggregateExprNode(
                udaf=e.uname, arg=expr_to_proto(e.arg)
            )
        )
    if isinstance(e, L.AggregateExpr):
        return pb.ExprNode(
            aggregate=pb.AggregateExprNode(
                func=getattr(pb, f"AGG_{e.func.name}"),
                arg=expr_to_proto(e.arg),
                distinct=e.distinct,
                **(
                    {"arg2": expr_to_proto(e.arg2)}
                    if e.arg2 is not None
                    else {}
                ),
            )
        )
    if isinstance(e, L.ScalarFunction):
        return pb.ExprNode(
            scalar_fn=pb.ScalarFunctionNode(
                name=e.fname, args=[expr_to_proto(a) for a in e.args]
            )
        )
    if isinstance(e, L.Wildcard):
        return pb.ExprNode(wildcard=True)
    if isinstance(e, L.IntervalLiteral):
        return pb.ExprNode(
            interval=pb.IntervalNode(months=e.months, days=e.days)
        )
    raise PlanError(f"cannot serialize expression {type(e).__name__}")


def expr_from_proto(p: pb.ExprNode) -> L.Expr:
    kind = p.WhichOneof("expr")
    if kind == "column":
        return L.Column(p.column)
    if kind == "literal":
        sv = p.literal
        dtype = _DT_FROM_P[sv.dtype]
        vk = sv.WhichOneof("value")
        if vk == "null_value":
            return L.Literal(None, dtype)
        value = getattr(sv, vk)
        if dtype in (DataType.INT32, DataType.INT64, DataType.DATE32,
                     DataType.TIMESTAMP_US):
            value = int(value)
        return L.Literal(value, dtype)
    if kind == "binary":
        return L.BinaryExpr(
            expr_from_proto(p.binary.left),
            L.Operator[pb.OperatorP.Name(p.binary.op)[3:]],
            expr_from_proto(p.binary.right),
        )
    if kind == "not":
        return L.Not(expr_from_proto(getattr(p, "not")))
    if kind == "negative":
        return L.Negative(expr_from_proto(p.negative))
    if kind == "is_null":
        return L.IsNull(expr_from_proto(p.is_null))
    if kind == "is_not_null":
        return L.IsNotNull(expr_from_proto(p.is_not_null))
    if kind == "cast":
        return L.Cast(expr_from_proto(p.cast.expr), _DT_FROM_P[p.cast.to])
    if kind == "case_":
        branches = tuple(
            (expr_from_proto(b.when), expr_from_proto(b.then))
            for b in p.case_.branches
        )
        otherwise = (
            expr_from_proto(p.case_.otherwise)
            if p.case_.HasField("otherwise")
            else None
        )
        return L.Case(branches, otherwise)
    if kind == "in_list":
        return L.InList(
            expr_from_proto(p.in_list.expr),
            tuple(expr_from_proto(v) for v in p.in_list.values),
            p.in_list.negated,
        )
    if kind == "between":
        return L.Between(
            expr_from_proto(p.between.expr),
            expr_from_proto(p.between.low),
            expr_from_proto(p.between.high),
            p.between.negated,
        )
    if kind == "like":
        return L.Like(expr_from_proto(p.like.expr), p.like.pattern, p.like.negated)
    if kind == "alias":
        return L.Alias(expr_from_proto(p.alias.expr), p.alias.alias)
    if kind == "aggregate":
        if p.aggregate.is_percentile:
            return L.PercentileExpr(
                expr_from_proto(p.aggregate.arg), p.aggregate.percentile_q
            )
        if p.aggregate.udaf:
            return L.UdafExpr(
                p.aggregate.udaf, expr_from_proto(p.aggregate.arg)
            )
        return L.AggregateExpr(
            L.AggFunc[pb.AggFuncP.Name(p.aggregate.func)[4:]],
            expr_from_proto(p.aggregate.arg),
            p.aggregate.distinct,
            expr_from_proto(p.aggregate.arg2)
            if p.aggregate.HasField("arg2")
            else None,
        )
    if kind == "scalar_fn":
        return L.ScalarFunction(
            p.scalar_fn.name,
            tuple(expr_from_proto(a) for a in p.scalar_fn.args),
        )
    if kind == "wildcard":
        return L.Wildcard()
    if kind == "interval":
        return L.IntervalLiteral(p.interval.months, p.interval.days)
    raise PlanError(f"cannot deserialize expression kind {kind!r}")


def _sort_exprs_to_proto(sort_exprs) -> list[pb.SortExprNode]:
    return [
        pb.SortExprNode(
            expr=expr_to_proto(s.expr),
            ascending=s.ascending,
            nulls_first=s.nulls_first,
        )
        for s in sort_exprs
    ]


def _sort_exprs_from_proto(ps) -> list[SortExpr]:
    return [
        SortExpr(expr_from_proto(s.expr), s.ascending, s.nulls_first)
        for s in ps
    ]


# ---------------------------------------------------------- logical plan ----


def logical_to_proto(plan: P.LogicalPlan) -> pb.LogicalPlanNode:
    if isinstance(plan, P.TableScan):
        src_kind, src_path, src_header, src_delim = (
            plan.source if plan.source is not None else ("", "", False, ",")
        )
        return pb.LogicalPlanNode(
            table_scan=pb.LogicalTableScanNode(
                table_name=plan.table_name,
                schema=schema_to_proto(plan.source_schema),
                projection=list(plan.projection or ()),
                has_projection=plan.projection is not None,
                filters=[expr_to_proto(f) for f in plan.filters],
                source_kind=src_kind,
                source_path=src_path,
                source_has_header=src_header,
                source_delimiter=src_delim,
            )
        )
    if isinstance(plan, P.Projection):
        return pb.LogicalPlanNode(
            projection=pb.LogicalUnaryExprsNode(
                input=logical_to_proto(plan.input),
                exprs=[expr_to_proto(e) for e in plan.exprs],
            )
        )
    if isinstance(plan, P.Filter):
        return pb.LogicalPlanNode(
            filter=pb.LogicalFilterNode(
                input=logical_to_proto(plan.input),
                predicate=expr_to_proto(plan.predicate),
            )
        )
    if isinstance(plan, P.Aggregate):
        return pb.LogicalPlanNode(
            aggregate=pb.LogicalAggregateNode(
                input=logical_to_proto(plan.input),
                group_exprs=[expr_to_proto(e) for e in plan.group_exprs],
                agg_exprs=[expr_to_proto(e) for e in plan.agg_exprs],
            )
        )
    if isinstance(plan, P.Sort):
        return pb.LogicalPlanNode(
            sort=pb.LogicalSortNode(
                input=logical_to_proto(plan.input),
                sort_exprs=_sort_exprs_to_proto(plan.sort_exprs),
            )
        )
    if isinstance(plan, P.Limit):
        return pb.LogicalPlanNode(
            limit=pb.LogicalLimitNode(
                input=logical_to_proto(plan.input),
                skip=plan.skip,
                fetch=-1 if plan.fetch is None else plan.fetch,
            )
        )
    if isinstance(plan, P.Join):
        node = pb.LogicalJoinNode(
            left=logical_to_proto(plan.left),
            right=logical_to_proto(plan.right),
            on=[
                pb.JoinOnPair(left=expr_to_proto(a), right=expr_to_proto(b))
                for a, b in plan.on
            ],
            join_type=getattr(pb, f"JOIN_{plan.join_type.name}"),
        )
        if plan.filter is not None:
            node.filter.CopyFrom(expr_to_proto(plan.filter))
        return pb.LogicalPlanNode(join=node)
    if isinstance(plan, P.CrossJoin):
        return pb.LogicalPlanNode(
            cross_join=pb.LogicalBinaryNode(
                left=logical_to_proto(plan.left),
                right=logical_to_proto(plan.right),
            )
        )
    if isinstance(plan, P.Union):
        return pb.LogicalPlanNode(
            union=pb.LogicalUnionNode(
                inputs=[logical_to_proto(c) for c in plan.inputs], all=plan.all
            )
        )
    if isinstance(plan, P.Window):
        return pb.LogicalPlanNode(
            window=pb.WindowNode(
                input=logical_to_proto(plan.input),
                exprs=[_window_expr_to_proto(w) for w in plan.window_exprs],
                names=list(plan.names),
            )
        )
    if isinstance(plan, P.Percentile):
        return pb.LogicalPlanNode(
            percentile=pb.PercentileNode(
                input=logical_to_proto(plan.input),
                group_exprs=[expr_to_proto(e) for e in plan.group_exprs],
                group_names=list(plan.group_names),
                values=[expr_to_proto(v) for v, _, _ in plan.requests],
                qs=[q for _, q, _ in plan.requests],
                out_names=[n for _, _, n in plan.requests],
            )
        )
    if isinstance(plan, P.Distinct):
        return pb.LogicalPlanNode(
            distinct=pb.LogicalUnaryNode(input=logical_to_proto(plan.input))
        )
    if isinstance(plan, P.SubqueryAlias):
        return pb.LogicalPlanNode(
            subquery_alias=pb.LogicalAliasNode(
                input=logical_to_proto(plan.input), alias=plan.alias
            )
        )
    if isinstance(plan, P.EmptyRelation):
        return pb.LogicalPlanNode(
            empty=pb.LogicalEmptyNode(
                produce_one_row=plan.produce_one_row,
                schema=schema_to_proto(plan.out_schema),
            )
        )
    raise PlanError(f"cannot serialize logical node {type(plan).__name__}")


def _window_expr_to_proto(w) -> pb.WindowExprNode:
    node = pb.WindowExprNode(
        fname=w.fname,
        partition_by=[expr_to_proto(e) for e in w.partition_by],
        order_exprs=[expr_to_proto(e) for e, _, _ in w.order_by],
        order_asc=[asc for _, asc, _ in w.order_by],
        order_nulls=[
            -1 if nf is None else int(nf) for _, _, nf in w.order_by
        ],
        shift_offset=w.offset,
    )
    if w.arg is not None:
        node.arg.CopyFrom(expr_to_proto(w.arg))
        node.has_arg = True
    if w.frame is not None:
        node.frame.CopyFrom(
            pb.WindowFrameP(
                units=w.frame.units,
                start_type=w.frame.start_type,
                start_n=w.frame.start_n,
                end_type=w.frame.end_type,
                end_n=w.frame.end_n,
            )
        )
        node.has_frame = True
    return node


def _window_expr_from_proto(w: pb.WindowExprNode):
    frame = None
    if w.has_frame:
        frame = L.WindowFrame(
            w.frame.units,
            w.frame.start_type,
            int(w.frame.start_n),
            w.frame.end_type,
            int(w.frame.end_n),
        )
    return L.WindowFunction(
        w.fname,
        tuple(expr_from_proto(e) for e in w.partition_by),
        tuple(
            (expr_from_proto(e), asc, None if nf < 0 else bool(nf))
            for e, asc, nf in zip(w.order_exprs, w.order_asc, w.order_nulls)
        ),
        arg=expr_from_proto(w.arg) if w.has_arg else None,
        frame=frame,
        # the field is meaningful only for shifts — LAG(x, 0) is a valid
        # explicit zero and must not be conflated with proto default 0
        offset=(
            int(w.shift_offset) if w.fname in ("lag", "lead") else 1
        ),
    )


def logical_from_proto(p: pb.LogicalPlanNode) -> P.LogicalPlan:
    kind = p.WhichOneof("plan")
    if kind == "table_scan":
        n = p.table_scan
        return P.TableScan(
            n.table_name,
            schema_from_proto(n.schema),
            tuple(n.projection) if n.has_projection else None,
            tuple(expr_from_proto(f) for f in n.filters),
            (n.source_kind, n.source_path, n.source_has_header,
             n.source_delimiter or ",")
            if n.source_kind
            else None,
        )
    if kind == "projection":
        return P.Projection(
            logical_from_proto(p.projection.input),
            tuple(expr_from_proto(e) for e in p.projection.exprs),
        )
    if kind == "filter":
        return P.Filter(
            logical_from_proto(p.filter.input),
            expr_from_proto(p.filter.predicate),
        )
    if kind == "aggregate":
        return P.Aggregate(
            logical_from_proto(p.aggregate.input),
            tuple(expr_from_proto(e) for e in p.aggregate.group_exprs),
            tuple(expr_from_proto(e) for e in p.aggregate.agg_exprs),
        )
    if kind == "sort":
        return P.Sort(
            logical_from_proto(p.sort.input),
            tuple(_sort_exprs_from_proto(p.sort.sort_exprs)),
        )
    if kind == "limit":
        return P.Limit(
            logical_from_proto(p.limit.input),
            int(p.limit.skip),
            None if p.limit.fetch < 0 else int(p.limit.fetch),
        )
    if kind == "join":
        n = p.join
        return P.Join(
            logical_from_proto(n.left),
            logical_from_proto(n.right),
            tuple(
                (expr_from_proto(o.left), expr_from_proto(o.right))
                for o in n.on
            ),
            P.JoinType[pb.JoinTypeP.Name(n.join_type)[5:]],
            expr_from_proto(n.filter) if n.HasField("filter") else None,
        )
    if kind == "cross_join":
        return P.CrossJoin(
            logical_from_proto(p.cross_join.left),
            logical_from_proto(p.cross_join.right),
        )
    if kind == "union":
        return P.Union(
            tuple(logical_from_proto(c) for c in p.union.inputs), p.union.all
        )
    if kind == "distinct":
        return P.Distinct(logical_from_proto(p.distinct.input))
    if kind == "window":
        return P.Window(
            logical_from_proto(p.window.input),
            tuple(_window_expr_from_proto(w) for w in p.window.exprs),
            tuple(p.window.names),
        )
    if kind == "percentile":
        n = p.percentile
        return P.Percentile(
            logical_from_proto(n.input),
            tuple(expr_from_proto(e) for e in n.group_exprs),
            tuple(n.group_names),
            tuple(
                (expr_from_proto(v), q, nm)
                for v, q, nm in zip(n.values, n.qs, n.out_names)
            ),
        )
    if kind == "subquery_alias":
        return P.SubqueryAlias(
            logical_from_proto(p.subquery_alias.input), p.subquery_alias.alias
        )
    if kind == "empty":
        return P.EmptyRelation(
            p.empty.produce_one_row, schema_from_proto(p.empty.schema)
        )
    raise PlanError(f"cannot deserialize logical node kind {kind!r}")


# --------------------------------------------------------- physical plan ----


class PhysicalExtensionCodec:
    """Third-party operator codec (ref serde/mod.rs:83-122): encode returns
    (codec_name, payload, children); decode rebuilds the operator."""

    name: str = "default"

    def try_encode(self, plan: ExecutionPlan) -> bytes | None:
        return None

    def try_decode(
        self, payload: bytes, inputs: list[ExecutionPlan]
    ) -> ExecutionPlan:
        raise PlanError("default codec cannot decode extensions")


class BallistaCodec:
    """Pairs the built-in serde with an optional extension codec (ref
    BallistaCodec, serde/mod.rs:125-165)."""

    def __init__(
        self,
        provider: TableProvider | None = None,
        extension: PhysicalExtensionCodec | None = None,
        mesh_runtime=None,
        device="cuda",
    ):
        self.provider = provider
        self.extension = extension or PhysicalExtensionCodec()
        # binds decoded Mesh*Exec nodes to THIS process's mesh (an executor
        # decodes a scheduler-planned mesh stage chain against its own
        # shards); None: one is built at the first mesh node, over the
        # process's shard count on ``device``
        self.mesh_runtime = mesh_runtime
        self.device = device

    def _mesh_runtime(self):
        if self.mesh_runtime is None:
            from ballista_tpu_torch.exec.mesh import MeshRuntime
            from ballista_tpu_torch.parallel import make_mesh

            self.mesh_runtime = MeshRuntime(make_mesh(device=self.device))
        return self.mesh_runtime

    # -- encode --------------------------------------------------------------
    def physical_to_proto(self, plan: ExecutionPlan) -> pb.PhysicalPlanNode:
        if isinstance(plan, (MemoryScanExec, CsvScanExec, AvroScanExec, ParquetScanExec)):
            return self._scan_to_proto(plan)
        if isinstance(plan, FilterExec):
            return pb.PhysicalPlanNode(
                filter=pb.PhysicalFilterNode(
                    input=self.physical_to_proto(plan.input),
                    predicate=expr_to_proto(plan.predicate),
                )
            )
        if isinstance(plan, ProjectionExec):
            return pb.PhysicalPlanNode(
                projection=pb.PhysicalProjectionNode(
                    input=self.physical_to_proto(plan.input),
                    exprs=[expr_to_proto(e) for e in plan.exprs],
                )
            )
        if isinstance(plan, HashAggregateExec):
            return pb.PhysicalPlanNode(
                aggregate=pb.PhysicalAggregateNode(
                    input=self.physical_to_proto(plan.input),
                    group_exprs=[expr_to_proto(e) for e in plan.group_exprs],
                    agg_exprs=[expr_to_proto(e) for e in plan.agg_exprs],
                    mode=plan.mode,
                    capacity=plan.capacity or 0,
                    input_schema=schema_to_proto(plan.planned_input_schema),
                )
            )
        if isinstance(plan, SortExec):
            return pb.PhysicalPlanNode(
                sort=pb.PhysicalSortNode(
                    input=self.physical_to_proto(plan.input),
                    sort_exprs=_sort_exprs_to_proto(plan.sort_exprs),
                    fetch=-1 if plan.fetch is None else plan.fetch,
                )
            )
        if isinstance(plan, GlobalLimitExec):
            return pb.PhysicalPlanNode(
                limit=pb.PhysicalLimitNode(
                    input=self.physical_to_proto(plan.input),
                    skip=plan.skip,
                    fetch=-1 if plan.fetch is None else plan.fetch,
                )
            )
        if isinstance(plan, HashJoinExec):
            node = pb.PhysicalJoinNode(
                left=self.physical_to_proto(plan.left),
                right=self.physical_to_proto(plan.right),
                on=[
                    pb.JoinOnPair(
                        left=expr_to_proto(a), right=expr_to_proto(b)
                    )
                    for a, b in plan.on
                ],
                join_type=getattr(pb, f"JOIN_{plan.join_type.name}"),
                partition_mode=plan.partition_mode,
            )
            if plan.filter is not None:
                node.filter.CopyFrom(expr_to_proto(plan.filter))
            return pb.PhysicalPlanNode(join=node)
        if isinstance(plan, HashRepartitionExec):
            return pb.PhysicalPlanNode(
                repartition=pb.PhysicalRepartitionNode(
                    input=self.physical_to_proto(plan.input),
                    keys=[expr_to_proto(k) for k in plan.keys],
                    partitions=plan.partitions,
                )
            )
        if isinstance(plan, MeshAggregateExec):
            return pb.PhysicalPlanNode(
                mesh_aggregate=pb.PhysicalMeshAggregateNode(
                    input=self.physical_to_proto(plan.input),
                    group_exprs=[expr_to_proto(e) for e in plan.group_exprs],
                    agg_exprs=[expr_to_proto(e) for e in plan.agg_exprs],
                )
            )
        if isinstance(plan, MeshJoinExec):
            node = pb.PhysicalMeshJoinNode(
                left=self.physical_to_proto(plan.left),
                right=self.physical_to_proto(plan.right),
                on=[
                    pb.JoinOnPair(left=expr_to_proto(a), right=expr_to_proto(b))
                    for a, b in plan.on
                ],
                join_type=getattr(pb, f"JOIN_{plan.join_type.name}"),
            )
            if plan.filter is not None:
                node.filter.CopyFrom(expr_to_proto(plan.filter))
            return pb.PhysicalPlanNode(mesh_join=node)
        if isinstance(plan, MeshSortExec):
            return pb.PhysicalPlanNode(
                mesh_sort=pb.PhysicalMeshSortNode(
                    input=self.physical_to_proto(plan.input),
                    sort_exprs=_sort_exprs_to_proto(plan.sort_exprs),
                    fetch=-1 if plan.fetch is None else plan.fetch,
                )
            )
        if isinstance(plan, MeshWindowExec):
            return pb.PhysicalPlanNode(
                mesh_window=pb.PhysicalMeshWindowNode(
                    input=self.physical_to_proto(plan.input),
                    exprs=[_window_expr_to_proto(w) for w in plan.window_exprs],
                    names=list(plan.names),
                )
            )
        if isinstance(plan, CrossJoinExec):
            return pb.PhysicalPlanNode(
                cross_join=pb.PhysicalBinaryNode(
                    left=self.physical_to_proto(plan.left),
                    right=self.physical_to_proto(plan.right),
                )
            )
        if isinstance(plan, UnionExec):
            return pb.PhysicalPlanNode(
                union=pb.PhysicalUnionNode(
                    inputs=[self.physical_to_proto(c) for c in plan.inputs]
                )
            )
        if isinstance(plan, RenameExec):
            return pb.PhysicalPlanNode(
                rename=pb.PhysicalRenameNode(
                    input=self.physical_to_proto(plan.input),
                    schema=schema_to_proto(plan.schema()),
                )
            )
        if isinstance(plan, CoalescePartitionsExec):
            return pb.PhysicalPlanNode(
                coalesce_partitions=pb.PhysicalUnaryNode(
                    input=self.physical_to_proto(plan.input)
                )
            )
        if isinstance(plan, WindowExec):
            return pb.PhysicalPlanNode(
                window=pb.PhysicalWindowNode(
                    input=self.physical_to_proto(plan.input),
                    exprs=[
                        _window_expr_to_proto(w) for w in plan.window_exprs
                    ],
                    names=list(plan.names),
                )
            )
        if isinstance(plan, PercentileExec):
            return pb.PhysicalPlanNode(
                percentile=pb.PhysicalPercentileNode(
                    input=self.physical_to_proto(plan.input),
                    group_exprs=[
                        expr_to_proto(e) for e in plan.group_exprs
                    ],
                    group_names=list(plan.group_names),
                    values=[expr_to_proto(v) for v, _, _ in plan.requests],
                    qs=[q for _, q, _ in plan.requests],
                    out_names=[n for _, _, n in plan.requests],
                )
            )
        if isinstance(plan, EmptyExec):
            return pb.PhysicalPlanNode(
                empty=pb.PhysicalEmptyNode(
                    produce_one_row=plan.produce_one_row,
                    schema=schema_to_proto(plan.schema()),
                )
            )
        if isinstance(plan, ShuffleWriterExec):
            return pb.PhysicalPlanNode(
                shuffle_writer=pb.ShuffleWriterExecNode(
                    job_id=plan.job_id,
                    stage_id=plan.stage_id,
                    input=self.physical_to_proto(plan.input),
                    partition_keys=[
                        expr_to_proto(e) for e in plan.partition_keys
                    ],
                    output_partitions=plan.output_partitions,
                )
            )
        if isinstance(plan, ShuffleReaderExec):
            return pb.PhysicalPlanNode(
                shuffle_reader=pb.ShuffleReaderExecNode(
                    partitions=[
                        pb.ShuffleReaderPartition(
                            locations=[loc_to_proto(l) for l in locs]
                        )
                        for locs in plan.partition_locations
                    ],
                    schema=schema_to_proto(plan.schema()),
                    # eager mode: locations are polled, not baked in
                    # (proto3 skips the defaults, keeping barriered
                    # encodings byte-identical to the pre-eager wire)
                    job_id=plan.job_id,
                    stage_id=plan.stage_id,
                    eager=plan.eager,
                )
            )
        if isinstance(plan, UnresolvedShuffleExec):
            return pb.PhysicalPlanNode(
                unresolved_shuffle=pb.UnresolvedShuffleExecNode(
                    stage_id=plan.stage_id,
                    schema=schema_to_proto(plan.schema()),
                    input_partition_count=plan.input_partition_count,
                    output_partition_count=plan.output_partition_count,
                )
            )
        payload = self.extension.try_encode(plan)
        if payload is not None:
            return pb.PhysicalPlanNode(
                extension=pb.PhysicalExtensionNode(
                    codec=self.extension.name,
                    payload=payload,
                    inputs=[self.physical_to_proto(c) for c in plan.children()],
                )
            )
        raise PlanError(
            f"cannot serialize physical node {type(plan).__name__}"
        )

    def _scan_to_proto(self, plan: ExecutionPlan) -> pb.PhysicalPlanNode:
        common = dict(
            table_name=getattr(plan, "table_name", ""),
            projection=plan.projection or [],
            has_projection=plan.projection is not None,
            partitions=plan.partitions,
        )
        if isinstance(plan, MemoryScanExec):
            node = pb.ScanExecNode(
                kind="memory", table_schema=schema_to_proto(plan.schema()), **common
            )
            if not node.table_name:
                raise PlanError(
                    "memory scan without a registered table name cannot "
                    "cross process boundaries"
                )
            return pb.PhysicalPlanNode(scan=node)
        file_schema = schema_to_proto(plan.table_schema)
        if isinstance(plan, CsvScanExec):
            node = pb.ScanExecNode(
                kind="csv", path=plan.path, table_schema=file_schema,
                has_header=plan.has_header, delimiter=plan.delimiter, **common,
            )
        elif isinstance(plan, AvroScanExec):
            node = pb.ScanExecNode(kind="avro", path=plan.path, table_schema=file_schema, **common)
        else:
            node = pb.ScanExecNode(
                kind="parquet", path=plan.path, table_schema=file_schema,
                filters=[expr_to_proto(e) for e in plan.predicates], **common,
            )
        return pb.PhysicalPlanNode(scan=node)

    # -- decode --------------------------------------------------------------
    def physical_from_proto(self, p: pb.PhysicalPlanNode) -> ExecutionPlan:
        kind = p.WhichOneof("plan")
        if kind == "scan":
            return self._scan_from_proto(p.scan)
        if kind == "filter":
            return FilterExec(
                self.physical_from_proto(p.filter.input),
                expr_from_proto(p.filter.predicate),
            )
        if kind == "projection":
            return ProjectionExec(
                self.physical_from_proto(p.projection.input),
                [expr_from_proto(e) for e in p.projection.exprs],
            )
        if kind == "aggregate":
            n = p.aggregate
            group = [expr_from_proto(e) for e in n.group_exprs]
            aggs = [expr_from_proto(e) for e in n.agg_exprs]
            input_schema = schema_from_proto(n.input_schema)
            spec = decompose_aggregates(group, aggs, input_schema)
            return HashAggregateExec(
                self.physical_from_proto(n.input),
                group,
                aggs,
                mode=n.mode,
                spec=spec if n.mode == "final" else None,
                capacity=n.capacity or None,
                planned_input_schema=input_schema,
            )
        if kind == "sort":
            n = p.sort
            return SortExec(
                self.physical_from_proto(n.input),
                _sort_exprs_from_proto(n.sort_exprs),
                None if n.fetch < 0 else int(n.fetch),
            )
        if kind == "limit":
            return GlobalLimitExec(
                self.physical_from_proto(p.limit.input),
                int(p.limit.skip),
                None if p.limit.fetch < 0 else int(p.limit.fetch),
            )
        if kind == "join":
            n = p.join
            return HashJoinExec(
                self.physical_from_proto(n.left),
                self.physical_from_proto(n.right),
                [
                    (expr_from_proto(o.left), expr_from_proto(o.right))
                    for o in n.on
                ],
                P.JoinType[pb.JoinTypeP.Name(n.join_type)[5:]],
                expr_from_proto(n.filter) if n.HasField("filter") else None,
                partition_mode=n.partition_mode or "collect",
            )
        if kind == "repartition":
            n = p.repartition
            return HashRepartitionExec(
                self.physical_from_proto(n.input),
                [expr_from_proto(k) for k in n.keys],
                int(n.partitions),
            )
        if kind == "mesh_aggregate":
            n = p.mesh_aggregate
            return MeshAggregateExec(
                self.physical_from_proto(n.input),
                [expr_from_proto(e) for e in n.group_exprs],
                [expr_from_proto(e) for e in n.agg_exprs],
                self._mesh_runtime(),
            )
        if kind == "mesh_join":
            n = p.mesh_join
            return MeshJoinExec(
                self.physical_from_proto(n.left),
                self.physical_from_proto(n.right),
                [(expr_from_proto(o.left), expr_from_proto(o.right)) for o in n.on],
                P.JoinType[pb.JoinTypeP.Name(n.join_type)[5:]],
                expr_from_proto(n.filter) if n.HasField("filter") else None,
                self._mesh_runtime(),
            )
        if kind == "mesh_sort":
            n = p.mesh_sort
            return MeshSortExec(
                self.physical_from_proto(n.input),
                _sort_exprs_from_proto(n.sort_exprs),
                # unbounded: -1 by the fetch convention above; 0 from plans
                # encoded before the convention reached this node
                None if n.fetch <= 0 else int(n.fetch),
                self._mesh_runtime(),
            )
        if kind == "mesh_window":
            n = p.mesh_window
            return MeshWindowExec(
                self.physical_from_proto(n.input),
                [_window_expr_from_proto(w) for w in n.exprs],
                list(n.names),
                self._mesh_runtime(),
            )
        if kind == "cross_join":
            return CrossJoinExec(
                self.physical_from_proto(p.cross_join.left),
                self.physical_from_proto(p.cross_join.right),
            )
        if kind == "union":
            return UnionExec(
                [self.physical_from_proto(c) for c in p.union.inputs]
            )
        if kind == "rename":
            return RenameExec(
                self.physical_from_proto(p.rename.input),
                schema_from_proto(p.rename.schema),
            )
        if kind == "coalesce_partitions":
            return CoalescePartitionsExec(
                self.physical_from_proto(p.coalesce_partitions.input)
            )
        if kind == "window":
            return WindowExec(
                self.physical_from_proto(p.window.input),
                [_window_expr_from_proto(w) for w in p.window.exprs],
                list(p.window.names),
            )
        if kind == "percentile":
            n = p.percentile
            return PercentileExec(
                self.physical_from_proto(n.input),
                [expr_from_proto(e) for e in n.group_exprs],
                list(n.group_names),
                [
                    (expr_from_proto(v), q, nm)
                    for v, q, nm in zip(n.values, n.qs, n.out_names)
                ],
            )
        if kind == "empty":
            return EmptyExec(
                p.empty.produce_one_row, schema_from_proto(p.empty.schema)
            )
        if kind == "shuffle_writer":
            n = p.shuffle_writer
            return ShuffleWriterExec(
                n.job_id,
                n.stage_id,
                self.physical_from_proto(n.input),
                [expr_from_proto(e) for e in n.partition_keys],
                n.output_partitions,
            )
        if kind == "shuffle_reader":
            n = p.shuffle_reader
            return ShuffleReaderExec(
                [
                    [loc_from_proto(l) for l in part.locations]
                    for part in n.partitions
                ],
                schema_from_proto(n.schema),
                job_id=n.job_id,
                stage_id=n.stage_id,
                eager=n.eager,
            )
        if kind == "unresolved_shuffle":
            n = p.unresolved_shuffle
            return UnresolvedShuffleExec(
                n.stage_id,
                schema_from_proto(n.schema),
                n.input_partition_count,
                n.output_partition_count,
            )
        if kind == "extension":
            n = p.extension
            if n.codec != self.extension.name:
                raise PlanError(f"no codec registered for extension {n.codec!r}")
            return self.extension.try_decode(
                n.payload, [self.physical_from_proto(c) for c in n.inputs]
            )
        raise PlanError(f"cannot deserialize physical node kind {kind!r}")

    def _scan_from_proto(self, n: pb.ScanExecNode) -> ExecutionPlan:
        projection = list(n.projection) if n.has_projection else None
        if n.kind == "memory":
            if self.provider is None:
                raise InternalError("memory scan decode requires a provider")
            plan = self.provider.scan(n.table_name, projection, n.partitions or 1)
        else:
            schema = schema_from_proto(n.table_schema)
            if n.kind == "csv":
                plan = CsvScanExec(
                    n.path, schema, n.has_header, n.delimiter or ",", projection, n.partitions or 1
                )
            elif n.kind == "avro":
                plan = AvroScanExec(n.path, schema, projection, n.partitions or 1)
            else:
                plan = ParquetScanExec(
                    n.path, schema, projection, n.partitions or 1,
                    predicates=[expr_from_proto(e) for e in n.filters],
                )
        # a decoded plan must re-encode (a stage reloaded from a scheduler's
        # state is dispatched again), and memory scans encode by name
        plan.table_name = n.table_name
        return plan


def loc_to_proto(loc) -> pb.PartitionLocation:
    """PartitionLocation dataclass -> proto (scheduler domain types,
    ref serde/scheduler/to_proto.rs)."""
    return pb.PartitionLocation(
        partition_id=pb.PartitionId(
            job_id=loc.job_id, stage_id=loc.stage_id, partition_id=loc.partition
        ),
        executor_meta=pb.ExecutorMetadata(
            id=loc.executor_id, host=loc.host, port=loc.port
        ),
        path=loc.path,
        push=loc.push,
        map_partition=loc.map_partition,
    )


def loc_from_proto(p: pb.PartitionLocation) -> PartitionLocation:
    return PartitionLocation(
        job_id=p.partition_id.job_id,
        stage_id=p.partition_id.stage_id,
        partition=p.partition_id.partition_id,
        executor_id=p.executor_meta.id,
        host=p.executor_meta.host,
        port=p.executor_meta.port,
        path=p.path,
        push=bool(p.push),
        map_partition=int(p.map_partition),
    )
