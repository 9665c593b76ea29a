"""Physical planner: logical plan -> ExecutionPlan tree (port of
``ballista_tpu/exec/planner.py``, single-process tier).

It builds the reference's operator tree node for node, so a plan's
``display()`` is the reference's: aggregates and DISTINCT lower to a
partial/final pair around a coalesce, pushed-down scan filters become
FilterExecs, sorts and limits gather their input, joins lower to
collect-mode hash joins (RIGHT flipped to LEFT, FULL as LEFT UNION ALL a
padded ANTI, the build side of a SEMI or ANTI join without a residual
filter deduplicated on its keys), cross joins broadcast a one-row side, a
subquery alias renames, and windows and percentiles gather their input.
A file table describes itself (``TableScan.source``), so its scan needs no
catalog; a provider that registered the same file lends the scan its
registration-lifetime ``scan_cache`` (``file_scan_cache``).

With ``distributed=True`` it plans for the multi-executor tier, as the
reference does: a hash repartition on the group keys between a GROUP BY's
partial and final aggregates (``ballista.repartition.aggregations``), a
partitioned join over a hash repartition of both sides for joins without
string keys (``ballista.repartition.joins``), and an explicit gather under
a sort of a multi-partition input. Such a tree also runs in process (the
repartitions mask their output partitions).

With a ``mesh_runtime`` (``exec/mesh.MeshRuntime``: a mesh of two or more
shards with ``ballista.tpu.collective_shuffle`` on) it lowers to the mesh
operators where the reference does: a grouped aggregate and DISTINCT to
``MeshAggregateExec`` (a scalar aggregate stays local), an INNER join and
a LEFT, SEMI or ANTI join without a residual filter to ``MeshJoinExec``, a
sort to ``MeshSortExec``'s sample sort, a limit over a sort to its top-k,
and a window whose expressions share one PARTITION BY set to
``MeshWindowExec``. A ``PlanError`` from a mesh constructor falls back to
the local operator.
"""

from __future__ import annotations

from ballista_tpu_torch.datatypes import DataType
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.aggregate import HashAggregateExec
from ballista_tpu_torch.exec.base import ExecutionPlan
from ballista_tpu_torch.exec.joins import CrossJoinExec, EmptyExec, HashJoinExec, UnionExec
from ballista_tpu_torch.exec.mesh import MeshAggregateExec, MeshJoinExec, MeshSortExec, MeshWindowExec
from ballista_tpu_torch.exec.percentile import PercentileExec
from ballista_tpu_torch.exec.repartition import HashRepartitionExec
from ballista_tpu_torch.exec.scan import AvroScanExec, CsvScanExec, ParquetScanExec
from ballista_tpu_torch.exec.pipeline import (
    CoalescePartitionsExec,
    FilterExec,
    ProjectionExec,
    RenameExec,
)
from ballista_tpu_torch.exec.sort import GlobalLimitExec, SortExec
from ballista_tpu_torch.exec.window import WindowExec
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan import logical as P


class TableProvider:
    """Resolves a table name to a scan operator."""

    def scan(
        self, table: str, projection: list[str] | None, partitions: int
    ) -> ExecutionPlan:
        raise NotImplementedError


class PhysicalPlanner:
    def __init__(
        self,
        provider: TableProvider,
        partitions: int = 2,
        mesh_runtime=None,
        config=None,
        distributed: bool = False,
    ):
        """``mesh_runtime``: an ``exec.mesh.MeshRuntime`` when the mesh tier
        is active; the planner then lowers to the mesh operators.

        ``distributed``: plan hash-exchange boundaries at aggregates and
        joins (honouring ``config``'s ``ballista.repartition.*`` keys), where
        a stage splitter cuts the plan into shuffled stages. The in-process
        tier leaves them out: one device gains nothing from a masked K-way
        fan-out."""
        self.provider = provider
        self.partitions = partitions
        self.mesh_runtime = mesh_runtime
        self.config = config
        self.distributed = distributed

    def _repartition_aggregations(self) -> bool:
        return (
            self.distributed
            and self.partitions > 1
            and (self.config is None or self.config.repartition_aggregations())
        )

    def _repartition_joins(self) -> bool:
        return (
            self.distributed
            and self.partitions > 1
            and (self.config is None or self.config.repartition_joins())
        )

    def plan(self, logical: P.LogicalPlan) -> ExecutionPlan:
        return self._plan(logical)

    def _plan(self, node: P.LogicalPlan) -> ExecutionPlan:
        if isinstance(node, P.TableScan):
            projection = list(node.projection) if node.projection else None
            if node.source is not None and node.source[0] in ("csv", "parquet", "avro"):
                kind, path, has_header, delimiter = node.source
                lend = getattr(self.provider, "file_scan_cache", None)
                cache = lend(node.table_name, node.source) if lend is not None else None
                if kind == "csv":
                    scan: ExecutionPlan = CsvScanExec(
                        path, node.source_schema, has_header, delimiter,
                        projection, self.partitions, scan_cache=cache,
                    )
                elif kind == "avro":
                    scan = AvroScanExec(
                        path, node.source_schema, projection, self.partitions, scan_cache=cache
                    )
                else:
                    scan = ParquetScanExec(
                        path, node.source_schema, projection, self.partitions,
                        predicates=list(node.filters), scan_cache=cache,
                    )
            else:
                scan = self.provider.scan(node.table_name, projection, self.partitions)
                if isinstance(scan, ParquetScanExec):
                    scan.predicates = list(node.filters)
            scan.table_name = node.table_name
            for f in node.filters:
                scan = FilterExec(scan, f)
            return scan
        if isinstance(node, P.Projection):
            return ProjectionExec(self._plan(node.input), list(node.exprs))
        if isinstance(node, P.Filter):
            return FilterExec(self._plan(node.input), node.predicate)
        if isinstance(node, P.Percentile):
            return PercentileExec(
                self._plan(node.input), node.group_exprs, node.group_names, node.requests
            )
        if isinstance(node, P.Window):
            child = self._plan(node.input)
            if self.mesh_runtime is not None:
                # partition-keyed windows exchange rows by PARTITION BY and
                # run shard-local; other windows gather below
                try:
                    return MeshWindowExec(
                        child, list(node.window_exprs), list(node.names), self.mesh_runtime
                    )
                except PlanError:
                    pass
            # the window operator gathers every input partition itself
            return WindowExec(child, list(node.window_exprs), list(node.names))
        if isinstance(node, P.Aggregate):
            child = self._plan(node.input)
            if self.mesh_runtime is not None and node.group_exprs:
                # one mesh stage; a scalar aggregate's state is one row,
                # with nothing to exchange, and stays local
                return MeshAggregateExec(
                    child, list(node.group_exprs), list(node.agg_exprs), self.mesh_runtime
                )
            return self._two_phase(
                child, list(node.group_exprs), list(node.agg_exprs),
                repartition=bool(node.group_exprs) and self._repartition_aggregations(),
            )
        if isinstance(node, P.Distinct):
            child = self._plan(node.input)
            groups = [L.Column(f.name) for f in node.input.schema()]
            if self.mesh_runtime is not None:
                return MeshAggregateExec(child, groups, [], self.mesh_runtime)
            return self._two_phase(child, groups, [])
        if isinstance(node, P.Sort):
            child = self._plan(node.input)
            if self.mesh_runtime is not None:
                # the sample sort (range exchange + local sort) instead of
                # the coalesce funnel
                try:
                    return MeshSortExec(child, list(node.sort_exprs), None, self.mesh_runtime)
                except PlanError:
                    pass  # non-column keys: the funnel below
            if self.distributed and child.output_partitioning().n > 1:
                # an explicit gather, where the stage splitter cuts: an
                # upstream K-way final aggregate keeps its K tasks
                child = CoalescePartitionsExec(child)
            return SortExec(child, list(node.sort_exprs))
        if isinstance(node, P.Limit):
            if (
                self.mesh_runtime is not None
                and node.fetch is not None
                and isinstance(node.input, P.Sort)
            ):
                # ORDER BY + LIMIT: the mesh top-k (local top-k per shard,
                # the candidates gathered and merged)
                sort_node = node.input
                try:
                    ms = MeshSortExec(
                        self._plan(sort_node.input), list(sort_node.sort_exprs),
                        node.skip + node.fetch, self.mesh_runtime,
                    )
                    return GlobalLimitExec(ms, node.skip, node.fetch)
                except PlanError:
                    pass  # non-column keys or fetch 0: planned below
            child = self._plan(node.input)
            if child.output_partitioning().n > 1:
                child = CoalescePartitionsExec(child)
            return GlobalLimitExec(child, node.skip, node.fetch)
        if isinstance(node, P.Join):
            return self._plan_join(node)
        if isinstance(node, P.CrossJoin):
            return CrossJoinExec(self._plan(node.left), self._plan(node.right))
        if isinstance(node, P.Union):
            return UnionExec([self._plan(c) for c in node.inputs])
        if isinstance(node, P.SubqueryAlias):
            return RenameExec(self._plan(node.input), node.schema())
        if isinstance(node, P.EmptyRelation):
            return EmptyExec(node.produce_one_row, node.out_schema)
        raise PlanError(f"cannot lower {type(node).__name__} to physical plan")

    def _two_phase(
        self, child: ExecutionPlan, groups: list, aggs: list, repartition: bool = False
    ) -> ExecutionPlan:
        """A partial aggregate per input partition, then a final merge
        behind a coalesce, or, with ``repartition``, behind a hash exchange
        of the partial states on the group keys (K parallel merges)."""
        partial = HashAggregateExec(child, groups, aggs, mode="partial")
        if repartition:
            keys = [L.Column(f.name) for f in partial.schema().fields[: len(groups)]]
            merged = HashRepartitionExec(partial, keys, self.partitions)
        else:
            merged = CoalescePartitionsExec(partial)
        return HashAggregateExec(
            merged, groups, aggs, mode="final", spec=partial.spec,
            planned_input_schema=partial.planned_input_schema,
        )

    def _plan_join(self, node: P.Join) -> ExecutionPlan:
        jt = node.join_type
        if jt == P.JoinType.FULL:
            # LEFT(l, r) UNION ALL (r ANTI l, the left columns padded with
            # typed NULLs); the ANTI side carries the residual filter: a
            # right row is unmatched when no pair passed keys and filter
            left_part = P.Join(node.left, node.right, node.on, P.JoinType.LEFT, node.filter)
            anti_part = P.Join(
                node.right, node.left,
                tuple((b, a) for a, b in node.on),
                P.JoinType.ANTI, node.filter,
            )
            pad = [L.Alias(L.Literal(None, f.dtype), f.name) for f in node.left.schema()]
            pad += [L.Column(f.name) for f in node.right.schema()]
            return UnionExec(
                [self._plan_join(left_part), ProjectionExec(self._plan_join(anti_part), pad)]
            )
        if jt == P.JoinType.RIGHT:
            # flip to LEFT; a projection restores the column order
            flipped = P.Join(
                node.right, node.left,
                tuple((b, a) for a, b in node.on),
                P.JoinType.LEFT, node.filter,
            )
            return ProjectionExec(
                self._plan_join(flipped), [L.Column(f.name) for f in node.schema()]
            )
        left = self._plan(node.left)
        right = self._plan(node.right)
        if self.mesh_runtime is not None and (
            jt == P.JoinType.INNER
            or (
                jt in (P.JoinType.LEFT, P.JoinType.SEMI, P.JoinType.ANTI)
                and node.filter is None
            )
        ):
            # partitioned over the mesh; the probe counts matches, so a
            # SEMI or ANTI build needs no dedup
            return MeshJoinExec(left, right, list(node.on), jt, node.filter, self.mesh_runtime)
        # string keys are dictionary-coded, and two executors cannot route
        # codes alike without a shared dictionary: those joins stay in
        # collect (broadcast-build) mode
        no_string_keys = all(
            a.data_type(node.left.schema()) != DataType.STRING
            and b.data_type(node.right.schema()) != DataType.STRING
            for a, b in node.on
        )
        if (
            self._repartition_joins()
            and no_string_keys
            and jt in (P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.SEMI, P.JoinType.ANTI)
        ):
            # partitioned mode: both sides hash-exchanged on the join keys,
            # each of K partitions joins its bucket; duplicate build keys
            # expand per bucket, so SEMI and ANTI need no dedup
            left = HashRepartitionExec(left, [a for a, _ in node.on], self.partitions)
            right = HashRepartitionExec(right, [b for _, b in node.on], self.partitions)
            return HashJoinExec(
                left, right, list(node.on), jt, node.filter, partition_mode="partitioned"
            )
        if jt in (P.JoinType.SEMI, P.JoinType.ANTI) and node.filter is None:
            # the probe needs a unique build side, and existence semantics
            # allow deduplicating it on the join keys
            keys = [b for _, b in node.on]
            right = self._two_phase(right, keys, [])
            on = [(a, L.Column(k.name())) for (a, _), k in zip(node.on, keys)]
            return HashJoinExec(left, right, on, jt, None)
        return HashJoinExec(left, right, list(node.on), jt, node.filter)
