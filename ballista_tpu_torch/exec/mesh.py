"""Mesh operators: the collective-shuffle query path (port of
``ballista_tpu/exec/mesh.py``).

When ``ballista.tpu.collective_shuffle`` is on and the context's mesh has
two or more shards (``BALLISTA_TPU_MESH_SHARDS``), the physical planner
lowers grouped aggregates, partitioned joins, sorts and partition-keyed
windows to these operators instead of the serial partial ->
CoalescePartitions -> final funnel. Each operator gathers its child's
batches, lays them out over the mesh's shards and runs one mesh stage
(``parallel/stage.py``): shard-local work and an exchange between shards,
which on one card is a permutation of the shards' rows on the card (the
reference's is a ``jax.lax.all_to_all`` over ICI).

Outputs stay sharded (one logical partition, ``DeviceBatch.shards`` set):
a downstream mesh operator takes them with no new layout
(``is_row_sharded``), and Filter and Projection keep the sharding, so a
q5/q18-shaped plan runs scan -> join -> join -> aggregate on the mesh with
one layout per base table. ``describe()`` keeps the reference's words,
``ici-all_to_all`` and ``ici-all_gather`` among them, so a plan's
``display()`` is the reference's.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.compilecache.tracecache import expr_key, schema_key, shared_callable
from ballista_tpu_torch.datatypes import DataType, Field, Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.aggregate import AggSpec, decompose_aggregates, finalize_state
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.expr.physical import compile_expr
from ballista_tpu_torch.ops.concat import concat_batches
from ballista_tpu_torch.ops.join import JoinSide
from ballista_tpu_torch.parallel import MeshStageRunner, is_row_sharded, shard_batch
from ballista_tpu_torch.plan.logical import JoinType


class MeshRuntime:
    """One mesh and its stage runner per context (or executor)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.runner = MeshStageRunner(mesh)

    def place(self, plan: ExecutionPlan, ctx) -> DeviceBatch:
        """Collect every partition of ``plan`` and present it sharded. A
        child that is itself a mesh operator hands over its sharded batch
        unchanged."""
        part = plan.output_partitioning()
        batches = []
        for p in range(part.n):
            batches.extend(plan.execute(p, ctx))
        if not batches:
            return shard_batch(self.mesh, DeviceBatch.empty(plan.schema(), device=self.mesh.device))
        if len(batches) == 1 and is_row_sharded(batches[0], self.mesh):
            return batches[0]
        merged = concat_batches(batches) if len(batches) > 1 else batches[0]
        return shard_batch(self.mesh, merged)


def _sharded(batch: DeviceBatch, like: DeviceBatch) -> DeviceBatch:
    """``batch`` (the same rows as ``like``) marked with ``like``'s shards."""
    return DeviceBatch(
        schema=batch.schema, columns=batch.columns, valid=batch.valid,
        nulls=batch.nulls, dictionaries=batch.dictionaries, shards=like.shards,
    )


class MeshAggregateExec(ExecutionPlan):
    """Repartitioned grouped aggregate as one mesh stage: partial per shard
    -> exchange of group states -> final merge, then the standard finalizer
    (AVG division etc.). One sharded output partition. Replaces partial +
    coalesce + final when the mesh is active."""

    def __init__(
        self,
        input: ExecutionPlan,
        group_exprs: list[L.Expr],
        agg_exprs: list[L.Expr],
        runtime: MeshRuntime,
        spec: AggSpec | None = None,
    ) -> None:
        super().__init__()
        if not group_exprs:
            raise PlanError("mesh aggregate requires group keys")
        self.input = input
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        self.runtime = runtime
        ins = input.schema()
        self.spec = (
            spec if spec is not None else decompose_aggregates(group_exprs, agg_exprs, ins)
        )
        self._pre_exprs = list(group_exprs) + list(self.spec.arg_exprs)
        self._pre_schema = Schema(
            [Field(e.name(), e.data_type(ins), e.nullable(ins)) for e in self._pre_exprs]
        )
        ng = len(self.spec.group_names)
        fields = list(self._pre_schema.fields[:ng])
        for name, dtype, _, _ in self.spec.finals:
            fields.append(Field(name, dtype, True))
        self._schema = Schema(fields)
        self._pre_plan = None

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        g = ", ".join(self.spec.group_names)
        a = ", ".join(s.name for s in self.spec.slots)
        return f"MeshAggregateExec(ici-all_to_all): gby=[{g}], aggr=[{a}]"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.pipeline import ProjectionExec

        if self._pre_plan is None:
            self._pre_plan = ProjectionExec(self.input, self._pre_exprs)
        batch = self.runtime.place(self._pre_plan, ctx)
        n_groups = len(self.spec.group_names)

        # COUNT(*) slots aggregate a ones column appended past the schema
        cols = list(batch.columns)
        nulls = list(batch.nulls)
        ones_idx = None
        val_idxs, ops = [], []
        for s in self.spec.slots:
            if s.src is None:
                if ones_idx is None:
                    ones_idx = len(cols)
                    cols.append(torch.ones_like(batch.valid, dtype=torch.int64))
                    nulls.append(None)
                val_idxs.append(ones_idx)
            else:
                val_idxs.append(s.src)
            ops.append(s.op)
        if ones_idx is not None:
            ext_schema = Schema(
                list(batch.schema.fields) + [Field("__ones__", DataType.INT64, False)]
            )
            batch = DeviceBatch(
                schema=ext_schema,
                columns=tuple(cols),
                valid=batch.valid,
                nulls=tuple(nulls),
                dictionaries=dict(batch.dictionaries),
                shards=batch.shards,
            )

        with self.metrics.time("agg_time"):
            state = self.runtime.runner.aggregate(
                batch,
                list(range(n_groups)),
                val_idxs,
                ops,
                capacity=self._capacity(ctx),
            )
        yield _sharded(finalize_state(state, self.spec, self._schema), state)

    def _capacity(self, ctx: TaskContext) -> int:
        if ctx.agg_capacity_override:
            return ctx.agg_capacity_override
        return ctx.config.agg_capacity()


class MeshJoinExec(ExecutionPlan):
    """PARTITIONED-mode hash join as one mesh stage: both sides exchanged
    by key hash, then a local build and probe (all pack modes, m:n
    expansion) on each shard. INNER residual filters run in the stage;
    LEFT, SEMI and ANTI are routed here only when filterless (the planner
    enforces that)."""

    def __init__(
        self,
        left: ExecutionPlan,
        right: ExecutionPlan,
        on: list[tuple[L.Expr, L.Expr]],
        join_type: JoinType,
        filter: L.Expr | None,
        runtime: MeshRuntime,
    ) -> None:
        super().__init__()
        self.left = left
        self.right = right
        self.on = list(on)
        self.join_type = join_type
        self.filter = filter
        self.runtime = runtime
        ls, rs = left.schema(), right.schema()
        for a, b in self.on:
            if not (isinstance(a, L.Column) and isinstance(b, L.Column)):
                raise PlanError("join keys must be columns (planner projects)")
        if join_type in (JoinType.SEMI, JoinType.ANTI):
            self._schema = ls
        elif join_type == JoinType.LEFT:
            self._schema = ls.join(Schema([Field(f.name, f.dtype, True) for f in rs]))
        elif join_type == JoinType.INNER:
            self._schema = ls.join(rs)
        else:
            raise PlanError(f"mesh join does not support {join_type}")
        if filter is not None and join_type != JoinType.INNER:
            raise PlanError(
                "mesh join residual filters are INNER-only; planner must "
                "route filtered outer joins to the local tier"
            )

    _KIND = {
        JoinType.INNER: JoinSide.INNER,
        JoinType.LEFT: JoinSide.LEFT,
        JoinType.SEMI: JoinSide.SEMI,
        JoinType.ANTI: JoinSide.ANTI,
    }

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.left, self.right]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        on = ", ".join(f"{a.name()} = {b.name()}" for a, b in self.on)
        f = f", filter={self.filter.name()}" if self.filter is not None else ""
        return f"MeshJoinExec({self.join_type.value}, ici-all_to_all): on=[{on}]{f}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        from ballista_tpu_torch.exec.joins import HashJoinExec

        ls, rs = self.left.schema(), self.right.schema()
        left_keys = [L.resolve_field_index(ls, a.cname) for a, _ in self.on]
        right_keys = [L.resolve_field_index(rs, b.cname) for _, b in self.on]

        lb = self.runtime.place(self.left, ctx)
        rb = self.runtime.place(self.right, ctx)
        # string join keys compare by code: unify dictionaries before the
        # exchange
        lb, rb = HashJoinExec._unify_key_dicts(self, lb, rb, left_keys, right_keys)

        filter_fn = None
        if self.filter is not None:
            filter_fn = self._residual_filter(lb.schema.join(rb.schema), lb.device)

        with self.metrics.time("join_time"):
            out = self.runtime.runner.join(
                lb, rb, left_keys, right_keys, self._KIND[self.join_type], filter_fn=filter_fn,
            )
        # schema field names follow the plan schema (positional identity)
        yield DeviceBatch(
            schema=self._schema,
            columns=out.columns,
            valid=out.valid,
            nulls=out.nulls,
            dictionaries=self._rekey_dicts(out, self._schema),
            shards=out.shards,
        )

    def _residual_filter(self, joined: Schema, device):
        """The residual filter over a joined shard, built once a signature
        (``compilecache.tracecache``)."""
        filt = self.filter
        phys = shared_callable(
            ("mesh_join_filter", expr_key(filt), schema_key(joined), str(device)),
            lambda: compile_expr(filt, joined).evaluate,
        )

        def fn(batch: DeviceBatch) -> torch.Tensor:
            cv = phys(batch)
            passes = cv.values.to(torch.bool)
            return passes if cv.nulls is None else passes & ~cv.nulls

        return fn

    @staticmethod
    def _rekey_dicts(out: DeviceBatch, schema: Schema):
        # dictionaries are name-keyed; positional renames keep values
        dicts = {}
        for i, f in enumerate(schema):
            d = out.dictionaries.get(out.schema.fields[i].name)
            if d is not None:
                dicts[f.name] = d
        return dicts


class MeshSortExec(ExecutionPlan):
    """ORDER BY over the mesh. With a fetch bound: distributed top-k (local
    top-k per shard -> the candidates gathered -> their merge). Without
    one: the full sample sort (splitters sampled on the primary key ->
    range exchange -> local multi-key sort; the sharded output read in
    index order IS the total order). Both replace the CoalescePartitions
    -> SortExec funnel, the stage boundary of the reference's single-task
    sort after a gather; fetch semantics are SortExec's."""

    def __init__(
        self,
        input: ExecutionPlan,
        sort_exprs,
        fetch: int | None,
        runtime: MeshRuntime,
    ) -> None:
        from ballista_tpu_torch.ops.sort import resolve_sort_keys

        super().__init__()
        if fetch is not None and fetch <= 0:
            raise PlanError("mesh sort fetch bound must be positive")
        self.input = input
        self.sort_exprs = list(sort_exprs)
        self.fetch = fetch
        self.runtime = runtime
        self._keys = resolve_sort_keys(input.schema(), self.sort_exprs)

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    @property
    def sorted_output(self) -> bool:
        """The live rows of the yielded batch are in total sort order
        (consumers that gather to the host keep index order)."""
        return True

    def describe(self) -> str:
        ks = ", ".join(
            f"{s.expr.name()} {'ASC' if s.ascending else 'DESC'}" for s in self.sort_exprs
        )
        mode = (
            f"ici-all_gather, fetch={self.fetch}" if self.fetch is not None else "ici-sample-sort"
        )
        return f"MeshSortExec({mode}): [{ks}]"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        batch = self.runtime.place(self.input, ctx)
        with self.metrics.time("sort_time"):
            if self.fetch is not None:
                out = self.runtime.runner.topk(batch, self._keys, self.fetch)
            else:
                out = self.runtime.runner.sort_full(batch, self._keys)
        yield out


class MeshWindowExec(ExecutionPlan):
    """Partition-keyed window functions over the mesh: rows exchanged by
    the (shared) PARTITION BY key set so every partition lands whole on one
    shard, then the single-device window computation per shard
    (``WindowExec.append_window_columns``). Every window expression must
    share one non-empty PARTITION BY column set; the planner falls back to
    the local gather funnel otherwise. The reference's upstream has no
    distributed window path at all (it coalesces)."""

    def __init__(self, input: ExecutionPlan, window_exprs, names, runtime: MeshRuntime) -> None:
        from ballista_tpu_torch.exec.window import WindowExec

        super().__init__()
        self.input = input
        self.runtime = runtime
        # the local operator: validation, schema and the per-shard work
        self._local = WindowExec(input, window_exprs, names)
        # serde encodes these field for field; SHARED with _local (not
        # copies), so the wire format cannot drift from what runs
        self.window_exprs = self._local.window_exprs
        self.names = self._local.names
        key_sets = {frozenset(pk) for pk, _ in self._local._keys}
        if len(key_sets) != 1 or not next(iter(key_sets)):
            raise PlanError(
                "mesh windows require a single shared non-empty PARTITION BY column set"
            )
        self._key_idxs = sorted(next(iter(key_sets)))
        self._schema = self._local._schema

    def schema(self) -> Schema:
        return self._schema

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def output_partitioning(self):
        return UnknownPartitioning(1)

    def describe(self) -> str:
        return "Mesh" + self._local.describe()

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        batch = self.runtime.place(self.input, ctx)
        in_schema = batch.schema
        dicts = dict(batch.dictionaries)
        local = self._local

        def local_fn(cols, nulls, valid):
            shard = DeviceBatch(
                schema=in_schema, columns=tuple(cols), valid=valid,
                nulls=tuple(nulls), dictionaries=dicts,
            )
            return local.append_window_columns(shard)

        with self.metrics.time("window_time"):
            out_cols, out_nulls, out_valid = self.runtime.runner.window(
                batch, self._key_idxs, local_fn
            )
        yield DeviceBatch(
            schema=self._schema,
            columns=tuple(out_cols),
            valid=out_valid,
            nulls=tuple(out_nulls),
            dictionaries=dicts,
            shards=self.runtime.mesh.n_dev,
        )
