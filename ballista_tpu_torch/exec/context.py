"""TorchContext: the single-process engine entry point (port of
``TpuContext``/``DataFrame`` in ``ballista_tpu/exec/context.py``).

``TorchContext(device="cuda").sql(q).collect()`` parses, plans, optimizes
and runs a query on the card and returns an Arrow table. The context runs on
the card unless the caller asks for the CPU (``device="cpu"``, as the tests
do); with no CUDA device it raises rather than fall back.

Physical plans are cached on the optimized logical plan (a structural
fingerprint), the settings and the registered data's version, so a repeated
query reuses its operators, and a registered table keeps its uploaded
device batches for warm queries. Every run goes through
``run_with_capacity_retry``: an aggregate that outgrows its group capacity
runs again with the capacity grown, and a stale plan-cache speculation runs
again without it. The context keeps the plan cache (join build flags,
probe-table sizes, decimal scales) and the grown capacity across runs, as
``TpuContext`` does. Not ported: history and system tables, the staleness
witness, plan verification, file registration, DDL statements, the
persisted capacity hints. A session key whose feature is not ported
(``config.UNPORTED``) raises here when it is set to another value than
its default.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import pyarrow as pa
import torch

from ballista_tpu_torch.columnar.arrow_interop import (
    batch_to_arrow,
    schema_from_arrow,
    schema_to_arrow,
)
from ballista_tpu_torch.columnar.batch import resolve_device
from ballista_tpu_torch.config import (
    BALLISTA_BUILD_CACHE_MB,
    BALLISTA_PROFILE_DIR,
    UNPORTED,
    BallistaConfig,
)
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, run_with_capacity_retry
from ballista_tpu_torch.exec.planner import PhysicalPlanner, TableProvider
from ballista_tpu_torch.exec.scan import MemoryScanExec
from ballista_tpu_torch.plan.logical import LogicalPlan
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.sql import ast
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import Catalog, SqlPlanner


def plan_fingerprint(obj):
    """Structural fingerprint of a logical plan (or expression): type names
    and field values, recursively. Two plans share a fingerprint only when
    they are the same tree, which a rendered display does not guarantee
    (aliased expressions render by alias)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plan_fingerprint(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)
        )
    if isinstance(obj, Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, (list, tuple)):
        return tuple(plan_fingerprint(o) for o in obj)
    return (type(obj).__name__, obj)


_CONTEXT_UNPORTED = tuple(
    k for k in UNPORTED
    if k not in (BALLISTA_PROFILE_DIR, BALLISTA_BUILD_CACHE_MB)
)


class TorchContext(Catalog, TableProvider):
    """Register Arrow tables, run SQL, collect Arrow results."""

    def __init__(
        self,
        config: BallistaConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or BallistaConfig()
        # the keys a context reads at its start in the reference, whose
        # features the port lacks: a non-default value raises here
        self.config.check_ported(*_CONTEXT_UNPORTED)
        self.device = resolve_device(device)
        self.tables: dict[str, tuple[Schema, pa.Table, dict]] = {}
        self._physical_cache: dict = {}
        # cross-run plan-shape facts (see TaskContext.plan_cache)
        self._plan_cache: dict = {}
        # the aggregate capacity a run grew to (see run_with_capacity_retry)
        self._capacity_hint: dict = {}

    # -- registration --------------------------------------------------------
    def register_table(self, name: str, table: pa.Table) -> None:
        # the dict is the table-lifetime device cache of its scans
        self.tables[name] = (schema_from_arrow(table.schema), table, {})
        # new data: learned plan shapes may be stale (they are validated
        # anyway; clearing avoids a certain speculation miss)
        self._plan_cache.clear()
        self._physical_cache.clear()

    def schema_of(self, table: str) -> Schema:
        if table not in self.tables:
            raise PlanError(f"table {table!r} not found")
        return self.tables[table][0]

    def scan(
        self, table: str, projection: list[str] | None, partitions: int
    ) -> ExecutionPlan:
        if table not in self.tables:
            raise PlanError(f"table {table!r} not found")
        schema, t, cache = self.tables[table]
        return MemoryScanExec(t, schema, projection, partitions, device_cache=cache)

    # -- SQL -----------------------------------------------------------------
    def sql_to_logical(self, sql: str) -> LogicalPlan:
        stmt = parse_sql(sql)
        if not isinstance(stmt, (ast.Select, ast.SetOp)):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not ported yet "
                "(ROADMAP queue 1, item 3)"
            )
        return SqlPlanner(self).plan(stmt)

    def _data_version(self) -> tuple:
        return tuple(
            (name, id(t), t.num_rows) for name, (_, t, _) in sorted(self.tables.items())
        )

    def create_physical_plan(self, logical: LogicalPlan) -> ExecutionPlan:
        optimized = optimize(logical)
        key = (
            plan_fingerprint(optimized),
            tuple(sorted(self.config.settings().items())),
            self._data_version(),
        )
        cached = self._physical_cache.get(key)
        if cached is not None:
            # metrics stay per query
            def _reset(p):
                p.metrics.reset()
                for c in p.children():
                    _reset(c)

            _reset(cached)
            return cached
        if len(self._physical_cache) >= 128:
            self._physical_cache.clear()
        phys = PhysicalPlanner(
            self, self.config.default_shuffle_partitions()
        ).plan(optimized)
        self._physical_cache[key] = phys
        return phys

    def sql(self, sql: str) -> "DataFrame":
        return DataFrame(self, self.sql_to_logical(sql))


class DataFrame:
    """Query handle; ``collect`` runs it."""

    def __init__(self, ctx: TorchContext, logical: LogicalPlan):
        self.ctx = ctx
        self.logical = logical
        # retries of the last collect: "capacity_retries",
        # "speculation_misses"
        self.stats: dict = {}

    def collect(self) -> pa.Table:
        return self.collect_with_plan()[0]

    def collect_with_plan(self) -> tuple[pa.Table, ExecutionPlan]:
        """(table, executed physical plan): the plan handle carries this
        run's per-operator metrics."""
        phys = self.ctx.create_physical_plan(self.logical)

        def run(task: TaskContext) -> list[pa.RecordBatch]:
            out = []
            for p in range(phys.output_partitioning().n):
                for b in phys.execute(p, task):
                    rb = batch_to_arrow(b)
                    if rb.num_rows:
                        out.append(rb)
            return out

        self.stats = {}
        batches = run_with_capacity_retry(
            self.ctx.config, run, device=self.ctx.device,
            hint=self.ctx._capacity_hint, plan_cache=self.ctx._plan_cache,
            stats=self.stats,
        )
        if not batches:
            return schema_to_arrow(phys.schema()).empty_table(), phys
        return pa.Table.from_batches(batches), phys
