"""TorchContext: the single-process engine entry point (port of
``TpuContext``/``DataFrame`` in ``ballista_tpu/exec/context.py``).

``TorchContext(device="cuda").sql(q).collect()`` parses, plans, optimizes
and runs a query on the card and returns an Arrow table. The context runs on
the card unless the caller asks for the CPU (``device="cpu"``, as the tests
do); with no CUDA device it raises rather than fall back.

Tables are Arrow tables (``register_table``) or files: ``register_csv``,
``register_parquet`` and ``register_avro`` take a schema (given, or the
CSV's inferred from the file, the Parquet footer's, the Avro header's)
and no data, and a file table's source
travels in the logical plan, so any process that plans or runs the query
opens the file itself. ``sql`` runs ``CREATE EXTERNAL TABLE``, ``DROP
TABLE``, ``SHOW TABLES``, ``SHOW COLUMNS`` and ``EXPLAIN [VERBOSE | VERIFY
| ANALYZE]`` as well as queries; ``table`` and ``read_*`` start a
``DataFrame`` builder chain.

Physical plans are cached on the optimized logical plan (a structural
fingerprint), the settings and the registered data's version (a memory
table's identity, a file's mtime), so a repeated query reuses its
operators, and a registered table keeps its uploaded device batches for
warm queries. Every run goes through ``run_with_capacity_retry``: an
aggregate that outgrows its group capacity runs again with the capacity
grown, and a stale plan-cache speculation runs again without it. The
context keeps the plan cache (join build flags, probe-table sizes, decimal
scales) and the grown capacity across runs, as ``TpuContext`` does. With
``ballista.tpu.verify_plans`` on (the default) the optimized logical plan
and a newly planned physical plan are verified (``analysis.verifier``)
before they run.

The context installs the session's capacity ladder
(``ballista.tpu.capacity_buckets``, process-wide as in the reference),
seeds its plan cache and capacity hint from the persisted hint file at
its first run and writes them back when they change
(``compilecache.hints``, ``BALLISTA_TPU_HINT_CACHE``). Every collect is
logged with its cost vector into a local query log that ``system.queries``
and ``system.task_attempts`` serve (``system.executors`` is empty without
a cluster); a plan that scans a system table is never cached, so each
query reads the rows as of its own planning. The context starts the
configured prewarm on its device (``ballista.tpu.prewarm``,
``compilecache.prewarm``), and with ``ballista.tpu.trace`` not ``off``
EXPLAIN ANALYZE records an ``explain_analyze`` span, under which the
run's spill passes and callable-cache misses land as events. With
``ballista.tpu.collective_shuffle`` on and ``BALLISTA_TPU_MESH_SHARDS`` at
2 or more, the context plans on a mesh of that many shards of its device
(``mesh_runtime``, ``exec/mesh.py``). Not ported: the staleness witness.
A session key whose feature is not ported (``config.UNPORTED``) raises
here when it is set to another value than its default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import pathlib
import time
from enum import Enum

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq
import torch

from ballista_tpu_torch.columnar.arrow_interop import (
    batch_to_arrow,
    schema_from_arrow,
    schema_to_arrow,
)
from ballista_tpu_torch.columnar.batch import resolve_device
from ballista_tpu_torch.config import UNPORTED, BallistaConfig
from ballista_tpu_torch.datatypes import Field, Schema
from ballista_tpu_torch.errors import PlanError, SqlError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, run_with_capacity_retry
from ballista_tpu_torch.exec.planner import PhysicalPlanner, TableProvider
from ballista_tpu_torch.exec.scan import (
    AvroScanExec,
    CsvScanExec,
    MemoryScanExec,
    ParquetScanExec,
    file_mtime,
)
from ballista_tpu_torch.plan.logical import LogicalPlan
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.sql import ast
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import Catalog, SqlPlanner

log = logging.getLogger(__name__)


class _Registered:
    """A registered table: ``kind`` is memory, csv, parquet or avro; ``kw``
    holds the table or the file's path and options, and the table's
    registration-lifetime caches (``device_cache``, ``scan_cache``)."""

    def __init__(self, kind: str, schema: Schema, **kw):
        self.kind = kind
        self.schema = schema
        self.kw = kw


def _scans_system_table(logical) -> bool:
    """Does this logical plan reference any system.* table? Such plans
    bypass the physical-plan cache: their scans must materialize fresh
    rows every run."""
    from ballista_tpu_torch.obs.history import SYSTEM_TABLE_SCHEMAS
    from ballista_tpu_torch.plan.logical import TableScan

    def walk(p) -> bool:
        if isinstance(p, TableScan) and p.table_name in SYSTEM_TABLE_SCHEMAS:
            return True
        return any(walk(c) for c in p.children())

    return walk(logical)


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


class TorchContext(Catalog, TableProvider):
    """Register tables, run SQL, collect Arrow results."""

    def __init__(
        self,
        config: BallistaConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or BallistaConfig()
        # the keys a context reads at its start in the reference, whose
        # features the port lacks: a non-default value raises here
        self.config.check_ported(*UNPORTED)
        self.device = resolve_device(device)
        # UDF plugins (ref plugin/mod.rs: loaded once at context creation;
        # both the ballista.plugin_dir key and $BALLISTA_PLUGIN_DIR count)
        from ballista_tpu_torch.plugin import load_plugins

        load_plugins(self.config.plugin_dir() or None)
        # the session's capacity ladder governs every batch built from here
        # on (process-wide, as in the reference)
        from ballista_tpu_torch.columnar.batch import set_capacity_buckets
        from ballista_tpu_torch.compilecache.hints import HintStore
        from ballista_tpu_torch.compilecache.prewarm import start_prewarm

        set_capacity_buckets(self.config.capacity_buckets())
        # run the device-program vocabulary once on this context's device
        # (latched process-wide; 'background' threads wind down on their
        # own, see compilecache.prewarm)
        self._prewarm = start_prewarm(
            self.config.prewarm(), max_rows=self.config.tpu_batch_rows(),
            device=self.device,
        )
        self.tables: dict[str, _Registered] = {}
        self._physical_cache: dict = {}
        # cross-run plan-shape facts (see TaskContext.plan_cache)
        self._plan_cache: dict = {}
        # the capacities a run grew to (see run_with_capacity_retry)
        self._capacity_hint: dict = {}
        # persisted hints: loaded at the FIRST run, since registration
        # clears the plan cache and would wipe an eager load
        self._hints = HintStore()
        # the local query log behind system.queries/system.task_attempts
        # (created at first use; the cluster client serves the scheduler's)
        self._local_history = None
        self._local_query_seq = 0
        self._mesh_runtime = None
        self._mesh_checked = False

    def mesh_runtime(self):
        """The mesh runtime when ``ballista.tpu.collective_shuffle`` is on
        and the process's shard count (``BALLISTA_TPU_MESH_SHARDS``) is 2
        or more; None otherwise (one shard: the local operators). Built
        once, on the context's device."""
        if not self.config.collective_shuffle():
            return None
        if not self._mesh_checked:
            self._mesh_checked = True
            from ballista_tpu_torch.parallel.mesh import make_mesh, mesh_shards

            if mesh_shards() >= 2:
                from ballista_tpu_torch.exec.mesh import MeshRuntime

                self._mesh_runtime = MeshRuntime(make_mesh(device=self.device))
        return self._mesh_runtime

    # -- registration --------------------------------------------------------
    def _registered(self, name: str, reg: _Registered) -> None:
        self.tables[name] = reg
        # new data: learned plan shapes may be stale (they are validated
        # anyway; clearing avoids a certain speculation miss)
        self._plan_cache.clear()
        self._physical_cache.clear()

    def register_table(self, name: str, table: pa.Table) -> None:
        # ``device_cache`` is the table-lifetime device cache of its scans
        self._registered(
            name,
            _Registered("memory", schema_from_arrow(table.schema), table=table, device_cache={}),
        )

    def register_csv(
        self,
        name: str,
        path: str,
        schema: Schema | None = None,
        has_header: bool = True,
        delimiter: str = ",",
    ) -> None:
        if schema is None:
            t = pacsv.read_csv(path, parse_options=pacsv.ParseOptions(delimiter=delimiter))
            schema = schema_from_arrow(t.schema)
        self._registered(
            name,
            _Registered("csv", schema, path=path, has_header=has_header, delimiter=delimiter),
        )

    def register_parquet(self, name: str, path: str) -> None:
        """The schema comes from the file's footer: no row is read."""
        self._registered(name, _Registered("parquet", schema_from_arrow(papq.read_schema(path)), path=path))

    def register_avro(self, name: str, path: str) -> None:
        """The schema comes from the file's header: no data block is
        decoded."""
        from ballista_tpu_torch.avro import read_avro_schema

        self._registered(
            name, _Registered("avro", schema_from_arrow(read_avro_schema(path)), path=path)
        )

    def append_table(self, name: str, table: pa.Table) -> None:
        """Append rows to a registered memory table; through
        ``register_table``, so the plan caches clear and the data version
        changes."""
        reg = self.tables.get(name)
        existing = reg.kw.get("table") if reg is not None else None
        if existing is None:
            raise PlanError(
                f"append_table: {name!r} is not a registered memory "
                "table (file-backed tables version by mtime; rewrite "
                "the file instead)"
            )
        if table.schema != existing.schema:
            raise PlanError(f"append_table: schema mismatch for {name!r}")
        self.register_table(name, pa.concat_tables([existing, table]).combine_chunks())

    def deregister_table(self, name: str) -> None:
        self.tables.pop(name, None)
        self._plan_cache.clear()
        self._physical_cache.clear()

    # -- system tables -------------------------------------------------------
    def _system_history(self):
        """The local query log (a memory backend: the local context's
        history lives with the process; durable history is the
        scheduler's)."""
        if self._local_history is None:
            from ballista_tpu_torch.obs.history import HistoryStore
            from ballista_tpu_torch.scheduler.state_backend import MemoryBackend

            self._local_history = HistoryStore(
                MemoryBackend(), retention_jobs=self.config.history_retention_jobs()
            )
        return self._local_history

    def _system_table_rows(self, name: str) -> list[dict]:
        """The current rows of one system table. The cluster client
        overrides this to fetch the scheduler's log."""
        from ballista_tpu_torch.obs.history import SYSTEM_TABLE_KINDS

        kind = SYSTEM_TABLE_KINDS[name]
        if kind == "queries":
            return self._system_history().jobs()
        if kind == "task_attempts":
            return self._system_history().attempts()
        return []  # no cluster: the local engine has no executor roster

    def _refresh_system_table(self, name: str) -> None:
        """Materialize one system table's current rows as the memory table
        the ordinary scan serves. Registered directly, not through
        ``register_table``: a refresh must not clear the plan caches (plans
        over system tables are never cached, and the data version leaves
        system tables out)."""
        from ballista_tpu_torch.obs import history as obs_history

        t = obs_history.system_table(name, self._system_table_rows(name))
        self.tables[name] = _Registered(
            "memory", obs_history.SYSTEM_TABLE_SCHEMAS[name], table=t, device_cache={}
        )

    def _log_local_query(self, phys, wall_s: float, cpu_s: float, compile_s: float) -> None:
        """Record one completed collect into the query log, in the record
        shape the scheduler persists."""
        from ballista_tpu_torch.obs import history as obs_history
        from ballista_tpu_torch.obs.qclass import plan_class

        hist = self._system_history()
        self._local_query_seq += 1
        job_id = f"local-{self._local_query_seq:06d}"
        submitted_s = obs_history.started_at(wall_s)
        cost = obs_history.cost_from_run(
            wall_seconds=wall_s, cpu_seconds=cpu_s, plan=phys, compile_seconds=compile_s,
        )
        qclass = plan_class(phys)
        hist.record_submit(job_id, query_class=qclass, submitted_s=submitted_s)
        hist.record_terminal(
            job_id, "completed", query_class=qclass,
            submitted_s=submitted_s, latency_s=wall_s, cost=cost,
        )

    # -- Catalog / TableProvider ---------------------------------------------
    def schema_of(self, table: str) -> Schema:
        from ballista_tpu_torch.obs.history import SYSTEM_TABLE_SCHEMAS

        if table in SYSTEM_TABLE_SCHEMAS:
            # a static schema: the rows are materialized when it is scanned
            return SYSTEM_TABLE_SCHEMAS[table]
        if table not in self.tables:
            raise PlanError(f"table {table!r} not found")
        return self.tables[table].schema

    def source_of(self, table: str):
        r = self.tables.get(table)
        if r is None or r.kind == "memory":
            return None
        if r.kind == "csv":
            return ("csv", r.kw["path"], r.kw["has_header"], r.kw["delimiter"])
        return (r.kind, r.kw["path"], False, ",")

    def file_scan_cache(self, table: str, source) -> dict | None:
        """The registration-lifetime ``scan_cache`` of ``table`` when it is
        registered from the file ``source`` names (the planner lends it
        to the file scans it builds), else None."""
        if source is None or self.source_of(table) != tuple(source):
            return None
        return self.tables[table].kw.setdefault("scan_cache", {})

    def scan(
        self, table: str, projection: list[str] | None, partitions: int
    ) -> ExecutionPlan:
        from ballista_tpu_torch.obs.history import SYSTEM_TABLE_SCHEMAS

        if table in SYSTEM_TABLE_SCHEMAS:
            # refresh on scan: a system table serves the rows as of this
            # query's planning, through the ordinary memory scan
            self._refresh_system_table(table)
        r = self.tables.get(table)
        if r is None:
            raise PlanError(f"table {table!r} not found")
        if r.kind == "memory":
            return MemoryScanExec(
                r.kw["table"], r.schema, projection, partitions, device_cache=r.kw["device_cache"]
            )
        # parsed host tables and uploaded batches, dropped with the mtime
        scache = r.kw.setdefault("scan_cache", {})
        if r.kind == "csv":
            return CsvScanExec(
                r.kw["path"], r.schema, r.kw["has_header"], r.kw["delimiter"],
                projection, partitions, scan_cache=scache,
            )
        if r.kind == "avro":
            return AvroScanExec(r.kw["path"], r.schema, projection, partitions, scan_cache=scache)
        return ParquetScanExec(r.kw["path"], r.schema, projection, partitions, scan_cache=scache)

    # -- DataFrame entry points ----------------------------------------------
    def _frame(self, logical: LogicalPlan) -> "DataFrame":
        """Frame factory: the cluster context's frames run remotely."""
        return DataFrame(self, logical)

    def table(self, name: str) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import TableScan

        return self._frame(TableScan(name, self.schema_of(name), source=self.source_of(name)))

    def _auto_name(self, path: str, kind: str) -> str:
        """The name ``read_*`` registers a file under: its stem, made unique
        when another source holds it (reading the same file again reuses
        the entry)."""
        base = pathlib.Path(path).stem
        name = base
        i = 2
        while name in self.tables:
            r = self.tables[name]
            if r.kind == kind and r.kw.get("path") == path:
                return name
            name = f"{base}_{i}"
            i += 1
        return name

    def read_csv(
        self,
        path: str,
        schema: Schema | None = None,
        has_header: bool = True,
        delimiter: str = ",",
        name: str | None = None,
    ) -> "DataFrame":
        name = name or self._auto_name(path, "csv")
        self.register_csv(name, path, schema, has_header, delimiter)
        return self.table(name)

    def read_parquet(self, path: str, name: str | None = None) -> "DataFrame":
        name = name or self._auto_name(path, "parquet")
        self.register_parquet(name, path)
        return self.table(name)

    def read_avro(self, path: str, name: str | None = None) -> "DataFrame":
        name = name or self._auto_name(path, "avro")
        self.register_avro(name, path)
        return self.table(name)

    # -- SQL -----------------------------------------------------------------
    def sql_to_logical(self, sql: str) -> LogicalPlan:
        stmt = parse_sql(sql)
        if not isinstance(stmt, (ast.Select, ast.SetOp)):
            raise SqlError("only queries produce logical plans; use sql()")
        return SqlPlanner(self).plan(stmt)

    def _data_version(self) -> tuple:
        """The registered data's signature in the plan cache's key: a
        swapped memory table (identity and rows) or a rewritten file
        (mtime) gets a fresh plan, since cached scans hold their data.
        System tables are left out: every scan of one re-registers it, and
        a dashboard polling ``system.queries`` must not invalidate every
        cached user plan (plans over system tables are never cached)."""
        from ballista_tpu_torch.obs.history import SYSTEM_TABLE_SCHEMAS

        sig = []
        for name in sorted(self.tables):
            if name in SYSTEM_TABLE_SCHEMAS:
                continue
            r = self.tables[name]
            t = r.kw.get("table")
            if t is not None:
                sig.append((name, id(t), t.num_rows))
            else:
                sig.append((name, r.kw["path"], file_mtime(r.kw["path"])))
        return tuple(sig)

    def _planner(self) -> PhysicalPlanner:
        return PhysicalPlanner(
            self, self.config.default_shuffle_partitions(), mesh_runtime=self.mesh_runtime()
        )

    def create_physical_plan(self, logical: LogicalPlan, sql: str | None = None) -> ExecutionPlan:
        optimized = optimize(logical)
        verify = self.config.verify_plans()
        if verify:
            # cached physical plans were verified when first planned
            from ballista_tpu_torch.analysis import verify_logical

            verify_logical(optimized, sql=sql)
        if _scans_system_table(optimized):
            # never cached: a cached scan holds the rows it was planned
            # against, and a system table serves the rows as of this query
            phys = self._planner().plan(optimized)
            if verify:
                from ballista_tpu_torch.analysis import verify_physical

                verify_physical(phys, sql=sql)
            return phys
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
            # the join build tables went with their plan instances: reset
            # the shared tally, or admission would starve
            self._plan_cache.pop("__build_cache_bytes__", None)
        phys = self._planner().plan(optimized)
        if verify:
            from ballista_tpu_torch.analysis import verify_physical

            verify_physical(phys, sql=sql)
        self._physical_cache[key] = phys
        return phys

    def sql(self, sql: str) -> "DataFrame":
        stmt = parse_sql(sql)
        if isinstance(stmt, ast.CreateExternalTable):
            self._create_external_table(stmt)
            return DataFrame.empty_ok(self)
        if isinstance(stmt, ast.DropTable):
            if stmt.name not in self.tables and not stmt.if_exists:
                raise PlanError(f"table {stmt.name!r} not found")
            self.deregister_table(stmt.name)
            return DataFrame.empty_ok(self)
        if isinstance(stmt, ast.ShowTables):
            return DataFrame.from_arrow(self, pa.table({"table_name": pa.array(sorted(self.tables))}))
        if isinstance(stmt, ast.ShowColumns):
            schema = self.schema_of(stmt.table)
            t = pa.table(
                {
                    "column_name": pa.array([f.name for f in schema]),
                    "data_type": pa.array([f.dtype.value for f in schema]),
                    "nullable": pa.array([f.nullable for f in schema]),
                }
            )
            return DataFrame.from_arrow(self, t)
        if isinstance(stmt, ast.Explain):
            logical = SqlPlanner(self).plan(stmt.query)
            optimized = optimize(logical)
            if stmt.analyze:
                return self._explain_analyze(optimized, sql)
            rows = [
                ("logical_plan", logical.display()),
                ("optimized_plan", optimized.display()),
            ]
            # one physical plan serves VERBOSE and VERIFY: the report
            # describes the plan the user sees
            phys = self._planner().plan(optimized) if stmt.verbose or stmt.verify else None
            if stmt.verbose:
                rows.append(("physical_plan", phys.display()))
            if stmt.verify:
                rows.append(("verification", self._verify_report(optimized, phys, sql)))
            return DataFrame.from_arrow(self, _plan_rows(rows))
        if isinstance(stmt, (ast.Select, ast.SetOp)):
            df = DataFrame(self, SqlPlanner(self).plan(stmt))
            df._sql = sql  # verifier diagnostics carry a source span
            return df
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    def _explain_analyze(self, optimized: LogicalPlan, sql: str | None) -> "DataFrame":
        """Plan afresh, meter every operator (``obs.profile``), run the query
        to its end with every Filter and Projection on its own, and return
        the plan with each operator's rows, bytes and elapsed seconds. The
        counters are the port's: device row counts resolve with one copy
        after the run, and on the card the run's total waits for the card
        to finish."""
        from ballista_tpu_torch.exec.pipeline import unfused
        from ballista_tpu_torch.obs import profile
        from ballista_tpu_torch.obs import trace as obs_trace
        from ballista_tpu_torch.scheduler.aqe import narrate

        phys = self._planner().plan(optimized)
        if self.config.verify_plans():
            from ballista_tpu_torch.analysis import verify_physical

            verify_physical(phys, sql=sql)
        profile.instrument_plan(phys)
        n = phys.output_partitioning().n

        def run(task: TaskContext) -> int:
            # fresh metrics per attempt: a capacity retry runs the tree again
            profile.reset_plan_metrics(phys)
            batches = 0
            for p in range(n):
                for _ in phys.execute(p, task):
                    batches += 1
            return batches

        mode = self.config.trace()
        if mode != "off":
            # the spill and callable-cache events of this run join a fresh
            # trace
            obs_trace.configure(mode)
            span_cm = obs_trace.span(
                "explain_analyze",
                trace_id=obs_trace.new_trace_id(),
                attrs={"sql": (sql or "")[:200]},
            )
        else:
            span_cm = contextlib.nullcontext()
        self._hints.load_once(self._capacity_hint, self._plan_cache)
        t0 = time.perf_counter()
        with unfused(), span_cm:
            run_with_capacity_retry(
                self.config, run, device=self.device, hint=self._capacity_hint,
                plan_cache=self._plan_cache,
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self._hints.save_if_changed(self._capacity_hint, self._plan_cache)
        rows = [
            ("physical_plan (analyzed)", profile.annotated_display(phys)),
            ("analyze_summary",
             f"total_elapsed={elapsed:.6f}s, fusion=off (per-operator attribution)"),
            ("aqe", narrate(self, optimized)),
        ]
        return DataFrame.from_arrow(self, _plan_rows(rows))

    def _verify_report(self, optimized: LogicalPlan, phys, sql: str) -> str:
        """EXPLAIN VERIFY's text: the logical and physical verifier passes
        over the plan VERBOSE shows; a failure becomes text (EXPLAIN shows
        the diagnosis rather than raise)."""
        from ballista_tpu_torch.analysis import verify_logical, verify_physical
        from ballista_tpu_torch.errors import PlanVerificationError

        lines = []
        try:
            lines.append(verify_logical(optimized, sql=sql).summary())
            lines.append(verify_physical(phys, sql=sql).summary())
        except PlanVerificationError as e:
            lines.append(f"FAILED: {e}")
        return "\n".join(lines)

    def _create_external_table(self, stmt: ast.CreateExternalTable) -> None:
        if stmt.name in self.tables:
            if stmt.if_not_exists:
                return
            raise PlanError(f"table {stmt.name!r} already exists")
        schema = None
        if stmt.columns is not None:
            schema = Schema([Field(c.name, c.dtype, c.nullable) for c in stmt.columns])
        if stmt.stored_as == "csv":
            self.register_csv(stmt.name, stmt.location, schema, stmt.has_header, stmt.delimiter)
        elif stmt.stored_as == "avro":
            self.register_avro(stmt.name, stmt.location)
        else:
            self.register_parquet(stmt.name, stmt.location)


def _plan_rows(rows: list[tuple[str, str]]) -> pa.Table:
    return pa.table(
        {"plan_type": pa.array([r[0] for r in rows]), "plan": pa.array([r[1] for r in rows])}
    )


class DataFrame:
    """Lazy query handle with a builder: each method returns a new frame
    over an extended logical plan, and ``collect`` runs it. A cluster
    context's frames (``RemoteDataFrame``) derive remote frames."""

    def __init__(self, ctx: TorchContext, logical: LogicalPlan):
        self.ctx = ctx
        self.logical = logical
        self._const: pa.Table | None = None
        # source SQL of a frame from sql(), for the verifier's diagnostics;
        # builder-derived frames drop it
        self._sql: str | None = None
        # retries of the last collect: "capacity_retries",
        # "speculation_misses"
        self.stats: dict = {}

    # -- builder -------------------------------------------------------------
    def _derive(self, logical: LogicalPlan) -> "DataFrame":
        if self._const is not None:
            raise PlanError("cannot build on a constant result frame")
        return type(self)(self.ctx, logical)

    @staticmethod
    def _expr(e):
        from ballista_tpu_torch.expr.logical import col_or_expr

        return col_or_expr(e)

    def schema(self) -> Schema:
        if self._const is not None:
            return schema_from_arrow(self._const.schema)
        return self.logical.schema()

    def select(self, *exprs) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Projection

        return self._derive(Projection(self.logical, tuple(self._expr(e) for e in exprs)))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*names)

    def filter(self, predicate) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Filter

        return self._derive(Filter(self.logical, self._expr(predicate)))

    where = filter

    def aggregate(self, group_by: list, aggs: list) -> "DataFrame":
        """Aggregates may be aliased (``F.sum("v").alias("total")``); the
        plan takes bare aggregates and renames them in a projection, as
        the SQL planner does."""
        from ballista_tpu_torch.expr import logical as L
        from ballista_tpu_torch.plan.logical import Aggregate, Projection

        groups = tuple(self._expr(e) for e in group_by)
        bare, out_names = [], []
        for e in aggs:
            e = self._expr(e)
            if isinstance(e, L.Alias):
                bare.append(e.expr)
                out_names.append(e.aname)
            else:
                bare.append(e)
                out_names.append(None)
        plan = Aggregate(self.logical, groups, tuple(bare))
        if any(n is not None for n in out_names):
            proj = [L.col(g.name()) for g in groups]
            for b, n in zip(bare, out_names):
                c = L.col(b.name())
                proj.append(c if n is None else c.alias(n))
            plan = Projection(plan, tuple(proj))
        return self._derive(plan)

    def sort(self, *exprs) -> "DataFrame":
        """``col("x")`` (ascending), ``col("x").sort(False)`` or a
        ``SortExpr``."""
        from ballista_tpu_torch.plan.logical import Sort, SortExpr

        sort_exprs = [e if isinstance(e, SortExpr) else self._expr(e).sort() for e in exprs]
        return self._derive(Sort(self.logical, tuple(sort_exprs)))

    def limit(self, count: int, skip: int = 0) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Limit

        return self._derive(Limit(self.logical, skip, count))

    def join(
        self,
        right: "DataFrame",
        join_keys: tuple[list[str], list[str]] | list[str],
        how: str = "inner",
    ) -> "DataFrame":
        """``join_keys``: ``(left_cols, right_cols)`` or one list of shared
        column names."""
        from ballista_tpu_torch.plan.logical import Join, JoinType

        if isinstance(join_keys, tuple) and len(join_keys) == 2 and not isinstance(join_keys[0], str):
            lks, rks = list(join_keys[0]), list(join_keys[1])
            if len(lks) != len(rks):
                raise PlanError(
                    f"join_keys sides differ in length: {len(lks)} vs {len(rks)}"
                )
        else:
            lks = rks = list(join_keys)
        try:
            jt = JoinType(how)
        except ValueError:
            raise PlanError(f"unknown join type {how!r}") from None
        on = tuple((self._expr(a), self._expr(b)) for a, b in zip(lks, rks))
        return self._derive(Join(self.logical, right.logical, on, jt))

    def union(self, other: "DataFrame", all: bool = False) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Distinct, Union

        u = Union((self.logical, other.logical), all=True)
        return self._derive(u if all else Distinct(u))

    def distinct(self) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Distinct

        return self._derive(Distinct(self.logical))

    def alias(self, name: str) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import SubqueryAlias

        return self._derive(SubqueryAlias(self.logical, name))

    @classmethod
    def from_arrow(cls, ctx: TorchContext, table: pa.Table) -> "DataFrame":
        df = cls(ctx, None)
        df._const = table
        return df

    @classmethod
    def empty_ok(cls, ctx: TorchContext) -> "DataFrame":
        return cls.from_arrow(ctx, pa.table({"result": pa.array(["ok"])}))

    # -- running -------------------------------------------------------------
    def collect(self) -> pa.Table:
        return self.collect_with_plan()[0]

    def collect_with_plan(self) -> tuple[pa.Table, ExecutionPlan | None]:
        """(table, executed physical plan): the plan handle carries this
        run's per-operator metrics (None for a statement's constant
        result)."""
        if self._const is not None:
            return self._const, None
        phys = self.ctx.create_physical_plan(self.logical, sql=self._sql)

        def run(task: TaskContext) -> list[pa.RecordBatch]:
            out = []
            for p in range(phys.output_partitioning().n):
                for b in phys.execute(p, task):
                    rb = batch_to_arrow(b)
                    if rb.num_rows:
                        out.append(rb)
            return out

        self.stats = {}
        ctx = self.ctx
        # the hint file seeds a cold run's capacities and plan shapes
        ctx._hints.load_once(ctx._capacity_hint, ctx._plan_cache)
        from ballista_tpu_torch.ops import cuda_build

        t0, c0, b0 = time.perf_counter(), time.thread_time(), cuda_build.build_seconds()
        batches = run_with_capacity_retry(
            ctx.config, run, device=ctx.device,
            hint=ctx._capacity_hint, plan_cache=ctx._plan_cache,
            stats=self.stats,
        )
        if ctx.config.cost_accounting():
            # the local query log (system.queries): wall and CPU seconds
            # around the run, and the kernel build seconds it paid
            try:
                ctx._log_local_query(
                    phys, time.perf_counter() - t0, time.thread_time() - c0,
                    cuda_build.build_seconds() - b0,
                )
            except Exception:  # noqa: BLE001 — the query log is
                # observability; it must never fail a collect
                log.exception("local query-log record failed")
        ctx._hints.save_if_changed(ctx._capacity_hint, ctx._plan_cache)
        if not batches:
            return schema_to_arrow(phys.schema()).empty_table(), phys
        return pa.Table.from_batches(batches), phys

    def to_pandas(self):
        return self.collect().to_pandas()

    def show(self, limit: int = 20) -> None:
        print(self.collect().slice(0, limit).to_pandas().to_string(index=False))

    def explain(self) -> str:
        return optimize(self.logical).display() if self.logical is not None else "<const>"
