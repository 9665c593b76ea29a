"""The system tables (``system.queries``, ``system.task_attempts``,
``system.executors``) of the port against the reference's, on the CPU: the
cases of ``tests/test_history.py`` that query ``system.*``, locally and on
a port cluster.

Locally, ``TorchContext`` logs every collect into its own query log, as
``TpuContext`` does; on a cluster, ``BallistaContext`` materializes the
tables from the scheduler's persistent history (``GetHistory``) and runs
the query client-side. Rows are compared with the reference's on the same
queries over the same seeded tables: schemas, row counts, statuses, query
classes, the executors' slots, and the attempts' stages and partitions
exactly; timings, ids and CPU seconds are only held to be positive where
the reference's test holds them so. A plan over a system table bypasses
the plan cache: a second poll reads the rows as of its own planning, and
a user query's cached plan survives the polls.
"""

from __future__ import annotations

import time

import pyarrow as pa
import pytest
import torch

ACCEPTANCE = (
    "SELECT query_class, count(*), sum(cpu_seconds), sum(shuffle_bytes) "
    "FROM system.queries GROUP BY query_class"
)
QUERIES = ("SELECT k, sum(v) AS s FROM t1 GROUP BY k", "SELECT count(*) AS n FROM t1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t1(n: int) -> pa.Table:
    return pa.table({
        "k": pa.array(["a", "b", "a", "c"] * (n // 4)),
        "v": pa.array(list(range(n)), type=pa.int64()),
    })


def contexts(settings: dict | None = None):
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext

    return (TorchContext(BallistaConfig(settings or {}), device="cpu"),
            TpuContext(RefConfig(settings or {})))


def test_parser_dotted_table_names():
    from ballista_tpu.sql.parser import parse_sql as ref_parse
    from ballista_tpu_torch.sql import ast
    from ballista_tpu_torch.sql.parser import parse_sql

    for sql in ("SELECT status FROM system.queries", "SELECT q.status FROM system.queries q",
                "SHOW COLUMNS FROM system.queries", "DROP TABLE IF EXISTS system.queries"):
        assert repr(parse_sql(sql)) == repr(ref_parse(sql)), sql
    stmt = parse_sql("SELECT q.status FROM system.queries q")
    assert (stmt.from_.name, stmt.from_.alias) == ("system.queries", "q")
    assert isinstance(parse_sql("SHOW COLUMNS FROM system.queries"), ast.ShowColumns)


def test_local_system_queries_through_engine():
    """The reference's local case through both contexts: two queries, the
    acceptance query (two classes, one job each), then ``system.queries``
    with three completed rows of measured work, and empty but typed
    ``system.executors`` and ``system.task_attempts``."""
    results = {}
    for side, ctx in zip(("port", "ref"), contexts()):
        ctx.register_table("t1", t1(100))
        for q in QUERIES:
            ctx.sql(q).collect()
        acc = ctx.sql(ACCEPTANCE).collect()
        rows = ctx.sql("SELECT job_id, query_class, status, wall_seconds, cpu_seconds FROM system.queries").collect()
        results[side] = dict(
            acc=acc, rows=rows, logged=len(ctx._system_history().jobs()),
            ex=ctx.sql("SELECT * FROM system.executors").collect(),
            at=ctx.sql("SELECT * FROM system.task_attempts").collect(),
        )
    got, want = results["port"], results["ref"]
    assert got["acc"].schema.equals(want["acc"].schema)
    assert got["acc"].num_rows == want["acc"].num_rows == 2
    assert sorted(got["acc"].column(1).to_pylist()) == sorted(want["acc"].column(1).to_pylist()) == [1, 1]
    assert sorted(got["acc"].column(0).to_pylist()) == sorted(want["acc"].column(0).to_pylist())
    assert got["acc"].column(3).to_pylist() == [0, 0]
    r = got["rows"].to_pydict()
    assert got["rows"].schema.equals(want["rows"].schema)
    assert len(r["status"]) == want["rows"].num_rows == 3
    assert set(r["status"]) == {"completed"}
    assert all(w > 0 for w in r["wall_seconds"]) and all(c > 0 for c in r["cpu_seconds"])
    # newest first, the local ids counting up, as in the reference
    assert r["job_id"] == ["local-000003", "local-000002", "local-000001"]
    assert r["query_class"] == want["rows"].column("query_class").to_pylist()
    assert got["logged"] == want["logged"] == 4  # the system query logged after its scan
    for k in ("ex", "at"):
        assert got[k].num_rows == want[k].num_rows == 0
        assert got[k].schema.equals(want[k].schema), k


def test_local_accounting_off_is_inert():
    for ctx in contexts({"ballista.tpu.cost_accounting": "false"}):
        ctx.register_table("t1", pa.table({"v": pa.array([1, 2, 3])}))
        ctx.sql("SELECT sum(v) AS s FROM t1").collect()
        assert ctx.sql("SELECT job_id FROM system.queries").collect().num_rows == 0


def test_system_plans_bypass_the_plan_cache():
    """Each poll of ``system.queries`` reads the rows as of its planning
    (the count grows by one a poll), the polls leave the physical-plan
    cache's user plan in place, and the user query keeps its plan."""
    ctx, _ = contexts()
    ctx.register_table("t1", t1(100))
    ctx.sql(QUERIES[0]).collect()
    cached = dict(ctx._physical_cache)
    counts = [ctx.sql("SELECT count(*) AS n FROM system.queries").collect().column(0)[0].as_py() for _ in range(3)]
    assert counts == [1, 2, 3]
    assert ctx._physical_cache == cached
    phys = ctx.create_physical_plan(ctx.sql_to_logical(QUERIES[0]))
    assert any(phys is p for p in cached.values())
    # SHOW TABLES lists the materialized system table, as the reference's does
    _, ref = contexts()
    ref.register_table("t1", t1(100))
    ref.sql("SELECT count(*) AS n FROM system.queries").collect()
    assert ctx.sql("SHOW TABLES").collect().equals(ref.sql("SHOW TABLES").collect())


# ---------------------------------------------------------------------------
# cluster level: one port cluster and one reference cluster a module
# ---------------------------------------------------------------------------


def settle(sched, n_jobs: int) -> None:
    """A job's terminal history row lands just after its client sees it
    complete: wait until ``n_jobs`` jobs are terminal in the log."""
    deadline = time.time() + 30
    while time.time() < deadline:
        if sum(r["status"] != "submitted" for r in sched.history.jobs()) >= n_jobs:
            return
        time.sleep(0.02)


@pytest.fixture(scope="module")
def clusters():
    from ballista_tpu.client.context import BallistaContext as RefClient
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    settings = {"ballista.shuffle.partitions": "2"}
    made = {
        "port": BallistaContext.standalone(BallistaConfig(settings), device="cpu", n_executors=1),
        "ref": RefClient.standalone(RefConfig(settings), n_executors=1),
    }
    try:
        for ctx in made.values():
            ctx.register_table("t1", t1(200))
            for q in QUERIES:
                ctx.sql(q).collect()
            settle(ctx._standalone_cluster.scheduler, len(QUERIES))
        yield made
    finally:
        for ctx in made.values():
            ctx.close()


def test_cluster_acceptance_query_matches_reference(clusters):
    """The acceptance query against the scheduler's history: two classes,
    measured CPU seconds and shuffle bytes, the same classes as the
    reference's cluster."""
    got, want = (clusters[s].sql(ACCEPTANCE).collect() for s in ("port", "ref"))
    assert got.schema.equals(want.schema)
    d = got.to_pydict()
    assert got.num_rows == want.num_rows == 2, d
    assert sorted(d[got.column_names[0]]) == sorted(want.column(0).to_pylist())
    assert all(c > 0 for c in d[got.column_names[2]]), d
    assert sum(d[got.column_names[3]]) > 0, d


def test_cluster_attempts_and_executors_match_reference(clusters):
    """``system.task_attempts``: one completed row per task of each job, the
    reference's stages and partitions, wall time in every row and CPU time
    in all; ``system.executors``: the one executor, alive, with slots."""
    sql = ("SELECT stage_id, partition, state FROM system.task_attempts "
           "ORDER BY stage_id, partition, state")
    got, want = (clusters[s].sql(sql).collect() for s in ("port", "ref"))
    assert got.schema.equals(want.schema)
    assert sorted(got.to_pylist(), key=str) == sorted(want.to_pylist(), key=str)
    assert set(got.column("state").to_pylist()) == {"completed"}
    at = clusters["port"].sql("SELECT wall_seconds, cpu_seconds FROM system.task_attempts").collect().to_pydict()
    assert len(at["wall_seconds"]) >= 3
    assert all(w > 0 for w in at["wall_seconds"]) and sum(at["cpu_seconds"]) > 0
    ex_sql = "SELECT alive, task_slots, n_devices FROM system.executors"
    ex, ref_ex = (clusters[s].sql(ex_sql).collect() for s in ("port", "ref"))
    assert ex.schema.equals(ref_ex.schema)
    assert ex.column("alive").to_pylist() == ref_ex.column("alive").to_pylist() == [True]
    assert ex.column("task_slots")[0].as_py() >= 1
    assert ex.column("n_devices").to_pylist() == ref_ex.column("n_devices").to_pylist()


def test_cluster_system_join_with_user_table(clusters):
    """A query joining a system table with a user table runs client-side,
    on both packages, to the same rows."""
    sql = ("SELECT t1.k, count(*) AS n FROM t1 JOIN system.executors e ON e.alive = (t1.v >= 0) "
           "GROUP BY t1.k ORDER BY t1.k")
    got, want = (clusters[s].sql(sql).collect() for s in ("port", "ref"))
    assert got.to_pydict() == want.to_pydict()
    assert got.column("n").to_pylist() == [100, 50, 50]


def test_sqlite_history_survives_scheduler_restart(tmp_path):
    """History written on the sqlite backend survives a restart of the
    port's scheduler: a new cluster over the same file re-serves the old
    job through ``system.queries`` with its class and status."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.scheduler.state_backend import SqliteBackend
    from ballista_tpu_torch.standalone import StandaloneCluster

    path = str(tmp_path / "sched.db")
    cfg = BallistaConfig({"ballista.shuffle.partitions": "2"})

    def cluster():
        c = StandaloneCluster.start(cfg, 2, state_backend=SqliteBackend(path), device="cpu")
        ctx = BallistaContext(f"localhost:{c.scheduler_port}", cfg, device="cpu")
        ctx._standalone_cluster = c
        c.attach_provider(ctx)
        return ctx

    ctx = cluster()
    ctx.register_table("t1", t1(200))
    ctx.sql(QUERIES[0]).collect()
    sched = ctx._standalone_cluster.scheduler
    settle(sched, 1)
    (before,) = sched.history.jobs()
    assert before["status"] == "completed" and before["cost"]["wall_seconds"] > 0
    ctx.close()

    ctx2 = cluster()
    try:
        rows = ctx2.sql("SELECT job_id, query_class, status, wall_seconds FROM system.queries").collect().to_pydict()
        i = rows["job_id"].index(before["job_id"])
        assert rows["status"][i] == "completed"
        assert rows["query_class"][i] == before["query_class"]
        assert rows["wall_seconds"][i] > 0
    finally:
        ctx2.close()


def test_system_query_on_a_cluster_needs_no_executor_task(clusters):
    """A system-table query submits no job: the scheduler's job count is
    unchanged after it."""
    sched = clusters["port"]._standalone_cluster.scheduler
    before = set(sched.jobs)
    n = clusters["port"].sql("SELECT count(*) AS n FROM system.queries").collect().column(0)[0].as_py()
    assert set(sched.jobs) == before
    assert n >= len(QUERIES)
