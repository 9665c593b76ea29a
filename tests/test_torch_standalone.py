"""The port's own cluster on the CPU: ``BallistaContext.standalone(
device="cpu")`` boots the port's scheduler and two port executors in this
process, and every query goes the whole way: the client plans it
logically, the plan crosses as proto bytes, the scheduler verifies,
plans, splits and hands out the stages, the executors run them and the
client fetches the result partitions.

All 22 TPC-H queries at SF=0.002 (spec constants that select nothing
replaced from the data, ``tpch.spec_substitutions``) equal the reference's
``TpuContext``, held as ``tests/test_tpch_distributed.py`` holds them: rows
sorted, keys and counts exactly, floats within rtol 1e-9, and the money
sums bit for bit against the reference's third run (its exact one, see
``tests/test_torch_stages.py``). q1, q3, q5, q12 and q18 run push-staged
too, and with eager shuffle, push shuffle and the local fast path off (so
every read crosses Flight). An executor killed between q3's stages, one
that holds output of the stage just finished, leaves q3 equal, and a
query submitted to a scheduler with no executor uploads nothing to a
device and reads no file. q1, q3, q5, q12 and q18 also run
over Parquet tables created by DDL through the client, each executor
opening the files itself, against the reference reading the same files.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
from ballista_tpu_torch.executor import push, reader
from ballista_tpu_torch.tpch import gen_all
from test_torch_stages import ORDER_DEPENDENT_FLOATS, query_sql, reference_exact
from test_torch_tpch import cmp

SCALE = 0.002
QUERIES = [f"q{i}" for i in range(1, 23)]
FIVE = ["q1", "q3", "q5", "q12", "q18"]
# q5's revenue is a dense-path f64 sum (its group key n_name is a
# dictionary key), whose order of adds follows the shuffle partitioning:
# at the default two partitions it is one ulp off the reference's collect
ORDER_DEPENDENT = {**ORDER_DEPENDENT_FLOATS, "q5": {"revenue"}}
OFF = {
    "ballista.tpu.eager_shuffle": "false",
    "ballista.tpu.push_shuffle": "false",
    "ballista.tpu.shuffle_local_fastpath": "false",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: in a parallel test run every worker's intra-op
    pool would oversubscribe the cores (see test_torch_repartition.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    return gen_all(SCALE, 42)


_WANT: dict = {}


def want_of(data, q: str) -> pa.Table:
    """The reference's exact collect of ``q`` (computed once a module)."""
    if q not in _WANT:
        _WANT[q] = reference_exact(data, query_sql(q, data))
    return _WANT[q]


def cluster_of(data, config=None, **kw) -> BallistaContext:
    ctx = BallistaContext.standalone(
        config, device="cpu", n_executors=2, concurrent_tasks=2, **kw
    )
    for name, t in data.items():
        ctx.register_table(name, t)
    return ctx


@pytest.fixture(scope="module")
def default_cluster(data):
    ctx = cluster_of(data)
    yield ctx
    ctx.close()


def sorted_rows(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def assert_matches(got: pa.Table, want: pa.Table, q: str) -> None:
    """Keys and counts exactly, floats within rtol 1e-9, rows sorted; the
    float columns but the order-dependent sums bit for bit."""
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    g, w = sorted_rows(got), sorted_rows(want)
    cmp(g.to_pandas(), w.to_pandas())
    skip = ORDER_DEPENDENT.get(q, ())
    for name in w.column_names:
        if name not in skip and pa.types.is_floating(w.schema.field(name).type):
            a = g.column(name).to_numpy(zero_copy_only=False)
            b = w.column(name).to_numpy(zero_copy_only=False)
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), (q, name)


def run(ctx: BallistaContext, data, q: str):
    """One query through the cluster: its result and its job."""
    sched = ctx._standalone_cluster.scheduler
    before = set(sched.jobs)
    got = ctx.sql(query_sql(q, data)).collect()
    (job_id,) = set(sched.jobs) - before
    return got, sched.jobs[job_id]


def reader_counter(job, name: str) -> float:
    """The sum of one counter over the job's shuffle readers, as the
    executors shipped their operator metrics home."""
    return sum(
        r["counters"].get(name, 0)
        for records in job.op_metrics.values()
        for r in records
        if r["operator"] == "ShuffleReaderExec"
    )


@pytest.mark.parametrize("q", QUERIES)
def test_standalone_query_matches_reference(default_cluster, data, q):
    """Default settings: eager shuffle, push shuffle, the local fast path,
    the verifier and the skew monitor on. Every job reads eager-fed or
    pushed input."""
    pushed = push.REGISTRY.total_pushed
    got, job = run(default_cluster, data, q)
    assert job.status == "completed" and len(job.stages) > 1
    assert_matches(got, want_of(data, q), q)
    assert reader_counter(job, "eager_polls") or push.REGISTRY.total_pushed > pushed


@pytest.mark.parametrize("q", FIVE)
def test_standalone_push_staged_matches_reference(data, push_cluster, q):
    got, job = run(push_cluster, data, q)
    assert job.status == "completed"
    assert_matches(got, want_of(data, q), q)


@pytest.fixture(scope="module")
def push_cluster(data):
    ctx = cluster_of(data, policy=TaskSchedulingPolicy.PUSH_STAGED)
    yield ctx
    ctx.close()


@pytest.fixture(scope="module")
def off_cluster(data):
    ctx = cluster_of(data, BallistaConfig(OFF))
    yield ctx
    ctx.close()


@pytest.mark.parametrize("q", FIVE)
def test_standalone_every_read_crosses_flight(data, off_cluster, q):
    """Eager shuffle, push shuffle and the local fast path off: every
    shuffle read and the result fetch go over Arrow Flight."""
    reader.reset_stats()
    got, job = run(off_cluster, data, q)
    assert job.status == "completed"
    assert_matches(got, want_of(data, q), q)
    assert reader.stats["flight_bytes"] > 0
    assert reader_counter(job, "eager_polls") == 0


def test_kill_executor_between_q3_stages_recomputes(data):
    """A two-executor cluster with tight liveness knobs loses, when q3's
    first stage finishes, an executor that holds output of that stage (its
    loops stop, its Flight service goes down, its shuffle files are
    deleted): the scheduler reports it lost, recomputes its work, and q3
    still equals the reference.

    Eager shuffle is off, so that no consumer of the stage runs, or reads
    the lost output, before the stage finishes and the kill is made: with
    it on, eager consumers could read every partition of that output first
    and finish before the executor expired, and then nothing was left to
    recompute (the kill also hit a fixed executor, which may have held no
    output of the stage)."""
    ctx = cluster_of(
        data, BallistaConfig({"ballista.tpu.eager_shuffle": "false"}),
        executor_timeout_s=5.0, expiry_check_interval_s=1.0,
    )
    try:
        cluster = ctx._standalone_cluster
        sched = cluster.scheduler
        killed: list = []
        expired: list = []
        finished = sched._on_stage_finished
        check = sched.check_expired_executors

        def on_stage_finished(job_id, stage_id):
            if not killed:
                # the executor of the stage's first completed task
                holders = [e for _, e, _ in sched.stage_manager.completed_partitions(job_id, stage_id)]
                victim = next(
                    i for i, h in enumerate(cluster.executors) if h.executor.executor_id == holders[0]
                )
                killed.append(cluster.kill_executor(victim))
            finished(job_id, stage_id)

        def check_expired():
            out = check()
            expired.extend(out)
            return out

        sched._on_stage_finished = on_stage_finished
        sched.check_expired_executors = check_expired
        got, job = run(ctx, data, "q3")
        # lineage recovery may finish q3 before the heartbeat expires
        deadline = time.time() + 15
        while not expired and time.time() < deadline:
            time.sleep(0.1)
        assert killed and expired == killed, (killed, expired)
        assert job.total_recomputes + job.total_retries >= 1
        assert_matches(got, want_of(data, "q3"), "q3")
    finally:
        ctx.close()


@pytest.fixture(scope="module")
def parquet_dir(data, tmp_path_factory):
    import pyarrow.parquet as papq

    d = tmp_path_factory.mktemp("tpch-parquet")
    for name, t in data.items():
        papq.write_table(t, d / f"{name}.parquet", row_group_size=4096)
    return d


def ddl(d, name: str) -> str:
    return f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET LOCATION '{d / name}.parquet'"


def test_submission_uploads_nothing_without_an_executor(data, parquet_dir, monkeypatch):
    """The scheduler plans and never runs an operator: a query submitted
    to a scheduler no executor has joined leaves the provider's scan
    device caches empty, over memory tables and over Parquet tables, where
    it opens no file either (row groups are pruned when a task runs)."""
    for source in ("memory", "parquet"):
        _submit_without_executor(data, parquet_dir, source, monkeypatch)


def _submit_without_executor(data, parquet_dir, source, monkeypatch):
    import pyarrow.parquet as papq

    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    provider = TorchContext(device="cpu")
    for name, t in data.items():
        if source == "memory":
            provider.register_table(name, t)
        else:
            provider.sql(ddl(parquet_dir, name))
    reads = []
    monkeypatch.setattr(papq, "ParquetFile", lambda *a, **kw: reads.append(a))
    server = SchedulerServer(provider=provider)
    try:
        session = server.get_or_create_session("", {})
        job_id = server.submit_sql(query_sql("q5", data), session)
        deadline = time.time() + 30
        while server._get_job(job_id).status == "queued" and time.time() < deadline:
            time.sleep(0.01)
        job = server._get_job(job_id)
        assert job.status == "running" and len(job.stages) > 1, job.error
        assert server.stage_manager.inflight_tasks() > 0
        assert all(
            not r.kw.get("device_cache") and not r.kw.get("scan_cache") for r in provider.tables.values()
        )
        assert not reads
    finally:
        server.shutdown()
        monkeypatch.undo()


def test_parquet_tables_through_the_cluster(data, parquet_dir):
    """The five queries over Parquet tables created by DDL through the
    client (statements run client-side; each executor opens the files the
    plan names) equal the reference reading the same files."""
    from ballista_tpu.exec.context import TpuContext

    ref = TpuContext()
    ctx = BallistaContext.standalone(
        BallistaConfig({"ballista.shuffle.partitions": "4"}), device="cpu", n_executors=2, concurrent_tasks=2
    )
    try:
        for name in data:
            ref.sql(ddl(parquet_dir, name))
            assert ctx.sql(ddl(parquet_dir, name)).collect().to_pydict() == {"result": ["ok"]}
        assert ctx.sql("SHOW TABLES").collect().column("table_name").to_pylist() == sorted(data)
        for q in FIVE:
            sql = query_sql(q, data)
            for _ in range(2):
                ref.sql(sql).collect()
            got, job = run(ctx, data, q)
            assert_matches(got, ref.sql(sql).collect(), q)
            assert job.status == "completed" and len(job.stages) > 1
            # the client's scans never ran: the executors read the files
            assert not any(r.kw.get("scan_cache") for r in ctx.tables.values())
    finally:
        ctx.close()


def test_concurrent_clients_share_one_cluster(default_cluster, data):
    """Two sessions submit at once through one cluster; each gets its own
    result."""
    other = BallistaContext(
        f"localhost:{default_cluster._standalone_cluster.scheduler_port}",
        device="cpu",
    )
    try:
        for name, t in data.items():
            other.register_table(name, t)
        out: dict = {}

        def go(ctx, q):
            out[q] = ctx.sql(query_sql(q, data)).collect()

        threads = [
            threading.Thread(target=go, args=(default_cluster, "q1")),
            threading.Thread(target=go, args=(other, "q12")),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert other.session_id != default_cluster.session_id
        for q in ("q1", "q12"):
            assert_matches(out[q], want_of(data, q), q)
    finally:
        other.close()


def test_result_cache_serves_a_repeated_query(data):
    """With ``ballista.tpu.result_cache_mb`` set on the scheduler, a
    repeated query over unchanged data is answered from the cache (the
    committed result rides the status reply), equal to the first run."""
    ctx = cluster_of(data, BallistaConfig({"ballista.tpu.result_cache_mb": "64"}))
    try:
        sched = ctx._standalone_cluster.scheduler
        first, job1 = run(ctx, data, "q12")
        deadline = time.time() + 30
        while sched.result_cache.stats()["entries"] == 0 and time.time() < deadline:
            time.sleep(0.05)
        again, job2 = run(ctx, data, "q12")
        assert job1.result_ipc == b"" and job2.result_ipc != b""
        assert not job2.stages and job2.status == "completed"
        assert again.equals(first)
    finally:
        ctx.close()


def test_single_stage_query_bypasses_the_stage_machine(data):
    """A plan of one stage with one input partition is granted as one
    direct task (the serving fast path), outside the stage manager."""
    from ballista_tpu_torch.exec.context import TorchContext

    ctx = cluster_of(data, BallistaConfig({"ballista.shuffle.partitions": "1"}))
    try:
        sched = ctx._standalone_cluster.scheduler
        sql = "select n_nationkey, n_name from nation where n_regionkey = 1"
        got = ctx.sql(sql).collect()
        (job,) = sched.jobs.values()
        assert job.bypass and job.status == "completed" and sched.obs_bypass_total == 1
        local = TorchContext(device="cpu")
        local.register_table("nation", data["nation"])
        assert sorted_rows(got).equals(sorted_rows(local.sql(sql).collect()))
    finally:
        ctx.close()
