"""The staged path of the port against the reference, on the CPU: a query
planned for the distributed tier (K = 4), split into stages, every stage's
plan sent through proto bytes, every task writing its shuffle files into a
work directory and every stage reading its inputs' files
(``run_staged``, the loop that plays the scheduler's part). All 22 TPC-H
queries at SF=0.002 equal the reference's ``TpuContext`` collect, and q1,
q3 and q12 write the reference's own staged run's files, bucket for
bucket."""

import datetime
import pathlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import torch

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.distributed_plan import DistributedPlanner as RefDistributedPlanner
from ballista_tpu.distributed_plan import remove_unresolved_shuffles as ref_remove_unresolved
from ballista_tpu.exec.base import run_with_capacity_retry as ref_run_with_capacity_retry
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
from ballista_tpu.executor.reader import fetch_partition_table as ref_fetch_partition_table
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu.proto import pb as ref_pb
from ballista_tpu.scheduler_types import PartitionLocation as RefLocation
from ballista_tpu.serde import BallistaCodec as RefCodec
from ballista_tpu_torch.columnar.arrow_interop import schema_to_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.distributed_plan import DistributedPlanner, remove_unresolved_shuffles
from ballista_tpu_torch.exec.base import run_with_capacity_retry
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.planner import PhysicalPlanner
from ballista_tpu_torch.executor.reader import fetch_partition_table
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler_types import PartitionLocation, PartitionStats
from ballista_tpu_torch.serde import BallistaCodec
from ballista_tpu_torch.tpch import gen_all, spec_substitutions
from test_torch_tpch import cmp

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.002
K = 4
QUERIES = [f"q{i}" for i in range(1, 23)]
# Float sums that neither engine takes through its exact decimal scaling:
# q1's dense aggregate sums f64 values in a fixed order of adds, q14's
# scalar aggregate in batch order, so a staged plan's order of adds gives
# other last bits; they are held to rtol 1e-9. Every other float column
# equals the reference's bit for bit: the money sums are int64 sums at a
# learned decimal scale, exact from the port's first run and from the
# reference's third (run 1 learns the partial scales, run 2 the merge
# scales), so the reference side is the third run of a fresh context.
# q15's total_revenue is exact on both sides and yet one ulp apart: the
# reference's third run misses the correctly rounded sum by one ulp (701556.0425
# at SF=0.002); test_q15_revenue_is_the_exact_sum holds the port's to it.
ORDER_DEPENDENT_FLOATS = {
    "q1": {"sum_base_price", "sum_disc_price", "sum_charge", "avg_price", "avg_disc"},
    "q14": {"promo_revenue"},
    "q15": {"total_revenue"},
}


def run_staged(port, sql, work_dir, partitions=K, plan_cache=None, device="cpu", job_id="job"):
    """One query through the staged path: plan for the distributed tier,
    split into stages, send each stage's plan through proto bytes, resolve
    its inputs to the files of the stages before it, and run one task an
    input partition, each writing its shuffle files under ``work_dir``.
    Returns the terminal stage's files as one table, and the stages."""
    cfg = BallistaConfig({"ballista.shuffle.partitions": str(partitions)})
    plan = PhysicalPlanner(port, partitions, config=cfg, distributed=True).plan(
        optimize(port.sql_to_logical(sql))
    )
    stages = DistributedPlanner().plan_query_stages(job_id, plan)
    codec = BallistaCodec(provider=port)
    locations: dict = {}
    for stage in stages:
        decoded = codec.physical_from_proto(
            pb.PhysicalPlanNode.FromString(codec.physical_to_proto(stage.plan).SerializeToString())
        )
        assert decoded.display() == stage.plan.display()
        task = remove_unresolved_shuffles(decoded, locations)
        parts = [[] for _ in range(stage.output_partition_count)]
        for p in range(stage.input_partition_count):
            metas = run_with_capacity_retry(
                cfg, lambda ctx: task.execute_shuffle_write(p, ctx), device=device,
                plan_cache=plan_cache, work_dir=str(work_dir), job_id=job_id,
            )
            for m in metas:
                parts[m.partition_id].append(PartitionLocation(
                    job_id, stage.stage_id, m.partition_id, "local", "localhost", 0, m.path,
                    PartitionStats(m.num_rows, m.num_batches, m.num_bytes), map_partition=p,
                ))
        locations[stage.stage_id] = parts
    tables = [fetch_partition_table(loc) for part in locations[stages[-1].stage_id] for loc in part]
    result = pa.concat_tables(tables) if tables else schema_to_arrow(plan.schema()).empty_table()
    return result, stages


def ref_run_staged(ref, sql, work_dir, partitions=K, job_id="job"):
    """``run_staged`` through the reference's own modules."""
    cfg = RefConfig().with_setting("ballista.shuffle.partitions", str(partitions))
    plan = RefPlanner(ref, partitions, config=cfg, distributed=True).plan(
        ref_optimize(ref.sql_to_logical(sql))
    )
    stages = RefDistributedPlanner().plan_query_stages(job_id, plan)
    codec = RefCodec(provider=ref)
    locations: dict = {}
    plan_cache: dict = {}
    for stage in stages:
        task = ref_remove_unresolved(
            codec.physical_from_proto(
                ref_pb.PhysicalPlanNode.FromString(codec.physical_to_proto(stage.plan).SerializeToString())
            ),
            locations,
        )
        parts = [[] for _ in range(stage.output_partition_count)]
        for p in range(stage.input_partition_count):
            metas = ref_run_with_capacity_retry(
                cfg, lambda ctx: task.execute_shuffle_write(p, ctx), plan_cache=plan_cache,
                work_dir=str(work_dir), job_id=job_id,
            )
            for m in metas:
                parts[m.partition_id].append(
                    RefLocation(job_id, stage.stage_id, m.partition_id, "local", "localhost", 0, m.path)
                )
        locations[stage.stage_id] = parts
    tables = [ref_fetch_partition_table(loc) for part in locations[stages[-1].stage_id] for loc in part]
    return pa.concat_tables(tables), stages


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: in a parallel test run every worker's intra-op
    pool would oversubscribe the cores (see test_torch_repartition.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def env():
    data = gen_all(SCALE, 42)
    port = TorchContext(device="cpu")
    for name, t in data.items():
        port.register_table(name, t)
    return data, port


def fresh_reference(data) -> TpuContext:
    ref = TpuContext()
    for name, t in data.items():
        ref.register_table(name, t)
    return ref


def reference_exact(data, sql: str) -> pa.Table:
    """The reference's collect once its decimal scales are learned: the
    third run of a fresh context."""
    ref = fresh_reference(data)
    for _ in range(2):
        ref.sql(sql).collect()
    return ref.sql(sql).collect()


def query_sql(q: str, data) -> str:
    sql = (QDIR / f"{q}.sql").read_text()
    for old, new in spec_substitutions(q, data).items():
        sql = sql.replace(old, new)
    return sql


def assert_bit_equal(got: pa.Table, want: pa.Table, skip=()) -> None:
    for name in want.column_names:
        if name not in skip and pa.types.is_floating(want.schema.field(name).type):
            a = got.column(name).to_numpy(zero_copy_only=False)
            b = want.column(name).to_numpy(zero_copy_only=False)
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), name


@pytest.mark.parametrize("q", QUERIES)
def test_staged_query_matches_reference(env, q, tmp_path):
    """Cold and warm staged runs (one plan cache across them, as an
    executor keeps one) against the reference's exact collect: keys,
    counts and order exactly, floats within rtol 1e-9 and, but for the
    order-dependent sums, bit for bit; the warm run bit-identical to the
    cold one."""
    data, port = env
    sql = query_sql(q, data)
    want = reference_exact(data, sql)
    cache: dict = {}
    cold, stages = run_staged(port, sql, tmp_path / "cold", plan_cache=cache)
    warm, _ = run_staged(port, sql, tmp_path / "warm", plan_cache=cache)
    assert len(stages) > 1
    assert cold.schema.equals(want.schema)
    cmp(cold.to_pandas(), want.to_pandas())
    assert_bit_equal(cold, want, skip=ORDER_DEPENDENT_FLOATS.get(q, ()))
    assert warm.equals(cold)


def test_q15_revenue_is_the_exact_sum(env, tmp_path):
    """q15 compares a sum with the max of the same sums: the staged plan
    computes them in two stages of their own, and the equality holds
    because both are exact. Each total_revenue is the correctly rounded
    double of its exact decimal sum."""
    data, port = env
    got, _ = run_staged(port, query_sql("q15", data), tmp_path, plan_cache={})
    li = data["lineitem"].to_pandas()
    li = li[(li.l_shipdate >= datetime.date(1996, 1, 1)) & (li.l_shipdate < datetime.date(1996, 4, 1))]
    cents = np.round(li.l_extendedprice.to_numpy() * 100).astype(np.int64)
    disc = np.round(li.l_discount.to_numpy() * 100).astype(np.int64)
    exact = pd.Series(cents * (100 - disc)).groupby(li.l_suppkey.to_numpy()).sum()
    assert got.num_rows >= 1
    for supp, rev in zip(got.column("s_suppkey").to_pylist(), got.column("total_revenue").to_pylist()):
        assert int(exact[supp]) == int(exact.max())
        assert rev == int(exact[supp]) / 10**4


def _files(root: pathlib.Path) -> dict:
    return {
        p.relative_to(root).as_posix(): paipc.open_file(pa.memory_map(str(p))).read_all()
        for p in sorted(root.rglob("*.arrow"))
    }


@pytest.mark.parametrize("q", ["q1", "q3", "q12"])
def test_shuffle_files_match_reference_staged_run(env, q, tmp_path):
    """The reference's own staged run on the CPU (its ShuffleWriterExec
    and ShuffleReaderExec) and the port's write the same files: the same
    paths, Arrow schemas and rows in the same order (floats within rtol
    1e-9: q1's partial sums are dense-path float sums)."""
    data, port = env
    sql = query_sql(q, data)
    want, ref_stages = ref_run_staged(fresh_reference(data), sql, tmp_path / "ref")
    got, stages = run_staged(port, sql, tmp_path / "port", plan_cache={})
    assert [s.plan.display() for s in stages] == [s.plan.display() for s in ref_stages]
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and ref_files
    for path, want_t in ref_files.items():
        got_t = port_files[path]
        assert got_t.schema.equals(want_t.schema), path
        cmp(got_t.to_pandas(), want_t.to_pandas())
    cmp(got.to_pandas(), want.to_pandas())


def test_staged_result_file_of_an_empty_result(env, tmp_path):
    """A query that selects nothing ends in no file, and its result is an
    empty table of the plan's schema, as collect's."""
    data, port = env
    sql = "SELECT n_name, COUNT(*) AS c FROM nation WHERE n_nationkey < 0 GROUP BY n_name ORDER BY n_name"
    got, _ = run_staged(port, sql, tmp_path)
    want = fresh_reference(data).sql(sql).collect()
    assert got.num_rows == want.num_rows == 0
    assert got.schema.equals(want.schema)
