"""Hash repartition and the distributed planner of the port, against the
reference: ``HashRepartitionExec`` masking in process, the distributed
plans' ``display()`` (hash exchanges between partial and final aggregates,
partitioned joins over repartitioned sides, string-keyed joins kept in
collect mode), and those trees executed in process on the CPU against the
reference's collect results."""

import pathlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.columnar.arrow_interop import batch_to_arrow as ref_batch_to_arrow
from ballista_tpu.columnar.arrow_interop import schema_from_arrow as ref_schema_from_arrow
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec.base import TaskContext as RefTaskContext
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.planner import PhysicalPlanner as RefPlanner
from ballista_tpu.exec.repartition import HashRepartitionExec as RefRepartition
from ballista_tpu.exec.scan import MemoryScanExec as RefScan
from ballista_tpu.expr import logical as RL
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow, schema_from_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.base import (
    HashPartitioning,
    TaskContext,
    execute_to_batches,
    run_with_capacity_retry,
)
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.planner import PhysicalPlanner
from ballista_tpu_torch.exec.repartition import HashRepartitionExec
from ballista_tpu_torch.exec.scan import MemoryScanExec
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.tpch import gen_all

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.005
QUERIES = ["q1", "q3", "q5", "q12", "q18"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU runs take one torch thread. In a parallel test run
    every worker's intra-op pool oversubscribes the cores, and the many
    small ops of the spill passes and the K-way views then run tens of
    times slower (a 1 MB-budget q3 at SF=0.006 on an 8-core host with every
    core busy: 2.3 s on one thread, 73 s on eight)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cmp(res: pd.DataFrame, want: pd.DataFrame, rtol=1e-9):
    """Floats within rtol, every other column exactly."""
    assert len(res) == len(want), f"rows: port {len(res)} reference {len(want)}"
    assert list(res.columns) == list(want.columns)
    for c in want.columns:
        a, b = res[c], want[c]
        if pd.api.types.is_float_dtype(b):
            np.testing.assert_allclose(
                a.to_numpy(dtype=float), b.to_numpy(dtype=float), rtol=rtol, err_msg=c
            )
        else:
            assert list(a) == list(b), c


@pytest.fixture(scope="module")
def tpch():
    data = gen_all(SCALE, 42)
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    # q18's spec threshold (300) selects nothing at this scale: take it from
    # the data, as tests/test_tpch_oracle.py does
    per_order = data["lineitem"].to_pandas().groupby("l_orderkey").l_quantity.sum()
    thr = int(np.floor(per_order.quantile(0.95)))
    return ref, port, thr


def query(q: str, thr: int) -> str:
    return (QDIR / f"{q}.sql").read_text().replace("> 300", f"> {thr}")


def plans(ref, port, sql: str, partitions: int = 4, settings: dict | None = None):
    rcfg = RefConfig()
    for k, v in (settings or {}).items():
        rcfg = rcfg.with_setting(k, v)
    pcfg = BallistaConfig(settings or {})
    rp = RefPlanner(ref, partitions, config=rcfg, distributed=True).plan(
        ref_optimize(ref.sql_to_logical(sql))
    )
    pp = PhysicalPlanner(port, partitions, config=pcfg, distributed=True).plan(
        optimize(port.sql_to_logical(sql))
    )
    return rp, pp


def run_in_process(plan, config=None) -> pa.Table:
    """Every output partition of a plan on the CPU, under the retry loop."""

    def run(ctx):
        return [rb for b in execute_to_batches(plan, ctx) if (rb := batch_to_arrow(b)).num_rows]

    batches = run_with_capacity_retry(config or BallistaConfig(), run, device="cpu")
    return pa.Table.from_batches(batches)


def test_repartition_exec_in_process():
    """Masking in process: every live row lands in exactly one output
    partition, values survive, and each partition holds the rows the
    reference's repartition puts there."""
    n = 5000
    r = np.random.default_rng(5)
    t = pa.table({
        "k": pa.array(r.integers(0, 97, n)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    })
    scan = MemoryScanExec(t, schema_from_arrow(t.schema), None, 2)
    rep = HashRepartitionExec(scan, [L.Column("k")], 4)
    assert isinstance(rep.output_partitioning(), HashPartitioning)
    assert rep.output_partitioning().n == 4
    ref_rep = RefRepartition(RefScan(t, ref_schema_from_arrow(t.schema), None, 2), [RL.Column("k")], 4)
    ctx, rctx = TaskContext(device="cpu"), RefTaskContext()
    seen = []
    for p in range(4):
        got = [v for b in rep.execute(p, ctx) for v in batch_to_arrow(b).column("v").to_pylist()]
        want = [v for b in ref_rep.execute(p, rctx) for v in ref_batch_to_arrow(b).column("v").to_pylist()]
        assert got == want
        seen.extend(got)
    assert sorted(seen) == list(range(n))
    # one materialization per task context: one batch, its partition ids
    assert rep._cache[0] is ctx and rep._cache[1][1].shape == rep._cache[1][0].valid.shape


def test_repartition_needs_column_keys():
    from ballista_tpu_torch.errors import ExecutionError

    t = pa.table({"k": pa.array([1, 2, 3])})
    scan = MemoryScanExec(t, schema_from_arrow(t.schema), None, 1)
    with pytest.raises(ExecutionError):
        HashRepartitionExec(scan, [], 2)
    rep = HashRepartitionExec(scan, [L.Literal(1, None)], 2)
    with pytest.raises(ExecutionError, match="must be a column"):
        list(rep.execute(0, TaskContext(device="cpu")))


@pytest.mark.parametrize("q", QUERIES)
def test_distributed_plan_display_matches_reference(tpch, q):
    ref, port, thr = tpch
    rp, pp = plans(ref, port, query(q, thr))
    assert pp.display() == rp.display()
    text = pp.display()
    assert "HashRepartitionExec" in text
    if q in ("q3", "q5", "q12", "q18"):
        assert "partitioned" in text


@pytest.mark.parametrize(
    "settings",
    [
        {"ballista.repartition.joins": "false"},
        {"ballista.repartition.aggregations": "false"},
        {"ballista.repartition.joins": "false", "ballista.repartition.aggregations": "false"},
    ],
    ids=["no-joins", "no-aggregations", "neither"],
)
def test_repartition_settings_match_reference(tpch, settings):
    ref, port, thr = tpch
    rp, pp = plans(ref, port, query("q12", thr), settings=settings)
    assert pp.display() == rp.display()
    text = pp.display()
    assert ("partitioned" in text) == (settings.get("ballista.repartition.joins") != "false")


def test_string_keyed_join_stays_in_collect_mode(tpch):
    ref, port, _ = tpch
    sql = (
        "select n_name, count(*) as c from nation join region on n_name = r_name "
        "group by n_name"
    )
    rp, pp = plans(ref, port, sql)
    assert pp.display() == rp.display()
    assert "collect" in pp.display() and "partitioned" not in pp.display()


@pytest.mark.parametrize("q", QUERIES)
def test_distributed_tree_in_process_matches_reference(tpch, q):
    ref, port, thr = tpch
    sql = query(q, thr)
    _, pp = plans(ref, port, sql)
    want = ref.sql(sql).collect()
    assert want.num_rows > 0
    got = run_in_process(pp)
    assert got.schema.equals(want.schema)
    cmp(got.to_pandas(), want.to_pandas())


def test_final_aggregate_merges_only_its_partition(tpch):
    """Under a hash repartition the final aggregate runs K merges, each
    owning the groups of its bucket: the partitions' group keys are
    disjoint and together the whole result."""
    ref, port, thr = tpch
    sql = "select l_orderkey, sum(l_quantity) as q from lineitem group by l_orderkey"
    _, pp = plans(ref, port, sql)
    assert pp.output_partitioning().n == 4
    ctx = TaskContext(device="cpu")
    keys = []
    for p in range(4):
        keys.append({
            k for b in pp.execute(p, ctx) for k in batch_to_arrow(b).column("l_orderkey").to_pylist()
        })
    ctx.raise_deferred()
    assert all(keys) and sum(map(len, keys)) == len(set().union(*keys))
    want = ref.sql(sql).collect()
    assert set().union(*keys) == set(want.column("l_orderkey").to_pylist())
