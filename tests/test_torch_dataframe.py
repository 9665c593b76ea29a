"""The DataFrame builder and the context's statements: the cases of
``tests/test_dataframe_api.py`` through the port's ``TorchContext`` (on
the CPU) and the reference's ``TpuContext``, results compared frame for
frame; ``SHOW TABLES``, ``SHOW COLUMNS``, ``DROP TABLE``, ``CREATE
EXTERNAL TABLE`` and ``EXPLAIN [VERBOSE | VERIFY]`` output tables compared
row for row; ``EXPLAIN ANALYZE``'s operator tree and row counts compared
(not its times); ``read_*``, ``append_table`` and the cluster's remote
frames."""

import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from ballista_tpu import functions as RF
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.errors import PlanError as RefPlanError
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.expr.logical import col as rcol
from ballista_tpu.expr.logical import lit as rlit
from ballista_tpu_torch import functions as F
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import PlanError
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.expr.logical import col, lit
from ballista_tpu_torch.tpch import gen_all
from test_torch_tpch import cmp
from test_torch_tpch22 import SCALE, query_sql

# the two packages' builder vocabularies, side by side
PORT = (F, col, lit, PlanError)
REF = (RF, rcol, rlit, RefPlanError)


def sales_tables():
    rng = np.random.default_rng(11)
    n = 500
    return {
        "sales": pa.table(
            {
                "region": pa.array(rng.integers(0, 5, n)),
                "amount": pa.array(rng.uniform(0, 100, n)),
                "qty": pa.array(rng.integers(1, 10, n)),
            }
        ),
        "regions": pa.table(
            {"id": pa.array(np.arange(5, dtype=np.int64)), "name": pa.array([f"r{i}" for i in range(5)])}
        ),
    }


@pytest.fixture(scope="module")
def pair():
    """(reference, port) contexts over the same tables, one partition."""
    settings = {"ballista.shuffle.partitions": "1"}
    ref, port = TpuContext(RefConfig(settings)), TorchContext(BallistaConfig(settings), device="cpu")
    for name, t in sales_tables().items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return ref, port


def both(pair, build):
    """Run one builder program through both contexts; equal results."""
    ref, port = pair
    want = build(ref, REF)
    got = build(port, PORT)
    _same(got, want)
    return got


def _same(got, want) -> None:
    """Keys and counts exactly, floats within rtol 1e-9 (the port's rule)."""
    if isinstance(want, pa.Table):
        assert got.schema.equals(want.schema)
        cmp(got.to_pandas(), want.to_pandas())
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def test_builder_matches_sql(pair):
    def build(ctx, v):
        F_, col_, lit_, _ = v
        return (
            ctx.table("sales")
            .filter(col_("qty") > lit_(3))
            .aggregate([col_("region")], [F_.sum("amount").alias("total"), F_.count_star().alias("c")])
            .sort(col_("region"))
            .collect()
        )

    got = both(pair, build)
    sql = pair[1].sql(
        "select region, sum(amount) as total, count(*) as c "
        "from sales where qty > 3 group by region order by region"
    ).collect()
    pd.testing.assert_frame_equal(got.to_pandas(), sql.to_pandas())


def test_select_project_limit(pair):
    def build(ctx, v):
        _, col_, lit_, _ = v
        return ctx.table("sales").select((col_("amount") * lit_(2)).alias("double"), "qty").limit(7).collect()

    got = both(pair, build)
    assert got.num_rows == 7 and got.column_names == ["double", "qty"]


def test_join_and_schema(pair):
    def build(ctx, v):
        F_, col_, _, _ = v
        return (
            ctx.table("sales")
            .join(ctx.table("regions"), (["region"], ["id"]), how="inner")
            .aggregate([col_("name")], [F_.avg("amount").alias("a")])
            .sort(col_("name").sort(False))
            .collect()
        )

    got = both(pair, build)
    want = pair[1].sql(
        "select name, avg(amount) as a from sales join regions "
        "on region = id group by name order by name desc"
    ).collect()
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    assert both(pair, lambda ctx, v: ctx.table("sales").schema().names) == ["region", "amount", "qty"]


def test_union_distinct_where_alias(pair):
    def build(ctx, v):
        F_, col_, lit_, _ = v
        a = ctx.table("sales").select("region").filter(col_("region") < lit_(2))
        b = ctx.table("sales").select("region").where(col_("region") >= lit_(1))
        return (
            a.union(b).sort("region").collect(),
            a.union(b, all=True).collect().num_rows,
            ctx.table("sales").select("qty").distinct().sort("qty").collect(),
            ctx.table("sales").alias("s").select_columns("s.qty").limit(3, skip=2).collect(),
            ctx.table("sales").aggregate([], [F_.max("qty"), F_.count_distinct("region")]).collect(),
        )

    u, n_all, distinct, aliased, aggs = both(pair, build)
    assert u.column("region").to_pylist() == [0, 1, 2, 3, 4]
    assert n_all > 5 and distinct.num_rows == 9 and aliased.num_rows == 3 and aggs.num_rows == 1


def test_builder_errors(pair):
    for ctx, (_, _, _, err) in zip(pair, (REF, PORT)):
        with pytest.raises(err):
            ctx.table("sales").join(ctx.table("regions"), (["region"], ["id"]), how="sideways")
        with pytest.raises(err):
            ctx.table("sales").join(ctx.table("regions"), (["region", "qty"], ["id"]))
        with pytest.raises(err):
            ctx.sql("show tables").select("x")  # constant frame


def test_read_files_roundtrip(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("k,v\n1,2.5\n2,3.5\n1,4.0\n")
    q = tmp_path / "t.parquet"
    papq.write_table(pa.table({"k": [1, 2, 1], "v": [2.5, 3.5, 4.0]}), q)
    ref, port = TpuContext(), TorchContext(device="cpu")

    def build(ctx, v):
        F_, col_, _, _ = v
        out = []
        for df in (ctx.read_csv(str(p)), ctx.read_parquet(str(q)), ctx.read_csv(str(p))):
            out.append(df.aggregate([col_("k")], [F_.sum("v").alias("s")]).sort("k").collect())
        return out, sorted(ctx.tables)

    got = build(port, PORT)
    want = build(ref, REF)
    assert got[1] == want[1] == ["t", "t_2"]  # the same file read twice reuses its entry
    _same(got[0], want[0])
    assert got[0][0].column("k").to_pylist() == [1, 2]
    np.testing.assert_allclose(got[0][0].column("s").to_pylist(), [6.5, 3.5])
    assert port.table("t").explain() == ref.table("t").explain()


def test_append_and_deregister(pair):
    ref, port = TpuContext(), TorchContext(device="cpu")
    t = sales_tables()["sales"]
    for c in (ref, port):
        c.register_table("s", t.slice(0, 100))
    sql = "select count(*) as n, sum(qty) as q from s"
    assert port.sql(sql).collect().equals(ref.sql(sql).collect())
    for c in (ref, port):
        c.append_table("s", t.slice(100, 50))
    got = port.sql(sql).collect()
    assert got.equals(ref.sql(sql).collect()) and got.column("n").to_pylist() == [150]
    with pytest.raises(PlanError, match="schema mismatch"):
        port.append_table("s", sales_tables()["regions"])
    port.deregister_table("s")
    with pytest.raises(PlanError, match="not found"):
        port.sql(sql).collect()


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    """The TPC-H tables as Parquet files, registered by DDL in both
    contexts (plus nation as CSV, with a column list and no header)."""
    import pyarrow.csv as pacsv

    data = gen_all(SCALE, 42)
    d = tmp_path_factory.mktemp("files")
    ref, port = TpuContext(), TorchContext(device="cpu")
    stmts = []
    for name, t in data.items():
        papq.write_table(t, d / f"{name}.parquet", row_group_size=4096)
        stmts.append(f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET LOCATION '{d / name}.parquet'")
    pacsv.write_csv(
        data["nation"].select(["n_nationkey", "n_name"]), d / "nation.csv",
        write_options=pacsv.WriteOptions(include_header=False, delimiter="|"),
    )
    stmts.append(
        "CREATE EXTERNAL TABLE IF NOT EXISTS nation_csv (n_nationkey BIGINT, n_name VARCHAR) "
        f"STORED AS CSV DELIMITER '|' LOCATION '{d}/nation.csv'"
    )
    for stmt in stmts:
        outs = [c.sql(stmt).collect() for c in (ref, port)]
        assert outs[1].equals(outs[0]) and outs[1].to_pydict() == {"result": ["ok"]}
    return data, ref, port


def _statement(tpch_files, stmt: str) -> pa.Table:
    _, ref, port = tpch_files
    want = ref.sql(stmt).collect()
    got = port.sql(stmt).collect()
    assert got.schema.equals(want.schema)
    assert got.to_pylist() == want.to_pylist(), stmt
    return got


@pytest.mark.parametrize(
    "stmt",
    [
        "SHOW TABLES",
        "SHOW COLUMNS FROM lineitem",
        "SHOW COLUMNS FROM nation_csv",
        "SELECT n_nationkey, n_name FROM nation_csv WHERE n_nationkey < 3 ORDER BY n_nationkey",
        "CREATE EXTERNAL TABLE IF NOT EXISTS nation_csv STORED AS PARQUET LOCATION '/nowhere.parquet'",
    ],
)
def test_statement_tables_match_reference(tpch_files, stmt):
    _statement(tpch_files, stmt)


@pytest.mark.parametrize("verb", ["EXPLAIN", "EXPLAIN VERBOSE", "EXPLAIN VERIFY"])
@pytest.mark.parametrize("q", ["q1", "q3", "q6", "q13"])
def test_explain_matches_reference(tpch_files, verb, q):
    data = tpch_files[0]
    got = _statement(tpch_files, f"{verb} {query_sql(q, data)}")
    kinds = got.column("plan_type").to_pylist()
    assert kinds[:2] == ["logical_plan", "optimized_plan"]
    if verb == "EXPLAIN VERBOSE":
        assert kinds[2] == "physical_plan" and "ParquetScanExec" in got.column("plan")[2].as_py()
    if verb == "EXPLAIN VERIFY":
        assert kinds[2] == "verification" and "FAILED" not in got.column("plan")[2].as_py()


def _analyzed(t: pa.Table):
    """[(depth, operator, rows)] of EXPLAIN ANALYZE's plan row."""
    assert t.column("plan_type").to_pylist() == ["physical_plan (analyzed)", "analyze_summary", "aqe"]
    out = []
    for line in t.column("plan")[0].as_py().split("\n"):
        depth = (len(line) - len(line.lstrip(" "))) // 2
        op, _, counters = line.strip().partition("  [")
        rows = re.search(r"\brows=(\d+)", counters)
        out.append((depth, op, int(rows.group(1)) if rows else None))
    assert re.fullmatch(r"total_elapsed=\d+\.\d{6}s, fusion=off \(per-operator attribution\)",
                        t.column("plan")[1].as_py())
    return out


@pytest.mark.parametrize("q", ["q1", "q3", "q6", "q12"])
def test_explain_analyze_tree_and_rows_match_reference(tpch_files, q):
    """The operator tree is the reference's line for line, and so are the
    row counts of every operator, on a first and a second run (the second
    takes the join strategies the first learned: q3's learned flip streams
    orders and never collects it, in both packages)."""
    data, ref, port = tpch_files
    stmt = f"EXPLAIN ANALYZE {query_sql(q, data)}"
    for run in range(2):
        want, got = _analyzed(ref.sql(stmt).collect()), _analyzed(port.sql(stmt).collect())
        assert [(d, op) for d, op, _ in got] == [(d, op) for d, op, _ in want]
        for (_, op, g), (_, _, w) in zip(got, want):
            assert g == w, (run, op, g, w)
    assert got[0][2] == port.sql(query_sql(q, data)).collect().num_rows


def test_drop_table(tpch_files):
    _, ref, port = tpch_files
    for c in (ref, port):
        c.sql("CREATE EXTERNAL TABLE IF NOT EXISTS doomed STORED AS PARQUET LOCATION "
              f"'{c.tables['region'].kw['path']}'")
    assert "doomed" in _statement(tpch_files, "SHOW TABLES").column("table_name").to_pylist()
    assert _statement(tpch_files, "DROP TABLE doomed").to_pydict() == {"result": ["ok"]}
    assert "doomed" not in _statement(tpch_files, "SHOW TABLES").column("table_name").to_pylist()
    assert _statement(tpch_files, "DROP TABLE IF EXISTS doomed").to_pydict() == {"result": ["ok"]}
    for c, err in ((ref, RefPlanError), (port, PlanError)):
        with pytest.raises(err, match="not found"):
            c.sql("DROP TABLE doomed")
        with pytest.raises(err, match="already exists"):
            c.sql(f"CREATE EXTERNAL TABLE region STORED AS PARQUET LOCATION '{c.tables['region'].kw['path']}'")


def test_information_schema_setting_is_accepted():
    """``ballista.with_information_schema`` is read nowhere in the
    reference; both contexts accept it and SHOW works either way."""
    for v in ("true", "false"):
        s = {"ballista.with_information_schema": v}
        ref, port = TpuContext(RefConfig(s)), TorchContext(BallistaConfig(s), device="cpu")
        for c in (ref, port):
            c.register_table("t", pa.table({"x": [1]}))
        assert port.sql("SHOW COLUMNS FROM t").collect().equals(ref.sql("SHOW COLUMNS FROM t").collect())


def test_remote_dataframe_builder(tmp_path):
    """The same builder runs through the port's cluster: frames derived
    from a remote table stay remote; a read_parquet frame runs there too."""
    from ballista_tpu_torch.client.context import BallistaContext, RemoteDataFrame

    rng = np.random.default_rng(3)
    t = pa.table({"g": pa.array(rng.integers(0, 4, 200)), "v": pa.array(rng.uniform(0, 1, 200))})
    path = tmp_path / "t.parquet"
    papq.write_table(t, path, row_group_size=64)
    ctx = BallistaContext.standalone(device="cpu")
    try:
        ctx.register_table("t", t)
        frame = ctx.table("t").filter(col("v") > lit(0.25))
        assert isinstance(frame, RemoteDataFrame)
        sched = ctx._standalone_cluster.scheduler
        jobs = len(sched.jobs)
        out = frame.aggregate([col("g")], [F.count_star().alias("n")]).sort("g").collect()
        assert len(sched.jobs) == jobs + 1
        want = ctx.sql("select g, count(*) as n from t where v > 0.25 group by g order by g").collect()
        pd.testing.assert_frame_equal(out.to_pandas(), want.to_pandas())
        pq = ctx.read_parquet(str(path)).filter(col("v") > lit(0.25)).aggregate([col("g")], [F.count_star().alias("n")])
        assert isinstance(pq, RemoteDataFrame)
        pd.testing.assert_frame_equal(pq.sort("g").collect().to_pandas(), want.to_pandas())
        assert ctx.sql("SHOW TABLES").collect().column("table_name").to_pylist() == ["t", "t_2"]
    finally:
        ctx.close()
