"""All 22 TPC-H queries over file tables registered by DDL: the port (on
the CPU) against the reference reading the same files. The tables of
``tests/test_torch_tpch22.py`` (SF=0.002, spec constants that select
nothing replaced from the data) are written as Parquet files with small
row groups, so that scans prune and partitions split; every query's
result equals the reference's (keys, counts and order exactly, floats
within rtol 1e-9), cold and warm, and its physical plan's ``display()``
is the reference's. q1, q5 and q12 also run over CSV (``WITH HEADER ROW``)
and Avro tables."""

import pytest

from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.avro import write_avro
from ballista_tpu_torch.exec.base import plan_counters
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.tpch import gen_all
from test_torch_tpch import cmp
from test_torch_tpch22 import QUERIES, SCALE, query_sql

FORMATS = {
    "parquet": "STORED AS PARQUET",
    "csv": "STORED AS CSV WITH HEADER ROW",
    "avro": "STORED AS AVRO",
}


@pytest.fixture(scope="module")
def data():
    return gen_all(SCALE, 42)


@pytest.fixture(scope="module")
def files(data, tmp_path_factory):
    """{format: (reference context, port context)}, each over the same
    files, registered by CREATE EXTERNAL TABLE."""
    import pyarrow.csv as pacsv
    import pyarrow.parquet as papq

    d = tmp_path_factory.mktemp("tpch-files")
    out = {}
    for fmt, stored in FORMATS.items():
        ref, port = TpuContext(), TorchContext(device="cpu")
        for name, t in data.items():
            path = d / f"{name}.{fmt}"
            if fmt == "parquet":
                papq.write_table(t, path, row_group_size=2048)
            elif fmt == "csv":
                pacsv.write_csv(t, path)
            else:
                write_avro(str(path), t)
            for c in (ref, port):
                c.sql(f"CREATE EXTERNAL TABLE {name} {stored} LOCATION '{path}'")
        out[fmt] = (ref, port)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_parquet_query_matches_reference(files, data, q):
    ref, port = files["parquet"]
    sql = query_sql(q, data)
    want_plan = ref.create_physical_plan(ref.sql_to_logical(sql)).display()
    assert port.create_physical_plan(port.sql_to_logical(sql)).display() == want_plan
    want = ref.sql(sql).collect()
    for _ in range(2):  # cold, then warm on the scan cache and plan cache
        got = port.sql(sql).collect()
        assert got.schema.equals(want.schema)
        cmp(got.to_pandas(), want.to_pandas())


def test_sorted_lineitem_prunes_and_stays_warm(files, data, tmp_path):
    """A copy of lineitem sorted by l_shipdate: q6 prunes row groups (and
    none with pruning off), q1 and q6 equal the unsorted file's results,
    and a warm run reads nothing from the file (the scan cache serves
    it)."""
    import pyarrow.parquet as papq

    from ballista_tpu_torch.config import BallistaConfig

    path = tmp_path / "lineitem.parquet"
    papq.write_table(data["lineitem"].sort_by("l_shipdate"), path, row_group_size=2048)
    _, unsorted = files["parquet"]
    for pruning in ("true", "false"):
        port = TorchContext(BallistaConfig({"ballista.parquet.pruning": pruning}), device="cpu")
        port.sql(f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION '{path}'")
        for q in ("q6", "q1"):
            sql = query_sql(q, data)
            got, phys = port.sql(sql).collect_with_plan()
            cmp(got.to_pandas(), unsorted.sql(sql).collect().to_pandas())
            pruned = plan_counters(phys, ["row_groups_pruned"])["row_groups_pruned"]
            assert (pruned >= 1) == (q == "q6" and pruning == "true"), (q, pruning, pruned)
        _, phys = port.sql(query_sql("q1", data)).collect_with_plan()
        scan = phys
        while type(scan).__name__ != "ParquetScanExec":
            scan = scan.children()[0]
        assert "read_time" not in scan.metrics.timers


@pytest.mark.parametrize("fmt", ["csv", "avro"])
@pytest.mark.parametrize("q", ["q1", "q5", "q12"])
def test_text_and_avro_queries_match_reference(files, data, fmt, q):
    ref, port = files[fmt]
    sql = query_sql(q, data)
    assert port.create_physical_plan(port.sql_to_logical(sql)).display() == ref.create_physical_plan(
        ref.sql_to_logical(sql)
    ).display()
    want = ref.sql(sql).collect()
    for _ in range(2):
        got = port.sql(sql).collect()
        assert got.schema.equals(want.schema)
        cmp(got.to_pandas(), want.to_pandas())
