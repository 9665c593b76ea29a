"""TPC-H q1 and q6 end to end: the port (on the CPU) against the
reference, from the same generated data through the same SQL."""

import pathlib

import numpy as np
import pandas as pd
import pytest

from ballista_tpu.exec.context import TpuContext
from ballista_tpu.tpch import gen_table as ref_gen
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.tpch import gen_table as port_gen

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.01


def cmp(res: pd.DataFrame, want: pd.DataFrame, rtol=1e-9):
    """tests/test_tpch_oracle.py's comparison: floats within rtol, every
    other column exactly."""
    assert len(res) == len(want), f"rows: engine {len(res)} oracle {len(want)}"
    assert res.shape[1] == want.shape[1], (res.columns, want.columns)
    for i in range(want.shape[1]):
        a, b = res.iloc[:, i], want.iloc[:, i]
        if pd.api.types.is_float_dtype(b) or pd.api.types.is_float_dtype(a):
            np.testing.assert_allclose(
                a.to_numpy(dtype=float),
                b.to_numpy(dtype=float),
                rtol=rtol,
                err_msg=f"col {i} ({res.columns[i]})",
            )
        else:
            assert list(a) == list(b), f"col {i} ({res.columns[i]})"


@pytest.fixture(scope="module")
def contexts():
    table = port_gen("lineitem", SCALE, 42)
    ref = TpuContext()
    ref.register_table("lineitem", table)
    port = TorchContext(device="cpu")
    port.register_table("lineitem", table)
    return ref, port


@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_generator_matches_reference(table):
    assert port_gen(table, SCALE, 42).equals(ref_gen(table, SCALE, 42))


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_physical_plan_display_matches_reference(contexts, q):
    ref, port = contexts
    sql = (QDIR / f"{q}.sql").read_text()
    want = ref.create_physical_plan(ref.sql_to_logical(sql)).display()
    got = port.create_physical_plan(port.sql_to_logical(sql)).display()
    assert got == want


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_query_matches_reference(contexts, q):
    ref, port = contexts
    sql = (QDIR / f"{q}.sql").read_text()
    want = ref.sql(sql).collect()
    got = port.sql(sql).collect()
    assert got.schema.equals(want.schema)
    cmp(got.to_pandas(), want.to_pandas())
    # a warm run reuses the cached plan and device batches
    again, plan = port.sql(sql).collect_with_plan()
    assert plan is port.create_physical_plan(port.sql_to_logical(sql))
    cmp(again.to_pandas(), want.to_pandas())


@pytest.mark.parametrize(
    "sql",
    [
        # dense grouping over one string key, batches small enough that the
        # partial folds (4 batches per fold) and the final merges
        "select l_linestatus, count(*) as c, sum(l_tax) as t, min(l_quantity) as mn, "
        "max(l_discount) as mx, avg(l_extendedprice) as ap from lineitem "
        "where l_quantity > 10 group by l_linestatus order by l_linestatus desc",
        "select l_returnflag, l_shipmode, sum(l_quantity * l_tax) as s from lineitem "
        "group by l_returnflag, l_shipmode order by l_shipmode, l_returnflag",
        "select count(*) as c, min(l_shipdate) as d, max(l_orderkey) as k, "
        "sum(l_linenumber) as ln, stddev(l_quantity) as sd from lineitem "
        "where l_shipmode = 'AIR' or l_discount > 0.09",
        "select l_returnflag, sum(l_quantity) as q from lineitem where l_tax < 0 "
        "group by l_returnflag",
        "select l_shipinstruct, count(*) as c from lineitem group by l_shipinstruct "
        "order by c desc, l_shipinstruct limit 2",
    ],
)
def test_slice_queries_match_reference(sql):
    table = port_gen("lineitem", 0.002, 7)
    ref = TpuContext()
    ref.register_table("lineitem", table)
    from ballista_tpu_torch.config import BallistaConfig

    port = TorchContext(
        BallistaConfig({"ballista.tpu.batch_rows": "1000"}), device="cpu"
    )
    port.register_table("lineitem", table)
    want = ref.sql(sql).collect()
    got = port.sql(sql).collect()
    assert got.schema.equals(want.schema)
    cmp(got.to_pandas(), want.to_pandas())


def test_unported_plans_raise_with_their_roadmap_item(contexts):
    _, port = contexts
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 4"):
        port.sql("select l_orderkey, count(*) from lineitem group by l_orderkey").collect()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        port.sql(
            "select count(*) from lineitem a join lineitem b on a.l_orderkey = b.l_orderkey"
        ).collect()
