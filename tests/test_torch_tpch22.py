"""All 22 TPC-H queries: the port (on the CPU) against the reference at
SF=0.002, from the same generated tables through the same SQL. Spec
constants that select nothing at this scale are replaced by values chosen
from the data, as ``tests/test_tpch_oracle.py`` chooses them
(``tpch.spec_substitutions``). Each query's result must equal the
reference's (keys, counts and order exactly, floats within rtol 1e-9),
cold and warm, and its physical plan's ``display()`` must be the
reference's."""

import pathlib

import pytest

from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.tpch import gen_all, spec_substitutions
from test_torch_tpch import cmp

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
SCALE = 0.002
QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def env():
    data = gen_all(SCALE, 42)
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in data.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return data, ref, port


def query_sql(q: str, data) -> str:
    sql = (QDIR / f"{q}.sql").read_text()
    for old, new in spec_substitutions(q, data).items():
        assert old in sql, f"substitution target {old!r} not in {q}"
        sql = sql.replace(old, new)
    return sql


@pytest.mark.parametrize("q", QUERIES)
def test_plan_display_matches_reference(env, q):
    data, ref, port = env
    sql = query_sql(q, data)
    want = ref.create_physical_plan(ref.sql_to_logical(sql)).display()
    assert port.create_physical_plan(port.sql_to_logical(sql)).display() == want


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(env, q):
    data, ref, port = env
    sql = query_sql(q, data)
    want = ref.sql(sql).collect()
    for _ in range(2):  # cold, then warm on the learned plan cache
        got = port.sql(sql).collect()
        assert got.schema.equals(want.schema)
        cmp(got.to_pandas(), want.to_pandas())


def test_substitutions_select_rows(env):
    """The substituted queries that filter on a chosen constant are not
    trivially empty at this scale (q22 may be: every customer can have
    orders here, and then both engines agree on the empty result)."""
    data, _, port = env
    for q in ("q7", "q8", "q11", "q17", "q18", "q19", "q20", "q21"):
        got = port.sql(query_sql(q, data)).collect()
        assert got.num_rows > 0 and got.column(got.num_columns - 1).null_count < got.num_rows, q
