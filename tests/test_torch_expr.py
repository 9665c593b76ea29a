"""compile_expr in the port against the reference's, on random batches
with nulls: values, null masks and dtypes must agree bit for bit."""

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.columnar import arrow_interop as ref_io
from ballista_tpu.expr.physical import compile_expr as ref_compile
from ballista_tpu.plan.optimizer import optimize as ref_optimize
from ballista_tpu.sql.parser import parse_sql as ref_parse
from ballista_tpu.sql.planner import DictCatalog as RefCatalog
from ballista_tpu.sql.planner import SqlPlanner as RefPlanner
from ballista_tpu_torch.columnar.bridge import batch_from_numpy
from ballista_tpu_torch.expr.physical import compile_expr as port_compile
from ballista_tpu_torch.plan.optimizer import optimize as port_optimize
from ballista_tpu_torch.sql.parser import parse_sql as port_parse
from ballista_tpu_torch.sql.planner import DictCatalog as PortCatalog
from ballista_tpu_torch.sql.planner import SqlPlanner as PortPlanner

EXPRS = [
    "a + b", "a - i", "i * 3", "b * (1 - c) * (1 + c)", "a / 7", "i / a",
    "a % 5", "i % a", "b / c", "a / 0", "-a", "-b",
    "a < b", "i >= 100", "b = c", "a <> 3", "b <= 0.5", "i > a",
    "a between -10 and 10", "b not between 0.1 and 0.9",
    "d <= date '1998-12-01' - interval '90' day",
    "d >= date '1994-01-01' and d < date '1994-01-01' + interval '1' year",
    "p and q", "p or q", "not p", "p and a > 0", "q or b < 0",
    "p is null", "b is not null", "s is null",
    "cast(b as int)", "cast(a as double)", "cast(i as int)", "cast(d as timestamp)",
    "cast(num as int)", "cast(num as double)",
    "s = 'bravo'", "s <> 'bravo'", "s < 'charlie'", "s <= 'charlie'",
    "s > 'bravo'", "s >= 'delta'", "s = 'nope'", "'charlie' > s",
    "s = s2", "s < s2",
]


def make_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array(["delta", "alpha", "charlie", "bravo", "zulu"])
    mask = lambda p: rng.random(n) < p  # noqa: E731
    return pa.table({
        "a": pa.array(rng.integers(-50, 50, n).astype(np.int32), mask=mask(0.1)),
        "i": pa.array(rng.integers(-(2**40), 2**40, n), mask=mask(0.1)),
        "b": pa.array(rng.normal(0, 10, n), mask=mask(0.2)),
        "c": pa.array(np.round(rng.random(n), 2)),
        "d": pa.array(rng.integers(8000, 10600, n).astype(np.int32)).cast(pa.date32()),
        "p": pa.array(rng.random(n) < 0.5, mask=mask(0.3)),
        "q": pa.array(rng.random(n) < 0.5, mask=mask(0.3)),
        "s": pa.array(words[rng.integers(0, 5, n)].tolist(), mask=mask(0.2)),
        "s2": pa.array(words[rng.integers(1, 5, n)].tolist()),
        "num": pa.array([str(x) for x in rng.integers(-9, 99, n)]),
    })


def planned(sql_expr, parse, planner, catalog, optimize, schema):
    """The optimized expression (date arithmetic folded), to be compiled
    against the full table schema (the optimizer prunes the scan's)."""
    plan = optimize(planner(catalog({"t": schema})).plan(parse(f"select {sql_expr} from t")))
    return plan.exprs[0]


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sql_expr", EXPRS)
def test_compile_expr_matches_reference(sql_expr, seed):
    t = make_table(3000, seed)
    ref_batch = ref_io.table_from_arrow(t, 4096)[0]
    # a filtered batch: evaluation must not depend on validity
    ref_batch = ref_batch.with_valid(ref_batch.valid & (np.arange(4096) % 7 != 0))
    port_batch = batch_from_numpy(
        fields=[(f.name, f.dtype.value, f.nullable) for f in ref_batch.schema],
        columns=[np.asarray(c) for c in ref_batch.columns],
        valid=np.asarray(ref_batch.valid),
        nulls=[None if m is None else np.asarray(m) for m in ref_batch.nulls],
        dictionaries={k: d.values for k, d in ref_batch.dictionaries.items()},
        device="cpu",
    )
    r_expr = planned(
        sql_expr, ref_parse, RefPlanner, RefCatalog, ref_optimize, ref_batch.schema
    )
    p_expr = planned(
        sql_expr, port_parse, PortPlanner, PortCatalog, port_optimize, port_batch.schema
    )
    assert p_expr.name() == r_expr.name()
    rv = ref_compile(r_expr, ref_batch.schema).evaluate(ref_batch)
    pv = port_compile(p_expr, port_batch.schema).evaluate(port_batch)
    assert pv.dtype.value == rv.dtype.value
    want = np.asarray(rv.values)
    got = pv.values.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(bits(got), bits(want))
    assert (pv.nulls is None) == (rv.nulls is None)
    if rv.nulls is not None:
        assert np.array_equal(pv.nulls.numpy(), np.asarray(rv.nulls))


@pytest.mark.parametrize(
    "sql_expr", ["case when a > 0 then 1 else 0 end", "a in (1, 2)", "s like 'a%'", "abs(a)"]
)
def test_unported_kinds_name_their_roadmap_item(sql_expr):
    from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow

    schema = schema_from_arrow(make_table(10, 0).schema)
    expr = planned(sql_expr, port_parse, PortPlanner, PortCatalog, port_optimize, schema)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 2"):
        port_compile(expr, schema)
