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
    # CASE: NULL conditions are no match; no ELSE (or ELSE NULL) is NULL
    "case when a > 0 then b else c end",
    "case when p then 1 when q then 2 else 3 end",
    "case when a > 10 then i when a < -10 then -i end",
    "case when p then b else null end",
    "case when s = 'alpha' then a * 2 when s = 'nope' then 0 else a end",
    "case a when 1 then 10 when 2 then 20 else -1 end",
    # IN / NOT IN: literals missing from the dictionary drop out; the
    # input's nulls stay
    "a in (1, 2, -3)", "a not in (0, 5)", "i in (7)", "b in (0.5, 1.5)",
    "s in ('alpha', 'zulu')", "s not in ('bravo', 'nope')", "s in ('nope', 'none')",
    "d in (date '1995-01-01', date '1996-02-29')",
    # LIKE / NOT LIKE against the dictionary
    "s like 'a%'", "s like '%a'", "s not like '%r%'", "s like '_ravo'",
    "s like 'nope%'", "num like '-%'", "s2 like '%'",
    # dates: days before 1970 and leap days
    "extract(year from e)", "extract(month from e)", "extract(day from e)",
    "extract(year from d)", "extract(month from cast(e as timestamp))",
    "extract(day from cast(e as timestamp))",
    "coalesce(a, 0)", "coalesce(b, c)", "coalesce(a, i, 7)", "coalesce(c, b)",
    "substr(s, 1, 2)", "substring(s from 2)", "substr(num, 1, 1)", "substr(s, 3, 1) = 'a'",
    "abs(a)", "abs(b)", "floor(b)", "ceil(b)", "floor(a)", "ceil(i)",
    "sqrt(c)", "sqrt(a)", "round(b)", "round(b, 2)", "round(c * 10, -1)", "round(a)",
]

# days since the epoch at and around leap days, before 1970 and far out
LEAP_DAYS = [-719468, -141459, -25508, -306, -1, 0, 59, 789, 11016, 11017, 47541, 2932896]


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
        "e": pa.array(
            np.concatenate([LEAP_DAYS, rng.integers(-800_000, 800_000, max(n - len(LEAP_DAYS), 0))])
            .astype(np.int32)[:n],
            mask=mask(0.1),
        ).cast(pa.date32()),
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


@pytest.mark.parametrize("sql_expr", ["my_udf(a)", "sum(my_udaf(a))"])
def test_unported_kinds_name_their_roadmap_item(sql_expr):
    from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow
    from ballista_tpu_torch.errors import PlanError

    schema = schema_from_arrow(make_table(10, 0).schema)
    # UDF plugins do not resolve: the name fails in the planner
    with pytest.raises(PlanError, match="ROADMAP queue 1, item 10"):
        planned(sql_expr, port_parse, PortPlanner, PortCatalog, port_optimize, schema)


def test_civil_from_days_matches_the_calendar():
    import datetime

    import torch

    from ballista_tpu_torch.expr.physical import civil_from_days

    days = list(range(-800_000, 800_000, 997)) + LEAP_DAYS
    y, m, d = civil_from_days(torch.tensor(days, dtype=torch.int32))
    epoch = datetime.date(1970, 1, 1)
    for z, yy, mm, dd in zip(days, y.tolist(), m.tolist(), d.tolist()):
        if -719162 <= z <= 2932896:  # datetime's years 1..9999
            want = epoch + datetime.timedelta(days=z)
            assert (yy, mm, dd) == (want.year, want.month, want.day), z
    assert (y.dtype, m.dtype, d.dtype) == (torch.int32,) * 3


def test_like_table_is_built_once_per_dictionary():
    from ballista_tpu_torch.columnar import dict_util
    from ballista_tpu_torch.columnar.arrow_interop import table_from_arrow

    t = make_table(100, 3)
    batch = table_from_arrow(t, 128, device="cpu")[0]
    expr = planned("s like 'a%'", port_parse, PortPlanner, PortCatalog, port_optimize, batch.schema)
    ev = port_compile(expr, batch.schema)
    first = ev.evaluate(batch).values
    key = (("like", "a%", False, "cpu"), id(batch.dictionaries["s"]))
    table = dict_util._MEMO[key]
    assert ev.evaluate(batch).values.equal(first)
    assert dict_util._MEMO[key] is table  # the warm evaluation reused it
