"""Window functions and percentiles: the port (on the CPU) against the
reference, through the SQL cases of ``test_window_functions.py``,
``test_window_aggregates.py`` and ``test_percentile.py``. The same Arrow
tables go to ``TpuContext`` and ``TorchContext(device="cpu")``; results
must agree row for row (keys, counts and order exactly, floats within
rtol 1e-9), cold and warm, and the plans' ``display()`` must be equal.
Queries that the reference rejects must raise the same error class."""

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.errors import BallistaError as RefError
from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.errors import BallistaError, PlanError
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.percentile import _percentiles
from ballista_tpu_torch.exec.window import _region_edges, _seg_running_minmax
from test_torch_tpch import cmp


def _ranking_table() -> pa.Table:
    r = np.random.default_rng(11)
    n = 3000
    return pa.table({
        "g": pa.array(r.integers(0, 20, n).astype(np.int64)),
        "v": pa.array(np.round(r.uniform(0, 100, n), 6)),
        "w": pa.array(r.integers(0, 5, n).astype(np.int64)),
    })


def _frame_table() -> pa.Table:
    r = np.random.default_rng(7)
    n = 2000
    return pa.table({
        "g": pa.array(r.integers(0, 15, n).astype(np.int64)),
        "o": pa.array(r.permutation(n).astype(np.int64)),
        "v": pa.array(np.round(r.uniform(0, 100, n), 6)),
        "q": pa.array(r.integers(1, 10, n).astype(np.int64)),
    })


def _percentile_table() -> pa.Table:
    r = np.random.default_rng(13)
    n = 3000
    return pa.table({
        "g": pa.array(r.integers(0, 12, n).astype(np.int64)),
        "v": pa.array(np.round(r.uniform(0, 100, n), 6)),
        "w": pa.array(r.integers(1, 50, n).astype(np.int64)),
    })


def _string_key_table() -> pa.Table:
    # a NOT NULL string key: the percentile split joins on it directly (a
    # nullable one would need a string-valued CASE, which neither engine
    # has on the device)
    r = np.random.default_rng(17)
    n = 2500
    t = pa.table({
        "k": pa.array(np.array(["A", "N", "R"])[r.integers(0, 3, n)].tolist()),
        "v": pa.array(np.round(r.uniform(900, 100_000, n), 2)),
        "d": pa.array(r.integers(0, 11, n) / 100.0),
    })
    return t.cast(pa.schema([f.with_nullable(False) for f in t.schema]))


NULLS = pa.table({
    "g": pa.array([0, 0, 0, 1, 1], type=pa.int64()),
    "o": pa.array([0, 1, 2, 3, 4], type=pa.int64()),
    "v": pa.array([1.0, None, 3.0, None, None]),
})
SHORT = pa.table({
    "o": pa.array([0, 1, 2], type=pa.int64()),
    "v": pa.array([5.0, 3.0, 9.0]),
})


@pytest.fixture(scope="module")
def contexts():
    tables = {
        "r": _ranking_table(), "t": _frame_table(), "p": _percentile_table(),
        "tn": NULLS, "tm": SHORT, "ps": _string_key_table(),
    }
    ref, port = TpuContext(), TorchContext(device="cpu")
    for name, t in tables.items():
        ref.register_table(name, t)
        port.register_table(name, t)
    return ref, port


CASES = [
    # test_window_functions.py
    "select g, v, row_number() over (partition by g order by v desc) as rn, "
    "rank() over (partition by g order by w) as rk, "
    "dense_rank() over (partition by g order by w) as dr from r",
    "select v, row_number() over (order by v) as rn, "
    "rank() over (partition by g) as rk from r",
    "SELECT g, v from (SELECT g, v, row_number() OVER "
    "(PARTITION BY g ORDER BY v DESC) AS row FROM r) s WHERE row <= 3",
    # test_window_aggregates.py
    "select o, sum(v) over (partition by g order by o) as s from t",
    "select o, sum(v) over (partition by g) as s, avg(v) over (partition by g) as a, "
    "count(*) over (partition by g) as c, min(v) over (partition by g) as mn, "
    "max(v) over (partition by g) as mx from t",
    "select o, avg(v) over (partition by g order by o "
    "rows between 2 preceding and current row) as ma, "
    "sum(q) over (partition by g order by o "
    "rows between 1 preceding and 1 following) as sq from t",
    "select o, min(v) over (partition by g order by o) as mn, "
    "max(v) over (partition by g order by o rows unbounded preceding) as mx from t",
    "select o, lag(v) over (partition by g order by o) as l1, "
    "lead(v, 2) over (partition by g order by o) as l2 from t",
    "select o, sum(v) over (partition by g order by o "
    "rows between 1 following and 2 following) as s from t",
    "select o, sum(v) over (partition by g order by q) as s from t",
    "select o, sum(v) over (partition by g order by o) as s, "
    "count(v) over (partition by g order by o) as c from tn",
    "select o, min(v) over (order by o rows between unbounded "
    "preceding and 1 preceding) as m from tm",
    # test_percentile.py
    "select g, median(v) as m from p group by g order by g",
    "select g, approx_percentile_cont(v, 0.25) as q1, median(v) as med, "
    "stddev(v) as sd, count(*) as c from p group by g order by g",
    "select g, median(v) as mv, median(w) as mw from p group by g order by g",
    "select approx_percentile_cont(v, 0.9) as p90, sum(w) as s from p",
    "select g, median(v) as m from tn group by g order by g",
    # the shape of the card's percentile query over lineitem
    "select k, median(v) as med, approx_percentile_cont(d, 0.9) as p90, "
    "count(*) as c from ps group by k order by k",
]


@pytest.mark.parametrize("sql", CASES)
def test_sql_case_matches_reference(contexts, sql):
    ref, port = contexts
    want_plan = ref.create_physical_plan(ref.sql_to_logical(sql)).display()
    assert port.create_physical_plan(port.sql_to_logical(sql)).display() == want_plan
    want = ref.sql(sql).collect()
    for _ in range(2):  # cold, then warm on the cached plan
        got = port.sql(sql).collect()
        assert got.schema.equals(want.schema)
        cmp(got.to_pandas(), want.to_pandas())


REJECTED = [
    "select g, sum(v), row_number() over (order by g) from r group by g",
    "select min(v) over (partition by g order by o "
    "rows between 2 preceding and current row) as m from t",
    "select sum(v) over (order by o range between 2 preceding and current row) as m from t",
    "select sum(v) over (order by o rows between current row and 1 preceding) as s from t",
    "select sum(v) over (order by o rows between 1 preceding and 3 preceding) as s from t",
    "select sum(v) over (order by o rows between 3 following and 1 following) as s from t",
    "select approx_percentile_cont(v, 1.5) from p",
]


@pytest.mark.parametrize("sql", REJECTED)
def test_rejected_case_raises_as_reference(contexts, sql):
    ref, port = contexts
    with pytest.raises(RefError) as want:
        ref.sql(sql).collect()
    with pytest.raises(BallistaError) as got:
        port.sql(sql).collect()
    assert type(got.value).__name__ == type(want.value).__name__


def test_bad_min_frame_raises_at_plan_time(contexts):
    _, port = contexts
    with pytest.raises(PlanError, match="UNBOUNDED PRECEDING"):
        port.create_physical_plan(port.sql_to_logical(REJECTED[1]))


def test_region_edges_and_running_min():
    import torch

    changed = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0], dtype=torch.bool)
    start, end = _region_edges(changed, 8)
    assert start.tolist() == [0, 0, 0, 3, 4, 4, 6, 6]
    assert end.tolist() == [2, 2, 2, 3, 5, 5, 7, 7]
    v = torch.tensor([5.0, 3.0, 4.0, 9.0, 8.0, float("nan"), 2.0, 1.0])
    run = _seg_running_minmax(v, start, is_min=True)
    got = run.tolist()
    assert got[:5] == [5.0, 3.0, 3.0, 9.0, 8.0]
    assert np.isnan(got[5])  # a NaN propagates through the running min
    assert got[6:] == [2.0, 1.0]


def test_percentile_interpolates_between_order_statistics():
    import torch

    # two groups, sorted by (key, value), a NULL value last in group 0
    key = torch.tensor([0, 0, 0, 0, 1, 1, 0, 0])
    val = torch.tensor([1.0, 2.0, 4.0, 0.0, 10.0, 20.0, 0.0, 0.0])
    vnull = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.bool)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
    outs, nulls, starts = _percentiles([(key, None)], val, vnull, valid, [0.5, 0.25])
    assert starts.tolist() == [True, False, False, False, True, False, False, False]
    assert outs[0][0].item() == 2.0 and outs[0][4].item() == 15.0
    assert outs[1][0].item() == 1.5 and outs[1][4].item() == 12.5
    assert not nulls[0][0].item() and not nulls[0][4].item()


def test_segmented_prefix_sums_restart_at_each_partition():
    import torch

    from ballista_tpu_torch.exec.window import _seg_scan

    rng = np.random.default_rng(5)
    n = 5000
    changed = torch.from_numpy(rng.random(n) < 0.01)
    changed[0] = True
    ps, _ = _region_edges(changed, n)
    ints = rng.integers(-1000, 1000, n)
    got = _seg_scan(torch.from_numpy(ints), ps, torch.add).numpy()
    starts = np.flatnonzero(changed.numpy())
    want = np.concatenate([np.cumsum(seg) for seg in np.split(ints, starts[1:])])
    assert np.array_equal(got, want)
    # f64: each prefix only carries its own partition's rounding
    vals = rng.uniform(900, 500_000, n)
    got = _seg_scan(torch.from_numpy(vals), ps, torch.add).numpy()
    want = np.concatenate([np.cumsum(seg) for seg in np.split(vals, starts[1:])])
    np.testing.assert_allclose(got, want, rtol=1e-14)


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [CASES[0], CASES[5], CASES[6], CASES[16], CASES[17]])
def test_card_matches_cpu_bit_for_bit(contexts, sql):
    # the window and percentile programs add and compare in one fixed order
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, cpu = contexts
    card = TorchContext(device="cuda")
    for name, r in cpu.tables.items():
        card.register_table(name, r.kw["table"])
    want = cpu.sql(sql).collect()
    assert card.sql(sql).collect().equals(want)
