"""The aggregate's clustered-input speculation, disjoint-clustered states
and learned state slicing (``ballista_tpu_torch/exec/aggregate.py``,
``ops/aggregate.group_aggregate(presorted=...)``) against the reference's
on the same seeded input: every case of ``tests/test_sorted_agg.py`` and
``tests/test_clustered_agg_stream.py`` through both packages.

Keys, counts, integer sums, ``sorted_ok``, ``input_was_sorted``, the
learned plan-cache entries (``agg_sorted``, ``agg_state_cap``,
``agg_state_prefix``) and the counters (``input_batches``,
``boundary_trims``, ``disjoint_break``, ``final_disjoint_skip``,
``final_disjoint_miss``) must equal the reference's; float sums agree
within rtol 1e-9. Port only: keys past 2^53 (the port fetches key bounds as
int64), the presorted arm giving the sort path's bits (its prefixes read
the live rows moved to the front, the sequence the sort path reads): warm
presorted runs of a float SUM that is not a decimal bit for bit among
themselves and with the cold (sort-path) run, and a kept build table's
subtree learning nothing. The card's cases are in
``tests/test_torch_adaptive_card.py``.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec.base import plan_counters as ref_plan_counters
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.ops.aggregate import AggOp as RefOp
from ballista_tpu.ops.aggregate import group_aggregate as ref_group_aggregate
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.exec.base import plan_counters
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.ops.aggregate import AggOp, group_aggregate

COUNTERS = (
    "input_batches", "boundary_trims", "disjoint_break", "final_disjoint_skip",
    "final_disjoint_miss",
)
FAMILIES = ("agg_sorted", "agg_state_cap", "agg_state_prefix")


# -- the segment kernel, presorted and not (tests/test_sorted_agg.py) ---------


def _both(keys, knulls, valid, vals, vnulls, ops, cap, presorted, device="cpu"):
    """(port result, reference result) of one grouped aggregate."""
    import jax.numpy as jnp

    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got = group_aggregate(
        [t(k) for k in keys], [t(k) for k in knulls], t(valid), [t(v) for v in vals],
        [t(v) for v in vnulls], [AggOp(o) for o in ops], cap, presorted=presorted,
    )
    want = ref_group_aggregate(
        [j(k) for k in keys], [j(k) for k in knulls], j(valid), [j(v) for v in vals],
        [j(v) for v in vnulls], [RefOp(o) for o in ops], cap, presorted=presorted,
    )
    return got, want


def _np(x):
    return None if x is None else (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _same_result(got, want) -> None:
    """Every output array at every slot: keys, counts and integers
    exactly, floats within rtol 1e-9; the flags equal."""
    assert int(got.n_groups) == int(want.n_groups)
    assert bool(got.overflow) == bool(want.overflow)
    for a, b in (("input_was_sorted", "input_was_sorted"), ("sorted_ok", "sorted_ok")):
        ga, wb = getattr(got, a), getattr(want, b)
        assert (ga is None) == (wb is None)
        if ga is not None:
            assert bool(ga) == bool(wb)
    if bool(want.overflow):
        return
    ok = _np(want.valid)
    assert np.array_equal(_np(got.valid), ok)
    for g, w in zip(got.keys + got.key_nulls, want.keys + want.key_nulls):
        assert (g is None) == (w is None)
        if g is not None:
            g, w = _np(g)[ok], _np(w)[ok]
            assert np.array_equal(g, w, equal_nan=w.dtype.kind == "f")
    for g, w in zip(got.values, want.values):
        g, w = _np(g)[ok], _np(w)[ok]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-9)
        else:
            assert np.array_equal(g, w)
    for g, w in zip(got.value_nulls, want.value_nulls):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(_np(g)[ok], _np(w)[ok])


def _clustered_input():
    rng = np.random.default_rng(7)
    n = 4096
    keys = np.sort(rng.integers(0, 300, n)).astype(np.int64)
    vals = rng.random(n) * 100
    ivals = rng.integers(-50, 50, n).astype(np.int64)
    valid = rng.random(n) < 0.6  # dead rows between the live ones
    return keys, vals, ivals, valid


@pytest.mark.parametrize("presorted", [False, True])
def test_clustered_sum_count_min_max(presorted):
    keys, vals, ivals, valid = _clustered_input()
    got, want = _both(
        [keys], [None], valid, [vals, ivals, vals, ivals], [None] * 4,
        ["sum", "sum", "min", "max"], 1024, presorted,
    )
    _same_result(got, want)
    assert bool(got.sorted_ok if presorted else got.input_was_sorted)
    # and against pandas, as the reference's case holds it
    ok = _np(got.valid)
    df = pd.DataFrame({"k": keys, "v": vals, "i": ivals})[valid].groupby("k")
    np.testing.assert_array_equal(_np(got.keys[0])[ok], df.v.sum().index.values)
    np.testing.assert_allclose(_np(got.values[0])[ok], df.v.sum().values, rtol=1e-9)
    assert _np(got.values[1])[ok].tolist() == df.i.sum().tolist()
    assert _np(got.values[2])[ok].tolist() == df.v.min().tolist()
    assert _np(got.values[3])[ok].tolist() == df.i.max().tolist()


def test_presorted_arm_gives_the_sort_paths_bits():
    """Port only: on clustered input with dead rows between the live ones,
    the presorted arm's f64 sums (and everything else) equal the sort
    path's bit for bit."""
    keys, vals, ivals, valid = _clustered_input()
    vals = vals * np.pi  # not a decimal
    got = [
        group_aggregate(
            [torch.from_numpy(keys)], [None], torch.from_numpy(valid),
            [torch.from_numpy(vals), torch.from_numpy(ivals)], [None, None],
            [AggOp.SUM, AggOp.COUNT], 1024, presorted=p,
        )
        for p in (False, True)
    ]
    for a, b in zip(got[0].keys + got[0].values + [got[0].valid], got[1].keys + got[1].values + [got[1].valid]):
        assert np.array_equal(a.numpy().view(np.uint8), b.numpy().view(np.uint8))


def test_presorted_flags_unsorted_input():
    keys = np.array([5, 1, 5, 1, 2, 2], dtype=np.int64)
    for presorted in (True, False):
        got, want = _both([keys], [None], np.ones(6, bool), [np.ones(6)], [None], ["sum"], 8, presorted)
        _same_result(got, want)
        assert not bool(got.sorted_ok if presorted else got.input_was_sorted)


def test_clustered_null_keys_and_values():
    keys = np.array([1, 1, 2, 2, 3, 3], dtype=np.int64)
    knull = np.array([False, False, False, False, True, True])
    vals = np.array([1.0, 2.0, 9.0, 9.0, 5.0, 6.0])
    vnull = np.array([False, False, True, True, False, False])
    for presorted in (False, True):
        got, want = _both([keys], [knull], np.ones(6, bool), [vals], [vnull], ["sum"], 8, presorted)
        _same_result(got, want)
        assert int(got.n_groups) == 3


def test_presorted_overflow_reports_group_count():
    keys = np.arange(64, dtype=np.int64)
    got, want = _both([keys], [None], np.ones(64, bool), [np.ones(64)], [None], ["sum"], 16, True)
    _same_result(got, want)
    assert bool(got.overflow) and int(got.n_groups) == 64


def test_presorted_two_keys_with_nulls_and_nan():
    """Port only, beyond the reference's cases: two keys, a nullable one,
    NaN keys and dead rows, in sort order (NaN last, NULL last): the
    presorted arm finds the sort path's groups, and one row out of order
    clears ``sorted_ok``."""
    rng = np.random.default_rng(5)
    a = np.repeat(np.arange(40, dtype=np.int64), 25)
    b = np.tile(np.repeat(np.array([0.0, 0.5, 1.5, np.nan, 0.0]), 5), 40)
    bn = np.tile(np.repeat(np.array([False, False, False, False, True]), 5), 40)
    valid = rng.random(a.size) < 0.7
    vals = rng.random(a.size)
    sort, _ = _both([a, b], [None, bn], valid, [vals], [None], ["sum"], 512, False)
    pre, want = _both([a, b], [None, bn], valid, [vals], [None], ["sum"], 512, True)
    _same_result(pre, want)
    assert bool(sort.input_was_sorted) and bool(pre.sorted_ok)
    assert int(pre.n_groups) == int(sort.n_groups)
    ok = _np(pre.valid)
    for x, y in zip(pre.keys + pre.key_nulls[1:], sort.keys + sort.key_nulls[1:]):
        assert np.array_equal(_np(x)[ok], _np(y)[ok], equal_nan=True)
    a2 = a.copy()
    live = np.flatnonzero(valid)
    a2[live[10]], a2[live[500]] = a2[live[500]], a2[live[10]]
    bad, want = _both([a2, b], [None, bn], valid, [vals], [None], ["sum"], 512, True)
    assert not bool(bad.sorted_ok) and not bool(want.sorted_ok)


# -- the operator: learning, speculation, state slicing ------------------------


def _contexts(tables: dict, **settings):
    cfg = {f"ballista.{k}": v for k, v in settings.items()}
    ctx = TorchContext(BallistaConfig(cfg), device="cpu")
    ref = TpuContext(RefConfig(cfg))
    for name, t in tables.items():
        ctx.register_table(name, t)
        ref.register_table(name, t)
    return ctx, ref


def _entries(cache: dict) -> dict:
    return {k: v for k, v in cache.items() if isinstance(k, tuple) and k[0] in FAMILIES}


def _run_both(ctx, ref, sql: str):
    got, plan = ctx.sql(sql).collect_with_plan()
    want, rplan = ref.sql(sql).collect_with_plan()
    assert plan_counters(plan, COUNTERS) == ref_plan_counters(rplan, COUNTERS)
    return got.to_pandas(), want.to_pandas()


def _same_frame(got, want, key: str) -> None:
    got = got.sort_values(key).reset_index(drop=True)
    want = want.sort_values(key).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-9)
        else:
            assert np.array_equal(g, w), c


def test_engine_learns_clustered_path():
    rng = np.random.default_rng(3)
    n = 5000
    k = np.sort(rng.integers(0, 800, n))
    v = rng.random(n) * 10
    t = pa.table({"k": pa.array(k, pa.int64()), "v": pa.array(v)})
    ctx, ref = _contexts({"t": t})
    sql = "select k, sum(v) as s, count(*) as c from t group by k"
    for run in range(2):
        got, want = _run_both(ctx, ref, sql)
        _same_frame(got, want, "k")
        assert _entries(ctx._plan_cache) == _entries(ref._plan_cache), run
    learned = [key for key in ctx._plan_cache if key[0] == "agg_sorted"]
    assert any(ctx._plan_cache[key] is True for key in learned)


def test_state_slice_respects_masked_repartition():
    rng = np.random.default_rng(11)
    n = 20_000
    k = rng.integers(0, 5000, n)
    v = rng.random(n)
    t = pa.table({"k": pa.array(k, pa.int64()), "v": pa.array(v)})
    ctx, ref = _contexts({"t": t}, **{"shuffle.partitions": "4"})
    sql = "select k, sum(v) as s, count(*) as c from t group by k"
    oracle = pd.DataFrame({"k": k, "v": v}).groupby("k").agg(s=("v", "sum"), c=("v", "count"))
    for run in (1, 2):
        got, want = _run_both(ctx, ref, sql)
        _same_frame(got, want, "k")
        assert len(got) == len(oracle), f"run {run} dropped groups"
        assert _entries(ctx._plan_cache) == _entries(ref._plan_cache), run


def test_engine_speculation_miss_recovers():
    rng = np.random.default_rng(4)
    n = 3000
    k = rng.integers(0, 500, n)
    v = rng.random(n)
    t = pa.table({"k": pa.array(k, pa.int64()), "v": pa.array(v)})
    ctx, ref = _contexts({"t": t})
    sql = "select k, sum(v) as s from t group by k"
    _run_both(ctx, ref, sql)
    assert _entries(ctx._plan_cache) == _entries(ref._plan_cache)
    poisoned = 0
    for c in (ctx._plan_cache, ref._plan_cache):
        for key in list(c):
            if key[0] == "agg_sorted":
                c[key] = True
                poisoned += 1
    assert poisoned
    df = ctx.sql(sql)
    got = df.collect().to_pandas()
    want = ref.sql(sql).collect().to_pandas()
    assert df.stats == {"speculation_misses": 1}
    _same_frame(got, want, "k")
    oracle = pd.DataFrame({"k": k, "v": v}).groupby("k").v.sum()
    np.testing.assert_allclose(got.sort_values("k")["s"], oracle.values, rtol=1e-9)
    assert _entries(ctx._plan_cache) == _entries(ref._plan_cache)
    assert not any(ctx._plan_cache[key] is True for key in ctx._plan_cache if key[0] == "agg_sorted")


# -- the disjoint-clustered stream (tests/test_clustered_agg_stream.py) -------

STREAM_SQL = (
    "SELECT k, SUM(v) AS s, COUNT(v) AS c, MIN(v) AS mn, "
    "MAX(v) AS mx, AVG(v) AS a FROM t GROUP BY k ORDER BY k"
)


def _stream_contexts(table, batch_rows: int):
    return _contexts({"t": table}, **{"shuffle.partitions": "1", "tpu.batch_rows": str(batch_rows)})


def test_clustered_groupby_streams_disjoint_states():
    rng = np.random.default_rng(7)
    reps = rng.integers(1, 14, 1400)
    keys = np.repeat(np.arange(1400, dtype=np.int64) * 3, reps)
    t = pa.table({"k": pa.array(keys), "v": pa.array(rng.uniform(-5, 5, len(keys)))})
    ctx, ref = _stream_contexts(t, 512)
    got_plan = ctx.sql(STREAM_SQL).collect_with_plan()
    got, want = _run_both(ctx, ref, STREAM_SQL)
    _same_frame(got, want, "k")
    counters = plan_counters(got_plan[1], COUNTERS)
    assert counters["boundary_trims"] > 0 and counters["disjoint_break"] == 0, counters
    assert counters["final_disjoint_skip"] == 1 and counters["input_batches"] > 1, counters


def test_unclustered_groupby_falls_back_and_matches():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 900, 9000).astype(np.int64)
    t = pa.table({"k": pa.array(keys), "v": pa.array(rng.uniform(-5, 5, len(keys)))})
    ctx, ref = _stream_contexts(t, 512)
    for _ in range(2):
        got, want = _run_both(ctx, ref, STREAM_SQL)
        _same_frame(got, want, "k")
        assert _entries(ctx._plan_cache) == _entries(ref._plan_cache)


def test_clustered_groupby_with_having_semi_join():
    rng = np.random.default_rng(9)
    reps = rng.integers(1, 9, 800)
    keys = np.repeat(np.arange(800, dtype=np.int64), reps)
    qty = rng.integers(1, 50, len(keys)).astype(np.int64)
    t = pa.table({"k": pa.array(keys), "q": pa.array(qty)})
    ctx, ref = _contexts({"li": t}, **{"shuffle.partitions": "1", "tpu.batch_rows": "512"})
    sql = ("SELECT k, SUM(q) AS tq FROM li WHERE k IN "
           "(SELECT k FROM li GROUP BY k HAVING SUM(q) > 200) "
           "GROUP BY k ORDER BY k")
    for _ in range(2):
        got, want = _run_both(ctx, ref, sql)
        _same_frame(got, want, "k")
    sums = t.to_pandas().groupby("k").q.sum()
    keep = sums[sums > 200]
    np.testing.assert_array_equal(got.k.values, keep.index.values)
    np.testing.assert_array_equal(got.tq.values, keep.values)


def test_null_key_group_not_conflated_with_zero():
    t = pa.table({
        "k": pa.array([0, 0, 0, 0, None, None, None, None], type=pa.int64()),
        "v": pa.array([1.0] * 8),
    })
    ctx, ref = _stream_contexts(t, 4)
    sql = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k"
    got, want = _run_both(ctx, ref, sql)
    assert len(got) == len(want) == 2
    by_null = {bool(row.isna().k): row for _, row in got.iterrows()}
    assert by_null[False].s == 4.0 and by_null[False].c == 4
    assert by_null[True].s == 4.0 and by_null[True].c == 4


# -- port only ------------------------------------------------------------------


def test_keys_past_2_53_are_decided_exactly():
    """Clustered int64 keys near 2^62, one apart: as f64 they would round
    to one value, and a range check or a boundary trim on the rounded
    bounds would merge the wrong groups. The port fetches the bounds as
    int64: every group holds its own rows (against numpy), with
    boundary trims and no break. The reference makes the same decisions
    (counters and sums equal); its keys come back rounded through f64, the
    host-copy fault ROADMAP queue 3 logs."""
    rng = np.random.default_rng(21)
    base = (1 << 62) + 12345
    reps = rng.integers(1, 9, 600)
    keys = base + np.repeat(np.arange(600, dtype=np.int64), reps)
    v = rng.integers(1, 100, keys.size).astype(np.int64)
    t = pa.table({"k": pa.array(keys), "v": pa.array(v)})
    ctx, ref = _contexts({"t": t}, **{"shuffle.partitions": "2", "tpu.batch_rows": "256"})
    sql = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"
    uk, inv = np.unique(keys, return_inverse=True)
    for _ in range(2):
        got, plan = ctx.sql(sql).collect_with_plan()
        assert got.column("k").to_pylist() == uk.tolist()
        assert got.column("s").to_pylist() == np.bincount(inv, weights=v).astype(np.int64).tolist()
        assert got.column("c").to_pylist() == np.bincount(inv).tolist()
        counters = plan_counters(plan, COUNTERS)
        assert counters["disjoint_break"] == 0 and counters["boundary_trims"] > 0, counters
        assert counters["final_disjoint_skip"] == 1, counters
        want, rplan = ref.sql(sql).collect_with_plan()
        assert ref_plan_counters(rplan, COUNTERS) == counters
        assert want.column("s").equals(got.column("s")) and want.column("c").equals(got.column("c"))
        assert want.column("k").to_pylist() == uk.astype(np.float64).astype(np.int64).tolist()


def test_warm_presorted_runs_are_bit_for_bit():
    """A float SUM that is not a decimal over a clustered key: the cold run
    sorts, the warm runs take the presorted arm. Warm runs equal each other
    and the cold run bit for bit (the f64 prefix reads the same sequence at
    the same positions on both arms)."""
    rng = np.random.default_rng(13)
    reps = rng.integers(1, 20, 3000)
    keys = np.repeat(np.arange(3000, dtype=np.int64), reps)
    v = rng.normal(size=keys.size) * np.pi  # not a decimal at any scale
    t = pa.table({"k": pa.array(keys), "v": pa.array(v), "f": pa.array(rng.random(keys.size))})
    ctx = TorchContext(BallistaConfig({"ballista.tpu.batch_rows": "4096"}), device="cpu")
    ctx.register_table("t", t)
    sql = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM t WHERE f < 0.8 GROUP BY k ORDER BY k"
    cold = ctx.sql(sql).collect()
    assert any(v is True for k, v in ctx._plan_cache.items() if k[0] == "agg_sorted")
    warm = []
    for _ in range(3):
        df = ctx.sql(sql)
        warm.append(df.collect())
        assert not df.stats
    for w in warm:
        assert w.equals(cold)


def test_kept_build_table_subtree_learns_nothing():
    """At ``build_cache_mb`` 2048 a warm run skips the SEMI join's build
    subtree (the HAVING aggregate over li) whose table was kept: entries of
    that subtree's sites, dropped from the cache, are not learned again,
    while the probe side's are."""
    rng = np.random.default_rng(9)
    reps = rng.integers(1, 9, 3000)
    keys = np.repeat(np.arange(3000, dtype=np.int64), reps)
    t = pa.table({"k": pa.array(keys), "q": pa.array(rng.integers(1, 50, keys.size))})
    ctx = TorchContext(BallistaConfig({"ballista.tpu.batch_rows": "4096"}), device="cpu")
    ctx.register_table("li", t)
    sql = ("SELECT k, SUM(q) AS tq FROM li WHERE k IN "
           "(SELECT k FROM li GROUP BY k HAVING SUM(q) > 200) GROUP BY k ORDER BY k")
    first = ctx.sql(sql).collect()
    fams = ("agg_sorted", "agg_state_cap", "agg_state_prefix", "shrink")

    def inside(key) -> bool:  # a site of the build subtree
        return isinstance(key, tuple) and key[0] in fams and any(
            isinstance(p, str) and p.startswith(("FilterExec: SUM(q) > 200", "HashAggregateExec(mode=final): gby=[k], aggr=[SUM(q)#sum]\n  CoalescePartitionsExec\n    HashAggregateExec(mode=partial): gby=[k], aggr=[SUM(q)#sum]\n      MemoryScanExec"))
            for p in key
        )

    dropped = [k for k in ctx._plan_cache if inside(k)]
    assert dropped
    for k in dropped:
        del ctx._plan_cache[k]
    df = ctx.sql(sql)
    got, plan = df.collect_with_plan()

    def nodes(p):
        yield p
        for c in p.children():
            yield from nodes(c)

    (having_filter,) = [p for p in nodes(plan) if p.describe() == "FilterExec: SUM(q) > 200"]
    assert not having_filter.metrics.counters.get("input_batches")  # the subtree did not run
    assert not [k for k in ctx._plan_cache if inside(k)]
    assert any(k[0] in fams for k in ctx._plan_cache if isinstance(k, tuple))
    assert got.equals(first)
