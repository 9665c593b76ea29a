"""The adaptive capacity shrink (``ballista_tpu_torch/exec/shrink.py``)
against the reference's (``ballista_tpu/exec/shrink.py``) on the same
seeded input: every case of ``tests/test_shrink.py`` through both packages.

The learned capacities, the sticky don't-shrink 0, the output's capacity
and rows (in order: both compactions are stable) and the speculation miss
of a grown input must be equal. The q18-shaped query runs twice on both
contexts (run 1 learns, run 2 speculates): the same result (keys exactly,
float sums within rtol 1e-9) and the same learned shrink entries. Port
only: warm runs learn nothing new, make no retry and are bit for bit
among themselves; a grown input under a learned capacity misses once and
recovers. The card's cases are in ``tests/test_torch_adaptive_card.py``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.columnar.arrow_interop import batch_from_arrow as ref_batch_from_arrow
from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.errors import SpeculationMiss as RefMiss
from ballista_tpu.exec.base import TaskContext as RefTask
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.exec.shrink import maybe_shrink as ref_shrink
from ballista_tpu_torch.columnar.arrow_interop import batch_from_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import SpeculationMiss
from ballista_tpu_torch.exec import shrink
from ballista_tpu_torch.exec.base import TaskContext
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.exec.shrink import SHRINK_MIN_CAP, maybe_shrink


def _table(n_rows: int) -> pa.Table:
    return pa.table({
        "k": pa.array(np.arange(n_rows, dtype=np.int64)),
        "v": pa.array(np.random.default_rng(0).random(n_rows)),
    })


def _batches(n_rows: int, live: int):
    """(port batch, reference batch): the same table, its first ``live``
    rows live."""
    import jax.numpy as jnp

    t = _table(n_rows)
    b = batch_from_arrow(t, device="cpu")
    b = b.with_valid(b.valid & (torch.arange(b.capacity) < live))
    r = ref_batch_from_arrow(t)
    r = r.with_valid(r.valid & (jnp.arange(r.capacity) < live))
    return b, r


def _ctxs(cache: dict, ref_cache: dict):
    return (
        TaskContext(config=BallistaConfig(), plan_cache=cache, device="cpu"),
        RefTask(config=RefConfig(), plan_cache=ref_cache),
    )


def _live(batch) -> tuple:
    valid = np.asarray(batch.valid)
    return tuple(np.asarray(c)[valid].tolist() for c in batch.columns)


def _shrink_both(b, r, cache, ref_cache, site="site"):
    ctx, rctx = _ctxs(cache, ref_cache)
    out, rout = maybe_shrink(b, ctx, site, 0), ref_shrink(r, rctx, site, 0)
    assert out.capacity == rout.capacity
    assert (out is b) == (rout is r)
    assert int(out.count_valid()) == int(rout.count_valid())
    # the compaction is stable in both: the same rows in the same order
    assert np.array_equal(np.asarray(out.valid), np.asarray(rout.valid))
    for c, rc in zip(out.columns, rout.columns):
        assert np.array_equal(np.asarray(c), np.asarray(rc))
    assert cache == ref_cache
    return out, ctx, rctx


def test_learns_and_shrinks_sparse_batch():
    cache, ref_cache = {}, {}
    b, r = _batches(1 << 19, live=100)
    out, _, _ = _shrink_both(b, r, cache, ref_cache)
    assert 100 <= out.capacity < b.capacity
    (key,) = [k for k in cache if k[0] == "shrink"]
    assert key == ("shrink", "site", 0, b.capacity) and cache[key] == out.capacity
    # a fresh run takes the learned capacity speculatively and validates it
    out2, ctx2, rctx2 = _shrink_both(b, r, cache, ref_cache)
    assert out2.capacity == out.capacity
    assert len(ctx2.speculative_checks) == len(rctx2.speculative_checks) == 1
    ctx2.raise_deferred()  # unchanged data: the flag does not fire
    rctx2.raise_deferred()


def test_rows_survive_shrink_exactly():
    cache, ref_cache = {}, {}
    b, r = _batches(1 << 19, live=57)
    out, _, _ = _shrink_both(b, r, cache, ref_cache)
    assert sorted(_live(out)[0]) == sorted(_live(b)[0]) == sorted(_live(r)[0])


def test_dense_batch_not_shrunk_and_sticky():
    cache, ref_cache = {}, {}
    b, r = _batches(1 << 19, live=1 << 18)  # 50% live: the ratio test fails
    ctx, rctx = _ctxs(cache, ref_cache)
    assert maybe_shrink(b, ctx, "site", 0) is b
    assert ref_shrink(r, rctx, "site", 0) is r
    (key,) = [k for k in cache if k[0] == "shrink"]
    assert cache == ref_cache and cache[key] == 0
    # a later sparse batch at the same site does not overwrite the sticky 0
    sb, sr = _batches(1 << 19, live=10)
    assert maybe_shrink(sb, ctx, "site", 0) is sb
    assert ref_shrink(sr, rctx, "site", 0) is sr
    assert cache == ref_cache and cache[key] == 0
    assert ctx.run_state["synced_caps"] == rctx.run_state["synced_caps"] == {key}


def test_grown_input_fires_speculation():
    cache, ref_cache = {}, {}
    b, r = _batches(1 << 19, live=20)
    _shrink_both(b, r, cache, ref_cache)
    # a fresh run at the same site with far more live rows than learned
    gb, gr = _batches(1 << 19, live=1 << 17)
    ctx, rctx = _ctxs(cache, ref_cache)
    maybe_shrink(gb, ctx, "site", 0)
    ref_shrink(gr, rctx, "site", 0)
    with pytest.raises(SpeculationMiss) as got:
        ctx.raise_deferred()
    with pytest.raises(RefMiss) as want:
        rctx.raise_deferred()
    assert got.value.invalid_keys == want.value.invalid_keys == [("shrink", "site", 0, 1 << 19)]


def test_small_capacity_untouched():
    cache, ref_cache = {}, {}
    b, r = _batches(SHRINK_MIN_CAP // 2, live=1)
    ctx, rctx = _ctxs(cache, ref_cache)
    assert maybe_shrink(b, ctx, "site", 0) is b
    assert ref_shrink(r, rctx, "site", 0) is r
    assert not cache and not ref_cache


def test_no_cache_is_noop():
    b, r = _batches(1 << 19, live=1)
    assert maybe_shrink(b, TaskContext(config=BallistaConfig(), device="cpu"), "s", 0) is b
    assert ref_shrink(r, RefTask(config=RefConfig()), "s", 0) is r


def test_constants_are_the_references():
    from ballista_tpu.exec import shrink as ref

    assert (shrink.SHRINK_MIN_CAP, shrink.SHRINK_RATIO, shrink.SHRINK_HEADROOM) == (
        ref.SHRINK_MIN_CAP, ref.SHRINK_RATIO, ref.SHRINK_HEADROOM,
    )


Q18_SHAPE = (
    "SELECT o.ok, o.total, SUM(l.qty) AS q FROM ord o, li l "
    "WHERE o.ok = l.ok AND o.ok IN "
    "(SELECT ok FROM li GROUP BY ok HAVING SUM(qty) > 220) "
    "GROUP BY o.ok, o.total ORDER BY q DESC, o.ok LIMIT 10"
)


def _q18_tables():
    rng = np.random.default_rng(7)
    n = 60_000
    li = pa.table({
        "ok": pa.array(rng.integers(0, 15_000, n).astype(np.int64)),
        "qty": pa.array(rng.uniform(1, 50, n)),
    })
    orders = pa.table({
        "ok": pa.array(np.arange(15_000, dtype=np.int64)),
        "total": pa.array(rng.uniform(10, 1000, 15_000)),
    })
    return {"li": li, "ord": orders}


def _shrink_entries(cache: dict) -> dict:
    return {k: v for k, v in cache.items() if isinstance(k, tuple) and k[0] == "shrink"}


def test_q18_shape_end_to_end_matches_reference():
    """The reference's q18-shaped case (selective HAVING, semi join, join,
    GROUP BY) on both contexts, run 1 learning and run 2 speculating: the
    same rows and the same learned shrink entries."""
    tables = _q18_tables()
    ctx = TorchContext(BallistaConfig(), device="cpu")
    ref = TpuContext(RefConfig())
    for name, t in tables.items():
        ctx.register_table(name, t)
        ref.register_table(name, t)
    for _ in range(2):
        got = ctx.sql(Q18_SHAPE).collect()
        want = ref.sql(Q18_SHAPE).collect()
        assert got.column("o.ok").to_pylist() == want.column("o.ok").to_pylist()
        np.testing.assert_allclose(
            got.column("q").to_numpy(), want.column("q").to_numpy(), rtol=1e-9
        )
        assert _shrink_entries(ctx._plan_cache) == _shrink_entries(ref._plan_cache)
    learned = _shrink_entries(ctx._plan_cache)
    # the HAVING's semi join shrinks (its display names the join)
    assert any(v and k[1].startswith("HashJoinExec") for k, v in learned.items()), learned


def _learned(cache: dict) -> dict:
    return {k: v for k, v in cache.items() if k != "__build_cache_bytes__"}


@pytest.mark.parametrize("build_cache_mb", ["0", "2048"])
def test_warm_runs_learn_nothing_new(build_cache_mb):
    """Port only: the cold run learns the shrink sites, and the first warm
    run the sites and layouts that the shrunk and sliced capacities give (a
    new capacity is a new key); from then on warm runs take
    every entry speculatively, learn nothing new, make no retry or miss
    and give the same bits."""
    tables = _q18_tables()
    ctx = TorchContext(BallistaConfig({"ballista.tpu.build_cache_mb": build_cache_mb}), device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    cold = ctx.sql(Q18_SHAPE).collect()
    shrinks = _shrink_entries(ctx._plan_cache)
    assert shrinks
    ctx.sql(Q18_SHAPE).collect()
    learned = _learned(ctx._plan_cache)
    assert shrinks.items() <= _shrink_entries(learned).items()
    results = []
    for _ in range(2):
        df = ctx.sql(Q18_SHAPE)
        results.append(df.collect())
        assert not df.stats, df.stats  # no capacity retry, no speculation miss
        assert _learned(ctx._plan_cache) == learned
    assert results[0].equals(results[1])
    assert results[0].column("o.ok").equals(cold.column("o.ok"))
    np.testing.assert_allclose(
        results[0].column("q").to_numpy(), cold.column("q").to_numpy(), rtol=1e-9
    )


def test_grown_input_under_a_cached_capacity_recovers():
    """A table re-registered with more rows through the same filter site,
    under the shrink capacity the earlier run learned (kept as a hint file
    would keep it): one SpeculationMiss, one re-run, the right result."""
    sql = "SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE k < 300"
    rng = np.random.default_rng(3)

    def table(live: int) -> pa.Table:
        k = np.full(1 << 18, 10_000, dtype=np.int64)
        k[rng.choice(k.size, live, replace=False)] = rng.integers(0, 300, live)
        return pa.table({"k": k, "v": rng.random(k.size)})

    ctx = TorchContext(BallistaConfig(), device="cpu")
    ctx.register_table("t", table(50))
    ctx.sql(sql).collect()
    learned = _shrink_entries(ctx._plan_cache)
    assert learned and all(v for v in learned.values())
    grown = table(60_000)
    ctx.register_table("t", grown)  # clears the plan cache
    ctx._plan_cache.update(learned)
    df = ctx.sql(sql)
    got = df.collect()
    assert df.stats == {"speculation_misses": 1}
    kv = grown.column("k").to_numpy()
    assert got.column("c").to_pylist() == [int((kv < 300).sum())]
    np.testing.assert_allclose(
        got.column("s").to_numpy(), [grown.column("v").to_numpy()[kv < 300].sum()], rtol=1e-9
    )
    # re-learned: the site does not shrink at 23% live
    assert set(_shrink_entries(ctx._plan_cache).values()) == {0}
