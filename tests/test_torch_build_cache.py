"""The join build-table cache and the learned INNER flip of the port's
``HashJoinExec`` (``ballista_tpu_torch/exec/joins.py``) against the
reference's ``TpuContext`` on the same seeded data, at one and two shuffle
partitions.

A collect-mode join keeps the table it built on its plan instance when the
run ends clean, within ``ballista.tpu.build_cache_mb``; a warm run reuses it
without collecting or sorting the build side again. A warm INNER join whose
right side was learned to hold duplicates and whose left side was learned
to be unique streams the right side through the (cached) left build and
never collects it. Keys, counts and integer sums are held exactly; float
sums within rtol 1e-9 against the reference, and bit for bit between the
port's own warm runs. The cache counters (``build_cache_store``,
``build_cache_skip``) equal the reference's.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.config import BallistaConfig as RefConfig
from ballista_tpu.exec.base import plan_counters as ref_plan_counters
from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.columnar.arrow_interop import batch_to_arrow
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.exec import joins
from ballista_tpu_torch.exec.base import TaskContext, plan_counters, run_with_capacity_retry
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.expr import logical as L

PARTS = ["1", "2"]
COUNTERS = ("build_cache_store", "build_cache_skip")
TALLY = "__build_cache_bytes__"


def _data(n_keys: int = 3000, reps: int = 5):
    """The reference test's fact and dimension (``tests/test_build_cache.py``)."""
    rng = np.random.default_rng(11)
    keys = np.repeat(np.arange(1, n_keys + 1, dtype=np.int64), reps)
    qty = rng.integers(1, 60, len(keys)).astype(np.int64)
    fact = pa.table({"k": pa.array(keys), "q": pa.array(qty)})
    dim = pa.table({
        "k": pa.array(np.arange(1, n_keys + 1, dtype=np.int64)),
        "name": pa.array([f"n{i}" for i in range(n_keys)]),
    })
    return fact, dim


def _flip_data(n: int = 3000):
    """A unique int64 dimension key and a fact whose keys repeat, with an
    f64 value column."""
    rng = np.random.default_rng(5)
    fk = rng.integers(1, n + 1, 5 * n).astype(np.int64)
    fact = pa.table({
        "k": fk, "q": rng.integers(1, 60, fk.size).astype(np.int64),
        "x": rng.normal(size=fk.size),
    })
    dim = pa.table({
        "k": np.arange(1, n + 1, dtype=np.int64),
        "g": (np.arange(n) % 7).astype(np.int64),
        "s": pa.array([f"s{i % 11}" for i in range(n)]),
    })
    return fact, dim


SEMI_SQL = (
    "SELECT d.k, SUM(f.q) AS s FROM f, d WHERE f.k = d.k AND f.k IN "
    "(SELECT k FROM f GROUP BY k HAVING SUM(q) > 200) GROUP BY d.k"
)
COUNT_SQL = "SELECT COUNT(*) AS c FROM f, d WHERE f.k = d.k"
# d JOIN f: the right side (f) has duplicate keys, the left (d) none
FLIP_SQL = (
    "SELECT d.g, COUNT(*) AS c, SUM(f.q) AS s, SUM(f.x) AS x "
    "FROM d JOIN f ON d.k = f.k GROUP BY d.g"
)


def _contexts(parts: str, tables: dict, **settings):
    s = {"ballista.shuffle.partitions": parts, **settings}
    ref = TpuContext(RefConfig(s))
    port = TorchContext(BallistaConfig(s), device="cpu")
    for c in (ref, port):
        for name, t in tables.items():
            c.register_table(name, t)
    return ref, port


def _run(ctx, sql: str):
    """(result, counters, stats) of one collect."""
    df = ctx.sql(sql)
    got, plan = df.collect_with_plan()
    counters = (ref_plan_counters if isinstance(ctx, TpuContext) else plan_counters)(plan, COUNTERS)
    return got, counters, getattr(df, "stats", {})


def _sorted(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def _assert_same(got: pa.Table, want: pa.Table) -> None:
    """Rows sorted; integer columns exactly, floats within rtol 1e-9."""
    g, w = _sorted(got), _sorted(want)
    assert g.column_names == w.column_names and g.num_rows == w.num_rows
    for name in w.column_names:
        a = g.column(name).to_numpy(zero_copy_only=False)
        b = w.column(name).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(w.schema.field(name).type):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(a, b)


def _joins(plan) -> list:
    """The hash joins of a plan of either package."""
    out = [plan] if type(plan).__name__ == "HashJoinExec" else []
    for c in plan.children():
        out += _joins(c)
    return out


def _cached_entries(plan) -> int:
    return sum(len(j._build_cache) for j in _joins(plan))


def _plan(ctx, sql: str):
    """The context's cached physical plan instance of ``sql`` (the one its
    collects run)."""
    return ctx.create_physical_plan(ctx.sql_to_logical(sql))


@pytest.mark.parametrize("parts", PARTS)
def test_semi_build_correct_after_capacity_retry(parts):
    """The reference's case: at agg_capacity 256 the HAVING subquery under
    the SEMI build overflows on the cold run, which retries; the table the
    failed attempt built is never kept. Cold and two warm runs equal the
    reference and the oracle; the cold run stores what the reference's
    stores, warm runs store nothing and do not retry."""
    fact, dim = _data()
    ref, port = _contexts(parts, {"f": fact, "d": dim}, **{"ballista.tpu.agg_capacity": "256"})
    sums = fact.to_pandas().groupby("k").q.sum()
    oracle = sums[sums > 200]
    for attempt in range(3):
        want, ref_counters, _ = _run(ref, SEMI_SQL)
        got, counters, stats = _run(port, SEMI_SQL)
        _assert_same(got, want)
        g = _sorted(got)
        np.testing.assert_array_equal(g.column(0).to_numpy(), oracle.index.values)
        np.testing.assert_array_equal(g.column(1).to_numpy(), oracle.values)
        assert counters == ref_counters, (attempt, counters, ref_counters)
        if attempt == 0:
            assert stats.get("capacity_retries", 0) >= 1
            assert counters["build_cache_store"] >= 1
        else:
            assert stats == {} and counters["build_cache_store"] == 0
    # the tally counts exactly the tables kept (the failed attempt's none)
    stored = [v for j in _joins(_plan(port, SEMI_SQL)) for v in j._build_cache.values()]
    assert stored and port._plan_cache[TALLY] == sum(_table_bytes(b, bt) for b, bt in stored)


def _table_bytes(batch, bt) -> int:
    size = sum(c.nbytes for c in batch.columns) + sum(c.nbytes for c in bt.batch.columns)
    return size + bt.keys.nbytes + sum(c.nbytes for c in bt.key_cols) + (
        0 if bt.lut2 is None else bt.lut2.nbytes
    )


@pytest.mark.parametrize("parts", PARTS)
def test_build_cache_reused_across_queries(parts):
    """The reference's case: the plan instance holds a built table after a
    run, a second run reuses it, and re-registering a table drops the
    instance and its cache (the new data's result is right)."""
    fact, dim = _data()
    ref, port = _contexts(parts, {"f": fact, "d": dim})
    for c in (ref, port):
        first = c.sql(COUNT_SQL).collect().column("c")[0].as_py()
        phys = c.create_physical_plan(c.sql_to_logical(COUNT_SQL))
        second = c.sql(COUNT_SQL).collect().column("c")[0].as_py()
        assert first == second == fact.num_rows
        assert _cached_entries(phys) >= 1
        c.register_table("f", fact.slice(0, 100))
        assert c.sql(COUNT_SQL).collect().column("c")[0].as_py() == 100
        assert c.create_physical_plan(c.sql_to_logical(COUNT_SQL)) is not phys
    assert _cached_entries(_plan(port, COUNT_SQL)) == _cached_entries(_plan(ref, COUNT_SQL)) == 1


@pytest.mark.parametrize("parts", PARTS)
def test_learned_flip_streams_the_right_side_uncollected(parts, monkeypatch):
    """d JOIN f with f's keys repeated: the cold run collects and sorts f to
    decide, then builds d and streams f through it. From the second run on
    the flip is learned: f is only streamed (each of its partitions executed
    once, never collected), d's table is built once and then taken from the
    cache. Every run equals the reference; warm runs are bit for bit."""
    fact, dim = _flip_data()
    ref, port = _contexts(parts, {"f": fact, "d": dim})
    (join,) = _joins(_plan(port, FLIP_SQL))
    executed, collected = [], []
    right_execute = join.right.execute
    monkeypatch.setattr(join.right, "execute", lambda p, t: (executed.append(p), right_execute(p, t))[1])
    collect = joins._collect
    monkeypatch.setattr(
        joins, "_collect",
        lambda plan, t: (collected.append("right" if plan is join.right else "left"), collect(plan, t))[1],
    )
    n = join.right.output_partitioning().n
    runs = []
    for i in range(4):
        executed.clear()
        collected.clear()
        want, ref_counters, _ = _run(ref, FLIP_SQL)
        got, counters, stats = _run(port, FLIP_SQL)
        _assert_same(got, want)
        assert stats == {}
        runs.append(_sorted(got))
        if i == 0:
            assert sorted(executed) == sorted(list(range(n)) * 2)  # collected, then streamed
            assert collected == ["right", "left"]
        else:
            assert sorted(executed) == list(range(n))  # streamed only
            assert "right" not in collected
            assert collected == (["left"] if i == 1 else [])
            assert counters["build_cache_store"] == (1 if i == 1 else 0)
        assert counters == ref_counters, (i, counters, ref_counters)
    assert list(join._build_cache) == [("bt_flip",)]
    for r in runs[2:]:
        for name in r.column_names:
            a, b = r.column(name).to_numpy(), runs[1].column(name).to_numpy()
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), name


@pytest.mark.parametrize("parts", PARTS)
def test_stale_learned_flip_misses_and_recovers(parts):
    """A planted stale entry claims the left side unique where its keys
    repeat: the learned flip's deferred validation raises a
    SpeculationMiss, the retry drops the entry and takes the m:n expansion,
    and the result equals the reference's. The failed attempt keeps no
    table."""
    fact, _ = _flip_data()
    dup = pa.table({"k": (np.arange(3000) % 1500 + 1).astype(np.int64), "g": np.arange(3000) % 5})
    sql = "SELECT d.g, COUNT(*) AS c, SUM(f.q) AS s FROM d JOIN f ON d.k = f.k GROUP BY d.g"
    ref, port = _contexts(parts, {"f": fact, "d": dup})
    (join,) = _joins(_plan(port, sql))
    lk = [L.resolve_field_index(join.left.schema(), a.cname) for a, _ in join.on]
    rk = [L.resolve_field_index(join.right.schema(), b.cname) for _, b in join.on]
    lfp, rfp = join._strategy_key(join.left, lk), join._strategy_key(join.right, rk)
    port._plan_cache[rfp] = (True, False, False, 1, 3000)
    port._plan_cache[lfp] = (False, False, False, 1, 1500)
    task = TaskContext(device="cpu", plan_cache=port._plan_cache)
    assert join._learned_flip(task, lk, rk) == (lfp, port._plan_cache[lfp])
    want, _, _ = _run(ref, sql)
    got, counters, stats = _run(port, sql)
    _assert_same(got, want)
    assert stats == {"speculation_misses": 1}
    assert port._plan_cache[lfp][0] is True  # relearned: the left side repeats
    assert ("bt_flip",) not in join._build_cache and counters["build_cache_store"] == 0
    got, _, stats = _run(port, sql)
    _assert_same(got, want)
    assert stats == {}


@pytest.mark.parametrize("parts", PARTS)
def test_cached_build_skips_the_budget_check(parts, monkeypatch):
    """Under ballista.tpu.hbm_budget_mb, a warm run whose build table is
    cached does not run the budget check, so its build subtree executes no
    time; with build_cache_mb 0 every run executes it as the cold run did.
    Both equal the reference."""
    fact, dim = _data()
    runs = {}
    for cache_mb in ("2048", "0"):
        ref, port = _contexts(
            parts, {"f": fact, "d": dim},
            **{"ballista.tpu.hbm_budget_mb": "1", "ballista.tpu.build_cache_mb": cache_mb},
        )
        (join,) = _joins(_plan(port, COUNT_SQL))
        executed = []
        right_execute = join.right.execute
        monkeypatch.setattr(join.right, "execute", lambda p, t, f=right_execute: (executed.append(p), f(p, t))[1])
        counts = []
        for _ in range(3):
            executed.clear()
            want, ref_counters, _ = _run(ref, COUNT_SQL)
            got, counters, _ = _run(port, COUNT_SQL)
            _assert_same(got, want)
            assert counters == ref_counters
            counts.append(len(executed))
        runs[cache_mb] = counts
    n = int(parts)
    assert runs["2048"][0] == runs["0"][0] >= n
    assert runs["2048"][1:] == [0, 0]
    assert runs["0"][1:] == [runs["0"][0]] * 2


@pytest.mark.parametrize("parts", PARTS)
def test_build_cache_mb_zero_keeps_nothing(parts):
    fact, dim = _data()
    ref, port = _contexts(parts, {"f": fact, "d": dim}, **{"ballista.tpu.build_cache_mb": "0"})
    for _ in range(2):
        want, ref_counters, _ = _run(ref, COUNT_SQL)
        got, counters, _ = _run(port, COUNT_SQL)
        _assert_same(got, want)
        assert counters == ref_counters == {"build_cache_store": 0, "build_cache_skip": 0}
    assert _cached_entries(_plan(port, COUNT_SQL)) == 0 and TALLY not in port._plan_cache


@pytest.mark.parametrize("parts", PARTS)
def test_table_over_the_budget_is_skipped(parts):
    """A unique 40,000-row build side takes over 1 MB as a table: at
    build_cache_mb 1 it is skipped (``build_cache_skip``), not kept."""
    fact, _ = _data()
    big = pa.table({"k": np.arange(1, 40_001, dtype=np.int64), "w": np.arange(40_000, dtype=np.int64)})
    sql = "SELECT COUNT(*) AS c, SUM(big.w) AS w FROM f JOIN big ON f.k = big.k"
    ref, port = _contexts(parts, {"f": fact, "big": big}, **{"ballista.tpu.build_cache_mb": "1"})
    for _ in range(2):
        want, ref_counters, _ = _run(ref, sql)
        got, counters, _ = _run(port, sql)
        _assert_same(got, want)
        # each probe partition offers the table, and each is refused
        assert counters == ref_counters == {"build_cache_store": 0, "build_cache_skip": int(parts)}
    assert _cached_entries(_plan(port, sql)) == 0 and port._plan_cache.get(TALLY, 0) == 0


@pytest.mark.parametrize("parts", PARTS)
def test_string_keyed_build_is_never_kept(parts):
    fact, dim = _flip_data()
    names = pa.table({"s": pa.array([f"s{i}" for i in range(11)]), "r": np.arange(11, dtype=np.int64)})
    sql = "SELECT COUNT(*) AS c, SUM(names.r) AS r FROM d JOIN names ON d.s = names.s"
    ref, port = _contexts(parts, {"d": dim, "names": names})
    for _ in range(2):
        want, ref_counters, _ = _run(ref, sql)
        got, counters, _ = _run(port, sql)
        _assert_same(got, want)
        assert counters == ref_counters == {"build_cache_store": 0, "build_cache_skip": 0}
    assert _cached_entries(_plan(port, sql)) == 0 and TALLY not in port._plan_cache


@pytest.mark.parametrize("parts", PARTS)
def test_tally_resets_with_the_physical_plan_cache(parts):
    """At 128 cached plans the context drops them all, and with them their
    tables: the tally goes too, and the next run keeps its table again."""
    fact, dim = _data()
    ref, port = _contexts(parts, {"f": fact, "d": dim})
    for c in (ref, port):
        c.sql(COUNT_SQL).collect()
        used = c._plan_cache[TALLY]
        assert used > 0
        for i in range(128):
            c.create_physical_plan(c.sql_to_logical(f"SELECT k FROM d WHERE k = {i}"))
        assert TALLY not in c._plan_cache
        c.sql(COUNT_SQL).collect()
        assert c._plan_cache[TALLY] == used


@pytest.mark.parametrize("parts", PARTS)
def test_failed_run_keeps_no_table(parts):
    """A run whose deferred check fails commits nothing: no table, no
    tally. The next clean run keeps its table."""
    fact, dim = _data()
    _, port = _contexts(parts, {"f": fact, "d": dim})
    phys = _plan(port, COUNT_SQL)

    def run(t):
        for p in range(phys.output_partitioning().n):
            list(phys.execute(p, t))
        t.defer_check(torch.tensor(True), "forced failure at the task boundary")

    with pytest.raises(ExecutionError, match="forced failure"):
        run_with_capacity_retry(port.config, run, device="cpu", plan_cache=port._plan_cache)
    assert _cached_entries(phys) == 0 and TALLY not in port._plan_cache
    port.sql(COUNT_SQL).collect()
    assert _cached_entries(phys) == 1 and port._plan_cache[TALLY] > 0


@pytest.mark.parametrize("parts", PARTS)
def test_cache_builds_false_keeps_nothing(parts):
    fact, dim = _data()
    _, port = _contexts(parts, {"f": fact, "d": dim})
    phys = _plan(port, COUNT_SQL)

    def run(t):
        assert t.cache_builds is False
        return [batch_to_arrow(b) for p in range(phys.output_partitioning().n) for b in phys.execute(p, t)]

    for _ in range(2):
        got = run_with_capacity_retry(
            port.config, run, device="cpu", plan_cache=port._plan_cache, cache_builds=False,
        )
        assert pa.Table.from_batches(got).column("c").to_pylist() == [fact.num_rows]
    assert _cached_entries(phys) == 0 and TALLY not in port._plan_cache


def test_failed_attempt_keeps_the_tally_of_other_runs():
    """A retried attempt puts the plan cache back as it found it, all but
    the tally: a run sharing the cache may have committed a table
    meanwhile, and the failed attempt committed none."""
    from ballista_tpu_torch.errors import SpeculationMiss

    cache = {TALLY: 100, ("join_flags", "x"): (True,)}
    attempts = []

    def fn(t):
        attempts.append(1)
        if len(attempts) == 1:
            cache[TALLY] = 300  # another run's commit
            cache[("join_flags", "y")] = (False,)  # this attempt's learning
            raise SpeculationMiss("stale", invalid_keys=[("join_flags", "x")])
        return "ok"

    assert run_with_capacity_retry(BallistaConfig(), fn, device="cpu", plan_cache=cache) == "ok"
    assert cache == {TALLY: 300}


def test_executor_tasks_keep_no_build_tables(tmp_path, monkeypatch):
    """An executor decodes a fresh plan a task, so its tasks run with
    ``cache_builds`` off."""
    from ballista_tpu_torch.distributed_plan import DistributedPlanner
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.executor import executor as executor_mod
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.serde import BallistaCodec

    fact, dim = _data()
    _, port = _contexts("1", {"f": fact, "d": dim})
    plan = PhysicalPlanner(port, 1, config=port.config, distributed=True).plan(
        optimize(port.sql_to_logical(COUNT_SQL))
    )
    stage = DistributedPlanner().plan_query_stages("job", plan)[0]
    plan_bytes = BallistaCodec(provider=port).physical_to_proto(stage.plan).SerializeToString()
    seen = []
    real = executor_mod.run_with_capacity_retry

    def spy(*a, **kw):
        seen.append(kw.get("cache_builds", True))
        return real(*a, **kw)

    monkeypatch.setattr(executor_mod, "run_with_capacity_retry", spy)
    ex = executor_mod.Executor("exec-1", str(tmp_path), provider=port, device="cpu")
    ex.execute_shuffle_write(pb.TaskDefinition(
        task_id=pb.PartitionId(job_id="job", stage_id=stage.stage_id, partition_id=0),
        plan=plan_bytes, session_id="s",
        props=[pb.KeyValuePair(key="ballista.shuffle.partitions", value="1")],
    ))
    assert seen == [False]

