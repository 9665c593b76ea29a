"""Persisted capacity hints (``compilecache/hints.py``: ``HintStore``,
``store_path``) against the reference's, on the CPU: the hint cases of
``tests/test_compile_cache.py`` through both packages.

- The round trip keeps and drops the same entries in both (literal keys
  and values kept, numpy bools canonicalized, the ``__build_cache_bytes__``
  tally and values without a literal repr dropped, in-memory learning
  winning a merge), and each package's file loads in the other.
- A corrupt file, a file of another version and ``off`` are ignored alike.
- A fresh ``TorchContext`` (a fresh process's state) is seeded from the
  file an earlier context wrote: its first run of a query whose cold run
  grows a group capacity and a join expansion makes no capacity retry, and
  its result equals the earlier run's and the reference's.
- A restarted port executor (a new ``Executor`` over the same hint
  directory) runs the stage tasks of the same query with no retry and
  writes the files the first one wrote.

Results are compared as the other port tests compare them: keys and
counts exactly, floats within rtol 1e-9 (``test_torch_tpch.cmp``).
"""

from __future__ import annotations

import json

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.compilecache import metrics
from ballista_tpu_torch.compilecache.hints import HintStore, store_path


@pytest.fixture
def hint_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", str(tmp_path))
    return tmp_path


def _cache() -> dict:
    return {
        ("shrink", "HashJoinExec: ...", 0, 1 << 21): 4096,
        ("join_flags", "", "plan display", (2,), None): (np.True_, False),
        ("dec_sum", "", "site", 1): 4,
        "__build_cache_bytes__": 123456,  # ephemeral: never persisted
        ("bad", "value"): object(),  # no literal repr: dropped
    }


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_hint_store_round_trip(hint_dir, pkg):
    """The reference's round-trip case, run by one package's store and
    loaded by both."""
    from ballista_tpu.compilecache.hints import HintStore as RefStore
    from ballista_tpu.compilecache.hints import store_path as ref_store_path

    writer = HintStore if pkg == "port" else RefStore
    hint, cache = {"agg_capacity": 1 << 22}, _cache()
    s = writer()
    assert s.load_once(hint, cache) == 0  # no file yet: arms the fingerprint
    assert s.save_if_changed(hint, cache)
    assert not s.save_if_changed(hint, cache)  # debounced: unchanged
    loaded = []
    for reader in (HintStore, RefStore):
        h2, c2 = {}, {"existing": 1}
        r = reader()
        assert r.load_once(h2, c2) == 4  # 3 entries + agg_capacity
        assert r.load_once(h2, c2) == 0  # once means once
        loaded.append((h2, c2))
    assert loaded[0] == loaded[1]
    h2, c2 = loaded[0]
    assert h2 == {"agg_capacity": 1 << 22}
    assert c2[("join_flags", "", "plan display", (2,), None)] == (True, False)
    assert "__build_cache_bytes__" not in c2 and ("bad", "value") not in c2
    assert c2["existing"] == 1
    # memory wins the merge: a pre-existing key is not overwritten
    h3, c3 = {"agg_capacity": 1 << 23}, {("dec_sum", "", "site", 1): 6}
    HintStore().load_once(h3, c3)
    assert h3["agg_capacity"] == 1 << 23 and c3[("dec_sum", "", "site", 1)] == 6
    assert store_path() == ref_store_path() == str(hint_dir / "plan_hints.json")


def test_site_capacities_persist_and_merge(hint_dir):
    """The port's hint also holds learned join-expansion capacities: saved
    beside ``agg_capacity`` (which the reference's store reads as before),
    loaded into a fresh hint, and merged by the larger value."""
    from ballista_tpu.compilecache.hints import HintStore as RefStore

    site = ("expand_cap", "HashJoinExec: ...", ("join_flags", "", "x", (0,), None), "INNER", 1)
    hint = {"agg_capacity": 1 << 17, "site_capacity": {site: 1 << 14}}
    assert HintStore().save_if_changed(hint, {})
    doc = json.loads((hint_dir / "plan_hints.json").read_text())
    assert doc["site_capacity"] == {repr(site): 1 << 14}
    h = {"site_capacity": {site: 1 << 15}}
    assert HintStore().load_once(h, {}) == 1  # the agg capacity; the site stays larger
    assert h == {"agg_capacity": 1 << 17, "site_capacity": {site: 1 << 15}}
    h = {}
    assert HintStore().load_once(h, {}) == 2
    assert h == hint
    rh = {}
    assert RefStore().load_once(rh, {}) == 1 and rh == {"agg_capacity": 1 << 17}
    # a second owner's save merges its sites under the file's
    other = ("expand_cap", "other", None, "LEFT", 0)
    assert HintStore().save_if_changed({"site_capacity": {other: 8192}}, {})
    h = {}
    HintStore().load_once(h, {})
    assert h["site_capacity"] == {site: 1 << 14, other: 8192}


def test_hint_store_corrupt_file_and_off(hint_dir, monkeypatch):
    from ballista_tpu.compilecache.hints import HintStore as RefStore
    from ballista_tpu.compilecache.hints import store_path as ref_store_path

    for text in ("{not json", '{"version": 99, "entries": {"1": "2"}}'):
        (hint_dir / "plan_hints.json").write_text(text, encoding="utf-8")
        for store in (HintStore, RefStore):
            h, c = {}, {}
            assert store().load_once(h, c) == 0
            assert h == {} and c == {}
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", "off")
    assert store_path() is None and ref_store_path() is None
    assert not HintStore().save_if_changed({"agg_capacity": 4096}, {})
    # unset: the port's own directory, never the reference's jax cache
    monkeypatch.delenv("BALLISTA_TPU_HINT_CACHE")
    monkeypatch.setenv("HOME", str(hint_dir))
    assert store_path() == str(hint_dir / ".cache" / "ballista_tpu_torch" / "plan_hints.json")


# ---------------------------------------------------------------------------
# cold runs seeded from the file
# ---------------------------------------------------------------------------

# a group capacity of 2048 slots: the GROUP BY's 5,000 keys overflow it on
# a cold run; an expansion of one output row per probe row: the join's
# three matches a fact row overflow it on a cold run
SETTINGS = {"ballista.tpu.agg_capacity": "2048", "ballista.tpu.join_expansion": "1"}
SQL = (
    "SELECT f.k, COUNT(*) AS n, SUM(f.v) AS sv, SUM(d.w) AS sw FROM f JOIN d ON f.j = d.j "
    "GROUP BY f.k ORDER BY f.k"
)


def _tables() -> dict:
    rng = np.random.default_rng(11)
    n = 6000
    return {
        "f": pa.table({
            "k": pa.array(rng.integers(0, 5000, n)),
            "j": pa.array(rng.integers(0, 40, n)),
            "v": pa.array(rng.uniform(0, 100, n).round(2)),
        }),
        "d": pa.table({
            "j": pa.array(np.repeat(np.arange(40, dtype=np.int64), 3)),
            "w": pa.array(np.arange(120, dtype=np.int64)),
        }),
    }


def _context():
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext

    ctx = TorchContext(BallistaConfig(SETTINGS), device="cpu")
    for name, t in _tables().items():
        ctx.register_table(name, t)
    return ctx


def test_hint_persistence_seeds_a_fresh_context(hint_dir):
    """A cold run retries; a fresh context seeded from the file the first
    one wrote does not, and returns the same table, equal to the
    reference's."""
    from ballista_tpu.config import BallistaConfig as RefConfig
    from ballista_tpu.exec.context import TpuContext
    from test_torch_tpch import cmp

    ctx1 = _context()
    cold = ctx1.sql(SQL)
    first = cold.collect()
    # the group and the expansion overflow in one attempt: one retry grows both
    assert cold.stats.get("capacity_retries", 0) >= 1, cold.stats
    assert (hint_dir / "plan_hints.json").exists()
    learned = dict(ctx1._plan_cache)
    assert learned, "expected the query to learn plan-shape facts"
    assert ctx1._capacity_hint.get("agg_capacity") and ctx1._capacity_hint.get("site_capacity")

    ctx2 = _context()
    with metrics.delta() as d:
        df = ctx2.sql(SQL)
        again = df.collect()
    assert d.value.get("hints_loaded", 0) > 0, d.value
    assert df.stats.get("capacity_retries", 0) == 0, df.stats
    assert df.stats.get("speculation_misses", 0) == 0, df.stats
    for k in learned:
        assert k in ctx2._plan_cache, k
    assert again.equals(first)
    ref = TpuContext(RefConfig(SETTINGS))
    for name, t in _tables().items():
        ref.register_table(name, t)
    cmp(again.to_pandas(), ref.sql(SQL).collect().to_pandas())


def test_hints_off_keeps_every_cold_run_cold(monkeypatch):
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", "off")
    for _ in range(2):
        df = _context().sql(SQL)
        df.collect()
        assert df.stats.get("capacity_retries", 0) >= 1, df.stats


def test_restarted_executor_is_seeded_from_the_file(hint_dir, tmp_path, monkeypatch):
    """Every stage task of the query through a port executor, then through
    a new executor over the same hint directory: the second makes no
    capacity retry and writes the same shuffle files."""
    import pyarrow.ipc as paipc

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.distributed_plan import DistributedPlanner, remove_unresolved_shuffles
    from ballista_tpu_torch.exec import base
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.executor import executor as executor_mod
    from ballista_tpu_torch.executor.executor import Executor
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.proto import pb
    from ballista_tpu_torch.scheduler_types import PartitionLocation
    from ballista_tpu_torch.serde import BallistaCodec

    retries: list = []

    def counted(*a, **kw):
        kw["stats"] = stats = {}
        try:
            return base.run_with_capacity_retry(*a, **kw)
        finally:
            retries.append(stats.get("capacity_retries", 0))

    monkeypatch.setattr(executor_mod, "run_with_capacity_retry", counted)
    ctx = _context()
    k = 2
    props = {**SETTINGS, "ballista.shuffle.partitions": str(k)}
    plan = PhysicalPlanner(ctx, k, config=BallistaConfig(props), distributed=True).plan(
        optimize(ctx.sql_to_logical(SQL))
    )
    stages = DistributedPlanner().plan_query_stages("job", plan)
    codec = BallistaCodec(provider=ctx)

    def run_all(work) -> dict:
        ex = Executor("e", str(work), provider=ctx, device="cpu")
        locs: dict = {}
        for stage in stages:
            wire = codec.physical_to_proto(remove_unresolved_shuffles(stage.plan, locs)).SerializeToString()
            parts = [[] for _ in range(stage.output_partition_count)]
            for p in range(stage.input_partition_count):
                task = pb.TaskDefinition(
                    task_id=pb.PartitionId(job_id="job", stage_id=stage.stage_id, partition_id=p),
                    plan=wire, props=[pb.KeyValuePair(key=a, value=b) for a, b in props.items()],
                    session_id="s",
                )
                for m in ex.execute_shuffle_write(task):
                    parts[m.partition_id].append(PartitionLocation(
                        "job", stage.stage_id, m.partition_id, "e", "localhost", 0, m.path, map_partition=p,
                    ))
            locs[stage.stage_id] = parts
        out = {}
        for path in sorted(work.rglob("*.arrow")):
            with pa.memory_map(str(path)) as src:
                out[path.relative_to(work).as_posix()] = paipc.open_file(src).read_all()
        return out

    first = run_all(tmp_path / "w1")
    assert sum(retries) >= 1, retries
    assert (hint_dir / "plan_hints.json").exists()
    retries.clear()
    second = run_all(tmp_path / "w2")
    assert retries and sum(retries) == 0, retries
    assert sorted(first) == sorted(second)
    for path, t in first.items():
        assert second[path].equals(t), path


def test_concurrent_merges_and_saves(hint_dir):
    """An executor's task threads merge learned capacities into one hint
    (``exec.base._remember``, under its lock) while other tasks save it
    and a fresh store loads into it: with a short switch interval and more
    threads than cores, no update is lost and the file ends with every
    site's largest capacity."""
    import sys
    import threading

    from ballista_tpu_torch.exec.base import _remember

    hint: dict = {}
    store = HintStore()
    store.load_once(hint, {})
    n_threads, rounds = 16, 200
    errors: list = []

    def task(i: int) -> None:
        try:
            for r in range(rounds):
                _remember(hint, 4096 * (r + 1), {("expand_cap", f"s{i % 4}", None, "INNER", 0): 2048 * (r + 1 + i)})
                if r % 20 == 0:
                    store.save_if_changed(hint, {})
                    HintStore().load_once(hint, {})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=task, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    want = {("expand_cap", f"s{k}", None, "INNER", 0): 2048 * (rounds + max(i for i in range(n_threads) if i % 4 == k))
            for k in range(4)}
    assert hint == {"agg_capacity": 4096 * rounds, "site_capacity": want}
    HintStore().save_if_changed(hint, {})
    fresh: dict = {}
    HintStore().load_once(fresh, {})
    assert fresh == hint
