"""The port's shared callable cache (``ballista_tpu_torch/compilecache/
tracecache.py``), the cases of ``tests/test_compile_cache.py``'s trace-cache
section: the cache dedupes and is bounded; a second identical submission
on fresh plan instances builds nothing, locally and through the standalone
cluster (whose executor decodes a fresh plan for every task), and the
executor ships the counters to the scheduler's REST state. Results equal
the reference's on the shared-cache paths (q1 and q3), and a closure is
never shared between two devices."""

import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from ballista_tpu.exec.context import TpuContext
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.compilecache import metrics, tracecache
from ballista_tpu_torch.exec.context import TorchContext
from ballista_tpu_torch.expr import logical as L
from ballista_tpu_torch.tpch import gen_all

QDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "queries"


def test_shared_callable_dedupes_and_bounds(monkeypatch):
    tracecache.clear()
    built = []

    def build():
        built.append(1)
        return lambda x: x + 1

    f1 = tracecache.shared_callable(("t", 1), build)
    f2 = tracecache.shared_callable(("t", 1), build)
    assert f1 is f2 and len(built) == 1
    assert tracecache.shared_callable(("t", 2), build) is not f1
    assert len(built) == 2
    monkeypatch.setattr(tracecache, "_MAX_ENTRIES", 2)
    tracecache.shared_callable(("t", 3), build)
    assert tracecache.cache_len() == 2
    # the oldest went: asking again builds it anew
    tracecache.shared_callable(("t", 1), build)
    assert len(built) == 4
    tracecache.clear()
    assert tracecache.cache_len() == 0


def _small_tables():
    n = 4000
    rng = np.random.default_rng(3)
    return {
        "t": pa.table({
            "k": pa.array(rng.integers(0, 50, n)),
            "v": pa.array(rng.uniform(0, 1, n)),
            "s": pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)]),
        }),
        "d": pa.table({
            "id": pa.array(np.arange(50, dtype=np.int64)),
            "grp": pa.array((np.arange(50) % 7).astype(np.int64)),
        }),
    }


SQL = (
    "SELECT grp, SUM(v) AS sv, COUNT(*) AS c FROM t JOIN d ON k = id "
    "WHERE v < 0.9 AND s <> 'c' GROUP BY grp ORDER BY grp"
)


def test_no_rebuild_on_second_identical_submission():
    """An identical second submission on a FRESH plan instance (as an
    executor-decoded task plan is) builds no closure: every Filter and
    Projection callable comes from the shared cache."""
    ctx = TorchContext(device="cpu")
    ref = TpuContext()
    for name, t in _small_tables().items():
        ctx.register_table(name, t)
        ref.register_table(name, t)
    first = ctx.sql(SQL).collect()
    ctx._physical_cache.clear()
    with metrics.delta() as d:
        again = ctx.sql(SQL).collect()
    assert d.value.get("jit_cache_misses", 0) == 0, d.value
    assert d.value.get("jit_cache_hits", 0) > 0, d.value
    assert first.to_pydict() == again.to_pydict()
    want = ref.sql(SQL).collect().to_pandas()
    got = again.to_pandas()
    assert list(got["grp"]) == list(want["grp"]) and list(got["c"]) == list(want["c"])
    np.testing.assert_allclose(got["sv"], want["sv"], rtol=1e-9)


def test_distributed_resubmission_reuses_callables():
    """Across the standalone cluster: the executor decodes a fresh plan
    per task, and the repeat job hits the shared cache instead of
    rebuilding; the executor's poll carries the counters into the
    scheduler's REST state."""
    from ballista_tpu_torch.scheduler.rest import scheduler_state

    ctx = BallistaContext.standalone(device="cpu")
    try:
        rng = np.random.default_rng(5)
        n = 3000
        ctx.register_table("t", pa.table({
            "k": pa.array(rng.integers(0, 20, n)),
            "v": pa.array(rng.uniform(0, 1, n)),
        }))
        sql = "SELECT k, SUM(v) AS s FROM t WHERE v < 0.8 GROUP BY k"
        r1 = ctx.sql(sql).collect()
        with metrics.delta() as d:
            r2 = ctx.sql(sql).collect()
        assert d.value.get("jit_cache_misses", 0) == 0, d.value
        assert d.value.get("jit_cache_hits", 0) > 0, d.value
        key = lambda t: t.to_pandas().sort_values("k").reset_index(drop=True)  # noqa: E731
        assert key(r1).equals(key(r2))
        state = scheduler_state(ctx._standalone_cluster.scheduler)
        assert state["executors"], "no executors registered"
        compile_metrics = state["executors"][0]["compile"]
        assert float(compile_metrics.get("jit_cache_hits", 0)) > 0, compile_metrics
    finally:
        ctx.close()


@pytest.fixture(scope="module")
def tpch():
    tables = gen_all(0.005, 42)
    port = TorchContext(device="cpu")
    ref = TpuContext()
    for name, t in tables.items():
        port.register_table(name, t)
        ref.register_table(name, t)
    return port, ref


@pytest.mark.parametrize("q", ["q1", "q3"])
def test_fresh_plans_on_the_shared_cache_match_the_reference(tpch, q):
    port, ref = tpch
    sql = (QDIR / f"{q}.sql").read_text()
    want = ref.sql(sql).collect().to_pandas()
    port.sql(sql).collect()
    port._physical_cache.clear()
    with metrics.delta() as d:
        got = port.sql(sql).collect().to_pandas()
    assert d.value.get("jit_cache_misses", 0) == 0 and d.value.get("jit_cache_hits", 0) > 0, d.value
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for c in want.columns:
        if pd.api.types.is_float_dtype(want[c]):
            np.testing.assert_allclose(got[c].to_numpy(float), want[c].to_numpy(float), rtol=1e-9)
        else:
            assert list(got[c]) == list(want[c]), c


def test_two_devices_never_share_a_closure(tpch):
    """The key holds the device: a CPU context's Filter callable and the
    same plan's callable for a second device key are two callables, and a
    join's residual filter is keyed by its batch's device too."""
    port, _ = tpch
    plan = port.create_physical_plan(port.sql_to_logical(
        "SELECT l_orderkey FROM lineitem WHERE l_quantity < 10"
    ))

    def filters(p):
        from ballista_tpu_torch.exec.pipeline import FilterExec

        if isinstance(p, FilterExec):
            yield p
        for c in p.children():
            yield from filters(c)

    f = next(filters(plan))
    cpu = f.batch_fn("cpu")
    assert f.batch_fn("cpu") is cpu
    other = f.batch_fn("cuda:1")
    assert other is not cpu
    assert f._cache_key("cpu") != f._cache_key("cuda:1")
    assert f._cache_key("cpu")[:3] == f._cache_key("cuda:1")[:3]
    # and back: the instance follows the device it is asked for
    assert f.batch_fn("cpu") is cpu
    assert tracecache.expr_key(None) is None
    assert tracecache.expr_key(L.Column("x")) == tracecache.expr_key(L.Column("x"))


CONCURRENT_IMPORTS = r"""
import sys
import threading

import torch  # noqa: F401  (the heavy imports a process has before its threads)

mods = sys.argv[1:]
barrier = threading.Barrier(len(mods))
errors = []


def go(m):
    barrier.wait()
    try:
        __import__(m)
    except Exception as e:  # noqa: BLE001
        errors.append(f"{m}: {type(e).__name__}: {e}")


threads = [threading.Thread(target=go, args=(m,)) for m in mods]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
print(errors)
sys.exit(1 if errors else 0)
"""


def test_threads_importing_the_package_at_once():
    """The analysis gate's analyzers import the port from threads at once;
    the shared callable cache is imported by the pipeline, so a cycle
    through ``compilecache/__init__.py`` (its eager imports) surfaced as an
    ImportError of a partially initialized module in some runs. Fresh
    processes, eight threads each, every import succeeds."""
    mods = [
        "ballista_tpu_torch.compilecache.registry", "ballista_tpu_torch.exec.pipeline",
        "ballista_tpu_torch.compilecache.prewarm", "ballista_tpu_torch.exec.context",
        "ballista_tpu_torch.compilecache.hints", "ballista_tpu_torch.exec.joins",
        "ballista_tpu_torch.analysis.devlint", "ballista_tpu_torch.compilecache.tracecache",
    ]
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    for _ in range(3):
        proc = subprocess.run(
            [sys.executable, "-c", CONCURRENT_IMPORTS, *mods], cwd=root,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.parametrize("change", ["register_again", "clear_and_register"])
def test_a_udf_registered_again_is_not_served_from_the_cache(change):
    """A compiled expression captures the body of each UDF it calls, so a
    UDF name registered again (or a cleared table) must build anew: the
    second query runs the new body at the projection, the filter and a
    join's residual filter, whose closures all come from the shared
    cache."""
    from ballista_tpu_torch.plugin import global_registry

    tables = _small_tables()
    ctx = TorchContext(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    sqls = (
        "SELECT udf_scale(v) AS x FROM t WHERE udf_scale(v) > 0.5",
        "SELECT COUNT(*) AS c FROM t JOIN d ON k = id AND udf_scale(v) > 0.5",
    )
    v = tables["t"].column("v").to_numpy()
    k = tables["t"].column("k").to_numpy()
    try:
        global_registry.register("udf_scale", lambda x: x * 2.0, min_args=1)
        first = [ctx.sql(s).collect() for s in sqls]
        if change == "clear_and_register":
            global_registry.clear()
        global_registry.register("udf_scale", lambda x: x * 3.0, min_args=1)
        ctx._physical_cache.clear()
        second = [ctx.sql(s).collect() for s in sqls]
    finally:
        global_registry.clear()
    for factor, (proj, join) in ((2.0, first), (3.0, second)):
        want = v * factor
        want = want[want > 0.5]
        got = proj.column("x").to_numpy()
        np.testing.assert_array_equal(np.sort(got), np.sort(want))
        live = (k < 50) & (v * factor > 0.5)
        assert join.column("c").to_pylist() == [int(live.sum())]
