"""The port's runtime staleness witness
(``ballista_tpu_torch/analysis/stalewitness.py``), the cases of
``tests/test_stalewitness.py``: each mechanics case (deterministic
sampling, the expect/resolve demotion protocol, stale recording, the
value-level fallback, drain accounting, the summary, the Prometheus family)
feeds the same inputs to the reference's witness and to the port's and
asserts equal outcomes, counters, summaries and ``tables_equivalent``
verdicts. ``TorchContext(device="cpu")`` and ``TpuContext`` record equal
counters on the same query sequence at their physical-plan-cache hits,
and both record a seeded stale plan (a cached plan swapped for another
query's) as ``stale``. A sampled result-cache hit on the port's
standalone cluster is demoted to a fresh run whose repopulation
hash-matches. The chaos scenario of ``tests/test_stalewitness_chaos.py``
(an executor killed mid-query, an append, AQE on) runs on the port's
cluster in a subprocess; it is ``slow`` as its reference is, and
``chip_smoke.py`` phase 20 (b) runs it on the card."""

import pathlib
import subprocess
import sys
import time

import pyarrow as pa
import pytest

from ballista_tpu.analysis import stalewitness as ref_witness
from ballista_tpu_torch.analysis import stalewitness

BOTH = (stalewitness, ref_witness)


@pytest.fixture(autouse=True)
def _witness_hygiene():
    for w in BOTH:
        w.reset()
    yield
    for w in BOTH:
        w.enable(False)
        w.set_sample_rate(1.0)
        w.reset()


def held_against_reference(scenario):
    """Run ``scenario(witness)`` on the port's witness and on the
    reference's; their observations must be equal. Returns the port's."""
    got, want = scenario(stalewitness), scenario(ref_witness)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# unit: sampling
# ---------------------------------------------------------------------------


def test_disabled_by_default_and_never_samples():
    def scenario(w):
        return w.enabled(), w.should_sample("c"), w.hit_counts()

    assert held_against_reference(scenario) == (False, False, {})


def test_sampling_is_deterministic_per_cache():
    def scenario(w):
        w.enable()
        first = [w.should_sample("a") for _ in range(5)]
        w.set_sample_rate(0.25)
        picks = [w.should_sample("b") for _ in range(8)]
        w.reset()  # the same stride from a fresh counter reproduces it
        again = [w.should_sample("b") for _ in range(8)]
        w.set_sample_rate(0.0)
        none = [w.should_sample("c") for _ in range(10)]
        return first, picks, again, none, w.hit_counts()

    first, picks, again, none, _ = held_against_reference(scenario)
    assert all(first)
    assert sum(picks) == 2  # every 4th hit, exactly
    assert picks == again
    assert not any(none)


def test_hit_counts_accumulate_even_when_not_sampled():
    def scenario(w):
        w.enable()
        w.set_sample_rate(0.5)
        picks = [w.should_sample("x") for _ in range(4)]
        return picks, w.hit_counts()

    picks, hits = held_against_reference(scenario)
    assert hits == {"x": 4} and sum(picks) == 2


# ---------------------------------------------------------------------------
# unit: expect/resolve/check protocol
# ---------------------------------------------------------------------------


def test_expect_resolve_match_path():
    def scenario(w):
        w.expect("result_cache", ("k",), "h1", version=3)
        pending = w.pending_count()
        w.resolve("result_cache", ("k",), "h1", version=3)
        w.assert_no_stale()
        return pending, w.pending_count(), w.counters(), w.summary()

    pending, after, counts, _ = held_against_reference(scenario)
    assert (pending, after) == (1, 0)
    assert counts == {("result_cache", "match"): 1}


def test_mismatch_records_stale_and_fails_assert():
    def scenario(w):
        w.expect("result_cache", ("k",), "served")
        w.resolve("result_cache", ("k",), "fresh")
        with pytest.raises(AssertionError, match="stale cache hits") as e:
            w.assert_no_stale()
        return w.counters(), w.stale_hits(), str(e.value)

    counts, (rec,), _ = held_against_reference(scenario)
    assert counts == {("result_cache", "stale"): 1}
    assert rec["expected"] == "served" and rec["got"] == "fresh"


def test_resolve_without_pending_is_silent():
    def scenario(w):
        # ordinary repopulation (nothing was served from cache): no check
        w.resolve("result_cache", ("other",), "h")
        return w.counters(), w.pending_count()

    assert held_against_reference(scenario) == ({}, 0)


def test_direct_check_compares_in_hand():
    def scenario(w):
        w.check("physical_plan_cache", "fp", "a", "a")
        w.check("physical_plan_cache", "fp", "a", "b", version=(("t", 1, 3),))
        return w.counters(), w.stale_hits()

    counts, stale = held_against_reference(scenario)
    assert counts == {
        ("physical_plan_cache", "match"): 1,
        ("physical_plan_cache", "stale"): 1,
    }
    assert stale[0]["version"] == repr((("t", 1, 3),))


@pytest.mark.parametrize(
    "fresh, equivalent",
    [
        # row order + last-ULP float shift: equivalent (the certified
        # multiset-exact drift envelope)
        pytest.param({"k": [2, 1], "v": [2.0 * (1 + 1e-15), 1.0]}, True, id="order-and-ulp"),
        # a genuinely different float value: not equivalent
        pytest.param({"k": [1, 2], "v": [1.0, 2.1]}, False, id="float-value"),
        # non-float columns stay bit-exact: no tolerance
        pytest.param({"k": [1, 3], "v": [1.0, 2.0]}, False, id="int-value"),
        # shape drift
        pytest.param({"k": [1], "v": [1.0]}, False, id="rows"),
        pytest.param({"k": [1, 2], "v": [None, 2.0]}, False, id="null"),
    ],
)
def test_tables_equivalent_tolerates_ulp_drift_only(fresh, equivalent):
    served = pa.table({"k": [1, 2], "v": [1.0, 2.0]})
    other = pa.table(fresh, schema=served.schema)
    got = stalewitness.tables_equivalent(served, other)
    assert got == ref_witness.tables_equivalent(served, other) == equivalent


def _resolve_with_payload(w, table_to_ipc, served, fresh):
    w.expect("result_cache", ("k",), "h-served", payload=table_to_ipc(served))
    w.resolve("result_cache", ("k",), "h-fresh", table=fresh)
    return w.counters(), w.pending_count()


@pytest.mark.parametrize(
    "fresh_v, outcome",
    [
        pytest.param([1.0, 2.0 * (1 + 1e-15)], "match", id="certified-float-drift"),
        pytest.param([1.0, 99.0], "stale", id="real-staleness"),
    ],
)
def test_resolve_fallback_against_the_served_payload(fresh_v, outcome):
    """The reference's ``test_resolve_fallback_accepts_certified_float_drift``
    and ``test_resolve_fallback_still_catches_real_staleness``: each
    package's witness decodes the payload its own result cache encoded."""
    from ballista_tpu.scheduler.result_cache import table_to_ipc as ref_to_ipc
    from ballista_tpu_torch.scheduler.result_cache import table_to_ipc

    served = pa.table({"k": [1, 2], "v": [1.0, 2.0]})
    fresh = pa.table({"k": [1, 2], "v": fresh_v})
    got = _resolve_with_payload(stalewitness, table_to_ipc, served, fresh)
    assert got == _resolve_with_payload(ref_witness, ref_to_ipc, served, fresh)
    assert got == ({("result_cache", outcome): 1}, 0)


def test_zero_checks_must_not_pass_silently():
    def scenario(w):
        with pytest.raises(AssertionError, match="checked nothing") as e:
            w.assert_no_stale()
        w.assert_no_stale(require_checks=False)
        return str(e.value)

    held_against_reference(scenario)


def test_summary_names_outcomes():
    def scenario(w):
        w.check("c", "k", "a", "a")
        w.check("c", "k", "a", "b")
        w.expect("r", ("k",), "h")
        return w.summary()

    s = held_against_reference(scenario)
    assert "2 checks" in s and "c:match=1" in s and "c:stale=1" in s
    assert "1 stale" in s and "1 pending" in s


# ---------------------------------------------------------------------------
# prometheus family (parser-level)
# ---------------------------------------------------------------------------


def test_metrics_family_gated_and_rendered():
    from ballista_tpu.obs import prometheus as ref_prometheus
    from ballista_tpu_torch.obs import prometheus

    def scenario(w, prom):
        off = prom._cache_witness_families()
        w.enable()
        w.check("result_cache", "k", "a", "a")
        w.check("result_cache", "k", "a", "b")
        return off, prom.render(prom._cache_witness_families())

    (off, text) = scenario(stalewitness, prometheus)
    assert (off, text) == scenario(ref_witness, ref_prometheus)
    assert off == []  # witness off -> absent
    assert "# TYPE ballista_cache_witness_checks_total counter" in text
    assert 'ballista_cache_witness_checks_total{cache="result_cache",outcome="match"} 1' in text
    assert 'ballista_cache_witness_checks_total{cache="result_cache",outcome="stale"} 1' in text


# ---------------------------------------------------------------------------
# acceptance: physical-plan cache (local context, in-process)
# ---------------------------------------------------------------------------

T = {"g": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]}
Q_SUM = "select g, sum(v) as s from t group by g order by g"
Q_COUNT = "select g, count(*) as n from t where v > 1.5 group by g order by g"


def _contexts():
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu_torch.exec.context import TorchContext

    return (TorchContext(device="cpu"), stalewitness), (TpuContext(), ref_witness)


def test_physical_plan_cache_hit_witnessed_clean():
    """The same sequence on both contexts: hits of two queries, a
    registration (which empties the cache: a miss), a sampled subset at
    rate 0.5. Every sampled hit plans afresh and hash-matches; the two
    contexts count the same hits, checks and outcomes, and return equal
    rows."""
    observed = []
    for ctx, w in _contexts():
        w.enable()
        ctx.register_table("t", pa.table(T))
        results = [ctx.sql(q).collect() for q in (Q_SUM, Q_SUM, Q_SUM, Q_COUNT, Q_COUNT)]
        assert results[1].equals(results[0]) and results[2].equals(results[0])
        ctx.register_table("t", pa.table(T))
        w.set_sample_rate(0.5)
        results += [ctx.sql(Q_SUM).collect() for _ in range(3)]
        w.assert_no_stale()
        observed.append((w.counters(), w.hit_counts(), [r.to_pylist() for r in results]))
    got, want = observed
    assert got == want
    # hits: Q_SUM 2 + Q_COUNT 1 at rate 1, then 2 at rate 0.5 (the 4th
    # and 5th hits: floor(k/2) crosses at k = 4)
    assert got[0] == {("physical_plan_cache", "match"): 4}
    assert got[1] == {"physical_plan_cache": 5}


def test_seeded_stale_plan_is_recorded_stale():
    """A cached plan swapped for another query's plan under the first
    one's key: the sampled hit's fresh plan renders differently, and both
    packages record one ``stale`` check (and fail ``assert_no_stale``)."""
    counts = []
    for ctx, w in _contexts():
        w.enable()
        ctx.register_table("t", pa.table(T))
        ctx.sql(Q_SUM).collect()
        (k_sum,) = ctx._physical_cache
        ctx.sql(Q_COUNT).collect()
        (k_count,) = set(ctx._physical_cache) - {k_sum}
        ctx._physical_cache[k_sum] = ctx._physical_cache[k_count]
        ctx.sql(Q_SUM).collect()
        with pytest.raises(AssertionError, match="1 stale cache hits"):
            w.assert_no_stale()
        (rec,) = w.stale_hits()
        assert rec["cache"] == "physical_plan_cache" and rec["expected"] != rec["got"]
        counts.append(w.counters())
    assert counts[0] == counts[1] == {("physical_plan_cache", "stale"): 1}


def test_witness_off_plans_once():
    """With the witness off a hit plans nothing: the planner runs once for
    two runs of a query."""
    from ballista_tpu_torch.exec import context as context_mod

    ctx, _ = _contexts()[0]
    ctx.register_table("t", pa.table(T))
    calls = []
    real = context_mod.TorchContext._planner

    def counted(self):
        calls.append(1)
        return real(self)

    context_mod.TorchContext._planner = counted
    try:
        ctx.sql(Q_SUM).collect()
        ctx.sql(Q_SUM).collect()
        assert len(calls) == 1
        stalewitness.enable()
        ctx.sql(Q_SUM).collect()
        assert len(calls) == 2  # the sampled hit planned afresh once
    finally:
        context_mod.TorchContext._planner = real
    assert stalewitness.counters() == {("physical_plan_cache", "match"): 1}


# ---------------------------------------------------------------------------
# acceptance: result cache demotion (the port's standalone cluster)
# ---------------------------------------------------------------------------


def _drain_pending(timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if stalewitness.pending_count() == 0:
            return
        time.sleep(0.02)
    raise AssertionError(f"{stalewitness.pending_count()} demoted hits never resolved")


def test_result_cache_demoted_hit_hash_matches():
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    stalewitness.enable()
    cfg = BallistaConfig({"ballista.shuffle.partitions": "2", "ballista.tpu.result_cache_mb": "16"})
    t = pa.table({"k": [i % 5 for i in range(200)], "v": [float(i) for i in range(200)]})
    sql = "select k, sum(v) as s from t group by k order by k"
    ref = TpuContext()
    ref.register_table("t", t)
    want = ref.sql(sql).collect()
    ctx = BallistaContext.standalone(cfg, device="cpu")
    sched = ctx._standalone_cluster.scheduler
    try:
        ctx.register_table("t", t)
        cold = ctx.sql(sql).collect()
        assert cold.equals(want)
        deadline = time.time() + 10.0
        while sched.result_cache.stats()["entries"] < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert sched.result_cache.stats()["entries"] >= 1
        # sampled hit: demoted to a fresh run, which must still return
        # the correct rows AND repopulate with a matching content hash
        hot = ctx.sql(sql).collect()
        assert hot.equals(cold)
        _drain_pending()
        counts = stalewitness.counters()
        assert counts.get(("result_cache", "match"), 0) >= 1, counts
        stalewitness.assert_no_stale()
    finally:
        ctx.close()


# ---------------------------------------------------------------------------
# chaos: kill, append and AQE on the port's cluster (subprocess)
# ---------------------------------------------------------------------------

CHAOS_SCRIPT = r"""
import pathlib
import threading
import time

from ballista_tpu_torch.analysis import replay, reswitness, stalewitness
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.tpch import gen_all

assert stalewitness.enabled(), "BALLISTA_CACHE_WITNESS must reach here"
assert stalewitness.sample_rate() == 1.0
assert reswitness.enabled(), "BALLISTA_RESOURCE_WITNESS must reach here"
replay.enable()

data = gen_all(scale=0.01)
q3 = pathlib.Path("benchmarks/queries/q3.sql").read_text()
qsum = "select sum(l_quantity) as q from lineitem"

cfg = BallistaConfig({
    "ballista.shuffle.partitions": "2",
    "ballista.tpu.result_cache_mb": "16",
    "ballista.tpu.fetch_backoff_ms": "10",
    # the reference's liveness knobs plus a short eager wait: eager
    # consumers may hold the survivor's slots while their producers are
    # requeued (ROADMAP queue 3)
    "ballista.tpu.eager_wait_s": "5",
    # real shuffle stages (a kill needs shuffle output to lose) and
    # adaptive re-planning on, so accepted rewrites ride every pass
    "ballista.tpu.collective_shuffle": "false",
    "ballista.tpu.aqe": "true",
})
ctx = BallistaContext.standalone(
    cfg, n_executors=2, executor_timeout_s=2.0, expiry_check_interval_s=0.5, device="cpu",
)
for name, t in data.items():
    ctx.register_table(name, t)
cluster = ctx._standalone_cluster
sched = cluster.scheduler


def drain_pending(timeout=60):
    deadline = time.time() + timeout
    while stalewitness.pending_count() and time.time() < deadline:
        time.sleep(0.05)
    assert stalewitness.pending_count() == 0, "demoted hits never resolved"


def wait_entries(n, timeout=30):
    deadline = time.time() + timeout
    while sched.result_cache.stats()["entries"] < n and time.time() < deadline:
        time.sleep(0.05)
    assert sched.result_cache.stats()["entries"] >= n, sched.result_cache.stats()


cold = ctx.sql(q3).collect()
assert cold.num_rows > 0
wait_entries(1)
hot = ctx.sql(q3).collect()  # sampled hit -> demoted -> fresh run
# AQE's certified rewrites may move a float sum's last bits: the drift
# envelope the witness itself allows
assert stalewitness.tables_equivalent(hot, cold)
drain_pending()
assert stalewitness.counters().get(("result_cache", "match"), 0) >= 1, stalewitness.counters()
print("WARM-OK", stalewitness.summary())


def attempt_kill_mid_query():
    result = {}

    def drive():
        result["q3"] = ctx.sql(q3).collect()

    t3 = threading.Thread(target=drive)
    t3.start()
    victim_id = None
    deadline = time.time() + 120
    while time.time() < deadline and victim_id is None:
        for (job_id, stage_id), stage in list(sched.stage_manager._stages.items()):
            for task in stage.tasks:
                if task.state.value == "completed" and task.executor_id:
                    victim_id = task.executor_id
                    break
            if victim_id:
                break
        time.sleep(0.005)
    job = list(sched.jobs.values())[-1]
    if victim_id is None or job.status != "running":
        t3.join(timeout=300)
        return None  # query outran the kill window: retry
    victim_idx = next(
        i for i, h in enumerate(cluster.executors) if h.alive and h.executor.executor_id == victim_id
    )
    cluster.kill_executor(victim_idx, lose_shuffle=True)
    cluster.add_executor()
    t3.join(timeout=300)
    assert not t3.is_alive(), "q3 wedged after executor kill"
    assert job.status == "completed", (job.status, job.error)
    return job, result["q3"]


got = None
for _round in range(3):
    got = attempt_kill_mid_query()
    if got is not None:
        break
assert got is not None, "kill never landed mid-query in 3 rounds"
job, chaos_result = got
assert stalewitness.tables_equivalent(chaos_result, cold)
assert job.total_retries + job.total_recomputes >= 1, "kill left no recovery trace"
drain_pending()
print("KILL-OK", job.total_retries, job.total_recomputes)

before = ctx.sql(qsum).collect().column("q")[0].as_py()
wait_entries(1)
extra = data["lineitem"].slice(0, 50)
ctx.append_table("lineitem", extra)
after = ctx.sql(qsum).collect().column("q")[0].as_py()
expect = before + sum(extra.column("l_quantity").to_pylist())
assert abs(after - expect) < 1e-6, (before, after, expect)
new_q3 = ctx.sql(q3).collect()
wait_entries(1)
again = ctx.sql(q3).collect()  # demoted hit on the post-append key
assert stalewitness.tables_equivalent(again, new_q3)
drain_pending()
print("APPEND-OK", before, "->", after)

counts = stalewitness.counters()
assert counts.get(("result_cache", "match"), 0) >= 3, counts
assert counts.get(("result_cache", "stale"), 0) == 0, stalewitness.stale_hits()
stalewitness.assert_no_stale()
print("WITNESS-OK", stalewitness.summary())

ctx.close()
from ballista_tpu_torch.client.flight import close_pool

close_pool()
deadline = time.time() + 30
while reswitness.live() and time.time() < deadline:
    time.sleep(0.1)
reswitness.assert_drained()
replay.assert_clean()
print("STALE-CHAOS-OK")
"""


@pytest.mark.chaos
@pytest.mark.slow  # as its reference is; the card runs the scenario (chip_smoke.py phase 20 b)
def test_zero_stale_hits_under_kill_append_and_aqe(cpu_mesh_env):
    proc = subprocess.run(
        [sys.executable, "-c", CHAOS_SCRIPT],
        env={**cpu_mesh_env, "BALLISTA_CACHE_WITNESS": "1", "BALLISTA_RESOURCE_WITNESS": "1"},
        capture_output=True,
        text=True,
        timeout=420,
        cwd=str(pathlib.Path(__file__).resolve().parent.parent),
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    for marker in ("WARM-OK", "KILL-OK", "APPEND-OK", "WITNESS-OK", "STALE-CHAOS-OK"):
        assert marker in proc.stdout, f"missing {marker}\nstdout:\n{proc.stdout}"
