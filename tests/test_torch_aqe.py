"""Adaptive query execution of the port (``ballista_tpu_torch/scheduler/
aqe.py``) held against the reference's (``ballista_tpu/scheduler/aqe.py``).

The cases of ``tests/test_aqe.py``: the strategy store, its persistence
through the plan-hint file, the decision rules and the spec plumbing run
the same inputs through both packages; the adaptive loop runs the same
seeded tables, session and query on the reference's standalone cluster
and the port's (executors on the CPU), and the port must make the
reference's decisions (op, source, outcome, stage ids, failing clause)
and rewrite its stage plans to the reference's ``display()``. Results:
AQE on against AQE off within the certificate's class (counts and keys
exact, floats within rtol 1e-9; bit for bit where nothing was rewritten),
and the port against the reference the same way."""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.scheduler import aqe as ref_aqe
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.scheduler import aqe

# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: in a parallel test run every worker's intra-op
    pool would oversubscribe the cores (see test_torch_repartition.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_store(monkeypatch):
    """The strategy stores are process-wide (the port's and the
    reference's); tests must not see each other's learning, nor a
    ``BALLISTA_AQE`` of another test."""
    monkeypatch.delenv("BALLISTA_AQE", raising=False)
    aqe.reset_store()
    ref_aqe.reset_store()
    yield
    aqe.reset_store()
    ref_aqe.reset_store()


def _skewed_tables(n_fact=120_000, n_dim=400, seed=7):
    """Zipfian int keys + string join keys with the small dim: the
    wrong-side-build / hot-key shapes the policy exists for (the
    reference test's tables)."""
    rng = np.random.default_rng(seed)
    key = np.minimum(rng.zipf(1.5, size=n_fact), 2000).astype(np.int64)
    vocab = np.array([f"s{i}" for i in range(n_dim * 4)])
    fact = pa.table(
        {
            "key": pa.array(key),
            "skey": pa.array(vocab[key % (n_dim * 4)]),
            "v": pa.array(rng.uniform(0, 100, n_fact)),
        }
    )
    dim = pa.table(
        {
            "skey": pa.array([f"s{i}" for i in range(n_dim)]),
            "attr": pa.array((np.arange(n_dim) % 7).astype(np.int64)),
        }
    )
    return {"fact": fact, "dim": dim}


# wrong-side build: dim JOIN fact puts the big fact on the build side of
# the string-keyed collect join
WRONG_BUILD_SQL = (
    "SELECT f.key, count(*) AS c, sum(f.v) AS s "
    "FROM dim d JOIN fact f ON d.skey = f.skey "
    "GROUP BY f.key ORDER BY s DESC LIMIT 20"
)


def _standalone(data, n_executors=1, side="port", **settings):
    s = {"ballista.shuffle.partitions": "4"}
    s.update({k.replace("__", "."): v for k, v in settings.items()})
    if side == "ref":
        from ballista_tpu.client.context import BallistaContext as RefClient
        from ballista_tpu.config import BallistaConfig as RefConfig

        ctx = RefClient.standalone(RefConfig(s), n_executors=n_executors)
    else:
        from ballista_tpu_torch.client.context import BallistaContext

        ctx = BallistaContext.standalone(BallistaConfig(s), n_executors=n_executors, device="cpu")
    for name, t in data.items():
        ctx.register_table(name, t)
    return ctx


def _latest_job(sched):
    with sched._lock:
        return max(sched.jobs.values(), key=lambda j: j.submitted_s)


def _decisions(job) -> list:
    """The comparable part of a job's AQE decisions, sorted: stages that
    run side by side finish in either order, and each StageFinished
    records its own decisions."""
    return sorted((d["op"], d["source"], d["outcome"], tuple(d["stage_ids"]), d["clause"]) for d in job.aqe_decisions)


def _plans(job) -> dict:
    return {sid: s.plan.display().replace(job.job_id, "JOB") for sid, s in sorted(job.stages.items())}


def _frames_close(a, b, exact=False):
    cols = list(a.columns)
    a = a.sort_values(cols).reset_index(drop=True)
    b = b.sort_values(cols).reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b, check_exact=exact, **({} if exact else {"rtol": 1e-9}))


def _runs(side: str, data, sql: str, n: int, n_executors=1, **settings):
    """``n`` runs of ``sql`` on a fresh cluster of ``side``: (result frame,
    the job's decisions, its rewrite counts, its stage plans) each."""
    ctx = _standalone(data, n_executors=n_executors, side=side, **settings)
    sched = ctx._standalone_cluster.scheduler
    out = []
    try:
        for _ in range(n):
            r = ctx.sql(sql).collect().to_pandas()
            j = _latest_job(sched)
            out.append((r, _decisions(j), (j.total_rewrites, j.total_rewrite_rejects), _plans(j)))
    finally:
        ctx.close()
    return out


# ---------------------------------------------------------------------------
# unit: strategy store
# ---------------------------------------------------------------------------


def _store_script(mod) -> list:
    """The reference test's sequence of store operations; returns what each
    step answered."""
    s = mod.StrategyStore()
    out = [s.get("cls")]
    out.append(s.learn("cls", ("split", 3, 8, 1000)))
    out.append(s.learn("cls", ("flip", 2, 0)))
    # same-family/same-stage replacement: coalesce retires the split
    out.append(s.learn("cls", ("coalesce", 3, 1)))
    out.append(s.get("cls"))
    # the nosplit tombstone retires bucket strategies for its stage
    out.append(s.learn("cls", ("nosplit", 3, 0)))
    out.append(s.get("cls"))
    out.append(s.learn("cls", ("split", 5, 16, 10)))
    out.append(s.get("cls"))
    out.append(s.unlearn("cls", ("flip", 2, 0)))
    out.append(s.unlearn("cls", ("flip", 2, 0)))
    out.append(s.learn("unknown", ("flip", 1, 0)))
    out.append(s.learn("overflow", ("flip", 1, 0)))
    out.append(s.learn("cls", ("split", 5, 32, 10)))
    out.append(s.get("cls"))
    s.deny("cls", "coalesce", 9)
    out.append(s.is_denied("cls", "split", 9))
    out.append(s.learn("cls", ("split", 9, 8, 1)))
    out.append(s.learn("cls", ("flip", 9, 0)))
    out.append(s.get("cls"))
    out.append(s.classes())
    return out


def test_store_learn_get_unlearn_families():
    got = _store_script(aqe)
    assert got == _store_script(ref_aqe)
    assert got[0] == ()
    assert got[1] and got[2] and got[3]
    assert ("coalesce", 3, 1) in got[4] and ("flip", 2, 0) in got[4]
    assert not any(sp[0] == "split" for sp in got[4])
    assert got[6] == (("flip", 2, 0), ("nosplit", 3, 0))
    assert got[7] and len(got[8]) == 3
    assert got[9] and not got[10]
    # unknown/overflow classes never learn (label-cardinality discipline)
    assert not got[11] and not got[12]
    assert got[13] and sum(1 for sp in got[14] if sp[1] == 5) == 1
    # the deny ledger: a certificate-rejected (family, stage) never
    # re-learns; other families are unaffected
    assert got[15] and not got[16] and got[17]


def test_store_persists_through_hint_seam(tmp_path, monkeypatch):
    """Learned strategies survive a process restart via plan_hints.json —
    the fresh-process-plans-adaptively story."""
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", str(tmp_path))
    s1 = aqe.StrategyStore()
    s1.load_once()
    s1.learn("abcd1234", ("flip", 2, 0))
    s1.learn("abcd1234", ("split", 3, 8, 500))
    s1.learn("ffff0000", ("coalesce", 4, 1))
    # a FRESH store (fresh process) reads them back
    s2 = aqe.StrategyStore()
    assert s2.get("abcd1234") == ()  # not loaded yet
    s2.load_once()
    assert s2.get("abcd1234") == (("flip", 2, 0), ("split", 3, 8, 500))
    assert s2.get("ffff0000") == (("coalesce", 4, 1),)
    # unlearn persists too
    s2.unlearn("ffff0000", ("coalesce", 4, 1))
    s3 = aqe.StrategyStore()
    s3.load_once()
    assert s3.get("ffff0000") == ()
    assert s3.get("abcd1234") == (("flip", 2, 0), ("split", 3, 8, 500))
    # the reference's store reads the same entries from the port's file:
    # the ("aqe", <class>) keys and spec tuples round-trip as literals
    ref = ref_aqe.StrategyStore()
    ref.load_once()
    assert ref.get("abcd1234") == s3.get("abcd1234")


def test_store_save_keeps_the_files_other_families(tmp_path, monkeypatch):
    """The hint file is shared with the executors' capacity hints and plan
    caches: a strategy save merges under it and never rolls back what the
    file's other owners persisted, before or after the store loaded."""
    from ballista_tpu_torch.compilecache import hints

    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", str(tmp_path))
    owner = hints.HintStore()
    hint = {"agg_capacity": 1 << 20, "site_capacity": {("join", 3): 1 << 18}}
    cache = {("join_flag", "abc"): True}
    assert owner.save_if_changed(hint, cache)
    s = aqe.StrategyStore()
    s.load_once()
    # the store keeps only its own families in memory
    assert all(k[0] in ("aqe", "aqe_deny") for k in s._cache) and s._hint == {}
    # another owner persists more after the store loaded
    hint2 = {"agg_capacity": 1 << 22, "site_capacity": {("join", 3): 1 << 19}}
    assert hints.HintStore().save_if_changed(hint2, {("join_flag", "def"): False})
    s.learn("cls", ("flip", 2, 0))
    s.deny("cls", "coalesce", 4)
    back_hint, back_cache = {}, {}
    hints.HintStore().load_once(back_hint, back_cache)
    assert back_hint["agg_capacity"] == 1 << 22
    assert back_hint["site_capacity"] == {("join", 3): 1 << 19}
    assert back_cache[("join_flag", "abc")] is True and back_cache[("join_flag", "def")] is False
    assert back_cache[("aqe", "cls")] == (("flip", 2, 0),)
    assert back_cache[("aqe_deny", "cls")] == (("buckets", 4),)


def test_store_off_hint_cache_is_process_local(monkeypatch):
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", "off")
    s1 = aqe.StrategyStore()
    s1.load_once()
    s1.learn("cls", ("flip", 1, 0))
    s2 = aqe.StrategyStore()
    s2.load_once()
    assert s2.get("cls") == ()


# ---------------------------------------------------------------------------
# unit: decision rules + spec plumbing
# ---------------------------------------------------------------------------


def test_decide_bucket_strategy_rules():
    MB = 1024 * 1024
    cases = [
        # skew: one bucket 10x the median -> split, growth bounded
        ({0: (100_000, 10 * MB), 1: (10_000, MB), 2: (10_000, MB), 3: (10_000, MB)}, 4, 4.0, 4096, 16),
        # tiny balanced buckets -> coalesce toward the target
        ({i: (1000, 64 * 1024) for i in range(8)}, 8, 4.0, 4096, 16),
        # balanced, right-sized -> nothing
        ({i: (1_000_000, 64 * MB) for i in range(4)}, 4, 4.0, 4096, 16),
        # below the skew noise floor -> no split
        ({0: (3000, MB), 1: (10, MB), 2: (10, MB), 3: (10, MB)}, 4, 4.0, 4096, 0),
        # degenerate inputs decide nothing
        ({}, 4, 4.0, 0, 16),
        ({0: (1, 1)}, 1, 4.0, 0, 16),
        # split respects the absolute bucket ceiling
        ({0: (10_000_000, MB), **{i: (10, 1) for i in range(1, 32)}}, 32, 2.0, 0, 0),
    ]
    got = [aqe.decide_bucket_strategy(*c) for c in cases]
    assert got == [ref_aqe.decide_bucket_strategy(*c) for c in cases]
    assert got[0][0] == "split" and 4 < got[0][1] <= 4 * aqe.SPLIT_MAX_FACTOR
    assert got[1] == ("coalesce", 1)
    assert got[2] is None and got[3] is None and got[4] is None and got[5] is None
    assert got[6][0] == "split" and got[6][1] <= aqe.SPLIT_BUCKET_CAP
    # the thresholds are the reference's
    for name in ("FLIP_FACTOR", "FLIP_EST_FACTOR", "FLIP_MIN_BUILD_BYTES", "FLIP_MIN_BUILD_ROWS",
                 "SPLIT_MAX_FACTOR", "SPLIT_BUCKET_CAP", "_TRANSIENT_CLAUSES", "_STRUCTURAL_CLAUSES"):
        assert getattr(aqe, name) == getattr(ref_aqe, name), name


def test_spec_describe_and_op_mapping():
    from ballista_tpu_torch import rewrite as rw
    from ballista_tpu_torch.errors import RewriteRejected

    assert aqe._op_from_spec(("flip", 2, 1)) == rw.FlipJoinBuildSide(2, 1)
    assert aqe._op_from_spec(("broadcast", 3, 0)) == rw.SwitchToBroadcast(3, 0)
    assert aqe._op_from_spec(("coalesce", 4, 1)) == rw.CoalesceShufflePartitions(4, 1)
    # extra learned metadata (observed peak) never reaches the op
    assert aqe._op_from_spec(("split", 5, 16, 123456)) == rw.SplitShufflePartitions(5, 16)
    with pytest.raises(RewriteRejected) as e:
        aqe._op_from_spec(("banana", 1, 2))
    assert e.value.clause == "op-applicability"
    for spec in (("flip", 2, 1), ("broadcast", 3, 0), ("coalesce", 4, 1), ("split", 5, 16, 9), ("nosplit", 3, 0)):
        assert f"stage={spec[1]}" in aqe.spec_describe(spec)
        assert aqe.spec_describe(spec) == ref_aqe.spec_describe(spec)
        if spec[0] != "nosplit":
            assert aqe._op_from_spec(spec).describe() == ref_aqe._op_from_spec(spec).describe()


def test_env_override(monkeypatch):
    on = BallistaConfig({"ballista.tpu.aqe": "true"})
    off = BallistaConfig()
    assert aqe.enabled(on) and not aqe.enabled(off)
    monkeypatch.setenv("BALLISTA_AQE", "0")
    assert not aqe.enabled(on)  # the ops kill-switch wins
    monkeypatch.setenv("BALLISTA_AQE", "on")
    assert aqe.enabled(off)
    monkeypatch.setenv("BALLISTA_AQE", "")
    assert aqe.enabled(on) and not aqe.enabled(off)
    for v in ("0", "off", "false", "1", "on", "true", "", "maybe"):
        monkeypatch.setenv("BALLISTA_AQE", v)
        assert aqe.env_override() == ref_aqe.env_override(), v


def test_estimate_subtree_bytes(tmp_path):
    import pyarrow.parquet as papq

    from ballista_tpu_torch.datatypes import DataType, Field, Schema
    from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec
    from ballista_tpu_torch.exec.pipeline import FilterExec
    from ballista_tpu_torch.exec.scan import MemoryScanExec, ParquetScanExec
    from ballista_tpu_torch.expr import logical as L

    schema = Schema([Field("a", DataType.INT64, False)])
    t = pa.table({"a": pa.array(np.arange(1000, dtype=np.int64))})
    scan = MemoryScanExec(t, schema)
    assert aqe.estimate_subtree_bytes(scan, {}) == t.nbytes
    u = UnresolvedShuffleExec(7, schema, 2, 2)
    assert aqe.estimate_subtree_bytes(u, {7: {"bytes": 555}}) == 555
    # unknowable leaf -> None (a wrong estimate must disable, not steer)
    assert aqe.estimate_subtree_bytes(u, {}) is None
    # operators pass their inputs' sum through; file scans their file size
    f = FilterExec(scan, L.BinaryExpr(L.Column("a"), L.Operator.GT, L.Literal.infer(3)))
    assert aqe.estimate_subtree_bytes(f, {}) == t.nbytes
    path = tmp_path / "a.parquet"
    papq.write_table(t, path)
    pq = ParquetScanExec(str(path), schema)
    assert aqe.estimate_subtree_bytes(pq, {}) == path.stat().st_size


# ---------------------------------------------------------------------------
# integration: the adaptive loop on a standalone cluster
# ---------------------------------------------------------------------------


def test_adaptive_loop_learns_then_applies_and_surfaces():
    """The full loop on the wrong-side-build join, on the port's cluster
    and the reference's: run 1 flips IN-JOB at StageFinished (eager off
    keeps the rewrite window open), run 2 applies the learned strategies
    from submission. The port's decisions and rewritten stage plans equal
    the reference's; its REST payloads, timeline markers, Prometheus
    families and history record surface the decisions."""
    from ballista_tpu_torch.obs import prometheus as prom
    from ballista_tpu_torch.scheduler import rest

    # big enough to clear the reactive flip's 1MB build floor
    data = _skewed_tables(n_fact=300_000)
    settings = dict(ballista__tpu__aqe="true", ballista__tpu__eager_shuffle="false")
    want = _runs("ref", data, WRONG_BUILD_SQL, 2, n_executors=2, **settings)
    ctx = _standalone(data, n_executors=2, **settings)
    sched = ctx._standalone_cluster.scheduler
    try:
        r1 = ctx.sql(WRONG_BUILD_SQL).collect().to_pandas()
        j1 = _latest_job(sched)
        assert _decisions(j1) == want[0][1]
        assert _plans(j1) == want[0][3]
        # run 1: the reactive flip applied mid-job, before the join
        # stage was promoted
        assert j1.total_rewrites >= 1
        flips = [d for d in j1.aqe_decisions if d["op"] == "flip" and d["outcome"] == "applied"]
        assert flips and flips[0]["source"] == "reactive"
        assert flips[0]["before"]["build_bytes"] > flips[0]["before"]["probe_bytes"]
        # and the class learned strategies for next time
        specs = aqe.strategy_store().get(j1.query_class)
        assert any(sp[0] == "flip" for sp in specs)

        r2 = ctx.sql(WRONG_BUILD_SQL).collect().to_pandas()
        j2 = _latest_job(sched)
        assert j2.job_id != j1.job_id
        assert _decisions(j2) == want[1][1]
        assert _plans(j2) == want[1][3]
        assert (j2.total_rewrites, j2.total_rewrite_rejects) == want[1][2]
        # run 2: learned strategies applied at submission
        applied = [d for d in j2.aqe_decisions if d["outcome"] == "applied"]
        assert applied and all(d["source"] == "learned" for d in applied)
        assert j2.total_rewrites == len(applied) >= 1
        _frames_close(r1, r2)  # multiset-exact certificate class
        _frames_close(r2, want[1][0])  # the reference's result
        assert r1["c"].tolist() == want[0][0]["c"].tolist()

        # REST surfaces: /api/job carries the decision logs
        detail = rest.job_detail(sched, j2.job_id)
        assert [d["op"] for d in detail["aqe"]] == [d["op"] for d in j2.aqe_decisions]
        assert detail["rewrite_log"] and all(
            r["outcome"] == "applied" and r["rewritten"] for r in detail["rewrite_log"]
        )
        # timeline marks rewritten stages
        tl = rest.job_timeline(sched, j2.job_id)
        marked = {t["stage_id"] for t in tl["tasks"] if t["rewritten"]}
        assert marked == set(j2.rewritten_stages) and marked
        # Prometheus: the AQE family + the rewrite totals, parser-valid
        text = prom.render(prom.scheduler_families(sched))
        prom.validate_exposition(text)
        assert 'ballista_aqe_rewrites_total{op="flip",outcome="applied"}' in text
        totals = {
            line.split(" ")[0]: float(line.split(" ")[1])
            for line in text.splitlines()
            if line.startswith(("ballista_plan_rewrites_total", "ballista_plan_rewrite_rejects_total"))
        }
        assert totals["ballista_plan_rewrites_total"] >= 2
        # history: the terminal record carries the adaptation tally
        rows = {r["job_id"]: r for r in sched.history.jobs()}
        assert rows[j2.job_id]["aqe_applied"] == len(applied)
        assert rows[j2.job_id]["aqe_rejected"] == 0
    finally:
        ctx.close()


def test_aqe_off_is_inert_and_env_kill_switch(monkeypatch):
    """aqe=false applies nothing even with a seeded store, and
    BALLISTA_AQE=0 overrides a session that asked for it; the results are
    bit for bit those of a run that adapted nothing."""
    data = _skewed_tables(n_fact=30_000)
    results = []
    for case in ("config_off", "env_kill"):
        aqe.reset_store()
        if case == "env_kill":
            monkeypatch.setenv("BALLISTA_AQE", "0")
            ctx = _standalone(data, ballista__tpu__aqe="true")
        else:
            monkeypatch.delenv("BALLISTA_AQE", raising=False)
            ctx = _standalone(data)
        sched = ctx._standalone_cluster.scheduler
        try:
            ctx.sql(WRONG_BUILD_SQL).collect()
            j1 = _latest_job(sched)
            # seed a strategy for the query's class: any application
            # would bump total_rewrites
            aqe.strategy_store().learn(j1.query_class, ("coalesce", j1.final_stage_id, 1))
            results.append(ctx.sql(WRONG_BUILD_SQL).collect().to_pandas())
            j2 = _latest_job(sched)
            assert j2.total_rewrites == 0
            assert j2.total_rewrite_rejects == 0
            assert j2.aqe_decisions == []
        finally:
            ctx.close()
            monkeypatch.delenv("BALLISTA_AQE", raising=False)
    _frames_close(results[0], results[1], exact=True)


def test_q15_float_equality_guard_exercised_by_policy():
    """The policy LEARNS a coalesce from q15's tiny buckets, PROPOSES it
    on the next submission, and the certificate's float-sensitivity
    clause REJECTS it — the job completes BIT-exactly on the pristine
    template, the rejected strategy is unlearned and denied, and the
    third run settles. Every run's decisions equal the reference's."""
    import pathlib

    from ballista_tpu_torch.tpch import gen_all

    qdir = pathlib.Path(__file__).resolve().parent.parent / "benchmarks/queries"
    sql = (qdir / "q15.sql").read_text()
    data = gen_all(0.01, 42)

    base_ctx = _standalone(data)
    try:
        base = base_ctx.sql(sql).collect().to_pandas()
    finally:
        base_ctx.close()
    assert len(base) > 0
    want = _runs("ref", data, sql, 3, ballista__tpu__aqe="true")

    ctx = _standalone(data, ballista__tpu__aqe="true")
    sched = ctx._standalone_cluster.scheduler
    try:
        r1 = ctx.sql(sql).collect().to_pandas()
        j1 = _latest_job(sched)
        assert _decisions(j1) == want[0][1]
        _frames_close(r1, base, exact=True)
        learned = aqe.strategy_store().get(j1.query_class)
        assert any(sp[0] == "coalesce" for sp in learned)

        ctx.sql(sql).collect()
        j2 = _latest_job(sched)
        assert _decisions(j2) == want[1][1]
        rejected = [d for d in j2.aqe_decisions if d["outcome"] == "rejected"]
        assert rejected, j2.aqe_decisions
        clauses = {d["clause"] for d in rejected}
        assert "float-sensitivity" in clauses, clauses
        assert j2.total_rewrite_rejects >= 1
        # nothing accepted: the job ran on the pristine templates
        assert j2.total_rewrites == 0
        assert _plans(j2) == _plans(j1)
        # rejected learned strategies are unlearned AND denied
        store = aqe.strategy_store()
        after = store.get(j2.query_class)
        for d in rejected:
            assert not any(sp[0] == d["op"] and sp[1] in d["stage_ids"] for sp in after)
            assert any(store.is_denied(j2.query_class, d["op"], sid) for sid in d["stage_ids"])
        from ballista_tpu_torch.scheduler import rest

        detail = rest.job_detail(sched, j2.job_id)
        assert any(r["outcome"] == "rejected" and r.get("clause") for r in detail["rewrite_log"])
        # run 3: the class has SETTLED — nothing proposed, nothing rejected
        r3 = ctx.sql(sql).collect().to_pandas()
        j3 = _latest_job(sched)
        assert j3.total_rewrites == 0
        assert j3.total_rewrite_rejects == 0
        assert j3.aqe_decisions == [] == want[2][1], j3.aqe_decisions
        _frames_close(r3, base, exact=True)
    finally:
        ctx.close()


@pytest.mark.parametrize("n_executors", [1, 2])
def test_policy_vs_certificate_disagreement(n_executors):
    """A policy that PROPOSES an illegal rewrite must log a rejection with
    its clause and complete bit-exactly on the pristine template — one
    and two executors. The seeded strategies are structurally wrong on
    purpose (a split of a consumer with no keyed producers, a flip of a
    stage with no eligible join): the certificate, not the policy, is the
    safety boundary. The reference rejects the same with the same
    clauses."""
    data = _skewed_tables(n_fact=30_000)
    off_ctx = _standalone(data, n_executors=n_executors)
    try:
        base = off_ctx.sql(WRONG_BUILD_SQL).collect().to_pandas()
    finally:
        off_ctx.close()

    quiet = dict(
        ballista__tpu__aqe="true",
        # keep the genuine rules quiet so ONLY the seeded illegal
        # proposals act
        ballista__tpu__aqe_target_partition_mb="0",
        ballista__tpu__aqe_broadcast_threshold_mb="0",
        ballista__tpu__skew_ratio="0",
    )
    decided = {}
    for side, mod in (("ref", ref_aqe), ("port", aqe)):
        ctx = _standalone(data, n_executors=n_executors, side=side, **quiet)
        sched = ctx._standalone_cluster.scheduler
        try:
            ctx.sql(WRONG_BUILD_SQL).collect()
            j1 = _latest_job(sched)
            store = mod.strategy_store()
            store.learn(j1.query_class, ("split", j1.final_stage_id, 8, 1))
            store.learn(j1.query_class, ("flip", 1, 0))
            got = ctx.sql(WRONG_BUILD_SQL).collect().to_pandas()
            j2 = _latest_job(sched)
            decided[side] = _decisions(j2)
            if side == "port":
                rejected = [d for d in j2.aqe_decisions if d["outcome"] == "rejected"]
                assert len(rejected) == 2, j2.aqe_decisions
                assert all(d["clause"] == "op-applicability" for d in rejected)
                assert j2.total_rewrites == 0
                assert j2.total_rewrite_rejects == 2
                # pristine template served the job: BIT-exact
                _frames_close(got, base, exact=True)
                # both bogus strategies self-healed away
                assert store.get(j2.query_class) == ()
        finally:
            ctx.close()
    assert decided["port"] == decided["ref"]


def test_input_skew_flags_final_stage_before_completion():
    """The final stage's input-bucket skew must be flagged at the LAST
    StageFinished — when its producers complete — not first at job
    completion, with the reference's flags, and the flag comes from the
    pre-run input pass: a ``skew`` trace span with ``source: input`` and
    the final stage's id (``ballista.tpu.trace`` on), as the reference's
    test reads it."""
    rng = np.random.default_rng(3)
    n = 60_000
    # a JOIN, not a groupby: a partitioned join's input buckets carry the
    # raw Zipfian mass — the hot key's bucket is hot
    key = np.minimum(rng.zipf(1.7, size=n), 500).astype(np.int64)
    data = {
        "fact": pa.table({"key": pa.array(key), "v": pa.array(rng.uniform(0, 1, n))}),
        "hdim": pa.table(
            {"key": pa.array(np.arange(1, 501, dtype=np.int64)),
             "attr": pa.array((np.arange(500) % 9).astype(np.int64))}
        ),
    }
    from ballista_tpu.obs import trace as ref_trace
    from ballista_tpu_torch.obs import trace

    sql = "SELECT f.key, h.attr, f.v FROM fact f JOIN hdim h ON f.key = h.key"
    flags = {}
    trace_of = {"ref": ref_trace, "port": trace}
    for side in ("ref", "port"):
        ctx = _standalone(
            data, side=side, ballista__tpu__skew_ratio="2", ballista__tpu__skew_min_rows="64",
            ballista__tpu__trace="on",  # the span-attr proof below
        )
        sched = ctx._standalone_cluster.scheduler
        at_completion = {}
        orig = sched._on_job_finished

        def spy(job_id, sched=sched, orig=orig, at_completion=at_completion):
            job = sched._get_job(job_id)
            if job is not None:
                with sched._lock:
                    at_completion[job_id] = list(job.skew_flags)
            return orig(job_id)

        sched._on_job_finished = spy
        try:
            # no aggregate/sort above the join: the TERMINAL stage is the
            # partitioned join itself, reading the keyed hash buckets
            ctx.sql(sql).collect()
            job = _latest_job(sched)
            final = job.final_stage_id
            flagged = at_completion[job.job_id]
            assert any(sid == final for sid, _ in flagged), (
                f"{side}: final-stage input skew was not flagged before job completion: {flagged}"
            )
            # and the flag came from the pre-run input pass (trace proof)
            spans = [sp for sp in job.spans.values() if sp.name == "skew"]
            assert any(
                sp.attrs.get("source") == "input" and sp.attrs.get("stage_id") == final for sp in spans
            ), (side, [sp.attrs for sp in spans])
            flags[side] = sorted(flagged)
        finally:
            sched._on_job_finished = orig
            ctx.close()
            # the session's trace setting configured the process-wide
            # recorder: turn it off for the tests after this one
            trace_of[side].configure("off")
    assert [sid for sid, _ in flags["port"]] == [sid for sid, _ in flags["ref"]]


def test_explain_analyze_narration():
    """EXPLAIN ANALYZE prints the aqe narration row: class token +
    learned strategies, as the reference's does."""
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.exec.planner import PhysicalPlanner
    from ballista_tpu_torch.obs.qclass import plan_class
    from ballista_tpu_torch.plan.optimizer import optimize

    t = pa.table({"a": pa.array(np.arange(100, dtype=np.int64)), "v": pa.array(np.arange(100, dtype=np.float64))})
    sql = "SELECT a, sum(v) FROM t GROUP BY a"
    ctx, ref = TorchContext(device="cpu"), TpuContext()
    for c in (ctx, ref):
        c.register_table("t", t)

    def aqe_row(c):
        out = c.sql(f"EXPLAIN ANALYZE {sql}").collect().to_pydict()
        return dict(zip(out["plan_type"], out["plan"]))["aqe"]

    # aqe off + nothing learned: the cheap line (no second planning pass
    # is paid on a profiling verb for nothing to say)
    assert "aqe=off: no learned strategies" in aqe_row(ctx)
    assert aqe_row(ctx) == aqe_row(ref)
    # seed a strategy for this query's distributed class and re-narrate
    phys = PhysicalPlanner(
        ctx, ctx.config.default_shuffle_partitions(), config=ctx.config, distributed=True
    ).plan(optimize(ctx.sql_to_logical(sql)))
    qclass = plan_class(phys)
    for mod in (aqe, ref_aqe):
        mod.strategy_store().learn(qclass, ("coalesce", 2, 1))
    row = aqe_row(ctx)
    assert f"aqe=off class={qclass}" in row
    assert "would apply coalesce(stage=2, n=1)" in row
    # the class token is the reference's: its store, seeded the same, narrates the same line
    assert row == aqe_row(ref)


def test_history_rest_payload_carries_aqe_counts():
    """GET /api/history rows (and system.queries' REST source) carry the
    aqe_applied/aqe_rejected tally; JSON-serializable end to end."""
    data = _skewed_tables(n_fact=30_000)
    ctx = _standalone(data, ballista__tpu__aqe="true")
    sched = ctx._standalone_cluster.scheduler
    try:
        ctx.sql(WRONG_BUILD_SQL).collect()
        ctx.sql(WRONG_BUILD_SQL).collect()
        j2 = _latest_job(sched)
        rows = sched.history_payload("queries")
        by_id = {r["job_id"]: r for r in rows}
        applied = sum(1 for d in j2.aqe_decisions if d["outcome"] == "applied")
        assert by_id[j2.job_id]["aqe_applied"] == applied >= 1
        json.dumps(rows)  # REST-serializable
        from ballista_tpu_torch.scheduler import rest

        json.dumps(rest.job_detail(sched, j2.job_id))
        json.dumps(rest.job_timeline(sched, j2.job_id))
    finally:
        ctx.close()


def test_fresh_store_applies_learned_strategies_at_first_submission(tmp_path, monkeypatch):
    """A new scheduler over the same hint directory (the process store
    dropped, so it re-reads the file) applies what an earlier cluster
    learned at its first submission of the class."""
    monkeypatch.setenv("BALLISTA_TPU_HINT_CACHE", str(tmp_path))
    data = _skewed_tables(n_fact=30_000)
    base = None
    for round_ in range(2):
        aqe.reset_store()
        ctx = _standalone(data, ballista__tpu__aqe="true")
        sched = ctx._standalone_cluster.scheduler
        try:
            got = ctx.sql(WRONG_BUILD_SQL).collect().to_pandas()
            j = _latest_job(sched)
        finally:
            ctx.close()
        if round_ == 0:
            base = got
            learned = [d for d in j.aqe_decisions if d["outcome"] == "learned"]
            assert learned and j.total_rewrites == 0
        else:
            applied = [d for d in j.aqe_decisions if d["outcome"] == "applied"]
            assert applied and all(d["source"] == "learned" for d in applied)
            assert j.total_rewrites == len(applied)
            _frames_close(got, base)
    assert (tmp_path / "plan_hints.json").exists()
