"""Runtime durability witness of the port
(``ballista_tpu_torch/analysis/durwitness.py``), the cases of
``tests/test_durwitness.py``: the witness mechanics (check recording,
divergence accounting, the zero-checks-proves-nothing rule, the
persisted-entry restart transform, each held against the reference's
witness on the same input), the ``ballista_dur_witness_checks_total``
family (parser-level), a port scheduler killed and restarted on sqlite
and verified over the full declared state inventory (also mid-workload,
with an executor killed), a seeded divergence that fails it, and a
two-scheduler failover over the etcd protocol where every job closes out
exactly once."""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.analysis import durwitness as ref_durwitness
from ballista_tpu_torch.analysis import durreg, durwitness
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.scheduler.server import JobInfo, SchedulerServer
from ballista_tpu_torch.scheduler.state_backend import SqliteBackend
from ballista_tpu_torch.standalone import StandaloneCluster


@pytest.fixture(autouse=True)
def _witness_hygiene():
    durwitness.reset()
    yield
    durwitness.enable(False)
    durwitness.reset()


# ---------------------------------------------------------------------------
# unit: recording + divergence accounting
# ---------------------------------------------------------------------------


def test_disabled_by_default():
    assert not durwitness.enabled()
    assert durwitness.counters() == {}


def test_record_and_counters():
    durwitness.record("job-map", "match")
    durwitness.record("job-map", "match")
    durwitness.record("sessions", "divergent", "lost s1")
    assert durwitness.counters() == {
        ("job-map", "match"): 2,
        ("sessions", "divergent"): 1,
    }
    (d,) = durwitness.divergences()
    assert d == {"field": "sessions", "detail": "lost s1"}


def test_divergence_fails_assert_with_detail():
    durwitness.record("sessions", "divergent", "lost s1")
    with pytest.raises(AssertionError, match="lost s1"):
        durwitness.assert_no_divergence()


def test_zero_checks_must_not_pass_silently():
    with pytest.raises(AssertionError, match="checked nothing"):
        durwitness.assert_no_divergence()
    durwitness.assert_no_divergence(require_checks=False)


def test_clean_checks_pass():
    durwitness.record("job-map", "match")
    durwitness.assert_no_divergence()


def test_summary_names_outcomes():
    durwitness.record("job-map", "match")
    durwitness.record("sessions", "divergent", "x")
    s = durwitness.summary()
    assert "2 checks" in s
    assert "job-map:match=1" in s and "1 divergent" in s


def test_reset_clears_everything():
    durwitness.record("sessions", "divergent", "x")
    durwitness.reset()
    assert durwitness.counters() == {}
    assert durwitness.divergences() == []


# ---------------------------------------------------------------------------
# unit: the declared restart semantics
# ---------------------------------------------------------------------------


def test_expected_persisted_transform_closes_inflight_jobs():
    before = {
        "done": ("completed", 3, ()),
        "mid": ("running", 2, ((1, (0,)),)),
        "new": ("queued", 0, ()),
        "dead": ("failed", 1, ()),
    }
    want = durwitness._expected_persisted("job-record", before)
    assert want["done"] == ("completed", 3, ())
    assert want["mid"] == ("failed", 2, ((1, (0,)),))
    assert want["new"] == ("failed", 0, ())
    assert want["dead"] == ("failed", 1, ())
    # every other persisted entry round-trips identically
    assert durwitness._expected_persisted("sessions", ("s1",)) == ("s1",)


def test_is_empty_shapes():
    assert durwitness._is_empty(0)
    assert durwitness._is_empty(())
    assert durwitness._is_empty((0, 0, 0))
    assert durwitness._is_empty({})
    assert not durwitness._is_empty((0, 1))
    assert not durwitness._is_empty(("a",))
    assert not durwitness._is_empty(3)


def test_restart_semantics_are_the_references():
    """The witness's transform, emptiness rule and rebuilt special cases
    give the reference's results on the same inputs."""
    before = {"a": ("running", 1, ()), "b": ("completed", 2, ((1, (0,)),))}
    for name in ("job-record", "sessions", "stage-plans"):
        assert durwitness._expected_persisted(name, before) == ref_durwitness._expected_persisted(name, before)
    for v in (0, 3, (), (0, 0), (0, 1), ("a",), {}, {"k": 1}, 0.0):
        assert durwitness._is_empty(v) == ref_durwitness._is_empty(v), v
    assert durwitness._REBUILT_EMPTY == ref_durwitness._REBUILT_EMPTY
    assert durwitness._REBUILT_CONVERGE == ref_durwitness._REBUILT_CONVERGE
    assert durwitness.ENV_WITNESS == ref_durwitness.ENV_WITNESS == "BALLISTA_DUR_WITNESS"


def test_witness_covers_every_declared_entry():
    """The witness's rebuilt-class special cases must stay inside the
    registry's vocabulary — a renamed entry would silently drop its
    restart check."""
    names = {e.name for e in durreg.STATE}
    for n in durwitness._REBUILT_EMPTY + durwitness._REBUILT_CONVERGE:
        assert n in names, n


# ---------------------------------------------------------------------------
# prometheus family (parser-level)
# ---------------------------------------------------------------------------


def test_metrics_family_gated_and_rendered():
    from ballista_tpu_torch.obs.prometheus import (
        _dur_witness_families,
        render,
        validate_exposition,
    )

    assert _dur_witness_families() == []  # witness off -> absent
    durwitness.enable()
    text = render(_dur_witness_families())
    validate_exposition(text)
    assert "ballista_dur_witness_checks_total 0" in text  # enabled, idle
    durwitness.record("job-map", "match")
    durwitness.record("sessions", "divergent", "x")
    text = render(_dur_witness_families())
    validate_exposition(text)
    assert "# TYPE ballista_dur_witness_checks_total counter" in text
    assert (
        'ballista_dur_witness_checks_total'
        '{field="job-map",outcome="match"} 1' in text
    )
    assert (
        'ballista_dur_witness_checks_total'
        '{field="sessions",outcome="divergent"} 1' in text
    )


# ---------------------------------------------------------------------------
# acceptance: sqlite restart over the FULL declared inventory
# ---------------------------------------------------------------------------

def _cluster(path: str, partitions: int, n_executors: int = 1):
    cfg = BallistaConfig({"ballista.shuffle.partitions": str(partitions)})
    cluster = StandaloneCluster.start(
        cfg, 4, state_backend=SqliteBackend(path), n_executors=n_executors, device="cpu"
    )
    ctx = BallistaContext(f"localhost:{cluster.scheduler_port}", cfg, device="cpu")
    ctx._standalone_cluster = cluster
    cluster.attach_provider(ctx)
    return cluster, ctx


def _run_and_die(path: str):
    """A port cluster on sqlite runs a job to completion; a second job is
    left running in memory and on the backend (with its history submit
    record), and the scheduler dies holding it. Returns (the dead
    scheduler's snapshot, the completed job's id, the provider)."""
    cluster, ctx = _cluster(path, 2)
    n = 4000
    t = pa.table({"k": pa.array((np.arange(n) % 9).astype(np.int64)),
                  "v": pa.array(np.random.default_rng(0).uniform(0, 1, n))})
    ctx.register_table("t", t)
    try:
        res = ctx.sql("select k, sum(v) as s from t group by k order by k").collect()
        assert res.num_rows == 9
        sched = cluster.scheduler
        done_id = next(iter(sched.jobs))
        assert sched.jobs[done_id].status == "completed"
        mid = JobInfo(job_id="inflt001", session_id=ctx.session_id, status="running")
        with sched._lock:
            sched.jobs[mid.job_id] = mid
        sched.state.save_job(mid)
        sched.history.record_submit(mid.job_id, session_id=mid.session_id)
        durwitness.enable()
        before = durwitness.snapshot(sched)
        assert before["job-record"][mid.job_id][0] == "running"
        assert before["executor-metadata"], "live cluster has executor metadata"
    finally:
        ctx.close()
    return before, done_id, ctx


def test_restart_witness_full_inventory_sqlite(tmp_path):
    path = str(tmp_path / "sched.db")
    before, done_id, provider = _run_and_die(path)
    # restart: a brand-new SchedulerServer over the same backend
    recovered = SchedulerServer(provider=provider, state_backend=SqliteBackend(path))
    try:
        outcomes = durwitness.verify_restart(before, recovered, reregistered=())
        bad = {f: o for f, o in outcomes.items() if o != "match"}
        assert not bad, (bad, durwitness.divergences())
        assert set(outcomes) == {e.name for e in durreg.STATE}
        durwitness.assert_no_divergence()
        assert sum(durwitness.counters().values()) == len(durreg.STATE)
        # in-flight job closed out as a failed terminal record, exactly once
        j = recovered.jobs["inflt001"]
        assert j.status == "failed" and "restart" in j.error
        assert durwitness.terminal_history_counts(
            recovered.history, "inflt001") == {"completed": 0, "failed": 1}
        assert durwitness.terminal_history_counts(
            recovered.history, done_id) == {"completed": 1, "failed": 0}
        assert recovered.result_cache.stats()["entries"] == 0
    finally:
        recovered.shutdown()


@pytest.mark.parametrize("seed", ["ephemeral-survives", "rebuilt-not-converged"])
def test_a_seeded_divergence_fails_the_witness(seed, tmp_path):
    """An ephemeral field that survives the restart (an eager plan
    resolution carried over), or a rebuilt field that does not converge
    (an executor that never re-registered), is a recorded divergence."""
    path = str(tmp_path / "sched.db")
    before, _, provider = _run_and_die(path)
    recovered = SchedulerServer(provider=provider, state_backend=SqliteBackend(path))
    try:
        if seed == "ephemeral-survives":
            fields = ["eager-plan-bytes"]
            with recovered._lock:
                recovered.jobs["inflt001"].eager_plan_bytes[1] = b"stale"
            outcomes = durwitness.verify_restart(before, recovered, reregistered=())
        else:
            fields = ["executor-heartbeats", "executor-slots"]
            outcomes = durwitness.verify_restart(before, recovered, reregistered=("ghost",))
        assert sorted(f for f, o in outcomes.items() if o != "match") == fields
        with pytest.raises(AssertionError, match=fields[0]):
            durwitness.assert_no_divergence()
    finally:
        recovered.shutdown()


# ---------------------------------------------------------------------------
# acceptance (chaos): scheduler killed MID-WORKLOAD + executor kill
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_restart_witness_chaos_midworkload_kill(tmp_path):
    path = str(tmp_path / "sched.db")
    cluster, ctx = _cluster(path, 4, n_executors=2)
    n = 200_000
    t = pa.table({"k": pa.array((np.arange(n) % 997).astype(np.int64)),
                  "v": pa.array(np.random.default_rng(1).uniform(0, 1, n))})
    ctx.register_table("t", t)
    errors = []

    def run():
        try:
            ctx.sql("select k, sum(v) as s, count(*) as c from t "
                    "group by k order by s desc").collect()
        except Exception as e:  # the scheduler dies under it: expected
            errors.append(e)

    worker = threading.Thread(target=run)
    worker.start()
    sched = cluster.scheduler
    deadline = time.time() + 30
    caught_running = False
    while time.time() < deadline:
        with sched._lock:
            if any(j.status == "running" and j.stages for j in sched.jobs.values()):
                caught_running = True
                break
        time.sleep(0.001)
    assert caught_running, "never observed the job mid-flight"
    # concurrent executor kill: the crashed-machine chaos primitive
    cluster.kill_executor(1, lose_shuffle=True)
    # then the scheduler itself dies mid-workload: loops stop, no drain
    for h in cluster.executors:
        if h.alive:
            cluster._stop_executor(h)
    sched.shutdown()
    cluster.scheduler_grpc.stop(grace=None)

    durwitness.enable()
    before = durwitness.snapshot(sched)
    assert any(status in ("queued", "running")
               for status, _f, _d in before["job-record"].values()), (
        "chaos run must snapshot an in-flight job", before["job-record"])
    recovered = SchedulerServer(provider=ctx, state_backend=SqliteBackend(path))
    try:
        outcomes = durwitness.verify_restart(before, recovered, reregistered=())
        bad = {f: o for f, o in outcomes.items() if o != "match"}
        assert not bad, (bad, durwitness.divergences())
        durwitness.assert_no_divergence()
        # exactly-once terminal history for EVERY job, in-flight ones included
        for job_id, job in recovered.jobs.items():
            assert job.status in ("completed", "failed"), (job_id, job.status)
            counts = durwitness.terminal_history_counts(recovered.history, job_id)
            assert sum(counts.values()) == 1, (job_id, counts)
        assert recovered.result_cache.stats()["entries"] == 0
    finally:
        recovered.shutdown()
        worker.join(timeout=30)
        ctx.close()


# ---------------------------------------------------------------------------
# acceptance: two-scheduler etcd-protocol failover
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_two_scheduler_etcd_failover_exactly_once():
    """Scheduler A (over one EtcdBackend client) dies holding a running
    job; scheduler B (a second client against the same 'cluster')
    recovers it. The survivor's watch must have OBSERVED the dead
    scheduler's writes (the property only etcd gives — embedded
    backends cannot see another process's puts), the recovered state
    must match the durability registry, and the job must close out as
    exactly one failed terminal record — stable across a second
    failover."""
    from ballista_tpu_torch.scheduler.etcd_backend import EtcdBackend
    from ballista_tpu_torch.scheduler_types import (
        ExecutorMetadata,
        ExecutorSpecification,
    )
    from tests.test_torch_ops_surface import FakeEtcd, serve_fake_etcd

    server, url = serve_fake_etcd(FakeEtcd())
    closers = []
    try:
        be_a = EtcdBackend(url)
        closers.append(be_a)
        a = SchedulerServer(provider=None, state_backend=be_a)

        # the survivor's client watches the job prefix BEFORE the dead
        # scheduler writes — etcd's watch is the cross-process channel
        be_b = EtcdBackend(url)
        closers.append(be_b)
        watch = be_b.watch("/ballista/default/jobs")

        # scheduler A's control-plane writes: session, executor, a job
        # it will die holding, and the job's history submit record
        sid = a.get_or_create_session("", {})
        meta = ExecutorMetadata(
            id="e1", host="h", port=1, grpc_port=2,
            specification=ExecutorSpecification(task_slots=4),
        )
        a.executor_manager.save_executor_metadata(meta)
        a.persist_executor(meta)
        job = JobInfo(job_id="fail0001", session_id=sid, status="running")
        with a._lock:
            a.jobs[job.job_id] = job
        a.state.save_job(job)
        a.history.record_submit(job.job_id, session_id=sid)

        durwitness.enable()
        before = durwitness.snapshot(a)

        # survivor's watch observed the dead scheduler's job write
        ev = watch.get(timeout=5)
        ok = ev is not None and ev.key.endswith("/jobs/fail0001")
        durwitness.record(
            "failover-watch", "match" if ok else "divergent",
            f"expected a put for fail0001, saw {ev!r}",
        )

        # A dies (no graceful handoff beyond what it already persisted)
        a.shutdown()

        # B takes over on the same etcd: recovery closes the job out
        b = SchedulerServer(provider=None, state_backend=be_b)
        outcomes = durwitness.verify_restart(before, b, reregistered=())
        bad = {f: o for f, o in outcomes.items() if o != "match"}
        assert not bad, (bad, durwitness.divergences())

        j = b.jobs["fail0001"]
        assert j.status == "failed" and "restart" in j.error
        assert sid in b.sessions
        assert b.executor_manager.get_executor_metadata("e1") is not None
        counts = durwitness.terminal_history_counts(b.history, "fail0001")
        durwitness.record(
            "exactly-once-terminal",
            "match" if counts == {"completed": 0, "failed": 1}
            else "divergent",
            f"terminal counts {counts}",
        )
        # B's own close-out write is also visible on the watch channel
        ev2 = watch.get(timeout=5)
        assert ev2 is not None and ev2.key.endswith("/jobs/fail0001")

        # a SECOND failover must not double-record: the job is already
        # terminal, so recovery leaves its single failed record alone
        b.shutdown()
        be_c = EtcdBackend(url)
        closers.append(be_c)
        c = SchedulerServer(provider=None, state_backend=be_c)
        assert c.jobs["fail0001"].status == "failed"
        counts2 = durwitness.terminal_history_counts(c.history, "fail0001")
        assert sum(counts2.values()) == 1, counts2
        c.shutdown()

        durwitness.assert_no_divergence()
        watch.stop()
    finally:
        for be in closers:
            be.close()
        server.stop(grace=None)
