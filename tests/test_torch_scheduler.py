"""The port's scheduler state machine, event loop and state backends
against the reference's, on the CPU.

- Seeded sequences in the forms of ``tests/test_stage_manager_properties.py``
  (random status updates, bounded retry cycles, executor loss, lost-shuffle
  invalidation, demote and promote, handouts) go to both packages'
  ``StageManager`` step by step; after every step the task, stage and job
  states, the events and the handouts are equal.
- The cases of ``tests/test_event_loop.py`` run through the port's
  ``EventLoop``.
- The backend key-value contract, sqlite reopen and watch, and the
  scheduler restart of ``tests/test_persistent_state.py``: a port cluster's
  job over a sqlite backend is recovered by a new port scheduler and by a
  new reference scheduler alike.
- The port's declared transition tables are the reference's.
- The keys whose features this slice ports are honoured.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu.scheduler.stage_manager as ref_sm
import ballista_tpu.scheduler_types as ref_types
import ballista_tpu_torch.event_loop as el
import ballista_tpu_torch.scheduler.stage_manager as port_sm
import ballista_tpu_torch.scheduler_types as port_types
from ballista_tpu_torch.event_loop import EventAction, EventLoop
from ballista_tpu_torch.scheduler.state_backend import MemoryBackend, SqliteBackend

SIDES = ((ref_sm, ref_types), (port_sm, port_types))
JOB = "job"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- StageManager: both packages, step by step ------------------------------


def _event(e) -> tuple:
    return (type(e).__name__,) + tuple(dataclasses.astuple(e))


def _snapshot(sm_mod, sm) -> tuple:
    out = []
    for key in sorted(sm._stages):
        stage = sm._stages[key]
        state = (
            "completed" if sm.is_completed_stage(*key)
            else "running" if sm.is_running_stage(*key)
            else "pending"
        )
        tasks = tuple(
            (t.state.value, t.attempts, t.executor_id, t.error, tuple(sorted(t.blamed)),
             tuple((m.partition_id, m.path, m.num_rows, m.push) for m in t.partitions))
            for t in stage.tasks
        )
        out.append((key, state, stage.recomputes, stage.max_attempts, tasks))
    return tuple(out), sm.inflight_tasks(), sm.final_stage(JOB)


def _ops(seed: int, kind: str, n_stages: int) -> list:
    """A seeded operation sequence; the same list drives both sides."""
    rng = random.Random(seed)
    ops = []
    for _ in range(rng.randint(10, 40)):
        stage = rng.randint(1, n_stages)
        part = rng.randrange(4)
        eid = f"e{rng.randrange(3)}"
        x = rng.random()
        if kind == "updates":
            state = rng.choice(["pending", "running", "failed", "completed"])
            ops.append(("status", stage, part, state, eid, "boom", True, True))
        elif kind == "retries":
            if x < 0.35:
                ops.append(("status", stage, part, "running", eid, "", True, True))
            elif x < 0.7:
                ops.append(("status", stage, part, "failed", eid, "boom", rng.random() < 0.9,
                            rng.random() < 0.8))
            elif x < 0.85:
                ops.append(("status", stage, part, "completed", eid, "", True, True))
            else:
                ops.append(("reset", eid))
        else:  # "recovery": the declared-tables sequences, with handouts
            if x < 0.2:
                ops.append(("assign", eid))
            elif x < 0.3:
                ops.append(("assign_many", eid, rng.randint(1, 3)))
            elif x < 0.45:
                ops.append(("status", stage, part, "completed", eid, "", True, True))
            elif x < 0.55:
                ops.append(("status", stage, part, "failed", eid, "boom", True, True))
            elif x < 0.62:
                ops.append(("reset", eid))
            elif x < 0.72:
                ops.append(("invalidate", stage, eid))
            elif x < 0.8:
                ops.append(("demote", stage))
            elif x < 0.88:
                ops.append(("promote", stage))
            elif x < 0.94:
                ops.append(("eager", eid))
            else:
                ops.append(("locations", stage, part))
    return ops


def _apply(sm_mod, types_mod, sm, op) -> tuple:
    kind = op[0]
    if kind == "status":
        _, stage, part, state, eid, error, retryable, count = op
        n = sm._stages[(JOB, stage)].n_tasks
        metas = [types_mod.ShuffleWritePartitionMeta(
            partition_id=part % 2, path=f"/w/{stage}/{part}", num_batches=1, num_rows=part + 1,
            num_bytes=8, push=bool(part % 2),
        )] if state == "completed" else None
        kw = dict(executor_id=eid, error=error if state == "failed" else "")
        if state == "failed":
            kw.update(retryable=retryable, count_attempt=count)
        if metas is not None:
            kw["partitions"] = metas
        events = sm.update_task_status(
            types_mod.PartitionId(JOB, stage, part % n), sm_mod.TaskState(state), **kw
        )
        return tuple(_event(e) for e in events)
    if kind == "assign":
        got = sm.assign_next_task(op[1])
        return None if got is None else got[:4] + (tuple(_event(e) for e in got[4]),)
    if kind == "assign_many":
        return tuple(g[:4] + (tuple(_event(e) for e in g[4]),) for g in sm.assign_next_tasks(op[1], op[2]))
    if kind == "reset":
        return tuple(dataclasses.astuple(p) for p in sm.reset_tasks_of_executors({op[1]}))
    if kind == "invalidate":
        return tuple(
            dataclasses.astuple(p) for p in sm.invalidate_executor_outputs(JOB, op[1], {op[2]})
        )
    if kind == "demote":
        sm.demote_running_stage(JOB, op[1])
        return ()
    if kind == "promote":
        return tuple(_event(e) for e in sm.promote_pending_stage(JOB, op[1]))
    if kind == "eager":
        got = sm.assign_next_eager_task(op[1], {JOB})
        return None if got is None else got[:4] + (tuple(_event(e) for e in got[4]),)
    if kind == "locations":
        snap = sm.shuffle_locations(JOB, op[1], op[2] % 2)
        if snap is None:
            return None
        entries, prefix, complete = snap
        return (tuple((i, e, m.path) for i, e, m in entries), prefix, complete)
    raise AssertionError(op)


def _new(sm_mod, n_stages: int, max_attempts: int):
    sm = sm_mod.StageManager()
    sm.add_running_stage(JOB, 1, 4, max_attempts=max_attempts)
    for s in range(2, n_stages + 1):
        sm.add_pending_stage(JOB, s, 4, max_attempts=max_attempts)
    sm.add_final_stage(JOB, n_stages)
    sm.add_stages_dependency(JOB, {s: {s + 1} for s in range(1, n_stages)})
    return sm


@pytest.mark.parametrize("kind", ["updates", "retries", "recovery"])
@pytest.mark.parametrize("batch", range(5))
def test_stage_manager_sequences_match_reference(kind, batch):
    """40 seeded sequences a case, each on a one- or two-stage job; the
    global ``random`` is seeded alike before every step of both sides (the
    stage pick is a random choice among runnable stages)."""
    for seed in range(batch * 40, batch * 40 + 40):
        n_stages = 1 + seed % 2
        max_attempts = 1 + seed % 3
        sms = [_new(m, n_stages, max_attempts) for m, _ in SIDES]
        for step, op in enumerate(_ops(seed, kind, n_stages)):
            out = []
            for (m, t), sm in zip(SIDES, sms):
                random.seed(seed * 1000 + step)
                out.append((_apply(m, t, sm, op), _snapshot(m, sm)))
            assert out[1] == out[0], (seed, step, op)


def test_stage_manager_tables_govern_port_sequences():
    """The reference's 500 declared-table sequences on the port alone:
    every observed task and stage transition is an edge of the port's
    declared tables (two hops where a requeue or a promote collapses
    them)."""
    from ballista_tpu_torch.analysis.statemachine import STAGE_TRANSITIONS, TASK_TRANSITIONS

    task_legal, stage_legal = set(TASK_TRANSITIONS), set(STAGE_TRANSITIONS)

    def stage_state(sm):
        if sm.is_completed_stage("job", 1):
            return "completed"
        return "running" if sm.is_running_stage("job", 1) else "pending"

    for seed in range(500):
        rng = random.Random(seed)
        sm = port_sm.StageManager()
        n_tasks = rng.randint(1, 4)
        sm.add_running_stage("job", 1, n_tasks, max_attempts=rng.randint(1, 3))
        sm.add_final_stage("job", 9)
        stage = sm.get_stage("job", 1)
        for _ in range(rng.randint(5, 25)):
            before = [t.state.value for t in stage.tasks]
            s_before = stage_state(sm)
            op = rng.random()
            eid = f"e{rng.randrange(2)}"
            pid = port_types.PartitionId("job", 1, rng.randrange(n_tasks))
            if op < 0.25:
                sm.assign_next_task(eid)
            elif op < 0.45:
                sm.update_task_status(pid, port_sm.TaskState.COMPLETED, executor_id=eid, partitions=[])
            elif op < 0.60:
                sm.update_task_status(pid, port_sm.TaskState.FAILED, executor_id=eid, error="boom")
            elif op < 0.70:
                sm.reset_tasks_of_executors({eid})
            elif op < 0.80:
                sm.invalidate_executor_outputs("job", 1, {eid})
            elif op < 0.90:
                sm.demote_running_stage("job", 1)
            else:
                sm.promote_pending_stage("job", 1)
            for b, a in zip(before, [t.state.value for t in stage.tasks]):
                if b != a:
                    assert (b, a) in task_legal or (
                        (b, "failed") in task_legal and ("failed", a) in task_legal
                    ), (seed, b, a)
            s_after = stage_state(sm)
            if s_before != s_after:
                assert (s_before, s_after) in stage_legal or (
                    (s_before, "running") in stage_legal and ("running", s_after) in stage_legal
                ), (seed, s_before, s_after)


def test_assign_next_task_hands_each_partition_out_once():
    sm = port_sm.StageManager()
    sm.add_running_stage("j", 1, 32)
    sm.add_final_stage("j", 1)
    out: list = []
    lock = threading.Lock()

    def worker(i: int):
        while True:
            got = sm.assign_next_task(f"e{i}")
            if got is None:
                return
            with lock:
                out.append(got[:3])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(out) == [("j", 1, i) for i in range(32)]


@pytest.mark.parametrize("table", ["TASK", "STAGE", "JOB"])
def test_transition_tables_are_the_references(table):
    import ballista_tpu.analysis.statemachine as ref
    import ballista_tpu_torch.analysis.statemachine as port

    assert getattr(port, f"{table}_TRANSITIONS") == getattr(ref, f"{table}_TRANSITIONS")
    assert getattr(port, f"{table}_STATES") == getattr(ref, f"{table}_STATES")


# -- EventLoop (tests/test_event_loop.py through the port) ------------------


class _Blocking(EventAction):
    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def on_receive(self, event):
        self.entered.set()
        self.release.wait(timeout=10)
        return None


def test_stop_does_not_deadlock_on_full_queue(monkeypatch):
    monkeypatch.setattr(el, "_BUFFER", 4)
    action = _Blocking()
    loop = EventLoop("t", action)
    loop._q.maxsize = 4
    loop.start()
    loop.post("wedge")
    assert action.entered.wait(timeout=5)
    for i in range(4):
        loop._q.put_nowait(f"e{i}")
    t0 = time.time()
    stopper = threading.Thread(target=loop.stop)
    stopper.start()
    time.sleep(0.1)
    action.release.set()
    stopper.join(timeout=10)
    assert not stopper.is_alive(), "EventLoop.stop() deadlocked"
    assert time.time() - t0 < 10


def test_consumer_thread_posts_survive_full_queue():
    class _Fanout(EventAction):
        def __init__(self):
            self.seen = []
            self.loop = None

        def on_receive(self, event):
            self.seen.append(event)
            if event == "boom":
                for i in range(20):
                    self.loop.post(("child", i))
            return None

    action = _Fanout()
    loop = EventLoop("t3", action)
    loop._q.maxsize = 4
    action.loop = loop
    loop.start()
    loop.post("boom")
    loop.drain(timeout=10)
    assert len([e for e in action.seen if isinstance(e, tuple)]) == 20
    loop.stop()


def test_run_loop_honors_stop_without_sentinel():
    class _Count(EventAction):
        def __init__(self):
            self.n = 0

        def on_receive(self, event):
            self.n += 1
            return None

    action = _Count()
    loop = EventLoop("t2", action)
    loop.start()
    loop.post("a")
    loop.drain()
    assert action.n == 1
    t0 = time.time()
    loop.stop()
    assert time.time() - t0 < 5
    assert loop._thread is not None and not loop._thread.is_alive()


def test_dispatch_lag_hook_sees_every_event():
    class _Nop(EventAction):
        def on_receive(self, event):
            return None

    lags = []
    loop = EventLoop("t4", _Nop())
    loop.lag_cb = lags.append
    loop.start()
    for i in range(5):
        loop.post(i)
    loop.drain(timeout=10)
    loop.stop()
    assert len(lags) == 5 and all(x >= 0 for x in lags)


# -- state backends and restart recovery ------------------------------------


@pytest.mark.parametrize("make", [MemoryBackend, None])
def test_backend_kv_contract(tmp_path, make):
    b = make() if make else SqliteBackend(str(tmp_path / "state.db"))
    assert b.get("/x") is None
    b.put("/ballista/default/jobs/a", b"1")
    b.put("/ballista/default/jobs/b", b"2")
    b.put("/ballista/default/sessions/s", b"3")
    assert b.get("/ballista/default/jobs/a") == b"1"
    assert b.get_from_prefix("/ballista/default/jobs") == [
        ("/ballista/default/jobs/a", b"1"),
        ("/ballista/default/jobs/b", b"2"),
    ]
    b.put("/ballista/default/jobs/a", b"9")
    assert b.get("/ballista/default/jobs/a") == b"9"
    b.delete("/ballista/default/jobs/a")
    assert b.get("/ballista/default/jobs/a") is None
    b.close()


def test_sqlite_survives_reopen(tmp_path):
    path = str(tmp_path / "state.db")
    b = SqliteBackend(path)
    b.put("/k", b"v")
    b.close()
    b2 = SqliteBackend(path)
    assert b2.get("/k") == b"v"
    b2.close()


def test_state_backend_watch(tmp_path):
    for be in (MemoryBackend(), SqliteBackend(str(tmp_path / "kv.db"))):
        w = be.watch("/ballista/jobs/")
        other = be.watch("/ballista/executors/")
        be.put("/ballista/jobs/j1", b"queued")
        be.put("/ballista/tasks/t1", b"x")
        be.put("/ballista/jobs/j1", b"running")
        be.delete("/ballista/jobs/j1")
        e1 = w.get(timeout=1)
        assert (e1.kind, e1.key, e1.value) == ("put", "/ballista/jobs/j1", b"queued")
        assert w.get(timeout=1).value == b"running"
        e3 = w.get(timeout=1)
        assert (e3.kind, e3.value) == ("delete", None)
        assert w.get(timeout=0.05) is None
        assert other.get(timeout=0.05) is None
        w.stop()
        assert w.get(timeout=0.05) is None
        be.close()


def _terminal_counts(history, job_id: str) -> dict:
    """Terminal history records of a job, by kind (the reference's
    ``durwitness.terminal_history_counts``)."""
    counts = {"completed": 0, "failed": 0}
    stamp = history._stamp_of(job_id)
    if stamp is None:
        return counts
    for key, _ in history.backend.get_from_prefix(history._k("jobs", stamp) + "/"):
        kind = key.rsplit("/", 1)[-1]
        if kind in counts:
            counts[kind] += 1
    return counts


def _recovered(job) -> tuple:
    return (
        job.status, job.error, job.final_stage_id,
        tuple(sorted((k, tuple(sorted(v))) for k, v in job.dependencies.items())),
        tuple((l.job_id, l.stage_id, l.partition, l.executor_id, l.path) for l in job.completed_locations),
        tuple((sid, st.plan.display()) for sid, st in sorted(job.stages.items())),
    )


def test_scheduler_restart_recovers_jobs_alike(tmp_path):
    """A port cluster runs a job to completion over a sqlite backend, and a
    job is left in flight. A new port scheduler and a new reference
    scheduler over the same file recover the same jobs (status, error,
    final stage, dependencies, result locations and stage plans, decoded
    by each package's codec), the session and the executors; the job in
    flight comes back failed with one terminal history record."""
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu.scheduler.server import SchedulerServer as RefServer
    from ballista_tpu.scheduler.state_backend import SqliteBackend as RefSqlite
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.scheduler.server import JobInfo, SchedulerServer
    from ballista_tpu_torch.standalone import StandaloneCluster

    path = str(tmp_path / "sched.db")
    cfg = BallistaConfig({"ballista.shuffle.partitions": "2"})
    cluster = StandaloneCluster.start(cfg, 2, state_backend=SqliteBackend(path), device="cpu")
    ctx = BallistaContext(f"localhost:{cluster.scheduler_port}", cfg, device="cpu")
    ctx._standalone_cluster = cluster
    cluster.attach_provider(ctx)
    n = 4000
    t = pa.table({"k": pa.array((np.arange(n) % 9).astype(np.int64)),
                  "v": pa.array(np.random.default_rng(0).uniform(0, 1, n))})
    ctx.register_table("t", t)
    try:
        res = ctx.sql("select k, sum(v) as s from t group by k order by k").collect()
        assert res.num_rows == 9
        sched = cluster.scheduler
        (job_id,) = list(sched.jobs)
        assert sched.jobs[job_id].status == "completed"
        session_id = ctx.session_id
        exec_ids = {m.id for m in sched.state.load_executors()}
        assert exec_ids
        mid = JobInfo(job_id="inflt001", session_id=session_id, status="running")
        with sched._lock:
            sched.jobs[mid.job_id] = mid
        sched.state.save_job(mid)
        sched.history.record_submit(mid.job_id, session_id=session_id)
    finally:
        ctx.close()

    port = SchedulerServer(provider=ctx, state_backend=SqliteBackend(path))
    ref_provider = TpuContext()
    ref_provider.register_table("t", t)
    ref = RefServer(provider=ref_provider, state_backend=RefSqlite(path))
    try:
        assert sorted(port.jobs) == sorted(ref.jobs) == sorted([job_id, "inflt001"])
        for jid in port.jobs:
            assert _recovered(port.jobs[jid]) == _recovered(ref.jobs[jid]), jid
        job = port.jobs[job_id]
        assert job.status == "completed" and job.completed_locations and job.stages
        assert session_id in port.sessions and session_id in ref.sessions
        assert {m.id for m in port.state.load_executors()} == exec_ids
        j = port.jobs["inflt001"]
        assert j.status == "failed" and "restart" in j.error
        assert _terminal_counts(port.history, "inflt001") == {"completed": 0, "failed": 1}
        assert port.result_cache.stats()["entries"] == 0
        st = port.job_status_proto(job_id)
        assert st.WhichOneof("status") == "completed"
        assert len(st.completed.partition_location) == len(job.completed_locations)
    finally:
        port.shutdown()
        ref.shutdown()


def test_inflight_job_fails_loudly_on_restart(tmp_path):
    from ballista_tpu_torch.scheduler.persistent_state import PersistentSchedulerState
    from ballista_tpu_torch.scheduler.server import JobInfo, SchedulerServer

    backend = SqliteBackend(str(tmp_path / "s.db"))
    st = PersistentSchedulerState(backend, "default", None)
    st.save_job(JobInfo(job_id="abc1234", session_id="s1", status="running"))
    st.save_session("s1", {})
    recovered = SchedulerServer(provider=None, state_backend=backend)
    try:
        j = recovered.jobs["abc1234"]
        assert j.status == "failed" and "restart" in j.error
    finally:
        recovered.shutdown()


@pytest.mark.parametrize("src,dst", [("queued", "failed"), ("running", "completed"), ("running", "failed")])
def test_terminal_transition_saves_job_exactly_once(src, dst):
    from types import SimpleNamespace

    from ballista_tpu_torch.analysis.statemachine import JOB_TRANSITIONS
    from ballista_tpu_torch.scheduler.persistent_state import PersistentSchedulerState
    from ballista_tpu_torch.scheduler.server import JobInfo, SchedulerServer

    assert (src, dst) in JOB_TRANSITIONS
    backend = MemoryBackend()
    server = SchedulerServer(provider=None, state_backend=backend)
    try:
        job = JobInfo(job_id="prop0001", session_id="s1", status=src)
        if dst == "completed":
            job.stages = {0: SimpleNamespace(output_partition_count=1)}
        with server._lock:
            server.jobs[job.job_id] = job
        saves = []
        real_save = server.state.save_job
        server.state.save_job = lambda j: (saves.append((j.job_id, j.status)), real_save(j))[-1]
        if dst == "completed":
            server._on_job_finished(job.job_id)
        else:
            server._on_job_failed(job.job_id, "attempts exhausted")
        server.state.save_job = real_save
        assert saves == [("prop0001", dst)], saves
        (row,) = server.state.load_jobs()
        assert row["status"] == dst
        assert PersistentSchedulerState.locations_from_json(row["locations"]) == []
        counts = _terminal_counts(server.history, job.job_id)
        assert counts[dst] == 1 and sum(counts.values()) == 1, counts
    finally:
        server.shutdown()
    recovered = SchedulerServer(provider=None, state_backend=backend)
    try:
        assert recovered.jobs["prop0001"].status == dst
        assert sum(_terminal_counts(recovered.history, "prop0001").values()) == 1
    finally:
        recovered.shutdown()


# -- keys whose features this slice ports -------------------------------------


@pytest.mark.parametrize(
    "key", ["ballista.tpu.verify_plans", "ballista.tpu.cost_accounting", "ballista.tpu.history_retention_jobs"]
)
def test_ported_key_is_honoured(key):
    """A key that used to be refused as unported now reaches its feature:
    the context takes the verifier's switch, a cluster session with cost
    accounting off leaves the job and the history without attempt costs,
    and the retention bound drops the oldest jobs' records."""
    from ballista_tpu_torch.config import _ENTRIES, UNPORTED, BallistaConfig
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.obs.history import CostVector, HistoryStore

    assert key not in UNPORTED
    assert BallistaConfig({key: _ENTRIES[key][0]}).settings()
    if key == "ballista.tpu.verify_plans":
        ctx = TorchContext(BallistaConfig({key: "false"}), device="cpu")
        ctx.register_table("t", pa.table({"g": [1, 2], "v": [1.0, 2.0]}))
        assert ctx.sql("select g from t where v > 1").collect().num_rows == 1
        assert ctx.config.verify_plans() is False
    elif key == "ballista.tpu.cost_accounting":
        from ballista_tpu_torch.client.context import BallistaContext

        ctx = BallistaContext.standalone(BallistaConfig({key: "false"}), device="cpu")
        try:
            ctx.register_table("t", pa.table({"g": [1, 2, 2], "v": [1.0, 2.0, 3.0]}))
            got = ctx.sql("select g, sum(v) as s from t group by g order by g").collect()
            assert got.column("s").to_pylist() == [1.0, 5.0]
            sched = ctx._standalone_cluster.scheduler
            (job,) = sched.jobs.values()
            assert job.status == "completed" and job.cost is None
            assert sched.history.attempts(0) == []
        finally:
            ctx.close()
    else:
        cfg = BallistaConfig({key: "2"})
        store = HistoryStore(MemoryBackend(), "ns", retention_jobs=cfg.history_retention_jobs())
        for i in range(4):
            store.record_submit(f"job{i}", submitted_s=1000.0 + i)
            store.record_terminal(f"job{i}", "completed", submitted_s=1000.0 + i, cost=CostVector())
        assert [r["job_id"] for r in store.jobs(0)] == ["job3", "job2"]
