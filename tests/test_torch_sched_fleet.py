"""The mixed fleet, reversed: the port's scheduler with one port executor
and one reference executor, on the CPU.

This process runs the port's ``SchedulerServer`` (pull-staged) and one
port ``Executor(device="cpu")`` with its Arrow Flight service and
``PollLoop``. A subprocess runs one reference ``Executor`` over a
``TpuContext`` holding the same TPC-H tables (each package's own
``gen_all(SCALE, 42)``), its Flight service and its ``PollLoop``, polling
the port's scheduler. Even partitions and one-task stages go to the port
executor and odd ones to the reference's (a filter on the port
scheduler's pending-task pick; the scheduler's code is unchanged), so
every multi-task stage runs on both engines, and each engine reads what
the other wrote.

q1, q3, q5, q12 and q18 run with the session defaults (eager shuffle, push
shuffle and the local fast path on) and with all three off, and each
result equals the reference's ``TpuContext`` as
``tests/test_tpch_distributed.py`` holds it. This is the gate that the
port scheduler's ``TaskDefinition``s, shuffle locations and eager
location polls are the reference's wire format.
"""

import os
import pathlib
import queue
import subprocess
import sys
import threading
import time

import pytest
import torch

from test_torch_stages import query_sql
from test_torch_tpch import cmp

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = 0.002
QUERIES = ["q1", "q3", "q5", "q12", "q18"]
OFF = {
    "ballista.tpu.eager_shuffle": "false",
    "ballista.tpu.push_shuffle": "false",
    "ballista.tpu.shuffle_local_fastpath": "false",
}

SCRIPT = r"""
import sys, tempfile

from ballista_tpu.exec.context import TpuContext
from ballista_tpu.executor.executor import Executor, PollLoop
from ballista_tpu.executor.flight_service import start_flight_server
from ballista_tpu.tpch import gen_all

sched_port, scale = int(sys.argv[1]), float(sys.argv[2])
ctx = TpuContext()
for name, t in gen_all(scale, 42).items():
    ctx.register_table(name, t)
work = tempfile.mkdtemp(prefix="ref-executor-")
ex = Executor("ref-exec", work, provider=ctx)
svc, port, thread = start_flight_server("127.0.0.1", 0, work)
loop = PollLoop(ex, f"127.0.0.1:{sched_port}", "localhost", port, task_slots=2)
loop.start()
print("READY", port, flush=True)
sys.stdin.read()  # until the test closes our stdin
loop.stop()
svc.shutdown()
thread.join(timeout=10)
print("STOPPED", flush=True)
"""


def _pump(proc, lines: queue.Queue) -> None:
    def run():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=run, daemon=True).start()


@pytest.fixture(scope="module")
def fleet():
    from ballista_tpu.exec.context import TpuContext
    from ballista_tpu.tpch import gen_all as ref_gen_all
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.executor import Executor, PollLoop
    from ballista_tpu_torch.executor.flight_service import start_flight_server
    from ballista_tpu_torch.scheduler.server import SchedulerServer, start_scheduler_grpc
    from ballista_tpu_torch.tpch import gen_all

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data = gen_all(SCALE, 42)
    local = TpuContext()
    for name, t in ref_gen_all(SCALE, 42).items():
        assert t.equals(data[name]), name
        local.register_table(name, t)

    server = SchedulerServer(provider=None, expiry_check_interval_s=1.0)
    gs, sched_port = start_scheduler_grpc(server, "127.0.0.1", 0)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", BALLISTA_TPU_HINT_CACHE="off")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(sched_port), str(SCALE)], cwd=ROOT, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: queue.Queue = queue.Queue()
    log: list = []
    _pump(proc, lines)
    work = None
    loop = svc = fthread = None
    clients = []
    try:
        import tempfile

        work = tempfile.mkdtemp(prefix="port-executor-")
        clients = [
            BallistaContext(f"127.0.0.1:{sched_port}", device="cpu"),
            BallistaContext(f"127.0.0.1:{sched_port}", BallistaConfig(OFF), device="cpu"),
        ]
        for c in clients:
            for name, t in data.items():
                c.register_table(name, t)
        server.provider = server.codec.provider = clients[0]
        port_exec = Executor("port-exec", work, provider=clients[0], device="cpu")
        svc, fport, fthread = start_flight_server("127.0.0.1", 0, work)
        loop = PollLoop(port_exec, f"127.0.0.1:{sched_port}", "localhost", fport, task_slots=2)

        # placement: even partitions and one-task stages on the port
        # executor, odd partitions on the reference's
        sm = server.stage_manager
        pending = sm.fetch_pending_tasks

        def placed(job_id, stage_id, max_n, executor_id=""):
            out = pending(job_id, stage_id, 1 << 30, executor_id=executor_id)
            if executor_id:
                n = sm._stages[(job_id, stage_id)].n_tasks
                ref_side = executor_id == "ref-exec"
                out = [p for p in out if (n > 1 and p % 2 == 1) == ref_side]
            return out[:max_n]

        sm.fetch_pending_tasks = placed
        loop.start()
        deadline = time.time() + 180
        while True:
            line = lines.get(timeout=max(0.1, deadline - time.time()))
            if line is None:
                raise AssertionError("the reference executor exited:\n" + "\n".join(log[-40:]))
            log.append(line)
            if line.startswith("READY"):
                break
        while {m.id for m in server.executor_manager.all_executors()} != {"ref-exec", "port-exec"}:
            assert time.time() < deadline, "both executors never polled"
            time.sleep(0.05)
        yield dict(data=data, local=local, clients=clients, server=server, log=log)
    finally:
        for c in clients:
            c.close()
        if loop is not None:
            loop.stop()
        if svc is not None:
            svc.shutdown()
            fthread.join(timeout=10)
        if proc.poll() is None:
            proc.stdin.close()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        server.shutdown()
        gs.stop(grace=None)
        if work is not None:
            import shutil

            shutil.rmtree(work, ignore_errors=True)
        torch.set_num_threads(threads)


def _run(fleet, setting: int, q: str):
    server = fleet["server"]
    sql = query_sql(q, fleet["data"])
    before = set(server.jobs)
    got = fleet["clients"][setting].sql(sql).collect()
    (job_id,) = set(server.jobs) - before
    job = server.jobs[job_id]
    want = fleet["local"].sql(sql).collect()
    assert got.schema.equals(want.schema)
    key = [(c, "ascending") for c in want.column_names]
    cmp(got.sort_by(key).to_pandas(), want.sort_by(key).to_pandas())
    ran = {t["executor_id"] for s in job.stage_stats for t in s["tasks"]}
    assert ran == {"ref-exec", "port-exec"}, ran
    return got, job


@pytest.mark.parametrize("q", QUERIES)
def test_port_scheduler_defaults_match_reference(fleet, q):
    """Eager, push and the local fast path on: the readers of both engines
    poll the port scheduler for published map outputs."""
    _, job = _run(fleet, 0, q)
    polls = sum(
        r["counters"].get("eager_polls", 0)
        for records in job.op_metrics.values() for r in records
        if r["operator"] == "ShuffleReaderExec"
    )
    assert polls > 0, polls


@pytest.mark.parametrize("q", QUERIES)
def test_port_scheduler_every_read_crosses_flight(fleet, q):
    """Eager, push and the local fast path off: every shuffle read and the
    result fetch cross Flight, between the two engines."""
    _, job = _run(fleet, 1, q)
    assert job.eager is False
