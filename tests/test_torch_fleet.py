"""The mixed fleet: the reference's scheduler with one reference executor
and one port executor, on the CPU.

A subprocess runs the reference's ``BallistaContext.standalone()``
(scheduler and one reference executor, pull policy) and prints its
scheduler's port. This process starts a port executor on it:
``Executor(device="cpu")`` over a ``TorchContext(device="cpu")`` holding
the same TPC-H tables (each package's own ``gen_all(SCALE, 42)``, held
equal column by column first), its own Arrow Flight service and its
``PollLoop``. Only once the scheduler sees both executors does the
subprocess run the queries, in two settings:

- (a) the session defaults (eager shuffle, push shuffle and the local fast
  path on): the TPC-H queries;
- (b) eager, push and the local fast path off, so every read crosses
  Flight: q1, q3, q5, q12 and q18.

Each result is held against the reference's ``TpuContext`` as
``tests/test_tpch_distributed.py`` holds it (rows sorted, floats within
rtol 1e-9), with the spec constants that select nothing at this scale
replaced from the data (``tpch.spec_substitutions``), so that every query
returns rows. So that every query runs on both executors, the subprocess
places the tasks of a stage by partition: even partitions and one-task
stages on the port executor, odd ones on the reference's (a filter on the
scheduler's pending-task pick; the scheduler's code is unchanged). For
every query the port executor ran a task, its Flight service served the
reference process, and it fetched from the reference executor's service.
"""

import json
import os
import pathlib
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = 0.002
SETTING_A = ["q1", "q3", "q5", "q6", "q12", "q14", "q15", "q18"] + [
    f"q{i}" for i in (2, 4, 7, 8, 9, 10, 11, 13, 16, 17, 19, 20, 21, 22)
]
SETTING_B = ["q1", "q3", "q5", "q12", "q18"]
OFF = {
    "ballista.tpu.eager_shuffle": "false",
    "ballista.tpu.push_shuffle": "false",
    "ballista.tpu.shuffle_local_fastpath": "false",
}

SCRIPT = r"""
import json, os, pathlib, sys, time

import numpy as np
import pandas as pd

from ballista_tpu.client.context import BallistaContext
from ballista_tpu.config import BallistaConfig
from ballista_tpu.exec.context import TpuContext
from ballista_tpu.tpch import gen_all

spec = json.loads(sys.argv[1])
data = gen_all(spec["scale"], 42)
local = TpuContext()
dist = BallistaContext.standalone(concurrent_tasks=2)
cluster = dist._standalone_cluster
for name, t in data.items():
    local.register_table(name, t)
    dist.register_table(name, t)
ref_id = cluster.executors[0].executor.executor_id

# placement: even partitions and one-task stages on the port executor,
# odd partitions on the reference's
sm = cluster.scheduler.stage_manager
pending = sm.fetch_pending_tasks


def placed(job_id, stage_id, max_n, executor_id=""):
    out = pending(job_id, stage_id, 1 << 30, executor_id=executor_id)
    if executor_id:
        n = sm._stages[(job_id, stage_id)].n_tasks
        mine = executor_id == ref_id
        out = [p for p in out if (n > 1 and p % 2 == 1) == mine]
    return out[:max_n]


sm.fetch_pending_tasks = placed
print("READY", cluster.scheduler_port, cluster.flight_port, ref_id, flush=True)
deadline = time.time() + 120
while len(cluster.scheduler.executor_manager.all_executors()) < 2:
    if time.time() > deadline:
        raise SystemExit("the port executor never polled")
    time.sleep(0.05)


def compare(got, want):
    assert list(got.columns) == list(want.columns), (got.columns, want.columns)
    assert len(got) == len(want), (len(got), len(want))
    if len(want):
        wk = want.sort_values(list(want.columns)).reset_index(drop=True)
        gk = got.sort_values(list(got.columns)).reset_index(drop=True)
        for c in want.columns:
            a, b = gk[c], wk[c]
            if pd.api.types.is_float_dtype(b):
                np.testing.assert_allclose(
                    a.to_numpy(dtype=float), b.to_numpy(dtype=float), rtol=1e-9, atol=1e-12
                )
            else:
                assert list(a) == list(b), c


for setting, settings, queries in spec["runs"]:
    ctx = dist if not settings else BallistaContext(f"localhost:{cluster.scheduler_port}", BallistaConfig(settings))
    for name, t in data.items():
        if ctx is not dist:
            ctx.register_table(name, t)
    submit = ctx._stub.ExecuteQuery
    jobs = []

    def execute_query(req, *a, _submit=submit, **kw):
        res = _submit(req, *a, **kw)
        if req.HasField("logical_plan"):
            jobs.append(res.job_id)
        return res

    ctx._stub.ExecuteQuery = execute_query
    for q in queries:
        sql = spec["sql"][q]
        t0 = time.time()
        rec = {"setting": setting, "q": q}
        try:
            want = local.sql(sql).collect().to_pandas()
            got = ctx.sql(sql).collect().to_pandas()
            rec["rows"] = len(want)
            compare(got, want)
            rec["ok"] = True
        except Exception as e:  # one line a query, keep going
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {str(e)[:600]}"
        rec["job"] = jobs[-1] if jobs else ""
        rec["s"] = round(time.time() - t0, 3)
        print("RESULT " + json.dumps(rec), flush=True)
    if ctx is not dist:
        ctx.close()
dist.close()
print("DONE", flush=True)
"""


class _Counts:
    """Per-job counts of the port executor: tasks run, Flight serves, and
    fetches from the reference executor's and from its own service."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tasks: dict = {}
        self.served: dict = {}
        self.fetched_ref: dict = {}
        self.fetched_self: dict = {}

    def add(self, what: dict, job: str) -> None:
        with self.lock:
            what[job] = what.get(job, 0) + 1


def _reader_thread(proc, lines: queue.Queue) -> threading.Thread:
    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def _next_line(lines: queue.Queue, deadline: float, log: list) -> str | None:
    while True:
        left = deadline - time.time()
        if left <= 0:
            raise AssertionError("the reference fleet timed out:\n" + "\n".join(log[-40:]))
        try:
            line = lines.get(timeout=left)
        except queue.Empty:
            continue
        if line is not None:
            log.append(line)
        return line


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    import ballista_tpu.tpch as ref_tpch
    import ballista_tpu_torch.client.flight as port_flight
    from ballista_tpu_torch.exec.context import TorchContext
    from ballista_tpu_torch.executor.executor import Executor, PollLoop
    from ballista_tpu_torch.executor.flight_service import BallistaFlightService, _parse_action
    from ballista_tpu_torch.tpch import gen_all, spec_substitutions

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data = gen_all(SCALE, 42)
    ref_data = ref_tpch.gen_all(SCALE, 42)
    assert sorted(data) == sorted(ref_data)
    for name, t in data.items():
        want = ref_data[name]
        assert t.schema.equals(want.schema), name
        for col in t.column_names:
            assert t.column(col).equals(want.column(col)), (name, col)
    provider = TorchContext(device="cpu")
    for name, t in data.items():
        provider.register_table(name, t)

    counts = _Counts()

    class CountingService(BallistaFlightService):
        def do_get(self, context, ticket):
            counts.add(counts.served, _parse_action(ticket.ticket).fetch_partition.job_id)
            return super().do_get(context, ticket)

        def do_exchange(self, context, descriptor, reader, writer):
            counts.add(counts.served, _parse_action(descriptor.command).fetch_partition.job_id)
            return super().do_exchange(context, descriptor, reader, writer)

    sqls = {}
    for q in SETTING_A:
        sqls[q] = (ROOT / "benchmarks" / "queries" / f"{q}.sql").read_text()
        for old, new in spec_substitutions(q, data).items():
            sqls[q] = sqls[q].replace(old, new)
    spec = {"scale": SCALE, "sql": sqls, "runs": [["a", {}, SETTING_A], ["b", OFF, SETTING_B]]}
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", BALLISTA_TPU_HINT_CACHE="off")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps(spec)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: queue.Queue = queue.Queue()
    log: list = []
    _reader_thread(proc, lines)
    work = tmp_path_factory.mktemp("port-executor")
    svc = loop = serve = None
    real_fetch = port_flight.fetch_partition_batches, port_flight.fetch_push_batches
    try:
        deadline = time.time() + 180
        line = _next_line(lines, deadline, log)
        while line is not None and not line.startswith("READY"):
            line = _next_line(lines, deadline, log)
        assert line is not None, "the reference fleet exited:\n" + "\n".join(log[-40:])
        _, sched_port, ref_flight_port, ref_id = line.split()
        ref_flight_port = int(ref_flight_port)

        svc = CountingService("grpc://127.0.0.1:0", str(work))
        serve = threading.Thread(target=svc.serve, daemon=True, name="flight-server")
        serve.start()

        def counted(real):
            def fetch(loc, *a, **kw):
                if loc.port == ref_flight_port:
                    counts.add(counts.fetched_ref, loc.job_id)
                elif loc.port == svc.port:
                    counts.add(counts.fetched_self, loc.job_id)
                yield from real(loc, *a, **kw)

            return fetch

        port_flight.fetch_partition_batches = counted(real_fetch[0])
        port_flight.fetch_push_batches = counted(real_fetch[1])
        executor = Executor("port-exec", str(work), provider=provider, device="cpu")
        run_task = executor.execute_shuffle_write

        def execute_shuffle_write(task):
            counts.add(counts.tasks, task.task_id.job_id)
            return run_task(task)

        executor.execute_shuffle_write = execute_shuffle_write
        loop = PollLoop(executor, f"127.0.0.1:{sched_port}", "localhost", svc.port, task_slots=2)
        loop.start()

        results = {}
        deadline = time.time() + 900
        while True:
            line = _next_line(lines, deadline, log)
            if line is None or line == "DONE":
                break
            if line.startswith("RESULT "):
                rec = json.loads(line[len("RESULT "):])
                results[(rec["setting"], rec["q"])] = rec
        assert line == "DONE", "the reference fleet exited early:\n" + "\n".join(log[-60:])
        assert proc.wait(timeout=60) == 0, "\n".join(log[-60:])
        yield dict(results=results, counts=counts, ref_id=ref_id, log=log)
    finally:
        port_flight.fetch_partition_batches, port_flight.fetch_push_batches = real_fetch
        if loop is not None:
            loop.stop()
        if svc is not None:
            svc.shutdown()
            serve.join(timeout=10)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        torch.set_num_threads(threads)


def _check(fleet, setting, q):
    rec = fleet["results"].get((setting, q))
    assert rec is not None, f"no result for {q} in setting {setting}"
    assert rec["ok"], rec
    c, job = fleet["counts"], rec["job"]
    assert job and c.tasks.get(job, 0) >= 1, (q, "the port executor ran no task")
    assert c.served.get(job, 0) > c.fetched_self.get(job, 0), (q, "the port served no fetch of the reference")
    assert c.fetched_ref.get(job, 0) >= 1, (q, "the port fetched nothing from the reference executor")
    return rec


@pytest.mark.parametrize("q", SETTING_A)
def test_fleet_defaults_match_reference(fleet, q):
    """Setting (a): eager, push and the local fast path on."""
    _check(fleet, "a", q)


@pytest.mark.parametrize("q", SETTING_B)
def test_fleet_every_read_crosses_flight(fleet, q):
    """Setting (b): eager, push and the local fast path off, so every
    shuffle read and the result fetch cross Flight."""
    _check(fleet, "b", q)


def test_fleet_tables_are_equal_column_by_column():
    """The two packages' generators give the same tables at the fleet's
    scale (the fleet fixture asserts it before it starts, too)."""
    import ballista_tpu.tpch as ref_tpch
    from ballista_tpu_torch.tpch import gen_all

    got, want = gen_all(SCALE, 42), ref_tpch.gen_all(SCALE, 42)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].equals(want[name]), name
        assert np.all([got[name].column(c).equals(want[name].column(c)) for c in want[name].column_names])
