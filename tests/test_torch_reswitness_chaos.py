"""The port's resource witness under chaos, the counterpart of
``tests/test_reswitness_chaos.py``: a two-executor port cluster on the CPU
runs TPC-H q3 with injected fetch faults (``ballista_tpu_torch/testing/
faults.py``) and an executor killed mid-query, under
``BALLISTA_RESOURCE_WITNESS=1`` in a subprocess. Lost-shuffle recovery
takes every tracked acquisition path: channels dialled again, fetch pools
torn down mid-stream, memory maps and files of abandoned streams, the
retried tasks' spills and queues. At the end the tracker must report no
live resource, and the replay witness, riding the same run, no hash
mismatch across the kill's retries and recomputes.

Marked ``chaos``: the fault rules and the witness are on in the
subprocess only; ``tests/conftest.py`` keeps the test process inert."""

import pathlib
import subprocess
import sys

import pytest

SCRIPT = r"""
import pathlib
import threading
import time

from ballista_tpu_torch.analysis import replay, reswitness
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.testing import faults
from ballista_tpu_torch.tpch import gen_all

assert reswitness.enabled(), "BALLISTA_RESOURCE_WITNESS must reach here"
# the replay witness rides the same chaos run: the kill and retries below
# must record identical content hashes again
replay.enable()

faults.install(
    [{"point": "fetch_error", "partition": 0, "attempt": [0, 1], "max_fires": 2},
     # stretch the shuffle phase so that the mid-query kill window is wide
     {"point": "fetch_slow", "delay_s": 0.05}],
    seed=7,
)

cfg = BallistaConfig({
    "ballista.tpu.fetch_backoff_ms": "10",
    "ballista.shuffle.partitions": "2",
    # real shuffle stages: no shuffle output to lose means no
    # recovery-path resource churn to witness
    "ballista.tpu.collective_shuffle": "false",
    # eager consumers may hold the survivor's slots while their producers
    # are requeued: a short eager wait frees them (ROADMAP queue 3)
    "ballista.tpu.eager_wait_s": "5",
})
ctx = BallistaContext.standalone(
    cfg, n_executors=2, executor_timeout_s=2.0, expiry_check_interval_s=0.5, device="cpu",
)
cluster = ctx._standalone_cluster
sched = cluster.scheduler
for name, t in gen_all(scale=0.01).items():
    ctx.register_table(name, t)

sql = pathlib.Path("benchmarks/queries/q3.sql").read_text()


def attempt_kill_mid_query():
    result = {}

    def drive():
        result["q3"] = ctx.sql(sql).collect()

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
        t3.join(timeout=120)
        return None  # the query outran the kill window: try again
    victim_idx = next(
        i for i, h in enumerate(cluster.executors) if h.alive and h.executor.executor_id == victim_id
    )
    cluster.kill_executor(victim_idx, lose_shuffle=True)
    cluster.add_executor()
    t3.join(timeout=120)
    assert not t3.is_alive(), "q3 wedged after executor kill"
    assert result["q3"].num_rows > 0, "q3 returned no rows under chaos"
    assert job.status == "completed", (job.status, job.error)
    return job


job = None
for _round in range(3):
    job = attempt_kill_mid_query()
    if job is not None:
        break
assert job is not None, "kill never landed mid-query in 3 rounds"
assert job.total_retries + job.total_recomputes >= 1, "kill left no recovery trace"
ctx.close()
from ballista_tpu_torch.client.flight import close_pool

close_pool()
faults.install(None)

# task threads of the killed executor may still be unwinding: give their
# finally blocks a bounded moment to run
deadline = time.time() + 30
while reswitness.live() and time.time() < deadline:
    time.sleep(0.1)

counts = reswitness.acquired_counts()
# the witness must have seen real churn across kinds, not a vacuous zero
assert counts.get("grpc-channel", 0) >= 3, counts
assert counts.get("fetch-queue", 0) >= 1 or counts.get("thread-pool", 0) >= 1, counts
reswitness.assert_drained()
rcounts = replay.record_counts()
assert rcounts.get("shuffle", 0) > 0, rcounts
replay.assert_clean()
print(f"REPLAY-CHAOS-OK {replay.summary()}")
print(f"RESWITNESS-CHAOS-OK {sorted(counts.items())}")
"""


@pytest.mark.chaos
def test_zero_leaked_resources_under_kill_and_fetch_faults(cpu_mesh_env):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        env={**cpu_mesh_env, "BALLISTA_RESOURCE_WITNESS": "1"},
        capture_output=True,
        text=True,
        timeout=240,
        cwd=str(pathlib.Path(__file__).resolve().parent.parent),
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    assert "REPLAY-CHAOS-OK" in proc.stdout
    assert "RESWITNESS-CHAOS-OK" in proc.stdout
