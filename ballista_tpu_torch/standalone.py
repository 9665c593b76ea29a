"""Standalone (in-proc) cluster: scheduler + N executors in one process.

ref ballista/rust/scheduler/src/standalone.rs:34-59 and
ballista/rust/executor/src/standalone.rs:38-93 — the testing backbone
(SURVEY.md §3.5): real gRPC + real Flight over localhost random ports +
temp work dirs, full cluster semantics without a cluster.

``n_executors > 1`` boots additional executors, each with its OWN work dir
and Flight server — the substrate for chaos tests: :meth:`kill_executor`
stops one executor's loops, tears down its Flight service, and (by
default) deletes its shuffle files, exactly what a crashed machine looks
like to the scheduler (heartbeats stop -> expiry sweep; fetches fail ->
lost-shuffle recovery; see docs/fault_tolerance.md).

Port of ``ballista_tpu/standalone.py``: the executors are the port's
``Executor(..., device=device)``, and ``device`` defaults to ``"cuda"``:
without a card :meth:`StandaloneCluster.start` raises unless it is asked
for the CPU (``device="cpu"``). The executors' task threads run torch in
this process beside the scheduler's threads.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import tempfile

from ballista_tpu_torch.columnar.batch import resolve_device
from ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
from ballista_tpu_torch.exec.planner import TableProvider
from ballista_tpu_torch.executor.executor import Executor, PollLoop, new_executor_id
from ballista_tpu_torch.executor.flight_service import start_flight_server
from ballista_tpu_torch.scheduler.server import SchedulerServer, start_scheduler_grpc

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ExecutorHandle:
    """One in-proc executor: core object, task loop, Flight data plane."""

    executor: Executor
    # PollLoop (pull mode) or ExecutorServer (push mode); both expose .stop()
    loop: object
    flight_service: object
    flight_port: int
    work_dir: str
    alive: bool = True
    # the Flight server's serve() thread — joined on stop so repeated
    # start/stop cycles in one process leak no threads
    flight_thread: object = None


@dataclasses.dataclass
class StandaloneCluster:
    scheduler: SchedulerServer
    scheduler_grpc: object
    scheduler_port: int
    executors: list[ExecutorHandle]
    work_dir: str
    _tmp: tempfile.TemporaryDirectory
    device: str = "cuda"

    # -- single-executor compatibility surface -------------------------------
    @property
    def executor(self) -> Executor:
        return self.executors[0].executor

    @property
    def poll_loop(self):
        return self.executors[0].loop

    @property
    def flight_port(self) -> int:
        return self.executors[0].flight_port

    @classmethod
    def start(
        cls,
        config: BallistaConfig | None = None,
        concurrent_tasks: int = 4,
        provider: TableProvider | None = None,
        state_backend=None,
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
        executor_timeout_s: float = 60.0,
        expiry_check_interval_s: float = 15.0,
        n_executors: int = 1,
        device: str = "cuda",
    ) -> "StandaloneCluster":
        # no card, no cluster: fail before any thread or port exists
        resolve_device(device)
        tmp = tempfile.TemporaryDirectory(prefix="ballista-standalone-")
        scheduler = SchedulerServer(
            provider=provider,
            config=config,
            state_backend=state_backend,
            policy=policy,
            executor_timeout_s=executor_timeout_s,
            expiry_check_interval_s=expiry_check_interval_s,
        )
        grpc_server, scheduler_port = start_scheduler_grpc(
            scheduler, "127.0.0.1", 0
        )

        cluster = cls(
            scheduler=scheduler,
            scheduler_grpc=grpc_server,
            scheduler_port=scheduler_port,
            executors=[],
            work_dir=tmp.name,
            _tmp=tmp,
            device=device,
        )
        for i in range(max(1, n_executors)):
            cluster.add_executor(
                concurrent_tasks=concurrent_tasks,
                provider=provider,
                policy=policy,
            )
        return cluster

    def add_executor(
        self,
        concurrent_tasks: int = 4,
        provider: TableProvider | None = None,
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
    ) -> ExecutorHandle:
        """Register one more executor (own work dir + Flight port) — new
        capacity mid-run, or a replacement after :meth:`kill_executor`."""
        idx = len(self.executors)
        work_dir = os.path.join(self.work_dir, f"exec-{idx}")
        os.makedirs(work_dir, exist_ok=True)
        executor = Executor(
            executor_id=new_executor_id(),
            work_dir=work_dir,
            provider=provider if provider is not None
            else self.scheduler.provider,
            device=self.device,
        )
        # in-proc the scheduler verified every stage plan at submission
        # (ballista.tpu.verify_plans) and the executor decodes the very
        # same bytes — skip the per-task re-verification walk. Remote
        # executors keep it: their build may disagree with the
        # scheduler's serde vocabulary.
        executor.verify_decoded_plans = False
        svc, flight_port, flight_thread = start_flight_server(
            "127.0.0.1", 0, work_dir
        )
        if policy == TaskSchedulingPolicy.PUSH_STAGED:
            from ballista_tpu_torch.executor.executor_server import ExecutorServer

            loop = ExecutorServer(
                executor,
                f"localhost:{self.scheduler_port}",
                "localhost",
                flight_port,
                task_slots=concurrent_tasks,
                heartbeat_interval_s=5.0,
            )
            loop.startup("127.0.0.1", 0)
        else:
            loop = PollLoop(
                executor,
                f"localhost:{self.scheduler_port}",
                "localhost",
                flight_port,
                task_slots=concurrent_tasks,
            )
            loop.start()
        handle = ExecutorHandle(
            executor=executor,
            loop=loop,
            flight_service=svc,
            flight_port=flight_port,
            work_dir=work_dir,
            flight_thread=flight_thread,
        )
        self.executors.append(handle)
        return handle

    def kill_executor(self, index: int, lose_shuffle: bool = True) -> str:
        """Chaos primitive: make executor ``index`` die the way a crashed
        machine does. Stops its task loop (heartbeats/polls cease — the
        scheduler's expiry sweep will declare it dead), shuts down its
        Flight server (remote fetches get connection-refused), and with
        ``lose_shuffle`` deletes its work dir (local-path fetches see the
        files gone — the lost-shuffle case even when reader and writer
        share a filesystem). Returns the dead executor's id."""
        h = self.executors[index]
        h.alive = False
        self._stop_executor(h)
        if lose_shuffle:
            shutil.rmtree(h.work_dir, ignore_errors=True)
        return h.executor.executor_id

    @staticmethod
    def _stop_executor(h: ExecutorHandle) -> None:
        """Stop one executor's loops AND join its daemon threads: the task
        loop (PollLoop/ExecutorServer joins its own workers) and the
        Flight serve() thread. Abandoning them leaked one thread set per
        start/stop cycle (tests assert a zero threading.enumerate()
        delta across repeated cycles)."""
        h.loop.stop()
        try:
            h.flight_service.shutdown()
        except Exception:  # noqa: BLE001 — already down
            pass
        t = h.flight_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
            if t.is_alive():
                log.warning(
                    "flight serve() thread outlived the join timeout"
                )

    def attach_provider(self, provider: TableProvider) -> None:
        """Point scheduler planning + executor decode at a shared table
        registry (the reference's client-side registration model)."""
        self.scheduler.provider = provider
        self.scheduler.codec.provider = provider
        for h in self.executors:
            h.executor.provider = provider
            h.executor.codec.provider = provider

    def stop(self) -> None:
        for h in self.executors:
            if h.alive:
                self._stop_executor(h)
        self.scheduler.shutdown()
        # wait for the gRPC worker pool to wind down, not just signal it
        ev = self.scheduler_grpc.stop(grace=None)
        if ev is not None:
            ev.wait(timeout=5)
        self._tmp.cleanup()
