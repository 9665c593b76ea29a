"""Push-mode executor server (port of
``ballista_tpu/executor/executor_server.py``).

ref ballista/rust/executor/src/executor_server.rs:49-354:
``startup`` starts the ExecutorGrpc service, registers with the scheduler
(RegisterExecutor, carrying the grpc_port the scheduler dials back), starts
a Heartbeater (60s, :273-283) and a task runner pool consuming LaunchTask
queues (:294-330). Each finished task pushes UpdateTaskStatus back to the
scheduler (:176-254). StopExecutor — ``todo!()`` in the reference
(:348-353) — is implemented here as a graceful drain + stop. Tasks run on
the executor's device (the card unless it was asked for the CPU), where
the configured prewarm runs at startup and is joined at stop.
"""

from __future__ import annotations

import logging
import queue
import threading
import traceback

import grpc

from ballista_tpu_torch.executor.executor import (
    Executor,
    as_task_status,
    compile_metrics,
    failed_attempt_cost,
)
from ballista_tpu_torch.executor import (
    effective_task_slots,
    visible_devices,
)
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.rpc import (
    EXECUTOR_METHODS,
    EXECUTOR_SERVICE,
    add_service,
    scheduler_stub,
)

log = logging.getLogger(__name__)

# The scheduler's liveness window defaults to 60s (executor_manager.rs:69-77);
# heartbeating at a quarter of it keeps a healthy margin (the reference's 60s
# interval against a 60s window has zero margin).
HEARTBEAT_INTERVAL_S = 15.0

# Every control RPC carries a deadline: a half-open connection (scheduler
# migrated, NAT dropped without RST) must time out and retry on the next
# loop tick, never wedge the heartbeat/runner thread forever.
RPC_TIMEOUT_S = 10.0



class ExecutorServer:
    """Push-mode executor process body."""

    def __init__(
        self,
        executor: Executor,
        scheduler_addr: str,
        flight_host: str,
        flight_port: int,
        task_slots: int = 4,
        heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
        prewarm: str | None = None,
    ) -> None:
        self.executor = executor
        # the prewarm's mode and start sequence are shared with PollLoop
        from ballista_tpu_torch.compilecache import prewarm as prewarm_mod

        self.prewarm_mode = prewarm_mod.resolve_mode(prewarm)
        self._prewarm = None
        self.scheduler_addr = scheduler_addr
        # eager shuffle: the executor core polls published map-output
        # locations from the same scheduler this server reports to
        if not executor.scheduler_addr:
            executor.scheduler_addr = scheduler_addr
        self.flight_host = flight_host
        self.flight_port = flight_port
        task_slots = effective_task_slots(task_slots)
        self.task_slots = task_slots
        self.heartbeat_interval_s = heartbeat_interval_s
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._grpc_server: grpc.Server | None = None
        self.grpc_port: int = 0
        self._channel: grpc.Channel | None = None
        self._channel_token = None
        self._sched = None

    # -- gRPC service (ExecutorGrpc) -----------------------------------------
    def LaunchTask(self, request: pb.LaunchTaskParams, context):
        """ref executor_server.rs:336-346 — enqueue, workers pick up."""
        for task in request.tasks:
            self._queue.put(task)
        return pb.LaunchTaskResult(success=True)

    def StopExecutor(self, request, context):
        self._stop.set()
        return pb.StopExecutorResult()

    # -- lifecycle -----------------------------------------------------------
    def startup(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start service + register + heartbeater + runner pool. Returns
        the bound grpc port (ref startup :49-108)."""
        from concurrent.futures import ThreadPoolExecutor

        # the prewarm runs while the control plane comes up: 'on' blocks
        # here so the scheduler never offers slots to a cold executor,
        # 'background' overlaps registration and is joined in stop()
        from ballista_tpu_torch.compilecache.prewarm import start_server_prewarm
        from ballista_tpu_torch.obs import trace as obs_trace

        # executor role: recorded spans stage in the outbox and ride the
        # heartbeat/status RPCs home (docs/observability.md)
        obs_trace.enable_shipping(True)
        self._prewarm = start_server_prewarm(self.prewarm_mode, self.executor.device)

        gs = grpc.server(ThreadPoolExecutor(max_workers=8))
        add_service(gs, EXECUTOR_SERVICE, EXECUTOR_METHODS, self)
        self.grpc_port = gs.add_insecure_port(f"{host}:{port}")
        gs.start()
        self._grpc_server = gs

        try:
            from ballista_tpu_torch.analysis import reswitness

            self._channel = grpc.insecure_channel(self.scheduler_addr)
            self._channel_token = reswitness.acquire(
                "grpc-channel", f"executor-server->{self.scheduler_addr}"
            )
            self._sched = scheduler_stub(self._channel)
            self._sched.RegisterExecutor(
                pb.RegisterExecutorParams(metadata=self._metadata()),
                timeout=RPC_TIMEOUT_S,
            )
        except BaseException:
            # partial-startup teardown: a failed registration (scheduler
            # not up yet, bad address) must not leave a running gRPC
            # server, an open channel and a live prewarm pool behind a
            # raised startup(), since nobody calls stop() on an instance
            # that never started
            self.stop()
            raise

        hb = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="heartbeater"
        )
        hb.start()
        self._threads.append(hb)
        # ref: 4-thread DedicatedExecutor pool (:294-330); the compute
        # runs on the device, so host threads stay light
        for i in range(self.task_slots):
            t = threading.Thread(
                target=self._runner_loop, daemon=True, name=f"task-runner-{i}"
            )
            t.start()
            self._threads.append(t)
        return self.grpc_port

    def _metadata(self) -> pb.ExecutorMetadata:
        return pb.ExecutorMetadata(
            id=self.executor.executor_id,
            host=self.flight_host,
            port=self.flight_port,
            grpc_port=self.grpc_port,
            specification=pb.ExecutorSpecification(
                task_slots=self.task_slots, n_devices=visible_devices()
            ),
        )

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            from ballista_tpu_torch.testing import faults

            inj = faults.active()
            if inj is not None and inj.heartbeat_suppressed(
                self.executor.executor_id
            ):
                # injected blackout: the scheduler's expiry sweep must see
                # this executor go silent
                continue
            from ballista_tpu_torch.obs import hist as obs_hist
            from ballista_tpu_torch.obs import trace as obs_trace

            spans = obs_trace.drain_outbox()
            hist_deltas = obs_hist.REGISTRY.drain_deltas()
            try:
                result = self._sched.HeartBeatFromExecutor(
                    pb.HeartBeatParams(
                        executor_id=self.executor.executor_id,
                        # compile-latency observability: the cumulative
                        # counter snapshot rides every beat; the scheduler
                        # stores the latest per executor (REST /api/state)
                        metrics=[
                            pb.KeyValuePair(key=k, value=str(v))
                            for k, v in compile_metrics().items()
                        ],
                        # trace spans not already shipped with a task
                        # status (flight serve spans, stragglers)
                        spans=[obs_trace.span_to_proto(s) for s in spans],
                        # latency-histogram deltas (task-run, shuffle-
                        # fetch-wait) merge into the scheduler's fleet
                        # registry (docs/observability.md)
                        hists=obs_hist.deltas_to_proto(hist_deltas),
                    ),
                    timeout=RPC_TIMEOUT_S,
                )
                if result.reregister:
                    # the scheduler expired us (or restarted); it has reset
                    # every task it launched here back to PENDING, so our
                    # queued (not yet started) copies must be dropped before
                    # re-announcing — otherwise the fresh slot grant lets
                    # the scheduler stack a second full load on top
                    dropped = 0
                    try:
                        while True:
                            self._queue.get_nowait()
                            dropped += 1
                    except queue.Empty:
                        pass
                    log.info(
                        "scheduler requested re-registration "
                        "(dropped %d queued tasks)", dropped,
                    )
                    self._sched.RegisterExecutor(
                        pb.RegisterExecutorParams(metadata=self._metadata()),
                        timeout=RPC_TIMEOUT_S,
                    )
            except grpc.RpcError as e:
                log.warning("heartbeat failed: %s", e)
                # spans + histogram deltas ship exactly once: a failed
                # beat re-queues what it drained for the next one
                obs_trace.requeue_outbox(spans)
                obs_hist.REGISTRY.requeue_deltas(hist_deltas)

    def _runner_loop(self) -> None:
        """ref run_task :176-254 — decode, execute, push status back."""
        while not self._stop.is_set():
            try:
                task = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            error = None
            result = []
            cost = None
            import time as _time

            t0, c0 = _time.perf_counter(), _time.thread_time()
            try:
                result = self.executor.execute_shuffle_write(task)
            except BaseException as e:  # noqa: BLE001 (catch_unwind parity)
                error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                log.error("task %s failed: %s", task.task_id, error)
                # failed attempts still consumed resources — charge them
                # (docs/observability.md cost accounting)
                cost = failed_attempt_cost(
                    task,
                    _time.perf_counter() - t0,
                    _time.thread_time() - c0,
                )
            status = as_task_status(
                task.task_id, self.executor.executor_id, result, error,
                cost=cost,
            )
            from ballista_tpu_torch.obs import trace as obs_trace

            # drain trace spans with the status so task-attempt spans
            # arrive WITH their completion, not a heartbeat later
            spans = obs_trace.drain_outbox()
            try:
                self._sched.UpdateTaskStatus(
                    pb.UpdateTaskStatusParams(
                        executor_id=self.executor.executor_id,
                        task_status=[status],
                        spans=[obs_trace.span_to_proto(s) for s in spans],
                    ),
                    timeout=RPC_TIMEOUT_S,
                )
            except grpc.RpcError as e:
                log.warning("UpdateTaskStatus failed: %s", e)
                obs_trace.requeue_outbox(spans)

    def stop(self) -> None:
        """Graceful drain: signal, then JOIN the heartbeater and every
        runner thread before tearing down the gRPC surface — abandoned
        daemon threads would leak across start/stop cycles and could
        race a half-closed channel with their final UpdateTaskStatus."""
        self._stop.set()
        if self._prewarm is not None:
            # cancel queued prewarm signatures and join the pool threads
            # before the thread audit below
            self._prewarm.stop()
            self._prewarm = None
        stragglers = []
        for t in self._threads:
            t.join(timeout=5)
            if t.is_alive():
                stragglers.append(t.name)
        # AFTER the runner join: a runner mid-eager-task must not see the
        # poll channel closed and re-dial one nobody would ever close
        # (close_locations_client also latches against exactly that race
        # for stragglers that outlived the join timeout)
        self.executor.close_locations_client()
        # push-shuffle streams die with their producer (docs/shuffle.md)
        from ballista_tpu_torch.executor.push import REGISTRY

        REGISTRY.drop_owner(self.executor.work_dir)
        if self._grpc_server is not None:
            ev = self._grpc_server.stop(grace=None)
            if ev is not None:
                ev.wait(timeout=5)
        if stragglers:
            # a runner still draining a long task would race a closed
            # channel with its final UpdateTaskStatus — leave the channel
            # to GC and make the leak loud instead of silent
            log.warning(
                "executor stop: threads outlived the join timeout: %s; "
                "leaving the scheduler channel open for them", stragglers,
            )
        elif self._channel is not None:
            from ballista_tpu_torch.analysis import reswitness

            self._channel.close()
            reswitness.release(getattr(self, "_channel_token", None))
            self._channel_token = None
