"""Executor core and the pull-mode poll loop (port of
``ballista_tpu/executor/executor.py``).

ref ballista/rust/executor/src/executor.rs:37-119 (Executor object owning
work_dir + runtime) and execution_loop.rs:42-239 (poll loop: drain finished
statuses, PollWork, decode plan, run shuffle write on a worker thread,
report status on next poll).

Where the port differs from the reference:

- **The device.** ``Executor(..., device="cuda")`` by default: every task
  runs on the card, and constructing an executor without one raises
  unless it is asked for the CPU (``device="cpu"``).
- **Prewarm**: ``PollLoop(prewarm=...)`` runs the device-program
  vocabulary on the executor's device (``compilecache.prewarm``).
- **Compile metrics** shipped on the poll are the nvcc build seconds of
  ``ops/cuda_build`` and the counters of ``compilecache.metrics``
  (prewarm progress, the shared callable cache, the hints).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import traceback
import uuid

import grpc

from ballista_tpu_torch.columnar.batch import resolve_device
from ballista_tpu_torch.config import (
    BALLISTA_PLUGIN_DIR,
    BallistaConfig,
)
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.exec.base import run_with_capacity_retry
from ballista_tpu_torch.exec.planner import TableProvider
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec
from ballista_tpu_torch.executor import (
    effective_task_slots,
    visible_devices,
)
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.rpc import scheduler_stub
from ballista_tpu_torch.serde import BallistaCodec

log = logging.getLogger(__name__)

POLL_INTERVAL = 0.1  # ref execution_loop.rs:110-112 (100ms idle sleep)


def compile_metrics() -> dict[str, float]:
    """The compile counters an executor ships on its poll and heartbeat:
    the nvcc build seconds of this process and the counters of
    ``compilecache.metrics`` (prewarm progress, the shared callable cache,
    the hints)."""
    from ballista_tpu_torch.compilecache import metrics
    from ballista_tpu_torch.ops import cuda_build

    return {"compile_seconds": round(cuda_build.build_seconds(), 4), **metrics.snapshot()}



class Executor:
    """ref executor.rs:37-119. Tasks run on ``device``: the card unless the
    caller asks for the CPU."""

    def __init__(
        self,
        executor_id: str,
        work_dir: str,
        provider: TableProvider | None = None,
        metrics_collector=None,
        scheduler_addr: str = "",
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.executor_id = executor_id
        self.work_dir = work_dir
        self.provider = provider
        self.codec = BallistaCodec(provider=provider)
        # eager shuffle (docs/shuffle.md): readers poll the scheduler for
        # published map-output locations through a lazily-dialed channel;
        # the task loops (PollLoop/ExecutorServer) stamp the address and
        # close the channel on stop
        self.scheduler_addr = scheduler_addr
        from ballista_tpu_torch.analysis.witness import make_lock

        self._locations_lock = make_lock("Executor._locations_lock")
        self._locations_channel = None
        self._locations_stub = None
        self._locations_closed = False
        self._locations_token = None  # reswitness entry for the channel
        # re-verify decoded stage plans before running them (catches serde
        # drift between scheduler and executor builds). StandaloneCluster
        # turns this off: in-proc, the scheduler just verified the same
        # bytes it hands over, so the second walk buys nothing.
        self.verify_decoded_plans = True
        # adaptive-capacity memory across tasks (run_with_capacity_retry),
        # seeded from the persisted hint file so a restarted executor keeps
        # its learned join strategies and capacities (compilecache.hints)
        self._capacity_hint: dict = {}
        self._plan_cache: dict = {}
        # job-scoped strategy snapshots (the q15 warm-pass drift fix):
        # every task of one job seeds its attempt cache from the SAME
        # frozen view of the learned strategies — see _job_snapshot
        import collections as _collections

        self._snapshot_lock = make_lock("Executor._snapshot_lock")
        self._job_snapshots: _collections.OrderedDict = (
            _collections.OrderedDict()
        )
        from ballista_tpu_torch.compilecache.hints import HintStore

        self._hints = HintStore()
        self._hints.load_once(self._capacity_hint, self._plan_cache)
        # None = resolve per task from the session's declared
        # ballista.tpu.metrics_collector (shipping by default); an
        # explicitly constructed collector wins (tests, embedders)
        self.metrics_collector = metrics_collector
        # cost accounting (docs/observability.md): latch the compile-
        # seconds claim baseline NOW so kernel builds before the first task
        # are never charged to it
        from ballista_tpu_torch.obs import history as obs_history

        obs_history.init_compile_claim()

    # -- eager-shuffle location polling (docs/shuffle.md) --------------------
    def _locations_client(self):
        """Scheduler stub for GetShuffleLocations, dialed lazily on the
        first eager poll. The dial happens OUTSIDE the lock (racelint
        blocking-under-lock); a store-race loser's channel is closed."""
        with self._locations_lock:
            if self._locations_closed:
                return None
            stub = self._locations_stub
        if stub is not None or not self.scheduler_addr:
            return stub
        from ballista_tpu_torch.analysis import reswitness

        ch = grpc.insecure_channel(self.scheduler_addr)
        stub = scheduler_stub(ch)
        tok = reswitness.acquire(
            "grpc-channel", f"eager-locations->{self.scheduler_addr}"
        )
        extra = None
        with self._locations_lock:
            if self._locations_closed:
                # stop() ran while we dialed: storing now would leak a
                # channel nobody will ever close again
                stub, extra = None, ch
            elif self._locations_stub is not None:
                stub, extra = self._locations_stub, ch
            else:
                self._locations_channel = ch
                self._locations_stub = stub
                self._locations_token, tok = tok, None
        reswitness.release(tok)  # race loser / closed: channel dies below
        if extra is not None:
            try:
                extra.close()
            except Exception:  # noqa: BLE001
                pass
        return stub

    def shuffle_locations(self, job_id: str, stage_id: int, partition: int):
        """TaskContext.shuffle_locations implementation: one
        GetShuffleLocations poll, decoded into a ShuffleLocationsView.
        A transiently unreachable scheduler reads as "no progress yet"
        (the reader keeps waiting under its own bounded deadline) rather
        than "stage gone" — only an explicit failed response is
        terminal."""
        from ballista_tpu_torch.executor.reader import ShuffleLocationsView
        from ballista_tpu_torch.serde import loc_from_proto

        stub = self._locations_client()
        if stub is None:
            return None
        try:
            res = stub.GetShuffleLocations(
                pb.FetchPartition(
                    job_id=job_id, stage_id=stage_id, partition_id=partition
                ),
                timeout=10.0,
            )
        except grpc.RpcError as e:
            log.warning("GetShuffleLocations poll failed: %s", e)
            return ShuffleLocationsView([], 0, False, False)
        return ShuffleLocationsView(
            locations=[
                (int(mt), loc_from_proto(loc))
                for mt, loc in zip(res.map_task, res.locations)
            ],
            tasks_done_prefix=int(res.tasks_done_prefix),
            complete=bool(res.complete),
            failed=bool(res.failed),
        )

    def close_locations_client(self) -> None:
        """Close the eager-poll channel (its sockets and callback threads
        would otherwise leak across start/stop cycles — the shutdown
        hygiene tests count threads). Latches CLOSED: an in-flight task
        polling after this must get None, not re-dial a channel nobody
        will close."""
        from ballista_tpu_torch.analysis import reswitness

        with self._locations_lock:
            ch = self._locations_channel
            tok = self._locations_token
            self._locations_channel = None
            self._locations_stub = None
            self._locations_token = None
            self._locations_closed = True
        reswitness.release(tok)
        if ch is not None:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass

    def _job_snapshot(self, job_id: str) -> dict:
        """The frozen strategy view every task of one job seeds from —
        the q15 warm-pass drift fix (docs/serving.md).

        The plan cache is executor-lifetime: without job scoping, task
        N's freshly committed observations (shrink re-measurement,
        flip-streaming adoption) were visible to task N+1 of the SAME
        job, so two structurally identical subplans — q15's revenue
        subquery appears in both the aggregate branch and the
        max-equality filter branch — could fold their partial sums in
        different orders. The last-ULP float drift that causes is
        invisible almost everywhere, but q15's ``total_revenue =
        (SELECT max(...))`` equality turns it into a silently EMPTY
        result on warm passes. Snapshotting per job makes strategy
        adoption atomic at the job boundary: commits still flow to
        ``_plan_cache`` (future jobs warm up as before), but never
        mid-job. Bounded FIFO — entries are tiny (a dict of strategy
        keys) and a job only needs its entry while its tasks run."""
        with self._snapshot_lock:
            snap = self._job_snapshots.get(job_id)
            if snap is None:
                snap = dict(self._plan_cache)
                self._job_snapshots[job_id] = snap
                while len(self._job_snapshots) > 64:
                    self._job_snapshots.popitem(last=False)
            return snap

    def execute_shuffle_write(
        self, task: pb.TaskDefinition
    ) -> "TaskRunOutput":
        """Decode + rebind work_dir + run one input partition
        (ref executor.rs:81-114). Returns the written partition metas plus
        the per-operator metrics the session's collector chose to ship."""
        from ballista_tpu_torch.config import (
            BALLISTA_INTERNAL_PREFIX,
            BALLISTA_INTERNAL_QUERY_CLASS,
            BALLISTA_INTERNAL_SPAN_PARENT,
            BALLISTA_INTERNAL_TASK_ATTEMPT,
            BALLISTA_INTERNAL_TRACE_ID,
        )

        props_early = {kv.key: kv.value for kv in task.props}
        # task-scoped internal keys (attempt number, trace context) are NOT
        # session config: strip them before BallistaConfig validation
        # rejects the unknown prefix
        attempt = int(props_early.get(BALLISTA_INTERNAL_TASK_ATTEMPT, "0"))
        # fleet observability: the job's query class labels this
        # executor's task-run histogram with the same token the
        # scheduler's job-latency series uses (docs/observability.md)
        query_class = props_early.get(
            BALLISTA_INTERNAL_QUERY_CLASS, "unknown"
        )
        # distributed tracing (docs/observability.md): the scheduler stamps
        # these only when the session traces, so "no prop" IS the
        # zero-overhead off path
        trace_id = props_early.get(BALLISTA_INTERNAL_TRACE_ID, "")
        span_parent = props_early.get(BALLISTA_INTERNAL_SPAN_PARENT, "")
        props_early = {
            k: v
            for k, v in props_early.items()
            if not k.startswith(BALLISTA_INTERNAL_PREFIX)
        }
        from ballista_tpu_torch.testing import faults

        inj = faults.active()
        if inj is not None:
            # deterministic chaos: raising here flows through the task
            # runner's catch-all and is reported as a normal task failure
            inj.on_task_start(
                task.task_id.job_id,
                task.task_id.stage_id,
                task.task_id.partition_id,
                attempt,
            )
        if attempt > 0:
            log.warning(
                "task %s/%s/%s starting attempt %d",
                task.task_id.job_id, task.task_id.stage_id,
                task.task_id.partition_id, attempt,
            )
        plugin_dir = props_early.get(BALLISTA_PLUGIN_DIR, "")
        if plugin_dir:
            # UDF plugins must be resolvable before plan decode builds
            # ScalarFunction nodes (ref plugin serde: names-only wire format)
            from ballista_tpu_torch.plugin import load_plugins

            load_plugins(plugin_dir)
        node = pb.PhysicalPlanNode()
        node.ParseFromString(task.plan)
        plan = self.codec.physical_from_proto(node)
        if not isinstance(plan, ShuffleWriterExec):
            raise ExecutionError(
                "task plan root must be ShuffleWriterExec "
                f"(got {type(plan).__name__})"
            )
        props = props_early
        config = BallistaConfig(props) if props else BallistaConfig()
        # the session's capacity ladder governs this executor's capacities
        # too, or client and executor would size the same query apart (a
        # no-op when the spec is unchanged)
        from ballista_tpu_torch.columnar.batch import set_capacity_buckets

        set_capacity_buckets(config.capacity_buckets())
        if self.verify_decoded_plans and config.verify_plans():
            from ballista_tpu_torch.analysis import verify_physical

            verify_physical(plan)
        from ballista_tpu_torch.executor.metrics import collector_for

        collector = collector_for(config, self.metrics_collector)
        if collector.wants_instrumentation():
            # per-operator rows/bytes/elapsed metering (obs.profile):
            # wrapped BEFORE execution; counters stay lazy device scalars
            # on the hot path and resolve once at record_stage
            from ballista_tpu_torch.obs import profile

            profile.instrument_plan(plan)
        import contextlib

        from ballista_tpu_torch.obs import trace as obs_trace

        if trace_id:
            # executor-side JSONL export follows the session's trace mode;
            # the span ships home on the next poll/status RPC either way
            obs_trace.configure(config.trace())
            span_cm = obs_trace.span(
                "task_attempt",
                trace_id=trace_id,
                parent_id=span_parent,
                attrs={
                    "job_id": task.task_id.job_id,
                    "stage_id": task.task_id.stage_id,
                    "partition": task.task_id.partition_id,
                    "attempt": attempt,
                    "executor_id": self.executor_id,
                },
            )
        else:
            span_cm = contextlib.nullcontext()
        # attempt-isolated speculation cache: run against a SNAPSHOT and
        # commit only on success. A failed attempt (injected crash, lost
        # shuffle fetch midway) has executed part of the plan and recorded
        # speculative observations (join build strategy, probe expansion)
        # from partial data; leaking those into the retry makes the re-run
        # diverge from a clean execution — observed as last-ULP float
        # drift in aggregates, breaking the chaos suite's bit-exact
        # recovery guarantee (docs/fault_tolerance.md).
        # The snapshot is JOB-scoped, not executor-lifetime: task N's
        # freshly committed observations must not be adopted mid-job by
        # task N+1 of the SAME job — see _job_snapshot (the q15
        # warm-pass drift fix).
        attempt_cache = dict(self._job_snapshot(task.task_id.job_id))

        def attempt(ctx):
            # fresh metrics per ATTEMPT: a capacity/speculation retry
            # re-executes this same plan instance, and accumulating
            # across attempts would ship double-counted rows/bytes
            # (obs.profile.reset_plan_metrics)
            if collector.wants_instrumentation():
                from ballista_tpu_torch.obs import profile as _profile

                _profile.reset_plan_metrics(plan)
            return plan.execute_shuffle_write(
                task.task_id.partition_id, ctx
            )

        run_t0 = time.perf_counter()
        cpu_t0 = time.thread_time()
        with span_cm:
            out = run_with_capacity_retry(
                config,
                attempt,
                device=self.device,
                hint=self._capacity_hint,
                plan_cache=attempt_cache,
                # the snapshot's own keys are what this attempt warms
                # from — eviction at the bound must take newer-job
                # entries first, never the working set mid-attempt
                pinned_cache_keys=frozenset(attempt_cache),
                # plan instances are decoded fresh a task: a build table
                # kept on one would die with the task while the shared
                # tally still counted it (see TaskContext.cache_builds)
                cache_builds=False,
                session_id=task.session_id,
                job_id=task.task_id.job_id,
                work_dir=self.work_dir,
                shuffle_locations=(
                    self.shuffle_locations if self.scheduler_addr else None
                ),
            )
        # task-run duration into the process-local fleet histogram
        # (obs/hist.REGISTRY): served by --metrics-port, and shipped home
        # as deltas on the next poll/heartbeat (docs/observability.md)
        from ballista_tpu_torch.obs import hist as obs_hist

        obs_hist.REGISTRY.histogram(
            "ballista_executor_task_run_seconds",
            "Successful task-attempt run duration by query class",
            ("class",),
        ).labels(query_class).observe(time.perf_counter() - run_t0)
        self._plan_cache.update(attempt_cache)
        # commit-back only ever ADDS, so the executor-lifetime cache needs
        # its own bound; job snapshots are independent copies, so nothing
        # running is pinned to these entries
        from ballista_tpu_torch.exec.base import evict_plan_cache

        evict_plan_cache(self._plan_cache)
        # outside exec.base's hint lock: the save only reads the hint
        self._hints.save_if_changed(self._capacity_hint, self._plan_cache)
        from ballista_tpu_torch.analysis import replay

        if replay.enabled():
            # replay witness (docs/fault_tolerance.md): content-hash every
            # COMMITTED (stage, map task, output partition) — a retry,
            # lineage recompute, or certified rewrite re-recording the
            # same key must hash identically. Only successful attempts
            # reach here, so failed attempts' partial files never record.
            # Push-committed partitions hash their in-memory batches with
            # the SAME canonical hash a file read produces (batch-
            # boundary/codec/residency invariant), so push-vs-pull
            # re-records of one key compare equal by construction.
            for m in out:
                digest = self._committed_hash(task, m)
                if digest is None:
                    continue
                replay.record(
                    "shuffle",
                    (
                        task.task_id.job_id,
                        task.task_id.stage_id,
                        task.task_id.partition_id,
                        m.partition_id,
                    ),
                    digest,
                )
        op_metrics = collector.record_stage(
            task.task_id.job_id, task.task_id.stage_id,
            task.task_id.partition_id, plan,
        )
        # cost accounting (docs/observability.md): this attempt's
        # resource vector — wall/CPU around the run, the plan's
        # data-plane counters (shuffle read, spill, push), the committed
        # output bytes, and the claimed share of process compile time.
        # Off = no measurement, no cost on the wire.
        cost = None
        if config.cost_accounting():
            from ballista_tpu_torch.obs import history as obs_history

            cost = obs_history.cost_from_run(
                wall_seconds=time.perf_counter() - run_t0,
                cpu_seconds=time.thread_time() - cpu_t0,
                plan=plan,
                partitions=out,
            )
        return TaskRunOutput(
            partitions=out, operator_metrics=op_metrics, cost=cost
        )

    @staticmethod
    def _committed_hash(task: pb.TaskDefinition, m) -> str | None:
        """Replay-witness hash of one committed shuffle partition: the
        in-memory push stream when it lives there, else the file. None
        means DON'T record: a non-empty commit that hashes as absent can
        only mean the data plane was torn down beneath this task between
        its commit and this read-back (executor kill racing the task
        thread — drop_owner emptied the registry and the work dir is
        gone). That commit is unobservable without a lineage recompute,
        and the recompute's re-record is the hash that matters; recording
        "empty" here would fabricate a mismatch for a row set nobody can
        ever consume."""
        from ballista_tpu_torch.analysis import replay

        if getattr(m, "push", False):
            from ballista_tpu_torch.executor.push import REGISTRY, stream_key

            batches = REGISTRY.peek_batches(
                stream_key(
                    task.task_id.job_id, task.task_id.stage_id,
                    task.task_id.partition_id, m.partition_id,
                )
            )
            if batches:
                import pyarrow as pa

                return replay.canonical_hash(pa.Table.from_batches(batches))
        digest = replay.hash_file(m.path)
        if digest == "empty" and m.num_rows > 0:
            return None
        return digest


def failed_attempt_cost(task: pb.TaskDefinition, wall_s: float,
                        cpu_s: float):
    """Cost vector for a FAILED attempt: wall/CPU metered by the runner
    loop around the call plus the claimed compile share — the plan's
    data-plane counters died with the attempt. Honors the session's
    cost_accounting knob read off the raw task props (the parsed config
    never materialized for a failed decode), so knob-off sessions ship
    no cost even on failure."""
    from ballista_tpu_torch.config import BALLISTA_COST_ACCOUNTING

    for kv in task.props:
        if kv.key == BALLISTA_COST_ACCOUNTING and kv.value.lower() in (
            "false", "0", "no"
        ):
            return None
    from ballista_tpu_torch.obs import history as obs_history

    return obs_history.cost_from_run(wall_seconds=wall_s, cpu_seconds=cpu_s)


@dataclasses.dataclass
class TaskRunOutput:
    """What one task attempt produced: the written shuffle partition metas
    plus (when the session's collector ships) the per-operator metric
    records. Iterable over the metas for callers that only care about
    partitions (tests, as_task_status)."""

    partitions: list
    operator_metrics: list | None = None
    # this attempt's resource cost vector (obs.history.CostVector), or
    # None when the session turned accounting off
    cost: object = None

    def __iter__(self):
        return iter(self.partitions)

    def __len__(self) -> int:
        return len(self.partitions)


def as_task_status(
    task_id: pb.PartitionId,
    executor_id: str,
    result,
    error: str | None,
    cost=None,
) -> pb.TaskStatus:
    """ref executor/src/lib.rs:39-68. ``result``: a TaskRunOutput (the
    executor path) or a bare meta list (tests / legacy callers).
    ``cost``: a failed attempt's measured CostVector (the runner loops
    meter wall/CPU around the call so retried attempts still charge);
    completed attempts carry their cost on the TaskRunOutput."""
    from ballista_tpu_torch.obs.history import cost_to_proto

    st = pb.TaskStatus(task_id=task_id)
    if error is not None:
        failed = pb.FailedTask(error=error[:4096])
        cost_p = cost_to_proto(cost)
        if cost_p is not None:
            failed.cost.CopyFrom(cost_p)
        st.failed.CopyFrom(failed)
        return st
    st.completed.CopyFrom(
        pb.CompletedTask(
            executor_id=executor_id,
            partitions=[
                pb.ShuffleWritePartition(
                    partition_id=m.partition_id,
                    path=m.path,
                    num_batches=m.num_batches,
                    num_rows=m.num_rows,
                    num_bytes=m.num_bytes,
                    push=getattr(m, "push", False),
                )
                for m in result
            ],
        )
    )
    op_metrics = getattr(result, "operator_metrics", None)
    if op_metrics:
        from ballista_tpu_torch.obs import profile

        st.completed.operator_metrics.extend(
            profile.metrics_to_proto(op_metrics)
        )
    cost_p = cost_to_proto(getattr(result, "cost", None))
    if cost_p is not None:
        st.completed.cost.CopyFrom(cost_p)
    return st


class PollLoop:
    """Pull-mode execution loop (ref execution_loop.rs:42-114)."""

    def __init__(
        self,
        executor: Executor,
        scheduler_addr: str,
        flight_host: str,
        flight_port: int,
        task_slots: int = 4,
        prewarm: str | None = None,
    ):
        self.executor = executor
        self.scheduler_addr = scheduler_addr
        # eager shuffle: the executor core polls published map-output
        # locations from the same scheduler this loop polls work from
        if not executor.scheduler_addr:
            executor.scheduler_addr = scheduler_addr
        self.flight_host = flight_host
        self.flight_port = flight_port
        task_slots = effective_task_slots(task_slots)
        self.task_slots = task_slots
        self._available = threading.Semaphore(task_slots)
        self._statuses: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the prewarm's mode (an explicit flag, else BALLISTA_TPU_PREWARM),
        # started and stopped with the loop; shared with ExecutorServer
        from ballista_tpu_torch.compilecache import prewarm as prewarm_mod

        self.prewarm_mode = prewarm_mod.resolve_mode(prewarm)
        self._prewarm = None

    def start(self) -> None:
        from ballista_tpu_torch.compilecache.prewarm import start_server_prewarm
        from ballista_tpu_torch.obs import trace as obs_trace

        # executor role: recorded spans stage in the outbox and ride the
        # poll home (docs/observability.md)
        obs_trace.enable_shipping(True)
        self._prewarm = start_server_prewarm(self.prewarm_mode, self.executor.device)
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="executor-poll-loop"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._prewarm is not None:
            # cancel queued prewarm signatures and join the pool: a stopped
            # loop leaves no compile-prewarm thread behind
            self._prewarm.stop()
            self._prewarm = None
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.executor.close_locations_client()
        # push-shuffle streams die with their producer by design
        # (docs/shuffle.md): drop this executor's registry entries so
        # consumers fall back / recompute and the memory (and resource-
        # witness entries) drain to zero at shutdown
        from ballista_tpu_torch.executor.push import REGISTRY

        REGISTRY.drop_owner(self.executor.work_dir)

    def _metadata(self) -> pb.ExecutorMetadata:
        return pb.ExecutorMetadata(
            id=self.executor.executor_id,
            host=self.flight_host,
            port=self.flight_port,
            specification=pb.ExecutorSpecification(
                task_slots=self.task_slots, n_devices=visible_devices()
            ),
        )

    def run(self) -> None:
        from ballista_tpu_torch.analysis import reswitness

        channel = grpc.insecure_channel(self.scheduler_addr)
        tok = reswitness.acquire(
            "grpc-channel", f"poll-loop->{self.scheduler_addr}"
        )
        stub = scheduler_stub(channel)
        try:
            self._poll(stub)
        finally:
            # the channel owns sockets and callback threads; a stopped
            # loop that abandons it leaks them across start/stop cycles
            channel.close()
            reswitness.release(tok)

    def _poll(self, stub) -> None:
        while not self._stop.is_set():
            from ballista_tpu_torch.testing import faults

            inj = faults.active()
            if inj is not None and inj.heartbeat_suppressed(
                self.executor.executor_id
            ):
                # injected heartbeat blackout: pull-mode liveness IS the
                # PollWork call, so skipping it makes the scheduler's
                # expiry sweep see this executor die. Checked BEFORE the
                # status drain: statuses are drained exactly once, so
                # draining first and then skipping the poll would lose
                # them permanently across a bounded blackout
                time.sleep(POLL_INTERVAL)
                continue
            # drain completed statuses (ref :219-239)
            statuses = []
            while True:
                try:
                    statuses.append(self._statuses.get_nowait())
                except queue.Empty:
                    break
            # free-slot count for batched grants (docs/serving.md):
            # drain the semaphore non-blocking, count, release. This
            # thread is the only grant consumer, so the count only ever
            # UNDER-advertises (a task finishing mid-count frees a slot
            # we don't report) — the scheduler never grants more tasks
            # than the _run_task acquires below can absorb unblocked.
            free_slots = 0
            while self._available.acquire(blocking=False):
                free_slots += 1
            for _ in range(free_slots):
                self._available.release()
            can_accept = free_slots > 0
            from ballista_tpu_torch.obs import hist as obs_hist
            from ballista_tpu_torch.obs import trace as obs_trace

            spans = obs_trace.drain_outbox()
            hist_deltas = obs_hist.REGISTRY.drain_deltas()
            try:
                result = stub.PollWork(
                    pb.PollWorkParams(
                        metadata=self._metadata(),
                        can_accept_task=can_accept,
                        task_status=statuses,
                        # compile-latency observability: pull-mode liveness
                        # IS the poll, so the counter snapshot rides it
                        metrics=[
                            pb.KeyValuePair(key=k, value=str(v))
                            for k, v in compile_metrics().items()
                        ],
                        # drained trace spans + latency-histogram deltas
                        # ride the same liveness RPC
                        # (docs/observability.md)
                        spans=[obs_trace.span_to_proto(s) for s in spans],
                        hists=obs_hist.deltas_to_proto(hist_deltas),
                        free_slots=free_slots,
                    )
                )
            except grpc.RpcError as e:
                log.warning("poll_work failed: %s", e)
                # re-enqueue the drained statuses (and spans, and
                # histogram deltas) for the next successful poll —
                # dropping them left tasks RUNNING forever on the
                # scheduler (statuses are reported exactly once; spans
                # and histogram deltas ship exactly once too)
                for st in statuses:
                    self._statuses.put(st)
                obs_trace.requeue_outbox(spans)
                obs_hist.REGISTRY.requeue_deltas(hist_deltas)
                time.sleep(1.0)
                continue
            # batched grants (docs/serving.md): a batching scheduler
            # fills `tasks` (first grant mirrored into `task`); a
            # pre-batching scheduler sets only `task`
            tasks = list(result.tasks)
            if not tasks and result.HasField("task"):
                tasks = [result.task]
            if tasks:
                for td in tasks:
                    self._run_task(td)
            else:
                time.sleep(POLL_INTERVAL)

    def _run_task(self, task: pb.TaskDefinition) -> None:
        """ref run_received_tasks :129-217 (panic-catching thread spawn)."""
        self._available.acquire()

        def work():
            error = None
            result = []
            cost = None
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                result = self.executor.execute_shuffle_write(task)
            except BaseException as e:  # noqa: BLE001 (catch_unwind parity)
                error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                log.error("task %s failed: %s", task.task_id, error)
                # the failed attempt still consumed resources — charge it
                # (docs/observability.md cost accounting)
                cost = failed_attempt_cost(
                    task, time.perf_counter() - t0, time.thread_time() - c0
                )
            finally:
                self._available.release()
            self._statuses.put(
                as_task_status(
                    task.task_id, self.executor.executor_id, result, error,
                    cost=cost,
                )
            )

        # fire-and-forget by design: concurrency is bounded by the task
        # slot semaphore and completion is observed through the status
        # queue, not a join (ref execution_loop.rs thread spawn)
        threading.Thread(  # lifelint: transfer=semaphore-bounded
            target=work, daemon=True, name="task-runner"
        ).start()


def new_executor_id() -> str:
    return uuid.uuid4().hex[:16]
