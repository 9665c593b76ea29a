"""BallistaContext: the distributed client entry point.

ref ballista/rust/client/src/context.rs:76-439 — remote() creates a
server-side session via ExecuteQuery-with-no-query (:83-135); standalone()
boots an in-proc scheduler + executor (:137-207); table registration is
kept CLIENT-side and travels with each query's serialized logical plan
(:258-308); sql() intercepts SHOW and CREATE EXTERNAL TABLE (:311-435);
collect() drives the DistributedQueryExec flow (core/src/execution_plans/
distributed_query.rs:160-326): submit, poll GetJobStatus every 100ms, then
Flight-fetch the completed partition locations.

Port of ``ballista_tpu/client/context.py`` over :class:`TorchContext`. The
client plans logically and never runs an operator, but it is a
``TorchContext``, so ``device`` (default ``"cuda"``) follows the port's
rule: without a card it raises unless asked for the CPU. ``standalone``
passes the device down to its executors. Statements (``CREATE EXTERNAL
TABLE``, ``DROP TABLE``, ``SHOW``, ``EXPLAIN``) run client-side through
``TorchContext.sql``; a file table's source travels in the logical plan,
so the executors open the file themselves. ``table()`` and ``read_*``
return remote frames, and every frame derived from one stays remote.
A query over ``system.*`` runs client-side, as in the reference: the
scan materializes the scheduler's persistent history (``GetHistory``)
and the query runs through the local ``TorchContext`` path on the
client's device.
"""

from __future__ import annotations

import time

import grpc
import pyarrow as pa

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import BallistaError, GrpcError
from ballista_tpu_torch.exec.context import DataFrame, TorchContext
from ballista_tpu_torch.plan.logical import LogicalPlan
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.rpc import scheduler_stub
from ballista_tpu_torch.serde import logical_to_proto
from ballista_tpu_torch.sql import ast
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner

POLL_INTERVAL = 0.1  # ref distributed_query.rs:268


class BallistaContext(TorchContext):
    """Extends the single-process context with a remote scheduler: queries
    plan logically client-side and execute on the cluster."""

    def __init__(
        self,
        scheduler_addr: str,
        config: BallistaConfig | None = None,
        device: str = "cuda",
    ):
        super().__init__(config, device=device)
        from ballista_tpu_torch.analysis import reswitness

        self.scheduler_addr = scheduler_addr
        # raised receive cap: GetHistory ships the retained query log as
        # one JSON payload, and a full task_attempts fetch on a busy
        # cluster can exceed grpc's default 4MB receive limit (the
        # retention bound keeps it well under this cap)
        self._channel = grpc.insecure_channel(
            scheduler_addr,
            options=[("grpc.max_receive_message_length", 64 << 20)],
        )
        self._channel_token = reswitness.acquire(
            "grpc-channel", f"client->{scheduler_addr}"
        )
        self._stub = scheduler_stub(self._channel)
        # create a server-side session (ref context.rs:83-135)
        result = self._stub.ExecuteQuery(
            pb.ExecuteQueryParams(
                settings=[
                    pb.KeyValuePair(key=k, value=v)
                    for k, v in self.config.settings().items()
                ]
            )
        )
        self.session_id = result.session_id
        self._standalone_cluster = None

    # -- factory constructors -------------------------------------------------
    @classmethod
    def remote(
        cls, host: str, port: int, config: BallistaConfig | None = None,
        device: str = "cuda",
    ) -> "BallistaContext":
        return cls(f"{host}:{port}", config, device=device)

    @classmethod
    def standalone(
        cls,
        config: BallistaConfig | None = None,
        concurrent_tasks: int = 4,
        policy=None,
        n_executors: int = 1,
        executor_timeout_s: float = 60.0,
        expiry_check_interval_s: float = 15.0,
        device: str = "cuda",
    ) -> "BallistaContext":
        """Boot an in-proc scheduler + executor over localhost gRPC/Flight
        (ref context.rs:137-207 + scheduler/standalone.rs +
        executor/standalone.rs) — full cluster semantics in one process.
        ``policy`` selects pull- vs push-staged task scheduling
        (ref scheduler/src/main.rs:87-95 ``--scheduler-policy``);
        ``n_executors`` boots a multi-executor cluster (chaos tests kill
        one and assert recovery; the liveness knobs tighten the expiry
        sweep so those tests run in seconds)."""
        from ballista_tpu_torch.config import TaskSchedulingPolicy
        from ballista_tpu_torch.standalone import StandaloneCluster

        cluster = StandaloneCluster.start(
            config,
            concurrent_tasks,
            policy=policy or TaskSchedulingPolicy.PULL_STAGED,
            n_executors=n_executors,
            executor_timeout_s=executor_timeout_s,
            expiry_check_interval_s=expiry_check_interval_s,
            device=device,
        )
        try:
            ctx = cls(
                f"localhost:{cluster.scheduler_port}", config, device=device
            )
        except BaseException:
            cluster.stop()
            raise
        ctx._standalone_cluster = cluster
        # the in-proc scheduler/executor resolve memory tables through the
        # client's own registry (the reference re-registers per query)
        cluster.attach_provider(ctx)
        return ctx

    def close(self) -> None:
        from ballista_tpu_torch.analysis import reswitness

        if self._standalone_cluster is not None:
            self._standalone_cluster.stop()
        self._channel.close()
        reswitness.release(self._channel_token)
        self._channel_token = None

    def _frame(self, logical: LogicalPlan) -> DataFrame:
        return RemoteDataFrame(self, logical)

    # -- system tables --------------------------------------------------------
    def _system_table_rows(self, name: str) -> list[dict]:
        """Cluster contexts materialize system.* from the scheduler's
        persistent history (the GetHistory RPC), the fleet-wide log,
        instead of the local process's query log."""
        import json

        from ballista_tpu_torch.obs.history import SYSTEM_TABLE_KINDS

        res = self._stub.GetHistory(pb.GetHistoryParams(kind=SYSTEM_TABLE_KINDS[name]))
        return json.loads(res.payload or b"[]")

    # -- query execution ------------------------------------------------------
    def sql(self, sql: str) -> DataFrame:
        stmt = parse_sql(sql)
        # DDL/utility statements run client-side (ref context.rs:311-435)
        if not isinstance(stmt, (ast.Select, ast.SetOp)):
            return super().sql(sql)
        logical = SqlPlanner(self).plan(stmt)
        frame = self._frame(logical)
        frame._sql = sql  # verifier diagnostics carry a source span
        return frame

    def collect_logical(
        self, logical: LogicalPlan, sql: str | None = None
    ) -> pa.Table:
        """Submit a logical plan, poll to completion, fetch partitions
        (the DistributedQueryExec flow)."""
        # system-table queries run client-side: the history lives on the
        # scheduler, not on executors, so the scan materializes it here
        # (GetHistory) and the query runs through the local TorchContext
        # path, planned and verified like any other; mixed queries (system
        # joined with user tables) take the local path too
        from ballista_tpu_torch.exec.context import _scans_system_table

        if _scans_system_table(logical):
            return DataFrame(self, logical).collect()
        if self.config.verify_plans():
            # client-side gate: a plan that cannot execute fails HERE with
            # an operator path (and SQL span when known) instead of as an
            # opaque failed-job error from an executor. The scheduler
            # re-verifies its physical/stage plans server-side.
            from ballista_tpu_torch.analysis import verify_logical
            from ballista_tpu_torch.plan.optimizer import optimize

            verify_logical(optimize(logical), sql=sql)
        node = logical_to_proto(logical)
        result = self._stub.ExecuteQuery(
            pb.ExecuteQueryParams(
                logical_plan=node.SerializeToString(),
                session_id=self.session_id,
                settings=[
                    pb.KeyValuePair(key=k, value=v)
                    for k, v in self.config.settings().items()
                ],
            )
        )
        job_id = result.job_id
        deadline = time.time() + 600
        while True:
            status = self._stub.GetJobStatus(
                pb.GetJobStatusParams(job_id=job_id)
            ).status
            kind = status.WhichOneof("status")
            if kind == "completed":
                return self._fetch_results(status.completed, logical)
            if kind == "failed":
                raise BallistaError(
                    f"job {job_id} failed: {status.failed.error}"
                )
            if time.time() > deadline:
                raise GrpcError(f"job {job_id} timed out")
            time.sleep(POLL_INTERVAL)

    def _fetch_results(
        self, completed: pb.CompletedJob, logical: LogicalPlan
    ) -> pa.Table:
        # fetch_partition_table per location: local partitions come back
        # zero-copy off a memory map and remote ones are assembled from
        # the streamed Flight batch path — nothing buffers a partition ON
        # TOP of the result — while each location's fetch stays atomic
        # and therefore fully retryable on transient transport errors.
        # (Streaming fetch_partition_batches here would be WRONG: its
        # retry stops after the first yielded batch — correct under the
        # scheduler's task-level retry, but no such layer exists above
        # this client-side result fetch.) Arrow tables share buffers, so
        # flattening to batches for the single from_batches below copies
        # nothing.
        from ballista_tpu_torch.analysis import replay
        from ballista_tpu_torch.columnar.coalesce import BatchCoalescer
        from ballista_tpu_torch.executor.reader import fetch_partition_table
        from ballista_tpu_torch.serde import loc_from_proto

        # serving fast path (docs/serving.md): a result-cache hit ships
        # the committed result inline on the status reply — nothing to
        # fetch. The replay witness still records the content hash, so
        # a cache-served result is held to the same bit-exactness
        # contract as a freshly fetched one.
        if completed.result_ipc:
            from ballista_tpu_torch.scheduler.result_cache import ipc_to_table

            t = ipc_to_table(completed.result_ipc)
            if replay.enabled():
                replay.record(
                    "result", ("cache", 0, 0), replay.canonical_hash(t)
                )
            return t

        # tiny-batch coalescing (columnar/coalesce.py): wide shuffles
        # deliver results as fan-out slivers, and from_batches over
        # thousands of them pays per-batch fixed costs twice (once per
        # chunk here, once per chunk in every downstream consumer of the
        # chunked table) — fold them to the shuffle target size first,
        # with the same helper both shuffle ends use
        coalescer = BatchCoalescer(
            self.config.shuffle_target_batch_mb() << 20
        )
        batches = []
        for loc_p in completed.partition_location:
            loc = loc_from_proto(loc_p)
            t = fetch_partition_table(loc)
            if replay.enabled():
                # replay witness: every final result partition records a
                # canonical content hash — the client-visible half of the
                # bit-exactness invariant (docs/fault_tolerance.md)
                replay.record(
                    "result",
                    (loc.job_id, loc.stage_id, loc.partition),
                    replay.canonical_hash(t),
                )
            if t.num_rows:
                for rb in t.to_batches():
                    out = coalescer.add(rb)
                    if out is not None:
                        batches.append(out)
        tail = coalescer.flush()
        if tail is not None:
            batches.append(tail)
        if not batches:
            from ballista_tpu_torch.columnar.arrow_interop import schema_to_arrow
            from ballista_tpu_torch.plan.optimizer import optimize

            schema = schema_to_arrow(optimize(logical).schema())
            return pa.table(
                {f.name: pa.array([], type=f.type) for f in schema}
            )
        return pa.Table.from_batches(batches)


class RemoteDataFrame(DataFrame):
    """DataFrame whose collect() submits to the scheduler. The builder
    methods are inherited: each derives another RemoteDataFrame, so a
    chain started from ``table()`` or ``read_*()`` runs remotely."""

    def collect(self) -> pa.Table:
        if self._const is not None:
            return self._const
        return self.ctx.collect_logical(self.logical, sql=self._sql)
