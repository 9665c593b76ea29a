"""Scheduler-domain vocabulary types (a copy of
``ballista_tpu/scheduler_types.py``).

Mirror of the reference's serde/scheduler/mod.rs:37-200: PartitionId,
PartitionLocation, PartitionStats, ExecutorMetadata, ExecutorSpecification,
ExecutorData, Action. Plain dataclasses used across the scheduler, executor,
and client; proto conversion lives in :mod:`ballista_tpu_torch.serde`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PartitionId:
    """ref serde/scheduler/mod.rs PartitionId {job_id, stage_id, partition}"""

    job_id: str
    stage_id: int
    partition_id: int

    def __str__(self) -> str:
        return f"{self.job_id}/{self.stage_id}/{self.partition_id}"


@dataclasses.dataclass(frozen=True)
class PartitionStats:
    num_rows: int = -1
    num_batches: int = -1
    num_bytes: int = -1


@dataclasses.dataclass(frozen=True)
class PartitionLocation:
    """Where one shuffle output partition lives (ref mod.rs:118-140).

    ``push`` marks a push-shuffle location (docs/shuffle.md): the
    producing executor committed the partition into its in-memory push
    registry, keyed ``(job_id, stage_id, map_partition, partition)`` —
    consumers stream it over Flight DoExchange (or read the in-process
    registry when colocated) and fall back to the pull path at ``path``
    when the stream spilled under backpressure or is gone."""

    job_id: str
    stage_id: int
    partition: int
    executor_id: str
    host: str
    port: int
    path: str
    stats: PartitionStats = PartitionStats()
    push: bool = False
    map_partition: int = 0


@dataclasses.dataclass(frozen=True)
class ExecutorSpecification:
    task_slots: int = 4
    # devices visible to the executor; >= 2 advertises mesh capability
    # (the scheduler may plan fused mesh stage-chains for it)
    n_devices: int = 1


@dataclasses.dataclass(frozen=True)
class ExecutorMetadata:
    id: str
    host: str
    port: int  # Flight (data plane) port
    grpc_port: int = 0  # push-mode control port
    specification: ExecutorSpecification = ExecutorSpecification()


@dataclasses.dataclass
class ExecutorData:
    """Slot accounting (ref mod.rs ExecutorData / executor_manager.rs)."""

    executor_id: str
    total_task_slots: int
    available_task_slots: int


@dataclasses.dataclass(frozen=True)
class ShuffleWritePartitionMeta:
    """One shuffle output file written by a task (ref CompletedTask
    partitions, proto ShuffleWritePartition). ``push`` means the data was
    committed into the producing executor's in-memory push registry
    instead of a file — ``path`` is where it WOULD spill under
    backpressure (the consumer's fall-back target)."""

    partition_id: int
    path: str
    num_batches: int
    num_rows: int
    num_bytes: int
    push: bool = False
