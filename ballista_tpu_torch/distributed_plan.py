"""Distributed planner: split a physical plan into shuffle-bounded stages
(port of ``ballista_tpu/distributed_plan.py``; no device code, so the
splitter, its placeholder and the shuffle resolution are the reference's,
over the port's operators).

The reference's DistributedPlanner (ballista/rust/scheduler/src/
planner.rs:42-270): walk the plan, cut at exchange boundaries, wrap each
fragment in a ShuffleWriterExec, and leave UnresolvedShuffleExec
placeholders where a downstream fragment consumes a not-yet-computed stage.

Boundary rules adapted to this engine's operators:
- ``CoalescePartitionsExec`` -> stage boundary with a single (unpartitioned)
  output, exactly like the reference's coalesce arm (planner.rs:104-132).
  This covers final aggregates, sorts, and limits, whose inputs are partial
  results computed per partition.
- ``HashJoinExec`` build side (the right/left child that gets collected) is
  a broadcast-like boundary: the build fragment materializes as a
  single-partition shuffle so every probe task can fetch it (the
  COLLECT_LEFT mode of the reference, proto:474-487).
- ``HashRepartitionExec`` -> stage boundary with ``Partitioning::Hash``,
  exactly the reference's RepartitionExec(Hash) arm (planner.rs:133-157):
  the upstream fragment's ShuffleWriter hash-partitions into K buckets and
  K downstream tasks each read their bucket from every writer. The
  physical planner emits these at aggregate/join exchange points when
  planning for the distributed tier (``ballista.repartition.*``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterator

from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import InternalError, PlanError
from ballista_tpu_torch.exec.base import (
    ExecutionPlan,
    TaskContext,
    UnknownPartitioning,
    replace_children,
)
from ballista_tpu_torch.exec.joins import HashJoinExec
from ballista_tpu_torch.exec.pipeline import CoalescePartitionsExec
from ballista_tpu_torch.exec.repartition import HashRepartitionExec
from ballista_tpu_torch.executor.reader import ShuffleReaderExec
from ballista_tpu_torch.executor.shuffle import ShuffleWriterExec


class UnresolvedShuffleExec(ExecutionPlan):
    """Placeholder leaf for a dependency on a not-yet-computed stage
    (ref execution_plans/unresolved_shuffle.rs:34-129). Non-executable."""

    def __init__(
        self,
        stage_id: int,
        schema: Schema,
        input_partition_count: int,
        output_partition_count: int,
    ) -> None:
        super().__init__()
        self.stage_id = stage_id
        self._schema = schema
        self.input_partition_count = input_partition_count
        self.output_partition_count = output_partition_count

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return UnknownPartitioning(self.output_partition_count)

    def describe(self) -> str:
        return f"UnresolvedShuffleExec: stage={self.stage_id}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator:
        raise InternalError(
            "UnresolvedShuffleExec cannot be executed; the scheduler must "
            "resolve it to a ShuffleReaderExec first "
            "(ref unresolved_shuffle.rs:102-110)"
        )


@dataclasses.dataclass
class QueryStage:
    """One stage = a ShuffleWriterExec-rooted fragment (ref planner.rs
    create_shuffle_writer)."""

    job_id: str
    stage_id: int
    plan: "ExecutionPlan"  # rooted at ShuffleWriterExec

    @property
    def input_partition_count(self) -> int:
        return self.plan.input.output_partitioning().n

    @property
    def output_partition_count(self) -> int:
        return self.plan.output_partitions


class DistributedPlanner:
    """ref planner.rs:42-270."""

    def __init__(self) -> None:
        self._next_stage_id = 0

    def plan_query_stages(
        self, job_id: str, plan: ExecutionPlan
    ) -> list[QueryStage]:
        """Returns stages in dependency order; the last is the terminal
        stage whose output the client fetches (ref planner.rs:62-78)."""
        stages: list[QueryStage] = []
        root = self._plan_node(job_id, plan, stages)
        terminal = ShuffleWriterExec(
            job_id, self._new_stage_id(), root, [], 1
        )
        stages.append(QueryStage(job_id, terminal.stage_id, terminal))
        return stages

    def _new_stage_id(self) -> int:
        self._next_stage_id += 1
        return self._next_stage_id

    def _plan_node(
        self, job_id: str, plan: ExecutionPlan, stages: list[QueryStage]
    ) -> ExecutionPlan:
        children = [
            self._plan_node(job_id, c, stages) for c in plan.children()
        ]

        if isinstance(plan, HashRepartitionExec):
            # hash-exchange boundary (ref planner.rs:133-157): the child
            # fragment becomes a stage whose ShuffleWriter hash-partitions
            # its output into K buckets; downstream tasks each read their
            # bucket from every writer
            (child,) = children
            writer = ShuffleWriterExec(
                job_id, self._new_stage_id(), child, list(plan.keys),
                plan.partitions,
            )
            stages.append(QueryStage(job_id, writer.stage_id, writer))
            return UnresolvedShuffleExec(
                writer.stage_id,
                child.schema(),
                child.output_partitioning().n,
                plan.partitions,
            )

        if isinstance(plan, CoalescePartitionsExec):
            # stage boundary: child fragment keeps its partitioning; the new
            # stage's tasks each write one output file (ref planner.rs:104-132)
            (child,) = children
            writer = ShuffleWriterExec(
                job_id, self._new_stage_id(), child, [], 1
            )
            stages.append(QueryStage(job_id, writer.stage_id, writer))
            reader_placeholder = UnresolvedShuffleExec(
                writer.stage_id,
                writer.input.schema(),
                writer.input.output_partitioning().n,
                1,
            )
            return CoalescePartitionsExec(reader_placeholder)

        if isinstance(plan, HashJoinExec):
            left, right = children
            if plan.partition_mode == "partitioned":
                # both sides already cut at their HashRepartitionExec
                # boundaries (children are shuffle placeholders); the join
                # runs one task per hash bucket
                return HashJoinExec(
                    left, right, plan.on, plan.join_type, plan.filter,
                    partition_mode="partitioned",
                )
            # the collected (build) side becomes its own single-output stage
            right = self._materialize_collected(job_id, right, stages)
            return HashJoinExec(
                left, right, plan.on, plan.join_type, plan.filter
            )

        return replace_children(plan, children)

    def _materialize_collected(
        self, job_id: str, side: ExecutionPlan, stages: list[QueryStage]
    ) -> ExecutionPlan:
        if isinstance(side, UnresolvedShuffleExec):
            return side  # already a stage output
        writer = ShuffleWriterExec(job_id, self._new_stage_id(), side, [], 1)
        stages.append(QueryStage(job_id, writer.stage_id, writer))
        return UnresolvedShuffleExec(
            writer.stage_id,
            side.schema(),
            side.output_partitioning().n,
            1,
        )


def find_unresolved_shuffles(
    plan: ExecutionPlan,
) -> list[UnresolvedShuffleExec]:
    """ref planner.rs:188-205."""
    out: list[UnresolvedShuffleExec] = []

    def walk(p: ExecutionPlan) -> None:
        if isinstance(p, UnresolvedShuffleExec):
            out.append(p)
        for c in p.children():
            walk(c)

    walk(plan)
    return out


def remove_unresolved_shuffles(
    plan: ExecutionPlan,
    partition_locations: dict[int, list[list]],
) -> ExecutionPlan:
    """Replace placeholders with ShuffleReaderExec given the completed
    stages' partition locations (ref planner.rs:207-255).

    ``partition_locations[stage_id][output_partition] -> [PartitionLocation]``

    COPY-ON-WRITE: nodes on the path to a replaced placeholder are
    shallow-copied before their child slots are rebound, untouched subtrees
    are shared, and ``plan`` itself is never mutated. The scheduler depends
    on this: it keeps each stage's UNRESOLVED plan as a pristine template
    so lost-shuffle recovery can re-resolve the stage against refreshed
    partition locations after an upstream recompute (an in-place patch
    would destroy the placeholders the second resolution needs)."""
    if isinstance(plan, UnresolvedShuffleExec):
        locs = partition_locations.get(plan.stage_id)
        if locs is None:
            raise PlanError(
                f"no partition locations for stage {plan.stage_id}"
            )
        return ShuffleReaderExec(locs, plan.schema())
    children = [
        remove_unresolved_shuffles(c, partition_locations)
        for c in plan.children()
    ]
    if all(a is b for a, b in zip(plan.children(), children)):
        return plan  # no placeholder below: share the subtree
    return replace_children(copy.copy(plan), children)


def resolve_shuffles_eager(plan: ExecutionPlan, job_id: str) -> ExecutionPlan:
    """Eager-mode resolution (ballista.tpu.eager_shuffle, docs/shuffle.md):
    replace every placeholder with an EAGER ShuffleReaderExec that carries
    only the producing (job, stage) and polls the scheduler for published
    locations at execute time — usable BEFORE the producer stage fully
    completes, unlike :func:`remove_unresolved_shuffles` which needs the
    committed location set. Same copy-on-write discipline: ``plan`` stays
    the pristine template."""
    if isinstance(plan, UnresolvedShuffleExec):
        return ShuffleReaderExec(
            [[] for _ in range(plan.output_partition_count)],
            plan.schema(),
            job_id=job_id,
            stage_id=plan.stage_id,
            eager=True,
        )
    children = [resolve_shuffles_eager(c, job_id) for c in plan.children()]
    if all(a is b for a, b in zip(plan.children(), children)):
        return plan
    return replace_children(copy.copy(plan), children)
