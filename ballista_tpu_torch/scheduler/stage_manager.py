"""Stage/task bookkeeping state machine.

ref ballista/rust/scheduler/src/state/stage_manager.rs:35-605. Tracks per
stage a vector of task statuses with legal-transition validation
(:536-586 — the reference's defensive mechanism against racy status
updates), the child->parents stage dependency map (:140-155), pending /
running / completed stage sets, and emits Stage/Job events on completion.
"""

from __future__ import annotations

import dataclasses
import enum
import random

from ballista_tpu_torch.analysis.statemachine import TASK_TRANSITIONS
from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.errors import InternalError
from ballista_tpu_torch.scheduler_types import (
    PartitionId,
    ShuffleWritePartitionMeta,
)


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    FAILED = "failed"
    COMPLETED = "completed"


# Legal transitions (ref stage_manager.rs:536-586: e.g. Pending->Failed is
# ignored; Completed->Pending re-opens a stage on status reset). DERIVED
# from the canonical declared table (analysis/statemachine.py) so the
# validator and the spec racelint/property tests check against cannot
# drift apart.
_LEGAL = {
    (TaskState(src), TaskState(dst)) for src, dst in TASK_TRANSITIONS
}


@dataclasses.dataclass
class TaskInfo:
    state: TaskState = TaskState.PENDING
    executor_id: str = ""
    error: str = ""
    partitions: list[ShuffleWritePartitionMeta] = dataclasses.field(
        default_factory=list
    )
    # bounded-retry bookkeeping: attempts = FAILED transitions consumed so
    # far (the next run is attempt number `attempts`); blamed = executors
    # this task failed on or was lost from (handout prefers others)
    attempts: int = 0
    blamed: set[str] = dataclasses.field(default_factory=set)
    # fleet observability (docs/observability.md): wall-clock bounds of
    # the CURRENT attempt (stamped on the RUNNING / terminal transitions;
    # a requeue resets them) — the timeline endpoint's Gantt source and
    # the straggler monitor's duration input
    started_s: float = 0.0
    ended_s: float = 0.0
    # flagged by the straggler monitor (duration > k x stage median)
    straggler: bool = False
    # this attempt window was already fed to the duration histogram —
    # replayed COMPLETED statuses (a lost PollWork response makes the
    # executor resend; the transition replay is rejected as illegal)
    # must not observe the same window twice
    duration_metered: bool = False


@dataclasses.dataclass
class Stage:
    job_id: str
    stage_id: int
    n_tasks: int  # = input partition count of the stage's ShuffleWriter
    tasks: list[TaskInfo] = dataclasses.field(default_factory=list)
    # retry policy (session config ballista.tpu.task_max_attempts): a task
    # may consume this many attempts before its failure fails the job; the
    # same bound caps lost-shuffle recompute rounds of this stage
    max_attempts: int = 3
    # times this stage's completed output was invalidated and re-run
    # (lost-shuffle recovery); bounded by max_attempts
    recomputes: int = 0

    def __post_init__(self):
        if not self.tasks:
            self.tasks = [TaskInfo() for _ in range(self.n_tasks)]

    def counts(self) -> dict[TaskState, int]:
        out = {s: 0 for s in TaskState}
        for t in self.tasks:
            out[t.state] += 1
        return out

    @property
    def is_completed(self) -> bool:
        return all(t.state == TaskState.COMPLETED for t in self.tasks)

    @property
    def has_failed(self) -> bool:
        return any(t.state == TaskState.FAILED for t in self.tasks)


class StageEvent:
    pass


@dataclasses.dataclass(frozen=True)
class StageFinished(StageEvent):
    job_id: str
    stage_id: int


@dataclasses.dataclass(frozen=True)
class JobFinished(StageEvent):
    job_id: str


@dataclasses.dataclass(frozen=True)
class JobFailed(StageEvent):
    job_id: str
    stage_id: int
    error: str


@dataclasses.dataclass(frozen=True)
class TaskRescheduled(StageEvent):
    """A failed task was requeued (FAILED -> PENDING) for another bounded
    attempt; `attempt` is the attempt number the NEXT run will carry."""

    job_id: str
    stage_id: int
    partition_id: int
    attempt: int
    error: str


def straggler_stats(
    durations: list[float], factor: float, min_s: float
) -> tuple[float, float] | None:
    """``(threshold, median)`` for the straggler monitor over a stage's
    completed task durations, or None when no meaningful threshold
    exists (monitor disabled, fewer than 3 completions to form a
    median, or a zero median). ONE definition shared by the committing
    check (SchedulerServer._observe_task_completion) and the timeline's
    live projection (rest.job_timeline) — two hand-synced copies once
    disagreed on the median convention, making the Gantt view and the
    Prometheus counter contradict each other about the same task. The
    median rides along so flag sites don't sort the list twice."""
    import statistics

    if factor <= 0 or len(durations) < 3:
        return None
    med = statistics.median(durations)
    if med <= 0:
        return None
    return max(min_s, factor * med), med


class StageManager:
    """In-memory running/pending/completed stage maps (ref :326-356)."""

    def __init__(self) -> None:
        self._lock = make_lock("StageManager._lock", reentrant=True)
        self._stages: dict[tuple[str, int], Stage] = {}
        self._running: set[tuple[str, int]] = set()
        self._pending: set[tuple[str, int]] = set()
        self._completed: set[tuple[str, int]] = set()
        # child stage -> parent stages waiting on it (ref :140-155)
        self._dependencies: dict[tuple[str, int], set[int]] = {}
        self._final_stage: dict[str, int] = {}

    # -- registration --------------------------------------------------------
    def add_final_stage(self, job_id: str, stage_id: int) -> None:
        with self._lock:
            self._final_stage[job_id] = stage_id

    def final_stage(self, job_id: str) -> int:
        with self._lock:
            return self._final_stage[job_id]

    def add_stages_dependency(
        self, job_id: str, deps: dict[int, set[int]]
    ) -> None:
        """deps: child_stage_id -> set of parent stage ids."""
        with self._lock:
            for child, parents in deps.items():
                self._dependencies[(job_id, child)] = set(parents)

    def parents_of(self, job_id: str, stage_id: int) -> set[int]:
        with self._lock:
            return set(self._dependencies.get((job_id, stage_id), set()))

    def add_running_stage(
        self, job_id: str, stage_id: int, n_tasks: int, max_attempts: int = 3
    ) -> None:
        with self._lock:
            key = (job_id, stage_id)
            self._stages[key] = Stage(
                job_id, stage_id, n_tasks, max_attempts=max(1, max_attempts)
            )
            self._running.add(key)
            self._pending.discard(key)

    def add_pending_stage(
        self, job_id: str, stage_id: int, n_tasks: int, max_attempts: int = 3
    ) -> None:
        with self._lock:
            key = (job_id, stage_id)
            self._stages[key] = Stage(
                job_id, stage_id, n_tasks, max_attempts=max(1, max_attempts)
            )
            self._pending.add(key)

    def is_running_stage(self, job_id: str, stage_id: int) -> bool:
        with self._lock:
            return (job_id, stage_id) in self._running

    def is_pending_stage(self, job_id: str, stage_id: int) -> bool:
        with self._lock:
            return (job_id, stage_id) in self._pending

    def is_completed_stage(self, job_id: str, stage_id: int) -> bool:
        with self._lock:
            return (job_id, stage_id) in self._completed

    def get_stage(self, job_id: str, stage_id: int) -> Stage | None:
        with self._lock:
            return self._stages.get((job_id, stage_id))

    # -- scheduling ----------------------------------------------------------
    def fetch_pending_tasks(
        self, job_id: str, stage_id: int, max_n: int, executor_id: str = ""
    ) -> list[int]:
        """Pending task (partition) ids of one stage, marking nothing.

        When ``executor_id`` is given, tasks that have NOT blamed it (never
        failed on / were lost from it) sort first — the soft "prefer a
        different executor" retry placement. Soft, not hard: a blamed
        executor is still offered the task when nothing else is pending,
        so a single-executor cluster can never deadlock on its own blame
        list."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None:
                return []
            out = [
                i
                for i, t in enumerate(stage.tasks)
                if t.state == TaskState.PENDING
            ]
            if executor_id:
                out.sort(
                    key=lambda i: executor_id in stage.tasks[i].blamed
                )
            return out[:max_n]

    def task_attempt(self, job_id: str, stage_id: int, partition: int) -> int:
        """Attempt number the next/current run of this task carries (= the
        count of FAILED transitions consumed so far)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None or not (0 <= partition < stage.n_tasks):
                return 0
            return stage.tasks[partition].attempts

    def assign_next_task(
        self, executor_id: str = ""
    ) -> tuple[str, int, int, int, list["StageEvent"]] | None:
        """Atomically pick a schedulable stage, choose a pending task
        (blame-aware soft preference), and mark it RUNNING. Returns
        ``(job_id, stage_id, partition, attempt, events)`` or None.

        One critical section closes the pick/mark race: two concurrent
        PollWork threads could both observe the same partition PENDING,
        and the loser's PENDING->RUNNING mark was silently ignored as an
        illegal RUNNING->RUNNING hop — both executors then ran the same
        task (wasted slot at best, double-reported completions at
        worst)."""
        with self._lock:
            pick = self.fetch_schedulable_stage()
            if pick is None:
                return None
            job_id, stage_id = pick
            pending = self.fetch_pending_tasks(
                job_id, stage_id, 1, executor_id=executor_id
            )
            if not pending:
                return None
            partition = pending[0]
            events = self.update_task_status(
                PartitionId(job_id, stage_id, partition),
                TaskState.RUNNING,
                executor_id=executor_id,
            )
            attempt = self.task_attempt(job_id, stage_id, partition)
            return job_id, stage_id, partition, attempt, events

    def assign_next_tasks(
        self, executor_id: str = "", max_n: int = 1
    ) -> list[tuple[str, int, int, int, list["StageEvent"]]]:
        """Batched :meth:`assign_next_task` (docs/serving.md): up to
        ``max_n`` picks inside ONE critical section, so a single PollWork
        round-trip can carry a full grant batch without re-racing the
        pick/mark window per task. Picks may span stages/jobs — each
        iteration re-fetches the schedulable stage, so a stage drained
        mid-batch simply hands the remaining slots to the next one."""
        out: list[tuple[str, int, int, int, list["StageEvent"]]] = []
        with self._lock:
            for _ in range(max(1, max_n)):
                got = self.assign_next_task(executor_id)
                if got is None:
                    break
                out.append(got)
        return out

    def assign_next_eager_task(
        self, executor_id: str, eager_jobs: set[str]
    ) -> tuple[str, int, int, int, list["StageEvent"]] | None:
        """Eager-shuffle handout (docs/shuffle.md): atomically pick a task
        from a PENDING consumer stage whose producers are all in flight
        with at least one committed map output, and mark it RUNNING.
        Called only when :meth:`assign_next_task` found no runnable work,
        so eager consumers never compete with normal tasks for slots —
        they soak otherwise-idle capacity with early fetch work.

        ``eager_jobs``: jobs whose session enabled ballista.tpu.
        eager_shuffle (the server snapshots the flag at submission).
        Promotion stays the commit point: the stage remains PENDING and is
        promoted exactly as in barriered mode once every producer
        completes."""
        with self._lock:
            candidates = []
            for key in self._pending:  # detlint: nondet=placement
                job_id, stage_id = key
                if job_id not in eager_jobs:
                    continue
                stage = self._stages.get(key)
                if stage is None or not any(
                    t.state == TaskState.PENDING for t in stage.tasks
                ):
                    continue
                producers = [
                    child
                    for (jid, child), parents in self._dependencies.items()
                    if jid == job_id and stage_id in parents
                ]
                if not producers:
                    continue
                ready = True
                for p in producers:
                    ps = self._stages.get((job_id, p))
                    if ps is None or not any(
                        t.state == TaskState.COMPLETED for t in ps.tasks
                    ):
                        ready = False
                        break
                if ready:
                    candidates.append(key)
            if not candidates:
                return None
            job_id, stage_id = random.choice(  # detlint: nondet=placement
                candidates
            )
            pending = self.fetch_pending_tasks(
                job_id, stage_id, 1, executor_id=executor_id
            )
            if not pending:
                return None
            partition = pending[0]
            events = self.update_task_status(
                PartitionId(job_id, stage_id, partition),
                TaskState.RUNNING,
                executor_id=executor_id,
            )
            attempt = self.task_attempt(job_id, stage_id, partition)
            return job_id, stage_id, partition, attempt, events

    def shuffle_locations(
        self, job_id: str, stage_id: int, partition: int
    ) -> tuple[list[tuple[int, str, ShuffleWritePartitionMeta]], int, bool] | None:
        """Eager-poll snapshot for GetShuffleLocations: the published
        (COMPLETED) map outputs of one stage feeding ``partition``, as
        ``(entries, tasks_done_prefix, complete)`` where entries are
        ``(map task index, executor_id, meta)`` in task order and the
        prefix counts leading COMPLETED tasks (lineage recovery may
        shrink it; readers never consume beyond it pre-commit). None when
        the stage bookkeeping is gone (job finished or torn down)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None:
                return None
            entries = []
            prefix = 0
            counting = True
            complete = True
            for i, t in enumerate(stage.tasks):
                if t.state == TaskState.COMPLETED:
                    if counting:
                        prefix = i + 1
                    for m in t.partitions:
                        if m.partition_id == partition:
                            entries.append((i, t.executor_id, m))
                else:
                    counting = False
                    complete = False
            return entries, prefix, complete

    def fetch_schedulable_stage(self) -> tuple[str, int] | None:
        """A random running stage with pending tasks (ref :300-324 — random
        pick avoids head-of-line blocking across jobs)."""
        with self._lock:
            candidates = [
                key
                for key in self._running  # detlint: nondet=placement
                if any(
                    t.state == TaskState.PENDING
                    for t in self._stages[key].tasks
                )
            ]
            if not candidates:
                return None
            return random.choice(candidates)  # detlint: nondet=placement

    # -- status updates ------------------------------------------------------
    def update_task_status(
        self,
        task_id: PartitionId,
        new_state: TaskState,
        executor_id: str = "",
        error: str = "",
        partitions: list[ShuffleWritePartitionMeta] | None = None,
        retryable: bool = True,
        count_attempt: bool = True,
    ) -> list[StageEvent]:
        """Apply one task status; illegal transitions are ignored (the
        reference rejects them rather than corrupting counts, :536-586).
        Returns stage/job events triggered by this update.

        A FAILED update consumes one bounded attempt: while attempts remain
        and the error is ``retryable``, the task is immediately requeued
        through the legal FAILED -> PENDING transition (blaming the
        executor so the next handout prefers a different one) and a
        :class:`TaskRescheduled` event fires instead of :class:`JobFailed`.
        ``retryable=False`` (deterministic errors — PlanVerificationError
        and friends, see errors.NON_RETRYABLE_ERROR_TYPES) short-circuits
        straight to JobFailed: re-running cannot change the outcome.
        ``count_attempt=False`` requeues without consuming an attempt —
        used for shuffle-fetch failures, which blame the *producing*
        executor, not this task; their boundedness comes from the
        producing stage's recompute cap instead."""
        with self._lock:
            key = (task_id.job_id, task_id.stage_id)
            stage = self._stages.get(key)
            if stage is None:
                # late status for a removed (failed/finished) job — drop it
                # rather than corrupting counts (ref :536-586 is equally
                # defensive about out-of-band updates)
                return []
            if not (0 <= task_id.partition_id < stage.n_tasks):
                raise InternalError(
                    f"task partition {task_id.partition_id} out of range "
                    f"for stage with {stage.n_tasks} tasks"
                )
            info = stage.tasks[task_id.partition_id]
            if (info.state, new_state) not in _LEGAL:
                return []
            blamed_executor = executor_id or info.executor_id
            import time as _time

            # attempt wall-clock bounds (timeline + straggler monitor):
            # RUNNING opens a fresh window, terminal states close it, and
            # any PENDING re-open (requeue, invalidation) clears it
            if new_state == TaskState.RUNNING:
                info.started_s = _time.time()
                info.ended_s = 0.0
            elif new_state in (TaskState.COMPLETED, TaskState.FAILED):
                info.ended_s = _time.time()
            elif new_state == TaskState.PENDING:
                info.started_s = 0.0
                info.ended_s = 0.0
                info.duration_metered = False
            info.state = new_state
            info.executor_id = executor_id or info.executor_id
            info.error = error
            if partitions is not None:
                info.partitions = list(partitions)

            events: list[StageEvent] = []
            if new_state == TaskState.FAILED:
                if blamed_executor:
                    info.blamed.add(blamed_executor)
                if count_attempt:
                    info.attempts += 1
                if not retryable:
                    events.append(
                        JobFailed(task_id.job_id, task_id.stage_id, error)
                    )
                elif info.attempts >= stage.max_attempts:
                    events.append(
                        JobFailed(
                            task_id.job_id,
                            task_id.stage_id,
                            f"task {task_id} failed after "
                            f"{info.attempts} attempts: {error}",
                        )
                    )
                else:
                    # bounded requeue (FAILED -> PENDING, the legal
                    # transition the reference declares but never takes)
                    info.state = TaskState.PENDING
                    info.executor_id = ""
                    info.started_s = 0.0
                    info.ended_s = 0.0
                    info.duration_metered = False
                    events.append(
                        TaskRescheduled(
                            task_id.job_id,
                            task_id.stage_id,
                            task_id.partition_id,
                            info.attempts,
                            error,
                        )
                    )
            elif stage.is_completed and key in self._running:
                self._running.discard(key)
                self._completed.add(key)
                if self._final_stage.get(task_id.job_id) == task_id.stage_id:
                    events.append(JobFinished(task_id.job_id))
                else:
                    events.append(
                        StageFinished(task_id.job_id, task_id.stage_id)
                    )
            return events

    def promote_pending_stage(self, job_id: str, stage_id: int) -> list[StageEvent]:
        """Pending -> running. Returns completion events in the (rare) case
        every task already COMPLETED while the stage sat pending — possible
        after lost-shuffle recovery demotes a running stage whose in-flight
        tasks then all report success; without this check the stage would
        re-enter running fully complete and no status update would ever
        fire its StageFinished/JobFinished."""
        with self._lock:
            key = (job_id, stage_id)
            if key not in self._pending:
                return []
            self._pending.discard(key)
            self._running.add(key)
            stage = self._stages[key]
            if not stage.is_completed:
                return []
            self._running.discard(key)
            self._completed.add(key)
            if self._final_stage.get(job_id) == stage_id:
                return [JobFinished(job_id)]
            return [StageFinished(job_id, stage_id)]

    def demote_running_stage(self, job_id: str, stage_id: int) -> None:
        """Running -> pending: a dependency's output was invalidated
        (lost shuffle), so no further task of this stage may be handed out
        until the dependency re-completes and locations are re-resolved.
        In-flight RUNNING tasks keep running (they either fetched the data
        before the loss — their output is valid — or will fail with a
        ShuffleFetchError and requeue)."""
        with self._lock:
            key = (job_id, stage_id)
            if key in self._running:
                self._running.discard(key)
                self._pending.add(key)

    def invalidate_executor_outputs(
        self, job_id: str, stage_id: int, executor_ids: set[str]
    ) -> list[PartitionId]:
        """Lost-shuffle recovery, producer side: COMPLETED tasks of this
        stage whose shuffle files live on one of ``executor_ids`` are
        re-opened (the legal COMPLETED -> PENDING transition) with their
        partition metadata dropped, and a completed stage rolls back to
        running so exactly the lost map partitions re-run. Blames the dead
        executor on each re-opened task and counts one recompute round
        against the stage. Returns the re-opened task ids (empty when the
        executor produced nothing here — e.g. a concurrent failure already
        invalidated it)."""
        out: list[PartitionId] = []
        with self._lock:
            key = (job_id, stage_id)
            stage = self._stages.get(key)
            if stage is None:
                return []
            for i, t in enumerate(stage.tasks):
                if (
                    t.state == TaskState.COMPLETED
                    and t.executor_id in executor_ids
                ):
                    t.state = TaskState.PENDING
                    t.blamed.add(t.executor_id)
                    t.executor_id = ""
                    t.partitions = []
                    t.started_s = 0.0
                    t.ended_s = 0.0
                    t.duration_metered = False
                    out.append(PartitionId(job_id, stage_id, i))
            if out:
                stage.recomputes += 1
                if key in self._completed:
                    self._completed.discard(key)
                    self._running.add(key)
        return out

    def rebind_stages_for_rewrite(
        self,
        job_id: str,
        affected: dict[int, int],
        removed: tuple[int, ...],
        added: dict[int, int],
        deps: dict[int, set[int]],
        max_attempts: int = 3,
    ) -> str | None:
        """Atomically re-register bookkeeping for a certified rewrite
        (SchedulerServer.apply_certified_rewrite): ``affected`` maps every
        rewritten stage id to its (possibly changed) task count,
        ``removed``/``added`` are the exchange-elimination/-injection
        deltas, ``deps`` is the job's full recomputed dependency map.

        Runtime precondition, checked under the lock before anything
        changes: every touched stage must be fully PENDING — no task
        running or completed, no completed stage. A stage with progress
        holds results computed against the OLD template (a producer's
        files already bucketed the old way, a consumer task mid-fetch),
        and swapping under it is exactly the uncertified mutation this
        API exists to prevent. Returns an error string on violation
        (nothing mutated — the caller rejects and keeps the pristine
        templates); None on success. Rewritten stages land PENDING (the
        caller re-resolves and promotes the ones whose deps are already
        complete); ``recomputes`` carries over so lineage-recovery
        boundedness survives a rewrite."""
        with self._lock:
            for sid in list(affected) + list(removed):
                key = (job_id, sid)
                stage = self._stages.get(key)
                if stage is None:
                    return f"stage {sid} has no bookkeeping to rebind"
                if key in self._completed:
                    return f"stage {sid} already completed"
                busy = [
                    t.state.value
                    for t in stage.tasks
                    if t.state != TaskState.PENDING
                ]
                if busy:
                    return (
                        f"stage {sid} has {len(busy)} non-pending tasks "
                        f"({sorted(set(busy))}); rewrites require a fully "
                        "pending stage"
                    )
            for sid, n_tasks in affected.items():
                key = (job_id, sid)
                old = self._stages[key]
                fresh = Stage(
                    job_id, sid, n_tasks, max_attempts=old.max_attempts
                )
                fresh.recomputes = old.recomputes
                self._stages[key] = fresh
                self._running.discard(key)
                self._pending.add(key)
            for sid in removed:
                key = (job_id, sid)
                self._stages.pop(key, None)
                self._running.discard(key)
                self._pending.discard(key)
            for sid, n_tasks in added.items():
                key = (job_id, sid)
                self._stages[key] = Stage(
                    job_id, sid, n_tasks, max_attempts=max(1, max_attempts)
                )
                self._pending.add(key)
            # dependency map: wholesale replacement for this job — stale
            # entries (including removed stages') all drop here
            for key in [k for k in self._dependencies if k[0] == job_id]:
                self._dependencies.pop(key)
            for child, parents in deps.items():
                self._dependencies[(job_id, child)] = set(parents)
            return None

    def stages_with_outputs_of(
        self, executor_ids: set[str]
    ) -> list[tuple[str, int]]:
        """Stages holding COMPLETED shuffle output produced by one of
        ``executor_ids`` — the candidates for lost-shuffle invalidation
        when those executors expire."""
        with self._lock:
            return [
                key
                for key, stage in self._stages.items()
                if any(
                    t.state == TaskState.COMPLETED
                    and t.executor_id in executor_ids
                    for t in stage.tasks
                )
            ]

    def take_unmetered_runtime(
        self, job_id: str, stage_id: int, partition: int
    ) -> float | None:
        """Duration (seconds) of a task's CURRENT closed attempt window,
        consumed EXACTLY ONCE (atomic under the lock): a replayed
        COMPLETED status — the executor resends after a lost RPC
        response, and the transition replay is rejected — gets None, so
        the stage-task histogram never double-counts one window. A
        PENDING re-open clears the flag with the window (a genuine new
        attempt meters again)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None or not (0 <= partition < stage.n_tasks):
                return None
            t = stage.tasks[partition]
            if t.duration_metered or not (t.started_s and t.ended_s):
                return None
            t.duration_metered = True
            return max(0.0, t.ended_s - t.started_s)

    def completed_durations(
        self, job_id: str, stage_id: int
    ) -> list[float]:
        """Closed-attempt durations of this stage's COMPLETED tasks (the
        straggler monitor's median base)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None:
                return []
            return [
                t.ended_s - t.started_s
                for t in stage.tasks
                if t.state == TaskState.COMPLETED
                and t.started_s
                and t.ended_s
            ]

    def mark_straggler(
        self, job_id: str, stage_id: int, partition: int
    ) -> bool:
        """Flag one task as a straggler (idempotent; returns whether the
        flag was newly set — the counter increments only once)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None or not (0 <= partition < stage.n_tasks):
                return False
            t = stage.tasks[partition]
            if t.straggler:
                return False
            t.straggler = True
            return True

    def all_tasks_pending(self, job_id: str, stage_id: int) -> bool:
        """True when every task of the stage is PENDING — the rewrite
        window (rebind_stages_for_rewrite's precondition). Eager-shuffle
        handout can start a PENDING stage's tasks early, which closes
        the window without promoting the stage; the AQE policy checks
        here before proposing a mid-job rewrite (docs/aqe.md)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None:
                return False
            return all(t.state == TaskState.PENDING for t in stage.tasks)

    def stage_recomputes(self, job_id: str, stage_id: int) -> int:
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            return stage.recomputes if stage is not None else 0

    def stage_max_attempts(self, job_id: str, stage_id: int) -> int:
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            return stage.max_attempts if stage is not None else 3

    def completed_partitions(
        self, job_id: str, stage_id: int
    ) -> list[tuple[int, str, list[ShuffleWritePartitionMeta]]]:
        """[(task/partition index, executor_id, written files)] of a
        completed stage (feeds PartitionLocation resolution)."""
        with self._lock:
            stage = self._stages.get((job_id, stage_id))
            if stage is None:
                return []
            return [
                (i, t.executor_id, list(t.partitions))
                for i, t in enumerate(stage.tasks)
                if t.state == TaskState.COMPLETED
            ]

    def remove_job_stages(self, job_id: str) -> None:
        """Drop every stage of a finished/failed job so dead tasks can't be
        scheduled again and inflight counts (the KEDA signal) go to zero."""
        with self._lock:
            keys = [k for k in self._stages if k[0] == job_id]
            for k in keys:
                self._stages.pop(k, None)
                self._running.discard(k)
                self._pending.discard(k)
                self._completed.discard(k)
                self._dependencies.pop(k, None)
            self._final_stage.pop(job_id, None)

    def reset_tasks_of_executors(
        self, executor_ids: set[str]
    ) -> list[PartitionId]:
        """Executor-lost recovery: every RUNNING task assigned to one of
        ``executor_ids`` goes back to PENDING (the RUNNING->PENDING legal
        transition, ref stage_manager.rs:553-558) so the next offer/poll can
        hand it to a live executor. Returns the reset task ids."""
        out: list[PartitionId] = []
        with self._lock:
            for (job_id, stage_id), stage in self._stages.items():
                for i, t in enumerate(stage.tasks):
                    if (
                        t.state == TaskState.RUNNING
                        and t.executor_id in executor_ids
                    ):
                        t.state = TaskState.PENDING
                        # blame (prefer another executor next time) but do
                        # NOT consume an attempt: the executor died, the
                        # task did nothing wrong
                        t.blamed.add(t.executor_id)
                        t.executor_id = ""
                        t.started_s = 0.0
                        t.ended_s = 0.0
                        t.duration_metered = False
                        out.append(PartitionId(job_id, stage_id, i))
        return out

    def job_stage_summary(self, job_id: str) -> list[dict]:
        """Read-only per-stage snapshot for the REST /api/state payload:
        stage id, DAG state, and task-state counts (ref ui job detail)."""
        with self._lock:
            out = []
            keys = sorted(k for k in self._stages if k[0] == job_id)
            for key in keys:
                _, sid = key
                stage = self._stages[key]
                state = (
                    "completed" if key in self._completed
                    else "running" if key in self._running
                    else "pending"
                )
                counts = stage.counts()
                out.append(
                    {
                        "stage_id": sid,
                        "state": state,
                        "n_tasks": stage.n_tasks,
                        "tasks": {
                            s.value: n for s, n in counts.items()
                        },
                        # retry visibility: total failed attempts consumed
                        # across this stage's tasks + lost-shuffle
                        # recompute rounds (both 0 on a clean run)
                        "attempts": sum(t.attempts for t in stage.tasks),
                        "recomputes": stage.recomputes,
                    }
                )
            return out

    def job_stage_detail(self, job_id: str) -> list[dict]:
        """Per-stage, per-task stats snapshot (docs/observability.md):
        everything /api/job/<id> and EXPLAIN ANALYZE aggregation need —
        task state, attempts, executor, and the written shuffle output's
        rows/bytes/batches summed over the task's output partitions. The
        scheduler overlays per-operator metrics (JobInfo.op_metrics) on
        top; this stays a pure StageManager view so it can be snapshotted
        before job teardown."""
        with self._lock:
            out = []
            keys = sorted(k for k in self._stages if k[0] == job_id)
            for key in keys:
                _, sid = key
                stage = self._stages[key]
                state = (
                    "completed" if key in self._completed
                    else "running" if key in self._running
                    else "pending"
                )
                tasks = []
                for i, t in enumerate(stage.tasks):
                    tasks.append(
                        {
                            "partition": i,
                            "state": t.state.value,
                            "attempts": t.attempts,
                            "executor_id": t.executor_id,
                            "output_rows": sum(
                                m.num_rows for m in t.partitions
                            ),
                            "output_bytes": sum(
                                m.num_bytes for m in t.partitions
                            ),
                            "output_batches": sum(
                                m.num_batches for m in t.partitions
                            ),
                            # push-shuffle visibility (docs/shuffle.md):
                            # how many of this task's output partitions
                            # committed in memory vs on disk
                            "output_pushed": sum(
                                1 for m in t.partitions if m.push
                            ),
                            # timeline (docs/observability.md): the
                            # current attempt's wall-clock window + the
                            # straggler-monitor flag
                            "started_s": round(t.started_s, 6),
                            "ended_s": round(t.ended_s, 6),
                            "straggler": t.straggler,
                        }
                    )
                out.append(
                    {
                        "stage_id": sid,
                        "state": state,
                        "n_tasks": stage.n_tasks,
                        "recomputes": stage.recomputes,
                        "tasks": tasks,
                    }
                )
            return out

    def has_running_tasks(self) -> bool:
        with self._lock:
            return any(
                t.state == TaskState.RUNNING
                for s in self._stages.values()
                for t in s.tasks
            )

    def inflight_tasks(self) -> int:
        with self._lock:
            return sum(
                1
                for s in self._stages.values()
                for t in s.tasks
                if t.state in (TaskState.PENDING, TaskState.RUNNING)
            )
