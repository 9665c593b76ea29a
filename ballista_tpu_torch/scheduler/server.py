"""SchedulerServer: query/stage orchestration + gRPC service.

Combines the reference's SchedulerServer (scheduler_server/mod.rs:54-232),
gRPC handlers (scheduler_server/grpc.rs:57-553), and QueryStageScheduler
event loop (scheduler_server/query_stage_scheduler.rs:40-473):

  ExecuteQuery -> plan (SQL -> logical -> optimized -> physical)
              -> JobSubmitted event -> DistributedPlanner stage split
              -> stage DAG submit (running if deps resolved, else pending)
  PollWork    -> heartbeat + apply statuses + hand out <=1 task (pull mode)
  StageFinished -> resolve dependent stages (patch shuffle locations)
  JobFinished -> assemble CompletedJob partition locations

Port of ``ballista_tpu/scheduler/server.py``. The scheduler plans and
never runs an operator: planning a memory scan uploads nothing (the
scans' device cache fills when an executor runs the task), so the
scheduler needs no card. Where the port differs:

- **Planning** uses the port's ``PhysicalPlanner`` with no mesh runtime:
  port executors advertise one device, so no stage lowers to the mesh
  operators (ROADMAP queue 1, item 10b).
- **AQE** (``scheduler/aqe.py``) and ``apply_certified_rewrite`` are the
  reference's: ``ballista.tpu.aqe=true`` (or ``BALLISTA_AQE=1``) turns the
  policy on, and every adaptation is a certified rewrite
  (``rewrite.py``) accepted here.
- **File tables**: a query's file scans are planned from the source in
  its logical plan; the scheduler reads no row of the file (row groups are
  pruned when an executor runs the task). ``GetFileMetadata`` reads a
  Parquet footer only.

The KEDA external scaler (``scheduler/external_scaler.py``) shares the
gRPC port, the REST API (``scheduler/rest.py``, with ``/api/metrics``)
reads this server's state, and ``scheduler/etcd_backend.py`` is one of
its state backends, as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import string
import threading

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
from ballista_tpu_torch.distributed_plan import (
    DistributedPlanner,
    QueryStage,
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
)
from ballista_tpu_torch.errors import (
    PlanError,
    RewriteRejected,
    error_is_retryable,
    parse_shuffle_fetch_error,
)
from ballista_tpu_torch.event_loop import EventAction, EventLoop
from ballista_tpu_torch.exec.base import ExecutionPlan
from ballista_tpu_torch.exec.planner import PhysicalPlanner, TableProvider
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler.executor_manager import ExecutorManager
from ballista_tpu_torch.scheduler.stage_manager import (
    JobFailed,
    JobFinished,
    StageFinished,
    StageManager,
    TaskRescheduled,
    TaskState,
)
from ballista_tpu_torch.scheduler_types import (
    ExecutorData,
    ExecutorMetadata,
    ExecutorSpecification,
    PartitionId,
    PartitionLocation,
    ShuffleWritePartitionMeta,
)
from ballista_tpu_torch.serde import BallistaCodec, loc_to_proto
from ballista_tpu_torch.sql import ast
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner

log = logging.getLogger(__name__)


def generate_job_id() -> str:
    """7-char alnum ids (ref grpc.rs:546-553)."""
    return "".join(  # detlint: nondet=id-minting
        random.choices(string.ascii_lowercase + string.digits, k=7)
    )


def _stage_dependencies(stages) -> dict[int, set[int]]:
    """child stage id -> parent stage ids (parents consume the child),
    recomputed from placeholders — shared by initial stage generation and
    the certified-rewrite swap (exchange injection/removal changes the
    edge set)."""
    deps: dict[int, set[int]] = {}
    for stage in stages:
        for u in find_unresolved_shuffles(stage.plan):
            deps.setdefault(u.stage_id, set()).add(stage.stage_id)
    return deps


@dataclasses.dataclass
class JobInfo:
    job_id: str
    session_id: str
    status: str = "queued"  # queued | running | failed | completed
    error: str = ""
    stages: dict[int, QueryStage] = dataclasses.field(default_factory=dict)
    # child stage id -> parent stage ids (parents consume the child)
    dependencies: dict[int, set[int]] = dataclasses.field(default_factory=dict)
    final_stage_id: int = 0
    completed_locations: list[PartitionLocation] = dataclasses.field(
        default_factory=list
    )
    # resolved (shuffle-patched) serialized plans, per stage. Invalidated
    # for a consumer stage whenever a dependency's shuffle output is lost
    # (the stage's pristine plan in `stages` is then re-resolved against
    # refreshed locations once the producer re-completes).
    resolved_plan_bytes: dict[int, bytes] = dataclasses.field(
        default_factory=dict
    )
    # eager-shuffle (docs/shuffle.md): session flag snapshot + serialized
    # EAGER resolutions per stage. Eager plans carry no locations (readers
    # poll), so unlike resolved_plan_bytes they are never invalidated by
    # lost-shuffle recovery.
    eager: bool = False
    eager_plan_bytes: dict[int, bytes] = dataclasses.field(
        default_factory=dict
    )
    # retry policy snapshot (session config at submission) + visibility
    # counters that outlive the per-stage bookkeeping (torn down at job
    # completion): bounded task retries + lost-shuffle recompute rounds
    max_attempts: int = 3
    total_retries: int = 0
    total_recomputes: int = 0
    # certified plan rewrites (ballista_tpu_torch/rewrite.py): accepted swaps of
    # stage templates + certificate-validation rejections (visibility for
    # REST and the chaos suites; both 0 on a non-adaptive run)
    total_rewrites: int = 0
    total_rewrite_rejects: int = 0
    # per-rewrite decision log (docs/aqe.md): one dict per
    # apply_certified_rewrite call — op, stage ids, outcome, and the
    # failing certificate clause on a reject — served by /api/job/<id>
    # so the UI can explain WHY a stage's shape changed mid-job
    rewrite_log: list = dataclasses.field(default_factory=list)
    # stage ids touched by ACCEPTED rewrites (the /timeline "rewritten"
    # marker: a Gantt row whose partition count changed mid-job says so)
    rewritten_stages: set = dataclasses.field(default_factory=set)
    # AQE policy decisions (scheduler/aqe.py): applied/rejected/learned,
    # with before/after stats — the policy-level view layered over
    # rewrite_log
    aqe_decisions: list = dataclasses.field(default_factory=list)
    # observability (docs/observability.md). trace_id is minted at
    # submission when the session's ballista.tpu.trace is not "off";
    # empty trace_id IS the zero-overhead off path (no span is ever
    # created for this job anywhere in the system).
    trace_id: str = ""
    root_span_id: str = ""
    # open stage spans (obs.trace.Span), by stage id — their span_id is
    # the parent stamped onto task-attempt props
    stage_spans: dict = dataclasses.field(default_factory=dict)
    # the job's reassembled span store, keyed by span_id (dict = dedup:
    # in-proc standalone clusters can see a scheduler-recorded span come
    # back through the executor shipping path)
    spans: dict = dataclasses.field(default_factory=dict)
    # per-(stage_id, partition) operator-metric records shipped home in
    # CompletedTask (obs.profile.operator_metrics shape)
    op_metrics: dict = dataclasses.field(default_factory=dict)
    # per-stage/per-task stats snapshot taken at job completion/failure —
    # the stage bookkeeping is torn down then, and /api/job must keep
    # serving the run's stats afterwards
    stage_stats: list | None = None
    # the OPEN root span (finished at job completion/failure)
    root_span: object = None
    # fleet observability (docs/observability.md): the query-class label
    # (obs.qclass.plan_class — repeated query shapes share one series),
    # submission + first-task-assignment timestamps (queue wait = the
    # gap), and the skew monitor's flagged (stage, partition) pairs
    query_class: str = "unknown"
    submitted_s: float = 0.0
    first_assign_s: float = 0.0
    skew_flags: list = dataclasses.field(default_factory=list)
    # cost accounting (docs/observability.md): the job's aggregated
    # resource cost vector (obs.history.CostVector), summed from every
    # attempt's shipped cost — failed/retried/recomputed attempts
    # included, because the tenant paid for them too. None until the
    # first costed attempt reports (accounting off = stays None).
    cost: object = None
    # serving fast path (docs/serving.md): the result-cache key this
    # job's committed result will be stored under (None = uncacheable or
    # cache off); the cached Arrow IPC payload when the job was SERVED
    # from the cache (GetJobStatus ships it in CompletedJob.result_ipc);
    # and the single-stage-bypass flag (task granted/completed outside
    # the stage state machine).
    cache_key: object = None
    result_ipc: bytes = b""
    bypass: bool = False


@dataclasses.dataclass(frozen=True)
class JobSubmitted:
    job_id: str
    plan: ExecutionPlan


@dataclasses.dataclass(frozen=True)
class ReviveOffers:
    """Push-mode dispatch tick (ref scheduler_server/event_loop.rs:35-169:
    SchedulerServerEvent::ReviveOffers)."""

    n: int = 1


class QueryStageScheduler(EventAction):
    """The stage DAG state machine (ref query_stage_scheduler.rs:40-473)."""

    def __init__(self, server: "SchedulerServer"):
        self.server = server

    def on_receive(self, event):
        s = self.server
        if isinstance(event, ReviveOffers):
            s._offer_resources()
            return None
        if isinstance(event, JobSubmitted):
            try:
                s._generate_stages(event.job_id, event.plan)
            except Exception as e:  # noqa: BLE001
                # stage persistence/serialization failures after planning
                # must FAIL the job — an escaped exception here previously
                # left it "running" forever (clients poll indefinitely)
                log.exception("stage submission failed for %s", event.job_id)
                s._on_job_failed(
                    event.job_id, f"stage submission failed: {e}"
                )
        elif isinstance(event, TaskRescheduled):
            s._on_task_rescheduled(event)
        elif isinstance(event, StageFinished):
            s._on_stage_finished(event.job_id, event.stage_id)
        elif isinstance(event, JobFinished):
            s._on_job_finished(event.job_id)
        elif isinstance(event, JobFailed):
            s._on_job_failed(event.job_id, event.error)
        else:
            log.warning("unknown scheduler event %r", event)
            return None
        # push mode: every stage/job event can unlock work — re-offer (ref
        # query_stage_scheduler.rs:403-408)
        if s.policy == TaskSchedulingPolicy.PUSH_STAGED:
            return ReviveOffers()
        return None


class SchedulerServer:
    """State + event loop. The gRPC servicer (:class:`SchedulerGrpcServicer`)
    and the REST API both drive this object."""

    def __init__(
        self,
        provider: TableProvider,
        config: BallistaConfig | None = None,
        state_backend=None,
        namespace: str = "default",
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
        executor_timeout_s: float = 60.0,
        expiry_check_interval_s: float = 15.0,
    ):
        """``state_backend``: a
        :class:`ballista_tpu_torch.scheduler.state_backend.StateBackendClient`;
        when given, executors/sessions/jobs/stage-plans write through to it
        and a new SchedulerServer over the same backend recovers them (ref
        persistent_state.rs:85-181 + the restart test :401-525)."""
        self.provider = provider
        self.config = config or BallistaConfig()
        # the scheduler plans queries, so it must resolve UDF names too
        # (plugin.py contract: client, scheduler, and executors all load
        # the same plugin dir; $BALLISTA_PLUGIN_DIR is always consulted)
        from ballista_tpu_torch.plugin import load_plugins

        load_plugins(self.config.plugin_dir() or None)
        self.codec = BallistaCodec(provider=provider)
        self.stage_manager = StageManager()
        self.executor_manager = ExecutorManager()
        self.jobs: dict[str, JobInfo] = {}
        self.sessions: dict[str, BallistaConfig] = {}
        self.policy = policy
        # push mode: the scheduler dials each executor's gRPC back at
        # registration (ref grpc.rs:180-192) and launches tasks through it
        self.executor_clients: dict[str, object] = {}
        self._executor_channels: dict[str, object] = {}
        # consecutive LaunchTask failures per executor; an executor that
        # heartbeats but can't be dialed (NAT, bad --external-host) would
        # otherwise soak offers forever
        self._launch_failures: dict[str, int] = {}
        self.max_launch_failures = 3
        self._lock = make_lock("SchedulerServer._lock", reentrant=True)
        # observability (docs/observability.md): trace_id -> job_id for
        # span ingestion from executor RPCs, and the cross-job counter
        # aggregation the /api/metrics plane serves — both guarded by
        # _lock like the job map they shadow. _obs_retained bounds the
        # HEAVY per-job payloads (spans, op_metrics, stage_stats) across
        # terminal jobs: the jobs dict itself has always kept light
        # JobInfo records forever, but with the shipping collector
        # default-on every completed task now adds per-operator records —
        # unbounded retention would leak a long-lived scheduler dry.
        self._traces: dict[str, str] = {}
        self.obs_task_counters: dict[str, float] = {}
        self._obs_retained: collections.deque = collections.deque()
        self.obs_retained_jobs = 50
        # fleet-level distributional plane (docs/observability.md): an
        # INSTANCE registry (never the executor-process module registry —
        # an in-proc standalone cluster would double-count shipped
        # deltas) holding the scheduler's own latency observations plus
        # everything executors ship home on poll/heartbeat
        from ballista_tpu_torch.obs import hist as obs_hist

        self.hists = obs_hist.Registry("scheduler")
        self._h_job_latency = self.hists.histogram(
            "ballista_job_latency_seconds",
            "End-to-end job latency (submit -> completed) by query class",
            ("class",),
        )
        self._h_queue_wait = self.hists.histogram(
            "ballista_queue_wait_seconds",
            "Queue wait (submit -> first task assignment) by query class",
            ("class",),
        )
        self._h_stage_task = self.hists.histogram(
            "ballista_stage_task_seconds",
            "Per-task durations by query class and stage",
            ("class", "stage"),
        )
        self._h_dispatch_lag = self.hists.histogram(
            "ballista_event_dispatch_lag_seconds",
            "Scheduler event-loop dispatch lag (post -> handler entry)",
            (),
        )
        # straggler/skew counters by query class + the recent queue-wait
        # window the composite autoscale signal reads (p90 of the last N
        # waits — a cumulative histogram cannot answer "right now").
        # Entries are (recorded_at, wait_s): the p90 is computed over a
        # RECENCY window, not just the last N samples — with no arrivals
        # nothing new is appended, and a count-only window would keep a
        # burst's waits applying the 4x scale-up long after the queue
        # drained.
        self.obs_straggler_total: dict[str, int] = {}
        self.obs_skew_total: dict[str, int] = {}
        self._recent_queue_waits: collections.deque = collections.deque(
            maxlen=64
        )
        self.queue_wait_window_s = 120.0
        # bounded label cardinality (no-silent-caps): the class
        # fingerprint keeps literal differences distinct, so a
        # parameterized workload (WHERE id = <user>) could mint one
        # class per literal — every class creates never-evicted
        # histogram children here AND on every executor. Beyond the cap,
        # new shapes aggregate under "overflow" and the overflow is
        # COUNTED (ballista_query_class_overflow_total).
        self._known_classes: set[str] = set()
        self.max_query_classes = 256
        self.obs_class_overflow = 0
        # per-query-class resource-cost rollup (docs/observability.md):
        # the ballista_job_cost_total counter family /api/metrics serves.
        # Guarded by _lock like the other obs aggregations.
        self.obs_class_cost: dict[str, dict[str, float]] = {}
        # queryable history (docs/observability.md): the append-only
        # job-lifecycle log. Written through the SAME state backend the
        # scheduler persists to — on sqlite/etcd it survives restarts;
        # without a configured backend an in-process MemoryBackend keeps
        # the surface (REST /api/history, system.queries) alive for the
        # process lifetime. Constructed BEFORE _recover_state so recovery
        # can terminal-record jobs that died with the old scheduler.
        from ballista_tpu_torch.obs.history import HistoryStore

        if state_backend is None:
            from ballista_tpu_torch.scheduler.state_backend import MemoryBackend

            history_backend = MemoryBackend()
        else:
            history_backend = state_backend
        self.history = HistoryStore(
            history_backend,
            namespace,
            retention_jobs=self.config.history_retention_jobs(),
        )
        # adaptive query execution (docs/aqe.md): the policy engine that
        # reads runtime stats and applies certified rewrites; inert
        # unless the session's ballista.tpu.aqe (or BALLISTA_AQE) turns
        # it on. The counter map feeds
        # ballista_aqe_rewrites_total{op,outcome} on /api/metrics.
        from ballista_tpu_torch.scheduler.aqe import AqePolicy

        self.aqe = AqePolicy(self)
        self.obs_aqe_total: dict[tuple[str, str], int] = {}
        # serving fast path (docs/serving.md). Result cache: capacity
        # comes from the SCHEDULER's config (sessions cannot resize a
        # shared cache); keys fold in the session settings, so different
        # sessions never collide. In-memory only by design — a restarted
        # scheduler starts cold, which is the no-stale-serve-after-
        # _recover_state contract. Bypass bookkeeping: jobs granted
        # outside the stage state machine, all guarded by _lock.
        from ballista_tpu_torch.scheduler.result_cache import ResultCache

        self.result_cache = ResultCache(self.config.result_cache_mb() << 20)
        self._bypass_pending: collections.deque = collections.deque()
        self._bypass_running: dict[str, str] = {}  # job_id -> executor_id
        self._bypass_attempts: dict[str, int] = {}
        self.obs_bypass_total = 0
        self.state = None
        if state_backend is not None:
            from ballista_tpu_torch.scheduler.persistent_state import (
                PersistentSchedulerState,
            )

            self.state = PersistentSchedulerState(
                state_backend, namespace, self.codec
            )
            self._recover_state()
        self.event_loop = EventLoop("query-stage", QueryStageScheduler(self))
        # dispatch-lag metering: installed BEFORE start so every event is
        # enveloped; the observe is lock-cheap and allocation-free
        self.event_loop.lag_cb = self._h_dispatch_lag.labels().observe
        self.event_loop.start()
        import time as _time

        self.start_time = _time.time()
        # executor-lost recovery: periodic expiry sweep (ref
        # executor_manager.rs:55-77 expire_dead_executors + the
        # RUNNING->PENDING reset transition stage_manager.rs:553-558)
        self.executor_timeout_s = executor_timeout_s
        self._expiry_stop = threading.Event()
        self._expiry_thread = threading.Thread(
            target=self._expiry_loop,
            args=(expiry_check_interval_s,),
            daemon=True,
            name="executor-expiry",
        )
        self._expiry_thread.start()

    def _expiry_loop(self, interval_s: float) -> None:
        while not self._expiry_stop.wait(interval_s):
            try:
                self.check_expired_executors()
            except Exception:  # noqa: BLE001
                log.exception("executor expiry sweep failed")

    def check_expired_executors(self) -> list[str]:
        """Detect heartbeat-expired executors, reset their RUNNING tasks to
        PENDING, invalidate their COMPLETED shuffle outputs that downstream
        stages still need (lost-shuffle recovery — the files died with the
        executor), drop them from slot accounting, and re-offer. Returns
        the expired executor ids (exposed for tests and the REST /state
        view)."""
        em = self.executor_manager
        # read tracked BEFORE alive: an executor registering between the two
        # snapshots is then in alive-but-not-tracked (harmless) instead of
        # tracked-but-not-alive (would be expired at birth, resetting its
        # just-launched tasks into duplicate execution)
        tracked = em.tracked_executors()
        alive = em.get_alive_executors(self.executor_timeout_s)
        expired = tracked - alive
        if not expired:
            return []
        for eid in expired:
            self._drop_executor(eid)
        # bypass grants die with their executor exactly like RUNNING
        # stage tasks: requeue without charging an attempt (the blame is
        # the executor's, not the task's) — docs/serving.md
        with self._lock:
            lost_bypass = sorted(
                jid
                for jid, ex in self._bypass_running.items()
                if ex in expired
            )
            for jid in lost_bypass:
                del self._bypass_running[jid]
                self._bypass_pending.append(jid)
        reset = self.stage_manager.reset_tasks_of_executors(expired)
        log.warning(
            "executors %s expired; reset %d running tasks", expired, len(reset)
        )
        # completed shuffle output hosted on a dead executor is gone; any
        # stage with an incomplete consumer must recompute the lost map
        # partitions (a stage whose consumers all finished is left alone —
        # its output will never be read again)
        recovered = False
        for job_id, stage_id in self.stage_manager.stages_with_outputs_of(
            expired
        ):
            consumers = self.stage_manager.parents_of(job_id, stage_id)
            if consumers and all(
                self.stage_manager.is_completed_stage(job_id, c)
                for c in consumers
            ):
                continue
            job = self._get_job(job_id)
            if not consumers and job is not None:
                # final stage of a still-running job: its output is the
                # job result the client fetches — recompute it too
                if job.final_stage_id != stage_id:
                    continue
            for eid in sorted(expired):
                if self._on_shuffle_lost(job_id, stage_id, eid):
                    recovered = True
        if (reset or recovered) and (
            self.policy == TaskSchedulingPolicy.PUSH_STAGED
        ):
            self.event_loop.post(ReviveOffers())
        return sorted(expired)

    # -- locked accessors (racelint unguarded-field discipline) --------------
    def _get_job(self, job_id: str) -> JobInfo | None:
        """``self.jobs`` is written under ``_lock`` (submission, recovery);
        every cross-thread read goes through here. Also closes the
        teardown race: a job removed between a stage pick and its use now
        surfaces as ``None`` instead of a ``KeyError``."""
        with self._lock:
            return self.jobs.get(job_id)

    def _session_config(self, session_id: str) -> BallistaConfig:
        with self._lock:
            return self.sessions.get(session_id, self.config)

    def _recover_state(self) -> None:
        """Rebuild in-memory state from the backend on restart (ref
        persistent_state.rs init :85-181). Runs under the lock: it is
        called from ``__init__`` today, but it writes the same maps the
        gRPC threads read, and the lock keeps that true if recovery is
        ever re-run live."""
        with self._lock:
            for em in self.state.load_executors():
                self.executor_manager.save_executor_metadata(em)
            for sid, settings in self.state.load_sessions().items():
                try:
                    self.sessions[sid] = (
                        BallistaConfig(settings) if settings else self.config
                    )
                except Exception:  # noqa: BLE001 — stale/unknown keys
                    self.sessions[sid] = self.config
            for rec in self.state.load_jobs():
                job = JobInfo(
                    job_id=rec["job_id"],
                    session_id=rec["session_id"],
                    status=rec["status"],
                    error=rec.get("error", ""),
                    final_stage_id=rec.get("final_stage_id", 0),
                )
                job.dependencies = {
                    int(k): set(v)
                    for k, v in rec.get("dependencies", {}).items()
                }
                job.completed_locations = self.state.locations_from_json(
                    rec.get("locations", [])
                )
                plans = self.state.load_stage_plans(job.job_id)
                for stage_id, plan in plans.items():
                    job.stages[stage_id] = QueryStage(
                        job.job_id, stage_id, plan
                    )
                if job.status in ("queued", "running"):
                    # tasks in flight died with the old scheduler; fail
                    # loudly rather than dangle (running StageManager state
                    # is not persisted, matching the reference)
                    job.status = "failed"
                    job.error = "scheduler restarted while job was in flight"
                    self.state.save_job(job)
                    # the history log must agree with the job record: the
                    # predecessor wrote "submitted" but never a terminal
                    # record — close it out so system.queries never shows
                    # an eternally-submitted ghost
                    try:
                        self.history.record_terminal(
                            job.job_id, "failed", error=job.error,
                            session_id=job.session_id,
                        )
                    except Exception:  # noqa: BLE001 — history is
                        # observability, never recovery-critical
                        log.exception(
                            "history terminal record failed for %s",
                            job.job_id,
                        )
                self.jobs[job.job_id] = job
            if self.jobs:
                log.info(
                    "recovered %d jobs, %d sessions from state backend",
                    len(self.jobs), len(self.sessions),
                )

    # -- session management (ref grpc.rs:350-374) ----------------------------
    def get_or_create_session(
        self, session_id: str, settings: dict[str, str]
    ) -> str:
        plugin_dir = (settings or {}).get("ballista.plugin_dir")
        if plugin_dir:
            from ballista_tpu_torch.plugin import load_plugins

            load_plugins(plugin_dir)
        with self._lock:
            if session_id and session_id in self.sessions:
                if settings:
                    self.sessions[session_id] = BallistaConfig(settings)
                return session_id
            new_id = "".join(  # detlint: nondet=id-minting
                random.choices(string.ascii_lowercase + string.digits, k=16)
            )
            self.sessions[new_id] = (
                BallistaConfig(settings) if settings else self.config
            )
            if self.state is not None:
                self.state.save_session(new_id, settings or {})
            return new_id

    def persist_executor(self, em: ExecutorMetadata) -> None:
        if self.state is not None:
            self.state.save_executor_metadata(em)

    # -- query submission ----------------------------------------------------
    def submit_sql(self, sql: str, session_id: str) -> str:
        stmt = parse_sql(sql)
        if not isinstance(stmt, (ast.Select, ast.SetOp)):
            raise PlanError("ExecuteQuery requires a SELECT statement")
        logical = SqlPlanner(self.provider).plan(stmt)
        return self.submit_logical(logical, session_id)

    def _mint_trace(self, cfg) -> dict | None:
        """Start a job trace when the session's ``ballista.tpu.trace`` is
        not off (docs/observability.md): a fresh trace_id, the open root
        span, and a list the pre-job-id plan/verify spans accumulate in.
        None (no allocation anywhere downstream) when tracing is off."""
        mode = cfg.trace()
        if mode == "off":
            return None
        from ballista_tpu_torch.obs import trace as obs_trace

        obs_trace.configure(mode)
        trace_id = obs_trace.new_trace_id()
        return {
            "trace_id": trace_id,
            "root": obs_trace.start("job", trace_id),
            "pre": [],
        }

    @staticmethod
    def _trace_step(tctx: dict | None, name: str):
        """Context manager recording one plan/verify span under the
        pending job's root (no-op when tracing is off)."""
        import contextlib

        if tctx is None:
            return contextlib.nullcontext()
        from ballista_tpu_torch.obs import trace as obs_trace

        @contextlib.contextmanager
        def step():
            s = obs_trace.start(
                name, tctx["trace_id"], tctx["root"].span_id
            )
            try:
                yield s
            except BaseException as e:
                s.outcome = "error"
                s.attrs["error"] = type(e).__name__
                raise
            finally:
                obs_trace.finish(s, s.outcome)
                tctx["pre"].append(s)

        return step()

    def submit_logical(self, logical, session_id: str) -> str:
        cfg = self._session_config(session_id)
        tctx = self._mint_trace(cfg)
        verify = cfg.verify_plans()
        with self._trace_step(tctx, "plan"):
            optimized = optimize(logical)
            # serving fast path (docs/serving.md): a repeated identical
            # query over unchanged data is answered from the result
            # cache right here — no physical planning, no stages, no
            # executor. The key folds in the session settings and the
            # provider's data versions; result_cache_key returns None
            # (uncacheable, counted as a miss) for system.* scans or
            # when no data-version-capable provider is attached.
            cache_key = None
            if self.result_cache.enabled:
                from ballista_tpu_torch.scheduler.result_cache import (
                    result_cache_key,
                )

                cache_key = result_cache_key(optimized, cfg, self.provider)
                entry = self.result_cache.get(cache_key)
                if entry is not None:
                    from ballista_tpu_torch.analysis import stalewitness

                    if stalewitness.enabled() and stalewitness.should_sample(
                        "result_cache"
                    ):
                        # staleness witness (docs/analysis.md): demote
                        # this sampled hit to a miss — the job runs
                        # fresh through the full stage machinery, and
                        # the committed repopulation must hash-match
                        # what this hit WOULD have served
                        # (_populate_result_cache resolves the pending
                        # expectation)
                        from ballista_tpu_torch.analysis import replay
                        from ballista_tpu_torch.scheduler.result_cache import (
                            ipc_to_table,
                        )

                        stalewitness.expect(
                            "result_cache", cache_key,
                            replay.canonical_hash(ipc_to_table(entry[0])),
                            payload=entry[0],
                        )
                    else:
                        return self._serve_cached_result(
                            entry, session_id, trace=tctx
                        )
            if verify:
                # submission-time gate: reject inconsistent plans with a
                # typed PlanVerificationError (naming the operator path)
                # BEFORE any stage exists — the client sees it as the
                # job-submission failure rather than an executor task
                # failure minutes later
                with self._trace_step(tctx, "verify_logical"):
                    from ballista_tpu_torch.analysis import verify_logical

                    verify_logical(optimized)
            # distributed=True inserts HashRepartitionExec exchange
            # boundaries (honoring ballista.repartition.*) so the stage
            # splitter can cut multi-partition hash shuffles (ref
            # planner.rs:133-157)
            physical = PhysicalPlanner(
                self.provider,
                cfg.default_shuffle_partitions(),
                config=cfg,
                distributed=True,
            ).plan(optimized)
            if verify:
                with self._trace_step(tctx, "verify_physical"):
                    from ballista_tpu_torch.analysis import verify_physical

                    verify_physical(physical)
        return self.submit_physical(
            physical, session_id, trace=tctx, cache_key=cache_key
        )

    def _serve_cached_result(
        self, entry: tuple[bytes, dict], session_id: str,
        trace: dict | None,
    ) -> str:
        """Mint a COMPLETED job for a result-cache hit (docs/serving.md).

        The job is real everywhere observability and charging look:
        history gets its submit + terminal records, the fleet latency
        histogram observes it under the ORIGINATING run's query class
        (carried in the cache entry — physical planning was skipped, so
        the class cannot be recomputed), and a traced session sees a
        ``cache`` event under the job root. Not written to the state
        backend: the payload lives only in this process, and recovering
        a "completed" job with no locations and no payload would serve
        an empty result — unknown-after-restart fails loudly instead.
        """
        payload, meta = entry
        qclass = meta.get("query_class", "unknown")
        job_id = generate_job_id()
        import time as _time

        now = _time.time()
        with self._lock:
            job = JobInfo(
                job_id=job_id, session_id=session_id, status="completed"
            )
            job.query_class = qclass
            job.submitted_s = now
            job.result_ipc = payload
            if trace is not None:
                job.trace_id = trace["trace_id"]
                root = trace["root"]
                root.attrs["job_id"] = job_id
                job.root_span_id = root.span_id
                job.root_span = root
                self._traces[job.trace_id] = job_id
                for s in trace["pre"]:
                    job.spans[s.span_id] = s
            self.jobs[job_id] = job
        self._job_event(
            job, "cache", attrs={"hit": True, "bytes": len(payload)}
        )
        latency = max(0.0, _time.time() - now)
        self._h_job_latency.labels(qclass).observe(latency)
        try:
            self.history.record_submit(
                job_id, query_class=qclass, session_id=session_id,
                submitted_s=now,
            )
            self._job_terminal_history(job, "completed")
        except Exception:  # noqa: BLE001 — observability, never
            # serving-critical
            log.exception("history record failed for %s", job_id)
        self._close_job_trace(job, "ok")
        self._retain_job_obs(job)
        log.info(
            "job %s served from result cache (%d bytes)", job_id,
            len(payload),
        )
        return job_id

    def submit_physical(
        self,
        physical: ExecutionPlan,
        session_id: str,
        trace: dict | None = None,
        cache_key: object = None,
    ) -> str:
        job_id = generate_job_id()
        if trace is None:
            # direct physical submissions (tests, embedders) trace too
            trace = self._mint_trace(self._session_config(session_id))
        # query-class fingerprint BEFORE stage splitting (no job ids or
        # locations exist yet to leak into it) — the label every fleet
        # latency series aggregates by (docs/observability.md)
        from ballista_tpu_torch.obs.qclass import plan_class

        qclass = plan_class(physical)
        import time as _time

        now = _time.time()
        with self._lock:
            if qclass not in self._known_classes:
                if len(self._known_classes) < self.max_query_classes:
                    self._known_classes.add(qclass)
                else:
                    # cardinality cap: aggregate the long tail instead of
                    # leaking one histogram-child set per distinct shape
                    self.obs_class_overflow += 1
                    qclass = "overflow"
            job = JobInfo(job_id=job_id, session_id=session_id)
            job.query_class = qclass
            job.submitted_s = now
            job.cache_key = cache_key
            if trace is not None:
                job.trace_id = trace["trace_id"]
                root = trace["root"]
                root.attrs["job_id"] = job_id
                job.root_span_id = root.span_id
                job.root_span = root
                self._traces[job.trace_id] = job_id
                for s in trace["pre"]:
                    job.spans[s.span_id] = s
            self.jobs[job_id] = job
            if self.state is not None:
                self.state.save_job(job)
        # history log (docs/observability.md): the submit record — written
        # OUTSIDE the lock (backend I/O) and guarded (history is
        # observability, never submission-critical)
        try:
            self.history.record_submit(
                job_id, query_class=qclass, session_id=session_id,
                submitted_s=now,
            )
        except Exception:  # noqa: BLE001
            log.exception("history submit record failed for %s", job_id)
        self.event_loop.post(JobSubmitted(job_id, physical))
        return job_id

    # -- observability (docs/observability.md) -------------------------------
    def _store_job_span(self, job: JobInfo, span) -> None:
        """Keep one span in the job's bounded store (dict keyed span_id —
        re-shipped duplicates dedup)."""
        with self._lock:
            if len(job.spans) < 20000:
                job.spans.setdefault(span.span_id, span)

    def _job_event(
        self,
        job: JobInfo,
        name: str,
        parent_id: str = "",
        attrs: dict | None = None,
    ) -> None:
        """Record one scheduler-side point event on a traced job (no-op
        for untraced jobs — the zero-overhead off path)."""
        if not job.trace_id:
            return
        from ballista_tpu_torch.obs import trace as obs_trace

        s = obs_trace.event(
            name,
            trace_id=job.trace_id,
            parent_id=parent_id or job.root_span_id,
            attrs=attrs,
        )
        self._store_job_span(job, s)

    def _stage_span_id(self, job: JobInfo, stage_id: int) -> str:
        with self._lock:
            s = job.stage_spans.get(stage_id)
        return s.span_id if s is not None else job.root_span_id

    def _open_stage_span(self, job: JobInfo, stage_id: int) -> None:
        if not job.trace_id:
            return
        from ballista_tpu_torch.obs import trace as obs_trace

        with self._lock:
            if stage_id in job.stage_spans:
                return
            job.stage_spans[stage_id] = obs_trace.start(
                "stage",
                job.trace_id,
                job.root_span_id,
                attrs={"stage_id": stage_id},
            )

    def _finish_stage_span(self, job: JobInfo, stage_id: int) -> None:
        """Close a stage's span on first completion. The span OBJECT stays
        in stage_spans: its span_id keeps parenting recompute-round task
        attempts, so the recovery tree stays connected."""
        if not job.trace_id:
            return
        from ballista_tpu_torch.obs import trace as obs_trace

        with self._lock:
            s = job.stage_spans.get(stage_id)
            if s is None or s.end_s:
                return
        obs_trace.finish(s)
        self._store_job_span(job, s)

    def ingest_spans(self, span_protos) -> None:
        """Executor-shipped spans (poll/heartbeat/status RPCs) land in
        their job's span store, matched by trace_id. Spans for unknown
        traces (job torn down, foreign) are dropped — the ring already
        has them for process-local debugging."""
        if not span_protos:
            return
        from ballista_tpu_torch.obs import trace as obs_trace

        for p in span_protos:
            s = obs_trace.span_from_proto(p)
            with self._lock:
                job_id = self._traces.get(s.trace_id)
                job = self.jobs.get(job_id) if job_id is not None else None
            if job is not None:
                self._store_job_span(job, s)

    def _ingest_task_metrics(self, job_id: str, stage_id: int,
                             partition: int, status) -> None:
        """Per-operator metrics shipped in a CompletedTask: stored per
        (stage, partition) on the job, and summed into the cross-job
        counter aggregation /api/metrics serves."""
        if not status.completed.operator_metrics:
            return
        from ballista_tpu_torch.obs import profile

        records = profile.metrics_from_proto(
            status.completed.operator_metrics
        )
        job = self._get_job(job_id)
        with self._lock:
            if job is not None:
                job.op_metrics[(stage_id, partition)] = records
            for r in records:
                for k, v in r["counters"].items():
                    if isinstance(v, (int, float)):
                        self.obs_task_counters[k] = (
                            self.obs_task_counters.get(k, 0) + v
                        )

    def _ingest_task_cost(self, tid: PartitionId, state: str,
                          executor_id: str, cost_msg) -> None:
        """One attempt's shipped cost vector (docs/observability.md):
        summed into the job's aggregate, rolled up per query class for
        the Prometheus cost counters, and appended to the history log as
        a task-attempt record. ``cost_msg`` is the CostVectorP or None
        (accounting off)."""
        if cost_msg is None:
            return
        from ballista_tpu_torch.obs.history import CostVector, cost_from_proto

        cost = cost_from_proto(cost_msg)
        if cost.is_zero():
            return
        job = self._get_job(tid.job_id)
        qclass = job.query_class if job is not None else "unknown"
        with self._lock:
            if job is not None:
                if job.cost is None:
                    job.cost = CostVector()
                job.cost.add(cost)
            rollup = self.obs_class_cost.setdefault(qclass, {})
            for k, v in cost.to_dict().items():
                rollup[k] = rollup.get(k, 0) + v
        try:
            self.history.record_attempt(
                tid.job_id, tid.stage_id, tid.partition_id, state,
                executor_id, cost,
            )
        except Exception:  # noqa: BLE001 — metering must never outrank
            # the status RPC it rides along with
            log.exception("history attempt record failed for %s", tid)

    def _job_terminal_history(self, job: JobInfo, status: str) -> None:
        """Write the job's terminal history record (completed|failed):
        latency/queue-wait, retry/recompute/straggler/skew counters, and
        the aggregated cost vector. Guarded by callers."""
        import time as _time

        now = _time.time()
        latency = max(0.0, now - job.submitted_s) if job.submitted_s else 0.0
        wait = 0.0
        if job.first_assign_s and job.submitted_s:
            wait = max(0.0, job.first_assign_s - job.submitted_s)
        stragglers = 0
        for st in job.stage_stats or []:
            stragglers += sum(1 for t in st["tasks"] if t.get("straggler"))
        with self._lock:
            cost = job.cost
            skew = len(job.skew_flags)
            aqe_applied = sum(
                1 for d in job.aqe_decisions if d.get("outcome") == "applied"
            )
            aqe_rejected = sum(
                1 for d in job.aqe_decisions
                if d.get("outcome") == "rejected"
            )
        self.history.record_terminal(
            job.job_id,
            status,
            query_class=job.query_class,
            session_id=job.session_id,
            submitted_s=job.submitted_s,
            latency_s=latency,
            queue_wait_s=wait,
            retries=job.total_retries,
            recomputes=job.total_recomputes,
            stragglers=stragglers,
            skew_partitions=skew,
            aqe_applied=aqe_applied,
            aqe_rejected=aqe_rejected,
            error=job.error,
            cost=cost,
        )

    def history_payload(self, kind: str = "queries",
                        limit: int = 0) -> list[dict]:
        """The rows behind ``GET /api/history`` and the GetHistory RPC —
        one payload shape for every ``system.*`` table source."""
        if kind in ("", "queries"):
            return self.history.jobs(limit)
        if kind == "task_attempts":
            return self.history.attempts(limit)
        if kind == "executors":
            import time as _time

            em = self.executor_manager
            now = _time.time()
            alive = em.get_alive_executors(self.executor_timeout_s)
            rows = []
            for meta in em.all_executors():
                data = em.get_executor_data(meta.id)
                seen = em.last_seen(meta.id)
                rows.append(
                    {
                        "id": meta.id,
                        "host": meta.host,
                        "port": meta.port,
                        "grpc_port": meta.grpc_port,
                        "task_slots": (
                            data.total_task_slots if data
                            else meta.specification.task_slots
                        ),
                        "n_devices": meta.specification.n_devices or 1,
                        "alive": meta.id in alive,
                        "last_heartbeat_age_s": (
                            round(now - seen, 3) if seen is not None
                            else -1.0
                        ),
                    }
                )
            return rows[:limit] if limit else rows
        raise ValueError(f"unknown history kind {kind!r}")

    def ingest_hists(self, hist_protos) -> None:
        """Executor-shipped latency-histogram deltas (poll/heartbeat
        RPCs) merge into the scheduler's registry — the fleet view
        /api/metrics serves (docs/observability.md). Exception-guarded:
        this runs on the liveness RPC BEFORE apply_task_statuses, and a
        malformed delta (a version-skewed executor shipping a family
        with different labels) escaping here would poison-pill EVERY
        retry of that executor's poll — its statuses would never apply
        and its RUNNING tasks would strand. Metering must never outrank
        the work it rides along with."""
        if not hist_protos:
            return
        from ballista_tpu_torch.obs import hist as obs_hist

        try:
            self.hists.ingest(obs_hist.deltas_from_proto(hist_protos))
        except Exception:  # noqa: BLE001
            log.exception("dropping unmergeable histogram deltas")

    def _observe_task_completion(self, tid: PartitionId) -> None:
        """Per-task duration into the stage histogram + the straggler
        check (docs/observability.md): a completed task exceeding
        straggler_factor x the median of its stage's completed durations
        (noise-floored) is flagged once — trace event, counter, timeline
        bit."""
        sm = self.stage_manager
        # consume-once: a replayed COMPLETED status (lost RPC response,
        # executor resend) must not observe the same attempt window into
        # the histogram twice
        dur = sm.take_unmetered_runtime(
            tid.job_id, tid.stage_id, tid.partition_id
        )
        if dur is None:
            return
        job = self._get_job(tid.job_id)
        if job is None:
            return
        self._h_stage_task.labels(
            job.query_class, str(tid.stage_id)
        ).observe(dur)
        cfg = self._session_config(job.session_id)
        # noise-floor fast path: the threshold is always >= min_s, so a
        # sub-floor task can never flag — skip the per-completion
        # durations scan+sort entirely (on a wide stage that scan is
        # O(n) per completion on the poll-RPC status path)
        if dur <= cfg.straggler_min_s():
            return
        durations = sm.completed_durations(tid.job_id, tid.stage_id)
        from ballista_tpu_torch.scheduler.stage_manager import straggler_stats

        # (fewer than 3 completions -> no threshold: a 2-task stage
        # cannot name a straggler without one of them being half the
        # evidence)
        stats = straggler_stats(
            durations, cfg.straggler_factor(), cfg.straggler_min_s()
        )
        if stats is None:
            return
        threshold, med = stats
        if dur <= threshold:
            return
        if not sm.mark_straggler(tid.job_id, tid.stage_id,
                                 tid.partition_id):
            return
        with self._lock:
            self.obs_straggler_total[job.query_class] = (
                self.obs_straggler_total.get(job.query_class, 0) + 1
            )
        self._job_event(
            job, "straggler",
            parent_id=self._stage_span_id(job, tid.stage_id),
            attrs={
                "stage_id": tid.stage_id,
                "partition": tid.partition_id,
                "duration_s": round(dur, 4),
                "stage_median_s": round(med, 4),
            },
        )
        log.warning(
            "straggler: task %s/%s/%s took %.3fs (stage median %.3fs, "
            "factor %.1f)",
            tid.job_id, tid.stage_id, tid.partition_id, dur, med,
            cfg.straggler_factor(),
        )

    def _detect_skew(self, job: JobInfo, stage_id: int) -> None:
        """Skew monitor (docs/observability.md): when a stage completes,
        compare each (stage, partition)'s processed rows — the max
        output_rows across its shipped per-operator metrics, i.e. the
        widest point of the fragment — against the stage median. Flagged
        partitions are EXACTLY the candidates the AQE split policy
        (ROADMAP) will feed to SplitShufflePartitions."""
        cfg = self._session_config(job.session_id)
        ratio = cfg.skew_ratio()
        if ratio <= 0:
            return
        with self._lock:
            rows_by_part: dict[int, float] = {}
            for (sid, part), records in job.op_metrics.items():
                if sid != stage_id:
                    continue
                widest = 0.0
                for r in records:
                    v = r.get("counters", {}).get("output_rows")
                    if isinstance(v, (int, float)):
                        widest = max(widest, float(v))
                rows_by_part[part] = widest
        if len(rows_by_part) < 2:
            return
        import statistics

        med = statistics.median(rows_by_part.values())
        if med <= 0:
            return
        floor = cfg.skew_min_rows()
        for part in sorted(rows_by_part):
            rows = rows_by_part[part]
            if rows < floor or rows <= ratio * med:
                continue
            self._commit_skew_flag(
                job, stage_id, part, rows, med, ratio, source="output"
            )

    def _commit_skew_flag(
        self,
        job: JobInfo,
        stage_id: int,
        part: int,
        rows: float,
        med: float,
        ratio: float,
        source: str,
    ) -> None:
        """The ONE skew-commit protocol shared by the post-run
        output-rows pass (``_detect_skew``) and the pre-run input-bucket
        pass (``_detect_input_skew``): dedup'd flag, counter, trace
        event, warning — two hand-synced copies would drift, and both
        passes feed the same consumers (timeline ``skewed`` bit, the
        AQE split rule)."""
        with self._lock:
            if (stage_id, part) in job.skew_flags:
                return
            job.skew_flags.append((stage_id, part))
            self.obs_skew_total[job.query_class] = (
                self.obs_skew_total.get(job.query_class, 0) + 1
            )
        attrs = {
            "stage_id": stage_id,
            "partition": part,
            "rows": int(rows),
            "stage_median_rows": int(med),
        }
        if source != "output":
            # distinguishes the pre-run input-bucket flag from the
            # post-run output-rows flag (regression-tested)
            attrs["source"] = source
        self._job_event(
            job, "skew",
            parent_id=self._stage_span_id(job, stage_id),
            attrs=attrs,
        )
        log.warning(
            "skew (%s): partition %s/%s/%s carries %d rows "
            "(stage median %d, ratio %.1f)",
            source, job.job_id, stage_id, part, int(rows), int(med),
            ratio,
        )

    def _detect_input_skew(
        self, job: JobInfo, consumer_id: int, stats: dict
    ) -> None:
        """Input-bucket skew for a consumer whose producers just ALL
        completed (docs/aqe.md): the producers' committed shuffle-write
        metas give exact per-bucket rows BEFORE the consumer runs, so
        the flag — and the AQE split policy reading it — arrives in
        time to act. This is the timing fix for the final stage too:
        its own ``_detect_skew`` pass used to run only at job
        completion, after anything could be done about it; evaluating
        its producers at the last StageFinished closes that gap. Flags
        share the (stage, partition) key space with ``_detect_skew``
        (a consumer task ``p`` reads exactly input bucket ``p``), so
        the later output-rows pass dedups against these."""
        cfg = self._session_config(job.session_id)
        ratio = cfg.skew_ratio()
        if ratio <= 0:
            return
        from ballista_tpu_torch.scheduler.aqe import keyed_bucket_totals

        with self._lock:
            stage = job.stages.get(consumer_id)
            n_buckets = (
                stage.input_partition_count if stage is not None else 0
            )
        if n_buckets < 2:
            return
        with self._lock:
            buckets, keyed = keyed_bucket_totals(job, stats)
        if not keyed:
            return
        rows_by_bucket = {
            b: buckets.get(b, (0, 0))[0] for b in range(n_buckets)
        }
        import statistics

        med = statistics.median(rows_by_bucket.values())
        if med <= 0:
            return
        floor = cfg.skew_min_rows()
        for part in sorted(rows_by_bucket):
            rows = rows_by_bucket[part]
            if rows < floor or rows <= ratio * med:
                continue
            self._commit_skew_flag(
                job, consumer_id, part, rows, med, ratio, source="input"
            )

    def record_aqe_decision(self, job: JobInfo, decision: dict) -> None:
        """One AQE policy decision (docs/aqe.md): appended to the job's
        decision log (REST /api/job), counted into the
        ballista_aqe_rewrites_total{op,outcome} family, and recorded as
        an ``aqe`` trace event carrying the before/after stats."""
        key = (decision.get("op", "?"), decision.get("outcome", "?"))
        with self._lock:
            if len(job.aqe_decisions) < 256:
                job.aqe_decisions.append(dict(decision))
            self.obs_aqe_total[key] = self.obs_aqe_total.get(key, 0) + 1
        attrs = {
            "op": decision.get("op", ""),
            "outcome": decision.get("outcome", ""),
            "stage_ids": decision.get("stage_ids", []),
            "source": decision.get("source", ""),
        }
        if decision.get("clause"):
            attrs["clause"] = decision["clause"]
        for side in ("before", "after"):
            for k, v in sorted((decision.get(side) or {}).items()):
                attrs[f"{side}_{k}"] = v
        self._job_event(job, "aqe", attrs=attrs)
        log.info(
            "aqe %s: %s %s stages=%s%s", decision.get("outcome"),
            decision.get("op"), decision.get("source", ""),
            decision.get("stage_ids"),
            f" clause={decision['clause']}" if decision.get("clause")
            else "",
        )

    def desired_executors(self) -> int:
        """The composite autoscale pressure the KEDA ExternalScaler
        reports (docs/observability.md): base demand = inflight tasks
        over per-executor slots, scaled up (capped 4x) when the p90 of
        recent queue waits exceeds the declared target — pending work
        alone under-scales when jobs are stacking up faster than slots
        free. Also served as the ballista_desired_executors gauge."""
        import math

        inflight = self.stage_manager.inflight_tasks()
        # bypassed jobs are invisible to the stage manager but are demand
        # all the same (docs/serving.md)
        with self._lock:
            inflight += len(self._bypass_pending) + len(self._bypass_running)
        if inflight <= 0:
            return 0
        em = self.executor_manager
        per_exec = 0
        for eid in sorted(em.tracked_executors()):
            data = em.get_executor_data(eid)
            if data is not None:
                per_exec = max(per_exec, data.total_task_slots)
        per_exec = per_exec or 4
        base = math.ceil(inflight / per_exec)
        target = self.config.scaler_queue_wait_target_s()
        import time as _time

        cutoff = _time.time() - self.queue_wait_window_s
        with self._lock:
            # recency-filtered: stale burst-era waits must stop driving
            # the multiplier once the queue has actually drained
            waits = sorted(
                w for at, w in self._recent_queue_waits if at >= cutoff
            )
        if waits and target > 0:
            p90 = waits[min(len(waits) - 1, int(0.9 * (len(waits) - 1)))]
            if p90 > target:
                base = math.ceil(base * min(p90 / target, 4.0))
        return max(base, 1)

    def job_stats(self, job_id: str) -> dict | None:
        """Aggregated per-stage / per-partition stats for one job (the
        /api/job/<id> payload body): task rows/bytes from the stage
        bookkeeping (live) or the completion snapshot, overlaid with the
        shipped per-operator metrics. None for unknown jobs."""
        job = self._get_job(job_id)
        if job is None:
            return None
        stages = job.stage_stats
        if stages is None:
            stages = self.stage_manager.job_stage_detail(job_id)
        with self._lock:
            op_metrics = {
                f"{sid}/{part}": records
                for (sid, part), records in sorted(job.op_metrics.items())
            }
        # key is "stage_stats", NOT "stages": the /api/job payload already
        # carries a "stages" list (DAG edges + plan display) the status UI
        # renders — clobbering it broke the expandable job rows
        return {"stage_stats": stages, "operator_metrics": op_metrics}

    def job_trace(self, job_id: str) -> list[dict] | None:
        """The job's reassembled span tree, start-ordered (REST + chaos
        assertions). None for unknown jobs; [] for untraced ones."""
        job = self._get_job(job_id)
        if job is None:
            return None
        with self._lock:
            spans = sorted(job.spans.values(), key=lambda s: s.start_s)
        return [
            {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "name": s.name,
                "start_s": round(s.start_s, 6),
                "end_s": round(s.end_s, 6),
                "status": s.outcome,
                "attrs": {k: str(v) for k, v in sorted(s.attrs.items())},
            }
            for s in spans
        ]

    # -- stage generation (ref query_stage_scheduler.rs:59-105) --------------
    def _generate_stages(self, job_id: str, plan: ExecutionPlan) -> None:
        job = self._get_job(job_id)
        if job is None:
            return
        try:
            planner = DistributedPlanner()
            stages = planner.plan_query_stages(job_id, plan)
            cfg = self._session_config(job.session_id)
            if cfg.verify_plans():
                # stage-DAG well-formedness: every UnresolvedShuffleExec
                # placeholder must agree with its writer stage on schema
                # and partition count, and reference an earlier stage —
                # the splitter bug class that otherwise dies mid-job on
                # an executor
                from ballista_tpu_torch.analysis import verify_stages

                verify_stages(stages)
        except Exception as e:  # noqa: BLE001
            self._on_job_failed(job_id, f"planning failed: {e}")
            return
        job.max_attempts = cfg.task_max_attempts()
        job.eager = cfg.eager_shuffle()
        # serving fast path (docs/serving.md): exactly one stage with one
        # input partition group needs none of the stage state machine —
        # no dependencies to track, no shuffles to resolve, no
        # StageFinished to promote. Grant it as one direct task instead
        # (retries stay bounded by the same task_max_attempts snapshot).
        if (
            len(stages) == 1
            and stages[0].input_partition_count == 1
            and cfg.single_stage_bypass()
        ):
            self._submit_bypass(job, stages[0])
            return
        deps = _stage_dependencies(stages)
        for stage in stages:
            job.stages[stage.stage_id] = stage
        job.final_stage_id = stages[-1].stage_id
        job.dependencies = deps
        self.stage_manager.add_final_stage(job_id, job.final_stage_id)
        self.stage_manager.add_stages_dependency(job_id, deps)
        job.status = "running"
        if self.state is not None:
            # write-through: stage plans + job record (ref
            # persistent_state.rs save_stage_plan :183-324)
            for stage in stages:
                self.state.save_stage_plan(
                    job_id, stage.stage_id, stage.plan
                )
            self.state.save_job(job)
        # AQE proactive pass (docs/aqe.md): apply this query class's
        # LEARNED strategies while every stage is still fully pending —
        # the window where broadcast/coalesce/split (which re-bucket
        # producers) are acceptable. When strategies exist, the leaf
        # stages are submitted PENDING (not claimable) first: a pull
        # executor's PollWork thread could otherwise claim a leaf task
        # in the gap between submission and rewrite application and
        # close the window with a spurious runtime-state rejection.
        # The rewrites apply, then the dep-free stages promote below.
        defer_running = False
        try:
            defer_running = self.aqe.wants_to_adapt(job)
        except Exception:  # noqa: BLE001
            log.exception("AQE strategy lookup failed for %s", job_id)
        self._submit_stage(
            job_id, job.final_stage_id, set(), defer_running=defer_running
        )
        if defer_running:
            try:
                self.aqe.on_job_submitted(job)
            except Exception:  # noqa: BLE001 — adaptation must never
                # outrank the submission it advises
                log.exception("AQE submission policy failed for %s", job_id)
            # open the gates: promote every pending stage whose deps are
            # already complete (leaf stages; apply_certified_rewrite has
            # already re-promoted the ones it touched)
            deferred: list = []
            with self._lock:
                for sid in sorted(job.stages):
                    if not self.stage_manager.is_pending_stage(job_id, sid):
                        continue
                    if any(
                        not self.stage_manager.is_completed_stage(
                            job_id, u.stage_id
                        )
                        for u in find_unresolved_shuffles(
                            job.stages[sid].plan
                        )
                    ):
                        continue
                    self._resolve_stage(job_id, sid)
                    deferred.extend(
                        self.stage_manager.promote_pending_stage(
                            job_id, sid
                        )
                    )
            for e in deferred:
                self.event_loop.post(e)

    def _submit_stage(
        self,
        job_id: str,
        stage_id: int,
        seen: set[int],
        defer_running: bool = False,
    ) -> None:
        """Recursive dependency walk (ref :124-177). ``defer_running``
        registers even dependency-free stages as PENDING (nothing is
        claimable yet): the AQE submission pass rewrites templates
        first, then the caller promotes — see ``_generate_stages``."""
        if stage_id in seen:
            return
        seen.add(stage_id)
        if self.stage_manager.is_running_stage(
            job_id, stage_id
        ) or self.stage_manager.is_pending_stage(job_id, stage_id):
            return
        job = self._get_job(job_id)
        if job is None:
            return
        stage = job.stages[stage_id]
        unresolved = find_unresolved_shuffles(stage.plan)
        unfinished = [
            u
            for u in unresolved
            if not self.stage_manager.is_completed_stage(job_id, u.stage_id)
        ]
        n_tasks = stage.input_partition_count
        self._open_stage_span(job, stage_id)
        if unfinished:
            self.stage_manager.add_pending_stage(
                job_id, stage_id, n_tasks, max_attempts=job.max_attempts
            )
            for u in unfinished:
                self._submit_stage(
                    job_id, u.stage_id, seen, defer_running=defer_running
                )
        elif defer_running:
            self.stage_manager.add_pending_stage(
                job_id, stage_id, n_tasks, max_attempts=job.max_attempts
            )
        else:
            self._resolve_stage(job_id, stage_id)
            self.stage_manager.add_running_stage(
                job_id, stage_id, n_tasks, max_attempts=job.max_attempts
            )

    def _resolve_stage(self, job_id: str, stage_id: int) -> None:
        """Patch completed shuffle locations into a COPY of the stage plan
        and serialize it (ref try_resolve_stage :181-309 +
        task_scheduler.rs:146-156). ``stage.plan`` stays the pristine
        unresolved template: lost-shuffle recovery re-invokes this after an
        upstream recompute, and re-resolution needs the placeholders a
        destructive patch would have consumed."""
        job = self._get_job(job_id)
        if job is None:
            raise PlanError(f"job {job_id} torn down during stage resolution")
        stage = job.stages[stage_id]
        unresolved = find_unresolved_shuffles(stage.plan)
        plan = stage.plan
        if unresolved:
            locations: dict[int, list[list[PartitionLocation]]] = {}
            for u in unresolved:
                locations[u.stage_id] = self._stage_output_locations(
                    job_id, u.stage_id, u.output_partition_count
                )
            plan = remove_unresolved_shuffles(stage.plan, locations)
        job.resolved_plan_bytes[stage_id] = self.codec.physical_to_proto(
            plan
        ).SerializeToString()

    def _executor_endpoint(self, executor_id: str) -> tuple[str, int]:
        """(host, port) a reader should dial for an executor's shuffle
        output — the single resolution used by BOTH the barriered
        (_stage_output_locations) and eager (shuffle_locations_proto)
        paths, so their location construction cannot drift. An unknown
        executor resolves to localhost:0: the location still carries the
        local filesystem path, which colocated readers can consume."""
        meta_exec = self.executor_manager.get_executor_metadata(executor_id)
        host = meta_exec.host if meta_exec else "localhost"
        port = meta_exec.port if meta_exec else 0
        return host, port

    def _stage_output_locations(
        self, job_id: str, stage_id: int, n_out: int
    ) -> list[list[PartitionLocation]]:
        locs: list[list[PartitionLocation]] = [[] for _ in range(n_out)]
        for (task_idx, executor_id, metas) in (
            self.stage_manager.completed_partitions(job_id, stage_id)
        ):
            host, port = self._executor_endpoint(executor_id)
            for m in metas:
                locs[m.partition_id].append(
                    PartitionLocation(
                        job_id=job_id,
                        stage_id=stage_id,
                        partition=m.partition_id,
                        executor_id=executor_id,
                        host=host,
                        port=port,
                        path=m.path,
                        # push-capable metadata (docs/shuffle.md): the
                        # consumer tries the producer's in-memory stream
                        # (keyed by the producing map task) before the
                        # file path
                        push=m.push,
                        map_partition=task_idx,
                    )
                )
        return locs

    # -- event handlers ------------------------------------------------------
    def _on_stage_finished(self, job_id: str, stage_id: int) -> None:
        """Promote pending parents whose deps are all complete (ref
        :107-122). Re-resolution here is what repairs consumers after a
        lost-shuffle recompute: their cached plan bytes were invalidated,
        and the pristine template re-resolves against the refreshed
        locations."""
        job = self._get_job(job_id)
        if job is None:
            return
        self._finish_stage_span(job, stage_id)
        # skew monitor (docs/observability.md): every task of this stage
        # has reported — its shipped per-partition metrics are complete,
        # so the rows-vs-median comparison is meaningful exactly now
        self._detect_skew(job, stage_id)
        # consumers whose producers are ALL now complete: the stages the
        # promote loop below is about to start. Their input-bucket skew
        # is knowable exactly now (producer metas are final), and this
        # is the AQE policy's decision point — BEFORE promotion, while
        # the consumer is still fully pending and a certified rewrite of
        # it can still be accepted (docs/aqe.md).
        ready: list[int] = []
        # the stats pass below scans every completed producer's shuffle
        # metas — skip it entirely when neither consumer exists: the
        # skew monitor is off AND the AQE policy is disabled (the
        # common aqe=false default must not pay for adaptivity)
        from ballista_tpu_torch.scheduler import aqe as aqe_mod

        cfg = self._session_config(job.session_id)
        want_stats = cfg.skew_ratio() > 0 or aqe_mod.enabled(cfg)
        if want_stats:
            with self._lock:
                for parent in sorted(
                    self.stage_manager.parents_of(job_id, stage_id)
                ):
                    if not self.stage_manager.is_pending_stage(
                        job_id, parent
                    ):
                        continue
                    stage = job.stages.get(parent)
                    if stage is not None and all(
                        self.stage_manager.is_completed_stage(
                            job_id, u.stage_id
                        )
                        for u in find_unresolved_shuffles(stage.plan)
                    ):
                        ready.append(parent)
        # producer stats computed ONCE per ready consumer (full scans of
        # the completed shuffle metas) and shared by the skew pass and
        # the policy — this runs on the event-loop thread, and doubling
        # the scan would show up straight in the dispatch-lag histogram
        ready_stats: dict[int, dict] = {}
        from ballista_tpu_torch.scheduler.aqe import producer_stats

        for parent in ready:
            with self._lock:
                stage = job.stages.get(parent)
                plan = stage.plan if stage is not None else None
            if plan is None:
                continue
            ready_stats[parent] = producer_stats(self, job_id, plan)
            self._detect_input_skew(job, parent, ready_stats[parent])
        try:
            self.aqe.on_stage_finished(job, stage_id, ready_stats)
        except Exception:  # noqa: BLE001 — adaptation must never outrank
            # the promotion it advises; the job proceeds unadapted
            log.exception("AQE StageFinished policy failed for %s", job_id)
        deferred: list = []
        promoted: list[int] = []
        # sorted: parents_of returns a set, and promote/event order should
        # not vary with hash seed (detlint unordered-iteration hardening —
        # determinism of the recovery event sequence is what the chaos
        # trace assertions read)
        for parent in sorted(self.stage_manager.parents_of(job_id, stage_id)):
            # check+resolve+promote under the server lock, serialized
            # against _on_shuffle_lost: an invalidation racing this
            # resolve would otherwise let it bake EMPTY location lists
            # for just-lost partitions into the resolved plan bytes and
            # promote the consumer anyway — next_task would then hand
            # out the poisoned plan without its completeness re-check
            # (plan_bytes present). Completion events post AFTER the
            # lock: the event queue is bounded (racelint
            # blocking-under-lock).
            with self._lock:
                if not self.stage_manager.is_pending_stage(job_id, parent):
                    continue
                unresolved = find_unresolved_shuffles(
                    job.stages[parent].plan
                )
                if all(
                    self.stage_manager.is_completed_stage(job_id, u.stage_id)
                    for u in unresolved
                ):
                    self._resolve_stage(job_id, parent)
                    deferred.extend(
                        self.stage_manager.promote_pending_stage(
                            job_id, parent
                        )
                    )
                    promoted.append(parent)
        for parent in promoted:
            # recovery-shape visibility (docs/observability.md): the
            # promote is the recovery's commit point — the chaos trace
            # test asserts submit -> stage -> failed attempt -> recompute
            # -> promote connect under one trace_id
            self._job_event(
                job, "promote",
                parent_id=self._stage_span_id(job, parent),
                attrs={"stage_id": parent, "after_stage": stage_id},
            )
        for e in deferred:
            self.event_loop.post(e)

    def _on_task_rescheduled(self, event: TaskRescheduled) -> None:
        """Bookkeeping for a bounded retry (visibility: REST /api/state
        exposes the count; chaos tests assert on it)."""
        job = self._get_job(event.job_id)
        if job is not None:
            job.total_retries += 1
            self._job_event(
                job, "task_retry",
                parent_id=self._stage_span_id(job, event.stage_id),
                attrs={
                    "stage_id": event.stage_id,
                    "partition": event.partition_id,
                    "attempt": event.attempt,
                },
            )
        log.warning(
            "task %s/%s/%s requeued for attempt %d: %s",
            event.job_id, event.stage_id, event.partition_id,
            event.attempt, event.error.splitlines()[0] if event.error else "",
        )

    def _on_shuffle_lost(
        self, job_id: str, map_stage_id: int, executor_id: str
    ) -> bool:
        """Lost-shuffle (lineage) recovery: ``executor_id``'s COMPLETED
        shuffle output of ``map_stage_id`` is unreachable — re-open exactly
        those map partitions, roll the stage back to running, and force
        consumers to re-resolve against refreshed locations once it
        re-completes. Returns True when anything was invalidated.

        Recompute rounds are bounded by the stage's max_attempts: an
        output that keeps vanishing (crash-looping executor, corrupt
        writes) must eventually fail the job instead of recomputing
        forever."""
        job = self._get_job(job_id)
        if job is None or job.status != "running":
            return False
        with self._lock:
            # atomic with the consumer demotion below, and serialized
            # against next_task's lazy re-resolution (which re-checks
            # producer completeness under the same lock): a resolve racing
            # this invalidation must see either the old complete state or
            # the demoted one, never a half-invalidated stage
            reopened = self.stage_manager.invalidate_executor_outputs(
                job_id, map_stage_id, {executor_id}
            )
            if not reopened:
                return False
            job.total_recomputes += 1
            for consumer in sorted(  # set-ordered walk: see _on_stage_finished
                self.stage_manager.parents_of(job_id, map_stage_id)
            ):
                job.resolved_plan_bytes.pop(consumer, None)
                self.stage_manager.demote_running_stage(job_id, consumer)
        rounds = self.stage_manager.stage_recomputes(job_id, map_stage_id)
        cap = self.stage_manager.stage_max_attempts(job_id, map_stage_id)
        # recovery-shape visibility (docs/observability.md): the
        # invalidate+recompute decision, parented to the producing stage's
        # span so the kill -> invalidate -> recompute -> promote chain
        # reads off the span tree
        self._job_event(
            job, "recompute",
            parent_id=self._stage_span_id(job, map_stage_id),
            attrs={
                "stage_id": map_stage_id,
                "executor_id": executor_id,
                "reopened": len(reopened),
                "round": rounds,
            },
        )
        log.warning(
            "shuffle output of %s/%s on executor %s lost; re-running %d map "
            "partitions (recompute round %d/%d)",
            job_id, map_stage_id, executor_id, len(reopened), rounds, cap,
        )
        if rounds > cap:
            self.event_loop.post(
                JobFailed(
                    job_id,
                    map_stage_id,
                    f"shuffle output of stage {map_stage_id} lost "
                    f"{rounds} times (last on executor {executor_id}); "
                    "recompute bound exceeded",
                )
            )
            return True
        # (stale locations were dropped and consumers demoted above, under
        # the lock; they re-resolve from their pristine templates when the
        # map stage re-completes: StageFinished -> _on_stage_finished)
        if self.policy == TaskSchedulingPolicy.PUSH_STAGED:
            self.event_loop.post(ReviveOffers())
        return True

    # -- certified plan rewrites (rewrite.py) ----------------------------------
    def apply_certified_rewrite(self, job_id: str, op):
        """The ONLY sanctioned way to change a running job's stage
        templates (docs/analysis.md): apply a typed rewrite op over THIS
        server's pristine templates under the server lock — the
        certificate is derived here, never accepted from a caller —
        enforce the runtime precondition (every touched stage fully
        pending), and only then swap templates + bookkeeping atomically.
        Any failure raises the typed :class:`RewriteRejected` carrying
        the failing clause and leaves the pristine templates untouched —
        the job proceeds on the unrewritten plan. Returns the validated
        certificate.

        This is the seam the AQE policy layer (ROADMAP) plugs into: it
        decides WHAT to rewrite from runtime stats; this method decides
        whether the rewrite is provably safe."""
        from ballista_tpu_torch import rewrite as rewrite_mod
        from ballista_tpu_torch.testing import faults

        job = self._get_job(job_id)
        if job is None or job.status != "running":
            raise RewriteRejected(
                f"job {job_id} is not running", clause="job-state"
            )
        deferred: list = []
        try:
            with self._lock:
                old_stages = list(job.stages.values())
                result = rewrite_mod.apply_rewrite(
                    old_stages, op, job_id=job_id
                )
                inj = faults.active()
                if inj is not None:
                    # chaos: the certificate-validation failure path
                    # (rewrite_reject rules raise RewriteRejected here)
                    inj.on_rewrite_validate(
                        job_id, getattr(op, "stage_id", -1)
                    )
                # the certificate was derived HERE, under the lock, from
                # this server's own pristine templates (apply_rewrite
                # certifies and raises on any failing clause) — there is
                # no producer-supplied copy to distrust
                cert = result.certificate
                new_by = {s.stage_id: s for s in result.stages}
                touched = cert.rewritten_stages + cert.added_stages
                err = self.stage_manager.rebind_stages_for_rewrite(
                    job_id,
                    affected={
                        sid: new_by[sid].input_partition_count
                        for sid in cert.rewritten_stages
                    },
                    removed=cert.removed_stages,
                    added={
                        sid: new_by[sid].input_partition_count
                        for sid in cert.added_stages
                    },
                    deps=_stage_dependencies(result.stages),
                    max_attempts=job.max_attempts,
                )
                if err is not None:
                    raise RewriteRejected(err, clause="runtime-state")
                # accepted: swap the pristine templates + invalidate every
                # cached resolution of a touched stage (eager bytes too —
                # they are location-free but template-derived)
                job.stages = {s.stage_id: s for s in result.stages}
                job.dependencies = _stage_dependencies(result.stages)
                for sid in touched + cert.removed_stages:
                    job.resolved_plan_bytes.pop(sid, None)
                    job.eager_plan_bytes.pop(sid, None)
                job.total_rewrites += 1
                # rewrite visibility (docs/aqe.md): the decision log
                # /api/job serves + the /timeline "rewritten" stage
                # marker (why did this stage's partition count change?)
                job.rewritten_stages.update(touched)
                if len(job.rewrite_log) < 256:
                    job.rewrite_log.append(
                        {
                            "op": op.describe(),
                            "outcome": "applied",
                            "exactness": cert.exactness,
                            "rewritten": sorted(cert.rewritten_stages),
                            "added": sorted(cert.added_stages),
                            "removed": sorted(cert.removed_stages),
                        }
                    )
                from ballista_tpu_torch import rewrite as _rw
                from ballista_tpu_torch.analysis import replay

                if replay.enabled():
                    # the witness must not compare across content that
                    # legitimately changes: re-bucketed stages always;
                    # for MULTISET_EXACT rewrites also every touched
                    # stage and its transitive consumers (float folds
                    # re-associate downstream — see rewrite.BIT_EXACT)
                    forget = set(cert.bucket_changed_stages)
                    if cert.exactness != _rw.BIT_EXACT:
                        forget |= set(touched)
                    frontier = set(forget)
                    while frontier:
                        frontier = {
                            parent
                            for child in frontier
                            for parent in job.dependencies.get(
                                child, set()
                            )
                        } - forget
                        forget |= frontier
                    for sid in sorted(forget):
                        replay.forget_stage(job_id, sid)
                if self.state is not None:
                    for sid in touched:
                        self.state.save_stage_plan(
                            job_id, sid, new_by[sid].plan
                        )
                # re-promote touched stages whose dependencies are already
                # complete (they were forced PENDING by the rebind; nothing
                # else re-promotes them until a dependency finishes)
                for sid in sorted(touched):
                    if not self.stage_manager.is_pending_stage(job_id, sid):
                        continue
                    unresolved = find_unresolved_shuffles(
                        job.stages[sid].plan
                    )
                    if all(
                        self.stage_manager.is_completed_stage(
                            job_id, u.stage_id
                        )
                        for u in unresolved
                    ):
                        self._resolve_stage(job_id, sid)
                        deferred.extend(
                            self.stage_manager.promote_pending_stage(
                                job_id, sid
                            )
                        )
        except RewriteRejected as e:
            with self._lock:
                # same discipline as the accepted-path counter: REST and
                # chaos assertions read these, and an unlocked
                # read-modify-write can drop concurrent increments
                job.total_rewrite_rejects += 1
                if len(job.rewrite_log) < 256:
                    job.rewrite_log.append(
                        {
                            "op": op.describe(),
                            "outcome": "rejected",
                            "clause": e.clause,
                            "stage_ids": sorted(
                                int(s) for s in (e.stage_ids or ())
                            ),
                        }
                    )
            self._job_event(
                job, "rewrite_reject",
                attrs={"op": op.describe(), "clause": e.clause},
            )
            log.warning(
                "certified rewrite REJECTED for %s: %s", job_id, e
            )
            raise
        # events post after the lock: the queue is bounded (racelint
        # blocking-under-lock), and every accepted rewrite may unlock work
        self._job_event(
            job, "rewrite",
            attrs={
                "op": op.describe(),
                "rewritten": list(cert.rewritten_stages),
                "added": list(cert.added_stages),
                "removed": list(cert.removed_stages),
            },
        )
        log.warning(
            "certified rewrite ACCEPTED for %s: %s (%s)",
            job_id, op.describe(), cert.summary(),
        )
        for e in deferred:
            self.event_loop.post(e)
        if self.policy == TaskSchedulingPolicy.PUSH_STAGED:
            self.event_loop.post(ReviveOffers())
        return cert

    def _close_job_trace(self, job: JobInfo, outcome: str = "ok") -> None:
        """Finish whatever spans are still open (stage spans, root) and
        store them — the job's span tree must be complete once the job
        reaches a terminal status."""
        if not job.trace_id:
            return
        from ballista_tpu_torch.obs import trace as obs_trace

        with self._lock:
            open_spans = [
                s for s in job.stage_spans.values() if not s.end_s
            ]
            root = job.root_span
        for s in open_spans:
            obs_trace.finish(s)
            self._store_job_span(job, s)
        if root is not None and not root.end_s:
            obs_trace.finish(root, outcome)
            self._store_job_span(job, root)

    def _retain_job_obs(self, job: JobInfo) -> None:
        """Enroll a terminal job in the bounded observability-retention
        window: the newest ``obs_retained_jobs`` terminal jobs keep their
        spans / operator metrics / stage-stats snapshot (served by
        /api/job/<id>); older ones are stripped back to the light
        JobInfo record the pre-observability scheduler kept."""
        with self._lock:
            self._obs_retained.append(job.job_id)
            while len(self._obs_retained) > max(1, self.obs_retained_jobs):
                old_id = self._obs_retained.popleft()
                old = self.jobs.get(old_id)
                if old is None:
                    continue
                old.spans.clear()
                old.op_metrics.clear()
                old.stage_spans.clear()
                old.stage_stats = None
                old.root_span = None
                # decision logs follow the same retention discipline as
                # the other heavy per-job payloads (counters stay)
                old.rewrite_log.clear()
                old.aqe_decisions.clear()
                # cache-served payloads follow the same retention window
                # (clients poll status within moments of submission; only
                # the cache itself keeps results long-term)
                old.result_ipc = b""
                if old.trace_id:
                    self._traces.pop(old.trace_id, None)

    def _on_job_finished(self, job_id: str) -> None:
        """Assemble CompletedJob locations (ref :370-388, :416-473)."""
        job = self._get_job(job_id)
        if job is None:
            return
        final = job.stages[job.final_stage_id]
        locs = self._stage_output_locations(
            job_id, job.final_stage_id, final.output_partition_count
        )
        flat: list[PartitionLocation] = []
        for part in locs:
            flat.extend(part)
        job.completed_locations = flat
        job.status = "completed"
        # the final stage has no StageFinished event (JobFinished fires
        # instead) — run its skew check here so the last stage's
        # partitions are monitored like every other stage's
        self._detect_skew(job, job.final_stage_id)
        # fleet plane: end-to-end latency by query class
        if job.submitted_s:
            import time as _time

            self._h_job_latency.labels(job.query_class).observe(
                max(0.0, _time.time() - job.submitted_s)
            )
        if self.state is not None:
            self.state.save_job(job)
        # AQE learning that needs the full run's per-operator metrics
        # (inline-probe collect joins can only be sized post-hoc) —
        # BEFORE the trace closes so its decisions land in the span tree
        try:
            self.aqe.on_job_finished(job)
        except Exception:  # noqa: BLE001 — learning must never outrank
            # job completion
            log.exception("AQE completion policy failed for %s", job_id)
        # observability: stats + trace snapshot BEFORE the stage teardown
        # below — /api/job/<id> keeps serving the run's per-stage/
        # per-partition stats after completion (docs/observability.md)
        job.stage_stats = self.stage_manager.job_stage_detail(job_id)
        self._close_job_trace(job, "ok")
        self._retain_job_obs(job)
        # history log: exactly ONE terminal record per job, carrying the
        # latency/queue-wait/retry/skew counters and the aggregated cost
        # vector — the durable row system.queries serves
        try:
            self._job_terminal_history(job, "completed")
        except Exception:  # noqa: BLE001 — observability, never
            # completion-critical
            log.exception("history record failed for %s", job_id)
        # serving fast path (docs/serving.md): populate the result cache
        # from the COMMITTED locations, off-thread
        self._maybe_cache_result(job)
        # locations are snapshotted on the JobInfo; dropping the stage
        # bookkeeping zeroes the inflight count (KEDA's scale signal) and
        # stops fetch_schedulable_stage from ever seeing this job again
        self.stage_manager.remove_job_stages(job_id)
        log.info("job %s completed (%d partitions)", job_id, len(flat))

    def _on_job_failed(self, job_id: str, error: str) -> None:
        job = self._get_job(job_id)
        if job is None:
            return
        job.status = "failed"
        job.error = error
        job.stage_stats = self.stage_manager.job_stage_detail(job_id)
        self._close_job_trace(job, "error")
        self._retain_job_obs(job)
        try:
            self._job_terminal_history(job, "failed")
        except Exception:  # noqa: BLE001 — the failure path must not
            # fail on its own bookkeeping
            log.exception("history record failed for %s", job_id)
        # stage cleanup FIRST, and the write-through guarded: failure may
        # be the persistence backend itself, and skipping cleanup would
        # leave the failed job's PENDING tasks schedulable forever (push
        # mode hot-loops JobFailed<->ReviveOffers on an unresolvable
        # stage, and KEDA never sees the cluster go idle)
        self.stage_manager.remove_job_stages(job_id)
        if self.state is not None:
            try:
                self.state.save_job(job)
            except Exception:  # noqa: BLE001 — in-memory state still marks
                # the job failed; clients polling status get the error
                log.exception("persisting failed-job record for %s", job_id)
        log.error("job %s failed: %s", job_id, error)

    # -- task handout (pull mode; ref grpc.rs:121-147) -----------------------
    def _pick_eager_task(self, executor_id: str):
        """Eager-shuffle handout, tried only after assign_next_task found
        no runnable work: a pending consumer stage whose producers all
        have committed output may start fetching early (docs/shuffle.md).
        Soaking otherwise-idle slots is what makes this deadlock-free —
        any producer task that becomes PENDING again does so by freeing a
        slot (failure) or by lost-shuffle invalidation, and the next free
        slot always prefers runnable stages over eager ones."""
        with self._lock:
            eager_jobs = {
                jid
                for jid, j in self.jobs.items()
                if j.status == "running" and j.eager
            }
        if not eager_jobs:
            return None
        return self.stage_manager.assign_next_eager_task(
            executor_id, eager_jobs
        )

    def _eager_plan_bytes(self, job, job_id: str, stage_id: int) -> bytes:
        """Serialized eager resolution of one stage (cached: it depends
        only on the pristine template, never on locations, so recovery
        cannot invalidate it). Caller holds the server lock."""
        plan_bytes = job.eager_plan_bytes.get(stage_id)
        if plan_bytes is None:
            from ballista_tpu_torch.distributed_plan import resolve_shuffles_eager

            plan = resolve_shuffles_eager(
                job.stages[stage_id].plan, job_id
            )
            plan_bytes = self.codec.physical_to_proto(
                plan
            ).SerializeToString()
            job.eager_plan_bytes[stage_id] = plan_bytes
        return plan_bytes

    def next_task(self, executor_id: str) -> pb.TaskDefinition | None:
        tasks = self.next_tasks(executor_id, 1)
        return tasks[0] if tasks else None

    def next_tasks(
        self, executor_id: str, max_n: int
    ) -> list[pb.TaskDefinition]:
        """Batched pull-mode handout (docs/serving.md): up to ``max_n``
        task definitions for one PollWork round-trip. Bypass grants go
        first (the latency-sensitive small jobs, queued FIFO outside the
        stage machinery), then stage tasks via ONE atomic batched pick
        (assign_next_tasks — the pick/mark race stays closed per batch),
        and only when nothing else was runnable, a single eager-shuffle
        task (eager consumers soak otherwise-idle slots; granting them a
        whole batch would starve runnable work arriving mid-poll)."""
        max_n = max(1, max_n)
        out: list[pb.TaskDefinition] = []
        while len(out) < max_n:
            td = self._next_bypass_task(executor_id)
            if td is None:
                break
            out.append(td)
        if len(out) < max_n:
            for picked in self.stage_manager.assign_next_tasks(
                executor_id, max_n - len(out)
            ):
                td = self._task_def_from_pick(picked, eager_pick=False)
                if td is not None:
                    out.append(td)
        if not out:
            picked = self._pick_eager_task(executor_id)
            if picked is not None:
                td = self._task_def_from_pick(picked, eager_pick=True)
                if td is not None:
                    out.append(td)
        return out

    def _task_def_from_pick(
        self, picked, eager_pick: bool
    ) -> pb.TaskDefinition | None:
        # atomic pick+mark inside the stage manager: two concurrent
        # PollWork threads previously could both see the same partition
        # PENDING (the second RUNNING mark was silently dropped as an
        # illegal RUNNING->RUNNING hop) and both run the task
        job_id, stage_id, partition, attempt, events = picked
        for e in events:
            self.event_loop.post(e)
        task_id = PartitionId(job_id, stage_id, partition)
        job = self._get_job(job_id)
        if job is None:
            # job torn down between the pick and here; release the task
            self.stage_manager.update_task_status(task_id, TaskState.PENDING)
            return None
        failure: JobFailed | None = None
        with self._lock:
            if eager_pick:
                try:
                    plan_bytes = self._eager_plan_bytes(
                        job, job_id, stage_id
                    )
                except Exception as e:  # noqa: BLE001 — deterministic
                    self.stage_manager.update_task_status(
                        task_id, TaskState.PENDING
                    )
                    failure = JobFailed(
                        job_id, stage_id,
                        f"eager stage resolution failed: {e}",
                    )
                    log.exception(
                        "eager stage %s/%s resolution failed",
                        job_id, stage_id,
                    )
            else:
                plan_bytes = job.resolved_plan_bytes.get(stage_id)
            if not eager_pick and plan_bytes is None:
                # lazy (re-)resolution under the server lock, serialized
                # against _on_shuffle_lost: recovery may have demoted this
                # stage and dropped its resolved bytes between the
                # schedulable pick above and here. Resolving while a
                # producer is incomplete would bake EMPTY location lists
                # for the lost partitions into the plan — the task would
                # then "succeed" with rows silently missing — so re-check
                # producer completeness first and back out.
                unresolved = find_unresolved_shuffles(
                    job.stages[stage_id].plan
                )
                if any(
                    not self.stage_manager.is_completed_stage(
                        job_id, u.stage_id
                    )
                    for u in unresolved
                ):
                    self.stage_manager.update_task_status(
                        task_id, TaskState.PENDING
                    )
                    return None
                try:
                    self._resolve_stage(job_id, stage_id)
                    plan_bytes = job.resolved_plan_bytes[stage_id]
                except Exception as e:  # noqa: BLE001
                    # roll the RUNNING mark back so the task isn't leaked
                    # on an executor that never received it, and fail the
                    # job — resolution is deterministic, retrying can't
                    # help. The JobFailed is POSTED AFTER the lock is
                    # released: the event queue is bounded, and a blocking
                    # put under the server lock while the consumer thread
                    # wants the same lock is the racelint deadlock shape
                    self.stage_manager.update_task_status(
                        task_id, TaskState.PENDING
                    )
                    failure = JobFailed(
                        job_id, stage_id, f"stage resolution failed: {e}"
                    )
                    log.exception(
                        "stage %s/%s resolution failed", job_id, stage_id
                    )
        if failure is not None:
            self.event_loop.post(failure)
            return None
        self._meter_first_assign(job)
        props = self._task_props(job, stage_id, attempt)
        return pb.TaskDefinition(
            task_id=pb.PartitionId(
                job_id=job_id, stage_id=stage_id, partition_id=partition
            ),
            plan=plan_bytes,
            props=props,
            session_id=job.session_id,
        )

    def _meter_first_assign(self, job: JobInfo) -> None:
        """Queue-wait metering (docs/observability.md): the FIRST task
        assignment of a job closes its submit->assignment gap — the
        admission/backpressure signal the composite autoscale pressure
        and the SLO harness read. Shared by the stage and bypass handout
        paths so bypassed jobs meter identically."""
        import time as _time

        now = _time.time()
        with self._lock:
            first_assign = job.first_assign_s == 0.0
            if first_assign:
                job.first_assign_s = now
        if first_assign and job.submitted_s:
            wait = max(0.0, now - job.submitted_s)
            self._h_queue_wait.labels(job.query_class).observe(wait)
            with self._lock:
                self._recent_queue_waits.append((now, wait))

    def _task_props(
        self, job: JobInfo, stage_id: int, attempt: int
    ) -> list[pb.KeyValuePair]:
        cfg = self._session_config(job.session_id)
        from ballista_tpu_torch.config import (
            BALLISTA_INTERNAL_QUERY_CLASS,
            BALLISTA_INTERNAL_SPAN_PARENT,
            BALLISTA_INTERNAL_TASK_ATTEMPT,
            BALLISTA_INTERNAL_TRACE_ID,
        )

        props = [
            pb.KeyValuePair(key=k, value=v)
            for k, v in cfg.settings().items()
        ] + [
            # task-scoped (NOT session config; executors strip the
            # ballista.internal. prefix before building BallistaConfig):
            # the attempt number keys fault injection and retry logging;
            # the query class labels the executor's task-run histogram
            pb.KeyValuePair(
                key=BALLISTA_INTERNAL_TASK_ATTEMPT, value=str(attempt)
            ),
            pb.KeyValuePair(
                key=BALLISTA_INTERNAL_QUERY_CLASS, value=job.query_class
            ),
        ]
        if job.trace_id:
            # distributed tracing (docs/observability.md): the trace id
            # plus the stage span as the task-attempt span's parent —
            # a RETRY of a killed producer carries the SAME trace_id with
            # a new attempt span, which is what the chaos trace test
            # asserts
            props += [
                pb.KeyValuePair(
                    key=BALLISTA_INTERNAL_TRACE_ID, value=job.trace_id
                ),
                pb.KeyValuePair(
                    key=BALLISTA_INTERNAL_SPAN_PARENT,
                    value=self._stage_span_id(job, stage_id),
                ),
            ]
        return props

    # -- serving fast path (docs/serving.md) ---------------------------------
    def _submit_bypass(self, job: JobInfo, stage: QueryStage) -> None:
        """Register a single-stage job for direct grant: serialize the
        (already fully resolved — one stage means no placeholders) plan
        once, queue the job FIFO, and never touch the stage manager.
        Called from _generate_stages on the event-loop thread."""
        job_id = job.job_id
        job.stages[stage.stage_id] = stage
        job.final_stage_id = stage.stage_id
        job.bypass = True
        job.status = "running"
        plan_bytes = self.codec.physical_to_proto(
            stage.plan
        ).SerializeToString()
        if self.state is not None:
            self.state.save_stage_plan(job_id, stage.stage_id, stage.plan)
            self.state.save_job(job)
        self._open_stage_span(job, stage.stage_id)
        self._job_event(job, "bypass", attrs={"stage_id": stage.stage_id})
        with self._lock:
            job.resolved_plan_bytes[stage.stage_id] = plan_bytes
            self.obs_bypass_total += 1
            self._bypass_pending.append(job_id)

    def _next_bypass_task(
        self, executor_id: str
    ) -> pb.TaskDefinition | None:
        """Pop one queued bypass grant. The pending queue only ever holds
        job ids; torn-down/failed jobs are skipped here rather than
        scrubbed at teardown (the queue is short-lived and bounded by
        submission rate)."""
        job = None
        with self._lock:
            while self._bypass_pending:
                job_id = self._bypass_pending.popleft()
                j = self.jobs.get(job_id)
                if j is None or j.status != "running":
                    continue
                job = j
                stage_id = job.final_stage_id
                plan_bytes = job.resolved_plan_bytes[stage_id]
                attempt = self._bypass_attempts.get(job_id, 0)
                self._bypass_running[job_id] = executor_id
                break
        if job is None:
            return None
        self._meter_first_assign(job)
        props = self._task_props(job, stage_id, attempt)
        return pb.TaskDefinition(
            task_id=pb.PartitionId(
                job_id=job.job_id, stage_id=stage_id, partition_id=0
            ),
            plan=plan_bytes,
            props=props,
            session_id=job.session_id,
        )

    def _apply_bypass_status(
        self, job: JobInfo, tid: PartitionId, st: pb.TaskStatus, kind: str
    ) -> None:
        """Terminal handling for a bypassed job's single task — inline on
        the status RPC thread (no event-loop hop: bypass exists to cut
        exactly that latency, and a bypass job has no other events its
        completion could race)."""
        if kind == "completed":
            with self._lock:
                if job.status != "running":
                    return  # duplicate report after a terminal state
                self._bypass_running.pop(job.job_id, None)
            metas = [
                ShuffleWritePartitionMeta(
                    partition_id=int(p.partition_id),
                    path=p.path,
                    num_batches=int(p.num_batches),
                    num_rows=int(p.num_rows),
                    num_bytes=int(p.num_bytes),
                    push=bool(p.push),
                )
                for p in st.completed.partitions
            ]
            self._ingest_task_metrics(
                tid.job_id, tid.stage_id, tid.partition_id, st
            )
            try:
                self._ingest_task_cost(
                    tid, "completed", st.completed.executor_id,
                    st.completed.cost
                    if st.completed.HasField("cost") else None,
                )
            except Exception:  # noqa: BLE001
                log.exception("task-cost ingest failed for %s", tid)
            self._finish_bypass_job(job, st.completed.executor_id, metas)
        elif kind == "failed":
            error = st.failed.error
            try:
                self._ingest_task_cost(
                    tid, "failed", "",
                    st.failed.cost if st.failed.HasField("cost") else None,
                )
            except Exception:  # noqa: BLE001
                log.exception("task-cost ingest failed for %s", tid)
            retry = False
            with self._lock:
                if job.status != "running":
                    return
                self._bypass_running.pop(job.job_id, None)
                n = self._bypass_attempts.get(job.job_id, 0) + 1
                self._bypass_attempts[job.job_id] = n
                # same bounded-retry contract as the stage machinery:
                # the job's task_max_attempts snapshot caps attempts
                retry = error_is_retryable(error) and n < job.max_attempts
                if retry:
                    job.total_retries += 1
                    self._bypass_pending.append(job.job_id)
            if not retry:
                self._on_job_failed(
                    job.job_id,
                    f"task {tid.job_id}/{tid.stage_id}/"
                    f"{tid.partition_id} failed: {error}",
                )

    def _finish_bypass_job(
        self, job: JobInfo, executor_id: str,
        metas: list[ShuffleWritePartitionMeta],
    ) -> None:
        """Complete a bypassed job with full observability parity: the
        same locations shape (the client streams the result back through
        the existing Flight path), latency histogram, terminal history
        record, trace close, retention enrollment, and result-cache
        population as _on_job_finished."""
        host, port = self._executor_endpoint(executor_id)
        flat = [
            PartitionLocation(
                job_id=job.job_id,
                stage_id=job.final_stage_id,
                partition=m.partition_id,
                executor_id=executor_id,
                host=host,
                port=port,
                path=m.path,
                push=m.push,
                map_partition=0,
            )
            for m in metas
        ]
        job.completed_locations = flat
        job.status = "completed"
        if job.submitted_s:
            import time as _time

            self._h_job_latency.labels(job.query_class).observe(
                max(0.0, _time.time() - job.submitted_s)
            )
        if self.state is not None:
            try:
                self.state.save_job(job)
            except Exception:  # noqa: BLE001 — persistence must not
                # outrank the completion the client is polling for
                log.exception("persisting bypass job %s failed", job.job_id)
        self._finish_stage_span(job, job.final_stage_id)
        self._close_job_trace(job, "ok")
        self._retain_job_obs(job)
        try:
            self._job_terminal_history(job, "completed")
        except Exception:  # noqa: BLE001
            log.exception("history record failed for %s", job.job_id)
        self._maybe_cache_result(job)
        log.info(
            "job %s completed via bypass (%d partitions)",
            job.job_id, len(flat),
        )

    def _maybe_cache_result(self, job: JobInfo) -> None:
        """Kick off background result-cache population for a COMPLETED
        job. Off-thread: it re-reads the committed partitions (file or
        Flight), and the callers hold the completion path."""
        if not self.result_cache.enabled or job.cache_key is None:
            return
        if not job.completed_locations:
            return  # nothing committed to re-read; never cache a guess
        # fire-and-forget by design: one short-lived thread per
        # completed job, observed through result_cache.stats() (and the
        # resource witness when enabled), not a join
        t = threading.Thread(  # lifelint: transfer=job-completion-scoped
            target=self._populate_result_cache,
            args=(job,),
            daemon=True,
            name=f"result-cache-{job.job_id}",
        )
        t.start()

    def _populate_result_cache(self, job: JobInfo) -> None:
        """Fetch the job's committed final-stage partitions through the
        SAME reader path the client uses and store them as one Arrow IPC
        stream. Running strictly after the job completed is the
        committed-only guarantee: a task killed mid-run never reported
        partitions, so nothing partial is reachable from
        completed_locations; any fetch failure (executor died in the
        window) stores nothing."""
        try:
            import pyarrow as pa

            from ballista_tpu_torch.executor.reader import fetch_partition_table
            from ballista_tpu_torch.scheduler.result_cache import table_to_ipc

            # the client concatenates in completed_locations order —
            # matching it keeps a cache-served result bit-exact with a
            # freshly fetched one
            tables = [
                fetch_partition_table(loc)
                for loc in job.completed_locations
            ]
            table = (
                pa.concat_tables(tables) if len(tables) > 1 else tables[0]
            )
            payload = table_to_ipc(table)
            from ballista_tpu_torch.analysis import stalewitness

            if stalewitness.enabled():
                # staleness witness: this fresh committed result is the
                # re-derivation for any demoted hit on the same key —
                # the served-payload hash registered at the demotion
                # must match it (no pending expectation -> no-op)
                from ballista_tpu_torch.analysis import replay

                stalewitness.resolve(
                    "result_cache", job.cache_key,
                    replay.canonical_hash(table), table=table,
                )
            stored = self.result_cache.put(
                job.cache_key, payload, {"query_class": job.query_class}
            )
            if stored:
                self._job_event(
                    job, "cache",
                    attrs={"stored": True, "bytes": len(payload)},
                )
        except Exception:  # noqa: BLE001 — the cache is an optimization;
            # population failure must never surface to the finished job
            log.exception(
                "result-cache population failed for %s", job.job_id
            )

    # -- task handout (push mode; ref scheduler_server/event_loop.rs:35-169
    # + state/task_scheduler.rs:53-211) --------------------------------------
    def _drop_executor(self, executor_id: str) -> None:
        """Remove one executor from scheduling: slot data, heartbeats,
        dial-back client/channel, failure counter. Shared by the expiry
        sweep, the launch-failure path, and shutdown."""
        self.executor_manager.remove_executor(executor_id)
        self._launch_failures.pop(executor_id, None)
        with self._lock:
            self.executor_clients.pop(executor_id, None)
            ch = self._executor_channels.pop(executor_id, None)
        if ch is not None:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass

    def _get_executor_client(self, executor_id: str):
        """Dial-back client to a push-mode executor's ExecutorGrpc service
        (ref scheduler_grpc.rs:180-192 — the scheduler connects using the
        grpc_port carried in RegisterExecutor metadata)."""
        import grpc as _grpc

        from ballista_tpu_torch.scheduler.rpc import executor_stub

        with self._lock:
            stub = self.executor_clients.get(executor_id)
        if stub is not None:
            return stub
        em = self.executor_manager.get_executor_metadata(executor_id)
        if em is None or not em.grpc_port:
            return None
        # dial OUTSIDE the lock (racelint blocking-under-lock): channel
        # setup toward an unreachable executor must never stall other
        # control threads; a concurrent dial loses the store-race below
        # and its channel is closed
        ch = _grpc.insecure_channel(f"{em.host}:{em.grpc_port}")
        stub = executor_stub(ch)
        extra = None
        with self._lock:
            raced = self.executor_clients.get(executor_id)
            if raced is not None:
                stub, extra = raced, ch
            elif (
                self.executor_manager.get_executor_data(executor_id) is None
            ):
                # the expiry sweep dropped this executor while we dialed:
                # storing now would resurrect a stale entry that a later
                # re-registration (possibly on a new port) would keep
                # serving dead addresses from
                stub, extra = None, ch
            else:
                self._executor_channels[executor_id] = ch
                self.executor_clients[executor_id] = stub
        if extra is not None:
            try:
                extra.close()
            except Exception:  # noqa: BLE001
                pass
        return stub

    def _offer_resources(self) -> None:
        """Round-robin pack pending tasks onto free executor slots and
        LaunchTask each batch (ref task_scheduler.rs:53-211: walk executors
        in most-free-first order assigning one task per visit until slots
        or tasks run out; event_loop.rs:68-103 drives this on every
        ReviveOffers)."""
        if self.policy != TaskSchedulingPolicy.PUSH_STAGED:
            return
        # NO server lock around the assignment loop: ReviveOffers events
        # are consumed solely by the single event-loop thread (the only
        # caller), every structure touched has its own lock (executor
        # manager slots, stage manager picks — atomic via
        # assign_next_task), and holding the server lock across next_task
        # would hold it across event posts — the blocking-under-lock
        # deadlock shape racelint bans.
        assignments: dict[str, list[pb.TaskDefinition]] = {}
        execs = self.executor_manager.get_available_executors_data(
            self.executor_timeout_s
        )
        free = sum(d.available_task_slots for d in execs)
        i = 0
        while free > 0:
            d = execs[i % len(execs)]
            i += 1
            if d.available_task_slots <= 0:
                continue
            try:
                td = self.next_task(d.executor_id)
            except Exception:  # noqa: BLE001 — plan resolution failure
                log.exception("offer: next_task failed")
                break
            if td is None:
                break
            assignments.setdefault(d.executor_id, []).append(td)
            d.available_task_slots -= 1
            free -= 1
            self.executor_manager.update_executor_data(d.executor_id, -1)
        for eid, tasks in assignments.items():
            stub = self._get_executor_client(eid)
            ok = False
            if stub is not None:
                try:
                    # deadline is load-bearing: this runs on the single
                    # event-loop thread, and a blackholed executor without a
                    # call deadline would wedge all scheduling
                    stub.LaunchTask(
                        pb.LaunchTaskParams(tasks=tasks), timeout=10.0
                    )
                    ok = True
                    self._launch_failures.pop(eid, None)
                except Exception as e:  # noqa: BLE001 — executor unreachable
                    log.warning("LaunchTask to %s failed: %s", eid, e)
            if not ok:
                # roll back: tasks go RUNNING->PENDING (the legal executor-
                # lost reset) and slots are returned
                for td in tasks:
                    self.stage_manager.update_task_status(
                        PartitionId(
                            td.task_id.job_id,
                            td.task_id.stage_id,
                            td.task_id.partition_id,
                        ),
                        TaskState.PENDING,
                    )
                self.executor_manager.update_executor_data(eid, len(tasks))
                # a heartbeating-but-undialable executor would soak every
                # re-offer forever; after N consecutive failures drop it
                # from scheduling (its next heartbeat gets reregister=true,
                # which retries the dial-back from scratch)
                n_fail = self._launch_failures.get(eid, 0) + 1
                self._launch_failures[eid] = n_fail
                if n_fail >= self.max_launch_failures:
                    log.error(
                        "executor %s unreachable after %d LaunchTask "
                        "attempts; dropping from scheduling", eid, n_fail,
                    )
                    self._drop_executor(eid)
                # schedule a delayed re-offer (delayed, not immediate, so a
                # persistently unreachable executor can't spin the event
                # loop)
                t = threading.Timer(
                    1.0, self.event_loop.post, args=(ReviveOffers(),)
                )
                t.daemon = True
                t.start()

    def apply_task_statuses(self, statuses: list[pb.TaskStatus]) -> None:
        """ref scheduler_server/mod.rs update_task_status :171-191."""
        for st in statuses:
            tid = PartitionId(
                st.task_id.job_id, st.task_id.stage_id, st.task_id.partition_id
            )
            kind = st.WhichOneof("status")
            # bypassed jobs (docs/serving.md) have no stage bookkeeping:
            # their single task's terminal status completes/fails the job
            # inline instead of flowing through the stage state machine
            bjob = self._get_job(tid.job_id)
            if bjob is not None and bjob.bypass:
                if kind in ("completed", "failed"):
                    self._apply_bypass_status(bjob, tid, st, kind)
                continue
            if kind == "completed":
                metas = [
                    ShuffleWritePartitionMeta(
                        partition_id=int(p.partition_id),
                        path=p.path,
                        num_batches=int(p.num_batches),
                        num_rows=int(p.num_rows),
                        num_bytes=int(p.num_bytes),
                        push=bool(p.push),
                    )
                    for p in st.completed.partitions
                ]
                events = self.stage_manager.update_task_status(
                    tid,
                    TaskState.COMPLETED,
                    executor_id=st.completed.executor_id,
                    partitions=metas,
                )
                # per-operator metrics shipped home (docs/observability.md)
                self._ingest_task_metrics(
                    tid.job_id, tid.stage_id, tid.partition_id, st
                )
                # cost accounting: the attempt's resource vector sums
                # into the job + class rollups and the history log.
                # Guarded like the straggler metering below — an
                # escaping exception after the transition applied would
                # wedge the job (see that comment).
                try:
                    self._ingest_task_cost(
                        tid, "completed", st.completed.executor_id,
                        st.completed.cost
                        if st.completed.HasField("cost") else None,
                    )
                except Exception:  # noqa: BLE001
                    log.exception("task-cost ingest failed for %s", tid)
                # fleet plane: stage-task duration histogram + the
                # straggler check, both off the just-closed window.
                # Guarded: an escaping metering exception here would
                # abort the RPC AFTER update_task_status already applied
                # the transition — the executor's retry then replays a
                # now-illegal COMPLETED->COMPLETED hop that returns no
                # events, so the StageFinished/JobFinished generated
                # above would be lost FOREVER and the job would wedge
                # "running" (observed: a NameError in the straggler log
                # line wedged every straggler-flagging run).
                try:
                    self._observe_task_completion(tid)
                except Exception:  # noqa: BLE001 — metering must never
                    # outrank the terminal events it rides along with
                    log.exception(
                        "task-completion metering failed for %s", tid
                    )
            elif kind == "failed":
                error = st.failed.error
                # a ShuffleFetchError carries the SOURCE of the lost data;
                # trigger producer-side recovery and requeue the reader
                # without consuming one of its own attempts (the blame
                # belongs to the producing executor's lost output, and
                # boundedness comes from the producer's recompute cap)
                src = parse_shuffle_fetch_error(error)
                count_attempt = True
                if src is not None:
                    src_job, src_stage, _src_part, src_exec = src
                    recovered = self._on_shuffle_lost(
                        src_job or tid.job_id, src_stage, src_exec
                    )
                    # only skip the attempt charge when recovery actually
                    # re-opened something: otherwise (unparseable executor,
                    # repeated loss already handled) the normal bounded
                    # path keeps the failure from looping forever.
                    # Exception: an eager reader giving up on a SLOW (not
                    # lost) producer (docs/shuffle.md) — charging that
                    # would fail healthy jobs barriered mode would have
                    # waited out; the requeue is bounded by producer
                    # progress, exactly like barriered waiting.
                    eager_timeout = "[eager-wait-timeout]" in error
                    count_attempt = not (recovered or eager_timeout)
                # failed attempts charge their cost too (retries are
                # exactly the attempts a tenant should see billed)
                try:
                    self._ingest_task_cost(
                        tid, "failed", "",
                        st.failed.cost
                        if st.failed.HasField("cost") else None,
                    )
                except Exception:  # noqa: BLE001
                    log.exception("task-cost ingest failed for %s", tid)
                events = self.stage_manager.update_task_status(
                    tid,
                    TaskState.FAILED,
                    error=error,
                    retryable=error_is_retryable(error),
                    count_attempt=count_attempt,
                )
            elif kind == "running":
                events = self.stage_manager.update_task_status(
                    tid, TaskState.RUNNING, executor_id=st.running.executor_id
                )
            else:
                events = []
            for e in events:
                self.event_loop.post(e)

    def shuffle_locations_proto(
        self, job_id: str, stage_id: int, partition: int
    ) -> pb.ShuffleLocationsResult:
        """GetShuffleLocations (eager shuffle, docs/shuffle.md): the
        published map outputs of one producing stage feeding one output
        partition, plus the completed-task prefix and commit flag.
        ``failed`` tells the polling reader to stop waiting: the job is
        gone/failed, or the stage bookkeeping was torn down."""
        res = pb.ShuffleLocationsResult()
        job = self._get_job(job_id)
        if job is None or job.status not in ("queued", "running"):
            res.failed = True
            return res
        snap = self.stage_manager.shuffle_locations(
            job_id, stage_id, partition
        )
        if snap is None:
            res.failed = True
            return res
        entries, prefix, complete = snap
        res.tasks_done_prefix = prefix
        res.complete = complete
        for task_idx, executor_id, m in entries:
            host, port = self._executor_endpoint(executor_id)
            res.map_task.append(task_idx)
            res.locations.append(
                loc_to_proto(
                    PartitionLocation(
                        job_id=job_id,
                        stage_id=stage_id,
                        partition=partition,
                        executor_id=executor_id,
                        host=host,
                        port=port,
                        path=m.path,
                        # push-capable eager metadata (docs/shuffle.md)
                        push=m.push,
                        map_partition=task_idx,
                    )
                )
            )
        return res

    def job_status_proto(self, job_id: str) -> pb.JobStatus:
        job = self._get_job(job_id)
        if job is None:
            return pb.JobStatus(failed=pb.FailedJob(error="unknown job"))
        if job.status == "queued":
            return pb.JobStatus(queued=pb.QueuedJob())
        if job.status == "running":
            return pb.JobStatus(running=pb.RunningJob())
        if job.status == "failed":
            return pb.JobStatus(failed=pb.FailedJob(error=job.error))
        return pb.JobStatus(
            completed=pb.CompletedJob(
                partition_location=[
                    loc_to_proto(l) for l in job.completed_locations
                ],
                # result-cache hits (docs/serving.md): the payload rides
                # the status reply and the client short-circuits the
                # partition fetch entirely
                result_ipc=job.result_ipc,
            )
        )

    def shutdown(self) -> None:
        """Stop and JOIN every thread this server started (expiry sweep,
        event loop) — abandoning daemon threads leaks them across repeated
        start/stop cycles in one process (tests assert a zero
        ``threading.enumerate()`` delta)."""
        self._expiry_stop.set()
        self._expiry_thread.join(timeout=5)
        self.event_loop.stop()
        with self._lock:
            channels = list(self._executor_channels.values())
            self._executor_channels.clear()
            self.executor_clients.clear()
        # close outside the lock: channel teardown does socket work
        for ch in channels:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass


class SchedulerGrpcServicer:
    """The gRPC surface (ref grpc.rs:57-553)."""

    def __init__(self, server: SchedulerServer):
        self.s = server

    def PollWork(self, request: pb.PollWorkParams, context):
        # policy handshake: a pull-mode executor against a push-staged
        # scheduler must fail loudly, not be silently half-served (the
        # reference rejects PollWork under push-staged, grpc.rs:110-118)
        if self.s.policy == TaskSchedulingPolicy.PUSH_STAGED:
            import grpc as _grpc

            context.abort(
                _grpc.StatusCode.FAILED_PRECONDITION,
                "scheduler is push-staged; start the executor with "
                "--task-scheduling-policy push-staged",
            )
        meta = request.metadata
        em = ExecutorMetadata(
            id=meta.id,
            host=meta.host,
            port=meta.port,
            grpc_port=meta.grpc_port,
            specification=ExecutorSpecification(
                task_slots=meta.specification.task_slots or 4,
                n_devices=meta.specification.n_devices or 1,
            ),
        )
        self.s.executor_manager.save_executor_metadata(em)
        self.s.executor_manager.save_executor_heartbeat(meta.id)
        self.s.executor_manager.save_executor_metrics(
            meta.id, {kv.key: float(kv.value) for kv in request.metrics}
        )
        self.s.persist_executor(em)
        if self.s.executor_manager.get_executor_data(meta.id) is None:
            self.s.executor_manager.save_executor_data(
                ExecutorData(
                    meta.id,
                    em.specification.task_slots,
                    em.specification.task_slots,
                )
            )
        self.s.ingest_spans(list(request.spans))
        self.s.ingest_hists(list(request.hists))
        self.s.apply_task_statuses(list(request.task_status))
        result = pb.PollWorkResult()
        if request.can_accept_task:
            # batched grants (docs/serving.md): an executor advertising
            # free_slots gets up to min(free_slots, task_grant_batch)
            # tasks per round-trip; free_slots == 0 is a pre-batching
            # executor, which gets at most one. The batch knob is read
            # from the SCHEDULER's config — PollWork carries no session.
            max_n = 1
            if request.free_slots > 0:
                max_n = min(
                    int(request.free_slots),
                    self.s.config.task_grant_batch(),
                )
            tasks = self.s.next_tasks(meta.id, max_n)
            if tasks:
                result.tasks.extend(tasks)
                # mirror the first grant into the singular field so a
                # pre-batching executor still makes progress
                result.task.CopyFrom(tasks[0])
        return result

    def RegisterExecutor(self, request, context):
        # inverse policy handshake: a push-mode executor registering with a
        # pull-staged scheduler would wait for LaunchTasks that never come
        if self.s.policy != TaskSchedulingPolicy.PUSH_STAGED:
            import grpc as _grpc

            context.abort(
                _grpc.StatusCode.FAILED_PRECONDITION,
                "scheduler is pull-staged; start the executor with "
                "--task-scheduling-policy pull-staged",
            )
        meta = request.metadata
        em = ExecutorMetadata(
            id=meta.id,
            host=meta.host,
            port=meta.port,
            grpc_port=meta.grpc_port,
            specification=ExecutorSpecification(
                task_slots=meta.specification.task_slots or 4,
                n_devices=meta.specification.n_devices or 1,
            ),
        )
        self.s.executor_manager.save_executor_metadata(em)
        self.s.executor_manager.save_executor_heartbeat(meta.id)
        self.s.persist_executor(em)
        # keep existing slot accounting on re-registration (a recovered
        # executor may still be draining pre-expiry tasks; resetting to
        # full would oversubscribe it). After an expiry the data is gone and
        # a fresh full grant is unavoidable — tasks still physically running
        # from before the expiry can then transiently oversubscribe the
        # executor by up to task_slots; they queue behind its runner pool,
        # so the bound is 2x threads queued, not 2x executing
        if self.s.executor_manager.get_executor_data(meta.id) is None:
            self.s.executor_manager.save_executor_data(
                ExecutorData(
                    meta.id,
                    em.specification.task_slots,
                    em.specification.task_slots,
                )
            )
        # push mode: a new executor is new capacity — offer immediately
        # (ref scheduler_grpc.rs:166-199)
        if self.s.policy == TaskSchedulingPolicy.PUSH_STAGED:
            self.s.event_loop.post(ReviveOffers())
        return pb.RegisterExecutorResult(success=True)

    def HeartBeatFromExecutor(self, request, context):
        self.s.executor_manager.save_executor_heartbeat(request.executor_id)
        self.s.executor_manager.save_executor_metrics(
            request.executor_id,
            {kv.key: float(kv.value) for kv in request.metrics},
        )
        self.s.ingest_spans(list(request.spans))
        self.s.ingest_hists(list(request.hists))
        # an executor the expiry sweep dropped (or a scheduler that restarted
        # without its registration) must re-register to get slots back
        reregister = (
            self.s.executor_manager.get_executor_data(request.executor_id)
            is None
        )
        return pb.HeartBeatResult(reregister=reregister)

    def UpdateTaskStatus(self, request, context):
        self.s.ingest_spans(list(request.spans))
        self.s.apply_task_statuses(list(request.task_status))
        n_done = sum(
            1
            for st in request.task_status
            if st.WhichOneof("status") in ("completed", "failed")
        )
        if n_done:
            self.s.executor_manager.update_executor_data(
                request.executor_id, n_done
            )
            # push mode: freed slots may unlock queued tasks even when no
            # stage event fired (ref scheduler_grpc.rs:246-252)
            if self.s.policy == TaskSchedulingPolicy.PUSH_STAGED:
                self.s.event_loop.post(ReviveOffers())
        return pb.UpdateTaskStatusResult(success=True)

    def GetFileMetadata(self, request, context):
        """Parquet-only schema inference (ref grpc.rs:279-326): the footer
        is read on the host; the card is not touched."""
        import grpc as _grpc
        import pyarrow.parquet as papq

        from ballista_tpu_torch.columnar.arrow_interop import schema_from_arrow
        from ballista_tpu_torch.serde import schema_to_proto

        if request.file_type not in ("parquet", ""):
            context.abort(
                _grpc.StatusCode.INVALID_ARGUMENT,
                f"unsupported file type {request.file_type!r}",
            )
        schema = schema_from_arrow(papq.read_schema(request.path))
        return pb.GetFileMetadataResult(schema=schema_to_proto(schema))

    def ExecuteQuery(self, request, context):
        settings = {kv.key: kv.value for kv in request.settings}
        session_id = self.s.get_or_create_session(request.session_id, settings)
        kind = request.WhichOneof("query")
        if kind is None:
            # session-create-only call (ref context.rs remote() :83-135)
            return pb.ExecuteQueryResult(job_id="", session_id=session_id)
        try:
            if kind == "sql":
                job_id = self.s.submit_sql(request.sql, session_id)
            else:
                from ballista_tpu_torch.serde import logical_from_proto

                node = pb.LogicalPlanNode()
                node.ParseFromString(request.logical_plan)
                job_id = self.s.submit_logical(
                    logical_from_proto(node), session_id
                )
        except Exception as e:  # noqa: BLE001
            log.exception("ExecuteQuery failed")
            job_id = generate_job_id()
            with self.s._lock:
                self.s.jobs[job_id] = JobInfo(
                    job_id=job_id, session_id=session_id, status="failed",
                    error=str(e),
                )
        return pb.ExecuteQueryResult(job_id=job_id, session_id=session_id)

    def GetJobStatus(self, request, context):
        return pb.GetJobStatusResult(
            status=self.s.job_status_proto(request.job_id)
        )

    def GetShuffleLocations(self, request, context):
        """Eager-shuffle location poll (request reuses the FetchPartition
        vocabulary: job, producing stage, output partition)."""
        return self.s.shuffle_locations_proto(
            request.job_id, request.stage_id, request.partition_id
        )

    def GetHistory(self, request, context):
        """Queryable history (docs/observability.md): the persistent
        query log / per-attempt cost records / executor roster, as JSON
        rows — the source the client-side system.* SQL tables
        materialize from."""
        import json as _json

        try:
            rows = self.s.history_payload(
                request.kind or "queries", int(request.limit)
            )
        except ValueError as e:
            import grpc as _grpc

            context.abort(_grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.GetHistoryResult(payload=_json.dumps(rows).encode())


def start_scheduler_grpc(
    server: SchedulerServer, host: str = "0.0.0.0", port: int = 0
):
    """Start the gRPC server; returns (grpc_server, bound_port)."""
    import grpc as _grpc

    from ballista_tpu_torch.scheduler.rpc import (
        SCHEDULER_METHODS,
        SCHEDULER_SERVICE,
        add_service,
    )

    gs = _grpc.server(
        __import__("concurrent.futures", fromlist=["ThreadPoolExecutor"])
        .ThreadPoolExecutor(max_workers=16)
    )
    add_service(gs, SCHEDULER_SERVICE, SCHEDULER_METHODS, SchedulerGrpcServicer(server))
    # KEDA external scaler rides the same port (ref main.rs:136-166
    # multiplexes gRPC services on the scheduler's bind address)
    from ballista_tpu_torch.scheduler.external_scaler import add_external_scaler

    add_external_scaler(gs, server)
    bound = gs.add_insecure_port(f"{host}:{port}")
    gs.start()
    return gs, bound
