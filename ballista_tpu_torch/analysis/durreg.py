"""The declared durability registry: every piece of scheduler state is
a recovery contract.

The ROADMAP's elastic-fleet item (scheduler HA, rolling restarts as
routine operations) rests on one assumption: every mutable control-plane
field either survives a restart through
:class:`~ballista_tpu_torch.scheduler.persistent_state.PersistentSchedulerState`
or is legitimately rebuildable. Today ``_recover_state`` recovers
whatever someone remembered to persist — nothing fails when a new
mutable field lands on ``SchedulerServer``/``StageManager``/``JobInfo``
with no recovery story. This module closes the class the way
:mod:`ballista_tpu_torch.analysis.cachereg` closed cache coherence: state may
only exist if it is DECLARED here with a durability class, and
:mod:`ballista_tpu_torch.analysis.durlint` proves the tree against the
declarations while :mod:`ballista_tpu_torch.analysis.durwitness` proves the
running system (restart + failover) against them.

Durability classes (what a scheduler restart does to the field):

- ``persisted`` — written through ``PersistentSchedulerState`` and read
  back in ``_recover_state``; the entry names its save/load pair and
  durlint's recovery-gap rule proves the load actually runs (write-only
  durability is the silent failure mode).
- ``rebuilt`` — reconstructed from a declared source after restart:
  executor re-registration/heartbeats, a backend prefix scan, or
  derivation from other declared state. The witness asserts these start
  empty and converge once the source replays.
- ``ephemeral`` — deliberately lost on restart. Must either cross-link
  a declared cachereg entry (restart-cold caches) or carry a written
  justification naming where the durable record lives instead (usually
  the append-only HistoryStore).

Anchors are ``"relative/path.py::Class.attr"`` (instance attribute or
dataclass field) — :func:`verify_anchors` proves every anchor still
resolves against the live tree, so a rename goes red in the gate
instead of silently orphaning the declaration. The reverse direction —
no mutable control-plane field left undeclared — is durlint's
``undeclared-state`` rule over :data:`CONTROL_CLASSES`.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

from ballista_tpu_torch.analysis import cachereg


@dataclasses.dataclass(frozen=True)
class StateEntry:
    """One declared state-field group. ``save``/``load`` name the
    ``PersistentSchedulerState`` method pair for ``persisted`` entries;
    ``recovery`` carries the rebuild source for ``rebuilt`` entries and
    the written justification for ``ephemeral`` ones; ``cache_link``
    cross-links restart-cold caches to their cachereg declarations."""

    name: str
    anchors: tuple[str, ...]
    durability: str  # persisted | rebuilt | ephemeral
    contents: str
    save: str | None = None
    load: str | None = None
    recovery: str = ""
    cache_link: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class PersistenceContract:
    """Machine-checked mutator→must-persist obligation: every
    ``mutators`` function in ``file`` must contain a call whose dotted
    name ends with each ``must_call`` suffix — durlint's
    unpersisted-mutation rule. This is how "every terminal job
    transition reaches save_job" stops being reviewer folklore and
    becomes a gate failure when the call is dropped."""

    source: str
    file: str
    mutators: tuple[str, ...]
    must_call: tuple[str, ...]
    fields: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class WriteSeam:
    """A declared exception to the backend-write lock discipline:
    functions in ``file`` that may call ``backend.put``/``backend.delete``
    outside ``with backend.lock():``, with the reasoning written down.
    Everything else is durlint's unguarded-backend-write rule — the
    split-brain shape that breaks two-scheduler etcd deployments."""

    file: str
    functions: tuple[str, ...]
    reason: str


DURABILITY = ("persisted", "rebuilt", "ephemeral")

STATE: tuple[StateEntry, ...] = (
    # -- persisted: the PersistentSchedulerState backbone -------------------
    StateEntry(
        name="job-map",
        anchors=("ballista_tpu_torch/scheduler/server.py::SchedulerServer.jobs",),
        durability="persisted",
        contents="job_id -> JobInfo, the scheduler's job table",
        save="save_job",
        load="load_jobs",
    ),
    StateEntry(
        name="job-record",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.job_id",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.session_id",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.status",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.error",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.final_stage_id",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.dependencies",
        ),
        durability="persisted",
        contents="the durable job record: identity, session, status, "
        "error, final stage, stage dependency graph",
        save="save_job",
        load="load_jobs",
    ),
    StateEntry(
        name="completed-locations",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::"
            "JobInfo.completed_locations",
        ),
        durability="persisted",
        contents="a completed job's committed partition locations — the "
        "payload GetJobStatus serves after a restart",
        save="save_job",
        load="load_jobs",
    ),
    StateEntry(
        name="stage-plans",
        anchors=("ballista_tpu_torch/scheduler/server.py::JobInfo.stages",),
        durability="persisted",
        contents="stage id -> pristine QueryStage templates (serialized "
        "per stage; recovery rebuilds the QueryStage objects)",
        save="save_stage_plan",
        load="load_stage_plans",
    ),
    StateEntry(
        name="sessions",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::SchedulerServer.sessions",
        ),
        durability="persisted",
        contents="session_id -> BallistaConfig settings snapshot",
        save="save_session",
        load="load_sessions",
    ),
    StateEntry(
        name="executor-metadata",
        anchors=(
            "ballista_tpu_torch/scheduler/executor_manager.py::"
            "ExecutorManager._metadata",
        ),
        durability="persisted",
        contents="executor_id -> host/ports/specification; kept past "
        "deregistration because shuffle locations reference the host",
        save="save_executor_metadata",
        load="load_executors",
    ),
    # -- rebuilt: reconstructed from a declared source ----------------------
    StateEntry(
        name="executor-heartbeats",
        anchors=(
            "ballista_tpu_torch/scheduler/executor_manager.py::"
            "ExecutorManager._heartbeats",
        ),
        durability="rebuilt",
        contents="executor_id -> last heartbeat timestamp",
        recovery="executor re-registration and heartbeat RPCs repopulate "
        "it; until then the expiry sweep treats unseen executors as "
        "expired, which is the safe default",
    ),
    StateEntry(
        name="executor-slots",
        anchors=(
            "ballista_tpu_torch/scheduler/executor_manager.py::"
            "ExecutorManager._data",
        ),
        durability="rebuilt",
        contents="executor_id -> live slot accounting (ExecutorData)",
        recovery="re-registration/PollWork grant a fresh full-slot "
        "record; pre-restart in-flight tasks queue behind the executor's "
        "runner pool (bounded oversubscription, see RegisterExecutor)",
    ),
    StateEntry(
        name="executor-metrics",
        anchors=(
            "ballista_tpu_torch/scheduler/executor_manager.py::"
            "ExecutorManager._metrics",
        ),
        durability="rebuilt",
        contents="executor_id -> latest shipped metrics snapshot",
        recovery="overwritten wholesale by the next heartbeat/poll",
    ),
    StateEntry(
        name="executor-clients",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.executor_clients",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._executor_channels",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._launch_failures",
        ),
        durability="rebuilt",
        contents="push-mode gRPC channels/stubs back to executors plus "
        "consecutive launch-failure counts",
        recovery="re-dialed lazily at registration/offer time; failure "
        "counts restart at zero (an executor only pays for failures the "
        "CURRENT scheduler observed)",
    ),
    StateEntry(
        name="stage-state",
        anchors=(
            "ballista_tpu_torch/scheduler/stage_manager.py::StageManager._stages",
            "ballista_tpu_torch/scheduler/stage_manager.py::StageManager._running",
            "ballista_tpu_torch/scheduler/stage_manager.py::StageManager._pending",
            "ballista_tpu_torch/scheduler/stage_manager.py::"
            "StageManager._completed",
            "ballista_tpu_torch/scheduler/stage_manager.py::"
            "StageManager._dependencies",
            "ballista_tpu_torch/scheduler/stage_manager.py::"
            "StageManager._final_stage",
        ),
        durability="rebuilt",
        contents="the live stage DAG: per-stage task tables, "
        "running/pending/completed membership, dependency edges, final "
        "stage ids",
        recovery="deliberately NOT persisted (matches the reference "
        "persistent_state.rs): _recover_state closes every in-flight "
        "job as failed — clients resubmit and stages regenerate from "
        "the persisted stage plans",
    ),
    StateEntry(
        name="trace-index",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::SchedulerServer._traces",
        ),
        durability="rebuilt",
        contents="trace_id -> job_id for executor span ingestion",
        recovery="derived from the jobs map at submission; recovered "
        "jobs are terminal, so no further span ingestion is expected "
        "for them",
    ),
    # -- ephemeral: deliberately lost, with the durable record named --------
    StateEntry(
        name="resolved-plan-bytes",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.resolved_plan_bytes",
        ),
        durability="ephemeral",
        contents="stage id -> shuffle-patched serialized plans",
        recovery="derived cache over stage-plans + live locations; "
        "re-resolved on demand after recovery",
        cache_link=("resolved-plan-bytes",),
    ),
    StateEntry(
        name="eager-plan-bytes",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.eager",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.eager_plan_bytes",
        ),
        durability="ephemeral",
        contents="eager-shuffle session flag snapshot + per-stage eager "
        "resolutions",
        recovery="derived cache over the pristine stage templates; "
        "re-derived on demand",
        cache_link=("eager-plan-bytes",),
    ),
    StateEntry(
        name="result-cache-state",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::SchedulerServer.result_cache",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.cache_key",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.result_ipc",
        ),
        durability="ephemeral",
        contents="the serving-path result cache plus the per-job cache "
        "key / served-payload fields",
        recovery="in-memory only BY DESIGN: a restarted scheduler starts "
        "cold, which is the no-stale-serve-after-recovery contract "
        "(the witness asserts emptiness post-restart)",
        cache_link=("result-cache",),
    ),
    StateEntry(
        name="bypass-state",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._bypass_pending",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._bypass_running",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._bypass_attempts",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.bypass",
        ),
        durability="ephemeral",
        contents="single-stage-bypass grant queue, running map, attempt "
        "counts, and the per-job bypass flag",
        recovery="grants die with the scheduler: bypass jobs are "
        "in-flight jobs, so _recover_state closes them as failed and "
        "clients resubmit (same contract as stage-state)",
    ),
    StateEntry(
        name="job-run-counters",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.max_attempts",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.total_retries",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.total_recomputes",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.total_rewrites",
            "ballista_tpu_torch/scheduler/server.py::"
            "JobInfo.total_rewrite_rejects",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.rewrite_log",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.rewritten_stages",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.aqe_decisions",
        ),
        durability="ephemeral",
        contents="retry-policy snapshot plus retry/recompute/rewrite "
        "visibility counters and decision logs",
        recovery="the durable record is the HistoryStore terminal row "
        "(obs/history.py record_terminal carries the counters); the "
        "live fields only feed /api/job for running jobs",
    ),
    StateEntry(
        name="job-obs-payloads",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::JobInfo.trace_id",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.root_span_id",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.stage_spans",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.spans",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.op_metrics",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.stage_stats",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.root_span",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.query_class",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.submitted_s",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.first_assign_s",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.skew_flags",
            "ballista_tpu_torch/scheduler/server.py::JobInfo.cost",
        ),
        durability="ephemeral",
        contents="per-job observability payloads: trace/span state, "
        "operator metrics, stage stats, query class, timing, skew "
        "flags, cost vector",
        recovery="the durable record is the HistoryStore terminal row "
        "(latency, queue wait, cost, class); live spans/metrics are "
        "scrape-time state that dies with the run",
    ),
    StateEntry(
        name="scheduler-obs-counters",
        anchors=(
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.obs_task_counters",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._obs_retained",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.obs_straggler_total",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.obs_skew_total",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._recent_queue_waits",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer._known_classes",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.obs_class_cost",
            "ballista_tpu_torch/scheduler/server.py::"
            "SchedulerServer.obs_aqe_total",
        ),
        durability="ephemeral",
        contents="cross-job metrics aggregations: task counters, "
        "retained terminal-job payload ring, straggler/skew counters, "
        "recent queue-wait window, query-class cardinality set, "
        "per-class cost rollup, AQE counters",
        recovery="metrics sinks restart at zero like any process "
        "counter (prometheus counters are resets-tolerant by "
        "convention); the durable analog is the HistoryStore query log",
    ),
)

CONTROL_CLASSES: dict[str, str] = {
    # class anchor -> sweep mode for durlint's undeclared-state rule:
    # "init-containers" flags every `self.x = <mutable container>` in the
    # class with no registry anchor; "dataclass-fields" requires EVERY
    # dataclass field to be anchored (scalars included — a scalar status
    # field is exactly the state a restart loses).
    "ballista_tpu_torch/scheduler/server.py::SchedulerServer": "init-containers",
    "ballista_tpu_torch/scheduler/server.py::JobInfo": "dataclass-fields",
    "ballista_tpu_torch/scheduler/stage_manager.py::StageManager":
        "init-containers",
    "ballista_tpu_torch/scheduler/executor_manager.py::ExecutorManager":
        "init-containers",
}

# Machine-checked persistence obligations (durlint unpersisted-mutation).
CONTRACTS: tuple[PersistenceContract, ...] = (
    PersistenceContract(
        source="job-terminal",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=(
            "_on_job_finished", "_on_job_failed", "_finish_bypass_job",
            "_recover_state",
        ),
        must_call=("save_job",),
        fields=("job-record", "completed-locations"),
    ),
    PersistenceContract(
        source="job-submit",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("submit_physical",),
        must_call=("save_job",),
        fields=("job-record",),
    ),
    PersistenceContract(
        source="stage-generation",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("_generate_stages",),
        must_call=("save_stage_plan", "save_job"),
        fields=("stage-plans", "job-record"),
    ),
    PersistenceContract(
        source="rewrite-acceptance",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("apply_certified_rewrite",),
        must_call=("save_stage_plan",),
        fields=("stage-plans",),
    ),
    PersistenceContract(
        source="bypass-submit",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("_submit_bypass",),
        must_call=("save_stage_plan", "save_job"),
        fields=("stage-plans", "job-record"),
    ),
    PersistenceContract(
        source="session-create",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("get_or_create_session",),
        must_call=("save_session",),
        fields=("sessions",),
    ),
    PersistenceContract(
        source="executor-register",
        file="ballista_tpu_torch/scheduler/server.py",
        mutators=("persist_executor",),
        must_call=("save_executor_metadata",),
        fields=("executor-metadata",),
    ),
)

# Declared exceptions to the backend-write lock discipline (durlint
# unguarded-backend-write). The history log is append-only with unique
# stamped keys and a single logical writer per job, so its puts need no
# global lock — taking it would serialize the observability plane behind
# persistence. Everything else must write under `with backend.lock():`.
WRITE_SEAMS: tuple[WriteSeam, ...] = (
    WriteSeam(
        file="ballista_tpu_torch/obs/history.py",
        functions=(
            "record_submit", "record_terminal", "record_attempt",
            "_enforce_retention",
        ),
        reason="append-only log: keys are uniquely stamped per "
        "(job, kind), each record is written once by the single "
        "scheduler that owns the job, and retention only deletes keys "
        "it stamped — no read-modify-write to race",
    ),
)


def _package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def anchor_index() -> dict[str, str]:
    """anchor -> declared entry name; duplicate anchors are a registry
    bug caught here."""
    idx: dict[str, str] = {}
    for e in STATE:
        for a in e.anchors:
            assert a not in idx, f"anchor declared twice: {a}"
            idx[a] = e.name
    return idx


def entry(name: str) -> StateEntry:
    for e in STATE:
        if e.name == name:
            return e
    raise KeyError(name)


def entries(durability: str) -> tuple[StateEntry, ...]:
    return tuple(e for e in STATE if e.durability == durability)


def verify_anchors() -> list[str]:
    """Every declared anchor must resolve against the live tree, every
    durability class must be legal and carry its required story
    (save/load pair, rebuild source, or justification/cache link), and
    every contract/cache-link reference must resolve."""
    root = _package_root()
    problems: list[str] = []
    trees: dict[str, ast.Module] = {}

    def tree_for(rel: str) -> ast.Module | None:
        if rel not in trees:
            path = root / rel
            if not path.exists():
                return None
            trees[rel] = ast.parse(path.read_text(), filename=rel)
        return trees[rel]

    anchors = [(a, e.name) for e in STATE for a in e.anchors]
    anchors += [(a, "control-class") for a in CONTROL_CLASSES]
    for anchor, owner in anchors:
        rel, _, qual = anchor.partition("::")
        t = tree_for(rel)
        if t is None:
            problems.append(f"{owner}: anchor file missing: {rel}")
        elif not cachereg._resolve_anchor(t, qual) and not _class_exists(
            t, qual
        ):
            problems.append(
                f"{owner}: anchor does not resolve: {anchor} "
                "(renamed attribute? update analysis/durreg.py)"
            )
    # the persistence layer itself: every persisted entry's save/load
    # pair must be real methods of PersistentSchedulerState
    ps = tree_for("ballista_tpu_torch/scheduler/persistent_state.py")
    for e in STATE:
        if e.durability not in DURABILITY:
            problems.append(f"{e.name}: unknown durability {e.durability!r}")
        if e.durability == "persisted":
            if not (e.save and e.load):
                problems.append(
                    f"{e.name}: persisted entries must name their "
                    "save/load pair"
                )
            else:
                for fn in (e.save, e.load):
                    if ps is not None and not cachereg._resolve_anchor(
                        ps, f"PersistentSchedulerState.{fn}"
                    ):
                        problems.append(
                            f"{e.name}: PersistentSchedulerState.{fn} "
                            "does not exist (renamed? update "
                            "analysis/durreg.py)"
                        )
        elif e.durability == "rebuilt":
            if not e.recovery:
                problems.append(
                    f"{e.name}: rebuilt entries must name their recovery "
                    "source"
                )
        elif e.durability == "ephemeral":
            if not (e.cache_link or e.recovery):
                problems.append(
                    f"{e.name}: ephemeral entries must cross-link a "
                    "cachereg entry or carry a written justification"
                )
        for c in e.cache_link:
            try:
                cachereg.entry(c)
            except KeyError:
                problems.append(
                    f"{e.name}: cache_link {c!r} is not a declared "
                    "cachereg entry"
                )
    for c in CONTRACTS:
        for name in c.fields:
            try:
                entry(name)
            except KeyError:
                problems.append(
                    f"contract {c.source}: unknown state entry {name!r}"
                )
    for mode in CONTROL_CLASSES.values():
        if mode not in ("init-containers", "dataclass-fields"):
            problems.append(f"unknown control-class mode {mode!r}")
    return problems


def _class_exists(tree: ast.Module, qual: str) -> bool:
    """CONTROL_CLASSES anchors name a bare class."""
    return "." not in qual and any(
        isinstance(n, ast.ClassDef) and n.name == qual for n in tree.body
    )


def render_inventory() -> str:
    """The durability inventory as a markdown table — embedded verbatim
    in docs/analysis.md and checked by the gate (docs_in_sync), the same
    generated-docs discipline as the cachereg inventory."""
    lines = [
        "| state | durability | persistence | recovery story |",
        "|---|---|---|---|",
    ]
    for e in STATE:
        if e.durability == "persisted":
            persist = f"`{e.save}` / `{e.load}`"
        elif e.cache_link:
            persist = "cachereg: " + ", ".join(
                f"`{c}`" for c in e.cache_link
            )
        else:
            persist = "—"
        story = e.recovery or "round-trips through the state backend"
        lines.append(
            f"| `{e.name}` | {e.durability} | {persist} | {story} |"
        )
    return "\n".join(lines)


def docs_path() -> pathlib.Path:
    """The port's analysis page, inside the package (the repo's
    ``docs/analysis.md`` is the reference's)."""
    return _package_root() / "ballista_tpu_torch" / "docs" / "analysis.md"


def docs_in_sync() -> str | None:
    """None when docs/analysis.md embeds the generated inventory table
    verbatim, else the failure message."""
    try:
        text = docs_path().read_text()
    except OSError as e:
        return f"ballista_tpu_torch/docs/analysis.md unreadable: {e}"
    if render_inventory() not in text:
        return (
            "ballista_tpu_torch/docs/analysis.md durability inventory is out of sync with "
            "analysis/durreg.py (paste render_inventory() output)"
        )
    return None
