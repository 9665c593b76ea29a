"""Durable query history and per-task-attempt resource cost accounting
(port of ``ballista_tpu/obs/history.py``).

:class:`CostVector` is the resource vector of one task attempt (wall
seconds, CPU thread-time seconds, shuffle bytes read and written, pushed
bytes, spill bytes, claimed compile seconds), measured by the executor
around every attempt and shipped home on ``CompletedTask.cost`` /
``FailedTask.cost`` (``ballista.tpu.cost_accounting``, on by default).

"Compile seconds" here are the nvcc build seconds that
``ops/cuda_build`` spent in this process: the port's counterpart of the
reference's XLA compile time, claimed exactly once across the attempts
that run after the executor was constructed.

:class:`HistoryStore` is the scheduler's append-only job-lifecycle log,
written through its state backend (``scheduler/state_backend``): one
``submitted`` and one terminal record per job plus per-attempt cost
records, bounded to ``retention_jobs`` jobs. The Arrow builders of the
``system.queries`` / ``system.task_attempts`` / ``system.executors``
tables are here too: ``TorchContext`` serves them from its local query
log, and ``BallistaContext`` from the scheduler's log, whose rows the
``GetHistory`` RPC returns as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.datatypes import DataType, Field, Schema

log = logging.getLogger(__name__)

# the closed cost-vector key set — every surface (proto, JSON records,
# Prometheus rollup, system-table columns, bench fields) uses exactly
# these names, so a new resource dimension is a one-list change
COST_KEYS = (
    "wall_seconds",
    "cpu_seconds",
    "shuffle_read_bytes",
    "shuffle_write_bytes",
    "pushed_bytes",
    "spill_bytes",
    "compile_seconds",
)

_BYTE_KEYS = (
    "shuffle_read_bytes", "shuffle_write_bytes", "pushed_bytes",
    "spill_bytes",
)


@dataclasses.dataclass
class CostVector:
    """One attempt's (or one job's aggregated) resource cost."""

    wall_seconds: float = 0.0
    cpu_seconds: float = 0.0
    shuffle_read_bytes: int = 0
    shuffle_write_bytes: int = 0
    pushed_bytes: int = 0
    spill_bytes: int = 0
    compile_seconds: float = 0.0

    def add(self, other: "CostVector") -> None:
        for k in COST_KEYS:
            setattr(self, k, getattr(self, k) + getattr(other, k))

    def to_dict(self) -> dict:
        return {
            k: (round(v, 6) if isinstance(v, float) else int(v))
            for k, v in ((k, getattr(self, k)) for k in COST_KEYS)
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "CostVector":
        c = cls()
        for k in COST_KEYS:
            v = (d or {}).get(k, 0)
            setattr(c, k, int(v) if k in _BYTE_KEYS else float(v))
        return c

    def is_zero(self) -> bool:
        return all(not getattr(self, k) for k in COST_KEYS)


def cost_to_proto(cost: CostVector | None):
    """CostVectorP for the wire, or None when there is nothing to ship
    (the caller skips the field — absent IS the accounting-off path)."""
    if cost is None or cost.is_zero():
        return None
    from ballista_tpu_torch.proto import pb

    return pb.CostVectorP(
        wall_seconds=cost.wall_seconds,
        cpu_seconds=cost.cpu_seconds,
        shuffle_read_bytes=int(cost.shuffle_read_bytes),
        shuffle_write_bytes=int(cost.shuffle_write_bytes),
        pushed_bytes=int(cost.pushed_bytes),
        spill_bytes=int(cost.spill_bytes),
        compile_seconds=cost.compile_seconds,
    )


def cost_from_proto(msg) -> CostVector:
    return CostVector(
        wall_seconds=float(msg.wall_seconds),
        cpu_seconds=float(msg.cpu_seconds),
        shuffle_read_bytes=int(msg.shuffle_read_bytes),
        shuffle_write_bytes=int(msg.shuffle_write_bytes),
        pushed_bytes=int(msg.pushed_bytes),
        spill_bytes=int(msg.spill_bytes),
        compile_seconds=float(msg.compile_seconds),
    )


# ---------------------------------------------------------------------------
# measurement helpers (executor / local context side)
# ---------------------------------------------------------------------------

# plan metric counters folded into the cost vector: fetched_bytes is the
# shuffle-read side (executor/reader.py), spill_bytes covers grace-hash
# passes (exec/spill.py) AND the push window's forced spills
# (executor/push.py meters push_spill_bytes separately), pushed_bytes the
# in-memory push commits (docs/shuffle.md)
_READ_COUNTERS = ("fetched_bytes",)
_SPILL_COUNTERS = ("spill_bytes", "push_spill_bytes")
_PUSH_COUNTERS = ("pushed_bytes",)

# exactly-once claim ledger for the process-wide nvcc build-seconds
# counter (ops/cuda_build.build_seconds): each attempt claims the UNCLAIMED
# compile time at its completion, so concurrent attempts split the
# process total approximately but the sum across attempts never exceeds
# it (no double charging). The baseline latches at init_compile_claim()
# (executor construction) so builds before it are never charged to the
# first task.
_claim_lock = make_lock("obs.history._claim_lock")
_claimed_compile_s: float | None = None


def _compile_seconds_now() -> float:
    from ballista_tpu_torch.ops import cuda_build

    return cuda_build.build_seconds()


def init_compile_claim() -> None:
    """Latch the claim baseline (idempotent). Called at Executor
    construction so build time before the first task is excluded from
    task attribution."""
    global _claimed_compile_s
    with _claim_lock:
        if _claimed_compile_s is None:
            _claimed_compile_s = _compile_seconds_now()


def claim_compile_seconds() -> float:
    """The process compile seconds accrued since the last claim (0 before
    :func:`init_compile_claim`). Exactly-once: two concurrent claimants
    split the delta, never double it."""
    global _claimed_compile_s
    now = _compile_seconds_now()
    with _claim_lock:
        if _claimed_compile_s is None:
            return 0.0
        delta = now - _claimed_compile_s
        _claimed_compile_s = now
    return max(0.0, delta)


def started_at(wall_s: float) -> float:
    """The wall-clock second at which a run of ``wall_s`` seconds that
    ends now began: the ``submitted_s`` of a query log record. Wall-clock
    reads stay in this plane, out of the operators (detlint's
    ``wallclock-in-dataplane``)."""
    return time.time() - wall_s


def cost_from_run(
    wall_seconds: float,
    cpu_seconds: float,
    plan=None,
    partitions=None,
    compile_seconds: float | None = None,
) -> CostVector:
    """Assemble one attempt's cost vector from its measured wall/CPU
    time, the executed plan's data-plane counters, and the committed
    shuffle partition metas (write side). ``compile_seconds=None`` takes
    the exactly-once process claim (the executor path); callers that
    measured their own delta (the local context, which must not steal
    claims from in-proc executors) pass it explicitly."""
    c = CostVector(
        wall_seconds=max(0.0, wall_seconds),
        cpu_seconds=max(0.0, cpu_seconds),
        compile_seconds=(
            claim_compile_seconds() if compile_seconds is None
            else max(0.0, compile_seconds)
        ),
    )
    if plan is not None:
        from ballista_tpu_torch.exec.base import plan_counters

        counters = plan_counters(
            plan, _READ_COUNTERS + _SPILL_COUNTERS + _PUSH_COUNTERS
        )
        c.shuffle_read_bytes = sum(counters[k] for k in _READ_COUNTERS)
        c.spill_bytes = sum(counters[k] for k in _SPILL_COUNTERS)
        c.pushed_bytes = sum(counters[k] for k in _PUSH_COUNTERS)
    for m in partitions or ():
        c.shuffle_write_bytes += max(0, int(m.num_bytes))
    return c


# ---------------------------------------------------------------------------
# the persistent history store
# ---------------------------------------------------------------------------


class HistoryStore:
    """Append-only job-lifecycle log over a
    :class:`~ballista_tpu_torch.scheduler.state_backend.StateBackendClient`.

    Key scheme (time-sortable, so prefix scans return jobs oldest-first
    and retention can drop from the front):

    - ``/ballista/<ns>/history/jobs/<stamp>/submitted``
    - ``/ballista/<ns>/history/jobs/<stamp>/completed`` (or ``failed``)
    - ``/ballista/<ns>/history/attempts/<stamp>/<stage>/<part>/<seq>``

    where ``stamp = <submit-ms, zero-padded>-<job_id>``. A restarted
    scheduler over the same backend rebuilds its job->stamp map from one
    prefix scan and keeps appending; the records themselves never need
    recovery — that is the whole point.
    """

    def __init__(self, backend, namespace: str = "default",
                 retention_jobs: int = 512) -> None:
        self.backend = backend
        self.namespace = namespace
        self.retention_jobs = max(1, int(retention_jobs))
        self._lock = make_lock("HistoryStore._lock")
        # job_id -> stamp for jobs this store has seen (rebuilt from the
        # backend on construction, so a restarted scheduler can still
        # terminal-record jobs submitted by its predecessor)
        self._stamps: dict[str, str] = {}
        # (job_id, stage_id, partition) -> next attempt record seq
        self._attempt_seq: dict[tuple, int] = {}
        for key, _v in self.backend.get_from_prefix(self._k("jobs")):
            stamp = key[len(self._k("jobs")) + 1:].split("/", 1)[0]
            job_id = stamp.split("-", 1)[1] if "-" in stamp else stamp
            with self._lock:
                self._stamps.setdefault(job_id, stamp)

    # -- keys ---------------------------------------------------------------
    def _k(self, *parts: str) -> str:
        return "/".join(
            ("/ballista", self.namespace, "history") + parts
        )

    @staticmethod
    def _stamp(job_id: str, submitted_s: float) -> str:
        return f"{int(submitted_s * 1000):015d}-{job_id}"

    def _stamp_of(self, job_id: str) -> str | None:
        with self._lock:
            return self._stamps.get(job_id)

    # -- writes -------------------------------------------------------------
    def record_submit(self, job_id: str, *, query_class: str = "unknown",
                      session_id: str = "", submitted_s: float = 0.0) -> None:
        submitted_s = submitted_s or time.time()
        stamp = self._stamp(job_id, submitted_s)
        with self._lock:
            self._stamps[job_id] = stamp
        rec = {
            "job_id": job_id,
            "status": "submitted",
            "query_class": query_class,
            "session_id": session_id,
            "submitted_s": round(submitted_s, 6),
        }
        self.backend.put(
            self._k("jobs", stamp, "submitted"), json.dumps(rec).encode()
        )
        self._enforce_retention()

    def record_terminal(
        self,
        job_id: str,
        status: str,  # "completed" | "failed"
        *,
        query_class: str = "unknown",
        session_id: str = "",
        submitted_s: float = 0.0,
        latency_s: float = 0.0,
        queue_wait_s: float = 0.0,
        retries: int = 0,
        recomputes: int = 0,
        stragglers: int = 0,
        skew_partitions: int = 0,
        aqe_applied: int = 0,
        aqe_rejected: int = 0,
        error: str = "",
        cost: CostVector | None = None,
    ) -> None:
        stamp = self._stamp_of(job_id)
        if stamp is None:
            # terminal record for a job this store never saw submitted
            # (direct embedder use); mint a stamp so it still lands
            stamp = self._stamp(job_id, submitted_s or time.time())
            with self._lock:
                self._stamps[job_id] = stamp
        rec = {
            "job_id": job_id,
            "status": status,
            "query_class": query_class,
            "session_id": session_id,
            "submitted_s": round(submitted_s, 6),
            "latency_s": round(max(0.0, latency_s), 6),
            "queue_wait_s": round(max(0.0, queue_wait_s), 6),
            "retries": int(retries),
            "recomputes": int(recomputes),
            "stragglers": int(stragglers),
            "skew_partitions": int(skew_partitions),
            # AQE decision tally (docs/aqe.md): how many certified
            # rewrites the policy applied/was denied on this job — the
            # durable adaptation record beside latency and cost
            "aqe_applied": int(aqe_applied),
            "aqe_rejected": int(aqe_rejected),
            "error": error[:1024],
            "cost": (cost or CostVector()).to_dict(),
        }
        # default-valued identity fields are DROPPED so the jobs() merge
        # keeps the submit record's values (a restarted scheduler writes
        # terminal records without knowing the original query class)
        if rec["query_class"] == "unknown":
            del rec["query_class"]
        if not rec["session_id"]:
            del rec["session_id"]
        if not rec["submitted_s"]:
            del rec["submitted_s"]
        self.backend.put(
            self._k("jobs", stamp, status), json.dumps(rec).encode()
        )

    def record_attempt(
        self,
        job_id: str,
        stage_id: int,
        partition: int,
        state: str,  # "completed" | "failed"
        executor_id: str,
        cost: CostVector,
    ) -> None:
        stamp = self._stamp_of(job_id)
        if stamp is None:
            return  # job already evicted (or never submitted here)
        key = (job_id, stage_id, partition)
        with self._lock:
            seq = self._attempt_seq.get(key, 0)
            self._attempt_seq[key] = seq + 1
        rec = {
            "job_id": job_id,
            "stage_id": int(stage_id),
            "partition": int(partition),
            "attempt": seq,
            "state": state,
            "executor_id": executor_id,
            "cost": cost.to_dict(),
        }
        self.backend.put(
            self._k("attempts", stamp, f"{stage_id:04d}",
                    f"{partition:05d}", f"{seq:03d}"),
            json.dumps(rec).encode(),
        )

    # -- retention ----------------------------------------------------------
    def _enforce_retention(self) -> None:
        """Drop the oldest jobs' history (job + attempt records) beyond
        ``retention_jobs``. Stamps sort by submit time, so sorted stamp
        order IS eviction order. Works off the in-memory job->stamp map
        (maintained on submit/evict, rebuilt from one scan at init) —
        re-scanning the backend on every submission would put
        O(retained-jobs) I/O on the submit path for nothing."""
        with self._lock:
            stamps = sorted(self._stamps.values())
        excess = len(stamps) - self.retention_jobs
        if excess <= 0:
            return
        for stamp in stamps[:excess]:
            # trailing "/" so a stamp that is a string prefix of another
            # stamp (same-millisecond submits with embedder-supplied ids
            # like "job-1" / "job-10") can never match the other job's
            # records
            for key, _v in self.backend.get_from_prefix(
                self._k("jobs", stamp) + "/"
            ):
                self.backend.delete(key)
            for key, _v in self.backend.get_from_prefix(
                self._k("attempts", stamp) + "/"
            ):
                self.backend.delete(key)
            job_id = stamp.split("-", 1)[1] if "-" in stamp else stamp
            with self._lock:
                self._stamps.pop(job_id, None)

    def job_count(self) -> int:
        """Jobs currently retained — the metrics-plane gauge source
        (no backend scan, no record decoding)."""
        with self._lock:
            return len(self._stamps)

    # -- reads --------------------------------------------------------------
    def jobs(self, limit: int = 0) -> list[dict]:
        """One merged row per job (submit overlaid by the terminal
        record), NEWEST first. ``limit`` bounds the result; 0 = all
        retained."""
        prefix = self._k("jobs")
        by_stamp: dict[str, dict] = {}
        for key, v in self.backend.get_from_prefix(prefix):
            stamp = key[len(prefix) + 1:].split("/", 1)[0]
            try:
                rec = json.loads(v)
            except ValueError:
                log.warning("undecodable history record at %s", key)
                continue
            merged = by_stamp.setdefault(stamp, {})
            # terminal records overlay the submit stub; both carry
            # status, and terminal ones arrive later in key order only
            # by name — overlay explicitly by record completeness
            if rec.get("status") in ("completed", "failed") or not merged:
                base = dict(merged)
                base.update(rec)
                by_stamp[stamp] = base
            else:
                for k, val in rec.items():
                    merged.setdefault(k, val)
        rows = [by_stamp[s] for s in sorted(by_stamp, reverse=True)]
        return rows[:limit] if limit else rows

    def attempts(self, limit: int = 0, job_id: str | None = None) -> list[dict]:
        """Per-attempt cost records, newest job first. ``job_id`` narrows
        to one job."""
        if job_id is not None:
            stamp = self._stamp_of(job_id)
            if stamp is None:
                return []
            stamps = [stamp]
        else:
            prefix = self._k("attempts")
            stamps = []
            for key, _v in self.backend.get_from_prefix(prefix):
                stamp = key[len(prefix) + 1:].split("/", 1)[0]
                if not stamps or stamps[-1] != stamp:
                    stamps.append(stamp)
            stamps.reverse()
        rows: list[dict] = []
        for stamp in stamps:
            for _key, v in self.backend.get_from_prefix(
                self._k("attempts", stamp) + "/"
            ):
                try:
                    rows.append(json.loads(v))
                except ValueError:
                    continue
            if limit and len(rows) >= limit:
                return rows[:limit]
        return rows

    def complete_record_count(self, job_id: str) -> int:
        """How many terminal 'completed' records exist for one job —
        the chaos suite's exactly-once assertion."""
        stamp = self._stamp_of(job_id)
        if stamp is None:
            return 0
        return sum(
            1
            for key, _v in self.backend.get_from_prefix(
                self._k("jobs", stamp) + "/"
            )
            if key.endswith("/completed")
        )


# ---------------------------------------------------------------------------
# system.* table schemas + Arrow builders
# ---------------------------------------------------------------------------

_COST_FIELDS = [
    Field("wall_seconds", DataType.FLOAT64),
    Field("cpu_seconds", DataType.FLOAT64),
    Field("shuffle_read_bytes", DataType.INT64),
    Field("shuffle_write_bytes", DataType.INT64),
    # derived convenience column: read + write, so "what did shuffle
    # cost" is one sum() away
    Field("shuffle_bytes", DataType.INT64),
    Field("pushed_bytes", DataType.INT64),
    Field("spill_bytes", DataType.INT64),
    Field("compile_seconds", DataType.FLOAT64),
]

QUERIES_SCHEMA = Schema(
    [
        Field("job_id", DataType.STRING),
        Field("status", DataType.STRING),
        Field("query_class", DataType.STRING),
        Field("session_id", DataType.STRING),
        Field("submitted_s", DataType.FLOAT64),
        Field("latency_s", DataType.FLOAT64),
        Field("queue_wait_s", DataType.FLOAT64),
        Field("retries", DataType.INT64),
        Field("recomputes", DataType.INT64),
        Field("stragglers", DataType.INT64),
        Field("skew_partitions", DataType.INT64),
        # AQE adaptation tally (docs/aqe.md) — queryable like the other
        # per-job counters: SELECT sum(aqe_applied) FROM system.queries
        Field("aqe_applied", DataType.INT64),
        Field("aqe_rejected", DataType.INT64),
        Field("error", DataType.STRING),
    ]
    + _COST_FIELDS
)

TASK_ATTEMPTS_SCHEMA = Schema(
    [
        Field("job_id", DataType.STRING),
        Field("stage_id", DataType.INT64),
        Field("partition", DataType.INT64),
        Field("attempt", DataType.INT64),
        Field("state", DataType.STRING),
        Field("executor_id", DataType.STRING),
    ]
    + _COST_FIELDS
)

EXECUTORS_SCHEMA = Schema(
    [
        Field("id", DataType.STRING),
        Field("host", DataType.STRING),
        Field("port", DataType.INT64),
        Field("grpc_port", DataType.INT64),
        Field("task_slots", DataType.INT64),
        Field("n_devices", DataType.INT64),
        Field("alive", DataType.BOOL),
        Field("last_heartbeat_age_s", DataType.FLOAT64),
    ]
)

SYSTEM_TABLE_SCHEMAS = {
    "system.queries": QUERIES_SCHEMA,
    "system.task_attempts": TASK_ATTEMPTS_SCHEMA,
    "system.executors": EXECUTORS_SCHEMA,
}

# GetHistory `kind` token per table name
SYSTEM_TABLE_KINDS = {
    "system.queries": "queries",
    "system.task_attempts": "task_attempts",
    "system.executors": "executors",
}


def _arrow_type(dtype: DataType):
    import pyarrow as pa

    return {
        DataType.STRING: pa.string(),
        DataType.INT64: pa.int64(),
        DataType.FLOAT64: pa.float64(),
        DataType.BOOL: pa.bool_(),
    }[dtype]


def _rows_to_arrow(schema: Schema, rows: list[dict]):
    """Arrow table in the declared column order; missing keys fill with
    type-appropriate zeros (a submit-only record has no cost yet)."""
    import pyarrow as pa

    zeros = {
        DataType.STRING: "",
        DataType.INT64: 0,
        DataType.FLOAT64: 0.0,
        DataType.BOOL: False,
    }
    cols = {}
    for f in schema:
        t = _arrow_type(f.dtype)
        cols[f.name] = pa.array(
            [r.get(f.name, zeros[f.dtype]) for r in rows], type=t
        )
    return pa.table(cols)


def _flatten_cost(rec: dict) -> dict:
    """Lift the nested cost dict into the flat column namespace (plus
    the derived shuffle_bytes = read + write convenience column)."""
    out = dict(rec)
    cost = rec.get("cost") or {}
    for k, v in cost.items():
        out.setdefault(k, v)
    out.setdefault(
        "shuffle_bytes",
        int(cost.get("shuffle_read_bytes", 0))
        + int(cost.get("shuffle_write_bytes", 0)),
    )
    return out


def queries_table(records: list[dict]):
    return _rows_to_arrow(
        QUERIES_SCHEMA, [_flatten_cost(r) for r in records]
    )


def task_attempts_table(records: list[dict]):
    return _rows_to_arrow(
        TASK_ATTEMPTS_SCHEMA, [_flatten_cost(r) for r in records]
    )


def executors_table(records: list[dict]):
    return _rows_to_arrow(EXECUTORS_SCHEMA, records)


def system_table(name: str, records: list[dict]):
    if name == "system.queries":
        return queries_table(records)
    if name == "system.task_attempts":
        return task_attempts_table(records)
    if name == "system.executors":
        return executors_table(records)
    raise KeyError(f"unknown system table {name!r}")
