"""Error model.

Mirrors the reference's ``BallistaError`` enum (reference:
ballista/rust/core/src/error.rs:33-185) as a Python exception hierarchy.
"""

from __future__ import annotations

import re


class BallistaError(Exception):
    """Base error for the framework (ref error.rs:33)."""


class NotImplementedError_(BallistaError):
    """Feature not implemented (ref error.rs NotImplemented variant)."""


class InternalError(BallistaError):
    """Invariant violation — a bug in the engine (ref error.rs Internal)."""


class PlanError(BallistaError):
    """Logical/physical planning failure (ref error.rs DataFusionError)."""


class SqlError(BallistaError):
    """SQL parse/analysis failure (ref error.rs SqlError)."""


class PlanVerificationError(PlanError):
    """Static plan verification failure (ballista_tpu/analysis/verifier.py).

    Raised BEFORE any stage is scheduled, so schema mismatches, unresolved
    columns, illegal TPU dtypes, and shuffle partition-count disagreements
    become submission-time errors instead of executor-runtime ones.
    ``path`` names the operator chain root -> offending node; ``span`` is a
    1-based (line, column) into the source SQL when the offending token
    could be located there."""

    def __init__(
        self,
        message: str,
        path: tuple = (),
        span: "tuple[int, int] | None" = None,
    ):
        self.reason = message
        self.path = tuple(path)
        self.span = span
        parts = [message]
        if self.path:
            parts.append("at " + " > ".join(self.path))
        if span is not None:
            parts.append(f"(SQL line {span[0]}, column {span[1]})")
        super().__init__("; ".join(parts))


class RewriteRejected(PlanError):
    """A certified plan rewrite failed certificate validation and was NOT
    applied (ballista_tpu/rewrite.py, docs/analysis.md). Carries the
    failing certificate ``clause`` name plus the stage ids the rejected
    rewrite would have touched, so callers (the scheduler's rewrite
    acceptance gate, AQE policies) can log and fall back to the pristine
    stage template with a machine-readable reason. Deterministic:
    re-validating the same rewrite re-derives the same rejection."""

    def __init__(
        self,
        message: str,
        clause: str = "",
        stage_ids: tuple = (),
    ):
        self.clause = clause
        self.stage_ids = tuple(stage_ids)
        tag = f"[rewrite-rejected clause={clause or 'unknown'}]"
        super().__init__(f"{tag} {message}")


class SchemaError(BallistaError):
    """Schema mismatch or unknown column."""


class IoError(BallistaError):
    """Filesystem / IPC failure (ref error.rs IoError)."""


class GrpcError(BallistaError):
    """Control-plane RPC failure (ref error.rs TonicError/GrpcError)."""


class ConfigError(BallistaError):
    """Invalid configuration (ref config.rs validation errors)."""


class ExecutionError(BallistaError):
    """Runtime failure while executing a physical plan."""


class CapacityError(ExecutionError):
    """A static device capacity (aggregate groups, join buckets) was
    exceeded. ``required`` carries the exact size needed when known (the
    aggregate kernel computes the true group count even on overflow), so
    callers can retry with an adequately-grown capacity instead of failing
    (adaptive sizing; the fixed-capacity failure mode is a TPU-only concern
    with no reference counterpart). ``sites`` maps the key of each other
    overflowed capacity (a join's expansion) to the rows it needed; the
    retry grows those alone and leaves the aggregates' capacity as it
    was."""

    def __init__(self, message: str, required: int = 0, sites: dict | None = None):
        super().__init__(message)
        self.required = int(required)
        self.sites = dict(sites or {})


class ShuffleFetchError(ExecutionError):
    """A shuffle partition could not be fetched from the executor that
    produced it (dead executor, deleted/corrupt file, unreachable Flight
    endpoint after bounded retries).

    Carries the SOURCE of the lost data — (job, map stage, map output
    partition, producing executor) — so the scheduler can invalidate
    exactly that executor's completed shuffle outputs and re-run the lost
    map partitions (Spark-style lineage recovery) instead of failing the
    job. ``transient=False`` marks data corruption: redialing cannot help,
    but recomputing the upstream stage can, so both flavors escalate to
    scheduler-level recompute — the flag only controls whether fetch-level
    retries were worth attempting first.

    The executor reports task failures as strings; ``__str__`` embeds a
    machine-parseable source tag that :func:`parse_shuffle_fetch_error`
    recovers scheduler-side (no proto change needed)."""

    def __init__(
        self,
        message: str,
        *,
        job_id: str = "",
        stage_id: int = -1,
        partition: int = -1,
        executor_id: str = "",
        transient: bool = True,
    ):
        self.reason = message
        self.job_id = job_id
        self.stage_id = int(stage_id)
        self.partition = int(partition)
        self.executor_id = executor_id
        self.transient = transient
        tag = (
            f"[shuffle-fetch job={job_id} stage={self.stage_id} "
            f"partition={self.partition} executor={executor_id}]"
        )
        super().__init__(f"{tag} {message}")


_SHUFFLE_FETCH_TAG = re.compile(
    r"\[shuffle-fetch job=(?P<job>\S*) stage=(?P<stage>-?\d+) "
    r"partition=(?P<part>-?\d+) executor=(?P<exec>[^\]]*)\]"
)


def parse_shuffle_fetch_error(error: str):
    """Recover the (job_id, stage_id, partition, executor_id) source tag a
    :class:`ShuffleFetchError` embeds in its message, or None when the
    error string is not a shuffle-fetch failure. Used by the scheduler to
    route a downstream task failure into lost-shuffle recovery."""
    m = _SHUFFLE_FETCH_TAG.search(error or "")
    if m is None:
        return None
    return (
        m.group("job"),
        int(m.group("stage")),
        int(m.group("part")),
        m.group("exec"),
    )


# Deterministic failures: re-running the identical task re-derives the
# identical error, so the scheduler short-circuits straight to JobFailed
# with zero retries. Keyed by exception TYPE NAME because task errors
# cross the wire as "TypeName: message" strings (executor.as_task_status).
NON_RETRYABLE_ERROR_TYPES = frozenset(
    {
        "PlanVerificationError",
        "PlanError",
        "RewriteRejected",
        "SqlError",
        "SchemaError",
        "ConfigError",
        "InternalError",
        "NotImplementedError_",
        "NotImplementedError",
        "TypeError",
        "AttributeError",
        "ValueError",
        "KeyError",
        "AssertionError",
    }
)

# Errors where another attempt (possibly on another executor, possibly
# after lost-shuffle recompute) can genuinely succeed. This list exists
# for the lifelint error-taxonomy closure (analysis/lifelint.py): every
# exception type RAISED in the task-boundary surfaces must appear in
# exactly one of the two lists, so "retryable" is always a decision and
# never a fall-through. ``error_is_retryable`` still defaults UNKNOWN
# wire strings (third-party types surfacing through a catch-all) to
# retryable — a wasted bounded retry is cheaper than failing a
# recoverable job — but nothing this codebase raises may rely on that
# default.
RETRYABLE_ERROR_TYPES = frozenset(
    {
        # framework errors where the environment, not the plan, failed
        "BallistaError",
        "ExecutionError",
        "CapacityError",
        "ShuffleFetchError",
        "SpeculationMiss",
        "GrpcError",
        "IoError",
        # transport-layer types the data plane raises/absorbs (pyarrow
        # Flight + grpc); surviving ones classify like any wire string
        "FlightError",
        "FlightUnavailableError",
        "FlightTimedOutError",
        "FlightCancelledError",
        "FlightServerError",
        "FlightInternalError",
        "RpcError",
        # deterministic chaos faults (testing/faults.py): injected
        # crashes/fetch errors simulate retryable infrastructure failure
        "InjectedFault",
        "InjectedFetchError",
    }
)

_OVERLAP = NON_RETRYABLE_ERROR_TYPES & RETRYABLE_ERROR_TYPES
assert not _OVERLAP, f"error taxonomy lists overlap: {sorted(_OVERLAP)}"


def error_is_retryable(error: str) -> bool:
    """Classify a wire-format task error ("TypeName: message..."): False
    for the deterministic taxonomy above, True otherwise (unknown errors
    default to retryable — a wasted bounded retry is cheaper than failing
    a recoverable job; the lifelint closure keeps first-party raises out
    of that default)."""
    head = (error or "").lstrip()
    type_name = head.split(":", 1)[0].strip()
    return type_name not in NON_RETRYABLE_ERROR_TYPES


class SpeculationMiss(ExecutionError):
    """A cached plan-shape speculation (join build strategy, expansion
    output capacity) was contradicted by this run's data. The run's output
    must be discarded; the retry loop drops ``invalid_keys`` from the plan
    cache and re-runs on the non-speculative path. TPU-only concern: the
    speculation exists to avoid blocking host round-trips."""

    def __init__(self, message: str, invalid_keys: list | None = None):
        super().__init__(message)
        self.invalid_keys = list(invalid_keys or [])
