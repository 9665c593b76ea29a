"""Session configuration: every key of the reference's ``BallistaConfig``
(``ballista_tpu/config.py``), with its name, default and parse rule.

An unknown key or an unparsable value raises :class:`ConfigError`, the same
contract as the reference's. A job ships its session keys to every
executor, so the port knows all of them, also those whose feature it does
not have yet. Such a key keeps its default behaviour, and a non-default
value raises at the point of use (``check_ported``), naming the ROADMAP
item that ports the feature; it is never silently ignored. The scheduler
(``scheduler/``) reads the task-retry, straggler, skew, AQE,
result-cache, grant-batch, history and verification keys; the executor reads the
fetch, shuffle, trace, metrics and cost keys (``executor/``).
"""

from __future__ import annotations

import dataclasses
from enum import Enum

from ballista_tpu_torch.columnar.batch import CapacityLadder
from ballista_tpu_torch.errors import ConfigError

BALLISTA_JOB_NAME = "ballista.job.name"
BALLISTA_DEFAULT_SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
BALLISTA_DEFAULT_BATCH_SIZE = "ballista.batch.size"
BALLISTA_REPARTITION_JOINS = "ballista.repartition.joins"
BALLISTA_REPARTITION_AGGREGATIONS = "ballista.repartition.aggregations"
BALLISTA_REPARTITION_WINDOWS = "ballista.repartition.windows"
BALLISTA_PARQUET_PRUNING = "ballista.parquet.pruning"
BALLISTA_WITH_INFORMATION_SCHEMA = "ballista.with_information_schema"
BALLISTA_PLUGIN_DIR = "ballista.plugin_dir"
BALLISTA_DEVICE = "ballista.tpu.device"
BALLISTA_AGG_CAPACITY = "ballista.tpu.agg_capacity"
BALLISTA_TPU_BATCH_ROWS = "ballista.tpu.batch_rows"
BALLISTA_PROFILE_DIR = "ballista.tpu.profile_dir"
BALLISTA_JOIN_EXPANSION = "ballista.tpu.join_expansion"
BALLISTA_BUILD_CACHE_MB = "ballista.tpu.build_cache_mb"
BALLISTA_COLLECTIVE_SHUFFLE = "ballista.tpu.collective_shuffle"
BALLISTA_SCAN_STREAM_MB = "ballista.tpu.scan_stream_mb"
BALLISTA_HBM_BUDGET_MB = "ballista.tpu.hbm_budget_mb"  # grace-hash trigger
BALLISTA_SPILL_BUDGET_MB = "ballista.tpu.spill_budget_mb"  # host spill ceiling
BALLISTA_SPILL_DIR = "ballista.tpu.spill_dir"  # grace-hash spill location
BALLISTA_PREFETCH_DEPTH = "ballista.tpu.prefetch_depth"
BALLISTA_VERIFY_PLANS = "ballista.tpu.verify_plans"
BALLISTA_TASK_MAX_ATTEMPTS = "ballista.tpu.task_max_attempts"
BALLISTA_FETCH_RETRIES = "ballista.tpu.fetch_retries"
BALLISTA_FETCH_BACKOFF_MS = "ballista.tpu.fetch_backoff_ms"
BALLISTA_FETCH_TIMEOUT_S = "ballista.tpu.fetch_timeout_s"
BALLISTA_SHUFFLE_FETCH_CONCURRENCY = "ballista.tpu.shuffle_fetch_concurrency"
BALLISTA_SHUFFLE_COMPRESSION = "ballista.tpu.shuffle_compression"  # none|lz4|zstd|auto
BALLISTA_SHUFFLE_LOCAL_FASTPATH = "ballista.tpu.shuffle_local_fastpath"
BALLISTA_EAGER_SHUFFLE = "ballista.tpu.eager_shuffle"
BALLISTA_PUSH_SHUFFLE = "ballista.tpu.push_shuffle"
BALLISTA_PUSH_SHUFFLE_WINDOW_MB = "ballista.tpu.push_shuffle_window_mb"
BALLISTA_SHUFFLE_TARGET_BATCH_MB = "ballista.tpu.shuffle_target_batch_mb"
BALLISTA_EAGER_POLL_MS = "ballista.tpu.eager_poll_ms"
BALLISTA_EAGER_WAIT_S = "ballista.tpu.eager_wait_s"
BALLISTA_CAPACITY_BUCKETS = "ballista.tpu.capacity_buckets"
BALLISTA_PREWARM = "ballista.tpu.prewarm"  # off|on|background
BALLISTA_TRACE = "ballista.tpu.trace"  # off|on|<jsonl path>
BALLISTA_METRICS_COLLECTOR = "ballista.tpu.metrics_collector"  # shipping|logging
BALLISTA_STRAGGLER_FACTOR = "ballista.tpu.straggler_factor"
BALLISTA_STRAGGLER_MIN_S = "ballista.tpu.straggler_min_s"
BALLISTA_SKEW_RATIO = "ballista.tpu.skew_ratio"
BALLISTA_SKEW_MIN_ROWS = "ballista.tpu.skew_min_rows"
BALLISTA_SCALER_QUEUE_WAIT_TARGET_S = "ballista.tpu.scaler_queue_wait_target_s"
BALLISTA_AQE = "ballista.tpu.aqe"
BALLISTA_AQE_BROADCAST_THRESHOLD_MB = "ballista.tpu.aqe_broadcast_threshold_mb"
BALLISTA_AQE_TARGET_PARTITION_MB = "ballista.tpu.aqe_target_partition_mb"
BALLISTA_COST_ACCOUNTING = "ballista.tpu.cost_accounting"
BALLISTA_HISTORY_RETENTION_JOBS = "ballista.tpu.history_retention_jobs"
BALLISTA_RESULT_CACHE_MB = "ballista.tpu.result_cache_mb"
BALLISTA_SINGLE_STAGE_BYPASS = "ballista.tpu.single_stage_bypass"
BALLISTA_TASK_GRANT_BATCH = "ballista.tpu.task_grant_batch"

# Task-scoped keys the scheduler stamps onto a task's props for the
# executor (attempt number, trace context, query class). Not session
# config: executors strip this prefix before building a BallistaConfig.
BALLISTA_INTERNAL_PREFIX = "ballista.internal."
BALLISTA_INTERNAL_TASK_ATTEMPT = "ballista.internal.task_attempt"
BALLISTA_INTERNAL_TRACE_ID = "ballista.internal.trace_id"
BALLISTA_INTERNAL_SPAN_PARENT = "ballista.internal.span_parent"
BALLISTA_INTERNAL_QUERY_CLASS = "ballista.internal.query_class"

METRICS_COLLECTORS = ("shipping", "logging")
SHUFFLE_COMPRESSION_CODECS = ("none", "lz4", "zstd", "auto")
PREWARM_MODES = ("off", "on", "background")


def _parse_bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


def _parse_metrics_collector(s: str) -> str:
    v = s.lower()
    if v not in METRICS_COLLECTORS:
        raise ValueError(f"not a metrics collector (shipping|logging): {s!r}")
    return v


def _parse_trace(s: str) -> str:
    # "off" | "on" (any case) | a JSONL export path, taken as it is
    v = s.strip()
    if v.lower() in ("off", "on"):
        return v.lower()
    return v or "off"


def _parse_prewarm(s: str) -> str:
    v = s.lower()
    if v not in PREWARM_MODES:
        raise ValueError(f"not a prewarm mode (off|on|background): {s!r}")
    return v


def _parse_shuffle_compression(s: str) -> str:
    v = s.lower()
    if v not in SHUFFLE_COMPRESSION_CODECS:
        raise ValueError(f"not a shuffle codec (none|lz4|zstd|auto): {s!r}")
    return v


def _parse_capacity_buckets(s: str) -> str:
    CapacityLadder.parse(s)  # raises on malformed specs
    return s


# key -> (default, parser), the reference's closed set of valid settings
_ENTRIES: dict[str, tuple[str, object]] = {
    BALLISTA_JOB_NAME: ("", str),
    BALLISTA_DEFAULT_SHUFFLE_PARTITIONS: ("2", int),
    BALLISTA_DEFAULT_BATCH_SIZE: ("8192", int),
    # hash-exchange the inputs of joins and aggregations in a distributed
    # plan (PhysicalPlanner(distributed=True))
    BALLISTA_REPARTITION_JOINS: ("true", _parse_bool),
    BALLISTA_REPARTITION_AGGREGATIONS: ("true", _parse_bool),
    BALLISTA_REPARTITION_WINDOWS: ("true", _parse_bool),
    BALLISTA_PARQUET_PRUNING: ("true", _parse_bool),
    BALLISTA_WITH_INFORMATION_SCHEMA: ("false", _parse_bool),
    BALLISTA_PLUGIN_DIR: ("", str),
    BALLISTA_PROFILE_DIR: ("", str),
    BALLISTA_DEVICE: ("auto", str),
    BALLISTA_AGG_CAPACITY: (str(1 << 16), int),
    BALLISTA_BUILD_CACHE_MB: ("2048", int),
    BALLISTA_TPU_BATCH_ROWS: (str(1 << 21), int),
    # output rows per probe row that a join's m:n expansion allocates
    # before it overflows and the run is retried with more
    BALLISTA_JOIN_EXPANSION: ("4", int),
    BALLISTA_COLLECTIVE_SHUFFLE: ("true", _parse_bool),
    BALLISTA_SCAN_STREAM_MB: ("4096", int),
    # device bytes (MB) a join build side or a final aggregate's states may
    # hold before they go grace-hash through host Arrow IPC buckets; 0 = off
    BALLISTA_HBM_BUDGET_MB: ("0", int),
    # host bytes (MB) of spill files a task attempt may write; 0 = no limit
    BALLISTA_SPILL_BUDGET_MB: (str(1 << 16), int),
    # where spill files go; empty = the task's work_dir, else the temp dir
    BALLISTA_SPILL_DIR: ("", str),
    BALLISTA_PREFETCH_DEPTH: ("1", int),
    BALLISTA_VERIFY_PLANS: ("true", _parse_bool),
    BALLISTA_TASK_MAX_ATTEMPTS: ("3", int),
    BALLISTA_FETCH_RETRIES: ("3", int),
    BALLISTA_FETCH_BACKOFF_MS: ("50", int),
    BALLISTA_FETCH_TIMEOUT_S: ("300", float),
    # upstream shuffle files a reader fetches at once (<= 1: one by one)
    BALLISTA_SHUFFLE_FETCH_CONCURRENCY: ("4", int),
    # IPC codec of shuffle files; "auto" writes them uncompressed
    BALLISTA_SHUFFLE_COMPRESSION: ("auto", _parse_shuffle_compression),
    BALLISTA_SHUFFLE_LOCAL_FASTPATH: ("true", _parse_bool),
    BALLISTA_EAGER_SHUFFLE: ("true", _parse_bool),
    BALLISTA_PUSH_SHUFFLE: ("true", _parse_bool),
    BALLISTA_PUSH_SHUFFLE_WINDOW_MB: ("256", int),
    # shuffle writers concatenate slices up to this size before a write
    BALLISTA_SHUFFLE_TARGET_BATCH_MB: ("8", int),
    BALLISTA_EAGER_POLL_MS: ("10", int),
    BALLISTA_CAPACITY_BUCKETS: ("2048:2", _parse_capacity_buckets),
    BALLISTA_PREWARM: ("off", _parse_prewarm),
    BALLISTA_TRACE: ("off", _parse_trace),
    BALLISTA_METRICS_COLLECTOR: ("shipping", _parse_metrics_collector),
    BALLISTA_STRAGGLER_FACTOR: ("3", float),
    BALLISTA_STRAGGLER_MIN_S: ("1", float),
    BALLISTA_SKEW_RATIO: ("4", float),
    BALLISTA_SKEW_MIN_ROWS: ("4096", int),
    BALLISTA_SCALER_QUEUE_WAIT_TARGET_S: ("2", float),
    BALLISTA_AQE: ("false", _parse_bool),
    BALLISTA_AQE_BROADCAST_THRESHOLD_MB: ("32", int),
    BALLISTA_AQE_TARGET_PARTITION_MB: ("16", int),
    BALLISTA_COST_ACCOUNTING: ("true", _parse_bool),
    BALLISTA_HISTORY_RETENTION_JOBS: ("512", int),
    BALLISTA_RESULT_CACHE_MB: ("0", int),
    BALLISTA_SINGLE_STAGE_BYPASS: ("true", _parse_bool),
    BALLISTA_TASK_GRANT_BATCH: ("4", int),
    BALLISTA_EAGER_WAIT_S: ("60", float),
}

# Keys whose feature the port lacks, with the ROADMAP item that ports it.
# A non-default value raises where the reference would use it.
UNPORTED: dict[str, str] = {
    BALLISTA_COLLECTIVE_SHUFFLE: "ROADMAP queue 1, item 10b (multi-device)",
}


@dataclasses.dataclass(frozen=True)
class EnvEntry:
    """One declared ``BALLISTA_*`` environment variable (the reference's
    ``config.EnvEntry``). Process-scoped knobs (daemons have no session
    config at start; debug witnesses must not ride query settings) live
    here; everything query-scoped is a key of ``_ENTRIES`` above. The
    ``config-registry`` analyzer (``analysis/configlint.py``) proves every
    env read site of the package resolves to exactly one entry, and
    ``ballista_tpu_torch/docs/config.md`` is generated from both tables. A
    trailing ``*`` declares a prefix family (per-flag daemon overrides)."""

    name: str
    kind: str  # value shape shown in docs ("0|1", "path|off", ...)
    default: str
    description: str
    doc: str  # the module that reads it


# What the port reads, nothing more: the reference's XLA cache and fusion
# variables and its test-harness limit have no reader here.
ENV_REGISTRY: tuple[EnvEntry, ...] = (
    EnvEntry(
        "BALLISTA_FAULTS", "JSON list", "",
        "Deterministic fault-injection rules installed at import; chaos "
        "tests set it in subprocess environments only",
        "testing/faults.py",
    ),
    EnvEntry(
        "BALLISTA_FAULTS_SEED", "int", "0",
        "Seed for probabilistic fault rules (p < 1)",
        "testing/faults.py",
    ),
    EnvEntry(
        "BALLISTA_LOCK_WITNESS", "0|1", "0",
        "Runtime lock-order witness: control-plane locks record per-thread "
        "acquisition order and flag inversions live",
        "analysis/witness.py",
    ),
    EnvEntry(
        "BALLISTA_RESOURCE_WITNESS", "0|1", "0",
        "Runtime resource witness: channels, pools, files and spill sets "
        "register on acquire and must drain to zero at shutdown",
        "analysis/reswitness.py",
    ),
    EnvEntry(
        "BALLISTA_REPLAY_WITNESS", "0|1", "0",
        "Runtime replay witness: committed shuffle outputs and final result "
        "partitions record canonical content hashes; retries, lineage "
        "recomputes and certified rewrites must re-record identical hashes",
        "analysis/replay.py",
    ),
    EnvEntry(
        "BALLISTA_CACHE_WITNESS", "0|1", "0",
        "Runtime cache-staleness witness: sampled cache hits are re-derived "
        "fresh and must hash-match what was served",
        "analysis/stalewitness.py",
    ),
    EnvEntry(
        "BALLISTA_CACHE_WITNESS_SAMPLE", "float 0..1", "1",
        "Fraction of cache hits the staleness witness re-derives "
        "(deterministic per-cache stride, no RNG)",
        "analysis/stalewitness.py",
    ),
    EnvEntry(
        "BALLISTA_DUR_WITNESS", "0|1", "0",
        "Runtime durability witness: a restarted scheduler's recovered "
        "state is diffed against the declared durability classes: "
        "persisted fields round-trip, rebuilt fields converge, ephemeral "
        "fields start empty",
        "analysis/durwitness.py",
    ),
    EnvEntry(
        "BALLISTA_RPC_TIMEOUT_S", "seconds", "30",
        "Default per-call deadline for scheduler-side gRPC and etcd client "
        "calls; 0 disables the default deadline",
        "scheduler/rpc.py",
    ),
    EnvEntry(
        "BALLISTA_AQE", "0|1", "",
        "Process-wide adaptive-query-execution override: 0/off forces AQE "
        "off regardless of session config, 1/on forces it on; unset defers "
        "to ballista.tpu.aqe",
        "scheduler/aqe.py",
    ),
    EnvEntry(
        "BALLISTA_TPU_HINT_CACHE", "path|off", "~/.cache/ballista_tpu_torch",
        "Persisted plan-shape hints (join strategies, learned capacities, "
        "AQE strategies) location override",
        "compilecache/hints.py",
    ),
    EnvEntry(
        "BALLISTA_TPU_PREWARM", "off|on|background", "off",
        "Kernel prewarm mode of executor processes (no session config at "
        "start): run the device-program vocabulary once on the executor's "
        "device at start; an explicit --prewarm flag wins",
        "compilecache/prewarm.py",
    ),
    EnvEntry(
        "BALLISTA_TPU_PREWARM_BUCKETS", "csv ints", "",
        "Bounds the prewarm ladder enumeration (tests / constrained "
        "hosts)",
        "compilecache/prewarm.py",
    ),
    EnvEntry(
        "BALLISTA_TPU_CAPACITY_BUCKETS", "ladder spec", "",
        "Capacity-bucket ladder for server prewarm on non-default "
        "deployments (session config arrives only with the first task)",
        "compilecache/prewarm.py",
    ),
    EnvEntry(
        "BALLISTA_PLUGIN_DIR", "path", "",
        "UDF plugin directory consulted alongside ballista.plugin_dir",
        "plugin.py",
    ),
    EnvEntry(
        "BALLISTA_SCHEDULER_*", "per-flag", "",
        "Scheduler daemon CLI-flag defaults (BALLISTA_SCHEDULER_<FLAG>=v)",
        "scheduler/__main__.py",
    ),
    EnvEntry(
        "BALLISTA_EXECUTOR_*", "per-flag", "",
        "Executor daemon CLI-flag defaults (BALLISTA_EXECUTOR_<FLAG>=v)",
        "executor/__main__.py",
    ),
)


def env_entry_for(name: str) -> EnvEntry | None:
    """The registry entry covering env var ``name`` (exact or prefix
    family), or None: the runtime side of the configlint closure."""
    for e in ENV_REGISTRY:
        if e.name.endswith("*"):
            if name.startswith(e.name[:-1]):
                return e
        elif e.name == name:
            return e
    return None


_ENV_WARNED = False


def warn_unknown_env() -> list[str]:
    """Warn (once per process) about ``BALLISTA_*`` environment variables
    no registry entry covers: a typo'd knob silently doing nothing is the
    env-var analogue of the unknown-config-key ConfigError. Returns the
    offending names (for tests)."""
    import logging
    import os

    global _ENV_WARNED
    unknown = sorted(
        k for k in os.environ
        if k.startswith("BALLISTA_") and env_entry_for(k) is None
    )
    if unknown and not _ENV_WARNED:
        logging.getLogger(__name__).warning(
            "unrecognized BALLISTA_* environment variables (typo? see "
            "ballista_tpu_torch/docs/config.md): %s", ", ".join(unknown),
        )
    _ENV_WARNED = True
    return unknown


class TaskSchedulingPolicy(Enum):
    """Pull vs push task dispatch (ref config.rs:264-281)."""

    PULL_STAGED = "pull-staged"
    PUSH_STAGED = "push-staged"

    @classmethod
    def parse(cls, s: str) -> "TaskSchedulingPolicy":
        for p in cls:
            if p.value == s.lower():
                return p
        raise ConfigError(f"invalid task scheduling policy: {s!r}")


class BallistaConfig:
    """Validated string-keyed settings with typed getters."""

    def __init__(self, settings: dict[str, str] | None = None):
        self._settings: dict[str, str] = {}
        for k, v in (settings or {}).items():
            self._validate(k, v)
            self._settings[k] = v

    @staticmethod
    def _validate(key: str, value: str) -> None:
        entry = _ENTRIES.get(key)
        if entry is None:
            raise ConfigError(f"unknown configuration key: {key!r}")
        try:
            entry[1](value)
        except Exception as e:
            raise ConfigError(
                f"invalid value {value!r} for {key!r}: {e}"
            ) from e

    def settings(self) -> dict[str, str]:
        return dict(self._settings)

    def _get(self, key: str):
        default, parse = _ENTRIES[key]
        return parse(self._settings.get(key, default))

    def check_ported(self, *keys: str) -> None:
        """Raise ConfigError for a key of ``keys`` (each one of
        ``UNPORTED``) set to a value other than its default: the feature
        that would honour it is not ported."""
        for key in keys:
            if key in self._settings and self._get(key) != _ENTRIES[key][1](_ENTRIES[key][0]):
                raise ConfigError(
                    f"{key}={self._settings[key]!r} is not supported by this engine "
                    f"yet ({UNPORTED[key]}); leave it at its default "
                    f"{_ENTRIES[key][0]!r}"
                )

    def default_shuffle_partitions(self) -> int:
        return self._get(BALLISTA_DEFAULT_SHUFFLE_PARTITIONS)

    def tpu_batch_rows(self) -> int:
        return self._get(BALLISTA_TPU_BATCH_ROWS)

    def agg_capacity(self) -> int:
        return self._get(BALLISTA_AGG_CAPACITY)

    def join_expansion(self) -> int:
        return self._get(BALLISTA_JOIN_EXPANSION)

    def repartition_joins(self) -> bool:
        return self._get(BALLISTA_REPARTITION_JOINS)

    def repartition_aggregations(self) -> bool:
        return self._get(BALLISTA_REPARTITION_AGGREGATIONS)

    def parquet_pruning(self) -> bool:
        return self._get(BALLISTA_PARQUET_PRUNING)

    def with_information_schema(self) -> bool:
        return self._get(BALLISTA_WITH_INFORMATION_SCHEMA)

    def scan_stream_mb(self) -> int:
        return self._get(BALLISTA_SCAN_STREAM_MB)

    def prefetch_depth(self) -> int:
        return self._get(BALLISTA_PREFETCH_DEPTH)

    def build_cache_mb(self) -> int:
        return self._get(BALLISTA_BUILD_CACHE_MB)

    def hbm_budget_mb(self) -> int:
        return self._get(BALLISTA_HBM_BUDGET_MB)

    def spill_budget_mb(self) -> int:
        return self._get(BALLISTA_SPILL_BUDGET_MB)

    def spill_dir(self) -> str:
        return self._get(BALLISTA_SPILL_DIR)

    def shuffle_fetch_concurrency(self) -> int:
        return max(0, self._get(BALLISTA_SHUFFLE_FETCH_CONCURRENCY))

    def shuffle_compression(self) -> str:
        return self._get(BALLISTA_SHUFFLE_COMPRESSION)

    def eager_shuffle(self) -> bool:
        return self._get(BALLISTA_EAGER_SHUFFLE)

    def push_shuffle(self) -> bool:
        return self._get(BALLISTA_PUSH_SHUFFLE)

    def push_shuffle_window_mb(self) -> int:
        return self._get(BALLISTA_PUSH_SHUFFLE_WINDOW_MB)

    def shuffle_target_batch_mb(self) -> int:
        return max(0, self._get(BALLISTA_SHUFFLE_TARGET_BATCH_MB))

    def verify_plans(self) -> bool:
        return self._get(BALLISTA_VERIFY_PLANS)

    def fetch_retries(self) -> int:
        return max(1, self._get(BALLISTA_FETCH_RETRIES))

    def fetch_backoff_ms(self) -> int:
        return max(0, self._get(BALLISTA_FETCH_BACKOFF_MS))

    def fetch_timeout_s(self) -> float:
        return max(0.0, self._get(BALLISTA_FETCH_TIMEOUT_S))

    def shuffle_local_fastpath(self) -> bool:
        return self._get(BALLISTA_SHUFFLE_LOCAL_FASTPATH)

    def eager_poll_ms(self) -> int:
        return max(1, self._get(BALLISTA_EAGER_POLL_MS))

    def capacity_buckets(self) -> str:
        return self._get(BALLISTA_CAPACITY_BUCKETS)

    def eager_wait_s(self) -> float:
        return max(0.0, self._get(BALLISTA_EAGER_WAIT_S))

    def trace(self) -> str:
        return self._get(BALLISTA_TRACE)

    def prewarm(self) -> str:
        return self._get(BALLISTA_PREWARM)

    def profile_dir(self) -> str:
        return self._get(BALLISTA_PROFILE_DIR)

    def metrics_collector(self) -> str:
        return self._get(BALLISTA_METRICS_COLLECTOR)

    def cost_accounting(self) -> bool:
        return self._get(BALLISTA_COST_ACCOUNTING)

    def plugin_dir(self) -> str:
        return self._get(BALLISTA_PLUGIN_DIR)

    def task_max_attempts(self) -> int:
        return max(1, self._get(BALLISTA_TASK_MAX_ATTEMPTS))

    def straggler_factor(self) -> float:
        return self._get(BALLISTA_STRAGGLER_FACTOR)

    def straggler_min_s(self) -> float:
        return max(0.0, self._get(BALLISTA_STRAGGLER_MIN_S))

    def skew_ratio(self) -> float:
        return self._get(BALLISTA_SKEW_RATIO)

    def skew_min_rows(self) -> int:
        return max(0, self._get(BALLISTA_SKEW_MIN_ROWS))

    def scaler_queue_wait_target_s(self) -> float:
        return self._get(BALLISTA_SCALER_QUEUE_WAIT_TARGET_S)

    def aqe(self) -> bool:
        return self._get(BALLISTA_AQE)

    def aqe_broadcast_threshold_mb(self) -> int:
        return self._get(BALLISTA_AQE_BROADCAST_THRESHOLD_MB)

    def aqe_target_partition_mb(self) -> int:
        return self._get(BALLISTA_AQE_TARGET_PARTITION_MB)

    def history_retention_jobs(self) -> int:
        return max(1, self._get(BALLISTA_HISTORY_RETENTION_JOBS))

    def result_cache_mb(self) -> int:
        return max(0, self._get(BALLISTA_RESULT_CACHE_MB))

    def single_stage_bypass(self) -> bool:
        return self._get(BALLISTA_SINGLE_STAGE_BYPASS)

    def task_grant_batch(self) -> int:
        return max(1, self._get(BALLISTA_TASK_GRANT_BATCH))

    def __eq__(self, other) -> bool:
        return isinstance(other, BallistaConfig) and other._settings == self._settings

    def __repr__(self) -> str:
        return f"BallistaConfig({self._settings!r})"
