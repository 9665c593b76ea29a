"""Executor metrics collection.

ref ballista/rust/executor/src/metrics/mod.rs:26-58 — a collector trait
and the default LoggingMetricsCollector that prints the annotated plan
after every completed stage task.

The trait is pluggable (docs/observability.md): the
default is now :class:`ShippingMetricsCollector`, which walks the
executed stage fragment and returns per-operator counter/timer records
that the task runner serializes into ``CompletedTask.operator_metrics``
— the scheduler aggregates them per (job, stage, partition) and serves
them through ``GET /api/job/<id>``, ``GET /api/metrics``, and the
EXPLAIN ANALYZE surface. ``ballista.tpu.metrics_collector=logging``
restores the reference's log-only behavior per session.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class ExecutorMetricsCollector:
    """One hook per completed stage task. ``record_stage`` may return a
    list of per-operator metric records (obs.profile.operator_metrics
    shape) to ship home in the task's CompletedTask, or None to ship
    nothing."""

    def record_stage(
        self, job_id: str, stage_id: int, partition: int, plan
    ) -> list[dict] | None:
        raise NotImplementedError

    def wants_instrumentation(self) -> bool:
        """Whether the executor should meter the decoded plan
        (obs.profile.instrument_plan) BEFORE running it — shipping needs
        per-operator rows/bytes/elapsed; logging keeps the reference's
        operator-recorded metrics only."""
        return False


class LoggingMetricsCollector(ExecutorMetricsCollector):
    """The reference's collector: annotated plan into the executor log."""

    def record_stage(self, job_id, stage_id, partition, plan) -> None:
        log.info(
            "=== [%s/%s/%s] Physical plan with metrics ===\n%s",
            job_id, stage_id, partition, plan.display(with_metrics=True),
        )
        return None


class ShippingMetricsCollector(ExecutorMetricsCollector):
    """Default collector: per-operator counters/timers collected from the
    executed fragment and returned for TaskStatus shipping. Device-scalar
    counters resolve here — at the task boundary, after the result fetch
    already drained the device queue — not on the per-batch hot path."""

    def record_stage(self, job_id, stage_id, partition, plan) -> list[dict]:
        from ballista_tpu_torch.obs import profile

        records = profile.operator_metrics(plan)
        log.debug(
            "[%s/%s/%s] shipping %d operator metric records",
            job_id, stage_id, partition, len(records),
        )
        return records

    def wants_instrumentation(self) -> bool:
        return True


def collector_for(config, override=None) -> ExecutorMetricsCollector:
    """Resolve the session's collector (``ballista.tpu.metrics_collector``,
    declared in the config registry). An explicitly constructed collector
    (tests, embedders) wins over the config value."""
    if override is not None:
        return override
    if config.metrics_collector() == "logging":
        return LoggingMetricsCollector()
    return ShippingMetricsCollector()
