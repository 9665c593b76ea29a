"""Executor registry: heartbeats + slot accounting.

ref ballista/rust/scheduler/src/state/executor_manager.rs:28-145.
"""

from __future__ import annotations

import time

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.scheduler_types import ExecutorData, ExecutorMetadata

DEFAULT_EXECUTOR_TIMEOUT_SECONDS = 60.0  # ref :69-77


class ExecutorManager:
    def __init__(self) -> None:
        self._lock = make_lock("ExecutorManager._lock", reentrant=True)
        self._heartbeats: dict[str, float] = {}
        self._metadata: dict[str, ExecutorMetadata] = {}
        self._data: dict[str, ExecutorData] = {}
        # latest compile-latency counter snapshot per executor (ridden in
        # on HeartBeatParams/PollWorkParams.metrics; docs/compile_cache.md)
        self._metrics: dict[str, dict[str, float]] = {}

    def save_executor_metadata(self, meta: ExecutorMetadata) -> None:
        with self._lock:
            self._metadata[meta.id] = meta

    def get_executor_metadata(self, executor_id: str) -> ExecutorMetadata | None:
        with self._lock:
            return self._metadata.get(executor_id)

    def all_executors(self) -> list[ExecutorMetadata]:
        with self._lock:
            return list(self._metadata.values())

    def save_executor_heartbeat(self, executor_id: str) -> None:
        with self._lock:
            self._heartbeats[executor_id] = time.time()

    def save_executor_metrics(
        self, executor_id: str, metrics: dict[str, float]
    ) -> None:
        """Store the latest counter snapshot (replace, not merge: the
        executor sends cumulative process-wide counters)."""
        if not metrics:
            return
        with self._lock:
            self._metrics[executor_id] = dict(metrics)

    def get_executor_metrics(self, executor_id: str) -> dict[str, float]:
        with self._lock:
            return dict(self._metrics.get(executor_id, ()))

    def last_seen(self, executor_id: str) -> float | None:
        with self._lock:
            return self._heartbeats.get(executor_id)

    def get_alive_executors(
        self, timeout: float = DEFAULT_EXECUTOR_TIMEOUT_SECONDS
    ) -> set[str]:
        """ref :55-77 — alive = heartbeat within the window."""
        now = time.time()
        with self._lock:
            return {
                eid
                for eid, ts in self._heartbeats.items()
                if now - ts <= timeout
            }

    def save_executor_data(self, data: ExecutorData) -> None:
        with self._lock:
            self._data[data.executor_id] = data

    def update_executor_data(self, executor_id: str, delta: int) -> None:
        """Adjust available slots by +/- delta (ref :84-109)."""
        with self._lock:
            d = self._data.get(executor_id)
            if d is None:
                return
            d.available_task_slots = max(
                0, min(d.total_task_slots, d.available_task_slots + delta)
            )

    def get_executor_data(self, executor_id: str) -> ExecutorData | None:
        with self._lock:
            return self._data.get(executor_id)

    def tracked_executors(self) -> set[str]:
        """Executors with registered slot accounting (candidates for
        expiry checks)."""
        with self._lock:
            return set(self._data.keys())

    def remove_executor(self, executor_id: str) -> None:
        """Drop a dead executor from scheduling (metadata is kept — already-
        written shuffle locations still reference its host)."""
        with self._lock:
            self._data.pop(executor_id, None)
            self._heartbeats.pop(executor_id, None)
            self._metrics.pop(executor_id, None)

    def get_available_executors_data(
        self, timeout: float = DEFAULT_EXECUTOR_TIMEOUT_SECONDS
    ) -> list[ExecutorData]:
        """Alive executors with free slots, most-free first (ref :121-135)."""
        alive = self.get_alive_executors(timeout)
        with self._lock:
            out = [
                ExecutorData(
                    d.executor_id, d.total_task_slots, d.available_task_slots
                )
                for d in self._data.values()
                if d.executor_id in alive and d.available_task_slots > 0
            ]
        out.sort(key=lambda d: -d.available_task_slots)
        return out
