"""Write-through persistent scheduler state.

Mirrors the reference's ``PersistentSchedulerState`` (ref
ballista/rust/scheduler/src/state/persistent_state.rs:39-399): a
write-through cache over a :class:`StateBackendClient` storing executor
metadata, job statuses, job->session config, and serialized stage plans
under ``/ballista/<namespace>/...`` keys (:326-352), with ``init()``
reloading everything on scheduler restart (:85-181) — the
restart-recovery contract pinned by the reference's test at
persistent_state.rs:401-525.

Running task state (the StageManager) is deliberately NOT persisted,
matching the reference: a restarted scheduler recovers completed jobs and
their result locations; jobs that were mid-flight are marked failed with
a restart error (the reference leaves them dangling — failing loudly is
the stricter contract).
"""

from __future__ import annotations

import dataclasses
import json
import logging

from ballista_tpu_torch.scheduler.state_backend import StateBackendClient
from ballista_tpu_torch.scheduler_types import (
    ExecutorMetadata,
    ExecutorSpecification,
    PartitionLocation,
)

log = logging.getLogger(__name__)


class PersistentSchedulerState:
    def __init__(
        self,
        backend: StateBackendClient,
        namespace: str = "default",
        codec=None,
    ) -> None:
        self.backend = backend
        self.namespace = namespace
        self.codec = codec

    # -- key scheme (ref persistent_state.rs:326-352) ------------------------
    def _k(self, *parts: str) -> str:
        return "/".join(("/ballista", self.namespace) + parts)

    # -- executors -----------------------------------------------------------
    def save_executor_metadata(self, meta: ExecutorMetadata) -> None:
        payload = json.dumps(
            {
                "id": meta.id,
                "host": meta.host,
                "port": meta.port,
                "grpc_port": meta.grpc_port,
                "task_slots": meta.specification.task_slots,
                "n_devices": meta.specification.n_devices,
            }
        ).encode()
        with self.backend.lock():  # ref persistent_state.rs:313-319
            self.backend.put(self._k("executor_metadata", meta.id), payload)

    def load_executors(self) -> list[ExecutorMetadata]:
        out = []
        for _, v in self.backend.get_from_prefix(
            self._k("executor_metadata")
        ):
            d = json.loads(v)
            out.append(
                ExecutorMetadata(
                    id=d["id"],
                    host=d["host"],
                    port=d["port"],
                    grpc_port=d.get("grpc_port", 0),
                    specification=ExecutorSpecification(
                        task_slots=d.get("task_slots", 4),
                        n_devices=d.get("n_devices", 1),
                    ),
                )
            )
        return out

    # -- sessions ------------------------------------------------------------
    def save_session(self, session_id: str, settings: dict[str, str]) -> None:
        with self.backend.lock():
            self.backend.put(
                self._k("sessions", session_id),
                json.dumps(settings).encode(),
            )

    def load_sessions(self) -> dict[str, dict[str, str]]:
        return {
            k.rsplit("/", 1)[1]: json.loads(v)
            for k, v in self.backend.get_from_prefix(self._k("sessions"))
        }

    # -- jobs ----------------------------------------------------------------
    def save_job(self, job) -> None:
        """``job`` is a scheduler JobInfo (duck-typed to avoid a cycle)."""
        payload = json.dumps(
            {
                "job_id": job.job_id,
                "session_id": job.session_id,
                "status": job.status,
                "error": job.error,
                "final_stage_id": job.final_stage_id,
                "dependencies": {
                    str(k): sorted(v) for k, v in job.dependencies.items()
                },
                "locations": [
                    {
                        k: v
                        for k, v in dataclasses.asdict(loc).items()
                        if k != "stats"  # per-file stats don't drive reads
                    }
                    for loc in job.completed_locations
                ],
            }
        ).encode()
        with self.backend.lock():
            self.backend.put(self._k("jobs", job.job_id), payload)

    def load_jobs(self) -> list[dict]:
        return [
            json.loads(v)
            for _, v in self.backend.get_from_prefix(self._k("jobs"))
        ]

    # -- stage plans ---------------------------------------------------------
    def save_stage_plan(self, job_id: str, stage_id: int, plan) -> None:
        if self.codec is None:
            return
        data = self.codec.physical_to_proto(plan).SerializeToString()
        with self.backend.lock():
            self.backend.put(self._k("stages", job_id, str(stage_id)), data)

    def load_stage_plans(self, job_id: str) -> dict[int, object]:
        """stage_id -> decoded physical plan."""
        if self.codec is None:
            return {}
        from ballista_tpu_torch.proto import pb

        out: dict[int, object] = {}
        for k, v in self.backend.get_from_prefix(
            self._k("stages", job_id)
        ):
            stage_id = int(k.rsplit("/", 1)[1])
            node = pb.PhysicalPlanNode()
            node.ParseFromString(v)
            try:
                out[stage_id] = self.codec.physical_from_proto(node)
            except Exception as e:  # noqa: BLE001 — table may be gone
                log.warning(
                    "could not decode stage %s/%s on recovery: %s",
                    job_id, stage_id, e,
                )
        return out

    @staticmethod
    def locations_from_json(rows: list[dict]) -> list[PartitionLocation]:
        return [PartitionLocation(**r) for r in rows]
