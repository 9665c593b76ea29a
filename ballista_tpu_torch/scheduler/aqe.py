"""Adaptive query execution: the part of ``ballista_tpu/scheduler/aqe.py``
that the scheduler's default path reaches.

Ported: the ``BALLISTA_AQE`` override and :func:`enabled`, the
runtime-stats gathering the skew monitor reads on every job
(:func:`producer_stats`, :func:`keyed_bucket_totals`), and
:class:`AqePolicy`, whose hooks return at once while AQE is off.

Not ported (ROADMAP queue 1, item 9e, step 3): the policy itself (the
learned strategy store over ``compilecache/hints.py``, the flip,
split, coalesce and broadcast rules), the certified rewrites it applies
(``rewrite.py``) and the scheduler's ``apply_certified_rewrite``. So where
the reference would turn AQE on (``ballista.tpu.aqe=true``, or
``BALLISTA_AQE=1`` in the environment), :func:`enabled` raises
``ConfigError`` naming that item; it never ignores the request.
"""

from __future__ import annotations

import logging
import os

from ballista_tpu_torch.config import BALLISTA_AQE, UNPORTED
from ballista_tpu_torch.errors import ConfigError

log = logging.getLogger(__name__)


def env_override() -> bool | None:
    """The ``BALLISTA_AQE`` process kill-switch/force: ``0``/``off``
    disables AQE regardless of session config, ``1``/``on`` enables it;
    unset defers to ``ballista.tpu.aqe``."""
    v = os.environ.get("BALLISTA_AQE", "").strip().lower()
    if v in ("0", "off", "false"):
        return False
    if v in ("1", "on", "true"):
        return True
    return None


def enabled(cfg) -> bool:
    """False, or ``ConfigError`` where the reference would return True."""
    ov = env_override()
    on = ov if ov is not None else cfg.aqe()
    if on:
        source = "BALLISTA_AQE" if ov is not None else BALLISTA_AQE
        raise ConfigError(
            f"{source} turns on adaptive query execution, which is not "
            f"supported by this engine yet ({UNPORTED[BALLISTA_AQE]})"
        )
    return False


def narrate(ctx, optimized) -> str:
    """EXPLAIN ANALYZE's AQE line. With AQE off and no strategy learned,
    the only state the port has (the strategy store is item 9e), the
    reference's line says so without planning anything."""
    return (
        "aqe=off: no learned strategies in this process (enable "
        "ballista.tpu.aqe to adapt; the distributed query class "
        "is computed when AQE is on or strategies exist)"
    )


# ---------------------------------------------------------------------------
# runtime-stats gathering
# ---------------------------------------------------------------------------


def producer_stats(server, job_id: str, consumer_plan) -> dict:
    """Observed output of every completed producer a consumer stage
    reads: ``{producer_stage_id: {"rows", "bytes",
    "buckets": {bucket: (rows, bytes)}}}`` summed from the committed
    shuffle-write metas (exact counts — the executors measured them)."""
    from ballista_tpu_torch.distributed_plan import find_unresolved_shuffles

    out: dict[int, dict] = {}
    for u in sorted(
        find_unresolved_shuffles(consumer_plan), key=lambda u: u.stage_id
    ):
        if u.stage_id in out:
            continue
        buckets: dict[int, tuple[int, int]] = {}
        rows = nbytes = 0
        for _task_idx, _eid, metas in server.stage_manager.completed_partitions(
            job_id, u.stage_id
        ):
            for m in metas:
                r, b = buckets.get(m.partition_id, (0, 0))
                buckets[m.partition_id] = (r + m.num_rows, b + m.num_bytes)
                rows += m.num_rows
                nbytes += m.num_bytes
        out[u.stage_id] = {"rows": rows, "bytes": nbytes, "buckets": buckets}
    return out


def keyed_bucket_totals(
    job, stats: dict
) -> tuple[dict[int, tuple[int, int]], int]:
    """Per-bucket ``(rows, bytes)`` summed across the KEYED producers in
    ``stats`` (the hash buckets a consumer's tasks each read), plus the
    keyed-producer count. Unkeyed (collect/coalesce) producers are
    excluded — their single output is not a hash bucket."""
    buckets: dict[int, tuple[int, int]] = {}
    keyed = 0
    for sid in sorted(stats):
        stage = job.stages.get(sid)
        if stage is None or not getattr(stage.plan, "partition_keys", None):
            continue
        keyed += 1
        for b in sorted(stats[sid]["buckets"]):
            r0, b0 = buckets.get(b, (0, 0))
            r, nb = stats[sid]["buckets"][b]
            buckets[b] = (r0 + r, b0 + nb)
    return buckets, keyed


class AqePolicy:
    """Decision engine bound to one :class:`SchedulerServer`, with the
    reference's hooks. Each returns at once: :func:`enabled` is False or
    raises, and the submission path has already called it for the job's
    session (``SchedulerServer.submit_physical``)."""

    def __init__(self, server) -> None:
        self.server = server

    def _cfg(self, job):
        return self.server._session_config(job.session_id)

    def wants_to_adapt(self, job) -> bool:
        return enabled(self._cfg(job))

    def on_job_submitted(self, job) -> None:
        enabled(self._cfg(job))

    def on_stage_finished(
        self, job, stage_id: int, ready_stats: dict[int, dict]
    ) -> None:
        enabled(self._cfg(job))

    def on_job_finished(self, job) -> None:
        enabled(self._cfg(job))
