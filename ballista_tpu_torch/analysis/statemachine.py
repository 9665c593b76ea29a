"""Canonical task/stage/job status state machines — ONE source of truth
(a copy of ``ballista_tpu/analysis/statemachine.py``).

The scheduler grew three status machines (task, stage-DAG membership, job record)
whose legal edges were encoded implicitly: a ``_LEGAL`` set inside
``stage_manager.py``, membership moves between the running/pending/
completed sets, and bare string assignments in ``server.py``. Any new
recovery path could add an undeclared transition that the runtime would
happily take (or silently drop) with nothing checking it.

This module declares every edge in one place, with the event that takes
it. Consumers:

- :mod:`ballista_tpu_torch.scheduler.stage_manager` derives its legal-transition
  validator from :data:`TASK_TRANSITIONS` — code and spec cannot drift.
- :mod:`ballista_tpu_torch.analysis.racelint` (rule
  ``undeclared-transition``) checks every status assignment of the
  control plane against these tables.
- ``tests/test_torch_scheduler.py`` drives randomized
  retry/recovery/promote sequences and asserts every observed hop is an
  edge of these tables, and that they are the reference's.

Edges are ``(from, to) -> event description``. States are the enum VALUE
strings (``"pending"``, not ``"PENDING"``) so runtime checks need no
mapping layer.
"""

from __future__ import annotations

# -- task status (ref stage_manager.rs:536-586) -------------------------------
TASK_STATES = ("pending", "running", "failed", "completed")

TASK_TRANSITIONS: dict[tuple[str, str], str] = {
    ("pending", "running"): "scheduled onto an executor",
    ("running", "completed"): "executor reported success",
    ("running", "failed"): "executor reported failure",
    ("running", "pending"): "executor lost — reset for re-handout",
    ("failed", "pending"): "bounded retry requeue (attempts < cap)",
    ("completed", "pending"): "lost-shuffle re-open (output invalidated)",
}

# -- stage DAG membership (running/pending/completed sets) --------------------
STAGE_STATES = ("pending", "running", "completed")

STAGE_TRANSITIONS: dict[tuple[str, str], str] = {
    ("pending", "running"): "promote — every dependency completed",
    ("running", "pending"): "demote — a dependency's output was invalidated",
    ("running", "completed"): "every task completed",
    ("completed", "running"): "lost-shuffle rollback — output re-opened",
}

# -- job record (server.py JobInfo.status) ------------------------------------
JOB_STATES = ("queued", "running", "failed", "completed")

JOB_TRANSITIONS: dict[tuple[str, str], str] = {
    ("queued", "running"): "stages generated and submitted",
    ("queued", "failed"): "planning/stage-submission failed",
    ("running", "completed"): "final stage finished",
    ("running", "failed"): "task attempts / recompute bound exhausted",
}


def is_legal_task_transition(src: str, dst: str) -> bool:
    return (src, dst) in TASK_TRANSITIONS


def is_legal_stage_transition(src: str, dst: str) -> bool:
    return (src, dst) in STAGE_TRANSITIONS


def is_legal_job_transition(src: str, dst: str) -> bool:
    return (src, dst) in JOB_TRANSITIONS


def render_tables() -> str:
    """Human-readable dump of the three tables."""
    out = []
    for title, table in (
        ("task", TASK_TRANSITIONS),
        ("stage", STAGE_TRANSITIONS),
        ("job", JOB_TRANSITIONS),
    ):
        out.append(f"{title} transitions:")
        for (src, dst), why in table.items():
            out.append(f"  {src:>9} -> {dst:<9}  {why}")
    return "\n".join(out)
