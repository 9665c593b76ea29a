"""Runtime durability witness: scheduler recovery as a checkable
invariant.

The static half (durlint + the declared state registry) proves the TREE
obeys the durability contracts; this witness proves the RUNNING SYSTEM
does — the durability analogue of the lock, resource, replay, and
staleness witnesses. When enabled, :func:`snapshot` canonicalizes the
declared state inventory of a live scheduler, and
:func:`verify_restart` diffs a RESTARTED scheduler (same sqlite/etcd
backend) against the durability classes:

- ``persisted`` fields must round-trip — with the one declared
  transform: queued/running jobs are closed out as ``failed`` by
  ``_recover_state`` (in-flight tasks died with the old scheduler).
- ``rebuilt`` fields must start empty and converge once their declared
  source replays (executors re-register → heartbeat/slot records for
  exactly the re-registered ids).
- ``ephemeral`` fields must start EMPTY — a result cache that survives
  a restart is a stale-serve bug, not a convenience.

Every comparison is recorded as a ``(field, outcome)`` check;
:func:`assert_no_divergence` is fatal on any ``divergent`` outcome and
— like the other witnesses — on a ZERO check count by default ("zero
divergence" must never silently mean "zero checks"). The two-scheduler
failover test records its watch-convergence and exactly-once-terminal
assertions through the same counters, and
:func:`terminal_history_counts` is the exactly-once probe: a job's
stamped history record must hold exactly one terminal row.

Default OFF: ``BALLISTA_DUR_WITNESS=1`` (or :func:`enable`) turns it
on. Exposed on ``/api/metrics`` as
``ballista_dur_witness_checks_total{field,outcome}``
(obs/prometheus.py) so chaos/soak runs scrape recovery state the same
way they scrape replay/staleness state."""

from __future__ import annotations

import logging
import os
import threading

from ballista_tpu_torch.analysis import durreg

ENV_WITNESS = "BALLISTA_DUR_WITNESS"

log = logging.getLogger(__name__)

_enabled = os.environ.get(ENV_WITNESS, "") in ("1", "true", "yes")

_lock = threading.Lock()
_checks: dict[tuple[str, str], int] = {}  # (field, match|divergent) -> n
_divergences: list[dict] = []

# rebuilt entries that must be EMPTY post-restart regardless of executor
# re-registration (their source replays through new submissions, which a
# witness run does not perform between restart and verification)
_REBUILT_EMPTY = ("stage-state", "trace-index")
# rebuilt entries that must CONVERGE to exactly the re-registered ids
_REBUILT_CONVERGE = ("executor-heartbeats", "executor-slots")


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def record(field: str, outcome: str, detail: str = "") -> None:
    """Count one durability check; ``divergent`` outcomes carry their
    detail into the fatal report."""
    with _lock:
        k = (field, outcome)
        _checks[k] = _checks.get(k, 0) + 1
        if outcome == "divergent":
            _divergences.append({"field": field, "detail": detail})
    if outcome == "divergent":
        log.error("durability witness DIVERGENCE in %s: %s", field, detail)


def counters() -> dict[tuple[str, str], int]:
    """(field, outcome) -> count, for the prometheus family."""
    with _lock:
        return dict(_checks)


def divergences() -> list[dict]:
    with _lock:
        return [dict(d) for d in _divergences]


def summary() -> str:
    cs = counters()
    total = sum(cs.values())
    bad = sum(n for (f, o), n in cs.items() if o == "divergent")
    per = ", ".join(f"{f}:{o}={n}" for (f, o), n in sorted(cs.items()))
    return f"{total} checks ({per or 'none'}), {bad} divergent"


def assert_no_divergence(require_checks: bool = True) -> None:
    """Zero divergences (and, by default, a nonzero check count — a
    witness that saw no restart proves nothing)."""
    bad = divergences()
    if bad:
        lines = [f"{d['field']}: {d['detail']}" for d in bad]
        raise AssertionError(
            f"{len(bad)} durability divergences:\n" + "\n".join(lines)
        )
    if require_checks and not counters():
        raise AssertionError(
            "durability witness checked nothing — enable() and run "
            "verify_restart() (or record checks) before asserting"
        )


def reset() -> None:
    with _lock:
        _checks.clear()
        _divergences.clear()


# ---------------------------------------------------------------------------
# inventory snapshot (canonical, order-independent values per entry)
# ---------------------------------------------------------------------------

def snapshot(server) -> dict[str, object]:
    """Canonicalize every declared state entry of a live
    SchedulerServer. Values are hashable/comparable shapes (sorted
    tuples, counts) so two snapshots diff cleanly across processes."""
    with server._lock:
        jobs = dict(server.jobs)
        sessions = sorted(server.sessions)
        traces = sorted(server._traces)
        bypass = (
            len(server._bypass_pending),
            len(server._bypass_running),
            len(server._bypass_attempts),
        )
        obs_counts = (
            len(server.obs_task_counters),
            len(server._obs_retained),
            len(server.obs_straggler_total),
            len(server.obs_skew_total),
            len(server._recent_queue_waits),
            len(server._known_classes),
            len(server.obs_class_cost),
            len(server.obs_aqe_total),
        )
        clients = sorted(
            set(server.executor_clients)
            | set(server._executor_channels)
            | set(server._launch_failures)
        )
    em = server.executor_manager
    with em._lock:
        metadata = {
            eid: (m.host, m.port, m.grpc_port,
                  m.specification.task_slots)
            for eid, m in em._metadata.items()
        }
        heartbeats = sorted(em._heartbeats)
        slots = sorted(em._data)
        metrics = sorted(em._metrics)
    sm = server.stage_manager
    with sm._lock:
        stage_keys = sorted(sm._stages)
    return {
        "job-map": tuple(sorted(jobs)),
        "job-record": {
            jid: (j.status, j.final_stage_id,
                  tuple(sorted((k, tuple(sorted(v)))
                               for k, v in j.dependencies.items())))
            for jid, j in jobs.items()
        },
        "completed-locations": {
            jid: tuple(sorted(
                (loc.stage_id, loc.partition, loc.path)
                for loc in j.completed_locations
            ))
            for jid, j in jobs.items()
            if j.status == "completed"
        },
        "stage-plans": {
            jid: tuple(sorted(j.stages)) for jid, j in jobs.items()
        },
        "sessions": tuple(sessions),
        "executor-metadata": metadata,
        "executor-heartbeats": tuple(heartbeats),
        "executor-slots": tuple(slots),
        "executor-metrics": tuple(metrics),
        "executor-clients": tuple(clients),
        "stage-state": tuple(stage_keys),
        "trace-index": tuple(traces),
        "resolved-plan-bytes": sum(
            len(j.resolved_plan_bytes) for j in jobs.values()
        ),
        "eager-plan-bytes": sum(
            len(j.eager_plan_bytes) for j in jobs.values()
        ) + sum(1 for j in jobs.values() if j.eager),
        "result-cache-state": (
            server.result_cache.stats().get("entries", 0),
            sum(1 for j in jobs.values() if j.cache_key is not None),
            sum(1 for j in jobs.values() if j.result_ipc),
        ),
        "bypass-state": bypass + (
            sum(1 for j in jobs.values() if j.bypass),
        ),
        "job-run-counters": sum(
            j.total_retries + j.total_recomputes + j.total_rewrites
            + j.total_rewrite_rejects + len(j.rewrite_log)
            + len(j.rewritten_stages) + len(j.aqe_decisions)
            for j in jobs.values()
        ),
        "job-obs-payloads": sum(
            len(j.spans) + len(j.op_metrics) + len(j.stage_spans)
            + (1 if j.trace_id else 0)
            + (1 if j.stage_stats else 0)
            for j in jobs.values()
        ),
        "scheduler-obs-counters": obs_counts,
    }


def _is_empty(value) -> bool:
    if isinstance(value, (int, float)):
        return value == 0
    if isinstance(value, tuple) and all(
        isinstance(v, (int, float)) for v in value
    ):
        return all(v == 0 for v in value)
    return not value


def _expected_persisted(name: str, before):
    """The declared restart transform for persisted entries: in-flight
    jobs close out as failed (_recover_state), everything else
    round-trips bit-identically."""
    if name == "job-record":
        return {
            jid: ("failed" if status in ("queued", "running") else status,
                  final, deps)
            for jid, (status, final, deps) in before.items()
        }
    return before


def verify_restart(
    before: dict[str, object], server, reregistered=(),
) -> dict[str, str]:
    """Diff a restarted scheduler against a pre-restart snapshot,
    recording one check per declared entry. ``reregistered`` names the
    executor ids that re-registered between restart and verification
    (the rebuilt-class convergence source). Returns field -> outcome."""
    after = snapshot(server)
    rereg = frozenset(reregistered)
    outcomes: dict[str, str] = {}
    for e in durreg.STATE:
        b, a = before.get(e.name), after.get(e.name)
        if e.durability == "persisted":
            want = _expected_persisted(e.name, b)
            ok = a == want
            detail = f"expected {want!r}, recovered {a!r}"
        elif e.durability == "rebuilt":
            if e.name in _REBUILT_EMPTY:
                ok = _is_empty(a)
                detail = f"must start empty after restart, found {a!r}"
            elif e.name in _REBUILT_CONVERGE:
                ok = frozenset(a) == rereg
                detail = (
                    f"must converge to re-registered executors "
                    f"{sorted(rereg)}, found {a!r}"
                )
            else:
                ok = frozenset(a) <= rereg
                detail = (
                    f"rebuilt from re-registration only, but found "
                    f"{a!r} with re-registered {sorted(rereg)}"
                )
        else:  # ephemeral
            ok = _is_empty(a)
            detail = f"ephemeral state must start empty, found {a!r}"
        outcome = "match" if ok else "divergent"
        outcomes[e.name] = outcome
        record(e.name, outcome, "" if ok else f"{e.name}: {detail}")
    return outcomes


# ---------------------------------------------------------------------------
# exactly-once terminal history (the failover invariant)
# ---------------------------------------------------------------------------

def terminal_history_counts(history, job_id: str) -> dict[str, int]:
    """How many terminal history records a job holds, by kind — the
    exactly-once probe: sum(counts.values()) must be 1 for every job
    that reached a terminal state, across any number of scheduler
    restarts/failovers."""
    counts = {"completed": 0, "failed": 0}
    stamp = history._stamp_of(job_id)
    if stamp is None:
        return counts
    prefix = history._k("jobs", stamp) + "/"
    for key, _ in history.backend.get_from_prefix(prefix):
        kind = key.rsplit("/", 1)[-1]
        if kind in counts:
            counts[kind] += 1
    return counts
