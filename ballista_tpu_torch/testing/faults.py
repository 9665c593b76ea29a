"""Deterministic fault-injection harness for chaos testing.

Proves the fault-tolerance machinery (bounded task retries, lost-shuffle
recovery, fetch-level resilience — docs/fault_tolerance.md) against
*reproducible* failures: every injection point is keyed by
``(job, stage, partition, attempt)`` and rule matching is pure, so the same
rule set + seed produces the same fault schedule on every run regardless of
thread interleaving.

Configuration
-------------
``BALLISTA_FAULTS``      JSON list of rules (see below) — or call
                         :func:`install` programmatically (tests).
``BALLISTA_FAULTS_SEED`` integer seed for probabilistic rules (``p`` < 1).

A rule is an object with a ``point`` plus match fields (omitted = match
anything)::

    {"point": "task_crash",  "job": "*", "stage": 2, "partition": 0,
     "attempt": 0, "error": "transient"}        # or "plan" | custom text
    {"point": "fetch_error", "stage": 1, "partition": 0, "attempt": [0, 1]}
    {"point": "fetch_slow",  "stage": 1, "delay_s": 0.2}
    {"point": "heartbeat_blackout", "executor": "deadbeef*"}
    {"point": "producer_kill", "stage": 1, "partition": 0,
     "after_batches": 2, "max_fires": 1}

``attempt`` matches an int, a list of ints, or "*" (default). ``executor``
supports a trailing-``*`` prefix match. ``p`` (default 1.0) fires the rule
with that probability, decided by a hash of (seed, point, key) — NOT a
shared RNG stream, so concurrency cannot reorder decisions. ``max_fires``
bounds total firings of one rule (stateful; use ``attempt`` lists when
exact determinism across processes matters).

Injection points (all default-off, one ``is None`` check when disabled):

- ``on_task_start`` — executor task loop, before the plan runs; a matching
  ``task_crash`` raises (``error: "plan"`` raises PlanVerificationError to
  exercise the non-retryable short-circuit; anything else raises
  ExecutionError).
- ``on_fetch_attempt`` — Flight client / shuffle reader, per fetch attempt;
  ``fetch_error`` raises a transient-transport error (counts against the
  fetch retry budget), ``fetch_slow`` sleeps ``delay_s``.
- ``heartbeat_suppressed`` — executor heartbeat/poll paths; a matching
  ``heartbeat_blackout`` silences the executor so the scheduler's expiry
  sweep sees it die.
- ``on_serve_batch`` — the Flight service's shuffle stream, per served
  batch; a matching ``producer_kill`` breaks the stream after
  ``after_batches`` batches already reached the consumer (the
  producer-dies-mid-stream recovery shape, docs/shuffle.md).
- ``on_rewrite_validate`` — the scheduler's certified-rewrite acceptance
  gate; a matching ``rewrite_reject`` (keyed by job/stage, optional
  ``clause``) fails certificate validation with the typed
  RewriteRejected, so the reject + fall-back-to-pristine-template path
  is reachable and testable (docs/analysis.md).

Normal runs must never be poisoned by a stray env var: tests/conftest.py
strips ``BALLISTA_FAULTS*`` from the environment and asserts the harness
is inert in-process (chaos tests opt in via subprocess envs).
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

ENV_FAULTS = "BALLISTA_FAULTS"
ENV_SEED = "BALLISTA_FAULTS_SEED"

POINTS = (
    "task_crash",
    "fetch_error",
    "fetch_slow",
    "heartbeat_blackout",
    "producer_kill",
    "rewrite_reject",
)


class InjectedFault(Exception):
    """Raised by the harness for injected task crashes (retryable flavor).

    Deliberately NOT a BallistaError subclass: it crosses the wire as
    "InjectedFault: ..." which the scheduler classifies as retryable
    (unknown error types default to retryable)."""


class InjectedFetchError(Exception):
    """Transient-transport flavored injected fetch failure; the Flight
    client treats it exactly like an unavailable endpoint (retry with
    backoff, then escalate to ShuffleFetchError)."""


class FaultInjector:
    def __init__(self, rules: list[dict], seed: int = 0):
        for r in rules:
            if r.get("point") not in POINTS:
                raise ValueError(
                    f"unknown fault point {r.get('point')!r}; "
                    f"valid: {POINTS}"
                )
        self.rules = [dict(r) for r in rules]
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._fires: dict[int, int] = {}  # rule index -> times fired
        self.log: list[tuple] = []  # (point, key) of every firing

    # -- matching ------------------------------------------------------------
    @staticmethod
    def _match_scalar(pattern, value) -> bool:
        if pattern is None or pattern == "*":
            return True
        if isinstance(pattern, list):
            return value in pattern
        return pattern == value

    @staticmethod
    def _match_executor(pattern, executor_id: str) -> bool:
        if pattern is None or pattern == "*":
            return True
        return fnmatch.fnmatchcase(executor_id, str(pattern))

    def _decide_p(self, rule: dict, point: str, key: tuple) -> bool:
        p = float(rule.get("p", 1.0))
        if p >= 1.0:
            return True
        # hash-based decision: deterministic per (seed, point, key), immune
        # to thread interleaving (a shared RNG stream would not be)
        h = hashlib.sha256(
            repr((self.seed, point, key)).encode()
        ).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)
        return u < p

    def _fire(self, idx: int, rule: dict, point: str, key: tuple) -> bool:
        if not self._decide_p(rule, point, key):
            return False
        max_fires = rule.get("max_fires")
        with self._lock:
            n = self._fires.get(idx, 0)
            if max_fires is not None and n >= int(max_fires):
                return False
            self._fires[idx] = n + 1
            self.log.append((point, key))
        log.warning("fault injected: %s %s (rule %d)", point, key, idx)
        return True

    def _matching(self, point: str, job, stage, partition, attempt):
        for idx, r in enumerate(self.rules):
            if r["point"] != point:
                continue
            if not self._match_scalar(r.get("job"), job):
                continue
            if not self._match_scalar(r.get("stage"), stage):
                continue
            if not self._match_scalar(r.get("partition"), partition):
                continue
            if not self._match_scalar(r.get("attempt"), attempt):
                continue
            yield idx, r

    # -- injection points ----------------------------------------------------
    def on_task_start(
        self, job_id: str, stage_id: int, partition: int, attempt: int
    ) -> None:
        key = (job_id, stage_id, partition, attempt)
        for idx, r in self._matching(
            "task_crash", job_id, stage_id, partition, attempt
        ):
            if not self._fire(idx, r, "task_crash", key):
                continue
            err = r.get("error", "injected task crash")
            if err == "plan":
                from ballista_tpu_torch.errors import PlanVerificationError

                raise PlanVerificationError(
                    f"injected deterministic plan error at {key}"
                )
            raise InjectedFault(f"injected task crash at {key}: {err}")

    def on_fetch_attempt(
        self, job_id: str, stage_id: int, partition: int, attempt: int
    ) -> None:
        key = (job_id, stage_id, partition, attempt)
        for idx, r in self._matching(
            "fetch_slow", job_id, stage_id, partition, attempt
        ):
            if self._fire(idx, r, "fetch_slow", key):
                time.sleep(float(r.get("delay_s", 0.1)))
        for idx, r in self._matching(
            "fetch_error", job_id, stage_id, partition, attempt
        ):
            if self._fire(idx, r, "fetch_error", key):
                raise InjectedFetchError(
                    f"injected fetch failure at {key}"
                )

    def on_serve_batch(
        self,
        job_id: str,
        stage_id: int,
        partition: int,
        batch_index: int,
        path: str = "",
    ) -> None:
        """Flight service, per batch SERVED from a shuffle file: a matching
        ``producer_kill`` rule breaks the stream once ``after_batches``
        batches already flowed to the consumer — the producer-dies-
        mid-stream shape (the consumer has real partial data; the rest of
        that output must be recomputed). Keyed by the PRODUCING (job,
        stage, output partition); pair with a heartbeat_blackout or
        ``StandaloneCluster.kill_executor`` to take the whole executor
        down, not just one stream."""
        for idx, r in enumerate(self.rules):
            if r["point"] != "producer_kill":
                continue
            if not self._match_scalar(r.get("job"), job_id):
                continue
            if not self._match_scalar(r.get("stage"), stage_id):
                continue
            if not self._match_scalar(r.get("partition"), partition):
                continue
            if batch_index < int(r.get("after_batches", 1)):
                continue
            # the serving file path rides in the key so a chaos test can
            # identify WHICH executor's stream broke (and kill it); rule
            # matching never looks at it, so determinism is unaffected
            key = (job_id, stage_id, partition, batch_index, path)
            if self._fire(idx, r, "producer_kill", key):
                raise InjectedFault(
                    f"injected producer kill mid-stream at {key}"
                )

    def on_rewrite_validate(self, job_id: str, stage_id: int) -> None:
        """Scheduler certificate-validation gate
        (SchedulerServer.apply_certified_rewrite): a matching
        ``rewrite_reject`` rule fails validation with the typed
        RewriteRejected the real gate raises, exercising the
        reject-and-fall-back-to-pristine-template path (the job must
        still complete, on the unrewritten plan). Keyed by (job, stage);
        ``partition``/``attempt`` do not apply."""
        key = (job_id, stage_id)
        for idx, r in self._matching(
            "rewrite_reject", job_id, stage_id, None, None
        ):
            if self._fire(idx, r, "rewrite_reject", key):
                from ballista_tpu_torch.errors import RewriteRejected

                raise RewriteRejected(
                    f"injected certificate rejection at {key}",
                    clause=r.get("clause", "injected"),
                    stage_ids=(stage_id,),
                )

    def heartbeat_suppressed(self, executor_id: str) -> bool:
        for idx, r in enumerate(self.rules):
            if r["point"] != "heartbeat_blackout":
                continue
            if not self._match_executor(r.get("executor"), executor_id):
                continue
            if self._fire(idx, r, "heartbeat_blackout", (executor_id,)):
                return True
        return False


# -- module-level switch (zero-cost when disabled) ---------------------------
_INJECTOR: FaultInjector | None = None
_ENV_LOADED = False
_ENV_LOCK = threading.Lock()


def install(rules: list[dict] | None, seed: int = 0) -> None:
    """Programmatic install (tests); ``rules=None`` disables injection."""
    global _INJECTOR, _ENV_LOADED
    with _ENV_LOCK:
        _INJECTOR = FaultInjector(rules, seed) if rules else None
        _ENV_LOADED = True  # explicit install wins over the env


def _load_env() -> None:
    global _INJECTOR, _ENV_LOADED
    with _ENV_LOCK:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
        spec = os.environ.get(ENV_FAULTS, "")
        if not spec:
            return
        try:
            rules = json.loads(spec)
            seed = int(os.environ.get(ENV_SEED, "0"))
            _INJECTOR = FaultInjector(rules, seed)
            log.warning(
                "fault injection ENABLED: %d rules, seed=%d", len(rules), seed
            )
        except Exception:  # noqa: BLE001 — a bad spec must not take the
            # process down; it just means no injection
            log.exception("invalid %s spec ignored", ENV_FAULTS)


def active() -> FaultInjector | None:  # racelint: disable=unguarded-field
    """The installed injector, or None. First call parses the env; after
    that the disabled path is a single global read.

    Deliberate double-checked read of ``_ENV_LOADED``/``_INJECTOR``
    outside ``_ENV_LOCK`` (the racelint suppression above): this sits on
    every task/fetch/heartbeat hot path, so the disabled case must stay a
    lone global load. ``_load_env`` re-checks under the lock, and both
    globals only ever transition once (False->True, None->injector), so a
    stale read is benign — GIL-visible by the next call."""
    if not _ENV_LOADED:
        _load_env()
    return _INJECTOR


def enabled() -> bool:
    return active() is not None
