"""Adaptive query execution: the POLICY layer over certified rewrites
(port of ``ballista_tpu/scheduler/aqe.py``, with its thresholds, store,
rules and narration).

The scheduler ships per-operator runtime stats, the certified-rewrite
safety substrate (``ballista_tpu_torch/rewrite.py`` +
``SchedulerServer.apply_certified_rewrite``) and a skew monitor that flags
hot partitions — this module is the brain that READS those signals and
DECIDES which certified rewrite to apply when. It never mutates a plan
itself: every adaptation goes through ``apply_certified_rewrite`` (the
eqlint closure stays intact), so an adaptation the certificate cannot
prove safe is REJECTED with its failing clause and the job proceeds on
the pristine template — the policy may be wrong, the plan may not.

Two decision points, one rule set:

- **Reactive (StageFinished)** — ``on_stage_finished`` runs BEFORE a
  dependent stage is promoted: the completed producers' shuffle-write
  metas give exact per-bucket rows/bytes, and the consumer is still
  fully PENDING, so a rewrite that touches ONLY the consumer (the
  build-side flip) can apply mid-job. Rewrites that re-bucket a producer
  (broadcast/coalesce/split) cannot apply here — the producer just
  completed, and the runtime precondition (touched stages fully pending)
  correctly rejects them — so those decisions are LEARNED instead.
- **Proactive (submission)** — ``on_job_submitted`` applies the learned
  strategies for the job's query class (obs/qclass.py) right after stage
  generation, while every stage is still pending: split a skew-flagged
  consumer's buckets, coalesce tiny ones toward
  ``ballista.tpu.aqe_target_partition_mb``, broadcast a build side that
  measured under ``ballista.tpu.aqe_broadcast_threshold_mb``, flip a
  misestimated build. Strategies persist through the plan-hint file
  (``compilecache/hints.py`` — the same ``plan_hints.json``, an
  ``("aqe", <class>)`` key family), so a FRESH process plans adaptively
  from the first submission of a known query class.

Every decision — applied, rejected (with the certificate clause), or
learned — is recorded on the job (``JobInfo.aqe_decisions``, served by
``GET /api/job/<id>``), as an ``aqe`` trace event with before/after
stats, in the ``ballista_aqe_rewrites_total{op,outcome}`` Prometheus
family, and in the job's terminal history record. A rejection of a
learned strategy whose certificate clause failed (not a transient
runtime-state race) UNLEARNS it, so a stale strategy self-heals into one
extra no-op submission rather than a permanent reject loop. All
adaptations stay inside the declared device programs by construction:
the certificate's compile-vocab clause is part of acceptance.
"""

from __future__ import annotations

import logging
import os

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.errors import RewriteRejected

log = logging.getLogger(__name__)

# decision thresholds (module constants, not knobs: they shape WHEN the
# knob-declared byte thresholds apply, and sweeping them is a bench
# exercise, not a deployment one)
FLIP_FACTOR = 2.0  # observed build > k x observed probe
FLIP_EST_FACTOR = 4.0  # observed build > k x ESTIMATED probe (hysteresis)
# noise floors: flipping a tiny build gains nothing and risks plan churn
# (every flip re-shapes a stage -> fresh compile signatures); only
# misestimates that actually cost something are worth acting on
FLIP_MIN_BUILD_BYTES = 1 << 20  # reactive path (exact meta bytes)
FLIP_MIN_BUILD_ROWS = 1 << 16  # metrics path (valid-row counts)
SPLIT_MAX_FACTOR = 8  # bucket-count growth per split decision
SPLIT_BUCKET_CAP = 64  # absolute bucket ceiling a split may reach
MB = 1024 * 1024

# rejection clauses that mean "this strategy is wrong for this plan"
# (unlearn) as opposed to "the job raced past the rewrite window"
# (keep — next submission applies while everything is pending)
_TRANSIENT_CLAUSES = ("runtime-state", "job-state", "injected")
# clauses that are STRUCTURAL per query class — determined by the plan
# shape alone, so a rejection today rejects forever: these also DENY
# the (family, stage) so the observe rules stop re-learning it.
# "op-applicability" is deliberately absent: its preconditions depend
# on session config (a coalesce learned at 16 buckets rejects at 2
# because 2 -> 2 cannot shrink), and a permanent denial would poison
# the class after a one-off config change — those just unlearn, and
# the observe rules re-derive a spec consistent with the current
# config on the next run.
_STRUCTURAL_CLAUSES = (
    "float-sensitivity",
    "schema-equivalence",
    "column-resolution",
    "compile-vocab",
    "partition-compat",
    "stage-dag",
)


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
    ov = env_override()
    if ov is not None:
        return ov
    return cfg.aqe()


# ---------------------------------------------------------------------------
# learned strategies, persisted through the plan-hint file
# ---------------------------------------------------------------------------


class StrategyStore:
    """Per-query-class learned rewrite strategies.

    In-memory map ``{query_class: (spec, ...)}`` where a spec is a plain
    literal tuple — ``("flip", stage_id, occurrence)``,
    ``("broadcast", stage_id, occurrence)``,
    ``("coalesce", stage_id, new_n)``, ``("split", stage_id, new_n)`` —
    persisted via :class:`compilecache.hints.HintStore` under
    ``("aqe", <class>)`` keys in the shared ``plan_hints.json`` (atomic
    merge-under writes; ``BALLISTA_TPU_HINT_CACHE=off`` keeps it
    process-local). Safety is NOT this store's job: stage ids are stable
    for a plan shape (the DistributedPlanner numbers deterministically
    and the class fingerprint is structural), and anything stale is
    caught by server-side re-certification at application time."""

    def __init__(self) -> None:
        self._lock = make_lock("AqeStrategyStore._lock")
        # hints.HintStore API shape: a scalar-hint dict (unused here)
        # plus the keyed entry cache the file round-trips
        self._hint: dict = {}
        self._cache: dict = {}
        from ballista_tpu_torch.compilecache.hints import HintStore

        self._persist = HintStore()

    @staticmethod
    def _is_aqe_key(k) -> bool:
        return (
            isinstance(k, tuple)
            and len(k) == 2
            and k[0] in ("aqe", "aqe_deny")
        )

    def load_once(self) -> int:
        """Merge persisted strategies under in-memory ones (first call
        does the file read; later calls are free). The hint file is
        SHARED with the executor plan caches — every foreign key family
        (join flags, capacities) is pruned after the load: keeping a
        stale snapshot here would write it back on the next save with
        in-memory-wins semantics, rolling back whatever the real owner
        persisted since (merge-under preserves on-disk keys we simply
        don't carry)."""
        with self._lock:
            hint, cache = self._hint, self._cache
        n = self._persist.load_once(hint, cache)
        with self._lock:
            for k in [k for k in self._cache if not self._is_aqe_key(k)]:
                del self._cache[k]
            self._hint.clear()
        return n

    def get(self, query_class: str) -> tuple:
        """Learned specs for one class, deterministic order."""
        if query_class in ("", "unknown", "overflow"):
            return ()
        with self._lock:
            specs = self._cache.get(("aqe", query_class), ())
        return tuple(sorted(specs))

    @staticmethod
    def _family(kind: str) -> str:
        # split, coalesce, and the nosplit tombstone are ONE family:
        # learning one must drop the others for the same stage, or a
        # later coalesce would silently undo an earlier skew split (and
        # a tombstone must retire the split it reverts)
        return (
            "buckets" if kind in ("split", "coalesce", "nosplit") else kind
        )

    def learn(self, query_class: str, spec: tuple) -> bool:
        """Add one spec (replacing any same-family spec for the same
        stage — a re-observed skew overwrites the previous split target
        rather than stacking). Returns True when the set changed.
        Denied (certificate-rejected) families never re-learn: without
        the deny ledger every submission would re-observe the same
        signal, re-learn the same strategy, and re-reject it — an
        endless propose/reject churn instead of a settled class."""
        if query_class in ("", "unknown", "overflow"):
            return False
        if self.is_denied(query_class, spec[0], spec[1]):
            return False
        key = ("aqe", query_class)
        with self._lock:
            current = tuple(self._cache.get(key, ()))
            kept = tuple(
                s for s in current
                if (self._family(s[0]), s[1])
                != (self._family(spec[0]), spec[1])
            )
            new = tuple(sorted(kept + (spec,)))
            if new == current:
                return False
            self._cache[key] = new
        self._save()
        return True

    def unlearn(self, query_class: str, spec: tuple) -> bool:
        key = ("aqe", query_class)
        with self._lock:
            current = tuple(self._cache.get(key, ()))
            new = tuple(s for s in current if s != spec)
            if new == current:
                return False
            # keep the (possibly empty) entry rather than popping it:
            # HintStore's save merges UNDER the on-disk file (in-memory
            # entries win per key, absent keys are preserved), so a
            # deletion only persists as an overriding empty value
            self._cache[key] = new
        self._save()
        return True

    def deny(self, query_class: str, kind: str, stage_id: int) -> None:
        """Record a STRUCTURAL certificate rejection of a (family,
        stage) strategy for this class: the spec is unlearned by the
        caller and this ledger stops the observe-side rules from
        re-learning it. Callers only deny on clauses determined by the
        plan shape alone (``_STRUCTURAL_CLAUSES`` — those fail every
        time for the class), so denial is permanent and persisted
        beside the strategies; config-dependent rejections merely
        unlearn."""
        if query_class in ("", "unknown", "overflow"):
            return
        key = ("aqe_deny", query_class)
        entry = (self._family(kind), int(stage_id))
        with self._lock:
            current = tuple(self._cache.get(key, ()))
            if entry in current:
                return
            self._cache[key] = tuple(sorted(current + (entry,)))
        self._save()

    def is_denied(self, query_class: str, kind: str, stage_id: int) -> bool:
        with self._lock:
            denied = self._cache.get(("aqe_deny", query_class), ())
        return (self._family(kind), int(stage_id)) in denied

    def _save(self) -> None:
        # take the dict REFS under our lock, write outside it: HintStore
        # serializes + does file IO under its OWN lock (and snapshots
        # the dict against concurrent resize), and holding ours across
        # that would be blocking-under-lock. This runs on the scheduler
        # event-loop thread, but only when a strategy set actually
        # CHANGED (learn/unlearn/deny call it on change only, and
        # save_if_changed fingerprint-debounces besides) — a class
        # learns a handful of times and then settles, so steady state
        # does zero IO here.
        with self._lock:
            hint, cache = self._hint, self._cache
        self._persist.save_if_changed(hint, cache)

    def classes(self) -> list[str]:
        with self._lock:
            return sorted(
                k[1] for k, v in self._cache.items()
                if isinstance(k, tuple) and len(k) == 2
                and k[0] == "aqe" and v
            )


_STORE: StrategyStore | None = None
_STORE_LOCK = make_lock("aqe._STORE_LOCK")


def strategy_store() -> StrategyStore:
    """The process-wide store (schedulers in one process — standalone
    clusters, tests — share learned strategies, exactly like the
    compile caches they ride beside)."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = StrategyStore()
        return _STORE


def reset_store() -> None:
    """Drop the process store (tests; a fresh store re-reads the hint
    file on its next load_once)."""
    global _STORE
    with _STORE_LOCK:
        _STORE = None


def spec_describe(spec: tuple) -> str:
    kind = spec[0]
    if kind in ("flip", "broadcast"):
        return f"{kind}(stage={spec[1]}, occurrence={spec[2]})"
    if kind == "nosplit":
        return f"nosplit(stage={spec[1]})"
    return f"{kind}(stage={spec[1]}, n={spec[2]})"


def _op_from_spec(spec: tuple):
    from ballista_tpu_torch import rewrite as rw

    kind = spec[0]
    if kind == "flip":
        return rw.FlipJoinBuildSide(int(spec[1]), int(spec[2]))
    if kind == "broadcast":
        return rw.SwitchToBroadcast(int(spec[1]), int(spec[2]))
    if kind == "coalesce":
        return rw.CoalesceShufflePartitions(int(spec[1]), int(spec[2]))
    if kind == "split":
        return rw.SplitShufflePartitions(int(spec[1]), int(spec[2]))
    raise RewriteRejected(
        f"unknown learned strategy kind {kind!r}", clause="op-applicability"
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


def estimate_subtree_bytes(node, observed: dict[int, dict]) -> int | None:
    """Rough byte estimate of a plan subtree from what is knowable
    before it runs: stage reads use their producer's OBSERVED output
    bytes, in-memory scans their Arrow table size, file scans their
    on-disk size; operators pass through the sum of their inputs (an
    upper-ish bound — filters/aggregates only shrink). ``None`` when any
    leaf is unknowable: a wrong estimate must disable the decision, not
    mis-steer it."""
    from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec

    if isinstance(node, UnresolvedShuffleExec):
        stats = observed.get(node.stage_id)
        return None if stats is None else int(stats["bytes"])
    table = getattr(node, "table", None)
    if table is not None and hasattr(table, "nbytes") and not node.children():
        return int(table.nbytes)
    paths = getattr(node, "paths", None) or (
        [node.path] if getattr(node, "path", None) else None
    )
    if paths and not node.children():
        try:
            return sum(os.path.getsize(p) for p in paths)
        except OSError:
            return None
    if not node.children():
        return None
    total = 0
    for c in node.children():
        est = estimate_subtree_bytes(c, observed)
        if est is None:
            return None
        total += est
    return total


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


# ---------------------------------------------------------------------------
# decision rules (pure — unit-testable without a scheduler)
# ---------------------------------------------------------------------------


def decide_bucket_strategy(
    buckets: dict[int, tuple[int, int]],
    current_n: int,
    skew_ratio: float,
    skew_min_rows: int,
    target_partition_mb: int,
) -> tuple | None:
    """Split-vs-coalesce over one consumer's observed input buckets.

    Skew first: a bucket whose rows exceed ``skew_ratio`` x the bucket
    median (above the noise floor) wants MORE buckets — grow by the
    observed imbalance (bounded). Otherwise, when the whole input would
    fit in fewer ``target_partition_mb`` buckets, shrink to that ideal —
    fuller buckets amortize per-task costs. Balanced, right-sized input
    decides nothing."""
    import statistics

    if current_n < 1 or len(buckets) < 2:
        return None
    rows = [buckets.get(i, (0, 0))[0] for i in range(current_n)]
    nbytes = sum(buckets.get(i, (0, 0))[1] for i in range(current_n))
    med = statistics.median(rows)
    peak = max(rows)
    if skew_ratio > 0 and med > 0 and peak >= skew_min_rows and (
        peak > skew_ratio * med
    ):
        factor = min(SPLIT_MAX_FACTOR, max(2, int(peak // max(1, med))))
        new_n = min(SPLIT_BUCKET_CAP, current_n * factor)
        if new_n > current_n:
            return ("split", new_n)
        return None
    if target_partition_mb > 0:
        ideal = max(1, -(-nbytes // (target_partition_mb * MB)))
        if ideal < current_n:
            return ("coalesce", ideal)
    return None


def find_collect_joins(plan) -> list[tuple[int, object]]:
    """``(occurrence, node)`` for collect-mode INNER hash joins, with
    occurrence counted over ALL hash joins in preorder — the exact
    addressing :class:`rewrite.FlipJoinBuildSide` resolves."""
    from ballista_tpu_torch.exec.joins import HashJoinExec
    from ballista_tpu_torch.plan.logical import JoinType
    from ballista_tpu_torch.rewrite import find_nodes

    out = []
    for i, j in enumerate(
        find_nodes(plan, lambda p: isinstance(p, HashJoinExec))
    ):
        if j.join_type == JoinType.INNER and j.partition_mode == "collect":
            out.append((i, j))
    return out


def find_partitioned_joins(plan) -> list[tuple[int, object]]:
    """``(occurrence, node)`` with occurrence counted over PARTITIONED
    hash joins only — :class:`rewrite.SwitchToBroadcast` addressing."""
    from ballista_tpu_torch.exec.joins import HashJoinExec
    from ballista_tpu_torch.rewrite import find_nodes

    return list(
        enumerate(
            find_nodes(
                plan,
                lambda p: isinstance(p, HashJoinExec)
                and p.partition_mode == "partitioned",
            )
        )
    )


# ---------------------------------------------------------------------------
# the policy engine
# ---------------------------------------------------------------------------


class AqePolicy:
    """Decision engine bound to one :class:`SchedulerServer`.

    Hooks (all exception-guarded by the caller — adaptation must never
    outrank the scheduling it advises):

    - ``on_job_submitted(job)`` — right after stage generation: apply
      this class's learned strategies while every stage is pending.
    - ``on_stage_finished(job, stage_id, ready)`` — before promotion of
      the ``ready`` consumers: reactive flip + learn bucket/broadcast
      strategies from the completed producers' exact output stats.
    - ``on_job_finished(job)`` — learn build-side flips from the shipped
      per-operator metrics (the only place an INLINE probe side's true
      size is measured)."""

    def __init__(self, server) -> None:
        self.server = server
        self.store = strategy_store()

    # -- shared plumbing -----------------------------------------------------
    def _cfg(self, job):
        return self.server._session_config(job.session_id)

    def _record(
        self,
        job,
        kind: str,
        outcome: str,
        stage_ids: tuple,
        *,
        clause: str = "",
        source: str = "",
        before: dict | None = None,
        after: dict | None = None,
        detail: str = "",
    ) -> None:
        self.server.record_aqe_decision(
            job,
            {
                "op": kind,
                "outcome": outcome,  # applied | rejected | learned
                "stage_ids": sorted(int(s) for s in stage_ids),
                "clause": clause,
                "source": source,  # reactive | learned
                "before": dict(before or {}),
                "after": dict(after or {}),
                "detail": detail,
            },
        )

    def _apply(
        self,
        job,
        kind: str,
        op,
        spec: tuple | None,
        source: str,
        before: dict,
        after: dict,
    ) -> bool:
        """One adaptation through the sanctioned gate. Returns True when
        the rewrite was ACCEPTED; a rejection records the failing clause
        and (for a learned strategy whose certificate genuinely failed)
        unlearns the spec so it cannot reject forever."""
        try:
            cert = self.server.apply_certified_rewrite(job.job_id, op)
        except RewriteRejected as e:
            self._record(
                job, kind, "rejected", e.stage_ids or (),
                clause=e.clause, source=source, before=before, after=after,
                detail=str(e),
            )
            if spec is not None and e.clause not in _TRANSIENT_CLAUSES:
                self.store.unlearn(job.query_class, spec)
                if e.clause in _STRUCTURAL_CLAUSES:
                    self.store.deny(job.query_class, spec[0], spec[1])
                log.warning(
                    "aqe: unlearned%s %s for class %s (%s)",
                    "+denied" if e.clause in _STRUCTURAL_CLAUSES else "",
                    spec_describe(spec), job.query_class, e.clause,
                )
            return False
        except Exception:  # noqa: BLE001 — policy failure must never
            # fail the job it advises
            log.exception("aqe: rewrite application failed for %s", kind)
            return False
        self._record(
            job, kind, "applied",
            cert.rewritten_stages + cert.added_stages,
            source=source, before=before, after=after,
            detail=cert.summary(),
        )
        return True

    # -- submission: learned strategies --------------------------------------
    def wants_to_adapt(self, job) -> bool:
        """True when this class has applicable learned strategies — the
        scheduler then submits leaf stages PENDING-first so a polling
        executor cannot claim a task in the submission/rewrite gap and
        spuriously close the rewrite window (runtime-state)."""
        if not enabled(self._cfg(job)):
            return False
        self.store.load_once()
        return any(
            sp[0] != "nosplit" for sp in self.store.get(job.query_class)
        )

    def on_job_submitted(self, job) -> None:
        cfg = self._cfg(job)
        if not enabled(cfg):
            return
        self.store.load_once()
        for spec in self.store.get(job.query_class):
            if spec[0] == "nosplit":
                # a tombstone, not an op: "splitting stage N did not
                # shrink its hot bucket — stop re-proposing it"
                continue
            try:
                op = _op_from_spec(spec)
            except RewriteRejected as e:
                self._record(
                    job, spec[0], "rejected", (spec[1],),
                    clause=e.clause, source="learned", detail=str(e),
                )
                self.store.unlearn(job.query_class, spec)
                continue
            self._apply(
                job, spec[0], op, spec, "learned",
                {"strategy": spec_describe(spec)}, {},
            )

    # -- StageFinished: reactive + learning ----------------------------------
    def on_stage_finished(
        self, job, stage_id: int, ready_stats: dict[int, dict]
    ) -> None:
        """``ready_stats``: pending consumer stage id -> that consumer's
        :func:`producer_stats`, for the consumers whose producers are
        all complete — the stages the caller is about to promote (the
        caller computed the stats once and shares them with the skew
        pass)."""
        cfg = self._cfg(job)
        if not enabled(cfg):
            return
        for consumer_id in sorted(ready_stats):
            with self.server._lock:
                stage = job.stages.get(consumer_id)
                plan = stage.plan if stage is not None else None
            if plan is None:
                continue
            stats = ready_stats[consumer_id]
            self._maybe_flip(job, consumer_id, plan, stats, cfg)
            self._learn_buckets(job, consumer_id, plan, stats, cfg)
            self._learn_broadcast(job, consumer_id, plan, stats, cfg)

    def _maybe_flip(self, job, consumer_id, plan, stats, cfg) -> None:
        """Reactive build-side flip: the ONLY rewrite whose touched set
        is exactly the still-pending consumer, so it can apply mid-job.
        Compares the OBSERVED build-producer output against the probe
        side (observed when it is a stage read, estimated from
        scan/table sizes otherwise — estimation uses a wider hysteresis
        factor)."""
        from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec

        applied_any = False
        for occurrence, join in find_collect_joins(plan):
            if applied_any:
                # one flip re-shapes the plan; re-decide on the next
                # signal rather than stacking occurrences on a stale tree
                break
            build = join.right
            if not isinstance(build, UnresolvedShuffleExec):
                continue
            bstats = stats.get(build.stage_id)
            if bstats is None or bstats["bytes"] < FLIP_MIN_BUILD_BYTES:
                continue
            build_bytes = bstats["bytes"]
            if isinstance(join.left, UnresolvedShuffleExec):
                pstats = stats.get(join.left.stage_id)
                probe_bytes = None if pstats is None else pstats["bytes"]
                factor = FLIP_FACTOR
            else:
                probe_bytes = estimate_subtree_bytes(join.left, stats)
                factor = FLIP_EST_FACTOR
            if probe_bytes is None or build_bytes <= factor * probe_bytes:
                continue
            from ballista_tpu_torch import rewrite as rw

            before = {
                "build_bytes": int(build_bytes),
                "probe_bytes": int(probe_bytes),
            }
            after = {
                "build_bytes": int(probe_bytes),
                "probe_bytes": int(build_bytes),
            }
            # remember the misestimate either way: the next submission
            # of this class flips at planning time
            spec = ("flip", consumer_id, occurrence)
            learned_now = self.store.learn(job.query_class, spec)
            if not self.server.stage_manager.all_tasks_pending(
                job.job_id, consumer_id
            ):
                # eager-shuffle handout already started this pending
                # stage's tasks — the mid-job rewrite window is closed
                # (rebind would reject on runtime-state), so defer to
                # the learned strategy instead of burning a certify
                if learned_now:
                    self._record(
                        job, "flip", "learned", (consumer_id,),
                        source="reactive", before=before, after=after,
                        detail="rewrite window closed by eager tasks; "
                        f"learned for class={job.query_class}",
                    )
                continue
            op = rw.FlipJoinBuildSide(consumer_id, occurrence)
            applied_any = self._apply(
                job, "flip", op, spec, "reactive", before, after,
            )

    def _learn_buckets(self, job, consumer_id, plan, stats, cfg) -> None:
        """Split/coalesce decisions over the consumer's observed input
        buckets. These re-bucket producers that JUST completed, so they
        cannot apply mid-job (the pending-stages precondition would —
        correctly — reject them); they are learned for the next
        submission of this query class."""
        with self.server._lock:
            buckets, keyed = keyed_bucket_totals(job, stats)
        if not keyed:
            return
        with self.server._lock:
            stage = job.stages.get(consumer_id)
            current_n = (
                stage.input_partition_count if stage is not None else 0
            )
        prior = next(
            (
                s for s in self.store.get(job.query_class)
                if StrategyStore._family(s[0]) == "buckets"
                and s[1] == consumer_id
            ),
            None,
        )
        if prior is not None and prior[0] == "nosplit":
            return
        decision = decide_bucket_strategy(
            buckets,
            current_n,
            cfg.skew_ratio(),
            cfg.skew_min_rows(),
            cfg.aqe_target_partition_mb(),
        )
        peak = max(
            buckets.get(i, (0, 0))[0] for i in range(max(1, current_n))
        )
        if prior is not None and prior[0] == "split" and (
            current_n >= prior[2]
        ):
            # the plan ran AT our learned split count: judge it, never
            # escalate. Escalation chases an asymptote — a hot bucket
            # that is ONE irreducible key keeps tripping the ratio at
            # any count (same hash -> same bucket), and even a genuine
            # rebalance keeps the top key's mass in one bucket — so the
            # split either HELPED (hot bucket shrank: freeze it exactly
            # as learned) or it didn't (revert and tombstone so the
            # class settles instead of oscillating relearn/revert).
            prev_peak = prior[3] if len(prior) > 3 else 0
            if decision is not None and decision[0] == "split" and (
                not prev_peak or peak >= 0.8 * prev_peak
            ):
                self.store.learn(
                    job.query_class, ("nosplit", consumer_id, 0)
                )
                self._record(
                    job, "split", "reverted", (consumer_id,),
                    source="reactive",
                    before={"buckets": current_n, "max_rows": int(peak)},
                    after={"max_rows_at_fewer_buckets": int(prev_peak)},
                    detail="split did not shrink the hot bucket "
                    "(irreducible hot key); tombstoned for this class",
                )
            return
        if decision is None:
            return
        kind, new_n = decision
        spec = (
            (kind, consumer_id, new_n, int(peak))
            if kind == "split"
            else (kind, consumer_id, new_n)
        )
        if self.store.learn(job.query_class, spec):
            rows = [buckets.get(i, (0, 0))[0] for i in range(current_n)]
            self._record(
                job, kind, "learned", (consumer_id,), source="reactive",
                before={
                    "buckets": current_n,
                    "max_rows": max(rows) if rows else 0,
                    "total_bytes": sum(
                        buckets.get(i, (0, 0))[1] for i in range(current_n)
                    ),
                },
                after={"buckets": new_n},
                detail=f"class={job.query_class}",
            )

    def _learn_broadcast(self, job, consumer_id, plan, stats, cfg) -> None:
        """A partitioned join whose build side measured under the
        broadcast threshold re-plans collect-mode next run — the build
        producer writes ONE partition every probe task collects whole,
        instead of hash-scattering both sides."""
        from ballista_tpu_torch.distributed_plan import UnresolvedShuffleExec

        threshold = cfg.aqe_broadcast_threshold_mb() * MB
        if threshold <= 0:
            return
        for occurrence, join in find_partitioned_joins(plan):
            build = join.right
            if not isinstance(build, UnresolvedShuffleExec):
                continue
            bstats = stats.get(build.stage_id)
            if bstats is None or not (0 < bstats["bytes"] < threshold):
                continue
            spec = ("broadcast", consumer_id, occurrence)
            if self.store.learn(job.query_class, spec):
                self._record(
                    job, "broadcast", "learned", (consumer_id,),
                    source="reactive",
                    before={"build_bytes": int(bstats["bytes"])},
                    after={"threshold_bytes": int(threshold)},
                    detail=f"class={job.query_class}",
                )

    # -- job completion: learn flips needing executed-operator metrics -------
    def on_job_finished(self, job) -> None:
        """Collect-join flips whose probe side ran INLINE (a scan
        subtree) can only be sized from the shipped per-operator metrics
        — compare each collect join's measured child outputs and learn
        the flip when the build side was the larger one. The plans in
        ``job.stages`` are the templates that actually RAN (any accepted
        rewrite already swapped them), so a flipped join measures
        build < probe and learns nothing — no flip-flopping."""
        cfg = self._cfg(job)
        if not enabled(cfg):
            return
        from ballista_tpu_torch.obs.profile import walk_paths

        with self.server._lock:
            stages = {
                sid: s.plan for sid, s in sorted(job.stages.items())
            }
            op_metrics = dict(job.op_metrics)
        # measured ROWS per (stage, operator path), summed across the
        # stage's partitions. Rows, not the shipped output_bytes: those
        # meter capacity-PADDED device residency (a 100-row dimension
        # batch padded to a 2M-row capacity reads as gigabytes), which
        # at small scale flagged flips backwards on every TPC-H join
        by_path: dict[tuple[int, str], float] = {}
        parts_of: dict[int, set] = {}
        for (sid, part), records in sorted(op_metrics.items()):
            parts_of.setdefault(sid, set()).add(part)
            for r in records:
                v = r.get("counters", {}).get("output_rows")
                if isinstance(v, (int, float)):
                    key = (sid, r["path"])
                    by_path[key] = by_path.get(key, 0) + float(v)
        if not by_path:
            return
        # per-TASK means, not cross-task sums: a collect join's build
        # reader re-reads the whole collected side in EVERY task, so a
        # 4-task stage reports 4x the build rows — comparing sums would
        # inflate build-vs-probe by the task count
        for (sid, path) in list(by_path):
            by_path[(sid, path)] /= max(1, len(parts_of.get(sid, ())))
        for sid in sorted(stages):
            plan = stages[sid]
            join_paths = {
                id(node): path for path, node in walk_paths(plan)
            }
            for occurrence, join in find_collect_joins(plan):
                jp = join_paths.get(id(join))
                if jp is None:
                    continue
                probe = by_path.get((sid, jp + ".0"))
                build = by_path.get((sid, jp + ".1"))
                if not probe or not build:
                    continue
                if build < FLIP_MIN_BUILD_ROWS or (
                    build <= FLIP_FACTOR * probe
                ):
                    continue
                spec = ("flip", sid, occurrence)
                if self.store.learn(job.query_class, spec):
                    self._record(
                        job, "flip", "learned", (sid,), source="reactive",
                        before={
                            "build_rows": int(build),
                            "probe_rows": int(probe),
                        },
                        after={},
                        detail=f"class={job.query_class}",
                    )


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE narration
# ---------------------------------------------------------------------------


def narrate(ctx, optimized) -> str:
    """One EXPLAIN ANALYZE line: the query's distributed class token,
    whether AQE would act on it, and the learned strategies a submission
    would apply (docs/aqe.md). Never raises — narration is advisory."""
    try:
        state = "on" if enabled(ctx.config) else "off"
        store = strategy_store()
        store.load_once()
        if state == "off" and not store.classes():
            # the class token needs a full distributed planning pass;
            # don't pay it on a profiling verb when AQE is off and this
            # process has learned nothing to narrate
            return (
                "aqe=off: no learned strategies in this process (enable "
                "ballista.tpu.aqe to adapt; the distributed query class "
                "is computed when AQE is on or strategies exist)"
            )
        from ballista_tpu_torch.exec.planner import PhysicalPlanner
        from ballista_tpu_torch.obs.qclass import plan_class

        phys = PhysicalPlanner(
            ctx,
            ctx.config.default_shuffle_partitions(),
            config=ctx.config,
            distributed=True,
        ).plan(optimized)
        qclass = plan_class(phys)
        specs = store.get(qclass)
        if not specs:
            return (
                f"aqe={state} class={qclass}: no learned strategies "
                "(first run observes; later runs adapt from submission)"
            )
        return (
            f"aqe={state} class={qclass}: would apply "
            + "; ".join(spec_describe(s) for s in specs)
        )
    except Exception as e:  # noqa: BLE001 — a profiling verb must not
        # die on its narration
        log.debug("aqe narration failed", exc_info=True)
        return f"aqe: narration unavailable ({type(e).__name__}: {e})"
