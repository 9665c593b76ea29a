"""ExecutionPlan protocol, partitioning, task context, metrics.

The port of ``ballista_tpu/exec/base.py``: ``schema()``,
``output_partitioning()``, ``execute(partition, ctx)`` streaming
DeviceBatches, per-operator metrics, the task context that carries the
device, the deferred device checks, the plan-cache speculation protocol
and the attempt's grace-hash spill files, the retry loop
``run_with_capacity_retry``, ``plan_counters`` and ``execute_to_batches``.
``replace_children`` rebinds an operator's children (the stage splitter
and ``remove_unresolved_shuffles`` use it). Not ported: the reference's
JAX profiler branch (``ballista.tpu.profile_dir``, ROADMAP queue 1, item
10b).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator

import torch

from ballista_tpu_torch.columnar.batch import DeviceBatch, resolve_device
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.expr import logical as L


@dataclasses.dataclass(frozen=True)
class UnknownPartitioning:
    n: int


@dataclasses.dataclass(frozen=True, eq=False)
class HashPartitioning:
    exprs: tuple[L.Expr, ...]
    n: int


Partitioning = UnknownPartitioning | HashPartitioning


@dataclasses.dataclass
class TaskContext:
    """Per-task runtime state: the session config, the device every batch
    of the task lives on (the card unless the caller asks for the CPU), the
    deferred device checks, and the plan-cache speculation protocol."""

    config: BallistaConfig = dataclasses.field(default_factory=BallistaConfig)
    device: torch.device | str = "cuda"
    session_id: str = ""
    job_id: str = ""
    # where a shuffle-writing task puts its files (and its spills, unless
    # ballista.tpu.spill_dir names a directory); empty in local contexts
    work_dir: str = ""
    # After an aggregate overflowed its group capacity, the retry runs with
    # this capacity (it wins over the configured one).
    agg_capacity_override: int | None = None
    # Capacities that earlier retries grew at other sites, by site key (a
    # join's m:n expansion: ("expand_cap", the join's plan, its build key,
    # kind, partition) -> output rows). Each site grows alone; none moves
    # the aggregates'.
    site_capacity: dict = dataclasses.field(default_factory=dict)
    # Deferred on-device error flags (bool scalars). Reading a scalar waits
    # for the device, so operators queue their checks here and the task
    # boundary fetches them all at once (raise_deferred), instead of one
    # sync per batch.
    deferred_checks: list = dataclasses.field(default_factory=list)
    # Cross-run plan-shape cache (join build flags, probe-table sizes,
    # decimal scales), owned by the context and shared across queries.
    # Entries are speculative: every use queues a validation flag through
    # defer_speculation; a fired flag discards the run, and the retry loop
    # retries without the stale entries.
    plan_cache: dict | None = None
    # validation flags of plan_cache entries: (flag, message, cache keys)
    speculative_checks: list = dataclasses.field(default_factory=list)
    # (cache key, value, is_bool) written to plan_cache at a clean task
    # boundary (see defer_learn)
    learned_values: list = dataclasses.field(default_factory=list)
    # callables run at a clean task boundary only (see defer_commit)
    clean_commits: list = dataclasses.field(default_factory=list)
    # Per-attempt scratch, fresh on every attempt. ``"synced_caps"`` holds
    # the plan-cache keys that this run has already decided by a host sync
    # (exec/shrink.py): later batches of the same run keep deciding them
    # instead of speculating against a value a smaller earlier batch just
    # wrote, so a site that sees many batches converges. Apart from
    # ``site_capacity``, the capacities earlier retries grew.
    run_state: dict = dataclasses.field(default_factory=dict)
    # Join build tables are kept on plan instances (exec/joins.py); a
    # caller whose instances live for one task only (an executor decodes a
    # fresh plan a task) turns this off, or the shared tally would count
    # tables that die with the task.
    cache_builds: bool = True
    # The attempt's grace-hash SpillManager (exec/spill.py), made on the
    # first spill; run_with_capacity_retry closes it (deleting its files)
    # at every attempt boundary, so a retry never reads stale buckets.
    spill: object | None = None
    # A scheduler-connected executor's poller of published shuffle
    # locations (executor/executor.Executor.shuffle_locations), which eager
    # shuffle and push shuffle need; None elsewhere.
    shuffle_locations: object | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def spill_manager(self):
        """The attempt's SpillManager, made on the first spill, under
        ``ballista.tpu.spill_dir``, else the task's work_dir, else the
        shared temp spill root."""
        if self.spill is None:
            import os

            from ballista_tpu_torch.exec.spill import SpillManager

            base = self.config.spill_dir() or None
            if base is None and self.work_dir:
                base = os.path.join(self.work_dir, self.job_id or "local", "spill")
            self.spill = SpillManager(base, self.config.spill_budget_mb() << 20)
        return self.spill

    def close_spills(self) -> None:
        if self.spill is not None:
            self.spill.close()
            self.spill = None

    def defer_check(self, flag, message: str, required=None, site=None) -> None:
        """Queue a device bool ``flag``; if it is set at the task boundary
        the task fails with ``message``. ``required`` (device int scalar) is
        the capacity that would have sufficed: a check that carries one
        fails with a CapacityError, which the retry loop retries. ``site``
        names the capacity the check guards when it is not the aggregates'
        (a key of ``site_capacity``)."""
        self.deferred_checks.append((flag, message, required, site))

    def defer_speculation(self, flag, message: str, cache_keys: list) -> None:
        """Queue a device bool validating a plan_cache speculation; if it
        is set at the task boundary the task raises SpeculationMiss carrying
        ``cache_keys``, so the retry loop can drop them and run again."""
        self.speculative_checks.append((flag, message, list(cache_keys)))

    def defer_learn(self, cache_key, value) -> None:
        """Queue a value (a device scalar, or a host bool or int) to be
        learned into the plan cache at a clean task boundary. Values for one
        key are AND-ed (bools) or max-ed (ints) across the run's batches;
        nothing is written if the run fails its checks."""
        if self.plan_cache is not None:
            is_bool = isinstance(value, bool) or (
                isinstance(value, torch.Tensor) and value.dtype == torch.bool
            )
            self.learned_values.append((cache_key, value, is_bool))

    def defer_commit(self, fn) -> None:
        """Queue a host-side cache mutation to run only if this task ends
        clean: a run that fails a deferred check may have computed from
        truncated intermediates."""
        self.clean_commits.append(fn)

    def _clear_deferred(self) -> None:
        self.deferred_checks = []
        self.speculative_checks = []
        self.learned_values = []
        self.clean_commits = []

    def raise_deferred(self) -> None:
        """Fetch every queued flag, capacity and learned value in one
        device-to-host copy, then: raise SpeculationMiss if a speculation
        failed (the run's output is invalid whatever else it says), else
        raise on a fired check, else commit the learned values and the
        queued cache mutations."""
        from ballista_tpu_torch.errors import (
            CapacityError,
            ExecutionError,
            SpeculationMiss,
        )

        checks, specs = self.deferred_checks, self.speculative_checks
        learned, commits = self.learned_values, self.clean_commits
        self._clear_deferred()
        queued = (
            [f for f, _, _, _ in checks]
            + [0 if r is None else r for _, _, r, _ in checks]
            + [f for f, _, _ in specs]
            + [v for _, v, _ in learned]
        )
        got: list[int] = []
        if queued:
            got = torch.stack(
                [torch.as_tensor(v, device=self.device).reshape(()).to(torch.int64) for v in queued]
            ).tolist()
        n, ns = len(checks), len(specs)
        flags, reqs = got[:n], got[n : 2 * n]
        spec_flags, values = got[2 * n : 2 * n + ns], got[2 * n + ns :]
        spec_fired = [(m, keys) for (_, m, keys), f in zip(specs, spec_flags) if f]
        if spec_fired:
            raise SpeculationMiss(
                "; ".join(dict.fromkeys(m for m, _ in spec_fired)),
                invalid_keys=[k for _, keys in spec_fired for k in keys],
            )
        fired = [
            (m, r, req, site)
            for (_, m, req, site), f, r in zip(checks, flags, reqs) if f
        ]
        if fired:
            msg = "; ".join(dict.fromkeys(m for m, _, _, _ in fired))
            if any(req is not None for _, _, req, _ in fired):
                sites: dict = {}
                for _, r, req, site in fired:
                    if req is not None and site is not None:
                        sites[site] = max(sites.get(site, 0), r)
                agg = [r for _, r, req, site in fired if req is not None and site is None]
                raise CapacityError(msg, required=max(agg, default=0), sites=sites)
            raise ExecutionError(msg)
        for fn in commits:
            fn()
        if self.plan_cache is None:
            return
        for (key, _, is_bool), v in zip(learned, values):
            prev = self.plan_cache.get(key)
            if is_bool:
                # one batch that says no vetoes the fast path
                self.plan_cache[key] = bool(v) if prev is None else (prev and bool(v))
            elif isinstance(key, tuple) and key and key[0] == "dec_sum_last":
                # merge-site decimal scales replace rather than max: the
                # first run's merge inputs are inexact float partials and
                # would otherwise veto forever; each run re-learns from its
                # own inputs until they are exact
                self.plan_cache[key] = v
            else:
                # capacities and scales cover every batch
                self.plan_cache[key] = v if prev is None else max(prev, v)


# Ceiling of the adaptive aggregate-capacity growth (groups), as in the
# reference. Beyond it a query needs a hash-repartitioned aggregate.
AGG_CAPACITY_HARD_MAX = 1 << 25

# Bound of a long-lived plan-strategy cache, as in the reference.
PLAN_CACHE_MAX_ENTRIES = 4096

# Keys eviction never removes (the reference's: the shared tally of the
# join build-table cache is an accounting cell, not a learned strategy).
_PLAN_CACHE_STICKY = ("__build_cache_bytes__",)

# Plan-cache evictions of this process: passes that evicted, and entries
# evicted (the reference meters both through its compile-cache metrics).
plan_cache_evictions = {"flushes": 0, "evicted": 0}


def evict_plan_cache(plan_cache: dict, pinned=(), max_entries: int = PLAN_CACHE_MAX_ENTRIES) -> int:
    """Bound ``plan_cache`` by evicting oldest-first (insertion order),
    down to half of ``max_entries`` so that eviction amortizes instead of
    firing on every insert. ``pinned`` keys and the sticky keys survive: a
    task running against a job's snapshot keeps the entries the snapshot
    was taken from. Returns the number of entries evicted."""
    if len(plan_cache) <= max_entries:
        return 0
    keep = set(pinned)
    keep.update(_PLAN_CACHE_STICKY)
    target = max_entries // 2
    evicted = 0
    for k in list(plan_cache):
        if len(plan_cache) <= target:
            break
        if k in keep:
            continue
        del plan_cache[k]
        evicted += 1
    if evicted:
        plan_cache_evictions["flushes"] += 1
        plan_cache_evictions["evicted"] += evicted
    return evicted


# An executor's task threads share its hint dict: what one task learned
# is merged into it under this lock, never replaced by another task's view.
_hint_lock = threading.Lock()


def _remember(hint: dict, agg_capacity: int | None, sites: dict) -> None:
    """Merge one successful run's capacities into ``hint``: the larger
    aggregate capacity, and each site's larger capacity (a hint past
    ``PLAN_CACHE_MAX_ENTRIES`` sites keeps only this run's)."""
    with _hint_lock:
        if agg_capacity is not None:
            hint["agg_capacity"] = max(hint.get("agg_capacity", 0), agg_capacity)
        if sites:
            learned = dict(hint.get("site_capacity", {}))
            if len(learned) + len(sites) > PLAN_CACHE_MAX_ENTRIES:
                learned = {}
            for site, cap in sites.items():
                learned[site] = max(learned.get(site, 0), cap)
            hint["site_capacity"] = learned


def run_with_capacity_retry(
    config: BallistaConfig,
    fn,
    device: torch.device | str = "cuda",
    hint: dict | None = None,
    plan_cache: dict | None = None,
    stats: dict | None = None,
    pinned_cache_keys=(),
    work_dir: str = "",
    job_id: str = "",
    session_id: str = "",
    shuffle_locations=None,
    cache_builds: bool = True,
):
    """The execution loop: build a TaskContext, run ``fn(ctx)``, raise
    the deferred device checks, and retry on two faults:

    - a CapacityError: run again with the capacity that overflowed grown
      to the reported need and snapped to the capacity ladder. An
      aggregate's group capacity (shared by every aggregate of the run) at
      least doubles, up to ``AGG_CAPACITY_HARD_MAX``; a keyed site's (a
      join's expansion) grows alone, to the rows it needed;
    - a SpeculationMiss (a plan-cache entry went stale): drop the stale
      keys and run again.

    Every attempt, whether it succeeds, retries or fails, closes its spill
    manager, deleting its grace-hash bucket files.

    ``hint`` is a caller-owned dict that remembers the capacities a run
    grew to (keys ``"agg_capacity"`` and ``"site_capacity"``), so warm
    re-runs start there instead of overflowing again; concurrent runs
    sharing it (an executor's tasks) merge what they learned. ``stats``, when
    given, counts the retries
    (``"capacity_retries"``, ``"speculation_misses"``). A ``plan_cache``
    grown past ``PLAN_CACHE_MAX_ENTRIES`` is first cut back by
    ``evict_plan_cache``, which keeps ``pinned_cache_keys``. ``work_dir``,
    ``job_id``, ``session_id``, ``shuffle_locations`` and ``cache_builds``
    go to every attempt's TaskContext (a shuffle-writing task's files, an
    executor's poller of published shuffle locations, whether joins keep
    their built tables)."""
    from ballista_tpu_torch.columnar.batch import round_capacity
    from ballista_tpu_torch.config import BALLISTA_PROFILE_DIR
    from ballista_tpu_torch.errors import CapacityError, SpeculationMiss

    config.check_ported(BALLISTA_PROFILE_DIR)

    override: int | None = (hint or {}).get("agg_capacity")
    if override is not None and override <= config.agg_capacity():
        override = None
    sites: dict = dict((hint or {}).get("site_capacity", {}))
    if len(sites) > PLAN_CACHE_MAX_ENTRIES:
        sites.clear()
    if plan_cache is not None:
        evict_plan_cache(plan_cache, pinned=pinned_cache_keys)
    spec_misses = 0
    while True:
        ctx = TaskContext(
            config=config, device=device, agg_capacity_override=override,
            site_capacity=dict(sites), plan_cache=plan_cache,
            work_dir=work_dir, job_id=job_id, session_id=session_id,
            shuffle_locations=shuffle_locations, cache_builds=cache_builds,
        )
        # operators write some plan-cache entries during the run (join
        # build flags, probe-table sizes); a failed attempt may have taken
        # them from truncated intermediates, so it leaves the cache as it
        # found it (the reference keeps them, and pays a speculation miss
        # on the retry)
        before = None if plan_cache is None else dict(plan_cache)
        try:
            out = fn(ctx)
            ctx.raise_deferred()
            if hint is not None:
                _remember(hint, override, sites)
            return out
        except (SpeculationMiss, CapacityError) as e:
            ctx._clear_deferred()
            if plan_cache is not None:
                # the sticky keys keep their current values: a failed
                # attempt committed no build table, and runs that share the
                # cache may have committed or dropped some meanwhile
                sticky = {k: plan_cache[k] for k in _PLAN_CACHE_STICKY if k in plan_cache}
                plan_cache.clear()
                plan_cache.update(before)
                for k in _PLAN_CACHE_STICKY:
                    if k in sticky:
                        plan_cache[k] = sticky[k]
                    else:
                        plan_cache.pop(k, None)
            if isinstance(e, SpeculationMiss):
                if plan_cache is not None:
                    for k in e.invalid_keys:
                        plan_cache.pop(k, None)
                spec_misses += 1
                if stats is not None:
                    stats["speculation_misses"] = stats.get("speculation_misses", 0) + 1
                if spec_misses > 3:  # each retry drops its stale entries;
                    # more means something re-poisons the cache every run
                    raise
                continue
            for site, rows in e.sites.items():
                new_cap = round_capacity(max(rows, 1))
                if new_cap <= sites.get(site, 0):
                    raise  # grown already, and still short
                sites[site] = new_cap
            if e.required > 0 or not e.sites:  # an aggregate overflowed
                base = override or config.agg_capacity()
                need = max(e.required + 1, base * 2)
                new_cap = round_capacity(need)
                if need <= AGG_CAPACITY_HARD_MAX < new_cap:
                    new_cap = AGG_CAPACITY_HARD_MAX
                if new_cap > AGG_CAPACITY_HARD_MAX or (
                    override is not None and new_cap <= override
                ):
                    raise
                override = new_cap
            if stats is not None:
                stats["capacity_retries"] = stats.get("capacity_retries", 0) + 1
        finally:
            ctx.close_spills()


class Metrics:
    """Per-operator counters/timers."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {}
        self.timers: dict[str, float] = {}

    def add(self, name: str, v=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()

    def time(self, name: str):
        return _Timer(self, name)

    def summary(self) -> dict[str, float]:
        """Counters (device scalars resolve here, at report time) and timers
        in float seconds, keys sorted."""
        out: dict[str, float] = {
            k: v if isinstance(v, (int, float)) else int(v)
            for k, v in self.counters.items()
        }
        out.update({k: round(float(v), 6) for k, v in self.timers.items()})
        return dict(sorted(out.items()))

    def format(self) -> str:
        s = self.summary()
        parts = [
            f"{k}={v}s" if k in self.timers else f"{k}={v}" for k, v in s.items()
        ]
        return "[" + ", ".join(parts) + "]"


def plan_counters(plan, names) -> dict[str, int]:
    """The named metric counters summed over a plan tree: the values of
    its most recent run (collect resets the metrics per query)."""
    out = {n: 0 for n in names}

    def walk(p) -> None:
        for n in names:
            v = p.metrics.counters.get(n)
            if v is not None:
                out[n] += int(v)
        for c in p.children():
            walk(c)

    walk(plan)
    return out


class _Timer:
    def __init__(self, m: Metrics, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.timers[self.name] = self.m.timers.get(self.name, 0.0) + (
            time.perf_counter() - self.t0
        )
        return False


class ExecutionPlan:
    """Base physical operator. Subclasses implement ``execute`` returning an
    iterator of DeviceBatch for one output partition."""

    def __init__(self) -> None:
        self.metrics = Metrics()

    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list["ExecutionPlan"]:
        return []

    def output_partitioning(self) -> Partitioning:
        return UnknownPartitioning(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def display(self, with_metrics: bool = False) -> str:
        lines: list[str] = []

        def walk(node: "ExecutionPlan", depth: int) -> None:
            line = "  " * depth + node.describe()
            if with_metrics and (node.metrics.counters or node.metrics.timers):
                line += f"  metrics={node.metrics.format()}"
            lines.append(line)
            for c in node.children():
                walk(c, depth + 1)

        walk(self, 0)
        return "\n".join(lines)


def replace_children(plan: ExecutionPlan, children: list[ExecutionPlan]) -> ExecutionPlan:
    """Rebind an operator's children, in place where one changed (its
    ``input``, ``left``/``right`` or ``inputs`` slot). Callers that need
    copy-on-write pass a ``copy.copy`` of ``plan``
    (``distributed_plan.remove_unresolved_shuffles``)."""
    from ballista_tpu_torch.errors import PlanError

    old = plan.children()
    if len(old) != len(children):
        raise PlanError("child arity mismatch")
    if all(a is b for a, b in zip(old, children)):
        return plan
    # a shrink site names the subtree below it (exec/pipeline.py)
    plan.__dict__.pop("_shrink_sites", None)
    if hasattr(plan, "input") and len(children) == 1:
        plan.input = children[0]
        return plan
    if hasattr(plan, "left") and len(children) == 2:
        plan.left, plan.right = children
        return plan
    if hasattr(plan, "inputs"):
        plan.inputs = list(children)
        return plan
    raise PlanError(f"cannot rebuild {type(plan).__name__} with new children")


def execute_to_batches(plan: ExecutionPlan, ctx: TaskContext) -> list[DeviceBatch]:
    """Every output partition of a plan, run in turn, its batches
    collected."""
    out: list[DeviceBatch] = []
    for p in range(plan.output_partitioning().n):
        out.extend(plan.execute(p, ctx))
    return out
