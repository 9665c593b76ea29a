"""Persisted plan-shape hints: the learned-capacity half of cold start
(port of ``ballista_tpu/compilecache/hints.py``).

Until the adaptive machinery has observed the data, a fresh process
learns join build strategies, decimal scales, probe-table sizes, the
capacity shrink's capacities (``("shrink", site, partition, capacity)``,
0 = do not shrink), the aggregates' clustered-input flags
(``("agg_sorted", ...)``) and their learned state-slice capacities and
prefix flags (``("agg_state_cap", ...)``, ``("agg_state_prefix", ...)``),
and pays the capacity retries of an aggregate that outgrows its group
capacity or a join whose m:n expansion outgrows its output: each retry
runs the whole query again. All of it is process-local state in
``TaskContext.plan_cache`` and the owner's capacity hint, re-derived from
scratch on every restart. This module persists that state.

Safety is inherited, not added: every plan-cache family is either
deferred-validated speculation (a stale entry fires its flag at the task
boundary → ``SpeculationMiss`` → invalidate + re-run, exec/base.py) or
learn-only input, and a capacity hint only starts a run larger, so a hint
file from last week degrades to one extra re-run in the worst case and
can never change results. Keys/values are serialized with ``repr`` and
parsed with ``ast.literal_eval``; an entry that fails the round trip (a
tensor must never reach a clean task boundary, but be defensive) is
silently dropped, as is the reference's ``__build_cache_bytes__`` tally.

Where the port differs: its capacity hint also holds the join expansion
sites' learned capacities (``site_capacity``, see
``run_with_capacity_retry``), and the file keeps them beside
``agg_capacity`` (each site's larger value wins a merge). The hint
directory is ``BALLISTA_TPU_HINT_CACHE`` when set (``off`` disables),
else ``~/.cache/ballista_tpu_torch``: the port's own, never the
reference's jax cache directory, whose plan-cache keys differ.

Layout: one JSON file, ``plan_hints.json``, in the resolved hint dir.
Writes are atomic (tmp + ``os.replace``) and debounced by content
fingerprint; concurrent executors sharing a dir are last-writer-wins,
which is safe for the same reason staleness is. A save reads the hint
without holding ``exec.base``'s hint lock during its file I/O.
"""

from __future__ import annotations

import ast
import json
import logging
import os
import tempfile
import threading

from ballista_tpu_torch.compilecache import metrics

log = logging.getLogger(__name__)

HINT_FILE = "plan_hints.json"
_VERSION = 1
# matches run_with_capacity_retry's in-memory bound; a fuller file would
# just be cleared on load anyway
_MAX_ENTRIES = 4096
# process-local tallies that meter in-process objects — never persisted
_EPHEMERAL_KEYS = frozenset({"__build_cache_bytes__"})


def store_path() -> str | None:
    """Resolved hint-file path, or None when persistence is off."""
    spec = os.environ.get("BALLISTA_TPU_HINT_CACHE", "")
    if not spec:
        spec = os.path.join(
            os.path.expanduser("~"), ".cache", "ballista_tpu_torch"
        )
    if spec == "off":
        return None
    return os.path.join(spec, HINT_FILE)


def _canon(x):
    """Recursively replace numpy scalars with python natives (their repr
    — ``np.True_``, ``np.int64(8)`` — does not literal_eval) so learned
    join flags and capacities survive encoding regardless of which layer
    produced them."""
    if isinstance(x, tuple):
        return tuple(_canon(v) for v in x)
    item = getattr(x, "item", None)
    if item is not None and getattr(x, "ndim", None) == 0:
        return x.item()
    return x


def _encode(x) -> str | None:
    """repr of the canonicalized value when it literal_evals back to an
    equal value, else None."""
    s = repr(_canon(x))
    try:
        return s if ast.literal_eval(s) == x else None
    except (ValueError, SyntaxError, MemoryError, RecursionError):
        return None


class HintStore:
    """One owner's (TorchContext / Executor) handle on the hint file.

    ``load_once`` merges persisted entries under the owner's existing
    state (in-memory learning always wins); ``save_if_changed`` writes
    the owner's current state back when its fingerprint moved. A write
    failure (read-only cache dir) disables further writes for this store
    rather than warning per query.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loaded = False
        self._last_fp: int | None = None
        self._write_failed = False

    def load_once(self, hint: dict, plan_cache: dict) -> int:
        """Merge the hint file into ``hint``/``plan_cache`` (first call
        only; later calls are free no-ops). Returns entries merged."""
        with self._lock:
            if self._loaded:
                return 0
            self._loaded = True
            path = store_path()
            if path is None:
                return 0
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
            except FileNotFoundError:
                return 0
            except (OSError, ValueError) as e:
                log.warning("plan-hint cache unreadable (%s): %s", path, e)
                return 0
            if not isinstance(doc, dict) or doc.get("version") != _VERSION:
                return 0
            n = _merge_hint(
                hint, doc.get("agg_capacity"),
                _decode_sites(doc.get("site_capacity")),
            )
            entries = doc.get("entries")
            if isinstance(entries, dict):
                for ks, vs in entries.items():
                    try:
                        k = ast.literal_eval(ks)
                        v = ast.literal_eval(vs)
                    except (ValueError, SyntaxError, MemoryError,
                            RecursionError):
                        continue
                    if k not in plan_cache:
                        plan_cache[k] = v
                        n += 1
            if n:
                metrics.add("hints_loaded", n)
                log.info(
                    "plan-hint cache: %d entries from %s", n, path
                )
            # fingerprint AFTER the merge: a workload that learns nothing
            # new never rewrites the file
            self._last_fp = _fingerprint(hint, plan_cache)
            return n

    def save_if_changed(self, hint: dict, plan_cache: dict) -> bool:
        """Persist the current state when it differs from the last
        loaded/saved fingerprint. Returns True on a write."""
        with self._lock:
            if self._write_failed:
                return False
            path = store_path()
            if path is None:
                return False
            fp = _fingerprint(hint, plan_cache)
            if fp == self._last_fp:
                return False
            doc = _document(hint, plan_cache)
            # merge UNDER the on-disk state rather than replacing it: the
            # owner's plan cache is cleared by table (re)registration, so
            # a wholesale write after that would destroy every other
            # query's / process's persisted learning; current in-memory
            # entries win per key, agg_capacity takes the max
            try:
                with open(path, encoding="utf-8") as f:
                    prev = json.load(f)
            except (OSError, ValueError):
                prev = None
            if (
                isinstance(prev, dict)
                and prev.get("version") == _VERSION
            ):
                prev_cap = prev.get("agg_capacity")
                if isinstance(prev_cap, int) and prev_cap > (
                    doc["agg_capacity"] or 0
                ):
                    doc["agg_capacity"] = prev_cap
                prev_sites = prev.get("site_capacity")
                if isinstance(prev_sites, dict):
                    for ks, cap in prev_sites.items():
                        if isinstance(cap, int) and cap > doc[
                            "site_capacity"
                        ].get(ks, 0):
                            doc["site_capacity"][ks] = cap
                prev_entries = prev.get("entries")
                if isinstance(prev_entries, dict):
                    merged = dict(prev_entries)
                    merged.update(doc["entries"])
                    if len(merged) > _MAX_ENTRIES:
                        # drop oldest on-disk-only entries first; the
                        # owner's own (newest) entries always survive
                        overflow = len(merged) - _MAX_ENTRIES
                        for k in list(prev_entries):
                            if overflow == 0:
                                break
                            if k not in doc["entries"]:
                                del merged[k]
                                overflow -= 1
                    doc["entries"] = merged
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(path), suffix=".tmp"
                )
                try:
                    with os.fdopen(fd, "w", encoding="utf-8") as f:
                        json.dump(doc, f)
                    os.replace(tmp, path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
            except OSError as e:
                log.warning(
                    "plan-hint cache not writable (%s): %s — hint "
                    "persistence disabled for this process", path, e,
                )
                self._write_failed = True
                return False
            self._last_fp = fp
            metrics.add("hints_saved")
            return True


def _snapshot_items(d: dict) -> list:
    """Stable snapshot of a dict OTHER task threads mutate concurrently:
    ``list(d.items())`` itself raises RuntimeError when the dict resizes
    mid-construction (observed live — two task-runner threads on one
    executor, one fingerprinting its save while the other committed its
    attempt cache; the bounded task retry masked it as a spurious task
    failure). Retrying is cheap and converges: resizes are rare single
    events, not a steady state. The empty-list give-up (never observed)
    at worst skips/doubles one debounced hint write — both correct."""
    for _ in range(8):
        try:
            return list(d.items())
        except RuntimeError:
            continue
    return []


def _persistable(plan_cache: dict):
    """Yield (repr-key, repr-value) for every entry that survives the
    literal_eval round trip, newest-biased to _MAX_ENTRIES
    (``agg_capacity`` is a separate top-level document field)."""
    items = _snapshot_items(plan_cache)
    if len(items) > _MAX_ENTRIES:
        items = items[-_MAX_ENTRIES:]
    for k, v in items:
        if k in _EPHEMERAL_KEYS:
            continue
        ks, vs = _encode(k), _encode(v)
        if ks is not None and vs is not None:
            yield ks, vs


def _sites_of(hint: dict) -> dict:
    """The hint's learned site capacities: ``run_with_capacity_retry``
    replaces the dict whole under its lock, never mutates it in place."""
    sites = hint.get("site_capacity")
    return sites if isinstance(sites, dict) else {}


def _decode_sites(raw) -> dict:
    """Site capacities of a hint document: literal keys, int values."""
    out: dict = {}
    if not isinstance(raw, dict):
        return out
    for ks, cap in raw.items():
        try:
            k = ast.literal_eval(ks)
        except (ValueError, SyntaxError, MemoryError, RecursionError):
            continue
        if isinstance(cap, int):
            out[k] = cap
    return out


def _merge_hint(hint: dict, cap, sites: dict) -> int:
    """Merge a file's aggregate and site capacities into the hint (the
    larger wins), under ``exec.base``'s hint lock: an executor's task
    threads merge into the same dict. Returns the values raised."""
    from ballista_tpu_torch.exec.base import _hint_lock

    n = 0
    with _hint_lock:
        if isinstance(cap, int) and cap > hint.get("agg_capacity", 0):
            hint["agg_capacity"] = cap
            n += 1
        learned = dict(_sites_of(hint))
        raised = {k: c for k, c in sites.items() if c > learned.get(k, 0)}
        if raised:
            hint["site_capacity"] = {**learned, **raised}
            n += len(raised)
    return n


def _document(hint: dict, plan_cache: dict) -> dict:
    cap = hint.get("agg_capacity")
    sites = {}
    for k, v in _sites_of(hint).items():
        ks = _encode(k)
        if ks is not None and isinstance(v, int):
            sites[ks] = v
    return {
        "version": _VERSION,
        "agg_capacity": cap if isinstance(cap, int) else None,
        "site_capacity": sites,
        "entries": dict(_persistable(plan_cache)),
    }


def _fingerprint(hint: dict, plan_cache: dict) -> int:
    """Change-detection only — repr without the literal_eval validation
    _persistable does: this runs per collect/task on the query hot path,
    and parsing thousands of entries to decide "nothing changed" would
    dwarf the write it debounces. Entries repr-unstable enough to fool
    this just cause one redundant (still-correct) merge-write."""
    items = []
    # snapshot first: the executor's task threads mutate this dict
    # concurrently with a finishing task's save (repr() between loop
    # steps can yield the GIL mid-iteration, and the list() itself must
    # survive a concurrent resize — _snapshot_items)
    for k, v in _snapshot_items(plan_cache):
        if k in _EPHEMERAL_KEYS:
            continue
        items.append((repr(_canon(k)), repr(_canon(v))))
    sites = tuple(sorted(
        (repr(k), repr(v)) for k, v in _sites_of(hint).items()
    ))
    return hash((hint.get("agg_capacity"), sites, tuple(sorted(items))))
