"""Scheduler-side plan-fingerprint result cache (docs/serving.md).

The serving fast path's first layer: a bounded LRU mapping the canonical
fingerprint of an optimized logical plan — the SAME serde-bytes identity
``exec/context.create_physical_plan`` caches physical plans under —
composed with the session settings and the registered tables' data
versions, to the job's committed Arrow result (one IPC stream). A
repeated identical query over unchanged data is answered by the
scheduler alone: no stages, no task grants, no executor round-trip.

Invalidation is BY KEY, never by sweep: re-registering or appending to a
table changes its ``_data_version`` component (memory tables key on
their registration generation + row count, files on mtime — the seam
``exec/context.py`` already uses for its local plan caches), so the next
submission simply misses and the stale entry ages out of the LRU. A
generation is never reused, where an object's address can be: a table
dropped and a new one registered never share a key.
Plans scanning ``system.*`` tables are never keyed at all (they must
serve the rows as of THIS query). The cache is in-memory only — a
scheduler restart starts empty by construction, which is exactly the
"no stale serve after ``_recover_state``" contract.

Only COMMITTED results enter: population happens after JobFinished, by
re-reading the final stage's committed partitions through the same
``fetch_partition_table`` path the client uses. A mid-run executor kill
therefore can never seed the cache with partial data — either the job's
lineage recovery re-completes it (and the re-read sees the recomputed
commit), or the job fails and nothing is stored.
"""

from __future__ import annotations

import collections
import logging

from ballista_tpu_torch.analysis.witness import make_lock

log = logging.getLogger(__name__)


def result_cache_key(optimized, cfg, provider) -> tuple | None:
    """Cache identity for one submission, or None for "uncacheable".

    ``(plan serde bytes, sorted session settings, provider data
    version)`` — identical queries over identical data under identical
    settings, nothing else. None when the provider cannot report data
    versions (no table registry attached — remote schedulers without an
    attached provider must not serve stale results), when the plan scans
    a system table, or when the plan has no serde encoding.
    """
    data_version = getattr(provider, "_data_version", None)
    if data_version is None:
        return None
    from ballista_tpu_torch.exec.context import _scans_system_table

    if _scans_system_table(optimized):
        return None
    try:
        from ballista_tpu_torch.serde import logical_to_proto

        fp = logical_to_proto(optimized).SerializeToString()
        version = data_version()
    except Exception:  # noqa: BLE001 — unserializable plan: run it fresh
        return None
    return (fp, tuple(sorted(cfg.settings().items())), version)


class ResultCache:
    """Bytes-bounded LRU of committed query results.

    Every mutable field is guarded by the witness lock (racelint
    guarded-field); payloads are immutable ``bytes`` so a returned hit
    is safe to hand to any thread. Eviction pops the least-recently-used
    entry first — ``OrderedDict`` recency order, fully deterministic for
    a given get/put sequence (detlint: no hash-seed iteration anywhere
    on the eviction path).
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = max(0, int(capacity_bytes))
        # one entry may use at most a quarter of the budget: a single
        # huge result would otherwise evict the entire working set for
        # one hit
        self.entry_cap_bytes = self.capacity_bytes // 4 or 1
        self._lock = make_lock("ResultCache._lock")
        # key -> (ipc payload, meta dict). meta carries the originating
        # job's query_class so a hit keeps labeling the fleet latency
        # series correctly WITHOUT re-running physical planning.
        self._entries: collections.OrderedDict[tuple, tuple[bytes, dict]] = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected_oversize = 0

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    def get(self, key: tuple | None) -> tuple[bytes, dict] | None:
        """``(payload, meta)`` for ``key``, counting the hit/miss.
        ``None`` keys (uncacheable submissions) count as misses so the
        hit ratio the bench reports stays honest about them."""
        if not self.enabled:
            return None
        with self._lock:
            if key is None:
                self.misses += 1
                return None
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: tuple, payload: bytes, meta: dict | None = None
            ) -> bool:
        """Store one committed result; False when it exceeds the
        per-entry cap (counted — no silent caps)."""
        if not self.enabled or key is None:
            return False
        size = len(payload)
        if size > self.entry_cap_bytes:
            with self._lock:
                self.rejected_oversize += 1
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[key] = (payload, dict(meta or {}))
            self._bytes += size
            while self._bytes > self.capacity_bytes and self._entries:
                _k, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted[0])
                self.evictions += 1
        return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        """Snapshot for /api/metrics and the BENCH_SERVE artifact."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejected_oversize": self.rejected_oversize,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
            }


def table_to_ipc(table) -> bytes:
    """One Arrow table -> one IPC stream (the CompletedJob.result_ipc
    wire shape). The stream format (not file) matches the shuffle data
    plane's framing so the client reassembles with the same reader."""
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def ipc_to_table(payload: bytes):
    import pyarrow as pa

    with pa.ipc.open_stream(pa.py_buffer(payload)) as r:
        return r.read_all()
