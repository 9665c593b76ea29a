"""Pluggable KV state backends for scheduler persistence.

Mirrors the reference's ``StateBackendClient`` trait (ref
ballista/rust/scheduler/src/state/backend/mod.rs:53-94: get,
get_from_prefix, put, lock, watch) with two implementations standing in
for the reference's sled (backend/standalone.rs:31-180) and etcd
(backend/etcd.rs:32-196):

- :class:`MemoryBackend` — in-process dict (tests / ephemeral schedulers);
- :class:`SqliteBackend` — a file-backed store, the embedded-DB analogue
  of sled in this Python runtime (sqlite ships in the stdlib and gives
  the same durability contract: survive a scheduler restart on one node).

Keys follow the reference's scheme: ``/ballista/<namespace>/...``
(persistent_state.rs:326-352).
"""

from __future__ import annotations

import dataclasses
import queue
import sqlite3
from typing import Iterator

from ballista_tpu_torch.analysis.witness import make_lock


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    """One observed mutation (ref backend/mod.rs:96-104 WatchEvent::Put /
    Delete)."""

    kind: str  # "put" | "delete"
    key: str
    value: bytes | None  # None for deletes


class Watch:
    """A live subscription to key mutations under a prefix (ref
    backend/mod.rs:84-94 ``watch`` returning a Stream of WatchEvents).
    Iterate for events; ``stop()`` ends the stream. Trigger-based: events
    fire from this process's put/delete calls — the same visibility the
    reference's sled-backed standalone watch has (cross-process watch is
    etcd's job; see docs/deployment.md HA notes)."""

    _STOP = object()

    def __init__(self, prefix: str, unsubscribe) -> None:
        self.prefix = prefix
        self._q: queue.Queue = queue.Queue()
        self._unsubscribe = unsubscribe
        self._stopped = False

    def _offer(self, event: WatchEvent) -> None:
        self._q.put(event)

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._unsubscribe(self)
            self._q.put(self._STOP)

    def __iter__(self) -> "Watch":
        return self

    def __next__(self) -> WatchEvent:
        item = self._q.get()
        if item is self._STOP:
            raise StopIteration
        return item

    def get(self, timeout: float | None = None) -> WatchEvent | None:
        """Non-raising fetch: the next event, or None on timeout/stop."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._STOP:
            self._q.put(self._STOP)  # keep the sentinel for iterators
            return None
        return item


class StateBackendClient:
    """KV-store interface (ref backend/mod.rs:53-94: get, get_from_prefix,
    put, lock, watch)."""

    def __init__(self) -> None:
        self._watchers: list[Watch] = []
        self._watch_lock = make_lock("StateBackendClient._watch_lock")

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def get_from_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        raise NotImplementedError

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def lock(self):
        """Global scheduler lock (ref etcd.rs:85 `/ballista_global_lock`,
        persistent_state.rs:313-319 global lock around each save)."""
        raise NotImplementedError

    def watch(self, prefix: str) -> Watch:
        """Subscribe to mutations under ``prefix``."""
        w = Watch(prefix, self._unwatch)
        with self._watch_lock:
            self._watchers.append(w)
        return w

    def _unwatch(self, w: Watch) -> None:
        with self._watch_lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def _notify(self, kind: str, key: str, value: bytes | None) -> None:
        with self._watch_lock:
            watchers = list(self._watchers)
        for w in watchers:
            if key.startswith(w.prefix):
                w._offer(WatchEvent(kind, key, value))

    def close(self) -> None:
        with self._watch_lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.stop()


class MemoryBackend(StateBackendClient):
    def __init__(self) -> None:
        super().__init__()
        self._data: dict[str, bytes] = {}
        self._lock = make_lock("MemoryBackend._lock", reentrant=True)

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def get_from_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        with self._lock:
            return sorted(
                (k, v) for k, v in self._data.items() if k.startswith(prefix)
            )

    def put(self, key: str, value: bytes) -> None:
        v = bytes(value)
        with self._lock:
            self._data[key] = v
            # notify under the data lock: watchers must observe events in
            # the order the writes were applied
            self._notify("put", key, v)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._notify("delete", key, None)

    def lock(self):
        return self._lock


class SqliteBackend(StateBackendClient):
    """File-backed KV store (the sled analogue, ref
    backend/standalone.rs:31-180). One table, BLOB values, WAL mode so a
    crashed scheduler's last committed writes survive."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self._lock = make_lock("SqliteBackend._lock", reentrant=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "key TEXT PRIMARY KEY, value BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE key = ?", (key,)
            ).fetchone()
        return None if row is None else bytes(row[0])

    def get_from_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE key >= ? AND key < ? "
                "ORDER BY key",
                (prefix, prefix + "￿"),
            ).fetchall()
        return [(k, bytes(v)) for k, v in rows]

    def put(self, key: str, value: bytes) -> None:
        v = bytes(value)
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (key, sqlite3.Binary(v)),
            )
            self._conn.commit()
            self._notify("put", key, v)

    def delete(self, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE key = ?", (key,))
            self._conn.commit()
            self._notify("delete", key, None)

    def lock(self):
        return self._lock

    def close(self) -> None:
        super().close()
        with self._lock:
            self._conn.close()
