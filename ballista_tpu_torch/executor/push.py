"""Push-shuffle stream registry: the in-memory shuffle data plane.

The pull data plane (docs/shuffle.md) persists every shuffle partition to
an Arrow IPC file and serves it over Flight ``do_get``. This module holds
the opportunistic fast path on top of it (``ballista.tpu.push_shuffle``):
a producing task commits each output partition's record batches into a
process-wide registry keyed ``(job_id, stage_id, map_partition,
out_partition)`` instead of writing them to disk, and consumers stream
them over Flight ``do_exchange`` (executor/flight_service.py) — or read
the registry directly when colocated in-process — so the hot path never
touches disk.

Disk remains the recovery/backpressure substrate:

- **Window overflow while producing** — an append that would push the
  process's in-memory total past ``ballista.tpu.push_shuffle_window_mb``
  first evicts sealed streams whose consumers lag (consumed first, then
  least-recently-touched), spilling each to its ordinary shuffle-file
  path; if the window is still exceeded the appending stream itself
  converts to disk writing and commits as a plain (non-push) file.
- **Consumer fall-back** — a consumer that finds no live stream falls
  back to the pull path at the location's ``path``: the spill target IS
  the path the location advertises, so spilled data is served by the
  unchanged file machinery (mmap local fast path, ``do_get``).
- **Producer loss** — streams die with the producing executor
  (:func:`drop_owner` on stop; process death loses them trivially), and
  the consumer's typed ShuffleFetchError drives the normal
  lineage-recompute machinery. Promotion stays the commit point.

Consumption is IDEMPOTENT: ``take_batches`` marks the stream consumed but
keeps the batches, because in-task capacity/speculation retries
(run_with_capacity_retry) legitimately re-execute a consumer plan and
re-fetch its inputs mid-attempt. Consumed streams live in a grace pool
capped at window/4 and are DROPPED (not spilled) beyond it, oldest
first — writing fall-back files for data whose consumer already
finished burned the disk savings push exists for, while keeping them
indefinitely let dead streams' residency outweigh the spills it
replaced (both measured on the reference); the rare post-drop re-fetch
recovers through lineage recompute. Memory is further reclaimed by the
TTL sweep (executor/cleanup.py) and :func:`drop_owner` at executor
stop.

Spill files appear ATOMICALLY (written to ``<path>.spill.tmp``, then
os.replace): a consumer can never open a half-written fall-back file.
All stream/registry state is mutated under one lock; file I/O always
happens outside it (racelint blocking-under-lock).
"""

from __future__ import annotations

import logging
import os
import threading
import time as _time

import pyarrow as pa
import pyarrow.ipc as paipc

from ballista_tpu_torch.analysis.witness import make_lock

log = logging.getLogger(__name__)

# stream.state values (all transitions under the registry lock)
_OPEN_MEM = "open-mem"  # producing, batches accumulate in memory
_OPEN_DISK = "open-disk"  # producing, converted to a disk writer
_SEALED = "sealed"  # committed, consumable from memory
_SPILLING = "spilling"  # sealed, being evicted to its file by some thread
_GONE = "gone"  # removed (fully spilled / consumed away / dropped)


class PushStream:
    """One shuffle output partition's in-flight batches. Mutable state is
    owned by the registry (mutated under its lock); the disk writer of an
    ``open-disk`` stream is touched only by the single producing task
    thread, outside the lock."""

    __slots__ = (
        "key", "path", "owner", "state", "batches", "nbytes", "num_rows",
        "num_batches", "consumed", "last_touch", "disk_done", "ipc_options",
        "_writer", "_token",
    )

    def __init__(self, key, path, owner, ipc_options):
        self.key = key
        self.path = path
        self.owner = owner
        self.state = _OPEN_MEM
        self.batches: list[pa.RecordBatch] = []
        self.nbytes = 0
        self.num_rows = 0
        self.num_batches = 0
        self.consumed = False
        self.last_touch = _time.monotonic()
        # set once the spill file is fully on disk (consumers racing an
        # eviction wait on this instead of reading a half-written file)
        self.disk_done = threading.Event()
        self.ipc_options = ipc_options
        self._writer: paipc.RecordBatchFileWriter | None = None
        self._token = None


def _write_spill(path: str, batches: list, options) -> int:
    """Write one stream's batches to ``path`` atomically (tmp + replace).
    Returns the final file size."""
    tmp = path + ".spill.tmp"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    kw = {"options": options} if options is not None else {}
    writer = paipc.new_file(tmp, batches[0].schema, **kw)
    try:
        for rb in batches:
            writer.write_batch(rb)
    finally:
        writer.close()
    os.replace(tmp, path)
    return os.path.getsize(path)


class PushRegistry:
    """Process-wide registry of live push streams, bounded by the
    in-flight window. One instance per process (module ``REGISTRY``);
    streams are tagged with their producing executor's work_dir so
    multi-executor (standalone) processes can drop exactly one
    executor's streams on stop/kill."""

    def __init__(self) -> None:
        # reentrant: the under-lock helpers (_plan_eviction_locked,
        # _forget_locked) re-take it so every _streams/_mem_bytes access
        # is provably guarded wherever it appears
        self._lock = make_lock("PushRegistry._lock", reentrant=True)
        self._streams: dict[tuple, PushStream] = {}
        self._mem_bytes = 0
        # process-lifetime counters (served by tests/diagnostics; the
        # per-task operator metrics are accounted by the writer)
        self.total_pushed = 0
        self.total_spilled = 0

    # -- producer side -------------------------------------------------------
    def open(self, key, path, owner, ipc_options) -> PushStream:
        """Register a fresh stream. An existing stream under the same key
        is a previous attempt's leftover (failed attempt / recompute) —
        it is dropped: only the NEWEST attempt's commit may be served."""
        from ballista_tpu_torch.analysis import reswitness

        s = PushStream(key, path, owner, ipc_options)
        tok = reswitness.acquire("push-stream", "/".join(map(str, key)))
        with self._lock:
            old = self._streams.pop(key, None)
            if old is not None:
                self._forget_locked(old)
                # retire it fully: a superseded attempt's thread may still
                # be mid-append, and without the GONE latch its appends
                # would keep inflating _mem_bytes for a stream no longer
                # reachable by any eviction/sweep/drop — permanently
                # shrinking the effective window
                old.state = _GONE
            s._token = tok
            self._streams[key] = s
        if old is not None:
            old.disk_done.set()
            reswitness.release(old._token)
        return s

    def append(self, s: PushStream, rb: pa.RecordBatch,
               window_bytes: int) -> int:
        """Append one batch to an open stream, evicting under the window.
        Returns the spill bytes this append forced (0 on the pure-memory
        path) so the producing task can meter its own backpressure."""
        spilled = 0
        with self._lock:
            if s.state == _GONE:
                # executor stop/kill raced this task mid-write: the data
                # plane is going away, drop the batch (the task dies with
                # the loops; nothing will ever consume this stream)
                return 0
            if s.state == _OPEN_DISK:
                victims, convert = [], False
            else:
                s.batches.append(rb)
                s.nbytes += rb.nbytes
                self._mem_bytes += rb.nbytes
                s.num_rows += rb.num_rows
                s.num_batches += 1
                s.last_touch = _time.monotonic()
                victims, convert = self._plan_eviction_locked(
                    s, window_bytes
                )
        if s.state == _OPEN_DISK:
            # single producer thread owns the writer; no lock needed
            s._writer.write_batch(rb)
            s.num_rows += rb.num_rows
            s.num_batches += 1
            return 0
        for v, batches in victims:
            if batches is None:
                # consumed stream dropped under pressure: release only
                # (a rare later re-fetch recovers via lineage recompute)
                from ballista_tpu_torch.analysis import reswitness

                v.disk_done.set()
                reswitness.release(v._token)
                continue
            spilled += self._spill_victim(v, batches)
        if convert:
            spilled += self._convert_to_disk(s)
        return spilled

    def _plan_eviction_locked(self, appender: PushStream, window_bytes):
        """Under the lock: reclaim memory until the window holds.
        CONSUMED sealed streams are DROPPED outright — their one
        consumer already streamed them, and the only re-reader is a
        rare retry (in-task capacity growth, a consumer task failing
        after its fetch), which recovers through the normal
        gone->lineage-recompute path; spilling them wrote gigabytes of
        fall-back files per SF1 query that nothing ever read back (in
        the reference's runs), erasing the disk-skipping win push exists
        for.
        UNCONSUMED sealed streams (genuinely lagging consumers) spill
        to their fall-back path, least-recently-touched first. Returns
        ``([(victim, batches-or-None), ...], convert_self)`` — batches
        None marks a drop (no file I/O needed)."""
        with self._lock:  # reentrant (callers hold it already)
            victims = []
            if window_bytes <= 0:
                return victims, True
            # consumed streams get only a FRACTION of the window (a grace
            # pool for in-task retry re-fetches): without the sub-budget,
            # a window sized generously for in-flight data let gigabytes
            # of already-consumed streams linger on the heap with nothing
            # ever reclaiming them (no pressure -> no drop), and that
            # residency cost more than the spills it replaced (in the
            # reference's runs)
            consumed_budget = window_bytes // 4
            consumed = sorted(
                (
                    v for v in self._streams.values()
                    if v.state == _SEALED and v.consumed
                    and v is not appender
                ),
                key=lambda v: v.last_touch,
            )
            consumed_bytes = sum(v.nbytes for v in consumed)
            for v in consumed:
                if (
                    consumed_bytes <= consumed_budget
                    and self._mem_bytes <= window_bytes
                ):
                    break
                del self._streams[v.key]
                consumed_bytes -= v.nbytes
                self._forget_locked(v)
                v.state = _GONE
                victims.append((v, None))
            if self._mem_bytes <= window_bytes:
                return victims, False
            lagging = sorted(
                (
                    v for v in self._streams.values()
                    if v.state == _SEALED and not v.consumed
                    and v is not appender
                ),
                key=lambda v: v.last_touch,
            )
            for v in lagging:
                if self._mem_bytes <= window_bytes:
                    break
                v.state = _SPILLING
                batches, v.batches = v.batches, []
                self._mem_bytes -= v.nbytes
                victims.append((v, batches))
            return victims, self._mem_bytes > window_bytes

    def _spill_victim(self, v: PushStream, batches: list) -> int:
        """File I/O outside the lock: write the detached batches to the
        stream's fall-back path, then retire the stream. Consumers racing
        this wait on ``disk_done`` before falling back to the file."""
        from ballista_tpu_torch.analysis import reswitness

        try:
            size = _write_spill(v.path, batches, v.ipc_options)
        except Exception:
            # spill failure loses the stream (disk full, dir swept): the
            # consumer's fall-back finds nothing and recovery recomputes
            # the producer — the same contract as a lost executor
            log.exception("push-stream spill to %s failed", v.path)
            size = 0
        with self._lock:
            if self._streams.get(v.key) is v:
                del self._streams[v.key]
            v.state = _GONE
        v.disk_done.set()
        reswitness.release(v._token)
        self.total_spilled += size
        return size

    def _convert_to_disk(self, s: PushStream) -> int:
        """The appending stream itself overflows the window: move its
        buffered batches to a disk writer (kept open for the rest of the
        task) and stop counting it against the window. Runs on the single
        producing thread; only the state flip takes the lock."""
        with self._lock:
            if s.state != _OPEN_MEM:
                return 0
            batches, s.batches = s.batches, []
            self._mem_bytes -= s.nbytes
            moved = s.nbytes
            s.nbytes = 0
            s.state = _OPEN_DISK
        tmp = s.path + ".spill.tmp"
        os.makedirs(os.path.dirname(s.path), exist_ok=True)
        if s.ipc_options is not None:
            s._writer = paipc.new_file(
                tmp, batches[0].schema, options=s.ipc_options
            )
        else:
            s._writer = paipc.new_file(tmp, batches[0].schema)
        for rb in batches:
            s._writer.write_batch(rb)
        self.total_spilled += moved
        return moved

    def seal(self, s: PushStream) -> tuple[int, int, int, bool]:
        """Commit one stream at task success. Returns ``(num_rows,
        num_batches, num_bytes, pushed)``: a memory stream becomes
        consumable (pushed=True); a disk-converted stream finalizes its
        file atomically and leaves the registry (pushed=False — the meta
        is an ordinary pull location)."""
        from ballista_tpu_torch.analysis import reswitness

        if s.state == _GONE:
            # dropped (stop/kill) between the last append and the commit:
            # close any disk writer and report a plain no-push meta — the
            # consumer's fall-back finds nothing and lineage recomputes
            if s._writer is not None:
                try:
                    s._writer.close()
                finally:
                    s._writer = None
                try:
                    os.remove(s.path + ".spill.tmp")
                except OSError:
                    pass
            return s.num_rows, s.num_batches, 0, False
        if s.state == _OPEN_DISK:
            s._writer.close()
            s._writer = None
            os.replace(s.path + ".spill.tmp", s.path)
            size = os.path.getsize(s.path)
            with self._lock:
                if self._streams.get(s.key) is s:
                    del self._streams[s.key]
                s.state = _GONE
            s.disk_done.set()
            reswitness.release(s._token)
            return s.num_rows, s.num_batches, size, False
        with self._lock:
            s.state = _SEALED
            s.last_touch = _time.monotonic()
        self.total_pushed += s.nbytes
        return s.num_rows, s.num_batches, s.nbytes, True

    def abort(self, s: PushStream) -> None:
        """Discard a stream of a FAILED task attempt (capacity retry,
        crash): its partial content must never be observable — the retry
        re-opens the key fresh."""
        from ballista_tpu_torch.analysis import reswitness

        with self._lock:
            if self._streams.get(s.key) is s:
                del self._streams[s.key]
            self._forget_locked(s)
            prev, s.state = s.state, _GONE
        if prev == _OPEN_DISK and s._writer is not None:
            try:
                s._writer.close()
            finally:
                s._writer = None
            try:
                os.remove(s.path + ".spill.tmp")
            except OSError:
                pass
        s.disk_done.set()
        reswitness.release(s._token)

    # -- consumer side -------------------------------------------------------
    def take_batches(self, key) -> list[pa.RecordBatch] | None:
        """The sealed in-memory batches under ``key`` (row order = append
        order = file order), or None when the consumer must fall back to
        the file path (stream spilled, still producing, or gone).
        Idempotent: the stream stays for in-task re-fetches; the window
        eviction prefers consumed streams when reclaiming memory."""
        with self._lock:
            s = self._streams.get(key)
            if s is not None and s.state == _SEALED:
                s.consumed = True
                s.last_touch = _time.monotonic()
                return s.batches
            spilling = s if s is not None and s.state == _SPILLING else None
        if spilling is not None:
            # eviction in flight: once disk_done is set the fall-back
            # file is complete (atomic replace), so None is safe
            spilling.disk_done.wait(timeout=30)
        return None

    def peek_batches(self, key) -> list[pa.RecordBatch] | None:
        """Like :meth:`take_batches` but WITHOUT touching consumption
        state (the replay witness hashes committed streams; a hash read
        must not make the eviction policy think a consumer came by)."""
        with self._lock:
            s = self._streams.get(key)
            if s is not None and s.state == _SEALED:
                return s.batches
        return None

    def has(self, key) -> bool:
        with self._lock:
            s = self._streams.get(key)
            return s is not None and s.state == _SEALED

    # -- lifecycle -----------------------------------------------------------
    def _forget_locked(self, s: PushStream) -> None:
        with self._lock:  # reentrant (callers hold it already)
            if s.state in (_OPEN_MEM, _SEALED):
                self._mem_bytes -= s.nbytes
                s.batches = []
                s.nbytes = 0

    def drop_owner(self, owner: str) -> int:
        """Drop every stream of one executor (stop/kill): push data dies
        with its producer by design — recovery recomputes. Returns the
        count dropped."""
        from ballista_tpu_torch.analysis import reswitness

        with self._lock:
            dead = [
                s for s in self._streams.values() if s.owner == owner
            ]
            for s in dead:
                del self._streams[s.key]
                self._forget_locked(s)
                s.state = _GONE
        for s in dead:
            s.disk_done.set()
            reswitness.release(s._token)
        if dead:
            log.info("dropped %d push streams of %s", len(dead), owner)
        return len(dead)

    def sweep(self, ttl_seconds: float) -> int:
        """TTL sweep (executor/cleanup.py): drop SEALED streams idle past
        the TTL — the in-memory analogue of the shuffle-file sweep (same
        horizon; a job this stale was torn down or its files were swept
        too). Open streams belong to a live task and are never swept."""
        from ballista_tpu_torch.analysis import reswitness

        cutoff = _time.monotonic() - ttl_seconds
        with self._lock:
            stale = [
                s for s in self._streams.values()
                if s.state == _SEALED and s.last_touch < cutoff
            ]
            for s in stale:
                del self._streams[s.key]
                self._forget_locked(s)
                s.state = _GONE
        for s in stale:
            s.disk_done.set()
            reswitness.release(s._token)
        return len(stale)

    def mem_bytes(self) -> int:
        with self._lock:
            return self._mem_bytes

    def stream_count(self) -> int:
        with self._lock:
            return len(self._streams)


# THE process-wide registry: producers (ShuffleWriterExec), the Flight
# service (do_exchange), colocated readers, and the cleanup sweep all see
# one instance — exactly like the shuffle work_dir is one filesystem.
REGISTRY = PushRegistry()


def stream_key(job_id: str, stage_id: int, map_partition: int,
               out_partition: int) -> tuple:
    return (job_id, int(stage_id), int(map_partition), int(out_partition))
