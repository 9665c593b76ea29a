"""ShuffleReaderExec: read a stage's shuffle partitions into the next stage
(port of the local-file part of ``ballista_tpu/executor/reader.py``).

For its output partition p the reader streams every mapped shuffle file
(one per upstream task that wrote rows for p) in location order, off a
memory map, re-chunks the record batches up to the device-batch row budget
and uploads each chunk to the task's device, with int64 narrowing off:
files of different writers share one layout. The host holds at most one
device batch of a partition beyond the batches in flight.

Up to ``ballista.tpu.shuffle_fetch_concurrency`` locations are read at once
by pool workers into small bounded queues, while batches are yielded
strictly in location order, so the stream (and every downstream reduction)
is the sequential one's. A local file that cannot be decoded raises a
non-transient ``ShuffleFetchError`` naming its producer.

Not ported yet (ROADMAP queue 1, item 9c): locations on another host
(Flight fetch), push locations, the eager feed that polls a scheduler for
published locations, fetch trace spans and the fault-injection points.
Each raises where the reference would take it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue as _queue
import threading
import time
from typing import Callable, Iterator

import pyarrow as pa
import pyarrow.ipc as paipc

from ballista_tpu_torch.columnar.arrow_interop import table_from_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.config import BALLISTA_SHUFFLE_LOCAL_FASTPATH
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import ShuffleFetchError
from ballista_tpu_torch.exec.base import ExecutionPlan, TaskContext, UnknownPartitioning
from ballista_tpu_torch.scheduler_types import PartitionLocation

BATCH_ROWS = 1 << 17

# Record batches buffered per in-flight location: deep enough to keep a
# worker busy while the consumer uploads, small enough that host residency
# stays about concurrency * depth batches.
_QUEUE_DEPTH = 4

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 9c)"

# What the reads cost, summed over the process (a run resets them): host
# seconds of opening and decoding the IPC files (on the fetching threads),
# and of building and uploading the device batches (on the consuming one).
stats = dict(read_s=0.0, upload_s=0.0)


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0.0


@contextlib.contextmanager
def _open_local_file(path: str):
    """An Arrow IPC file reader over a memory map (uncompressed files are
    read zero-copy), closing the map on exit: the file reader itself has
    no close."""
    src = pa.memory_map(path)
    try:
        yield paipc.open_file(src)
    finally:
        src.close()


_LOCAL_HOSTS: frozenset | None = None


def _local_hostnames() -> frozenset:
    """Names and addresses that mean 'this host' for the per-link codec
    negotiation (computed once)."""
    global _LOCAL_HOSTS
    if _LOCAL_HOSTS is None:
        import socket

        names = {"", "localhost", "127.0.0.1", "::1"}
        try:
            host = socket.gethostname()
            names.add(host)
            names.add(socket.getfqdn())
            for info in socket.getaddrinfo(host, None):
                names.add(info[4][0])
        except OSError:  # pragma: no cover — hosts without a resolver
            pass
        _LOCAL_HOSTS = frozenset(names)
    return _LOCAL_HOSTS


def resolve_link_codec(codec: str, loc: PartitionLocation) -> str:
    """Per-(producer, consumer) codec negotiation: ``auto`` is ``none``
    when the pair is colocated (the file is on this filesystem, or the
    producer's host is this host) and ``lz4`` across hosts. Explicit codecs
    pass through."""
    if codec != "auto":
        return codec
    if os.path.exists(loc.path) or loc.host in _local_hostnames():
        return "none"
    return "lz4"


def _remote(loc: PartitionLocation) -> NotImplementedError:
    what = "a push location" if loc.push else "a location on another host (Flight fetch)"
    return NotImplementedError(
        f"reading {what} {_NOT_PORTED}: stage {loc.stage_id} partition "
        f"{loc.partition} of executor {loc.executor_id!r} at {loc.host}:{loc.port}, "
        f"{loc.path} is not on this filesystem"
    )


def fetch_partition_table(loc: PartitionLocation) -> pa.Table:
    """One shuffle file as an Arrow table, read off a memory map."""
    if loc.push or not os.path.exists(loc.path):
        raise _remote(loc)
    try:
        with _open_local_file(loc.path) as r:
            return r.read_all()
    except (pa.ArrowInvalid, pa.ArrowIOError, OSError) as e:
        raise _local_fetch_error(loc, e) from e


def _local_fetch_error(loc: PartitionLocation, exc: Exception) -> ShuffleFetchError:
    """A local shuffle file that exists but cannot be decoded is lost data,
    as an unreachable producer is: typed so that a scheduler recomputes the
    producing map partition. Corruption is not transient: reading the same
    bytes again cannot help."""
    return ShuffleFetchError(
        f"corrupt/unreadable local shuffle file {loc.path}: {type(exc).__name__}: {exc}",
        job_id=loc.job_id,
        stage_id=loc.stage_id,
        partition=loc.partition,
        executor_id=loc.executor_id,
        transient=False,
    )


def fetch_partition_batches(loc: PartitionLocation) -> Iterator[pa.RecordBatch]:
    """One local shuffle file as a stream of record batches (peak memory a
    batch, not the file). A location that is not a local file raises: the
    Flight fetch, with the reference's retries, backoff, deadline and wire
    codec (``ballista.tpu.fetch_*``, ``resolve_link_codec``), is not
    ported."""
    if loc.push or not os.path.exists(loc.path):
        raise _remote(loc)
    try:
        t = time.perf_counter()
        with _open_local_file(loc.path) as r:
            for i in range(r.num_record_batches):
                rb = r.get_batch(i)
                stats["read_s"] += time.perf_counter() - t
                yield rb
                t = time.perf_counter()
        stats["read_s"] += time.perf_counter() - t
    except (pa.ArrowInvalid, pa.ArrowIOError, OSError) as e:
        raise _local_fetch_error(loc, e) from e


# ---------------------------------------------------------------------------
# location feeds: where the reader's upstream locations come from
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShuffleLocationsView:
    """One poll of a scheduler's published shuffle locations, decoded:
    locations tagged with their producing map task, the contiguous prefix
    of completed tasks, and the terminal flags. (The eager feed that polls
    them comes with ROADMAP queue 1, item 9c.)"""

    locations: list[tuple[int, PartitionLocation]]
    tasks_done_prefix: int
    complete: bool
    failed: bool


class _StaticFeed:
    """Barriered mode: the location list fixed when the stage was
    resolved."""

    def __init__(self, locs: list[PartitionLocation]):
        self._locs = collections.deque(locs)

    def next_ready(self) -> PartitionLocation | None:
        return self._locs.popleft() if self._locs else None

    def next_blocking(self) -> PartitionLocation | None:
        return self.next_ready()


# ---------------------------------------------------------------------------
# overlapped fetch pipeline
# ---------------------------------------------------------------------------

_DONE = object()


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _pump_put(q: _queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded, cancellable handoff from a fetch worker to the consumer:
    the put blocks in short slices, so an abandoned consumer (``stop``
    set) never leaves a worker stuck on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _iter_location_batches(
    feed, fetch_one: Callable, concurrency: int, metrics
) -> Iterator[pa.RecordBatch]:
    """Merge upstream locations into one record-batch stream.

    ``concurrency <= 1``: one location at a time. Otherwise up to
    ``concurrency`` locations are fetched at once by pool workers, each into
    a bounded queue, while batches are yielded strictly in location order
    (all of location i's batches before location i+1's), so the stream is
    the sequential one's. A location's fetch error is raised where the
    consumer reaches that location, as the sequential loop raises it."""
    if concurrency <= 1:
        while True:
            loc = feed.next_blocking()
            if loc is None:
                return
            got_any = False
            it = fetch_one(loc)
            try:
                while True:
                    with metrics.time("fetch_time"):
                        rb = next(it, None)
                    if rb is None:
                        break
                    got_any = True
                    metrics.add("fetched_bytes", rb.nbytes)
                    yield rb
            finally:
                # close the file now when the consumer stops early
                it.close()
            if got_any:
                metrics.add("fetched_batches")

    from concurrent.futures import ThreadPoolExecutor

    stop = threading.Event()
    window: collections.deque = collections.deque()
    ex = ThreadPoolExecutor(max_workers=concurrency, thread_name_prefix="shuffle-fetch")

    def pump(loc: PartitionLocation, q: _queue.Queue) -> None:
        try:
            for rb in fetch_one(loc):
                if not _pump_put(q, rb, stop):
                    return
            _pump_put(q, _DONE, stop)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _pump_put(q, _Err(e), stop)

    def start_fetch(loc: PartitionLocation) -> None:
        q: _queue.Queue = _queue.Queue(maxsize=_QUEUE_DEPTH)
        window.append((loc, q))
        ex.submit(pump, loc, q)

    def top_up() -> None:
        while len(window) < concurrency:
            loc = feed.next_ready()
            if loc is None:
                return
            start_fetch(loc)

    try:
        top_up()
        while True:
            if not window:
                loc = feed.next_blocking()
                if loc is None:
                    return
                start_fetch(loc)
                top_up()
            _loc, q = window[0]
            got_any = False
            while True:
                try:
                    item = q.get_nowait()
                    buffered = True
                except _queue.Empty:
                    buffered = False
                    with metrics.time("fetch_time"):
                        item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, _Err):
                    raise item.exc
                # a miss: the consumer waited on the read
                metrics.add("fetch_overlap_hits" if buffered else "fetch_overlap_misses")
                got_any = True
                metrics.add("fetched_bytes", item.nbytes)
                yield item
                top_up()
            window.popleft()
            if got_any:
                metrics.add("fetched_batches")
            top_up()
    finally:
        # an early-stopping consumer lands here too: stop lets blocked
        # workers leave their puts, and the join ends every fetch thread
        stop.set()
        ex.shutdown(wait=True, cancel_futures=True)


class ShuffleReaderExec(ExecutionPlan):
    """Reads ``partition_locations[p]`` for output partition p. ``eager``
    plans carry the producing (job_id, stage_id) in place of locations and
    poll a scheduler; they encode and decode, and raise when executed
    (ROADMAP queue 1, item 9c)."""

    def __init__(
        self,
        partition_locations: list[list[PartitionLocation]],
        schema: Schema,
        job_id: str = "",
        stage_id: int = 0,
        eager: bool = False,
    ) -> None:
        super().__init__()
        self.partition_locations = [list(p) for p in partition_locations]
        self._schema = schema
        self.job_id = job_id
        self.stage_id = stage_id
        self.eager = eager

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return UnknownPartitioning(max(1, len(self.partition_locations)))

    def describe(self) -> str:
        if self.eager:
            return (
                f"ShuffleReaderExec: eager stage={self.stage_id}, "
                f"{len(self.partition_locations)} partitions"
            )
        n = sum(len(p) for p in self.partition_locations)
        return f"ShuffleReaderExec: {len(self.partition_locations)} partitions, {n} locations"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        if self.eager:
            raise NotImplementedError(f"the eager shuffle reader {_NOT_PORTED}")
        ctx.config.check_ported(BALLISTA_SHUFFLE_LOCAL_FASTPATH)
        locs = self.partition_locations[partition] if partition < len(self.partition_locations) else []
        if not locs:
            yield DeviceBatch.empty(self._schema, device=ctx.device)
            return
        cfg = ctx.config
        batch_rows = min(BATCH_ROWS, cfg.tpu_batch_rows())
        # record batches accumulate up to one device batch before the
        # upload, so the host holds one device batch of the partition
        pending: list[pa.RecordBatch] = []
        pending_rows = 0
        any_rows = False

        def flush() -> list[DeviceBatch]:
            t = time.perf_counter()
            table = pa.Table.from_batches(pending)
            pending.clear()
            # narrowing off: files of different writers share one layout
            out = table_from_arrow(table, batch_rows, frozenset(), device=ctx.device)
            stats["upload_s"] += time.perf_counter() - t
            return out

        for rb in _iter_location_batches(
            _StaticFeed(locs), fetch_partition_batches, cfg.shuffle_fetch_concurrency(), self.metrics
        ):
            if rb.num_rows == 0:
                continue
            any_rows = True
            pending.append(rb)
            pending_rows += rb.num_rows
            if pending_rows >= batch_rows:
                yield from flush()
                pending_rows = 0
        if pending:
            yield from flush()
        if not any_rows:
            yield DeviceBatch.empty(self._schema, device=ctx.device)
