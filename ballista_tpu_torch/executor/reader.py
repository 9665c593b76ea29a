"""ShuffleReaderExec: fetch and merge a stage's shuffle partitions into the
next stage (port of ``ballista_tpu/executor/reader.py``).

ref ballista/rust/core/src/execution_plans/shuffle_reader.rs:44-294. For
its output partition p the reader streams every mapped shuffle file (one
per upstream task that wrote rows for p) in location order: local paths
off a memory map, push streams out of this process's registry, and
everything else over Arrow Flight (``client/flight.py``: ``do_get`` of a
file, ``do_exchange`` of a push stream). It re-chunks the record batches
up to the device-batch row budget and uploads each chunk to the task's
device, with int64 narrowing off: files of different writers share one
layout. The host holds at most one device batch of a partition beyond the
batches in flight.

- **Overlapped fetch**: up to ``ballista.tpu.shuffle_fetch_concurrency``
  locations are fetched at once by pool workers into small bounded
  queues, while batches are yielded strictly in location order, so the
  stream (and every downstream reduction) is the sequential one's.
- **Eager mode** (``ballista.tpu.eager_shuffle``): the reader polls the
  scheduler (``TaskContext.shuffle_locations``) for map outputs as they
  are published, in map-task order, the order the barriered resolution
  gives. "Not yet published" waits (bounded by
  ``ballista.tpu.eager_wait_s``); "location lost" is a typed
  ShuffleFetchError.
- ``ballista.tpu.shuffle_local_fastpath=false`` sends every read, local
  or not, through Flight.
- **In-task retries**: a reader keeps the push batches its task took out
  of the registry, so a capacity retry of the task reads them again even
  after the registry dropped the consumed stream (the reference leaves
  that case to lineage recompute).

Per-location retries and backoff live in the Flight client; what escapes
is a typed :class:`ShuffleFetchError` naming the producing (executor,
stage, partition), so that a scheduler recomputes lost map output.
"""

from __future__ import annotations

import collections
import contextlib as _contextlib
import dataclasses
import os
import queue as _queue
import threading
import time as _time
from typing import Callable, Iterator

import pyarrow as pa
import pyarrow.ipc as paipc

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.columnar.arrow_interop import table_from_arrow
from ballista_tpu_torch.columnar.batch import DeviceBatch
from ballista_tpu_torch.datatypes import Schema
from ballista_tpu_torch.errors import ExecutionError, ShuffleFetchError
from ballista_tpu_torch.exec.base import (
    ExecutionPlan,
    TaskContext,
    UnknownPartitioning,
)
from ballista_tpu_torch.scheduler_types import PartitionLocation

BATCH_ROWS = 1 << 17

# Record batches buffered per in-flight location: deep enough to keep a
# worker busy while the consumer uploads, small enough that host residency
# stays about concurrency * depth batches.
_QUEUE_DEPTH = 4

# What the reads cost, summed over the process (a run resets them): host
# seconds of opening and decoding local IPC files (on the fetching
# threads), of building and uploading the device batches (on the consuming
# one), and the batches and bytes that came over Flight. Task threads and
# their fetch workers update them together, under the lock.
stats = dict(read_s=0.0, upload_s=0.0, flight_batches=0, flight_bytes=0)
_stats_lock = make_lock("reader._stats_lock")


def add_stats(**kv) -> None:
    with _stats_lock:
        for k, v in kv.items():
            stats[k] += v


def reset_stats() -> None:
    with _stats_lock:
        for k in stats:
            stats[k] = 0


@_contextlib.contextmanager
def _open_local_file(path: str):
    """Arrow IPC reader over a memory map: uncompressed shuffle files are
    then consumed zero-copy (batches alias the page cache instead of being
    read into fresh host buffers); compressed ones decode per batch.

    A context manager that closes the MEMORY MAP itself: pyarrow's
    ``RecordBatchFileReader`` has no ``close()`` and its ``with`` is a
    no-op, so the previous ``open_file(memory_map(path))`` left every
    fetched partition's fd + mapping open until GC (lifelint
    leaked-resource; on a wide fan-in that is hundreds of live maps whose
    touched pages all count into RSS — docs/memory.md)."""
    from ballista_tpu_torch.analysis import reswitness

    src = pa.memory_map(path)
    tok = reswitness.acquire("mmap", path)
    try:
        yield paipc.open_file(src)
    finally:
        src.close()
        reswitness.release(tok)


_LOCAL_HOSTS: frozenset | None = None


def _local_hostnames() -> frozenset:
    """Names/addresses that mean 'this host' for the per-link codec
    negotiation (computed once; getfqdn can stat resolvers)."""
    global _LOCAL_HOSTS
    if _LOCAL_HOSTS is None:
        import socket

        names = {"", "localhost", "127.0.0.1", "::1"}
        try:
            host = socket.gethostname()
            names.add(host)
            names.add(socket.getfqdn())
            # interface ADDRESSES too: executors on one machine commonly
            # advertise an IP, and missing it would negotiate lz4 onto a
            # loopback link — the exact regression 'auto' exists to fix
            for info in socket.getaddrinfo(host, None):
                names.add(info[4][0])
        except OSError:  # pragma: no cover — resolver-less hosts
            pass
        _LOCAL_HOSTS = frozenset(names)
    return _LOCAL_HOSTS


def resolve_link_codec(codec: str, loc: PartitionLocation) -> str:
    """Per-(producer, consumer) codec negotiation (docs/shuffle.md):
    ``auto`` picks ``none`` when the pair is colocated — the file is
    reachable on this filesystem, or the producer's advertised host IS
    this host. Anything crossing a real NIC gets lz4, the reference's
    choice (fewer wire bytes for little CPU; not measured on the port).
    Explicit codecs pass through unchanged."""
    if codec != "auto":
        return codec
    if os.path.exists(loc.path) or loc.host in _local_hostnames():
        return "none"
    return "lz4"


def fetch_partition_table(loc: PartitionLocation) -> pa.Table:
    """One shuffle partition -> Arrow table. Local files come back
    zero-copy off a memory map (the table aliases the page cache — no
    heap copy of the partition); a colocated push stream materializes
    straight from the registry's batches (no serialization at all);
    remote ones are assembled from the streamed Flight batch path, so
    nothing buffers the whole partition ON TOP of the table the caller
    asked for. Shuffle readers should prefer
    :func:`fetch_partition_batches` and never materialize at all."""
    if loc.push:
        from ballista_tpu_torch.executor.push import REGISTRY, stream_key

        batches = REGISTRY.take_batches(
            stream_key(loc.job_id, loc.stage_id, loc.map_partition,
                       loc.partition)
        )
        if batches is not None:
            return pa.Table.from_batches(batches)
    if os.path.exists(loc.path):
        try:
            with _open_local_file(loc.path) as r:
                return r.read_all()
        except (pa.ArrowInvalid, pa.ArrowIOError, OSError) as e:
            raise _local_fetch_error(loc, e) from e
    if loc.push:
        from ballista_tpu_torch.client.flight import fetch_push_partition

        return fetch_push_partition(loc)
    from ballista_tpu_torch.client.flight import fetch_partition

    return fetch_partition(loc)


def _local_fetch_error(loc: PartitionLocation, exc: Exception):
    """A local shuffle file that exists but cannot be decoded is lost data
    exactly like an unreachable remote: typed so the scheduler recomputes
    the producing map partition (corruption is non-transient — re-reading
    the same bytes cannot help)."""
    return ShuffleFetchError(
        f"corrupt/unreadable local shuffle file {loc.path}: "
        f"{type(exc).__name__}: {exc}",
        job_id=loc.job_id,
        stage_id=loc.stage_id,
        partition=loc.partition,
        executor_id=loc.executor_id,
        transient=False,
    )


def fetch_partition_batches(
    loc: PartitionLocation,
    retries: int | None = None,
    backoff_ms: int | None = None,
    timeout_s: float | None = None,
    compression: str = "",
    local_fastpath: bool = True,
    trace_ctx: tuple[str, str] | None = None,
    on_push_fallback=None,
    held: dict | None = None,
) -> Iterator[pa.RecordBatch]:
    """One shuffle file -> record-batch stream; peak memory is a batch,
    not the partition (ref shuffle_reader.rs streams batches through the
    Flight channel; read_all here was an OOM at SF=100 shuffle widths).

    Error taxonomy (docs/fault_tolerance.md): transient transport errors
    are retried inside the Flight client; what escapes here is a typed
    ShuffleFetchError naming the producing (executor, stage, partition) so
    the scheduler can recompute lost map output. Local-file corruption is
    classified the same way — non-transient, recompute-recoverable.

    ``compression`` asks the SERVING executor to compress the Flight
    stream with that codec (files are self-describing, so the local path
    ignores it); ``auto`` negotiates per link (resolve_link_codec).
    ``trace_ctx`` — the consuming task's (trace_id, span_id): remote
    fetches carry it in the Flight ticket settings so the serving
    executor's serve span joins the same trace (docs/observability.md).

    Push locations (docs/shuffle.md) try, in order: the in-process push
    registry (colocated consumer — zero copies, zero serialization), the
    local spilled/committed file, then a remote DoExchange stream that
    itself serves memory-or-file. ``on_push_fallback`` fires when a push
    location ended up served from disk — the backpressure/lag signal the
    push_fallbacks counter reads.

    ``held`` (the port's addition): the push batches the calling task
    took from the in-process registry, by stream key. The task's in-task
    retries (``run_with_capacity_retry``) read its inputs again, and by
    then the registry may have dropped the consumed stream to hold its
    window; with ``held`` the retry reads what the task already took
    instead of failing the task on a gone stream."""
    compression = resolve_link_codec(compression, loc)
    if loc.push:
        if local_fastpath:
            # the in-process registry shortcut is the push analogue of
            # the mmap local fast path: same colocation concept, same
            # knob (off forces every byte through the Flight wire path —
            # the separate-hosts shape, and what bench.py paces), and
            # the same fetch-attempt fault plumbing — fetch_error/
            # fetch_slow rules must fire here exactly like on the file
            # fast path, or chaos/fault tests silently stop covering
            # push-mode runs
            from ballista_tpu_torch.executor.push import REGISTRY, stream_key

            _inject_local_fetch_faults(loc, retries, backoff_ms)
            key = stream_key(
                loc.job_id, loc.stage_id, loc.map_partition, loc.partition
            )
            batches = None if held is None else held.get(key)
            if batches is None:
                batches = REGISTRY.take_batches(key)
                if batches is not None and held is not None:
                    held[key] = batches
            if batches is not None:
                yield from _local_push_batches(loc, batches)
                return
        if not (local_fastpath and os.path.exists(loc.path)):
            from ballista_tpu_torch.client.flight import fetch_push_batches

            yield from _metered_flight(fetch_push_batches(
                loc, retries, backoff_ms, timeout_s, compression,
                trace_ctx=trace_ctx, on_fallback=on_push_fallback,
            ))
            return
        # spilled under backpressure and we share its filesystem: the
        # pull fast path below serves the very file the stream spilled to
        if on_push_fallback is not None:
            on_push_fallback()
    if local_fastpath and os.path.exists(loc.path):
        from ballista_tpu_torch.testing import faults

        _inject_local_fetch_faults(loc, retries, backoff_ms)
        inj = faults.active()
        try:
            t = _time.perf_counter()
            with _open_local_file(loc.path) as r:
                for i in range(r.num_record_batches):
                    if inj is not None:
                        # producer_kill mirrors the Flight service's
                        # injection point on the LOCAL fast path (standalone
                        # clusters share a filesystem, so chaos tests would
                        # never reach the remote hook): the producer "dies"
                        # after i batches were already consumed
                        try:
                            inj.on_serve_batch(
                                loc.job_id, loc.stage_id, loc.partition, i,
                                path=loc.path,
                            )
                        except faults.InjectedFault as e:
                            raise ShuffleFetchError(
                                str(e),
                                job_id=loc.job_id,
                                stage_id=loc.stage_id,
                                partition=loc.partition,
                                executor_id=loc.executor_id,
                                transient=False,
                            ) from e
                    rb = r.get_batch(i)
                    add_stats(read_s=_time.perf_counter() - t)
                    yield rb
                    t = _time.perf_counter()
            add_stats(read_s=_time.perf_counter() - t)
            return
        except (pa.ArrowInvalid, pa.ArrowIOError, OSError) as e:
            raise _local_fetch_error(loc, e) from e
    from ballista_tpu_torch.client.flight import fetch_partition_batches as remote

    yield from _metered_flight(remote(
        loc, retries, backoff_ms, timeout_s, compression,
        trace_ctx=trace_ctx,
    ))


def _metered_flight(inner: Iterator[pa.RecordBatch]) -> Iterator[pa.RecordBatch]:
    """Count the batches and bytes a Flight fetch brought in
    (``stats``)."""
    for rb in inner:
        add_stats(flight_batches=1, flight_bytes=rb.nbytes)
        yield rb


def _local_push_batches(
    loc: PartitionLocation, batches: list
) -> Iterator[pa.RecordBatch]:
    """Colocated push consumption straight out of the in-process registry
    (the memory analogue of the mmap local fast path). Exposes the SAME
    ``producer_kill`` chaos point the file paths expose — standalone
    clusters consume push streams in-process, so chaos tests would never
    reach the Flight-side hook — with the push path tagged so the kill
    harness can attribute the stream to its producing executor."""
    from ballista_tpu_torch.testing import faults

    inj = faults.active()
    for i, rb in enumerate(batches):
        if inj is not None:
            try:
                inj.on_serve_batch(
                    loc.job_id, loc.stage_id, loc.partition, i,
                    path=loc.path,
                )
            except faults.InjectedFault as e:
                raise ShuffleFetchError(
                    str(e),
                    job_id=loc.job_id,
                    stage_id=loc.stage_id,
                    partition=loc.partition,
                    executor_id=loc.executor_id,
                    transient=False,
                ) from e
        yield rb


def _inject_local_fetch_faults(
    loc: PartitionLocation, retries: int | None, backoff_ms: int | None
) -> None:
    """Fault-injection for the LOCAL fast path: standalone clusters share a
    filesystem, so chaos tests would never exercise fetch faults through
    the Flight client's own injection point. Mirrors the client's retry
    loop (same attempt keying, same backoff) so a rule like
    ``attempt: [0, 1]`` is absorbed transparently and one exceeding the
    retry budget escalates to the scheduler-level recompute path."""
    from ballista_tpu_torch.testing import faults

    inj = faults.active()
    if inj is None:
        return
    from ballista_tpu_torch.client.flight import (
        DEFAULT_FETCH_BACKOFF_MS,
        DEFAULT_FETCH_RETRIES,
        backoff_s,
    )
    from ballista_tpu_torch.testing.faults import InjectedFetchError

    n = DEFAULT_FETCH_RETRIES if retries is None else max(1, retries)
    backoff = DEFAULT_FETCH_BACKOFF_MS if backoff_ms is None else backoff_ms
    for attempt in range(n):
        try:
            inj.on_fetch_attempt(
                loc.job_id, loc.stage_id, loc.partition, attempt
            )
            return
        except InjectedFetchError as e:
            if attempt + 1 >= n:
                raise ShuffleFetchError(
                    str(e),
                    job_id=loc.job_id,
                    stage_id=loc.stage_id,
                    partition=loc.partition,
                    executor_id=loc.executor_id,
                    transient=True,
                ) from e
            _time.sleep(backoff_s(loc, attempt, backoff))


# ---------------------------------------------------------------------------
# location feeds: where the reader's upstream locations come from
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShuffleLocationsView:
    """One GetShuffleLocations poll, decoded (executor.py builds these from
    the proto): published locations tagged with their producing map-task
    index, the contiguous completed-task prefix, and terminal flags."""

    locations: list[tuple[int, PartitionLocation]]
    tasks_done_prefix: int
    complete: bool
    failed: bool


class _StaticFeed:
    """Barriered mode: the location list baked in at stage promotion."""

    def __init__(self, locs: list[PartitionLocation]):
        self._locs = collections.deque(locs)

    def next_ready(self) -> PartitionLocation | None:
        return self._locs.popleft() if self._locs else None

    def next_blocking(self) -> PartitionLocation | None:
        return self.next_ready()


class _EagerFeed:
    """Eager mode: poll the scheduler for published map outputs, yielding
    locations in MAP-TASK ORDER — exactly the order the barriered
    resolution produces — so eager results stay bit-exact vs barriered.

    A location is yielded only once its map-task index is below the
    completed-task prefix (or the stage committed): everything yielded is
    a closed, fully-written file. The prefix may SHRINK under lineage
    recovery (a completed task re-opened); already-yielded indices are
    never re-yielded — the data consumed from the original file is the
    same bytes a bit-exact recompute would produce, and a fetch that dies
    mid-stream escalates through the normal ShuffleFetchError path."""

    def __init__(self, ctx: TaskContext, job_id: str, stage_id: int,
                 partition: int, metrics):
        if ctx.shuffle_locations is None:
            raise ExecutionError(
                "eager ShuffleReaderExec requires a scheduler-connected "
                "executor (TaskContext.shuffle_locations); eager plans "
                "are only dispatched by the scheduler"
            )
        from ballista_tpu_torch.obs import trace as obs_trace

        # tracing: the feed is built on the consumer task's thread, so
        # the ambient context here IS the task-attempt span — poll events
        # recorded against it nest under the consumer task
        # (docs/observability.md); None when the session doesn't trace
        self._trace_parent = obs_trace.current()
        self._poll: Callable = ctx.shuffle_locations
        self.job_id = job_id
        self.stage_id = stage_id
        self.partition = partition
        self._metrics = metrics
        self._interval_s = ctx.config.eager_poll_ms() / 1000.0
        self._wait_s = ctx.config.eager_wait_s()
        self._pending: collections.deque = collections.deque()
        self._next_map = 0
        self._complete = False
        self._last_poll = 0.0

    def _lost(self, msg: str) -> ShuffleFetchError:
        return ShuffleFetchError(
            msg,
            job_id=self.job_id,
            stage_id=self.stage_id,
            partition=self.partition,
            executor_id="",
            transient=True,
        )

    def _refresh(self) -> None:
        view: ShuffleLocationsView | None = self._poll(
            self.job_id, self.stage_id, self.partition
        )
        self._last_poll = _time.monotonic()
        self._metrics.add("eager_polls")
        if view is None or view.failed:
            raise self._lost(
                f"eager shuffle source stage {self.stage_id} of job "
                f"{self.job_id} is gone (job torn down or stage removed)"
            )
        upto = None if view.complete else view.tasks_done_prefix
        ready = sorted(
            (mt, loc)
            for mt, loc in view.locations
            if mt >= self._next_map and (upto is None or mt < upto)
        )
        for mt, loc in ready:
            self._pending.append(loc)
            self._next_map = mt + 1
        if ready and self._trace_parent is not None:
            # span volume bounded by #map tasks: only polls that made
            # progress are recorded, not the 10ms-cadence empty ones
            from ballista_tpu_torch.obs import trace as obs_trace

            obs_trace.event(
                "eager_poll",
                trace_id=self._trace_parent[0],
                parent_id=self._trace_parent[1],
                attrs={
                    "stage_id": self.stage_id,
                    "partition": self.partition,
                    "new_locations": len(ready),
                    "next_map": self._next_map,
                },
            )
        if upto is not None:
            # empty producers below the prefix publish no file; skip them
            self._next_map = max(self._next_map, upto)
        else:
            self._complete = True

    def next_ready(self) -> PartitionLocation | None:
        """Non-blocking: a published location if one is due, else None.
        Polls are rate-limited to the configured cadence so the overlap
        top-up on every consumed batch cannot turn into an RPC storm."""
        if not self._pending and not self._complete and (
            _time.monotonic() - self._last_poll >= self._interval_s
        ):
            self._refresh()
        return self._pending.popleft() if self._pending else None

    def next_blocking(self) -> PartitionLocation | None:
        """The next location in map-task order, waiting (bounded) for the
        producer to publish it; None once the stage committed and every
        published location was yielded."""
        start = _time.monotonic()
        while True:
            if self._pending:
                return self._pending.popleft()
            if self._complete:
                return None
            self._refresh()
            if self._pending or self._complete:
                continue
            if self._wait_s and _time.monotonic() - start > self._wait_s:
                # [eager-wait-timeout] is machine-parsed by the scheduler
                # (apply_task_statuses): giving up on a SLOW producer must
                # requeue this task WITHOUT consuming a bounded attempt —
                # charging it would fail healthy jobs whose map tasks just
                # take longer than the deadline, something barriered mode
                # would have waited out. The requeue loop converges: each
                # round only soaks an otherwise-idle slot, and ends when
                # the producer publishes (or the job fails on its own).
                raise self._lost(
                    f"[eager-wait-timeout] eager shuffle wait deadline "
                    f"({self._wait_s:g}s) exceeded for stage "
                    f"{self.stage_id} partition {self.partition} "
                    f"(map tasks >= {self._next_map} unpublished)"
                )
            self._metrics.add("eager_waits")
            _time.sleep(self._interval_s)


def _traced_fetch(
    inner: Iterator[pa.RecordBatch],
    loc: PartitionLocation,
    parent: tuple[str, str],
) -> Iterator[pa.RecordBatch]:
    """Wrap one location's fetch stream in a ``shuffle_fetch`` span with
    an EXPLICIT parent (no thread-local push: overlapped fetches run on
    pool threads, and a generator-held ambient context would leak onto
    whatever else the thread runs between yields)."""
    from ballista_tpu_torch.obs import trace as obs_trace

    s = obs_trace.start(
        "shuffle_fetch",
        parent[0],
        parent[1],
        attrs={
            "stage_id": loc.stage_id,
            "partition": loc.partition,
            "executor_id": loc.executor_id,
            "host": loc.host,
        },
    )
    rows = 0
    try:
        for rb in inner:
            rows += rb.num_rows
            yield rb
    except GeneratorExit:
        # an early-stopping consumer (LIMIT) is a CLEAN close, not a
        # fetch failure — the span stays ok, tagged cancelled
        s.attrs["cancelled"] = 1
        raise
    except BaseException as e:
        s.outcome = "error"
        s.attrs["error"] = type(e).__name__
        raise
    finally:
        close = getattr(inner, "close", None)
        if close is not None:
            close()
        s.attrs["rows"] = rows
        obs_trace.finish(s, s.outcome)


# ---------------------------------------------------------------------------
# overlapped fetch pipeline
# ---------------------------------------------------------------------------

_DONE = object()


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _pump_put(q: _queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded, cancellation-aware handoff from a fetch worker to the
    consuming generator: the put blocks only in short slices so an
    abandoned consumer (GeneratorExit sets ``stop``) can never leave a
    worker wedged against a full queue."""
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

    ``concurrency <= 1``: the sequential baseline — one location at a
    time, exactly the pre-overlap loop. Otherwise up to ``concurrency``
    locations are fetched at once by pool workers, each into a bounded
    queue, while batches are YIELDED strictly in location order (location
    i's batches all precede location i+1's), so the merged stream is
    byte-identical to the sequential one. A location's fetch error is
    raised at the point the consumer reaches that location — the same
    position the sequential loop would raise it."""
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
                # deterministic cancel of the in-flight Flight read /
                # local mmap on a consumer that stops early
                # (GeneratorExit) or a downstream error — parity with
                # the overlapped path's stop+join, instead of leaving
                # the fetch generator's cleanup to GC timing
                it.close()
            if got_any:
                metrics.add("fetched_batches")

    from concurrent.futures import ThreadPoolExecutor

    from ballista_tpu_torch.analysis import reswitness

    stop = threading.Event()
    window: collections.deque = collections.deque()
    ex = ThreadPoolExecutor(
        max_workers=concurrency, thread_name_prefix="shuffle-fetch"
    )
    pool_tok = reswitness.acquire("thread-pool", "shuffle-fetch")

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
        qtok = reswitness.acquire(
            "fetch-queue", f"{loc.job_id}/{loc.stage_id}/{loc.partition}"
        )
        window.append((loc, q, qtok))
        ex.submit(pump, loc, q)

    def top_up() -> None:
        while len(window) < concurrency:
            loc = feed.next_ready()
            if loc is None:
                return
            start_fetch(loc)

    # resolved ONCE per read, not per stalled batch: the stall branch is
    # per-batch under fetch pressure, and re-resolving the vec would add
    # registry-lock acquisitions to the data-plane hot loop
    from ballista_tpu_torch.obs import hist as obs_hist

    fetch_wait_hist = obs_hist.REGISTRY.histogram(
        "ballista_shuffle_fetch_wait_seconds",
        "Consumer stall time waiting on shuffle fetches "
        "(the overlap window could still hide this)",
    ).labels()

    try:
        top_up()
        while True:
            if not window:
                loc = feed.next_blocking()
                if loc is None:
                    return
                start_fetch(loc)
                top_up()
            _loc, q, qtok = window[0]
            got_any = False
            while True:
                try:
                    item = q.get_nowait()
                    buffered = True
                except _queue.Empty:
                    buffered = False
                    # genuine network wait: the consumer stalled on the
                    # fetch pipeline. The duration feeds the fleet
                    # shuffle-fetch-wait histogram (obs/hist.py) shipped
                    # home on poll/heartbeat (docs/observability.md).
                    wait_t0 = _time.perf_counter()
                    with metrics.time("fetch_time"):
                        item = q.get()
                    fetch_wait_hist.observe(
                        _time.perf_counter() - wait_t0
                    )
                if item is _DONE:
                    break
                if isinstance(item, _Err):
                    raise item.exc
                # counted only for real record batches — sentinels would
                # skew the overlap ratio by one entry per location. A miss
                # means the consumer genuinely waited on the network: the
                # time a deeper overlap window could still hide.
                metrics.add(
                    "fetch_overlap_hits" if buffered
                    else "fetch_overlap_misses"
                )
                got_any = True
                metrics.add("fetched_bytes", item.nbytes)
                yield item
                top_up()
            window.popleft()
            reswitness.release(qtok)
            if got_any:
                metrics.add("fetched_batches")
            top_up()
    finally:
        # GeneratorExit from an early-stopping consumer lands here too:
        # stop lets blocked workers bail out of their bounded puts, then
        # the pool join guarantees no fetch thread outlives the task
        stop.set()
        ex.shutdown(wait=True, cancel_futures=True)
        reswitness.release(pool_tok)
        for _loc, _q, qtok in window:  # abandoned mid-flight locations
            reswitness.release(qtok)


class ShuffleReaderExec(ExecutionPlan):
    """``eager`` plans (ballista.tpu.eager_shuffle) carry the producing
    (job_id, stage_id) instead of resolved locations and poll the
    scheduler; ``partition_locations`` then only sizes the output
    partitioning (one empty list per output partition)."""

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
        # push batches taken from the in-process registry, kept for the
        # task's in-task retries (see fetch_partition_batches' ``held``);
        # a decoded stage plan lives for one task
        self._held_push: dict = {}

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
        return (
            f"ShuffleReaderExec: {len(self.partition_locations)} partitions, "
            f"{n} locations"
        )

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[DeviceBatch]:
        if partition >= len(self.partition_locations):
            yield DeviceBatch.empty(self._schema, device=ctx.device)
            return
        # fetch resilience knobs travel with the session config; exhausted
        # retries surface as a typed ShuffleFetchError that fails this task
        # and routes the scheduler into lost-shuffle recompute
        retries = ctx.config.fetch_retries()
        backoff_ms = ctx.config.fetch_backoff_ms()
        timeout_s = ctx.config.fetch_timeout_s()
        compression = ctx.config.shuffle_compression()
        local_fastpath = ctx.config.shuffle_local_fastpath()
        # tracing (docs/observability.md): execute() runs on the task
        # thread, where the ambient context is the task-attempt span (when
        # the session traces) — captured HERE and passed explicitly, since
        # overlapped fetches run on pool threads
        from ballista_tpu_torch.obs import trace as obs_trace

        trace_parent = obs_trace.current()

        def on_push_fallback():
            # a push location got served from disk (spilled under the
            # window, or the stream died): the lag/backpressure signal
            self.metrics.add("push_fallbacks")

        def fetch_one(loc: PartitionLocation) -> Iterator[pa.RecordBatch]:
            it = fetch_partition_batches(
                loc, retries, backoff_ms, timeout_s, compression,
                local_fastpath, trace_ctx=trace_parent,
                on_push_fallback=on_push_fallback, held=self._held_push,
            )
            if trace_parent is None:
                return it
            return _traced_fetch(it, loc, trace_parent)

        if self.eager:
            feed = _EagerFeed(
                ctx, self.job_id, self.stage_id, partition, self.metrics
            )
        else:
            locs = self.partition_locations[partition]
            if not locs:
                yield DeviceBatch.empty(self._schema, device=ctx.device)
                return
            feed = _StaticFeed(locs)

        any_rows = False
        batch_rows = min(BATCH_ROWS, ctx.config.tpu_batch_rows())
        # Streamed re-chunking: record batches accumulate only up to the
        # device-batch row budget before flushing to device, so host
        # memory is bounded by one device batch regardless of how wide
        # the shuffle partition is.
        pending: list[pa.RecordBatch] = []
        pending_rows = 0

        def flush() -> list[DeviceBatch]:
            t0 = _time.perf_counter()
            t = pa.Table.from_batches(pending)
            pending.clear()
            # narrowing OFF: shuffle files from different writers must
            # share one physical layout
            out = table_from_arrow(t, batch_rows, frozenset(), device=ctx.device)
            add_stats(upload_s=_time.perf_counter() - t0)
            return out

        concurrency = ctx.config.shuffle_fetch_concurrency()
        for rb in _iter_location_batches(
            feed, fetch_one, concurrency, self.metrics
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
