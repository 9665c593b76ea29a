"""Arrow Flight data-plane client.

ref ballista/rust/core/src/client.rs:50-178 (BallistaClient): encode a
protobuf Action{FetchPartition} as the Flight Ticket, `do_get`, read the
IPC stream. pyarrow.flight is Arrow C++ Flight underneath — the native
data plane the reference uses, not a Python reimplementation.

Fetch-level resilience (docs/fault_tolerance.md):

- Connections are cached per ``(host, port)`` — a shuffle-wide fan-in
  dials each peer once instead of per partition, and one flaky handshake
  no longer turns into a hard error on an otherwise-healthy stream.
- Every fetch attempt carries a deadline (``ballista.tpu.fetch_timeout_s``)
  and transient transport errors (unavailable / timed out) retry up to
  ``ballista.tpu.fetch_retries`` times with bounded exponential backoff +
  deterministic jitter (``ballista.tpu.fetch_backoff_ms``).
- Exhausted retries — and non-transient errors (corrupt stream, server-side
  missing file), where redialing cannot help — escalate to a typed
  :class:`ShuffleFetchError` naming the producing (executor, job, stage,
  partition) so the scheduler can recompute the lost map output instead of
  failing the job.
- Retries only happen while NOTHING has been yielded yet: once batches
  flowed downstream, a silent re-fetch would duplicate rows, so mid-stream
  failures escalate immediately.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import pyarrow as pa
import pyarrow.flight as paflight

from ballista_tpu_torch.analysis.witness import make_lock
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import ShuffleFetchError
from ballista_tpu_torch.proto import pb
from ballista_tpu_torch.scheduler_types import PartitionLocation

# library defaults (the config entry defaults); callers with a session
# config (ShuffleReaderExec) pass explicit values instead
_DEFAULTS = BallistaConfig()
DEFAULT_FETCH_RETRIES = _DEFAULTS.fetch_retries()
DEFAULT_FETCH_BACKOFF_MS = _DEFAULTS.fetch_backoff_ms()
DEFAULT_FETCH_TIMEOUT_S = _DEFAULTS.fetch_timeout_s()

# Transient transport failures: another attempt against the same endpoint
# can succeed (executor restarting, listen backlog full, deadline blown by
# a GC pause). Everything else is treated as non-transient — corrupt IPC
# data or a server that answers-but-errors won't be fixed by redialing.
_TRANSIENT_FLIGHT_ERRORS = (
    paflight.FlightUnavailableError,
    paflight.FlightTimedOutError,
    # cancellations surface when a concurrent user of the shared pooled
    # channel saw a transport error first and evicted it — the data is not
    # lost, a redial succeeds
    paflight.FlightCancelledError,
)

_POOL: dict[tuple[str, int], paflight.FlightClient] = {}
# witness tokens for pooled clients (analysis/reswitness.py), keyed like
# the pool and mutated under the same lock
_POOL_TOKENS: dict[tuple[str, int], object] = {}
_POOL_LOCK = make_lock("flight._POOL_LOCK")


def _client_for(host: str, port: int) -> paflight.FlightClient:
    """Cached Flight connection per (host, port). Arrow's FlightClient is
    thread-safe; concurrent shuffle readers share one channel per peer.

    The dial happens OUTSIDE the pool lock (racelint blocking-under-lock):
    a slow handshake toward one dead peer must not serialize every other
    fetch thread — across healthy peers — behind the global lock. Two
    threads racing the first dial both connect; the loser's channel is
    closed (nobody else can have seen it)."""
    from ballista_tpu_torch.analysis import reswitness

    key = (host, port)
    with _POOL_LOCK:
        client = _POOL.get(key)
    if client is not None:
        return client
    client = paflight.connect(f"grpc://{host}:{port}")
    tok = reswitness.acquire("flight-client", f"{host}:{port}")
    extra = None
    with _POOL_LOCK:
        raced = _POOL.get(key)
        if raced is not None:
            client, extra = raced, client
        else:
            _POOL[key] = client
            _POOL_TOKENS[key], tok = tok, None
    reswitness.release(tok)  # store-race loser: closed right below
    if extra is not None:
        with contextlib.suppress(Exception):
            extra.close()
    return client


def _evict(host: str, port: int, client: paflight.FlightClient) -> None:
    """Drop a connection that produced a transport error (if it is still
    the cached one) so the next attempt redials instead of reusing a
    poisoned channel. Deliberately does NOT close(): other threads may be
    mid-do_get on the shared channel, and closing under them would turn
    their healthy streams into spurious failures — the evicted client is
    closed by GC once the last user drops it."""
    from ballista_tpu_torch.analysis import reswitness

    key = (host, port)
    with _POOL_LOCK:
        if _POOL.get(key) is client:
            del _POOL[key]
            # ownership deliberately moves to GC (in-flight streams may
            # still be using the channel) — the eviction IS the release
            # decision the witness records
            reswitness.release(_POOL_TOKENS.pop(key, None))


def close_pool() -> None:
    """Close every cached connection (tests / process shutdown)."""
    from ballista_tpu_torch.analysis import reswitness

    with _POOL_LOCK:
        clients = list(_POOL.values())
        _POOL.clear()
        tokens = list(_POOL_TOKENS.values())
        _POOL_TOKENS.clear()
    for t in tokens:
        reswitness.release(t)
    for c in clients:
        with contextlib.suppress(Exception):
            c.close()


def backoff_s(loc: PartitionLocation, attempt: int, backoff_ms: int) -> float:
    """Bounded exponential backoff with deterministic +-25% jitter keyed by
    (location, attempt) — reproducible under the fault harness, and
    de-synchronized across the many readers that lose the same executor at
    once (no thundering-herd redial)."""
    if backoff_ms <= 0:
        return 0.0
    base = min(backoff_ms * (2 ** attempt), backoff_ms * 100) / 1000.0
    h = hashlib.sha256(
        repr((loc.job_id, loc.stage_id, loc.partition, attempt)).encode()
    ).digest()
    jitter = 0.75 + 0.5 * (h[0] / 255.0)
    return base * jitter


def make_fetch_action(
    loc: PartitionLocation,
    compression: str = "",
    trace_ctx: tuple[str, str] | None = None,
) -> pb.Action:
    """The FetchPartition action shared by the pull ticket (``do_get``)
    and the push descriptor (``do_exchange``). ``compression``
    (none|lz4|zstd) rides the Action's settings so the SERVING executor
    compresses the Flight stream's IPC buffers — the per-link negotiated
    codec applied to bytes on the wire, not just bytes on disk. Empty =
    server streams uncompressed. ``trace_ctx`` (trace_id, parent span id)
    rides the settings too, so the serving executor's flight_serve span
    joins the consumer's trace (docs/observability.md)."""
    from ballista_tpu_torch.config import (
        BALLISTA_INTERNAL_SPAN_PARENT,
        BALLISTA_INTERNAL_TRACE_ID,
        BALLISTA_SHUFFLE_COMPRESSION,
    )

    settings = []
    if compression and compression != "none":
        settings.append(
            pb.KeyValuePair(
                key=BALLISTA_SHUFFLE_COMPRESSION, value=compression
            )
        )
    if trace_ctx is not None:
        settings.append(
            pb.KeyValuePair(
                key=BALLISTA_INTERNAL_TRACE_ID, value=trace_ctx[0]
            )
        )
        settings.append(
            pb.KeyValuePair(
                key=BALLISTA_INTERNAL_SPAN_PARENT, value=trace_ctx[1]
            )
        )
    return pb.Action(
        fetch_partition=pb.FetchPartition(
            job_id=loc.job_id,
            stage_id=loc.stage_id,
            partition_id=loc.partition,
            path=loc.path,
            map_partition=loc.map_partition,
            push=loc.push,
        ),
        settings=settings,
    )


def make_ticket(
    loc: PartitionLocation,
    compression: str = "",
    trace_ctx: tuple[str, str] | None = None,
) -> paflight.Ticket:
    """do_get ticket: the serialized fetch action."""
    return paflight.Ticket(
        make_fetch_action(loc, compression, trace_ctx).SerializeToString()
    )


def _call_options(timeout_s: float) -> paflight.FlightCallOptions:
    if timeout_s and timeout_s > 0:
        return paflight.FlightCallOptions(timeout=timeout_s)
    return paflight.FlightCallOptions()


def _escalate(loc: PartitionLocation, exc: Exception, transient: bool):
    return ShuffleFetchError(
        f"failed to fetch shuffle partition from {loc.host}:{loc.port}: "
        f"{type(exc).__name__}: {exc}",
        job_id=loc.job_id,
        stage_id=loc.stage_id,
        partition=loc.partition,
        executor_id=loc.executor_id,
        transient=transient,
    )


def _inject_fetch_fault(loc: PartitionLocation, attempt: int) -> None:
    from ballista_tpu_torch.testing import faults

    inj = faults.active()
    if inj is None:
        return
    from ballista_tpu_torch.testing.faults import InjectedFetchError

    try:
        inj.on_fetch_attempt(
            loc.job_id, loc.stage_id, loc.partition, attempt
        )
    except InjectedFetchError as e:
        # surface as the transient-transport flavor so the retry/backoff
        # path is exercised exactly like a real unavailable endpoint
        raise paflight.FlightUnavailableError(str(e)) from e


def fetch_partition(
    loc: PartitionLocation,
    retries: int | None = None,
    backoff_ms: int | None = None,
    timeout_s: float | None = None,
) -> pa.Table:
    """ref client.rs fetch_partition (:75-130). Materializes the whole
    partition — use for RESULT fetches; shuffle readers should stream via
    fetch_partition_batches. The table is assembled from the streamed
    batches (``read_all`` double-buffered the partition inside the Flight
    reader before handing it over); every transient attempt stays safely
    retryable because the partial batch list is private to this call and
    discarded on retry — nothing flowed downstream."""
    retries = DEFAULT_FETCH_RETRIES if retries is None else max(1, retries)
    backoff_ms = (
        DEFAULT_FETCH_BACKOFF_MS if backoff_ms is None else backoff_ms
    )
    timeout_s = DEFAULT_FETCH_TIMEOUT_S if timeout_s is None else timeout_s
    for attempt in range(retries):
        client = None
        reader = None
        try:
            _inject_fetch_fault(loc, attempt)
            client = _client_for(loc.host, loc.port)
            reader = client.do_get(
                make_ticket(loc), options=_call_options(timeout_s)
            )
            try:
                schema = reader.schema
                batches = [
                    chunk.data for chunk in reader if chunk.data is not None
                ]
            finally:
                with contextlib.suppress(Exception):
                    reader.cancel()
            return pa.Table.from_batches(batches, schema=schema)
        except _TRANSIENT_FLIGHT_ERRORS as e:
            if client is not None:
                _evict(loc.host, loc.port, client)
            if attempt + 1 >= retries:
                raise _escalate(loc, e, transient=True) from e
            time.sleep(backoff_s(loc, attempt, backoff_ms))
        except (paflight.FlightError, pa.ArrowInvalid, pa.ArrowIOError) as e:
            raise _escalate(loc, e, transient=False) from e
    raise AssertionError("unreachable")  # pragma: no cover


def fetch_partition_batches(
    loc: PartitionLocation,
    retries: int | None = None,
    backoff_ms: int | None = None,
    timeout_s: float | None = None,
    compression: str = "",
    trace_ctx: tuple[str, str] | None = None,
):
    """Stream a remote shuffle partition batch-at-a-time (the server side
    is a GeneratorStream over the IPC file) — peak memory is one record
    batch, not the partition.

    Generator hygiene: a downstream consumer that stops early (LIMIT)
    triggers GeneratorExit — the in-flight Flight read is cancelled in the
    ``finally`` so the stream isn't leaked (the pooled CONNECTION stays
    cached by design; only the per-call reader is torn down)."""
    retries = DEFAULT_FETCH_RETRIES if retries is None else max(1, retries)
    backoff_ms = (
        DEFAULT_FETCH_BACKOFF_MS if backoff_ms is None else backoff_ms
    )
    timeout_s = DEFAULT_FETCH_TIMEOUT_S if timeout_s is None else timeout_s

    yielded = False
    for attempt in range(retries):
        client = None
        reader = None
        try:
            _inject_fetch_fault(loc, attempt)
            client = _client_for(loc.host, loc.port)
            reader = client.do_get(
                make_ticket(loc, compression, trace_ctx=trace_ctx),
                options=_call_options(timeout_s),
            )
            try:
                for chunk in reader:
                    if chunk.data is not None:
                        yielded = True
                        yield chunk.data
            finally:
                # closes the stream on normal exhaustion AND on
                # GeneratorExit from an early-stopping consumer
                with contextlib.suppress(Exception):
                    reader.cancel()
            return
        except _TRANSIENT_FLIGHT_ERRORS as e:
            if client is not None:
                _evict(loc.host, loc.port, client)
            if yielded:
                # batches already flowed downstream: a restart would
                # duplicate rows — escalate to a clean task-level retry
                raise _escalate(loc, e, transient=True) from e
            if attempt + 1 >= retries:
                raise _escalate(loc, e, transient=True) from e
            time.sleep(backoff_s(loc, attempt, backoff_ms))
        except ShuffleFetchError:
            raise
        except (paflight.FlightError, pa.ArrowInvalid, pa.ArrowIOError) as e:
            # non-transient: data corruption or a server-side error (e.g.
            # the shuffle file is gone). Redialing cannot help; recomputing
            # the producing stage can.
            raise _escalate(loc, e, transient=False) from e


def fetch_push_batches(
    loc: PartitionLocation,
    retries: int | None = None,
    backoff_ms: int | None = None,
    timeout_s: float | None = None,
    compression: str = "",
    trace_ctx: tuple[str, str] | None = None,
    on_fallback=None,
):
    """Stream a push-shuffle partition over Flight ``do_exchange``
    (docs/shuffle.md): the serving executor writes the live in-memory
    stream when it has one and transparently serves the spilled file
    otherwise — its first message is an app-metadata tag (``mem`` /
    ``file``); ``on_fallback`` fires when the tag says the push window
    already spilled this stream (the consumer effectively took the pull
    path over the exchange call).

    Resilience matches :func:`fetch_partition_batches`: transient
    transport errors redial with bounded backoff while nothing was
    yielded; a ``[push-stream-gone]`` server error (producer lost the
    stream AND its fall-back file) is non-transient — the typed
    ShuffleFetchError it escalates to names the producing executor, and
    the scheduler recomputes the lost map output."""
    retries = DEFAULT_FETCH_RETRIES if retries is None else max(1, retries)
    backoff_ms = (
        DEFAULT_FETCH_BACKOFF_MS if backoff_ms is None else backoff_ms
    )
    timeout_s = DEFAULT_FETCH_TIMEOUT_S if timeout_s is None else timeout_s

    action = make_fetch_action(loc, compression, trace_ctx)
    descriptor = paflight.FlightDescriptor.for_command(
        action.SerializeToString()
    )
    yielded = False
    for attempt in range(retries):
        client = None
        reader = None
        try:
            _inject_fetch_fault(loc, attempt)
            client = _client_for(loc.host, loc.port)
            writer, reader = client.do_exchange(
                descriptor, options=_call_options(timeout_s)
            )
            try:
                # consumer->producer half unused: close it so the server
                # handler is not left waiting on our writes
                writer.done_writing()
                while True:
                    try:
                        chunk = reader.read_chunk()
                    except StopIteration:
                        break
                    if chunk.data is None:
                        if (
                            on_fallback is not None
                            and chunk.app_metadata is not None
                            and chunk.app_metadata.to_pybytes() == b"file"
                        ):
                            on_fallback()
                        continue
                    yielded = True
                    yield chunk.data
            finally:
                with contextlib.suppress(Exception):
                    reader.cancel()
                with contextlib.suppress(Exception):
                    writer.close()
            return
        except _TRANSIENT_FLIGHT_ERRORS as e:
            if client is not None:
                _evict(loc.host, loc.port, client)
            if yielded or attempt + 1 >= retries:
                # mid-stream loss of a push stream is unrecoverable by
                # redialing (take-once memory): escalate to the typed
                # error that drives producer recompute
                raise _escalate(loc, e, transient=True) from e
            time.sleep(backoff_s(loc, attempt, backoff_ms))
        except ShuffleFetchError:
            raise
        except (paflight.FlightError, pa.ArrowInvalid, pa.ArrowIOError) as e:
            # includes the machine-parseable [push-stream-gone] server
            # error: the stream is dead, only lineage recompute helps
            raise _escalate(loc, e, transient=False) from e


def fetch_push_partition(
    loc: PartitionLocation,
    retries: int | None = None,
    backoff_ms: int | None = None,
    timeout_s: float | None = None,
) -> pa.Table:
    """Materialize one push partition (result fetches). The batch list is
    private to each attempt and discarded on a transient retry — the same
    atomic-per-location retry contract :func:`fetch_partition` gives the
    client result path (nothing flows downstream mid-attempt)."""
    retries = DEFAULT_FETCH_RETRIES if retries is None else max(1, retries)
    for attempt in range(retries):
        try:
            batches = list(
                fetch_push_batches(
                    loc, retries=1, backoff_ms=backoff_ms,
                    timeout_s=timeout_s,
                )
            )
            return pa.Table.from_batches(batches) if batches else (
                pa.Table.from_batches([], schema=pa.schema([]))
            )
        except ShuffleFetchError as e:
            if not e.transient or attempt + 1 >= retries:
                raise
            time.sleep(
                backoff_s(
                    loc, attempt,
                    DEFAULT_FETCH_BACKOFF_MS
                    if backoff_ms is None else backoff_ms,
                )
            )
    raise AssertionError("unreachable")  # pragma: no cover
