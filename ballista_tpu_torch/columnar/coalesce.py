"""Record-batch coalescing: amortize per-batch fixed costs on the data
plane (a copy of ``ballista_tpu/columnar/coalesce.py``; pyarrow only).

A hash shuffle slices every device batch ``fan_out`` ways, so the batches
reaching the wire/disk are ``batch_bytes / fan_out`` — tiny at real fan-
outs — and each one pays fixed costs end-to-end: IPC framing, a Flight
chunk round-trip, a queue handoff in the overlapped reader, a device-
upload dispatch. BENCH_SHUFFLE showed that per-batch CPU is what made
overlapped fetch LOSE to sequential on raw loopback. Both ends of the
shuffle coalesce with the SAME helper (``ballista.tpu.
shuffle_target_batch_mb``): writers concatenate sub-target batches
before write/stream (executor/shuffle.py), and result assembly
concatenates streamed batches before building its one table
(client _fetch_results, fetch_partition).

Coalescing preserves ROW ORDER exactly (concatenation in arrival order);
only batch boundaries move. Downstream consumers that re-chunk by row
budget (the shuffle reader's device flush) are boundary-insensitive, and
the replay witness's canonical hash is boundary-invariant by
construction (analysis/replay.py).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import pyarrow as pa


# hard ceiling on coalescing targets: binary/string arrays carry 32-bit
# offsets (2GB per array), so combining beyond ~1GB of string data per
# batch could leave combine_chunks unable to produce one chunk — and
# silently dropping chunks would corrupt shuffle content. No data plane
# wants GB-scale batches anyway (they defeat streaming).
MAX_TARGET_BYTES = 1 << 30


def concat_batches(batches: list[pa.RecordBatch]) -> pa.RecordBatch:
    """One record batch from many (row order preserved). Dictionary
    columns with per-batch dictionaries are unified by the table
    combine — the result carries one dictionary per column."""
    if len(batches) == 1:
        return batches[0]
    t = pa.Table.from_batches(batches).combine_chunks()
    out = t.to_batches()
    if len(out) == 1:
        return out[0]
    # unreachable under the MAX_TARGET_BYTES cap (32-bit offsets can
    # hold any <=1GB concat); fail LOUDLY rather than drop chunks
    raise ValueError(
        f"coalesce produced {len(out)} chunks for {t.num_rows} rows / "
        f"{t.nbytes} bytes — offset overflow; lower "
        "ballista.tpu.shuffle_target_batch_mb"
    )


class BatchCoalescer:
    """Accumulate record batches up to ``target_bytes`` before releasing
    one concatenated batch. ``target_bytes <= 0`` passes batches through
    untouched. Zero-row batches are dropped (they carry no data and a
    schema-only batch still pays every fixed cost)."""

    def __init__(self, target_bytes: int):
        self.target_bytes = min(max(0, int(target_bytes)), MAX_TARGET_BYTES)
        self._pending: list[pa.RecordBatch] = []
        self._pending_bytes = 0

    def add(self, rb: pa.RecordBatch) -> pa.RecordBatch | None:
        """Feed one batch; returns a coalesced batch once the target is
        reached, else None. A batch already >= target passes through
        alone (after flushing anything pending — order preserved by the
        caller draining :meth:`flush` first via the return contract:
        the flushed prefix is concatenated IN FRONT of the big batch)."""
        if self.target_bytes == 0:
            return rb if rb.num_rows else None
        if rb.num_rows == 0:
            return None
        self._pending.append(rb)
        self._pending_bytes += rb.nbytes
        if self._pending_bytes >= self.target_bytes:
            return self.flush()
        return None

    def flush(self) -> pa.RecordBatch | None:
        """Concatenate and release everything pending (None when empty)."""
        if not self._pending:
            return None
        out = concat_batches(self._pending)
        self._pending = []
        self._pending_bytes = 0
        return out


def coalesce_batches(
    batches: Iterable[pa.RecordBatch], target_bytes: int
) -> Iterator[pa.RecordBatch]:
    """Stream adapter over :class:`BatchCoalescer`: same rows in the same
    order, re-chunked so every yielded batch (except possibly the last)
    is >= ``target_bytes``."""
    c = BatchCoalescer(target_bytes)
    for rb in batches:
        out = c.add(rb)
        if out is not None:
            yield out
    tail = c.flush()
    if tail is not None:
        yield tail
